"""The port's training pieces held against the JAX package on the
qwen2-0.5b smoke model in fp32, with the same numpy weights and batches:
the loss and every gradient leaf (``Model.loss`` under autograd vs
``jax.value_and_grad``), with the masked and the kernel attention (the JAX
``pallas`` in interpret mode) and with remat none and full; and AdamW.

Tolerances: the loss to rtol 1e-5 and the gradients to atol 1e-5 +
rtol 1e-4, since XLA and eager PyTorch sum in different orders; AdamW to
rtol 1e-5 + atol 1e-8 (elementwise fp32, but scaled by a clip coefficient
from a global norm, itself a sum) and the lr schedule to an ulp (rtol
1e-6: the two libraries' cos differ in the last bit)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (ARCH, jax_model, jax_params, port_model,  # noqa: E402
                           randn, smoke_weights, to_numpy)

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.utils.trees import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch.configs import get_arch, get_smoke_arch  # noqa: E402
from repro_torch.models import ModelSettings  # noqa: E402
from repro_torch.models.transformer import check_trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils.trees import tree_from_paths, tree_paths  # noqa: E402

B, S, CHUNK = 2, 16, 8


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=5)


@pytest.fixture(scope="module")
def batch():
    arch = get_smoke_arch(ARCH)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, arch.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # ignored positions, as the loss's mask allows
    return {"tokens": toks[:, :-1], "labels": labels}


def port_loss_and_grads(model, batch):
    params = model.params()
    flat = tree_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("attn_impl", ["masked", "kernel"])
def test_loss_and_grads_match_jax(weights, batch, attn_impl, remat):
    jm = jax_model(attn_impl="pallas" if attn_impl == "kernel" else "masked",
                   remat=remat, loss_chunk=CHUNK)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jax_params(weights), {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(weights, attn_impl=attn_impl, remat=remat,
                       loss_chunk=CHUNK)
    loss, grads = port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = jax_tree_paths(jgrads)
    assert grads.keys() == jflat.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(to_numpy(g), np.asarray(jflat[path]),
                                   atol=1e-5, rtol=1e-4, err_msg=path)


def test_loss_chunk_does_not_change_the_loss(weights, batch):
    losses = [port_loss_and_grads(port_model(weights, remat="none",
                                             loss_chunk=c), batch)[0]
              for c in (4, 16)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_untrainable_raise():
    """What the port trains: every family, remat none/full/dots, tri
    attention, fp32/fp32, bf16/bf16 and bf16/fp32, under a model axis or
    not, with k/v repeated per query head (``gqa_repeat``) or not, MoE
    dispatch groups, every family with its sequence split (``seq_axis``,
    ``batch_axes``); the GSPMD step, which has no check of its own since
    it runs the encoder-decoder too.
    What still raises, naming ROADMAP.md: fp32 parameters with a bf16
    compute dtype (no reference)."""
    from repro_torch.configs.base import EncoderConfig
    st = ModelSettings(param_dtype="float32", compute_dtype="float32")
    for name in ("rwkv6-1.6b", "jamba-1.5-large-398b", "deepseek-moe-16b"):
        check_trainable(get_smoke_arch(name), st)
    for pdt, cdt in (("bfloat16", "bfloat16"), ("bfloat16", "float32")):
        check_trainable(get_arch(ARCH), dataclasses.replace(
            st, param_dtype=pdt, compute_dtype=cdt, remat="dots",
            attn_impl="tri"))
    encdec = get_smoke_arch(ARCH).replace(family="audio",
                                          encoder=EncoderConfig(n_layers=2))
    for arch in (encdec, get_smoke_arch("whisper-medium")):
        check_trainable(arch, st)
    for name in ("jamba-1.5-large-398b", "deepseek-moe-16b"):
        check_trainable(get_smoke_arch(name), dataclasses.replace(st, moe_groups=2))
    check_trainable(get_arch(ARCH), dataclasses.replace(st, gqa_repeat=True))
    for sp in (dict(seq_axis="model"), dict(batch_axes=("data",))):
        check_trainable(get_arch(ARCH), dataclasses.replace(st, **sp))
    for name in ("deepseek-moe-16b", "rwkv6-1.6b", "jamba-1.5-large-398b",
                 "whisper-medium"):
        check_trainable(get_smoke_arch(name),
                        dataclasses.replace(st, seq_axis="model"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_trainable(get_arch(ARCH), dataclasses.replace(
            st, compute_dtype="bfloat16"))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(seed, shapes, scale=1.0):
    return {k: randn(seed + i, *s, scale=scale) for i, (k, s) in enumerate(shapes.items())}


SHAPES = {"a/w": (8, 16), "a/b": (16,), "c": (3, 4, 5)}


@pytest.mark.parametrize("clip", [0.0, 1.0, 0.05])
def test_adamw_update_matches_jax(clip):
    cfg = adamw.AdamWConfig(grad_clip=clip)
    jcfg = jax_adamw.AdamWConfig(grad_clip=clip)
    p = _tree(0, SHAPES)
    state = adamw.init_moments(tree_from_paths({k: torch.from_numpy(v) for k, v in p.items()}))
    jstate = jax_adamw.init_moments(tree_from_paths({k: jnp.asarray(v) for k, v in p.items()}))
    params = tree_from_paths({k: torch.from_numpy(v) for k, v in p.items()})
    jparams = tree_from_paths({k: jnp.asarray(v) for k, v in p.items()})
    lr_fn, jlr_fn = adamw.cosine_schedule(1e-2, 2, 6), jax_adamw.cosine_schedule(1e-2, 2, 6)
    for step in range(4):
        g = _tree(10 * step + 3, SHAPES, scale=0.5)
        lr, jlr = lr_fn(step), jlr_fn(step)
        np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-6)
        np.testing.assert_allclose(
            adamw.global_norm(tree_from_paths({k: torch.from_numpy(v) for k, v in g.items()})).item(),
            float(jax_adamw.global_norm(tree_from_paths({k: jnp.asarray(v) for k, v in g.items()}))),
            rtol=1e-6)
        params, state = adamw.adamw_update(
            params, tree_from_paths({k: torch.from_numpy(v) for k, v in g.items()}),
            state, lr, cfg)
        jparams, jstate = jax_adamw.adamw_update(
            jparams, tree_from_paths({k: jnp.asarray(v) for k, v in g.items()}),
            jstate, jlr, jcfg)
        for k in SHAPES:
            for a, b in ((tree_paths(params)[k], jax_tree_paths(jparams)[k]),
                         (tree_paths(state["m"])[k], jax_tree_paths(jstate["m"])[k]),
                         (tree_paths(state["v"])[k], jax_tree_paths(jstate["v"])[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                           atol=1e-8, err_msg=k)
    assert state["step"] == int(jstate["step"]) == 4


def test_cosine_schedule_matches_jax():
    for args in ((3e-3, 1, 6), (1e-3, 10, 100), (5e-4, 0, 1)):
        f, jf = adamw.cosine_schedule(*args), jax_adamw.cosine_schedule(*args)
        for step in (0, 1, 3, 5, 50, 120):
            np.testing.assert_allclose(f(step).numpy(), np.asarray(jf(step)), rtol=1e-6)
