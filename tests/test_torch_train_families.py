"""Training the port's other decoder families, held against the JAX
package with the same numpy weights and batches: the loss (the MoE aux
loss included) and every gradient leaf in fp32 for the deepseek-moe-16b,
rwkv6-1.6b and jamba-1.5-large-398b smoke configs (jamba with its experts,
MoE every 2nd layer), the recurrences through their plain versions and
through the kernels' autograd wrappers (``use_kernel_ssm``: on CPU
tensors the plain forward, and the backward recomputed through it);
``attend(impl="tri")``; ``remat="dots"``; the sharding rules of every
MoE, RWKV and Mamba leaf; and the deepseek-moe and jamba smokes trained
for 8 steps by the ``Trainer`` on 8 gloo ranks against the JAX ``Trainer``
on 8 fake devices (``tests/batteries/train_battery.py``'s runs, on a
data-parallel mesh), and the whisper smoke (the encoder-decoder, its
frames from the data pipeline) for 4 steps on (pod, data, model) = (2, 1,
1), two ranks, with and without the int8 slow tier, against the JAX
``Trainer`` there.

Tolerances are ``test_torch_train_model.py``'s: the loss to rtol 1e-5,
gradients to atol 1e-5 + rtol 1e-4; ``tri`` to ``tests/test_system.py``'s
2e-4; the trainer losses to ``test_torch_trainer.py``'s rtol 1e-4, and
the ranks' parameters bit-equal; whisper's final parameters to
``check_params_close`` (atol 2e-5; with the int8 codec 99% of them, every
one to 2 x lr x steps), its losses to rtol 1e-4 (1e-3 with the int8
codec, ``test_torch_tp.py``'s for a lossy codec)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, JAMBA, RWKV, TRAIN, WHISPER,  # noqa: E402
                           check_params_close, jax_loss_and_grads,
                           jax_model, jax_trainer_runs, port_loss_and_grads,
                           port_model, randn, rank_trainer, smoke_weights,
                           spawn_ranks, to_numpy, train_batch)

from repro.configs import get_smoke_arch as jax_smoke_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import sharding as jax_sharding  # noqa: E402
from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

CHUNK = 8
FAMILIES = {DEEPSEEK: False, RWKV: True, JAMBA: True}  # arch: has a recurrence


def _case(arch: str, seed: int):
    return (smoke_weights(seed=seed, arch=arch, experts=True),
            train_batch(get_smoke_arch(arch), seed=seed + 1))


@pytest.mark.parametrize("arch,remat,use_kernel", [
    (arch, remat, use_kernel) for arch, recurrent in FAMILIES.items()
    for remat in ("none", "full") for use_kernel in (False, True)[:1 + recurrent]])
def test_loss_and_grads_match_jax(arch, remat, use_kernel):
    weights, batch = _case(arch, seed=50)
    jm = jax_model(arch=arch, experts=True, remat=remat, loss_chunk=CHUNK)
    jloss, jgrads = jax_loss_and_grads(jm, weights, batch)
    model = port_model(weights, arch=arch, experts=True, remat=remat,
                       loss_chunk=CHUNK, use_kernel_ssm=use_kernel)
    loss, grads = port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(to_numpy(g), jgrads[path], atol=1e-5,
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", [DEEPSEEK, JAMBA])
def test_aux_loss_is_in_the_loss(arch):
    """The MoE aux loss enters ``train_loss`` at 0.01 a MoE layer, as in
    the JAX package: the port's loss less its CE is that term."""
    from repro_torch.models import transformer as T
    weights, batch = _case(arch, seed=51)
    model = port_model(weights, arch=arch, experts=True, loss_chunk=CHUNK)
    params, tb = model.params(), {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden, aux = T.forward_train(model.arch, params, tb["tokens"], model.settings)
    ce = T.ce_loss_chunked(model.arch, params, hidden, tb["labels"], model.settings)
    n_moe = len(model.arch.moe_layer_ids())
    assert n_moe >= 1 and float(aux) > 0
    torch.testing.assert_close(model.loss(params, tb), ce + 0.01 * aux / n_moe)


@pytest.mark.parametrize("S,block", [(256, 64), (512, 128)])
def test_attend_tri_matches_jax_and_masked(S, block):
    """``tests/test_system.py::test_attention_masked_vs_tri``'s shapes."""
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = randn(60, B, S, H, hd), randn(61, B, S, KV, hd), randn(62, B, S, KV, hd)
    tri = L.attend(*map(torch.from_numpy, (q, k, v)), causal=True, impl="tri",
                   block=block, q_chunk=64, kv_chunk=64)
    masked = L.attend(*map(torch.from_numpy, (q, k, v)), causal=True,
                      impl="masked", q_chunk=64, kv_chunk=64)
    jtri = JL.attend(*map(jnp.asarray, (q, k, v)), causal=True, impl="tri",
                     block=block, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(tri.numpy(), np.asarray(jtri), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tri.numpy(), masked.numpy(), rtol=2e-4, atol=2e-4)


def test_tri_model_loss_and_grads_match_jax():
    """``attn_impl="tri"`` through the model: seq 16 over blocks of 4."""
    weights, batch = _case("qwen2-0.5b", seed=52)
    jm = jax_model(attn_impl="tri", attn_block=4, loss_chunk=CHUNK)
    jloss, jgrads = jax_loss_and_grads(jm, weights, batch)
    loss, grads = port_loss_and_grads(
        port_model(weights, attn_impl="tri", attn_block=4, loss_chunk=CHUNK), batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(to_numpy(g), jgrads[path], atol=1e-5,
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", DEEPSEEK, RWKV, JAMBA])
def test_remat_dots_gradients_equal_remat_none(arch):
    """``remat="dots"`` keeps the products without batch dims and
    recomputes the rest; the gradients are ``remat="none"``'s, bit for
    bit, and the JAX ``remat="dots"`` loss's to the tolerances above."""
    weights, batch = _case(arch, seed=53)
    out = {r: port_loss_and_grads(port_model(weights, arch=arch, experts=True,
                                             remat=r, loss_chunk=CHUNK), batch)
           for r in ("none", "dots")}
    assert out["dots"][0] == out["none"][0]
    for path, g in out["dots"][1].items():
        torch.testing.assert_close(g, out["none"][1][path], atol=0, rtol=0)
    jloss, _ = jax_loss_and_grads(jax_model(arch=arch, experts=True, remat="dots",
                                            loss_chunk=CHUNK), weights, batch)
    np.testing.assert_allclose(out["dots"][0], jloss, rtol=1e-5)


@pytest.mark.parametrize("sizes", [{"pod": 2, "data": 4, "model": 1},
                                   {"pod": 1, "data": 2, "model": 2}],
                         ids=["dp", "tp2"])
@pytest.mark.parametrize("arch", [DEEPSEEK, RWKV, JAMBA])
def test_param_specs_match_jax(arch, sizes):
    """Every leaf's spec, the moe/, rwkv and mamba ones among them, as the
    JAX rules give it (on the data-parallel mesh and, rules only, with a
    model axis of 2, where the guards split dims)."""
    model = build_model(get_smoke_arch(arch), ModelSettings(
        param_dtype="float32", compute_dtype="float32"), device="meta")
    shapes = {k: v.shape for k, v in tree_paths(model.param_shapes()).items()}
    mi = sharding.MeshInfo(sizes, dp_axes=("pod", "data"))
    ours = sharding.param_specs(model.arch, shapes, mi)
    jmi = jax_sharding.MeshInfo(sizes, dp_axes=("pod", "data"))
    jshapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    from repro.utils.trees import tree_from_paths
    from repro.utils.trees import tree_paths as jax_tree_paths
    theirs = jax_tree_paths(jax_sharding.param_specs(
        jax_smoke_arch(arch), tree_from_paths(jshapes), jmi))
    assert ours.keys() == theirs.keys()
    kinds = ("moe/", "tmix/", "cmix/", "mamba/")
    assert any(k in p for p in ours for k in kinds)
    for path, spec in ours.items():
        assert spec == tuple(theirs[path]), path


def test_one_card_train_cut():
    """deepseek-moe-16b trains on one card cut in depth, every width kept;
    the other archs train as ``one_card_arch`` serves them."""
    from repro_torch.configs import get_arch, one_card_arch, one_card_train_arch
    arch, cuts = one_card_train_arch(DEEPSEEK)
    full = get_arch(DEEPSEEK)
    assert cuts == (f"n_layers: 28 -> {arch.n_layers}",) and arch.n_layers == 2
    assert arch.replace(n_layers=full.n_layers) == full
    for name in ("qwen2-0.5b", RWKV, JAMBA):
        assert one_card_train_arch(name) == one_card_arch(name)


# ---------------------------------------------------------------------------
# the Trainer on 8 gloo ranks against the JAX Trainer
# ---------------------------------------------------------------------------

TRAINER_ARCHS = (DEEPSEEK, JAMBA)
TRAINER_SIZES = {"pod": 2, "data": 4, "model": 1}
TRAINER_CFG = dict(mode="dfabric", zero1=True, codec=None)
TRAINER_STEPS = dict(steps=8)


@pytest.fixture(scope="module")
def trainer_runs():
    out = {}
    for arch in TRAINER_ARCHS:
        weights = smoke_weights(seed=54, arch=arch, experts=True)
        jax_out = jax_trainer_runs({"run": (TRAINER_SIZES, TRAINER_CFG)},
                                   weights, arch=arch, train=TRAINER_STEPS)
        port = spawn_ranks(8, rank_trainer, {
            "weights": weights, "sizes": TRAINER_SIZES, "cfg": TRAINER_CFG,
            "arch": arch, "train": TRAINER_STEPS})
        out[arch] = (jax_out, port)
    return out


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_matches_jax(trainer_runs, arch):
    jax_out, port = trainer_runs[arch]
    losses, params = port[0][0], port[0][1]
    assert len(losses) == TRAINER_STEPS["steps"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_out["run/loss"], rtol=1e-4)
    for rank, (_, p, _, _) in enumerate(port[1:], 1):  # the DP invariant
        for k in params:
            np.testing.assert_array_equal(p[k], params[k], err_msg=f"rank {rank} {k}")


WHISPER_SIZES = {"pod": 2, "data": 1, "model": 1}
WHISPER_RUNS = {"plain": dict(mode="dfabric", zero1=True, codec=None),
                "int8": dict(mode="dfabric", zero1=True, codec="int8")}


@pytest.fixture(scope="module")
def whisper_runs():
    weights = smoke_weights(seed=55, arch=WHISPER)
    jax_out = jax_trainer_runs({n: (WHISPER_SIZES, c) for n, c in WHISPER_RUNS.items()},
                               weights, arch=WHISPER)
    port = {n: spawn_ranks(2, rank_trainer, {
        "weights": weights, "sizes": WHISPER_SIZES, "cfg": c, "arch": WHISPER})
        for n, c in WHISPER_RUNS.items()}
    return jax_out, port


@pytest.mark.parametrize("name", list(WHISPER_RUNS))
def test_whisper_dp_trainer_matches_jax(whisper_runs, name):
    """The DFabric step on (2, 1, 1), as ``chip_smoke.py``
    ``[train-whisper]`` runs it with the int8 slow tier (error feedback,
    ZeRO-1) and without a codec: each member's rows of the batch's frames
    feed the encoder, whose gradients, the cross attention's and
    ``pos_embed``'s, are synced with the rest.  The losses to rtol 1e-4
    (1e-3 with int8), the final parameters to ``check_params_close``, the
    two ranks' parameters bit-equal."""
    jax_out, port = whisper_runs
    int8 = WHISPER_RUNS[name]["codec"] == "int8"
    losses, params = port[name][0][0], port[name][0][1]
    assert len(losses) == TRAIN["steps"] and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jax_out[f"{name}/loss"],
                               rtol=1e-3 if int8 else 1e-4)
    check_params_close(params, {k: jax_out[f"{name}/p/{k}"] for k in params},
                       int8=int8, steps=TRAIN["steps"])
    assert {"pos_embed", "enc_blocks/attn/wq", "blocks/l0/xattn/wv"} <= set(params)
    for k in params:  # the DP invariant
        np.testing.assert_array_equal(port[name][1][1][k], params[k], err_msg=k)
