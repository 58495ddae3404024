"""The decoder configs of the port's MoE slice — qwen3-1.7b, stablelm-12b,
nemotron-4-340b, chameleon-34b (dense), deepseek-moe-16b and
moonshot-v1-16b-a3b (experts) — and jamba-1.5-large-398b with its experts
(the hybrid + MoE composition, the registered smoke config rather than the
port's one-card cut), held against the JAX package.

Each config module equals its JAX original.  Each smoke model, with the
same numpy weights, matches the JAX model in fp32 at atol = rtol = 1e-4
(``tests/test_torch_model.py``'s tolerance) in prefill logits and cache,
in 8 decode steps, and in the greedy tokens of the JAX ``DecodeServer``.
The dense ones match the JAX training loss at rtol 1e-5
(``tests/test_torch_train_model.py``'s); training with experts raises."""
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, FP32, JAMBA, NEW_ARCHS,  # noqa: E402
                           jax_model, jax_params, port_model, smoke_weights,
                           to_numpy)

from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.runtime.serve_loop import DecodeServer as JaxDecodeServer  # noqa: E402
from repro.runtime.serve_loop import Request as JaxRequest  # noqa: E402
from repro.utils.jax_compat import make_mesh  # noqa: E402
from repro.utils.trees import tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import one_card_arch  # noqa: E402
from repro_torch.models import ModelSettings, build_model, count_params  # noqa: E402
from repro_torch.models.transformer import check_supported, check_trainable  # noqa: E402
from repro_torch.runtime.serve_loop import DecodeServer, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
DENSE = NEW_ARCHS[:4]
MOE = NEW_ARCHS[4:]
# (arch, with the registered experts): the six configs, and Jamba with its
# experts at offsets 1, 3, 5 and 7 of its one block
MODELS = [(name, False) for name in NEW_ARCHS] + [(JAMBA, True)]
IDS = [name + ("+experts" if ex else "") for name, ex in MODELS]


def _close(port, ref, **tol):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def weights():
    """The smoke model's flat tree for each (arch, experts), drawn once."""
    cache = {}

    def get(name, experts):
        if (name, experts) not in cache:
            cache[name, experts] = smoke_weights(seed=7, arch=name,
                                                 experts=experts)
        return cache[name, experts]
    return get


def _tokens(vocab, shape, seed=8):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_config_copy_equals_jax(name):
    """The file is the JAX package's, but for the import of ``base``; the
    registered full and smoke configs are field-for-field the reference."""
    module = name.replace("-", "_").replace(".", "_") + ".py"
    ours = (ROOT / "src/repro_torch/configs" / module).read_text()
    theirs = (ROOT / "src/repro/configs" / module).read_text()
    assert ours == theirs.replace("from repro.configs.base import",
                                  "from repro_torch.configs.base import")
    for getter in ("get_arch", "get_smoke_arch"):
        assert dataclasses.asdict(getattr(configs, getter)(name)) == \
            dataclasses.asdict(getattr(jax_configs, getter)(name))


def test_nemotron_one_card_cut_keeps_the_published_widths():
    """96 layers to 4, every width published: 23,253,553,152 parameters,
    the JAX count of the same cut (shapes only, on the meta device)."""
    arch, cuts = one_card_arch("nemotron-4-340b")
    full = configs.get_arch("nemotron-4-340b")
    assert cuts == ("n_layers: 96 -> 4",)
    assert arch == full.replace(n_layers=4)
    n = count_params(build_model(arch, ModelSettings(), device="meta"))
    assert n == 23_253_553_152 == jax_count_params(jax_build_model(
        jax_configs.get_arch("nemotron-4-340b").replace(n_layers=4)))
    smoke, cuts = one_card_arch("nemotron-4-340b", smoke=True)
    assert smoke == configs.get_smoke_arch("nemotron-4-340b") and cuts == ()
    for name in NEW_ARCHS[:-2] + MOE:
        if name != "nemotron-4-340b":
            assert one_card_arch(name) == (configs.get_arch(name), ())


@pytest.mark.parametrize("name,count", [("deepseek-moe-16b", 16_879_568_896),
                                        ("qwen3-1.7b", 1_720_574_976),
                                        ("stablelm-12b", 12_143_339_520)])
def test_full_width_param_count(name, count):
    """The registered full config, as the card builds it: the JAX count,
    and in bf16 every leaf but the fp32 router."""
    model = build_model(configs.get_arch(name), ModelSettings(), device="meta")
    assert count_params(model) == count == jax_count_params(
        jax_build_model(jax_configs.get_arch(name)))
    for path, p in model.named_parameters():
        assert p.dtype == (torch.float32 if path.endswith("moe.router")
                           else torch.bfloat16), path


@pytest.mark.parametrize("name,experts", MODELS, ids=IDS)
def test_param_tree_matches_jax(name, experts):
    """bf16 shapes and dtypes, leaf for leaf (the router fp32 in both)."""
    st = ModelSettings()
    model = build_model(configs.get_smoke_arch(name) if experts
                        else one_card_arch(name, smoke=True)[0], st, device="meta")
    jshapes = tree_paths(jax_model(dtype="bfloat16", arch=name,
                                   experts=experts).param_shapes())
    ours = {n.replace(".", "/"): (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for n, p in model.named_parameters()}
    assert ours == {k: (tuple(v.shape), str(v.dtype)) for k, v in jshapes.items()}


def test_supported_families():
    """Experts, hybrids with experts and the encoder-decoder are let
    through, learned positions on any family too; what still raises is
    fp32 parameters with a bf16 compute dtype (no reference)."""
    st = ModelSettings(**FP32)
    for name in MOE + (JAMBA,):
        check_supported(configs.get_arch(name), st)
    check_supported(configs.get_arch("whisper-medium"), st)
    check_trainable(configs.get_arch("whisper-medium"), st)
    check_supported(configs.get_arch(DEEPSEEK).replace(positional="learned"), st)
    with pytest.raises(NotImplementedError, match="no reference"):
        check_supported(configs.get_arch("whisper-medium"),
                        ModelSettings(param_dtype="float32", compute_dtype="bfloat16"))


# ---------------------------------------------------------------------------
# prefill, decode, served tokens against the JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,experts", MODELS, ids=IDS)
def test_prefill_matches_jax(weights, name, experts):
    """Last logits and every cache leaf; the kernel path (attention through
    K1's plain version on the CPU, the JAX ``pallas`` in interpret mode)
    and the masked one."""
    w = weights(name, experts)
    jm = jax_model(arch=name, experts=experts, attn_impl="pallas")
    toks = _tokens(512, (B, S))
    jlogits, jcache = jm.prefill(jax_params(w), jnp.asarray(toks))
    jflat = tree_paths(jcache)
    for impl in ("kernel", "masked"):
        logits, cache = port_model(w, arch=name, experts=experts,
                                   attn_impl=impl).prefill(torch.from_numpy(toks).long())
        _close(logits, jlogits)
        flat = tree_paths(cache)
        assert sorted(flat) == sorted(jflat)
        for path, leaf in flat.items():
            assert tuple(leaf.shape) == jflat[path].shape, path
            _close(leaf, jflat[path])


@pytest.mark.parametrize("name,experts", MODELS, ids=IDS)
def test_decode_steps_match_jax(weights, name, experts):
    """8 chained decode steps from an empty cache: logits and the cache
    after each."""
    w = weights(name, experts)
    jm = jax_model(arch=name, experts=experts)
    jp = jax_params(w)
    model = port_model(w, arch=name, experts=experts)
    jcache, cache = jm.init_cache(B, 12), model.init_cache(B, 12)
    toks = _tokens(512, (B, 8), seed=9)
    for t in range(8):
        tok = toks[:, t:t + 1]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long(), t)
        _close(logits, jlogits)
        jflat = tree_paths(jcache)
        for path, leaf in tree_paths(cache).items():
            _close(leaf, jflat[path])


@pytest.mark.parametrize("name,experts", MODELS, ids=IDS)
def test_greedy_tokens_match_jax_server(weights, name, experts):
    """tests/test_system.py's five continuous-batching requests on two
    slots: the same token ids, request for request (at two slots a MoE
    decode step routes T = 2 tokens at C = T, so nothing is dropped)."""
    w = weights(name, experts)
    jserver = JaxDecodeServer(jax_model(max_seq=64, arch=name, experts=experts),
                              make_mesh((1, 1), ("data", "model")),
                              batch_slots=2, max_seq=64)
    server = DecodeServer(port_model(w, arch=name, experts=experts,
                                     attn_impl="kernel", use_kernel_ssm=True),
                          "cpu", batch_slots=2, max_seq=64)
    for s, req in ((jserver, JaxRequest), (server, Request)):
        for i in range(5):
            s.submit(req(uid=i, prompt=np.array([1, 2, 3], np.int32), max_new=4))
    jouts = jserver.run(jax_params(w), max_steps=40)
    outs = server.run(max_steps=40)
    assert outs == jouts
    assert len(set(map(tuple, outs.values()))) > 1
    assert server.stats == {**jserver.stats, "wall": server.stats["wall"]}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_train_loss_matches_jax(weights, name):
    """The dense configs train through the existing path: the loss with
    the kernel attention (the JAX ``pallas``), remat full, two loss
    chunks."""
    w = weights(name, False)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jm = jax_model(arch=name, attn_impl="pallas", remat="full", loss_chunk=8)
    jloss = jm.loss(jax_params(w), {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(w, arch=name, attn_impl="kernel", remat="full", loss_chunk=8)
    loss = model.loss(model.params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("name,experts", [(n, False) for n in MOE] + [(JAMBA, True)],
                         ids=list(MOE) + [JAMBA + "+experts"])
def test_training_with_experts_raises(name, experts):
    """Training with experts is ported (``test_torch_train_families.py``
    holds it to JAX); only fp32 parameters with a bf16 compute dtype, which
    has no reference, still raise."""
    arch = configs.get_smoke_arch(name)
    assert arch.moe is not None
    for dt in ("float32", "bfloat16"):
        check_trainable(arch, ModelSettings(param_dtype="bfloat16", compute_dtype=dt))
    check_trainable(arch, ModelSettings(**FP32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_trainable(arch, ModelSettings(param_dtype="float32",
                                            compute_dtype="bfloat16"))
