"""The port's dense model (``repro_torch.models``) and weight bridge
(``repro_torch.convert``) held against the JAX package on the qwen2-0.5b
smoke config, in fp32, with the same numpy weights and inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (ARCH, FP32, jax_model, jax_params,  # noqa: E402
                           port_model, randn, smoke_weights, to_numpy)

from repro.configs import get_smoke_arch as jax_smoke_arch  # noqa: E402
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.utils.trees import tree_paths  # noqa: E402
from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.models import ModelSettings, build_model, count_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=3)


@pytest.fixture(scope="module")
def tokens():
    arch = get_smoke_arch(ARCH)
    return np.random.default_rng(4).integers(0, arch.vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jarch = jax_smoke_arch(ARCH).replace(norm=norm)
    arch = get_smoke_arch(ARCH).replace(norm=norm)
    x = randn(0, B, S, arch.d_model)
    p = {"scale": 1 + randn(1, arch.d_model, scale=0.1),
         "bias": randn(2, arch.d_model, scale=0.1)}
    _close(L.apply_norm(arch, {k: _t(v) for k, v in p.items()}, _t(x)),
           JL.apply_norm(jarch, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))


def test_apply_rope():
    arch = get_smoke_arch(ARCH)
    x = randn(5, B, S, arch.n_heads, arch.resolved_head_dim)
    pos = np.tile(np.arange(S, dtype=np.int32) * 37, (B, 1))  # large angles
    _close(L.apply_rope(_t(x), _t(pos), arch.rope_theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), arch.rope_theta))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_qkv(weights, qk_norm):
    """QKV bias (redrawn, so non-zero) plus, optionally, qk-norm."""
    jarch = jax_smoke_arch(ARCH).replace(qk_norm=qk_norm)
    arch = get_smoke_arch(ARCH).replace(qk_norm=qk_norm)
    p = {k.split("/")[-1]: v[0] for k, v in weights.items()
         if k.startswith("blocks/l0/attn/")}
    hd = arch.resolved_head_dim
    p["q_norm"] = 1 + randn(6, hd, scale=0.1)
    p["k_norm"] = 1 + randn(7, hd, scale=0.1)
    assert np.abs(p["bq"]).max() > 0
    x = randn(8, B, S, arch.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    out = L.attention_qkv(arch, {k: _t(v) for k, v in p.items()}, _t(x), _t(pos))
    exp = JL.attention_qkv(jarch, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(pos))
    for o, e in zip(out, exp):
        _close(o, e)


@pytest.mark.parametrize("activation,glu", [("silu", True), ("gelu", False),
                                            ("relu2", True)])
def test_apply_mlp(weights, activation, glu):
    jarch = jax_smoke_arch(ARCH).replace(activation=activation, glu=glu)
    arch = get_smoke_arch(ARCH).replace(activation=activation, glu=glu)
    p = {k.split("/")[-1]: v[0] for k, v in weights.items()
         if k.startswith("blocks/l0/mlp/")}
    x = randn(9, B, S, arch.d_model)
    _close(L.apply_mlp(arch, {k: _t(v) for k, v in p.items()}, _t(x)),
           JL.apply_mlp(jarch, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


@pytest.mark.parametrize("causal", [True, False])
def test_attend_masked_chunked(causal):
    """Several q and kv chunks, so the online-softmax merge runs."""
    q, k, v = randn(10, B, 32, 4, 16), randn(11, B, 32, 2, 16), randn(12, B, 32, 2, 16)
    out = L.attend(_t(q), _t(k), _t(v), causal=causal, impl="masked",
                   q_chunk=8, kv_chunk=16)
    exp = JL.attend(*map(jnp.asarray, (q, k, v)), causal=causal,
                    impl="masked", q_chunk=8, kv_chunk=16)
    _close(out, exp, atol=1e-5, rtol=1e-5)


def test_attend_kernel_impl_matches_masked():
    q, k, v = randn(13, B, 32, 4, 16), randn(14, B, 32, 2, 16), randn(15, B, 32, 2, 16)
    a = L.attend(_t(q), _t(k), _t(v), causal=True, impl="kernel")
    b = L.attend(_t(q), _t(k), _t(v), causal=True, impl="masked", q_chunk=8,
                 kv_chunk=8)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.attend(_t(q), _t(k), _t(v), causal=True, impl="tri")
    with pytest.raises(ValueError, match="pallas"):
        L.attend(_t(q), _t(k), _t(v), causal=True, impl="pallas")


def test_attend_decode():
    q = randn(16, B, 1, 4, 16)
    kc, vc = randn(17, B, 24, 2, 16), randn(18, B, 24, 2, 16)
    lens = np.array([5, 24], np.int32)
    _close(L.attend_decode(_t(q), _t(kc), _t(vc), _t(lens)),
           JL.attend_decode(*map(jnp.asarray, (q, kc, vc, lens))),
           atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# parameters and the weight bridge
# ---------------------------------------------------------------------------


def test_param_tree_matches_jax():
    jm = jax_model()
    model = build_model(get_smoke_arch(ARCH), ModelSettings(**FP32), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in
              tree_paths(jm.param_shapes()).items()}
    assert {n.replace(".", "/"): tuple(p.shape)
            for n, p in model.named_parameters()} == shapes
    assert count_params(model) == jax_count_params(jm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_params_round_trip(dtype):
    """Every leaf of the JAX init crosses bit for bit, bf16 included."""
    flat = {k: np.asarray(v) for k, v in
            tree_paths(jax_model(dtype=dtype).init(jax.random.key(0))).items()}
    model = port_model(flat, dtype=dtype)
    tree = tree_paths(model.params())
    assert sorted(tree) == sorted(flat)
    for path, leaf in flat.items():
        got = to_numpy(tree[path])
        assert got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8),
                                      err_msg=path)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_load_jax_params_rejects(weights, fault):
    flat = dict(weights)
    if fault == "missing":
        flat.pop("blocks/l0/attn/bq")
    elif fault == "extra":
        flat["blocks/l0/attn/q_norm"] = np.ones((2, 16), np.float32)
    elif fault == "shape":
        flat["final_norm/scale"] = np.ones((65,), np.float32)
    else:
        flat["embed"] = flat["embed"].astype(np.float64)
    model = build_model(get_smoke_arch(ARCH), ModelSettings(**FP32), device="cpu")
    before = model.embed.clone()
    with pytest.raises(KeyError if fault in ("missing", "extra") else ValueError):
        load_jax_params(model, flat)
    assert torch.equal(model.embed, before)  # nothing copied


def test_unported_family_raises():
    moe = get_smoke_arch(ARCH).replace(family="moe")
    from repro_torch.configs.base import MoEConfig
    moe = moe.replace(moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=32))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(moe, ModelSettings(**FP32), device="cpu")


# ---------------------------------------------------------------------------
# prefill / decode against the JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_impl,port_impl", [("pallas", "kernel"),
                                                ("masked", "masked")])
def test_prefill_matches_jax(weights, tokens, jax_impl, port_impl):
    """Last logits and the whole stacked KV cache."""
    jm = jax_model(attn_impl=jax_impl)
    jlogits, jcache = jm.prefill(jax_params(weights), jnp.asarray(tokens))
    logits, cache = port_model(weights, attn_impl=port_impl).prefill(
        torch.from_numpy(tokens).long())
    _close(logits, jlogits)
    jflat, flat = tree_paths(jcache), tree_paths(cache)
    assert sorted(flat) == sorted(jflat) == ["l0/k", "l0/v"]
    for path in flat:
        assert tuple(flat[path].shape) == jflat[path].shape == (2, B, S, 2, 16)
        _close(flat[path], jflat[path])


def test_decode_steps_match_jax(weights, tokens):
    """Two chained decode steps: logits and cache after each."""
    jm = jax_model()
    jp = jax_params(weights)
    model = port_model(weights)
    jcache, cache = jm.init_cache(B, 8), model.init_cache(B, 8)
    for t in range(2):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long(), t)
        _close(logits, jlogits)
        for path, leaf in tree_paths(cache).items():
            _close(leaf, tree_paths(jcache)[path])


def test_prefill_decode_consistency(weights, tokens):
    """logits from prefill(t[0:S]) match S decode steps (the tolerance of
    tests/test_models_smoke.py::test_prefill_decode_consistency)."""
    model = port_model(weights, attn_impl="kernel")
    toks = torch.from_numpy(tokens).long()
    pre_logits, pre_cache = model.prefill(toks)
    cache = model.init_cache(B, S + 1)
    for t in range(S):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits, pre_logits, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(cache["l0"]["k"][:, :, :S], pre_cache["l0"]["k"],
                               atol=2e-3, rtol=2e-3)
