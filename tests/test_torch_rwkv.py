"""The port's RWKV6 model (``repro_torch.models.ssm`` and the rwkv branch of
``repro_torch.models.transformer``) held against the JAX package on the
rwkv6-1.6b smoke config, with the same numpy weights and inputs: fp32 at
1e-4, bf16 at 2e-2."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (FP32, RWKV, jax_model, jax_params,  # noqa: E402
                           port_model, randn, smoke_weights, to_numpy)

from repro.configs import get_smoke_arch as jax_smoke_arch  # noqa: E402
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.utils.trees import tree_paths  # noqa: E402
from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.configs.base import MambaConfig  # noqa: E402
from repro_torch.models import ModelSettings, build_model, count_params  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, bf16=False):
    """fp32: 1e-4.  bf16: the JAX tests' bf16 tolerance, 2e-2, with atol
    scaled by the tensor's largest magnitude: the two frameworks round bf16
    at different places (XLA keeps a fused elementwise chain in fp32,
    eager PyTorch rounds after every op), so an element near zero is off
    by a few bf16 ulps of the tensor's scale, not of its own."""
    ref = np.asarray(ref, np.float32)
    tol = dict(atol=2e-2 * float(np.abs(ref).max()), rtol=2e-2) if bf16 else TOL
    np.testing.assert_allclose(np.asarray(to_numpy(port), np.float32), ref,
                               **tol)


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=3, arch=RWKV)


@pytest.fixture(scope="module")
def tokens():
    arch = get_smoke_arch(RWKV)
    return np.random.default_rng(4).integers(0, arch.vocab, (B, S)).astype(np.int32)


def _layer_params(weights, block):
    """One layer's ``block`` ('tmix', 'cmix') leaves, as numpy."""
    prefix = f"blocks/l0/{block}/"
    return {k[len(prefix):]: v[0] for k, v in weights.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_states", [False, True])
def test_apply_rwkv_time_mix(weights, use_kernel, with_states):
    """Output, new shift and new wkv state; ``use_kernel`` against the JAX
    ``use_pallas`` (the Pallas kernel in interpret mode)."""
    arch, jarch = get_smoke_arch(RWKV), jax_smoke_arch(RWKV)
    p = _layer_params(weights, "tmix")
    H, hd = arch.d_model // arch.rwkv.head_size, arch.rwkv.head_size
    x = randn(5, B, S, arch.d_model)
    shift = randn(6, B, arch.d_model) if with_states else None
    wkv = randn(7, B, H, hd, hd, scale=0.1) if with_states else None
    out, (nshift, nwkv) = SSM.apply_rwkv_time_mix(
        arch, {k: _t(v) for k, v in p.items()}, _t(x),
        shift_state=None if shift is None else _t(shift),
        wkv_state=None if wkv is None else _t(wkv), use_kernel=use_kernel)
    jout, (jshift, jwkv) = JS.apply_rwkv_time_mix(
        jarch, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        shift_state=None if shift is None else jnp.asarray(shift),
        wkv_state=None if wkv is None else jnp.asarray(wkv),
        use_pallas=use_kernel)
    _close(out, jout)
    _close(nshift, jshift)
    _close(nwkv, jwkv)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rwkv_channel_mix(weights, with_state):
    """Squared relu, whatever ``arch.activation`` says."""
    arch = get_smoke_arch(RWKV).replace(activation="silu")
    jarch = jax_smoke_arch(RWKV).replace(activation="silu")
    p = _layer_params(weights, "cmix")
    x = randn(8, B, S, arch.d_model)
    shift = randn(9, B, arch.d_model) if with_state else None
    out, nshift = SSM.apply_rwkv_channel_mix(
        arch, {k: _t(v) for k, v in p.items()}, _t(x),
        shift_state=None if shift is None else _t(shift))
    jout, jshift = JS.apply_rwkv_channel_mix(
        jarch, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        shift_state=None if shift is None else jnp.asarray(shift))
    _close(out, jout)
    _close(nshift, jshift)


def test_wkv_groupnorm_population_variance(weights):
    """A head of 16 values with a large mean and a small spread: the
    unbiased variance would miss by 16/15."""
    arch = get_smoke_arch(RWKV)
    p = _layer_params(weights, "tmix")
    H, hd = arch.d_model // arch.rwkv.head_size, arch.rwkv.head_size
    y = 3.0 + randn(10, B, S, H, hd, scale=0.05)
    out = SSM._wkv_groupnorm(arch, {k: _t(v) for k, v in p.items()}, _t(y))
    exp = JS._wkv_groupnorm(jax_smoke_arch(RWKV),
                            {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(y))
    assert out.shape == (B, S, arch.d_model) and out.dtype == torch.float32
    _close(out, exp)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_scan_ref_matches_jax(with_state):
    H, hd = 3, 16
    r, k, v = (randn(11 + i, B, 24, H, hd) for i in range(3))
    w = np.exp(-np.exp(randn(14, B, 24, H, hd) * 0.5)).astype(np.float32)
    u = randn(15, H, hd, scale=0.1)
    state = randn(16, B, H, hd, hd, scale=0.1) if with_state else None
    y, sT = SSM.wkv6_scan_ref(*map(_t, (r, k, v, w, u)),
                              None if state is None else _t(state))
    jy, js = JS.wkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u)),
                              None if state is None else jnp.asarray(state))
    _close(y, jy)
    _close(sT, js)


# ---------------------------------------------------------------------------
# parameters and the weight bridge
# ---------------------------------------------------------------------------


def test_param_tree_matches_jax():
    jm = jax_model(arch=RWKV)
    model = build_model(get_smoke_arch(RWKV), ModelSettings(**FP32), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in
              tree_paths(jm.param_shapes()).items()}
    assert {n.replace(".", "/"): tuple(p.shape)
            for n, p in model.named_parameters()} == shapes
    assert "blocks/l0/tmix/u" in shapes and "lm_head" in shapes
    assert count_params(model) == jax_count_params(jm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_params_round_trip(dtype):
    """Every leaf of the JAX init crosses bit for bit, bf16 included."""
    flat = {k: np.asarray(v) for k, v in tree_paths(
        jax_model(dtype=dtype, arch=RWKV).init(jax.random.key(0))).items()}
    model = port_model(flat, dtype=dtype, arch=RWKV)
    tree = tree_paths(model.params())
    assert sorted(tree) == sorted(flat)
    for path, leaf in flat.items():
        got = to_numpy(tree[path])
        assert got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8),
                                      err_msg=path)


def test_hybrid_still_raises():
    """RWKV and Mamba hybrids, with or without experts, are let through for
    serving and for training: a hybrid with experts (Jamba as published,
    MoE every 2nd layer) included, under either step, with MoE dispatch
    groups under the GSPMD step too, and with a sequence split of RWKV6 or
    hybrid layers (the name is the refusal's, which that split was)."""
    from repro_torch.models.transformer import check_trainable
    jamba = get_smoke_arch("jamba-1.5-large-398b")
    assert jamba.is_hybrid and jamba.moe is not None
    assert count_params(build_model(jamba, ModelSettings(**FP32),
                                    device="cpu")) > 0
    check_trainable(jamba, ModelSettings(**FP32))
    check_trainable(get_smoke_arch("rwkv6-1.6b"), ModelSettings(**FP32))
    check_trainable(jamba, ModelSettings(**FP32, moe_groups=2))
    for arch in (jamba, get_smoke_arch("rwkv6-1.6b")):
        check_trainable(arch, ModelSettings(**FP32, seq_axis="model"))
    hybrid = get_smoke_arch("qwen2-0.5b").replace(mamba=MambaConfig(d_state=4),
                                                  attn_every=2)
    assert count_params(build_model(hybrid, ModelSettings(**FP32),
                                    device="cpu")) > 0


# ---------------------------------------------------------------------------
# prefill / decode against the JAX model
# ---------------------------------------------------------------------------


def _check_cache(cache, jcache, bf16=False):
    jflat, flat = tree_paths(jcache), tree_paths(cache)
    assert sorted(flat) == sorted(jflat) == ["l0/cshift", "l0/tshift", "l0/wkv"]
    for path in flat:
        assert tuple(flat[path].shape) == jflat[path].shape
        _close(flat[path], jflat[path], bf16=bf16)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(weights, tokens, use_kernel):
    """Last logits and the whole stacked tshift / wkv / cshift cache; the
    kernel impl against the JAX Pallas path."""
    jm = jax_model(arch=RWKV, use_pallas_ssm=use_kernel)
    jlogits, jcache = jm.prefill(jax_params(weights), jnp.asarray(tokens))
    model = port_model(weights, arch=RWKV, use_kernel_ssm=use_kernel)
    logits, cache = model.prefill(torch.from_numpy(tokens).long())
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert tuple(cache["l0"]["wkv"].shape) == (2, B, 4, 16, 16)
    assert cache["l0"]["wkv"].dtype == torch.float32


def test_prefill_ragged_seq_matches_jax(weights):
    """S = 40 divides by no chunk: the JAX Pallas path asserts there, so
    the port's kernel impl is held against the JAX sequential path."""
    toks = np.random.default_rng(5).integers(0, 512, (B, 40)).astype(np.int32)
    jlogits, jcache = jax_model(arch=RWKV).prefill(jax_params(weights),
                                                   jnp.asarray(toks))
    model = port_model(weights, arch=RWKV, use_kernel_ssm=True)
    logits, cache = model.prefill(torch.from_numpy(toks).long())
    _close(logits, jlogits)
    _check_cache(cache, jcache)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_steps_match_jax(weights, tokens, use_kernel):
    """Two chained decode steps: logits and the whole cache after each."""
    jm = jax_model(arch=RWKV, use_pallas_ssm=use_kernel)
    jp = jax_params(weights)
    model = port_model(weights, arch=RWKV, use_kernel_ssm=use_kernel)
    jcache, cache = jm.init_cache(B, 8), model.init_cache(B, 8)
    for t in range(2):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long(), t)
        _close(logits, jlogits)
        _check_cache(cache, jcache)


def test_decode_writes_states_in_place(weights, tokens):
    """The cache tensors are written where they lie, and the shifts are
    copies, not views of the step's activations."""
    model = port_model(weights, arch=RWKV, use_kernel_ssm=True)
    cache = model.init_cache(B, 8)
    before = {k: v.data_ptr() for k, v in cache["l0"].items()}
    _, out = model.decode_step(cache, torch.from_numpy(tokens[:, :1]).long(), 0)
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache["l0"].items()} == before
    assert all(v.abs().sum() > 0 for v in cache["l0"].values())


def test_prefill_decode_consistency(weights, tokens):
    """logits from prefill(t[0:S]) match S decode steps (the tolerance of
    tests/test_models_smoke.py::test_prefill_decode_consistency), and so
    do the final states."""
    model = port_model(weights, arch=RWKV, use_kernel_ssm=True)
    toks = torch.from_numpy(tokens).long()
    pre_logits, pre_cache = model.prefill(toks)
    cache = model.init_cache(B, S + 1)
    for t in range(S):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits, pre_logits, atol=2e-3, rtol=2e-3)
    for name in ("tshift", "wkv", "cshift"):
        torch.testing.assert_close(cache["l0"][name], pre_cache["l0"][name],
                                   atol=2e-3, rtol=2e-3)


def test_prefill_bf16_matches_jax(tokens):
    """bf16 weights and compute against the JAX bf16 model, at the JAX
    tests' bf16 tolerance."""
    flat = smoke_weights(seed=3, dtype="bfloat16", arch=RWKV)
    jm = jax_model(dtype="bfloat16", arch=RWKV, use_pallas_ssm=True)
    jlogits, jcache = jm.prefill(jax_params(flat), jnp.asarray(tokens))
    model = port_model(flat, dtype="bfloat16", arch=RWKV, use_kernel_ssm=True)
    logits, cache = model.prefill(torch.from_numpy(tokens).long())
    assert cache["l0"]["tshift"].dtype == torch.bfloat16
    _close(logits, jlogits, bf16=True)
    _check_cache(cache, jcache, bf16=True)


def test_settings_twin_jax_defaults():
    """``use_kernel_ssm`` is the twin of ``use_pallas_ssm``, off by default."""
    from repro.models import ModelSettings as JaxSettings
    assert ModelSettings().use_kernel_ssm is JaxSettings().use_pallas_ssm is False
