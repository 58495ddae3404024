"""The port's hybrid model (the Mamba half of ``repro_torch.models.ssm`` and
the hybrid branch of ``repro_torch.models.transformer``) held against the
JAX package on the jamba-1.5-large-398b smoke config without experts (the
port's one-card cut), with the same numpy weights and inputs: fp32 at
1e-4, bf16 at 2e-2."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (FP32, JAMBA, jax_model, jax_params,  # noqa: E402
                           port_model, randn, smoke_archs, smoke_weights,
                           to_numpy)

from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import ModelSettings as JaxSettings  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.utils.trees import tree_paths  # noqa: E402
from repro_torch.configs import get_arch, get_smoke_arch, one_card_arch  # noqa: E402
from repro_torch.convert import numpy_to_torch  # noqa: E402
from repro_torch.models import ModelSettings, build_model, count_params  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.utils.trees import tree_from_paths  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 64
# every cache leaf of one Jamba block: Mamba at offsets 0-3 and 5-7,
# attention at offset 4
CACHE_LEAVES = sorted([f"l{o}/{n}" for o in (0, 1, 2, 3, 5, 6, 7)
                       for n in ("conv", "ssm")] + ["l4/k", "l4/v"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, bf16=False):
    """fp32: 1e-4.  bf16: the JAX tests' bf16 tolerance, 2e-2, with atol
    scaled by the tensor's largest magnitude, as in test_torch_rwkv.py:
    the two frameworks round bf16 at different places."""
    ref = np.asarray(ref, np.float32)
    tol = dict(atol=2e-2 * float(np.abs(ref).max()), rtol=2e-2) if bf16 else TOL
    np.testing.assert_allclose(np.asarray(to_numpy(port), np.float32), ref,
                               **tol)


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=3, arch=JAMBA)


@pytest.fixture(scope="module")
def tokens():
    arch = smoke_archs(JAMBA)[1]
    return np.random.default_rng(4).integers(0, arch.vocab, (B, S)).astype(np.int32)


def _mamba_params(weights, off=0):
    prefix = f"blocks/l{off}/mamba/"
    return {k[len(prefix):]: v[0] for k, v in weights.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the one-card cut and the layer pattern
# ---------------------------------------------------------------------------


def test_one_card_arch_keeps_the_published_widths():
    """Full width, one Jamba block, no experts; other archs unchanged."""
    full, cuts = one_card_arch(JAMBA)
    assert (full.n_layers, full.moe, full.d_model, full.d_ff, full.vocab) == (
        8, None, 8192, 24576, 65536)
    assert (full.mamba.d_state, full.mamba.expand,
            full.mamba.resolved_dt_rank(full.d_model)) == (16, 2, 512)
    assert len(cuts) == 2 and "72 -> 8" in cuts[0] and "none" in cuts[1]
    smoke, cuts = one_card_arch(JAMBA, smoke=True)
    assert smoke == get_smoke_arch(JAMBA).replace(moe=None) and len(cuts) == 1
    assert one_card_arch("qwen2-0.5b") == (get_arch("qwen2-0.5b"), ())
    assert T.group_size(full) == 8 and T.n_groups(full) == 1
    assert [T.layer_kind(full, i) for i in range(8)] == ["mamba"] * 4 + [
        "attn"] + ["mamba"] * 3


def test_jamba_with_experts_raises():
    """Jamba with its experts is served (tests/test_torch_configs.py holds
    it to JAX) and trained (tests/test_torch_train_families.py): MoE on
    the odd offsets of its 8-layer group, and a finite loss with a
    gradient for every leaf.  (The name is the refusals'.)  Its training
    settings all pass the check: MoE dispatch groups and a sequence split
    of its layers (``tests/test_torch_seq_parallel_families.py`` holds
    them to JAX)."""
    import dataclasses
    from repro_torch.models.transformer import check_trainable
    model = build_model(get_smoke_arch(JAMBA), ModelSettings(**FP32, remat="none"),
                        device="cpu")
    kids = [dict(getattr(model.blocks, f"l{off}").named_children())
            for off in range(8)]
    assert [("moe" in k) for k in kids] == [off % 2 == 1 for off in range(8)]
    check_trainable(model.arch, model.settings)
    params = model.params()
    leaves = [p.requires_grad_(True) for p in model.parameters()]
    toks = torch.randint(0, model.arch.vocab, (2, 16))
    loss = model.loss(params, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    for extra in (dict(moe_groups=2), dict(seq_axis="model"),
                  dict(seq_axis="model", batch_axes=("data",))):
        check_trainable(model.arch, dataclasses.replace(model.settings, **extra))


def test_full_width_param_count():
    """8,999,034,880 parameters at the published widths, the JAX count of
    the same cut (shapes only: the meta device allocates nothing)."""
    arch = one_card_arch(JAMBA)[0]
    tree = T.init_params(arch, torch.Generator(), ModelSettings(), "meta")
    n = sum(t.numel() for t in tree_paths(tree).values())
    jarch = smoke_archs(JAMBA)[0].replace(**{
        f: getattr(arch, f) for f in ("n_layers", "d_model", "n_heads",
                                      "n_kv_heads", "head_dim", "d_ff", "vocab")})
    jarch = jarch.replace(mamba=type(jarch.mamba)(d_state=16, d_conv=4, expand=2))
    assert n == 8_999_034_880 == jax_count_params(jax_build_model(jarch))


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_conv_matches_jax(weights, dtype):
    """The causal depthwise conv with left padding, in fp32 and bf16."""
    p = _mamba_params(weights)
    x = randn(5, B, 24, p["conv_w"].shape[1])
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    got = SSM._mamba_conv_train({k: _t(v).to(tdt) for k, v in p.items()},
                                _t(x).to(tdt))
    exp = JS._mamba_conv_train({k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
                               jnp.asarray(x).astype(jdt))
    assert got.dtype == tdt
    _close(got, exp, bf16=dtype == "bfloat16")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_states", [False, True])
def test_apply_mamba(weights, use_kernel, with_states):
    """Output, new conv state and new ssm state; ``use_kernel`` against the
    JAX ``use_pallas`` (the Pallas kernel in interpret mode)."""
    jarch, arch = smoke_archs(JAMBA)
    p = _mamba_params(weights, off=1)
    m, di = arch.mamba, arch.mamba.expand * arch.d_model
    x = randn(6, B, 32, arch.d_model)
    conv = randn(7, B, m.d_conv - 1, di) if with_states else None
    ssm = randn(8, B, di, m.d_state, scale=0.1) if with_states else None
    out, (nconv, nssm) = SSM.apply_mamba(
        arch, {k: _t(v) for k, v in p.items()}, _t(x),
        conv_state=None if conv is None else _t(conv),
        ssm_state=None if ssm is None else _t(ssm), use_kernel=use_kernel)
    jout, (jconv, jssm) = JS.apply_mamba(
        jarch, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        conv_state=None if conv is None else jnp.asarray(conv),
        ssm_state=None if ssm is None else jnp.asarray(ssm),
        use_pallas=use_kernel)
    _close(out, jout)
    _close(nconv, jconv)
    _close(nssm, jssm)


def test_mamba_scan_ref_model_layout_matches_jax():
    """The model-level oracle, with its zero default state."""
    u, dt = randn(9, B, 20, 32), np.logaddexp(randn(10, B, 20, 32) - 2, 0)
    A = -np.exp(randn(11, 32, 8) * 0.3)
    Bc, Cc, D = randn(12, B, 20, 8), randn(13, B, 20, 8), randn(14, 32)
    args = [a.astype(np.float32) for a in (u, dt, A, Bc, Cc, D)]
    y, hT = SSM.mamba_scan_ref(*map(_t, args))
    jy, jh = JS.mamba_scan_ref(*map(jnp.asarray, args))
    _close(y, jy)
    _close(hT, jh)


# ---------------------------------------------------------------------------
# parameters and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_jax(dtype):
    """Paths, shapes and dtypes: ``A_log`` and ``D`` stay fp32 in a bf16
    tree."""
    jm = jax_model(arch=JAMBA, dtype=dtype)
    model = build_model(smoke_archs(JAMBA)[1],
                        ModelSettings(param_dtype=dtype, compute_dtype=dtype),
                        device="cpu")
    jshapes = {k: (tuple(v.shape), np.dtype(v.dtype).name)
               for k, v in tree_paths(jm.param_shapes()).items()}
    assert {n.replace(".", "/"): (tuple(p.shape), str(p.dtype)[6:])
            for n, p in model.named_parameters()} == jshapes
    assert jshapes["blocks/l0/mamba/A_log"][1] == "float32"
    assert jshapes["blocks/l7/mamba/D"][1] == "float32"
    assert jshapes["blocks/l0/mamba/w_in"][1] == dtype
    assert "blocks/l4/attn/wq" in jshapes and "blocks/l4/mamba/D" not in jshapes
    assert count_params(model) == jax_count_params(jm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_params_round_trip(dtype):
    """Every leaf of the JAX init crosses bit for bit, the mixed-dtype
    leaves included."""
    flat = {k: np.asarray(v) for k, v in tree_paths(
        jax_model(dtype=dtype, arch=JAMBA).init(jax.random.key(0))).items()}
    model = port_model(flat, dtype=dtype, arch=JAMBA)
    tree = tree_paths(model.params())
    assert sorted(tree) == sorted(flat)
    for path, leaf in flat.items():
        got = to_numpy(tree[path])
        assert got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8),
                                      err_msg=path)


def test_init_matches_jax_init_values():
    """The deterministic leaves of ``init_mamba``: A_log = log(1..ds) on
    every channel, D = 1, dt_bias = softplus^-1(~0.018)."""
    flat = {k: np.asarray(v) for k, v in tree_paths(
        jax_model(arch=JAMBA).init(jax.random.key(0))).items()}
    own = tree_paths(build_model(smoke_archs(JAMBA)[1], ModelSettings(**FP32),
                                 device="cpu").params())
    for leaf in ("A_log", "D", "dt_bias", "conv_b"):
        path = f"blocks/l2/mamba/{leaf}"
        np.testing.assert_array_equal(to_numpy(own[path]), flat[path])


# ---------------------------------------------------------------------------
# prefill / decode against the JAX model
# ---------------------------------------------------------------------------


def _check_cache(cache, jcache, bf16=False, leaves=CACHE_LEAVES):
    jflat, flat = tree_paths(jcache), tree_paths(cache)
    assert sorted(flat) == sorted(jflat) == leaves
    for path in flat:
        assert tuple(flat[path].shape) == jflat[path].shape, path
        assert to_numpy(flat[path]).dtype == jflat[path].dtype, path
        _close(flat[path], jflat[path], bf16=bf16)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_matches_jax(weights, tokens, use_kernel):
    """Last logits and every cache leaf at S = 64; the kernel impls
    (``use_kernel_ssm``, attention ``kernel``) against the JAX Pallas
    Mamba path (``use_pallas_ssm``)."""
    jm = jax_model(arch=JAMBA, use_pallas_ssm=use_kernel)
    jlogits, jcache = jm.prefill(jax_params(weights), jnp.asarray(tokens))
    model = port_model(weights, arch=JAMBA, use_kernel_ssm=use_kernel,
                       attn_impl="kernel" if use_kernel else "masked")
    logits, cache = model.prefill(torch.from_numpy(tokens).long())
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert tuple(cache["l0"]["ssm"].shape) == (1, B, 128, 4)
    assert tuple(cache["l0"]["conv"].shape) == (1, B, 3, 128)


def test_prefill_ragged_seq_matches_jax(weights):
    """S = 100 divides by no chunk: the JAX Pallas Mamba path asserts there
    (ROADMAP queue 3), so the port's kernel impl is held against the JAX
    sequential path."""
    toks = np.random.default_rng(5).integers(0, 512, (B, 100)).astype(np.int32)
    jlogits, jcache = jax_model(arch=JAMBA, max_seq=128).prefill(
        jax_params(weights), jnp.asarray(toks))
    model = port_model(weights, arch=JAMBA, use_kernel_ssm=True,
                       attn_impl="kernel")
    logits, cache = model.prefill(torch.from_numpy(toks).long())
    _close(logits, jlogits)
    _check_cache(cache, jcache)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_steps_match_jax(weights, tokens, use_kernel):
    """Three chained decode steps: logits and the whole cache after each."""
    jm = jax_model(arch=JAMBA, use_pallas_ssm=use_kernel)
    jp = jax_params(weights)
    model = port_model(weights, arch=JAMBA, use_kernel_ssm=use_kernel)
    jcache, cache = jm.init_cache(B, 8), model.init_cache(B, 8)
    _check_cache(cache, jcache)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long(), t)
        _close(logits, jlogits)
        _check_cache(cache, jcache)


def test_decode_writes_states_in_place(weights, tokens):
    model = port_model(weights, arch=JAMBA, use_kernel_ssm=True)
    cache = model.init_cache(B, 8)
    before = {p: t.data_ptr() for p, t in tree_paths(cache).items()}
    _, out = model.decode_step(cache, torch.from_numpy(tokens[:, :1]).long(), 0)
    assert out is cache
    assert {p: t.data_ptr() for p, t in tree_paths(cache).items()} == before
    assert all(t.abs().sum() > 0 for t in tree_paths(cache).values())


def test_prefill_decode_consistency(weights, tokens):
    """logits from prefill(t[0:16]) match 16 decode steps (the tolerance of
    tests/test_models_smoke.py::test_prefill_decode_consistency), and so do
    the final conv and ssm states."""
    model = port_model(weights, arch=JAMBA, use_kernel_ssm=True,
                       attn_impl="kernel")
    toks = torch.from_numpy(tokens[:, :16]).long()
    pre_logits, pre_cache = model.prefill(toks)
    cache = model.init_cache(B, 17)
    for t in range(16):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits, pre_logits, atol=2e-3, rtol=2e-3)
    for off in ("l0", "l3", "l7"):
        for name in ("conv", "ssm"):
            torch.testing.assert_close(cache[off][name], pre_cache[off][name],
                                       atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_two_groups_match_jax(tokens, use_kernel):
    """16 layers, G = 2 groups of one Jamba block each: prefill and two
    decode steps, every cache leaf stacked over both groups."""
    flat = smoke_weights(seed=6, arch=JAMBA, n_layers=16)
    jm = jax_model(arch=JAMBA, n_layers=16, use_pallas_ssm=use_kernel)
    jp = jax_params(flat)
    model = port_model(flat, arch=JAMBA, n_layers=16, use_kernel_ssm=use_kernel)
    assert T.n_groups(model.arch) == 2
    jlogits, jcache = jm.prefill(jp, jnp.asarray(tokens))
    logits, cache = model.prefill(torch.from_numpy(tokens).long())
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert cache["l4"]["k"].shape[0] == 2
    jcache, cache = jm.init_cache(B, 4), model.init_cache(B, 4)
    for t in range(2):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long(), t)
        _close(logits, jlogits)
        _check_cache(cache, jcache)


@pytest.fixture(scope="module")
def weights_bf16():
    return smoke_weights(seed=3, dtype="bfloat16", arch=JAMBA)


@pytest.mark.parametrize("off", range(8))
def test_layer_bf16_matches_jax(weights_bf16, off):
    """Each layer of the block in bf16 (A_log and D fp32), on the same bf16
    input, against the JAX layer at the JAX tests' bf16 tolerance: the
    output and the layer's cache; the kernel impls against the JAX Pallas
    Mamba path."""
    jarch, arch = smoke_archs(JAMBA)
    prefix = f"blocks/l{off}/"
    p = {k[len(prefix):]: v[0] for k, v in weights_bf16.items()
         if k.startswith(prefix)}
    x = randn(20 + off, B, S, arch.d_model)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jout, _, jcache = JT._apply_layer(
        jarch, jax_params(p), jx, jnp.arange(S)[None].repeat(B, 0), "prefill",
        None, JaxSettings(use_pallas_ssm=True), off)
    out, _, cache = T._apply_layer(
        arch, tree_from_paths({k: numpy_to_torch(v) for k, v in p.items()}),
        numpy_to_torch(np.asarray(jx)), torch.arange(S)[None].expand(B, S),
        ModelSettings(use_kernel_ssm=True, attn_impl="kernel"), off)
    assert out.dtype == torch.bfloat16
    _close(out, jout, bf16=True)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert to_numpy(cache[name]).dtype == jcache[name].dtype
        _close(cache[name], jcache[name], bf16=True)


def test_prefill_bf16_as_accurate_as_jax(weights_bf16, tokens):
    """The whole bf16 prefill.  Through 8 random layers bf16 rounding alone
    moves the JAX logits ~2.5 % of their range away from the fp32 logits of
    the same weights, past the per-op 2e-2, and the two frameworks round at
    different places.  So the port's bf16 logits are held to the fp32
    logits, at most 1.5 times as far from them as JAX's bf16 logits are."""
    flat32 = {k: np.asarray(v, np.float32) for k, v in weights_bf16.items()}
    exact, _ = jax_model(arch=JAMBA).prefill(jax_params(flat32), jnp.asarray(tokens))
    exact = np.asarray(exact)
    jlogits, _ = jax_model(dtype="bfloat16", arch=JAMBA, use_pallas_ssm=True
                           ).prefill(jax_params(weights_bf16), jnp.asarray(tokens))
    model = port_model(weights_bf16, dtype="bfloat16", arch=JAMBA,
                       use_kernel_ssm=True, attn_impl="kernel")
    logits, cache = model.prefill(torch.from_numpy(tokens).long())
    assert cache["l0"]["conv"].dtype == torch.bfloat16
    assert cache["l0"]["ssm"].dtype == torch.float32
    jax_err = np.abs(np.asarray(jlogits, np.float32) - exact).max()
    port_err = np.abs(logits.numpy() - exact).max()
    assert 0 < port_err <= 1.5 * jax_err
