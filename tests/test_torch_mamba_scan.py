"""The port's Mamba selective scan (``repro_torch.kernels.mamba_scan``) held
against the JAX package's kernel (interpret mode) and oracle, at the JAX
test's tolerance (rtol = atol = 1e-4).

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import randn  # noqa: E402

from repro.kernels.mamba_scan import ops as jax_ops  # noqa: E402
from repro.kernels.mamba_scan.kernel import mamba_scan_fwd as jax_scan  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402

# the sweep of tests/test_kernels.py::test_mamba_scan: B, S, di, ds, chunk, bd
SWEEP = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 4, 64, 32), (2, 32, 16, 16, 32, 16)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _inputs(seed, B, S, di, ds):
    """u, dt, A, Bc, Cc, D, h0 as numpy, drawn as the JAX test draws them."""
    u = randn(seed, B, S, di)
    dt = _softplus(randn(seed + 1, B, S, di) - 2)
    A = -np.exp(randn(seed + 2, di, ds) * 0.3).astype(np.float32)
    Bc, Cc = randn(seed + 3, B, S, ds), randn(seed + 4, B, S, ds)
    D = np.ones((di,), np.float32)
    h0 = randn(seed + 5, B, di, ds, scale=0.1)
    return u, dt, A, Bc, Cc, D, h0


def _port(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, exp):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), **TOL)


@pytest.mark.parametrize("B,S,di,ds,chunk,bd", SWEEP)
def test_mamba_scan_ref_matches_jax(B, S, di, ds, chunk, bd):
    """The port's ref and ``ops`` (CPU) against the JAX oracle and the
    Pallas kernel in interpret mode."""
    arrs = _inputs(0, B, S, di, ds)
    y, hT = mamba_scan_ref(*_port(arrs))
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (B, S, di) and hT.shape == (B, di, ds)
    yo, ho = ops.mamba_scan(*_port(arrs[:6]), state=torch.from_numpy(arrs[6]))
    jarrs = [jnp.asarray(a) for a in arrs]
    for jy, jh in (jax_ref(*jarrs),
                   jax_scan(*jarrs, chunk=chunk, block_d=bd, interpret=True)):
        for got_y, got_h in ((y, hT), (yo, ho)):
            _close(got_y.numpy(), jy)
            _close(got_h.numpy(), jh)


@pytest.mark.parametrize("S", [1, 100, 333])
def test_mamba_scan_single_step_and_ragged(S):
    """S = 1 (a decode step) and S that divides by no chunk: the port's
    contract takes any S (the Pallas kernel asserts S % chunk == 0, so a
    ragged S is held against the JAX oracle only)."""
    arrs = _inputs(10, 2, S, 48, 16)
    y, hT = ops.mamba_scan(*_port(arrs[:6]), state=torch.from_numpy(arrs[6]))
    jy, jh = jax_ref(*(jnp.asarray(a) for a in arrs))
    _close(y.numpy(), jy)
    _close(hT.numpy(), jh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ops_model_layout_matches_jax(dtype, with_state):
    """``ops.mamba_scan`` against the JAX ``ops.mamba_scan`` (which runs
    the Pallas kernel in interpret mode), u/dt/B/C in ``dtype``; the state
    defaults to zeros in both."""
    u, dt, A, Bc, Cc, D, h0 = _inputs(20, 2, 64, 32, 8)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    state = h0 if with_state else None
    y, hT = ops.mamba_scan(*(torch.from_numpy(a).to(tdt) for a in (u, dt)),
                           torch.from_numpy(A),
                           *(torch.from_numpy(a).to(tdt) for a in (Bc, Cc)),
                           torch.from_numpy(D),
                           None if state is None else torch.from_numpy(state))
    jy, jh = jax_ops.mamba_scan(*(jnp.asarray(a).astype(jdt) for a in (u, dt)),
                                jnp.asarray(A),
                                *(jnp.asarray(a).astype(jdt) for a in (Bc, Cc)),
                                jnp.asarray(D),
                                None if state is None else jnp.asarray(state))
    assert y.shape == (2, 64, 32) and y.dtype == torch.float32
    _close(y.numpy(), jy)
    _close(hT.numpy(), jh)


def test_strided_b_c_slices_match_contiguous():
    """B and C as the model hands them in: column slices of one
    (B, S, dt_rank + 2 ds) projection, not copies."""
    B, S, di, ds, dtr = 2, 40, 32, 16, 8
    u, dt, A, _, _, D, h0 = _inputs(30, B, S, di, ds)
    xdbl = torch.from_numpy(randn(36, B, S, dtr + 2 * ds))
    Bc, Cc = xdbl[..., dtr:dtr + ds], xdbl[..., dtr + ds:]
    assert not Bc.is_contiguous() and Bc.stride(-1) == 1
    y, hT = ops.mamba_scan(torch.from_numpy(u), torch.from_numpy(dt),
                           torch.from_numpy(A), Bc, Cc, torch.from_numpy(D),
                           torch.from_numpy(h0))
    jy, jh = jax_ref(*(jnp.asarray(a) for a in (u, dt, A)),
                     jnp.asarray(Bc.contiguous().numpy()),
                     jnp.asarray(Cc.contiguous().numpy()),
                     jnp.asarray(D), jnp.asarray(h0))
    _close(y.numpy(), jy)
    _close(hT.numpy(), jh)


def test_kernel_takes_cuda_tensors_only():
    args = _port(_inputs(40, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.mamba_scan_fwd(*args)


def test_non_cpu_tensor_never_reaches_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises; it does not
    fall back to ``mamba_scan_ref`` (which would accept meta tensors)."""
    seq = torch.zeros(1, 4, 16, device="meta")
    A = torch.zeros(16, 4, device="meta")
    bc = torch.zeros(1, 4, 4, device="meta")
    D = torch.zeros(16, device="meta")
    h0 = torch.zeros(1, 16, 4, device="meta")
    assert mamba_scan_ref(seq, seq, A, bc, bc, D, h0)[0].is_meta
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.mamba_scan(seq, seq, A, bc, bc, D, h0)


# ---- the kernel's polynomial exp2 and its launch configuration -------------

CU_SOURCE = kernel.SOURCES[0].read_text()


def test_exp2_poly_matches_exp2_in_fp64():
    """``exp2_poly`` (the kernel's polynomial, step for step in fp32)
    against ``torch.exp2`` in fp64: at most 3e-7 relative over
    [-126, 127], the reach of a normal fp32 result."""
    x = torch.cat([torch.linspace(-126.0, 127.0, 2_000_001, dtype=torch.float64).float(),
                   torch.linspace(-0.5, 0.5, 100_001).float(),
                   torch.from_numpy(np.random.default_rng(0).uniform(
                       -126.0, 127.0, 200_000).astype(np.float32))])
    got = kernel.exp2_poly(x)
    assert got.dtype == torch.float32
    want = torch.exp2(x.double())
    assert ((got.double() - want).abs() / want).max().item() <= 3e-7


def test_exp2_poly_ends():
    """+inf from x = 128 on, 0 from x = -127 down, and exactly 1 at 0 (a
    zero dt leaves the state as it was)."""
    x = torch.tensor([128.0, 128.5, 1e30, float("inf"), -127.0, -127.5, -1e30,
                      float("-inf"), 0.0, -0.0])
    got = kernel.exp2_poly(x)
    assert torch.equal(got[:4], torch.full((4,), float("inf")))
    assert torch.equal(got[4:8], torch.zeros(4))
    assert got[8].item() == 1.0 and got[9].item() == 1.0


def test_exp2_poly_coefficients_match_the_cuda_source():
    """The literals EXP2_C1..EXP2_C5 and the rounding constant in
    ``csrc/mamba_scan_fwd.cu`` are ``kernel.EXP2_POLY`` and
    ``kernel.ROUND_MAGIC``, as fp32."""
    import re
    lits = dict(re.findall(r"constexpr float (EXP2_C\d|ROUND_MAGIC) = ([0-9.e+-]+)f;",
                           CU_SOURCE))
    got = [np.float32(lits[f"EXP2_C{i}"]) for i in range(1, 6)]
    assert got == [np.float32(c) for c in kernel.EXP2_POLY]
    assert np.float32(lits["ROUND_MAGIC"]) == np.float32(kernel.ROUND_MAGIC)


def test_candidates_match_the_cuda_dispatch():
    """``kernel.CANDIDATES`` lists exactly the (d_state, KP, threads) that
    the .cu's dispatch instantiates, in its order."""
    import re
    cases = re.findall(r"^\s*MS_CASE\((\d+), (\d+), (\d+)\)$", CU_SOURCE, flags=re.M)
    assert tuple(tuple(int(v) for v in c) for c in cases) == kernel.CANDIDATES


def _poly_scan(u, dt, A, Bc, Cc, D, h0, k):
    """The plain scan with the kernel's exps: exp(dt A) = 2^(dt (A log2 e))
    in fp32, the last k of each channel's d_state through ``exp2_poly`` and
    the rest through ``torch.exp2``."""
    a2 = (A * np.float32(1.4426950408889634)).float()
    x = dt[..., None] * a2  # (B, S, di, ds)
    ds = A.shape[1]
    dA = torch.cat([torch.exp2(x[..., :ds - k]), kernel.exp2_poly(x[..., ds - k:])], -1)
    h, ys = h0, []
    for t in range(u.shape[1]):
        h = dA[:, t] * h + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]) + D * u[:, t])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("k", [1, 16])
def test_poly_exps_hold_the_long_memory_draw(k):
    """The model's long-memory draw, where an exp's error is summed longest:
    A = -(1..16) (S4D-real, ``models/ssm.py``), dt = softplus(-4 + 0.1
    noise) (a decay of 0.982 a step on state 0), S = 2048, fp32.  A scan
    with k of the 16 exps on the polynomial stays within rtol = atol =
    1e-4 of ``mamba_scan_ref``."""
    B, S, di, ds = 2, 2048, 8, 16
    rng = np.random.default_rng(50)
    u = torch.from_numpy(rng.standard_normal((B, S, di)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        (-4 + 0.1 * rng.standard_normal((B, S, di))).astype(np.float32)))
    A = -torch.arange(1, ds + 1, dtype=torch.float32).repeat(di, 1)
    Bc, Cc = (torch.from_numpy(rng.standard_normal((B, S, ds)).astype(np.float32))
              for _ in range(2))
    D = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, di, ds)).astype(np.float32))
    y, hT = _poly_scan(u, dt, A, Bc, Cc, D, h0, k)
    ey, eh = mamba_scan_ref(u, dt, A, Bc, Cc, D, h0)
    torch.testing.assert_close(y, ey, **TOL)
    torch.testing.assert_close(hT, eh, **TOL)


@pytest.mark.parametrize("B,S,di,dtype,want", [
    # jamba's prefill: one 512-thread block an SM (128 of 132), one wave
    # (one exp a channel on the polynomial at bf16)
    (4, 2048, 16384, torch.bfloat16, (1, 512, 32, 163_840, 128)),
    (4, 2048, 16384, torch.float32, (0, 512, 16, 163_840, 128)),
    # B = 1 would leave 100 SMs idle with 512-thread blocks
    (1, 2048, 16384, torch.bfloat16, (0, 128, 32, 40_960, 128)),
    # a decode step (S = 1) and a scan no longer than a B/C tile
    (8, 1, 16384, torch.bfloat16, (0, 128, 32, 40_960, 1024)),
    (4, 128, 16384, torch.float32, (0, 128, 16, 40_960, 512)),
    # odd di, and di below one block's 128 channels
    (2, 333, 333, torch.float32, (0, 128, 16, 40_960, 6)),
    (3, 7, 6, torch.bfloat16, (0, 128, 32, 40_960, 3)),
])
def test_launch_config_picks(B, S, di, dtype, want):
    cfg = kernel.launch_config(B, S, di, 16, dtype)
    assert tuple(cfg) == want
    assert (16, cfg.poly, cfg.threads) in kernel.CANDIDATES
    assert cfg.smem == kernel.smem_bytes(cfg.threads, dtype.itemsize, 16, cfg.tile)
    assert cfg.smem <= kernel.SMEM_LIMIT


@pytest.mark.parametrize("ds", [4, 8])
def test_launch_config_small_d_state(ds):
    cfg = kernel.launch_config(2, 256, 4096, ds, torch.float32)
    assert (ds, cfg.poly, cfg.threads) in kernel.CANDIDATES
    assert cfg.poly == 0 and cfg.threads == 128


def test_launch_config_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="d_state 32"):
        kernel.launch_config(1, 8, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        kernel.launch_config(1, 8, 64, 16, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        kernel.launch_config(1, 0, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="not instantiated"):
        kernel.make_config(1, 64, 16, torch.float32, 2, 512, 16)
    with pytest.raises(ValueError, match="not instantiated"):
        kernel.make_config(1, 64, 8, torch.float32, 0, 512, 16)
    with pytest.raises(ValueError, match="tile"):
        kernel.make_config(1, 64, 16, torch.float32, 0, 128, 8)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.make_config(1, 64, 16, torch.float32, 0, 512, 32)


def test_copy_bytes():
    """16-byte chunks for aligned rows; narrower ones for a view that
    starts one element in, or rows of an odd number of bf16 channels."""
    u = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    assert kernel.copy_bytes(u, u) == 16
    wide = torch.zeros(2 * 4 * 64 + 1, dtype=torch.bfloat16)
    view = wide[1:].view(2, 4, 64)
    assert kernel.copy_bytes(view, u) == 2
    odd = torch.zeros(2, 4, 33, dtype=torch.bfloat16)
    assert kernel.copy_bytes(odd, odd) == 2
    assert kernel.copy_bytes(odd.float(), odd.float()) == 4
