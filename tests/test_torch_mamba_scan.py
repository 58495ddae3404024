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
