"""The port's WKV6 (``repro_torch.kernels.wkv6``) held against the JAX
package's kernel (interpret mode) and oracle.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import randn  # noqa: E402

from repro.kernels.wkv6 import ops as jax_ops  # noqa: E402
from repro.kernels.wkv6.kernel import wkv6_fwd as jax_wkv6  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as jax_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel, ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402

# the sweep of tests/test_kernels.py::test_wkv6: B, H, S, hd, chunk
SWEEP = [(2, 2, 128, 16, 32), (1, 4, 64, 32, 16), (2, 2, 96, 16, 32),
         (1, 1, 64, 64, 64)]


def _inputs(seed, B, H, S, hd, layout="kernel"):
    """r, k, v, w, u, s0 as numpy, drawn as the JAX test draws them; the
    sequence tensors in (B, H, S, hd), or (B, S, H, hd) for ``model``."""
    shape = (B, H, S, hd) if layout == "kernel" else (B, S, H, hd)
    r, k, v = (randn(seed + i, *shape) for i in range(3))
    w = np.exp(-np.exp(randn(seed + 3, *shape) * 0.5)).astype(np.float32)
    u = randn(seed + 4, H, hd, scale=0.1)
    s0 = randn(seed + 5, B, H, hd, hd, scale=0.1)
    return r, k, v, w, u, s0


def _close(got, exp):
    """tests/test_kernels.py::test_wkv6's tolerance: it scales with the
    output's magnitude."""
    exp = np.asarray(exp)
    scale = float(np.max(np.abs(exp))) + 1.0
    np.testing.assert_allclose(np.asarray(got), exp, rtol=1e-4,
                               atol=2e-5 * scale)


def _port(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,H,S,hd,chunk", SWEEP)
def test_wkv6_ref_matches_jax(B, H, S, hd, chunk):
    arrs = _inputs(0, B, H, S, hd)
    y, sT = wkv6_ref(*_port(arrs))
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, H, S, hd) and sT.shape == (B, H, hd, hd)
    jarrs = [jnp.asarray(a) for a in arrs]
    for jy, js in (jax_ref(*jarrs),
                   jax_wkv6(*jarrs, chunk=chunk, interpret=True)):
        _close(y.numpy(), jy)
        _close(sT.numpy(), js)


@pytest.mark.parametrize("S", [1, 40, 100])
def test_wkv6_ref_ragged_and_single_step(S):
    """S = 1 (a decode step) and S that divides by no chunk: the port's
    contract takes any S (the Pallas kernel asserts S % chunk == 0)."""
    arrs = _inputs(10, 2, 3, S, 16)
    y, sT = wkv6_ref(*_port(arrs))
    jy, js = jax_ref(*(jnp.asarray(a) for a in arrs))
    _close(y.numpy(), jy)
    _close(sT.numpy(), js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ops_model_layout_matches_jax(dtype, with_state):
    """``ops.wkv6`` in the model layout against the JAX ``ops.wkv6`` (which
    runs the Pallas kernel in interpret mode), r/k/v in ``dtype``."""
    r, k, v, w, u, s0 = _inputs(20, 2, 2, 64, 16, layout="model")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    state = s0 if with_state else None
    y, sT = ops.wkv6(*(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
                     torch.from_numpy(w), torch.from_numpy(u),
                     None if state is None else torch.from_numpy(state))
    jy, js = jax_ops.wkv6(*(jnp.asarray(a).astype(jdt) for a in (r, k, v)),
                          jnp.asarray(w), jnp.asarray(u),
                          None if state is None else jnp.asarray(state))
    assert y.shape == (2, 64, 2, 16) and y.dtype == torch.float32
    _close(y.numpy(), jy)
    _close(sT.numpy(), js)


def test_kernel_takes_cuda_tensors_only():
    r, k, v, w, u, s0 = _port(_inputs(30, 1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv6_fwd(r, k, v, w, u, s0)


def test_non_cpu_tensor_never_reaches_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises; it does not
    fall back to ``wkv6_ref`` (which would accept meta tensors)."""
    seq = torch.zeros(1, 4, 2, 16, device="meta")
    u = torch.zeros(2, 16, device="meta")
    s0 = torch.zeros(1, 2, 16, 16, device="meta")
    assert wkv6_ref(*(seq.transpose(1, 2),) * 4, u, s0)[0].is_meta
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.wkv6(seq, seq, seq, seq, u, s0)
