"""The port's flash attention (``repro_torch.kernels.flash_attention``)
held against the JAX package's kernel (interpret mode) and oracle.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import randn  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_fa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the sweep of tests/test_kernels.py::test_flash_attention, same tolerances
CASES = [
    (2, 4, 2, 256, 64, True, "float32", 1e-5),
    (1, 4, 4, 128, 32, False, "float32", 1e-5),
    (2, 8, 2, 256, 64, True, "bfloat16", 2e-2),
    (1, 2, 1, 512, 128, True, "float32", 1e-5),
    (1, 6, 2, 192, 64, True, "float32", 1e-5),  # non-pow2 seq
]


def _qkv(seed, B, H, KV, S, hd, dtype):
    jdt, tdt = _DT[dtype]
    arrs = [randn(seed + i, *shape) for i, shape in
            enumerate([(B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)])]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,dtype,tol", CASES)
def test_attention_ref_matches_jax(B, H, KV, S, hd, causal, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, B, H, KV, S, hd, dtype)
    out = attention_ref(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    kern = jax_fa(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                  interpret=True)
    ref = jax_ref(jq, jk, jv, causal=causal)
    for exp in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(exp), atol=tol * 10,
                                   rtol=tol * 10)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_ragged_seq(causal):
    """S = 77 divides by no block: the port's contract takes any S."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(10, 2, 6, 3, 77, 16, "float32")
    np.testing.assert_allclose(_f32(attention_ref(tq, tk, tv, causal=causal)),
                               _f32(jax_ref(jq, jk, jv, causal=causal)),
                               atol=1e-5, rtol=1e-5)


def test_ops_model_layout_matches_jax():
    B, S, KV, G, hd = 2, 64, 2, 3, 16
    qg, k, v = (randn(20, B, S, KV, G, hd), randn(21, B, S, KV, hd),
                randn(22, B, S, KV, hd))
    out = ops.flash_attention(*map(torch.from_numpy, (qg, k, v)), causal=True)
    exp = jax_ops.flash_attention(*map(jnp.asarray, (qg, k, v)), causal=True)
    assert out.shape == (B, S, KV, G, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


def test_flash_attention_grad_path():
    """Differentiable, with the gradient of the reference (the twin of the
    JAX custom VJP) and of the JAX wrapper."""
    B, S, KV, G, hd = 1, 64, 2, 2, 16
    qg, k, v = (randn(30, B, S, KV, G, hd), randn(31, B, S, KV, hd),
                randn(32, B, S, KV, hd))
    tq = torch.from_numpy(qg).requires_grad_()
    (g,) = torch.autograd.grad(
        ops.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                            causal=True).sum(), tq)
    assert torch.isfinite(g).all()
    tq2 = torch.from_numpy(qg).requires_grad_()
    o = attention_ref(tq2.reshape(B, S, KV * G, hd).transpose(1, 2),
                      torch.from_numpy(k).transpose(1, 2),
                      torch.from_numpy(v).transpose(1, 2), causal=True)
    (g_ref,) = torch.autograd.grad(o.sum(), tq2)
    torch.testing.assert_close(g, g_ref, atol=1e-6, rtol=1e-6)
    g_jax = jax.grad(lambda q_: jax_ops.flash_attention(
        q_, jnp.asarray(k), jnp.asarray(v), causal=True).sum())(jnp.asarray(qg))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), atol=1e-4,
                               rtol=1e-4)


def test_kernel_takes_cuda_tensors_only():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_fwd(q, q[:, :1], q[:, :1])


def test_non_cpu_tensor_never_reaches_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises; it does not
    fall back to ``attention_ref`` (which would accept meta tensors)."""
    qg = torch.zeros(1, 8, 1, 2, 16, device="meta")
    kv = torch.zeros(1, 8, 1, 16, device="meta")
    assert attention_ref(qg.reshape(1, 8, 2, 16).transpose(1, 2),
                         kv.transpose(1, 2), kv.transpose(1, 2)).is_meta
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(qg, kv, kv, causal=True)


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_tracks_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build.library_path("k", (src,))
    assert first == _build.library_path("k", (src,))
    src.write_text("// two")
    assert _build.library_path("k", (src,)) != first
    assert first.parent == _build.BUILD_DIR

