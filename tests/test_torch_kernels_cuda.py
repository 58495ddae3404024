"""The port's CUDA flash-attention kernel held against its plain version
on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports nothing of JAX, so it runs where only the port is
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# the sweep of tests/test_kernels.py::test_flash_attention (same
# tolerances), a ragged S and the widest head_dim in the configs
CASES = [
    (2, 4, 2, 256, 64, True, "float32", 1e-5),
    (1, 4, 4, 128, 32, False, "float32", 1e-5),
    (2, 8, 2, 256, 64, True, "bfloat16", 2e-2),
    (1, 2, 1, 512, 128, True, "float32", 1e-5),
    (1, 6, 2, 192, 64, True, "float32", 1e-5),
    (2, 4, 2, 200, 64, True, "float32", 1e-5),
    (1, 3, 3, 100, 192, False, "bfloat16", 2e-2),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m cuda on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape, dtype=torch.float32, device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,causal,dtype,tol", CASES)
def test_kernel_matches_ref_on_card(cuda_device, B, H, KV, S, hd, causal,
                                    dtype, tol):
    dt = getattr(torch, dtype)
    q = _randn(40, B, H, S, hd, dtype=dt, device=cuda_device)
    k = _randn(41, B, KV, S, hd, dtype=dt, device=cuda_device)
    v = _randn(42, B, KV, S, hd, dtype=dt, device=cuda_device)
    before = kernel.LAUNCHES
    out = kernel.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert out.dtype == dt and out.shape == q.shape
    exp = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol * 10,
                               rtol=tol * 10)


@pytest.mark.cuda
def test_model_layout_goes_through_the_kernel(cuda_device):
    """``ops.flash_attention`` hands the kernel strided views of the
    model's (B, S, heads, hd) tensors: one launch, the plain result."""
    B, S, KV, G, hd = 2, 130, 2, 7, 64
    qg = _randn(50, B, S, KV, G, hd, device=cuda_device)
    k = _randn(51, B, S, KV, hd, device=cuda_device)
    v = _randn(52, B, S, KV, hd, device=cuda_device)
    before = kernel.LAUNCHES
    out = ops.flash_attention(qg, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    exp = attention_ref(qg.reshape(B, S, KV * G, hd).transpose(1, 2),
                        k.transpose(1, 2), v.transpose(1, 2), causal=True)
    torch.testing.assert_close(out, exp.transpose(1, 2).reshape(out.shape),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 48"):
        kernel.flash_attention_fwd(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        kernel.flash_attention_fwd(q, q[:, :1], q[:, :1])
