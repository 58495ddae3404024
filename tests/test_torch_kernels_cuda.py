"""The port's CUDA kernels (flash attention, WKV6, the Mamba selective scan,
the int8 quantize + error feedback) held against their plain versions on
the card.

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
from repro_torch.kernels.mamba_scan import kernel as ms_kernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.quantize import kernel as q_kernel  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ef_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402

# the sweep of tests/test_kernels.py::test_flash_attention (same
# tolerances), a ragged S, the widest head_dim in the configs, and
# whisper-medium's decoder at its 448-token text context (its bf16 prefill
# at B=4, its fp32 training rows at B=2), and a DP member's rows of
# qwen2-0.5b's train_4k cell (8 x 4096, bf16)
CASES = [
    (4, 16, 16, 448, 64, True, "bfloat16", 2e-2),
    (2, 16, 16, 448, 64, True, "float32", 1e-5),
    (8, 14, 2, 4096, 64, True, "bfloat16", 2e-2),
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
def test_kernel_at_the_prefill_32k_cell_on_card(cuda_device):
    """A DP member's share of qwen2-0.5b's prefill_32k cell, q (1, 14,
    32768, 64) bf16 in the model's layout, against the chunked masked
    attention the plain prefill runs (``attention_ref`` would hold 60 GB
    of fp32 scores at this length), at the bf16 tolerance."""
    from repro_torch.models import layers as L
    B, S, H, KV, hd = 1, 32768, 14, 2, 64
    q = _randn(43, B, S, H, hd, dtype=torch.bfloat16, device=cuda_device)
    k = _randn(44, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    v = _randn(45, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    before = kernel.LAUNCHES
    out = L.attend(q, k, v, causal=True, impl="kernel")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    exp = L.attend(q, k, v, causal=True, impl="masked")
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_kernel_at_a_model_members_share_of_prefill_32k_on_card(cuda_device):
    """One model member's heads of qwen3-1.7b's prefill_32k share at model
    = 4 (``[serve-mesh]`` (a)): q (1, 32768, 4, 128) bf16 and 2 kv heads
    repeated per query head (``gqa_repeat``), against the chunked masked
    attention at the bf16 tolerance."""
    from repro_torch.models import layers as L
    B, S, H, KV, hd = 1, 32768, 4, 2, 128
    q = _randn(46, B, S, H, hd, dtype=torch.bfloat16, device=cuda_device)
    k = _randn(47, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    v = _randn(48, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    before = kernel.LAUNCHES
    out = L.attend(q, k, v, causal=True, impl="kernel", gqa_repeat=True)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    exp = L.attend(q, k, v, causal=True, impl="masked")
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2, rtol=2e-2)


# Both bodies (bf16: wgmma + TMA; fp32: CUDA cores) at every head_dim, with
# G = 1 and G = 8, causal and not, in the model's strided layout and
# contiguous; then S at and around the 64-row q tiles and the 128-key (hd
# <= 64) and 64-key (hd > 64) kv tiles.  Tolerances: fp32 1e-5, bf16 2e-2.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SWEEP = [(hd, dtype, 130, G, causal, layout)
         for hd in kernel.SUPPORTED_HEAD_DIMS
         for dtype in ("float32", "bfloat16")
         for G, causal, layout in ((1, True, "model"), (8, False, "contiguous"))]
SWEEP += [(hd, dtype, S, G, True, "model")
          for hd, G in ((64, 7), (128, 4))
          for dtype in ("float32", "bfloat16")
          for S in (1, 63, 64, 65, 127, 129, 2049)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,S,G,causal,layout", SWEEP)
def test_kernel_sweep_on_card(cuda_device, hd, dtype, S, G, causal, layout):
    dt = getattr(torch, dtype)
    B, KV = 2, 2
    if layout == "model":  # (B, S, heads, hd) memory seen as (B, heads, S, hd)
        q, k, v = (_randn(120 + i, B, S, n, hd, dtype=dt, device=cuda_device)
                   .transpose(1, 2) for i, n in enumerate((KV * G, KV, KV)))
    else:
        q, k, v = (_randn(120 + i, B, n, S, hd, dtype=dt, device=cuda_device)
                   for i, n in enumerate((KV * G, KV, KV)))
    before = kernel.LAUNCHES
    out = kernel.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert out.dtype == dt and out.shape == q.shape
    exp = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_rejects_views_tma_cannot_address(cuda_device, dtype):
    """A data pointer one element (2 bytes in bf16) past a 16-byte boundary,
    or a row stride that is not a multiple of 16 bytes: ValueError, and
    nothing is launched."""
    dt = getattr(torch, dtype)
    n = 2 * 8 * 64
    good = torch.zeros(1, 2, 8, 64, dtype=dt, device=cuda_device)
    offset = torch.zeros(n + 1, dtype=dt, device=cuda_device)[1:].view(1, 2, 8, 64)
    padded = torch.zeros(1, 2, 8, 66, dtype=dt, device=cuda_device)[..., :64]
    assert offset.data_ptr() % 16 and (padded.stride(2) * padded.element_size()) % 16
    before = kernel.LAUNCHES
    for q, k in ((offset, good), (good, offset), (padded, good), (good, padded)):
        with pytest.raises(ValueError, match="bytes"):
            kernel.flash_attention_fwd(q, k[:, :1], k[:, :1])
    assert kernel.LAUNCHES == before


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


# WKV6: the sweep of tests/test_kernels.py::test_wkv6 (B, H, S, hd), then
# S = 1 (a decode step) and ragged S, in fp32 and bf16 r/k/v; then grids
# small enough that launch_config splits a head's columns (NJ > 1), S = 1,
# S below one tile and one tile +- 1, and hd 16 and 32 in bf16
WKV_CASES = [
    (2, 2, 128, 16, "float32"),
    (1, 4, 64, 32, "float32"),
    (2, 2, 96, 16, "float32"),
    (1, 1, 64, 64, "float32"),
    (8, 4, 1, 64, "float32"),
    (2, 3, 333, 64, "bfloat16"),
    (1, 2, 40, 32, "bfloat16"),
    (1, 4, 333, 64, "bfloat16"),
    (1, 4, 333, 64, "float32"),
    (4, 32, 1, 64, "bfloat16"),
    (1, 32, 1, 64, "bfloat16"),  # rwkv6-1.6b's long_500k cell: one row's decode
    (1, 8, 1, 64, "bfloat16"),  # the same on a member's heads at model = 4
    (2, 8, 20, 64, "float32"),
    (2, 8, 31, 64, "bfloat16"),
    (2, 8, 33, 64, "bfloat16"),
    (3, 40, 17, 64, "float32"),
    (2, 4, 100, 16, "bfloat16"),
    (2, 4, 100, 32, "bfloat16"),
]


def _wkv_inputs(seed, B, H, S, hd, dtype, device):
    r, k, v = (_randn(seed + i, B, H, S, hd, dtype=dtype, device=device)
               for i in range(3))
    w = torch.exp(-torch.exp(_randn(seed + 3, B, H, S, hd, device=device) * 0.5))
    u = _randn(seed + 4, H, hd, device=device) * 0.1
    s0 = _randn(seed + 5, B, H, hd, hd, device=device) * 0.1
    return r, k, v, w, u, s0


def _wkv_close(got, exp):
    """tests/test_kernels.py::test_wkv6's tolerance, scaled by the output."""
    scale = exp.abs().max().item() + 1.0
    torch.testing.assert_close(got, exp, rtol=1e-4, atol=2e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", WKV_CASES)
def test_wkv6_kernel_matches_ref_on_card(cuda_device, B, H, S, hd, dtype):
    args = _wkv_inputs(60, B, H, S, hd, getattr(torch, dtype), cuda_device)
    before = wkv_kernel.LAUNCHES
    y, sT = wkv_kernel.wkv6_fwd(*args)
    torch.cuda.synchronize()
    assert wkv_kernel.LAUNCHES == before + 1
    assert y.dtype == sT.dtype == torch.float32 and y.shape == (B, H, S, hd)
    ey, es = wkv6_ref(*args)
    _wkv_close(y, ey)
    _wkv_close(sT, es)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [("bfloat16", 1), ("bfloat16", 2),
                                          ("bfloat16", 4), ("float32", 1),
                                          ("float32", 2)])
def test_wkv6_kernel_takes_views_aligned_below_16_bytes(cuda_device, dtype,
                                                        offset):
    """r, k, v, w as views that start ``offset`` elements into wider rows,
    so the tile ring is filled in 2-, 4- or 8-byte chunks."""
    B, H, S, hd = 2, 3, 45, 64
    r, k, v, w, u, s0 = _wkv_inputs(90, B, H, S, hd, getattr(torch, dtype),
                                    cuda_device)

    def shifted(a):
        wide = torch.zeros(B, S, H, hd + 8, dtype=a.dtype, device=cuda_device)
        view = wide[..., offset:offset + hd].transpose(1, 2)
        view.copy_(a)
        return view

    args = [shifted(a) for a in (r, k, v, w)] + [u, s0]
    assert wkv_kernel.copy_bytes(*args[:4]) < 16
    y, sT = wkv_kernel.wkv6_fwd(*args)
    torch.cuda.synchronize()
    ey, es = wkv6_ref(*args)
    _wkv_close(y, ey)
    _wkv_close(sT, es)


@pytest.mark.cuda
def test_wkv6_model_layout_goes_through_the_kernel(cuda_device):
    """``ops.wkv6`` hands the kernel strided views of the model's
    (B, S, H, hd) tensors and returns y in that layout: one launch."""
    B, S, H, hd = 2, 70, 4, 64
    r, k, v, w = (_randn(70 + i, B, S, H, hd, device=cuda_device)
                  for i in range(4))
    w = torch.sigmoid(w)
    u = _randn(74, H, hd, device=cuda_device) * 0.1
    before = wkv_kernel.LAUNCHES
    y, sT = wkv_ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    torch.cuda.synchronize()
    assert wkv_kernel.LAUNCHES == before + 1
    assert y.shape == (B, S, H, hd) and y.is_contiguous()
    ey, es = wkv6_ref(*(a.transpose(1, 2) for a in (r.bfloat16(), k.bfloat16(),
                                                    v.bfloat16(), w)),
                      u, torch.zeros(B, H, hd, hd, device=cuda_device))
    _wkv_close(y, ey.transpose(1, 2))
    _wkv_close(sT, es)


@pytest.mark.cuda
def test_wkv6_kernel_rejects_what_it_does_not_take(cuda_device):
    r, k, v, w, u, s0 = _wkv_inputs(80, 1, 2, 8, 48, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim 48"):
        wkv_kernel.wkv6_fwd(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _wkv_inputs(80, 1, 2, 8, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        wkv_kernel.wkv6_fwd(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(ValueError, match="w must be float32"):
        wkv_kernel.wkv6_fwd(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv_kernel.wkv6_fwd(r, k, v, w, u, s0.transpose(2, 3))


# Mamba scan: the sweep of tests/test_kernels.py::test_mamba_scan (B, S, di,
# ds; same tolerance), then S = 1 (a decode step), ragged S and di, bf16
MS_CASES = [
    (2, 64, 32, 8, "float32"),
    (1, 128, 64, 4, "float32"),
    (2, 32, 16, 16, "float32"),
    (8, 1, 256, 16, "float32"),
    (2, 100, 200, 16, "bfloat16"),
    (1, 333, 128, 8, "float32"),
    (3, 40, 384, 4, "bfloat16"),
    (1, 1, 8192, 16, "bfloat16"),  # a decode step on a model member's jamba channels
]


def _ms_inputs(seed, B, S, di, ds, dtype, device):
    """Drawn as the JAX test draws them; u, dt, B, C in ``dtype``."""
    u = _randn(seed, B, S, di, dtype=dtype, device=device)
    dt = torch.nn.functional.softplus(
        _randn(seed + 1, B, S, di, device=device) - 2).to(dtype)
    A = -torch.exp(_randn(seed + 2, di, ds, device=device) * 0.3)
    Bc = _randn(seed + 3, B, S, ds, dtype=dtype, device=device)
    Cc = _randn(seed + 4, B, S, ds, dtype=dtype, device=device)
    D = torch.ones(di, device=device)
    h0 = _randn(seed + 5, B, di, ds, device=device) * 0.1
    return u, dt, A, Bc, Cc, D, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,ds,dtype", MS_CASES)
def test_mamba_scan_kernel_matches_ref_on_card(cuda_device, B, S, di, ds, dtype):
    args = _ms_inputs(90, B, S, di, ds, getattr(torch, dtype), cuda_device)
    before = ms_kernel.LAUNCHES
    y, hT = ms_kernel.mamba_scan_fwd(*args)
    torch.cuda.synchronize()
    assert ms_kernel.LAUNCHES == before + 1
    assert y.dtype == hT.dtype == torch.float32 and y.shape == (B, S, di)
    ey, eh = mamba_scan_ref(*args)
    torch.testing.assert_close(y, ey, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, eh, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_mamba_scan_model_layout_goes_through_the_kernel(cuda_device):
    """``ops.mamba_scan`` hands the kernel B and C as column slices of one
    (B, S, dt_rank + 2 ds) projection, as the model does: one launch."""
    B, S, di, ds, dtr = 2, 70, 256, 16, 32
    u, dt, A, _, _, D, _ = _ms_inputs(100, B, S, di, ds, torch.bfloat16,
                                      cuda_device)
    xdbl = _randn(106, B, S, dtr + 2 * ds, dtype=torch.bfloat16,
                  device=cuda_device)
    Bc, Cc = xdbl[..., dtr:dtr + ds], xdbl[..., dtr + ds:]
    before = ms_kernel.LAUNCHES
    y, hT = ms_ops.mamba_scan(u, dt, A, Bc, Cc, D)
    torch.cuda.synchronize()
    assert ms_kernel.LAUNCHES == before + 1
    ey, eh = mamba_scan_ref(u, dt, A, Bc.contiguous(), Cc.contiguous(), D,
                            torch.zeros(B, di, ds, device=cuda_device))
    torch.testing.assert_close(y, ey, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, eh, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_mamba_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    u, dt, A, Bc, Cc, D, h0 = _ms_inputs(110, 2, 8, 64, 4, torch.float32,
                                         cuda_device)
    with pytest.raises(ValueError, match="d_state 32"):
        ms_kernel.mamba_scan_fwd(u, dt, A.repeat(1, 8), Bc.repeat(1, 1, 8),
                                 Cc.repeat(1, 1, 8), D, h0.repeat(1, 1, 8))
    with pytest.raises(ValueError, match="dtype"):
        ms_kernel.mamba_scan_fwd(u.half(), dt.half(), A, Bc.half(), Cc.half(),
                                 D, h0)
    with pytest.raises(ValueError, match="A must be float32"):
        ms_kernel.mamba_scan_fwd(u, dt, A.bfloat16(), Bc, Cc, D, h0)
    with pytest.raises(ValueError, match="u must be contiguous"):
        ms_kernel.mamba_scan_fwd(u.transpose(0, 1), dt.transpose(0, 1), A,
                                 Bc.transpose(0, 1), Cc.transpose(0, 1), D, h0)
    with pytest.raises(ValueError, match="h0 must be"):
        ms_kernel.mamba_scan_fwd(u, dt, A, Bc, Cc, D, h0.transpose(1, 2))


# K4's edges: odd di and di around one and two 128-thread blocks'
# channels; S around the 16- and 32-step ring stages and B/C tiles
MS_EDGE_CASES = [
    (2, 100, 333, 16, "float32"), (2, 100, 333, 16, "bfloat16"),
    (2, 64, 127, 16, "bfloat16"), (2, 64, 129, 16, "float32"),
    (2, 64, 255, 16, "bfloat16"), (2, 64, 257, 16, "float32"),
    (2, 64, 254, 16, "float32"), (2, 64, 258, 16, "bfloat16"),
    (2, 15, 512, 16, "bfloat16"), (2, 16, 512, 16, "float32"),
    (2, 17, 512, 16, "bfloat16"), (2, 31, 512, 16, "float32"),
    (2, 32, 512, 16, "bfloat16"), (2, 33, 512, 16, "float32"),
]


def _ms_check(args, got):
    y, hT = got
    torch.cuda.synchronize()
    ey, eh = mamba_scan_ref(*args)
    torch.testing.assert_close(y, ey, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, eh, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,ds,dtype", MS_EDGE_CASES)
def test_mamba_scan_kernel_edges_on_card(cuda_device, B, S, di, ds, dtype):
    args = _ms_inputs(120, B, S, di, ds, getattr(torch, dtype), cuda_device)
    _ms_check(args, ms_kernel.mamba_scan_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cand", ms_kernel.CANDIDATES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_every_instantiation_on_card(cuda_device, cand, dtype):
    """Each instantiated (d_state, KP, threads) through ``launch``, at a
    shape with a ragged last stage (S = 333) and a partial last block."""
    ds, poly, threads = cand
    dt = getattr(torch, dtype)
    args = _ms_inputs(130, 2, 333, 640, ds, dt, cuda_device)
    cfg = ms_kernel.make_config(2, 640, ds, dt, poly, threads, 16)
    _ms_check(args, ms_kernel.launch(*args, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_long_memory_on_card(cuda_device, dtype):
    """The model's long-memory draw, where the exps' errors are summed
    longest: A = -(1..16), dt = softplus(-4 + 0.1 noise), S = 2048."""
    B, S, di, ds = 2, 2048, 512, 16
    dt_ = getattr(torch, dtype)
    u = _randn(140, B, S, di, dtype=dt_, device=cuda_device)
    dt = torch.nn.functional.softplus(
        -4 + 0.1 * _randn(141, B, S, di, device=cuda_device)).to(dt_)
    A = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device=cuda_device).repeat(di, 1)
    Bc = _randn(142, B, S, ds, dtype=dt_, device=cuda_device)
    Cc = _randn(143, B, S, ds, dtype=dt_, device=cuda_device)
    D = _randn(144, di, device=cuda_device)
    h0 = _randn(145, B, di, ds, device=cuda_device)
    args = (u, dt, A, Bc, Cc, D, h0)
    _ms_check(args, ms_kernel.mamba_scan_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cand", [c for c in ms_kernel.CANDIDATES if c[1] > 0])
def test_mamba_scan_extreme_exponents_on_card(cuda_device, cand):
    """dt A far below -127 (the decay flushes to 0) and dt = 0 (x = 0: the
    decay is exactly 1), on every instantiation with polynomial exps."""
    ds, poly, threads = cand
    u, dt, A, Bc, Cc, D, h0 = _ms_inputs(150, 2, 64, 512, ds, torch.float32,
                                         cuda_device)
    A = A * 400.0
    zero = torch.from_numpy(np.random.default_rng(151).random(dt.shape) < 0.3
                            ).to(cuda_device)
    dt = torch.where(zero, torch.zeros_like(dt), dt + 1.0)
    args = (u, dt, A, Bc, Cc, D, h0)
    cfg = ms_kernel.make_config(2, 512, ds, torch.float32, poly, threads, 16)
    _ms_check(args, ms_kernel.launch(*args, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_unaligned_views_on_card(cuda_device, dtype):
    """u and dt one element into wider buffers: rows copied in chunks
    narrower than 16 bytes, by the picked launch and by the launch with a
    polynomial exp."""
    dt_ = getattr(torch, dtype)
    args = list(_ms_inputs(160, 2, 100, 4096, 16, dt_, cuda_device))
    for i in (0, 1):
        wide = torch.empty(args[i].numel() + 1, dtype=dt_, device=cuda_device)
        view = wide[1:].view(args[i].shape)
        view.copy_(args[i])
        args[i] = view
    assert ms_kernel.copy_bytes(args[0], args[1]) < 16
    _ms_check(args, ms_kernel.mamba_scan_fwd(*args))
    cfg = ms_kernel.make_config(2, 4096, 16, dt_, 1, 512, 16)
    _ms_check(args, ms_kernel.launch(*args, cfg))


@pytest.mark.cuda
def test_exp2_poly_on_card(cuda_device):
    """The kernel's polynomial 2^x on the card: within 3e-7 of exp2 in
    fp64 over [-126, 127]; +inf from 128 on, 0 from -127 down, 1 at 0."""
    x = torch.linspace(-126.0, 127.0, 2_000_001, device=cuda_device)
    got = ms_kernel.exp2_poly(x)
    want = torch.exp2(x.double())
    assert ((got.double() - want).abs() / want).max().item() <= 3e-7
    ends = ms_kernel.exp2_poly(torch.tensor(
        [128.0, 1e30, -127.0, -1e30, 0.0], device=cuda_device)).tolist()
    assert ends == [float("inf"), float("inf"), 0.0, 0.0, 1.0]


# the sweep of tests/test_kernels.py::test_quantize_ef, then the section
# sizes of the training path (qwen2-0.5b on (pod, data, model) = (2, 1, 1):
# embed, mlp, wq/wo, wk/wv and the padded bucket of small leaves)
Q_CASES = [(8192, 512), (4096, 2048), (2048, 128), (136_134_656, 2048),
           (104_595_456, 2048), (19_267_584, 2048), (2_752_512, 2048),
           (71_680, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block", Q_CASES)
def test_quantize_kernel_bit_equal_on_card(cuda_device, n, block, dtype):
    """q, scales and err bit for bit: the kernel divides (never multiplies
    by a reciprocal), rounds half to even and rounds q * scale before the
    subtraction, as the plain version does."""
    g = torch.Generator(device=cuda_device).manual_seed(n + block)
    x = (torch.randn(n, generator=g, device=cuda_device) * 1e-3).to(getattr(torch, dtype))
    before = q_kernel.LAUNCHES
    got = q_ops.quantize_ef(x, block=block)
    torch.cuda.synchronize()
    assert q_kernel.LAUNCHES == before + 1
    for a, b in zip(got, quantize_ef_ref(x, block=block)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_quantize_kernel_ties_zeros_and_unaligned(cuda_device):
    block = 512
    g = torch.Generator(device=cuda_device).manual_seed(0)
    c = torch.exp2(torch.randint(-8, 4, (16, 1), generator=g, device=cuda_device).float())
    k = torch.randint(-127, 127, (16, block), generator=g, device=cuda_device).float() + 0.5
    k[:, 0] = 127.0  # scale = c exactly, so x / scale are exact halves
    x = (k * c).reshape(-1)
    x[:block] = 0.0
    for xin in (x, torch.cat([x.new_zeros(1), x])[1:]):  # aligned, offset by 4 B
        for a, b in zip(q_kernel.quantize_ef_fwd(xin, block=block),
                        quantize_ef_ref(xin, block=block)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_quantize_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(4096, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        q_kernel.quantize_ef_fwd(x[:4000], block=512)
    with pytest.raises(ValueError, match="CUDA"):
        q_kernel.quantize_ef_fwd(x.cpu())
    with pytest.raises(ValueError, match="dtype"):
        q_kernel.quantize_ef_fwd(x.half())
    with pytest.raises(ValueError, match="block"):
        q_kernel.quantize_ef_fwd(x, block=1024)
    with pytest.raises(ValueError, match="1-D"):
        q_kernel.quantize_ef_fwd(x.reshape(2, 2048))


# ---------------------------------------------------------------------------
# scatter-add reproducibility on the card (two runs, compared bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_topk_combine_reproducible_on_card(cuda_device):
    """``compression.combine_topk`` on P = 4 gathered (values, indices)
    sets, the shape of the top-k slow leg on the (4, 2) mesh at k = n/16,
    indices overlapping across members: two runs are bit-equal, and equal
    to the sum formed member by member on the CPU."""
    from repro_torch.core.compression import combine_topk
    n, P = 1 << 22, 4
    k = n // 16
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    idx = torch.stack([torch.randperm(n, generator=gen, device=cuda_device)[:k]
                       for _ in range(P)]).to(torch.int32)
    vals = torch.randn((P, k), generator=gen, device=cuda_device)
    a = combine_topk(vals, idx, n, torch.float32)
    b = combine_topk(vals, idx, n, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = combine_topk(vals.cpu(), idx.cpu(), n, torch.float32)
    assert torch.equal(a.cpu(), want)


@pytest.mark.cuda
def test_moe_layer_repeats_on_card(cuda_device):
    """One deepseek-moe-16b MoE layer (64 routed experts of d_ff 1408,
    top-6, 2 shared) in bf16 on 4 x 2048 tokens, forward and backward run
    twice: the outputs, the aux loss and the gradients of the input and of
    every parameter are bit-equal.  The combine gathers each token's k
    slots and sums them in one reduction over k, and both gathers'
    backwards are gathers and sums (``layers._GatherRows``), with no
    atomics; the scatter-add it replaced differed
    in 83,529 and 99,156 of 16,777,216 outputs between two runs on the
    H100 (ROADMAP queue 3, item 10, now repaired)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils.trees import tree_paths
    arch = get_arch("deepseek-moe-16b")
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    p = L.init_moe(arch, gen, (), torch.bfloat16, cuda_device)
    x = torch.randn((4, 2048, arch.d_model), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    gy = torch.randn((4, 2048, arch.d_model), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    leaves = tree_paths(p)
    for t in leaves.values():
        t.requires_grad_(True)

    def run():
        xi = x.clone().requires_grad_(True)
        y, aux = L.apply_moe(arch, p, xi)
        grads = torch.autograd.grad((y, aux), [xi] + list(leaves.values()),
                                    (gy, torch.ones_like(aux)))
        return y.detach(), aux.detach(), grads

    (y1, aux1, g1), (y2, aux2, g2) = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(aux1, aux2)
    assert torch.equal(y1, y2), f"{int((y1 != y2).sum())} outputs differ"
    for name, a, b in zip(["x"] + list(leaves), g1, g2):
        assert torch.equal(a, b), f"d{name}: {int((a != b).sum())} differ"
    assert torch.isfinite(y1.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_autograd_matches_plain_on_card(cuda_device, dtype):
    """``wkv6_ops.wkv6`` (K3 in the forward, the plain recurrence
    recomputed in the backward) at rwkv6-1.6b's training shape (B=1,
    S=2048, 32 heads of 64): y to K3's tolerance, and the gradients of
    r, k, v, w, u and the initial state equal to autograd through
    ``wkv6_ref``'s (the same backward, so to fp32 rounding)."""
    dt = getattr(torch, dtype)
    r, k, v, w, u, s0 = _wkv_inputs(70, 1, 32, 2048, 64, dt, cuda_device)
    args = [a.transpose(1, 2).contiguous().requires_grad_(True)
            for a in (r, k, v, w)] + [u.requires_grad_(True), s0.requires_grad_(True)]
    gy = _randn(77, 1, 2048, 32, 64, device=cuda_device)
    before = wkv_kernel.LAUNCHES
    y, _ = wkv_ops.wkv6(*args)
    assert wkv_kernel.LAUNCHES == before + 1
    grads = torch.autograd.grad(y, args, gy)
    ref_args = [a.detach().transpose(1, 2).requires_grad_(True) for a in args[:4]] \
        + [a.detach().requires_grad_(True) for a in args[4:]]
    y_ref, _ = wkv6_ref(*ref_args)
    _wkv_close(y, y_ref.transpose(1, 2))
    ref_grads = torch.autograd.grad(y_ref, ref_args, gy.transpose(1, 2))
    for i, (g, gr) in enumerate(zip(grads, ref_grads)):
        gr = gr.transpose(1, 2) if i < 4 else gr
        assert g.dtype == args[i].dtype
        torch.testing.assert_close(g.float(), gr.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_autograd_matches_plain_on_card(cuda_device, dtype):
    """``ms_ops.mamba_scan`` (K4 in the forward, the plain scan recomputed
    in the backward) at one jamba Mamba layer's training shape (B=1,
    S=2048, d_inner 16384, d_state 16): y to K4's tolerance, and the
    gradients of u, dt, A, B, C, D and the initial state equal to autograd
    through ``mamba_scan_ref``'s."""
    dt_ = getattr(torch, dtype)
    ins = [a.requires_grad_(True)
           for a in _ms_inputs(91, 1, 2048, 16384, 16, dt_, cuda_device)]
    gy = _randn(92, 1, 2048, 16384, device=cuda_device)
    before = ms_kernel.LAUNCHES
    y, hT = ms_ops.mamba_scan(*ins)
    assert ms_kernel.LAUNCHES == before + 1
    grads = torch.autograd.grad(y, ins, gy)
    _ms_check(tuple(a.detach() for a in ins), (y.detach(), hT.detach()))
    ref_ins = [a.detach().requires_grad_(True) for a in ins]
    y_ref, _ = mamba_scan_ref(*ref_ins)
    ref_grads = torch.autograd.grad(y_ref, ref_ins, gy)
    for a, g, gr in zip(ins, grads, ref_grads):
        assert g.dtype == a.dtype
        torch.testing.assert_close(g.float(), gr.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_flash_attention_bf16_backward_in_a_training_step(cuda_device):
    """A bf16 training step of a 2-layer qwen2-0.5b (full width) with K1
    (its bf16 body) in each layer's forward and its backward through
    ``attention_ref``: K1 launched twice in the forward and twice in the
    ``remat="full"`` recompute, and the loss and every gradient within the
    JAX tests' bf16 tolerance (2e-2) of the same step with the plain
    masked attention, each element and each leaf's relative error
    ||g - g_plain|| / ||g_plain|| (3e-2, about 8 bf16 ulps, as
    ``test_torch_train_mixed.py`` holds bf16 gradients to JAX's); a
    zeroed leaf reads 1."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelSettings, build_model
    arch = get_arch("qwen2-0.5b").replace(n_layers=2)
    toks = torch.randint(0, arch.vocab, (2, 512), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(3))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = {}
    for impl in ("kernel", "masked"):
        model = build_model(arch, ModelSettings(attn_impl=impl, remat="full",
                                                loss_chunk=512),
                            device=cuda_device, seed=4)
        leaves = [p.requires_grad_(True) for p in model.parameters()]
        before = kernel.LAUNCHES
        loss = model.loss(model.params(), batch)
        grads = torch.autograd.grad(loss, leaves)
        out[impl] = (loss.item(), grads, kernel.LAUNCHES - before)
    assert out["kernel"][2] == 2 * arch.n_layers and out["masked"][2] == 0
    np.testing.assert_allclose(out["kernel"][0], out["masked"][0], rtol=2e-2)
    for i, (g, gm) in enumerate(zip(out["kernel"][1], out["masked"][1])):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), gm.float(), rtol=2e-2, atol=2e-2)
        norm = gm.double().norm()
        rel = float((g.double() - gm.double()).norm() / norm)
        print(f"leaf {i} {tuple(g.shape)}: max |g| {gm.abs().max().item():.3e}, "
              f"relative error {rel:.3e}")
        assert norm > 0 and rel <= 3e-2, (i, rel)


def _moe_tp_rank(rank, store, queue):
    """One of two ranks sharing the card over gloo: one deepseek-moe-16b
    MoE layer in fp32 (seed 8), whole on this rank, then this rank's half
    of the routed experts and of the shared experts' d_ff on the mesh
    ``{"model": 2}``, forward and backward run twice."""
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.configs import get_arch
        from repro_torch.core import prims
        from repro_torch.models import layers as L
        from repro_torch.utils.trees import tree_from_paths, tree_paths
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        arch = get_arch("deepseek-moe-16b")
        gen = torch.Generator(device=dev).manual_seed(8)
        p = L.init_moe(arch, gen, (), torch.float32, dev)
        x = torch.randn((1, 2048, arch.d_model), generator=gen, device=dev)
        gy = torch.randn((1, 2048, arch.d_model), generator=gen, device=dev)
        with torch.no_grad():
            whole = L.apply_moe(arch, p, x)[0]
        E, F = arch.moe.num_experts // 2, p["shared"]["wi"].shape[1] // 2

        def cut(path, t):
            if path.startswith("we_"):
                return t[rank * E:(rank + 1) * E]
            if path in ("shared/wi", "shared/wg"):
                return t[:, rank * F:(rank + 1) * F]
            if path == "shared/wo":
                return t[rank * F:(rank + 1) * F]
            return t
        local = tree_from_paths({k: cut(k, t).contiguous().requires_grad_(True)
                                 for k, t in tree_paths(p).items()})
        leaves = tree_paths(local)
        runs = []
        with prims.bind(prims.Mesh({"model": 2})):
            for _ in range(2):
                xi = x.clone().requires_grad_(True)
                y, aux = L.apply_moe(arch, local, xi,
                                     dispatch_spec=(None, "model"),
                                     shared_axis="model")
                grads = torch.autograd.grad(
                    (y, aux), [xi] + list(leaves.values()), (gy, torch.ones_like(aux)))
                runs.append([y.detach()] + [aux.detach()] + list(grads))
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
        err = (runs[0][0] - whole).abs().max().item()
        scale = whole.abs().max().item()
        dist.destroy_process_group()
        queue.put((rank, (same, err, scale, leaves["we_in"].shape[0]), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


@pytest.mark.cuda
def test_moe_layer_at_model_2_on_card(cuda_device, tmp_path):
    """The deepseek MoE layer with its experts split over a model axis of
    2 (two ranks on the card over gloo, 32 routed experts and half the
    shared d_ff each): the output, the aux loss and every gradient
    bit-equal over two runs, and the output equal to the unsharded
    layer's within 1e-5 (fp32) of its largest value."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_moe_tp_rank, args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(2):
            rank, res, err = queue.get(timeout=600)
            assert err is None, err
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, (same, err, scale, experts) in out.items():
        assert experts == 32
        assert all(same), f"rank {rank}: {same.count(False)} of {len(same)} differ"
        assert err <= 1e-5 * scale, (rank, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("member", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [512, 1024])
def test_wkv6_on_a_members_heads_on_card(cuda_device, member, dtype, seq):
    """K3 through ``wkv6_ops.wkv6`` on one model member's heads of
    rwkv6-1.6b at model = 2 (``[train-gspmd-rwkv]``: B=1, 16 of the 32
    heads, S=512, and 1024, hd 64), the member's heads a slice of the
    model-layout (B, S, H, hd) tensors (a view, no copy): y and the final
    state against the plain version on the same slice, at K3's tolerance."""
    dt = getattr(torch, dtype)
    r, k, v, w, u, s0 = _wkv_inputs(130, 1, 32, seq, 64, dt, cuda_device)
    heads = slice(16 * member, 16 * (member + 1))
    # the model layout, (B, S, H, hd), and this member's heads of it
    local = [a.transpose(1, 2).contiguous()[:, :, heads] for a in (r, k, v, w)]
    before = wkv_kernel.LAUNCHES
    y, sT = wkv_ops.wkv6(*local, u[heads], state=s0[:, heads])
    assert wkv_kernel.LAUNCHES == before + 1 and y.shape == (1, seq, 16, 64)
    ey, es = wkv6_ref(*(a.transpose(1, 2) for a in local), u[heads], s0[:, heads])
    _wkv_close(y, ey.transpose(1, 2))
    _wkv_close(sT, es)


@pytest.mark.cuda
@pytest.mark.parametrize("member", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_on_a_members_channels_on_card(cuda_device, member, dtype):
    """K4 through ``ms_ops.mamba_scan`` on one model member's channels of
    one jamba Mamba layer at model = 2 (``[train-tp-hybrid]`` (d): B=1,
    S=2048, 8192 of d_inner's 16384 channels, d_state 16): u and dt this
    member's channels of the whole layer's (sliced, then made contiguous,
    as the kernel takes them), A, D and the state its rows, B and C
    whole; against the plain version at K4's tolerance."""
    dt_ = getattr(torch, dtype)
    u, dt, A, Bc, Cc, D, h0 = _ms_inputs(140, 1, 2048, 16384, 16, dt_, cuda_device)
    ch = slice(8192 * member, 8192 * (member + 1))
    args = (u[..., ch].contiguous(), dt[..., ch].contiguous(), A[ch], Bc, Cc,
            D[ch], h0[:, ch].contiguous())
    before = ms_kernel.LAUNCHES
    got = ms_ops.mamba_scan(*args)
    assert ms_kernel.LAUNCHES == before + 1 and got[0].shape == (1, 2048, 8192)
    _ms_check(args, got)


def _moe_fsdp_tp_rank(rank, store, queue):
    """One of four ranks sharing the card over gloo, mesh (data, model) =
    (2, 2): one deepseek-moe-16b MoE layer in fp32 (seed 9) and a 2-row
    global batch (S=2048), whole on this rank (its output, aux loss and
    dropped slots), then under FSDP x TP: each leaf this member's block
    (``sharding.param_specs`` with FSDP over data), the FSDP blocks
    gathered on use, the experts split over model, this member's row
    routed with the whole batch (``token_axes``)."""
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.configs import get_arch
        from repro_torch.core import prims
        from repro_torch.models import layers as L
        from repro_torch.models import sharding
        from repro_torch.models.transformer import _gather_fsdp
        from repro_torch.utils.trees import tree_from_paths, tree_paths
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=4, rank=rank)
        arch = get_arch("deepseek-moe-16b")
        gen = torch.Generator(device=dev).manual_seed(9)
        p = L.init_moe(arch, gen, (), torch.float32, dev)
        # a direction shared by every token skews the routing past C
        x = (torch.randn((2, 2048, arch.d_model), generator=gen, device=dev)
             + 0.5 * torch.randn(arch.d_model, generator=gen, device=dev))
        L.DROP_LOG = []
        with torch.no_grad():
            whole, whole_aux = L.apply_moe(arch, p, x)
        whole_drops = int(L.DROP_LOG.pop().sum())
        sizes = {"data": 2, "model": 2}
        mesh = prims.Mesh(sizes)
        flat = {f"moe/{k}": t for k, t in tree_paths(p).items()}
        specs = sharding.param_specs(arch, {k: t.shape for k, t in flat.items()},
                                     sharding.MeshInfo(sizes, fsdp_axis="data"))
        local = {k: sharding.local_block(t, specs[k], mesh.coords, sizes).contiguous()
                 for k, t in flat.items()}
        row = mesh.coords["data"]
        with prims.bind(mesh), torch.no_grad():
            pl = _gather_fsdp(tree_from_paths(local)["moe"],
                              tree_from_paths(specs)["moe"], "data")
            y, aux = L.apply_moe(arch, pl, x[row:row + 1],
                                 dispatch_spec=(None, "model"), shared_axis="model",
                                 token_axes=("data",))
        drops = int(L.DROP_LOG.pop().sum())
        torch.cuda.synchronize()
        err = (y[0] - whole[row]).abs().max().item()
        res = (mesh.coords, drops, whole_drops, err, whole.abs().max().item(),
               abs(aux.item() - whole_aux.item()) / whole_aux.item(),
               pl["we_in"].shape[0])
        dist.destroy_process_group()
        queue.put((rank, res, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


@pytest.mark.cuda
def test_moe_layer_under_fsdp_tp_drops_as_the_whole_batch_on_card(cuda_device,
                                                                   tmp_path):
    """The deepseek MoE layer under FSDP x TP, (data, model) = (2, 2),
    four ranks on the card, each DP member one row of a 2-row batch
    (S=2048) routed as one batch with the capacity of its 4096 tokens
    (C = 480 against a mean load of 384 a routed expert; the rows share a
    direction that skews the routing, so slots drop):
    the members' dropped slots add up to the unsharded layer's, its
    output is the unsharded layer's row within 1e-5 of the largest value
    (fp32), and its aux loss is the batch's within 1e-6."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_moe_fsdp_tp_rank,
                         args=(r, str(tmp_path / "store"), queue)) for r in range(4)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(4):
            rank, res, err = queue.get(timeout=600)
            assert err is None, err
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    members = [r for r in out.values() if r[0]["model"] == 0]
    whole_drops = members[0][2]
    assert whole_drops > 0 and sum(r[1] for r in members) == whole_drops
    for coords, drops, _, err, scale, aux_rel, experts in out.values():
        assert experts == 32
        assert err <= 1e-5 * scale, (coords, err, scale)
        assert aux_rel <= 1e-6, (coords, aux_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_smoke_prefill_through_the_kernel(cuda_device, dtype):
    """The whisper smoke model's prefill on the card (S = 40, ragged, and
    16 frames), with K1 in each decoder layer's causal self-attention (one
    launch a layer; the encoder and the cross attention stay masked), held
    to the same model's masked prefill: the logits and every cache leaf,
    ``xk``/``xv`` included, at 1e-4 in fp32 and 2e-2 (atol scaled by the
    largest value) in bf16."""
    import dataclasses
    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.utils.trees import tree_paths
    arch = get_smoke_arch("whisper-medium")
    st = ModelSettings(param_dtype=dtype, compute_dtype=dtype,
                       attn_impl="kernel", max_seq=64)
    model = build_model(arch, st, device=cuda_device, seed=0)
    toks = torch.from_numpy(np.random.default_rng(61).integers(
        0, arch.vocab, (2, 40))).to(cuda_device)
    frames = _randn(62, 2, arch.encoder.n_frames, arch.d_model, device=cuda_device)
    before = kernel.LAUNCHES
    logits, cache = model.prefill(toks, frames)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + arch.n_layers
    model.settings = dataclasses.replace(st, attn_impl="masked")
    want, want_cache = model.prefill(toks, frames)
    assert kernel.LAUNCHES == before + arch.n_layers
    pairs = [(logits, want)] + [(t, tree_paths(want_cache)[k])
                                for k, t in tree_paths(cache).items()]
    assert sorted(tree_paths(cache)) == ["l0/k", "l0/v", "l0/xk", "l0/xv"]
    for got, ref in pairs:
        tol = (dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else
               dict(atol=2e-2 * ref.float().abs().max().item(), rtol=2e-2))
        torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_staging_buffers_on_card(cuda_device):
    """``StagingBuffers`` on the card: each batch (a tree of a numpy array
    and a tensor) lands whole on the device through pinned slots copied on
    a side stream, the slots round-robin and keep their pinned buffers,
    and a slot is rewritten only after its copy is done; the offload
    placement is pinned host memory."""
    from repro_torch.core.staging_utils import (StagingBuffers,
                                                host_memory_kind_available,
                                                offload_placement)
    assert host_memory_kind_available()
    staging = StagingBuffers(cuda_device, n_slots=2)
    outs = []
    for i in range(6):
        out = staging.put({"tokens": np.full((4, 1 << 16), i, np.int32),
                           "x": torch.full((1 << 18,), float(i))})
        outs.append(out)
        if i == 1:
            pinned = staging._host[0]["tokens"]
    # consumed on the current stream, after the copies it waits for
    sums = [(o["tokens"].sum(), o["x"].sum()) for o in outs]
    torch.cuda.synchronize()
    for i, (t, x) in enumerate(sums):
        assert outs[i]["tokens"].device.type == "cuda"
        assert int(t) == i * 4 * (1 << 16) and float(x) == i * float(1 << 18)
    assert staging._slots[0] is outs[4] and staging._slots[1] is outs[5]
    assert staging._next == 0
    assert staging._host[0]["tokens"] is pinned and pinned.is_pinned()
    placement = offload_placement(cuda_device, offload=True)
    assert placement.pinned and placement.zeros((2, 3)).is_pinned()
    assert offload_placement(cuda_device, offload=False).device.type == "cuda"


def _split_decode_rank(rank, store, queue, pos):
    """One of two ranks sharing the card over gloo, the members of a
    ``data`` axis: decode attention at jamba's model member shape (B=1, a
    524,288-long cache of 4 kv heads, 32 query heads, hd 128, bf16 k/v
    drawn alike on both), this member's half of the rows through the
    two-stage softmax and the whole cache through one ``attend_decode``."""
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.core import prims
        from repro_torch.models import layers as L
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        S, KV, H, hd = 524288, 4, 32, 128
        gen = torch.Generator(device=dev).manual_seed(9)
        k = torch.randn((1, S, KV, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((1, S, KV, hd), generator=gen, device=dev).bfloat16()
        q = torch.randn((1, 1, H, hd), generator=gen, device=dev)
        lens = torch.full((1,), pos, device=dev)
        half = S // 2
        with prims.bind(prims.Mesh({"data": 2})):
            split = L.attend_decode(q, k[:, rank * half:(rank + 1) * half],
                                    v[:, rank * half:(rank + 1) * half], lens, "data")
        whole = L.attend_decode(q, k, v, lens)
        err = (split - whole).abs().max().item()
        scale = whole.abs().max().item()
        finite = bool(torch.isfinite(split).all())
        dist.destroy_process_group()
        queue.put((rank, (err, scale, finite), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [100003, 300001])
def test_split_decode_attention_matches_the_whole_on_card(cuda_device, tmp_path, pos):
    """``attend_decode`` over a cache split on its sequence between two
    ranks (``[serve-mesh]`` (d)): a ``pos`` where member 1's rows all lie
    past it (its max is -inf, the global one is used) and a ragged one
    inside member 1's rows; each member's fp32 output within 1e-6 of one
    ``attend_decode`` over the whole cache, and finite."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_split_decode_rank,
                         args=(r, str(tmp_path / "store"), queue, pos))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(2):
            rank, res, err = queue.get(timeout=600)
            assert err is None, err
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, (err, scale, finite) in out.items():
        assert finite and err <= 1e-6 * max(scale, 1.0), (rank, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", [(7, 1, 64), (16, 8, 128)])
def test_kernel_on_the_gathered_sequence_on_card(cuda_device, H, KV, hd):
    """K1 at ``chip_smoke.py`` ``[seq-par]``'s shapes, S=4096 gathered
    from the members' rows: (a) a model member's 7 of qwen2-0.5b's heads
    and its kv head, (b) every head of qwen3-1.7b (the context-parallel
    cell's whole blocks), bf16 in the model's layout, against the plain
    version at the bf16 tolerance."""
    from repro_torch.models import layers as L
    B, S = 1, 4096
    q = _randn(50, B, S, H, hd, dtype=torch.bfloat16, device=cuda_device)
    k = _randn(51, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    v = _randn(52, B, S, KV, hd, dtype=torch.bfloat16, device=cuda_device)
    before = kernel.LAUNCHES
    out = L.attend(q, k, v, causal=True, impl="kernel")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    G = H // KV
    exp = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True).transpose(1, 2)
    assert exp.shape == (B, S, H, hd) and G * KV == H
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2, rtol=2e-2)


def _seq_split_rank(rank, store, queue):
    """One of two ranks sharing the card over gloo, the members of a
    ``model`` axis: ``prims.scatter_sum`` and ``prims.split_replicated``
    on CUDA tensors along the sequence dim, forward and backward, against
    the whole tensors computed on this rank."""
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.core import prims
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        gen = torch.Generator(device=dev).manual_seed(7)
        # both members' parts and the gradients of their rows, drawn alike
        parts = torch.randn((2, 2, 512, 64), generator=gen, device=dev)
        grads = torch.randn((2, 2, 256, 64), generator=gen, device=dev)
        out = {}
        with prims.bind(prims.Mesh({"model": 2})):
            x = parts[rank].clone().requires_grad_(True)
            y = prims.scatter_sum(x, "model", 1)
            (g,) = torch.autograd.grad(y, x, grads[rank])
            out["scatter"] = (y - parts.sum(0)[:, rank * 256:(rank + 1) * 256]).abs().max().item()
            out["scatter_grad"] = (g - torch.cat([grads[0], grads[1]], 1)).abs().max().item()
            x = parts[0].clone().requires_grad_(True)  # alike on both
            y = prims.split_replicated(x, "model", 1)
            (g,) = torch.autograd.grad(y, x, grads[rank])
            out["split"] = (y - parts[0][:, rank * 256:(rank + 1) * 256]).abs().max().item()
            out["split_grad"] = (g - torch.cat([grads[0], grads[1]], 1)).abs().max().item()
            out["device"] = (y.device.type, g.device.type)
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


@pytest.mark.cuda
def test_sequence_split_functions_on_card(cuda_device, tmp_path):
    """The sequence split's autograd Functions on two ranks sharing the
    card over gloo, CUDA tensors: ``scatter_sum`` keeps each member's rows
    of the members' sum and gathers the rows' gradients in the backward;
    ``split_replicated`` keeps the member's rows of a tensor both hold
    alike and gathers likewise.  fp32 sums of two terms: within 1e-6."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_seq_split_rank,
                         args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(2):
            rank, res, err = queue.get(timeout=300)
            assert err is None, err
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, res in out.items():
        assert res.pop("device") == ("cuda", "cuda"), rank
        assert all(v <= 1e-6 for v in res.values()), (rank, res)


@pytest.mark.cuda
@pytest.mark.parametrize("H,S", [(16, 1024), (8, 32768)])
def test_wkv6_on_a_members_heads_over_the_gathered_sequence_on_card(cuda_device, H, S):
    """K3 through ``wkv6_ops.wkv6`` at ``chip_smoke.py`` ``[seq-par]``'s
    shapes, a model member's heads of rwkv6-1.6b's 32 over the sequence
    gathered from the members' rows: (g) train_4k at model = 2 (16 heads,
    S=1024) and (j) prefill_32k at model = 4 (8 heads, S=32768), bf16, the
    last member's heads a view of the model-layout tensors; y and the
    final state against the plain version at K3's tolerance."""
    r, k, v, w, u, s0 = _wkv_inputs(150, 1, 32, S, 64, torch.bfloat16, cuda_device)
    heads = slice(32 - H, 32)
    local = [a.transpose(1, 2).contiguous()[:, :, heads] for a in (r, k, v, w)]
    del r, k, v, w
    before = wkv_kernel.LAUNCHES
    y, sT = wkv_ops.wkv6(*local, u[heads], state=s0[:, heads])
    assert wkv_kernel.LAUNCHES == before + 1 and y.shape == (1, S, H, 64)
    ey, es = wkv6_ref(*(a.transpose(1, 2) for a in local), u[heads], s0[:, heads])
    _wkv_close(y, ey.transpose(1, 2))
    _wkv_close(sT, es)


@pytest.mark.cuda
@pytest.mark.parametrize("S,di", [(2048, 8192), (8192, 4096)])
def test_mamba_scan_over_the_gathered_sequence_on_card(cuda_device, S, di):
    """K4 through ``ms_ops.mamba_scan`` at ``chip_smoke.py`` ``[seq-par]``'s
    shapes, a model member's channels of one jamba Mamba layer (d_inner
    16384, d_state 16) over the sequence gathered from the members' rows:
    (h) at model = 2 (8192 channels, S=2048) and (j) the block's prefill at
    model = 4 (4096 channels, S=8192), bf16, the last member's channels;
    against the plain version at K4's tolerance."""
    u, dt, A, Bc, Cc, D, h0 = _ms_inputs(160, 1, S, 16384, 16, torch.bfloat16,
                                         cuda_device)
    ch = slice(16384 - di, 16384)
    args = (u[..., ch].contiguous(), dt[..., ch].contiguous(), A[ch], Bc, Cc,
            D[ch], h0[:, ch].contiguous())
    del u, dt
    before = ms_kernel.LAUNCHES
    got = ms_ops.mamba_scan(*args)
    assert ms_kernel.LAUNCHES == before + 1 and got[0].shape == (1, S, di)
    _ms_check(args, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (2, 8, 448, 64, "bfloat16"), (2, 8, 448, 64, "float32"),
    (1, 8, 4096, 128, "bfloat16"), (1, 8, 4096, 128, "float32")])
def test_kernel_on_a_members_heads_over_the_gathered_sequence_on_card(
        cuda_device, B, H, S, hd, dtype):
    """K1 through ``L.attend`` at ``chip_smoke.py`` ``[seq-par]``'s member
    shapes, model = 2: (i) whisper-medium's decoder, 8 of 16 heads over
    its 448-long gathered text (B=2), and (f) deepseek-moe-16b's train_4k,
    8 of 16 heads at hd 128 over S=4096, each in bf16 (its tolerance 2e-2)
    and fp32 (the fp32 holds', 1e-4), in the model's layout, against the
    plain version."""
    from repro_torch.models import layers as L
    dt = getattr(torch, dtype)
    q, k, v = (_randn(170 + i, B, S, H, hd, dtype=dt, device=cuda_device)
               for i in range(3))
    before = kernel.LAUNCHES
    out = L.attend(q, k, v, causal=True, impl="kernel")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    exp = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True).transpose(1, 2)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd", [(8, 4, 2, 64, 16), (8, 4, 2, 32, 16),
                                         (8, 8, 8, 256, 64)],
                         ids=["quickstart", "elastic_restart", "ddp_train"])
def test_kernel_at_the_examples_training_shapes_on_card(cuda_device, B, H, KV, S, hd):
    """K1's fp32 body through ``L.attend`` at the training twins' batches
    (``examples/*_torch.py``): quickstart's qwen2 smoke (8 x 64), the
    elastic restart's qwen3 smoke (8 x 32), ddp_train's 12-layer model (8 x
    256, 8 heads of 64), in the model's layout, against the plain version
    at the fp32 tolerance."""
    from repro_torch.models import layers as L
    q = _randn(180, B, S, H, hd, device=cuda_device)
    k, v = (_randn(181 + i, B, S, KV, hd, device=cuda_device) for i in range(2))
    before = kernel.LAUNCHES
    out = L.attend(q, k, v, causal=True, impl="kernel")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    exp = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True).transpose(1, 2)
    torch.testing.assert_close(out, exp, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_wkv6_over_gathered_whole_heads_on_card(cuda_device):
    """K3 at ``chip_smoke.py`` ``[train3]`` (e)'s shape, every head of
    rwkv6-1.6b's smoke (8 rows of 32, 4 heads of 16, fp32) on each member
    of a model axis of 8: r, k, v and w put together from the 8 members'
    column blocks as the tiled gather lays them out, then made contiguous
    and cut into heads as the time mix does; y and the final state against
    the plain version at K3's tolerance."""
    B, S, H, hd, n = 8, 32, 4, 16, 8
    r, k, v, w, u, s0 = _wkv_inputs(190, B, H, S, hd, torch.float32, cuda_device)

    def gathered(t):  # (B, H, S, hd) -> the members' (B, S, d / n) blocks, gathered
        cols = t.transpose(1, 2).reshape(B, S, H * hd)
        blocks = torch.stack(cols.chunk(n, dim=2))  # (n, B, S, d / n)
        moved = blocks.movedim(3, 1).reshape(n * H * hd // n, B, S)
        return moved.movedim(0, 2).contiguous().reshape(B, S, H, hd)

    heads = [gathered(t) for t in (r, k, v, w)]
    for got, t in zip(heads, (r, k, v, w)):
        assert torch.equal(got, t.transpose(1, 2))
    before = wkv_kernel.LAUNCHES
    y, sT = wkv_ops.wkv6(*heads, u, state=s0)
    assert wkv_kernel.LAUNCHES == before + 1 and y.shape == (B, S, H, hd)
    ey, es = wkv6_ref(r, k, v, w, u, s0)
    _wkv_close(y, ey.transpose(1, 2))
    _wkv_close(sT, es)


def _whole_heads_rank(rank, store, queue):
    """One of two ranks sharing the card over gloo, the members of a
    ``model`` axis: RWKV6's time mix with one head of 64 (d 64), so that
    its projections split over the two members and its head does not (``u``
    whole), through K3 on CUDA tensors, against the unsplit time mix on this
    rank."""
    import dataclasses
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.configs import get_smoke_arch
        from repro_torch.core import prims
        from repro_torch.models import ssm
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        arch = get_smoke_arch("rwkv6-1.6b")
        arch = arch.replace(rwkv=dataclasses.replace(arch.rwkv, head_size=64))
        gen = torch.Generator(device=dev).manual_seed(11)
        p = ssm.init_rwkv_time_mix(arch, gen, (), torch.float32, dev)
        for name in ("x_maa", "w_maa", "k_maa", "v_maa", "r_maa", "g_maa", "ln_bias"):
            p[name] = torch.randn(p[name].shape, generator=gen, device=dev) * 0.1
        x = torch.randn((2, 32, 64), generator=gen, device=dev)
        out_w, (_, wkv_w) = ssm.apply_rwkv_time_mix(arch, p, x, use_kernel=True)
        cols = slice(rank * 32, (rank + 1) * 32)
        mine = dict(p, wo=p["wo"][cols],
                    **{n: p[n][:, cols] for n in ("wr", "wk", "wv", "wg")})
        before = wkv_kernel.LAUNCHES
        with prims.bind(prims.Mesh({"model": 2})):
            out, (_, wkv) = ssm.apply_rwkv_time_mix(arch, mine, x, use_kernel=True,
                                                    axis="model")
        torch.cuda.synchronize()
        res = dict(launches=wkv_kernel.LAUNCHES - before,
                   out=(out - out_w).abs().max().item(),
                   wkv=(wkv - wkv_w).abs().max().item(),
                   scale=out_w.abs().max().item(), wkv_scale=wkv_w.abs().max().item(),
                   shape=tuple(wkv.shape))
        dist.destroy_process_group()
        queue.put((rank, res, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


@pytest.mark.cuda
def test_time_mix_over_whole_heads_on_card(cuda_device, tmp_path):
    """The time mix with its projections split over two members and its
    one head whole on each (the layout of ``[train3]`` (e) at model = 8),
    two ranks sharing the card over gloo: each member's output within 1e-5
    of its largest value of the unsplit time mix's, its ``wkv`` state (the
    whole head) within K3's atol, 2e-5 x (its largest value + 1) (the
    members' projections are other GEMMs than the whole one's, so they
    round apart), and one K3 launch a member."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_whole_heads_rank,
                         args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(2):
            rank, res, err = queue.get(timeout=300)
            assert err is None, err
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, res in out.items():
        assert res["launches"] == 1 and res["shape"] == (2, 1, 64, 64), (rank, res)
        assert res["out"] <= 1e-5 * res["scale"], (rank, res)
        assert res["wkv"] <= 2e-5 * (res["wkv_scale"] + 1), (rank, res)
