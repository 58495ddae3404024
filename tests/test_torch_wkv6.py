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


# launch_config over the shapes the kernel takes: B*H from 1*1 to 8*32
GRIDS = [(1, 1), (1, 4), (2, 3), (1, 32), (2, 32), (4, 32), (8, 32)]
LENGTHS = [1, 31, 32, 33, 2048]


@pytest.mark.parametrize("hd", kernel.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_config_fits_the_card(hd, dtype):
    for B, H in GRIDS:
        for S in LENGTHS:
            cfg = kernel.launch_config(B, H, S, hd, dtype)
            R, C = cfg.rows, cfg.cols
            assert (R, C) in kernel.MICRO_TILES
            assert hd % cfg.nj == 0 and (hd // cfg.nj) % C == 0
            assert (hd // cfg.nj) % 4 == 0  # y is written 4 columns a thread
            compute = (hd // R) * (hd // cfg.nj // C)
            assert cfg.threads == -(-compute // 32) * 32 + kernel.HELPERS <= 1024
            assert cfg.smem == kernel.smem_bytes(hd, dtype.itemsize, R, cfg.nj,
                                                 cfg.tile, cfg.stages)
            assert cfg.smem <= 232_448
            assert cfg.tile == min(S, kernel.TILE) and cfg.stages in (3, 4)
            assert cfg.blocks == B * H * cfg.nj
            if B * H * (hd // 4) >= 128:
                assert cfg.blocks >= 128
            if B * H >= 128:  # the grid is full without a split
                assert cfg.nj == 1


def test_launch_config_main_path():
    """rwkv6-1.6b's prefill (4, 32, 2048, 64) bf16 takes the preferred
    micro-tile unsplit, two tiles in flight; one long prompt (B = 1) splits
    each head's columns over 4 blocks."""
    main = kernel.launch_config(4, 32, 2048, 64, torch.bfloat16)
    assert (main.rows, main.cols) == kernel.MICRO_TILES[0]
    assert (main.nj, main.blocks, main.stages, main.tile) == (1, 128, 4, 32)
    assert main.threads == 128 + kernel.HELPERS
    one = kernel.launch_config(1, 32, 2048, 64, torch.bfloat16)
    assert (one.nj, one.blocks) == (4, 128)
    assert one.threads >= kernel.MIN_THREADS + kernel.HELPERS


def test_launch_config_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim 48"):
        kernel.launch_config(1, 2, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        kernel.launch_config(1, 2, 8, 64, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        kernel.launch_config(1, 2, 0, 64, torch.float32)
    with pytest.raises(ValueError, match="micro-tile"):
        kernel.make_config(1, 2, 64, torch.float32, (2, 2), 1, 8, 4)
    with pytest.raises(ValueError, match="nj"):
        kernel.make_config(1, 2, 16, torch.float32, (8, 4), 8, 8, 4)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.make_config(4, 32, 64, torch.float32, (4, 2), 1, 32, 4)


def test_copy_bytes_is_the_widest_chunk_every_row_starts_on():
    """r, k, v, w as the kernel takes them: (B, H, S, hd) views of wider
    (B, S, H, .) rows; the chunk is the largest power of two up to 16 that
    divides every data pointer and every outer byte stride."""
    x = torch.zeros(2, 40, 4, 80, dtype=torch.bfloat16)
    wide = torch.zeros(2, 40, 4, 66)  # fp32 rows 264 bytes apart
    assert x.data_ptr() % 16 == 0 and wide.data_ptr() % 16 == 0

    def views(off, w_off=0, w_src=None):
        rkv = x[..., off:off + 64].transpose(1, 2)
        w = (w_src if w_src is not None else torch.zeros(2, 40, 4, 64))
        return rkv, rkv, rkv, w[..., w_off:w_off + 64].transpose(1, 2)

    assert kernel.copy_bytes(*views(0)) == 16
    assert kernel.copy_bytes(*views(4)) == 8
    assert kernel.copy_bytes(*views(2)) == 4
    assert kernel.copy_bytes(*views(1)) == 2
    assert kernel.copy_bytes(*views(0, 0, wide)) == 8
    assert kernel.copy_bytes(*views(0, 1, wide)) == 4
    # a dim of length 1 constrains nothing: a decode step's S stride
    one = torch.zeros(3, 64).as_strided((1, 3, 1, 64), (7, 64, 7, 1))
    assert kernel.copy_bytes(one, one, one, one) == 16


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
