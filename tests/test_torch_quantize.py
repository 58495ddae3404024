"""The port's fused int8 quantize + error feedback (``repro_torch.kernels.
quantize``, kernel K2) and its int8 codec (``repro_torch.core.compression``)
held against the JAX package.

The plain version is the JAX codec op for op (``Int8Codec.encode``, then
``x - decode``), so q, scales and err are held to ``quantize_ef_ref``
bit for bit.  The JAX Pallas kernel in interpret mode is not bit-equal to
its own oracle on the CPU: XLA divides by 127 as a multiply by the
reciprocal and contracts ``x - q*scale`` into an FMA, so its scales move by
an ulp and err by up to ~127 ulps of the scale.  Against it the port is
held as ``tests/test_kernels.py`` holds it to the oracle: q bit for bit,
scales to rtol 1e-6, and err to 2.5e-5 of the block's scale (that test's
atol 1e-5 is absolute at unit-size inputs; these inputs span 12
decades).

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import randn  # noqa: E402

from repro.core import compression as jax_comp  # noqa: E402
from repro.kernels.quantize.kernel import quantize_ef_fwd as jax_kernel  # noqa: E402
from repro.kernels.quantize.ref import quantize_ef_ref as jax_ref  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels.quantize import kernel, ops  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ef_ref  # noqa: E402

# tests/test_kernels.py::test_quantize_ef's sweep
SWEEP = [(8192, 512), (4096, 2048), (2048, 128)]
# err against the JAX kernel, in units of the block's scale: one ulp of
# the scale times |q| <= 127, plus half an ulp of q * scale
ERR_TOL = 2.5e-5


def halves(n: int, block: int, seed: int) -> np.ndarray:
    """Blocks whose x/scale are exact halves k + 0.5 (ties for the
    rounding), each block's scale a power of two, with one all-zero
    block."""
    rng = np.random.default_rng(seed)
    c = 2.0 ** rng.integers(-8, 4, size=(n // block, 1))
    k = rng.integers(-127, 127, size=(n // block, block)) + 0.5
    k[:, 0] = 127.0  # absmax = 127 c, so scale = c exactly
    x = (k * c).astype(np.float32)
    x[:block] = 0.0
    return x.reshape(n)


def inputs(kind: str, n: int, block: int) -> np.ndarray:
    if kind == "randn":
        return randn(n + block, n, scale=3.0)
    if kind == "halves":
        return halves(n, block, seed=n + block)
    # mixed magnitudes and a zero block: scales over 12 decades
    x = randn(n - block, n).reshape(-1, block) * np.float32(10.0) ** \
        np.random.default_rng(n).integers(-8, 4, size=(n // block, 1))
    x[1] = 0.0
    return x.astype(np.float32).reshape(n)


def port(x: np.ndarray, block: int):
    return [t.numpy() for t in ops.quantize_ef(torch.from_numpy(x), block=block)]


@pytest.mark.parametrize("kind", ["randn", "halves", "mixed"])
@pytest.mark.parametrize("n,block", SWEEP)
def test_plain_bit_equal_to_jax_oracle(n, block, kind):
    x = inputs(kind, n, block)
    q, s, e = port(x, block)
    jq, js, je = (np.asarray(a) for a in jax_ref(jnp.asarray(x), block=block))
    assert q.dtype == np.int8 and s.dtype == e.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(e, je)
    # the residual is exact: x == decode(q, s) + err, block for block
    if kind == "halves":  # exact halves: the residual is exactly +-scale/2
        dec = q.reshape(-1, block).astype(np.float32) * s[:, None]
        np.testing.assert_array_equal(dec.reshape(-1) + e, x)


@pytest.mark.parametrize("kind", ["randn", "halves", "mixed"])
@pytest.mark.parametrize("n,block", SWEEP)
def test_plain_matches_jax_kernel(n, block, kind):
    x = inputs(kind, n, block)
    q, s, e = port(x, block)
    jq, js, je = (np.asarray(a) for a in
                  jax_kernel(jnp.asarray(x), block=block, interpret=True))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    np.testing.assert_allclose(e.reshape(-1, block) / s[:, None],
                               je.reshape(-1, block) / s[:, None], atol=ERR_TOL)


@pytest.mark.parametrize("n,block", SWEEP)
def test_bf16_input_matches_jax_kernel(n, block):
    """bf16 in: both kernels cast to fp32 first (``quantize/kernel.py:28``),
    while the JAX codec computes in bf16, so the JAX kernel is the
    reference here.  bf16 values put x/scale within an ulp of a half more
    often than fp32 ones, and there the JAX kernel's reciprocal scale may
    round the other way: q is held equal except at such near-ties, where
    it may differ by one."""
    x = randn(n, n, scale=3.0).astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    q, s, e = (t.numpy() for t in ops.quantize_ef(xt, block=block))
    jq, js, je = (np.asarray(a) for a in
                  jax_kernel(jnp.asarray(x), block=block, interpret=True))
    diff = q.astype(np.int32) - jq
    r = x.astype(np.float32).reshape(-1, block) / s[:, None]
    near_half = np.abs(np.abs(r - np.floor(r)) - 0.5).reshape(-1) < 1e-5
    assert np.abs(diff).max() <= 1 and near_half[diff != 0].all()
    assert (diff != 0).mean() < 1e-3
    np.testing.assert_allclose(s, js, rtol=1e-6)
    ok = diff.reshape(-1, block) == 0
    np.testing.assert_allclose((e.reshape(-1, block) / s[:, None])[ok],
                               (je.reshape(-1, block) / s[:, None])[ok],
                               atol=ERR_TOL)
    # and bit for bit with the plain version on the fp32 cast
    for a, b in zip((q, s, e), port(x.astype(np.float32), block)):
        np.testing.assert_array_equal(a, b)


def test_codec_matches_jax_codec():
    x = randn(5, 3 * 2048, scale=0.01)
    codec, jcodec = compression.Int8Codec(), jax_comp.Int8Codec()
    q, s = codec.encode(torch.from_numpy(x))
    jq, js = jcodec.encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(codec.decode(q, s).numpy(),
                                  np.asarray(jcodec.decode(jq, js)))
    assert codec.wire_bytes(6144) == jcodec.wire_bytes(6144)
    assert codec.name == jcodec.name
    # encode_ef is one pass: its residual is x - decode
    q2, s2, e2 = codec.encode_ef(torch.from_numpy(x))
    np.testing.assert_array_equal(
        e2.numpy(), x - np.asarray(jcodec.decode(jq, js)))


def test_make_codec():
    assert compression.make_codec(None) is None
    assert compression.make_codec("none") is None
    assert compression.make_codec("int8", block=512) == compression.Int8Codec(512)
    assert compression.make_codec("topk") == compression.TopKCodec()
    assert compression.make_codec("topk", k_frac=0.25, block=512) == \
        compression.TopKCodec(0.25)
    with pytest.raises(ValueError):
        compression.make_codec("fp4")


def test_plain_and_kernel_reject():
    x = torch.zeros(4096)
    with pytest.raises(ValueError, match="multiple"):
        quantize_ef_ref(torch.zeros(1000), block=512)
    # the CUDA wrapper refuses CPU tensors (no build is attempted)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize_ef_fwd(x)
    assert kernel.LAUNCHES == 0
