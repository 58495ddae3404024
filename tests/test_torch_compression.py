"""The port's top-k codec (``repro_torch.core.compression.TopKCodec``) held
against the JAX package's, bit for bit: ``k_of``, ``encode`` (the same
indices in the same order, values descending, ties to the lowest index),
``decode``, ``wire_bytes`` and ``name``, on integer-valued inputs full of
ties and on normals; a mirror of ``tests/test_properties.py``'s
``test_topk_keeps_largest``; and ``make_codec("topk")``.

The JAX codec runs eagerly on the CPU (``lax.top_k``), the port's on CPU
tensors (a stable descending sort of ``|x|``), so nothing here is a
tolerance: an index that differed would be a different top-k set.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

hypothesis = pytest.importorskip(
    "hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import compression as jax_comp  # noqa: E402
from repro_torch.core import compression  # noqa: E402

FRACS = (1 / 16, 0.25, 1.0)


def _input(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "ints":  # 17 values for n entries: ties everywhere
        return rng.integers(-8, 9, size=n).astype(np.float32)
    if kind == "signs":  # +v and -v tie on |x|
        return (rng.integers(0, 4, size=n) * rng.choice([-1, 1], size=n)
                ).astype(np.float32)
    if kind == "zeros":  # one n-way tie
        return np.zeros(n, np.float32)
    return rng.standard_normal(n).astype(np.float32)


CASES = [(kind, n, frac) for kind in ("ints", "signs", "zeros", "normal")
         for n in (64, 1000, 4096) for frac in FRACS]


@pytest.mark.parametrize("kind,n,frac", CASES,
                         ids=[f"{k}-{n}-{f:g}" for k, n, f in CASES])
def test_topk_matches_jax(kind, n, frac):
    x = _input(kind, n, seed=n)
    codec, jcodec = compression.TopKCodec(frac), jax_comp.TopKCodec(frac)
    assert codec.k_of(n) == jcodec.k_of(n)
    vals, idx = codec.encode(torch.from_numpy(x))
    jvals, jidx = jcodec.encode(jnp.asarray(x))
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    dec = codec.decode(vals, idx, n)
    np.testing.assert_array_equal(dec.numpy(),
                                  np.asarray(jcodec.decode(jvals, jidx, n)))
    # the EF invariant, exactly: what is kept plus what is left is x
    np.testing.assert_array_equal(dec.numpy() + (x - dec.numpy()), x)
    assert codec.wire_bytes(n) == jcodec.wire_bytes(n)
    assert codec.name == jcodec.name


def test_topk_ties_go_to_the_lowest_index():
    x = torch.tensor([1.0, -3.0, 3.0, 0.0, 3.0, -1.0, 2.0, 2.0])
    vals, idx = compression.TopKCodec(0.5).encode(x)
    assert idx.tolist() == [1, 2, 4, 6]
    assert vals.tolist() == [-3.0, 3.0, 3.0, 2.0]


@pytest.mark.parametrize("n", [1, 7, 15, 16, 17, 100])
def test_k_of_matches_jax(n):
    for frac in (1e-3, 1 / 16, 0.3, 1.0):
        assert compression.TopKCodec(frac).k_of(n) == \
            jax_comp.TopKCodec(frac).k_of(n)


@settings(max_examples=30, deadline=None)
@given(st.integers(16, 512), st.floats(0.05, 1.0), st.integers(0, 2**31 - 1))
def test_topk_keeps_largest(n, frac, seed):
    """``tests/test_properties.py::test_topk_keeps_largest`` on the port,
    plus the reference's indices."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    codec = compression.TopKCodec(k_frac=frac)
    vals, idx = codec.encode(torch.from_numpy(x))
    k = codec.k_of(n)
    kept = np.sort(np.abs(vals.numpy()))
    thresh = np.sort(np.abs(x))[-k]
    assert kept[0] >= thresh - 1e-6
    np.testing.assert_allclose(vals.numpy(), x[idx.numpy()], rtol=1e-6)
    if frac < 0.5:
        assert codec.wire_bytes(n) < n * 4
    _, jidx = jax_comp.TopKCodec(k_frac=frac).encode(jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_make_codec_topk():
    for frac in (None, 0.125, 1.0):
        kw = {} if frac is None else {"k_frac": frac}
        got = compression.make_codec("topk", block=512, **kw)
        want = jax_comp.make_codec("topk", block=512, **kw)
        assert isinstance(got, compression.TopKCodec)
        assert got.k_frac == want.k_frac and got.name == want.name
