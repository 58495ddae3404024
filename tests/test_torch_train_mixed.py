"""Training the port in bf16 — parameters and compute (the JAX cells'
setting), and bf16 parameters under an fp32 compute dtype — held against
the JAX package on the qwen2-0.5b smoke model with the same numpy weights
(drawn in bf16) and batch: the loss and every gradient leaf (``Model.loss``
under autograd vs ``jax.value_and_grad``), with remat none and full.

Tolerance: each element within atol = rtol = 2e-2, the JAX tests' bf16
tolerance (``tests/test_kernels.py``'s bf16 flash-attention case), and each
leaf within a relative error ||g - g_jax|| / ||g_jax|| of ``REL``, which
holds the leaves whose elements are all well under 2e-2 (the smoke
model's gradients are of order 1e-2 rms).  With bf16 compute every
product rounds to 8 bits of mantissa, in another order than XLA's: 3e-2,
about 8 bf16 ulps (2^-8); the worst leaf reads 2.0e-2 (``attn/bv``, a
sum over tokens).  With fp32 compute only the gradients' last cast to
bf16 rounds, so no element is off by more than one bf16 ulp and no leaf
by more than 2^-8 = 3.9e-3 of its norm; the worst reads 6.9e-5.  A zeroed
or missing gradient reads 1.

fp32 parameters under a bf16 compute dtype raise in both packages: the
JAX forward's layer scan meets a bf16 carry and an fp32 output."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (ARCH, jax_loss_and_grads, jax_model,  # noqa: E402
                           port_loss_and_grads, port_model, smoke_weights,
                           to_numpy, train_batch)

from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402

TOL = dict(atol=2e-2, rtol=2e-2)
REL = {"bf16": 3e-2, "bf16-params-fp32-compute": 2.0 ** -8}
DTYPES = {"bf16": ("bfloat16", "bfloat16"),
          "bf16-params-fp32-compute": ("bfloat16", "float32")}
CHUNK = 8


@pytest.fixture(scope="module")
def weights():
    return smoke_weights(seed=41, dtype="bfloat16")


@pytest.fixture(scope="module")
def batch():
    return train_batch(get_smoke_arch(ARCH), seed=42)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_loss_and_grads_match_jax(weights, batch, dtypes, remat):
    pdt, cdt = DTYPES[dtypes]
    jm = jax_model(dtype=pdt, compute_dtype=cdt, remat=remat, loss_chunk=CHUNK)
    jloss, jgrads = jax_loss_and_grads(jm, weights, batch)
    model = port_model(weights, dtype=pdt, compute_dtype=cdt, remat=remat,
                       loss_chunk=CHUNK)
    loss, grads = port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        assert g.dtype == torch.bfloat16, path  # the parameters' dtype
        got = to_numpy(g).astype(np.float64)
        want = jgrads[path].astype(np.float64)
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
        norm = np.linalg.norm(want)
        assert norm > 0, path
        rel = np.linalg.norm(got - want) / norm
        assert rel <= REL[dtypes], (
            f"{path}: relative error {rel:.3e} > {REL[dtypes]:.3e} "
            f"(max |g_jax| {np.abs(want).max():.3e})")


def test_fp32_params_bf16_compute_raises_in_both(weights, batch):
    """No reference: the JAX package's forward raises its scan-carry
    ``TypeError``; the port refuses the pair, naming ROADMAP.md."""
    jm = jax_model(dtype="float32", compute_dtype="bfloat16",
                   loss_chunk=CHUNK)
    with pytest.raises(TypeError, match="carry"):
        jm.loss(jm.init(jax.random.key(0)),
                {k: jax.numpy.asarray(v) for k, v in batch.items()})
    st = ModelSettings(param_dtype="float32", compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_smoke_arch(ARCH), st, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_in_place_equals_the_reference(dtype):
    """``adamw_leaf(inplace=True)`` (the sync's: moments updated where they
    lie) gives the functional update bit for bit, and both give the JAX
    ``adamw_leaf``'s to rtol 1e-5 (``test_torch_train_model.py``'s AdamW
    tolerance); a bf16 parameter is updated in fp32 and cast back."""
    import jax.numpy as jnp
    from repro.optim import adamw as jax_adamw
    from repro_torch.optim import adamw
    rng = np.random.default_rng(43)
    p = torch.from_numpy(rng.standard_normal(4099).astype(np.float32)).to(
        getattr(torch, dtype))
    g, m = (torch.from_numpy(rng.standard_normal(4099).astype(np.float32)) * 1e-3
            for _ in range(2))
    v = torch.from_numpy(rng.random(4099).astype(np.float32)) * 1e-6
    cfg, lr, clip = adamw.AdamWConfig(), torch.tensor(3e-4), torch.tensor(0.7)
    ref = adamw.adamw_leaf(p, g, m, v, 3, lr, cfg, clip)
    got = adamw.adamw_leaf(p, g.clone(), m.clone(), v.clone(), 3, lr, cfg, clip,
                           inplace=True)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ref[0].dtype == p.dtype
    jp = jnp.asarray(to_numpy(p))
    jout = jax_adamw.adamw_leaf(jp, jnp.asarray(g.numpy()), jnp.asarray(m.numpy()),
                                jnp.asarray(v.numpy()), jnp.int32(3), 3e-4,
                                jax_adamw.AdamWConfig(), 0.7)
    for a, b in zip(ref, jout):
        np.testing.assert_allclose(to_numpy(a).astype(np.float32),
                                   np.asarray(b).astype(np.float32), rtol=1e-5,
                                   atol=1e-8)
