"""The port's GSPMD step: FSDP over ``data`` and TP over ``model``, the
batch over the DP axes, held against the JAX package.

Loss and gradients.  With the model cut for FSDP x TP on (data, model) =
(2, 2), each member's loss is its rows' share of the batch mean; summed
over the DP axes it is the JAX single-device loss, and the gradient
blocks (FSDP's reduce-scatter, the other DP axes summed) put together
are its gradients: fp32, rtol 1e-5.

Trainer.  qwen3's smoke config in ``mode="gspmd"`` on (pod, data, model)
= (2, 2, 2), as ``tests/batteries/train_battery.py`` runs it, against the
JAX ``Trainer``: the loss curve to rtol 1e-4, the final parameters to atol
2e-5, the moments ``m`` and ``v`` (global arrays put together from the
blocks) to 1e-4 of their range.  A GSPMD checkpoint (the JAX package's
``{"m", "v", "step"}`` global arrays) is restored by the JAX ``Trainer``
and by the port on another mesh, (pod, data, model) = (1, 4, 2), and both
train on alike.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (assemble_blocks, check_tp_run,  # noqa: E402
                           jax_loss_and_grads, jax_model, jax_tp_runs,
                           rank_gspmd_zero_opt, rank_tp_grads,
                           rank_tp_trainer, smoke_archs, smoke_weights,
                           spawn_ranks, train_batch)

QWEN3 = "qwen3-1.7b"
FT = {"data": 2, "model": 2}
MESH = {"pod": 2, "data": 2, "model": 2}
ELASTIC = {"pod": 1, "data": 4, "model": 2}
GSPMD = dict(mode="gspmd")
CK = dict(mode="gspmd", ckpt_every=2)
ON = dict(steps=6)
GRAD_ARCHS = ("qwen2-0.5b", QWEN3)


def _case(arch):
    weights = smoke_weights(seed=5, arch=arch)
    batch = train_batch(smoke_archs(arch)[1], seed=9, B=4, S=16)
    return weights, batch


@pytest.fixture(scope="module")
def grad_runs():
    cases = [dict(zip(("weights", "batch"), _case(a)), arch=a, sizes=FT,
                  fsdp=True, remat="full", loss_chunk=8) for a in GRAD_ARCHS]
    out = spawn_ranks(4, rank_tp_grads, dict(cases=cases))
    return {a: [r[i] for r in out] for i, a in enumerate(GRAD_ARCHS)}


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_fsdp_tp_loss_and_grads_match_jax(grad_runs, arch):
    weights, batch = _case(arch)
    jloss, jgrads = jax_loss_and_grads(jax_model(arch=arch, loss_chunk=8),
                                       weights, batch)
    out = grad_runs[arch]
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    specs = out[0][3]
    assert specs["blocks/l0/attn/wq"] == (None, "data", "model", None)
    assert out[0][1]["blocks/l0/attn/wq"].shape[1:3] == (32, 2)  # d/2, H/2
    grads = assemble_blocks([(g, c, s) for _, g, c, s in out],
                            {k: v.shape for k, v in jgrads.items()}, FT, arch)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jgrads[k]).max(),
                                   err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's GSPMD run, a checkpointed one (steps 2 and 4) and its
    step-4 checkpoint restored on ``ELASTIC``, training on to 6; the JAX
    GSPMD run and the JAX restore of a copy of that checkpoint."""
    tmp = tmp_path_factory.mktemp("gspmd")
    weights = {QWEN3: smoke_weights(seed=7, arch=QWEN3)}
    ck = dict(CK, ckpt_dir=str(tmp / "g"))
    port = [dict(name="gspmd", arch=QWEN3, sizes=MESH, cfg=GSPMD),
            dict(name="ckpt", arch=QWEN3, sizes=MESH, cfg=ck,
                 copy_to=str(tmp / "g-jax")),
            dict(name="restore", arch=QWEN3, sizes=ELASTIC, cfg=ck, train=ON)]
    recs = spawn_ranks(8, rank_tp_trainer, dict(weights=weights, runs=port),
                       timeout=600)
    jax = jax_tp_runs([
        dict(name="gspmd", arch=QWEN3, sizes=MESH, cfg=GSPMD),
        dict(name="restore", arch=QWEN3, sizes=MESH, restore=True, train=ON,
             cfg=dict(CK, ckpt_dir=str(tmp / "g-jax")))], weights)
    return jax, {run["name"]: [r[i] for r in recs] for i, run in enumerate(port)}


def test_gspmd_trainer_matches_jax(runs):
    jax, port = runs
    check_tp_run("gspmd", port["gspmd"], jax, MESH, GSPMD)
    specs = port["gspmd"][0]["specs"]
    assert specs["embed"] == ("model", "data")  # vocab TP x FSDP


def test_gspmd_checkpoint_restores_in_both_packages(runs):
    """The checkpointed run is the plain one bit for bit; its step-4
    checkpoint, restored by the port on (1, 4, 2) and by the JAX
    ``Trainer`` on (2, 2, 2), trains on alike (the moments too)."""
    jax, port = runs
    for a, b in zip(port["ckpt"], port["gspmd"]):
        assert a["losses"] == b["losses"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    rest = port["restore"]
    assert all(r["restored"] for r in rest) and len(rest[0]["losses"]) == 2
    check_tp_run("restore", rest, jax, ELASTIC, CK, steps=ON["steps"])


def test_zero_moment_specs_match_jax():
    import types
    from jax.sharding import PartitionSpec as P
    from repro.runtime import train_loop as jtl
    from repro_torch.models import ModelSettings, build_model
    from repro_torch.runtime.train_loop import mesh_info, zero_moment_specs
    from repro_torch.utils.trees import tree_paths
    model = build_model(smoke_archs(QWEN3)[1], ModelSettings(
        param_dtype="float32", compute_dtype="float32"), device="meta")
    shapes = tree_paths(model.param_shapes())
    specs = tree_paths(model.param_specs(mesh_info(MESH, fsdp=True)))
    got = zero_moment_specs(shapes, specs, MESH)
    jm = jax_model(arch=QWEN3)
    # the functions read the mesh's axis names and shape only
    mesh = types.SimpleNamespace(axis_names=tuple(MESH),
                                 devices=np.empty(tuple(MESH.values())))
    jspecs = jm.param_specs(jtl.mesh_info(mesh, fsdp=True))
    want = tree_paths(jtl.zero_moment_specs(jm.param_shapes(), jspecs, mesh))
    assert set(got) == set(want)
    for k, sp in got.items():
        assert P(*sp) == want[k], (k, sp, want[k])
    assert any(sp != tuple(specs[k]) + (None,) * (len(sp) - len(specs[k]))
               for k, sp in got.items())


def test_zero_opt_step_equals_the_plain_one():
    """With the moments split further over the mesh (``zero_opt``), each
    member updates its part of its block and the parts are gathered: the
    parameters come out bit for bit those of the plain layout."""
    out = spawn_ranks(4, rank_gspmd_zero_opt, dict(
        weights=smoke_weights(seed=7, arch=QWEN3), sizes=FT))
    for plain, zero, mshapes in out:
        for k in plain:
            np.testing.assert_array_equal(plain[k], zero[k], err_msg=k)
        assert mshapes["blocks/l0/ln1/scale"] != plain["blocks/l0/ln1/scale"].shape
