"""The port's GSPMD step: FSDP over ``data`` and TP over ``model``, the
batch over the DP axes, held against the JAX package.

Loss and gradients.  With the model cut for FSDP x TP on (data, model) =
(2, 2), each member's loss is its rows' share of the batch mean; summed
over the DP axes it is the JAX single-device loss, and the gradient
blocks (FSDP's reduce-scatter, the other DP axes summed) put together
are its gradients: fp32, rtol 1e-5 (RWKV6's at the tolerance its
unsharded gradients meet, ``torch_harness.grad_tolerance``).  The
deepseek, rwkv6 and jamba smokes (experts included) run the same grid; a
MoE layer routes the whole batch as one group, as the JAX package's
``jax.jit`` of the global batch does, and deepseek's batch overflows the
capacity, so the members' dropped slots, summed, are the unsharded
model's, layer by layer.

Trainer.  qwen3's smoke config in ``mode="gspmd"`` on (pod, data, model)
= (2, 2, 2), as ``tests/batteries/train_battery.py`` runs it, against the
JAX ``Trainer``: the loss curve to rtol 1e-4, the final parameters to atol
2e-5, the moments ``m`` and ``v`` (global arrays put together from the
blocks) to 1e-4 of their range.  A GSPMD checkpoint (the JAX package's
``{"m", "v", "step"}`` global arrays) is restored by the JAX ``Trainer``
and by the port on another mesh, (pod, data, model) = (1, 4, 2), and both
train on alike.  The deepseek, rwkv6 and jamba smokes in ``mode="gspmd"``
on (2, 2, 2) against the JAX ``Trainer`` in ``mode="gspmd"``, deepseek's
also in two microbatches (each the JAX step's contiguous global rows);
deepseek's step-4 checkpoint restored by the port on (1, 4, 2):
parameters and moments bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, JAMBA, RECURRENT_FAR, RWKV,  # noqa: E402
                           assemble_blocks, check_tp_run, grad_tolerance,
                           jax_loss_and_grads, jax_model, jax_tp_runs,
                           port_drops, port_model, rank_gspmd_zero_opt,
                           rank_tp_grads, rank_tp_trainer, smoke_archs,
                           smoke_weights, spawn_ranks, train_batch)

QWEN3 = "qwen3-1.7b"
FT = {"data": 2, "model": 2}
MESH = {"pod": 2, "data": 2, "model": 2}
ELASTIC = {"pod": 1, "data": 4, "model": 2}
#: the JAX GSPMD step's Mamba ``conv_w`` gradient is ``data``'s size times
#: the single-device one (ROADMAP.md queue 3), so the reference's jamba
#: GSPMD run takes a mesh without FSDP; the step's result is the global
#: batch's on any mesh
JAMBA_JAX_MESH = {"pod": 4, "data": 1, "model": 2}
GSPMD = dict(mode="gspmd")
CK = dict(mode="gspmd", ckpt_every=2)
ON = dict(steps=6)
GRAD_ARCHS = ("qwen2-0.5b", QWEN3, DEEPSEEK, RWKV, JAMBA)
FAMILIES = (DEEPSEEK, RWKV, JAMBA)  # the smokes with their experts
#: the MoE smoke's GSPMD run in two microbatches: one row a member each
MOE_MB2 = dict(name=f"{DEEPSEEK}-gspmd-mb2", arch=DEEPSEEK, sizes=MESH,
               cfg=dict(GSPMD, microbatches=2))


def _case(arch):
    experts = arch in FAMILIES
    weights = smoke_weights(seed=5, arch=arch, experts=experts)
    batch = train_batch(smoke_archs(arch, experts=experts)[1], seed=9, B=4, S=16)
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
    experts = arch in FAMILIES
    jloss, jgrads = jax_loss_and_grads(
        jax_model(arch=arch, loss_chunk=8, experts=experts), weights, batch)
    out = grad_runs[arch]
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    specs = out[0][3]
    if arch == RWKV:
        assert specs["blocks/l0/tmix/wr"] == (None, "data", "model")
        assert out[0][1]["blocks/l0/tmix/wr"].shape[1:] == (32, 32)  # d/2, d/2
    elif arch == JAMBA:
        assert specs["blocks/l0/mamba/w_in"] == (None, "data", "model")
        assert out[0][1]["blocks/l0/mamba/w_in"].shape[1:] == (32, 128)
    else:
        assert specs["blocks/l0/attn/wq"] == (None, "data", "model", None)
        assert out[0][1]["blocks/l0/attn/wq"].shape[1:3] == (32, 2)  # d/2, H/2
    grads = assemble_blocks([(g, c, s) for _, g, c, s, _ in out],
                            {k: v.shape for k, v in jgrads.items()}, FT, arch)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k,
                                   **grad_tolerance(arch, jgrads[k]))
    if arch == DEEPSEEK:  # the whole batch's capacity, slots in its order
        want = port_drops(port_model(weights, arch=arch, experts=True,
                                     loss_chunk=8), batch)
        members = [r for r in out if dict(r[2])["model"] == 0]
        got = [sum(r[4][i] for r in members) for i in range(len(want))]
        assert all(n > 0 for n in want) and got == want, (got, want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's GSPMD run, a checkpointed one (steps 2 and 4) and its
    step-4 checkpoint restored on ``ELASTIC``, training on to 6; the JAX
    GSPMD run and the JAX restore of a copy of that checkpoint."""
    tmp = tmp_path_factory.mktemp("gspmd")
    weights = {a: smoke_weights(seed=7, arch=a, experts=a in FAMILIES)
               for a in (QWEN3,) + FAMILIES}
    ck = dict(CK, ckpt_dir=str(tmp / "g"))
    ck_moe = dict(CK, ckpt_dir=str(tmp / "moe"))
    families = [dict(name=f"{a}-gspmd", arch=a, sizes=MESH, cfg=GSPMD)
                for a in FAMILIES]
    port = [dict(name="gspmd", arch=QWEN3, sizes=MESH, cfg=GSPMD),
            dict(name="ckpt", arch=QWEN3, sizes=MESH, cfg=ck,
                 copy_to=str(tmp / "g-jax")),
            dict(name="restore", arch=QWEN3, sizes=ELASTIC, cfg=ck, train=ON)] + [
        dict(f, cfg=ck_moe) if f["arch"] == DEEPSEEK else f for f in families] + [
        MOE_MB2,
        # the MoE run's step-4 checkpoint on another mesh, no step taken
        dict(name="moe-restore", arch=DEEPSEEK, sizes=ELASTIC, cfg=ck_moe)]
    recs = spawn_ranks(8, rank_tp_trainer, dict(weights=weights, runs=port),
                       timeout=900)
    jax = jax_tp_runs([
        dict(name="gspmd", arch=QWEN3, sizes=MESH, cfg=GSPMD),
        dict(name="restore", arch=QWEN3, sizes=MESH, restore=True, train=ON,
             cfg=dict(CK, ckpt_dir=str(tmp / "g-jax")))] + [
        dict(f, sizes=JAMBA_JAX_MESH) if f["arch"] == JAMBA else f
        for f in families] + [MOE_MB2], weights)
    return jax, {run["name"]: [r[i] for r in recs] for i, run in enumerate(port)}


def test_gspmd_trainer_matches_jax(runs):
    jax, port = runs
    check_tp_run("gspmd", port["gspmd"], jax, MESH, GSPMD)
    specs = port["gspmd"][0]["specs"]
    assert specs["embed"] == ("model", "data")  # vocab TP x FSDP


@pytest.mark.parametrize("arch", FAMILIES)
def test_gspmd_trainer_families_match_jax(runs, arch):
    """The deepseek (MoE: the whole batch one dispatch group), rwkv6 and
    jamba smokes in the GSPMD step on (2, 2, 2) against the JAX
    ``Trainer``'s GSPMD runs (jamba's on ``JAMBA_JAX_MESH``), to
    ``check_tp_run``'s tolerances, the recurrent smokes' with
    ``RECURRENT_FAR`` (the deepseek run checkpoints at steps 2 and 4, the
    JAX one does not)."""
    jax, port = runs
    check_tp_run(f"{arch}-gspmd", port[f"{arch}-gspmd"], jax, MESH, GSPMD,
                 far_share=RECURRENT_FAR if arch in (JAMBA, RWKV) else 0.0)


def test_gspmd_moe_microbatches_match_jax(runs):
    """The deepseek smoke in the GSPMD step with two microbatches against
    the JAX ``Trainer``'s: the JAX step's microbatch *i* is the global
    batch's contiguous rows ``[i B/2, (i+1) B/2)``, routed as one group
    (its capacity, slot order and aux loss), so each member takes its
    share of each of them (``Trainer.local_batch``), not two slices of a
    contiguous block of its own."""
    jax, port = runs
    name = MOE_MB2["name"]
    check_tp_run(name, port[name], jax, MESH, MOE_MB2["cfg"])


def test_gspmd_moe_checkpoint_restores_bit_for_bit(runs):
    """The deepseek GSPMD run's step-4 checkpoint, restored by the port on
    (1, 4, 2): the parameters and the moments, put together from the
    blocks, are the run's own bit for bit."""
    jax, port = runs
    name = f"{DEEPSEEK}-gspmd"
    saved, rest = port[name], port["moe-restore"]
    assert all(r["restored"] for r in rest) and rest[0]["losses"] == []
    for key, specs, tag in (("params", "specs", "p"), ("state", "state_specs", "s")):
        shapes = {k[len(f"{name}/{tag}/"):]: v.shape for k, v in jax.items()
                  if k.startswith(f"{name}/{tag}/")}
        a = assemble_blocks([(r[key], r["coords"], r[specs]) for r in saved],
                            shapes, MESH, name)
        b = assemble_blocks([(r[key], r["coords"], r[specs]) for r in rest],
                            shapes, ELASTIC, "moe-restore")
        for k, v in a.items():
            np.testing.assert_array_equal(b[k], v, err_msg=k)


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
