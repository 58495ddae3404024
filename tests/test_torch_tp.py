"""Tensor parallelism in the port: the model split over a ``model`` axis of
gloo ranks (local heads with a row-parallel ``wo``, column- then
row-parallel MLPs, RWKV6 time and channel mixes on local heads and d_ff,
Mamba on local channels of d_inner, the vocab-sharded embedding and loss,
experts split over the axis, whisper's encoder and cross attention on
local heads and its learned positions' d columns gathered), and the
DFabric ``Trainer`` on (pod, data, model) = (2, 2, 2), held against the
JAX package.

Loss and gradients.  The smoke models' loss and every leaf's gradient,
put together from the members' blocks, against the JAX single-device
``value_and_grad`` on the same weights and batch: fp32, rtol 1e-5 (the
sums over the members run in another order than one device's); RWKV6's
gradients at the tolerance its unsharded ones meet
(``torch_harness.grad_tolerance``).  Every block two members hold alike
(the replicated leaves: norm scales, the router, ``q_norm``/``k_norm``,
RWKV6's token-shift mix and its LoRA) is bit-equal across them.

Trainer.  The battery's DFabric runs (``tests/batteries/train_battery.py``)
against the JAX ``Trainer`` on 8 fake devices, to the tolerances of the DP
trainer tests (``test_torch_trainer.py``): loss curve rtol 1e-4 (1e-3 with
the int8 codec), final parameters atol 2e-5 (the key biases to 2 x lr x
steps; with int8 99% of them, every one to 2 x lr x steps), the sync state
put together by its merged specs against the JAX global arrays.  A TP
run's checkpoint is restored on a DP mesh of the port (its sections
re-cut leaf by leaf) and by the JAX ``Trainer`` on the TP mesh; so is a
jamba run's, whose Mamba ``w_in`` each model member holds as its channels
of both halves (``sharding.Paired``) while the checkpoint holds the
reference's global array.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, JAMBA, RECURRENT_FAR, RWKV, WHISPER,  # noqa: E402
                           assemble_blocks, check_round_trip,
                           check_state_round_trip, check_tp_run,
                           grad_tolerance, jax_loss_and_grads, jax_model,
                           jax_tp_runs, rank_second_cut, rank_tp_grads,
                           rank_tp_trainer, smoke_archs, smoke_weights, spawn_ranks,
                           train_batch, zero_gradient, NOISE)

QWEN3 = "qwen3-1.7b"
TP2 = {"data": 1, "model": 2}
MESH = {"pod": 2, "data": 2, "model": 2}


# ---------------------------------------------------------------------------
# loss and gradients at model = 2
# ---------------------------------------------------------------------------


GRAD_CASES = [("qwen2-0.5b", "none"), (QWEN3, "none"), (DEEPSEEK, "none"),
              ("qwen2-0.5b", "full"), (DEEPSEEK, "dots"),
              (RWKV, "none"), (RWKV, "full"), (JAMBA, "none"), (JAMBA, "full"),
              (WHISPER, "none"), (WHISPER, "full")]


def _case(arch):
    weights = smoke_weights(seed=5, arch=arch, experts=True)
    arch_ = smoke_archs(arch, experts=True)[1]
    batch = train_batch(arch_, seed=9, B=2, S=16)
    if arch_.is_encdec:  # the encoder's frame embeddings
        batch["frames"] = np.random.default_rng(10).standard_normal(
            (2, arch_.encoder.n_frames, arch_.d_model)).astype(np.float32)
    return weights, batch


@pytest.fixture(scope="module")
def grad_runs():
    """Every case's ranks in one spawn (the ranks' start-up dominates)."""
    cases = [dict(zip(("weights", "batch"), _case(arch)), arch=arch,
                  sizes=TP2, remat=remat, loss_chunk=8)
             for arch, remat in GRAD_CASES]
    out = spawn_ranks(2, rank_tp_grads, dict(cases=cases))
    return {c: [r[i] for r in out] for i, c in enumerate(GRAD_CASES)}


@pytest.mark.parametrize("arch,remat", GRAD_CASES)
def test_loss_and_grads_match_jax(grad_runs, arch, remat):
    """A recomputed layer runs its sums over the axis again in the
    backward; the result is the same."""
    weights, batch = _case(arch)
    jloss, jgrads = jax_loss_and_grads(
        jax_model(arch=arch, experts=True, loss_chunk=8), weights, batch)
    out = grad_runs[(arch, remat)]
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = assemble_blocks([(g, c, s) for _, g, c, s, _ in out],
                            {k: v.shape for k, v in jgrads.items()}, TP2, arch)
    specs = out[0][3]
    assert any("model" in sp for sp in specs.values())
    for k, g in grads.items():
        if zero_gradient(arch, k):  # rounding noise in both packages
            assert max(np.abs(g).max(), np.abs(jgrads[k]).max()) <= NOISE, k
            continue
        np.testing.assert_allclose(g, jgrads[k], err_msg=k,
                                   **grad_tolerance(arch, jgrads[k]))
    if arch == DEEPSEEK:  # the experts split over the axis
        assert out[0][1]["blocks/l0/moe/we_in"].shape[1] == 4
    if arch == RWKV:  # 2 of the smoke's 4 heads, 64 of its 128 d_ff
        assert out[0][1]["blocks/l0/tmix/u"].shape[1] == 2
        assert out[0][1]["blocks/l0/cmix/wv"].shape[1] == 64
    if arch == JAMBA:  # 64 of d_inner's 128 channels in xs and in z
        assert out[0][1]["blocks/l0/mamba/w_in"].shape[2] == 2 * 64
        assert out[0][1]["blocks/l0/mamba/A_log"].shape[1] == 64
    if arch == WHISPER:  # 2 of the 4 heads in the encoder and the cross
        # attention, 32 of pos_embed's 64 columns
        assert out[0][1]["enc_blocks/attn/wq"].shape[2] == 2
        assert out[0][1]["blocks/l0/xattn/wk"].shape[2] == 2
        assert out[0][1]["pos_embed"].shape[1] == 32


# ---------------------------------------------------------------------------
# the DFabric Trainer on (2, 2, 2)
# ---------------------------------------------------------------------------

RUNS = {  # name: (arch, TrainerConfig fields); the battery's dfabric runs
    "qwen3-zero1": (QWEN3, dict(mode="dfabric", zero1=True, codec=None)),
    "qwen3-int8-paper": (QWEN3, dict(mode="dfabric", zero1=False, codec="int8")),
    "deepseek-zero1": (DEEPSEEK, dict(mode="dfabric", zero1=True)),
    "jamba-zero1": (JAMBA, dict(mode="dfabric", zero1=True)),
    "rwkv-zero1": (RWKV, dict(mode="dfabric", zero1=True)),
    "whisper-zero1": (WHISPER, dict(mode="dfabric", zero1=True)),
}
DP = {"pod": 2, "data": 4, "model": 1}
CK = dict(mode="dfabric", zero1=True, ckpt_every=2)
ON = dict(steps=6)  # the restored runs train on to step 6


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Both packages' runs: those of ``RUNS``; a checkpointed qwen3 TP run
    (steps 2 and 4), restored at step 4 on the DP mesh ``DP`` by the port
    and on the TP mesh by the JAX ``Trainer``, each training on to step 6;
    the same for the port's jamba run of ``RUNS``, which checkpoints
    (the JAX one does not)."""
    tmp = tmp_path_factory.mktemp("tp")
    weights = {a: smoke_weights(seed=7, arch=a, experts=True)
               for a in (QWEN3, DEEPSEEK, JAMBA, RWKV, WHISPER)}
    runs = [dict(name=n, arch=a, sizes=MESH, cfg=c) for n, (a, c) in RUNS.items()]
    ck = dict(CK, ckpt_dir=str(tmp / "tp"))
    # the jamba checkpoint's copies: the port restores one on the DP mesh
    # (no step: its experts route per DP member in the DFabric step, so a
    # DP mesh's losses are another run's) and one on the TP mesh, as the
    # JAX Trainer does (which cannot re-cut a sync state for a DP mesh)
    jamba = {k: str(tmp / f"jamba-{k}") for k in ("dp", "tp", "jax")}
    port = [dict(r, cfg=dict(r["cfg"], **CK, ckpt_dir=jamba["dp"]),
                 copy_to=[jamba["tp"], jamba["jax"]])
            if r["name"] == "jamba-zero1" else r for r in runs] + [
        dict(name="ckpt", arch=QWEN3, sizes=MESH, cfg=ck,
             copy_to=str(tmp / "tp-jax")),
        dict(name="dp-restore", arch=QWEN3, sizes=DP, cfg=ck, train=ON),
        dict(name="jamba-dp-restore", arch=JAMBA, sizes=DP,
             cfg=dict(CK, ckpt_dir=jamba["dp"])),
        dict(name="jamba-restore", arch=JAMBA, sizes=MESH, train=ON,
             cfg=dict(CK, ckpt_dir=jamba["tp"]))]
    recs = spawn_ranks(8, rank_tp_trainer, dict(weights=weights, runs=port),
                       timeout=900)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.utils.trees import tree_paths
    step4 = tree_paths(CheckpointManager(jamba["jax"], read_only=True)
                       .restore(4)["params"])
    jax = jax_tp_runs(runs + [
        dict(name="restore", arch=QWEN3, sizes=MESH, restore=True, train=ON,
             cfg=dict(CK, ckpt_dir=str(tmp / "tp-jax"))),
        dict(name="jamba-restore", arch=JAMBA, sizes=MESH, restore=True,
             train=ON, cfg=dict(CK, ckpt_dir=jamba["jax"]))], weights)
    port = {run["name"]: [r[i] for r in recs] for i, run in enumerate(port)}
    return jax, port, step4


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(trainer_runs, name):
    jax, port, _ = trainer_runs
    arch, cfg = RUNS[name]
    check_tp_run(name, port[name], jax, MESH, cfg,
                 far_share=RECURRENT_FAR if arch in (JAMBA, RWKV) else 0.0,
                 arch=arch)


def test_tp_checkpoint_restores_on_a_dp_mesh_and_in_jax(trainer_runs):
    """The TP run's step-4 checkpoint (the global arrays) restored by the
    port on a DP mesh, where the plan packs other sections (re-cut leaf
    by leaf), and by the JAX ``Trainer`` on the TP mesh: both train steps
    4 and 5 alike.  The checkpointed run itself matches the uncheckpointed
    one bit for bit."""
    jax, port, _ = trainer_runs
    for a, b in zip(port["ckpt"], port["qwen3-zero1"]):
        assert a["losses"] == b["losses"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    dp = port["dp-restore"]
    assert all(r["restored"] for r in dp) and len(dp[0]["losses"]) == 2
    assert set(dp[0]["state"]) != set(port["ckpt"][0]["state"])  # re-cut
    check_tp_run("restore", dp, jax, DP, CK, steps=ON["steps"], state=False)


def test_a_second_step_function_keeps_the_cut():
    """``make_dfabric_train_step`` twice on one model at model = 2: the
    second call finds the model cut for its layout and keeps every block
    (a second cut would halve the heads, the ff and the vocab rows again);
    a step then runs.  A step function for another layout (the GSPMD
    step's FSDP) raises rather than cut the blocks again."""
    batch = train_batch(smoke_archs("qwen2-0.5b")[1], seed=9, B=2, S=16)
    for cuts, want, loss, err in spawn_ranks(2, rank_second_cut,
                                             dict(sizes=TP2, batch=batch)):
        assert cuts[0] == want and cuts[1] == want
        assert want["embed"][0] * 2 == smoke_archs("qwen2-0.5b")[1].vocab
        assert np.isfinite(loss)
        assert err is not None and "already cut" in err


def test_jamba_tp_checkpoint_holds_the_global_w_in(trainer_runs):
    """The jamba TP run's step-4 checkpoint: its Mamba ``w_in`` is the
    global array of the reference's layout, bit for bit the members'
    paired blocks put together (and not their blocks side by side, which
    would put member 1's xs channels among z's).  The port restores it on
    the DP mesh (every leaf whole, the checkpoint's bit for bit), and the
    JAX ``Trainer`` and the port on the TP mesh, where both train steps 4
    and 5 alike."""
    jax, port, step4 = trainer_runs
    recs = port["jamba-zero1"]
    path = "blocks/l0/mamba/w_in"
    assert recs[0]["specs"][path] == (None, None, "model")
    shapes = {k: v.shape for k, v in step4.items()}
    params = assemble_blocks([(r["params"], r["coords"], r["specs"]) for r in recs],
                             shapes, MESH, "jamba")
    for k, v in step4.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
    side_by_side = np.concatenate([r["params"][path] for r in recs
                                   if dict(r["coords"])["pod"] == 0
                                   and dict(r["coords"])["data"] == 0], axis=-1)
    assert not np.array_equal(side_by_side, step4[path])
    # the reference's own run of the same steps, to its tolerance
    np.testing.assert_allclose(step4[path], jax["jamba-zero1/p/" + path],
                               atol=2e-5, rtol=0)
    dp = port["jamba-dp-restore"]
    assert all(r["restored"] for r in dp) and dp[0]["losses"] == []
    for r in dp:
        for k, v in step4.items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    tp = port["jamba-restore"]
    assert all(r["restored"] for r in tp) and len(tp[0]["losses"]) == 2
    check_tp_run("jamba-restore", tp, jax, MESH, CK, steps=ON["steps"],
                 state=False, far_share=RECURRENT_FAR)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
@pytest.mark.parametrize("fsdp", [False, True])
def test_blocks_round_trip(arch, fsdp):
    """``local_block`` and ``assemble`` round-trip every leaf of the rwkv6
    and jamba smokes on (2, 2, 2), with and without FSDP over ``data``;
    ``w_in``'s block holds the member's channels of both halves."""
    specs = check_round_trip(arch, MESH, fsdp)
    if arch == JAMBA:
        from repro_torch.models.sharding import Paired
        assert isinstance(specs["blocks/l0/mamba/w_in"][-1], Paired)


def test_sync_state_round_trips_at_a_fast_tier_of_4():
    """The jamba smoke's DFabric sync state on (pod, data, model) =
    (2, 4, 2): every entry's blocks put back together are the global
    array, and ``w_in``'s section keeps its paired cut over ``model``
    beside the scatter over ``data``, whose dim it does not share."""
    from repro_torch.models.sharding import Paired
    from repro_torch.optim.grad_sync import merge_specs
    leaves, specs = check_state_round_trip(JAMBA, {"pod": 2, "data": 4, "model": 2})
    (sec,) = [n for n, paths in leaves.items() if paths == ("blocks/l0/mamba/w_in",)]
    for spec in specs[sec].values():
        assert isinstance(spec[-1], Paired) and "data" in spec[:-1], spec
    with pytest.raises(ValueError, match="paired"):
        merge_specs((None, "data"), (None, Paired("model")), 2)
