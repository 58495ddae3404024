"""The port's mixture-of-experts layer (``repro_torch.models.layers``:
``moe_capacity``, ``moe_expert_capacities``, ``moe_dispatch_schedule``,
``init_moe``, ``apply_moe``, ``_execute_dispatch``, ``_moe_dispatch``) held
against the JAX package with the same numpy weights and inputs, fp32 at
atol = rtol = 1e-4; integer results and the executed dispatch schedule
exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, FP32, port_model, randn,  # noqa: E402
                           smoke_weights, to_numpy)

from repro.configs import get_smoke_arch as jax_smoke_arch  # noqa: E402
from repro.configs.base import ArchConfig as JaxArchConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core import schedule as jax_schedule  # noqa: E402
from repro.core import topology as jax_topology  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.convert import numpy_to_torch  # noqa: E402
from repro_torch.core import planner, schedule, topology  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(port, ref, **tol):
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), **(tol or TOL))


def moe_weights(arch, seed: int, lead=()):
    """The layer's leaves drawn with numpy, at init_moe's scales."""
    moe = arch.moe
    d, f, E = arch.d_model, moe.expert_d_ff, moe.num_experts
    p = {"router": randn(seed, *lead, d, E, scale=d ** -0.5),
         "we_in": randn(seed + 1, *lead, E, d, f, scale=d ** -0.5),
         "we_gate": randn(seed + 2, *lead, E, d, f, scale=d ** -0.5),
         "we_out": randn(seed + 3, *lead, E, f, d, scale=f ** -0.5)}
    if moe.num_shared_experts:
        fs = f * moe.num_shared_experts
        p["shared"] = {"wi": randn(seed + 4, *lead, d, fs, scale=d ** -0.5),
                       "wg": randn(seed + 5, *lead, d, fs, scale=d ** -0.5),
                       "wo": randn(seed + 6, *lead, fs, d, scale=fs ** -0.5)}
    return p


def _port(p):
    return {k: _port(v) if isinstance(v, dict) else numpy_to_torch(v)
            for k, v in p.items()}


def _jax(p):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in p.items()}


def archs(name=DEEPSEEK, **moe):
    """(the JAX smoke arch, the port's), the MoE config's fields replaced."""
    jarch, arch = jax_smoke_arch(name), get_smoke_arch(name)
    if moe:
        jarch = jarch.replace(moe=dataclasses.replace(jarch.moe, **moe))
        arch = arch.replace(moe=dataclasses.replace(arch.moe, **moe))
    return jarch, arch


def port_drops(arch, p, x, **kw):
    """(apply_moe's output, aux, the (token, k) slots it dropped)."""
    L.DROP_LOG = []
    try:
        y, aux = L.apply_moe(arch, p, x, **kw)
        drops = int(sum(d.sum() for d in L.DROP_LOG))
    finally:
        L.DROP_LOG = None
    return y, aux, drops


# ---------------------------------------------------------------------------
# capacities: integers equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,top_k,experts,cf", [
    (64, 2, 8, 1.25), (32, 2, 8, 1.25), (8, 6, 64, 1.25), (8192, 6, 64, 1.25),
    (64, 6, 64, 64 / 6), (512, 6, 64, 1.25), (7, 2, 4, 4.0), (1024, 1, 16, 0.5)])
def test_moe_capacity_matches_jax(tokens, top_k, experts, cf):
    assert L.moe_capacity(tokens, top_k, experts, cf) == \
        JL.moe_capacity(tokens, top_k, experts, cf)


@pytest.mark.parametrize("counts,tokens,cf", [
    ([1024 * 6 / 64] * 64, 1024, 1.25), ([0, 1], 1024, 1.0),
    ([10_000], 64, 1.0), ([3, 17, 40, 0, 9], 48, 1.25)])
def test_moe_expert_capacities_match_jax(counts, tokens, cf):
    got = L.moe_expert_capacities(counts, tokens, cf)
    assert got == JL.moe_expert_capacities(counts, tokens, cf)
    assert all(isinstance(c, int) for c in got)


def test_top_k_breaks_ties_to_the_lowest_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1],
                  [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    vals, idx = L.top_k(torch.from_numpy(x), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]


# ---------------------------------------------------------------------------
# the layer against JAX apply_moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", ["drops", "smoke", "full-capacity"])
def test_apply_moe_matches_jax(groups, case):
    """Output and aux at three capacity factors: 0.5 (C = 8, half the mean
    load an expert, so slots are dropped), the smoke config's 1.25, and
    num_experts / top_k (C = T: nothing can drop)."""
    cf = {"drops": 0.5, "smoke": None, "full-capacity": 8 / 2}[case]
    jarch, arch = archs(**({} if cf is None else {"capacity_factor": cf}))
    p = moe_weights(arch, seed=10)
    x = randn(20, 2, 32, arch.d_model)
    jy, jaux = JL.apply_moe(jarch, _jax(p), jnp.asarray(x), groups=groups)
    y, aux, drops = port_drops(arch, _port(p), torch.from_numpy(x), groups=groups)
    _close(y, jy)
    _close(aux, jaux)
    if case != "smoke":
        assert (drops > 0) == (case == "drops")


def test_apply_moe_groups_do_not_share_routing():
    """groups=2 routes each half of the tokens on its own: the first
    group's output is that of the first half alone."""
    _, arch = archs()
    p = _port(moe_weights(arch, seed=11))
    x = torch.from_numpy(randn(21, 2, 32, arch.d_model))
    y2, _ = L.apply_moe(arch, p, x, groups=2)
    y1, _ = L.apply_moe(arch, p, x[:1], groups=1)
    torch.testing.assert_close(y2[:1], y1, atol=1e-6, rtol=1e-6)


def test_moe_matches_bruteforce_at_full_capacity():
    """tests/test_system.py's case: at capacity factor 4 nothing drops, so
    the layer is every expert computed densely and combined with the
    renormalised top-2 gates; and it is JAX apply_moe."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab=64)
    arch = ArchConfig(**kw, moe=MoEConfig(num_experts=4, top_k=2,
                                          expert_d_ff=32, capacity_factor=4.0))
    jarch = JaxArchConfig(**kw, moe=JaxMoEConfig(num_experts=4, top_k=2,
                                                 expert_d_ff=32,
                                                 capacity_factor=4.0))
    p = moe_weights(arch, seed=30)
    x = randn(31, 2, 8, 16)
    out, aux, drops = port_drops(arch, _port(p), torch.from_numpy(x))
    assert drops == 0 and np.isfinite(to_numpy(out)).all() and float(aux) > 0
    jout, jaux = JL.apply_moe(jarch, _jax(p), jnp.asarray(x))
    _close(out, jout)
    _close(aux, jaux)

    xt = x.reshape(16, 16).astype(np.float64)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    gi = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    gv = np.take_along_axis(probs, gi, -1)
    gv /= gv.sum(-1, keepdims=True)
    dense = []
    for e in range(4):
        a = xt @ p["we_in"][e]
        h = a / (1 + np.exp(-a)) * (xt @ p["we_gate"][e])
        dense.append(h @ p["we_out"][e])
    dense = np.stack(dense, 1)  # (T, E, d)
    expect = np.einsum("tk,tkd->td", gv,
                       np.take_along_axis(dense, gi[..., None], axis=1))
    np.testing.assert_allclose(to_numpy(out).reshape(16, 16), expect, **TOL)


def test_init_moe_matches_jax_tree():
    """The same leaves, shapes and dtypes as JAX init_moe, stacked under a
    group dim; the router fp32 in a bf16 layer."""
    jarch, arch = archs()
    jp = jax.eval_shape(lambda k: JL.init_moe(jarch, k, jnp.bfloat16),
                        jax.random.key(0))
    p = L.init_moe(arch, torch.Generator().manual_seed(0), (3,),
                   torch.bfloat16, "cpu")

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    jflat, pflat = flat(jp), flat(p)
    assert sorted(jflat) == sorted(pflat)
    for k, v in pflat.items():
        assert tuple(v.shape) == (3,) + jflat[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(jflat[k].dtype), k
    assert pflat["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the executed dispatch schedule, the skew-planned capacity, drift checks
# ---------------------------------------------------------------------------


def _cxl_fabric(topo_mod, pods):
    return topo_mod.as_fabric(topo_mod.TwoTierTopology(
        num_pods=pods, pod_shape=(1,))).with_paths(topo_mod.cxl_shortcut_path())


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunks,offset", [(1, 0), (2, 1), (3, 2)])
def test_apply_moe_executes_schedule_bitwise(groups, chunks, offset):
    """tests/test_skew.py's case: a 4-member all-to-all schedule, at each
    chunking x lane offset x path split x group count, executed through
    the dispatch is bitwise the unscheduled layer, which is JAX's."""
    jarch, arch = archs()
    moe, n, T = arch.moe, 4, 64
    p = moe_weights(arch, seed=40)
    x = randn(41, 2, 32, arch.d_model)
    C = L.moe_capacity(T // groups, moe.top_k, moe.num_experts,
                       moe.capacity_factor)
    numel = n * groups * (moe.num_experts // n) * C * arch.d_model
    cfg = schedule.SyncConfig(chunks=chunks,
                              path_split=(("cxl", 0.5),) if chunks > 1 else None)
    s = schedule.build_all_to_all(_cxl_fabric(topology, n), cfg,
                                  (n, numel // n), "float32").with_lane_offset(offset)
    assert s.slow_legs
    pt, xt = _port(p), torch.from_numpy(x)
    y0, a0 = L.apply_moe(arch, pt, xt, groups=groups)
    y1, a1 = L.apply_moe(arch, pt, xt, groups=groups, dispatch_schedule=s)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    jy, jaux = JL.apply_moe(jarch, _jax(p), jnp.asarray(x), groups=groups)
    _close(y1, jy)
    _close(a1, jaux)


def test_execute_dispatch_walks_every_chunk_in_issue_order():
    """The walk itself, on a buffer that does not divide evenly into the
    chunks: bitwise its input, and the identity when there is no exchange."""
    s = schedule.build_all_to_all(
        _cxl_fabric(topology, 4), schedule.SyncConfig(chunks=3),
        (4, 2 * 3 * 5), "float32").with_lane_offset(1)
    assert [leg.index for leg in s.slow_legs] != sorted(leg.index for leg in s.slow_legs)
    xe = torch.arange(1 * 8 * 3 * 5, dtype=torch.float32).reshape(1, 8, 3, 5)
    assert torch.equal(L._execute_dispatch(s, xe), xe)
    one = schedule.build_all_to_all(_cxl_fabric(topology, 1),
                                    schedule.SyncConfig(), (1, 8), "float32")
    assert L._execute_dispatch(one, xe) is xe


def _planners(pods=2, members=2):
    """(the JAX planner, the port's) over pods x members devices."""
    out = []
    for topo, plan in ((jax_topology, jax_planner), (topology, planner)):
        fab = topo.as_fabric(topo.TwoTierTopology(num_pods=pods,
                                                  pod_shape=(members,)))
        out.append(plan.Planner(fab, min_chunk_numel=1 << 6))
    return out


def test_moe_dispatch_schedule_matches_jax():
    """The uniform plan: the same shape and the same legs as JAX's, and
    executed by the layer bitwise the unscheduled dispatch."""
    jarch, arch = archs()
    jpl, pl = _planners()
    assert pl.domain_size == 4
    for groups in (1, 2):
        js = JL.moe_dispatch_schedule(jarch, 64, jpl, groups=groups)
        s = L.moe_dispatch_schedule(arch, 64, pl, groups=groups)
        assert s.kind == "all_to_all" and s.shape == js.shape
        assert s.to_json() == js.to_json()
        pt = _port(moe_weights(arch, seed=45))
        x = torch.from_numpy(randn(46, 2, 32, arch.d_model))
        y0, _ = L.apply_moe(arch, pt, x, groups=groups)
        y1, _ = L.apply_moe(arch, pt, x, groups=groups, dispatch_schedule=s)
        assert torch.equal(y0, y1)


def test_skew_planned_capacity_matches_jax():
    """tests/test_skew.py's cases: a schedule planned from measured router
    logits carries per-member dest_sizes and C_exec = max_e C_e; the
    layer dispatches at it, as JAX's does; a hot expert makes a hot
    destination; a logits shape that does not cover the tokens raises."""
    jarch, arch = archs()
    jpl, pl = _planners()
    p = moe_weights(arch, seed=50)
    x = randn(51, 2, 32, arch.d_model)
    logits = x.reshape(64, arch.d_model) @ p["router"]
    js = JL.moe_dispatch_schedule(jarch, 64, jpl, router_logits=logits)
    s = L.moe_dispatch_schedule(arch, 64, pl,
                                router_logits=torch.from_numpy(logits))
    assert s.to_json() == js.to_json()
    assert any(leg.dest_sizes is not None for leg in s.slow_legs)
    y, aux, _ = port_drops(arch, _port(p), torch.from_numpy(x),
                           dispatch_schedule=s)
    jy, jaux = JL.apply_moe(jarch, _jax(p), jnp.asarray(x), dispatch_schedule=js)
    _close(y, jy)
    _close(aux, jaux)
    # a hot expert 0 (owned by member 0): the hot destination is member 0
    hot = np.random.default_rng(0).gumbel(size=(128, 8)).astype(np.float32)
    hot[:, 0] += 4.0
    s = L.moe_dispatch_schedule(arch, 128, pl, router_logits=hot)
    js = JL.moe_dispatch_schedule(jarch, 128, jpl, router_logits=hot)
    assert s.to_json() == js.to_json()
    a2a0 = next(leg for leg in s.legs if isinstance(leg, schedule.AllToAll))
    assert a2a0.dest_sizes[0] > a2a0.dest_sizes[1]
    for mod, plan, ar in ((L, pl, arch), (JL, jpl, jarch)):
        with pytest.raises(ValueError, match="router_logits"):
            mod.moe_dispatch_schedule(ar, 128, plan, router_logits=hot[:64])


def _drift_cases(sched_mod, topo_mod, layers_mod, arch, plan):
    """Each schedule the layer must refuse, built with one package's
    modules: (name, schedule, the error's text)."""
    moe, d = arch.moe, arch.d_model
    fab4 = topo_mod.as_fabric(topo_mod.TwoTierTopology(num_pods=4, pod_shape=(1,)))
    fab3 = topo_mod.as_fabric(topo_mod.TwoTierTopology(num_pods=3, pod_shape=(1,)))
    C = layers_mod.moe_capacity(64, moe.top_k, moe.num_experts, moe.capacity_factor)
    ok = 4 * (moe.num_experts // 4) * C * d
    reduce = sched_mod.build_schedule(fab4, sched_mod.SyncConfig(), (4, ok // 4))
    skewed = layers_mod.moe_dispatch_schedule(
        arch, 64, plan, router_logits=np.random.default_rng(1).standard_normal(
            (64, moe.num_experts)).astype(np.float32))
    return [
        ("all-reduce", reduce, "all_to_all schedule"),
        ("three members", sched_mod.build_all_to_all(
            fab3, sched_mod.SyncConfig(), (3, 8 * d), "float32"), "does not divide"),
        ("other tokens", sched_mod.build_all_to_all(
            fab4, sched_mod.SyncConfig(), (4, (ok + 4 * d) // 4), "float32"),
         "different dispatch buffer"),
        ("skewed slabs", dataclasses.replace(
            skewed, shape=(skewed.shape[0], skewed.shape[1] + 1)),
         "different dispatch buffer")]


def test_capacity_drift_raises_where_jax_does():
    """A schedule of the wrong kind, over members that do not divide the
    experts, planned for another token count, or skew-planned with a
    payload that does not divide into expert slabs: ValueError in both."""
    jarch, arch = archs()
    jpl, pl = _planners()
    x = randn(60, 2, 32, arch.d_model)
    p = moe_weights(arch, seed=61)
    ours = _drift_cases(schedule, topology, L, arch, pl)
    theirs = _drift_cases(jax_schedule, jax_topology, JL, jarch, jpl)
    assert [c[0] for c in ours] == [c[0] for c in theirs]
    for (name, s, msg), (_, js, _) in zip(ours, theirs):
        with pytest.raises(ValueError, match=msg):
            JL.apply_moe(jarch, _jax(p), jnp.asarray(x), dispatch_schedule=js)
        with pytest.raises(ValueError, match=msg):
            L.apply_moe(arch, _port(p), torch.from_numpy(x), dispatch_schedule=s)
    # the planner refuses experts that do not divide over its domain
    jpl3, pl3 = _planners(pods=3, members=1)
    for mod, plan, ar in ((L, pl3, arch), (JL, jpl3, jarch)):
        with pytest.raises(ValueError, match="does not divide"):
            mod.moe_dispatch_schedule(ar, 64, plan)


def test_dispatch_spec_is_not_ported(tmp_path):
    """``dispatch_spec`` (dp, tp), the JAX package's placement hint, is
    ported as the expert placement: with no ``tp``, or a ``tp`` of one
    member, the layer is the one without it, bit for bit; leaves that do
    not hold the experts the axis gives a member raise.  The split over
    two members is held against the JAX layer in
    ``test_torch_tp.py``."""
    import torch.distributed as dist
    from repro_torch.core import prims
    _, arch = archs()
    p = _port(moe_weights(arch, seed=0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 8, arch.d_model)).astype(np.float32))
    want = L.apply_moe(arch, p, x)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with prims.bind(prims.Mesh({"data": 1, "model": 1})):
            for spec in (("data", None), ("data", "model")):
                got = L.apply_moe(arch, p, x, dispatch_spec=spec)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
            half = {k: (v[:v.shape[0] // 2] if k.startswith("we_") else v)
                    for k, v in p.items()}
            with pytest.raises(ValueError, match="experts"):
                L.apply_moe(arch, half, x, dispatch_spec=("data", "model"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# MoE in the model
# ---------------------------------------------------------------------------


def test_bf16_model_keeps_the_router_fp32():
    """The one leaf where param_dtype does not rule: built, loaded from a
    bf16 JAX tree (whose router is fp32) and moved, it stays fp32."""
    flat = smoke_weights(seed=70, dtype="bfloat16", arch=DEEPSEEK)
    assert flat["blocks/l0/moe/router"].dtype == np.float32
    assert flat["blocks/l0/moe/we_in"].dtype.name == "bfloat16"
    model = port_model(flat, dtype="bfloat16", arch=DEEPSEEK)
    model.to("cpu")
    leaves = dict(model.named_parameters())
    assert leaves["blocks.l0.moe.router"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in leaves.items()
               if not k.endswith("router"))
    np.testing.assert_array_equal(to_numpy(leaves["blocks.l0.moe.router"]),
                                  flat["blocks/l0/moe/router"])
    logits, _ = model.prefill(torch.zeros(1, 4, dtype=torch.long))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_moe_groups_setting_reaches_the_layer():
    """``ModelSettings.moe_groups`` is the layer's ``groups``: prefill with
    2 groups is JAX's with moe_groups=2."""
    from torch_harness import jax_model, jax_params
    weights = smoke_weights(seed=71, arch=DEEPSEEK)
    toks = np.random.default_rng(72).integers(0, 512, (2, 16)).astype(np.int32)
    jl, _ = jax_model(arch=DEEPSEEK, moe_groups=2).prefill(
        jax_params(weights), jnp.asarray(toks))
    model = port_model(weights, arch=DEEPSEEK, moe_groups=2)
    l2, _ = model.prefill(torch.from_numpy(toks).long())
    _close(l2, jl)
    l1, _ = port_model(weights, arch=DEEPSEEK).prefill(torch.from_numpy(toks).long())
    assert not torch.allclose(l1, l2)


def test_moe_layers_follow_the_layer_ids():
    """Every deepseek layer has experts; Jamba's at odd offsets of a block,
    with the dense MLP at the even ones."""
    ds = build_model(get_smoke_arch(DEEPSEEK), ModelSettings(**FP32), device="meta")
    assert set(dict(ds.blocks.l0.named_children())) == {"ln1", "ln2", "attn", "moe"}
    jamba = build_model(get_smoke_arch("jamba-1.5-large-398b"),
                        ModelSettings(**FP32), device="meta")
    for off in range(8):
        kids = set(dict(getattr(jamba.blocks, f"l{off}").named_children()))
        assert ("moe" in kids) == (off % 2 == 1) and ("mlp" in kids) == (off % 2 == 0)


@pytest.mark.parametrize("G,N,E", [(1, 12, 4), (2, 64 * 6, 64), (3, 257, 8)])
def test_slab_positions_equal_the_one_hot_cumsum(G, N, E):
    """The position of each slot in its expert's slab is the JAX package's
    one-hot cumsum count, integer for integer, skewed routing included."""
    rng = np.random.default_rng(N)
    flat_e = rng.integers(0, E, (G, N))
    flat_e[:, : N // 3] = rng.integers(0, 2, (G, N // 3))  # two hot experts
    onehot = jax.nn.one_hot(jnp.asarray(flat_e), E, dtype=jnp.int32)
    want = np.asarray(jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1))
    got = L._slab_positions(torch.from_numpy(flat_e), E)
    np.testing.assert_array_equal(got.numpy(), want)
