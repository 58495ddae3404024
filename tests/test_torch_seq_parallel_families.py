"""The sequence split of the MoE, RWKV6, Mamba and encoder-decoder layers,
whisper under the GSPMD step and a planned MoE dispatch schedule over
split experts and the GSPMD step's token routing, held against the JAX
package on the CPU.

  * the smokes' loss and every leaf's gradient at (data, model) = (1, 2)
    with the residual stream's sequence split over ``model``
    (``seq_axis``): deepseek-moe-16b, rwkv6-1.6b, jamba with its experts
    and whisper-medium, the gradients put together from the members'
    blocks against JAX's single-device ``value_and_grad``; the router's,
    the channel mix's ``wr``'s and the norms' on their own;
  * on (2, 2, 2), against the JAX ``Trainer`` on 8 fake devices: the
    DFabric step with ``seq_axis`` (deepseek, rwkv6, whisper), the GSPMD
    step with ``seq_axis``/``batch_axes`` (deepseek; jamba on (4, 1, 2):
    the reference scales Mamba's ``conv_w`` gradient by the FSDP size,
    ROADMAP.md queue 3), whisper under the GSPMD step with and without the
    split: losses, parameters and moments after the steps;
  * prefill with the split on (data, model) = (2, 4) (deepseek, rwkv6,
    jamba): each member's logits and cache blocks against the JAX ``jit``
    of ``prefill`` on the same mesh and the port's prefill without the
    split (the recurrent states are the whole sequence's);
  * ``apply_moe`` with a planned dispatch schedule, the experts split over
    ``model`` and/or the rows split over ``data`` (``token_axes``): bit-equal
    to the unscheduled layer on every member, the members' outputs within
    ``tests/test_torch_moe.py``'s tolerance of JAX's layer with the same
    schedule; a schedule planned for one member's tokens raises.

Tolerances are ``test_torch_seq_parallel.py``'s.  One spawn a world size
(2, 4 and 8 gloo ranks); the JAX runs in two subprocesses on 8 fake
devices.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (DEEPSEEK, FP32, JAMBA, MAX_SEQ,  # noqa: E402
                           RECURRENT_FAR, RWKV, TRAIN, TRAIN_LOSS_CHUNK, TRAIN_SHAPE,
                           WHISPER, assemble_blocks, check_tp_run, grad_tolerance,
                           port_model, randn, rank_moe_schedule, rank_seq_parallel,
                           redraw, run_jax_devices, smoke_archs, spawn_ranks,
                           train_batch, zero_gradient)

from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.runtime.train_loop import mesh_info  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

FAMILIES = (DEEPSEEK, RWKV, JAMBA, WHISPER)
TP2 = {"data": 1, "model": 2}
MESH = {"pod": 2, "data": 2, "model": 2}
JAMBA_MESH = {"pod": 4, "data": 1, "model": 2}
PREFILL_MESH = {"data": 2, "model": 4}
SP = dict(seq_axis="model")
SP_GSPMD = dict(seq_axis="model", batch_axes=("pod", "data"))
STEPS = 2  # the Trainer runs'
# the Trainer runs, on both packages: name: (arch, sizes, TrainerConfig
# fields, ModelSettings fields)
RUNS = {"deepseek-dfabric-sp": (DEEPSEEK, MESH, dict(mode="dfabric"), SP),
        "rwkv6-dfabric-sp": (RWKV, MESH, dict(mode="dfabric"), SP),
        "whisper-dfabric-sp": (WHISPER, MESH, dict(mode="dfabric"), SP),
        "deepseek-gspmd-sp": (DEEPSEEK, MESH, dict(mode="gspmd"), SP_GSPMD),
        "jamba-gspmd-sp": (JAMBA, JAMBA_MESH, dict(mode="gspmd"), SP_GSPMD),
        "whisper-gspmd": (WHISPER, MESH, dict(mode="gspmd"), {}),
        "whisper-gspmd-sp": (WHISPER, MESH, dict(mode="gspmd"), SP_GSPMD)}
PREFILLS = {f"{a}-prefill": dict(
    name=f"{a}-prefill", arch=a, sizes=PREFILL_MESH,
    settings=dict(seq_axis="model", batch_axes=("data",)),
    tokens=np.random.default_rng(31).integers(
        0, get_smoke_arch(a).vocab, (4, 16)).astype(np.int32))
    for a in (DEEPSEEK, RWKV, JAMBA)}

_WEIGHTS = {}  # each arch's drawn once in the module


def _weights(arch):
    """Every leaf of the smoke tree (experts included; whisper's learned
    positions ``MAX_SEQ`` rows) redrawn from seed 5."""
    if arch not in _WEIGHTS:
        meta = build_model(get_smoke_arch(arch), ModelSettings(**FP32, max_seq=MAX_SEQ),
                           device="meta")
        _WEIGHTS[arch] = redraw(tree_paths(meta.param_shapes()), 5)
    return _WEIGHTS[arch]


def _batch(arch):
    """Two rows of 16 tokens (whisper: with its frame embeddings)."""
    a = smoke_archs(arch, experts=True)[1]
    batch = train_batch(a, seed=9, B=2, S=16)
    if a.is_encdec:
        batch["frames"] = np.random.default_rng(10).standard_normal(
            (2, a.encoder.n_frames, a.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the planned dispatch schedule's cases: (name, split experts, token_axes,
# groups, skew-planned)
# ---------------------------------------------------------------------------

SCHED_MESH = {"data": 2, "model": 2}
SCHED_CASES = [("split", True, False, 1, False), ("split-groups", True, False, 2, False),
               ("tokens", False, True, 2, False), ("both", True, True, 1, False),
               ("both-skewed", True, True, 1, True)]
SCHED_T = 64  # the whole batch's tokens: 2 rows of 32


def _sched_inputs():
    """(the MoE layer's numpy leaves, the input (2, 32, d), the router
    logits of its tokens)."""
    arch = get_smoke_arch(DEEPSEEK)
    moe, d = arch.moe, arch.d_model
    f, E = moe.expert_d_ff, moe.num_experts
    fs = f * moe.num_shared_experts
    p = {"router": randn(70, d, E, scale=d ** -0.5),
         "we_in": randn(71, E, d, f, scale=d ** -0.5),
         "we_gate": randn(72, E, d, f, scale=d ** -0.5),
         "we_out": randn(73, E, f, d, scale=f ** -0.5),
         "shared": {"wi": randn(74, d, fs, scale=d ** -0.5),
                    "wg": randn(75, d, fs, scale=d ** -0.5),
                    "wo": randn(76, fs, d, scale=fs ** -0.5)}}
    x = randn(77, 2, 32, d)
    return p, x, x.reshape(SCHED_T, d) @ p["router"]


def _schedule(pkg, groups, skewed, logits, tokens=SCHED_T):
    """One package's schedule of a case (``pkg`` "repro_torch" or the
    reference's "repro"): a 4-member all-to-all at chunks 2 and lane offset
    1 over a CXL shortcut, for the dispatch buffer of ``tokens`` tokens;
    or skew-planned from the router ``logits`` by the planner over 2 x 2
    members."""
    import importlib
    sched_mod, plan_mod, topo_mod, layers_mod = (
        importlib.import_module(f"{pkg}.{m}") for m in
        ("core.schedule", "core.planner", "core.topology", "models.layers"))
    arch = importlib.import_module(f"{pkg}.configs").get_smoke_arch(DEEPSEEK)
    moe, d = arch.moe, arch.d_model
    if skewed:
        fab = topo_mod.as_fabric(topo_mod.TwoTierTopology(num_pods=2, pod_shape=(2,)))
        return layers_mod.moe_dispatch_schedule(
            arch, tokens, plan_mod.Planner(fab, min_chunk_numel=1 << 6),
            router_logits=logits)
    n = 4
    C = layers_mod.moe_capacity(tokens // groups, moe.top_k, moe.num_experts,
                                moe.capacity_factor)
    numel = n * groups * (moe.num_experts // n) * C * d
    fab = topo_mod.as_fabric(topo_mod.TwoTierTopology(
        num_pods=n, pod_shape=(1,))).with_paths(topo_mod.cxl_shortcut_path())
    cfg = sched_mod.SyncConfig(chunks=2, path_split=(("cxl", 0.5),))
    return sched_mod.build_all_to_all(fab, cfg, (n, numel // n),
                                      "float32").with_lane_offset(1)


@pytest.fixture(scope="module")
def runs():
    """Every port case, one spawn a world size, beside the JAX runs in two
    subprocesses on 8 fake devices."""
    grads = [dict(kind="grads", weights=_weights(a), batch=_batch(a), arch=a,
                  loss_chunk=8, sizes=TP2, settings=SP) for a in FAMILIES]
    weights = {a: _weights(a) for a in FAMILIES}
    trainers = [dict(kind="trainer", name=n, arch=a, sizes=sz, cfg=cfg,
                     settings=st, train=dict(steps=STEPS))
                for n, (a, sz, cfg, st) in RUNS.items()]
    eight = trainers + [dict(c, kind="prefill") for c in PREFILLS.values()]
    p, x, logits = _sched_inputs()
    sched = [dict(arch=DEEPSEEK, p=p, x=x, groups=g, sizes=SCHED_MESH, split=split,
                  token_axes=tok, schedule=_schedule("repro_torch", g, skew, logits))
             for _, split, tok, g, skew in SCHED_CASES]
    # planned for one member's 32 tokens: the buffer is the batch's 64
    sched.append(dict(sched[-2], schedule=_schedule("repro_torch", 1, False, logits,
                                                    32)))
    inputs = {
        "runs": np.array(json.dumps([dict(name=n, arch=a, sizes=sz, cfg=cfg,
                                          settings=st)
                                     for n, (a, sz, cfg, st) in RUNS.items()])),
        "prefill": np.array(json.dumps([{k: v for k, v in c.items() if k != "tokens"}
                                        for c in PREFILLS.values()])),
        "tokens": np.array({n: c["tokens"] for n, c in PREFILLS.items()}, dtype=object),
        "grads": np.array([dict(arch=a, batch=_batch(a), weights=_weights(a))
                           for a in FAMILIES], dtype=object),
        "weights": np.array(weights, dtype=object),
        "train": np.array(json.dumps(dict(TRAIN, steps=STEPS))),
        "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK)}
    pool = ThreadPoolExecutor(2)
    jobs = [pool.submit(run_jax_devices, JAX_SCRIPT, dict(inputs, what=np.array(w)))
            for w in ("grads", "mesh")]
    try:
        out2 = spawn_ranks(2, rank_seq_parallel, dict(cases=grads, weights={}))
        out4 = spawn_ranks(4, rank_moe_schedule, dict(cases=sched))
        out8 = spawn_ranks(8, rank_seq_parallel, dict(cases=eight, weights=weights),
                           timeout=900)
        jax = {k: v for job in jobs for k, v in job.result().items()}
    finally:
        pool.shutdown(wait=True)
    port = {("grads", a): [r[i] for r in out2] for i, a in enumerate(FAMILIES)}
    port.update({("sched", c[0]): [r[i] for r in out4]
                 for i, c in enumerate(SCHED_CASES)})
    port["drift"] = [r[-1] for r in out4]
    for i, case in enumerate(eight):
        port[case["name"]] = [r[i] for r in out8]
    return port, jax


JAX_SCRIPT = r'''
import os, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_smoke_arch
from repro.launch.cells import _dp_spec
from repro.models import ModelSettings, build_model
from repro.runtime.train_loop import Trainer, TrainerConfig, mesh_info
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
runs, all_weights = json.loads(str(z["runs"])), z["weights"].item()
train, shp = json.loads(str(z["train"])), json.loads(str(z["shape"]))


class Shape:
    global_batch, seq_len = shp["global_batch"], shp["seq_len"]
    name, kind = "t", "train"


def settings(extra, **kw):
    extra = {k: tuple(v) if isinstance(v, list) else v for k, v in extra.items()}
    return ModelSettings(param_dtype="float32", compute_dtype="float32",
                         max_seq=64, **kw, **extra)


def weights_of(arch):
    return tree_from_paths({k: jnp.asarray(v) for k, v in all_weights[arch].items()})


def mesh_of(sizes):
    return make_mesh(tuple(sizes.values()), tuple(sizes))


res = {}
what = str(z["what"])
for case in z["grads"] if what == "grads" else ():
    arch = get_smoke_arch(case["arch"])
    model = build_model(arch, settings({}, remat="none", loss_chunk=8))
    params = tree_from_paths({k: jnp.asarray(v) for k, v in case["weights"].items()})
    loss, grads = jax.value_and_grad(model.loss)(
        params, {k: jnp.asarray(v) for k, v in case["batch"].items()})
    res[f"grads/{case['arch']}/loss"] = np.asarray(loss)
    for k, v in tree_paths(grads).items():
        res[f"grads/{case['arch']}/g/{k}"] = np.asarray(v)

for run in runs if what == "mesh" else ():
    name, sizes, cfg = run["name"], run["sizes"], run["cfg"]
    model = build_model(get_smoke_arch(run["arch"]), settings(
        run["settings"], remat="none", loss_chunk=int(z["loss_chunk"])))
    mesh = mesh_of(sizes)
    tr = Trainer(model, mesh, Shape(), TrainerConfig(**train, **cfg))
    params = weights_of(run["arch"])
    if cfg.get("mode") == "gspmd":
        params = jax.device_put(params, tr.pshard)
        opt = jax.device_put(
            {"m": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
             "v": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
             "step": jnp.zeros((), jnp.int32)}, tr.oshard)
    else:
        params = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), model.param_specs(mesh_info(mesh))))
        opt = jax.device_put(tr._init_state(), tr.state_sharding)
    with mesh:  # the sequence split's constraints name its axes
        out = tr.train(params, opt, 0)
    res[f"{name}/loss"] = np.array([m["loss"] for m in out["metrics"]])
    for k, v in tree_paths(out["params"]).items():
        res[f"{name}/p/{k}"] = np.asarray(v)
    opt = out["opt"]
    if "sections" in opt:
        for sec, entry in opt["sections"].items():
            for k, v in entry.items():
                res[f"{name}/s/{sec}/{k}"] = np.asarray(v)
    else:
        for key in ("m", "v"):
            for k, v in tree_paths(opt[key]).items():
                res[f"{name}/s/{key}/{k}"] = np.asarray(v)

all_tokens = z["tokens"].item()
for pre in json.loads(str(z["prefill"])) if what == "mesh" else ():
    # prefill with the sequence split, the model laid out by mesh_info
    model = build_model(get_smoke_arch(pre["arch"]), settings(pre["settings"],
                                                              remat="none"))
    mesh = mesh_of(pre["sizes"])
    mi = mesh_info(mesh)
    params = jax.device_put(weights_of(pre["arch"]), jax.tree.map(
        lambda s: NamedSharding(mesh, s), model.param_specs(mi)))
    tokens = all_tokens[pre["name"]]
    tokens = jax.device_put(jnp.asarray(tokens), NamedSharding(
        mesh, _dp_spec(mi, 2, tokens.shape[0])))
    with mesh:
        logits, cache = jax.jit(model.prefill)(params, tokens)
    res[f"{pre['name']}/logits"] = np.asarray(logits)
    for k, v in tree_paths(cache).items():
        res[f"{pre['name']}/cache/{k}"] = np.asarray(v)
np.savez(os.environ["JAX_OUT"], **res)
'''


# ---------------------------------------------------------------------------
# loss and gradients with the sequence split, at model = 2
# ---------------------------------------------------------------------------


def _jax_grads(jax, arch):
    pre = f"grads/{arch}/g/"
    return (float(jax[f"grads/{arch}/loss"]),
            {k[len(pre):]: v for k, v in jax.items() if k.startswith(pre)})


def _tolerance(arch, path, want):
    """``grad_tolerance``; a leaf whose true gradient is zero (whisper's
    key biases) to ``NOISE`` of rounding."""
    if zero_gradient(arch, path):
        return dict(rtol=0, atol=1e-6)
    return grad_tolerance(arch, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sp_loss_and_grads_match_jax(runs, arch):
    """Each member's loss within rtol 1e-5 of JAX's single-device loss;
    every leaf's gradient, put together from the members' blocks (two
    members' blocks of a leaf held alike bit-equal), within
    ``grad_tolerance`` of JAX's; the layers' leaves split over model."""
    port, jax = runs
    out = port[("grads", arch)]
    jloss, jgrads = _jax_grads(jax, arch)
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = assemble_blocks([(g, c, s) for _, g, c, s, _ in out],
                            {k: v.shape for k, v in jgrads.items()}, TP2, arch)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k,
                                   **_tolerance(arch, k, jgrads[k]))
    specs = out[0][3]
    assert any(k.startswith("blocks/") and "model" in sp for k, sp in specs.items())


def _rows_only(arch, jgrads):
    """The replicated leaves each member uses on its rows (the norms, the
    learned positions) or routes the gathered tokens with (the router),
    and the channel mix's gate ``wr``."""
    keys = [k for k in jgrads if any(f"/{n}/" in k for n in ("ln1", "ln2", "lnx"))
            or k.endswith(("/router", "cmix/wr")) or k == "pos_embed"]
    assert keys
    return keys


@pytest.mark.parametrize("arch", FAMILIES)
def test_sp_router_gate_and_norm_grads(runs, arch):
    """The router's gradient (routing the gathered tokens alike on every
    member, whole there, the aux loss counted once), RWKV6's ``cmix/wr``
    (the gate taken on a member's rows, its gradient summed over the
    axis), the norms' (``ln1``, ``ln2``, ``lnx``) and whisper's learned
    positions' (each member's rows, summed; then their d columns): each
    member's block against JAX's, two members' alike blocks bit-equal."""
    port, jax = runs
    out = port[("grads", arch)]
    _, jgrads = _jax_grads(jax, arch)
    keys = _rows_only(arch, jgrads)
    if arch in (DEEPSEEK, JAMBA):
        assert any(k.endswith("/router") for k in keys)
    if arch == RWKV:
        assert any(k.endswith("cmix/wr") for k in keys)
    for k in keys:
        for _, g, coords, specs, _ in out:
            want = sharding.local_block(jgrads[k], specs[k], dict(coords), TP2)
            np.testing.assert_allclose(g[k], want, err_msg=k,
                                       **_tolerance(arch, k, jgrads[k]))
        if "model" not in specs[k]:
            np.testing.assert_array_equal(out[0][1][k], out[1][1][k])


# ---------------------------------------------------------------------------
# the steps on a mesh, against the JAX Trainer on the same mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_with_sp_matches_jax(runs, name):
    """The DFabric ``Trainer`` with the sequence split (deepseek, rwkv6,
    whisper), the GSPMD one with it and ``batch_axes`` (deepseek on (2, 2,
    2), jamba on (4, 1, 2)), whisper's GSPMD one with and without it, each
    against the JAX ``Trainer`` on the same mesh with the same settings:
    losses, parameters and optimizer state (``check_tp_run``)."""
    port, jax = runs
    arch, sizes, cfg, _ = RUNS[name]
    recs = port[name]
    check_tp_run(name, recs, jax, sizes, cfg, steps=STEPS,
                 far_share=RECURRENT_FAR if arch in (JAMBA, RWKV) else 0.0, arch=arch)
    specs = recs[0]["specs"]
    assert any(k.startswith("blocks/") and "model" in sp for k, sp in specs.items())
    if cfg["mode"] == "gspmd":
        assert any("data" in sp for k, sp in specs.items() if k.startswith("blocks/"))
    if arch == WHISPER and cfg["mode"] == "gspmd":
        assert any("data" in sp for k, sp in specs.items()
                   if k.startswith("enc_blocks/"))
        assert any("data" in sp for k, sp in specs.items() if "/xattn/" in k)


# ---------------------------------------------------------------------------
# prefill with the split on (data, model) = (2, 4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PREFILLS))
def test_prefill_with_sp_matches_jax(runs, name):
    """The smoke's prefill on (2, 4), 4 rows of 16 (two a DP member), the
    sequence split over model: each member's logits and its block of every
    cache leaf against the JAX ``jit`` of ``prefill`` on the same mesh with
    the same settings, and against the port's prefill without the split:
    the attention cache holds the whole sequence, the token-shift and conv
    states the whole sequence's last rows."""
    port, jax = runs
    case = PREFILLS[name]
    recs, tokens = port[name], case["tokens"]
    model = build_model(get_smoke_arch(case["arch"]), ModelSettings(), device="meta")
    shapes = {k: v.shape for k, v in tree_paths(model.cache_shapes(4, 16)).items()}
    cspecs = sharding.cache_specs(model.arch, shapes, mesh_info(PREFILL_MESH), 4)
    whole = port_model(_weights(case["arch"]), arch=case["arch"], experts=True)
    with torch.no_grad():
        plain, pcache = whole.prefill(torch.from_numpy(tokens))
    pcache = {k: v.numpy() for k, v in tree_paths(pcache).items()}
    states = [k for k in pcache if k.split("/")[-1] in ("tshift", "cshift", "conv")]
    assert bool(states) == (case["arch"] != DEEPSEEK)
    for logits, cache, coords in recs:
        c = dict(coords)
        r = 2 * c["data"]
        for want in (jax[f"{name}/logits"], plain.numpy()):
            np.testing.assert_allclose(logits, want[r:r + 2], atol=1e-4, rtol=1e-4)
        for k, blk in cache.items():
            for src in (jax[f"{name}/cache/{k}"], pcache[k]):
                want = sharding.local_block(src, cspecs[k], c, PREFILL_MESH)
                assert blk.shape == want.shape, k
                np.testing.assert_allclose(blk, want, atol=1e-4, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# a planned dispatch schedule over split experts and the GSPMD step's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,split,token_axes,groups,skewed", SCHED_CASES,
                         ids=[c[0] for c in SCHED_CASES])
def test_planned_schedule_split_and_token_axes(runs, name, split, token_axes,
                                               groups, skewed):
    """deepseek's MoE layer on (data, model) = (2, 2), its experts split
    over model and/or its rows over data (``token_axes``): with a planned
    schedule (chunks 2, lane offset 1; or skew-planned from the tokens'
    router logits, at its ``C_exec`` from the payload) each member's output
    and aux loss are bit-equal to the unscheduled layer's (the uniform
    plan's), and the members' outputs, put together, within ``tests/test_torch_moe.py``'s
    tolerance of JAX's ``apply_moe`` with the same schedule on one
    device."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_arch as jax_smoke_arch
    from repro.models import layers as JL
    port, _ = runs
    p, x, logits = _sched_inputs()
    jarch = jax_smoke_arch(DEEPSEEK)
    js = _schedule("repro", groups, skewed, logits)
    assert js.to_json() == _schedule("repro_torch", groups, skewed, logits).to_json()
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    jy, jaux = JL.apply_moe(jarch, jp, jnp.asarray(x), groups=groups,
                            dispatch_schedule=js)
    jy = np.asarray(jy)
    recs = port[("sched", name)]
    assert not any(isinstance(rec, str) for rec in recs), recs
    if skewed:  # dispatched at the plan's capacity, not the prior's
        assert any(not np.array_equal(y1, y0) for y0, y1, *_ in recs)
    for y0, y1, a0, a1, coords in recs:
        if not skewed:
            np.testing.assert_array_equal(y1, y0)
            np.testing.assert_array_equal(a1, a0)
        rows = slice(dict(coords)["data"], dict(coords)["data"] + 1) \
            if token_axes else slice(None)
        np.testing.assert_allclose(y1, jy[rows], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a1, np.asarray(jaux), atol=1e-4, rtol=1e-4)


def test_planned_schedule_of_other_tokens_raises(runs):
    """Under ``token_axes`` the dispatch buffer is the whole batch's: a
    schedule planned for one member's 32 tokens raises on every member."""
    port, _ = runs
    for rec in port["drift"]:
        assert isinstance(rec, str) and "different dispatch buffer" in rec, rec
