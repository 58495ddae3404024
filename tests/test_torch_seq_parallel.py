"""Sequence parallelism, the context-parallel step and MoE dispatch groups
under the GSPMD step, held against the JAX package on the CPU.

  * the dense smokes' loss and every leaf's gradient at (data, model) =
    (1, 2) with the residual stream's sequence split over ``model``
    (``seq_axis``): qwen2 (remat none and full), qwen3 with its q/k norms,
    nemotron and stablelm, and qwen3 with its blocks whole on both members
    (the context-parallel layout, ``tp_scope="embed_only"``); the
    gradients put together from the members' blocks against JAX's
    single-device ``value_and_grad`` (the JAX settings place data, they do
    not change the numbers), ``ln1``/``ln2`` on their own;
  * MoE dispatch groups under the GSPMD step's token routing (the global
    batch cut into groups, ``layers.apply_moe``): deepseek on (pod, data,
    model) = (2, 2, 1) and jamba with its experts on (4, 1, 2), groups 2
    and 4, loss and gradients against JAX, the members' dropped slots
    summed against the unsharded grouped layer's;
  * on (2, 2, 2), against the JAX package on 8 fake devices: the DFabric
    ``Trainer`` with ``seq_axis`` (qwen2), the GSPMD ``Trainer`` (FSDP x
    TP) with ``seq_axis``/``batch_axes`` (nemotron), the context-parallel
    step (``make_gspmd_train_step(mi=embed_only, zero_opt=True)``, qwen3):
    losses, parameters and moments after the steps; prefill with
    ``seq_axis`` (qwen3): each member's logits and cache blocks; and on
    (4, 1, 2) jamba's GSPMD ``Trainer`` with ``moe_groups=2`` (``data`` 1:
    the reference scales Mamba's ``conv_w`` gradient by the FSDP size,
    ROADMAP.md queue 3).

Tolerances are ``test_torch_tp.py``'s and ``test_torch_gspmd.py``'s: loss
rtol 1e-5 and gradients ``grad_tolerance``; trainer runs by
``check_tp_run``; prefill atol = rtol = 1e-4 (``test_torch_serve_mesh.py``).
One spawn a world size (2, 4 and 8 gloo ranks); the JAX runs on 8 fake
devices in one subprocess.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_harness import (CP_STEPS, DEEPSEEK, FP32, JAMBA,  # noqa: E402
                           RECURRENT_FAR, TRAIN, TRAIN_LOSS_CHUNK, TRAIN_SHAPE,
                           assemble_blocks, check_tp_run, grad_tolerance,
                           port_drops, port_model, rank_seq_parallel, redraw,
                           run_jax_devices, smoke_archs, spawn_ranks, train_batch)

from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import ModelSettings, build_model  # noqa: E402
from repro_torch.configs import get_smoke_arch  # noqa: E402
from repro_torch.runtime.train_loop import mesh_info  # noqa: E402
from repro_torch.utils.trees import tree_paths  # noqa: E402

QWEN2, QWEN3, NEMOTRON, STABLELM = ("qwen2-0.5b", "qwen3-1.7b", "nemotron-4-340b",
                                    "stablelm-12b")
TP2 = {"data": 1, "model": 2}
MESH = {"pod": 2, "data": 2, "model": 2}
JAMBA_MESH = {"pod": 4, "data": 1, "model": 2}
DEEPSEEK_MESH = {"pod": 2, "data": 2, "model": 1}
SP = dict(seq_axis="model")
SP_GSPMD = dict(seq_axis="model", batch_axes=("pod", "data"))
STEPS = 2  # the Trainer runs'

# (arch, remat, tp_scope): loss and gradients at model = 2 under seq_axis
SP_CASES = [(QWEN2, "none", "full"), (QWEN2, "full", "full"),
            (QWEN3, "none", "full"), (NEMOTRON, "none", "full"),
            (STABLELM, "none", "full"), (QWEN3, "full", "embed_only")]
# (arch, mesh, groups): MoE dispatch groups over the GSPMD step's batch
GROUP_CASES = [(DEEPSEEK, "2x2x1", 2), (DEEPSEEK, "2x2x1", 4),
               (JAMBA, "4x1x2", 2), (JAMBA, "4x1x2", 4)]
GROUP_MESHES = {"2x2x1": DEEPSEEK_MESH, "4x1x2": JAMBA_MESH}
# the Trainer runs, on both packages: name: (arch, sizes, TrainerConfig
# fields, ModelSettings fields)
RUNS = {"qwen2-dfabric-sp": (QWEN2, MESH, dict(mode="dfabric"), SP),
        "nemotron-gspmd-sp": (NEMOTRON, MESH, dict(mode="gspmd"), SP_GSPMD),
        "jamba-gspmd-groups2": (JAMBA, JAMBA_MESH, dict(mode="gspmd"),
                                dict(moe_groups=2))}
CP = dict(name="qwen3-cp", arch=QWEN3, sizes=MESH, settings=SP_GSPMD)
PREFILL = dict(name="qwen3-prefill", arch=QWEN3, sizes=MESH, settings=SP_GSPMD,
               tokens=np.random.default_rng(31).integers(
                   0, get_smoke_arch(QWEN3).vocab, (4, 16)).astype(np.int32))


_WEIGHTS = {}  # each arch's drawn once in the module


def _weights(arch):
    """``smoke_weights(seed=5, arch, experts=True)``: every leaf of the
    smoke tree (the port's, leaf for leaf the JAX package's) redrawn."""
    if arch not in _WEIGHTS:
        meta = build_model(get_smoke_arch(arch), ModelSettings(**FP32), device="meta")
        _WEIGHTS[arch] = redraw(tree_paths(meta.param_shapes()), 5)
    return _WEIGHTS[arch]


# the loss-and-gradient cases: key: (arch, rows, seq, moe_groups, loss
# chunk, batch seed); the JAX side computes each once on one device
GRADS = {**{f"sp-{arch}": (arch, 2, 16, 1, 8, 9) for arch, _, _ in SP_CASES},
         **{f"groups-{arch}-{g}": (arch, 4, 16, g, 8, 9)
            for arch, _, g in GROUP_CASES},
         # 12 tokens a member of a 4-member axis, 3 groups of 16
         "straddle": (DEEPSEEK, 4, 12, 3, 4, 11)}
STRADDLE_MESH = {"data": 4, "model": 1}


def _batch(key):
    arch, rows, seq, _, _, seed = GRADS[key]
    return train_batch(smoke_archs(arch, experts=True)[1], seed=seed, B=rows, S=seq)


def _grads_case(key, **kw):
    """The port's rank case of ``GRADS[key]``."""
    arch, _, _, groups, chunk, _ = GRADS[key]
    settings = dict(kw.pop("settings", {}), moe_groups=groups)
    return dict(kind="grads", weights=_weights(arch), batch=_batch(key), arch=arch,
                loss_chunk=chunk, settings=settings, **kw)


@pytest.fixture(scope="module")
def runs():
    """Every port case, one spawn a world size, beside the JAX runs in one
    subprocess on 8 fake devices (each case's loss and gradients on one
    device; the steps and prefill on (2, 2, 2) and (4, 1, 2))."""
    sp = [_grads_case(f"sp-{arch}", sizes=TP2, remat=remat, settings=SP,
                      tp_scope=scope, gspmd=scope == "embed_only")
          for arch, remat, scope in SP_CASES]
    groups = {(a, m, g): _grads_case(f"groups-{a}-{g}", sizes=GROUP_MESHES[m],
                                     fsdp=True)
              for a, m, g in GROUP_CASES}
    four = [c for (a, m, g), c in groups.items() if m == "2x2x1"] + [
        _grads_case("straddle", sizes=STRADDLE_MESH, fsdp=True)]
    weights = {a: _weights(a) for a in (QWEN2, QWEN3, NEMOTRON, JAMBA)}
    trainers = [dict(kind="trainer", name=n, arch=a, sizes=sz, cfg=cfg,
                     settings=st, train=dict(steps=STEPS))
                for n, (a, sz, cfg, st) in RUNS.items()]
    eight = trainers + [dict(CP, kind="cp"), dict(PREFILL, kind="prefill")] + [
        c for (a, m, g), c in groups.items() if m == "4x1x2"]
    inputs = {
        "runs": np.array(json.dumps([dict(name=n, arch=a, sizes=sz, cfg=cfg,
                                          settings=st)
                                     for n, (a, sz, cfg, st) in RUNS.items()])),
        "cp": np.array(json.dumps(CP)),
        "prefill": np.array(json.dumps({k: v for k, v in PREFILL.items()
                                        if k != "tokens"})),
        "grads": np.array([dict(key=k, arch=v[0], groups=v[3], chunk=v[4],
                                batch=_batch(k), weights=_weights(v[0]))
                           for k, v in GRADS.items()], dtype=object),
        "tokens": PREFILL["tokens"], "weights": np.array(weights, dtype=object),
        "train": np.array(json.dumps(dict(TRAIN, steps=STEPS))),
        "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK), "cp_steps": np.array(CP_STEPS)}
    # two JAX subprocesses (the single-device gradients; the mesh runs)
    # beside the port's ranks
    pool = ThreadPoolExecutor(2)
    jobs = [pool.submit(run_jax_devices, JAX_SCRIPT, dict(inputs, what=np.array(w)))
            for w in ("grads", "mesh")]
    try:
        out2 = spawn_ranks(2, rank_seq_parallel, dict(cases=sp, weights={}))
        out4 = spawn_ranks(4, rank_seq_parallel, dict(cases=four, weights={}))
        out8 = spawn_ranks(8, rank_seq_parallel, dict(cases=eight, weights=weights),
                           timeout=900)
        jax = {k: v for job in jobs for k, v in job.result().items()}
    finally:
        pool.shutdown(wait=True)
    port = {}
    for i, key in enumerate(SP_CASES):
        port[("sp",) + key] = [r[i] for r in out2]
    keys4 = [("groups",) + k for k in GROUP_CASES if k[1] == "2x2x1"] + ["straddle"]
    for i, key in enumerate(keys4):
        port[key] = [r[i] for r in out4]
    for i, case in enumerate(eight):
        key = (case.get("name") or ("groups", case["arch"], "4x1x2",
                                     case["settings"]["moe_groups"]))
        port[key] = [r[i] for r in out8]
    return port, jax


JAX_SCRIPT = r'''
import os, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_arch
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch.cells import _dp_spec
from repro.models import ModelSettings, build_model
from repro.optim.adamw import AdamWConfig, cosine_schedule
from repro.runtime.train_loop import (Trainer, TrainerConfig, make_gspmd_train_step,
                                      mesh_info)
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
runs, all_weights = json.loads(str(z["runs"])), z["weights"].item()
train, shp = json.loads(str(z["train"])), json.loads(str(z["shape"]))
cp, pre = json.loads(str(z["cp"])), json.loads(str(z["prefill"]))


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
    model = build_model(arch, settings({}, remat="none", loss_chunk=case["chunk"],
                                       moe_groups=case["groups"]))
    params = tree_from_paths({k: jnp.asarray(v) for k, v in case["weights"].items()})
    loss, grads = jax.value_and_grad(model.loss)(
        params, {k: jnp.asarray(v) for k, v in case["batch"].items()})
    res[f"grads/{case['key']}/loss"] = np.asarray(loss)
    for k, v in tree_paths(grads).items():
        res[f"grads/{case['key']}/g/{k}"] = np.asarray(v)

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

if what == "mesh":
    # the context-parallel cell's step: blocks whole on every model member,
    # the sequence over model, ZeRO moments
    model = build_model(get_smoke_arch(cp["arch"]), settings(
        cp["settings"], remat="full", loss_chunk=int(z["loss_chunk"])))
    mesh = mesh_of(cp["sizes"])
    mi = mesh_info(mesh, fsdp=False)
    mi.tp_scope = "embed_only"
    steps = int(z["cp_steps"])
    step_fn, pshard, oshard, bshard = make_gspmd_train_step(
        model, mesh, AdamWConfig(), cosine_schedule(train["lr"], train["warmup"], steps),
        fsdp=False, mi=mi, zero_opt=True, donate=False)
    params = jax.device_put(weights_of(cp["arch"]), pshard)
    opt = jax.device_put(
        {"m": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
         "v": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
         "step": jnp.zeros((), jnp.int32)}, oshard)
    pipe = TokenPipeline(model.arch, Shape(), DataConfig(seed=train["seed"]))
    losses = []
    for step in range(steps):
        batch = jax.device_put({k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()},
                               bshard)
        with mesh:
            params, opt, metrics = step_fn(params, opt, batch, jnp.int32(step))
        losses.append(float(metrics["loss"]))
    res[f"{cp['name']}/loss"] = np.array(losses)
    for k, v in tree_paths(params).items():
        res[f"{cp['name']}/p/{k}"] = np.asarray(v)
    for key in ("m", "v"):
        for k, v in tree_paths(opt[key]).items():
            res[f"{cp['name']}/s/{key}/{k}"] = np.asarray(v)

    # prefill with the sequence split, the model laid out by mesh_info
    model = build_model(get_smoke_arch(pre["arch"]), settings(pre["settings"], remat="none"))
    mesh = mesh_of(pre["sizes"])
    mi = mesh_info(mesh)
    params = jax.device_put(weights_of(pre["arch"]), jax.tree.map(
        lambda s: NamedSharding(mesh, s), model.param_specs(mi)))
    tokens = z["tokens"]
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


def _jax_grads(jax, key):
    """JAX's single-device loss and gradients of ``GRADS[key]``."""
    pre = f"grads/{key}/g/"
    return (float(jax[f"grads/{key}/loss"]),
            {k[len(pre):]: v for k, v in jax.items() if k.startswith(pre)})


def _check_grads(out, jloss, jgrads, sizes, arch):
    """Each member's loss within rtol 1e-5 of JAX's, every gradient put
    together from the members' blocks (two members' blocks of a leaf held
    alike bit-equal) within ``grad_tolerance``."""
    for loss, *_ in out:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = assemble_blocks([(g, c, s) for _, g, c, s, _ in out],
                            {k: v.shape for k, v in jgrads.items()}, sizes, arch)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k,
                                   **grad_tolerance(arch, jgrads[k]))


def _check_drops(key, out, n_model):
    """The members' dropped slots, summed over the DP members (the model
    members of one drop alike), against the unsharded port's grouped
    layers', layer by layer."""
    arch, _, _, groups, chunk, _ = GRADS[key]
    want = port_drops(port_model(_weights(arch), arch=arch, experts=True,
                                 loss_chunk=chunk, moe_groups=groups), _batch(key))
    got = np.sum([d for *_, d in out], axis=0) // n_model
    assert list(got) == want and sum(want) > 0, (list(got), want)


@pytest.mark.parametrize("arch,remat,scope", SP_CASES)
def test_sp_loss_and_grads_match_jax(runs, arch, remat, scope):
    """Each member's loss equals JAX's; every leaf's gradient, put together
    from the members' blocks (the replicated ones bit-equal across them),
    equals JAX's.  Under ``embed_only`` only the vocab splits."""
    port, jax = runs
    out = port[("sp", arch, remat, scope)]
    _check_grads(out, *_jax_grads(jax, f"sp-{arch}"), TP2, arch)
    specs = out[0][3]
    split = [k for k, sp in specs.items() if "model" in sp]
    if scope == "embed_only":
        assert sorted(split) == ["embed"] + (["lm_head"] if "lm_head" in specs else [])
    else:
        assert any(k.startswith("blocks/") for k in split)


@pytest.mark.parametrize("arch,remat,scope", SP_CASES)
def test_sp_norm_grads_sum_the_members_rows(runs, arch, remat, scope):
    """``ln1``/``ln2`` see only a member's rows of the sequence: their
    gradients are summed over the model axis (``to_parallel``), so each
    member holds the whole one, bit-equal on both and equal to JAX's."""
    port, jax = runs
    out = port[("sp", arch, remat, scope)]
    _, jgrads = _jax_grads(jax, f"sp-{arch}")
    norms = [k for k in jgrads if "/ln1/" in k or "/ln2/" in k]
    assert norms
    for k in norms:
        for _, g, *_ in out:
            np.testing.assert_allclose(g[k], jgrads[k], err_msg=k,
                                       **grad_tolerance(arch, jgrads[k]))
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k])


# ---------------------------------------------------------------------------
# MoE dispatch groups under the GSPMD step's token routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mname,groups", GROUP_CASES)
def test_moe_groups_under_gspmd_match_jax(runs, arch, mname, groups):
    """The global batch (4 rows of 16) cut into ``groups`` dispatch groups:
    on (2, 2, 1) each group spans two members (2) or is one member's rows
    (4); on (4, 1, 2) likewise, with the experts over model.  Loss and
    every gradient against JAX's grouped layers on one device; the
    members' dropped slots against the unsharded grouped layers'."""
    port, jax = runs
    out = port[("groups", arch, mname, groups)]
    _check_grads(out, *_jax_grads(jax, f"groups-{arch}-{groups}"),
                 GROUP_MESHES[mname], arch)
    _check_drops(f"groups-{arch}-{groups}", out, GROUP_MESHES[mname]["model"])


def test_moe_group_straddling_two_members_matches_jax(runs):
    """Four members of a DP axis, 12 tokens each, in 3 dispatch groups of
    16: member 1's tokens straddle groups 0 and 1, member 2's groups 1 and
    2.  Loss, gradients and drops as above."""
    port, jax = runs
    out = port["straddle"]
    _check_grads(out, *_jax_grads(jax, "straddle"), STRADDLE_MESH, DEEPSEEK)
    _check_drops("straddle", out, 1)


# ---------------------------------------------------------------------------
# the steps and prefill on a mesh, against the JAX package on the same mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_with_sp_or_groups_matches_jax(runs, name):
    """The DFabric ``Trainer`` with the sequence split (qwen2), the GSPMD
    one with it and ``batch_axes`` (nemotron, FSDP x TP), and jamba's
    GSPMD one with ``moe_groups=2`` on (4, 1, 2), each against the JAX
    ``Trainer`` on the same mesh with the same settings: losses,
    parameters and optimizer state (``check_tp_run``)."""
    port, jax = runs
    arch, sizes, cfg, _ = RUNS[name]
    recs = port[name]
    check_tp_run(name, recs, jax, sizes, cfg, steps=STEPS,
                 far_share=RECURRENT_FAR if arch == JAMBA else 0.0, arch=arch)
    if cfg["mode"] == "dfabric":
        assert recs[0]["specs"]["blocks/l0/mlp/wi"][2] == "model"


def test_context_parallel_step_matches_jax(runs):
    """The context-parallel cell's step (qwen3's smoke, blocks whole on both
    model members, the sequence split over model, no FSDP, the moments
    under ``zero_moment_specs``) against JAX's ``make_gspmd_train_step(mi=
    embed_only, zero_opt=True)`` on the same mesh: the losses of both
    steps, the parameters and both moments after them; every block two
    members hold alike (the blocks over model, the embedding over the DP
    axes) bit-equal."""
    port, jax = runs
    recs = port["qwen3-cp"]
    check_tp_run("qwen3-cp", recs, jax, MESH, {}, steps=CP_STEPS)
    specs, mspecs = recs[0]["specs"], recs[0]["state_specs"]
    assert all(sp == (None,) * len(sp) for k, sp in specs.items()
               if k.startswith("blocks/"))
    assert specs["embed"][0] == "model"
    assert any("model" in sp for k, sp in mspecs.items() if "/blocks/" in k)


def test_prefill_with_sp_matches_jax(runs):
    """qwen3's smoke prefill on (2, 2, 2), 4 rows of 16 (one a DP member),
    the sequence split over model: each member's logits and its block of
    every cache leaf (its row, its kv heads, the whole sequence) against
    the JAX ``jit`` of ``prefill`` on the same mesh with the same settings,
    and against the port's prefill without the split."""
    port, jax = runs
    recs = port["qwen3-prefill"]
    tokens = PREFILL["tokens"]
    model = build_model(get_smoke_arch(QWEN3), ModelSettings(), device="meta")
    cspecs = sharding.cache_specs(
        model.arch, {k: v.shape for k, v in _cache_shapes(model, 4, 16).items()},
        mesh_info(MESH), 4)
    whole = port_model(_weights(QWEN3), arch=QWEN3, experts=True)
    with torch.no_grad():
        plain, _ = whole.prefill(torch.from_numpy(tokens))
    for logits, cache, coords in recs:
        c = dict(coords)
        r = c["pod"] * 2 + c["data"]
        np.testing.assert_allclose(logits, jax["qwen3-prefill/logits"][r:r + 1],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(logits, plain.numpy()[r:r + 1], atol=1e-4, rtol=1e-4)
        for k, blk in cache.items():
            want = sharding.local_block(jax[f"qwen3-prefill/cache/{k}"], cspecs[k],
                                        c, MESH)
            assert blk.shape == want.shape and blk.shape[2] == tokens.shape[1], k
            np.testing.assert_allclose(blk, want, atol=1e-4, rtol=1e-4, err_msg=k)


def _cache_shapes(model, batch, seq):
    return tree_paths(model.cache_shapes(batch, seq))


def test_sp_axis_checks_the_settings_against_the_step():
    """The sequence splits over the layout's model axis where it has
    several members (else the stream stays whole), and over a length it
    divides; ``batch_axes`` must name DP axes that split the step's rows
    or have one member: the DFabric step (no row axes) refuses a split
    ``data``, the GSPMD step (``pod``/``data``) takes it, and a non-DP or
    unknown axis raises."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import Layout
    sizes = {"pod": 2, "data": 1, "model": 2}
    lay = Layout({}, sizes, {a: 0 for a in sizes}, tp="model")
    st = ModelSettings(seq_axis="model")
    assert T._sp_axis(st, lay, 16, ()) == "model"
    assert T._sp_axis(st, None, 16, ()) is None
    assert T._sp_axis(ModelSettings(), lay, 16, ()) is None
    assert T._sp_axis(st, Layout({}, {"data": 2, "model": 1}, {"data": 0, "model": 0},
                                 tp="model"), 16, ()) is None
    gspmd = dataclasses.replace(st, batch_axes=("pod", "data"))
    assert T._sp_axis(gspmd, lay, 16, ("pod", "data")) == "model"
    assert T._sp_axis(dataclasses.replace(st, batch_axes=("data",)), lay, 16, ()) == "model"
    for bad in (("pod", "data"), ("model",), ("dat",)):
        with pytest.raises(ValueError, match="batch_axes"):
            T._sp_axis(dataclasses.replace(st, batch_axes=bad), lay, 16, ())
    with pytest.raises(ValueError, match="does not split"):
        T._sp_axis(st, lay, 15, ())
    with pytest.raises(ValueError, match="model axis"):
        T._sp_axis(dataclasses.replace(st, seq_axis="pod"), lay, 16, ())
