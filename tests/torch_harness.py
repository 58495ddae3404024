"""Helpers for the PyTorch port's tests (``tests/test_torch_*.py``).

The same seeded numpy arrays go through the JAX package (the reference)
and its port.  Import this after ``pytest.importorskip("torch")``.

The JAX package is imported inside the helpers that use it, so that the
port's rank processes (``spawn_ranks``), which import this module to find
their entry point, load torch only.
"""
import math
import multiprocessing
import os
import tempfile
import traceback

import ml_dtypes
import numpy as np
import torch

from repro_torch.configs import one_card_arch
from repro_torch.convert import load_jax_params
from repro_torch.models import ModelSettings, build_model

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)

ARCH = "qwen2-0.5b"  # the dense arch, and the default below
RWKV = "rwkv6-1.6b"
JAMBA = "jamba-1.5-large-398b"  # runs without experts (one_card_arch)
DEEPSEEK = "deepseek-moe-16b"
WHISPER = "whisper-medium"  # the encoder-decoder
# the decoder configs of the MoE slice: four dense, two with experts
NEW_ARCHS = ("qwen3-1.7b", "stablelm-12b", "nemotron-4-340b", "chameleon-34b",
             DEEPSEEK, "moonshot-v1-16b-a3b")
ARCHS = tuple(sorted((JAMBA, ARCH, RWKV, WHISPER) + NEW_ARCHS))  # every arch the port registers
FP32 = dict(param_dtype="float32", compute_dtype="float32")
#: the learned positions' rows (``ModelSettings.max_seq``) of every smoke
#: model the tests build in both packages
MAX_SEQ = 64


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def redraw(flat, seed: int):
    """Every leaf of a flat JAX tree redrawn with numpy, in its dtype.
    ``init_attention`` zeroes the QKV biases and ``init_norm`` sets scales
    to one; redrawn, both are exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(flat.items()):
        x = rng.standard_normal(leaf.shape) * 0.1
        if path.endswith("scale"):
            x = x + 1.0
        out[path] = np.asarray(x, dtype=leaf.dtype)
    return out


def smoke_archs(arch: str = ARCH, n_layers=None, experts: bool = False):
    """(the JAX smoke config, the port's) with the port's one-card cut
    (no experts for jamba) unless ``experts`` (the registered smoke config,
    jamba's experts included) and, if given, ``n_layers``."""
    from repro.configs import get_smoke_arch as jax_smoke_arch
    from repro_torch.configs import get_smoke_arch
    port = get_smoke_arch(arch) if experts else one_card_arch(arch, smoke=True)[0]
    jarch = jax_smoke_arch(arch)
    if port.moe is None:
        jarch = jarch.replace(moe=None)
    if n_layers is not None:
        port, jarch = port.replace(n_layers=n_layers), jarch.replace(n_layers=n_layers)
    return jarch, port


def jax_model(attn_impl: str = "masked", max_seq: int = MAX_SEQ, dtype="float32",
              arch: str = ARCH, use_pallas_ssm: bool = False, n_layers=None,
              experts: bool = False, compute_dtype=None, **settings):
    """The JAX smoke model; ``settings`` override its ``ModelSettings``
    (remat "none" unless given); ``compute_dtype`` is ``dtype`` unless
    given."""
    from repro.models import ModelSettings as JaxSettings
    from repro.models import build_model as jax_build_model
    settings.setdefault("remat", "none")
    st = JaxSettings(param_dtype=dtype, compute_dtype=compute_dtype or dtype,
                     attn_impl=attn_impl, max_seq=max_seq,
                     use_pallas_ssm=use_pallas_ssm, **settings)
    return jax_build_model(smoke_archs(arch, n_layers, experts)[0], st)


def smoke_weights(seed: int = 0, dtype="float32", arch: str = ARCH,
                  n_layers=None, experts: bool = False):
    """The smoke model's flat JAX tree, every leaf redrawn from ``seed``."""
    import jax
    from repro.utils.trees import tree_paths
    params = jax_model(dtype=dtype, arch=arch, n_layers=n_layers,
                       experts=experts).init(jax.random.key(0))
    return redraw({k: np.asarray(v) for k, v in tree_paths(params).items()},
                  seed)


def jax_params(flat):
    import jax.numpy as jnp
    from repro.utils.trees import tree_from_paths
    return tree_from_paths({k: jnp.asarray(v) for k, v in flat.items()})


def port_model(flat, attn_impl: str = "masked", dtype="float32",
               arch: str = ARCH, use_kernel_ssm: bool = False, n_layers=None,
               experts: bool = False, compute_dtype=None, max_seq: int = MAX_SEQ,
               **settings):
    st = ModelSettings(param_dtype=dtype, compute_dtype=compute_dtype or dtype,
                       attn_impl=attn_impl, use_kernel_ssm=use_kernel_ssm,
                       max_seq=max_seq, **settings)
    model = build_model(smoke_archs(arch, n_layers, experts)[1], st,
                        device="cpu")
    load_jax_params(model, flat)
    return model


def port_loss_and_grads(model, batch):
    """(loss, {path: gradient}) of ``model.loss`` on the numpy ``batch``,
    under autograd."""
    from repro_torch.utils.trees import tree_paths
    params = model.params()
    flat = tree_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def jax_loss_and_grads(jm, flat, batch):
    """(loss, {path: gradient}) of the JAX model's loss under
    ``jax.value_and_grad``, the same weights and batch."""
    import jax
    import jax.numpy as jnp
    from repro.utils.trees import tree_paths
    loss, grads = jax.value_and_grad(jm.loss)(
        jax_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in tree_paths(grads).items()}


def train_batch(arch, seed: int, B: int = 2, S: int = 16):
    """A (B, S) next-token batch of the arch's vocab, three positions of
    the first row ignored (label -1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ---------------------------------------------------------------------------
# several processes: the JAX package on fake devices, the port on gloo ranks
# ---------------------------------------------------------------------------


def run_jax_devices(script: str, inputs: dict, n_devices: int = 8,
                    timeout: int = 600) -> dict:
    """Run ``script`` (Python source) in a subprocess that sees
    ``n_devices`` fake CPU devices, as ``conftest.run_multi_device`` does.
    The script reads ``np.load(os.environ["JAX_IN"], allow_pickle=True)``
    and writes its results with ``np.savez(os.environ["JAX_OUT"], ...)``;
    returns them as a dict."""
    from conftest import run_multi_device
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "script.py")
        with open(path, "w") as f:
            f.write(script)
        np.savez(os.path.join(tmp, "in.npz"), **inputs)
        run_multi_device(path, n_devices=n_devices, timeout=timeout,
                         extra_env={"JAX_IN": os.path.join(tmp, "in.npz"),
                                    "JAX_OUT": os.path.join(tmp, "out.npz")})
        with np.load(os.path.join(tmp, "out.npz"), allow_pickle=True) as z:
            return {k: z[k] for k in z.files}


def _rank_main(rank, world, store, fn, payload_path, queue, group=True):
    import pickle
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        if group:
            dist.init_process_group("gloo", init_method=f"file://{store}",
                                    world_size=world, rank=rank)
        out = fn(rank, payload)
        if group:
            dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))


def spawn_ranks(world: int, fn, payload, timeout: float = 300,
                group: bool = True) -> list:
    """``fn(rank, payload)`` in each of ``world`` spawned processes joined
    in one gloo group through a tmp-file store (no fixed port, so parallel
    test workers do not collide); returns the results in rank order.
    ``fn`` must be a module-level function of a module that imports no
    jax (this one).  Without ``group`` the processes join no group (``fn``
    starts its own)."""
    import pickle
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # through a file: a start() whose pickled arguments overflow the
        # pipe blocks until that child has imported everything, so the
        # ranks would start one after another
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"), fn,
                                   os.path.join(tmp, "payload.pkl"), queue, group))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors = [None] * world, []
        try:
            for _ in range(world):
                rank, out, err = queue.get(timeout=timeout)
                results[rank] = out
                if err:
                    errors.append(f"rank {rank}:\n{err}")
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if errors else 30)
                if p.is_alive():
                    p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# rank programs (run by spawn_ranks; torch only)
# ---------------------------------------------------------------------------

#: the collectives grid's meshes: (shape, axes slowest first, fast axes
#: fastest first, slow axis) — tests/batteries/schedule_battery.py's
COLLECTIVE_MESHES = {
    "1tier": ((8,), ("data",), ("data",), None),
    "2tier": ((2, 4), ("pod", "data"), ("data",), "pod"),
    "3tier": ((2, 2, 2), ("pod", "host", "data"), ("data", "host"), "pod"),
}


def collective_cfg(sched_mod, case):
    """The case's ``SyncConfig``, built by either package's ``schedule``."""
    mesh, chunks, codec, pipeline, op, shape, dim = case
    return sched_mod.SyncConfig("hier_striped", chunks=chunks, codec=codec,
                                codec_block=128, pipeline=pipeline)


def collective_schedule(sched_mod, case, sizes):
    """The case's schedule, built by either package's ``schedule``."""
    mesh, chunks, codec, pipeline, op, shape, dim = case
    _, _, fast, slow = COLLECTIVE_MESHES[mesh]
    return sched_mod.schedule_from_axes(fast, slow, collective_cfg(sched_mod, case),
                                        shape, dim, sizes)


def rank_collectives(rank, payload):
    """Each case of ``payload["cases"]`` on this rank: its input row
    (``payload["x"][shape][rank]``) through ``lower_all_reduce``,
    ``lower_reduce_scatter`` + ``dfabric_all_gather``, or ``pod_psum`` (the
    bare slow leg, its EF the size of the input); returns {case index:
    (output, new EF or None, gathered or None, leg log == schedule legs)}."""
    from repro_torch.core import prims, schedule
    from repro_torch.core.collectives import (dfabric_all_gather,
                                              lower_all_reduce,
                                              lower_reduce_scatter, pod_psum)
    meshes = {name: prims.Mesh(dict(zip(axes, shape)))
              for name, (shape, axes, _, _) in COLLECTIVE_MESHES.items()}
    out = {}
    for i, case in enumerate(payload["cases"]):
        mesh_name, chunks, codec, pipeline, op, shape, dim = case
        mesh = meshes[mesh_name]
        x = torch.from_numpy(payload["x"][str(shape)][rank])
        ef_key = mesh_name + ("/full" if op == "pod_psum" else "")
        ef = torch.from_numpy(payload["ef"][str(shape)][ef_key][rank]) \
            if codec else None
        with prims.bind(mesh):
            sched = collective_schedule(schedule, case, mesh.sizes)
            log = []
            if op == "pod_psum":
                y, nef = pod_psum(x, COLLECTIVE_MESHES[mesh_name][3],
                                  collective_cfg(schedule, case), ef=ef)
                out[i] = (y.numpy(), None if nef is None else nef.numpy(),
                          None, True)
                continue
            if op == "all_reduce":
                y, nef = lower_all_reduce(sched, x, ef=ef, leg_log=log)
                gathered = None
            else:
                y, nef = lower_reduce_scatter(sched, x, ef=ef, leg_log=log)
                gathered = dfabric_all_gather(
                    y, COLLECTIVE_MESHES[mesh_name][2], gather_dim=dim).numpy()
            legs = list(sched.legs) if op == "all_reduce" else \
                list(sched.down_legs) + list(sched.slow_legs)
        out[i] = (y.numpy(), None if nef is None else nef.numpy(), gathered,
                  log == legs)
    return out


#: the codec grid's meshes: the collectives grid's, and (4, 2), whose slow
#: leg adds 4 members' top-k sets (the combine order)
CODEC_MESHES = dict(COLLECTIVE_MESHES,
                    **{"4x2": ((4, 2), ("pod", "data"), ("data",), "pod")})


def codec_schedule(sched_mod, case, sizes):
    """(the case's ``SyncConfig``, its schedule or None for ``pod_psum``),
    built by either package's ``schedule``; a case is (mesh, SyncConfig
    fields, op, shape, scatter dim)."""
    mesh, fields, op, shape, dim = case
    _, _, fast, slow = CODEC_MESHES[mesh]
    cfg = sched_mod.SyncConfig(**fields)
    if op == "pod_psum":
        return cfg, None
    return cfg, sched_mod.schedule_from_axes(fast, slow, cfg, tuple(shape),
                                             dim, sizes)


def rank_codec_collectives(rank, payload):
    """Each case of ``payload["cases"]`` on this rank: its input row
    ``payload["x"][i][rank]`` (and EF row, where the case has one) through
    ``lower_all_reduce``, ``lower_reduce_scatter`` + ``dfabric_all_gather``
    or ``pod_psum``; returns {case index: (output, new EF or None, gathered
    or None, leg log == the schedule's legs)}."""
    from repro_torch.core import prims, schedule
    from repro_torch.core.collectives import (dfabric_all_gather,
                                              lower_all_reduce,
                                              lower_reduce_scatter, pod_psum)
    meshes = {name: prims.Mesh(dict(zip(axes, shape)))
              for name, (shape, axes, _, _) in CODEC_MESHES.items()}
    out = {}
    for i, case in enumerate(payload["cases"]):
        mesh_name, _, op, shape, dim = case
        mesh = meshes[mesh_name]
        x = torch.from_numpy(payload["x"][i][rank])
        ef = payload["ef"][i]
        ef = None if ef is None else torch.from_numpy(ef[rank])
        log, gathered = [], None
        with prims.bind(mesh):
            cfg, sched = codec_schedule(schedule, case, mesh.sizes)
            if op == "pod_psum":
                y, nef = pod_psum(x, CODEC_MESHES[mesh_name][3], cfg, ef=ef)
                legs = log
            elif op == "all_reduce":
                y, nef = lower_all_reduce(sched, x, ef=ef, leg_log=log)
                legs = list(sched.legs)
            else:
                y, nef = lower_reduce_scatter(sched, x, ef=ef, leg_log=log)
                gathered = dfabric_all_gather(
                    y, CODEC_MESHES[mesh_name][2], gather_dim=dim).numpy()
                legs = list(sched.down_legs) + list(sched.slow_legs)
        out[i] = (y.numpy(), None if nef is None else nef.numpy(), gathered,
                  log == legs)
    return out


#: ``tests/batteries/alltoall_battery.py``'s meshes: (shape, axes slowest
#: first, fast axes fastest first, slow axis)
ALLTOALL_MESHES = {
    "8": ((8,), ("data",), ("data",), None),
    "2x4": ((2, 4), ("pod", "data"), ("data",), "pod"),
    "4x2": ((4, 2), ("pod", "data"), ("data",), "pod"),
    "2x2x2": ((2, 2, 2), ("pod", "host", "data"), ("data", "host"), "pod"),
}
ALLTOALL_TIERS = {"data": "ici", "host": "cxl", "pod": "dcn"}


def alltoall_schedules(sched_mod, mesh_name, shape, dest_sizes=None):
    """{(chunks, lane offset): the all-to-all schedule} on a mesh of
    ``ALLTOALL_MESHES``, chunks 1/2/4 x every lane offset, built by either
    package's ``schedule`` as the battery builds them."""
    dims, axes, fast, slow = ALLTOALL_MESHES[mesh_name]
    sizes = dict(zip(axes, dims))
    out = {}
    for chunks in (1, 2, 4):
        s = sched_mod.all_to_all_from_axes(
            fast, slow, sched_mod.SyncConfig(chunks=chunks), shape, sizes,
            tier_names=ALLTOALL_TIERS, dest_sizes=dest_sizes)
        for off in range(max(len(s.slow_legs), 1)):
            out[(chunks, off)] = s.with_lane_offset(off)
    return out


def rank_alltoall(rank, payload):
    """On each mesh of ``ALLTOALL_MESHES``: this rank's row of
    ``payload["x"]`` through ``lower_all_to_all`` for every schedule of
    ``alltoall_schedules`` (and the skewed ones of ``payload["skew"]``),
    through ``dfabric_all_to_all`` built in place for each chunk count,
    and through one flat ``all_to_all_single`` over the world.  Returns
    {mesh: {"flat": out, (chunks, offset): (out, leg log), ("skew", chunks,
    offset): out, ("in_place", chunks): out}}."""
    import torch.distributed as dist
    from repro_torch.core import prims, schedule
    from repro_torch.core.collectives import (dfabric_all_to_all,
                                              lower_all_to_all)
    x = torch.from_numpy(payload["x"][rank])
    flat = torch.empty_like(x)
    dist.all_to_all_single(flat, x)
    out = {}
    for name, (dims, axes, fast, slow) in ALLTOALL_MESHES.items():
        mesh = prims.Mesh(dict(zip(axes, dims)))
        res = {"flat": flat.numpy()}
        with prims.bind(mesh):
            for key, s in alltoall_schedules(schedule, name, tuple(x.shape)).items():
                log = []
                res[key] = (lower_all_to_all(s, x, leg_log=log).numpy(), log)
            for key, s in alltoall_schedules(schedule, name, tuple(x.shape),
                                             payload["skew"]).items():
                res[("skew",) + key] = lower_all_to_all(s, x).numpy()
            for chunks in (1, 2, 4):
                res[("in_place", chunks)] = dfabric_all_to_all(
                    x, fast, slow, schedule.SyncConfig(chunks=chunks)).numpy()
        out[name] = res
    return out


#: ring all-reduce cases: (mesh sizes, ring axis);
#: ``tests/batteries/collectives_battery.py``'s (ring over "data" within
#: each pod of a (2, 2, 2) mesh) and one 8-member ring
RING_CASES = {
    "battery": ({"pod": 2, "data": 2, "model": 2}, "data"),
    "ring8": ({"data": 8}, "data"),
}


def rank_ring(rank, payload):
    """``ring_all_reduce`` and ``prims.psum`` of this rank's rows of
    ``payload[case][kind]`` over each case's ring axis; returns {(case,
    kind): (ring, psum)}."""
    from repro_torch.core import prims
    from repro_torch.core.collectives import ring_all_reduce
    out = {}
    for case, (sizes, axis) in RING_CASES.items():
        mesh = prims.Mesh(sizes)
        with prims.bind(mesh):
            for kind, rows in payload[case].items():
                x = torch.from_numpy(rows[rank])
                out[(case, kind)] = (ring_all_reduce(x, axis, mesh.size(axis)).numpy(),
                                     prims.psum(x, axis).numpy())
    return out


#: the Trainer comparison's settings, shared by both packages' runs
TRAIN = dict(steps=4, lr=8e-3, warmup=2, log_every=0, seed=3)
TRAIN_SHAPE = dict(global_batch=8, seq_len=32)
TRAIN_LOSS_CHUNK = 16


def rank_trainer(rank, payload):
    """The port's ``Trainer`` on this rank, from ``payload["weights"]`` (a
    flat JAX tree of numpy arrays) on the mesh ``payload["sizes"]`` with
    ``payload["cfg"]`` (TrainerConfig fields beside ``TRAIN``, which
    ``payload["train"]`` may override), for the smoke config of
    ``payload["arch"]`` (``ARCH`` unless given; experts included).  Returns
    (losses, final params flat as numpy, {section: {m, v[, ef]: this
    rank's local block}}, this rank's mesh coords as a sorted tuple)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.utils.trees import tree_paths
    mesh = prims.Mesh(payload["sizes"])
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="none", loss_chunk=TRAIN_LOSS_CHUNK, max_seq=MAX_SEQ)
    model = build_model(get_smoke_arch(payload.get("arch", ARCH)), st,
                        device="cpu")
    load_jax_params(model, payload["weights"])
    shape = ShapeConfig("t", TRAIN_SHAPE["seq_len"], TRAIN_SHAPE["global_batch"],
                        "train")
    trainer = Trainer(model, mesh, shape, TrainerConfig(
        **{**TRAIN, **payload.get("train", {})}, **payload["cfg"]))
    out = trainer.train()
    params = {k: v.detach().numpy().copy()
              for k, v in tree_paths(out["params"]).items()}
    state = {name: {k: t.numpy().copy() for k, t in e.items()}
             for name, e in out["opt"]["sections"].items()}
    return ([m["loss"] for m in out["metrics"]], params, state,
            tuple(sorted(mesh.coords.items())))


TRAINER_JAX_SCRIPT = r'''
import os, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_arch
from repro.models import ModelSettings, build_model
from repro.runtime.train_loop import Trainer, TrainerConfig
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
runs, weights = json.loads(str(z["runs"])), z["weights"].item()
train, shp = json.loads(str(z["train"])), json.loads(str(z["shape"]))

class Shape:
    global_batch, seq_len = shp["global_batch"], shp["seq_len"]
    name, kind = "t", "train"

st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                   remat="none", loss_chunk=int(z["loss_chunk"]), max_seq=64)
model = build_model(get_smoke_arch(str(z["arch"])), st)
res = {}
for name, (sizes, cfg) in runs.items():
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    tr = Trainer(model, mesh, Shape(), TrainerConfig(**train, **cfg))
    params = jax.device_put(tree_from_paths({k: jnp.asarray(v) for k, v in weights.items()}),
                            NamedSharding(mesh, P()))
    opt = jax.device_put(tr._init_state(), tr.state_sharding)
    out = tr.train(params, opt, 0)
    res[f"{name}/loss"] = np.array([m["loss"] for m in out["metrics"]])
    for k, v in tree_paths(out["params"]).items():
        res[f"{name}/p/{k}"] = np.asarray(v)
    for sec, entry in out["opt"]["sections"].items():
        for k, v in entry.items():
            res[f"{name}/s/{sec}/{k}"] = np.asarray(v)
np.savez(os.environ["JAX_OUT"], **res)
'''


def jax_trainer_runs(runs, weights, arch: str = ARCH, train=None):
    """The JAX ``Trainer`` on 8 fake devices for each of ``runs`` ({name:
    (mesh sizes, TrainerConfig fields)}) from the flat ``weights``, on the
    smoke config of ``arch``; ``train`` overrides fields of ``TRAIN``."""
    import json
    return run_jax_devices(TRAINER_JAX_SCRIPT, {
        "runs": np.array(json.dumps(runs)), "weights": np.array(weights, dtype=object),
        "train": np.array(json.dumps({**TRAIN, **(train or {})})),
        "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK), "arch": np.array(arch)})


def lossy(cfg) -> bool:
    """Whether a run's sync rounds: the int8 or top-k slow codec, or the
    mid-tier codec; such runs are held to the int8 tolerances."""
    return cfg.get("codec") in ("int8", "topk") or cfg.get("mid_codec") is not None


def plan_fields(cfg) -> dict:
    """The ``make_sync_plan`` arguments beside the codec in a run's
    fields (the step-level runs name them; the ``Trainer`` passes none)."""
    return {k: cfg[k] for k in ("mid_codec", "strategy") if k in cfg}


def run_topology(sizes, cfg, topology_mod=None):
    """The topology a run plans with: ``three_tier_fabric`` for the runs
    that name ``fabric: "3tier"``, else the ``Trainer``'s default; built
    by the port's ``topology`` or, given, the JAX package's."""
    if topology_mod is None:
        from repro_torch.core import topology as topology_mod
    if cfg.get("fabric") == "3tier":
        return topology_mod.three_tier_fabric(
            num_pods=sizes["pod"], hosts_per_pod=sizes["host"],
            chips_per_host=sizes["data"])
    return topology_mod.topology_from_mesh_sizes(sizes)


def rank_sync_plan_steps(rank, payload):
    """``TRAIN["steps"]`` steps of the port's ``make_dfabric_train_step``
    on this rank, with the plan of ``make_sync_plan(model, sizes,
    run_topology(...), codec=..., **plan_fields(...))`` from
    ``payload["cfg"]``, on the smoke model loaded from
    ``payload["weights"]`` and the ``Trainer``'s data and schedule.
    Returns what ``rank_trainer`` does, and the plan's ``to_json()``."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import (local_rows,
                                                make_dfabric_train_step,
                                                make_sync_plan)
    from repro_torch.utils.trees import tree_paths
    sizes, cfg = payload["sizes"], payload["cfg"]
    mesh = prims.Mesh(sizes)
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="none", loss_chunk=TRAIN_LOSS_CHUNK)
    model = build_model(get_smoke_arch(ARCH), st, device="cpu")
    load_jax_params(model, payload["weights"])
    plan, ss = make_sync_plan(model, sizes, run_topology(sizes, cfg),
                              codec=cfg.get("codec"), **plan_fields(cfg))
    step_fn, init_state = make_dfabric_train_step(
        model, mesh, plan, ss, AdamWConfig(),
        cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"]))
    model.requires_grad_(True)
    params, state = model.params(), init_state()
    pipe = TokenPipeline(model.arch, ShapeConfig("t", TRAIN_SHAPE["seq_len"],
                                                 TRAIN_SHAPE["global_batch"], "train"),
                         DataConfig(seed=TRAIN["seed"]))
    losses = []
    for step in range(TRAIN["steps"]):
        batch = {k: torch.from_numpy(v)
                 for k, v in local_rows(pipe.batch_at(step), mesh).items()}
        params, state, metrics = step_fn(params, state, batch, step)
        losses.append(float(metrics["loss"]))
    return (losses, {k: v.detach().numpy().copy() for k, v in tree_paths(params).items()},
            {name: {k: t.numpy().copy() for k, t in e.items()}
             for name, e in state["sections"].items()},
            tuple(sorted(mesh.coords.items()))), plan.to_json()


def rank_in_place_steps(rank, payload):
    """Two DFabric steps (the int8 slow tier, ZeRO-1) on (pod, data, model)
    = (2, 1, 1) and two GSPMD steps on (1, 2, 1) of the smoke model, from
    random batches; for each, whether every parameter and the optimizer's
    moments kept their storage (``data_ptr``) and whether the returned
    trees hold the given tensors — what ``donated_jit`` gives the
    reference.  The error feedback is left out: the codec returns it as a
    fresh residual, which replaces the old one."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import prims
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import (make_dfabric_train_step,
                                                make_gspmd_train_step,
                                                make_sync_plan)
    from repro_torch.utils.trees import tree_paths

    def tensors(tree):
        return {k: v for k, v in tree_paths(tree).items()
                if isinstance(v, torch.Tensor)}

    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="none", loss_chunk=TRAIN_LOSS_CHUNK)
    lr = cosine_schedule(1e-3, 1, 4)
    gen = torch.Generator().manual_seed(rank)
    out = {}
    for mode, sizes in (("dfabric", {"pod": 2, "data": 1, "model": 1}),
                        ("gspmd", {"pod": 1, "data": 2, "model": 1})):
        mesh = prims.Mesh(sizes)
        model = build_model(get_smoke_arch(ARCH), st, device="cpu")
        load_jax_params(model, payload["weights"])
        if mode == "dfabric":
            plan, ss = make_sync_plan(model, sizes,
                                      run_topology(sizes, {}), codec="int8")
            step_fn, init = make_dfabric_train_step(model, mesh, plan, ss,
                                                    AdamWConfig(), lr)
        else:
            step_fn, init, _ = make_gspmd_train_step(model, mesh, AdamWConfig(), lr)
        model.requires_grad_(True)
        params, state = model.params(), init()
        given = {**{f"p/{k}": v for k, v in tensors(params).items()},
                 **{f"s/{k}": v for k, v in tensors(state).items()
                    if not k.endswith("/ef")}}
        ptrs = {k: v.data_ptr() for k, v in given.items()}
        before = {k: v.detach().clone() for k, v in tensors(params).items()}
        for step in range(2):
            batch = {k: torch.randint(0, 512, (2, 16), generator=gen)
                     for k in ("tokens", "labels")}
            params, state, _ = step_fn(params, state, batch, step)
        now = {**{f"p/{k}": v for k, v in tensors(params).items()},
               **{f"s/{k}": v for k, v in tensors(state).items()
                  if not k.endswith("/ef")}}
        out[mode] = {"same_storage": {k: v.data_ptr() == ptrs[k]
                                      for k, v in now.items()},
                     "same_tensors": all(now[k] is given[k] for k in given),
                     "updated": all(not torch.equal(before[k], v)
                                    for k, v in tensors(params).items()),
                     "keys": sorted(now) == sorted(given),
                     "has_ef": any(k.endswith("/ef")
                                   for k in tree_paths(state))}
    return out


STEP_JAX_SCRIPT = r'''
import os, sys, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_arch
from repro.core import topology
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.models import ModelSettings, build_model
from repro.optim.adamw import AdamWConfig, cosine_schedule
from repro.runtime.train_loop import (batch_sharding, make_dfabric_train_step,
                                      make_sync_plan, mesh_info)
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths
sys.path.insert(0, os.environ["TESTS_DIR"])
from torch_harness import plan_fields, run_topology

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
runs, weights = json.loads(str(z["runs"])), z["weights"].item()
train, shp = json.loads(str(z["train"])), json.loads(str(z["shape"]))

class Shape:
    global_batch, seq_len = shp["global_batch"], shp["seq_len"]
    name, kind = "t", "train"

st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                   remat="none", loss_chunk=int(z["loss_chunk"]), max_seq=64)
model = build_model(get_smoke_arch(str(z["arch"])), st)
res = {}
for name, (sizes, cfg) in runs.items():
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    plan, ss = make_sync_plan(model, mesh, run_topology(sizes, cfg, topology),
                              codec=cfg.get("codec"), **plan_fields(cfg))
    step_fn, init_state, state_sharding = make_dfabric_train_step(
        model, mesh, plan, ss, AdamWConfig(),
        cosine_schedule(train["lr"], train["warmup"], train["steps"]))
    params = jax.device_put(tree_from_paths({k: jnp.asarray(v) for k, v in weights.items()}),
                            NamedSharding(mesh, P()))
    opt = jax.device_put(init_state(), state_sharding)
    bshard = batch_sharding(mesh, model, mesh_info(mesh))
    pipe = TokenPipeline(model.arch, Shape(), DataConfig(seed=train["seed"]))
    losses = []
    for step in range(train["steps"]):
        batch = {k: jax.device_put(v, bshard[k]) for k, v in pipe.batch_at(step).items()}
        params, opt, metrics = step_fn(params, opt, batch, jnp.int32(step))
        losses.append(float(metrics["loss"]))
    res[f"{name}/loss"] = np.array(losses)
    res[f"{name}/plan"] = np.array(plan.to_json())
    for k, v in tree_paths(params).items():
        res[f"{name}/p/{k}"] = np.asarray(v)
    for sec, entry in opt["sections"].items():
        for k, v in entry.items():
            res[f"{name}/s/{sec}/{k}"] = np.asarray(v)
np.savez(os.environ["JAX_OUT"], **res)
'''


def jax_step_runs(runs, weights):
    """The JAX ``make_dfabric_train_step`` on 8 fake devices for each of
    ``runs`` ({name: (mesh sizes, plan fields)}), as
    ``rank_sync_plan_steps`` runs the port's."""
    import json
    os.environ["TESTS_DIR"] = os.path.dirname(os.path.abspath(__file__))
    return run_jax_devices(STEP_JAX_SCRIPT, {
        "runs": np.array(json.dumps(runs)), "weights": np.array(weights, dtype=object),
        "train": np.array(json.dumps(TRAIN)), "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK), "arch": np.array(ARCH)})


def check_trainer_run(name, sizes, cfg, jax_out, per_rank):
    """The port's run (``rank_trainer``'s result on each rank) against the
    JAX one, to the tolerances set out in ``test_torch_trainer.py``: losses,
    final parameters, and the sync state (each rank's local blocks put
    together with ``grad_sync.assemble`` against the JAX global arrays)."""
    losses, params, _, _ = per_rank[0]
    jloss = jax_out[f"{name}/loss"]
    int8 = lossy(cfg)
    assert len(losses) == TRAIN["steps"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jloss, rtol=1e-3 if int8 else 1e-4)
    for rank, (_, p, _, _) in enumerate(per_rank[1:], 1):  # the DP invariant
        for k in params:
            np.testing.assert_array_equal(p[k], params[k], err_msg=f"rank {rank} {k}")
    far = total = 0
    bound = 2 * TRAIN["lr"] * TRAIN["steps"]
    for k, v in params.items():
        d = np.abs(v - jax_out[f"{name}/p/{k}"])
        if k.endswith("attn/bk"):  # zero gradient but for rounding
            assert d.max() <= bound, (k, d.max())
        elif int8:
            assert d.max() <= bound, (k, d.max())
            far += int((d > 2e-5).sum())
            total += d.size
        else:
            np.testing.assert_allclose(v, jax_out[f"{name}/p/{k}"], atol=2e-5,
                                       rtol=0, err_msg=k)
    assert far <= 1e-2 * total, (far, total)
    check_sync_state(name, sizes, cfg, jax_out, per_rank)


def check_sync_state(name, sizes, cfg, jax_out, per_rank):
    """Every section's m, v (and EF) put together from the ranks' local
    blocks by the port's specs equals the JAX global array: m and v to
    1e-4 of their range (in 99% of the elements with int8: the flips of
    ``test_torch_trainer.py``).  The EF state is the quantization residual
    of the gradient plus the old EF, ~127x smaller than that sum, so it
    carries the gradients' absolute differences (summation order) at ~250x
    its own range, and a flip moves an element by a whole scale (~2x its
    range): it is held to 1e-2 of its range in 99% of the elements."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.optim import grad_sync
    from repro_torch.runtime.train_loop import make_sync_plan
    import dataclasses
    st = ModelSettings(param_dtype="float32", compute_dtype="float32")
    model = build_model(get_smoke_arch(ARCH), st, device="meta")
    plan, ss = make_sync_plan(model, sizes, run_topology(sizes, cfg),
                              codec=cfg.get("codec"), **plan_fields(cfg))
    if not cfg.get("zero1", True):
        ss = dataclasses.replace(ss, mode="paper")
    specs = grad_sync.sync_state_specs(plan, model.param_shapes(), ss)
    int8 = lossy(cfg)
    for sec in plan.sections:
        for k, spec in specs["sections"][sec.name].items():
            want = jax_out[f"{name}/s/{sec.name}/{k}"]
            blocks = {coords: state[sec.name][k]
                      for _, _, state, coords in per_rank}
            for coords, blk in blocks.items():  # each block is its spec's
                np.testing.assert_array_equal(
                    grad_sync.local_shape(want.shape, spec, sizes), blk.shape)
            got = grad_sync.assemble(blocks, spec, want.shape, sizes,
                                     lambda parts, d: np.concatenate(parts, d))
            assert got.shape == want.shape, (sec.name, k)
            rel = 1e-2 if k == "ef" else 1e-4
            close = np.abs(got - want) <= rel * np.abs(want).max() + 1e-12
            if int8:
                assert close.mean() >= 0.99, (sec.name, k, close.mean())
            else:
                assert close.all(), (sec.name, k, np.abs(got - want).max())
            blk = grad_sync.local_block(want, spec, dict(per_rank[0][3]), sizes)
            assert blk.shape == per_rank[0][2][sec.name][k].shape


# ---------------------------------------------------------------------------
# fault tolerance: checkpoint, crash, restart, preemption (both packages)
# ---------------------------------------------------------------------------

#: the fault runs' settings beside ``steps`` (the Trainer comparison's)
FAULT = {k: v for k, v in TRAIN.items() if k != "steps"}


def rank_fault_runs(rank, payload):
    """A sequence of the port's ``Trainer`` runs on this rank, each on
    one model that starts from ``payload["weights"]`` (or the newest
    checkpoint of its dir; a restart in the same process).  Each of
    ``payload["runs"]`` holds ``cfg`` (TrainerConfig fields beside
    ``FAULT``) and optionally ``preempt_rank`` (that rank's trainer is
    flagged preempted before it trains) and ``slow_save`` (seconds added to
    each ``np.save`` of the checkpoint writer).  A ``SimulatedFailure`` is
    caught and recorded.  Returns one record a run: the steps and losses
    it ran, the error, whether it restored, LATEST after it, the
    parameters (rank 0) and this rank's sync-state blocks after its last
    step (after the restore if it ran none), its coords, its checkpoint
    timings and the step it ended at."""
    import time as _time

    import repro_torch.checkpoint.manager as ckpt_mod
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.runtime.train_loop import (SimulatedFailure, Trainer,
                                                TrainerConfig)
    from repro_torch.utils.trees import tree_paths
    mesh = prims.Mesh(payload["sizes"])
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="none", loss_chunk=TRAIN_LOSS_CHUNK)
    model = build_model(get_smoke_arch(ARCH), st, device="cpu")
    shape = ShapeConfig("t", TRAIN_SHAPE["seq_len"], TRAIN_SHAPE["global_batch"],
                        "train")
    real_save = ckpt_mod.np.save
    records = []
    for run in payload["runs"]:
        load_jax_params(model, payload["weights"])  # what a new process has
        delay = run.get("slow_save", 0)

        def save(*a, **k):
            _time.sleep(delay)
            return real_save(*a, **k)

        ckpt_mod.np.save = save if delay else real_save
        trainer = Trainer(model, mesh, shape, TrainerConfig(**FAULT, **run["cfg"]))
        if run.get("preempt_rank") == rank:
            trainer._preempted = True  # as the SIGTERM handler would
        last = {}

        def on_step(step, params, opt, metrics):
            last["state"] = {name: {k: t.detach().numpy().copy()
                                    for k, t in e.items()}
                             for name, e in opt["sections"].items()}

        error = None
        try:
            out = trainer.train(on_step=on_step)
        except SimulatedFailure as exc:
            error = type(exc).__name__
        log = trainer.metrics_log
        records.append(dict(
            steps=[m["step"] for m in log], losses=[m["loss"] for m in log],
            error=error, latest=trainer.ckpt.latest_step() if trainer.ckpt else None,
            restored=trainer.restore_s is not None,
            params=({k: v.detach().numpy().copy()
                     for k, v in tree_paths(model.params()).items()}
                    if rank == 0 else None),
            state=(last.get("state") if error else
                   {name: {k: t.detach().numpy().copy() for k, t in e.items()}
                    for name, e in out["opt"]["sections"].items()}),
            coords=tuple(sorted(mesh.coords.items())),
            ckpt_log=trainer.ckpt_log,
            stats=trainer.ckpt.stats if trainer.ckpt else None,
            end=None if error else out["step"]))
    ckpt_mod.np.save = real_save
    return records


FAULT_JAX_SCRIPT = r'''
import os, json, shutil
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_arch
from repro.models import ModelSettings, build_model
from repro.runtime.train_loop import SimulatedFailure, Trainer, TrainerConfig
from repro.utils.jax_compat import make_mesh
from repro.utils.trees import tree_from_paths, tree_paths

z = np.load(os.environ["JAX_IN"], allow_pickle=True)
runs, weights = json.loads(str(z["runs"])), z["weights"].item()
base, shp = json.loads(str(z["base"])), json.loads(str(z["shape"]))

class Shape:
    global_batch, seq_len = shp["global_batch"], shp["seq_len"]
    name, kind = "t", "train"

st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                   remat="none", loss_chunk=int(z["loss_chunk"]), max_seq=64)
model = build_model(get_smoke_arch(str(z["arch"])), st)
res = {}
for run in runs:
    name, sizes = run["name"], run["sizes"]
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    tr = Trainer(model, mesh, Shape(), TrainerConfig(**base, **run["cfg"]))
    try:
        if run["fresh"]:
            params = jax.device_put(
                tree_from_paths({k: jnp.asarray(v) for k, v in weights.items()}),
                NamedSharding(mesh, P()))
            out = tr.train(params, jax.device_put(tr._init_state(), tr.state_sharding), 0)
        else:
            out = tr.train()  # restores the newest checkpoint
        for k, v in tree_paths(out["params"]).items():
            res[f"{name}/p/{k}"] = np.asarray(v)
    except SimulatedFailure:
        tr.ckpt.wait()  # the reference raises before draining its write
    if run.get("copy_to"):
        shutil.copytree(run["cfg"]["ckpt_dir"], run["copy_to"])
    res[f"{name}/steps"] = np.array([m["step"] for m in tr.metrics_log])
    res[f"{name}/loss"] = np.array([m["loss"] for m in tr.metrics_log])
np.savez(os.environ["JAX_OUT"], **res)
'''


def jax_fault_runs(runs, weights, n_devices: int = 8):
    """The JAX ``Trainer`` for each of ``runs`` in order (a list of {name,
    sizes, cfg: TrainerConfig fields beside ``FAULT``, fresh: start from
    ``weights`` rather than the newest checkpoint, and optionally copy_to:
    a dir the run's checkpoint dir is copied to after it}), on fake
    devices.  A ``SimulatedFailure`` is caught after draining the pending
    write.
    Returns {name/steps, name/loss, name/p/<path> (runs that finished)}."""
    import json
    return run_jax_devices(FAULT_JAX_SCRIPT, {
        "runs": np.array(json.dumps(runs)), "weights": np.array(weights, dtype=object),
        "base": np.array(json.dumps(FAULT)), "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK), "arch": np.array(ARCH)},
        n_devices=n_devices)


def check_params_close(params, jax_params, int8: bool, steps: int):
    """The final parameters of a port run against a JAX run's, to the
    tolerances of ``test_torch_trainer.py`` (``check_trainer_run``)."""
    far = total = 0
    bound = 2 * TRAIN["lr"] * steps
    for k, v in params.items():
        d = np.abs(v - jax_params[k])
        if k.endswith("attn/bk"):  # zero gradient but for rounding
            assert d.max() <= bound, (k, d.max())
        elif int8:
            assert d.max() <= bound, (k, d.max())
            far += int((d > 2e-5).sum())
            total += d.size
        else:
            np.testing.assert_allclose(v, jax_params[k], atol=2e-5, rtol=0,
                                       err_msg=k)
    assert far <= 1e-2 * total, (far, total)


# ---------------------------------------------------------------------------
# tensor parallelism and the GSPMD step (both packages)
# ---------------------------------------------------------------------------


def rank_tp_grads(rank, payload):
    """:func:`tp_grads` for each case of ``payload["cases"]``, in order."""
    return [tp_grads(rank, case) for case in payload["cases"]]


def rank_second_cut(rank, payload):
    """Two ``make_dfabric_train_step`` calls on one model on the mesh
    ``payload["sizes"]``, then ``make_gspmd_train_step`` (FSDP, another
    layout) on it.  Returns ({path: shape} after each DFabric call, the
    shapes the first cut should give, the loss of one step after the
    second call, the GSPMD call's error or None)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import prims
    from repro_torch.models.sharding import local_shape
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import (local_rows,
                                                make_dfabric_train_step,
                                                make_gspmd_train_step,
                                                make_sync_plan, mesh_info)
    from repro_torch.utils.trees import tree_paths
    sizes = payload["sizes"]
    mesh = prims.Mesh(sizes)
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="none", loss_chunk=TRAIN_LOSS_CHUNK)
    model = build_model(get_smoke_arch(ARCH), st, device="cpu")
    shapes = {k: v.shape for k, v in tree_paths(model.param_shapes()).items()}
    specs = tree_paths(model.param_specs(mesh_info(sizes)))
    want = {k: local_shape(sh, specs[k], sizes) for k, sh in shapes.items()}
    plan, ss = make_sync_plan(model, sizes, run_topology(sizes, {}))
    lr = cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"])
    cuts = []
    for _ in range(2):
        step_fn, init_state = make_dfabric_train_step(model, mesh, plan, ss,
                                                      AdamWConfig(), lr)
        cuts.append({k: tuple(v.shape)
                     for k, v in tree_paths(model.params()).items()})
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in local_rows(payload["batch"], mesh).items()}
    _, _, metrics = step_fn(model.params(), init_state(), batch, 0)
    try:
        make_gspmd_train_step(model, mesh, AdamWConfig(), lr)
        err = None
    except ValueError as e:
        err = str(e)
    return cuts, want, float(metrics["loss"]), err


def tp_grads(rank, payload):
    """The port's loss and gradients on this rank with the model cut for
    the mesh ``payload["sizes"]`` (TP over ``model``, or with
    ``payload["tp_scope"]`` "embed_only" the embedding and head only;
    FSDP over ``data`` when ``payload["fsdp"]``; with that or
    ``payload["gspmd"]`` the loss the batch mean summed over the DP
    members), from ``payload["weights"]`` of ``payload["arch"]``'s smoke
    config and ``payload["settings"]`` (``ModelSettings`` fields), on this
    member's rows of ``payload["batch"]``.  Returns (the loss, summed over
    the DP axes in the GSPMD case; {path: this member's gradient block,
    there summed over the DP axes its spec does not name}; the
    coords; the layout's specs; the (token, k) slots each MoE layer of the
    forward dropped on this member, a list)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    from repro_torch.runtime.train_loop import dp_axes_of, local_rows, mesh_info
    from repro_torch.models.sharding import spec_axes
    from repro_torch.utils.trees import tree_paths
    sizes, fsdp = payload["sizes"], payload.get("fsdp", False)
    mesh = prims.Mesh(sizes)
    torch.manual_seed(0)
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat=payload.get("remat", "none"),
                       loss_chunk=payload.get("loss_chunk", 2048), max_seq=MAX_SEQ,
                       **payload.get("settings", {}))
    model = build_model(get_smoke_arch(payload["arch"]), st, device="cpu")
    dp = dp_axes_of(sizes)
    mi = mesh_info(sizes, fsdp=fsdp)
    mi.tp_scope = payload.get("tp_scope", "full")
    gspmd = fsdp or payload.get("gspmd", False)  # the loss: the batch mean
    model.shard(mi, sizes, mesh.coords, loss_axes=dp if gspmd else ())
    load_jax_params(model, payload["weights"])
    batch = {k: torch.from_numpy(v)
             for k, v in local_rows(payload["batch"], mesh).items()}
    with prims.bind(mesh):
        params = model.params()
        flat = tree_paths(params)
        for t in flat.values():
            t.requires_grad_(True)
        L.DROP_LOG = []
        loss = model.loss(params, batch)
        dropped = [int(d.sum()) for d in L.DROP_LOG]
        L.DROP_LOG = None
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        specs = model.layout.specs
        if gspmd:
            loss = prims.psum(loss.detach(), dp)
            grads = {k: prims.psum(g, tuple(a for a in dp
                                            if a not in spec_axes(specs[k])))
                     for k, g in grads.items()}
        else:
            loss = prims.pmean(loss.detach(), dp)
    return (loss.item(), {k: g.numpy().copy() for k, g in grads.items()},
            tuple(sorted(mesh.coords.items())), dict(specs), dropped)


def assemble_blocks(per_rank, shapes, sizes, what: str = ""):
    """{path: global array} from each rank's (blocks {path: array}, coords
    tuple, specs {path: spec}); every two members that hold the same block
    of a leaf must hold it bit for bit (the replicated leaves across the
    model members, the DP invariant)."""
    from repro_torch.models import sharding
    out = {}
    for k, shape in shapes.items():
        spec = per_rank[0][2][k]
        seen = {}
        for blocks, coords, _ in per_rank:
            idx = sharding.block_coords(spec, dict(coords), sizes)
            if idx in seen:
                np.testing.assert_array_equal(
                    blocks[k], seen[idx], err_msg=f"{what} {k}: block {idx} "
                    f"differs between members")
            seen.setdefault(idx, blocks[k])
        got = sharding.assemble({c: b[k] for b, c, _ in per_rank}, spec, shape,
                                sizes, lambda ps, d: np.concatenate(ps, d))
        assert got.shape == tuple(shape), (k, got.shape, shape)
        out[k] = got
    return out


def port_drops(model, batch):
    """The (token, k) slots each MoE layer of ``model``'s forward drops on
    the numpy ``batch``, unsharded: a list."""
    from repro_torch.models import layers as L
    L.DROP_LOG = []
    try:
        with torch.no_grad():
            model.loss(model.params(), {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        return [int(d.sum()) for d in L.DROP_LOG]
    finally:
        L.DROP_LOG = None


def grad_tolerance(arch: str, want: np.ndarray) -> dict:
    """The tolerance a model-axis gradient is held to against JAX's
    single-device one: rtol 1e-5 with an atol of 1e-5 of the leaf's
    largest value; RWKV6's at ``test_torch_train_families.py``'s atol 1e-5
    + rtol 1e-4, the tolerance its unsharded gradients meet (the fp32
    recurrence's rounding: unsharded, the port's are up to 1.9 x the
    tighter one off JAX's)."""
    if arch == RWKV:
        return dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())


#: the largest value a zero gradient's rounding noise (or its AdamW
#: moments) may take: the smoke models' real gradients are 1e-3 to 1
NOISE = 1e-6


def zero_gradient(arch: str, path: str) -> bool:
    """Whether the leaf (or the sync-state section named after it) at
    ``path`` has a zero true gradient, so that both packages compute
    rounding noise for it: the key biases of attention without rotary
    positions — whisper's self-, cross- and encoder attention — since the
    softmax over the keys is shift invariant (ROADMAP.md queue 3, item
    7).  Such a leaf is held to ``NOISE`` in both packages rather than to
    the other's noise."""
    return arch == WHISPER and path.replace(".", "/").endswith("attn/bk")


def check_round_trip(arch: str, sizes: dict, fsdp: bool):
    """Every leaf of ``arch``'s smoke config (experts included) cut into
    each member's block on the mesh ``sizes`` and put back together:
    the global array, bit for bit.  Returns the specs."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import sharding
    from repro_torch.runtime.train_loop import mesh_info
    from repro_torch.utils.trees import tree_paths
    model = build_model(get_smoke_arch(arch), ModelSettings(**FP32), device="cpu")
    specs = tree_paths(model.param_specs(mesh_info(sizes, fsdp=fsdp)))
    axes = list(sizes)
    members = [dict(zip(axes, idx)) for idx in np.ndindex(*sizes.values())]
    for path, p in tree_paths(model.params()).items():
        x = p.detach().numpy()
        blocks = {tuple(sorted(c.items())): sharding.local_block(x, specs[path], c, sizes)
                  for c in members}
        for c, b in blocks.items():
            assert b.shape == sharding.local_shape(x.shape, specs[path], sizes), path
        got = sharding.assemble(blocks, specs[path], x.shape, sizes,
                                lambda ps, d: np.concatenate(ps, d))
        np.testing.assert_array_equal(got, x, err_msg=path)
    return specs


def check_state_round_trip(arch: str, sizes: dict):
    """Every entry of the DFabric sync state of ``arch``'s smoke config
    (experts included) on the mesh ``sizes`` (the plan's sections, their
    DP scatter merged with the parameters' TP specs) cut into each
    member's block of a random global array and put back together: the
    array, bit for bit.  Returns ({section: leaf paths}, {section: entry
    specs})."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core.topology import topology_from_mesh_sizes
    from repro_torch.models import sharding
    from repro_torch.optim import grad_sync
    from repro_torch.runtime.train_loop import make_sync_plan, mesh_info
    model = build_model(get_smoke_arch(arch), ModelSettings(**FP32), device="cpu")
    plan, ss = make_sync_plan(model, sizes, topology_from_mesh_sizes(sizes))
    pshapes = model.param_shapes()
    specs = grad_sync.merged_state_specs(
        plan, pshapes, model.param_specs(mesh_info(sizes)), ss)["sections"]
    shapes = grad_sync.state_shapes(plan, pshapes, ss)
    members = [dict(zip(sizes, idx)) for idx in np.ndindex(*sizes.values())]
    rng = np.random.default_rng(0)
    for name, entry in specs.items():
        for k, spec in entry.items():
            x = rng.standard_normal(shapes[name]).astype(np.float32)
            blocks = {tuple(sorted(c.items())): sharding.local_block(x, spec, c, sizes)
                      for c in members}
            want = sharding.local_shape(x.shape, spec, sizes)
            assert all(b.shape == want for b in blocks.values()), (name, k)
            got = sharding.assemble(blocks, spec, x.shape, sizes,
                                    lambda ps, d: np.concatenate(ps, d))
            np.testing.assert_array_equal(got, x, err_msg=f"{name}/{k}")
    return {sec.name: sec.leaf_paths for sec in plan.sections}, specs


def rank_tp_trainer(rank, payload):
    """A sequence of the port's ``Trainer`` runs on this rank
    (``payload["runs"]``: each {arch, sizes, cfg: TrainerConfig fields
    beside ``TRAIN``, optionally train: fields of ``TRAIN`` to override,
    settings: ``ModelSettings`` fields, copy_to: a dir, or a list of them,
    member 0 copies the checkpoint dir to after the run}),
    each on a new model of its arch's smoke config (experts included)
    loaded from ``payload["weights"][arch]`` where given (a run with ``ckpt_dir``
    restores the newest checkpoint there first).  Every mesh has the
    world's ranks.  Returns one record a run: losses, this member's
    parameter blocks, its optimizer-state blocks (flat), its coords, the
    layout's specs, the state's specs and whether it restored."""
    import shutil
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.utils.trees import tree_paths
    records = []
    for run in payload["runs"]:
        sizes = run["sizes"]
        st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                           remat=run.get("remat", "none"),
                           loss_chunk=TRAIN_LOSS_CHUNK, max_seq=MAX_SEQ,
                           **run.get("settings", {}))
        model = build_model(get_smoke_arch(run["arch"]), st, device="cpu")
        if run["arch"] in payload["weights"]:  # else the model's own draw
            load_jax_params(model, payload["weights"][run["arch"]])
        shape = ShapeConfig("t", TRAIN_SHAPE["seq_len"],
                            TRAIN_SHAPE["global_batch"], "train")
        mesh = prims.Mesh(sizes)
        trainer = Trainer(model, mesh, shape, TrainerConfig(
            **{**TRAIN, **run.get("train", {})}, **run["cfg"]))
        out = trainer.train()
        if run.get("copy_to") and rank == 0:  # the writes were drained
            for dst in np.atleast_1d(run["copy_to"]):
                shutil.copytree(run["cfg"]["ckpt_dir"], str(dst))
        opt = out["opt"]
        state = ({f"{n}/{k}": t.numpy().copy()
                  for n, e in opt["sections"].items() for k, t in e.items()}
                 if "sections" in opt else
                 {f"{key}/{k}": t.numpy().copy() for key in ("m", "v")
                  for k, t in tree_paths(opt[key]).items()})
        records.append(dict(
            losses=[m["loss"] for m in out["metrics"]],
            params={k: v.detach().numpy().copy()
                    for k, v in tree_paths(out["params"]).items()},
            state=state, coords=tuple(sorted(mesh.coords.items())),
            specs=dict(model.layout.specs),
            state_specs=_flat_state_specs(trainer),
            restored=trainer.restore_s is not None))
    return records


def _flat_state_specs(trainer):
    """{"<section>/<key>" or "m|v/<path>": spec} of a trainer's optimizer
    state."""
    if trainer.plan is None:
        return {f"{key}/{k}": sp for key in ("m", "v")
                for k, sp in trainer.moment_specs.items()}
    return {f"{n}/{k}": sp for n, e in trainer.state_specs()["sections"].items()
            for k, sp in e.items()}


TP_JAX_SCRIPT = r'''
import os, json, shutil
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_arch
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

st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                   remat="none", loss_chunk=int(z["loss_chunk"]), max_seq=64)
res = {}
for run in runs:
    name, sizes, cfg = run["name"], run["sizes"], run["cfg"]
    model = build_model(get_smoke_arch(run["arch"]), st)
    weights = all_weights[run["arch"]]
    mesh = make_mesh(tuple(sizes.values()), tuple(sizes))
    tr = Trainer(model, mesh, Shape(),
                 TrainerConfig(**{**train, **run.get("train", {})}, **cfg))
    if run.get("restore"):
        out = tr.train()
    else:
        params = tree_from_paths({k: jnp.asarray(v) for k, v in weights.items()})
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
        out = tr.train(params, opt, 0)
    if run.get("copy_to"):
        shutil.copytree(cfg["ckpt_dir"], run["copy_to"])
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
np.savez(os.environ["JAX_OUT"], **res)
'''


def jax_tp_runs(runs, weights):
    """The JAX ``Trainer`` on 8 fake devices for each of ``runs`` in order
    (a list of {name, arch, sizes, cfg: TrainerConfig fields beside
    ``TRAIN``, and optionally train: fields of ``TRAIN`` to override,
    restore: start from the newest checkpoint of ``cfg["ckpt_dir"]``
    rather than ``weights[arch]``, copy_to: a dir the checkpoint dir is
    copied to after the run}), in ``dfabric`` or ``gspmd`` mode, on the
    arch's smoke config.  Returns {name/loss, name/p/<path>,
    name/s/<section>/<key> or name/s/m|v/<path>}."""
    import json
    return run_jax_devices(TP_JAX_SCRIPT, {
        "runs": np.array(json.dumps(runs)),
        "weights": np.array(weights, dtype=object),
        "train": np.array(json.dumps(TRAIN)),
        "shape": np.array(json.dumps(TRAIN_SHAPE)),
        "loss_chunk": np.array(TRAIN_LOSS_CHUNK)})


#: the recurrent smokes' share of parameter elements a run may leave past
#: 2e-5 of the JAX run's: the port's DP-only runs of them (no model axis)
#: leave 1-2 elements of ~800k there too, at most 5.5e-5 (an element whose
#: gradient is near zero, whose AdamW step m/sqrt(v) then follows its
#: rounding, as the key biases' does); their moments to 1e-2 of each leaf's
#: range (the DP-only runs leave elements up to 8.7e-4 of it off)
RECURRENT_FAR = 1e-4


def check_tp_run(name, recs, jax_out, sizes, cfg, steps=None, state=True,
                 far_share=0.0, arch=None):
    """A port run (each rank's ``rank_tp_trainer`` record) against the JAX
    one: the loss curve (rtol 1e-4, 1e-3 with a lossy codec), the final
    parameters put together from the blocks (atol 2e-5; the key biases to
    2 x lr x steps; with a lossy codec 99% of the elements to 2e-5, every
    one to 2 x lr x steps; with ``far_share`` that share of them past
    2e-5, every one to 2 x lr x steps), with ``state`` the optimizer state
    put together (m and v to 1e-4 of their range, 1e-2 with ``far_share``,
    in 99% of the elements with a lossy codec; the EF to 1e-2 in 99%), and
    every block held alike by two members bit-equal (``assemble_blocks``);
    the state of a leaf with a zero true gradient (``zero_gradient`` for
    ``arch``) within ``NOISE`` in both packages.  Returns the global
    parameters."""
    steps = steps or TRAIN["steps"]
    int8 = lossy(cfg)
    far_ok = 1e-2 if int8 else far_share
    losses = recs[0]["losses"]
    assert len(losses) == len(jax_out[f"{name}/loss"]) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jax_out[f"{name}/loss"],
                               rtol=1e-3 if int8 else 1e-4)
    for r in recs[1:]:
        assert r["losses"] == losses
    shapes = {k[len(f"{name}/p/"):]: v.shape for k, v in jax_out.items()
              if k.startswith(f"{name}/p/")}
    params = assemble_blocks([(r["params"], r["coords"], r["specs"]) for r in recs],
                             shapes, sizes, name)
    far = total = 0
    bound = 2 * TRAIN["lr"] * steps
    for k, v in params.items():
        want = jax_out[f"{name}/p/{k}"]
        d = np.abs(v - want)
        if k.endswith("attn/bk") or far_ok:
            assert d.max() <= bound, (k, d.max())
            if far_ok:
                far += int((d > 2e-5).sum())
                total += d.size
        else:
            np.testing.assert_allclose(v, want, atol=2e-5, rtol=0, err_msg=k)
    assert far <= far_ok * total, (far, total)
    if not state:
        return params
    sshapes = {k[len(f"{name}/s/"):]: v.shape for k, v in jax_out.items()
               if k.startswith(f"{name}/s/")}
    assert set(sshapes) == set(recs[0]["state"]), (
        sorted(set(sshapes) ^ set(recs[0]["state"])))
    state = assemble_blocks([(r["state"], r["coords"], r["state_specs"])
                             for r in recs], sshapes, sizes, name) \
        if not any(k.endswith("/ef") for k in sshapes) else \
        _assemble_first(recs, sshapes, sizes)
    for k, got in state.items():
        want = jax_out[f"{name}/s/{k}"]
        # a sync-state section is named after its leaf, the GSPMD state's
        # moments carry the leaf's path
        if zero_gradient(arch, k.rsplit("/", 1)[0]) or zero_gradient(arch, k):
            assert max(np.abs(got).max(), np.abs(want).max()) <= NOISE, k
            continue
        rel = 1e-2 if k.endswith("/ef") else 1e-4
        if far_share:
            rel = 1e-2
        close = np.abs(got - want) <= rel * np.abs(want).max() + 1e-12
        if int8:
            assert close.mean() >= 0.99, (k, close.mean())
        else:
            assert close.all(), (k, np.abs(got - want).max())
    return params


def _assemble_first(recs, shapes, sizes):
    """The optimizer state put together without the bit-equality check
    (the int8 EF differs across the pod members its spec does not name:
    the first member's block is taken, as ``jax.device_get`` does)."""
    from repro_torch.models import sharding
    return {k: sharding.assemble({r["coords"]: r["state"][k] for r in recs},
                                 recs[0]["state_specs"][k], shape, sizes,
                                 lambda ps, d: np.concatenate(ps, d))
            for k, shape in shapes.items()}


def rank_gspmd_zero_opt(rank, payload):
    """Two steps of the port's GSPMD step on this rank from
    ``payload["weights"]`` (qwen3's smoke config) on the mesh
    ``payload["sizes"]``, once with the moments laid out as the
    parameters and once with ``zero_opt`` (split further by
    ``zero_moment_specs``).  Returns ({path: parameter block} of each,
    the moments' block shapes of the second)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import local_rows, make_gspmd_train_step
    from repro_torch.utils.trees import tree_paths
    mesh = prims.Mesh(payload["sizes"])
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    pipe = TokenPipeline(get_smoke_arch("qwen3-1.7b"),
                         ShapeConfig("t", TRAIN_SHAPE["seq_len"],
                                     TRAIN_SHAPE["global_batch"], "train"),
                         DataConfig(seed=TRAIN["seed"]))
    out = []
    for zero_opt in (False, True):
        model = build_model(get_smoke_arch("qwen3-1.7b"), st, device="cpu")
        load_jax_params(model, payload["weights"])
        step_fn, init_opt, mspecs = make_gspmd_train_step(
            model, mesh, AdamWConfig(), cosine_schedule(TRAIN["lr"], 1, 4),
            zero_opt=zero_opt)
        model.requires_grad_(True)
        params, opt = model.params(), init_opt()
        for step in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in local_rows(pipe.batch_at(step), mesh).items()}
            params, opt, _ = step_fn(params, opt, batch, step)
        out.append({k: v.detach().numpy().copy()
                    for k, v in tree_paths(params).items()})
    return out[0], out[1], {k: tuple(v.shape)
                            for k, v in tree_paths(opt["m"]).items()}


# ---------------------------------------------------------------------------
# sequence parallelism, the context-parallel step and MoE dispatch groups
# (test_torch_seq_parallel.py)
# ---------------------------------------------------------------------------

#: the context-parallel step's steps, and its schedule's (both packages)
CP_STEPS = 2


def rank_seq_parallel(rank, payload):
    """Each case of ``payload["cases"]`` on this rank, in order, by its
    ``kind``: "grads" (:func:`tp_grads`), "trainer" (one run of
    :func:`rank_tp_trainer`), "cp" (:func:`cp_steps`) or "prefill"
    (:func:`sp_prefill`); ``payload["weights"]``: {arch: flat JAX tree}."""
    out = []
    for case in payload["cases"]:
        kind = case["kind"]
        if kind == "grads":
            out.append(tp_grads(rank, case))
        elif kind == "trainer":
            out.append(rank_tp_trainer(rank, dict(weights=payload["weights"],
                                                  runs=[case]))[0])
        elif kind == "cp":
            out.append(cp_steps(rank, case, payload["weights"][case["arch"]]))
        else:
            out.append(sp_prefill(rank, case, payload["weights"][case["arch"]]))
    return out


def _sp_model(case, weights, **settings):
    """``case["arch"]``'s smoke model (experts included) in fp32 with
    ``case["settings"]`` and ``settings``, from ``weights``."""
    from repro_torch.configs import get_smoke_arch
    st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                       max_seq=MAX_SEQ, **settings, **case.get("settings", {}))
    model = build_model(get_smoke_arch(case["arch"]), st, device="cpu")
    load_jax_params(model, weights)
    return model


def cp_steps(rank, case, weights):
    """``CP_STEPS`` steps of the context-parallel cell's step on this rank:
    ``make_gspmd_train_step(mi=...)`` with the blocks whole on every model
    member (``tp_scope="embed_only"``), no FSDP, the moments split by
    ``zero_moment_specs`` (``zero_opt``), on the mesh ``case["sizes"]``,
    each step on this member's rows of the data pipeline's global batch.
    Returns a record as :func:`rank_tp_trainer`'s."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prims
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.runtime.train_loop import (local_rows, make_gspmd_train_step,
                                                mesh_info)
    from repro_torch.utils.trees import tree_paths
    sizes = case["sizes"]
    mesh = prims.Mesh(sizes)
    model = _sp_model(case, weights, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    mi = mesh_info(sizes)
    mi.tp_scope = "embed_only"
    step_fn, init_opt, mspecs = make_gspmd_train_step(
        model, mesh, AdamWConfig(),
        cosine_schedule(TRAIN["lr"], TRAIN["warmup"], CP_STEPS),
        fsdp=False, mi=mi, zero_opt=True)
    model.requires_grad_(True)
    params, opt = model.params(), init_opt()
    pipe = TokenPipeline(model.arch, ShapeConfig("t", TRAIN_SHAPE["seq_len"],
                                                 TRAIN_SHAPE["global_batch"], "train"),
                         DataConfig(seed=TRAIN["seed"]))
    losses = []
    for step in range(CP_STEPS):
        batch = {k: torch.from_numpy(v)
                 for k, v in local_rows(pipe.batch_at(step), mesh).items()}
        params, opt, metrics = step_fn(params, opt, batch, step)
        losses.append(float(metrics["loss"]))
    return dict(
        losses=losses,
        params={k: v.detach().numpy().copy() for k, v in tree_paths(params).items()},
        state={f"{key}/{k}": t.numpy().copy() for key in ("m", "v")
               for k, t in tree_paths(opt[key]).items()},
        coords=tuple(sorted(mesh.coords.items())), specs=dict(model.layout.specs),
        state_specs={f"{key}/{k}": sp for key in ("m", "v")
                     for k, sp in mspecs.items()})


def sp_prefill(rank, case, weights):
    """``Model.prefill`` on this rank of the mesh ``case["sizes"]``, the
    model cut by ``mesh_info`` (TP over model) with ``case["settings"]``,
    on this member's rows of ``case["tokens"]``.  Returns (the logits, the
    cache's blocks {path: array}, the coords)."""
    from repro_torch.core import prims
    from repro_torch.runtime.train_loop import dp_rank, mesh_info
    from repro_torch.utils.trees import tree_paths
    sizes = case["sizes"]
    mesh = prims.Mesh(sizes)
    model = _sp_model(case, weights, remat="none")
    model.shard(mesh_info(sizes), sizes, mesh.coords)
    tokens = case["tokens"]
    b = tokens.shape[0] // model.layout.dp_total
    rows = torch.from_numpy(tokens[dp_rank(mesh) * b:(dp_rank(mesh) + 1) * b])
    with prims.bind(mesh):
        logits, cache = model.prefill(rows, batch=tokens.shape[0])
    return (logits.numpy().copy(),
            {k: v.numpy().copy() for k, v in tree_paths(cache).items()},
            tuple(sorted(mesh.coords.items())))


# ---------------------------------------------------------------------------
# serving over a mesh (test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------


def _pad_seq(cache: dict, max_seq: int) -> dict:
    """Every attention cache leaf ('k', 'v') of a prefill cache padded with
    zero rows to ``max_seq`` positions (dim 2), for decode to go on from it;
    the cross cache and the states as they are."""
    out = {}
    for path, t in cache.items():
        if path.split("/")[-1] in ("k", "v"):
            pad = np.zeros(t.shape[:2] + (max_seq - t.shape[2],) + t.shape[3:], t.dtype)
            t = np.concatenate([t, pad], axis=2)
        out[path] = t
    return out


def rank_serve_mesh(rank, payload):
    """The port's serving on this rank's member of the mesh
    ``payload["sizes"]``, for each of ``payload["cases"]`` (a dict each:
    ``arch`` (its registered smoke config), ``fsdp``, ``settings`` beside
    fp32, and either ``tokens`` (B, S) of a prefill, with ``frames`` for an
    encoder-decoder, then optionally ``decode`` (B, n) tokens decoded from
    that cache padded to ``max_seq``; or ``zero``: (B, n) tokens decoded
    from ``init_cache(B, max_seq, n_frames)`` at ``start``, its cross cache
    set to the global leaves ``xcache`` where given), and each of
    ``payload["servers"]`` (a ``DecodeServer`` over the mesh: ``arch``,
    ``slots``, ``max_seq``, ``prompts``, ``max_new``, ``max_steps``).  The
    model is cut by ``mesh_info(sizes, fsdp=...)`` and loaded from
    ``payload["weights"][arch]``; every input is this member's rows (the
    JAX ``_dp_spec``).  Returns {coords, cases: {name: {logits, cache,
    decode: [logits a step], final}}, servers: {name: (outputs, stats)}},
    the caches as {path: this member's block}."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import prims
    from repro_torch.launch.cells import _dp_spec
    from repro_torch.models import sharding
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    from repro_torch.runtime.train_loop import mesh_info
    from repro_torch.utils.trees import tree_from_paths, tree_paths
    sizes = payload["sizes"]
    mesh = prims.Mesh(sizes)
    coords = mesh.coords

    def built(arch, fsdp=False, **settings):
        st = ModelSettings(param_dtype="float32", compute_dtype="float32",
                           max_seq=MAX_SEQ, **settings)
        model = build_model(get_smoke_arch(arch), st, device="cpu")
        model.shard(mesh_info(sizes, fsdp=fsdp), sizes, coords)
        load_jax_params(model, payload["weights"][arch])
        return model

    def rows(x, B):
        mi = mesh_info(sizes)
        return torch.from_numpy(np.ascontiguousarray(
            sharding.local_block(x, _dp_spec(mi, x.ndim, B), coords, sizes)))

    def blocks(cache):
        return {k: v.numpy().copy() for k, v in tree_paths(cache).items()}

    out = {"coords": dict(coords), "cases": {}, "servers": {}}
    with prims.bind(mesh):
        for case in payload.get("cases", ()):
            model = built(case["arch"], case.get("fsdp", False),
                          **case.get("settings", {}))
            rec = {}
            if "tokens" in case:
                toks = case["tokens"]
                B, S = toks.shape
                frames = (rows(case["frames"], B) if "frames" in case else None)
                logits, cache = model.prefill(rows(toks, B).long(), frames, batch=B)
                rec.update(logits=logits.numpy().copy(), cache=blocks(cache))
                start, steps = S, case.get("decode")
                if steps is not None:
                    cache = tree_from_paths({
                        k: torch.from_numpy(v) for k, v in
                        _pad_seq(blocks(cache), case["max_seq"]).items()})
            else:
                steps, start = case["zero"], case["start"]
                B = steps.shape[0]
                cache = model.init_cache(B, case["max_seq"], case.get("n_frames"))
                specs = tree_paths(model.cache_specs(
                    mesh_info(sizes, fsdp=case.get("fsdp", False)), B,
                    case["max_seq"], case.get("n_frames")))
                flat = tree_paths(cache)
                for path, x in case.get("xcache", {}).items():
                    flat[path].copy_(torch.from_numpy(np.ascontiguousarray(
                        sharding.local_block(x, specs[path], coords, sizes))))
            if steps is not None:
                rec["decode"] = []
                for t in range(steps.shape[1]):
                    logits, cache = model.decode_step(
                        cache, rows(steps[:, t:t + 1], B).long(), start + t,
                        batch=B, max_seq=case["max_seq"], n_frames=case.get("n_frames"))
                    rec["decode"].append(logits.numpy().copy())
                rec["final"] = blocks(cache)
            out["cases"][case["name"]] = rec
    for srv in payload.get("servers", ()):
        model = built(srv["arch"])
        server = DecodeServer(model, mesh, batch_slots=srv["slots"],
                              max_seq=srv["max_seq"])
        for i, prompt in enumerate(srv["prompts"]):
            server.submit(Request(uid=i, prompt=prompt, max_new=srv["max_new"]))
        outs = server.run(max_steps=srv["max_steps"])
        stats = {k: v for k, v in server.stats.items() if k != "wall"}
        out["servers"][srv["name"]] = (outs, stats,
                                       [len(r.token_s) for r in server.all_requests])
    if payload.get("cell"):
        out["cell"] = _serve_cell(mesh, payload["cell"])
    return out


def _serve_cell(mesh, cell_case):
    """``Cell.bind`` of a serving cell on this member's mesh (of the cell's
    sizes), the cell's arch cut to ``layers`` (an encoder-decoder's
    encoder too), bf16 on the CPU: one decode step at pos 0 from
    ``init(batch, max_seq)``.  Returns (logits, rows, its cache's leaf
    shapes)."""
    import dataclasses
    from repro_torch.launch.cells import build_cell
    from repro_torch.runtime.train_loop import dp_rank
    from repro_torch.utils.trees import tree_paths
    cell = build_cell(cell_case["arch"], cell_case["shape"], mesh.sizes)
    cut = cell.arch.replace(n_layers=cell_case["layers"])
    if cut.is_encdec:
        cut = cut.replace(encoder=dataclasses.replace(
            cut.encoder, n_layers=cell_case["layers"]))
    cell = dataclasses.replace(cell, arch=cut)
    bound = cell.bind(mesh, device="cpu", seed=0)
    B = cell.shape.global_batch
    cache = bound.init(B, cell_case["max_seq"])
    n = B // math.prod(mesh.size(a) for a in mesh.sizes if a != "model")
    r = dp_rank(mesh)
    toks = torch.arange(r * n, (r + 1) * n).reshape(n, 1) % cut.vocab
    logits, cache = bound.run(cache, toks, 0)
    return (logits.float().numpy().copy(), n,
            {k: tuple(v.shape) for k, v in tree_paths(cache).items()})


# ---------------------------------------------------------------------------
# the sequence split of every family, whisper under the GSPMD step, planned
# MoE dispatch over split experts (test_torch_seq_parallel_families.py)
# ---------------------------------------------------------------------------


def rank_moe_schedule(rank, payload):
    """For each case of ``payload["cases"]`` (``arch``'s smoke MoE layer
    from the numpy leaves ``p``, the global input ``x`` (B, S, d),
    ``groups``, ``schedule``: a port schedule, on the mesh ``sizes``):
    ``apply_moe`` on this member, with its ``E / n`` experts where
    ``split`` (over model) and on its rows of ``x`` under ``token_axes``
    (the DP axes, the GSPMD step's routing), once without the schedule
    and once with it.  Returns one record a case: (the two outputs, the
    two aux losses, the coords), or the error's text where the scheduled
    call raised ``ValueError``."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import prims
    from repro_torch.models import layers as L
    from repro_torch.runtime.train_loop import dp_axes_of, local_rows
    out = []
    for case in payload["cases"]:
        sizes = case["sizes"]
        mesh = prims.Mesh(sizes)
        arch = get_smoke_arch(case["arch"])
        p = {k: torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()}
             for k, v in case["p"].items()}
        spec = None
        if case["split"]:
            n, r = sizes["model"], mesh.rank("model")
            El = arch.moe.num_experts // n
            for k in ("we_in", "we_gate", "we_out"):
                p[k] = p[k][r * El:(r + 1) * El]
            spec = (None, "model")
        token_axes = dp_axes_of(sizes) if case["token_axes"] else ()
        x = case["x"]
        if token_axes:
            x = local_rows({"x": x}, mesh)["x"]
        x = torch.from_numpy(x)
        with prims.bind(mesh):
            kw = dict(groups=case["groups"], dispatch_spec=spec,
                      token_axes=token_axes)
            y0, a0 = L.apply_moe(arch, p, x, **kw)
            try:
                y1, a1 = L.apply_moe(arch, p, x, dispatch_schedule=case["schedule"],
                                     **kw)
            except ValueError as e:
                out.append(str(e))
                continue
        out.append((y0.numpy().copy(), y1.numpy().copy(), a0.numpy().copy(),
                    a1.numpy().copy(), tuple(sorted(mesh.coords.items()))))
    return out


# ---------------------------------------------------------------------------
# the examples' PyTorch twins (test_torch_examples.py)
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
#: the smokes ``examples/serve_decode_torch.py`` is held to its original on
SERVE_ARCHS = (ARCH, RWKV, JAMBA, WHISPER)
#: quickstart's steps held to the JAX ``Trainer``'s
QUICKSTART_STEPS = 6


def _run_main(mod, argv):
    """(``mod.main(argv)``'s return, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    return out, buf.getvalue()


def rank_examples(rank, payload):
    """The twins in this process, which no group joins (each ``main``
    starts and ends a world of its own): quickstart's first
    ``QUICKSTART_STEPS`` steps from ``payload["quickstart"]`` (JAX's
    weights), ddp_train's parameter count and step-0 loss from
    ``payload["ddp"]``, serve_decode's server at temperature 0 on each of
    ``SERVE_ARCHS`` from ``payload["serve"][arch]``, then each ``main`` on
    the CPU: quickstart's 60 steps, elastic_restart, ddp_train
    ``--steps 2`` (checkpoints under ``payload["tmp"]``) and serve_decode
    twice an arch.  Returns the records the tests read."""
    import dataclasses
    import importlib
    import sys
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import one_process_mesh
    from repro_torch.models import count_params
    from repro_torch.runtime.train_loop import Trainer
    torch.set_num_threads(payload.get("threads", 2))
    sys.path.insert(0, EXAMPLES)
    qs, ddp, er, sd = (importlib.import_module(f"{n}_torch") for n in
                       ("quickstart", "ddp_train", "elastic_restart", "serve_decode"))
    out = {}

    model, cfg = qs.build("cpu")
    load_jax_params(model, payload["quickstart"])
    with one_process_mesh((1, 1, 1), ("pod", "data", "model"), "cpu") as mesh:
        res = Trainer(model, mesh, qs.Shape(), dataclasses.replace(
            cfg, steps=QUICKSTART_STEPS, log_every=0)).train()
    out["quickstart_losses"] = [m["loss"] for m in res["metrics"]]

    model = ddp.build("cpu")
    load_jax_params(model, payload["ddp"])
    batch = TokenPipeline(model.arch, ddp.Shape(), DataConfig(seed=0)).batch_at(0)
    with torch.no_grad():
        loss = model.loss(model.params(), {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    out["ddp"] = dict(count=count_params(model), loss0=loss.item(), batch=batch)
    del model

    out["greedy"] = {}
    for name in SERVE_ARCHS:
        arch, model = sd.build(name, "cpu")
        load_jax_params(model, payload["serve"][name])
        _, outs = sd.serve(arch, model, "cpu", 12, 24, None, temperature=0.0)
        out["greedy"][name] = outs

    res, out["quickstart_text"] = _run_main(qs, ["--device", "cpu"])
    out["quickstart_main"] = [m["loss"] for m in res["metrics"]]
    (ref, restarted, restored), out["elastic_text"] = _run_main(er, ["--device", "cpu"])
    out["elastic"] = dict(ref=[m["loss"] for m in ref["metrics"]],
                          restarted=[(m["step"], m["loss"]) for m in restarted["metrics"]],
                          restored_step=restored[2])
    (trainer, res), out["ddp_text"] = _run_main(ddp, [
        "--device", "cpu", "--steps", "2", "--ckpt-dir", os.path.join(payload["tmp"], "ddp")])
    out["ddp_main"] = dict(step=res["step"], losses=[m["loss"] for m in res["metrics"]])
    out["serve_main"] = {}
    for name in SERVE_ARCHS:
        runs = [_run_main(sd, ["--device", "cpu", "--arch", name]) for _ in range(2)]
        out["serve_main"][name] = [(outs, text) for (_, outs), text in runs]
    return out


# ---------------------------------------------------------------------------
# RWKV6's time mix over whole heads (test_torch_rwkv_split_heads.py)
# ---------------------------------------------------------------------------


def rank_split_heads(rank, payload):
    """:func:`rank_seq_parallel` on ``payload["train"]`` (its payload),
    then :func:`rank_serve_mesh` on ``payload["serve"]``, in one world."""
    return (rank_seq_parallel(rank, payload["train"]),
            rank_serve_mesh(rank, payload["serve"]))
