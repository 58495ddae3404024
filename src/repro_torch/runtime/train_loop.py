"""Training runtime — the port of ``repro.runtime.train_loop``: the
DFabric explicit-DP step, the GSPMD (FSDP x TP) step, the ``Trainer``
(train loop, checkpoint/restart, preemption, failure injection, metrics)
and the straggler watchdog.

One process is one member of the mesh (pod [, host], data, model), with
axis names resolved against the bound
:class:`~repro_torch.core.prims.Mesh`.  The model keeps this member's
block of every leaf (``Model.shard``) and runs with the collectives
GSPMD puts in for the JAX package (``models.transformer``).

  * ``dfabric`` — each member runs the forward and backward on its rows
    of the global batch (the model members of a DP member on the same
    rows), then the gradient sync and the (ZeRO-1) AdamW update through
    the paper's hierarchical striped collectives (``optim.grad_sync``):
    each model member syncs its own blocks over its DP groups.
  * ``gspmd`` — FSDP over ``data`` and TP over ``model``, the batch over
    the DP axes: each layer's FSDP blocks are gathered on use and their
    gradients reduce-scattered back, the other DP axes' gradients summed,
    and AdamW runs on the local blocks, its moments laid out as the
    parameters (or, with ``zero_opt``, by :func:`zero_moment_specs`).

Checkpoints are the reference's format (``checkpoint.manager``): the
parameters and the optimizer state as the JAX package's *global* arrays,
and the data pipeline's state.  Member 0 writes them: the other members'
blocks are gathered to it on the main thread (the writer thread runs no
collective), and every member restores by cutting its own block of the
global arrays under the current mesh's specs — so a job may restart on
another mesh (elastic restart).  A DFabric sync state whose sections
differ from the current plan's (another model axis or fast tier packs
other buckets) is re-cut leaf by leaf (``grad_sync.resection_state``).

Every decoder family trains under both steps, with or without a model
axis, and the encoder-decoder (whisper) under the DFabric step, its
frames cut by DP member as the tokens are; MoE dispatch groups
(``moe_groups`` > 1) under both.  The dense decoders train with their
residual stream's sequence split over the model axis
(``ModelSettings.seq_axis``) in both steps, and in the GSPMD step with
their blocks whole on every model member (the context-parallel cell:
``make_gspmd_train_step(mi=...)`` with ``tp_scope="embed_only"``).  Not
ported yet (it raises, naming ROADMAP.md): the encoder-decoder under the
GSPMD step.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, owned_host_array
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import prims
from repro_torch.core.planner import Planner, SyncPlan
from repro_torch.core.topology import topology_from_mesh_sizes
from repro_torch.convert import load_jax_params
from repro_torch.models.registry import Model
from repro_torch.models.sharding import (MeshInfo, assemble, local_block,
                                         local_shape, spec_axes)
from repro_torch.models.transformer import check_trainable
from repro_torch.obs.metrics import MetricsLogger
from repro_torch.optim import grad_sync
from repro_torch.optim.adamw import (AdamWConfig, adamw_leaf,
                                     clip_coefficient, cosine_schedule,
                                     global_norm)
from repro_torch.optim.grad_sync import SyncSettings, sync_and_update
from repro_torch.utils.trees import tree_from_paths, tree_paths


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------


#: DP mesh axes, slowest tier first (the order batch rows are laid out in);
#: "host" is the optional mid tier of a 3-tier fabric (rack-level CXL).
DP_MESH_AXES = ("pod", "host", "data")


def dp_axes_of(sizes) -> Tuple[str, ...]:
    return tuple(a for a in DP_MESH_AXES if a in sizes)


def fast_axes_of(sizes) -> Tuple[str, ...]:
    """Fast-tier DP axes ordered FASTEST first (the reduce-scatter order);
    the slowest tier ("pod") is excluded."""
    return tuple(a for a in ("data", "host") if a in sizes)


def mesh_info(sizes: Dict[str, int], *, fsdp: bool = False,
              embed_tp: bool = True) -> MeshInfo:
    """The rule inputs of a mesh: TP over ``model``, FSDP over ``data``
    when ``fsdp`` (the GSPMD step), ``embed_tp`` as the JAX package's
    modern stack sets it (vocab-sharded tables)."""
    return MeshInfo(sizes, tp_axis="model" if "model" in sizes else None,
                    fsdp_axis="data" if fsdp else None,
                    dp_axes=dp_axes_of(sizes), embed_tp=embed_tp)


def dp_rank(mesh: prims.Mesh) -> int:
    """This member's flat index over the DP axes, slowest-axis-major (the
    row order of the global batch)."""
    r = 0
    for a in dp_axes_of(mesh.sizes):
        r = r * mesh.size(a) + mesh.rank(a)
    return r


def local_rows(batch: Dict[str, np.ndarray], mesh: prims.Mesh,
               microbatches: int = 1) -> Dict[str, np.ndarray]:
    """This member's rows of a global batch (every entry: the tokens, the
    labels and an encoder-decoder's frames): a contiguous block of them,
    or with ``microbatches`` > 1 its block of each of the global batch's
    ``microbatches`` contiguous slices, one after the other.  The GSPMD
    step takes the latter: the JAX step's microbatch *i* is the global
    rows ``[i B/mb, (i+1) B/mb)``, so the members' *i*-th local slices,
    member-major, are those rows in their order (a MoE layer routes them
    as one group)."""
    n_dp = int(np.prod([mesh.size(a) for a in dp_axes_of(mesh.sizes)]))
    r = dp_rank(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n_dp * microbatches):
            raise ValueError(f"batch {v.shape[0]} does not split over the "
                             f"{n_dp} DP members x {microbatches} microbatches")
        lb = v.shape[0] // (n_dp * microbatches)
        mb = v.reshape((microbatches, n_dp, lb) + v.shape[1:])[:, r]
        out[k] = mb.reshape((microbatches * lb,) + v.shape[1:])
    return out


# ---------------------------------------------------------------------------
# DFabric explicit-DP step
# ---------------------------------------------------------------------------


def make_sync_plan(model: Model, sizes: Dict[str, int], topo, *,
                   codec: Optional[str] = None, strategy: str = "auto",
                   bucket_bytes: int = 4 << 20,
                   embed_tp: bool = True,
                   pipeline: bool = True,
                   mid_codec: Optional[str] = None
                   ) -> Tuple[SyncPlan, SyncSettings]:
    """The shared planner's plan for ``model`` on a mesh of ``sizes``
    ({axis: size}), and the sync settings — the reference's, input for
    input."""
    mi = mesh_info(sizes, embed_tp=embed_tp)
    fast_axes = fast_axes_of(sizes) or ("data",)
    fast_sizes = tuple(sizes.get(a, 1) for a in fast_axes)
    n_fast = int(np.prod(fast_sizes))
    n_slow = sizes.get("pod", 1)
    ss = SyncSettings(mode="zero1", fast_axis=fast_axes[0],
                      slow_axis="pod" if "pod" in sizes else None,
                      n_fast=n_fast, n_slow=n_slow,
                      model_axis="model" if "model" in sizes else None,
                      fast_axes=fast_axes)
    shapes = tree_paths(model.param_shapes())
    specs = tree_paths(model.param_specs(mi))
    # the planner keeps its scatter off dims the TP rules shard, even when
    # the model axis has size 1
    avoid = {p: frozenset(i for i, s in enumerate(sp) if s is not None)
             for p, sp in specs.items()}
    ntp = sizes.get("model", 1)

    def local_shape(path):
        sh = list(shapes[path].shape)
        for d, ax in enumerate(specs[path]):
            if ax is not None and d < len(sh):
                sh[d] //= ntp
        return tuple(sh)

    local = {p: local_shape(p) for p in shapes}
    planner = Planner(topo, fast_axis_sizes=fast_sizes, codec=codec,
                      strategy=strategy, pipeline=pipeline,
                      mid_codec=mid_codec)
    plan = planner.plan(shapes, bucket_bytes=bucket_bytes, avoid_dims=avoid,
                        local_shapes=local)
    return plan, ss


def make_dfabric_train_step(model: Model, mesh: prims.Mesh, plan: SyncPlan,
                            ss: SyncSettings, opt_cfg: AdamWConfig,
                            lr_fn: Callable, *, microbatches: int = 1,
                            zero1: bool = True):
    """Returns (step_fn(params, sync_state, batch, step_idx) -> (params,
    sync_state, metrics), init_sync_state_fn).

    ``batch`` holds this member's rows (tensors on the model's device);
    ``params`` is the model's parameter tree, this member's blocks,
    updated in place.  The model is cut for the mesh first
    (``Model.shard``: TP over ``model``, vocab-sharded tables).  The loss
    is averaged over the DP members (``pmean``) and the gradients over the
    microbatches, as in the JAX step."""
    check_trainable(model.arch, model.settings)
    if not zero1:
        ss = dataclasses.replace(ss, mode="paper")
    dp_axes = dp_axes_of(mesh.sizes)
    mi = mesh_info(mesh.sizes)
    model.shard(mi, mesh.sizes, mesh.coords)
    pshapes = model.param_shapes()
    pspecs = model.param_specs(mi)

    def step_fn(params, sync_state, batch, step_idx):
        with prims.bind(mesh):
            loss, grads = _accumulate(model, params, batch, microbatches)
            loss = prims.pmean(loss, dp_axes)
            lr = lr_fn(step_idx).to(loss.device)
            # the sync drops each gradient from this tree once it is synced
            grads = tree_from_paths(grads)
            params, new_state, metrics = sync_and_update(
                params, grads, sync_state, plan, ss, lr, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, new_state, metrics

    def init_state():
        with prims.bind(mesh):
            return grad_sync.init_sync_state(plan, pshapes, ss, model.device,
                                             param_specs_tree=pspecs)

    return step_fn, init_state


def _accumulate(model, params, batch, microbatches: int):
    """(loss, {path: gradient}) of ``model.loss`` on ``batch``, averaged
    over ``microbatches`` equal slices of its rows, as the JAX steps
    average them."""
    flat = tree_paths(params)
    loss = grads = None
    for i in range(microbatches):
        mb = ({k: v.chunk(microbatches)[i] for k, v in batch.items()}
              if microbatches > 1 else batch)
        l = model.loss(params, mb)
        g = dict(zip(flat, torch.autograd.grad(l, list(flat.values()))))
        if grads is None:
            loss, grads = l.detach(), g
        else:
            loss = loss + l.detach()
            grads = {k: grads[k] + g[k] for k in grads}
        del l, g
    if microbatches > 1:
        loss = loss / microbatches
        grads = {k: g / microbatches for k, g in grads.items()}
    return loss, grads


# ---------------------------------------------------------------------------
# GSPMD (FSDP) step
# ---------------------------------------------------------------------------


def zero_moment_specs(pshapes, pspecs, sizes: Dict[str, int]):
    """ZeRO-style optimizer-moment sharding for GSPMD steps: each moment is
    sharded on its largest dim divisible by a mesh axis not already used by
    the param spec (prefer 'data', then 'model').  ``pshapes`` and
    ``pspecs`` are flat {path: ShapeDtype} and {path: spec}."""
    def spec_of(shape, pspec):
        used = set(spec_axes(pspec))
        entries = list(pspec) + [None] * (len(shape) - len(pspec))
        for axis in ("data", "model"):
            if axis in used or axis not in sizes:
                continue
            n = sizes[axis]
            cands = [(d, s) for d, s in enumerate(shape)
                     if entries[d] is None and s % n == 0]
            if cands:
                d = max(cands, key=lambda ds: ds[1])[0]
                entries[d] = axis
                used.add(axis)
        return tuple(entries)

    return {k: spec_of(tuple(pshapes[k].shape), pspecs[k]) for k in pshapes}


def make_gspmd_train_step(model: Model, mesh: prims.Mesh,
                          opt_cfg: AdamWConfig, lr_fn: Callable, *,
                          fsdp: bool = True, microbatches: int = 1,
                          zero_opt: bool = False,
                          mi: Optional[MeshInfo] = None):
    """Returns (step_fn(params, opt_state, batch, step_idx) -> (params,
    opt_state, metrics), init_opt_fn, moment specs {path: spec}).

    The model is cut for FSDP over ``data`` (with ``fsdp``) and TP over
    ``model``, or by the rules of ``mi`` where given (the reference's
    argument: the context-parallel cell's ``tp_scope="embed_only"``, whose
    blocks are whole on every model member while the sequence splits over
    it, ``ModelSettings.seq_axis``); ``batch`` holds this member's rows (the DP axes
    ``pod``/``host``/``data``, slowest major).  Each member's loss is its
    rows' share of the batch mean (the token count summed over the DP
    axes), so the members' gradients add up to the global batch's: the
    FSDP blocks' by the reduce-scatter of the gather-on-use, every other
    DP axis a leaf's spec does not name by a sum.  Then AdamW with the
    global-norm clip (``global_norm`` over the blocks) updates each block
    in place; ``opt_state`` is the JAX package's ``{"m", "v", "step"}``,
    the moments laid out as the parameters or, with ``zero_opt``, split
    further by :func:`zero_moment_specs` (each member updates its part of
    its block and the parts are gathered)."""
    check_trainable(model.arch, model.settings)
    mi = mi or mesh_info(mesh.sizes, fsdp=fsdp)
    dp_axes = dp_axes_of(mesh.sizes)
    model.shard(mi, mesh.sizes, mesh.coords, loss_axes=dp_axes)
    pspecs = dict(model.layout.specs)
    pshapes = tree_paths(model.param_shapes())
    mspecs = (zero_moment_specs(pshapes, pspecs, mesh.sizes) if zero_opt
              else pspecs)
    live = [a for a in mesh.axis_names if mesh.size(a) > 1]
    # per leaf: the DP axes its gradient is summed over, and the dims the
    # moments split beyond the parameter's block (axis, dim)
    sum_axes = {k: tuple(a for a in dp_axes if a not in spec_axes(sp))
                for k, sp in pspecs.items()}
    extra = {k: [(e, d) for d, e in enumerate(mspecs[k])
                 if e is not None and e != (pspecs[k][d] if d < len(pspecs[k])
                                            else None) and e in live]
             for k in pspecs}

    def step_fn(params, opt_state, batch, step_idx):
        with prims.bind(mesh):
            loss, grads = _accumulate(model, params, batch, microbatches)
            loss = prims.psum(loss, dp_axes)
            grads = {k: prims.psum(g, sum_axes[k]) for k, g in grads.items()}
            gnorm = global_norm(grads, pspecs)
            clip = clip_coefficient(gnorm, opt_cfg)
            lr = lr_fn(step_idx).to(loss.device)
            step = opt_state["step"]
            mflat, vflat = tree_paths(opt_state["m"]), tree_paths(opt_state["v"])
            with torch.no_grad():
                for k, p in tree_paths(params).items():
                    g, p_blk = grads.pop(k), p
                    for axis, d in extra[k]:
                        n, r = prims.axis_size(axis), prims.axis_rank(axis)
                        blk = p.shape[d] // n
                        p_blk = p_blk.narrow(d, r * blk, blk)
                        g = g.narrow(d, r * blk, blk)
                    new, mflat[k], vflat[k] = adamw_leaf(
                        p_blk, g, mflat[k], vflat[k], step, lr, opt_cfg, clip,
                        inplace=True)
                    for axis, d in reversed(extra[k]):
                        new = prims.all_gather_tiled(new, axis, d)
                    p.copy_(new)
                    del g, new
        new_opt = {"m": tree_from_paths(mflat), "v": tree_from_paths(vflat),
                   "step": step + 1}
        return params, new_opt, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def init_opt():
        def zeros(k):
            shape = local_shape(pshapes[k].shape, mspecs[k], mesh.sizes)
            return torch.zeros(shape, dtype=torch.float32, device=model.device)
        return {"m": tree_from_paths({k: zeros(k) for k in pshapes}),
                "v": tree_from_paths({k: zeros(k) for k in pshapes}),
                "step": 0}

    return step_fn, init_opt, mspecs


# ---------------------------------------------------------------------------
# Straggler watchdog (EWMA z-score on step times)
# ---------------------------------------------------------------------------


@dataclass
class StragglerWatchdog:
    """Detects slow steps; on a real fleet the mitigation hook triggers
    hot-spare swap / data rebalancing — here it records the event."""

    alpha: float = 0.2
    z_threshold: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: List[Dict[str, Any]] = field(default_factory=list)
    mitigation_hook: Optional[Callable[[Dict[str, Any]], None]] = None

    def update(self, step: int, dt: float) -> Optional[Dict[str, Any]]:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EWMA
            self.mean = dt if self.n == 1 else (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return None
        std = max(self.var ** 0.5, 1e-6, 0.05 * self.mean)
        z = (dt - self.mean) / std
        event = None
        if z > self.z_threshold:
            event = {"step": step, "dt": dt, "z": z, "mean": self.mean,
                     "action": "flag-straggler (hot-spare swap on real fleet)"}
            self.events.append(event)
            if self.mitigation_hook:
                self.mitigation_hook(event)
        else:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + self.alpha * (dt - self.mean) ** 2
        return event


class SimulatedFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclass
class TrainerConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    ckpt_every: int = 0  # 0 = no checkpointing
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    mode: str = "dfabric"  # dfabric | gspmd
    zero1: bool = True
    codec: Optional[str] = None
    pipeline: bool = True  # overlap slow-leg chunks with fast all-gathers
    fail_at_step: Optional[int] = None  # failure injection (tests)
    seed: int = 0
    metrics_path: Optional[str] = None  # JSONL sink (obs.metrics)


class Trainer:
    """End-to-end training driver (one per mesh member) with
    checkpoint/restart and preemption.  ``mesh`` is this process's
    :class:`prims.Mesh`; the model's weights are the initial parameters
    (every member must build them from the same seed, or load the same
    weights).

    Faults.  Before an exception leaves :meth:`train` the member drains its
    pending checkpoint write, so a restarted job never meets a half-written
    step it could sweep (the reference's race, ROADMAP.md queue 3, item 1).
    An injected failure (``fail_at_step``) and a preemption are taken by
    every member at the same step (a preemption flag is agreed on over the
    mesh each step) and end at a barrier, so no member leaves while member
    0 still writes."""

    def __init__(self, model: Model, mesh: prims.Mesh, shape: ShapeConfig,
                 cfg: TrainerConfig, topo=None,  # TwoTierTopology | FabricSpec
                 data_pipeline=None):
        from repro_torch.data.pipeline import DataConfig, TokenPipeline

        if cfg.mode not in ("dfabric", "gspmd"):
            raise ValueError(f"unknown mode {cfg.mode!r} (dfabric | gspmd)")
        # refused before any collective or checkpoint directory
        check_trainable(model.arch, model.settings)
        self.model, self.mesh, self.shape, self.cfg = model, mesh, shape, cfg
        self.topo = topo if topo is not None else topology_from_mesh_sizes(mesh.sizes)
        self.pipeline = data_pipeline or TokenPipeline(
            model.arch, shape, DataConfig(seed=cfg.seed))
        opt_cfg = AdamWConfig()
        lr_fn = cosine_schedule(cfg.lr, cfg.warmup, cfg.steps)
        self.mi = mesh_info(mesh.sizes, fsdp=cfg.mode == "gspmd")
        if cfg.mode == "dfabric":
            self.plan, self.ss = make_sync_plan(model, mesh.sizes, self.topo,
                                                codec=cfg.codec,
                                                pipeline=cfg.pipeline)
            # the settings the sync state is laid out with (paper mode when
            # ZeRO-1 is off, as make_dfabric_train_step runs it)
            self._state_ss = (self.ss if cfg.zero1
                              else dataclasses.replace(self.ss, mode="paper"))
            self.step_fn, self._init_state = make_dfabric_train_step(
                model, mesh, self.plan, self.ss, opt_cfg, lr_fn,
                microbatches=cfg.microbatches, zero1=cfg.zero1)
        else:
            self.plan = self.ss = self._state_ss = None
            self.step_fn, self._init_state, self.moment_specs = \
                make_gspmd_train_step(model, mesh, opt_cfg, lr_fn, fsdp=True,
                                      microbatches=cfg.microbatches)
        # member 0 writes; the others only read (restore)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep,
                                       read_only=mesh.flat_rank != 0)
                     if cfg.ckpt_every and cfg.ckpt_dir else None)
        #: one record a checkpoint save: step, gather_s (the optimizer
        #: state's and the parameters' blocks to member 0), blocking_s
        #: (gather and host snapshot)
        self.ckpt_log: List[Dict[str, float]] = []
        self.restore_s: Optional[float] = None
        self.watchdog = StragglerWatchdog()
        self._preempted = False
        self.metrics_log: List[Dict[str, float]] = []
        # one member prints; every member keeps its records (and its JSONL
        # sink when cfg.metrics_path is set)
        self.metrics = MetricsLogger(path=cfg.metrics_path,
                                     echo=mesh.flat_rank == 0, run="train",
                                     mode=cfg.mode)

    # ---- preemption ------------------------------------------------------------
    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        def handler(signum, frame):
            self._preempted = True
        for s in signals:
            signal.signal(s, handler)

    def _preempted_anywhere(self) -> bool:
        """Whether any member was preempted: every member then saves and
        stops at the same step."""
        if dist.get_world_size() == 1:
            return self._preempted
        flag = torch.tensor([int(self._preempted)],
                            device=self._transport_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _transport_device(self) -> torch.device:
        """Where the trainer's own collectives put their tensors: host
        memory for gloo, the model's card for nccl."""
        return (torch.device("cpu") if self.mesh.backend == "gloo"
                else self.model.device)

    # ---- init / restore -----------------------------------------------------------
    def init_state(self):
        """(the model's parameter tree, differentiable, zero sync state,
        step 0)."""
        self.model.requires_grad_(True)
        return self.model.params(), self._init_state(), 0

    def try_restore(self):
        """(params, this member's optimizer state, step) from the newest
        checkpoint, or None.  The parameters are copied into the model in
        place (they stay its leaves; a model that holds blocks takes its
        own); the optimizer state is this member's block of each global
        array under the current mesh's specs.  The arrays are read through
        a memory map, so a member reads its blocks only."""
        if self.ckpt is None:
            return None
        t0 = time.perf_counter()
        out = self.ckpt.restore(mmap=True)
        if out is None:
            return None
        step = int(out["data_state"]["step"])
        opt = (self._local_sync_state(out["opt"]) if self.plan is not None
               else self._local_moments(out["opt"]))
        # checks every path, shape and dtype against the model first
        load_jax_params(self.model, tree_paths(out["params"]))
        self.model.requires_grad_(True)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        self.restore_s = time.perf_counter() - t0
        self.metrics.info(f"restored step {step} from {self.cfg.ckpt_dir}")
        return self.model.params(), opt, step

    def _block_to_device(self, g, spec) -> torch.Tensor:
        blk = local_block(g, spec, self.mesh.coords, self.mesh.sizes)
        # a copy: the block may be a view of a read-only memory map
        return torch.from_numpy(np.array(blk)).to(self.model.device)

    def local_batch(self, step: int) -> Dict[str, np.ndarray]:
        """This member's rows of the global batch of ``step`` (host
        arrays), laid out for the step function: the GSPMD step's by
        global microbatch (:func:`local_rows`)."""
        return local_rows(self.pipeline.batch_at(step), self.mesh,
                          self.cfg.microbatches if self.cfg.mode == "gspmd" else 1)

    def state_specs(self) -> Dict[str, Any]:
        """The specs of the DFabric sync state's global arrays on this
        mesh (the DP scatter merged with the parameters' TP specs)."""
        return grad_sync.merged_state_specs(
            self.plan, self.model.param_shapes(),
            self.model.param_specs(self.mi), self._state_ss)

    def _local_sync_state(self, saved: Dict[str, Any]) -> Dict[str, Any]:
        """This member's blocks of a checkpoint's global sync state.  A
        checkpoint whose sections differ from this mesh's plan is re-cut
        leaf by leaf (``grad_sync.resection_state``); one whose leaves,
        entries or shapes differ raises ``ValueError``, as the JAX restore
        fails on it (a pytree or sharding mismatch)."""
        pshapes = self.model.param_shapes()
        specs = self.state_specs()
        shapes = grad_sync.state_shapes(self.plan, pshapes, self._state_ss)
        sections = saved["sections"]
        if set(sections) != set(specs["sections"]):
            sections = grad_sync.resection_state(
                sections, self.plan, pshapes, self._state_ss)
        state: Dict[str, Any] = {"step": int(saved["step"]), "sections": {}}
        for name, entry_specs in specs["sections"].items():
            entry = sections[name]
            if set(entry) != set(entry_specs):
                raise ValueError(f"{name}: the checkpoint holds {sorted(entry)}, "
                                 f"the plan {sorted(entry_specs)}")
            state["sections"][name] = {}
            for k, spec in entry_specs.items():
                g = entry[k]
                if tuple(g.shape) != shapes[name] or g.dtype != np.float32:
                    raise ValueError(
                        f"{name}/{k}: the checkpoint holds {g.dtype} "
                        f"{tuple(g.shape)}; the plan on mesh "
                        f"{self.mesh.sizes} wants float32 {shapes[name]}")
                state["sections"][name][k] = self._block_to_device(g, spec)
        return state

    def _local_moments(self, saved: Dict[str, Any]) -> Dict[str, Any]:
        """This member's blocks of a GSPMD checkpoint's ``{"m", "v",
        "step"}`` (the moments' global arrays, one a leaf)."""
        pshapes = tree_paths(self.model.param_shapes())
        out: Dict[str, Any] = {"step": int(saved["step"])}
        for key in ("m", "v"):
            flat = tree_paths(saved[key])
            if set(flat) != set(pshapes):
                raise ValueError(f"the checkpoint's {key} has leaves "
                                 f"{sorted(set(flat) ^ set(pshapes))} that the "
                                 f"model has not, or lacks them")
            blocks = {}
            for k, g in flat.items():
                if tuple(g.shape) != tuple(pshapes[k].shape) or g.dtype != np.float32:
                    raise ValueError(f"{key}/{k}: the checkpoint holds {g.dtype} "
                                     f"{tuple(g.shape)}, the model wants float32 "
                                     f"{tuple(pshapes[k].shape)}")
                blocks[k] = self._block_to_device(g, self.moment_specs[k])
            out[key] = tree_from_paths(blocks)
        return out

    # ---- save ------------------------------------------------------------------------
    def _to_writer(self, blk: torch.Tensor, spec, shape) -> Any:
        """The global array of a leaf each member holds a block of under
        ``spec``, on member 0 (None on the others; collective).  A block
        that is the whole array is member 0's own, which is what the JAX
        package's ``device_get`` saves (for the int8 EF, pod 0's
        residual)."""
        sizes = self.mesh.sizes
        writer = self.mesh.flat_rank == 0
        if local_shape(shape, spec, sizes) == tuple(shape):
            return blk if writer else None
        world = dist.get_world_size()
        src = blk.detach().to(self._transport_device()).contiguous()
        parts = [torch.empty_like(src) for _ in range(world)] if writer else None
        dist.gather(src, parts, dst=0)
        if not writer:
            return None
        blocks = {tuple(sorted(self.mesh.coords_of(r).items())): parts[r].cpu()
                  for r in range(world)}
        # a new array, so the checkpoint keeps it with no second copy
        return owned_host_array(assemble(blocks, spec, shape, sizes,
                                         lambda ps, d: torch.cat(ps, d)))

    def _global_params(self, params) -> Optional[Dict[str, Any]]:
        """The parameters as global arrays on member 0 (None on the
        others)."""
        shapes = tree_paths(self.model.param_shapes())
        specs = self.model.layout.specs
        out = {k: self._to_writer(p, specs[k], shapes[k].shape)
               for k, p in tree_paths(params).items()}
        return tree_from_paths(out) if self.mesh.flat_rank == 0 else None

    def _global_sync_state(self, opt) -> Optional[Dict[str, Any]]:
        """The optimizer state as the JAX package's global arrays, on
        member 0 (None on the others): the DFabric sync state's sections,
        or the GSPMD ``{"m", "v", "step"}``."""
        writer = self.mesh.flat_rank == 0
        out = {"step": np.asarray(opt["step"], dtype=np.int32)}
        if self.plan is None:
            shapes = tree_paths(self.model.param_shapes())
            for key in ("m", "v"):
                flat = {k: self._to_writer(t, self.moment_specs[k],
                                           shapes[k].shape)
                        for k, t in tree_paths(opt[key]).items()}
                out[key] = tree_from_paths(flat) if writer else None
            return out if writer else None
        specs = self.state_specs()
        shapes = grad_sync.state_shapes(self.plan, self.model.param_shapes(),
                                        self._state_ss)
        out["sections"] = {
            name: {k: self._to_writer(opt["sections"][name][k], spec,
                                      shapes[name])
                   for k, spec in entry_specs.items()}
            for name, entry_specs in specs["sections"].items()}
        return out if writer else None

    def _save(self, step: int, params, opt, blocking: bool = False) -> None:
        """A checkpoint of ``step``, on every member (the gathers are
        collective); member 0 writes it."""
        t0 = time.perf_counter()
        opt_global = self._global_sync_state(opt)
        params_global = self._global_params(params)
        gather_s = time.perf_counter() - t0
        if not self.ckpt.read_only:
            self.ckpt.save(step, {"params": params_global, "opt": opt_global,
                                  "data_state": self.pipeline.state_dict(step)},
                           blocking=blocking)
        self.ckpt_log.append({"step": step, "gather_s": gather_s,
                              "blocking_s": time.perf_counter() - t0})

    def _settle(self, barrier: bool) -> None:
        """Drain the pending write; with ``barrier``, meet every member
        after it, so none leaves while member 0 still writes."""
        if self.ckpt is None:
            return
        self.ckpt.wait()
        if barrier and dist.get_world_size() > 1:
            dist.barrier()

    # ---- the loop -------------------------------------------------------------------
    def train(self, params=None, opt=None, start_step: int = 0,
              on_step: Optional[Callable] = None) -> Dict[str, Any]:
        """Train to ``cfg.steps``, from the newest checkpoint when there is
        one and no ``params`` are given.  ``on_step(step, params, opt,
        metrics)``, when given, runs after each step."""
        if params is None:
            params, opt, start_step = self.try_restore() or self.init_state()
        dev = self.model.device
        step = start_step
        try:
            while step < self.cfg.steps:
                t0 = time.perf_counter()
                host_batch = self.local_batch(step)
                batch = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                         for k, v in host_batch.items()}
                params, opt, metrics = self.step_fn(params, opt, batch, step)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.watchdog.update(step, dt)
                metrics.update(step=step, dt=dt)
                self.metrics_log.append(metrics)
                self.metrics.log("train_step", **metrics)
                self.metrics.inc("steps")
                self.metrics.gauge("loss", metrics["loss"])
                if self.cfg.log_every and step % self.cfg.log_every == 0:
                    self.metrics.info(
                        f"step {step:5d} loss {metrics['loss']:.4f} "
                        f"gnorm {metrics['grad_norm']:.3f} dt {dt*1e3:.1f}ms")
                if on_step is not None:
                    on_step(step, params, opt, metrics)
                step += 1
                if self.ckpt and step % self.cfg.ckpt_every == 0:
                    self._save(step, params, opt)
                if self.cfg.fail_at_step is not None and step >= self.cfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at step {step}")
                if self._preempted_anywhere():
                    if self.ckpt:
                        self._save(step, params, opt, blocking=True)
                    break
        except BaseException as exc:
            # every member takes an injected failure at the same step, so
            # they may meet; another error may be this member's alone
            try:
                self._settle(barrier=isinstance(exc, SimulatedFailure))
            except Exception as err:
                raise err from exc
            raise
        finally:
            # emit the final 'summary' record and release the JSONL handle
            self.metrics.close()
        self._settle(barrier=True)
        return {"params": params, "opt": opt, "step": step,
                "metrics": self.metrics_log,
                "straggler_events": self.watchdog.events}
