"""Per-(arch x shape) cells: settings, step kind and the stand-ins of every
input of the cell's step — the port of ``repro.launch.cells``.

A cell is one architecture at one input shape (``configs.SHAPES``) on one
mesh, given as {axis: size} (``launch.mesh.make_production_mesh``).  Nothing
is allocated and no collective is issued: the model is built on the meta
device, and every input of the step is a :class:`StandIn` (global shape,
numpy dtype name, spec), the twin of the reference's
``jax.ShapeDtypeStruct`` with a ``NamedSharding``.  ``Cell.bind`` builds
the model for real on a device and hands it to the step the cell chose;
given the bound mesh of one member, of the cell's sizes, it cuts the model
for that member (a serving cell too: its prefill and decode then take the
member's rows and cache blocks).

The reference's flags: ``seq_shard`` splits the residual stream's
sequence over the model axis (``ModelSettings.seq_axis``) in the DFabric
and GSPMD training steps and in prefill, with ``batch_axes`` the DP axes
where the batch is global (the GSPMD step, serving); ``context_parallel``
builds the context-parallel training cell (step kind ``gspmd_cp``): the
blocks whole on every model member (``tp_scope="embed_only"``), the
sequence split over it, the fp32 moments split further by
``train_loop.zero_moment_specs``, the GSPMD step without FSDP;
``moe_groups`` > 1 gives the MoE layers dispatch groups, under the GSPMD
step over the global batch (``layers.apply_moe``).  Every family takes
the sequence split: dense, MoE, RWKV6, hybrid and encoder-decoder layers.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig, get_arch,
                                      shape_applicable)
from repro_torch.core import prims
from repro_torch.core.cost_model import dtype_itemsize
from repro_torch.core.planner import SyncPlan
from repro_torch.core.topology import topology_from_mesh_sizes
from repro_torch.models import sharding
from repro_torch.models.registry import Model, build_model, numpy_dtype_name
from repro_torch.models.transformer import ModelSettings
from repro_torch.optim import grad_sync
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
from repro_torch.runtime.train_loop import (make_dfabric_train_step,
                                            make_gspmd_train_step,
                                            make_sync_plan, mesh_info,
                                            zero_moment_specs)
from repro_torch.utils.trees import tree_from_paths, tree_paths

# archs whose optimizer state / params cannot be replicated within a pod —
# they run the GSPMD+FSDP step; everything else runs the explicit DFabric
# DDP/ZeRO-1 step
FSDP_ARCHS = {"nemotron-4-340b", "jamba-1.5-large-398b"}


def cell_settings(arch: ArchConfig, shape: ShapeConfig, *,
                  attn_impl: str = "masked", remat: str = "full") -> ModelSettings:
    return ModelSettings(
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        attn_impl=attn_impl,
        attn_block=1024,
        attn_chunk=1024 if shape.seq_len > 2048 else min(shape.seq_len, 1024),
        remat=remat if shape.kind == "train" else "none",
        loss_chunk=min(2048, shape.seq_len),
        max_seq=shape.seq_len,
    )


def cell_microbatches(arch: ArchConfig, shape: ShapeConfig, dp_total: int) -> int:
    if shape.kind != "train":
        return 1
    local_b = shape.global_batch // dp_total
    want = 8 if arch.name in FSDP_ARCHS else (4 if arch.d_model >= 5120 else 1)
    while want > 1 and local_b % want != 0:
        want //= 2
    return max(want, 1)


@dataclass(frozen=True)
class StandIn:
    """One input leaf of a cell's step: its global ``shape``, numpy
    ``dtype`` name and ``spec`` (one entry a dim: None, an axis, or a tuple
    of axes, major first)."""

    shape: Tuple[int, ...]
    dtype: str
    spec: Tuple[Any, ...]

    def local_shape(self, sizes: Dict[str, int]) -> Tuple[int, ...]:
        """The block one member holds on a mesh of ``sizes``."""
        return sharding.local_shape(self.shape, self.spec, sizes)

    def member_bytes(self, sizes: Dict[str, int]) -> int:
        return math.prod(self.local_shape(sizes)) * dtype_itemsize(self.dtype)


@dataclass
class Bound:
    """A cell bound to a device: ``model`` built for real, ``run`` the
    cell's step (train: ``run(params, state, batch, step_idx)``; prefill:
    ``run(tokens[, frames])``; decode: ``run(cache, tokens, pos)``) and
    ``init`` what it carries (train: ``init()``, the sync or optimizer
    state; decode: ``init(batch, max_seq)``, a zeroed cache: this member's
    blocks of it when bound to a mesh)."""

    model: Model
    run: Callable
    init: Optional[Callable] = None


@dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    sizes: Dict[str, int]
    model: Model  # on the meta device
    mode: str  # train | prefill | decode
    step_kind: str  # dfabric | gspmd | gspmd_cp | serve
    args: Tuple  # trees of StandIn, one per argument of the step
    donate: Tuple[int, ...] = ()
    microbatches: int = 1
    plan: Optional[SyncPlan] = None  # the DFabric step's gradient sync
    _bind: Optional[Callable] = None  # (model, mesh) -> Bound

    def bind(self, mesh: Optional[prims.Mesh] = None, *, device="cuda",
             seed: int = 0) -> Bound:
        """The model built on ``device`` from ``seed`` and the cell's step
        on it.  A training cell takes the bound ``mesh`` of this member,
        whose sizes must be the cell's.  A serving cell given that mesh
        holds this member's blocks (cut under the cell's ``mesh_info``,
        FSDP for ``FSDP_ARCHS``), runs on its rows of the cell's batch
        (every row where the batch does not divide the DP members) under
        the mesh, and ``init`` gives its cache blocks; without a mesh it
        runs the whole model on this member (one DP member, its model axis
        folded)."""
        if (self.mode == "train" or mesh is not None) and (
                mesh is None or mesh.sizes != self.sizes):
            raise ValueError(f"a {self.step_kind} cell on {self.sizes} "
                             f"binds to a mesh of those sizes, got "
                             f"{mesh and mesh.sizes}")
        model = build_model(self.arch, self.model.settings, device=device,
                            seed=seed)
        return self._bind(model, mesh)


def _stand_ins(shapes, specs) -> Dict[str, Any]:
    """A tree of StandIn from a tree of ShapeDtype and a tree of specs."""
    sp = tree_paths(specs)
    return tree_from_paths({k: StandIn(tuple(v.shape), str(v.dtype), tuple(sp[k]))
                            for k, v in tree_paths(shapes).items()})


def _scalar() -> StandIn:
    return StandIn((), "int32", ())


def build_cell(arch_name: str, shape_name: str, sizes: Dict[str, int], *,
               topo=None,
               attn_impl: str = "masked",
               codec: Optional[str] = None,
               sync_strategy: str = "hier_striped",
               zero1: bool = True,
               microbatches: Optional[int] = None,
               seq_shard: bool = False,
               moe_groups: int = 1,
               loss_chunk: Optional[int] = None,
               context_parallel: bool = False) -> Cell:
    """The cell of ``arch_name`` at ``shape_name`` on a mesh of ``sizes``
    ({axis: size}), with the reference's keyword arguments."""
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        raise ValueError(f"skip: {why}")
    sizes = dict(sizes)
    if topo is None:
        topo = topology_from_mesh_sizes(sizes)
    st = cell_settings(arch, shape, attn_impl=attn_impl)
    ntp = sizes.get("model", 1)
    # repeat-KV layout when heads are TP-sharded but the GQA group factors
    # don't divide the TP degree (nemotron/stablelm/jamba/chameleon at TP16)
    if (arch.n_heads % ntp == 0 and arch.n_kv_heads % ntp != 0
            and (arch.n_heads // arch.n_kv_heads) % ntp != 0):
        st = dataclasses.replace(st, gqa_repeat=True)
    if seq_shard:
        # GSPMD-mode activations are globally batched -> constrain B too;
        # dfabric-mode batch dims are manual (local) -> only the seq axis
        gspmd_like = (arch.name in FSDP_ARCHS) or shape.kind != "train"
        baxes = tuple(a for a in ("pod", "data") if a in sizes) if gspmd_like else None
        st = dataclasses.replace(st, seq_axis="model", batch_axes=baxes)
    if moe_groups > 1:
        st = dataclasses.replace(st, moe_groups=moe_groups)
    if loss_chunk:
        st = dataclasses.replace(st, loss_chunk=loss_chunk)
    model = build_model(arch, st, device="meta")  # raises where not ported
    fsdp = arch.name in FSDP_ARCHS
    mi = mesh_info(sizes, fsdp=fsdp)
    pshapes = model.param_shapes()

    def cell(mode, step_kind, args, bind, donate=(), mb=1, plan=None) -> Cell:
        return Cell(arch, shape, sizes, model, mode, step_kind, tuple(args),
                    donate, mb, plan, bind)

    if shape.kind == "train":
        mb = microbatches or cell_microbatches(arch, shape, mi.dp_total)
        opt_cfg = AdamWConfig()
        lr_fn = cosine_schedule(3e-4, 100, 10000)
        if context_parallel:
            # the reference's context-parallel cell: sequence-sharded
            # activations, blocks replicated over the TP axis, ZeRO moments,
            # the GSPMD step without FSDP
            st = dataclasses.replace(st, seq_axis="model", batch_axes=tuple(
                a for a in ("pod", "data") if a in sizes))
            model = build_model(arch, st, device="meta")
            mi_cp = mesh_info(sizes, fsdp=False)
            mi_cp.tp_scope = "embed_only"
            pspecs = model.param_specs(mi_cp)
            mspecs = zero_moment_specs(tree_paths(pshapes), tree_paths(pspecs),
                                       sizes)
            return cell("train", "gspmd_cp",
                        _gspmd_args(model, shape, mi_cp, pspecs, mspecs),
                        _gspmd_binder(opt_cfg, lr_fn, mb, fsdp=False, mi=mi_cp,
                                      zero_opt=True), mb=mb)
        if fsdp:
            pspecs = model.param_specs(mi)
            return cell("train", "gspmd",
                        _gspmd_args(model, shape, mi, pspecs),
                        _gspmd_binder(opt_cfg, lr_fn, mb), mb=mb)
        # dfabric explicit-DP
        plan, ss = make_sync_plan(model, sizes, topo, codec=codec,
                                  strategy=sync_strategy)
        ss_state = ss if zero1 else dataclasses.replace(ss, mode="paper")
        pspecs = model.param_specs(mesh_info(sizes))
        # the global arrays (sizes {}), on the meta device
        state = grad_sync.init_sync_state(plan, pshapes, ss_state,
                                          torch.device("meta"),
                                          param_specs_tree=pspecs, sizes={})
        sspecs = grad_sync.merged_state_specs(plan, pshapes, pspecs, ss_state)
        sync_state = {"step": _scalar(), "sections": {
            name: {k: StandIn(tuple(t.shape), numpy_dtype_name(t.dtype),
                              tuple(sspecs["sections"][name][k]))
                   for k, t in entry.items()}
            for name, entry in state["sections"].items()}}

        def bind(model: Model, mesh: prims.Mesh) -> Bound:
            step, init = make_dfabric_train_step(
                model, mesh, plan, ss, opt_cfg, lr_fn, microbatches=mb,
                zero1=zero1)
            return Bound(model, step, init)

        return cell("train", "dfabric",
                    (_stand_ins(pshapes, pspecs), sync_state,
                     _batch_args(model, shape, mi), _scalar()), bind, mb=mb,
                    plan=plan)

    # ---- inference cells ------------------------------------------------------
    params = _stand_ins(pshapes, model.param_specs(mi))
    B = shape.global_batch
    frames = arch.encoder.n_frames if arch.is_encdec else None

    def on_member(model: Model, mesh: Optional[prims.Mesh], fn):
        """``fn`` under ``mesh``, the model cut for its member first."""
        if mesh is None:
            return fn
        model.shard(mi, mesh.sizes, mesh.coords)

        def run(*args, **kw):
            with prims.bind(mesh):
                return fn(*args, **kw)
        return run

    if shape.kind == "prefill" or shape.name == "prefill_32k":
        args = [params, StandIn((B, shape.seq_len), "int32", _dp_spec(mi, 2, B))]
        if arch.is_encdec:
            args.append(StandIn((B, frames, arch.d_model), "bfloat16",
                                _dp_spec(mi, 3, B)))
        return cell("prefill", "serve", args,
                    lambda model, mesh: Bound(model, on_member(
                        model, mesh, functools.partial(model.prefill, batch=B))))

    # decode
    cache = _stand_ins(model.cache_shapes(B, shape.seq_len, n_frames=frames),
                       model.cache_specs(mi, B, shape.seq_len, n_frames=frames))
    tokens = StandIn((B, 1), "int32", _dp_spec(mi, 2, B))

    def bind_decode(model: Model, mesh: Optional[prims.Mesh]) -> Bound:
        run = on_member(model, mesh, functools.partial(
            model.decode_step, batch=B, max_seq=shape.seq_len, n_frames=frames))
        return Bound(model, run, on_member(
            model, mesh, lambda batch, max_seq: model.init_cache(
                batch, max_seq, n_frames=frames)))

    return cell("decode", "serve", (params, cache, tokens, _scalar()),
                bind_decode, donate=(1,))


def _gspmd_args(model: Model, shape: ShapeConfig, mi, pspecs, mspecs=None):
    """(params, opt state, batch, step) of a GSPMD cell: fp32 moments laid
    out as the parameters, or by ``mspecs`` ({path: spec}) where given."""
    pshapes = model.param_shapes()
    ms = mspecs or tree_paths(pspecs)
    moments = tree_from_paths({k: StandIn(tuple(v.shape), "float32", tuple(ms[k]))
                               for k, v in tree_paths(pshapes).items()})
    opt = {"m": moments, "v": moments, "step": _scalar()}
    return (_stand_ins(pshapes, pspecs), opt, _batch_args(model, shape, mi),
            _scalar())


def _gspmd_binder(opt_cfg, lr_fn, mb, fsdp=True, mi=None, zero_opt=False):
    def bind(model: Model, mesh: prims.Mesh) -> Bound:
        step, init, _ = make_gspmd_train_step(
            model, mesh, opt_cfg, lr_fn, fsdp=fsdp, microbatches=mb, mi=mi,
            zero_opt=zero_opt)
        return Bound(model, step, init)
    return bind


def _dp_spec(mi, ndim: int, batch: Optional[int] = None) -> Tuple[Any, ...]:
    dp = mi.dp_axes if len(mi.dp_axes) > 1 else (mi.dp_axes[0] if mi.dp_axes else None)
    if batch is not None and dp is not None and batch % mi.dp_total != 0:
        dp = None  # tiny-batch cell (long_500k): batch stays unsharded
    return (dp,) + (None,) * (ndim - 1)


def _batch_args(model: Model, shape: ShapeConfig, mi) -> Dict[str, StandIn]:
    arch = model.arch
    B = shape.global_batch
    spec = _dp_spec(mi, 2)
    batch = {"tokens": StandIn((B, shape.seq_len), "int32", spec),
             "labels": StandIn((B, shape.seq_len), "int32", spec)}
    if arch.is_encdec:
        batch["frames"] = StandIn((B, arch.encoder.n_frames, arch.d_model),
                                  "bfloat16", _dp_spec(mi, 3))
    return batch


def input_specs(arch_name: str, shape_name: str, sizes: Dict[str, int], **kw):
    """The stand-ins of every input of the cell's step (the reference's
    ``input_specs()`` entry point)."""
    return build_cell(arch_name, shape_name, sizes, **kw).args
