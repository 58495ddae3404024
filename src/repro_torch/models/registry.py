"""Public model API: ``Model`` (an ``nn.Module``), ``build_model``,
``count_params`` and ``count_active_params`` — the port of
``repro.models.registry``.

``Model`` registers its parameters under the JAX tree's paths, with ``/``
read as ``.`` (``blocks/l0/attn/wq`` is ``blocks.l0.attn.wq``), and with
the JAX shapes, so ``convert.load_jax_params`` can load a JAX tree leaf by
leaf.  The layer code works on the nested dict that ``params()`` returns.

Under a model axis (tensor parallelism) or an FSDP axis, :meth:`Model.shard`
keeps this member's block of every leaf, as its spec gives it, and records
the :class:`Layout`; the layers then run on the blocks with the
collectives GSPMD would put in for the JAX package.  ``param_shapes`` and
``param_specs`` stay the global tree's, as ``jax.eval_shape`` gives them.

Serving under a layout (the mesh bound with ``prims.bind``):
``prefill`` and ``decode_step`` take this member's rows of the batch and
``init_cache`` gives its block of every cache leaf under
``sharding.cache_specs``, allocated at the block's shape.  The rows are
split over the DP axes when the global ``batch`` divides their members
(the JAX ``_dp_spec``); otherwise every member holds every row, and an
attention cache's sequence (and a cross-attention cache's frames) splits
over the last DP axis where the axis divides it.  A model cut for a
DP-only training step serves its member's rows too; an uncut model serves
the whole batch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prims
from repro_torch.core.planner import ShapeDtype
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelSettings
from repro_torch.utils.trees import tree_from_paths, tree_paths

__all__ = ["ModelSettings", "build_model", "Model", "Layout", "count_params",
           "count_active_params", "resolve_device", "numpy_dtype_name"]


def numpy_dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.bfloat16`` -> "bfloat16"):
    what the planner copy is handed, since ``str(torch.bfloat16)`` prices at
    4 bytes there."""
    return str(dtype).removeprefix("torch.")


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for; CUDA without a card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class Layout:
    """How one member holds the parameters: ``specs`` ({path: spec}), the
    mesh ``sizes`` and this member's ``coords``; ``tp`` and ``fsdp`` name
    the model and FSDP axes (None when absent); ``loss_axes`` are the DP
    axes over which the loss is one mean over the whole batch (the GSPMD
    step's; the DFabric step averages the members' means instead)."""

    specs: Dict[str, Tuple]
    sizes: Dict[str, int]
    coords: Dict[str, int]
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    loss_axes: Tuple[str, ...] = ()

    @functools.cached_property
    def tree(self) -> Dict[str, Any]:
        """The specs as a tree, an axis of one member read as None (what
        the layers read: such a dim is whole)."""
        return tree_from_paths({
            k: tuple(e if any(self.split(a) for a in sharding.entry_axes(e))
                     else None for e in sp)
            for k, sp in self.specs.items()})

    def split(self, axis: Optional[str]) -> bool:
        return axis is not None and self.sizes.get(axis, 1) > 1

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The DP axes of the mesh, slowest first."""
        return tuple(a for a in prims.MESH_AXES[:-1] if a in self.sizes)

    @property
    def dp_total(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp_axes)

    def mesh_info(self) -> sharding.MeshInfo:
        """The rule inputs the layout was cut by (the cache's rules read
        the model and DP axes)."""
        return sharding.MeshInfo(self.sizes, tp_axis=self.tp, fsdp_axis=self.fsdp,
                                 dp_axes=self.dp_axes)

    @property
    def sharded(self) -> bool:
        """Whether any leaf is split over a member axis."""
        return any(self.split(a) for sp in self.specs.values()
                   for a in sharding.spec_axes(sp))


class Model(nn.Module):
    def __init__(self, arch: ArchConfig, settings: ModelSettings,
                 device: torch.device, seed: int = 0):
        super().__init__()
        self.arch = arch
        self.settings = settings
        # the meta device (shapes only, no memory) has no generator
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        for path, leaf in tree_paths(T.init_params(arch, gen, settings,
                                                   device)).items():
            node = self
            *parents, name = path.split("/")
            for part in parents:
                if part not in node._modules:
                    node.add_module(part, nn.Module())
                node = node._modules[part]
            node.register_parameter(name, nn.Parameter(leaf, requires_grad=False))
        self.layout: Optional[Layout] = None
        self._global_shapes: Optional[Dict[str, Any]] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def shard(self, mi: sharding.MeshInfo, sizes: Dict[str, int],
              coords: Dict[str, int], loss_axes: Tuple[str, ...] = ()
              ) -> Layout:
        """Keep this member's block of every leaf under ``mi``'s specs on
        a mesh of ``sizes`` (this member at ``coords``), in place; the
        blocks are contiguous copies, so the global leaves are freed.  A
        model is cut once: a second call with the same layout keeps the
        blocks as they are, and one with another layout raises unless
        neither layout splits a leaf."""
        specs = tree_paths(self.param_specs(mi))
        layout = Layout(specs, dict(sizes), dict(coords), tp=mi.tp,
                        fsdp=mi.fsdp, loss_axes=tuple(loss_axes))
        if self.layout == layout:
            return layout
        if self.layout is not None:
            if self.layout.sharded or layout.sharded:
                raise ValueError(f"the model is already cut for {self.layout}; "
                                 f"build a new one for {layout}")
            self.layout = layout  # whole leaves either way
            return layout
        shapes = self.param_shapes()
        with torch.no_grad():
            for name, p in self.named_parameters():
                spec = specs[name.replace(".", "/")]
                blk = sharding.local_block(p.data, spec, coords, sizes)
                if tuple(blk.shape) != tuple(p.shape):
                    p.data = blk.contiguous().clone()
        self._global_shapes, self.layout = shapes, layout
        return layout

    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested dict tree."""
        return tree_from_paths({n.replace(".", "/"): p
                                for n, p in self.named_parameters()})

    def param_shapes(self) -> Dict[str, Any]:
        """The tree of :class:`ShapeDtype` records (shape, numpy dtype
        name) — the port of ``jax.eval_shape`` over ``init``: the global
        shapes, also once the model holds blocks."""
        if self._global_shapes is not None:
            return self._global_shapes
        return tree_from_paths({
            n.replace(".", "/"): ShapeDtype(tuple(p.shape),
                                            numpy_dtype_name(p.dtype))
            for n, p in self.named_parameters()})

    def param_specs(self, mi: sharding.MeshInfo) -> Dict[str, Any]:
        """The tree of per-dim sharding specs."""
        shapes = {k: v.shape for k, v in tree_paths(self.param_shapes()).items()}
        return tree_from_paths(sharding.param_specs(self.arch, shapes, mi))

    # --- steps ---------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token loss of ``batch`` ({'tokens', 'labels'}: (B, S)
        integer; an encoder-decoder's also 'frames': (B, F, d_model)) under
        ``params`` (a tree like ``params()``); differentiable in
        ``params``."""
        return T.train_loss(self.arch, params, batch, self.settings,
                            self.layout)

    def _serving(self, rows: int, batch: Optional[int]):
        """(the model's layout or None, the DP axes over which the members'
        ``rows`` form the batch, and the DP axis over which a cache's
        sequence may split or None) for a global ``batch`` (None: ``rows``
        on every DP member).  The sequence may split only where the batch
        does not divide the DP members: over the last DP axis, where that
        has several members."""
        lay = self.layout
        if lay is None:
            return None, (), None
        n = lay.dp_total
        batch = rows * n if batch is None else batch
        if batch % n == 0:
            if rows * n != batch:
                raise ValueError(f"a batch of {batch} gives each of {n} DP "
                                 f"members {batch // n} rows, got {rows}")
            return lay, tuple(a for a in lay.dp_axes if lay.split(a)), None
        if rows != batch:
            raise ValueError(f"a batch of {batch} does not split over {n} DP "
                             f"members: each holds all of it, got {rows} rows")
        data = lay.dp_axes[-1]
        return lay, (), data if lay.split(data) else None

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None, *,
                batch: Optional[int] = None):
        """(last-position logits (B, V) fp32, cache).  Under a layout
        ``tokens`` (and ``frames``) are this member's rows of a ``batch``
        (see the module docstring), the logits its rows over the whole
        vocab, and the cache its block of each leaf under
        ``sharding.cache_specs`` for the prompt's length."""
        lay, rows, _ = self._serving(tokens.shape[0], batch)
        logits, cache = T.prefill(self.arch, self.params(), tokens, self.settings,
                                  frames=frames, layout=lay, token_axes=rows)
        if lay is None:
            return logits, cache
        B = tokens.shape[0] * lay.dp_total if batch is None else batch
        specs = tree_paths(self.cache_specs(
            lay.mesh_info(), B, tokens.shape[1],
            n_frames=frames.shape[1] if frames is not None else None))
        flat = tree_paths(cache)
        for path, t in flat.items():  # the sequence split is the only cut left
            seq = (None, None, specs[path][2]) if path.split("/")[-1] in (
                "k", "v", "xk", "xv") else ()
            blk = sharding.local_block(t, seq, lay.coords, lay.sizes)
            flat[path] = blk.clone() if blk.shape != t.shape else t
        return logits, tree_from_paths(flat)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, pos: int, *,
                    batch: Optional[int] = None, max_seq: Optional[int] = None,
                    n_frames: Optional[int] = None):
        """One decode step at ``pos``: (logits (B, V) fp32, the cache written
        in place).  Under a layout ``tokens`` are this member's rows of a
        ``batch``, ``cache`` its blocks of a cache of ``max_seq`` positions
        and ``n_frames`` cross-attention frames (the config's when None), as
        :meth:`init_cache` gives them.  Where the batch does not split over
        the DP members, each of the two splits its sequence as
        ``sharding.cache_specs`` does, where the axis divides it, so
        ``max_seq`` must be given there."""
        lay, rows, data = self._serving(tokens.shape[0], batch)
        seq = xseq = None
        if data is not None:
            if max_seq is None:
                raise ValueError(f"a batch of {tokens.shape[0]} rows on every DP "
                                 f"member: give max_seq, by which the cache's "
                                 f"sequence splits over {data!r}")
            n = lay.sizes[data]
            seq = data if max_seq % n == 0 else None
            if self.arch.is_encdec:
                frames = n_frames or self.arch.encoder.n_frames
                xseq = data if frames % n == 0 else None
        return T.decode_step(self.arch, self.params(), cache, tokens, pos,
                             self.settings, layout=lay, token_axes=rows,
                             seq_axis=seq, xseq_axis=xseq)

    def init_cache(self, batch: int, max_seq: int,
                   n_frames: Optional[int] = None):
        """A zeroed cache for ``batch`` rows of ``max_seq`` positions (see
        ``transformer.init_cache``); under a layout this member's block of
        each leaf under ``sharding.cache_specs``, allocated at its shape."""
        lay = self.layout
        if lay is None:
            return T.init_cache(self.arch, batch, max_seq, self.settings,
                                self.device, n_frames=n_frames)
        shapes = tree_paths(self.cache_shapes(batch, max_seq, n_frames))
        specs = tree_paths(self.cache_specs(lay.mesh_info(), batch, max_seq,
                                            n_frames))
        return tree_from_paths({
            k: torch.zeros(sharding.local_shape(v.shape, specs[k], lay.sizes),
                           dtype=getattr(torch, v.dtype), device=self.device)
            for k, v in shapes.items()})

    def cache_shapes(self, batch: int, max_seq: int,
                     n_frames: Optional[int] = None) -> Dict[str, Any]:
        """The cache's tree of :class:`ShapeDtype` records, built on the
        meta device (nothing allocated): the global shapes."""
        cache = T.init_cache(self.arch, batch, max_seq, self.settings,
                             torch.device("meta"), n_frames=n_frames)
        return tree_from_paths({
            k: ShapeDtype(tuple(t.shape), numpy_dtype_name(t.dtype))
            for k, t in tree_paths(cache).items()})

    # --- sharding of the inputs ------------------------------------------------
    def batch_specs(self, mi: sharding.MeshInfo) -> Dict[str, Any]:
        return sharding.batch_specs(self.arch, mi)

    def cache_specs(self, mi: sharding.MeshInfo, batch: int, max_seq: int,
                    n_frames: Optional[int] = None) -> Dict[str, Any]:
        shapes = {k: v.shape for k, v in tree_paths(
            self.cache_shapes(batch, max_seq, n_frames)).items()}
        return tree_from_paths(sharding.cache_specs(self.arch, shapes, mi, batch))

    # --- inputs ------------------------------------------------------------------
    def synthetic_batch(self, gen: torch.Generator, shape) -> Dict[str, torch.Tensor]:
        """A random batch of ``shape`` (a ``ShapeConfig``) drawn from ``gen``
        on its device: int32 tokens and labels in [0, vocab), and for an
        encoder-decoder standard-normal frames (B, n_frames, d_model) in the
        compute dtype — the reference's shapes, dtypes and ranges, other
        numbers."""
        B, S, dev = shape.global_batch, shape.seq_len, gen.device
        batch = {k: torch.randint(0, self.arch.vocab, (B, S), generator=gen,
                                  dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        if self.arch.is_encdec:
            batch["frames"] = torch.randn(
                (B, self.arch.encoder.n_frames, self.arch.d_model),
                generator=gen, dtype=self.settings.cdt(), device=dev)
        return batch


def build_model(arch: ArchConfig, settings: Optional[ModelSettings] = None, *,
                device="cuda", seed: int = 0, **overrides) -> Model:
    """A model with weights drawn from ``seed``, on ``device``."""
    dev = resolve_device(device)
    st = settings or ModelSettings()
    if overrides:
        st = dataclasses.replace(st, **overrides)
    return Model(arch, st, dev, seed=seed)


def count_params(model: Model) -> int:
    """Parameters of the global tree (a member holding blocks counts them
    all)."""
    return sum(math.prod(leaf.shape)
               for leaf in tree_paths(model.param_shapes()).values())


def count_active_params(model: Model) -> int:
    """Active params per token (MoE: only top-k routed experts count)."""
    arch = model.arch
    total = 0
    for p, leaf in tree_paths(model.param_shapes()).items():
        n = math.prod(leaf.shape)
        if arch.moe is not None and ("we_in" in p or "we_out" in p or "we_gate" in p):
            n = int(n * arch.moe.top_k / arch.moe.num_experts)
        total += n
    return total
