"""AdamW in PyTorch (fp32 moments, fp32 update math) — the port of
``repro.optim.adamw``.

Parameters and moments are nested dicts of tensors, as in the JAX package.
The functions return new tensors and leave their inputs as they were; the
gradient sync updates the moments in place (``adamw_leaf(inplace=True)``)
and writes the parameters back in place, where that saves memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.trees import tree_from_paths, tree_paths


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_moments(params) -> Dict[str, Any]:
    flat = tree_paths(params)
    return {"m": tree_from_paths({k: _zeros(p) for k, p in flat.items()}),
            "v": tree_from_paths({k: _zeros(p) for k, p in flat.items()}),
            "step": 0}


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def adamw_leaf(p, g, m, v, step, lr, cfg: AdamWConfig, clip_coef=1.0,
               inplace: bool = False):
    """Single-leaf AdamW update in fp32.  Returns (new_p, new_m, new_v).
    ``step`` is the number of updates already made; ``lr`` and
    ``clip_coef`` are floats or 0-d fp32 tensors.  With ``inplace`` the
    fp32 ``g``, ``m`` and ``v`` are consumed: the moments are updated where
    they lie and returned, and ``g`` is overwritten, so that a leaf's
    update holds no second copy of them (the sync's use); otherwise the
    inputs are left as they were.  Either way the arithmetic is the
    reference's, operation for operation."""
    g = g.float()
    if not inplace:
        g, m, v = g.clone(), m.clone(), v.clone()
    g.mul_(_f32(clip_coef, g))
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    del g
    t = _f32(step, m) + 1.0
    denom = (v / (1 - torch.pow(_f32(cfg.b2, m), t))).sqrt_().add_(cfg.eps)
    upd = (m / (1 - torch.pow(_f32(cfg.b1, m), t))).div_(denom)
    del denom
    upd.add_(p.float() * cfg.weight_decay)
    new_p = (p.float() - upd.mul_(_f32(lr, m))).to(p.dtype)
    return new_p, m, v


def global_norm(tree, specs=None) -> torch.Tensor:
    """The L2 norm over every leaf.  With ``specs`` ({path: spec}) the
    leaves are this member's blocks (the GSPMD step's sharded gradients):
    the squared sums of the leaves split over the same axes are summed
    over those axes of the bound mesh, so that each block counts once and
    a replicated leaf is not counted once a member."""
    flat = tree_paths(tree)
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                              for l in flat.values()))
    from repro_torch.core import prims
    from repro_torch.models.sharding import spec_axes
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, leaf in flat.items():
        axes = tuple(sorted(a for a in spec_axes(specs[path])
                            if prims.axis_size(a) > 1))
        sq = torch.sum(torch.square(leaf.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    return torch.sqrt(sum(prims.psum(sq, axes) for axes, sq in groups.items()))


def clip_coefficient(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    if cfg.grad_clip <= 0:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)


def adamw_update(params, grads, state, lr, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any]]:
    """Full-tree AdamW with global-norm clipping."""
    clip = clip_coefficient(global_norm(grads), cfg)
    step = state["step"]
    pf, gf = tree_paths(params), tree_paths(grads)
    mf, vf = tree_paths(state["m"]), tree_paths(state["v"])
    out = {k: adamw_leaf(pf[k], gf[k], mf[k], vf[k], step, lr, cfg, clip)
           for k in pf}
    new_p = tree_from_paths({k: o[0] for k, o in out.items()})
    return new_p, {"m": tree_from_paths({k: o[1] for k, o in out.items()}),
                   "v": tree_from_paths({k: o[2] for k, o in out.items()}),
                   "step": step + 1}


# -- schedules ----------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr at a step, in fp32 as the JAX schedule computes it."""
    def lr_at(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr_at
