"""Closed-form FLOP/byte accounting per (arch x shape x mode) — a copy of
``repro.roofline.analytics``, verbatim but for docstrings and the package
name (``tests/test_torch_planner.py::test_copy_is_verbatim``).

The reference prices its flash-attention kernel under ``attn_impl ==
"pallas"``; the port names that path ``"kernel"``, which this copy prices
as masked-dense attention (the whole S x S), as the reference prices any
implementation it does not name.

Conventions:
  * flops: one multiply-add = 2 flops; matmul (m,k)@(k,n) = 2mkn.
  * fwd/bwd: backward of a matmul = 2x its forward flops; full-remat
    training recomputes the forward once more: train = (1 + 2 + r) x fwd,
    r = 1 for remat="full", 0 otherwise.
  * bytes: HBM traffic of each op = read(A) + read(B) + write(C) at the
    compute dtype; KV-cache reads at cache dtype; parameter/optimizer
    traffic added once per step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.registry import Model, count_active_params, count_params
from repro_torch.models.transformer import ModelSettings, group_size, layer_is_moe, layer_kind


@dataclass
class CostBreakdown:
    flops: float = 0.0
    bytes_hbm: float = 0.0
    detail: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float = 0.0):
        self.flops += flops
        self.bytes_hbm += nbytes
        self.detail[name] = self.detail.get(name, 0.0) + flops


def _mm(cost: CostBreakdown, name: str, m: float, k: float, n: float,
        dt: int = 2, times: float = 1.0):
    """matmul (m,k)@(k,n): flops + A/B read + C write traffic."""
    cost.add(name, 2.0 * m * k * n * times, (m * k + k * n + m * n) * dt * times)


def _ew(cost: CostBreakdown, name: str, numel: float, flops_per: float = 1.0,
        dt: int = 2, io_factor: float = 2.0, times: float = 1.0):
    cost.add(name, numel * flops_per * times, numel * dt * io_factor * times)


def _attn_core_factor(S: int, st: ModelSettings, causal: bool) -> float:
    """Fraction of the full S x S attention actually computed."""
    if not causal:
        return 1.0
    if st.attn_impl == "tri" and S > st.attn_block and S % st.attn_block == 0:
        # rectangles = exactly the strict lower triangle; leaf diagonal
        # blocks are computed dense-masked (half wasted within each).
        nb = S // st.attn_block
        return 0.5 + 0.5 / nb
    if st.attn_impl == "pallas":
        nb = max(S // 128, 1)
        return 0.5 + 0.5 / nb
    return 1.0  # masked-dense computes everything


def layer_fwd_cost(arch: ArchConfig, B: float, S: int, st: ModelSettings,
                   layer_id: int, mode: str, S_cache: int = 0) -> CostBreakdown:
    """Forward cost of ONE layer on a (B, S) slab.  mode: train|prefill|decode."""
    c = CostBreakdown()
    d, H, KV, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    f = arch.d_ff
    T = B * S
    kind = layer_kind(arch, layer_id)

    if kind == "attn":
        _mm(c, "attn/qkv", T, d, (H + 2 * KV) * hd)
        if mode == "decode":
            Sk = S_cache
            # q@K^T and P@V against the cache (+ cache read traffic)
            c.add("attn/core", 4.0 * B * 1 * Sk * H * hd,
                  2.0 * B * Sk * KV * hd * 2 + B * H * Sk * 4)
        else:
            factor = _attn_core_factor(S, st, causal=True)
            # kv re-read across q blocks (chunked implementation)
            nq = max(S // st.attn_chunk, 1)
            c.add("attn/core", 4.0 * B * S * S * H * hd * factor,
                  (B * S * (H + 2 * KV) * hd * 2) * 2
                  + B * S * KV * hd * 2 * 2 * (nq - 1) * factor)
        _mm(c, "attn/out", T, H * hd, d)
    elif kind == "mamba":
        m = arch.mamba
        di = m.expand * d
        dtr = m.resolved_dt_rank(d)
        _mm(c, "mamba/in", T, d, 2 * di)
        _ew(c, "mamba/conv", T * di, 2.0 * m.d_conv)
        _mm(c, "mamba/xproj", T, di, dtr + 2 * m.d_state)
        _mm(c, "mamba/dt", T, dtr, di)
        _ew(c, "mamba/scan", T * di * m.d_state, 9.0, dt=4)
        _mm(c, "mamba/out", T, di, d)
    elif kind == "rwkv":
        r = arch.rwkv
        Hr, hdr = d // r.head_size, r.head_size
        _mm(c, "rwkv/proj", T, d, d, times=5)  # r,k,v,g,o
        _mm(c, "rwkv/mix_lora", T, d, 5 * r.mix_lora)
        _mm(c, "rwkv/mix_lora2", T, 5 * r.mix_lora, d)
        _mm(c, "rwkv/decay_lora", T, d, r.decay_lora)
        _mm(c, "rwkv/decay_lora2", T, r.decay_lora, d)
        _ew(c, "rwkv/wkv", T * Hr * hdr * hdr, 7.0, dt=4)
        # channel mix
        _mm(c, "rwkv/cmix_k", T, d, f)
        _mm(c, "rwkv/cmix_v", T, f, d)
        _mm(c, "rwkv/cmix_r", T, d, d)

    if kind != "rwkv":
        if layer_is_moe(arch, layer_id):
            moe = arch.moe
            E, k_, fe = moe.num_experts, moe.top_k, moe.expert_d_ff
            _mm(c, "moe/router", T, d, E, dt=4)
            routed = T * k_ * moe.capacity_factor
            nmats = 3 if arch.glu else 2
            _mm(c, "moe/experts", routed, d, fe, times=nmats)
            if moe.num_shared_experts:
                _mm(c, "moe/shared", T, d, fe * moe.num_shared_experts,
                    times=nmats)
        else:
            nmats = 3 if arch.glu else 2
            _mm(c, "mlp", T, d, f, times=nmats)

    # norms + residuals
    _ew(c, "norms", T * d, 6.0, io_factor=4.0)
    return c


def model_cost(model: Model, shape: ShapeConfig, mode: str,
               n_chips: int = 1) -> Dict[str, float]:
    """Whole-program cost for one step of ``mode`` at ``shape``.

    Returns GLOBAL totals (divide by n_chips for per-chip roofline terms).
    """
    arch, st = model.arch, model.settings
    B, S = shape.global_batch, shape.seq_len
    g = group_size(arch)
    G = arch.n_layers // g

    c = CostBreakdown()
    if mode == "decode":
        Sq, S_cache = 1, S
    else:
        Sq, S_cache = S, 0

    for off in range(g):
        lc = layer_fwd_cost(arch, B, Sq, st, off, mode, S_cache=S_cache)
        c.flops += lc.flops * G
        c.bytes_hbm += lc.bytes_hbm * G
        for k_, v in lc.detail.items():
            c.detail[k_] = c.detail.get(k_, 0.0) + v * G

    if arch.is_encdec and mode != "decode":
        enc = CostBreakdown()
        Fr = arch.encoder.n_frames
        _mm(enc, "enc/qkv", B * Fr, arch.d_model, (arch.n_heads + 2 * arch.n_kv_heads) * arch.resolved_head_dim)
        enc.add("enc/core", 4.0 * B * Fr * Fr * arch.n_heads * arch.resolved_head_dim,
                B * Fr * arch.d_model * 2 * 4)
        _mm(enc, "enc/out", B * Fr, arch.n_heads * arch.resolved_head_dim, arch.d_model)
        _mm(enc, "enc/mlp", B * Fr, arch.d_model, arch.d_ff, times=2)
        c.flops += enc.flops * arch.encoder.n_layers
        c.bytes_hbm += enc.bytes_hbm * arch.encoder.n_layers
        # decoder cross attention
        x = CostBreakdown()
        _mm(x, "xattn/q", B * Sq, arch.d_model, arch.n_heads * arch.resolved_head_dim)
        if mode != "decode":
            _mm(x, "xattn/kv", B * Fr, arch.d_model, 2 * arch.n_kv_heads * arch.resolved_head_dim)
        x.add("xattn/core", 4.0 * B * Sq * Fr * arch.n_heads * arch.resolved_head_dim,
              B * Fr * arch.n_kv_heads * arch.resolved_head_dim * 2 * 2)
        _mm(x, "xattn/out", B * Sq, arch.n_heads * arch.resolved_head_dim, arch.d_model)
        c.flops += x.flops * arch.n_layers
        c.bytes_hbm += x.bytes_hbm * arch.n_layers

    # embedding + head (+ CE for train)
    V, d = arch.vocab, arch.d_model
    Th = B * (Sq if mode == "train" else 1)
    _mm(c, "lm_head", Th, d, V)
    if mode == "train":
        _ew(c, "ce", B * Sq * V, 5.0, dt=4, io_factor=1.0)
    c.add("embed", 0.0, B * Sq * d * 2)

    fwd_flops, fwd_bytes = c.flops, c.bytes_hbm

    P = count_params(model)
    Pa = count_active_params(model)
    pdt = 2 if st.param_dtype == "bfloat16" else 4

    if mode == "train":
        remat_extra = 1.0 if st.remat != "none" else 0.0
        total_flops = fwd_flops * (3.0 + remat_extra)
        # parameter-side traffic: reads fwd + bwd (+remat), grad write,
        # adam m/v read+write (fp32), param write
        param_bytes = P * pdt * (2.0 + remat_extra) + P * pdt + P * 4 * 4 + P * pdt
        total_bytes = fwd_bytes * (3.0 + remat_extra) + param_bytes
    else:
        total_flops = fwd_flops
        total_bytes = fwd_bytes + Pa * pdt  # active weights stream in once

    useful = 6.0 * Pa * (B * S) if mode == "train" else 2.0 * Pa * B * Sq
    return {
        "flops": total_flops,
        "bytes": total_bytes,
        "fwd_flops": fwd_flops,
        "model_flops": useful,
        "useful_ratio": useful / max(total_flops, 1.0),
        "params": float(P),
        "active_params": float(Pa),
        "detail": c.detail,
    }
