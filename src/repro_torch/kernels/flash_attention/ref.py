"""Plain PyTorch version of flash attention (GQA, optional causal).

The oracle for the CUDA kernel, and the path a CPU tensor takes.  The twin
of ``repro.kernels.flash_attention.ref.attention_ref``.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd). fp32 softmax, exact.
    Returns (B, H, S, hd) in q's dtype."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
