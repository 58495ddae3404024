"""Plain PyTorch version of the WKV6 recurrence: sequential, in fp32.

The oracle for the CUDA kernel, and the path a CPU tensor takes.  The twin
of ``repro.kernels.wkv6.ref.wkv6_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd), rows the
    key dim i and columns the value dim j.  Returns (y (B, H, S, hd) fp32,
    final state (B, H, hd, hd) fp32)::

        y_t[j] = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
        S_t    = diag(w_t) S_{t-1} + k_t v_t^T
    """
    r, k, v, w = (a.float() for a in (r, k, v, w))
    ukv = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, :, t], s + ukv * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2), s
