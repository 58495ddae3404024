"""Plain PyTorch version of the Mamba selective scan: sequential, in fp32.

The oracle for the CUDA kernel, and the path a CPU tensor takes.  The twin
of ``repro.kernels.mamba_scan.ref.mamba_scan_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, S, di); A: (di, ds); Bc, Cc: (B, S, ds); D: (di,); h0:
    (B, di, ds).  Returns (y (B, S, di) fp32, final state (B, di, ds)
    fp32)::

        h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t
        y_t = h_t C_t + D u_t
    """
    u, dt, Bc, Cc = (a.float() for a in (u, dt, Bc, Cc))
    A, D = A.float(), D.float()
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        ut, dtt, bt, ct = u[:, t], dt[:, t], Bc[:, t], Cc[:, t]
        dA = torch.exp(dtt[..., None] * A[None])  # (B, di, ds)
        dBu = dtt[..., None] * bt[:, None, :] * ut[..., None]
        h = dA * h + dBu
        ys.append(torch.einsum("bds,bs->bd", h, ct) + D * ut)
    return torch.stack(ys, dim=1), h
