"""Public wrapper for the Mamba selective-scan kernel, in the model layout.

``mamba_scan`` runs the CUDA kernel on CUDA tensors and the plain version
on CPU tensors; the choice follows the tensor's device only, so a CUDA
tensor never reaches the plain version in the forward.  It is
differentiable in u, dt, A, B, C, D and the initial state: the JAX package
has no scan backward kernel, so the backward recomputes the plain scan
(``mamba_scan_ref``) from the saved inputs and takes its gradients with
autograd, on purpose and on either device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._recompute import ref_backward
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dt, A, Bc, Cc, D, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, Bc, Cc, D, state)
        if u.device.type == "cpu":
            return mamba_scan_ref(u, dt, A, Bc, Cc, D, state)
        return mamba_scan_fwd(u, dt, A, Bc, Cc, D, state)

    @staticmethod
    def backward(ctx, gy, gs):
        return ref_backward(ctx, mamba_scan_ref, gy, gs)


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, S, di); A: (di, ds); Bc, Cc: (B, S, ds), which may be
    column slices of a wider tensor (the model's ``xdbl``: the kernel reads
    them through their strides, so no copy is made); D: (di,); state
    (B, di, ds) fp32 or None (zeros).  Returns (y (B, S, di) fp32, final
    state (B, di, ds) fp32)."""
    B, S, di = u.shape
    if state is None:
        state = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                            device=u.device)
    return _MambaScan.apply(u, dt, A, Bc, Cc, D, state)
