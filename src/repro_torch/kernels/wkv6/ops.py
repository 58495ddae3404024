"""Public wrapper for the WKV6 kernel, in the model layout.

``wkv6`` runs the CUDA kernel on CUDA tensors and the plain version on CPU
tensors; the choice follows the tensor's device only, so a CUDA tensor
never reaches the plain version in the forward.  It is differentiable:
the JAX package has no WKV6 backward kernel, so the backward recomputes
the plain recurrence (``wkv6_ref``) from the saved inputs and takes its
gradients with autograd, on purpose and on either device — the twin of
``kernels/flash_attention/ops.py``'s backward through ``attention_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._recompute import ref_backward
from repro_torch.kernels.wkv6.kernel import wkv6_fwd
from repro_torch.kernels.wkv6.ref import wkv6_ref


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        if r.device.type == "cpu":
            return wkv6_ref(r, k, v, w, u, state)
        return wkv6_fwd(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, gy, gs):
        return ref_backward(ctx, wkv6_ref, gy, gs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: r, k, v, w (B, S, H, hd); u (H, hd); state
    (B, H, hd, hd) or None (zeros).  Returns (y (B, S, H, hd) fp32, final
    state).  The (B, H, S, hd) tensors the kernel takes are strided views
    of these, not copies, and y comes back in the model layout."""
    B, S, H, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    rt, kt, vt, wt = (a.transpose(1, 2) for a in (r, k, v, w))
    y, sT = _WKV6.apply(rt, kt, vt, wt, u, state)
    return y.transpose(1, 2), sT
