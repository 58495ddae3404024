"""Public wrapper for the flash-attention kernel.

``flash_attention`` takes the model's (B, S, KV, G, hd) grouped layout,
runs the CUDA kernel on CUDA tensors and the plain version on CPU tensors,
and is differentiable: its backward is autograd through ``attention_ref``,
the twin of the JAX custom VJP (forward-optimized prefill is the kernel's
job; a backward kernel comes with the training slice).  The choice follows
the tensor's device only; a CUDA tensor never reaches the plain version in
the forward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal)
        return flash_attention_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = attention_ref(q, k, v, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """qg: (B, S, KV, G, hd); k, v: (B, S, KV, hd) — the model layout.
    Returns (B, S, KV, G, hd).  The (B, H, S, hd) views the kernel takes
    are strided views of these tensors, not copies."""
    B, S, KV, G, hd = qg.shape
    q = qg.reshape(B, S, KV * G, hd).transpose(1, 2)  # (B, H, S, hd)
    o = _FlashAttention.apply(q, k.transpose(1, 2), v.transpose(1, 2), causal)
    return o.transpose(1, 2).reshape(B, S, KV, G, hd)
