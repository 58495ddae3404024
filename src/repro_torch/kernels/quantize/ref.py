"""Plain PyTorch version of the fused int8 quantize + error feedback.

The oracle for the CUDA kernel, and the path a CPU tensor takes.  The twin
of ``repro.kernels.quantize.ref.quantize_ef_ref``: ``Int8Codec.encode``
followed by ``x - decode(q, scales)``, op for op (a division by 127, a
division by the scale, round half to even, the product rounded before the
subtraction), so it agrees with the JAX codec bit for bit, on the CPU
and on the card.  Like the TPU
kernel it computes in fp32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_ef_ref(x: torch.Tensor, *, block: int = 2048
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (n,) float, n % block == 0.  Returns (q (n,) int8, scales
    (n/block,) fp32, err (n,) fp32)."""
    n = x.shape[0]
    if n % block:
        raise ValueError(f"n={n} is not a multiple of block={block}")
    xb = x.float().reshape(n // block, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.clamp_min(scale, 1e-30)
    qf = torch.clamp(torch.round(xb / scale), -127, 127)
    err = xb - qf * scale
    return qf.to(torch.int8).reshape(n), scale[:, 0], err.reshape(n)
