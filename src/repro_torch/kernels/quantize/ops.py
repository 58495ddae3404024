"""Public wrapper for the fused quantize kernel.

``quantize_ef`` runs the CUDA kernel on CUDA tensors and the plain version
on CPU tensors; the choice follows the tensor's device only, so a CUDA
tensor never reaches the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.quantize.kernel import quantize_ef_fwd
from repro_torch.kernels.quantize.ref import quantize_ef_ref


def quantize_ef(x: torch.Tensor, *, block: int = 2048
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (n,) fp32 or bf16, n % block == 0.  Returns (q (n,) int8, scales
    (n/block,) fp32, err (n,) fp32 — the error-feedback residual)."""
    if x.device.type == "cpu":
        return quantize_ef_ref(x, block=block)
    return quantize_ef_fwd(x.contiguous(), block=block)
