"""Gradient compression for the slow (DCN / "Ethernet") tier — the port of
``repro.core.compression``.

``Int8Codec`` is the per-block symmetric int8 quantizer with error
feedback; its encode is the fused quantize kernel (K2,
``kernels/quantize``) on CUDA tensors and the kernel's plain version on CPU
tensors, and one launch gives the EF residual too.  Like K2 it computes in
fp32 whatever the input dtype (the JAX codec computes in the input's
dtype; the gradient sync hands it fp32 in both packages).

``compressed_psum_int8`` sums over one mesh axis with int8 on the wire: each
member quantizes its shard, the int8 payloads and scales are all-gathered,
and every member dequantize-sums locally.  It is split into an issue half
(quantize, start the gathers) and a finish half (wait, decode, sum), so the
pipelined lowering can keep a slow leg in flight while it gathers another
chunk.

``TopKCodec`` and the mid-tier codec are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prims
from repro_torch.kernels.quantize import ops as quant_ops


@dataclass(frozen=True)
class Int8Codec:
    """Symmetric per-block int8 quantizer."""

    block: int = 2048

    def encode_ef(self, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (n,) float -> (q (n,) int8, scales (n/block,) fp32, err (n,)
        fp32 = x - decode(q, scales)), one kernel launch on the card."""
        return quant_ops.quantize_ef(x, block=self.block)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (n,) float -> (q: (n,) int8, scales: (n/block,) f32)."""
        q, s, _ = self.encode_ef(x)
        return q, s

    def decode(self, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        """(..., n) int8 and (..., n/block) scales -> (..., n) fp32."""
        lead, n = q.shape[:-1], q.shape[-1]
        qb = q.reshape(*lead, n // self.block, self.block).float()
        return (qb * scales[..., None]).reshape(*lead, n)

    def wire_bytes(self, n: int) -> int:
        return n * 1 + (n // self.block) * 4

    @property
    def name(self) -> str:
        return f"int8(b{self.block})"


# ---------------------------------------------------------------------------
# Compressed psum over the slow axis
# ---------------------------------------------------------------------------


@dataclass
class PendingInt8Psum:
    """A compressed psum whose gathers are in flight; ``finish`` waits for
    them and dequantize-sums."""

    codec: Int8Codec
    n0: int
    dtype: torch.dtype
    q: prims.Pending
    s: prims.Pending
    new_ef: Optional[torch.Tensor]

    def finish(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        qg, sg = self.q.wait(), self.s.wait()  # (P, n) int8, (P, n/block)
        dec = self.codec.decode(qg, sg)
        out = dec.sum(dim=0)[:self.n0].to(self.dtype)
        return out, self.new_ef


def issue_psum_int8(x: torch.Tensor, axis_name: str, codec: Int8Codec,
                    ef: Optional[torch.Tensor] = None) -> PendingInt8Psum:
    """Quantize ``x`` (+ ``ef``) and start the all-gathers of the int8
    payload and the scales over ``axis_name``.  Inputs are zero-padded to a
    multiple of the codec block (padding quantizes to exact zeros)."""
    n0 = x.shape[0]
    if ef is not None:
        x = x + ef.to(x.dtype)
    pad = (-n0) % codec.block
    xp = F.pad(x, (0, pad)) if pad else x
    q, s, err = codec.encode_ef(xp)
    new_ef = err[:n0] if ef is not None else None
    return PendingInt8Psum(
        codec, n0, x.dtype,
        prims.all_gather_stacked(q, axis_name, async_op=True),  # int8 wire
        prims.all_gather_stacked(s, axis_name, async_op=True),
        new_ef)


def compressed_psum_int8(x: torch.Tensor, axis_name: str, codec: Int8Codec,
                         ef: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sum ``x`` over ``axis_name`` transferring int8 on the wire; returns
    (the sum, the new EF state: the residual of this member's own
    quantization, or None without ``ef``)."""
    return issue_psum_int8(x, axis_name, codec, ef).finish()


def make_codec(kind: Optional[str], **kw):
    if kind in (None, "none"):
        return None
    if kind == "int8":
        return Int8Codec(**{k: v for k, v in kw.items() if k in ("block",)})
    if kind == "topk":
        raise NotImplementedError(
            "the top-k codec is not ported yet (ROADMAP.md queue 1)")
    raise ValueError(f"unknown codec {kind!r}")
