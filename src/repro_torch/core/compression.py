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

``compressed_reduce_scatter_int8`` is the mid-tier codec's scattered leg,
with the reference's wire strategy: quantize the whole local tensor (K2 on
the card), all-gather the int8 payload and the scales, dequantize-sum, and
keep this member's block; no error feedback.

``TopKCodec`` keeps the k largest magnitudes with the reference's indices
in its order (values descending, ties to the lowest index: a stable
descending sort of ``|x|``; ``torch.topk`` leaves the order of ties
unspecified).  ``compressed_psum_topk`` gathers every member's (values,
indices) and adds them member by member in member order: each member's
indices are distinct, so no ``index_add_`` collides and the sum is
bit-reproducible on the card, where one ``index_add_`` over all members'
indices would add by atomics in no fixed order.
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


@dataclass(frozen=True)
class TopKCodec:
    """Magnitude top-k sparsifier. k_frac is the kept fraction."""

    k_frac: float = 0.0625  # 1/16

    def k_of(self, n: int) -> int:
        return max(1, int(n * self.k_frac))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (n,) -> (values (k,) in x's dtype, indices (k,) int32), the
        k largest |x|, ties to the lowest index."""
        k = self.k_of(x.shape[0])
        idx = torch.sort(x.abs(), descending=True, stable=True).indices[:k]
        return x[idx], idx.to(torch.int32)

    def decode(self, values: torch.Tensor, idx: torch.Tensor,
               n: int) -> torch.Tensor:
        out = torch.zeros((n,), dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx.long(), values)

    def wire_bytes(self, n: int) -> int:
        return self.k_of(n) * 8  # fp32 value + int32 index

    @property
    def name(self) -> str:
        return f"topk({self.k_frac})"


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


def compressed_reduce_scatter_int8(x: torch.Tensor, axis_name: str,
                                   codec: Int8Codec,
                                   dim: int) -> torch.Tensor:
    """Reduce-scatter ``x`` over ``axis_name`` along ``dim`` with int8 on
    the wire (tiled: member *i* keeps block *i* of the sum).  The whole
    local tensor is quantized and gathered and the sum formed locally, as
    in the reference (whose wire bytes ``CostModel`` prices); no error
    feedback, since a scattered leg's residual would belong to another
    shard each step."""
    n = prims.axis_size(axis_name)
    shp = x.shape
    assert shp[dim] % n == 0, (shp, dim, n)
    xf = x.reshape(-1)
    n0 = xf.shape[0]
    pad = (-n0) % codec.block
    q, s = codec.encode(F.pad(xf, (0, pad)) if pad else xf)
    qg = prims.all_gather_stacked(q, axis_name)  # (P, n) int8 on the wire
    sg = prims.all_gather_stacked(s, axis_name)  # (P, n/block) fp32
    full = codec.decode(qg, sg).sum(dim=0)[:n0].to(x.dtype).reshape(shp)
    blk = shp[dim] // n
    return full.narrow(dim, prims.axis_rank(axis_name) * blk, blk).contiguous()


def compressed_psum_topk(x: torch.Tensor, axis_name: str, codec: TopKCodec,
                         ef: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sum ``x`` over ``axis_name`` sending each member's top-k (values,
    indices); returns (the sum, the new EF state: what this member did not
    send, or None without ``ef``)."""
    if ef is not None:
        x = x + ef
    vals, idx = codec.encode(x)
    n = x.shape[0]
    new_ef = x - codec.decode(vals, idx, n) if ef is not None else None
    vg = prims.all_gather_stacked(vals, axis_name)  # (P, k)
    ig = prims.all_gather_stacked(idx, axis_name)  # (P, k)
    return combine_topk(vg, ig, n, x.dtype), new_ef


def combine_topk(values: torch.Tensor, idx: torch.Tensor, n: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The (n,) sum of P members' gathered top-k sets, values (P, k) and
    indices (P, k), added member by member in member order: no index
    repeats within a member, so each ``index_add_`` is free of collisions
    and the result is the same on every run and every rank."""
    out = torch.zeros((n,), dtype=dtype, device=values.device)
    for p in range(values.shape[0]):
        out.index_add_(0, idx[p].long(), values[p].to(dtype))
    return out


def make_codec(kind: Optional[str], **kw):
    if kind in (None, "none"):
        return None
    if kind == "int8":
        return Int8Codec(**{k: v for k, v in kw.items() if k in ("block",)})
    if kind == "topk":
        return TopKCodec(**{k: v for k, v in kw.items() if k in ("k_frac",)})
    raise ValueError(f"unknown codec {kind!r}")
