"""Memory-pool analogues: in-place carries, staging, host offload — the
port of ``repro.core.staging_utils``.

The paper's memory pool (§4.1) exists so the NIC pool can DMA at its full
aggregate rate, and so compute nodes consume received data in place
(pass-by-reference, §4.3).  The reference maps these onto JAX; here each
takes PyTorch's idiom:

  * **pass-by-reference** → the reference's ``donated_jit``, a ``jax.jit``
    whose carry arguments are donated, has no torch form: there is no jit
    to donate to.  The port's steps update their carries in place instead
    (``train_loop``'s DFabric and GSPMD steps write each parameter block
    and moment where it lies; the error feedback is replaced by the
    codec's fresh residual), so no copy of the old state survives a step
    either, and the parameters and moments a step returns are the tensors
    it was given (``tests/test_torch_staging.py`` checks the data
    pointers).
  * **aggregate-HBM absorption** → ZeRO sharding of the optimizer state
    over the fast tiers (``optim.grad_sync``), as in the reference.
  * **added memory devices** → page-locked ("pinned") host memory, the
    twin of JAX's ``pinned_host`` memory kind (:func:`offload_placement`).
  * **the RX queue** → :class:`StagingBuffers`: pinned host slots, each
    copied to the device on a side stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch


def host_memory_kind_available() -> bool:
    """True if page-locked host memory can be had (it needs CUDA)."""
    if not torch.cuda.is_available():
        return False
    try:
        torch.empty(1, pin_memory=True)
    except RuntimeError:
        return False
    return True


@dataclass(frozen=True)
class Placement:
    """Where a tensor is made: ``device``, in page-locked memory when
    ``pinned`` (``device`` is then the CPU)."""

    device: torch.device
    pinned: bool = False

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device,
                           pin_memory=self.pinned)


def offload_placement(device, *, offload: bool) -> Placement:
    """The placement of optimizer state (the reference's
    ``offload_sharding``): pinned host memory when ``offload`` is asked
    for and pinned memory can be had (the paper's added memory devices),
    else ``device`` itself, as the reference degrades on a backend without
    ``pinned_host``."""
    if offload and host_memory_kind_available():
        return Placement(torch.device("cpu"), pinned=True)
    return Placement(torch.device(device))


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _signature(tree):
    return _map(lambda t: (tuple(t.shape), t.dtype), tree)


class StagingBuffers:
    """Round-robin host->device staging — the RX-queue analogue.

    ``put`` copies a host batch (an array, a tensor, or a dict tree of
    them) into the next of ``n_slots`` page-locked host slots and from
    there to ``device`` with ``non_blocking=True`` on a side stream, so
    the pipeline writes batch t+1 while step t consumes batch t; the
    current stream waits for the copy before it uses the result.  A slot
    is written again only once its last copy has finished.  On a CPU
    ``device`` the slot holds a copy of the batch.  ``_slots[i]`` is the
    last batch that slot ``i`` took, on the device."""

    def __init__(self, device, n_slots: int = 2):
        self.device = torch.device(device)
        self.n_slots = n_slots
        self._slots: list = [None] * n_slots
        self._host: list = [None] * n_slots  # pinned buffers, per slot
        self._done: list = [None] * n_slots  # the event of each slot's copy
        self._next = 0
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None)

    def put(self, host_batch: Any) -> Any:
        slot = self._next
        self._next = (self._next + 1) % self.n_slots
        host = _map(lambda x: torch.as_tensor(np.asarray(x))
                    if not isinstance(x, torch.Tensor) else x, host_batch)
        if self._stream is None:
            dev = _map(lambda t: t.to(self.device, copy=True), host)
        else:
            dev = self._put_cuda(slot, host)
        self._slots[slot] = dev
        return dev

    def _put_cuda(self, slot: int, host):
        if self._done[slot] is not None:
            self._done[slot].synchronize()  # its pinned buffers are free
        bufs = self._host[slot]
        if bufs is None or _signature(bufs) != _signature(host):
            bufs = _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True), host)
            self._host[slot] = bufs
        for buf, t in zip(_leaves(bufs), _leaves(host)):
            buf.copy_(t)
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = _map(lambda t: t.to(self.device, non_blocking=True), bufs)
            self._done[slot] = torch.cuda.Event()
            self._done[slot].record(self._stream)
        current.wait_stream(self._stream)
        for t in _leaves(dev):
            t.record_stream(current)  # made on the side stream, used here
        return dev
