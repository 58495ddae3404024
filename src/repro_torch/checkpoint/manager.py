"""Fault-tolerant checkpointing: async, atomic, elastic — the port of
``repro.checkpoint.manager``, writing and reading the same format.

Layout (one directory per step)::

    <root>/step_000100/
        index.json        # tree structure, shapes, dtypes, metadata
        arrays/<tree>__<path with / -> __>.npy   # one global array a leaf
    <root>/LATEST          # text file with the newest complete step dir

A checkpoint the JAX manager wrote restores here and one written here
restores in the JAX manager, bf16 leaves bit for bit
(``tests/test_torch_checkpoint.py``).  The port imports no ``ml_dtypes``:
a bf16 leaf crosses as its 16-bit payload.

  * **atomicity** — writes go to ``.tmp-step_X`` then ``os.replace``, and
    ``LATEST`` through ``.LATEST.tmp``, so a crash mid-save never corrupts
    the newest checkpoint;
  * **async** — the host snapshot (``.detach()`` to a CPU copy, numpy) is
    taken before :meth:`save` returns; only the file IO runs on a worker
    thread, which issues no collective;
  * **elastic restore** — :meth:`restore` returns *global* numpy arrays;
    the caller cuts and places its block (``Trainer.try_restore``), so the
    restoring job may run on another mesh;
  * **keep-K GC** that never deletes ``LATEST``'s target.

Unlike the reference, a manager's orphan sweep never removes the
``.tmp-step_*`` dir of a write still pending in this process (a restarted
trainer in the same process would otherwise delete the dead trainer's
in-flight save; ROADMAP.md queue 3, item 1).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.trees import tree_from_paths, tree_paths

#: the ``.tmp-step_*`` dirs of writes pending in this process (absolute
#: paths), which no manager's sweep may remove
_LIVE_WRITES: set = set()
_LIVE_LOCK = threading.Lock()


def _sanitize(path: str) -> str:
    return path.replace("/", "__")


#: how a bf16 leaf lies in an array file: its 16-bit payload as a 2-byte
#: void, which is what ``np.save`` writes for the reference's
#: ``ml_dtypes.bfloat16`` arrays; ``index.json`` names it ``"bfloat16"``
BF16_FILE_DTYPE = np.dtype("V2")


def _host_copy(v) -> np.ndarray:
    """A host snapshot of one leaf that later in-place updates of ``v`` do
    not reach: a copy of a tensor (the CPU ones too), the array itself for
    numpy and Python scalars (as the reference's ``device_get``).  A bf16
    tensor becomes its 16-bit payload (``BF16_FILE_DTYPE``)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_FILE_DTYPE)
        return t.numpy()
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array, as JAX saves it
        return arr.view(BF16_FILE_DTYPE)
    return arr


def owned_host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor that nothing else holds as a numpy array over the same
    memory (a bf16 one as its 16-bit payload): what ``save`` keeps as it
    is, with no second copy."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_FILE_DTYPE)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    """The dtype ``index.json`` records: the reference's ``str(dtype)``,
    ``"bfloat16"`` for a bf16 payload."""
    return "bfloat16" if arr.dtype == BF16_FILE_DTYPE else str(arr.dtype)


class CheckpointManager:
    """``read_only`` (the port's multi-rank use): a member that only
    restores — it sweeps nothing, starts no worker, and cannot save."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True, *,
                 read_only: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.read_only = read_only
        #: one record a save: step, bytes, snapshot_s (in ``save``) and
        #: write_s (on the worker, once the write is done)
        self.stats: List[Dict[str, float]] = []
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self._pool = None
        if read_only:
            return
        os.makedirs(root, exist_ok=True)
        self._sweep_orphans()
        self._pool = ThreadPoolExecutor(max_workers=1)

    def _sweep_orphans(self) -> None:
        """Remove ``.tmp-step_*`` dirs (and a stale ``.LATEST.tmp``) left
        by a crash mid-save — but not the dir of a write pending in this
        process, which is alive and will rename it."""
        with _LIVE_LOCK:
            for d in os.listdir(self.root):
                path = os.path.abspath(os.path.join(self.root, d))
                if d.startswith(".tmp-step_") and path not in _LIVE_WRITES:
                    shutil.rmtree(path, ignore_errors=True)
            tmp_latest = os.path.join(self.root, ".LATEST.tmp")
            if os.path.exists(tmp_latest) and not any(
                    os.path.dirname(p) == os.path.abspath(self.root)
                    for p in _LIVE_WRITES):
                os.remove(tmp_latest)

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, trees: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None,
             blocking: bool = False) -> None:
        """``trees``: {'params': ..., 'opt': ..., 'data_state': {...}}, each
        a dict tree (or one leaf) of tensors, numpy arrays or scalars."""
        if self.read_only:
            raise RuntimeError("a read-only CheckpointManager cannot save")
        t0 = time.perf_counter()
        # snapshot to host memory *now* (values at this step)
        host: Dict[str, Dict[str, np.ndarray]] = {}
        for name, tree in trees.items():
            flat = tree_paths(tree) if isinstance(tree, dict) else {"__leaf__": tree}
            host[name] = {k: _host_copy(v) for k, v in flat.items()}
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0,
               "bytes": sum(v.nbytes for flat in host.values()
                            for v in flat.values())}
        tmp = os.path.join(self.root, f".tmp-step_{step:08d}")
        live = os.path.abspath(tmp)

        def write():
            t1 = time.perf_counter()
            try:
                final = os.path.join(self.root, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(os.path.join(tmp, "arrays"))
                index = {"step": step, "metadata": metadata or {}, "trees": {}}
                for name, flat in host.items():
                    entries = {}
                    for k, v in flat.items():
                        fname = f"{name}__{_sanitize(k)}.npy"
                        np.save(os.path.join(tmp, "arrays", fname), v)
                        entries[k] = {"file": fname, "shape": list(v.shape),
                                      "dtype": _dtype_name(v)}
                    index["trees"][name] = entries
                with open(os.path.join(tmp, "index.json"), "w") as f:
                    json.dump(index, f, indent=1)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                with open(os.path.join(self.root, ".LATEST.tmp"), "w") as f:
                    f.write(os.path.basename(final))
                os.replace(os.path.join(self.root, ".LATEST.tmp"),
                           os.path.join(self.root, "LATEST"))
                self._gc()
                rec["write_s"] = time.perf_counter() - t1
            finally:
                with _LIVE_LOCK:
                    _LIVE_WRITES.discard(live)

        self.wait()
        self.stats.append(rec)
        with _LIVE_LOCK:
            _LIVE_WRITES.add(live)
        if self.async_save and not blocking:
            with self._lock:
                self._pending = self._pool.submit(write)
        else:
            write()

    def wait(self) -> None:
        with self._lock:
            if self._pending is None:
                return
            try:
                self._pending.result()
            finally:
                # clear even when the write failed — a sticky pending
                # future would re-raise the same exception from every
                # later save()/wait() and block checkpointing forever
                self._pending = None

    def close(self, wait: bool = True) -> None:
        """Drain the pending write (re-raising its failure) and shut the
        worker thread down.  The manager is unusable afterwards."""
        try:
            if wait:
                self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=wait)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except Exception:
                pass  # don't mask the exception already unwinding
        return False

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        # Never delete the step LATEST points at: with a small `keep`
        # and out-of-order saves the pointer's target need not be among
        # the keep newest dirs, and deleting it would break restore().
        latest = None
        try:
            with open(os.path.join(self.root, "LATEST")) as f:
                latest = f.read().strip()
        except OSError:
            pass
        steps = sorted(d for d in os.listdir(self.root) if d.startswith("step_"))
        for d in steps[:-self.keep]:
            if d == latest:
                continue
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # ---- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.root, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.root, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: Optional[int] = None,
                mmap: bool = False) -> Optional[Dict[str, Any]]:
        """Returns {'__step__', '__metadata__', 'params': tree of global
        numpy arrays, ...}, or None if there is no checkpoint (or no
        checkpoint of the explicit ``step``).  A bf16 leaf comes back as
        the reference's ``np.load`` gives it, its 16-bit payload as a
        2-byte void array, which ``convert.numpy_to_torch`` reads as
        bf16.  With ``mmap`` the arrays are read-only memory maps of the
        files, so that a member that keeps a block of each reads only
        that."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        cdir = os.path.join(self.root, f"step_{step:08d}")
        index_path = os.path.join(cdir, "index.json")
        if not os.path.exists(index_path):
            return None  # explicit step missing: "None if no checkpoint"
        with open(index_path) as f:
            index = json.load(f)
        out: Dict[str, Any] = {"__step__": index["step"],
                               "__metadata__": index["metadata"]}
        for name, entries in index["trees"].items():
            flat = {k: np.load(os.path.join(cdir, "arrays", meta["file"]),
                               mmap_mode="r" if mmap else None)
                    for k, meta in entries.items()}
            out[name] = (tree_from_paths(flat) if "__leaf__" not in flat
                         else flat["__leaf__"])
        return out
