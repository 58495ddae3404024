"""Serving runtime: batched decode with continuous batching — the port of
``repro.runtime.serve_loop``.

A fixed pool of batch slots decodes in lock-step (the slots share one
position counter); finished sequences are swapped for queued requests
between decode steps ("continuous batching lite").  The KV cache is
preallocated at ``max_seq`` and written in place.

As in the JAX server, admission writes only a request's last prompt token
into its slot: there is no prompt prefill here.  That is the reference's
behaviour, which the port keeps; so an encoder-decoder (whisper) runs no
encoder here and decodes against a zeroed cross-attention cache of the
config's frame count, as the reference's server does.

Over a mesh (a bound ``prims.Mesh`` in place of the device; one server a
rank) the model is cut by ``Model.shard`` under ``mesh_info(sizes)``, as
the JAX server lays out its parameters by ``param_specs(mesh_info(mesh))``,
and the cache is each member's block under ``cache_specs``.  Each DP
member decodes its rows of the slots (``_dp_spec``'s split), or every
slot where the slots do not divide the DP members, the cache's sequence
then split.  Every rank runs the same admission over the same queue, and
the sampled tokens are gathered over the DP axes after each step, so that
every member's ``outputs`` and ``stats`` are equal; sampling with
``temperature > 0`` draws from one generator, seeded alike on every
member, over the gathered logits.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import prims
from repro_torch.models.registry import Model, resolve_device
from repro_torch.obs.metrics import MetricsLogger
from repro_torch.runtime.train_loop import dp_rank, mesh_info
from repro_torch.utils.stats import percentile


@dataclass
class Request:
    """One serving request.  ``priority`` is the admission weight (used
    by :func:`priority_admission`; plain FIFO ignores it).  The server
    fills the timing fields: ``submit_t`` at :meth:`DecodeServer.submit`,
    ``ttft_s`` when the first token lands (queueing included), and
    ``token_s`` with one inter-token interval per generated token (the
    first entry IS the TTFT)."""

    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 32
    priority: float = 1.0
    generated: List[int] = field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    ttft_s: Optional[float] = None
    token_s: List[float] = field(default_factory=list)


def fifo_admission(queue: List[Request]) -> int:
    """The default admission policy: first come, first served."""
    return 0


def priority_admission(queue: List[Request]) -> int:
    """Admit the highest-priority queued request; FIFO among equals."""
    return max(range(len(queue)), key=lambda i: (queue[i].priority, -i))


class DecodeServer:
    """``mesh``: a bound ``prims.Mesh`` of which this rank is a member (the
    model is cut for it and decodes on its own device), or a device, which
    takes the place of the JAX server's mesh on one member (the model is
    moved there and decodes there).  Greedy decoding takes the argmax;
    ``temperature > 0`` samples from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, model: Model, mesh="cuda", *, batch_slots: int = 4,
                 max_seq: int = 128, temperature: float = 0.0, seed: int = 0,
                 metrics: Optional[MetricsLogger] = None,
                 admission: Optional[Callable[[List[Request]], int]] = None):
        self.mesh = mesh if isinstance(mesh, prims.Mesh) else None
        self.model = model
        self.rows = slice(0, batch_slots)  # this member's slots
        self.dp: tuple = ()  # the DP axes over which the slots split
        if self.mesh is None:
            self.device = resolve_device(mesh)
        else:
            self.device = model.device
            layout = model.shard(mesh_info(self.mesh.sizes), self.mesh.sizes,
                                 self.mesh.coords)
            n = layout.dp_total
            if batch_slots % n == 0:
                b, r = batch_slots // n, dp_rank(self.mesh)
                self.rows = slice(r * b, (r + 1) * b)
                self.dp = tuple(a for a in layout.dp_axes if layout.split(a))
        self.metrics = metrics or MetricsLogger(echo=False, run="serve")
        # admission picks WHICH queued request takes a freed slot (an
        # index into the queue); FIFO unless told otherwise
        self.admission = admission or fifo_admission
        self.B, self.S = batch_slots, max_seq
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.all_requests: List[Request] = []
        self.stats = {"tokens": 0, "steps": 0, "wall": 0.0}
        self._last_emit: Dict[int, float] = {}  # uid -> last token wall time

    # ---- admission --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submit_t = time.perf_counter()
        self.queue.append(req)
        self.all_requests.append(req)

    def _admit(self, tokens: np.ndarray) -> np.ndarray:
        """Fill empty slots from the queue; the ``admission`` policy picks
        which queued request each freed slot takes.  Only the prompt's last
        token enters the slot (the reference's lock-step behaviour)."""
        for b in range(self.B):
            if self.active[b] is None and self.queue:
                i = int(self.admission(self.queue))
                if not 0 <= i < len(self.queue):
                    raise ValueError(
                        f"admission policy returned index {i} for a queue "
                        f"of {len(self.queue)}")
                req = self.queue.pop(i)
                self.active[b] = req
                tokens[b, 0] = int(req.prompt[-1])
        return tokens

    # ---- main loop -----------------------------------------------------------------
    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of ``x`` from the DP members' (slowest axis
        major, the rows' order)."""
        for a in reversed(self.dp):
            x = prims.all_gather_tiled(x, a, 0)
        return x

    def _step(self, cache, tokens: np.ndarray, pos: int):
        """One decode step of this member's slots; (every slot's next token
        as numpy, the cache)."""
        toks = torch.from_numpy(tokens[self.rows]).to(self.device)
        if self.mesh is None:
            logits, cache = self.model.decode_step(cache, toks, pos)
        else:
            logits, cache = self.model.decode_step(cache, toks, pos, batch=self.B,
                                                   max_seq=self.S)
        if self.temperature > 0:
            probs = torch.softmax(self._gather_rows(logits) / self.temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = self._gather_rows(torch.argmax(logits, dim=-1))
        return nxt.cpu().numpy(), cache

    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        if self.mesh is not None:
            with prims.bind(self.mesh):
                return self._run(max_steps)
        self.model.to(self.device)
        return self._run(max_steps)

    def _run(self, max_steps: int) -> Dict[int, List[int]]:
        cache = self.model.init_cache(self.B, self.S)
        tokens = self._admit(np.zeros((self.B, 1), np.int64))
        t0 = time.perf_counter()
        for pos in range(min(max_steps, self.S - 1)):
            if not any(self.active):
                break
            nxt_np, cache = self._step(cache, tokens, pos)
            now = time.perf_counter()
            self.stats["steps"] += 1
            self.metrics.inc("decode_steps")
            for b, req in enumerate(self.active):
                if req is None:
                    continue
                req.generated.append(int(nxt_np[b]))
                # per-token latency; the first interval (measured from
                # submit, queueing included) is the request's TTFT
                last = self._last_emit.get(req.uid, req.submit_t)
                req.token_s.append(now - last)
                self._last_emit[req.uid] = now
                if req.ttft_s is None:
                    req.ttft_s = now - req.submit_t
                    self.metrics.log("first_token", uid=req.uid,
                                     ttft_s=req.ttft_s)
                self.stats["tokens"] += 1
                self.metrics.inc("tokens")
                if len(req.generated) >= req.max_new:
                    req.done = True
                    self.active[b] = None
                    self.metrics.log("request_done", uid=req.uid,
                                     generated=len(req.generated),
                                     ttft_s=req.ttft_s,
                                     tpot_s=sum(req.token_s[1:])
                                     / max(len(req.token_s) - 1, 1))
            tokens = self._admit(nxt_np[:, None].astype(np.int64))
        self.stats["wall"] = time.perf_counter() - t0
        self.metrics.gauge("tokens_per_s", self.throughput())
        self.metrics.log("serve_run", **self.stats, **self.latency_summary())
        return {r.uid: r.generated for r in self.all_requests}

    def latency_summary(self) -> Dict[str, float]:
        """p50/p99 TTFT and per-token latency over every request that
        produced tokens (truncated requests included — their tail
        matters most); empty when nothing decoded."""
        ttfts = [r.ttft_s for r in self.all_requests if r.ttft_s is not None]
        tpots = [s for r in self.all_requests for s in r.token_s[1:]]
        out: Dict[str, float] = {}
        if ttfts:
            out["ttft_p50_s"] = percentile(ttfts, 50)
            out["ttft_p99_s"] = percentile(ttfts, 99)
        if tpots:
            out["tpot_p50_s"] = percentile(tpots, 50)
            out["tpot_p99_s"] = percentile(tpots, 99)
        return out

    def throughput(self) -> float:
        return self.stats["tokens"] / max(self.stats["wall"], 1e-9)
