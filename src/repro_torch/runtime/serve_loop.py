"""Serving runtime: batched decode with continuous batching — the port of
``repro.runtime.serve_loop``.

A fixed pool of batch slots decodes in lock-step (the slots share one
position counter); finished sequences are swapped for queued requests
between decode steps ("continuous batching lite").  The KV cache is
preallocated at ``max_seq`` and written in place.

As in the JAX server, admission writes only a request's last prompt token
into its slot: there is no prompt prefill here.  That is the reference's
behaviour, which the port keeps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import Model, resolve_device
from repro_torch.obs.metrics import MetricsLogger
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
    """``device`` takes the place of the JAX server's mesh: the model is
    moved there and decodes there.  Greedy decoding takes the argmax;
    ``temperature > 0`` samples from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, model: Model, device="cuda", *, batch_slots: int = 4,
                 max_seq: int = 128, temperature: float = 0.0, seed: int = 0,
                 metrics: Optional[MetricsLogger] = None,
                 admission: Optional[Callable[[List[Request]], int]] = None):
        self.device = resolve_device(device)
        self.model = model
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
    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        self.model.to(self.device)
        cache = self.model.init_cache(self.B, self.S)
        tokens = self._admit(np.zeros((self.B, 1), np.int64))
        t0 = time.perf_counter()
        for pos in range(min(max_steps, self.S - 1)):
            if not any(self.active):
                break
            logits, cache = self.model.decode_step(
                cache, torch.from_numpy(tokens).to(self.device), pos)
            if self.temperature > 0:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt_np = nxt.cpu().numpy()
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
