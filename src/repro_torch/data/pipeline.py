"""Sharded synthetic data pipeline with deterministic resume.

Two sources:
  * ``SyntheticLM`` — zipf-distributed tokens with a planted bigram
    structure (so small models show real loss curves, TinyStories-style),
  * ``UniformLM``   — uniform random tokens (throughput benchmarking).

The pipeline is *step-indexed*: batch(step) is a pure function of
(seed, step), so resuming from a checkpoint at step k reproduces the exact
stream without persisting cursors — the deterministic-resume property the
fault-tolerance tests assert.  Host sharding: each data-parallel host
materializes only its slice (``host_slice``), double-buffered onto device
via :class:`repro.core.staging_utils.StagingBuffers`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    kind: str = "synthetic"  # synthetic | uniform
    zipf_a: float = 1.2
    bigram_weight: float = 0.7  # structure strength (learnable signal)
    n_bigram_states: int = 64


class TokenPipeline:
    """Deterministic, step-indexed token batches."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig, cfg: DataConfig,
                 host_index: int = 0, host_count: int = 1):
        assert shape.global_batch % host_count == 0
        self.arch = arch
        self.shape = shape
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = shape.global_batch // host_count
        # planted bigram table (same on all hosts)
        rng = np.random.default_rng(cfg.seed)
        V = arch.vocab
        self._next_tok = rng.integers(0, V, size=(cfg.n_bigram_states,), dtype=np.int64)

    # -- pure function of (seed, step, host) ----------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        V = self.arch.vocab
        B, S = self.local_batch, self.shape.seq_len
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.host_index)
        if cfg.kind == "uniform":
            toks = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        else:
            # zipf base distribution, clipped into vocab
            base = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
            toks = np.minimum(base - 1, V - 1)
            # plant bigram structure: with prob bigram_weight the next token
            # is a deterministic function of the previous one
            follow = rng.random((B, S + 1)) < cfg.bigram_weight
            for t in range(1, S + 1):
                nxt = self._next_tok[toks[:, t - 1] % cfg.n_bigram_states]
                toks[:, t] = np.where(follow[:, t], nxt, toks[:, t])
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.arch.is_encdec:
            batch["frames"] = rng.standard_normal(
                (B, self.arch.encoder.n_frames, self.arch.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # -- state for checkpointing (trivially small, by design) -----------------
    def state_dict(self, step: int) -> Dict[str, Any]:
        return {"seed": self.cfg.seed, "step": step,
                "host_index": self.host_index, "host_count": self.host_count}

    @staticmethod
    def resume_step(state: Dict[str, Any]) -> int:
        return int(state["step"])
