"""A tiny dependency-free metrics logger: counters / gauges / timers → JSONL.

One :class:`MetricsLogger` per run.  Events are appended to a JSONL file
as they happen (``path=None`` keeps the logger in-memory only — every
call still works, nothing is written), human-readable lines go through
:meth:`info` (stdout by default), and the accumulated counters/gauges are
flushed as one ``summary`` record on :meth:`close`.  Stdlib only — the
runtime loops and benchmarks must not grow a telemetry dependency.  A copy
of ``repro.obs.metrics``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, TextIO, Union


def _jsonable(v):
    """Coerce numpy / torch scalars (anything float()-able) for json."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


_GIT_SHA_CACHE: Dict[str, str] = {}


def git_sha(repo_dir: Optional[str] = None, short: int = 12) -> str:
    """The current commit's SHA, for stamping artifacts with provenance.

    Reads ``.git/HEAD`` directly (fast, no subprocess) and falls back to
    ``git rev-parse`` for packed refs / worktrees; ``"unknown"`` outside a
    repository.  Cached per directory."""
    root = os.path.abspath(repo_dir or os.getcwd())
    if root in _GIT_SHA_CACHE:
        return _GIT_SHA_CACHE[root]
    sha = "unknown"
    d = root
    while True:
        head = os.path.join(d, ".git", "HEAD")
        if os.path.exists(head):
            try:
                with open(head) as f:
                    ref = f.read().strip()
                if ref.startswith("ref:"):
                    ref_path = os.path.join(d, ".git", ref[4:].strip())
                    if os.path.exists(ref_path):
                        with open(ref_path) as f:
                            sha = f.read().strip()
                else:
                    sha = ref
            except OSError:
                pass
            break
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    if sha == "unknown":
        try:
            sha = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=root, text=True,
                capture_output=True, timeout=10).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            sha = "unknown"
    sha = sha[:short] if sha != "unknown" else sha
    _GIT_SHA_CACHE[root] = sha
    return sha


class MetricsLogger:
    """Counters, gauges, timers and structured events, JSONL on disk.

    ``path`` is the JSONL sink (parent directories are created; None =
    in-memory only).  ``echo`` is where :meth:`info` renders
    human-readable lines: ``True`` (default) = ``sys.stdout``, ``False``
    = silent (the structured record is still kept), or any text stream.
    ``run`` / extra ``meta`` are stamped on every record so concatenated
    logs stay attributable.
    """

    def __init__(self, path: Optional[str] = None,
                 echo: Union[bool, TextIO] = True,
                 run: Optional[str] = None, **meta):
        self.path = path
        # True is kept symbolic: sys.stdout resolves at info() time, so
        # stream redirection (pytest capture) after construction works
        self.echo: Union[bool, TextIO] = False if echo is False else echo
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.records: List[dict] = []  # in-memory mirror (tests, describe)
        self._meta = dict(meta)
        if run is not None:
            self._meta["run"] = run
        self._fh: Optional[TextIO] = None
        self._t0 = time.monotonic()
        if path:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    # ---- structured events -------------------------------------------------
    def log(self, event: str, **fields) -> dict:
        rec = {"t": round(time.monotonic() - self._t0, 9), "event": event}
        rec.update(self._meta)
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def info(self, msg: str, **fields) -> None:
        """A human-readable line: rendered to ``echo`` verbatim AND kept
        as a structured ``info`` record."""
        if self.echo is not False:
            print(msg, file=sys.stdout if self.echo is True else self.echo)
        self.log("info", msg=msg, **fields)

    # ---- counters / gauges / timers ---------------------------------------
    def inc(self, name: str, value: float = 1.0) -> float:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)
        return self.counters[name]

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    @contextmanager
    def timer(self, name: str, **fields) -> Iterator[None]:
        """Times the with-block: accumulates ``<name>_s`` as a counter and
        logs one ``timer`` record."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.inc(f"{name}_s", dt)
            self.inc(f"{name}_n", 1.0)
            self.log("timer", name=name, seconds=dt, **fields)

    # ---- lifecycle ---------------------------------------------------------
    def summary(self) -> dict:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges)}

    def close(self) -> None:
        if self.counters or self.gauges:
            self.log("summary", **{f"c:{k}": v
                                   for k, v in self.counters.items()},
                     **{f"g:{k}": v for k, v in self.gauges.items()})
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
