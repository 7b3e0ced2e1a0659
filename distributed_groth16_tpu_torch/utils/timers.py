"""Phase timers — the ark_std start_timer!/end_timer! role, the
counterpart of the JAX package's utils/timers.py, which this module copies
but for the package logger's name.

The reference wraps every proof phase in wall-clock scopes gated by the
`print-trace` feature ("MSM operations", "Compute A", ... —
groth16/examples/sha256.rs:42-91) and reports `time_taken` in API responses
(common/src/dto/mod.rs:53-55). Here: a context manager + registry, gated by
the DG16_TRACE env var, with structured access so the service layer can
report per-phase timings.

`phase()` is a thin wrapper over `telemetry.tracing.span()`: the span
records into the given PhaseTimings on exit, so a phase shows up in the
per-job trace timeline, the `job_phase_seconds{phase=}` histogram and the
phase map from one clock read. Host clock: a caller timing device work
drains the device inside the block.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..telemetry import logbus as _logbus
from ..telemetry import metrics as _metrics
from ..telemetry import tracing as _tracing
from . import config as _config

log = logging.getLogger("distributed_groth16_tpu_torch")

_JOB_PHASE_SECONDS = _metrics.registry().histogram(
    "job_phase_seconds",
    "Wall-clock seconds of one recorded proof phase",
    ("phase",),
)


def trace_enabled() -> bool:
    return _config.env_flag("DG16_TRACE", False)


def _emit(msg: str, *args) -> None:
    """Exactly-once INFO log; when logging is unconfigured everywhere,
    install the logbus console handler instead of a raw print so
    DG16_TRACE output stays visible AND lands in the structured ring.

    When BOTH a package CONSOLE handler and the root logger's handlers
    would print, `log.info` would print twice (once via the package
    handlers, once via propagation to root) — in that case the package
    handlers win and the record is handed to them directly, bypassing
    propagation. The spine's ring handler does not count: it never
    writes a terminal, so ring + root is not a double print. If every
    package handler rejects the record (level), fall through to the
    normal path: they reject it there too and root prints it once."""
    root = logging.getLogger()
    printers = [
        h for h in log.handlers
        if not isinstance(h, _logbus.LogBusHandler)
    ]
    if printers and log.propagate and root.handlers:
        if not log.isEnabledFor(logging.INFO):
            return
        record = log.makeRecord(
            log.name, logging.INFO, __file__, 0, msg, args, None
        )
        if not log.filter(record):
            return
        # the double-print question is decided by PRINTERS only: if none
        # accepts the record, fall through so root prints it once (the
        # ring handler would swallow it here and drop it from the console)
        if any(record.levelno >= h.level for h in printers):
            for h in log.handlers:
                if record.levelno >= h.level:
                    h.handle(record)
            return
    if log.handlers or root.handlers:
        log.info(msg, *args)
        return
    _logbus.setup(console=True)
    log.info(msg, *args)


@dataclass
class PhaseTimings:
    """Collected {phase: seconds} for one operation (e.g. one proof).

    The service layer's worker pool hands one instance to each job but
    merges them all into one service-wide aggregate for `/stats`, so both
    `record` and `merge` may be hit from several worker threads at once —
    a lock keeps the read-modify-write on each phase bucket atomic.
    """

    phases: dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds

    def merge(self, other: "PhaseTimings") -> "PhaseTimings":
        """Fold `other`'s phases into self (summing shared names) —
        the `/stats` aggregation primitive. Returns self for chaining."""
        for name, seconds in other.snapshot().items():
            self.record(name, seconds)
        return self

    def snapshot(self) -> dict[str, float]:
        """Consistent copy of the phase map."""
        with self._lock:
            return dict(self.phases)

    def as_millis(self) -> dict[str, float]:
        return {k: round(v * 1e3, 3) for k, v in self.snapshot().items()}


@contextmanager
def phase(name: str, timings: PhaseTimings | None = None):
    """with phase("Compute A"): ... — prints when DG16_TRACE is set,
    records into `timings` when given (via the span's exit hook), and
    shows up as a span on any active trace buffer."""
    emit = trace_enabled()
    if emit:
        _emit("Start: %s", name)
    t0 = time.perf_counter()
    try:
        with _tracing.span(name, timings=timings):
            yield
    finally:
        dt = time.perf_counter() - t0
        if timings is not None:
            _JOB_PHASE_SECONDS.labels(phase=name).observe(dt)
        if emit:
            _emit("End: %s — %.3f ms", name, dt * 1e3)
