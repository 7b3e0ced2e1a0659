"""Phase timers — the ark_std start_timer!/end_timer! role, the
counterpart of the JAX package's utils/timers.py (PhaseTimings, phase).

The reference wraps every proof phase in wall-clock scopes gated by its
`print-trace` feature (groth16/examples/sha256.rs:42-91). Here: a context
manager that records into a PhaseTimings and, when DG16_TRACE is set,
logs Start:/End: lines. The JAX package's phases are also spans, feed a
job_phase_seconds histogram and log through its logbus; those come with
the port's telemetry plane.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from . import config as _config

log = logging.getLogger("distributed_groth16_tpu_torch")


def trace_enabled() -> bool:
    return _config.env_flag("DG16_TRACE", False)


def _emit(msg: str, *args) -> None:
    """INFO log; to stderr when no logging is configured anywhere, so
    DG16_TRACE output stays visible."""
    if log.hasHandlers():
        log.info(msg, *args)
    else:
        print(msg % args, file=sys.stderr, flush=True)


@dataclass
class PhaseTimings:
    """Collected {phase: seconds} for one operation (e.g. one proof).
    `record` may be hit from several threads at once, so a lock keeps
    each phase bucket's read-modify-write atomic."""

    phases: dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds

    def snapshot(self) -> dict[str, float]:
        """Consistent copy of the phase map."""
        with self._lock:
            return dict(self.phases)

    def as_millis(self) -> dict[str, float]:
        return {k: round(v * 1e3, 3) for k, v in self.snapshot().items()}


@contextmanager
def phase(name: str, timings: PhaseTimings | None = None):
    """with phase("Compute A", timings): ... — records the block's wall
    seconds into `timings` when given, and logs Start:/End: lines when
    DG16_TRACE is set. Host clock: a caller timing device work drains the
    device inside the block."""
    emit = trace_enabled()
    if emit:
        _emit("Start: %s", name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if timings is not None:
            timings.record(name, dt)
        if emit:
            _emit("End: %s — %.3f ms", name, dt * 1e3)
