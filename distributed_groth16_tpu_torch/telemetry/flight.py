"""Flight recorder: a bounded ring of recent telemetry, dumped on faults.

A chaos-suite failure (or a production peer death at hour three of a 2^20
proof) used to leave only a stack trace; the *lead-up* — the last
collectives, the last frames, the fault counters — was gone. The flight
recorder keeps a bounded in-memory ring of

  * recent finished spans (installed as a tracing sink, so it sees the
    same events every other buffer sees),
  * recent net events (`note("peer_death", peer=3, ...)` — prodnet's
    lifecycle/fault path calls in),

and on a fault trigger (peer death, round-retry exhaustion — the transport's fault
machinery) writes one JSON post-mortem artifact to `DG16_FLIGHT_DIR`:
reason, the rings, and a full metric-registry snapshot (every fault
counter included). Dumps are rate-limited per trigger so a death cascade
across n-1 peers costs n files, not a disk flood.

Enabled iff `DG16_FLIGHT_DIR` is set (or `configure(dir)`); with it off,
`note()` / `dump()` are attribute-check no-ops and the span hot path is
untouched (docs/OBSERVABILITY.md zero-overhead contract).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import metrics as _tm
from . import tracing as _tracing
from ..utils import config as _config

_REG = _tm.registry()
_DUMPS = _REG.counter(
    "flight_dumps_total", "Flight-recorder post-mortems written, per trigger",
    ("trigger",),
)
_SUPPRESSED = _REG.counter(
    "flight_dumps_suppressed_total",
    "Post-mortems skipped past the per-trigger cap, per trigger",
    ("trigger",),
)
_FAILED = _REG.counter(
    "flight_dump_failures_total",
    "Post-mortem writes that failed (unwritable DG16_FLIGHT_DIR), "
    "per trigger",
    ("trigger",),
)

_recorder: "FlightRecorder | None" = None
_lock = threading.Lock()


class FlightRecorder:
    """Bounded rings of recent spans + net events, dumpable as JSON."""

    def __init__(
        self,
        directory: str,
        max_spans: int = 512,
        max_net_events: int = 256,
        max_dumps_per_trigger: int = 16,
    ):
        self.directory = directory
        self._lock = threading.Lock()
        self._spans: deque[dict] = deque(maxlen=max_spans)
        self._net: deque[dict] = deque(maxlen=max_net_events)
        self._seq = 0
        # the docstring's rate limit: a flapping peer on a long-lived
        # service must cost a bounded number of post-mortems, not a disk
        # flood — after the cap, dumps of that trigger are counted
        # (flight_dumps_suppressed_total) but not written
        self.max_dumps_per_trigger = max_dumps_per_trigger
        self._dumps_by_trigger: dict[str, int] = {}

    # -- tracing sink protocol (same .add(ev) as TraceBuffer) ---------------

    def add(self, ev: dict) -> None:
        with self._lock:
            self._spans.append(ev)

    # -- net events ----------------------------------------------------------

    def note(self, kind: str, **fields) -> None:
        """Append one net/lifecycle event to the ring (cheap: dict +
        deque append under a lock; only ever called when enabled)."""
        ev = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            self._net.append(ev)

    # -- the post-mortem -----------------------------------------------------

    def dump(
        self,
        trigger: str,
        party: int | None = None,
        extra: dict | None = None,
    ) -> str | None:
        """Write one post-mortem JSON file; returns its path (None if the
        write failed or the per-trigger cap is exhausted — the recorder
        must never turn a fault into a second fault, nor a fault storm
        into a disk flood)."""
        with self._lock:
            if (
                self._dumps_by_trigger.get(trigger, 0)
                >= self.max_dumps_per_trigger
            ):
                _SUPPRESSED.labels(trigger=trigger).inc()
                return None
            self._seq += 1
            seq = self._seq
            spans = list(self._spans)
            net = list(self._net)
        # HBM state at dump time (telemetry/devmem.py; None-valued per
        # device on XLA:CPU) — an OOM post-mortem must say how full the
        # device was, not just which Python frame died
        from . import devmem as _devmem
        from . import logbus as _logbus

        record = {
            "trigger": trigger,
            "wallTime": time.time(),
            "party": party,
            "osPid": os.getpid(),
            "seq": seq,
            "extra": extra or {},
            "netEvents": net,
            "spans": spans,
            "deviceMemory": _devmem.snapshot(),
            "metrics": _tm.registry().snapshot(),
            # the structured log tail (telemetry/logbus.py): what the
            # process SAID in the lead-up, correlated by trace/job ids —
            # empty when the spine never saw a record
            "logs": _logbus.tail(256),
        }
        name = f"flight-p{party if party is not None else 'x'}-" \
               f"{os.getpid()}-{seq}-{trigger}.json"
        path = os.path.join(self.directory, name)
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(path, "w") as f:
                json.dump(record, f)
        except OSError:
            # a failed write must not burn the per-trigger cap — an
            # unwritable directory may become writable again (disk-full
            # resolved) and a later real fault still deserves its dump
            _FAILED.labels(trigger=trigger).inc()
            return None
        with self._lock:
            self._dumps_by_trigger[trigger] = (
                self._dumps_by_trigger.get(trigger, 0) + 1
            )
        _DUMPS.labels(trigger=trigger).inc()
        return path


def configure(directory: str) -> FlightRecorder:
    """Install the process flight recorder writing into `directory` (the
    DG16_FLIGHT_DIR knob, testable). Replaces any previous recorder."""
    global _recorder
    with _lock:
        if _recorder is not None:
            _tracing.remove_sink(_recorder)
        _recorder = FlightRecorder(directory)
        _tracing.add_sink(_recorder)
        return _recorder


def disable() -> None:
    global _recorder
    with _lock:
        if _recorder is not None:
            _tracing.remove_sink(_recorder)
        _recorder = None


def recorder() -> FlightRecorder | None:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def note(kind: str, **fields) -> None:
    """Module-level convenience: record a net event iff enabled."""
    r = _recorder
    if r is not None:
        r.note(kind, **fields)


def dump(
    trigger: str, party: int | None = None, extra: dict | None = None
) -> str | None:
    """Module-level convenience: write a post-mortem iff enabled."""
    r = _recorder
    if r is not None:
        return r.dump(trigger, party=party, extra=extra)
    return None


def dump_soon(
    trigger: str, party: int | None = None, extra: dict | None = None
) -> None:
    """dump() off the caller's thread when an event loop is running —
    the pump's _fail_peer path must not stall heartbeats for every OTHER
    peer behind a slow disk, turning one fault into several. Falls back
    to a synchronous write outside a loop."""
    r = _recorder
    if r is None:
        return
    import asyncio

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        r.dump(trigger, party=party, extra=extra)
        return
    loop.run_in_executor(
        None, lambda: r.dump(trigger, party=party, extra=extra)
    )


def configure_from_env() -> None:
    """Honor DG16_FLIGHT_DIR: install the recorder pointed at it."""
    d = _config.env_str("DG16_FLIGHT_DIR")
    if d:
        configure(d)


configure_from_env()
