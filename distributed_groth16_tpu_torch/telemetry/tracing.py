"""Lightweight nested spans + Chrome trace-event export.

The observability spine's timeline half (docs/OBSERVABILITY.md): a span is
a named wall-clock scope (`with span("prove.A", party=net.party_id): ...`)
that nests via a contextvar — so the parent chain survives asyncio task
fan-out (tasks copy the context at creation) and `asyncio.to_thread` /
`asyncio.run` boundaries, which is exactly the shape of a distributed
proof: service worker thread -> in-process MPC round -> per-party tasks ->
per-channel collectives.

Recording targets, in precedence order (a span records into every active
one):

  * a per-proof `TraceBuffer` installed with `collect(buf)` — the service
    layer gives each job its own, surfaced as the span tree in
    `GET /jobs/{id}`;
  * the process-global buffer enabled by `DG16_TRACE_OUT=trace.json` (or
    `enable_global(path)` / million.py's `--trace-out`), dumped as Chrome
    trace-event JSON at exit (atexit) or via `flush_global()` — open it in
    chrome://tracing or Perfetto and the whole proof renders as a
    timeline, one track per (party, task).

Zero overhead when idle: with no buffer installed and no `timings` sink,
`span()` returns a shared no-op singleton — no allocation, no clock read.
Keyword args are fixed parameters (not **kwargs) for the same reason.
Events use the complete-event form (`"ph": "X"`) with perf_counter
microsecond timestamps; `pid` is the MPC party id, `tid` the asyncio task
(or OS thread), so concurrent parties and overlapped channels land on
separate tracks.
"""

from __future__ import annotations

import asyncio
import atexit
import itertools
import json
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar

from ..utils import config as _config

_CURRENT: ContextVar["Span | None"] = ContextVar("dg16_span", default=None)
_BUFFER: ContextVar["TraceBuffer | None"] = ContextVar(
    "dg16_trace_buffer", default=None
)
_IDS = itertools.count(1)

_global_buffer: "TraceBuffer | None" = None
_global_path: str | None = None

# Rarely-installed extra recording targets (the aggregation buffer of
# telemetry/aggregate.py, the flight-recorder ring of telemetry/flight.py).
# A tuple, rebuilt on (un)install, so the idle fast path stays one truthy
# check — `span()` must remain allocation-free with nothing installed.
_extra_sinks: tuple = ()

# Device-timeline annotator (telemetry/profiler.py): while an on-demand
# XLA capture runs, every span ALSO enters a `jax.profiler.TraceAnnotation`
# of the same name, so job phases line up with XLA ops in the downloaded
# trace. None except during a capture — the idle fast path pays one extra
# `is None` check and still allocates nothing.
_annotator = None


def set_annotator(factory) -> None:
    """Install (or, with None, remove) the device-timeline annotation
    factory: a callable `name -> context manager` entered for the span's
    extent. Installed only while a profiler capture is live."""
    global _annotator
    _annotator = factory


def add_sink(sink) -> None:
    """Install an extra span sink (anything with `.add(ev)`); spans record
    into it whenever they record at all. Idempotent."""
    global _extra_sinks
    if all(s is not sink for s in _extra_sinks):
        _extra_sinks = _extra_sinks + (sink,)


def remove_sink(sink) -> None:
    global _extra_sinks
    _extra_sinks = tuple(s for s in _extra_sinks if s is not sink)


class TraceBuffer:
    """Bounded, thread-safe sink of finished span events (dicts in Chrome
    trace-event form). Overflow drops (counted) rather than grows — a
    runaway span source must not OOM a long-lived service."""

    def __init__(self, max_events: int = 65536):
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0

    def add(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def take(self) -> list[dict]:
        """Atomically remove and return everything recorded so far — the
        drain primitive. A plain events()+clear() pair would destroy any
        span recorded between the two lock acquisitions."""
        with self._lock:
            out = self._events
            self._events = []
            self.dropped = 0
            return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def chrome_trace(self) -> dict:
        """The chrome://tracing / Perfetto JSON object."""
        return chrome_envelope(self.events())

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def span_tree(self) -> list[dict]:
        """Nest finished spans by parent id — the `metrics.spans` block of
        GET /jobs/{id}. A span whose parent was dropped (overflow) or is
        still open becomes a root."""
        evs = [e for e in self.events() if e.get("ph", "X") == "X"]
        nodes: dict[int, dict] = {}
        for ev in evs:
            args = ev.get("args", {})
            node = {
                "name": ev["name"],
                "startUs": ev["ts"],
                "durUs": ev["dur"],
                "children": [],
            }
            extra = {
                k: v for k, v in args.items() if k not in ("id", "parent")
            }
            if extra:
                node["attrs"] = extra
            nodes[args.get("id", 0)] = (node)
        roots: list[dict] = []
        for ev in evs:
            args = ev.get("args", {})
            node = nodes[args.get("id", 0)]
            parent = nodes.get(args.get("parent", 0))
            (parent["children"] if parent is not None else roots).append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n["startUs"])
        roots.sort(key=lambda n: n["startUs"])
        return roots


def chrome_envelope(events: list[dict]) -> dict:
    """The one Chrome trace-file wrapper every export path shares."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


def _tid() -> int:
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    if task is not None:
        return id(task) % 1_000_000
    return threading.get_ident() % 1_000_000


class Span:
    __slots__ = (
        "name", "bufs", "timings", "pid", "attrs",
        "id", "parent_id", "parent", "_token", "t0", "annotation",
    )

    def __init__(self, name, bufs, timings, pid, attrs, annotation=None):
        self.name = name
        self.bufs = bufs
        self.timings = timings
        self.pid = pid
        self.attrs = attrs
        self.id = next(_IDS)
        self.parent_id = 0
        # live parent reference (not just the id): telemetry/logbus.py
        # walks the open chain at log time to find trace/job attrs set on
        # an enclosing span. Spans are short-lived scopes, so the extra
        # reference does not extend any object's lifetime meaningfully.
        self.parent = None
        self._token = None
        self.t0 = 0.0
        self.annotation = annotation

    def __enter__(self):
        parent = _CURRENT.get()
        if parent is not None:
            self.parent = parent
            self.parent_id = parent.id
            if self.pid is None:
                self.pid = parent.pid
        self._token = _CURRENT.set(self)
        if self.annotation is not None:
            try:
                self.annotation.__enter__()
            except Exception:  # noqa: BLE001 — profiling must never fail work
                self.annotation = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, etype, evalue, tb):
        dt = time.perf_counter() - self.t0
        if self.annotation is not None:
            try:
                self.annotation.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        _CURRENT.reset(self._token)
        if self.timings is not None:
            self.timings.record(self.name, dt)
        if self.bufs:
            args = {"id": self.id, "parent": self.parent_id}
            if self.attrs:
                args.update(self.attrs)
            if etype is not None:
                args["error"] = etype.__name__
            ev = {
                "name": self.name,
                "ph": "X",
                "ts": round(self.t0 * 1e6, 1),
                "dur": round(dt * 1e6, 1),
                "pid": self.pid if self.pid is not None else 0,
                "tid": _tid(),
                "args": args,
            }
            for buf in self.bufs:
                buf.add(ev)
        return False


def span(
    name: str,
    *,
    timings=None,
    party: int | None = None,
    sid: int | None = None,
    job: str | None = None,
    attrs: dict | None = None,
):
    """Open a span. `timings` is an optional PhaseTimings-shaped sink
    (`record(name, seconds)`) written on exit — utils.timers.phase rides
    on this, making PhaseTimings a view over span data. Returns a shared
    no-op when no buffer is active and no sink was given."""
    b = _BUFFER.get()
    g = _global_buffer
    x = _extra_sinks
    if b is None and g is None and not x:
        if timings is None and _annotator is None:
            return NOOP
        bufs = ()
    elif not x:
        if b is None:
            bufs = (g,)
        elif g is None or g is b:
            bufs = (b,)
        else:
            bufs = (b, g)
    else:
        # slow path: something unusual (agg buffer / flight ring) is
        # installed; dedup by identity — recording allocates anyway
        seen: list = []
        for s in (b, g) + x:
            if s is not None and all(s is not t for t in seen):
                seen.append(s)
        bufs = tuple(seen)
    a = attrs
    if sid is not None or job is not None:
        a = dict(attrs) if attrs else {}
        if sid is not None:
            a["sid"] = sid
        if job is not None:
            a["job"] = job
    ann = _annotator
    annotation = None
    if ann is not None:
        try:
            annotation = ann(name)
        except Exception:  # noqa: BLE001 — a capture teardown race is benign
            annotation = None
    return Span(name, bufs, timings, party, a, annotation)


def current() -> "Span | None":
    """The innermost OPEN span in this context (None when idle) — the
    ambient-enrichment hook for telemetry/logbus.py, which walks the
    `.parent` chain for trace/job attrs at log time."""
    return _CURRENT.get()


def instant(
    name: str,
    *,
    args: dict | None = None,
    pid: int | None = None,
) -> bool:
    """Record one Chrome instant event (`"ph": "i"`) into every buffer a
    span would record into right now — how logbus paints WARN+ records
    onto the job timeline. Returns False (and allocates nothing beyond
    the contextvar read) when no buffer is active, preserving the
    zero-overhead-when-idle contract. `dur` is 0 so the aggregation
    plane's numeric ts/dur filter ships these cross-party instead of
    dropping them; span_tree() skips non-"X" phases."""
    b = _BUFFER.get()
    g = _global_buffer
    x = _extra_sinks
    if b is None and g is None and not x:
        return False
    if not x:
        if b is None:
            bufs = (g,)
        elif g is None or g is b:
            bufs = (b,)
        else:
            bufs = (b, g)
    else:
        seen: list = []
        for s in (b, g) + x:
            if s is not None and all(s is not t for t in seen):
                seen.append(s)
        bufs = tuple(seen)
    cur = _CURRENT.get()
    if pid is None and cur is not None:
        pid = cur.pid
    ev = {
        "name": name,
        "ph": "i",
        "s": "g",
        "ts": round(time.perf_counter() * 1e6, 1),
        "dur": 0.0,
        "pid": pid if pid is not None else 0,
        "tid": _tid(),
        "args": dict(args) if args else {},
    }
    for buf in bufs:
        buf.add(ev)
    return True


def active() -> bool:
    """True when at least one buffer would record spans."""
    return (
        _BUFFER.get() is not None
        or _global_buffer is not None
        or bool(_extra_sinks)
    )


@contextmanager
def collect(buffer: TraceBuffer):
    """Route spans in this dynamic extent (including tasks and threads
    spawned inside it) into `buffer` — the per-proof trace hook."""
    token = _BUFFER.set(buffer)
    try:
        yield buffer
    finally:
        _BUFFER.reset(token)


def enable_global(
    path: str | None = None, max_events: int = 262144
) -> TraceBuffer:
    """Install the process-global buffer (the DG16_TRACE_OUT / --trace-out
    path); returns it. `flush_global()` or process exit writes the file."""
    global _global_buffer, _global_path
    if _global_buffer is None:
        _global_buffer = TraceBuffer(max_events=max_events)
    if path:
        _global_path = path
    return _global_buffer


def disable_global() -> None:
    global _global_buffer, _global_path
    _global_buffer = None
    _global_path = None


def flush_global(path: str | None = None) -> str | None:
    """Dump the global buffer as Chrome trace JSON; returns the path
    written (None when there is nothing to write)."""
    p = path or _global_path
    if _global_buffer is None or not p:
        return None
    _global_buffer.dump(p)
    return p


def configure_from_env() -> None:
    """Honor DG16_TRACE_OUT: install the global buffer pointed at it."""
    path = _config.env_str("DG16_TRACE_OUT")
    if path:
        enable_global(path)


configure_from_env()
atexit.register(flush_global)
