"""Structured logging spine: correlated, queryable logs as a third pillar.

Metrics and traces already answer "how fast" and
"where did the time go"; this module answers "what did the code SAY while
that happened" — without touching a single call site. A stdlib
`logging.Handler` is installed on the package logger, so every existing
`log = logging.getLogger(__name__)` upgrade for free: each record becomes
a structured event auto-enriched from the ambient context the repo
already maintains —

  * the active span chain (telemetry/tracing.py): innermost span name,
    plus `trace` / `job` / party id found by walking open parents, so a
    log line inside `prove.A` inherits the job's end-to-end trace id;
  * the MPC job contextvar (`parallel.net.job_context`);
  * `bind()`-scoped fields (tenant / priority — the service worker binds
    them around each proof);
  * the replica id (`set_replica`, fed from ServiceConfig).

Records land in a bounded per-process ring (`DG16_LOG_RING`), queryable
by level/since/trace/job/logger — the data plane behind `GET /logs`, the
job DTO's `logs` tail, router-side `/fleet/jobs/{id}/logs` federation,
and the flight recorder's post-mortem `logs` block. WARN+ records are
additionally painted onto the live trace as Chrome instant events, so an
ERROR shows up ON the job timeline, not just beside it.

Two safety valves run in the handler itself:

  * a storm suppressor — token bucket per (logger, template); a tight
    retry loop logging the same template thousands of times costs a
    bounded number of ring slots plus one synthetic "suppressed N
    similar" record when the storm drains (log_dropped_total counts the
    rest);
  * runtime secret redaction complementing static DG102: structured
    extras whose key names a secret (witness/trapdoor/...) are replaced
    with "[REDACTED]", and 20+ digit integers in formatted messages are
    elided — a sanitizer for the call sites lint cannot see.

Records carry BOTH clocks: wall `ts` (display) and `tsPcNs`
(perf_counter_ns — the clock ClockSync measures), so the fleet router
can rebase a replica's records onto its own timeline exactly like the
stitched Chrome trace (docs/FLEET.md).
"""

from __future__ import annotations

import io
import json
import logging
import re
import sys
import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar

from . import metrics as _tm
from . import tracing as _tracing
from ..utils import config as _config

PACKAGE_LOGGER = "distributed_groth16_tpu_torch"

_REG = _tm.registry()
_RECORDS = _REG.counter(
    "log_records_total", "Structured log records admitted to the ring, "
    "per level and (package-relative) logger",
    ("level", "logger"),
)
_DROPPED = _REG.counter(
    "log_dropped_total",
    "Log records NOT admitted to the ring, per reason "
    "(storm = per-template token bucket exhausted)",
    ("reason",),
)

# -- runtime secret redaction (complements static analysis/rules/dg102) ------

_SECRET_PARTS = ("witness", "wtns", "trapdoor", "toxic", "secret")
_BIGINT_RE = re.compile(r"\d{20,}")
REDACTED = "[REDACTED]"


def _secret_key(key: str) -> bool:
    low = key.lower()
    return any(p in low for p in _SECRET_PARTS)


def redact_text(text: str) -> str:
    """Elide 20+ digit integers — nothing benign in this codebase prints
    one, but a field element leaked into an error message would (cf.
    service.jobs.sanitize_message, the HTTP-surface twin)."""
    return _BIGINT_RE.sub("<bigint>", text)


# -- bind(): explicit ambient fields -----------------------------------------

_BOUND: ContextVar[dict | None] = ContextVar("dg16_log_bound", default=None)


@contextmanager
def bind(**fields):
    """Attach fields to every record logged in this dynamic extent (the
    service worker binds tenant/priority around each proof). Values land
    in the record verbatim — never pass secret material; dg16lint DG102
    treats `logbus.bind(...)` as a log sink."""
    prev = _BOUND.get()
    merged = dict(prev) if prev else {}
    # unset metadata (a job with no tenant) must not stamp empty strings
    merged.update(
        {k: v for k, v in fields.items() if v not in (None, "")}
    )
    token = _BOUND.set(merged)
    try:
        yield
    finally:
        _BOUND.reset(token)


_replica_id: str | None = None


def set_replica(replica_id: str | None) -> None:
    """Stamp every subsequent record with this replica id (the service
    layer calls this with ServiceConfig.replica_id at startup)."""
    global _replica_id
    _replica_id = replica_id


# -- the ring ----------------------------------------------------------------

LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40,
          "CRITICAL": 50}
_LEVELS = LEVELS


class LogRing:
    """Bounded, thread-safe ring of structured records with a monotonic
    per-process `seq` — the `since` cursor `--follow` polls on."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._records: deque[dict] = deque(maxlen=maxlen)
        self._seq = 0

    def append(self, record: dict) -> int:
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            self._records.append(record)
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def seq(self) -> int:
        return self._seq

    def tail(self, n: int = 256) -> list[dict]:
        with self._lock:
            if n <= 0:
                return []
            return list(self._records)[-n:]

    def query(
        self,
        *,
        level: str | None = None,
        since: int | None = None,
        trace: str | None = None,
        job: str | None = None,
        logger: str | None = None,
        limit: int = 256,
    ) -> list[dict]:
        """Filtered view, oldest-first, capped to the LAST `limit`
        matches (the tail is what an operator debugging a fault wants).
        `level` is a minimum ("WARNING" matches ERROR too); `since` is an
        exclusive seq cursor; `logger` is a prefix match on the
        package-relative logger name."""
        floor = _LEVELS.get(level.upper(), 0) if level else 0
        with self._lock:
            records = list(self._records)
        out = []
        for r in records:
            if floor and r.get("levelNo", 0) < floor:
                continue
            if since is not None and r["seq"] <= since:
                continue
            if trace is not None and r.get("trace") != trace:
                continue
            if job is not None and r.get("job") != job:
                continue
            if logger is not None and not r.get("logger", "").startswith(
                logger
            ):
                continue
            out.append(r)
        if limit and limit > 0:
            out = out[-limit:]
        return out


_ring: LogRing | None = None
_ring_lock = threading.Lock()


def ring() -> LogRing:
    """The process ring (created on first use; size = DG16_LOG_RING)."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = LogRing(
                    maxlen=max(16, _config.env_int("DG16_LOG_RING", 4096))
                )
    return _ring


def tail(n: int = 256) -> list[dict]:
    """Module-level convenience for the flight recorder: last n records
    without touching handler internals (empty if nothing logged yet)."""
    r = _ring
    return r.tail(n) if r is not None else []


# -- storm suppression --------------------------------------------------------


class _TemplateBucket:
    __slots__ = ("tokens", "last", "suppressed")

    def __init__(self, burst: float):
        self.tokens = burst
        self.last = time.monotonic()
        self.suppressed = 0


class StormSuppressor:
    """Token bucket per (logger, template): `burst` records pass
    immediately, then `rate` per second; the rest are dropped (counted)
    and summarized by ONE synthetic record when tokens free up — so a
    peer-death retry loop costs ring slots proportional to time, not to
    iterations."""

    def __init__(self, burst: float = 10.0, rate: float = 1.0):
        self.burst = max(1.0, burst)
        self.rate = rate
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, str], _TemplateBucket] = {}

    def admit(self, key: tuple[str, str]) -> tuple[bool, int]:
        """(admitted, n_suppressed_to_report): the second element is
        nonzero when this admission should be preceded by a synthetic
        "suppressed N similar" record summarizing the drained storm."""
        if self.rate <= 0:
            return True, 0
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                # bound the bucket table itself: a logger minting unique
                # templates (it shouldn't — lint wants %s templates) must
                # not grow this dict forever
                if len(self._buckets) >= 1024:
                    self._buckets.clear()
                b = self._buckets[key] = _TemplateBucket(self.burst)
            b.tokens = min(self.burst, b.tokens + (now - b.last) * self.rate)
            b.last = now
            if b.tokens < 1.0:
                b.suppressed += 1
                return False, 0
            b.tokens -= 1.0
            flush, b.suppressed = b.suppressed, 0
            return True, flush


# -- the handler --------------------------------------------------------------

_STD_ATTRS = frozenset(
    vars(logging.LogRecord("", 0, "", 0, "", (), None))
) | frozenset({"message", "asctime", "taskName"})

_in_emit = threading.local()


def _ambient(record_dict: dict) -> None:
    """Fill trace/job/span/party from the ambient context, cheapest
    source first; explicit extras already in `record_dict` win."""
    span = _tracing.current()
    if span is not None:
        record_dict.setdefault("span", span.name)
        pid = span.pid
        node = span
        while node is not None:
            attrs = node.attrs
            if attrs:
                t = attrs.get("trace")
                if t is not None:
                    record_dict.setdefault("trace", t)
                j = attrs.get("job")
                if j is not None:
                    record_dict.setdefault("job", j)
            if pid is None:
                pid = node.pid
            node = node.parent
        if pid is not None:
            record_dict.setdefault("party", pid)
    if "job" not in record_dict:
        # lazy, import-cycle-free lookup: telemetry must not import
        # parallel.net (net imports telemetry); if net was never
        # imported there is no MPC job to attribute anyway
        net = sys.modules.get("distributed_groth16_tpu_torch.parallel.net")
        if net is not None:
            jid = net.CURRENT_JOB_ID.get()
            if jid is not None:
                record_dict["job"] = jid
    bound = _BOUND.get()
    if bound:
        for k, v in bound.items():
            record_dict.setdefault(k, v)
    if _replica_id is not None:
        record_dict.setdefault("replica", _replica_id)


class LogBusHandler(logging.Handler):
    """The spine: structure + enrich + redact + suppress + ring + trace
    instants. One instance per process, installed by `setup()`."""

    def __init__(self, ring_: LogRing, suppressor: StormSuppressor):
        super().__init__(level=logging.DEBUG)
        self.ring = ring_
        self.suppressor = suppressor

    def emit(self, record: logging.LogRecord) -> None:  # noqa: C901
        if getattr(_in_emit, "active", False):
            return  # a log call from inside emit must not recurse
        _in_emit.active = True
        try:
            self._emit(record)
        except Exception:  # noqa: BLE001 — logging must never fail work
            _DROPPED.labels(reason="error").inc()
        finally:
            _in_emit.active = False

    def _emit(self, record: logging.LogRecord) -> None:
        logger = record.name
        if logger.startswith(PACKAGE_LOGGER + "."):
            logger = logger[len(PACKAGE_LOGGER) + 1:]
        template = record.msg if isinstance(record.msg, str) else str(
            record.msg
        )
        admitted, flushed = self.suppressor.admit((logger, template))
        if not admitted:
            _DROPPED.labels(reason="storm").inc()
            return
        if flushed:
            synth = {
                "ts": time.time(),
                "tsPcNs": time.perf_counter_ns(),
                "level": record.levelname,
                "levelNo": record.levelno,
                "logger": logger,
                "msg": f"suppressed {flushed} similar record"
                       f"{'s' if flushed != 1 else ''}",
                "template": template,
                "suppressed": flushed,
            }
            _ambient(synth)
            self.ring.append(synth)
            _RECORDS.labels(level=record.levelname, logger=logger).inc()
        out = {
            "ts": record.created,
            "tsPcNs": time.perf_counter_ns(),
            "level": record.levelname,
            "levelNo": record.levelno,
            "logger": logger,
            "msg": redact_text(record.getMessage()),
            "template": template,
        }
        fields = {}
        for k, v in record.__dict__.items():
            if k in _STD_ATTRS or k.startswith("_"):
                continue
            fields[k] = REDACTED if _secret_key(k) else v
        # explicit correlation extras (log.error(..., extra={"trace": t}))
        # are promoted to first-class record keys so they win over ambient
        for k in ("trace", "job", "party", "tenant", "priority", "span"):
            if k in fields:
                out[k] = fields.pop(k)
        if fields:
            out["fields"] = fields
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = redact_text(
                "".join(traceback.format_exception(*record.exc_info))[-4096:]
            )
        _ambient(out)
        self.ring.append(out)
        _RECORDS.labels(level=record.levelname, logger=logger).inc()
        if record.levelno >= logging.WARNING:
            # paint the record onto the live timeline: shows as a glyph
            # at the fault instant in chrome://tracing / Perfetto
            args = {"msg": out["msg"][:512], "logger": logger}
            if "trace" in out:
                args["trace"] = out["trace"]
            if "job" in out:
                args["job"] = out["job"]
            _tracing.instant(
                f"log.{record.levelname}",
                args=args,
                pid=out.get("party"),
            )


class JsonFormatter(logging.Formatter):
    """One JSON object per line on the console (DG16_LOG_JSON) — the
    shape log shippers want; same record schema as the ring."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": redact_text(record.getMessage()),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = redact_text(
                "".join(traceback.format_exception(*record.exc_info))[-4096:]
            )
        _ambient(out)
        return json.dumps(out, default=str)


# -- setup() ------------------------------------------------------------------

_handler: LogBusHandler | None = None
_console: logging.Handler | None = None
_setup_lock = threading.Lock()


def setup(
    console: bool | None = None,
    level: str | None = None,
    stream: io.TextIOBase | None = None,
) -> LogBusHandler:
    """THE process logging entry point (replaces per-module
    `logging.basicConfig` calls): installs the ring handler on the
    package logger (idempotent), sets its level from `level` /
    DG16_LOG_LEVEL (default INFO), and — when `console` is True, or None
    with no other handler configured anywhere — adds a stderr handler
    (JSON lines under DG16_LOG_JSON). Safe to call from every entry
    point; later calls only adjust the level."""
    global _handler, _console
    pkg = logging.getLogger(PACKAGE_LOGGER)
    with _setup_lock:
        if _handler is None:
            _handler = LogBusHandler(
                ring(),
                StormSuppressor(
                    burst=_config.env_float("DG16_LOG_STORM_BURST", 10.0),
                    rate=_config.env_float("DG16_LOG_STORM_RATE", 1.0),
                ),
            )
            pkg.addHandler(_handler)
        lvl = (level or _config.env_str("DG16_LOG_LEVEL", "INFO")).upper()
        pkg.setLevel(_LEVELS.get(lvl, logging.INFO))
        if console is None:
            console = _console is None and not logging.getLogger().handlers
        if console and _console is None:
            _console = logging.StreamHandler(stream or sys.stderr)
            if _config.env_flag("DG16_LOG_JSON"):
                _console.setFormatter(JsonFormatter())
            else:
                _console.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s: %(message)s"
                ))
            pkg.addHandler(_console)
            pkg.propagate = False  # console handler owns stderr now
    return _handler


def reset_for_tests() -> None:
    """Tear down handlers + ring so a test gets a pristine spine (test
    helper only — production processes install once and keep it)."""
    global _handler, _console, _ring
    pkg = logging.getLogger(PACKAGE_LOGGER)
    with _setup_lock:
        if _handler is not None:
            pkg.removeHandler(_handler)
        if _console is not None:
            pkg.removeHandler(_console)
            pkg.propagate = True
        _handler = None
        _console = None
    with _ring_lock:
        _ring = None
