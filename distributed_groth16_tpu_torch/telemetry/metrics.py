"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The observability spine's numeric half (docs/OBSERVABILITY.md). Design
constraints, in order:

  1. Hot-path cost. The star collectives call into this once per op at
     2^20 scale, so a recorded sample must cost one dict lookup plus an
     in-place add — no per-call allocations. Call sites pre-bind label
     children (`family.labels(op="gather_to_king")`) once and hold the
     child; `child.inc()` / `child.observe()` is then lock + add.
  2. Process-wide. One registry per process (the Prometheus model): every
     layer registers its families at import time, so `GET /metrics` and
     bench.py see one coherent snapshot without plumbing a registry handle
     through twelve constructors. `registry()` returns it; tests compare
     deltas, never absolute values.
  3. Thread-safe. Worker threads, the event loop, and the bench watchdog
     all record concurrently; every family carries an RLock (re-entrant so
     a signal handler snapshotting mid-increment cannot deadlock bench's
     SIGTERM emit path).

Exposition is Prometheus text format 0.0.4 (`render_prometheus`), with
HELP/TYPE lines for every registered family — a family with no recorded
series is still discoverable by scrapers. `DG16_METRICS=0` turns every
record call into an early return (the kill switch; collection is on by
default because it is allocation-free).
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Sequence

from ..utils import config as _config

INF = float("inf")

# latency buckets wide enough for both a microseconds-scale in-process
# collective and a minutes-scale million-constraint proof phase
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, INF,
)

# kernel-latency buckets (perf_kernel_* families, telemetry/perf.py): a
# warm NTT at 2^10 is tens of microseconds on TPU — DEFAULT_TIME_BUCKETS'
# 1 ms floor would collapse every fast kernel into one bucket, hiding the
# exact curve-bending the per-kernel bench exists to show
DEFAULT_KERNEL_BUCKETS = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, INF,
)

_ENABLED = _config.env_flag("DG16_METRICS", True)


def set_enabled(on: bool) -> None:
    """Flip collection globally (the DG16_METRICS knob, testable)."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == INF:
        return "+Inf"
    if v == -INF:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _series(name: str, labelnames: tuple, labelvalues: tuple) -> str:
    if not labelnames:
        return name
    inner = ",".join(
        f'{n}="{_escape_label(v)}"'
        for n, v in zip(labelnames, labelvalues)
    )
    return f"{name}{{{inner}}}"


class _Counter:
    """Monotonic counter child (one label combination)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += n


class _Gauge:
    """Set-to-current-value child."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value = v

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class _Histogram:
    """Fixed-bucket histogram child: per-bucket counts + sum + count."""

    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, lock: threading.RLock, bounds: tuple):
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * len(bounds)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.counts[bisect_left(self._bounds, v)] += 1
            self.sum += v
            self.count += 1


class _Family:
    """One named metric with a fixed label dimension; children per label
    combination. `labels()` is get-or-create and returns the same child
    object for the same values — bind it once on hot paths."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.RLock()
        self._children: dict[tuple, object] = {}
        self._default = self._child() if not self.labelnames else None

    def _child(self):
        raise NotImplementedError

    def labels(self, *values, **kw):
        if kw:
            if values or set(kw) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: labels {sorted(kw)} != "
                    f"{list(self.labelnames)}"
                )
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            if len(values) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: {len(values)} label values for "
                    f"{len(self.labelnames)} label names"
                )
            values = tuple(str(v) for v in values)
        with self._lock:
            c = self._children.get(values)
            if c is None:
                c = self._children[values] = self._child()
            return c

    def remove(self, *values, **kw) -> None:
        """Drop one child series, if it exists. For label MIGRATION —
        e.g. a fleet replica adopting its self-reported id after first
        contact — where leaving the old series exported would show a
        phantom forever. Not for routine cleanup: dropping a live
        counter child loses its count."""
        if kw:
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    def _items(self) -> list[tuple[tuple, object]]:
        with self._lock:
            if self._default is not None:
                return [((), self._default)]
            return sorted(self._children.items())

    def items(self) -> list[tuple[tuple, object]]:
        """Snapshot of (label-values, child) pairs — the read side for
        derived samplers (service/slo.py) that fold existing series into
        new gauges instead of instrumenting call sites twice."""
        return self._items()


class CounterFamily(_Family):
    kind = "counter"

    def _child(self):
        return _Counter(self._lock)

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    @property
    def value(self) -> float:
        return self._default.value


class GaugeFamily(_Family):
    kind = "gauge"

    def _child(self):
        return _Gauge(self._lock)

    def set(self, v: float) -> None:
        self._default.set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default.dec(n)

    @property
    def value(self) -> float:
        return self._default.value


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets=DEFAULT_TIME_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or b[-1] != INF:
            b = b + (INF,)
        if list(b) != sorted(b):
            raise ValueError(f"{name}: buckets must be sorted")
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _child(self):
        return _Histogram(self._lock, self.buckets)

    def observe(self, v: float) -> None:
        self._default.observe(v)


class MetricsRegistry:
    """Name -> family map; get-or-create is idempotent so every module can
    declare its families at import time in any order. Re-registering a
    name with a different type, label set, or bucket layout is a bug and
    raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}"
                    )
                if kw.get("buckets") is not None and tuple(
                    float(x) for x in kw["buckets"]
                ) not in (fam.buckets, fam.buckets[:-1]):
                    raise ValueError(
                        f"metric {name!r} re-registered with different buckets"
                    )
                return fam
            fam = cls(name, help, labelnames, **{
                k: v for k, v in kw.items() if v is not None
            })
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> CounterFamily:
        return self._get(CounterFamily, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> GaugeFamily:
        return self._get(GaugeFamily, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(), buckets=None
    ) -> HistogramFamily:
        return self._get(
            HistogramFamily, name, help, labelnames, buckets=buckets
        )

    def family(self, name) -> _Family | None:
        """Look a family up by name WITHOUT registering it — None when the
        registering module was never imported (the reader must treat that
        as 'no data', not create a typeless placeholder)."""
        with self._lock:
            return self._families.get(name)

    def snapshot(self) -> dict[str, float]:
        """Flat {series: value} map (histograms as _sum/_count) — the
        bench.py JSON-line and /stats shape."""
        out: dict[str, float] = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for values, child in fam._items():
                s = _series(fam.name, fam.labelnames, values)
                if isinstance(child, _Histogram):
                    if child.count:
                        out[
                            _series(fam.name + "_sum", fam.labelnames, values)
                        ] = child.sum
                        out[
                            _series(fam.name + "_count", fam.labelnames, values)
                        ] = float(child.count)
                elif isinstance(child, _Gauge) or child.value:
                    out[s] = child.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam._items():
                if isinstance(child, _Histogram):
                    cum = 0
                    for bound, n in zip(fam.buckets, child.counts):
                        cum += n
                        lines.append(
                            _series(
                                fam.name + "_bucket",
                                fam.labelnames + ("le",),
                                values + (_fmt(bound),),
                            )
                            + f" {cum}"
                        )
                    lines.append(
                        _series(fam.name + "_sum", fam.labelnames, values)
                        + f" {_fmt(child.sum)}"
                    )
                    lines.append(
                        _series(fam.name + "_count", fam.labelnames, values)
                        + f" {child.count}"
                    )
                else:
                    lines.append(
                        _series(fam.name, fam.labelnames, values)
                        + f" {_fmt(child.value)}"
                    )
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every layer records into."""
    return _REGISTRY


# -- exposition parsing + snapshot merging (the federation utilities) ---------
#
# The fleet router (fleet/federate.py) scrapes every replica's /metrics,
# re-exports the series with a `replica` label, and rolls the fleet up
# (merged job_seconds histograms -> fleet p50/p95). That needs the read
# side of the text format this module writes: a parser back into
# (family, samples), and histogram snapshot math — cumulative bucket
# counts are summable across shards (sum of cumulatives = cumulative of
# sums), which is what makes federated quantiles possible at all.

_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) ?(.*)$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$"
)
# value, then an OPTIONAL int64 millisecond timestamp — spec-legal in
# 0.0.4 (exporters/sidecars append it); parsed but discarded, since the
# federation treats every scrape as "now"
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)(?: (-?\d+))?$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(v: str) -> str:
    # single pass, never sequential str.replace: unescaping "\\n"
    # (backslash then literal n) with replace("\\n", "\n") first would
    # corrupt it into a real newline
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(0)), v
    )


class ParsedFamily:
    """One metric family read back from text exposition: `samples` is a
    list of (sample_name, labels_dict, value) — sample names keep their
    `_bucket`/`_sum`/`_count` suffixes so histogram math stays explicit."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str = "", samples=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples: list[tuple[str, dict, float]] = samples or []


def _parse_value(raw: str) -> float:
    if raw in ("Inf", "+Inf"):
        return INF
    if raw == "-Inf":
        return -INF
    return float(raw)


def parse_exposition(text: str) -> dict[str, ParsedFamily]:
    """Parse Prometheus text format 0.0.4 into {family_name: ParsedFamily}.
    Sample lines are attributed to their base family (stripping the
    histogram suffixes); a malformed line raises ValueError — a federated
    scrape must fail loudly, not silently drop half a replica's series."""
    fams: dict[str, ParsedFamily] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                name, kind = m.group(1), m.group(2)
                fam = fams.get(name)
                if fam is None:
                    fams[name] = ParsedFamily(name, kind)
                else:
                    fam.kind = kind
                continue
            m = _HELP_RE.match(line)
            if m:
                name = m.group(1)
                fam = fams.setdefault(name, ParsedFamily(name, "untyped"))
                fam.help = m.group(2)
                continue
            continue  # other comments are legal and ignored
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        sname, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        labels: dict[str, str] = {}
        if raw_labels:
            pairs = _LABEL_PAIR_RE.findall(raw_labels)
            if _LABEL_PAIR_RE.sub("", raw_labels).strip(',"'):
                raise ValueError(f"bad label syntax: {line!r}")
            labels = {k: _unescape_label(v) for k, v in pairs}
        base = sname
        if base not in fams:
            for suffix in ("_bucket", "_sum", "_count"):
                if sname.endswith(suffix) and sname[: -len(suffix)] in fams:
                    base = sname[: -len(suffix)]
                    break
        fam = fams.setdefault(base, ParsedFamily(base, "untyped"))
        fam.samples.append((sname, labels, _parse_value(raw_value)))
    return fams


class HistogramSnapshot:
    """One histogram's state as read from exposition: sorted bucket
    bounds, CUMULATIVE counts aligned to them, and the _sum/_count pair.
    Snapshots with identical bounds merge by plain addition — that is
    the whole federation trick."""

    __slots__ = ("bounds", "cumulative", "sum", "count")

    def __init__(self, bounds, cumulative, sum, count):
        self.bounds = tuple(bounds)
        self.cumulative = list(cumulative)
        self.sum = float(sum)
        self.count = float(count)


def histogram_snapshots(
    family: ParsedFamily, group_by: tuple = ()
) -> dict[tuple, HistogramSnapshot]:
    """The snapshot-merge utility: fold a parsed histogram family's
    series into one HistogramSnapshot per combination of the `group_by`
    label values, merging every OTHER label dimension away. Examples:
    `group_by=("kind",)` merges a replica-labeled federated `job_seconds`
    into per-kind fleet histograms; `group_by=("replica",)` merges kinds
    into per-replica latency; `()` merges everything into one."""
    acc: dict[tuple, dict] = {}
    for sname, labels, value in family.samples:
        key = tuple(labels.get(g, "") for g in group_by)
        slot = acc.setdefault(key, {"les": {}, "sum": 0.0, "count": 0.0})
        if sname.endswith("_bucket"):
            le = labels.get("le")
            if le is None:
                continue
            b = _parse_value(le)
            slot["les"][b] = slot["les"].get(b, 0.0) + value
        elif sname.endswith("_sum"):
            slot["sum"] += value
        elif sname.endswith("_count"):
            slot["count"] += value
    out: dict[tuple, HistogramSnapshot] = {}
    for key, slot in acc.items():
        bounds = tuple(sorted(slot["les"]))
        out[key] = HistogramSnapshot(
            bounds=bounds,
            cumulative=[slot["les"][b] for b in bounds],
            sum=slot["sum"],
            count=slot["count"],
        )
    return out


def histogram_quantile(snap: HistogramSnapshot, q: float) -> float:
    """Prometheus-style bucket quantile: linear interpolation inside the
    bucket the target rank lands in; ranks in the +Inf bucket answer the
    highest finite bound (the honest cap of what buckets can say).
    Returns 0.0 for an empty snapshot."""
    if snap.count <= 0 or not snap.bounds:
        return 0.0
    target = q * snap.count
    prev_bound = 0.0
    prev_cum = 0.0
    for bound, cum in zip(snap.bounds, snap.cumulative):
        if cum >= target:
            if bound == INF:
                return prev_bound
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return bound
            frac = (target - prev_cum) / in_bucket
            return prev_bound + (bound - prev_bound) * frac
        prev_cum = cum
        if bound != INF:
            prev_bound = bound
    return prev_bound
