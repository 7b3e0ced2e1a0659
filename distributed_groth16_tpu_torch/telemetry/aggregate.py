"""Star-wide trace aggregation: clock alignment, merging, critical path.

The telemetry subsystem made one process legible; a zkSaaS proof is an n-process star, and
the question the king/client split raises — *where does a round's
wall-clock go: king compute, the slowest client, or the wire?* — needs
every party's spans on ONE timeline. This module is the king-side half of
that plane (the transport half — the TELEMETRY frame and the heartbeat
clock echo — lives in `parallel/prodnet.py`):

  * `ClockSync` — NTP-style (offset, rtt) estimation from heartbeat
    echoes. Each party timestamps telemetry with `now_ns()`
    (perf_counter_ns — the SAME clock the span `ts` fields use, so an
    offset estimate rebases spans directly); the estimate with the
    smallest rtt over a sliding window wins, because asymmetric queuing
    delay is the error term and small-rtt samples bound it tightest.
  * `TraceAggregator` — per-party tracks of clock-rebased span events,
    merged into one Chrome trace (one `pid` per party, named via
    process_name metadata events), plus the per-round **critical path**:

        busy(p)   = union(all spans of p) − union(net.* spans of p)
        king      = |busy(0)|
        straggler = max over clients of |busy(p)| (argmax = the straggler)
        wire      = wall − |union of every party's busy set|
                    (time when NO party is computing: wire/wait)

    exported as `round_critical_path_seconds{component}` and
    `party_straggler_total{party}`. The components deliberately do not
    sum to wall — king and clients overlap; each answers its own
    question (is the king the bottleneck / who is slow / is the network).

Enablement: `DG16_AGG=1` (or `set_enabled(True)`) installs a dedicated
aggregation TraceBuffer as a tracing sink; with it off, no buffer exists,
no TELEMETRY frames are sent, and the span hot path is untouched — the
same zero-overhead contract as the rest of the spine
(docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import metrics as _tm
from . import tracing as _tracing
from ..utils import config as _config

# The telemetry clock: the SAME clock span timestamps use (tracing.py
# stamps `ts` from time.perf_counter), so a ClockSync offset estimated
# over it rebases span events without a second epoch translation.
now_ns = time.perf_counter_ns

_REG = _tm.registry()
_CRITICAL_PATH = _REG.histogram(
    "round_critical_path_seconds",
    "Per-round critical-path components of the star "
    "(king compute / slowest-client straggler / wire)",
    ("component",),
)
_STRAGGLER = _REG.counter(
    "party_straggler_total",
    "Rounds in which this party was the slowest client",
    ("party",),
)
_CLOCK_OFFSET = _REG.gauge(
    "clock_offset_seconds",
    "Estimated peer_clock - local_clock from heartbeat echoes, per peer",
    ("peer",),
)
_CLOCK_RTT = _REG.gauge(
    "clock_rtt_seconds",
    "Round-trip time of the best (min-rtt) clock sample, per peer",
    ("peer",),
)

_enabled = _config.env_flag("DG16_AGG", False)

_agg_buffer: "_tracing.TraceBuffer | None" = None
_AGGREGATOR: "TraceAggregator | None" = None
_lock = threading.Lock()


def enabled() -> bool:
    """True when the aggregation plane is on (DG16_AGG / set_enabled)."""
    return _enabled


def set_enabled(on: bool, max_events: int = 65536) -> None:
    """Flip the aggregation plane. Enabling installs a dedicated span
    buffer as a tracing sink; disabling removes it (the hot path returns
    to the shared no-op singleton)."""
    global _enabled, _agg_buffer
    with _lock:
        _enabled = bool(on)
        if _enabled:
            if _agg_buffer is None:
                _agg_buffer = _tracing.TraceBuffer(max_events=max_events)
            _tracing.add_sink(_agg_buffer)
        elif _agg_buffer is not None:
            _tracing.remove_sink(_agg_buffer)
            _agg_buffer = None


def drain() -> list[dict]:
    """Take (and clear) everything the aggregation buffer has recorded —
    the per-round compaction step before a TELEMETRY send or local merge.
    Atomic: a span recorded mid-drain lands in the next round's batch."""
    buf = _agg_buffer
    if buf is None:
        return []
    return buf.take()


def requeue(events: list[dict]) -> None:
    """Put drained events back (a TELEMETRY send failed): they ride the
    next flush instead of being lost. No-op when the plane went off."""
    buf = _agg_buffer
    if buf is None:
        return
    for ev in events:
        buf.add(ev)


def aggregator() -> "TraceAggregator":
    """The process-wide merger (king side; trivially shared in-process)."""
    global _AGGREGATOR
    with _lock:
        if _AGGREGATOR is None:
            _AGGREGATOR = TraceAggregator()
        return _AGGREGATOR


def reset_aggregator() -> "TraceAggregator":
    global _AGGREGATOR
    with _lock:
        _AGGREGATOR = TraceAggregator()
        return _AGGREGATOR


def group_by_pid(events: list[dict]) -> dict[int, list[dict]]:
    """Split a shared-process event list into per-party groups (the span
    `pid` is the MPC party id; partyless harness spans land on 0)."""
    out: dict[int, list[dict]] = {}
    for ev in events:
        out.setdefault(int(ev.get("pid", 0)), []).append(ev)
    return out


def merge_local(finish: bool = False):
    """In-process round boundary (LocalSimNet): drain the shared buffer,
    attribute events to parties by pid (offset 0 — one process, one
    clock), and optionally close the round. Returns the critical-path
    dict when `finish`, else None."""
    if not _enabled:
        return None
    evs = drain()
    agg = aggregator()
    for party, group in group_by_pid(evs).items():
        agg.add_party(party, group)
    if finish:
        return agg.finish_round()
    return None


class ClockSync:
    """Per-peer clock-offset estimator over NTP-style echo samples.

    A sample comes from one heartbeat round-trip: we sent at t0 (our
    clock), the peer received at t1 and replied at t2 (peer clock), we
    received the reply at t3 (our clock). Then

        offset = ((t1 - t0) + (t2 - t3)) / 2     (peer_clock - our_clock)
        rtt    = (t3 - t0) - (t2 - t1)

    and the offset error is bounded by the one-way delay asymmetry, i.e.
    at most rtt/2 — so the best estimate over a window is the one with
    the smallest rtt. The window slides (deque) so a skew introduced
    mid-run ages the stale estimates out.
    """

    def __init__(self, window: int = 16, label: str | None = None):
        self._samples: deque[tuple[int, int]] = deque(maxlen=window)
        self._label = label
        self._gauge_off = (
            _CLOCK_OFFSET.labels(peer=label) if label is not None else None
        )
        self._gauge_rtt = (
            _CLOCK_RTT.labels(peer=label) if label is not None else None
        )

    @staticmethod
    def from_echo(t0: int, t1: int, t2: int, t3: int) -> tuple[int, int]:
        """(offset_ns, rtt_ns) from one echo: t0/t3 local, t1/t2 peer."""
        offset = ((t1 - t0) + (t2 - t3)) // 2
        rtt = (t3 - t0) - (t2 - t1)
        return offset, rtt

    def add_sample(self, offset_ns: int, rtt_ns: int) -> None:
        if rtt_ns < 0:  # clock went backwards / corrupt echo — discard
            return
        self._samples.append((rtt_ns, offset_ns))
        if self._gauge_off is not None:
            rtt, off = min(self._samples)
            self._gauge_off.set(off / 1e9)
            self._gauge_rtt.set(rtt / 1e9)

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    @property
    def offset_ns(self) -> int:
        """Best estimate of peer_clock - local_clock (0 until sampled)."""
        if not self._samples:
            return 0
        return min(self._samples)[1]

    @property
    def rtt_ns(self) -> int:
        if not self._samples:
            return 0
        return min(self._samples)[0]


def _union_length_us(intervals: list[tuple[float, float]]) -> float:
    """Total length (µs) of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return total + (cur_e - cur_s)


def _subtract_us(
    base: list[tuple[float, float]], holes: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """base minus holes, both interval lists (µs)."""
    if not base:
        return []
    if not holes:
        return sorted(base)
    holes = sorted(holes)
    out: list[tuple[float, float]] = []
    for s, e in sorted(base):
        cur = s
        for hs, he in holes:
            if he <= cur or hs >= e:
                continue
            if hs > cur:
                out.append((cur, min(hs, e)))
            cur = max(cur, he)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def critical_path(events: list[dict]) -> dict:
    """The round decomposition over a merged (or single-process) event
    list — see the module docstring for the model. Returns seconds:
    {wall, king, straggler, wire, stragglerParty, parties, perPartyBusy}.
    """
    tracks = group_by_pid([
        e for e in events
        if e.get("ph", "X") == "X"
        and isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("dur"), (int, float))
    ])
    if not tracks:
        return {
            "wall": 0.0, "king": 0.0, "straggler": 0.0, "wire": 0.0,
            "stragglerParty": None, "parties": 0, "perPartyBusy": {},
        }
    t_min = min(e["ts"] for evs in tracks.values() for e in evs)
    t_max = max(e["ts"] + e["dur"] for evs in tracks.values() for e in evs)
    busy_by_party: dict[int, list[tuple[float, float]]] = {}
    for party, evs in tracks.items():
        all_iv = [(e["ts"], e["ts"] + e["dur"]) for e in evs]
        net_iv = [
            (e["ts"], e["ts"] + e["dur"])
            for e in evs
            if str(e.get("name", "")).startswith("net.")
        ]
        busy_by_party[party] = _subtract_us(all_iv, net_iv)
    per_busy = {
        p: _union_length_us(list(iv)) / 1e6 for p, iv in busy_by_party.items()
    }
    king = per_busy.get(0, 0.0)
    clients = {p: b for p, b in per_busy.items() if p != 0}
    straggler_party = max(clients, key=clients.get) if clients else None
    straggler = clients[straggler_party] if clients else 0.0
    all_busy = [iv for ivs in busy_by_party.values() for iv in ivs]
    wall = (t_max - t_min) / 1e6
    wire = max(0.0, wall - _union_length_us(all_busy) / 1e6)
    return {
        "wall": wall,
        "king": king,
        "straggler": straggler,
        "wire": wire,
        "stragglerParty": straggler_party,
        "parties": len(tracks),
        "perPartyBusy": per_busy,
    }


def record_critical_path(cp: dict) -> None:
    """Observe a computed decomposition into the registry series."""
    for comp in ("king", "straggler", "wire"):
        _CRITICAL_PATH.labels(component=comp).observe(cp[comp])
    if cp.get("stragglerParty") is not None:
        _STRAGGLER.labels(party=str(cp["stragglerParty"])).inc()


class TraceAggregator:
    """King-side merger: per-party tracks of rebased events, one Chrome
    trace out, critical path per round. Thread-safe — ProdNet's pump
    (event loop) and a dump from a worker thread may interleave."""

    # per-party track bound: a long-lived DG16_AGG service merges every
    # round forever — past this, the oldest events drop (counted) so the
    # merger cannot OOM the process the way an unbounded list would
    MAX_EVENTS_PER_PARTY = 65536

    def __init__(self):
        self._lock = threading.Lock()
        self._tracks: dict[int, list[dict]] = {}
        self._metrics: dict[int, dict] = {}
        self._round_marks: dict[int, int] = {}
        self.last_critical_path: dict | None = None
        self.dropped = 0

    def add_party(
        self,
        party: int,
        events: list[dict],
        offset_ns: int = 0,
        metrics: dict | None = None,
    ) -> None:
        """Merge one party's compacted span events. `offset_ns` is the
        rebase delta ADDED to timestamps — pass king_clock − party_clock
        (i.e. −ClockSync.offset_ns for that peer) so the events land on
        the king's timeline. The party id overwrites `pid` so tracks
        stay per-party even for partyless harness spans."""
        off_us = offset_ns / 1e3
        rebased = []
        for ev in events:
            # TELEMETRY frames may come from a version-skewed (or hostile
            # — the transport spans trust domains) peer: an event without
            # numeric ts/dur would crash the round close downstream, so
            # it is dropped here, at the boundary
            if not isinstance(ev, dict):
                continue
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or not isinstance(
                dur, (int, float)
            ):
                continue
            ev = dict(ev)
            ev["ts"] = ts + off_us
            ev["pid"] = party
            rebased.append(ev)
        with self._lock:
            track = self._tracks.setdefault(party, [])
            track.extend(rebased)
            overflow = len(track) - self.MAX_EVENTS_PER_PARTY
            if overflow > 0:
                del track[:overflow]
                self.dropped += overflow
                # the round mark indexes into the list — shift it with
                # the truncation or finish_round re-reads stale slices
                mark = self._round_marks.get(party, 0)
                self._round_marks[party] = max(0, mark - overflow)
            if metrics is not None:
                self._metrics[party] = dict(metrics)

    def parties(self) -> list[int]:
        with self._lock:
            return sorted(self._tracks)

    def party_metrics(self) -> dict[int, dict]:
        """Last metric-registry snapshot shipped by each party."""
        with self._lock:
            return {p: dict(m) for p, m in self._metrics.items()}

    def events(self) -> list[dict]:
        with self._lock:
            return [e for p in sorted(self._tracks) for e in self._tracks[p]]

    def chrome_trace(self) -> dict:
        """One Chrome trace object: a process_name metadata event names
        each party's track, then every rebased span event, time-sorted."""
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": p,
                "args": {
                    "name": "king (party 0)" if p == 0 else f"party {p}"
                },
            }
            for p in self.parties()
        ]
        evs = sorted(self.events(), key=lambda e: e.get("ts", 0.0))
        return _tracing.chrome_envelope(meta + evs)

    def dump(self, path: str) -> str:
        import json

        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def finish_round(self) -> dict:
        """Close a round: compute the critical path over every event
        added since the previous round boundary, record the
        round_critical_path_seconds / party_straggler_total series, and
        advance the marks. Returns the decomposition."""
        with self._lock:
            fresh: list[dict] = []
            for party, evs in self._tracks.items():
                mark = self._round_marks.get(party, 0)
                fresh.extend(evs[mark:])
                self._round_marks[party] = len(evs)
        cp = critical_path(fresh)
        # same guard as the jobs layer: a single-track round has no
        # straggler and would skew the shared histograms with degenerate
        # zero samples
        if cp["parties"] > 1:
            record_critical_path(cp)
        if cp["parties"]:
            # an empty close (double boundary, nothing since) must not
            # clobber the last real round's decomposition
            self.last_critical_path = cp
        return cp


# honor DG16_AGG at import, like DG16_TRACE_OUT in tracing.py
if _enabled:
    set_enabled(True)
