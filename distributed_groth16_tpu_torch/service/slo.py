"""SLO burn-rate monitor: error budgets derived from existing series.

The service already measures everything an SLO needs — `job_seconds{kind}`
histograms and the `jobs_*_total` counters — but a router or
autoscaler can't act on raw histograms: it needs ONE number per replica
per job kind saying "this replica is eating its error budget N times
faster than sustainable". That is the burn rate.

Definitions (Google SRE workbook semantics, latency SLO):

  * A job of kind k is GOOD when its end-to-end runtime lands within the
    kind's target (`SLOConfig.target_for`), BAD otherwise. Goodness is
    read off the `job_seconds{kind}` bucket counts — observations in
    buckets whose upper bound <= target count as good, so a target
    between bucket bounds is rounded DOWN (conservative: jobs in the
    straddling bucket count bad). Failed jobs observe their runtime too,
    so a fast-failing job only burns budget via `jobs_finished_total`
    dashboards — the SLO here is a latency objective.
  * Error budget: over a rolling `window_s`, `(1 - objective)` of the
    kind's jobs may be bad.
  * `slo_burn_rate{kind}` = (bad/total in window) / (1 - objective) —
    1.0 means "exactly on budget", 2.0 means the budget dies in half a
    window.
  * `slo_budget_remaining{kind}` = 1 - bad/allowed, clamped at no floor
    (negative = overdrawn).

The monitor samples cumulative series into a per-kind ring of snapshots
and differences against the oldest in-window snapshot, so process-lifetime
counters become windowed rates without any new instrumentation at the
call sites. On budget exhaustion it writes one flight-recorder post-mortem
(trigger `slo_budget_exhausted`, `telemetry/flight.py`) per episode and
re-arms once the budget recovers — the dump carries the span/net rings
that explain WHY latency degraded, not just that it did.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque

from ..telemetry import flight as _flight
from ..telemetry import metrics as _tm
from ..utils.config import SLOConfig

_REG = _tm.registry()
_BURN = _REG.gauge(
    "slo_burn_rate",
    "Error-budget burn rate per job kind over the SLO window (1.0 = "
    "exactly on budget; >1 the budget dies before the window does)",
    ("kind",),
)
_BUDGET = _REG.gauge(
    "slo_budget_remaining",
    "Fraction of the windowed error budget left per job kind (negative = "
    "overdrawn; 1.0 = untouched)",
    ("kind",),
)


class SloMonitor:
    """Derives the SLO gauges from the metrics registry. `now` is
    injectable for window tests (same pattern as the scheduler clock)."""

    def __init__(self, cfg: SLOConfig, now=time.monotonic):
        self.cfg = cfg
        self._now = now
        self._lock = threading.Lock()
        # kind -> ring of (t, cumulative_total, cumulative_bad)
        self._rings: dict[str, deque] = {}
        self._exhausted: set[str] = set()
        # baseline snapshot: jobs finished before the monitor existed
        # belong to no window — a kind's ring is seeded from this when it
        # first shows up in a sample
        self._base = self._cumulative()

    # -- cumulative reads off the registry ----------------------------------

    def _cumulative(self) -> dict[str, tuple[int, int]]:
        """{kind: (total, bad)} from the job_seconds{kind} histogram."""
        fam = _REG.family("job_seconds")
        out: dict[str, tuple[int, int]] = {}
        if fam is None:
            return out
        for values, child in fam.items():
            kind = dict(zip(fam.labelnames, values)).get("kind")
            if kind is None:
                continue
            target = self.cfg.target_for(kind)
            i = bisect_right(fam.buckets, target) - 1
            good = sum(child.counts[: i + 1])
            out[kind] = (child.count, child.count - good)
        return out

    # -- the sampler ---------------------------------------------------------

    def sample(self) -> dict:
        """Advance every kind's window, refresh the gauges, and return the
        `/slo` / `/stats` document. Cheap pure-Python dict math — safe to
        call from the event loop."""
        t = self._now()
        kinds_doc: dict[str, dict] = {}
        with self._lock:
            cum = self._cumulative()
            # kinds with explicit targets are reported even before their
            # first job, so dashboards see the objective exists
            for kind, _ in self.cfg.targets:
                cum.setdefault(kind, (0, 0))
            for kind, (total, bad) in sorted(cum.items()):
                ring = self._rings.get(kind)
                if ring is None:
                    ring = self._rings[kind] = deque()
                    bt, bb = self._base.get(kind, (0, 0))
                    ring.append((t, bt, bb))
                ring.append((t, total, bad))
                while len(ring) > 1 and t - ring[0][0] > self.cfg.window_s:
                    ring.popleft()
                t0, total0, bad0 = ring[0]
                wtotal = total - total0
                wbad = bad - bad0
                kinds_doc[kind] = self._judge(kind, wtotal, wbad)
        return {
            "enabled": True,
            "objective": self.cfg.objective,
            "windowS": self.cfg.window_s,
            "sampleS": self.cfg.sample_s,
            "kinds": kinds_doc,
        }

    def _judge(self, kind: str, wtotal: int, wbad: int) -> dict:
        allowed = (1.0 - self.cfg.objective) * wtotal
        if wtotal <= 0:
            burn, remaining = 0.0, 1.0
        elif allowed > 0:
            burn = (wbad / wtotal) / (1.0 - self.cfg.objective)
            remaining = 1.0 - wbad / allowed
        else:
            # objective == 1.0: zero budget — any bad job exhausts it
            burn = 0.0 if wbad == 0 else float(wbad)
            remaining = 1.0 if wbad == 0 else -float(wbad)
        _BURN.labels(kind=kind).set(burn)
        _BUDGET.labels(kind=kind).set(remaining)
        exhausted = wtotal > 0 and remaining <= 0.0
        if exhausted and kind not in self._exhausted:
            self._exhausted.add(kind)
            _flight.dump_soon(
                "slo_budget_exhausted",
                extra={
                    "kind": kind,
                    "targetS": self.cfg.target_for(kind),
                    "objective": self.cfg.objective,
                    "windowS": self.cfg.window_s,
                    "windowTotal": wtotal,
                    "windowBad": wbad,
                    "burnRate": burn,
                },
            )
        elif not exhausted:
            self._exhausted.discard(kind)
        return {
            "targetS": self.cfg.target_for(kind),
            "windowTotal": wtotal,
            "windowBad": wbad,
            "burnRate": round(burn, 4),
            "budgetRemaining": round(remaining, 4),
            "exhausted": exhausted,
        }


def disabled_doc() -> dict:
    """The `/stats`/`/slo` shape when no SLO is configured."""
    return {"enabled": False}
