"""Fleet metrics federation: one scrape surface over N replica registries.

Each replica serves its own process registry at `/metrics`; an operator
or autoscaler watching the fleet would need N scrape targets and still
could not ask fleet-level questions ("what is the fleet p95?", "how many
breakers are open anywhere?"). The federator closes that gap with the
Monarch/Prometheus-federation shape (docs/OBSERVABILITY.md "Fleet
observatory"):

  * the router's discovery loop scrapes every live replica's `/metrics`
    on the same tick it polls `/readyz` (one extra GET per replica per
    `DG16_FLEET_POLL_S`), and `note_scrape` parses the text back into
    families (`telemetry.metrics.parse_exposition`);
  * `GET /fleet/metrics` re-exports EVERY replica series with a
    `replica="<id>"` label appended — the federation label rule: replica
    series keep their name, labels, type, and bucket layout, they only
    gain the source dimension — rebuilt into a fresh registry per render
    so HELP/TYPE lines stay unique and the output is strict 0.0.4;
  * fleet **rollups** ride the same exposition: the per-replica
    `job_seconds{kind}` histograms merge (cumulative bucket counts add)
    into `fleet_job_seconds{kind}` with p50/p95 read off the merged
    buckets, terminal-job counters sum, and max-burn / open-breaker
    scans give the one-glance fleet health numbers `dg16-cli fleet top`
    renders.

The federator never talks HTTP itself — the router owns the session and
feeds outcomes in, so everything here is unit-testable with canned
exposition text and an injectable clock (same split as the registry).
"""

from __future__ import annotations

import time

from ..telemetry.metrics import (
    DEFAULT_TIME_BUCKETS,
    MetricsRegistry,
    ParsedFamily,
    histogram_quantile,
    histogram_snapshots,
    parse_exposition,
)

# replica anomaly signals need a minimum of evidence: a p95 over 3 jobs
# is noise, not a diagnosis
MIN_ANOMALY_SAMPLES = 5

_ROLLUP_QUANTILES = (("0.5", 0.5), ("0.95", 0.95))


def _fill_histogram_child(child, snap) -> None:
    """Load a HistogramSnapshot into a registry histogram child: the
    snapshot's cumulative bucket counts become the child's per-bucket
    counts (the registry renders them back to cumulative)."""
    cum_prev = 0.0
    for i, cum in enumerate(snap.cumulative):
        child.counts[i] = int(round(cum - cum_prev))
        cum_prev = cum
    child.sum = snap.sum
    child.count = int(round(snap.count))


class MetricsFederator:
    """Parsed per-replica scrapes + the /fleet/metrics render."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._scrapes: dict[str, dict[str, ParsedFamily]] = {}
        self.scrapes_ok = 0
        self.scrapes_failed = 0
        self.series_skipped = 0  # label/type skew vs another replica
        # aggregate job rate over discovery ticks: per-replica counter
        # deltas summed over the tick interval — per-REPLICA, not a
        # grand-total diff, so a replica rejoining after ejection does
        # not replay its whole lifetime count as one tick's rate
        self._last_finished: dict[str, float] = {}
        self._last_tick_t: float | None = None
        self._rate_per_s = 0.0

    # -- ingestion (router discovery loop) ------------------------------------

    def note_scrape(self, replica: str, text: str) -> None:
        """One successful replica /metrics body."""
        try:
            fams = parse_exposition(text)
        except ValueError:
            self.scrapes_failed += 1
            return
        self._scrapes[replica] = fams
        self.scrapes_ok += 1

    def note_failure(self, replica: str) -> None:
        """A failed scrape: counted, last good scrape kept (a transient
        scrape hiccup must not blank the replica out of the fleet view —
        ejection, via retain(), is what removes it)."""
        self.scrapes_failed += 1

    def retain(self, live: set[str]) -> None:
        """Drop scrapes of replicas no longer in rotation (ejected or
        removed): their stale series must not keep shaping rollups."""
        for name in [n for n in self._scrapes if n not in live]:
            del self._scrapes[name]

    def tick(self) -> None:
        """Once per discovery pass: refresh the aggregate job rate from
        the summed per-replica jobs_finished_total deltas. A replica
        seen for the first time this tick (fresh join or rejoin after
        ejection) contributes no delta — its lifetime count is history,
        not this tick's throughput."""
        totals: dict[str, float] = {}
        for name, fams in self._scrapes.items():
            fam = fams.get("jobs_finished_total")
            if fam is None:
                continue
            totals[name] = sum(v for _, _, v in fam.samples)
        now = self._clock()
        if self._last_tick_t is not None:
            dt = now - self._last_tick_t
            if dt > 0:
                delta = sum(
                    # max(0): a replica restart resets its counters —
                    # read that as a quiet tick, not a negative rate
                    max(0.0, total - self._last_finished[name])
                    for name, total in totals.items()
                    if name in self._last_finished
                )
                self._rate_per_s = delta / dt
        self._last_finished = totals
        self._last_tick_t = now

    def replicas(self) -> list[str]:
        return sorted(self._scrapes)

    # -- derived per-replica signals (the anomaly hook + fleet top) -----------

    def replica_p95(self, min_count: int = MIN_ANOMALY_SAMPLES) -> dict:
        """{replica: p95 seconds} over job_seconds merged across kinds;
        replicas with fewer than `min_count` finished jobs are omitted."""
        out: dict[str, float] = {}
        for name, fams in self._scrapes.items():
            fam = fams.get("job_seconds")
            if fam is None or fam.kind != "histogram":
                continue
            snaps = histogram_snapshots(fam)
            snap = snaps.get(())
            if snap is None or snap.count < min_count:
                continue
            out[name] = histogram_quantile(snap, 0.95)
        return out

    def replica_burn(self) -> dict:
        """{replica: max slo_burn_rate across kinds} — only replicas
        actually exporting the gauge (SLO plane on)."""
        out: dict[str, float] = {}
        for name, fams in self._scrapes.items():
            fam = fams.get("slo_burn_rate")
            if fam is None or not fam.samples:
                continue
            out[name] = max(v for _, _, v in fam.samples)
        return out

    # -- the /fleet/metrics render ---------------------------------------------

    def render(self) -> str:
        """Strict Prometheus 0.0.4: replica-labeled re-exports of every
        scraped family, then the fleet rollups. Built into a FRESH
        registry each time so the router's own families never collide
        with replica families of the same name."""
        reg = MetricsRegistry()
        for rname in sorted(self._scrapes):
            for fam_name in sorted(self._scrapes[rname]):
                self._export_family(reg, rname, self._scrapes[rname][fam_name])
        self._export_rollups(reg)
        return reg.render_prometheus()

    def _export_family(
        self, reg: MetricsRegistry, rname: str, fam: ParsedFamily
    ) -> None:
        if fam.kind not in ("counter", "gauge", "histogram") or not fam.samples:
            return
        base_labels = sorted(
            {k for _, labels, _ in fam.samples for k in labels} - {"le"}
        )
        labelnames = tuple(base_labels) + ("replica",)
        try:
            if fam.kind == "histogram":
                self._export_histogram(reg, rname, fam, labelnames)
            else:
                f = getattr(reg, fam.kind)(fam.name, fam.help, labelnames)
                for sname, labels, value in fam.samples:
                    if sname != fam.name:
                        continue
                    child = f.labels(**{**labels, "replica": rname})
                    child.value = value
        except ValueError:
            # label-set/type/bucket skew against another replica's export
            # (version skew mid-rolling-restart): skip THIS family for
            # THIS replica rather than 500 the whole federation route
            self.series_skipped += 1

    def _export_histogram(
        self, reg, rname: str, fam: ParsedFamily, labelnames: tuple
    ) -> None:
        # group_by every base label: each series is its own group, so
        # this is a pure regroup through the shared snapshot utility,
        # never a merge
        base = tuple(n for n in labelnames if n != "replica")
        snaps = histogram_snapshots(fam, group_by=base)
        bounds = None
        for snap in snaps.values():
            if snap.bounds:
                bounds = snap.bounds
                break
        if bounds is None:
            return
        f = reg.histogram(fam.name, fam.help, labelnames, buckets=bounds)
        for key, snap in snaps.items():
            if snap.bounds != f.buckets:
                self.series_skipped += 1
                continue
            child = f.labels(**dict(zip(base, key)), replica=rname)
            _fill_histogram_child(child, snap)

    def _export_rollups(self, reg: MetricsRegistry) -> None:
        # merged job_seconds per kind across every replica: concatenating
        # the families' samples and grouping by kind IS the merge —
        # cumulative bucket counts add (telemetry.metrics snapshot math)
        merged = ParsedFamily("job_seconds", "histogram")
        for fams in self._scrapes.values():
            fam = fams.get("job_seconds")
            if fam is not None and fam.kind == "histogram":
                merged.samples.extend(fam.samples)
        per_kind = histogram_snapshots(merged, group_by=("kind",))
        bounds = None
        for snap in per_kind.values():
            if snap.bounds:
                bounds = snap.bounds
                break
        hist = reg.histogram(
            "fleet_job_seconds",
            "End-to-end job runtime merged across every replica, per kind "
            "— the fleet-wide latency distribution",
            ("kind",),
            buckets=bounds or DEFAULT_TIME_BUCKETS,
        )
        quant = reg.gauge(
            "fleet_job_quantile_seconds",
            "Latency quantiles read off the merged fleet job_seconds "
            "buckets, per kind (q = 0.5 | 0.95)",
            ("kind", "q"),
        )
        for (kind,), snap in sorted(per_kind.items()):
            if snap.bounds != hist.buckets:
                # bucket-layout skew across replicas (mid-rolling-restart
                # version skew): the merged cumulative list interleaves
                # two layouts and is meaningless — export neither the
                # histogram nor quantiles read off it
                self.series_skipped += 1
                continue
            _fill_histogram_child(hist.labels(kind=kind), snap)
            for qs, q in _ROLLUP_QUANTILES:
                quant.labels(kind=kind, q=qs).set(
                    histogram_quantile(snap, q)
                )

        finished = reg.counter(
            "fleet_jobs_finished_total",
            "Terminal jobs summed across every replica, per state",
            ("state",),
        )
        totals: dict[str, float] = {}
        burn = 0.0
        open_breakers = 0
        for fams in self._scrapes.values():
            fam = fams.get("jobs_finished_total")
            if fam is not None:
                for _, labels, value in fam.samples:
                    state = labels.get("state", "")
                    totals[state] = totals.get(state, 0.0) + value
            fam = fams.get("slo_burn_rate")
            if fam is not None and fam.samples:
                burn = max(burn, max(v for _, _, v in fam.samples))
            fam = fams.get("mesh_breaker_state")
            if fam is not None:
                open_breakers += sum(
                    1 for _, _, v in fam.samples if v != 0
                )
        for state, total in sorted(totals.items()):
            finished.labels(state=state).value = total

        reg.gauge(
            "fleet_jobs_per_second",
            "Aggregate terminal-job rate across the fleet over the last "
            "discovery tick",
        ).set(round(self._rate_per_s, 4))
        reg.gauge(
            "fleet_max_burn_rate",
            "Worst slo_burn_rate across every replica and kind — the "
            "autoscaler's one-number fleet SLO signal",
        ).set(burn)
        reg.gauge(
            "fleet_open_breakers",
            "Mesh circuit breakers not closed (half-open or cooling) "
            "summed across the fleet",
        ).set(open_breakers)
        reg.gauge(
            "fleet_replicas_scraped",
            "Replicas whose /metrics contributed to this federated view",
        ).set(len(self._scrapes))
