"""Replica registry: pull-based discovery, scoring, and ejection.

The router never holds a connection-level view of replica health; it
POLLS. Every `poll_s` it GETs each replica's `/readyz` — which since the
fleet PR returns a one-stop JSON **capacity document** (replica id,
device inventory, open breaker count, drain flag, queue shape, SLO burn
summary; docs/FLEET.md) — and folds the answer into a scored table:

    score = (queued + running + 1) / workers * (1 + max SLO burn rate)

Lower is better: the least-loaded replica wins, but a replica eating its
error budget (slo_burn_rate > 1) looks proportionally worse than
its raw queue depth says, so traffic drifts away from a replica that is
slow *before* it is full. Dispatch picks the minimum-score ACTIVE
replica (not draining, breaker closed).

Ejection reuses the mesh breakers' state machine shape (closed ->
open/cooldown -> half-open single probe): `eject_threshold` consecutive
failures — poll errors, connection refusals, 5xx dispatches — trip the
replica out of rotation; after `eject_cooldown_s` ONE probe poll may
readmit it. A replica that 503s because it is DRAINING is not ejected
(it answered; it is deliberately finishing work) but stops receiving new
jobs, and either state hands its journaled backlog to the router's
handoff pass (fleet/router.py).

Pure event-loop-side state; the HTTP GET itself is the router's (async)
job — the registry only ingests outcomes, so it is unit-testable with
canned documents and an injectable clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..telemetry import metrics as _tm
from ..telemetry.aggregate import ClockSync

_REG = _tm.registry()
_SCORE = _REG.gauge(
    "fleet_replica_score",
    "Routing score per replica (lower = preferred): load weighted by "
    "SLO burn rate; -1 while the replica is out of rotation",
    ("replica",),
)
_STATE = _REG.gauge(
    "fleet_replica_state",
    "Replica rotation state: 0 active, 1 draining, 2 ejected "
    "(cooling down / probing)",
    ("replica",),
)
_EJECTIONS = _REG.counter(
    "fleet_replica_ejections_total",
    "Replicas ejected from rotation (consecutive-failure breaker trips)",
    ("replica",),
)

# gauge values are part of the dashboard contract (docs/FLEET.md)
ACTIVE, DRAINING, EJECTED = 0, 1, 2

_STATE_NAMES = {ACTIVE: "active", DRAINING: "draining", EJECTED: "ejected"}


@dataclass
class Replica:
    """One replica as the router knows it."""

    url: str
    journal_dir: str | None = None
    # identity: the url is the stable config name; `replica_id` is what
    # the replica itself reports (DG16_FLEET_REPLICA_ID) once a poll
    # succeeded — operator commands accept either
    replica_id: str = ""
    doc: dict = field(default_factory=dict)  # last capacity document
    state: int = ACTIVE
    failures: int = 0  # consecutive, feeds the ejection breaker
    ejected_at: float = 0.0
    probing: bool = False  # half-open: one probe in flight max
    handoff_done: bool = False  # this outage's backlog already re-routed
    polls_ok: int = 0
    polls_failed: int = 0
    # NTP-style offset estimate (replica_clock − router_clock) fed by
    # the /readyz poll's clock echo — what rebases this replica's trace
    # events onto the router's timeline in the stitched fleet trace
    clock: ClockSync = field(default_factory=ClockSync, repr=False)

    @property
    def name(self) -> str:
        return self.replica_id or self.url

    def score(self) -> float:
        """Routing score from the last capacity document (lower wins)."""
        doc = self.doc
        workers = max(1, int(doc.get("workers", 1)))
        load = (
            int(doc.get("queueDepth", 0)) + int(doc.get("running", 0)) + 1
        ) / workers
        burn = max(0.0, float(doc.get("maxBurnRate", 0.0) or 0.0))
        return load * (1.0 + burn)


class ReplicaRegistry:
    def __init__(
        self,
        replicas,  # ((url, journal_dir | None), ...)
        eject_threshold: int = 3,
        eject_cooldown_s: float = 15.0,
        clock=time.monotonic,
    ):
        self.eject_threshold = eject_threshold
        self.eject_cooldown_s = eject_cooldown_s
        self._clock = clock
        self.replicas: list[Replica] = [
            Replica(url=url, journal_dir=jdir) for url, jdir in replicas
        ]
        for r in self.replicas:
            _STATE.labels(replica=r.name).set(ACTIVE)

    def find(self, name: str) -> Replica | None:
        """By reported id or config URL (operator commands take either)."""
        for r in self.replicas:
            if name in (r.replica_id, r.url, r.name):
                return r
        return None

    # -- poll/dispatch outcome ingestion -------------------------------------

    def note_doc(self, replica: Replica, doc: dict) -> None:
        """A successful /readyz poll (HTTP 200 *or* a parsed 503-drain
        body): refresh the capacity document and the breaker."""
        replica.doc = doc
        replica.polls_ok += 1
        if replica.replica_id == "" and doc.get("replicaId"):
            # first contact: adopt the replica's self-reported id for
            # metrics/commands, migrating the placeholder gauge labels —
            # the URL-labeled series must go, or dashboards see a
            # phantom always-active replica per configured URL
            old = replica.name
            replica.replica_id = str(doc["replicaId"])
            if replica.name != old:
                _STATE.remove(replica=old)
                _SCORE.remove(replica=old)
                # a pre-adoption ejection (unreachable at boot, then
                # recovered) counted under the URL label: carry the
                # count over so one replica's ejections stay one series
                ejected = dict(_EJECTIONS.items()).get((old,))
                if ejected is not None:
                    _EJECTIONS.remove(replica=old)
                    if ejected.value:
                        _EJECTIONS.labels(replica=replica.name).inc(
                            ejected.value
                        )
        draining = bool(doc.get("draining"))
        if replica.state == EJECTED:
            # probe succeeded: the replica answers again. Its journal
            # may hold jobs accepted before the outage — clear the
            # handoff latch only AFTER recovery so the next outage
            # hands off again.
            replica.probing = False
            replica.failures = 0
            replica.handoff_done = False
        replica.state = DRAINING if draining else ACTIVE
        if replica.state == ACTIVE:
            replica.handoff_done = False
        replica.failures = 0
        self._export(replica)

    def note_failure(self, replica: Replica) -> bool:
        """A failed poll or dispatch (connect error, timeout, 5xx).
        Returns True when THIS failure ejects the replica."""
        replica.polls_failed += 1
        if replica.state == EJECTED:
            # a failed half-open probe re-opens the cooldown
            replica.probing = False
            replica.ejected_at = self._clock()
            self._export(replica)
            return False
        if self.eject_threshold <= 0:
            return False
        replica.failures += 1
        if replica.failures >= self.eject_threshold:
            replica.state = EJECTED
            replica.ejected_at = self._clock()
            replica.probing = False
            _EJECTIONS.labels(replica=replica.name).inc()
            self._export(replica)
            return True
        self._export(replica)
        return False

    def pollable(self) -> list[Replica]:
        """Who the discovery loop should GET this tick: every ACTIVE and
        DRAINING replica, plus ejected ones whose cooldown lapsed (one
        half-open probe each)."""
        now = self._clock()
        out = []
        for r in self.replicas:
            if r.state != EJECTED:
                out.append(r)
            elif (
                not r.probing
                and now - r.ejected_at >= self.eject_cooldown_s
            ):
                r.probing = True
                out.append(r)
        return out

    # -- routing --------------------------------------------------------------

    def pick(self) -> Replica | None:
        """The dispatch target: minimum score over ACTIVE replicas."""
        best = None
        for r in self.replicas:
            if r.state != ACTIVE:
                continue
            if best is None or r.score() < best.score():
                best = r
        return best

    def active_count(self) -> int:
        return sum(1 for r in self.replicas if r.state == ACTIVE)

    def needs_handoff(self) -> list[Replica]:
        """Replicas whose journaled backlog should be re-routed now:
        dead (ejected) or draining, not yet handed off this outage."""
        return [
            r
            for r in self.replicas
            if r.state in (EJECTED, DRAINING) and not r.handoff_done
        ]

    def _export(self, replica: Replica) -> None:
        _STATE.labels(replica=replica.name).set(replica.state)
        _SCORE.labels(replica=replica.name).set(
            replica.score() if replica.state == ACTIVE else -1.0
        )

    def stats(self) -> list[dict]:
        """The /fleet/stats replica table (docs/FLEET.md)."""
        rows = []
        for r in self.replicas:
            doc = r.doc
            rows.append(
                {
                    "replicaId": r.name,
                    "url": r.url,
                    "state": _STATE_NAMES[r.state],
                    "score": round(r.score(), 3) if doc else None,
                    "queueDepth": doc.get("queueDepth"),
                    "running": doc.get("running"),
                    "workers": doc.get("workers"),
                    "devices": doc.get("devices"),
                    "openBreakers": doc.get("openBreakers"),
                    "maxBurnRate": doc.get("maxBurnRate"),
                    # the replica's /readyz buildInfo (package version) —
                    # `fleet top` renders it so a rolling upgrade shows
                    # up as a mixed VER column
                    "version": (doc.get("buildInfo") or {}).get("version"),
                    "journal": r.journal_dir,
                    "pollsOk": r.polls_ok,
                    "pollsFailed": r.polls_failed,
                    "clockOffsetS": (
                        round(r.clock.offset_ns / 1e9, 6)
                        if r.clock.n_samples
                        else None
                    ),
                }
            )
        return rows
