"""The fleet front door: one router process over N replica ApiServers.

zkSaaS scales one star (a king + n-1 clients); "heavy traffic from
millions of users" needs many stars behind one door. The router is that
door (docs/FLEET.md): a thin aiohttp process that owns NO proving code —
it admits, schedules, dispatches, proxies, and hands off. Each replica
is a full crash-safe ApiServer with its own device inventory and
durable journal; all replicas share the circuit store.

Request path for `POST /jobs/prove` (and its verification-plane siblings
`POST /jobs/verify` / `POST /jobs/aggregate` — same admission, same
weighted-fair queue, dispatched to the matching replica endpoint;
docs/VERIFY.md):

  1. tenant identity from the `X-DG16-Tenant` header (absent ->
     "anonymous") and a priority class from `X-DG16-Priority` /
     the `priority` multipart field (interactive | batch | bulk);
  2. admission: the tenant's token bucket + in-flight quota
     (fleet/tenants.py) and the router's dispatch-backlog bound — any
     failure is HTTP 429 whose retryAfter is the MAX over the tenant
     bucket's refill hint and the replicas' own last 429 hints;
  3. the job enters the weighted-fair dispatch queue and the response
     returns immediately (202, state PENDING) — same contract as a
     replica's jobs API, one hop earlier;
  4. the dispatcher pops fairly (tenants round-robin inside classes,
     classes by weight) and POSTs to the least-loaded live replica
     (registry score: load x (1 + SLO burn)), carrying a router-minted
     `job_id` so any re-submission is idempotent;
  5. status/result/trace/cancel proxy through the router by job id —
     clients never need to know which replica proved their job.

Journal-backed handoff: when a replica is EJECTED (stopped answering /
kept 5xx-ing) or begins DRAINING, the router reads its journal directory
(shared filesystem — `DG16_FLEET_REPLICAS=url=journal-dir`) off the event
loop and re-submits every replayable job to a healthy replica under the
SAME job id. If the "dead" replica was merely slow and replays its own
journal too, both sides converge: submission is idempotent by job id on
every replica and in every journal, so the job proves at most once per
replica and the client sees one terminal state. Nothing accepted is lost.

Fleet observatory (docs/OBSERVABILITY.md): the router mints a `trace_id`
next to the job id and propagates it in `X-DG16-Trace`; every hop the
job takes at the front door is a router-side span, and
`GET /fleet/jobs/{id}/trace` stitches them with the replica's merged job
trace (ClockSync-rebased from /readyz poll echoes) into ONE Chrome
trace. The discovery loop also scrapes each replica's `/metrics` and
`GET /fleet/metrics` federates them (fleet/federate.py); an anomaly hook
flight-dumps replicas whose p95/burn deviates from the fleet median.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import statistics
import time
import uuid
from dataclasses import dataclass, field
from collections import deque

import aiohttp
from aiohttp import web

from ..service.journal import read_journal
from ..telemetry import flight as _flight
from ..telemetry import logbus as _logbus
from ..telemetry import metrics as _tm
from ..telemetry.aggregate import ClockSync, now_ns as _now_ns
from ..utils.config import FleetConfig, TenantConfig
from .federate import MetricsFederator
from .registry import ACTIVE, DRAINING, EJECTED, Replica, ReplicaRegistry
from .tenants import (
    DEFAULT_PRIORITY,
    DEFAULT_TENANT,
    TenantAdmission,
    TenantQuotaError,
    WeightedFairQueue,
)

log = logging.getLogger(__name__)

MAX_BODY = 100 * 1024 * 1024  # mirror the replica body cap

_TERMINAL = ("DONE", "FAILED", "CANCELLED")

# the router's track id in stitched fleet traces: far above any MPC party
# pid (a replica trace uses 0..n-1), so the three tiers never collide
ROUTER_PID = 9999

# per-job router span cap: a job normally records a handful (admission,
# one queue wait, one dispatch); a pathological requeue loop must not
# grow an unbounded event list on a retained job
MAX_JOB_SPANS = 256

_REG = _tm.registry()
_ROUTED = _REG.counter(
    "fleet_jobs_routed_total",
    "Jobs dispatched to a replica, per tenant and priority class",
    ("tenant", "priority"),
)
_HANDOFFS = _REG.counter(
    "fleet_handoffs_total",
    "Journaled jobs re-submitted to a healthy replica after their "
    "owner died (death) or began draining (drain)",
    ("reason",),
)
_HTTP_SECONDS = _REG.histogram(
    "fleet_http_seconds",
    "Router front-door HTTP latency per route and status code — "
    "measured in middleware, so front-door cost is separable from "
    "replica latency",
    ("route", "code"),
)
_PROXY_ERRORS = _REG.counter(
    "fleet_proxy_errors_total",
    "Proxied replica requests that failed at the router (unreachable "
    "replica, bad body), per route",
    ("route",),
)
_ANOMALIES = _REG.counter(
    "fleet_anomalies_total",
    "Fleet-anomaly episodes: a replica's p95 or burn rate exceeded the "
    "fleet median by DG16_FLEET_ANOMALY_FACTOR (each also writes a "
    "flight-recorder dump, trigger fleet_anomaly)",
    ("replica", "signal"),
)


def _error(msg: str, status: int = 500) -> web.Response:
    return web.json_response({"error": msg}, status=status)


def _busy(tenant: str, reason: str, retry_after_s: float,
          detail: str) -> web.Response:
    return web.json_response(
        {
            "error": detail,
            "tenant": tenant,
            "reason": reason,
            "retryAfter": round(retry_after_s, 1),
        },
        status=429,
        headers={"Retry-After": str(int(retry_after_s) or 1)},
    )


async def _read_multipart(request) -> dict[str, bytes]:
    # deliberately NOT imported from api.server: the router owns no
    # proving code, so it must not depend on the prover-facing module
    reader = await request.multipart()
    out = {}
    async for part in reader:
        out[part.name] = await part.read(decode=False)
    return out


@dataclass
class RoutedJob:
    """One job as the router tracks it: identity + placement, never the
    payload once dispatched (the replica's journal is the durable copy;
    holding every payload in router memory would cap the fleet at the
    router's RAM)."""

    id: str
    tenant: str
    priority: str
    circuit_id: str
    kind: str
    # end-to-end trace id, minted next to the job id and propagated to
    # the replica in X-DG16-Trace (docs/OBSERVABILITY.md)
    trace_id: str = ""
    state: str = "PENDING"
    replica: Replica | None = None
    created_at: float = field(default_factory=time.time)
    attempts: int = 0
    charged: bool = True  # holds a tenant in-flight slot until terminal
    cancelled: bool = False  # DELETE before dispatch: dispatcher skips
    error: dict | None = None  # router-side terminal failure, if any
    # router-side spans of this job's life at the front door (Chrome
    # trace-event dicts on the router's perf_counter clock): admission,
    # each queue wait, each dispatch attempt, handoff — the router tier
    # of the stitched GET /fleet/jobs/{id}/trace
    spans: list = field(default_factory=list, repr=False)
    queued_pc: float = 0.0  # perf_counter at the last enqueue

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    def record_span(self, name: str, t0: float, dur: float, **attrs) -> None:
        if len(self.spans) >= MAX_JOB_SPANS:
            return
        self.spans.append(
            {
                "name": name,
                "ph": "X",
                "ts": round(t0 * 1e6, 1),
                "dur": round(dur * 1e6, 1),
                "pid": ROUTER_PID,
                "tid": 0,
                "args": attrs,
            }
        )

    def to_dict(self) -> dict:
        out = {
            "jobId": self.id,
            "tenant": self.tenant,
            "priority": self.priority,
            "traceId": self.trace_id,
            "circuitId": self.circuit_id,
            "state": self.state,
            "replica": self.replica.name if self.replica else None,
            "createdAt": self.created_at,
        }
        if self.error is not None:
            out["error"] = self.error
        return out


class FleetRouter:
    def __init__(
        self,
        cfg: FleetConfig | None = None,
        tenant_cfg: TenantConfig | None = None,
    ):
        self.cfg = cfg or FleetConfig.from_env()
        # logging spine: ring handler on (idempotent — an in-process
        # test fleet shares one ring with its replicas; the /fleet logs
        # route filters to fleet-tier loggers to stay distinct)
        _logbus.setup(console=False)
        self.registry = ReplicaRegistry(
            self.cfg.replicas,
            eject_threshold=self.cfg.eject_threshold,
            eject_cooldown_s=self.cfg.eject_cooldown_s,
        )
        self.admission = TenantAdmission(tenant_cfg or TenantConfig.from_env())
        self.queue = WeightedFairQueue(self.cfg.weights)
        self.federator = MetricsFederator()
        # (replica, signal) pairs currently over the anomaly threshold —
        # one flight dump per episode, re-armed on recovery
        self._anomaly_latched: set[tuple[str, str]] = set()
        self.jobs: dict[str, RoutedJob] = {}
        self._payloads: dict[str, dict[str, bytes]] = {}  # pending only
        self._terminal_order: deque[str] = deque()
        self.draining = False
        self.handoffs = 0
        self._last_replica_hint = 0.0  # newest replica-side 429 retryAfter
        self._hint_at = 0.0  # when it arrived (monotonic)
        self._wake: asyncio.Event | None = None
        self._tasks: list[asyncio.Task] = []
        self._session: aiohttp.ClientSession | None = None

    # -- lifecycle ------------------------------------------------------------

    async def _on_startup(self, app) -> None:
        # force_close: a pooled keepalive socket to a dead replica hides
        # the death until a write fails mid-request — a router must learn
        # about replica loss at connect time, not from a torn response
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(force_close=True)
        )
        self._wake = asyncio.Event()
        self._tasks = [
            asyncio.create_task(self._discovery_loop(), name="fleet-poll"),
            asyncio.create_task(self._dispatch_loop(), name="fleet-dispatch"),
        ]

    async def _on_cleanup(self, app) -> None:
        self.draining = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._session is not None:
            await self._session.close()
            self._session = None

    # -- discovery ------------------------------------------------------------

    async def _discovery_loop(self) -> None:
        while True:
            try:
                await self.poll_once()
                self.federator.retain(
                    {
                        r.name
                        for r in self.registry.replicas
                        if r.state != EJECTED
                    }
                )
                self.federator.tick()
                self._anomaly_pass()
                await self._handoff_pass()
                await self._sweep_jobs()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — discovery must not die
                log.exception("fleet discovery pass failed")
            await asyncio.sleep(self.cfg.poll_s)

    async def poll_once(self) -> None:
        """One discovery tick: GET every pollable replica's /readyz."""
        await asyncio.gather(
            *(self._poll_replica(r) for r in self.registry.pollable())
        )

    def _note_replica_failure(self, replica: Replica, op: str) -> None:
        """Feed the ejection breaker; an ejection is a fleet-tier fault
        the flight recorder must witness (docs/OBSERVABILITY.md)."""
        if self.registry.note_failure(replica):
            log.warning("replica %s ejected (%s)", replica.name, op)
            _flight.note(
                "replica_ejected", replica=replica.name, op=op
            )
            _flight.dump_soon(
                "replica_ejected",
                extra={"replica": replica.name, "op": op},
            )

    async def _poll_replica(self, replica: Replica) -> None:
        # the poll doubles as a clock-echo round (NTP-style, the
        # transport heartbeat's shape): t0/t3 on the router's perf_counter_ns, t1/t2
        # echoed by the replica — feeding the per-replica ClockSync that
        # rebases its trace events in the stitched fleet trace
        t0 = _now_ns()
        try:
            async with self._session.get(
                f"{replica.url}/readyz",
                params={"echo": str(t0)},
                timeout=aiohttp.ClientTimeout(total=max(1.0, self.cfg.poll_s)),
            ) as resp:
                doc = await resp.json()
            t3 = _now_ns()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError) as e:
            log.debug("poll %s failed: %r", replica.name, e)
            self._note_replica_failure(replica, "poll")
            return
        # 503 + draining body is an ANSWER (deliberate drain), any other
        # non-200 is a failure
        if resp.status == 200 or doc.get("draining"):
            echo = doc.get("clockEcho") or {}
            try:
                t1, t2 = int(echo["t1"]), int(echo["t2"])
            except (KeyError, TypeError, ValueError):
                pass  # pre-echo replica: stitching falls back to offset 0
            else:
                replica.clock.add_sample(*ClockSync.from_echo(t0, t1, t2, t3))
            self.registry.note_doc(replica, doc)
            if self._wake is not None:
                # capacity may have appeared — wake the dispatcher
                # BEFORE the federation scrape, so a slow /metrics
                # cannot delay queued jobs that already have a home
                self._wake.set()
            await self._scrape_replica(replica)
        else:
            self._note_replica_failure(replica, "poll")

    async def _scrape_replica(self, replica: Replica) -> None:
        """Federation scrape, same tick as the capacity poll. A failed
        scrape never feeds the ejection breaker — /readyz just answered,
        so the replica is alive; only the fleet view goes stale."""
        try:
            async with self._session.get(
                f"{replica.url}/metrics",
                timeout=aiohttp.ClientTimeout(total=max(1.0, self.cfg.poll_s)),
            ) as resp:
                if resp.status != 200:
                    self.federator.note_failure(replica.name)
                    return
                text = await resp.text()
        except (aiohttp.ClientError, asyncio.TimeoutError):
            self.federator.note_failure(replica.name)
            return
        self.federator.note_scrape(replica.name, text)

    # -- fleet anomaly hook ----------------------------------------------------

    def _anomaly_pass(self) -> None:
        """Flag replicas whose federated p95 or SLO burn deviates from
        the fleet median beyond the knob'd factor: one counter increment
        and one flight-recorder post-mortem per episode (latched until
        the signal recovers). Needs >= 3 replicas with data — a median
        of two is just the other replica."""
        factor = self.cfg.anomaly_factor
        if factor <= 0:
            return
        self._check_anomaly("p95_seconds", self.federator.replica_p95(), factor)
        self._check_anomaly("burn_rate", self.federator.replica_burn(), factor)

    def _check_anomaly(self, signal: str, values: dict, factor: float) -> None:
        # a replica that stopped reporting this signal (ejected, or a
        # restart reset it below the sample floor) re-arms: its next
        # episode after rejoining must dump again, not hit a stale latch
        self._anomaly_latched -= {
            (name, sig)
            for name, sig in self._anomaly_latched
            if sig == signal and name not in values
        }
        if len(values) < 3:
            return
        median = statistics.median(values.values())
        if median <= 0:
            return
        for name, value in values.items():
            key = (name, signal)
            if value > median * factor:
                if key in self._anomaly_latched:
                    continue
                self._anomaly_latched.add(key)
                _ANOMALIES.labels(replica=name, signal=signal).inc()
                log.warning(
                    "fleet anomaly: replica %s %s=%.3f vs fleet median %.3f",
                    name, signal, value, median,
                )
                _flight.note(
                    "fleet_anomaly", replica=name, signal=signal,
                    value=value, median=median,
                )
                _flight.dump_soon(
                    "fleet_anomaly",
                    extra={
                        "replica": name,
                        "signal": signal,
                        "value": value,
                        "fleetMedian": median,
                        "factor": factor,
                    },
                )
            else:
                self._anomaly_latched.discard(key)

    # -- handoff --------------------------------------------------------------

    async def _handoff_pass(self) -> None:
        for replica in self.registry.needs_handoff():
            await self._handoff(replica)

    async def _handoff(self, replica: Replica) -> int:
        """Re-route a dead/draining replica's journaled backlog. Latches
        per outage (handoff_done) so one death costs one journal read."""
        reason = "death" if replica.state == EJECTED else "drain"
        if not replica.journal_dir:
            replica.handoff_done = True
            log.warning(
                "replica %s needs handoff but has no journal dir configured "
                "— its accepted jobs must wait for its own restart replay",
                replica.name,
            )
            return 0
        # journal parse decodes every live payload — never on the loop.
        # The latch is only set AFTER the read succeeds: a transient
        # read error (shared-journal mount hiccup) must leave the
        # handoff retryable on the next discovery pass, not strand the
        # dead replica's accepted jobs forever.
        t_read0 = time.perf_counter()
        entries = await asyncio.to_thread(read_journal, replica.journal_dir)
        replica.handoff_done = True
        moved = 0
        for e in entries:
            if not e.replayable:
                continue
            known = self.jobs.get(e.id)
            if known is not None:
                if known.terminal or known.state == "PENDING":
                    continue  # finished, or already re-queued for dispatch
                if known.replica is not None and known.replica is not replica:
                    # a PREVIOUS handoff already moved it to a healthy
                    # replica (the dead one's journal still lists it
                    # live) — re-queueing would run the proof again and
                    # regress the client-visible state to PENDING
                    continue
            job = known or RoutedJob(
                id=e.id,
                tenant=e.tenant or DEFAULT_TENANT,
                priority=e.priority or DEFAULT_PRIORITY,
                circuit_id=e.circuit_id,
                kind=e.kind,
                # the journaled trace id survives the handoff: the
                # re-proved job stitches into the SAME end-to-end trace
                trace_id=e.trace_id or uuid.uuid4().hex,
                created_at=e.created_at,
                # jobs the router never admitted (posted straight to the
                # replica) are grandfathered: no tenant slot to release
                charged=False,
            )
            job.state = "PENDING"
            job.replica = None
            self.jobs[job.id] = job
            job.record_span(
                "fleet.handoff",
                t_read0,
                time.perf_counter() - t_read0,
                source=replica.name,
                reason=reason,
            )
            # rebuild the full submission: the journal keeps the payload
            # fields (witness/input bytes) and the rest of the identity
            # as record columns. The re-queued payloads live in router
            # memory until re-dispatched — bounded by the dead replica's
            # own admission bound (its journal can hold at most one
            # queue's worth of live jobs), and deliberately exempt from
            # pending_bound: these jobs were already accepted once.
            fields = dict(e.fields)
            fields["circuit_id"] = e.circuit_id.encode()
            fields["l"] = str(e.l).encode()
            if e.kind == "mpc_prove":
                fields["mpc"] = b"1"
            self._payloads[job.id] = fields
            self._queue_job(job)
            _HANDOFFS.labels(reason=reason).inc()
            self.handoffs += 1
            moved += 1
        if moved:
            log.info(
                "handoff: re-queued %d journaled job(s) from %s (%s)",
                moved, replica.name, reason,
            )
            _flight.note(
                "fleet_handoff", replica=replica.name, reason=reason,
                moved=moved,
            )
            _flight.dump_soon(
                "fleet_handoff",
                extra={
                    "replica": replica.name,
                    "reason": reason,
                    "moved": moved,
                },
            )
            if self._wake is not None:
                self._wake.set()
        return moved

    # -- job-state sweep ------------------------------------------------------

    async def _sweep_jobs(self) -> None:
        """Refresh non-terminal dispatched jobs from their replicas and
        release tenant in-flight slots as they finish — the quota must
        not depend on clients polling through the router."""
        live = [
            j for j in self.jobs.values()
            # EJECTED owners are unreachable; handoff owns those jobs
            if j.replica is not None and not j.terminal
            and j.replica.state != EJECTED
        ]
        # concurrent like poll_once: a sweep must cost one timeout, not
        # one per job, or a slow replica stalls ejection and handoff
        await asyncio.gather(*(self._sweep_one(j) for j in live))

    async def _sweep_one(self, job: RoutedJob) -> None:
        try:
            async with self._session.get(
                f"{job.replica.url}/jobs/{job.id}",
                timeout=aiohttp.ClientTimeout(total=max(1.0, self.cfg.poll_s)),
            ) as resp:
                if resp.status != 200:
                    return
                body = await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return
        self._note_state(job, body.get("state", job.state))

    def _note_state(self, job: RoutedJob, state: str) -> None:
        if job.terminal:
            return
        job.state = state
        if job.terminal:
            self._payloads.pop(job.id, None)
            if job.charged:
                self.admission.release(job.tenant)
                job.charged = False
            self._note_terminal(job)

    def _note_terminal(self, job: RoutedJob) -> None:
        self._terminal_order.append(job.id)
        while len(self._terminal_order) > self.cfg.history:
            jid = self._terminal_order.popleft()
            j = self.jobs.get(jid)
            if j is not None and j.terminal:
                del self.jobs[jid]

    # -- dispatch -------------------------------------------------------------

    def _queue_job(self, job: RoutedJob) -> None:
        """Every enqueue goes through here so the queue-wait span always
        has its start stamp."""
        job.queued_pc = time.perf_counter()
        self.queue.push(job.tenant, job.priority, job)

    async def _dispatch_loop(self) -> None:
        while True:
            job = self.queue.pop()
            if job is None:
                await self._wait_for_work()
                continue
            if job.queued_pc:
                now = time.perf_counter()
                job.record_span(
                    "fleet.queue", job.queued_pc, now - job.queued_pc,
                    priority=job.priority,
                )
                job.queued_pc = 0.0
            if job.cancelled:
                self._note_state(job, "CANCELLED")
                continue
            ok = await self._dispatch(job)
            if not ok:
                # no replica could take it right now: back of its own
                # tenant line, then wait for capacity (a poll refreshes
                # scores and sets the wake event)
                self._queue_job(job)
                await self._wait_for_work()

    async def _wait_for_work(self) -> None:
        try:
            await asyncio.wait_for(self._wake.wait(), self.cfg.poll_s)
        except asyncio.TimeoutError:
            pass
        self._wake.clear()

    async def _dispatch(self, job: RoutedJob) -> bool:
        """Try every active replica best-first; True once one accepted."""
        if job.id not in self._payloads:
            return True  # cancelled or finished under us: nothing to send
        tried: set[str] = set()
        outcomes: list[str] = []
        while True:
            replica = self._pick_excluding(tried)
            if replica is None:
                if outcomes and all(o == "errored" for o in outcomes):
                    # every live replica saw the payload and 5xx'd it:
                    # that is the submission's problem, not a transient
                    # hiccup — terminal-fail instead of requeueing a
                    # poison pill forever
                    self._payloads.pop(job.id, None)
                    self._note_state(job, "FAILED")
                    _flight.note(
                        "fleet_dispatch_failed", job=job.id,
                        attempts=job.attempts,
                        error=(job.error or {}).get("message"),
                    )
                    _flight.dump_soon(
                        "fleet_dispatch_failed",
                        extra={
                            "job": job.id,
                            "attempts": job.attempts,
                            "error": job.error,
                        },
                    )
                    return True
                return False
            tried.add(replica.url)
            job.attempts += 1
            outcome = await self._submit_to(replica, job)
            if outcome in ("accepted", "rejected"):
                return True
            outcomes.append(outcome)
            # "busy", "failed", and "errored" all fall through to the
            # next-best replica; note_failure already advanced the
            # ejection breaker on "failed"

    def _replica_hint(self) -> float:
        """The replicas' last 429 retryAfter, if RECENT — a spike hint
        from hours ago must not inflate today's 429s against an idle
        fleet, so it expires after a minute."""
        if time.monotonic() - self._hint_at > 60.0:
            return 0.0
        return self._last_replica_hint

    def _pick_excluding(self, tried: set) -> Replica | None:
        best = None
        for r in self.registry.replicas:
            if r.url in tried or r.state != ACTIVE:
                continue
            if best is None or r.score() < best.score():
                best = r
        return best

    async def _submit_to(self, replica: Replica, job: RoutedJob) -> str:
        """One dispatch attempt, recorded as a fleet.dispatch span so the
        stitched trace shows every replica the payload visited."""
        t0 = time.perf_counter()
        outcome = await self._submit_to_inner(replica, job)
        job.record_span(
            "fleet.dispatch", t0, time.perf_counter() - t0,
            replica=replica.name, outcome=outcome,
        )
        return outcome

    async def _submit_to_inner(self, replica: Replica, job: RoutedJob) -> str:
        fields = self._payloads.get(job.id)
        if fields is None:  # cancelled/handed off under us
            return "accepted"
        form = aiohttp.FormData()
        for name, value in fields.items():
            form.add_field(name, value, filename=name)
        form.add_field("job_id", job.id)
        # kind picks the replica endpoint: the verification plane has
        # its own submission routes (docs/VERIFY.md); prove/mpc_prove
        # share /jobs/prove (the mpc flag rides in the fields)
        endpoint = {
            "verify": "/jobs/verify",
            "aggregate": "/jobs/aggregate",
        }.get(job.kind, "/jobs/prove")
        try:
            async with self._session.post(
                f"{replica.url}{endpoint}",
                data=form,
                headers={
                    "X-DG16-Tenant": job.tenant,
                    "X-DG16-Priority": job.priority,
                    "X-DG16-Trace": job.trace_id,
                },
                timeout=aiohttp.ClientTimeout(total=600.0),
            ) as resp:
                body = await resp.json()
                status = resp.status
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError) as e:
            log.debug(
                "dispatch %s -> %s failed: %r", job.id, replica.name, e,
                extra={"job": job.id, "trace": job.trace_id},
            )
            self._note_replica_failure(replica, "dispatch")
            return "failed"
        if status in (200, 202):
            job.replica = replica
            job.state = body.get("state", "QUEUED")
            job.error = None  # a prior attempt's 5xx note is moot now
            # optimistic local load bump so a burst between polls doesn't
            # pile onto one replica's stale low score
            replica.doc["queueDepth"] = int(replica.doc.get("queueDepth", 0)) + 1
            self._payloads.pop(job.id, None)
            _ROUTED.labels(tenant=job.tenant, priority=job.priority).inc()
            # the router-tier breadcrumb in the job's federated log view
            # (GET /fleet/jobs/{id}/logs — docs/OBSERVABILITY.md)
            log.info(
                "dispatch %s -> %s accepted", job.id, replica.name,
                extra={"job": job.id, "trace": job.trace_id},
            )
            return "accepted"
        if status == 429:
            hint = body.get("retryAfter")
            if hint is not None:
                self._last_replica_hint = float(hint)
                self._hint_at = time.monotonic()
            return "busy"
        if status == 503:
            # draining: deliberate — stop routing there, don't eject
            replica.state = DRAINING
            return "busy"
        if status >= 500:
            # a replica-side internal error may be transient (a journal
            # fsync hitting a momentarily full disk) — remember the
            # message and let _dispatch try the next-best replica; it
            # terminal-fails only once EVERY live replica 5xx'd the
            # payload. Not fed to the ejection breaker: the replica
            # answered, so connectivity is fine.
            log.warning(
                "dispatch %s -> %s errored (HTTP %d): %s",
                job.id, replica.name, status, body.get("error"),
                extra={"job": job.id, "trace": job.trace_id},
            )
            job.error = {
                "type": "DispatchRejected",
                "message": str(body.get("error", f"HTTP {status}")),
            }
            return "errored"
        # a 4xx is the SUBMISSION's fault (malformed payload, unknown
        # circuit), not the replica's: terminal-fail the job at the
        # router. Feeding these into the ejection breaker would let one
        # poisoned payload, retried across the fleet, eject every
        # healthy replica — connectivity problems (the exception path
        # above) and failed /readyz polls are what ejection is for.
        log.warning(
            "dispatch %s -> %s rejected (HTTP %d): %s",
            job.id, replica.name, status, body.get("error"),
            extra={"job": job.id, "trace": job.trace_id},
        )
        job.error = {
            "type": "DispatchRejected",
            "message": str(body.get("error", f"HTTP {status}")),
        }
        self._payloads.pop(job.id, None)
        self._note_state(job, "FAILED")
        return "rejected"

    # -- HTTP handlers --------------------------------------------------------

    async def jobs_prove(self, request):
        return await self._jobs_submit(request, None)

    async def jobs_verify(self, request):
        return await self._jobs_submit(request, "verify")

    async def jobs_aggregate(self, request):
        return await self._jobs_submit(request, "aggregate")

    async def _jobs_submit(self, request, kind: str | None):
        """Front-door admission for every job kind. kind=None is the
        prove route (mpc flag picks prove/mpc_prove); "verify" and
        "aggregate" are the verification plane (docs/VERIFY.md) — same
        tenant buckets, same weighted-fair queue, same idempotent
        dispatch; only the replica endpoint differs (by job.kind)."""
        t_req0 = time.perf_counter()
        tenant = request.headers.get("X-DG16-Tenant", "").strip() \
            or DEFAULT_TENANT
        try:
            fields = await _read_multipart(request)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        priority = (
            request.headers.get("X-DG16-Priority", "").strip()
            or fields.pop("priority", b"").decode().strip()
            or DEFAULT_PRIORITY
        )
        if self.draining:
            self.admission.note_rejected(tenant, "draining")
            return _error("fleet router is draining", status=503)
        if "circuit_id" not in fields:
            return _error("circuit_id field is required")
        if kind in ("verify", "aggregate") and "proofs_file" not in fields:
            return _error("proofs_file field is required", status=400)
        # decode BEFORE admit(): a slot charged for a submission that
        # then 500s on bad bytes would never be released (quota leak)
        try:
            circuit_id = fields["circuit_id"].decode()
            mpc = fields.get("mpc", b"").decode().lower() in ("1", "true", "yes")
        except UnicodeDecodeError:
            return _error("circuit_id / mpc fields must be UTF-8")
        if kind is None:
            kind = "mpc_prove" if mpc else "prove"
        if len(self.queue) >= self.cfg.pending_bound:
            self.admission.note_rejected(tenant, "backlog")
            return _busy(
                tenant, "backlog",
                max(self._replica_hint(), 5.0),
                f"fleet dispatch backlog full "
                f"({len(self.queue)}/{self.cfg.pending_bound} pending)",
            )
        try:
            self.admission.admit(tenant)
        except TenantQuotaError as e:
            # the promised hint: max over the tenant bucket and whatever
            # the replicas last said about their own queues
            return _busy(
                tenant, e.reason,
                max(e.retry_after_s, self._replica_hint()),
                str(e),
            )
        job = RoutedJob(
            id=uuid.uuid4().hex,
            tenant=tenant,
            priority=priority,
            circuit_id=circuit_id,
            kind=kind,
            # the end-to-end trace context is born here, next to the
            # idempotent job id: every router span, replica service
            # span, and MPC-party span downstream carries it
            trace_id=uuid.uuid4().hex,
        )
        job.record_span(
            "fleet.admission", t_req0, time.perf_counter() - t_req0,
            tenant=tenant, priority=priority,
        )
        self.jobs[job.id] = job
        self._payloads[job.id] = fields
        self._queue_job(job)
        if self._wake is not None:
            self._wake.set()
        return web.json_response(
            {
                "jobId": job.id,
                "traceId": job.trace_id,
                "tenant": tenant,
                "priority": priority,
                "state": job.state,
                "pending": len(self.queue),
            },
            status=202,
        )

    def _job_or_404(self, request) -> RoutedJob | web.Response:
        job = self.jobs.get(request.match_info["job_id"])
        if job is None:
            return _error("unknown job id", status=404)
        return job

    async def _proxy_job(self, request, suffix: str = "") -> web.Response:
        job = self._job_or_404(request)
        if isinstance(job, web.Response):
            return job
        # snapshot the owner: a concurrent handoff may null job.replica
        # while the proxy await is in flight
        replica = job.replica
        if replica is None:
            if suffix:
                if job.state == "FAILED":
                    return _error(
                        (job.error or {}).get("message", "job failed")
                    )
                if job.state == "CANCELLED":
                    return _error("job was cancelled", status=410)
                return _error(
                    f"job not dispatched yet (state {job.state})", 409
                )
            return web.json_response(job.to_dict())
        try:
            async with self._session.request(
                request.method,
                f"{replica.url}/jobs/{job.id}{suffix}",
                timeout=aiohttp.ClientTimeout(total=60.0),
            ) as resp:
                body = await resp.read()
                status = resp.status
                ctype = resp.content_type
        except (aiohttp.ClientError, asyncio.TimeoutError):
            _PROXY_ERRORS.labels(route=f"/jobs/{{job_id}}{suffix}").inc()
            self._note_replica_failure(replica, "proxy")
            return _error(
                f"replica {replica.name} unreachable "
                "(handoff will re-route the job)",
                status=503,
            )
        if status == 200 and not suffix:
            # piggyback state tracking on client polls — a DELETE body
            # carries the post-cancel state too (RUNNING jobs cancel
            # cooperatively, so CANCELLED only lands when it is real)
            try:
                self._note_state(job, json.loads(body).get("state", job.state))
            except ValueError:
                pass
        return web.Response(body=body, status=status, content_type=ctype)

    async def job_status(self, request):
        return await self._proxy_job(request)

    async def job_result(self, request):
        return await self._proxy_job(request, "/result")

    async def job_trace(self, request):
        return await self._proxy_job(request, "/trace")

    async def fleet_job_trace(self, request):
        """GET /fleet/jobs/{id}/trace — the STITCHED end-to-end trace:
        router-tier spans (admission, queue wait, dispatch attempts,
        handoff) plus the owning replica's merged job trace — service
        phases and MPC-party rounds — rebased onto the router's clock
        via the /readyz poll echoes, one Chrome trace out. Clicking any
        job shows the full router -> queue -> batch -> MPC-round
        critical path across all three tiers (docs/OBSERVABILITY.md
        "Fleet observatory")."""
        job = self.jobs.get(request.match_info["job_id"])
        if job is None:
            return _error("unknown job id", status=404)
        events = [dict(ev) for ev in job.spans]
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": ROUTER_PID,
                "args": {"name": "fleet router"},
            }
        ]
        warning = None
        # snapshot the owner: a concurrent handoff may null job.replica
        # while the trace fetch await is in flight
        replica = job.replica
        if replica is not None:
            body = None
            try:
                async with self._session.get(
                    f"{replica.url}/jobs/{job.id}/trace",
                    timeout=aiohttp.ClientTimeout(total=60.0),
                ) as resp:
                    if resp.status == 200:
                        body = await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
                body = None
            if body is None:
                warning = (
                    f"replica {replica.name} did not serve the job "
                    "trace; router spans only"
                )
                _PROXY_ERRORS.labels(
                    route="/fleet/jobs/{job_id}/trace"
                ).inc()
            else:
                # rebase replica perf_counter timestamps onto the
                # router's clock: ClockSync.offset_ns estimates
                # replica_clock − router_clock, so ADD its negation
                # (the aggregator's add_party convention)
                off_us = -replica.clock.offset_ns / 1e3
                pids: set[int] = set()
                for ev in body.get("traceEvents", []):
                    if not isinstance(ev, dict):
                        continue
                    ts = ev.get("ts")
                    if not isinstance(ts, (int, float)):
                        continue  # metadata/corrupt events don't rebase
                    ev = dict(ev)
                    ev["ts"] = ts + off_us
                    try:
                        pids.add(int(ev.get("pid", 0)))
                    except (TypeError, ValueError):
                        ev["pid"] = 0
                        pids.add(0)
                    events.append(ev)
                for p in sorted(pids):
                    name = f"replica {replica.name}"
                    if p != 0:
                        name += f" party {p}"
                    meta.append(
                        {
                            "name": "process_name",
                            "ph": "M",
                            "pid": p,
                            "args": {"name": name},
                        }
                    )
        events.sort(key=lambda e: e.get("ts", 0.0))
        out = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "traceId": job.trace_id,
        }
        if warning is not None:
            out["warning"] = warning
        return web.json_response(out)

    async def fleet_job_logs(self, request):
        """GET /fleet/jobs/{id}/logs — the job's CORRELATED log stream
        across tiers: the router's own structured records for this trace
        plus the owning replica's (`GET /logs?trace=`), rebased onto the
        router's clock with the same ClockSync offset the stitched trace
        uses. Every record gains `source` (router / replica name) and
        `tsRouterNs`; the merge is sorted on the latter, so an operator
        reads one causally-ordered story: admitted here, dispatched
        there, died on party 3 (docs/OBSERVABILITY.md "Logging spine").
        ?level= filters both sides; ?limit= caps each side's tail."""
        job = self.jobs.get(request.match_info["job_id"])
        if job is None:
            return _error("unknown job id", status=404)
        q = request.rel_url.query
        level = q.get("level")
        if level and level.upper() not in _logbus.LEVELS:
            return _error(
                "level must be one of DEBUG/INFO/WARNING/ERROR/CRITICAL",
                status=400,
            )
        try:
            limit = int(q.get("limit", "256"))
        except ValueError:
            return _error("limit must be an integer", status=400)
        # the router's own records for this trace. An in-process test
        # fleet shares ONE ring between router and replica, so keep only
        # fleet-tier loggers here — the replica's records arrive (once)
        # over HTTP below.
        records = [
            dict(r, source="router", tsRouterNs=r["tsPcNs"])
            for r in _logbus.ring().query(
                trace=job.trace_id, level=level, limit=limit
            )
            if r.get("logger", "").startswith("fleet")
        ]
        warning = None
        replica = job.replica  # snapshot: handoff may null it mid-await
        if replica is not None:
            body = None
            try:
                params = {"trace": job.trace_id, "limit": str(limit)}
                if level:
                    params["level"] = level
                async with self._session.get(
                    f"{replica.url}/logs",
                    params=params,
                    timeout=aiohttp.ClientTimeout(total=60.0),
                ) as resp:
                    if resp.status == 200:
                        body = await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
                body = None
            if body is None:
                warning = (
                    f"replica {replica.name} did not serve logs; "
                    "router records only"
                )
                _PROXY_ERRORS.labels(route="/fleet/jobs/{job_id}/logs").inc()
            else:
                # rebase: ClockSync.offset_ns estimates replica_clock −
                # router_clock over perf_counter_ns, so SUBTRACT it
                off_ns = replica.clock.offset_ns
                for r in body.get("records", []):
                    if not isinstance(r, dict):
                        continue
                    if str(r.get("logger", "")).startswith("fleet"):
                        # the shared-ring mirror of the dedup above: an
                        # in-process replica echoes the router's own
                        # records back — they're already counted
                        continue
                    ts = r.get("tsPcNs")
                    if not isinstance(ts, (int, float)):
                        continue
                    r = dict(r)
                    r["source"] = f"replica {replica.name}"
                    r["tsRouterNs"] = ts - off_ns
                    records.append(r)
        records.sort(key=lambda r: r.get("tsRouterNs", 0))
        out = {
            "jobId": job.id,
            "traceId": job.trace_id,
            "records": records,
        }
        if warning is not None:
            out["warning"] = warning
        return web.json_response(out)

    async def job_cancel(self, request):
        job = self._job_or_404(request)
        if isinstance(job, web.Response):
            return job
        if job.replica is None:
            job.cancelled = True
            self._note_state(job, "CANCELLED")
            return web.json_response(
                {"jobId": job.id, "state": "CANCELLED",
                 "cancelRequested": False}
            )
        return await self._proxy_job(request)

    # -- fleet control plane --------------------------------------------------

    def _pending_by_kind(self) -> dict[str, int]:
        """Undispatched depth per job kind — how much prove vs verify
        work waits at the front door (`fleet top`, docs/VERIFY.md)."""
        out: dict[str, int] = {}
        for j in self.jobs.values():
            if j.state == "PENDING" and not j.cancelled:
                out[j.kind] = out.get(j.kind, 0) + 1
        return out

    async def fleet_stats(self, request):
        return web.json_response(
            {
                "replicas": self.registry.stats(),
                "tenants": self.admission.stats(),
                "pending": len(self.queue),
                "pendingByClass": self.queue.occupancy(),
                "pendingByKind": self._pending_by_kind(),
                "weights": dict(self.cfg.weights),
                "handoffs": self.handoffs,
                "jobsTracked": len(self.jobs),
                "federation": {
                    "replicasScraped": len(self.federator.replicas()),
                    "scrapesOk": self.federator.scrapes_ok,
                    "scrapesFailed": self.federator.scrapes_failed,
                    "seriesSkipped": self.federator.series_skipped,
                },
            }
        )

    async def fleet_metrics(self, request):
        """GET /fleet/metrics — the federated exposition: every live
        replica's series re-exported with a `replica` label plus the
        fleet rollups (docs/OBSERVABILITY.md "Fleet observatory"). The
        router's own families stay on /metrics."""
        return web.Response(
            text=self.federator.render(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def fleet_drain(self, request):
        """Operator drain without SIGTERM access (docs/FLEET.md): ask the
        replica to stop admitting, then hand its backlog off NOW."""
        name = request.match_info["replica"]
        replica = self.registry.find(name)
        if replica is None:
            return _error(f"unknown replica {name!r}", status=404)
        try:
            async with self._session.post(
                f"{replica.url}/drain",
                timeout=aiohttp.ClientTimeout(total=30.0),
            ) as resp:
                ok = resp.status == 200
        except (aiohttp.ClientError, asyncio.TimeoutError):
            _PROXY_ERRORS.labels(route="/fleet/drain/{replica}").inc()
            ok = False
        if not ok and replica.state != EJECTED:
            return _error(
                f"replica {replica.name} did not acknowledge the drain",
                status=502,
            )
        replica.state = DRAINING
        replica.handoff_done = False
        moved = await self._handoff(replica)
        return web.json_response(
            {
                "replica": replica.name,
                "state": "draining",
                "handedOff": moved,
            }
        )

    async def healthz(self, request):
        return web.json_response(
            {
                "status": "draining" if self.draining else "ok",
                "replicas": len(self.registry.replicas),
                "activeReplicas": self.registry.active_count(),
                "pending": len(self.queue),
            }
        )

    async def readyz(self, request):
        """The router is ready when it could place a job somewhere."""
        ready = self.registry.active_count() > 0 and not self.draining
        return web.json_response(
            {"status": "ok" if ready else "no active replicas"},
            status=200 if ready else 503,
        )

    async def metrics(self, request):
        return web.Response(
            text=_tm.registry().render_prometheus(),
            content_type="text/plain",
            charset="utf-8",
        )

    # -- app ------------------------------------------------------------------

    @web.middleware
    async def _http_middleware(self, request, handler):
        """Front-door latency histogram per (route template, status):
        the router's own cost, separable from replica latency. The label
        is the matched ROUTE (bounded cardinality — unmatched paths all
        land on "unmatched"), never the raw path."""
        t0 = time.perf_counter()
        code = 500
        try:
            resp = await handler(request)
            code = resp.status
            return resp
        except web.HTTPException as e:
            code = e.status
            raise
        finally:
            resource = (
                request.match_info.route.resource
                if request.match_info.route is not None
                else None
            )
            route = (
                resource.canonical if resource is not None else "unmatched"
            )
            _HTTP_SECONDS.labels(route=route, code=str(code)).observe(
                time.perf_counter() - t0
            )

    def app(self) -> web.Application:
        app = web.Application(
            client_max_size=MAX_BODY, middlewares=[self._http_middleware]
        )
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        app.router.add_post("/jobs/prove", self.jobs_prove)
        app.router.add_post("/jobs/verify", self.jobs_verify)
        app.router.add_post("/jobs/aggregate", self.jobs_aggregate)
        app.router.add_get("/jobs/{job_id}", self.job_status)
        app.router.add_get("/jobs/{job_id}/result", self.job_result)
        app.router.add_get("/jobs/{job_id}/trace", self.job_trace)
        app.router.add_delete("/jobs/{job_id}", self.job_cancel)
        app.router.add_get("/fleet/stats", self.fleet_stats)
        app.router.add_get("/fleet/metrics", self.fleet_metrics)
        app.router.add_get(
            "/fleet/jobs/{job_id}/trace", self.fleet_job_trace
        )
        app.router.add_get(
            "/fleet/jobs/{job_id}/logs", self.fleet_job_logs
        )
        # {replica:.+}: the operand may be the config URL itself
        # (slashes and all) — `find` accepts either spelling
        app.router.add_post("/fleet/drain/{replica:.+}", self.fleet_drain)
        app.router.add_get("/healthz", self.healthz)
        app.router.add_get("/readyz", self.readyz)
        app.router.add_get("/metrics", self.metrics)
        return app


def main() -> None:
    # console + ring via the one logging entry point (DG16_LOG_LEVEL /
    # DG16_LOG_JSON) — basicConfig would bypass the structured spine
    _logbus.setup()
    port = int(os.environ.get("PORT", "8080"))
    router = FleetRouter()
    if not router.registry.replicas:
        raise SystemExit(
            "no replicas configured — set DG16_FLEET_REPLICAS "
            "(docs/FLEET.md)"
        )
    web.run_app(router.app(), port=port)
