"""Configuration: the DG16_* knobs and the structured configs, the
counterpart of the JAX package's utils/config.py.

  * KNOBS, the registry of the DG16_* environment knobs the port reads,
    with the JAX package's text, and the typed accessors env_str,
    env_flag, env_int and env_float (reading an undeclared knob raises);
  * NetConfig, the star transport's deadlines and liveness knobs, each
    with a DG16_NET_* override (NetConfig.from_env);
  * ServiceConfig, SchedulerConfig and SLOConfig, the job service's,
    batching scheduler's and SLO monitor's knobs, with the JAX package's
    fields, defaults and overrides;
  * FleetConfig and TenantConfig, the fleet router's and its tenant
    admission's knobs (DG16_FLEET_*, DG16_TENANT_*), the JAX package's
    text;
  * read_address_file: the address-file format of network-address/4|8,
    one `host:port` per rank.

The JAX package's knobs of the JAX compilation cache and bench.py are
not declared: nothing in the port reads them. DG16_PROF_DIR names
torch.profiler where the JAX text names the XLA profiler, and
DG16_PEAK_FLOPS counts 32-bit multiply-adds/s, the unit of the port's
roofline (telemetry/roofline.py). The JAX package's Opt and parse_opt
are left out: no entry point of the port parses them (the examples take
their own flags, examples/_star.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

KNOBS: dict[str, str] = {
    # transport (docs/ROBUSTNESS.md)
    "DG16_NET_OP_TIMEOUT_S": "per-collective send/recv deadline, <=0 off",
    "DG16_NET_CONNECT_TIMEOUT_S": "total bring-up budget (dial + barrier)",
    "DG16_NET_CONNECT_BASE_DELAY_S": "client redial backoff base",
    "DG16_NET_CONNECT_MAX_DELAY_S": "client redial backoff cap",
    "DG16_NET_CONNECT_JITTER": "redial backoff jitter fraction",
    "DG16_NET_HEARTBEAT_S": "idle-link keepalive period, <=0 off",
    "DG16_NET_IDLE_TIMEOUT_S": "declare a silent peer dead after this",
    # service (docs/SERVICE.md)
    "DG16_SERVICE_WORKERS": "worker pool size (concurrent proofs)",
    "DG16_SERVICE_QUEUE_BOUND": "admission bound before 429",
    "DG16_SERVICE_CRS_CACHE": "packed-CRS LRU entries, 0 off",
    "DG16_SERVICE_ROUND_RETRIES": "transient-fault re-runs per MPC round",
    "DG16_SERVICE_RETRY_AFTER_S": "cold-start retryAfter hint seconds",
    "DG16_SERVICE_JOB_HISTORY": "terminal jobs kept addressable",
    # crash safety (docs/ROBUSTNESS.md)
    "DG16_JOURNAL": "durable job journal: dir, or 1 = <store>/_journal",
    "DG16_JOURNAL_FSYNC": "fsync each journal append (default on)",
    "DG16_JOURNAL_SEGMENT_RECORDS": "journal records per segment before compaction",
    # batching scheduler (docs/SCHEDULER.md)
    "DG16_BATCH_MAX": "jobs per batch; <=1 disables the scheduler",
    "DG16_BATCH_LINGER_MS": "partial-bucket wait for batchmates",
    "DG16_SCHED_MESHES": "cap on concurrently leased prover meshes",
    "DG16_SCHED_INFLIGHT": "scheduler backpressure bound",
    "DG16_SCHED_POISON_RETRIES": "solo batch failures before quarantine",
    "DG16_BREAKER_THRESHOLD": "slice failures tripping its breaker, <=0 off",
    "DG16_BREAKER_COOLDOWN_S": "tripped-slice cooldown before half-open probe",
    # verification plane (docs/VERIFY.md)
    "DG16_VERIFY_BATCH_MAX": "verify jobs per RLC batch; <=1 per-job checks",
    "DG16_VERIFY_LINGER_MS": "partial verify-bucket wait for batchmates",
    # telemetry (docs/OBSERVABILITY.md)
    "DG16_METRICS": "metrics kill switch (default on; 0/false off)",
    "DG16_TRACE": "print Start:/End: phase lines",
    "DG16_TRACE_OUT": "record all spans, Chrome trace file at exit",
    "DG16_AGG": "star-wide trace aggregation plane (default off)",
    "DG16_FLIGHT_DIR": "flight-recorder post-mortem directory",
    # logging spine (docs/OBSERVABILITY.md "Logging spine")
    "DG16_LOG_RING": "structured log ring size, records",
    "DG16_LOG_LEVEL": "package logger level (default INFO)",
    "DG16_LOG_JSON": "console handler emits JSON lines",
    "DG16_LOG_STORM_BURST": "per-template records before suppression",
    "DG16_LOG_STORM_RATE": "suppressed-template refill, records/sec, <=0 off",
    # performance observatory (telemetry/perf.py, telemetry/benchgate.py)
    "DG16_PERF_REPS": "benchgate warm reps per kernel case",
    "DG16_PERF_REL_THRESHOLD": "benchgate relative slowdown gate",
    "DG16_PERF_ABS_FLOOR_S": "benchgate absolute-seconds noise floor",
    # device observatory (docs/OBSERVABILITY.md "Device observatory")
    "DG16_PROF_DIR": "on-demand torch.profiler artifact directory",
    "DG16_PROF_MAX_S": "cap on one POST /profile capture duration",
    "DG16_DEVMEM_SAMPLE_S": "device-memory sampler period, <=0 off",
    "DG16_PEAK_FLOPS": "roofline peak 32-bit multiply-adds/s override for this backend",
    "DG16_PEAK_BW": "roofline peak HBM bytes/sec override for this backend",
    # fleet plane (docs/FLEET.md)
    "DG16_FLEET_REPLICAS": "router replica set: url[=journal-dir] CSV",
    "DG16_FLEET_POLL_S": "router discovery poll period seconds",
    "DG16_FLEET_EJECT_THRESHOLD": "consecutive replica failures before ejection, <=0 off",
    "DG16_FLEET_COOLDOWN_S": "ejected-replica cooldown before a half-open probe",
    "DG16_FLEET_PENDING_BOUND": "router dispatch backlog bound before 429",
    "DG16_FLEET_WEIGHTS": "priority-class weights, class=weight CSV",
    "DG16_FLEET_REPLICA_ID": "this replica's id in /readyz (default: random)",
    "DG16_FLEET_HISTORY": "terminal routed jobs the router keeps addressable",
    "DG16_FLEET_ANOMALY_FACTOR": "replica p95/burn vs fleet-median anomaly factor, <=0 off",
    # tenant admission (docs/FLEET.md)
    "DG16_TENANT_RATE": "default tenant token-bucket refill, jobs/sec, <=0 off",
    "DG16_TENANT_BURST": "default tenant token-bucket capacity",
    "DG16_TENANT_INFLIGHT": "default tenant in-flight job quota, <=0 off",
    "DG16_TENANT_LIMITS": "per-tenant overrides, tenant=rate:burst:inflight CSV",
    # SLO burn-rate monitoring (docs/OBSERVABILITY.md)
    "DG16_SLO_TARGET_S": "default job-latency SLO target, <=0 off",
    "DG16_SLO_TARGETS": "per-kind latency targets, kind=seconds CSV",
    "DG16_SLO_OBJECTIVE": "fraction of jobs that must meet the target",
    "DG16_SLO_WINDOW_S": "error-budget accounting window",
    "DG16_SLO_SAMPLE_S": "SLO sampler period",
    # frontend / store
    "DG16_NO_CWASM": "force the pure-Python WASM witness VM",
    "DG16_STORE": "circuit store root directory",
    # examples
    "DG16_VECTORS": "introspect.py: external test-vector directory",
    "DG16_REQUIRE_VECTORS": "introspect.py: fail when vectors missing",
}


def _declared(name: str) -> str:
    if name not in KNOBS:
        raise KeyError(
            f"{name} is not declared in utils.config.KNOBS — add it there "
            "(and to the docs) before reading it"
        )
    return name


def env_str(name: str, default: str = "") -> str:
    v = os.environ.get(_declared(name))
    return v if v not in (None, "") else default


def env_flag(name: str, default: bool = False) -> bool:
    """'', unset -> default; '0'/'false' (any case) -> False; else True."""
    v = os.environ.get(_declared(name))
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false")


def env_int(name: str, default: int) -> int:
    v = os.environ.get(_declared(name))
    return int(v) if v not in (None, "") else default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(_declared(name))
    return float(v) if v not in (None, "") else default


@dataclass(frozen=True)
class NetConfig:
    """Fault-tolerance knobs of the star transport (parallel/net.py,
    parallel/prodnet.py). Every field has a DG16_NET_* override read by
    from_env(); per-op `timeout=` arguments on the collectives override
    the config value again.

      * op_timeout_s — deadline for one point-to-point send/recv inside a
        collective; <= 0 disables it. Long compute phases legitimately
        stall the wire, so the default is generous; liveness between ops
        is the heartbeat's job.
      * connect_timeout_s — TOTAL bring-up budget: a client's dial with
        backoff, the king's wait for all clients, and the Syn/SynAck
        barrier each run under it.
      * connect_base_delay_s / connect_max_delay_s / connect_jitter — the
        client's redial backoff: sleep min(base * 2^attempt, max) *
        (1 + jitter * U[0,1)).
      * heartbeat_interval_s — idle-link keepalive period. <= 0 disables
        heartbeats AND idle detection.
      * idle_timeout_s — a peer silent (no frames, heartbeats included)
        this long is declared dead and its pending recvs fail. A rank's
        heartbeat task shares its asyncio loop with the prover's
        synchronous GPU work, so a long compute phase blocks its own
        heartbeats: keep this ABOVE the workload's longest synchronous
        phase and well above heartbeat_interval_s. <= 0 disables idle
        detection only.
    """

    op_timeout_s: float = 600.0
    connect_timeout_s: float = 120.0
    connect_base_delay_s: float = 0.1
    connect_max_delay_s: float = 5.0
    connect_jitter: float = 0.5
    heartbeat_interval_s: float = 15.0
    idle_timeout_s: float = 600.0

    @staticmethod
    def from_env() -> "NetConfig":
        return NetConfig(
            op_timeout_s=env_float("DG16_NET_OP_TIMEOUT_S", 600.0),
            connect_timeout_s=env_float("DG16_NET_CONNECT_TIMEOUT_S", 120.0),
            connect_base_delay_s=env_float(
                "DG16_NET_CONNECT_BASE_DELAY_S", 0.1
            ),
            connect_max_delay_s=env_float("DG16_NET_CONNECT_MAX_DELAY_S", 5.0),
            connect_jitter=env_float("DG16_NET_CONNECT_JITTER", 0.5),
            heartbeat_interval_s=env_float("DG16_NET_HEARTBEAT_S", 15.0),
            idle_timeout_s=env_float("DG16_NET_IDLE_TIMEOUT_S", 600.0),
        )


@dataclass(frozen=True)
class ServiceConfig:
    """Proof-job service knobs (service/ + api/server.py). Every field has
    a DG16_SERVICE_* env override so a deployment can be tuned without code
    changes. See docs/SERVICE.md for the backpressure semantics.

      * workers — bounded worker pool size: at most this many proofs
        execute concurrently; everything else waits in the queue.
      * queue_bound — admission control: jobs waiting (QUEUED) beyond this
        are rejected with a structured queue-full error that the API maps
        to HTTP 429 + a retryAfter hint.
      * crs_cache_size — LRU capacity (entries) of the packed-CRS cache,
        keyed by (circuit_id, packing params). 0 disables caching.
      * round_retries — transient-fault re-runs per MPC round, forwarded
        to parallel.net.run_round_with_retries.
      * retry_after_s — fallback retryAfter hint (seconds) reported on
        queue-full rejections before any job has completed (after that the
        hint is estimated from observed job runtimes).
      * job_history — how many terminal (DONE/FAILED/CANCELLED) jobs stay
        addressable via GET /jobs/{id}; older ones are evicted so a
        long-lived service doesn't grow its registry without bound.
      * journal_dir — durable job-journal directory (service/journal.py):
        "" disables, "1"/"true" means <store root>/_journal, anything
        else is an explicit path. With it on, accepted jobs survive a
        crash and are replayed at the next boot (docs/ROBUSTNESS.md).
      * journal_fsync — fsync every journal append (the durability
        contract; off trades it for speed in tests/throwaway replicas).
      * journal_segment_records — appends per journal segment before a
        compaction rewrites the live set and drops old segments.
    """

    workers: int = 2
    queue_bound: int = 64
    crs_cache_size: int = 8
    round_retries: int = 2
    retry_after_s: float = 5.0
    job_history: int = 1024
    journal_dir: str = ""
    journal_fsync: bool = True
    journal_segment_records: int = 4096
    # fleet identity (docs/FLEET.md): the id this replica reports in its
    # /readyz capacity document — what `dg16-cli fleet status` and the
    # router's replica table call it. "" = a random id per process.
    replica_id: str = ""

    @staticmethod
    def from_env() -> "ServiceConfig":
        return ServiceConfig(
            workers=env_int("DG16_SERVICE_WORKERS", 2),
            queue_bound=env_int("DG16_SERVICE_QUEUE_BOUND", 64),
            crs_cache_size=env_int("DG16_SERVICE_CRS_CACHE", 8),
            round_retries=env_int("DG16_SERVICE_ROUND_RETRIES", 2),
            retry_after_s=env_float("DG16_SERVICE_RETRY_AFTER_S", 5.0),
            job_history=env_int("DG16_SERVICE_JOB_HISTORY", 1024),
            journal_dir=env_str("DG16_JOURNAL", ""),
            journal_fsync=env_flag("DG16_JOURNAL_FSYNC", True),
            journal_segment_records=env_int(
                "DG16_JOURNAL_SEGMENT_RECORDS", 4096
            ),
            replica_id=env_str("DG16_FLEET_REPLICA_ID", ""),
        )


@dataclass(frozen=True)
class SchedulerConfig:
    """Batching-scheduler knobs (scheduler/, docs/SCHEDULER.md). Every
    field has a DG16_* env override.

      * batch_max — jobs per bucket before a batch releases immediately.
        <= 1 DISABLES the scheduler entirely: the service runs its
        per-job executor funnel, byte-for-byte.
      * batch_linger_ms — how long a partially-filled bucket waits for
        batchmates before releasing anyway: the latency a lone job pays
        for amortization. 0 releases on the next scheduler tick.
      * max_meshes — cap on concurrently leased prover meshes. 0 = as
        many disjoint 4l-device slices as the inventory supports.
      * max_inflight — backpressure bound on jobs the scheduler holds
        (bucketed + batching). Workers stop feeding past it, so the
        queue refills and the 429 admission bound stays meaningful.
        0 = 4 x batch_max.
      * poison_retries — how many times a job may kill its batch ALONE
        (after bisection isolates it) before it is quarantined instead
        of retried (docs/SCHEDULER.md "Poisoned batches").
      * breaker_threshold — consecutive mesh-level batch failures that
        trip a device slice's circuit breaker; <= 0 disables breakers.
      * breaker_cooldown_s — seconds a tripped slice cools down before
        a half-open probe batch may test it again.
      * verify_batch_max / verify_linger_ms — the verify-bucket overrides
        (docs/VERIFY.md): kind="verify" jobs release at verify_batch_max
        and linger verify_linger_ms, independent of the prove knobs,
        because an RLC fold is milliseconds of host pairing math and can
        afford a much bigger batch than a mesh lease can.
        verify_batch_max <= 1 keeps verify jobs on the per-job executor
        path even with the scheduler on. (The scheduler itself still
        exists only when batch_max > 1.)
    """

    batch_max: int = 1
    batch_linger_ms: float = 50.0
    max_meshes: int = 0
    max_inflight: int = 0
    poison_retries: int = 2
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    verify_batch_max: int = 16
    verify_linger_ms: float = 25.0

    @staticmethod
    def from_env() -> "SchedulerConfig":
        return SchedulerConfig(
            batch_max=env_int("DG16_BATCH_MAX", 1),
            batch_linger_ms=env_float("DG16_BATCH_LINGER_MS", 50.0),
            max_meshes=env_int("DG16_SCHED_MESHES", 0),
            max_inflight=env_int("DG16_SCHED_INFLIGHT", 0),
            poison_retries=env_int("DG16_SCHED_POISON_RETRIES", 2),
            breaker_threshold=env_int("DG16_BREAKER_THRESHOLD", 3),
            breaker_cooldown_s=env_float("DG16_BREAKER_COOLDOWN_S", 30.0),
            verify_batch_max=env_int("DG16_VERIFY_BATCH_MAX", 16),
            verify_linger_ms=env_float("DG16_VERIFY_LINGER_MS", 25.0),
        )


@dataclass(frozen=True)
class SLOConfig:
    """Service-level-objective knobs (service/slo.py, the burn-rate
    sampler behind `/slo` and the `slo_burn_rate{kind}` gauges). The SLO
    is a latency objective per job kind: at least `objective` of a kind's
    terminal jobs must finish within that kind's target seconds; the
    remainder is the error budget, accounted over a rolling `window_s`.

      * target_s — default latency target (seconds) for any kind without
        an explicit entry in `targets`. <= 0 disables SLO monitoring
        entirely (no sampler task, `/stats` reports enabled: false).
      * targets — per-kind overrides, parsed from the DG16_SLO_TARGETS
        CSV (`prove=30,mpc_prove=120`).
      * objective — fraction of jobs that must meet the target (0.99 =
        a 1% error budget).
      * window_s — rolling window the budget is accounted over.
      * sample_s — how often the background sampler re-derives the
        burn-rate gauges from the job_seconds series.
    """

    target_s: float = 0.0
    targets: tuple = ()
    objective: float = 0.99
    window_s: float = 3600.0
    sample_s: float = 5.0

    @property
    def enabled(self) -> bool:
        return self.target_s > 0 or bool(self.targets)

    def target_for(self, kind: str) -> float:
        for k, v in self.targets:
            if k == kind:
                return v
        return self.target_s

    @staticmethod
    def parse_targets(spec: str) -> tuple:
        """`prove=30,mpc_prove=120` -> (("prove", 30.0), ...). Malformed
        entries raise ValueError — a silently ignored SLO is worse than a
        loud boot failure."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, val = part.partition("=")
            if not kind or not val:
                raise ValueError(
                    f"bad DG16_SLO_TARGETS entry {part!r} "
                    "(expected kind=seconds)"
                )
            out.append((kind.strip(), float(val)))
        return tuple(out)

    @staticmethod
    def from_env() -> "SLOConfig":
        return SLOConfig(
            target_s=env_float("DG16_SLO_TARGET_S", 0.0),
            targets=SLOConfig.parse_targets(env_str("DG16_SLO_TARGETS", "")),
            objective=env_float("DG16_SLO_OBJECTIVE", 0.99),
            window_s=env_float("DG16_SLO_WINDOW_S", 3600.0),
            sample_s=env_float("DG16_SLO_SAMPLE_S", 5.0),
        )


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-router knobs (fleet/, docs/FLEET.md) — the front door
    spreading `/jobs/prove` traffic across N replica ApiServers.

      * replicas — the replica set: ((base_url, journal_dir | None), ...)
        parsed from the DG16_FLEET_REPLICAS CSV. Each entry is a base URL,
        optionally `=journal-dir` suffixed: with a journal directory the
        router can hand a dead/draining replica's journaled jobs off to a
        healthy one (journal-backed handoff); without one, handoff for
        that replica is impossible and its accepted jobs ride out its own
        restart replay instead.
      * poll_s — discovery period: how often the router polls each
        replica's /readyz capacity document and sweeps routed jobs.
      * eject_threshold — consecutive failed polls/dispatches before a
        replica is EJECTED from rotation (breaker-style, same
        closed -> open cooldown -> half-open shape as the mesh breakers);
        <= 0 disables ejection.
      * eject_cooldown_s — seconds an ejected replica cools down before
        one half-open probe poll may readmit it.
      * pending_bound — dispatch-backlog bound: admitted jobs waiting for
        a replica beyond this are rejected 429 at the router door.
      * weights — priority-class weighted-fair dequeue weights
        (docs/FLEET.md "Priority classes"); classes absent from the map
        dispatch at weight 1.
      * history — terminal routed jobs kept addressable through the
        router (same eviction contract as DG16_SERVICE_JOB_HISTORY).
      * anomaly_factor — fleet-anomaly hook (docs/OBSERVABILITY.md
        "Fleet observatory"): a replica whose federated job p95 or SLO
        burn rate exceeds the fleet MEDIAN by this factor gets one
        flight-recorder post-mortem per episode (trigger fleet_anomaly).
        <= 0 disables the hook.
    """

    replicas: tuple = ()
    poll_s: float = 2.0
    eject_threshold: int = 3
    eject_cooldown_s: float = 15.0
    pending_bound: int = 256
    weights: tuple = (("interactive", 8), ("batch", 3), ("bulk", 1))
    history: int = 4096
    anomaly_factor: float = 3.0

    def weight_for(self, priority: str) -> int:
        for k, v in self.weights:
            if k == priority:
                return v
        return 1

    @property
    def priorities(self) -> tuple:
        return tuple(k for k, _ in self.weights)

    @staticmethod
    def parse_replicas(spec: str) -> tuple:
        """`http://h1:8001=/var/j1,http://h2:8002` ->
        (("http://h1:8001", "/var/j1"), ("http://h2:8002", None))."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            url, _, jdir = part.partition("=")
            out.append((url.rstrip("/"), jdir or None))
        return tuple(out)

    @staticmethod
    def parse_weights(spec: str) -> tuple:
        """`interactive=8,batch=3,bulk=1` -> (("interactive", 8), ...).
        Malformed entries raise ValueError (loud boot > silent default)."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            cls, _, w = part.partition("=")
            if not cls or not w:
                raise ValueError(
                    f"bad DG16_FLEET_WEIGHTS entry {part!r} "
                    "(expected class=weight)"
                )
            out.append((cls.strip(), int(w)))
        return tuple(out)

    @staticmethod
    def from_env() -> "FleetConfig":
        weights = env_str("DG16_FLEET_WEIGHTS", "")
        return FleetConfig(
            replicas=FleetConfig.parse_replicas(
                env_str("DG16_FLEET_REPLICAS", "")
            ),
            poll_s=env_float("DG16_FLEET_POLL_S", 2.0),
            eject_threshold=env_int("DG16_FLEET_EJECT_THRESHOLD", 3),
            eject_cooldown_s=env_float("DG16_FLEET_COOLDOWN_S", 15.0),
            pending_bound=env_int("DG16_FLEET_PENDING_BOUND", 256),
            weights=(
                FleetConfig.parse_weights(weights)
                if weights
                else FleetConfig.weights
            ),
            history=env_int("DG16_FLEET_HISTORY", 4096),
            anomaly_factor=env_float("DG16_FLEET_ANOMALY_FACTOR", 3.0),
        )


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant admission knobs enforced at the router door
    (fleet/tenants.py, docs/FLEET.md "Tenant admission").

      * rate — default sustained submission rate (token-bucket refill,
        jobs/second) per tenant; <= 0 disables rate limiting.
      * burst — default token-bucket capacity (submissions a quiet tenant
        may burst before the refill rate governs).
      * inflight — default cap on a tenant's routed-but-not-terminal
        jobs; <= 0 disables the in-flight quota.
      * limits — per-tenant overrides from the DG16_TENANT_LIMITS CSV
        (`acme=5:20:50` = rate 5/s, burst 20, inflight 50; empty slots
        keep the defaults: `acme=:=:8` is rejected, `acme=::8` overrides
        only inflight).
    """

    rate: float = 0.0
    burst: int = 16
    inflight: int = 0
    limits: tuple = ()

    def limits_for(self, tenant: str) -> tuple[float, int, int]:
        """(rate, burst, inflight) for one tenant."""
        for name, rate, burst, inflight in self.limits:
            if name == tenant:
                return (
                    self.rate if rate is None else rate,
                    self.burst if burst is None else burst,
                    self.inflight if inflight is None else inflight,
                )
        return self.rate, self.burst, self.inflight

    @staticmethod
    def parse_limits(spec: str) -> tuple:
        """`acme=5:20:50,free=0.5:2:4` ->
        (("acme", 5.0, 20, 50), ...); empty slots stay None (defaults)."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            tenant, _, vals = part.partition("=")
            if not tenant or not vals:
                raise ValueError(
                    f"bad DG16_TENANT_LIMITS entry {part!r} "
                    "(expected tenant=rate:burst:inflight)"
                )
            slots = (vals.split(":") + ["", "", ""])[:3]
            out.append(
                (
                    tenant.strip(),
                    float(slots[0]) if slots[0] else None,
                    int(slots[1]) if slots[1] else None,
                    int(slots[2]) if slots[2] else None,
                )
            )
        return tuple(out)

    @staticmethod
    def from_env() -> "TenantConfig":
        return TenantConfig(
            rate=env_float("DG16_TENANT_RATE", 0.0),
            burst=env_int("DG16_TENANT_BURST", 16),
            inflight=env_int("DG16_TENANT_INFLIGHT", 0),
            limits=TenantConfig.parse_limits(
                env_str("DG16_TENANT_LIMITS", "")
            ),
        )


def read_address_file(path: str) -> list[tuple[str, int]]:
    """network-address/4|8 format: one host:port per line, rank order."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            host, port = line.rsplit(":", 1)
            out.append((host, int(port)))
    return out
