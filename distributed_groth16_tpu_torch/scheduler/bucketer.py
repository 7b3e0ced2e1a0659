"""Shape-bucketed batch admission — the grouping half of the scheduler.

Queued jobs are grouped by `BucketKey` — (kind, circuit_id, curve,
domain_size, num_inputs, l) — because only shape-identical jobs over the
SAME circuit can share one packed CRS and one jitted batch program
(zkSaaS §7's CRS/packing reuse; Orca-style batching needs identical
tensor shapes). A bucket releases a `Batch` when it reaches `batch_max`
jobs or when its oldest job has lingered `linger_s` seconds — the classic
size-or-deadline tradeoff: a full batch maximizes amortization, the
linger deadline bounds the latency a lone job pays for it.

Deadline-aware release (docs/FLEET.md, ROADMAP "linger less when an SLO
is near"): with an SLO target configured (`slo_target_s` =
DG16_SLO_TARGET_S), a job that already burned queue-wait before reaching
its bucket gets LESS linger — the bucket may only linger while the
oldest job's total age stays under half the target, reserving the other
half for proving. A fresh job lingers the full `linger_s`; a job whose
age already crossed the half-target releases on the next tick. Without
an SLO target the linger is unconditional (the pre-fleet behavior).

Pure event-loop-side bookkeeping: no locks, no I/O, injectable clock.
The orchestration (who calls `add` / `pop_expired`, who runs released
batches) lives in `scheduler/__init__.py`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..telemetry import metrics as _tm

_REG = _tm.registry()
_BATCH_SIZE = _REG.histogram(
    "scheduler_batch_size",
    "Jobs per released batch",
    ("bucket",),
    buckets=(1, 2, 4, 8, 16, 32),
)
_OCCUPANCY = _REG.gauge(
    "scheduler_bucket_occupancy",
    "Jobs currently lingering in a bucket, per bucket",
    ("bucket",),
)
_LINGER_WAIT = _REG.histogram(
    "scheduler_linger_wait_seconds",
    "Seconds a job waited in its bucket before batch release",
)
_BATCHES = _REG.counter(
    "scheduler_batches_total",
    "Batches released, by release reason (full | linger | flush)",
    ("reason",),
)


@dataclass(frozen=True)
class BucketKey:
    """Everything two jobs must agree on to prove as one batch: same
    circuit (hence CRS and QAP shapes), same curve, same packing factor
    (hence party count), same job kind. domain_size / num_inputs are
    derivable from circuit_id but carried explicitly — they ARE the
    tensor shapes the jit cache keys on, and the /stats + metrics label
    should say so without a store lookup."""

    kind: str
    circuit_id: str
    curve: str
    domain_size: int
    num_inputs: int
    l: int

    @property
    def n_parties(self) -> int:
        return 4 * self.l

    @property
    def label(self) -> str:
        """Compact metric-label spelling (bounded cardinality: one per
        (kind, circuit, l) actually served)."""
        return f"{self.kind}:{self.circuit_id}:m{self.domain_size}:l{self.l}"


@dataclass
class Batch:
    """A released group of shape-compatible jobs, ready to prove."""

    key: BucketKey
    jobs: list
    reason: str  # "full" | "linger" | "flush"
    created_at: float = 0.0


@dataclass
class _Bucket:
    key: BucketKey
    jobs: list = field(default_factory=list)
    enqueued_at: list = field(default_factory=list)  # clock() per job
    deadline: float = 0.0  # oldest job's linger deadline


# how much of the SLO target a job may spend WAITING (queue + linger)
# before its bucket must release: the other half is reserved for the
# proving round itself
_SLO_WAIT_FRACTION = 0.5


class Bucketer:
    def __init__(
        self,
        batch_max: int,
        linger_s: float,
        clock=time.monotonic,
        slo_target_s: float = 0.0,
        age_of=None,
        kind_overrides: dict | None = None,
    ):
        self.batch_max = max(1, batch_max)
        self.linger_s = max(0.0, linger_s)
        # per-kind (batch_max, linger_s) overrides — one bucketer, one
        # linger loop, different release knobs per workload: verify
        # buckets (DG16_VERIFY_BATCH_MAX / DG16_VERIFY_LINGER_MS,
        # docs/VERIFY.md) can afford far bigger batches than a mesh
        # lease, so they must not ride the prove knobs
        self.kind_overrides = dict(kind_overrides or {})
        self.clock = clock
        # deadline-aware release: <= 0 disables (unconditional linger).
        # `age_of` maps a job to its seconds-since-submission — injectable
        # (with `clock`) so the SLO-shortened linger is unit-testable
        # without wall-clock sleeps; the default reads ProofJob.created_at
        # against the wall clock, which is what job age means in an SLO.
        self.slo_target_s = slo_target_s
        self.age_of = age_of or (lambda job: time.time() - job.created_at)
        self._buckets: dict[BucketKey, _Bucket] = {}

    def __len__(self) -> int:
        return sum(len(b.jobs) for b in self._buckets.values())

    def batch_max_for(self, kind: str) -> int:
        """The release threshold governing buckets of this kind."""
        ov = self.kind_overrides.get(kind)
        return self.batch_max if ov is None else max(1, ov[0])

    def linger_s_for(self, kind: str) -> float:
        """The base linger governing buckets of this kind."""
        ov = self.kind_overrides.get(kind)
        return self.linger_s if ov is None else max(0.0, ov[1])

    def _linger_for(self, job, kind: str) -> float:
        """This job's linger allowance: the configured (per-kind) linger,
        shortened by however much of its SLO wait budget the queue
        already spent."""
        linger_s = self.linger_s_for(kind)
        if self.slo_target_s <= 0:
            return linger_s
        budget = _SLO_WAIT_FRACTION * self.slo_target_s - self.age_of(job)
        return min(linger_s, max(0.0, budget))

    def add(self, job, key: BucketKey) -> Batch | None:
        """Admit one job. Returns a released Batch when this admission
        fills the bucket to batch_max, else None (the job lingers until
        `pop_expired` or a later filling admission)."""
        now = self.clock()
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _Bucket(
                key=key, deadline=now + self._linger_for(job, key.kind)
            )
        else:
            # the TIGHTEST member deadline governs the bucket: an aged
            # job joining a fresh bucket must still release in time
            b.deadline = min(
                b.deadline, now + self._linger_for(job, key.kind)
            )
        b.jobs.append(job)
        b.enqueued_at.append(now)
        _OCCUPANCY.labels(bucket=key.label).set(len(b.jobs))
        if len(b.jobs) >= self.batch_max_for(key.kind):
            return self._release(key, "full")
        return None

    def next_deadline(self) -> float | None:
        """Earliest linger deadline across non-empty buckets (clock units),
        or None when nothing lingers."""
        if not self._buckets:
            return None
        return min(b.deadline for b in self._buckets.values())

    def pop_expired(self, now: float | None = None) -> list[Batch]:
        """Release every bucket whose oldest job has lingered past the
        deadline."""
        now = self.clock() if now is None else now
        out = []
        for key in [k for k, b in self._buckets.items() if b.deadline <= now]:
            out.append(self._release(key, "linger"))
        return out

    def flush(self) -> list[Batch]:
        """Release everything (shutdown path)."""
        return [self._release(k, "flush") for k in list(self._buckets)]

    def _release(self, key: BucketKey, reason: str) -> Batch:
        b = self._buckets.pop(key)
        now = self.clock()
        for t in b.enqueued_at:
            _LINGER_WAIT.observe(now - t)
        _OCCUPANCY.labels(bucket=key.label).set(0)
        _BATCH_SIZE.labels(bucket=key.label).observe(len(b.jobs))
        _BATCHES.labels(reason=reason).inc()
        return Batch(key=key, jobs=b.jobs, reason=reason, created_at=now)

    def occupancy(self) -> dict[str, int]:
        """{bucket label: lingering job count} — the /stats spelling."""
        return {k.label: len(b.jobs) for k, b in self._buckets.items()}
