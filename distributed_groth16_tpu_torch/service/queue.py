"""Asyncio job queue with admission control — the backpressure layer.

The queue is also the job registry and the service's bookkeeping core:
every submitted job stays addressable by id for status/result/cancel, and
completion statistics (counters, runtime EMA, merged phase timings) feed
both the `/stats` route and the retryAfter hint on rejections.

Admission control: at most `bound` jobs may be waiting (QUEUED). A submit
past that raises `QueueFullError` carrying a `retry_after_s` hint — the
API maps it to HTTP 429 — estimated as (depth / workers) x the observed
mean runtime of jobs in the rejected job's BUCKET (kind + circuit + l,
`ProofJob.bucket`), so a slow big circuit doesn't inflate hints for small
ones; unknown buckets fall back to the cross-bucket mean, and cold start
to a configured constant.

Everything here runs on the event-loop thread except `record_timings`
(PhaseTimings is internally locked), so plain attributes suffice.
"""

from __future__ import annotations

import asyncio
import math
from collections import deque

from ..telemetry import metrics as _tm
from ..utils.timers import PhaseTimings
from .jobs import JobState, ProofJob, error_dto

# Queue-shape metrics (docs/OBSERVABILITY.md). Process-wide like the rest
# of the registry: a process runs one service, so queue gauges are global.
_REG = _tm.registry()
_SUBMITTED = _REG.counter("jobs_submitted_total", "Jobs admitted to the queue")
_REJECTED = _REG.counter(
    "jobs_rejected_total", "Jobs rejected at the admission bound (HTTP 429)"
)
_FINISHED = _REG.counter(
    "jobs_finished_total", "Jobs reaching a terminal state", ("state",)
)
_DEPTH = _REG.gauge("job_queue_depth", "Jobs currently waiting (QUEUED)")
_RUNNING = _REG.gauge("job_queue_running", "Jobs currently executing")
_RUNTIME_EMA = _REG.gauge(
    "job_runtime_ema_seconds",
    "Exponential moving average of job runtime, per bucket — the "
    "retryAfter estimator (a slow big circuit must not inflate hints "
    "for small ones)",
    ("bucket",),
)
_QUEUE_WAIT = _REG.histogram(
    "job_queue_wait_seconds", "Seconds a job waited QUEUED before starting"
)
_JOB_SECONDS = _REG.histogram(
    "job_seconds", "End-to-end job runtime (RUNNING to terminal), per kind",
    ("kind",),
)


class QueueFullError(Exception):
    """Structured rejection: the queue is at its admission bound."""

    def __init__(self, bound: int, depth: int, retry_after_s: float):
        self.bound = bound
        self.depth = depth
        self.retry_after_s = retry_after_s
        super().__init__(
            f"job queue full ({depth}/{bound} queued); "
            f"retry in ~{retry_after_s:.0f}s"
        )


class JobQueue:
    def __init__(
        self,
        bound: int = 64,
        workers: int = 2,
        retry_after_s: float = 5.0,
        history_bound: int = 1024,
        journal=None,
    ):
        self.bound = bound
        self.workers = max(1, workers)
        self.default_retry_after_s = retry_after_s
        # optional durable job journal (service/journal.py): every
        # admission and state transition flowing through the queue is
        # recorded, so a crashed replica's successor can replay
        self.journal = journal
        # terminal jobs stay addressable for status polling, but only the
        # `history_bound` most recent — without eviction the registry (and
        # every result payload) grows without bound on a long-lived service
        self.history_bound = history_bound
        self._terminal_order: deque[str] = deque()
        self.jobs: dict[str, ProofJob] = {}
        self._q: asyncio.Queue[ProofJob] = asyncio.Queue()
        self._queued_ids: set[str] = set()
        self._running_ids: set[str] = set()
        # counters for /stats
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        # runtime EMA per bucket (jobs.ProofJob.bucket): retryAfter hints
        # are estimated from jobs of the SAME shape, so a slow big circuit
        # doesn't inflate the hint for a small one queued behind it
        self._runtime_ema_s: dict[str, float] = {}
        self.aggregate_timings = PhaseTimings()

    # -- submission (request path) ------------------------------------------

    def submit(self, job: ProofJob) -> ProofJob:
        """Synchronous admission (tests, startup replay — no traffic to
        stall). The request path uses submit_async so the journal fsync
        happens off the event loop."""
        self._admit_or_reject(job)
        if self.journal is not None:
            # durability BEFORE admission: once the caller sees a 202 the
            # job survives a crash (WAL contract, service/journal.py)
            self.journal.append_submit(job)
        self._enqueue(job)
        return job

    async def submit_async(self, job: ProofJob) -> ProofJob:
        """Request-path admission: the journal append (base64 of a
        payload up to the 100 MB body cap + write + fsync) must not run
        on the event loop — one big upload would stall /healthz,
        heartbeats, and every concurrent request. The admission slot is
        reserved BEFORE the thread hop so the 429 bound holds exactly
        under concurrent submissions, and returned on a failed append."""
        self._admit_or_reject(job)
        self.jobs[job.id] = job
        self._queued_ids.add(job.id)
        _DEPTH.set(len(self._queued_ids))
        if self.journal is not None:
            try:
                await asyncio.to_thread(self.journal.append_submit, job)
            except BaseException:
                self._queued_ids.discard(job.id)
                del self.jobs[job.id]
                _DEPTH.set(len(self._queued_ids))
                raise
            if job.state.terminal:
                # a DELETE landed during the append hop: cancel() found
                # the id missing from the journal and its CANCELLED
                # record was dropped — write the terminal record now or
                # the entry stays live forever and the next boot
                # resurrects a deliberately cancelled job
                await asyncio.to_thread(
                    self.journal.append_state, job.id, job.state, job.error
                )
                self.submitted += 1
                _SUBMITTED.inc()
                return job
        self._q.put_nowait(job)
        self.submitted += 1
        _SUBMITTED.inc()
        return job

    def _admit_or_reject(self, job: ProofJob) -> None:
        depth = len(self._queued_ids)
        if depth >= self.bound:
            self.rejected += 1
            _REJECTED.inc()
            raise QueueFullError(
                self.bound, depth, self.retry_after_hint(job.bucket)
            )

    def _enqueue(self, job: ProofJob) -> None:
        self.jobs[job.id] = job
        self._queued_ids.add(job.id)
        self._q.put_nowait(job)
        self.submitted += 1
        _SUBMITTED.inc()
        _DEPTH.set(len(self._queued_ids))

    def retry_after_hint(self, bucket: str | None = None) -> float:
        """Seconds until a queue slot plausibly frees: one full drain of
        the current backlog through the worker pool at the observed mean
        runtime of jobs in the SAME bucket. Unknown bucket (or none
        given) falls back to the mean across buckets; cold start falls
        back to the configured constant."""
        ema = self._runtime_ema_s.get(bucket) if bucket is not None else None
        if ema is None and self._runtime_ema_s:
            ema = sum(self._runtime_ema_s.values()) / len(self._runtime_ema_s)
        if ema is None:
            return self.default_retry_after_s
        drains = math.ceil((len(self._queued_ids) + 1) / self.workers)
        return max(1.0, drains * ema)

    # -- worker side ---------------------------------------------------------

    async def get(self) -> ProofJob:
        job = await self._q.get()
        self._queued_ids.discard(job.id)
        _DEPTH.set(len(self._queued_ids))
        return job

    def on_started(self, job: ProofJob) -> None:
        self._running_ids.add(job.id)
        _RUNNING.set(len(self._running_ids))
        if self.journal is not None:
            self.journal.append_state(job.id, JobState.RUNNING)
        if job.started_at is not None:
            _QUEUE_WAIT.observe(job.started_at - job.created_at)

    def on_finished(self, job: ProofJob) -> None:
        self._running_ids.discard(job.id)
        _RUNNING.set(len(self._running_ids))
        if job.state is JobState.DONE:
            self.completed += 1
        elif job.state is JobState.FAILED:
            self.failed += 1
        elif job.state is JobState.CANCELLED:
            self.cancelled += 1
        _FINISHED.labels(state=job.state.value).inc()
        if self.journal is not None:
            # idempotent: the shutdown paths (fail_terminal) journal the
            # terminal record first, and the journal drops a second
            # terminal append for an id it no longer holds live
            self.journal.append_state(job.id, job.state, error=job.error)
        rt = job.runtime_s
        if rt is not None:
            b = job.bucket
            prev = self._runtime_ema_s.get(b)
            self._runtime_ema_s[b] = (
                rt if prev is None else 0.7 * prev + 0.3 * rt
            )
            _RUNTIME_EMA.labels(bucket=b).set(self._runtime_ema_s[b])
            _JOB_SECONDS.labels(kind=job.kind).observe(rt)
        self.aggregate_timings.merge(job.timings)
        self._note_terminal(job)

    def _note_terminal(self, job: ProofJob) -> None:
        self._terminal_order.append(job.id)
        while len(self._terminal_order) > self.history_bound:
            jid = self._terminal_order.popleft()
            j = self.jobs.get(jid)
            if j is not None and j.state.terminal:
                del self.jobs[jid]

    def drain_pending(self) -> list[ProofJob]:
        """Pop every still-QUEUED job (shutdown path): the caller owns
        transitioning them to a terminal state so sync waiters and status
        pollers don't see QUEUED forever."""
        out = []
        while True:
            try:
                job = self._q.get_nowait()
            except asyncio.QueueEmpty:
                break
            self._queued_ids.discard(job.id)
            if job.state is JobState.QUEUED:
                out.append(job)
        _DEPTH.set(len(self._queued_ids))
        return out

    # -- control plane -------------------------------------------------------

    def cancel(self, job_id: str) -> ProofJob | None:
        """Cancel a job. QUEUED jobs flip to CANCELLED immediately and are
        skipped when popped; RUNNING jobs get a cooperative cancel request
        honored at the executor's next phase boundary. Terminal jobs are a
        no-op. Returns the job, or None if unknown."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if job.state is JobState.QUEUED:
            self._queued_ids.discard(job.id)
            _DEPTH.set(len(self._queued_ids))
            job.request_cancel()
            if self.journal is not None:
                # durable first: a crash right here must not resurrect a
                # job the operator deliberately cancelled
                self.journal.append_state(job.id, JobState.CANCELLED)
            job.mark_cancelled()
            self.cancelled += 1
            _FINISHED.labels(state=JobState.CANCELLED.value).inc()
            self._note_terminal(job)
        elif job.state is JobState.RUNNING:
            job.request_cancel()
        return job

    def fail_terminal(self, job: ProofJob, exc: BaseException) -> None:
        """Shutdown-drain path (WorkerPool.stop / BatchScheduler.stop):
        journal the terminal failure BEFORE the in-memory transition. The
        old order (mark_failed, then the on_finished journal write) left
        a crash window in which a deliberately failed job was still
        QUEUED on disk — the next boot would resurrect it."""
        if self.journal is not None:
            self.journal.append_state(
                job.id, JobState.FAILED, error=error_dto(exc)
            )
        job.mark_failed(exc)
        self.on_finished(job)

    def stats(self) -> dict:
        return {
            "queueDepth": len(self._queued_ids),
            "queueBound": self.bound,
            "workers": self.workers,
            "running": len(self._running_ids),
            "submitted": self.submitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            # the runtime EMAs feeding retry_after_hint, exposed both here
            # and as the job_runtime_ema_seconds{bucket} gauge on /metrics;
            # meanRuntimeS keeps its pre-bucketing shape (None until the
            # first job completes) as the cross-bucket mean
            "meanRuntimeS": (
                sum(self._runtime_ema_s.values()) / len(self._runtime_ema_s)
                if self._runtime_ema_s
                else None
            ),
            "runtimeEmaByBucket": dict(self._runtime_ema_s),
            "phases": self.aggregate_timings.as_millis(),
        }
