"""Proof-job records: the unit of work the service layer schedules.

A `ProofJob` is everything the worker pool needs to run one proof off the
request path — the parsed submission payload, lifecycle state, wall-clock
stamps, per-phase timings, and (on completion) either a result payload or
a structured error. State machine:

    QUEUED --> RUNNING --> DONE
       |          |`-----> FAILED
       |          `------> CANCELLED   (cooperative, between phases)
       `-----------------> CANCELLED   (never ran)

All state transitions happen on the event-loop thread (the worker pool's
tasks); the executor thread only reads `cancel_requested` (a
threading.Event) and writes through the transition helpers' return values,
so no per-job lock is needed.
"""

from __future__ import annotations

import asyncio
import enum
import json
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ..telemetry import aggregate as _aggregate
from ..telemetry import logbus as _logbus
from ..telemetry.tracing import TraceBuffer, chrome_envelope
from ..utils.timers import PhaseTimings

# Failure-DTO sanitization (docs/ROBUSTNESS.md): exception messages are
# operator-facing via GET /jobs/{id} AND durable via the job journal, so
# they must not leak witness-adjacent material. Two redactions cover the
# real leak vectors observed in practice: filesystem paths (a failed
# witness upload names the tmp file it was spooled to) and huge integer
# literals (a field-element mismatch embeds the ~77-digit value).
_PATH_RE = re.compile(r"(?:/[\w.+-]+){2,}/?")
_BIGINT_RE = re.compile(r"\d{20,}")
_MESSAGE_CAP = 300


# how many of the job's own log records the status DTO carries — a tail,
# not the firehose (the full filtered stream lives behind GET /logs)
LOG_TAIL = 50


def sanitize_message(msg: str) -> str:
    msg = _PATH_RE.sub("<path>", msg)
    msg = _BIGINT_RE.sub("<bigint>", msg)
    if len(msg) > _MESSAGE_CAP:
        msg = msg[:_MESSAGE_CAP] + "…"
    return msg


def error_dto(exc: BaseException, phase: str | None = None) -> dict[str, Any]:
    """The structured failure shape every surface shares — status DTO,
    journal record, shutdown pre-journal: {type, message, phase}, never
    a raw repr(exc)."""
    return {
        "type": type(exc).__name__,
        "message": sanitize_message(str(exc)),
        "phase": phase,
    }


class JobState(str, enum.Enum):
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    @property
    def terminal(self) -> bool:
        return self in (JobState.DONE, JobState.FAILED, JobState.CANCELLED)


class JobCancelled(Exception):
    """Raised by the executor at a cooperative cancellation point."""


@dataclass
class ProofJob:
    """One queued proving request.

    kind:    "prove" (single-prover) | "mpc_prove" (packed-MPC round) |
             "verify" (batched Groth16 verification, docs/VERIFY.md) |
             "aggregate" (RLC proof-bundle attestation)
    fields:  the raw multipart fields of the submission (witness bytes,
             JSON inputs, or a proofs_file batch) — parsed lazily by the
             executor, off the request path.
    """

    kind: str
    circuit_id: str
    fields: dict[str, bytes]
    l: int = 2
    # fleet identity (docs/FLEET.md): which tenant submitted the job
    # (X-DG16-Tenant at the router/replica door) and its priority class.
    # Pure metadata at the replica — quotas and weighted-fair dispatch
    # are enforced at the router; here they ride the DTO and the journal
    # so a handoff re-routes under the right tenant.
    tenant: str = ""
    priority: str = ""
    # end-to-end trace context (docs/OBSERVABILITY.md "Fleet
    # observatory"): minted by the fleet router next to the idempotent
    # job id and propagated via the X-DG16-Trace header, or minted at
    # the replica door for direct submissions. Rides the DTO and the
    # journal so a handoff re-proves under the SAME trace, and the
    # stitched fleet trace can join router spans to replica spans.
    trace_id: str = ""
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    state: JobState = JobState.QUEUED
    created_at: float = field(default_factory=time.time)
    started_at: float | None = None
    finished_at: float | None = None
    timings: PhaseTimings = field(default_factory=PhaseTimings)
    # per-proof span trace (telemetry/tracing.py): the executor collects
    # into this while the job runs; GET /jobs/{id} returns it as a span
    # tree. Bounded so 1024 retained terminal jobs stay cheap.
    trace: TraceBuffer = field(
        default_factory=lambda: TraceBuffer(max_events=4096),
        repr=False, compare=False,
    )
    result: dict[str, Any] | None = None
    error: dict[str, Any] | None = None

    def __post_init__(self):
        import threading

        # set from the event loop on DELETE, read from the executor thread
        # at phase boundaries — the only cross-thread signal a job carries
        self._cancel_flag = threading.Event()
        self._done = asyncio.Event()
        # terminal-state trace snapshots (see _finish): the span tree for
        # the status DTO, the raw Chrome trace for GET /jobs/{id}/trace,
        # and the round critical-path decomposition
        self._spans_json: str | None = None
        self._chrome_json: str | None = None
        self._logs_json: str | None = None
        self._critical_path: dict | None = None
        self._dropped_spans = 0
        # the phase the executor is currently in (note_phase) — failure
        # DTOs carry it so "FAILED" says where; written from the worker
        # thread, read at the loop-side terminal transition (a str swap
        # is atomic, no lock needed)
        self._phase: str | None = None
        # device-memory stamp (telemetry/devmem.py): how much this job
        # raised the process HBM peak — written by the executor / batch
        # prover thread, None on backends without memory_stats (XLA:CPU)
        self._device_memory: dict | None = None

    # -- executor-side hooks (worker thread) --------------------------------

    def check_cancel(self) -> None:
        """Cooperative cancellation point; the executor calls this between
        phases so a cancel costs at most one phase, not the whole proof."""
        if self._cancel_flag.is_set():
            raise JobCancelled(self.id)

    def note_phase(self, name: str | None) -> None:
        """Executors stamp the phase they are entering so a failure DTO
        can say WHERE the job died ({type, message, phase})."""
        self._phase = name

    def note_device_memory(self, doc: dict | None) -> None:
        """Stamp the job's device-memory footprint ({peakBytes,
        peakDeltaBytes}, plus batchSize on the batched path) into the
        status DTO — None-safe where the backend reports nothing."""
        if doc is not None:
            self._device_memory = doc

    # -- loop-side transitions ----------------------------------------------

    def mark_running(self) -> None:
        self.state = JobState.RUNNING
        self.started_at = time.time()

    def mark_done(self, result: dict[str, Any]) -> None:
        self.state = JobState.DONE
        self.result = result
        self._finish()

    def mark_failed(self, exc: BaseException) -> None:
        self.state = JobState.FAILED
        self.error = error_dto(exc, phase=self._phase)
        self._finish()

    def mark_cancelled(self) -> None:
        self.state = JobState.CANCELLED
        self._finish()

    def request_cancel(self) -> None:
        self._cancel_flag.set()

    @property
    def cancel_requested(self) -> bool:
        """True once DELETE landed — read by the batching scheduler at
        batch-admission time (a job cancelled while lingering in a bucket
        must never enter a batch) and by the executor's check_cancel."""
        return self._cancel_flag.is_set()

    @property
    def bucket(self) -> str:
        """Coarse bucket label — the runtime-EMA key (service/queue.py).
        Cheap on purpose (no store lookup): kind + circuit + packing
        factor determine the work shape closely enough for retryAfter
        estimation; the scheduler's full BucketKey adds the shape fields
        it must not guess."""
        return f"{self.kind}:{self.circuit_id}:l{self.l}"

    def _finish(self) -> None:
        self.finished_at = time.time()
        # the submission payload (witness bytes, up to the 100 MB body cap)
        # is dead weight once the job is terminal — drop it so retained
        # terminal jobs cost registry metadata, not upload-sized buffers
        self.fields = {}
        # likewise the raw trace events: up to 4096 dicts per job across
        # 1024 retained jobs is hundreds of MB of Python objects. Compact
        # the span tree + the Chrome trace to JSON strings (tens of KB)
        # and drop them. An MPC job's trace holds EVERY party's spans
        # (the contextvar buffer flows into the per-party tasks), so the
        # Chrome export is already the merged per-job timeline — one
        # track per party — and supports a critical-path decomposition.
        self._dropped_spans = self.trace.dropped
        # snapshot this job's slice of the structured log ring NOW — the
        # shared ring keeps rolling after the job is terminal, and the
        # status DTO must keep answering "what did this job log" after
        # its records fell off (telemetry/logbus.py)
        self._logs_json = json.dumps(
            _logbus.ring().query(job=self.id, limit=LOG_TAIL)
        )
        events = self.trace.events()
        self._spans_json = json.dumps(self.trace.span_tree())
        self._chrome_json = json.dumps(self._envelope(events))
        if events:
            # window the decomposition to the MPC round: the harness
            # spans ("job", the load/witness/packing phases) are pid-0
            # wrappers covering the whole timeline, which would read as
            # king ~= wall and wire ~= 0. Inside the "MPC Proof" phase
            # the only spans are the per-party rounds, so the
            # king/straggler/wire split is real. A non-MPC job keeps the
            # whole-trace numbers (single-track: never recorded anyway).
            window = [e for e in events if e.get("name") == "MPC Proof"]
            if window:
                w0 = window[0]["ts"]
                w1 = w0 + window[0]["dur"]
                round_evs = [
                    e for e in events
                    if e.get("name") != "MPC Proof"
                    and e.get("ts", 0) >= w0
                    and e.get("ts", 0) + e.get("dur", 0) <= w1
                ]
            else:
                round_evs = events
            cp = _aggregate.critical_path(round_evs)
            self._critical_path = cp
            # record into the shared round series only when the plane is
            # OFF — with DG16_AGG on, the round boundary (merge_local's
            # finish_round) already recorded this round, and recording
            # here too would double every histogram sample. Single-track
            # jobs have no straggler and are never recorded.
            if cp["parties"] > 1 and not _aggregate.enabled():
                _aggregate.record_critical_path(cp)
        self.trace.clear()
        self._done.set()

    async def wait(self) -> "ProofJob":
        """Block until the job reaches a terminal state (the sync API
        wrappers' submit-and-await path)."""
        await self._done.wait()
        return self

    def _envelope(self, events: list) -> dict:
        """The job's Chrome trace object, stamped with the trace id so a
        downloaded file still says which end-to-end trace it belongs to
        (viewers ignore the extra key)."""
        env = chrome_envelope(events)
        if self.trace_id:
            env["traceId"] = self.trace_id
        return env

    def chrome_trace_json(self) -> str:
        """The job's Chrome trace-event JSON (GET /jobs/{id}/trace):
        the compacted snapshot once terminal, the live buffer before."""
        if self._chrome_json is not None:
            return self._chrome_json
        return json.dumps(self._envelope(self.trace.events()))

    @property
    def runtime_s(self) -> float | None:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    def to_dict(self) -> dict[str, Any]:
        """The GET /jobs/{id} status DTO."""
        out = {
            "jobId": self.id,
            "kind": self.kind,
            "circuitId": self.circuit_id,
            "tenant": self.tenant,
            "priority": self.priority,
            "traceId": self.trace_id,
            "state": self.state.value,
            "createdAt": self.created_at,
            "startedAt": self.started_at,
            "finishedAt": self.finished_at,
            "phases": self.timings.as_millis(),
            "metrics": (
                {
                    "spans": json.loads(self._spans_json),
                    "droppedSpans": self._dropped_spans,
                    "criticalPath": self._critical_path,
                    "deviceMemory": self._device_memory,
                }
                if self._spans_json is not None
                else {
                    "spans": self.trace.span_tree(),
                    "droppedSpans": self.trace.dropped,
                    "criticalPath": None,
                    "deviceMemory": self._device_memory,
                }
            ),
        }
        # the job's correlated log tail (docs/OBSERVABILITY.md "Logging
        # spine"): terminal jobs serve the _finish snapshot, running jobs
        # a live ring query keyed on the job id
        out["logs"] = (
            json.loads(self._logs_json)
            if self._logs_json is not None
            else _logbus.ring().query(job=self.id, limit=LOG_TAIL)
        )
        if self.error is not None:
            out["error"] = self.error
        return out
