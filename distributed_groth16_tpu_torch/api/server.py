"""HTTP proving service — the mpc-api role (mpc-api/src/main.rs:795-805),
now fronting the proof-job service layer (service/, docs/SERVICE.md);
the counterpart of the JAX package's api/server.py, whose routes, DTOs,
status codes and headers it keeps. `ApiServer(..., device=None)` proves
on `device` (None: the card): it hands the device to the default
CircuitStore, the ProofExecutor and the batching scheduler's placement.
Run it with `python -m distributed_groth16_tpu_torch.api.server
[--device cpu]` (PORT, DG16_STORE and the DG16_SERVICE_* knobs as for the
JAX server).

Legacy routes and DTO field names mirror the reference exactly:

  POST /save_circuit                multipart: circuit_name, r1cs_file,
                                    witness_generator
  POST /create_proof_without_mpc    multipart: circuit_id, input_file |
                                    witness_file (.wtns)
  POST /create_proof_with_naive_mpc same fields (+ l)
  POST /verify_proof                JSON: circuitId, proof (bytes),
                                    publicInputs ([str]) — now a
                                    submit-and-await wrapper over a
                                    kind="verify" job (docs/VERIFY.md):
                                    malformed payloads get a typed 400
                                    {"error": {type, message, phase}},
                                    an invalid proof is isValid=false 200
  GET  /get_circuit_files/{id}

Jobs API (the async path — every proof, including the legacy synchronous
routes above, funnels through one queue + bounded worker pool):

  POST   /jobs/prove      same multipart fields + optional `mpc` flag;
                          returns {jobId, state} immediately
  POST   /jobs/verify     multipart: circuit_id, proofs_file (JSON array
                          of {proof, publicInputs}); a batched-RLC
                          verification job — same 202 DTO, same queue,
                          bucketer admission and journal as prove
                          (docs/VERIFY.md)
  POST   /jobs/aggregate  same fields; verifies then compresses the
                          batch into one RLC-folded bundle attestation
                          (result carries `bundle`, re-checkable by a
                          single multi-pairing)
  GET    /jobs/{id}       status DTO (state, timestamps, phases, error,
                          span tree + critical path under `metrics`)
  GET    /jobs/{id}/trace Chrome trace-event JSON of the job's merged
                          per-party timeline (open in chrome://tracing /
                          Perfetto; `dg16-cli trace` is the CLI spelling)
  GET    /jobs/{id}/result  proof DTO once DONE (409 while in flight)
  DELETE /jobs/{id}       cancel (QUEUED never runs; RUNNING cancels
                          cooperatively at the next phase boundary)
  GET    /healthz         liveness + pool shape (always 200 while the
                          process lives; body flips to "draining")
  GET    /readyz          readiness + fleet capacity document: HTTP 503
                          once a drain began so the balancer pulls the
                          replica; the JSON body carries replica id,
                          device inventory, open breakers, drain flag,
                          queue shape and SLO burn — everything the fleet
                          router reads in one poll (docs/FLEET.md)
  POST   /drain           begin a graceful drain WITHOUT SIGTERM access
                          (the router's `dg16-cli fleet drain` path):
                          admission closes, in-flight work finishes, the
                          process stays up
  GET    /stats           queue depth/counters, CRS-cache hit rate,
                          per-phase timing aggregates, batching-scheduler
                          bucket/placement state when DG16_BATCH_MAX > 1
                          (docs/SCHEDULER.md), profiler capture history
  POST   /profile         start one bounded on-demand torch.profiler capture
                          ({"durationS": 3}; single-flight — 409 while one
                          runs; docs/OBSERVABILITY.md "Device observatory")
  GET    /profile         capture history + the running capture id
  GET    /profile/{id}    the capture's .tar.gz trace artifact once done
                          (202 JSON while it still runs; `dg16-cli profile
                          capture` wraps the whole flow)
  GET    /slo             SLO burn-rate document per job kind (enabled via
                          DG16_SLO_TARGET_S / DG16_SLO_TARGETS; the
                          per-replica signal a router/autoscaler polls —
                          docs/OBSERVABILITY.md "SLO monitoring")
  GET    /metrics         Prometheus text exposition of the process-wide
                          telemetry registry (docs/OBSERVABILITY.md)

Backpressure: submissions past the queue bound get HTTP 429 with a
`retryAfter` hint (seconds). Sync responses keep the reference's camelCase
DTO shapes (common/src/dto/mod.rs): circuitId / circuitName / proof /
isValid / timeTaken / remarks; errors are HTTP 500 {"error": ...}
(CustomError semantics). Proofs travel as ark-style 128-byte compressed
blobs (frontend/ark_serde.py), JSON-encoded as byte lists.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import time
import uuid

from aiohttp import web

from ..service.jobs import error_dto
from ..telemetry import buildinfo as telemetry_buildinfo
from ..telemetry import devmem as telemetry_devmem
from ..telemetry import logbus as telemetry_logbus
from ..telemetry import metrics as telemetry_metrics
from ..telemetry import profiler as telemetry_profiler
from ..telemetry.aggregate import now_ns as _trace_now_ns
from ..service import (
    CrsCache,
    JobJournal,
    JobQueue,
    JobState,
    ProofExecutor,
    ProofJob,
    QueueFullError,
    SloMonitor,
    WorkerPool,
)
from ..service.slo import disabled_doc as _slo_disabled
from ..utils.config import (
    SchedulerConfig,
    ServiceConfig,
    SLOConfig,
    env_float,
    env_str,
)
from .store import CircuitStore

log = logging.getLogger(__name__)

MAX_BODY = 100 * 1024 * 1024  # 100 MB limit (main.rs:801)

_JOB_FIELDS = ("witness_file", "input_file", "proofs_file")

_DRAINING = telemetry_metrics.registry().gauge(
    "service_draining",
    "1 while the service is draining (SIGTERM received: admission closed, "
    "in-flight work finishing)",
)


class DrainingError(Exception):
    """Raised at admission once a drain began — mapped to HTTP 503 so a
    rolling-restart router retries the submission on a healthy replica."""


def _error(msg: str, status: int = 500) -> web.Response:
    return web.json_response({"error": msg}, status=status)


def _busy(e: QueueFullError) -> web.Response:
    return web.json_response(
        {
            "error": str(e),
            "retryAfter": round(e.retry_after_s, 1),
            "queueDepth": e.depth,
            "queueBound": e.bound,
        },
        status=429,
        headers={"Retry-After": str(int(e.retry_after_s) or 1)},
    )


async def _read_multipart(request) -> dict[str, bytes]:
    reader = await request.multipart()
    out = {}
    async for part in reader:
        out[part.name] = await part.read(decode=False)
    return out


def _millis(t0: float) -> int:
    return int((time.time() - t0) * 1000)


class ApiServer:
    def __init__(
        self,
        store: CircuitStore | None = None,
        cfg: ServiceConfig | None = None,
        sched_cfg: SchedulerConfig | None = None,
        slo_cfg: SLOConfig | None = None,
        device=None,
    ):
        # jobs prove on `device` (None: the card): the default store's
        # keys, the executor's witnesses and circuits, the scheduler's meshes
        self.store = store or CircuitStore(device=device)
        self.cfg = cfg or ServiceConfig.from_env()
        self.sched_cfg = sched_cfg or SchedulerConfig.from_env()
        self.slo_cfg = slo_cfg or SLOConfig.from_env()
        # fleet identity (docs/FLEET.md): what this replica calls itself
        # in its /readyz capacity document and the router's replica table
        self.replica_id = self.cfg.replica_id or f"r-{uuid.uuid4().hex[:8]}"
        # logging spine (docs/OBSERVABILITY.md "Logging spine"): install
        # the structured ring handler and stamp records with our fleet
        # identity; console output stays whatever the entry point chose
        telemetry_logbus.setup(console=False)
        telemetry_logbus.set_replica(self.replica_id)
        # SLO burn-rate sampler (docs/OBSERVABILITY.md "SLO monitoring"):
        # derives slo_burn_rate{kind}/slo_budget_remaining{kind} from the
        # job_seconds series on a timer; DG16_SLO_TARGET_S <= 0 (and no
        # per-kind targets) leaves the whole plane off
        self.slo: SloMonitor | None = (
            SloMonitor(self.slo_cfg) if self.slo_cfg.enabled else None
        )
        self._slo_task: asyncio.Task | None = None
        self.crs_cache = CrsCache(self.cfg.crs_cache_size)
        # durable job journal (DG16_JOURNAL, docs/ROBUSTNESS.md): with it
        # on, every accepted job is fsynced before the 202 and replayed
        # at the next boot — a crashed replica's successor finishes its
        # backlog instead of silently dropping it
        self.journal: JobJournal | None = None
        jdir = self.cfg.journal_dir
        if jdir:
            if jdir.lower() in ("1", "true"):
                jdir = os.path.join(self.store.root, "_journal")
            self.journal = JobJournal(
                jdir,
                fsync=self.cfg.journal_fsync,
                segment_records=self.cfg.journal_segment_records,
            )
        self.draining = False
        _DRAINING.set(0)
        self.queue = JobQueue(
            bound=self.cfg.queue_bound,
            workers=self.cfg.workers,
            retry_after_s=self.cfg.retry_after_s,
            history_bound=self.cfg.job_history,
            journal=self.journal,
        )
        self.executor = ProofExecutor(
            self.store, self.crs_cache, self.cfg, device=device
        )
        # the batching scheduler (docs/SCHEDULER.md) is opt-in: with
        # DG16_BATCH_MAX <= 1 the pool runs its per-job funnel exactly
        self.scheduler = None
        if self.sched_cfg.batch_max > 1:
            import torch

            from ..scheduler import BatchScheduler

            self.scheduler = BatchScheduler(
                self.executor, self.queue, self.sched_cfg,
                devices=None if device is None else [torch.device(device)],
                slo_target_s=self.slo_cfg.target_s,
            )
        self.pool = WorkerPool(
            self.queue, self.executor, self.cfg.workers,
            scheduler=self.scheduler,
        )
        # device observatory (docs/OBSERVABILITY.md): on-demand
        # torch.profiler (artifacts under DG16_PROF_DIR, default a _profiles
        # dir next to the circuit store) and the HBM gauge sampler
        self.profiler = telemetry_profiler.Profiler(
            env_str("DG16_PROF_DIR", "")
            or os.path.join(self.store.root, "_profiles")
        )
        self.devmem_sample_s = env_float("DG16_DEVMEM_SAMPLE_S", 10.0)
        self._devmem_task: asyncio.Task | None = None
        # constant-1 identity gauge + the /readyz buildInfo block — how a
        # mixed-version fleet shows up in `fleet top`
        self.build_info = telemetry_buildinfo.build_info(device)

    # -- job plumbing --------------------------------------------------------

    async def _submit(
        self, fields: dict[str, bytes], kind: str, request=None
    ) -> ProofJob:
        """Build + enqueue a ProofJob from multipart fields. Raises
        KeyError/ValueError on malformed submissions (mapped to 500 by the
        callers, CustomError-style), QueueFullError past the bound, and
        DrainingError (503) once a graceful drain began. Async because
        the journal fsync runs off the loop (queue.submit_async).

        Fleet hooks (docs/FLEET.md): the X-DG16-Tenant / X-DG16-Priority
        headers stamp the job's identity, and a caller-supplied `job_id`
        field makes submission IDEMPOTENT — a re-submission of a known id
        (the router handing a dead replica's journal off while that
        replica replays it itself) returns the existing job instead of
        proving twice."""
        if self.draining:
            raise DrainingError("service is draining; not accepting jobs")
        job_id = fields.get("job_id", b"").decode().strip()
        if job_id:
            existing = self.queue.jobs.get(job_id)
            if existing is not None:
                return existing
        circuit_id = fields["circuit_id"].decode()
        tenant = priority = trace_id = ""
        if request is not None:
            tenant = request.headers.get("X-DG16-Tenant", "").strip()
            priority = request.headers.get("X-DG16-Priority", "").strip()
            # trace context (docs/OBSERVABILITY.md "Fleet observatory"):
            # the router mints one trace id per job and propagates it in
            # X-DG16-Trace; a direct submission mints its own here so
            # every job has a trace whether or not a router fronted it
            trace_id = request.headers.get("X-DG16-Trace", "").strip()
        kwargs = {"id": job_id} if job_id else {}
        job = ProofJob(
            kind=kind,
            circuit_id=circuit_id,
            fields={k: fields[k] for k in _JOB_FIELDS if k in fields},
            l=int(fields.get("l", b"2").decode()),
            tenant=tenant,
            priority=priority,
            trace_id=trace_id or uuid.uuid4().hex,
            **kwargs,
        )
        return await self.queue.submit_async(job)

    # -- crash recovery + graceful drain -------------------------------------

    def _replay_journal(self) -> int:
        """Re-enqueue every journaled non-terminal job (startup path):
        QUEUED jobs simply re-queue; jobs interrupted mid-RUNNING are
        re-submitted from their journaled payload and prove again.
        Idempotent by job id — the journal turns the re-submission into a
        requeue record, not a duplicate payload."""
        if self.journal is None:
            return 0
        replayed = 0
        for entry in self.journal.pending():
            interrupted_state = entry.state
            job = ProofJob(
                kind=entry.kind,
                circuit_id=entry.circuit_id,
                fields=dict(entry.fields),
                l=entry.l,
                tenant=entry.tenant,
                priority=entry.priority,
                # the crash must not break the end-to-end trace: the
                # replayed job re-proves under the journaled trace id
                trace_id=entry.trace_id or uuid.uuid4().hex,
                id=entry.id,
                created_at=entry.created_at,
            )
            try:
                self.queue.submit(job)
            except QueueFullError:
                # a replica restarted under a full backlog: the rest of
                # the journal stays live and the NEXT boot (or a manual
                # `dg16-cli job recover`) picks it up
                log.warning("journal replay stopped at the admission bound")
                break
            self.journal.note_replayed(interrupted_state)
            replayed += 1
        if replayed:
            log.info("journal replay re-enqueued %d job(s)", replayed)
        return replayed

    def begin_drain(self) -> None:
        """Flip the service into draining: /healthz turns 503, admission
        refuses (503 + DrainingError), lingering buckets flush early."""
        self.draining = True
        _DRAINING.set(1)

    async def drain(self) -> None:
        """Graceful drain (SIGTERM): stop admitting, flush partial
        batches, then wait until every accepted job is terminal — so a
        rolling restart loses nothing even before the journal replays."""
        self.begin_drain()
        while True:
            if self.scheduler is not None:
                await self.scheduler.drain()
            # every registered job terminal — not just "queue empty":
            # a job mid-offer (between queue pop and bucket admission)
            # is in neither gauge but is still owed work
            if all(j.state.terminal for j in self.queue.jobs.values()):
                return
            await asyncio.sleep(0.05)

    async def _submit_and_await(self, request, kind: str) -> ProofJob:
        """The legacy synchronous routes: enqueue, then block the request
        (not the loop) until the job is terminal."""
        fields = await _read_multipart(request)
        job = await self._submit(fields, kind, request=request)
        await job.wait()
        return job

    # -- legacy handlers -----------------------------------------------------

    async def save_circuit(self, request):
        t0 = time.time()
        try:
            fields = await _read_multipart(request)
            name = fields["circuit_name"].decode()
            r1cs = fields["r1cs_file"]
            wasm = fields.get("witness_generator", b"")
            circuit_id = await asyncio.to_thread(
                self.store.save_circuit, name, r1cs, wasm
            )
        except Exception as e:  # noqa: BLE001 — CustomError-style 500
            return _error(str(e))
        return web.json_response(
            {
                "circuitId": circuit_id,
                "circuitName": name,
                "timeTaken": _millis(t0),
            }
        )

    async def create_proof_without_mpc(self, request):
        t0 = time.time()
        try:
            job = await self._submit_and_await(request, "prove")
        except QueueFullError as e:
            return _busy(e)
        except DrainingError as e:
            return _error(str(e), status=503)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        if job.state is not JobState.DONE:
            return _error((job.error or {}).get("message", job.state.value))
        return web.json_response(
            {
                "circuitId": job.circuit_id,
                "proof": job.result["proof"],
                "timeTaken": _millis(t0),
            }
        )

    async def create_proof_with_naive_mpc(self, request):
        t0 = time.time()
        try:
            job = await self._submit_and_await(request, "mpc_prove")
        except QueueFullError as e:
            return _busy(e)
        except DrainingError as e:
            return _error(str(e), status=503)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        if job.state is not JobState.DONE:
            return _error((job.error or {}).get("message", job.state.value))
        return web.json_response(
            {
                "circuitId": job.circuit_id,
                "proof": job.result["proof"],
                "timeTaken": _millis(t0),
                "phases": job.result["phases"],
            }
        )

    async def verify_proof(self, request):
        """Legacy single-proof verification — now a submit-and-await
        wrapper over a kind="verify" job (docs/VERIFY.md), so the check
        rides the same queue, metrics (job_seconds{kind="verify"},
        jobs_finished_total) and scheduler batching as every other job.
        A malformed payload is a typed 400 with the sanitized error DTO
        ({type, message, phase}), never a 500 traceback; an invalid but
        well-formed proof is a definite verdict: isValid=false, HTTP 200."""
        t0 = time.time()
        try:
            body = await request.json()
            circuit_id = str(body["circuitId"])
            proof_bytes = bytes(bytearray(body["proof"]))
            publics = [str(int(x)) for x in body["publicInputs"]]
        except Exception as e:  # noqa: BLE001 — malformed request body
            return web.json_response(
                {"error": error_dto(e, phase="parse")}, status=400
            )
        payload = json.dumps(
            [{"proof": list(proof_bytes), "publicInputs": publics}]
        ).encode()
        try:
            job = await self._submit(
                {"circuit_id": circuit_id.encode(), "proofs_file": payload},
                "verify",
                request=request,
            )
            await job.wait()
        except QueueFullError as e:
            return _busy(e)
        except DrainingError as e:
            return _error(str(e), status=503)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        err = job.error or {}
        if job.state is JobState.DONE:
            is_valid = True
        elif err.get("type") == "InvalidProofError":
            is_valid = False  # definite verdict, not an error
        elif err.get("type") in ("ValueError", "KeyError", "TypeError"):
            # payload the executor could not even parse: client error
            return web.json_response({"error": err}, status=400)
        else:
            return _error(err.get("message", job.state.value))
        return web.json_response(
            {
                "circuitId": circuit_id,
                "publicInputs": publics,
                "verifierKey": None,
                "proof": list(proof_bytes),
                "isValid": is_valid,
                "timeTaken": _millis(t0),
                "remarks": None,
            }
        )

    async def get_circuit_files(self, request):
        t0 = time.time()
        try:
            circuit_id = request.match_info["circuit_id"]
            r1cs, wasm = await asyncio.to_thread(
                self.store.get_files, circuit_id
            )
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        return web.json_response(
            {
                "r1csFile": list(r1cs),
                "witnessGenerator": list(wasm),
                "timeTaken": _millis(t0),
            }
        )

    # -- jobs API ------------------------------------------------------------

    async def jobs_prove(self, request):
        try:
            fields = await _read_multipart(request)
            mpc = fields.get("mpc", b"").decode().lower() in ("1", "true", "yes")
            job = await self._submit(
                fields, "mpc_prove" if mpc else "prove", request=request
            )
        except QueueFullError as e:
            return _busy(e)
        except DrainingError as e:
            return _error(str(e), status=503)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        return web.json_response(
            {
                "jobId": job.id,
                "circuitId": job.circuit_id,
                "state": job.state.value,
                "queueDepth": self.queue.stats()["queueDepth"],
            },
            status=202,
        )

    async def _jobs_submit_batchable(self, request, kind: str):
        """POST /jobs/verify and /jobs/aggregate — the 202 submission
        path for the verification plane (docs/VERIFY.md). Unlike the
        prove route, a malformed submission here is a typed 400 with the
        sanitized error DTO — the verify plane's contract everywhere."""
        try:
            fields = await _read_multipart(request)
            if "circuit_id" not in fields:
                raise ValueError("need a circuit_id field")
            if "proofs_file" not in fields:
                raise ValueError(
                    "need a proofs_file field "
                    "(JSON array of {proof, publicInputs})"
                )
            job = await self._submit(fields, kind, request=request)
        except QueueFullError as e:
            return _busy(e)
        except DrainingError as e:
            return _error(str(e), status=503)
        except (KeyError, ValueError, TypeError) as e:
            return web.json_response(
                {"error": error_dto(e, phase="submit")}, status=400
            )
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        return web.json_response(
            {
                "jobId": job.id,
                "circuitId": job.circuit_id,
                "state": job.state.value,
                "queueDepth": self.queue.stats()["queueDepth"],
            },
            status=202,
        )

    async def jobs_verify(self, request):
        return await self._jobs_submit_batchable(request, "verify")

    async def jobs_aggregate(self, request):
        return await self._jobs_submit_batchable(request, "aggregate")

    def _job_or_404(self, request) -> ProofJob | web.Response:
        job = self.queue.jobs.get(request.match_info["job_id"])
        if job is None:
            return _error("unknown job id", status=404)
        return job

    async def job_status(self, request):
        job = self._job_or_404(request)
        if isinstance(job, web.Response):
            return job
        return web.json_response(job.to_dict())

    async def job_trace(self, request):
        """Chrome trace-event JSON of the job's span timeline — the
        compacted terminal snapshot, or the live buffer while running."""
        job = self._job_or_404(request)
        if isinstance(job, web.Response):
            return job
        return web.Response(
            text=job.chrome_trace_json(),
            content_type="application/json",
            charset="utf-8",
        )

    async def job_result(self, request):
        job = self._job_or_404(request)
        if isinstance(job, web.Response):
            return job
        if job.state is JobState.FAILED:
            return _error((job.error or {}).get("message", "job failed"))
        if job.state is JobState.CANCELLED:
            return _error("job was cancelled", status=410)
        if job.state is not JobState.DONE:
            return _error(f"job not finished (state {job.state.value})", 409)
        rt = job.runtime_s or 0.0
        body = {
            "jobId": job.id,
            "circuitId": job.circuit_id,
            "timeTaken": int(rt * 1000),
            "remarks": None,
        }
        # prove-kind results carry {proof, phases}; verify/aggregate
        # results carry {count, verdicts, pairingsSaved, bundle?, phases}
        # — return whichever shape the job produced
        body.update(job.result or {})
        return web.json_response(body)

    async def job_cancel(self, request):
        job = self.queue.cancel(request.match_info["job_id"])
        if job is None:
            return _error("unknown job id", status=404)
        return web.json_response(
            {
                "jobId": job.id,
                "state": job.state.value,
                "cancelRequested": not job.state.terminal,
            }
        )

    async def healthz(self, request):
        """LIVENESS: always 200 while the process is healthy — including
        during a drain (the body says "draining"). A liveness probe must
        not kill a replica that is deliberately finishing its work; use
        /readyz for rotation decisions."""
        s = self.queue.stats()
        return web.json_response(
            {
                "status": "draining" if self.draining else "ok",
                "workers": s["workers"],
                "queueDepth": s["queueDepth"],
                "running": s["running"],
            }
        )

    async def readyz(self, request):
        """READINESS + capacity document (docs/FLEET.md): 503 while
        draining so a balancer pulls the replica, and a JSON body that
        tells the fleet router everything discovery needs in ONE poll —
        replica id, device inventory size, open mesh-breaker count, the
        drain flag, the live queue shape, and the worst SLO burn rate
        across kinds. /healthz keeps its original liveness body.

        Clock echo (docs/OBSERVABILITY.md "Fleet observatory"): a poll
        carrying `?echo=<t0_ns>` gets a `clockEcho` block back —
        {t0 echoed, t1 receipt, t2 send} over perf_counter_ns, the same
        clock span timestamps use — one NTP-style sample per poll, so
        the router can rebase this replica's trace events onto its own
        timeline when stitching the fleet trace."""
        t1_ns = _trace_now_ns()
        s = self.queue.stats()
        open_breakers = 0
        devices = 0
        if self.scheduler is not None:
            placement = self.scheduler.devices.stats()
            devices = placement["devices"]
            open_breakers = sum(
                1 for st in placement["breakers"].values() if st != "closed"
            )
        max_burn = 0.0
        if self.slo is not None:
            doc = self.slo.sample()
            burns = [k["burnRate"] for k in doc["kinds"].values()]
            max_burn = max(burns) if burns else 0.0
        body = {
            "status": "draining" if self.draining else "ok",
            "replicaId": self.replica_id,
            "draining": self.draining,
            "devices": devices,
            "openBreakers": open_breakers,
            "workers": s["workers"],
            "queueDepth": s["queueDepth"],
            "queueBound": s["queueBound"],
            "running": s["running"],
            "maxBurnRate": round(max_burn, 4),
            # build identity (telemetry/buildinfo.py): the fleet registry
            # keeps it per replica so `fleet top` shows a mixed-version
            # fleet during a rolling upgrade
            "buildInfo": self.build_info,
        }
        echo = request.query.get("echo")
        if echo is not None:
            try:
                body["clockEcho"] = {
                    "t0": int(echo),
                    "t1": t1_ns,
                    "t2": _trace_now_ns(),
                }
            except ValueError:
                pass  # malformed echo: answer the capacity doc anyway
        return web.json_response(body, status=503 if self.draining else 200)

    async def drain_route(self, request):
        """POST /drain — operator/router-initiated graceful drain without
        SIGTERM access to the process (`dg16-cli fleet drain`,
        docs/FLEET.md): admission closes, /readyz flips 503, lingering
        buckets flush early, in-flight jobs finish. Unlike the SIGTERM
        path the process does NOT exit — a drained replica sits idle,
        journal checkpointed by whatever stops it later. Idempotent."""
        already = self.draining
        self.begin_drain()
        if self.scheduler is not None and not already:
            # early-flush lingering buckets like the SIGTERM drain does,
            # but without blocking the request on in-flight work
            self.scheduler.flush_lingering()
        return web.json_response(
            {
                "status": "draining",
                "replicaId": self.replica_id,
                "alreadyDraining": already,
            }
        )

    async def stats(self, request):
        return web.json_response(
            {
                "queue": self.queue.stats(),
                "crsCache": self.crs_cache.stats(),
                "verifierCache": self.executor.verifier.pvk_cache.stats(),
                "journal": (
                    self.journal.stats()
                    if self.journal is not None
                    else {"enabled": False}
                ),
                "scheduler": (
                    self.scheduler.stats()
                    if self.scheduler is not None
                    else {"enabled": False}
                ),
                "slo": (
                    self.slo.sample()
                    if self.slo is not None
                    else _slo_disabled()
                ),
                "profiler": self.profiler.stats(),
            }
        )

    async def slo_status(self, request):
        """The SLO document alone — what a router/autoscaler polls per
        replica (sampled fresh, not waiting on the background timer)."""
        if self.slo is None:
            return web.json_response(_slo_disabled())
        return web.json_response(self.slo.sample())

    async def metrics(self, request):
        """Prometheus text format 0.0.4 scrape endpoint."""
        return web.Response(
            text=telemetry_metrics.registry().render_prometheus(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def logs(self, request):
        """GET /logs — the structured log ring, filterable by
        ?level= (minimum), ?since= (exclusive seq cursor — the --follow
        primitive), ?trace=, ?job=, ?logger= (prefix), ?limit= (tail
        cap). Returns records oldest-first plus a `nextSince` cursor
        (docs/OBSERVABILITY.md "Logging spine")."""
        q = request.rel_url.query
        try:
            since = int(q["since"]) if "since" in q else None
            limit = int(q.get("limit", "256"))
        except ValueError:
            return _error("since/limit must be integers", status=400)
        level = q.get("level")
        if level and level.upper() not in telemetry_logbus.LEVELS:
            return _error(
                "level must be one of DEBUG/INFO/WARNING/ERROR/CRITICAL",
                status=400,
            )
        ring = telemetry_logbus.ring()
        records = ring.query(
            level=level,
            since=since,
            trace=q.get("trace") or None,
            job=q.get("job") or None,
            logger=q.get("logger") or None,
            limit=limit,
        )
        return web.json_response({
            "replicaId": self.replica_id,
            "records": records,
            "nextSince": records[-1]["seq"] if records else ring.seq,
            # the router rebases our records onto its clock from this
            # (same perf_counter_ns timebase ClockSync measures)
            "nowNs": _trace_now_ns(),
        })

    # -- on-demand profiling (docs/OBSERVABILITY.md "Device observatory") ----

    async def profile_start(self, request):
        """POST /profile — begin one bounded single-flight torch.profiler
        capture mid-job; 409 while another runs. The start runs off the
        loop (the capture's own thread starts the profiler and CUPTI)."""
        duration = telemetry_profiler.DEFAULT_DURATION_S
        if request.can_read_body:
            try:
                body = await request.json()
                duration = float(body.get("durationS", duration))
            except (ValueError, TypeError, AttributeError):
                # not JSON, not an object, or durationS not a number —
                # all the same 400, never a 500 traceback
                return _error(
                    "body must be JSON like {\"durationS\": 3}", status=400
                )
        if duration <= 0:
            return _error("durationS must be > 0", status=400)
        try:
            cap = await asyncio.to_thread(self.profiler.start, duration)
        except telemetry_profiler.ProfileBusyError as e:
            return _error(str(e), status=409)
        except telemetry_profiler.ProfileError as e:
            return _error(str(e))
        return web.json_response(
            {"id": cap.id, "state": cap.state, "durationS": cap.duration_s},
            status=202,
        )

    async def profile_status(self, request):
        """GET /profile — capture history + whichever capture runs now."""
        return web.json_response(self.profiler.stats())

    async def profile_artifact(self, request):
        """GET /profile/{id} — the .tar.gz trace artifact once the capture
        finished; 202 JSON while it still runs (poll), 404 unknown id,
        500 when the capture errored."""
        cap = self.profiler.get(request.match_info["capture_id"])
        if cap is None:
            return _error("unknown capture id", status=404)
        if cap.state == "running":
            return web.json_response(cap.to_dict(), status=202)
        if cap.state != "done" or not cap.artifact:
            return _error(cap.error or "capture failed")
        return web.FileResponse(
            cap.artifact,
            headers={
                "Content-Type": "application/gzip",
                "Content-Disposition":
                    f'attachment; filename="profile-{cap.id}.tar.gz"',
            },
        )

    # -- app -----------------------------------------------------------------

    async def _on_startup(self, app):
        # replay BEFORE the workers start pulling: the backlog of a
        # crashed predecessor re-queues in submission order, ahead of
        # anything the fresh process admits
        self._replay_journal()
        await self.pool.start()
        if self.slo is not None:
            self._slo_task = asyncio.create_task(self._slo_loop())
        if self.devmem_sample_s > 0:
            self._devmem_task = asyncio.create_task(self._devmem_loop())
        self._install_signal_handlers()

    async def _slo_loop(self) -> None:
        """Background burn-rate sampler: keeps the slo_* gauges fresh for
        scrapes that never touch /slo or /stats."""
        assert self.slo is not None
        while True:
            await asyncio.sleep(self.slo_cfg.sample_s)
            self.slo.sample()

    async def _devmem_loop(self) -> None:
        """Background device-memory sampler: keeps the
        device_memory_bytes{device,kind} gauges fresh between jobs
        (DG16_DEVMEM_SAMPLE_S; a no-op data-wise on the CPU, which
        reports no stats)."""
        while True:
            await asyncio.sleep(self.devmem_sample_s)
            await asyncio.to_thread(telemetry_devmem.sample)

    async def _on_cleanup(self, app):
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except asyncio.CancelledError:
                pass
            self._slo_task = None
        if self._devmem_task is not None:
            self._devmem_task.cancel()
            try:
                await self._devmem_task
            except asyncio.CancelledError:
                pass
            self._devmem_task = None
        # a capture left running would outlive its server: stop + pack it
        # off the loop — the tar pack is minutes-scale under a saturated
        # CPU and must not stall the rest of teardown
        await asyncio.to_thread(self.profiler.stop)
        await self.pool.stop()
        self._remove_signal_handlers()
        if self.journal is not None:
            # clean-shutdown checkpoint: compact to exactly the jobs
            # still owed work (empty after a full drain) so the next
            # boot replays precisely those
            self.journal.checkpoint()
            self.journal.close()

    # -- SIGTERM -> drain -> exit ---------------------------------------------

    def _install_signal_handlers(self) -> None:
        """SIGTERM starts a graceful drain instead of aiohttp's immediate
        teardown: healthz flips to draining, in-flight jobs finish, and
        only then does the app exit (cleanup checkpoints the journal).
        No-op where loop signal handlers are unsupported."""
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, self._on_sigterm)
            self._sigterm_installed = True
        except (NotImplementedError, RuntimeError, ValueError):
            self._sigterm_installed = False

    def _remove_signal_handlers(self) -> None:
        if getattr(self, "_sigterm_installed", False):
            try:
                asyncio.get_running_loop().remove_signal_handler(
                    signal.SIGTERM
                )
            except (NotImplementedError, RuntimeError, ValueError):
                pass
            self._sigterm_installed = False

    def _on_sigterm(self) -> None:
        log.info("SIGTERM: draining before shutdown")
        # keep a strong reference: the loop holds tasks weakly, and a
        # GC during a multi-minute drain would silently abort it —
        # leaving a 503 replica that never exits
        self._drain_task = asyncio.ensure_future(self._drain_then_exit())

    async def _drain_then_exit(self) -> None:
        await self.drain()
        # mirror aiohttp's own signal path: GracefulExit is a SystemExit
        # subclass, so raising it from a call_soon callback escapes
        # run_forever and run_app proceeds to cleanup
        loop = asyncio.get_running_loop()
        loop.call_soon(self._raise_graceful_exit)

    @staticmethod
    def _raise_graceful_exit() -> None:
        raise web.GracefulExit()

    def app(self) -> web.Application:
        app = web.Application(client_max_size=MAX_BODY)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        app.router.add_post("/save_circuit", self.save_circuit)
        app.router.add_post(
            "/create_proof_without_mpc", self.create_proof_without_mpc
        )
        app.router.add_post(
            "/create_proof_with_naive_mpc", self.create_proof_with_naive_mpc
        )
        app.router.add_post("/verify_proof", self.verify_proof)
        app.router.add_get(
            "/get_circuit_files/{circuit_id}", self.get_circuit_files
        )
        app.router.add_post("/jobs/prove", self.jobs_prove)
        app.router.add_post("/jobs/verify", self.jobs_verify)
        app.router.add_post("/jobs/aggregate", self.jobs_aggregate)
        app.router.add_get("/jobs/{job_id}", self.job_status)
        app.router.add_get("/jobs/{job_id}/trace", self.job_trace)
        app.router.add_get("/jobs/{job_id}/result", self.job_result)
        app.router.add_delete("/jobs/{job_id}", self.job_cancel)
        app.router.add_get("/healthz", self.healthz)
        app.router.add_get("/readyz", self.readyz)
        app.router.add_post("/drain", self.drain_route)
        app.router.add_get("/stats", self.stats)
        app.router.add_get("/slo", self.slo_status)
        app.router.add_get("/metrics", self.metrics)
        app.router.add_get("/logs", self.logs)
        app.router.add_post("/profile", self.profile_start)
        app.router.add_get("/profile", self.profile_status)
        app.router.add_get("/profile/{capture_id}", self.profile_artifact)
        return app


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m distributed_groth16_tpu_torch.api.server"
    )
    p.add_argument("--device", default=None,
                   help="where jobs prove: a torch device such as cpu or "
                        "cuda:1 (default: the card)")
    args = p.parse_args(argv)
    telemetry_logbus.setup()  # console handler + ring for a real server
    port = int(os.environ.get("PORT", "8000"))
    web.run_app(ApiServer(device=args.device).app(), port=port)


if __name__ == "__main__":
    main()
