"""Bounded worker pool + the proof executor it drives — the counterpart of
distributed_groth16_tpu/service/worker.py, whose host part this module
copies; the executor takes a `device` (None: the card) for the witness
tensor and the compiled circuit.

The pool is DG16_SERVICE_WORKERS asyncio tasks pulling from the JobQueue;
each job's body runs in a thread (`asyncio.to_thread`) because proving is
synchronous device work and the in-process MPC round owns its own event
loop (`simulate_network_round` calls `asyncio.run`). At most `workers`
proofs execute concurrently — the admission bound on the queue plus this
pool is the whole backpressure story.

`ProofExecutor` is the single proving path of the service: witness
generation, CRS packing (through the packed-CRS cache), and the MPC round
via `run_round_with_retries` so a transient transport fault costs
one round, not the job. Cooperative cancellation points sit between
phases (`job.check_cancel()`).
"""

from __future__ import annotations

import asyncio
import logging

from ..frontend.ark_serde import proof_to_bytes
from ..frontend.readers import read_wtns
from ..models.groth16 import (
    CompiledR1CS,
    distributed_prove_party,
    pack_from_witness,
    pack_proving_key,
    reassemble_proof,
)
from ..models.groth16.prove import prove_single
from ..ops.field import fr
from ..parallel.net import job_context, run_round_with_retries
from ..parallel.pss import PackedSharingParams
from ..telemetry import aggregate, devmem, logbus, tracing, transfer
from ..utils.config import ServiceConfig
from ..utils.timers import phase
from ..verifier.executor import VerifyExecutor
from .crs_cache import CrsCache
from .jobs import JobCancelled, JobState, ProofJob
from .queue import JobQueue

log = logging.getLogger(__name__)


class ProofExecutor:
    """Runs one ProofJob to a result dict — always on a worker thread."""

    def __init__(
        self,
        store,
        crs_cache: CrsCache | None = None,
        cfg: ServiceConfig | None = None,
        device=None,
    ):
        self.store = store
        self.cfg = cfg or ServiceConfig()
        # where the witness and the compiled circuit live (None: the
        # card); the store's keys must live there too
        self.device = device
        # explicit None check: an EMPTY CrsCache is falsy (it has __len__),
        # so `crs_cache or ...` would silently split the server's cache
        # from the executor's
        self.crs_cache = (
            crs_cache
            if crs_cache is not None
            else CrsCache(self.cfg.crs_cache_size)
        )
        # the verification plane's executor (verifier/executor.py): owns
        # the PreparedVerifyingKey cache the same way this executor owns
        # the packed-CRS cache, sized by the same knob
        self.verifier = VerifyExecutor(store, device=device)
        self.verifier.pvk_cache.capacity = self.cfg.crs_cache_size

    # -- witness -------------------------------------------------------------

    def resolve_witness(self, job: ProofJob, r1cs) -> list[int]:
        """Resolve + validate a job's witness assignment. Public because
        the batching scheduler's BatchProver resolves each batched job's
        witness through the same path (scheduler/batch_prover.py)."""
        fields = job.fields
        if "witness_file" in fields:
            z = read_wtns(fields["witness_file"])
        elif "input_file" in fields:
            # the reference's primary prove flow (mpc-api/src/main.rs:
            # 282-421): JSON inputs -> circom WASM witness generation on
            # the pure-Python interpreter (frontend/wasm_vm.py)
            import json

            from ..frontend.witness_calculator import WitnessCalculator

            _, wasm = self.store.get_files(job.circuit_id)
            if not wasm:
                raise ValueError(
                    "circuit was saved without a witness_generator wasm; "
                    "upload a .wtns in the witness_file field instead"
                )
            inputs = json.loads(fields["input_file"].decode())
            wc = WitnessCalculator(wasm)
            z = wc.calculate_witness(inputs)
        else:
            raise ValueError("need witness_file or input_file")
        if len(z) != r1cs.num_wires or not r1cs.is_satisfied(z):
            raise ValueError("witness does not satisfy the circuit")
        return z

    # -- CRS -----------------------------------------------------------------

    def packed_crs(self, job: ProofJob, pk, pp: PackedSharingParams):
        """All-party CRS shares through the LRU cache. The key is the
        circuit plus every parameter the shares depend on (l determines
        n/t and the chunking). A cache MISS is the packed-CRS
        host->device boundary: the factory accounts the share bytes it
        materialized on device (hits move nothing, and count nothing)."""

        def _pack():
            with transfer.account("h2d") as t:
                shares = pack_proving_key(pk, pp, strip=True)
                # PackedProvingKeyShare is a plain dataclass, not a
                # registered pytree — count its array fields explicitly
                t.add_tree([tuple(vars(sh).values()) for sh in shares])
            return shares

        key = (job.circuit_id, pp.l)
        return self.crs_cache.get_or_pack(key, _pack)

    # -- the proving path ----------------------------------------------------

    def run(self, job: ProofJob) -> dict:
        """Executor entry: every span below lands in the job's own trace
        buffer (GET /jobs/{id} metrics block — and DG16_TRACE_OUT, if
        set), and any transport failure inside the MPC round carries the
        job id (net.job_context -> MpcNetError.job_id)."""
        attrs = {"kind": job.kind, "circuit": job.circuit_id}
        if job.trace_id:
            # the cross-tier trace context (docs/OBSERVABILITY.md "Fleet
            # observatory"): every span nested under the job root joins
            # the router-minted trace via this attribute
            attrs["trace"] = job.trace_id
        # bracket the job with the device-memory peak so the DTO can say
        # how much IT raised the process HBM high-water mark (None on
        # the CPU — devmem is None-safe end to end)
        peak0 = devmem.peak_bytes()
        try:
            with tracing.collect(job.trace), job_context(job.id), tracing.span(
                "job", job=job.id, attrs=attrs,
            ), logbus.bind(tenant=job.tenant, priority=job.priority):
                try:
                    return self._run(job)
                except JobCancelled:
                    raise
                except Exception as e:  # noqa: BLE001 — logged, re-raised
                    # log the failure INSIDE the job's trace/log context:
                    # the record lands in the ring carrying this job's
                    # trace id, and its WARN+ instant event lands in the
                    # job's own Chrome trace at the fault instant
                    log.error("job %s failed: %s", job.id, e)
                    raise
        finally:
            job.note_device_memory(
                devmem.peak_delta(peak0, devmem.peak_bytes())
            )

    def _run(self, job: ProofJob) -> dict:
        if job.kind in ("verify", "aggregate"):
            # verification plane (docs/VERIFY.md): same tracing/cancel
            # envelope, entirely different body — no witness, no CRS,
            # no mesh
            return self.verifier.run_job(job)
        timings = job.timings
        job.note_phase("load")
        with phase("load", timings):
            r1cs, pk = self.store.load(job.circuit_id)
        job.check_cancel()
        job.note_phase("witness")
        with phase("witness", timings):
            z = self.resolve_witness(job, r1cs)
        job.check_cancel()
        F = fr()
        # the witness-upload boundary: F.encode materializes the (wires,
        # 16) Montgomery limb tensor on device from host bigints
        with transfer.account("h2d") as t:
            z_mont = F.encode(z, device=self.device)
            t.add_tree(z_mont)
        if job.kind == "prove":
            job.note_phase("prove")
            with phase("prove", timings):
                comp = CompiledR1CS(r1cs, self.device)
                proof = prove_single(pk, comp, z_mont)
        elif job.kind == "mpc_prove":
            pp = PackedSharingParams(job.l)
            job.note_phase("packing")
            with phase("packing", timings):
                comp = CompiledR1CS(r1cs, self.device)
                qap_shares = comp.qap(z_mont).pss(pp)
                crs_shares = self.packed_crs(job, pk, pp)
                ni = r1cs.num_instance
                a_sh = pack_from_witness(pp, z_mont[1:])
                ax_sh = pack_from_witness(pp, z_mont[ni:])
            job.check_cancel()

            async def party(net, d):
                return await distributed_prove_party(
                    pp, d[0], d[1], d[2], d[3], net
                )

            # round boundary for the aggregation plane: the load/witness/
            # packing spans above are harness (pid 0) work — drop them so
            # the round close at simulate_network_round's end decomposes
            # only the MPC round (million.py does the same; concurrent
            # jobs on one process buffer still interleave — the per-job
            # windowed decomposition in jobs.py is the exact one)
            if aggregate.enabled():
                aggregate.drain()

            job.note_phase("MPC Proof")
            with phase("MPC Proof", timings):
                res = run_round_with_retries(
                    pp.n,
                    party,
                    [
                        (crs_shares[i], qap_shares[i], a_sh[i], ax_sh[i])
                        for i in range(pp.n)
                    ],
                    retries=self.cfg.round_retries,
                )
            proof = reassemble_proof(res[0], pk)
        else:
            raise ValueError(f"unknown job kind {job.kind!r}")
        job.note_phase(None)
        job.check_cancel()
        # the proof-readback boundary: serializing pulls the proof's
        # device-resident curve points back to host
        with transfer.account("d2h") as t:
            proof_bytes = proof_to_bytes(proof)
            t.add(len(proof_bytes))
        return {
            "circuitId": job.circuit_id,
            "proof": list(proof_bytes),
            "phases": timings.as_millis(),
        }


class WorkerPool:
    """DG16_SERVICE_WORKERS asyncio tasks draining the JobQueue.

    With a batching scheduler attached (DG16_BATCH_MAX > 1 —
    scheduler/BatchScheduler, docs/SCHEDULER.md) the workers become
    FEEDERS for batch-eligible jobs: popped jobs are offered to the
    bucketer and the scheduler runs released batches end-to-end under
    mesh leases, so proving concurrency is bounded by mesh slices rather
    than worker count. Ineligible jobs (and every job when the scheduler
    is absent) take the per-job executor path below, unchanged."""

    def __init__(self, queue: JobQueue, executor: ProofExecutor,
                 workers: int = 2, scheduler=None):
        self.queue = queue
        self.executor = executor
        self.workers = max(1, workers)
        self.scheduler = scheduler
        self._tasks: list[asyncio.Task] = []

    async def start(self) -> None:
        if self.scheduler is not None:
            await self.scheduler.start()
        for i in range(self.workers):
            self._tasks.append(
                asyncio.create_task(self._worker(i), name=f"dg16-worker-{i}")
            )

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self.scheduler is not None:
            # flushes still-lingering bucketed jobs to a terminal state
            # and waits out in-flight batches (their proofs are results)
            await self.scheduler.stop()
        # jobs still QUEUED will never get a worker now — transition them
        # so sync waiters and status pollers see a terminal state instead
        # of QUEUED forever (and of stalling graceful shutdown).
        # fail_terminal journals the failure BEFORE the in-memory
        # transition so a crash mid-shutdown can't resurrect them.
        for job in self.queue.drain_pending():
            self.queue.fail_terminal(job, RuntimeError("service shutting down"))

    async def _worker(self, idx: int) -> None:
        while True:
            job = await self.queue.get()
            if job.state is not JobState.QUEUED:
                continue  # cancelled while queued — never runs
            if self.scheduler is not None and self.scheduler.eligible(job):
                # feed the bucketer; `offer` blocks when the scheduler is
                # saturated (backpressure: the queue refills and 429s
                # keep firing at the admission bound)
                await self.scheduler.offer(job)
                continue
            job.mark_running()
            self.queue.on_started(job)
            fut = asyncio.ensure_future(
                asyncio.to_thread(self.executor.run, job)
            )
            try:
                result = await asyncio.shield(fut)
            except asyncio.CancelledError:
                # pool shutdown. The proof thread can't be interrupted, so
                # ask for a phase-boundary stop, wait it out, and record
                # the real outcome — a proof that finished during shutdown
                # is a result, not a failure.
                job.request_cancel()
                try:
                    result = await fut
                except JobCancelled:
                    job.mark_cancelled()
                except Exception as e:  # noqa: BLE001
                    job.mark_failed(e)
                else:
                    job.mark_done(result)
                self.queue.on_finished(job)
                raise
            except JobCancelled:
                job.mark_cancelled()
            except Exception as e:  # noqa: BLE001 — job-level CustomError
                # the loop thread runs outside the job's trace context —
                # correlate explicitly via the structured-extras API
                log.warning(
                    "job %s failed: %s", job.id, e,
                    extra={"job": job.id, "trace": job.trace_id},
                )
                job.mark_failed(e)
            else:
                job.mark_done(result)
            self.queue.on_finished(job)
