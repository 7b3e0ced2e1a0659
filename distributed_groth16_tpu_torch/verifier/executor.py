"""Executors for job kinds "verify" and "aggregate".

`VerifyExecutor.run_job` is the per-job body, called from
`service.worker.ProofExecutor._run`'s kind dispatch so verify jobs ride
the exact tracing/cancellation/journal envelope proving jobs do.
`VerifyBatchRunner.run_batch` is the scheduler-side runner: a released
bucket of verify jobs folds ALL member proofs into one RLC multi-pairing
(scheduler/__init__.py dispatches on BucketKey.kind); per-job outcomes
stay exact — an invalid proof fails only the job that submitted it, via
the proof-level bisection in `batch.verify_each`.

Job contract: a verify job is DONE when every proof it carries checks
out; it FAILS with `InvalidProofError` (naming the bad indices) when any
does not — per-proof verdicts ride the error message, the batch is never
poisoned by a member (invalid proofs are job outcomes, not BatchFaults).
An aggregate job additionally folds its (all-valid) proofs into a
`build_bundle` attestation as its result.
"""

from __future__ import annotations

import json
import logging

from ..frontend.ark_serde import proof_from_bytes
from ..models.groth16.keys import Proof
from ..utils.timers import phase
from .batch import (
    PreparedVerifyingKey,
    PvkCache,
    build_bundle,
    verify_batch,
    verify_each,
)

log = logging.getLogger(__name__)


class InvalidProofError(ValueError):
    """One or more proofs in a verify/aggregate job failed the exact
    Groth16 check. Carries the failing indices; the sanitized error DTO
    (service/jobs.py error_dto) surfaces them, and the legacy
    /verify_proof wrapper maps this to isValid: false rather than an
    error."""

    def __init__(self, indices: list[int], total: int):
        self.indices = list(indices)
        self.total = total
        idx = ", ".join(str(i) for i in self.indices)
        super().__init__(
            f"invalid proof at index {idx} of {total}"
        )


def parse_items(fields: dict) -> list[tuple[Proof, list[int]]]:
    """Parse a verify/aggregate job payload: `proofs_file` is JSON
    `[{"proof": <128-byte list | hex str>, "publicInputs": ["7", ...]},
    ...]` (a bare object is accepted as a batch of one). Raises ValueError
    naming the offending entry — the API maps it to a typed 400."""
    raw = fields.get("proofs_file")
    if raw is None:
        raise ValueError(
            "need proofs_file: JSON [{proof, publicInputs}, ...]"
        )
    try:
        doc = json.loads(raw.decode())
    except Exception as e:
        raise ValueError(f"proofs_file is not valid JSON: {e}") from e
    if isinstance(doc, dict):
        doc = [doc]
    if not isinstance(doc, list) or not doc:
        raise ValueError("proofs_file must be a non-empty JSON list")
    items = []
    for i, entry in enumerate(doc):
        try:
            if not isinstance(entry, dict):
                raise ValueError("entry must be an object")
            pr = entry["proof"]
            pb = bytes.fromhex(pr) if isinstance(pr, str) else bytes(pr)
            if len(pb) != 128:
                raise ValueError(f"proof must be 128 bytes, got {len(pb)}")
            proof = proof_from_bytes(pb)
            publics = [int(x) for x in entry.get("publicInputs", [])]
        except InvalidProofError:
            raise
        except Exception as e:
            raise ValueError(f"proofs[{i}]: {e}") from e
        items.append((proof, publics))
    return items


class VerifyExecutor:
    """Loads circuits' verifying keys (through the PreparedVerifyingKey
    cache) and runs verify/aggregate job bodies — always on a worker
    thread, like every executor."""

    def __init__(self, store, pvk_cache: PvkCache | None = None, device=None):
        self.store = store
        self.pvk_cache = pvk_cache if pvk_cache is not None else PvkCache()
        # where the prepared keys (the gamma_abc stack the fold's MSM
        # reads) live (None: the card)
        self.device = device

    def load_pvk(self, circuit_id: str) -> PreparedVerifyingKey:
        def _prepare():
            _, pk = self.store.load(circuit_id)
            return PreparedVerifyingKey.prepare(
                circuit_id, pk.vk, device=self.device
            )

        return self.pvk_cache.get_or_prepare(circuit_id, _prepare)

    # -- per-job path (worker funnel / scheduler-less service) ---------------

    def run_job(self, job) -> dict:
        """Body of one verify/aggregate job (ProofExecutor._run dispatch).
        Parses the payload, folds, bisects on failure, and either returns
        the result DTO or raises InvalidProofError."""
        timings = job.timings
        job.note_phase("load")
        with phase("load", timings):
            items = parse_items(job.fields)
            pvk = self.load_pvk(job.circuit_id)
        job.check_cancel()
        proofs = [p for p, _ in items]
        publics = [x for _, x in items]
        job.note_phase("verify")
        with phase("verify", timings):
            verdicts = verify_each(pvk, proofs, publics)
        job.check_cancel()
        bad = [i for i, ok in enumerate(verdicts) if not ok]
        if bad:
            raise InvalidProofError(bad, len(verdicts))
        result = {
            "circuitId": job.circuit_id,
            "count": len(proofs),
            "verdicts": verdicts,
            "pairingsSaved": max(0, 3 * len(proofs) - 3),
        }
        if job.kind == "aggregate":
            job.note_phase("aggregate")
            with phase("aggregate", timings):
                result["bundle"] = build_bundle(pvk, proofs, publics)
        job.note_phase(None)
        result["phases"] = timings.as_millis()
        return result


class VerifyBatchRunner:
    """Scheduler-side runner for a released bucket of verify jobs: the
    cross-JOB fold. All member jobs' proofs join one RLC multi-pairing —
    a bucket of B jobs carrying N proofs total costs N+3 Miller loops on
    the happy path — and a failing fold drops to `verify_each`, whose
    per-proof bisection assigns each job its own exact outcome. Only
    infrastructure faults (store load, payload decode of the whole
    bucket's shared circuit) raise out of `run_batch`; those are what
    the scheduler's BatchFault bisection ladder is for."""

    def __init__(self, executor: VerifyExecutor):
        self.executor = executor

    def run_batch(self, jobs, key, mesh=None) -> list:
        """[(job, result_dict | exception)] — same outcome contract as
        scheduler.batch_prover.BatchProver.run_batch. `mesh` is accepted
        for signature parity and ignored: verification is host + device
        MSM work, it leases no prover mesh."""
        pvk = self.executor.load_pvk(key.circuit_id)
        outcomes: list = [None] * len(jobs)
        parsed: list = []  # (job_index, proofs, publics)
        for ji, job in enumerate(jobs):
            try:
                items = parse_items(job.fields)
            except Exception as e:  # noqa: BLE001 — per-job outcome
                outcomes[ji] = (job, e)
                continue
            parsed.append(
                (ji, [p for p, _ in items], [x for _, x in items])
            )
        if parsed:
            all_proofs = [p for _, ps, _ in parsed for p in ps]
            all_publics = [x for _, _, xs in parsed for x in xs]
            if verify_batch(pvk, all_proofs, all_publics):
                verdicts = [True] * len(all_proofs)
            else:
                verdicts = verify_each(pvk, all_proofs, all_publics)
            off = 0
            for ji, ps, _ in parsed:
                job = jobs[ji]
                vs = verdicts[off : off + len(ps)]
                off += len(ps)
                bad = [i for i, ok in enumerate(vs) if not ok]
                if bad:
                    outcomes[ji] = (job, InvalidProofError(bad, len(vs)))
                else:
                    outcomes[ji] = (
                        job,
                        {
                            "circuitId": job.circuit_id,
                            "count": len(ps),
                            "verdicts": vs,
                            "pairingsSaved": max(0, 3 * len(ps) - 3),
                            "batchJobs": len(jobs),
                        },
                    )
        return outcomes
