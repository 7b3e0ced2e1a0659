"""Batched proving path: B shape-identical jobs through ONE mesh pass —
the counterpart of distributed_groth16_tpu/scheduler/batch_prover.py.

`prove_batch` is the pure API (the correctness tests and the card's smoke
run drive it directly): given one proving key + compiled circuit and B
Montgomery witness assignments, it stacks the witness-dependent tensors
along a batch axis after the party axis on the king's device, runs
`build_batch_mesh_prover` over one shared packed CRS placed on the mesh's
device shards, and demuxes B deterministic proofs — each byte-identical
to what the sequential path (`prove_single` / the single-job MPC round)
emits for the same witness.

`BatchProver` is the job-facing wrapper the scheduler drives: it reuses
the service's `ProofExecutor` for witness resolution and the packed-CRS
cache (one pack per (circuit, l), the service's single-flight LRU), pads
partial batches up to the next power of two so the prover cache holds at
most log2(DG16_BATCH_MAX) provers per bucket instead of one per batch
size, as the JAX package does for its jit cache, and returns per-job
outcomes — a bad witness fails ITS job, never its batchmates.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from ..models.groth16 import (
    CompiledR1CS,
    pack_from_witness,
    reassemble_proof,
)
from ..models.groth16.mesh_prover import build_batch_mesh_prover
from ..models.groth16.prove import PartyProofShare
from ..ops.field import fr
from ..service.jobs import JobCancelled
from ..parallel.pss import PackedSharingParams
from ..telemetry import devmem as _devmem
from ..telemetry import metrics as _tm
from ..telemetry import tracing as _tracing
from ..telemetry import transfer as _transfer

_REG = _tm.registry()
_BATCH_SECONDS = _REG.histogram(
    "scheduler_batch_seconds",
    "End-to-end wall seconds per batched mesh execution",
)
_AMORTIZED = _REG.histogram(
    "scheduler_batch_amortized_seconds",
    "Per-proof amortized seconds inside a batched mesh execution",
)
_BATCH_JOBS = _REG.counter(
    "scheduler_batch_jobs_total",
    "Jobs that completed through the batched proving path, by outcome",
    ("outcome",),
)


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class BatchFault(Exception):
    """A BATCH-WIDE execution failure (the mesh program itself died), as
    opposed to a per-job outcome (bad witness, cancel). The scheduler
    treats these specially: the batchmates are innocent until proven
    otherwise, so it bisects — retry halves, then solo — instead of
    failing everyone (docs/SCHEDULER.md "Poisoned batches")."""

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(f"batch execution failed: {cause}")


class ProverCache:
    """Small LRU of batch provers keyed by (circuit, l, m, padded batch
    size, the mesh's devices) — one per bucket shape, as the JAX package
    keeps its jitted programs. A port prover is a plain closure (its build
    only places the domain twiddles on the devices), so the cache is
    cheap; its hit and miss counts feed the scheduler's stats()."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._d: OrderedDict[tuple, object] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: tuple, factory):
        fn = self._d.get(key)
        if fn is not None:
            self._d.move_to_end(key)
            self.hits += 1
            return fn
        self.misses += 1
        fn = factory()
        self._d[key] = fn
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        return fn


def prover_cache_key(circuit_id, l: int, m: int, b_pad: int,
                     mesh) -> tuple:
    """A ProverCache key: the bucket's shape and every shard's device, so
    a one-shard and a k-shard prover on one card are two entries."""
    return (circuit_id, l, m, b_pad, tuple(str(d) for d in mesh.devices))


def shard_crs(mesh, crs_shares) -> tuple:
    """The n parties' PartyCRS list -> their s, u, v, w shares stacked
    over the parties and placed on the mesh's shards: four tuples of k
    blocks."""
    return tuple(
        mesh.shard(torch.stack([getattr(c, f) for c in crs_shares]))
        for f in ("s", "u", "v", "w")
    )


def prove_batch(
    pk,
    comp: CompiledR1CS,
    pp: PackedSharingParams,
    mesh,
    crs_shares,
    z_monts: list,
    prover=None,
):
    """B witnesses -> B deterministic proofs through one SPMD program.

    z_monts: list of (num_wires, 16) Montgomery assignments, all for the
    circuit `comp` compiles, on the mesh's (king's) device. crs_shares:
    the n-party packed CRS (one `pack_proving_key` result, shared across
    the batch), placed on the mesh's shards here.
    Pass `prover` (a `build_batch_mesh_prover` result) to reuse one; its
    batch size must match the padded B. A partial batch is padded to the
    next power of two with copies of job 0, whose proofs are dropped."""
    B = len(z_monts)
    if B == 0:
        return []
    ni = comp.num_inputs
    qabc_rows, a_rows, ax_rows = [], [], []
    for zm in z_monts:
        qs = comp.qap(zm).pss(pp)
        qabc_rows.append(
            [torch.stack([qs[i].a, qs[i].b, qs[i].c], dim=0)
             for i in range(pp.n)]
        )
        a_rows.append(pack_from_witness(pp, zm[1:]))
        ax_rows.append(pack_from_witness(pp, zm[ni:]))
    b_pad = _next_pow2(B)
    for _ in range(b_pad - B):  # pad with copies of job 0; outputs dropped
        qabc_rows.append(qabc_rows[0])
        a_rows.append(a_rows[0])
        ax_rows.append(ax_rows[0])
    # the batched witness-upload boundary: the per-job rows stack into
    # the (n, B, ...) device tensors the mesh prover consumes
    with _transfer.account("h2d") as t:
        qabc = torch.stack(
            [torch.stack([qabc_rows[j][i] for j in range(b_pad)], dim=0)
             for i in range(pp.n)],
            dim=0,
        )  # (n, B, 3, m/l, 16)
        a_sh = torch.stack(a_rows, dim=1)  # (n, B, c_a, 16)
        ax_sh = torch.stack(ax_rows, dim=1)
        t.add_tree((qabc, a_sh, ax_sh))
    if prover is None:
        prover = build_batch_mesh_prover(pp, pk.domain_size, mesh, b_pad)
    pa, pb, pc = prover(qabc, a_sh, ax_sh, *shard_crs(mesh, crs_shares))
    # the batched proof-readback boundary: reassembly pulls party 0's
    # clear cores host-side, one (a, b, c) triple per real job
    with _transfer.account("d2h") as t:
        proofs = [
            reassemble_proof(
                PartyProofShare(a=pa[0, j], b=pb[0, j], c=pc[0, j]), pk
            )
            for j in range(B)
        ]
        t.add_tree([(pa[0, j], pb[0, j], pc[0, j]) for j in range(B)])
    return proofs


class BatchProver:
    """Runs one released batch of ProofJobs to per-job outcomes — always
    on a worker thread (the scheduler calls via asyncio.to_thread)."""

    def __init__(self, executor, prover_cache_size: int = 8):
        self.executor = executor  # service.worker.ProofExecutor
        self.provers = ProverCache(prover_cache_size)

    def run_batch(self, jobs: list, key, mesh) -> list[tuple]:
        """Returns [(job, result dict | exception), ...] — one entry per
        job. Shared phases (load/packing/prove) are recorded into each
        job's timings AMORTIZED (duration / batch size) so aggregate
        phase sums stay comparable with the sequential path."""
        from ..frontend.ark_serde import proof_to_bytes
        from .bucketer import BucketKey  # noqa: F401  (type of `key`)

        t_start = time.monotonic()
        with _tracing.span(
            "scheduler.batch",
            attrs={"bucket": key.label, "size": len(jobs)},
        ):
            outcomes: list[tuple] = []
            t0 = time.monotonic()
            r1cs, pk = self.executor.store.load(key.circuit_id)
            comp = CompiledR1CS(r1cs, mesh.device)
            load_s = time.monotonic() - t0

            F = fr()
            good, z_monts = [], []
            for job in jobs:
                try:
                    job.check_cancel()
                    job.note_phase("witness")
                    t_w = time.monotonic()
                    z = self.executor.resolve_witness(job, r1cs)
                    job.timings.record("witness", time.monotonic() - t_w)
                    good.append(job)
                    z_monts.append(F.encode(z, device=mesh.device))
                except BaseException as e:  # noqa: BLE001 — per-job outcome
                    outcomes.append((job, e))
                    _BATCH_JOBS.labels(
                        outcome="cancelled"
                        if isinstance(e, JobCancelled)
                        else "failed"
                    ).inc()
            if good:
                pp = PackedSharingParams(key.l)
                t0 = time.monotonic()
                crs_shares = self.executor.packed_crs(good[0], pk, pp)
                pack_s = time.monotonic() - t0

                b_pad = _next_pow2(len(good))
                cache_key = prover_cache_key(
                    key.circuit_id, key.l, pk.domain_size, b_pad, mesh)
                t0 = time.monotonic()
                for job in good:
                    job.note_phase("batch_prove")
                # per-BATCH device-memory bracket: one mesh execution is
                # the allocation event; every batchmate gets the same
                # stamp (None-safe on the CPU)
                peak0 = _devmem.peak_bytes()
                try:
                    prover = self.provers.get_or_build(
                        cache_key,
                        lambda: build_batch_mesh_prover(
                            pp, pk.domain_size, mesh, b_pad
                        ),
                    )
                    proofs = prove_batch(
                        pk, comp, pp, mesh, crs_shares, z_monts,
                        prover=prover,
                    )
                except BaseException as e:  # noqa: BLE001 — batch-wide fault
                    # NOT counted as failed here: the scheduler bisects
                    # BatchFault outcomes, and the batchmates usually
                    # complete on retry — only the final verdict counts
                    fault = BatchFault(e)
                    for job in good:
                        outcomes.append((job, fault))
                    return outcomes
                prove_s = time.monotonic() - t0
                mem = _devmem.peak_delta(peak0, _devmem.peak_bytes())
                if mem is not None:
                    mem["batchSize"] = len(good)
                    for job in good:
                        job.note_device_memory(dict(mem))
                share = 1.0 / len(good)
                for job, proof in zip(good, proofs):
                    job.timings.record("load", load_s * share)
                    job.timings.record("packing", pack_s * share)
                    job.timings.record("batch_prove", prove_s * share)
                    outcomes.append(
                        (job, {
                            "circuitId": job.circuit_id,
                            "proof": list(proof_to_bytes(proof)),
                            "phases": job.timings.as_millis(),
                            "batchSize": len(good),
                        })
                    )
                    _BATCH_JOBS.labels(outcome="done").inc()
                wall = time.monotonic() - t_start
                _BATCH_SECONDS.observe(wall)
                _AMORTIZED.observe(wall / len(good))
            return outcomes
