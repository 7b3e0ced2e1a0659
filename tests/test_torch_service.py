"""The port's job service (distributed_groth16_tpu_torch/service, scheduler,
api/store, telemetry) on the CPU at m = 16: JobQueue + WorkerPool +
BatchScheduler(devices=[cpu]) prove jobs in batches, a bad witness fails
alone, the per-job funnel proves a circuit from a store directory the
JAX package wrote, and the placement, prover cache, device-memory,
transfer and log-spine pieces keep their JAX contracts. Proofs are held
against the JAX package's host oracle `prove_host` (tolerance zero).

One key and one CRS pack are made in a module fixture: the store's key
is setup(seed=42), as the store makes it, and its pack (the scalar route
of the same key) is put in the executor's CRS cache, as a warm service
holds it."""

import asyncio
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_groth16_tpu.api import store as j_store
from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as j_mult_chain,
)
from distributed_groth16_tpu.frontend.readers import write_r1cs as j_write_r1cs
from distributed_groth16_tpu.models.groth16.keys import (
    ProvingKey as JaxProvingKey,
)
from distributed_groth16_tpu.models.groth16.reference import (
    prove_host as j_prove_host,
)
from distributed_groth16_tpu_torch.api.store import SETUP_SEED, CircuitStore
from distributed_groth16_tpu_torch.frontend.ark_serde import proof_from_bytes
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.frontend.readers import (
    write_r1cs,
    write_wtns,
)
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.models.groth16.reference import (
    decode_pk_host,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.parallel.pss import PackedSharingParams
from distributed_groth16_tpu_torch.scheduler import BatchScheduler
from distributed_groth16_tpu_torch.scheduler.batch_prover import (
    ProverCache,
    _next_pow2,
)
from distributed_groth16_tpu_torch.scheduler.placement import DevicePool
from distributed_groth16_tpu_torch.service import (
    CrsCache,
    JobQueue,
    JobState,
    ProofExecutor,
    ProofJob,
    WorkerPool,
)
from distributed_groth16_tpu_torch.telemetry import devmem, logbus, transfer
from distributed_groth16_tpu_torch.utils.config import SchedulerConfig

torch.set_num_threads(1)

L = 2
CPU = torch.device("cpu")
LENGTH = 13  # constraints of the chain: m = 16 with its 2 instance rows
X0S = (3, 4, 5, 6)  # four distinct witnesses of one circuit
QUERIES = ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
           "h_query", "l_query")
# local MSMs: n = 8 > LADDER_MSM_MAX_N takes the tree MSM, as on the card
CARD_ROUTES = {"LADDER_MSM_MAX_N": 1}


@pytest.fixture(scope="module")
def svc(tmp_path_factory):
    r1cs, _ = mult_chain_circuit(X0S[0], LENGTH).finish()
    zs = [mult_chain_circuit(x0, LENGTH).finish()[1] for x0 in X0S]
    store = CircuitStore(str(tmp_path_factory.mktemp("store")), device=CPU)
    cid = store.save_circuit("chain", write_r1cs(r1cs), b"")
    dealer = port.setup(r1cs, seed=SETUP_SEED, device=CPU)
    cache = CrsCache(4)
    cache.get_or_pack(
        (cid, L), lambda: port.pack_proving_key(dealer, PackedSharingParams(L))
    )
    _, pk = store.load(cid)
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(dealer, q))
    j_r1cs, jz = j_mult_chain(X0S[0], LENGTH).finish()
    assert jz == zs[0]
    return dict(store=store, cid=cid, cache=cache, pk=pk, r1cs=r1cs,
                j_r1cs=j_r1cs, zs=zs, pk_host=decode_pk_host(pk),
                wtns=[write_wtns(z) for z in zs])


def _run(jobs, store, cache, batch_max):
    """Submit the jobs to a JobQueue drained by a WorkerPool (with a
    BatchScheduler on the CPU when batch_max > 1), wait (at most 10
    minutes) for every job, stop the pool; returns the scheduler (or
    None)."""
    async def main():
        q = JobQueue(bound=64, workers=2)
        ex = ProofExecutor(store, crs_cache=cache, device=CPU)
        sched = None
        if batch_max > 1:
            sched = BatchScheduler(
                ex, q, SchedulerConfig(batch_max=batch_max,
                                       batch_linger_ms=500.0),
                devices=[CPU],
            )
        pool = WorkerPool(q, ex, workers=2, scheduler=sched)
        await pool.start()
        try:
            for job in jobs:
                q.submit(job)
            await asyncio.wait_for(
                asyncio.gather(*(job.wait() for job in jobs)), 600.0
            )
        finally:
            await pool.stop()
        return sched

    with pytest.MonkeyPatch.context() as mp:
        for name, value in CARD_ROUTES.items():
            mp.setattr(tmsm, name, value)
        return asyncio.run(main())


def _prove_job(cid, wtns, kind="prove"):
    return ProofJob(kind=kind, circuit_id=cid, fields={"witness_file": wtns},
                    l=L)


def _assert_proof(job, pk, j_r1cs, z, pk_host):
    assert job.state is JobState.DONE, job.error
    proof = proof_from_bytes(bytes(job.result["proof"]))
    want = j_prove_host(pk, j_r1cs, z, pk_host)
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)


def test_four_jobs_prove_in_two_batched_executions(svc):
    jobs = [_prove_job(svc["cid"], w) for w in svc["wtns"]]
    sched = _run(jobs, svc["store"], svc["cache"], batch_max=2)
    for job, z in zip(jobs, svc["zs"]):
        _assert_proof(job, svc["pk"], svc["j_r1cs"], z, svc["pk_host"])
        assert job.result["batchSize"] == 2
        assert "batch_prove" in job.result["phases"]
        assert job.to_dict()["metrics"]["deviceMemory"] is None  # the CPU
    stats = sched.stats()
    assert stats["batchesDispatched"] <= 2 and stats["jobsBatched"] == 4
    assert stats["jobsPoisoned"] == 0
    assert stats["placement"]["devices"] == 1
    assert stats["proverCache"] == {"hits": 1, "misses": 1}


def test_a_bad_witness_fails_alone_in_its_batch(svc):
    bad = bytearray(svc["wtns"][1])
    bad[-1] ^= 1  # the last wire's value no longer satisfies the circuit
    good, poison = (_prove_job(svc["cid"], svc["wtns"][0]),
                    _prove_job(svc["cid"], bytes(bad)))
    sched = _run([good, poison], svc["store"], svc["cache"], batch_max=2)
    assert poison.state is JobState.FAILED
    assert poison.error["phase"] == "witness"
    assert "does not satisfy" in poison.error["message"]
    _assert_proof(good, svc["pk"], svc["j_r1cs"], svc["zs"][0],
                  svc["pk_host"])
    assert good.result["batchSize"] == 1
    assert sched.stats()["batchesDispatched"] == 1


def _jax_key(pk):
    """The JAX package's ProvingKey of the same points (the limb layout
    both packages share), so the JAX store writes it without a JAX
    setup."""
    arrays = {k: jnp.asarray(getattr(pk, k).numpy().astype(np.uint32))
              for k in QUERIES}
    return JaxProvingKey(vk=pk.vk, domain_size=pk.domain_size,
                         num_instance=pk.num_instance, **arrays)


def test_a_jax_written_store_proves_through_the_per_job_funnel(
    svc, tmp_path, monkeypatch
):
    """The JAX package's CircuitStore writes the circuit (its .r1cs
    writer, its key's .npz); the port's store loads that directory
    unchanged and, with batching off, its per-job executor proves a job
    from it."""
    monkeypatch.setattr(j_store, "setup",
                        lambda r1cs, seed: _jax_key(svc["pk"]))
    root = str(tmp_path / "jax_store")
    cid = j_store.CircuitStore(root).save_circuit(
        "chain", j_write_r1cs(svc["j_r1cs"]), b""
    )
    store = CircuitStore(root, device=CPU)
    r1cs, pk = store.load(cid)
    assert (r1cs.a, r1cs.b, r1cs.c) == (svc["r1cs"].a, svc["r1cs"].b,
                                        svc["r1cs"].c)
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(svc["pk"], q))
    job = _prove_job(cid, svc["wtns"][2])
    assert _run([job], store, CrsCache(1), batch_max=1) is None
    _assert_proof(job, pk, svc["j_r1cs"], svc["zs"][2], svc["pk_host"])
    assert "prove" in job.result["phases"]
    assert "batchSize" not in job.result


def test_device_pool_leases_one_card_per_mesh():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePool()
    pool = DevicePool([CPU], max_meshes=0)
    assert pool.capacity(8) == pool.capacity(64) == 1
    assert pool.capacity(0) == 0
    assert DevicePool([CPU, CPU], max_meshes=1).capacity(8) == 1

    async def leases():
        a = await pool.acquire(8)
        assert (a.devices, a.n_parties) == ([CPU], 8)
        assert (a.mesh.device, a.mesh.n) == (CPU, 8)
        waiter = asyncio.ensure_future(pool.acquire(8))
        await asyncio.sleep(0.05)
        assert not waiter.done()  # the one card is held
        a.release()
        b = await asyncio.wait_for(waiter, 5)
        assert b.mesh is a.mesh  # memoised per (card, n_parties)
        assert pool.stats()["busyDevices"] == 1
        b.release()
        await asyncio.sleep(0)
        assert pool.stats()["leasesInUse"] == 0

    asyncio.run(leases())


def test_prover_cache_lru_and_next_pow2():
    assert [_next_pow2(x) for x in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    cache = ProverCache(capacity=2)
    built = []

    def factory(k):
        return lambda: built.append(k) or k

    assert cache.get_or_build("a", factory("a")) == "a"
    assert cache.get_or_build("b", factory("b")) == "b"
    assert cache.get_or_build("a", factory("a")) == "a"  # hit, now newest
    cache.get_or_build("c", factory("c"))  # evicts b
    assert cache.get_or_build("b", factory("b")) == "b"
    assert built == ["a", "b", "c", "b"]
    assert (cache.hits, cache.misses) == (1, 4)


def test_devmem_and_transfer_are_none_safe_and_count_tensor_bytes():
    assert devmem.peak_bytes([CPU]) is None
    assert devmem.peak_delta(None, None) is None
    assert devmem.sample([CPU]) == {"cpu:0": None}
    assert devmem.device_label(torch.device("cuda", 1)) == "cuda:1"
    if not torch.cuda.is_available():
        assert devmem.peak_bytes() is None and devmem.snapshot() == {}
    t = torch.zeros((3, 16), dtype=torch.int32)
    tree = [(t, np.zeros(5, np.uint32)), {"x": t[:1], "n": 7}, None]
    assert transfer.tree_nbytes(tree) == 3 * 64 + 20 + 64
    with transfer.account("h2d") as acct:
        acct.add_tree([(t, None)])
    assert acct.nbytes == 192


def test_logbus_records_a_port_jobs_lines_under_the_port_logger(svc):
    """A failing job's executor line lands in the port's ring under the
    port's package logger (package-relative name), carrying the job id;
    the JAX package's logger gets nothing of it."""
    logbus.reset_for_tests()
    logbus.setup(console=False)
    jax_records = []
    jax_logger = logging.getLogger("distributed_groth16_tpu")

    class Grab(logging.Handler):
        def emit(self, record):
            jax_records.append(record)

    grab = Grab()
    jax_logger.addHandler(grab)
    try:
        job = _prove_job(svc["cid"], b"not a witness")
        ex = ProofExecutor(svc["store"], crs_cache=svc["cache"], device=CPU)
        with pytest.raises(Exception):
            ex.run(job)
        recs = logbus.ring().query(job=job.id, level="ERROR")
        assert [r["logger"] for r in recs] == ["service.worker"]
        assert f"job {job.id} failed" in recs[0]["msg"]
        assert logbus.PACKAGE_LOGGER == "distributed_groth16_tpu_torch"
        assert jax_records == []
    finally:
        jax_logger.removeHandler(grab)
        logbus.reset_for_tests()
