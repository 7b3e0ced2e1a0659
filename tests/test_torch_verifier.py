"""The port's verification plane (distributed_groth16_tpu_torch/verifier)
against the JAX package's on the CPU, at m = 8: the batched prepare_inputs
MSM, the RLC fold's scalars and pairing operands, verify_batch and
verify_each, aggregation bundles, the PreparedVerifyingKey cache and the
verify/aggregate job runners on stand-in store and job objects.

Proofs come from the host prover (models/groth16/reference.py, pure ints)
over one port key; two witnesses of one circuit give two publics below
2^16, so a fold's prepare_inputs ladder stops after 16 steps (the
full-width ladder: test_prepare_inputs_batched_equals_host_and_jax). The
JAX package's folds compile its batched ladder once per batch size, so
every JAX fold here folds two proofs."""

import json
import types

import numpy as np
import pytest
import torch

from distributed_groth16_tpu import verifier as jver
from distributed_groth16_tpu.utils.timers import PhaseTimings as JTimings
from distributed_groth16_tpu_torch import verifier as pver
from distributed_groth16_tpu_torch.frontend.ark_serde import proof_to_bytes
from distributed_groth16_tpu_torch.frontend.r1cs import ConstraintSystem
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.models.groth16.keys import Proof
from distributed_groth16_tpu_torch.models.groth16.reference import (
    decode_pk_host,
    prove_host,
)
from distributed_groth16_tpu_torch.models.groth16.verify import (
    prepare_inputs,
)
from distributed_groth16_tpu_torch.ops import refmath as rm
from distributed_groth16_tpu_torch.ops.constants import G1_GENERATOR
from distributed_groth16_tpu_torch.utils.timers import PhaseTimings

torch.set_num_threads(1)

CPU = torch.device("cpu")
LENGTH = 5  # squarings: m = 8 with the 2 instance rows
CID = "chain"


def _statement(x: int):
    """Public x, then LENGTH squarings of it as witness wires: the same
    circuit for every x."""
    cs = ConstraintSystem()
    w = cs.new_instance(x)
    for _ in range(LENGTH):
        w = cs.mul(w, w)
    return cs.finish()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(9)
    x0s = [int(x) for x in rng.choice(2**16 - 2, size=2, replace=False) + 2]
    circuits = [_statement(x) for x in x0s]
    r1cs = circuits[0][0]
    assert all(vars(c[0]) == vars(r1cs) for c in circuits)
    pk = port.setup(r1cs, seed=int(rng.integers(1, 2**31)), device=CPU)
    host = decode_pk_host(pk)
    proofs = [prove_host(pk, r1cs, z, host) for _, z in circuits]
    publics = [[int(x) for x in z[1 : r1cs.num_instance]]
               for _, z in circuits]
    assert publics[0] != publics[1]
    p = proofs[0]
    bad = Proof(a=p.a, b=p.b, c=rm.G1.add(p.c, G1_GENERATOR))
    return dict(
        pk=pk, proofs=proofs, publics=publics, bad=bad, rng=rng,
        pvk=pver.PreparedVerifyingKey.prepare(CID, pk.vk, device=CPU),
        jpvk=jver.PreparedVerifyingKey.prepare(CID, pk.vk),
    )


def test_prepare_inputs_batched_equals_host_and_jax(world):
    pubs = [world["publics"][0], [int(world["rng"].integers(1, 2**62))
                                  * 2**190 + 7]]  # a full-width ladder
    got = pver.prepare_inputs_batched(world["pvk"], pubs)
    vk = world["pk"].vk
    host = [rm.G1.msm(vk.gamma_abc_g1, [1] + pub) for pub in pubs]
    assert got == host == [prepare_inputs(vk, pub) for pub in pubs]
    assert got == jver.prepare_inputs_batched(world["jpvk"], pubs)
    assert world["pvk"].gamma_abc_dev.device == CPU
    for mod, pvk in ((pver, world["pvk"]), (jver, world["jpvk"])):
        with pytest.raises(ValueError, match="2 public inputs for 1"):
            mod.prepare_inputs_batched(pvk, [pubs[0] + [1]])


def test_fold_scalars_and_folded_pairs_equal_jax(world):
    from distributed_groth16_tpu.verifier import batch as jbatch
    from distributed_groth16_tpu_torch.ops.pairing import pairing_check
    from distributed_groth16_tpu_torch.verifier import batch as pbatch

    seed = world["rng"].bytes(32)
    rs = pbatch.fold_scalars(seed, 5)
    assert rs == jbatch.fold_scalars(seed, 5)
    assert all(0 < r < 2**128 for r in rs) and len(set(rs)) == 5
    vk, proofs = world["pk"].vk, world["proofs"]
    l_pubs = [prepare_inputs(vk, pub) for pub in world["publics"]]
    pairs = pbatch.folded_pairs(vk, proofs, l_pubs, rs[:2])
    assert pairs == jbatch.folded_pairs(vk, proofs, l_pubs, rs[:2])
    assert len(pairs) == 2 + 3
    assert pairing_check(pairs)


def test_verify_batch_true_and_false(world):
    pvk, proofs, pubs = world["pvk"], world["proofs"], world["publics"]
    assert pver.verify_batch(pvk, proofs, pubs) is True
    assert pver.verify_batch(pvk, [proofs[0], world["bad"]], pubs) is False
    # one proof is the exact check, none passes, a ragged batch raises
    assert pver.verify_batch(pvk, [world["bad"]], pubs[:1]) is False
    assert pver.verify_batch(pvk, [], []) is True
    with pytest.raises(ValueError, match="one public-input vector"):
        pver.verify_batch(pvk, proofs, pubs[:1])


def test_verify_each_names_the_jax_indices(world):
    proofs = [world["bad"], world["proofs"][1]]
    pubs = world["publics"]
    got = pver.verify_each(world["pvk"], proofs, pubs)
    assert got == jver.verify_each(world["jpvk"], proofs, pubs)
    assert got == [False, True]


def test_bundles_are_byte_equal_to_jax(world):
    seed = world["rng"].bytes(32)
    proofs, pubs = world["proofs"], world["publics"]
    bundle = pver.build_bundle(world["pvk"], proofs, pubs, seed=seed)
    assert json.dumps(bundle) == json.dumps(
        jver.build_bundle(world["jpvk"], proofs, pubs, seed=seed))
    assert bundle["count"] == 2 and len(bundle["pairs"]) == 2 + 3
    assert bundle["rSeed"] == seed.hex()
    assert pver.check_bundle(bundle) is True
    tampered = json.loads(json.dumps(bundle))
    pairs = tampered["pairs"]
    pairs[0][1], pairs[1][1] = pairs[1][1], pairs[0][1]
    assert pver.check_bundle(tampered) is False
    with pytest.raises(ValueError, match="empty proof list"):
        pver.build_bundle(world["pvk"], [], [])


def test_pvk_cache_stats_equal_jax(world):
    stats = []
    for mod, pvk in ((pver, world["pvk"]), (jver, world["jpvk"])):
        cache = mod.PvkCache(capacity=1)
        calls = []

        def factory(pvk=pvk, calls=calls):
            calls.append(1)
            return pvk

        for cid in (CID, CID, "other", CID):
            assert cache.get_or_prepare(cid, factory) is pvk
        assert len(calls) == 3 and len(cache) == 1
        off = mod.PvkCache(capacity=0)
        off.get_or_prepare(CID, factory)
        stats.append((cache.stats(), off.stats()))
    assert stats[0] == stats[1]
    assert stats[0][0] == {"entries": 1, "capacity": 1, "hits": 1,
                           "misses": 3, "evictions": 2, "hitRate": 0.25}


# -- the job runners on stand-in store and job objects ----------------------


class _Job:
    """The surface of service.jobs.ProofJob that the runners read."""

    def __init__(self, kind, items, timings):
        self.kind = kind
        self.circuit_id = CID
        self.timings = timings
        self.fields = {"proofs_file": json.dumps([
            {"proof": proof_to_bytes(p).hex(),
             "publicInputs": [str(x) for x in pub]} for p, pub in items
        ]).encode()}
        self.phases = []

    def note_phase(self, name):
        self.phases.append(name)

    def check_cancel(self):
        pass


def _executors(world):
    """The port's and the JAX package's VerifyExecutor over one stand-in
    store; the port's prepares its key on the CPU."""
    store = types.SimpleNamespace(load=lambda cid: (None, world["pk"]))
    return (pver.VerifyExecutor(store, device=CPU),
            jver.VerifyExecutor(store))


def _outcome(out):
    if isinstance(out, Exception):
        return type(out).__name__, str(out)
    out = dict(out)
    out.pop("phases", None)
    return out


def test_verify_executor_run_job_outcomes_equal_jax(world):
    pex, jex = _executors(world)
    good = [(world["proofs"][0], world["publics"][0])]
    bad = [(world["bad"], world["publics"][0])]
    for kind, items in (("verify", good), ("verify", bad)):
        outcomes = []
        for ex, timings in ((pex, PhaseTimings()), (jex, JTimings())):
            job = _Job(kind, items, timings)
            try:
                outcomes.append(_outcome(ex.run_job(job)))
            except ValueError as e:
                outcomes.append(_outcome(e))
            assert job.phases == ["load", "verify"] + (
                [None] if items is good else [])
        assert outcomes[0] == outcomes[1]
    assert outcomes[0] == ("InvalidProofError",
                           "invalid proof at index 0 of 1")
    agg = pex.run_job(_Job("aggregate", good, PhaseTimings()))
    assert agg["verdicts"] == [True] and agg["pairingsSaved"] == 0
    assert agg["bundle"]["count"] == 1
    assert set(agg["phases"]) == {"load", "verify", "aggregate"}
    assert pver.check_bundle(agg["bundle"]) is True


def test_verify_batch_runner_outcomes_equal_jax(world):
    pex, jex = _executors(world)
    items = [[(world["proofs"][1], world["publics"][1])],
             [(world["bad"], world["publics"][0])]]
    key = types.SimpleNamespace(circuit_id=CID)
    outcomes = []
    for ex, mod, timings in ((pex, pver, PhaseTimings), (jex, jver,
                                                         JTimings)):
        jobs = [_Job("verify", it, timings()) for it in items]
        malformed = _Job("verify", [], timings())
        malformed.fields = {"proofs_file": b"[]"}
        jobs.append(malformed)
        out = mod.VerifyBatchRunner(ex).run_batch(jobs, key)
        assert [j for j, _ in out] == jobs
        outcomes.append([_outcome(o) for _, o in out])
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0]["verdicts"] == [True]
    assert outcomes[0][0]["batchJobs"] == 3
    assert outcomes[0][1] == ("InvalidProofError",
                              "invalid proof at index 0 of 1")
    assert outcomes[0][2] == ("ValueError",
                              "proofs_file must be a non-empty JSON list")
