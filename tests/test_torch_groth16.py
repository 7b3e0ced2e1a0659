"""The port's single-node Groth16 (models/groth16 of
distributed_groth16_tpu_torch) against the JAX package at m = 16: a
JAX-saved key loads into the port unchanged, the port's setup makes the
same key from the same seed, the QAP vectors agree, and the port's proof
at r = s = 0 from the JAX-made key is the JAX proof, byte for byte."""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu.models.groth16 import setup as jax_setup
from distributed_groth16_tpu.models.groth16 import verify as jax_verify
from distributed_groth16_tpu.models.groth16.prove import prove_single as jax_prove
from distributed_groth16_tpu.models.groth16.qap import CompiledR1CS as JaxCompiled
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, R
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.ops import curve as tcurve
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops import ntt as tntt
from distributed_groth16_tpu_torch.ops.field import fr as tfr

torch.set_num_threads(1)

CPU = torch.device("cpu")
QUERIES = ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
           "h_query", "l_query")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    r1cs, z = mult_chain_circuit(7, 13).finish()  # nc=13, ni=2 -> m=16
    pk = jax_setup(r1cs, seed=42)
    path = str(tmp_path_factory.mktemp("key") / "pk.npz")
    pk.save(path)
    return dict(r1cs=r1cs, z=z, pk=pk, path=path,
                pubs=z[1 : r1cs.num_instance])


@pytest.fixture
def kernel_routes(monkeypatch):
    """Lower the routing thresholds so the tree MSM (kernels 1, 3) and the
    limb NTT (kernel 4) take this tiny circuit, as they take m >= 2^11."""
    monkeypatch.setattr(tmsm, "TREE_MSM_MIN_N", 1)
    monkeypatch.setattr(tntt, "LIMB_NTT_MIN_N", 1)


def _port_key(world):
    return port.ProvingKey.load(world["path"], device="cpu")


def test_jax_saved_key_loads_unchanged(world):
    pk = _port_key(world)
    with np.load(world["path"]) as d:
        for k in QUERIES:
            got = getattr(pk, k)
            assert got.dtype == torch.int32 and got.device == CPU
            np.testing.assert_array_equal(got.numpy(), d[k].astype(np.int64))
    assert vars(pk.vk) == vars(world["pk"].vk)
    assert (pk.domain_size, pk.num_instance) == (16, 2)


def test_port_setup_equals_jax_setup(world):
    pk = port.setup(world["r1cs"], seed=42, device="cpu")
    ref = world["pk"]
    for k in QUERIES:
        np.testing.assert_array_equal(
            getattr(pk, k).numpy(), np.asarray(getattr(ref, k)).astype(np.int64)
        )
    assert vars(pk.vk) == vars(ref.vk)
    # the dealer's query scalars (the scalar route of the CRS pack), as the
    # JAX package's setup keeps them
    for k in ("a", "b", "l", "h"):
        np.testing.assert_array_equal(
            getattr(pk.query_scalars, k).numpy(),
            np.asarray(getattr(ref.query_scalars, k)).astype(np.int64),
        )


def test_qap_matches_jax(world):
    z = world["z"]
    got = port.CompiledR1CS(world["r1cs"], CPU).qap(tfr().encode(z, CPU))
    want = JaxCompiled(world["r1cs"]).qap(jfr().encode(z))
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(want, k))
        )


def test_proof_at_r_s_zero_is_the_jax_proof(world, kernel_routes):
    z = world["z"]
    got = port.prove_single(
        _port_key(world), port.CompiledR1CS(world["r1cs"], CPU),
        tfr().encode(z, CPU),
    )
    want = jax_prove(world["pk"], JaxCompiled(world["r1cs"]), jfr().encode(z))
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert port.verify(world["pk"].vk, got, world["pubs"])


def test_randomized_proof_verifies_in_both_packages(world, kernel_routes):
    rng = np.random.default_rng(3)
    r, s = (int.from_bytes(rng.bytes(40), "little") % R for _ in range(2))
    timings = {}
    proof = port.prove_single(
        _port_key(world), port.CompiledR1CS(world["r1cs"], CPU),
        tfr().encode(world["z"], CPU), r=r, s=s, timings=timings,
    )
    assert port.verify(world["pk"].vk, proof, world["pubs"])
    assert jax_verify(world["pk"].vk, proof, world["pubs"])
    assert set(timings) == {"qap", "h_poly", "msm_a", "msm_b_g2", "msm_l",
                            "msm_h", "rest"}
    bad = port.Proof(a=proof.a, b=proof.b, c=rm.G1.add(proof.c, G1_GENERATOR))
    assert not port.verify(world["pk"].vk, bad, world["pubs"])


@pytest.mark.parametrize("route", ["ladder", "tree"])
def test_msm_routes_agree_with_host(route, monkeypatch):
    if route == "tree":
        monkeypatch.setattr(tmsm, "TREE_MSM_MIN_N", 1)
    C = tcurve.g1()
    rng = np.random.default_rng(4)
    pts = [rm.G1.scalar_mul(G1_GENERATOR, int(rng.integers(1, 2**40)))
           for _ in range(3)]
    scs = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(3)]
    got = tmsm.msm(C, C.encode(pts, CPU), tmsm.encode_scalars_std(scs, CPU))
    assert C.decode(got) == rm.G1.msm(pts, scs)
