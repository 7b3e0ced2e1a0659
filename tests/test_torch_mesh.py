"""The port's parties mesh (parallel/mesh.py), mesh prover
(models/groth16/mesh_prover.py) and batch prover
(scheduler/batch_prover.py) against the JAX package at m = 16, l = 2,
n = 8, on the CPU, tolerance zero.

None of the JAX mesh programs runs here (build_mesh_prover and
build_batch_mesh_prover compile for minutes on the CPU): the port's mesh
transforms are held against the JAX package's eager d_fft pieces run party
by party, its batched d_msm against refmath sums of the clear scalars, and
its proofs against the JAX package's host oracle `prove_host` and host
`verify`. The local MSMs take the tree route they take on the card
(CARD_ROUTES, as in tests/test_torch_mpc.py)."""

from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as j_mult_chain,
)
from distributed_groth16_tpu.models.groth16 import ext_wit as j_ext_wit
from distributed_groth16_tpu.models.groth16.reference import (
    prove_host as j_prove_host,
)
from distributed_groth16_tpu.models.groth16.verify import verify as j_verify
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.ntt import domain as j_domain
from distributed_groth16_tpu.parallel import dfft as j_dfft
from distributed_groth16_tpu.parallel.pss import (
    PackedSharingParams as JaxPSS,
)
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.models.groth16 import ext_wit
from distributed_groth16_tpu_torch.models.groth16 import mesh_prover as mp_
from distributed_groth16_tpu_torch.models.groth16.reference import (
    decode_pk_host,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.constants import G1_GENERATOR
from distributed_groth16_tpu_torch.ops.curve import g1
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.limb_kernels import lg1, msm_tree
from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std
from distributed_groth16_tpu_torch.ops.ntt import domain
from distributed_groth16_tpu_torch.parallel import mesh
from distributed_groth16_tpu_torch.parallel.pss import PackedSharingParams
from distributed_groth16_tpu_torch.scheduler.batch_prover import prove_batch

torch.set_num_threads(1)

L = 2
CPU = torch.device("cpu")
LENGTH = 13  # constraints of the chain: m = 16 with its 2 instance rows
X0S = (7, 9, 11)  # three distinct witnesses of one circuit
# local MSMs: n = 8 > LADDER_MSM_MAX_N takes the tree MSM, as on the card
CARD_ROUTES = {"LADDER_MSM_MAX_N": 1}


@pytest.fixture(scope="module")
def world():
    r1cs, _ = mult_chain_circuit(X0S[0], LENGTH).finish()
    zs = [mult_chain_circuit(x0, LENGTH).finish()[1] for x0 in X0S]
    j_r1cs, jz = j_mult_chain(X0S[0], LENGTH).finish()
    assert jz == zs[0]
    pk = port.setup(r1cs, seed=5, device=CPU)  # keeps its query scalars
    pp = PackedSharingParams(L)
    crs = port.pack_proving_key(pk, pp)  # the scalar route
    F = fr()
    return dict(
        r1cs=r1cs, j_r1cs=j_r1cs, zs=zs, pk=pk, pp=pp, crs=crs,
        comp=port.CompiledR1CS(r1cs, CPU),
        z_monts=[F.encode(z, CPU) for z in zs],
        pk_host=decode_pk_host(pk), ni=r1cs.num_instance,
        mesh=mesh.make_mesh(pp.n, CPU),
    )


@contextmanager
def _card_routes():
    with pytest.MonkeyPatch.context() as mpatch:
        for name, value in CARD_ROUTES.items():
            mpatch.setattr(tmsm, name, value)
        yield


@pytest.fixture(scope="module")
def batches(world):
    """prove_batch at B = 2 and at B = 3 (padded to 4 with copies of job
    0), each over the first B distinct witnesses."""
    w = world
    with _card_routes():
        return {
            B: prove_batch(w["pk"], w["comp"], w["pp"], w["mesh"], w["crs"],
                           w["z_monts"][:B])
            for B in (2, 3)
        }


def _limbs(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _shares(seed, shape):
    """Canonical random Fr elements (Montgomery limbs) of the given batch
    shape, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % fr().p
            for _ in range(n)]
    return torch.as_tensor(fr().encode_np(vals)).reshape(shape + (16,))


@pytest.mark.parametrize("case", ["inverse_rearrange_pad2",
                                  "forward_king_clear"])
def test_mesh_dfft_matches_jax_party_by_party(case):
    """_mesh_dfft runs stage 1 once over the stacked (n, B, 3, m/l)
    shares and the king's tail once; the JAX package runs _fft1_local per
    party and then _king_tail_array / _king_clear_array. Limb for limb."""
    m, n, B = 16, 2 * L * 2, 2
    inverse = case.startswith("inverse")
    size = m if inverse else 2 * m
    logm = size.bit_length() - 1
    pp, jpp = PackedSharingParams(L), JaxPSS(L)
    x = _shares(3 if inverse else 4, (n, B, 3, size // L))
    dom, jdom = domain(size), j_domain(size)
    wpows = dom._live_wpows(CPU)
    size_inv = torch.as_tensor(dom._size_inv) if inverse else None
    got = mesh._mesh_dfft(x, pp, logm, inverse, inverse, 2 if inverse else 1,
                          False, not inverse, wpows, size_inv)

    jw = jdom._live_wpows()
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    if inverse:
        from distributed_groth16_tpu.ops.field import fr as jfr

        jx = jfr().mul(jx, jnp.asarray(jdom._size_inv))
    local = jnp.stack([j_dfft._fft1_local(jx[i], jw, logm, 1, inverse)
                       for i in range(n)])
    if inverse:
        want = j_dfft._king_tail_array(local, jpp, logm, True, 2, False,
                                       True, jw)
        assert got.shape == (n, B, 3, 2 * size // L, 16)
    else:
        want = j_dfft._king_clear_array(local, jpp, logm, False, False, jw)
        assert got.shape == (B, 3, size, 16)
    np.testing.assert_array_equal(_limbs(got), _limbs(want))


def test_king_combine_h_matches_jax_row_by_row():
    """The king's combine over a (B, 2m) batch: each party's row of the
    port's (n, B, m/l) h shares equals the JAX package's, job by job."""
    m, B = 16, 3
    p, q, w = (_shares(s, (B, 2 * m)) for s in (5, 6, 7))
    pp, jpp = PackedSharingParams(L), JaxPSS(L)
    got = ext_wit.king_combine_h(p, q, w, pp)
    assert got.shape == (pp.n, B, m // L, 16)
    for b in range(B):
        want = j_ext_wit.king_combine_h(
            *(jnp.asarray(t[b].numpy().astype(np.uint32)) for t in (p, q, w)),
            jpp,
        )
        for i in range(pp.n):
            np.testing.assert_array_equal(_limbs(got[i, b]),
                                          _limbs(want[i]))


def test_mesh_dmsm_batched_matches_refmath(world):
    """Two jobs' A-query d_msms over ONE shared CRS table (a broadcast set
    of bases, read in place by both entries): each equals the refmath MSM
    of the clear witness over the clear query points."""
    w = world
    pp, zs = w["pp"], w["zs"]
    a_sh = torch.stack([port.pack_from_witness(pp, zm[1:])
                        for zm in w["z_monts"][:2]], dim=1)  # (n, 2, c, 16)
    s_q = torch.stack([c.s for c in w["crs"]])[:, None]  # (n, 1, c)+pt
    with _card_routes():
        got = mesh._mesh_dmsm_batched(g1(), s_q, a_sh, pp)
    assert got.shape == (2, 3, 16)
    assert g1().decode(got) == [
        rm.G1.msm(w["pk_host"]["a_query"][1:], z[1:]) for z in zs[:2]
    ]


@pytest.mark.parametrize("B", [2, 3])
def test_batch_prover_proofs_equal_the_jax_host_oracle(world, batches, B):
    """Batch row j is job j: each demuxed proof equals the JAX package's
    prove_host of its own (distinct) witness and passes the JAX verify;
    B = 3 runs padded to 4, the pad's proof dropped."""
    w = world
    proofs = batches[B]
    assert len(proofs) == B
    for z, proof in zip(w["zs"], proofs):
        want = j_prove_host(w["pk"], w["j_r1cs"], z, w["pk_host"])
        assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
        assert j_verify(w["pk"].vk, proof, z[1 : w["ni"]])
    assert len({(p.a, p.b, p.c) for p in proofs}) == B


def test_mesh_prove_zk_equals_prove_single(world, batches):
    """mesh_prove_zk's r/s completion of the mesh cores equals
    prove_single(r, s) on the same witness; the r = s = 0 proof of that
    witness does not."""
    w = world
    pp, crs, zm = w["pp"], w["crs"], w["z_monts"][0]
    rng = np.random.default_rng(9)
    r, s = (int.from_bytes(rng.bytes(32), "little") % fr().p
            for _ in range(2))
    qs = w["comp"].qap(zm).pss(pp)
    inp = mp_.MeshProverInputs(
        qap_a=torch.stack([q.a for q in qs]),
        qap_b=torch.stack([q.b for q in qs]),
        qap_c=torch.stack([q.c for q in qs]),
        a_share=port.pack_from_witness(pp, zm[1:]),
        ax_share=port.pack_from_witness(pp, zm[w["ni"]:]),
        s=torch.stack([c.s for c in crs]), u=torch.stack([c.u for c in crs]),
        v=torch.stack([c.v for c in crs]), w=torch.stack([c.w for c in crs]),
        h=torch.stack([c.h for c in crs]),
    )
    with _card_routes():
        got = mp_.mesh_prove_zk(pp, w["pk"].domain_size, w["mesh"], inp,
                                w["pk"], r, s)
        want = port.prove_single(w["pk"], w["comp"], zm, r=r, s=s)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert j_verify(w["pk"].vk, got, w["zs"][0][1 : w["ni"]])
    det = batches[2][0]
    assert (got.a, got.b, got.c) != (det.a, det.b, det.c)


def test_infinity_padding_keeps_the_tree_msm_exact():
    """The G1 bases of the batched d_msm are padded to a common length
    with the infinity encoding (0, 1, 0): the tree MSM over the padded
    set equals the unpadded sum. An all-zero row absorbs under the
    complete add, so zero padding gives another point."""
    aff = [rm.G1.scalar_mul(G1_GENERATOR, k) for k in (3, 5, 7)]
    pts = g1().encode(aff, CPU)
    want = rm.G1.msm(aff, [11, 13, 17])
    sc = mp_._pad_scalars(encode_scalars_std([11, 13, 17], CPU), 5)
    padded = mp_._pad_bases(pts[None], 5)[0]
    assert torch.equal(padded[3], g1().infinity((), CPU))
    assert g1().decode(msm_tree(padded, sc, group=lg1())) == want
    zeros = torch.cat([pts, torch.zeros_like(pts[:2])])
    assert g1().decode(msm_tree(zeros, sc, group=lg1())) != want


def test_mesh_objects_hold_all_parties_on_one_device():
    """make_mesh holds all n parties in one shard; make_mesh_from_devices
    takes one party an entry, as the JAX package's, so [CPU] * 4 is four
    shards of one party on one device and two devices are two shards."""
    assert mesh.make_mesh(8, CPU) == mesh.PartyMesh((CPU,), 8)
    assert mesh.make_mesh(8, CPU).k == 1
    assert mesh.make_mesh_from_devices([CPU] * 4) == mesh.PartyMesh(
        (CPU,) * 4, 4)
    with pytest.raises(RuntimeError, match="empty"):
        mesh.make_mesh_from_devices([])
    two = mesh.make_mesh_from_devices([CPU, torch.device("meta")])
    assert (two.devices, two.device) == ((CPU, torch.device("meta")), CPU)
    with pytest.raises(ValueError):
        mesh.make_mesh(0, CPU)
