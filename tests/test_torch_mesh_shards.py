"""The port's parties mesh split over device shards (parallel/mesh.py,
models/groth16/mesh_prover.py, scheduler/batch_prover.py,
examples/multichip.py) against the JAX package at m = 16 on the CPU,
tolerance zero.

Every shard here is a CPU shard: k blocks on one device run every line of
the sharded path (one stage-1 transform and one batched local MSM a
shard, the gather onto the king, the king's tail once, the scatter back)
but a copy between two devices. As in tests/test_torch_mesh.py, none of
the JAX mesh programs runs (their shard_map compiles take minutes on the
CPU): the sharded transforms are held against the JAX package's eager
d_fft pieces run party by party, the sharded d_msm against refmath sums
of the clear scalars, and the sharded zk proof against the JAX package's
host oracle `prove_host` randomised on the host and its host `verify`.
The local MSMs take the tree route they take on the card (CARD_ROUTES)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as j_mult_chain,
)
from distributed_groth16_tpu.models.groth16.reference import (
    prove_host as j_prove_host,
)
from distributed_groth16_tpu.models.groth16.verify import verify as j_verify
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.ntt import domain as j_domain
from distributed_groth16_tpu.parallel import dfft as j_dfft
from distributed_groth16_tpu.parallel.pss import (
    PackedSharingParams as JaxPSS,
)
from distributed_groth16_tpu_torch.examples import multichip
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.models.groth16 import mesh_prover as mp_
from distributed_groth16_tpu_torch.models.groth16.reference import (
    decode_pk_host,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.curve import g1
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.ntt import domain
from distributed_groth16_tpu_torch.parallel import mesh
from distributed_groth16_tpu_torch.parallel.pss import PackedSharingParams
from distributed_groth16_tpu_torch.scheduler import batch_prover as bp

torch.set_num_threads(1)

L = 2
CPU = torch.device("cpu")
META = torch.device("meta")
LENGTH = 13  # constraints of the chain: m = 16 with its 2 instance rows
X0S = (7, 9)
# local MSMs: more points than LADDER_MSM_MAX_N take the tree MSM, as on
# the card
CARD_ROUTES = {"LADDER_MSM_MAX_N": 1}


@pytest.fixture
def card_routes(monkeypatch):
    for name, value in CARD_ROUTES.items():
        monkeypatch.setattr(tmsm, name, value)


@pytest.fixture(scope="module")
def world():
    r1cs, _ = mult_chain_circuit(X0S[0], LENGTH).finish()
    zs = [mult_chain_circuit(x0, LENGTH).finish()[1] for x0 in X0S]
    j_r1cs, jz = j_mult_chain(X0S[0], LENGTH).finish()
    assert jz == zs[0]
    pk = port.setup(r1cs, seed=5, device=CPU)  # keeps its query scalars
    pp = PackedSharingParams(L)
    F = fr()
    return dict(
        r1cs=r1cs, j_r1cs=j_r1cs, zs=zs, pk=pk, pp=pp,
        crs=port.pack_proving_key(pk, pp),  # the scalar route
        comp=port.CompiledR1CS(r1cs, CPU),
        z_monts=[F.encode(z, CPU) for z in zs],
        pk_host=decode_pk_host(pk), ni=r1cs.num_instance,
    )


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


def _cpu_mesh(k, n):
    return mesh.PartyMesh((CPU,) * k, n)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_mesh_dfft_matches_jax_party_by_party(k, monkeypatch):
    """Over k shards of n = 8 parties, _mesh_dfft runs stage 1 once a
    shard (k calls), gathers onto the king, runs the king's tail once and scatters k blocks back, or leaves
    the clear result on the king. Gathered, the shares equal the JAX
    package's _fft1_local run party by party and its king tail, limb for
    limb; the clear forward transform equals _king_clear_array's."""
    m, n, B = 16, 4 * L, 2
    pp, jpp = PackedSharingParams(L), JaxPSS(L)
    me = _cpu_mesh(k, n)
    calls = []
    fft1 = mesh._fft1_local
    monkeypatch.setattr(mesh, "_fft1_local",
                        lambda v, *a: calls.append(v.shape[0]) or fft1(v, *a))

    # the inverse transforms of ext_wit::h: re-laid out, padded to 2m
    x = _shares(3, (n, B, 3, m // L))
    dom, jdom = domain(m), j_domain(m)
    got = mesh._mesh_dfft(
        me.shard(x), pp, 4, True, True, 2, False, False,
        {CPU: dom._live_wpows(CPU)}, {CPU: torch.as_tensor(dom._size_inv)},
    )
    assert calls == [n // k] * k
    assert len(got) == k and {b.shape for b in got} == {
        (n // k, B, 3, 2 * m // L, 16)}
    jw = jdom._live_wpows()
    jx = jfr().mul(jnp.asarray(x.numpy().astype(np.uint32)),
                   jnp.asarray(jdom._size_inv))
    local = jnp.stack([j_dfft._fft1_local(jx[i], jw, 4, 1, True)
                       for i in range(n)])
    want = j_dfft._king_tail_array(local, jpp, 4, True, 2, False, True, jw)
    np.testing.assert_array_equal(_limbs(me.gather(got)), _limbs(want))

    # the forward transforms, left clear on the king
    calls.clear()
    y = _shares(4, (n, B, 3, 2 * m // L))
    dom2, jdom2 = domain(2 * m), j_domain(2 * m)
    clear = mesh._mesh_dfft(me.shard(y), pp, 5, False, False, 1, False, True,
                            {CPU: dom2._live_wpows(CPU)}, None)
    assert calls == [n // k] * k
    assert clear.shape == (B, 3, 2 * m, 16)
    jw2 = jdom2._live_wpows()
    jy = jnp.asarray(y.numpy().astype(np.uint32))
    local = jnp.stack([j_dfft._fft1_local(jy[i], jw2, 5, 1, False)
                       for i in range(n)])
    want = j_dfft._king_clear_array(local, jpp, 5, False, False, jw2)
    np.testing.assert_array_equal(_limbs(clear), _limbs(want))


def test_sharded_mesh_dmsm_batched_matches_refmath(world, card_routes,
                                                   monkeypatch):
    """Two jobs' A-query d_msms over one shared CRS table on k = 2
    shards: one msm_batched a shard, and each clear result equals the
    refmath MSM of the clear witness over the clear query points."""
    w = world
    pp, zs = w["pp"], w["zs"]
    me = _cpu_mesh(2, pp.n)
    a_sh = torch.stack([port.pack_from_witness(pp, zm[1:])
                        for zm in w["z_monts"]], dim=1)  # (n, 2, c, 16)
    s_q = torch.stack([c.s for c in w["crs"]])[:, None]  # (n, 1, c)+pt
    calls = []
    msm_batched = tmsm.msm_batched
    monkeypatch.setattr(
        tmsm, "msm_batched",
        lambda curve, b, s, of: calls.append(s.shape[0])
        or msm_batched(curve, b, s, of))
    got = mesh._mesh_dmsm_batched(g1(), me.shard(s_q), me.shard(a_sh), pp)
    assert calls == [pp.n // 2 * 2] * 2  # (n/k parties) x 2 jobs a shard
    assert got.shape == (2, 3, 16)
    assert g1().decode(got) == [
        rm.G1.msm(w["pk_host"]["a_query"][1:], z[1:]) for z in zs
    ]


def test_sharded_mesh_prove_zk_equals_the_jax_host_oracle(world,
                                                          card_routes):
    """mesh_prove_zk over k = 4 shards of the n = 8 parties, at r, s != 0:
    the JAX package's prove_host (r = s = 0) randomised on the host as
    prove.rs does (A + r delta, B + s delta, C + s A + r (beta_g1 +
    b_g1_query . z)) gives the same proof, and the JAX verify accepts
    it. The cores come back on the king's device as (n, ...) views."""
    w = world
    pp, crs, zm, z = w["pp"], w["crs"], w["z_monts"][0], w["zs"][0]
    pk, hp = w["pk"], w["pk_host"]
    rng = np.random.default_rng(11)
    r, s = (int.from_bytes(rng.bytes(32), "little") % fr().p
            for _ in range(2))
    qs = w["comp"].qap(zm).pss(pp)
    me = _cpu_mesh(4, pp.n)
    inp = mp_.MeshProverInputs(
        qap_a=torch.stack([q.a for q in qs]),
        qap_b=torch.stack([q.b for q in qs]),
        qap_c=torch.stack([q.c for q in qs]),
        a_share=port.pack_from_witness(pp, zm[1:]),
        ax_share=port.pack_from_witness(pp, zm[w["ni"]:]),
        **{f: me.shard(torch.stack([getattr(c, f) for c in crs]))
           for f in ("s", "u", "v", "w", "h")},
    )  # the CRS already sharded, the witness sharded on entry
    got = mp_.mesh_prove_zk(pp, pk.domain_size, me, inp, pk, r, s)

    det = j_prove_host(pk, w["j_r1cs"], z, hp)
    vk = pk.vk
    delta_g1 = g1().decode(pk.delta_g1)
    a = rm.G1.add(det.a, rm.G1.scalar_mul(delta_g1, r))
    b = rm.G2.add(det.b, rm.G2.scalar_mul(vk.delta_g2, s))
    b1 = rm.G1.add(g1().decode(pk.beta_g1), rm.G1.msm(hp["b_g1_query"], z))
    c = rm.G1.add(rm.G1.add(det.c, rm.G1.scalar_mul(a, s)),
                  rm.G1.scalar_mul(b1, r))
    assert (got.a, got.b, got.c) == (a, b, c)
    assert (got.a, got.b, got.c) != (det.a, det.b, det.c)
    assert j_verify(vk, got, z[1 : w["ni"]])


def test_multichip_dry_run_on_cpu_shards(capsys, monkeypatch):
    """examples/multichip.py, the counterpart of dryrun_multichip(4): the
    full zk step over 4 CPU shards, one party each, runs one local
    msm_batched a shard in each of its two d_msms and prints the JAX
    line; its cores come back (n, ...) on the king's device. The local
    MSMs answer the point at infinity here (on the CPU each is a plain
    254-step ladder: ~30 s in all), and
    test_sharded_mesh_prove_zk_equals_the_jax_host_oracle holds the real
    ones over shards."""
    calls = []

    def local_msm(curve, bases, scalars, bases_of=None):
        calls.append((bases.device, scalars.shape[0]))
        return curve.infinity((scalars.shape[0],), bases.device)

    monkeypatch.setattr(tmsm, "msm_batched", local_msm)
    res = multichip.run(4, device="cpu")
    # the 4-row G1 d_msm, then the G2 one: one call a shard, its party's
    # rows
    assert calls == [(CPU, 4)] * 4 + [(CPU, 1)] * 4
    assert "dryrun_multichip: n=4 parties (l=1) over 4-device mesh" in \
        capsys.readouterr().out
    assert res["shards"] == ["cpu"] * 4 and res["cards"] == 0
    assert res["outputs"] == [[4, 3, 16], [4, 3, 2, 16], [4, 3, 16],
                              [4, 3, 16]]
    assert res["output_device"] == "cpu"
    with pytest.raises(ValueError, match="power of two"):
        multichip.run(6, device="cpu")


def test_mesh_objects_split_the_parties_over_shards():
    """make_mesh is one shard; make_mesh_from_devices one party an entry,
    entries repeating; the king's device is shard 0's; k must divide n;
    an empty slice and a card this host lacks raise."""
    assert mesh.make_mesh(8, CPU) == mesh.PartyMesh((CPU,), 8)
    four = mesh.make_mesh_from_devices([CPU] * 4)
    assert (four.devices, four.n, four.k, four.device) == (
        (CPU,) * 4, 4, 4, CPU)
    mixed = mesh.make_mesh_from_devices(["cpu", "meta"])
    assert (mixed.devices, mixed.device) == ((CPU, META), CPU)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.PartyMesh((CPU,) * 3, 8)
    with pytest.raises(RuntimeError, match="empty"):
        mesh.make_mesh_from_devices([])
    with pytest.raises(RuntimeError, match="no device"):
        mesh.make_mesh_from_devices(["cuda:64"])
    with pytest.raises(ValueError):
        mesh.make_mesh(0, CPU)


def test_shard_gather_and_scatter_keep_views_and_devices():
    """shard splits axis 0 into k blocks: views where the block already
    sits on its device, an expand view moved as one row and expanded
    again; already sharded input passes through, misplaced blocks and a
    wrong party count raise; gather stacks the blocks on the king and
    scatter puts each shard's rows back on its device."""
    x = _shares(5, (8, 3))
    me = _cpu_mesh(4, 8)
    blocks = me.shard(x)
    assert [b.data_ptr() for b in blocks] == [
        x[2 * j].data_ptr() for j in range(4)]
    assert me.shard(blocks) is blocks
    assert torch.equal(me.gather(blocks), x)
    assert all(torch.equal(a, b) for a, b in zip(me.scatter(x), blocks))
    with pytest.raises(ValueError, match="rows"):
        me.shard(x[:4])

    mixed = mesh.PartyMesh((CPU, META), 8)
    row = x[0].unsqueeze(0).expand((8, 3, 16))
    king, peer = mixed.shard(row)
    assert king.data_ptr() == row.data_ptr() and king.device == CPU
    assert peer.device == META and peer.shape == (4, 3, 16)
    assert peer.stride(0) == 0  # one row placed, not four
    with pytest.raises(ValueError, match="mesh shards"):
        me.shard((king, peer))
    with pytest.raises(ValueError, match="mesh shards"):
        mixed.shard(blocks[:2])


def test_prover_cache_keys_name_every_shard():
    """A one-shard and a four-shard prover on one device are two
    ProverCache entries."""
    one, four = mesh.make_mesh(8, CPU), _cpu_mesh(4, 8)
    k1 = bp.prover_cache_key("c", L, 16, 2, one)
    k4 = bp.prover_cache_key("c", L, 16, 2, four)
    assert k1 != k4 and k4[-1] == ("cpu",) * 4
    cache = bp.ProverCache()
    assert cache.get_or_build(k1, lambda: "one") == "one"
    assert cache.get_or_build(k4, lambda: "four") == "four"
    assert (cache.hits, cache.misses) == (0, 2)


def test_shard_crs_places_the_packed_crs_on_the_shards(world):
    """shard_crs stacks the n parties' s, u, v, w shares and splits them
    into one block a shard, two parties each over four shards; gathered,
    each equals the one-shard stack."""
    crs, four = world["crs"], _cpu_mesh(4, 8)
    placed = bp.shard_crs(four, crs)
    for f, blocks in zip(("s", "u", "v", "w"), placed, strict=True):
        assert len(blocks) == 4 and {b.shape[0] for b in blocks} == {2}
        assert torch.equal(four.gather(blocks),
                           torch.stack([getattr(c, f) for c in crs]))
