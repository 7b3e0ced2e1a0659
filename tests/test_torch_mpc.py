"""The port's MPC prover (models/groth16 of distributed_groth16_tpu_torch:
QAP.pss, pack_proving_key, pack_from_witness, distributed_prove_party,
reassemble_proof) against the JAX package at m = 16, l = 2, n = 8, over
LocalSimNet.

The key is made by the JAX package's setup and saved; both packages load
it, so both pack it in the exponent (the route of every loaded key). The
JAX round runs once, in a module fixture. The port runs with its small-MSM
threshold lowered (CARD_ROUTES) so that at m = 16 every step takes the
route it takes on the card at m = 2^15: the CRS pack and the king's unpack
ladder_apply (kernels 1 and 2), every party's local MSM the tree MSM
(kernels 1 and 3). Field shares are compared limb for limb, CRS shares as
affine points, proofs as host integers (tolerance zero throughout)."""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu.models import groth16 as jg
from distributed_groth16_tpu.models.groth16.prove import (
    public_prove_consts as jax_public_consts,
)
from distributed_groth16_tpu.ops.curve import g1 as jg1, g2 as jg2
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.parallel import net as jnet
from distributed_groth16_tpu.parallel.pss import PackedSharingParams
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.models.groth16 import prove as tprove
from distributed_groth16_tpu_torch.ops import limb_kernels
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.curve import g1, g2
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.parallel import net as tnet
from distributed_groth16_tpu_torch.parallel.pss import pss

torch.set_num_threads(1)

L = 2
CPU = torch.device("cpu")
R_ZK, S_ZK = 123456789, 987654321
# local MSMs: n = 8 > LADDER_MSM_MAX_N takes the tree MSM
CARD_ROUTES = {"LADDER_MSM_MAX_N": 1}


def _card_routes(mp):
    for name, value in CARD_ROUTES.items():
        mp.setattr(tmsm, name, value)


def _limbs(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _proof_tuple(p):
    return (p.a, p.b, p.c)


def _round(sim, prove, pp, crs, qs, a, ax, **kw):
    async def party(net, d):
        return await prove(pp, d[0], d[1], d[2], d[3], net, **kw)

    return sim(pp.n, party, [(crs[i], qs[i], a[i], ax[i]) for i in range(pp.n)])


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    r1cs, z = mult_chain_circuit(7, 13).finish()  # nc=13, ni=2 -> m=16
    path = str(tmp_path_factory.mktemp("key") / "pk.npz")
    dealer = jg.setup(r1cs, seed=42)  # keeps its query scalars
    dealer.save(path)
    pk = jg.ProvingKey.load(path)  # no query scalars: the point route
    jp = PackedSharingParams(L)
    z_mont = jfr().encode(z)
    ni = r1cs.num_instance
    qs = jg.CompiledR1CS(r1cs).qap(z_mont).pss(jp)
    crs = jg.pack_proving_key(pk, jp)
    a = jg.pack_from_witness(jp, z_mont[1:])
    ax = jg.pack_from_witness(jp, z_mont[ni:])
    res = _round(jnet.simulate_network_round, jg.distributed_prove_party,
                 jp, crs, qs, a, ax)
    return dict(r1cs=r1cs, z=z, path=path, pk=pk, qs=qs, crs=crs, a=a,
                ax=ax, res=res, proof=jg.reassemble_proof(res[0], pk),
                pubs=z[1:ni], dealer=dealer, jp=jp)


def _tensors(value):
    """Every tensor inside a value sent across the net."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


def _recording_send(log):
    """A LocalSimNet._send_impl that logs every tensor it sends, with a
    copy taken at send time."""
    orig = tnet.LocalSimNet._send_impl

    async def recording(self, to, value, sid):
        log.extend((t, t.clone()) for t in _tensors(value))
        return await orig(self, to, value, sid)

    return recording


def _changed(log):
    return [i for i, (t, copy) in enumerate(log)
            if t.shape != copy.shape or not torch.equal(t, copy)]


def _recording_d_msm(log):
    """prove.d_msm that logs (bases, scalar shares, result) of each call."""
    orig = tprove.d_msm

    async def recording(curve, bases, scalar_shares, pp, net, sid=0):
        out = await orig(curve, bases, scalar_shares, pp, net, sid)
        log.append((bases, scalar_shares, out))
        return out

    return recording


def _replaying_d_msm(log, fresh):
    """prove.d_msm that hands back the logged result of a call on the same
    bases tensor with equal scalar shares (d_msm is a function of them) and
    runs the real d_msm, counting it in `fresh`, on anything else."""
    orig = tprove.d_msm

    async def replaying(curve, bases, scalar_shares, pp, net, sid=0):
        for b, s, out in log:
            if b is bases and torch.equal(s, scalar_shares):
                return out
        fresh.append(net.party_id)
        return await orig(curve, bases, scalar_shares, pp, net, sid)

    return replaying


def _count_calls(mp, counts, targets):
    """Count the calls of each (module, name) in `targets` into `counts`."""
    for mod, name in targets:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        mp.setattr(mod, name, counted)


@pytest.fixture(scope="module")
def port_world(jax_world):
    w = jax_world
    sent, msms, pack_routes, round_routes = [], [], {}, {}
    routes = [(limb_kernels, "ladder_apply"), (limb_kernels, "msm_tree")]
    with pytest.MonkeyPatch.context() as mp:
        _card_routes(mp)
        pk = port.ProvingKey.load(w["path"], device="cpu")
        pp = pss(L)
        z_mont = fr().encode(w["z"], CPU)
        comp = port.CompiledR1CS(w["r1cs"], CPU)
        ni = w["r1cs"].num_instance
        qs = comp.qap(z_mont).pss(pp)
        with pytest.MonkeyPatch.context() as counting:
            _count_calls(counting, pack_routes, routes)
            crs = port.pack_proving_key(pk, pp)
        a = port.pack_from_witness(pp, z_mont[1:])
        ax = port.pack_from_witness(pp, z_mont[ni:])
        mp.setattr(tnet.LocalSimNet, "_send_impl", _recording_send(sent))
        mp.setattr(tprove, "d_msm", _recording_d_msm(msms))
        _count_calls(mp, round_routes, routes)
        res = _round(tnet.simulate_network_round,
                     port.distributed_prove_party, pp, crs, qs, a, ax)
    return dict(pk=pk, pp=pp, z_mont=z_mont, comp=comp, qs=qs, crs=crs,
                a=a, ax=ax, res=res, sent=sent, msms=msms,
                pack_routes=pack_routes,
                round_routes=round_routes,
                proof=port.reassemble_proof(res[0], pk))


def test_port_takes_the_card_routes(port_world):
    """Five query ladders through ladder_apply; in the round, 8 parties x
    4 local tree MSMs and the king's 4 unpacks through ladder_apply."""
    assert port_world["pack_routes"] == {"ladder_apply": 5}
    assert port_world["round_routes"] == {"msm_tree": 32, "ladder_apply": 4}


def test_qap_shares_match_jax_limb_for_limb(jax_world, port_world):
    for got, want in zip(port_world["qs"], jax_world["qs"]):
        for k in ("a", "b", "c"):
            np.testing.assert_array_equal(_limbs(getattr(got, k)),
                                          _limbs(getattr(want, k)))
        assert got.domain.size == want.domain.size == 16


def test_king_combine_h_matches_jax_limb_for_limb():
    """The king's h combine keeps the odd 2m-th-root evaluations, which in
    natural domain order are every second entry, then packs consecutively
    per party."""
    from distributed_groth16_tpu.models.groth16.ext_wit import (
        king_combine_h as jax_combine,
    )
    from distributed_groth16_tpu_torch.models.groth16.ext_wit import (
        king_combine_h,
    )

    rng = np.random.default_rng(17)
    vecs = [[int.from_bytes(rng.bytes(40), "little") % fr().p
             for _ in range(32)] for _ in range(3)]
    got = king_combine_h(*(fr().encode(v, CPU) for v in vecs), pss(L))
    want = jax_combine(*(jfr().encode(v) for v in vecs),
                       PackedSharingParams(L))
    assert got.shape == (8, 8, 16)
    np.testing.assert_array_equal(_limbs(got), _limbs(want))


def test_witness_shares_match_jax_limb_for_limb(jax_world, port_world):
    for k in ("a", "ax"):
        assert port_world[k].shape == (8,) + tuple(jax_world[k].shape[1:])
        np.testing.assert_array_equal(_limbs(port_world[k]),
                                      _limbs(jax_world[k]))


@pytest.mark.parametrize("query", ["s", "u", "v", "w", "h"])
def test_crs_shares_match_jax_as_affine_points(jax_world, port_world, query):
    curve, jcurve = (g2(), jg2()) if query == "v" else (g1(), jg1())
    for i in range(8):
        got = getattr(port_world["crs"][i], query)
        want = getattr(jax_world["crs"][i], query)
        assert tuple(got.shape) == tuple(want.shape)
        assert curve.decode(got) == jcurve.decode(want)


def test_mpc_proof_equals_jax_round_and_prove_single(jax_world, port_world,
                                                     monkeypatch):
    _card_routes(monkeypatch)
    proof = port_world["proof"]
    assert _proof_tuple(proof) == _proof_tuple(jax_world["proof"])
    single = port.prove_single(port_world["pk"], port_world["comp"],
                               port_world["z_mont"])
    assert _proof_tuple(proof) == _proof_tuple(single)
    assert port.verify(port_world["pk"].vk, proof, jax_world["pubs"])
    # d_msm hands every party the same clear core
    res = port_world["res"]
    assert all(r.a is res[0].a and r.b is res[0].b for r in res)


def test_d_msm_results_match_jax_as_affine_points(jax_world, port_world):
    """Every party's A = d_msm(S, a), B = d_msm(V, a) and C = d_msm(W, ax)
    + d_msm(U, h) at r = s = 0, against the JAX round's."""
    for got, want in zip(port_world["res"], jax_world["res"]):
        assert g1().decode(got.a) == jg1().decode(want.a)
        assert g2().decode(got.b) == jg2().decode(want.b)
        assert g1().decode(got.c) == jg1().decode(want.c)


def test_nothing_sent_across_the_net_is_mutated(port_world):
    """Tensors cross LocalSimNet by reference: after the whole round, every
    tensor any party sent still holds what it held when it was sent."""
    assert len(port_world["sent"]) > 100
    assert _changed(port_world["sent"]) == []


def test_mutation_check_catches_an_in_place_write(monkeypatch):
    """The check above fails if a party writes to a received tensor."""
    sent = []
    monkeypatch.setattr(tnet.LocalSimNet, "_send_impl", _recording_send(sent))

    async def party(net, _):
        x = torch.arange(4) if net.is_king else None
        got = await net.scatter_from_king(
            [x] * net.n_parties if net.is_king else None
        )
        if net.party_id == 3:
            got.add_(1)
        return got

    tnet.simulate_network_round(4, party)
    assert len(sent) == 3 and _changed(sent) == [0, 1, 2]


def test_randomized_mpc_proof_verifies_in_both_packages(jax_world,
                                                        port_world,
                                                        monkeypatch):
    """A round at r, s != 0. Its four d_msm calls on the same inputs as the
    r = s = 0 round's are handed that round's results, so only the H-query
    d_msm (run at r != 0 alone) runs again, on every party."""
    _card_routes(monkeypatch)
    w = port_world
    fresh = []
    monkeypatch.setattr(tprove, "d_msm", _replaying_d_msm(w["msms"], fresh))
    pub = port.public_prove_consts(w["pk"])
    jpub = jax_public_consts(jax_world["pk"])
    for k in ("N", "A0", "M"):
        assert g1().decode(pub[k]) == jg1().decode(jpub[k])
    assert g2().decode(pub["K"]) == jg2().decode(jpub["K"])
    res = _round(tnet.simulate_network_round, port.distributed_prove_party,
                 w["pp"], w["crs"], w["qs"], w["a"], w["ax"],
                 pub=pub, r=R_ZK, s=S_ZK)
    assert sorted(fresh) == list(range(8))
    proof = port.reassemble_proof(res[0], w["pk"])
    assert _proof_tuple(proof) != _proof_tuple(w["proof"])
    assert port.verify(w["pk"].vk, proof, jax_world["pubs"])
    assert jg.verify(jax_world["pk"].vk, proof, jax_world["pubs"])
    with pytest.raises(ValueError, match="public_prove_consts"):
        _round(tnet.simulate_network_round, port.distributed_prove_party,
               w["pp"], w["crs"], w["qs"], w["a"], w["ax"], r=R_ZK)


def test_net_faults_are_structured_and_transient_ones_retried():
    """LocalSimNet's error surface, as the JAX package's: a silent peer
    times out naming party, peer, collective and job; protocol misuse
    raises at once; a transient fault re-runs the whole round."""

    async def silent(net, _):
        if net.party_id == 1:
            return None
        return await net.gather_to_king(net.party_id, timeout=0.05)

    with tnet.job_context("job-7"), pytest.raises(tnet.MpcTimeoutError) as e:
        tnet.simulate_network_round(3, silent)
    assert (e.value.party, e.value.peer, e.value.op, e.value.job_id) == (
        0, 1, "gather_to_king", "job-7")

    async def misuse(net, _):
        return await net.scatter_from_king([1] if net.is_king else None)

    with pytest.raises(tnet.MpcNetError, match="1 values for 2 parties"):
        tnet.simulate_network_round(2, misuse)

    attempts = []

    async def flaky(net, _):
        if len(attempts) < 2 * net.n_parties:
            attempts.append(net.party_id)
            raise tnet.MpcDisconnectError("link dropped", party=net.party_id)
        return await net.broadcast_from_king(net.party_id)

    retried = []
    out = tnet.run_round_with_retries(
        2, flaky, retries=2, on_retry=lambda i, err: retried.append(i)
    )
    assert out == [0, 0] and retried == [0, 1]


def test_strip_clears_query_scalars(jax_world):
    pk = port.ProvingKey.load(jax_world["path"], device="cpu")
    pk.query_scalars = object()
    assert pk.strip() is pk and pk.query_scalars is None


# -- the scalar route of the CRS pack ---------------------------------------

QUERIES = ("s", "u", "v", "w", "h")


@pytest.fixture(scope="module")
def scalar_world(jax_world):
    """The port's own setup of the same circuit and seed (which keeps the
    dealer's query scalars), packed by the scalar route."""
    pk = port.setup(jax_world["r1cs"], seed=42, device="cpu")
    assert isinstance(pk.query_scalars, port.QueryScalars)
    timings = {}
    crs = port.pack_proving_key(pk, pss(L), timings=timings)
    return dict(pk=pk, crs=crs, timings=timings)


def _affine_shares(crs, query):
    curve = g2() if query == "v" else g1()
    return [curve.decode(getattr(share, query)) for share in crs]


@pytest.mark.parametrize("query", QUERIES)
def test_scalar_route_shares_equal_point_route_shares(scalar_world,
                                                      port_world, query):
    """The port's form of the JAX package's
    test_scalar_route_pack_matches_point_route: packing the dealer's
    scalars in the field, then one fixed-base multiply per share point,
    gives the in-exponent pack's share points."""
    got, want = scalar_world["crs"], port_world["crs"]
    for a, b in zip(got, want):
        assert tuple(getattr(a, query).shape) == tuple(getattr(b, query).shape)
    assert _affine_shares(got, query) == _affine_shares(want, query)
    assert set(scalar_world["timings"]) == set(QUERIES)


def test_scalar_route_shares_equal_the_jax_scalar_route(jax_world,
                                                        scalar_world):
    want = jg.pack_proving_key(jax_world["dealer"], jax_world["jp"])
    for query in QUERIES:
        jcurve = jg2() if query == "v" else jg1()
        assert _affine_shares(scalar_world["crs"], query) == [
            jcurve.decode(getattr(share, query)) for share in want
        ], query


def test_save_load_drop_query_scalars_and_strip_clears_them(scalar_world,
                                                            tmp_path):
    pk = scalar_world["pk"]
    pk.save(str(tmp_path / "pk.npz"))
    with np.load(tmp_path / "pk.npz") as d:
        assert not any("scalar" in name for name in d.files)
    loaded = port.ProvingKey.load(str(tmp_path / "pk.npz"), device="cpu")
    assert loaded.query_scalars is None
    assert pk.to("cpu").query_scalars is None
    once = dataclasses.replace(pk)  # a one-shot dealer flow's key
    shares = port.pack_proving_key(once, pss(L), strip=True)
    assert once.query_scalars is None and pk.query_scalars is not None
    assert _affine_shares(shares, "u") == _affine_shares(
        scalar_world["crs"], "u")
