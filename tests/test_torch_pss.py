"""The port's packed secret sharing and distributed kernels
(parallel/pss.py, packing.py, dfft.py, dmsm.py of
distributed_groth16_tpu_torch) against the JAX package at l = 2, n = 8.

Field shares are integers, so they are compared limb for limb (tolerance
zero). Curve points are compared as decoded affine points: projective
representatives depend on the order of operations. d_msm here is held
against the JAX package's refmath (the clear MSM of the host points):
its bases are packed on the host, which avoids compiling a JAX pack for
another shape; tests/test_torch_mpc.py compares every d_msm of a whole
round with the JAX round's."""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, G2_GENERATOR, R
from distributed_groth16_tpu.ops.curve import g1 as jg1, g2 as jg2
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.ntt import domain as jdomain
from distributed_groth16_tpu.parallel import dfft as jdfft
from distributed_groth16_tpu.parallel import packing as jpacking
from distributed_groth16_tpu.parallel import pss as jpss
from distributed_groth16_tpu.parallel.net import (
    simulate_network_round as jax_round,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.curve import g1, g2
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.ntt import domain
from distributed_groth16_tpu_torch.parallel import dfft, packing, pss
from distributed_groth16_tpu_torch.parallel.dmsm import d_msm
from distributed_groth16_tpu_torch.parallel.net import simulate_network_round

torch.set_num_threads(1)

L = 2
N = 4 * L
CPU = torch.device("cpu")


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(count)]


def _limbs(x) -> np.ndarray:
    """Port int32 or JAX uint32 limb arrays as int64, for exact equality."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def pps():
    return pss.pss(L), jpss.PackedSharingParams(L)


@pytest.fixture
def card_routes(monkeypatch):
    """Routes as on the card at full size: every local MSM takes the tree
    MSM (kernels 1 and 3)."""
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)


def test_parameters_and_matrices_match_jax(pps):
    pp, jp = pps
    assert (pp.l, pp.t, pp.n) == (jp.l, jp.t, jp.n) == (2, 1, 8)
    assert (pp.share.size, pp.secret.size, pp.secret2.size) == (8, 4, 8)
    assert pp.secret.offset == pp.secret2.offset == jp.secret_h.offset
    for name in ("pack_matrix", "unpack_matrix", "unpack2_matrix"):
        assert getattr(pp, name) == getattr(jp, name), name


def test_host_ground_truth_matches_jax(pps):
    pp, jp = pps
    rng = np.random.default_rng(3)
    secrets = _ints(rng, L)
    shares = pss.pack_host(pp, secrets)
    assert shares == jpss.pack_host(jp, secrets)
    assert pss.unpack_host(pp, shares) == secrets
    sq = [s * s % R for s in shares]
    assert pss.unpack2_host(pp, sq) == jpss.unpack2_host(jp, sq)
    assert pss.unpack2_host(pp, sq) == [s * s % R for s in secrets]


def test_field_transforms_match_jax_limb_for_limb(pps):
    pp, jp = pps
    rng = np.random.default_rng(11)
    secrets = _ints(rng, 3 * L)
    shape = (3, L)
    x = fr().encode(np.array(secrets, dtype=object).reshape(shape), CPU)
    jx = jfr().encode(np.array(secrets, dtype=object).reshape(shape))
    shares, jshares = pp.pack_from_public(x), jp.pack_from_public(jx)
    np.testing.assert_array_equal(_limbs(shares), _limbs(jshares))
    np.testing.assert_array_equal(_limbs(pp.unpack(shares)),
                                  _limbs(jp.unpack(jshares)))
    np.testing.assert_array_equal(_limbs(pp.unpack(shares)), _limbs(x))
    sq, jsq = fr().mul(shares, shares), jfr().mul(jshares, jshares)
    np.testing.assert_array_equal(_limbs(pp.unpack2(sq)),
                                  _limbs(jp.unpack2(jsq)))


def test_pack_from_public_rand_matches_jax_from_one_seed(pps):
    pp, jp = pps
    secrets = _ints(np.random.default_rng(12), 4 * L)
    arr = np.array(secrets, dtype=object).reshape(4, L)
    got = pp.pack_from_public_rand(fr().encode(arr, CPU),
                                   np.random.default_rng(99))
    want = jp.pack_from_public_rand(jfr().encode(arr),
                                    np.random.default_rng(99))
    np.testing.assert_array_equal(_limbs(got), _limbs(want))
    np.testing.assert_array_equal(_limbs(pp.unpack(got)),
                                  _limbs(fr().encode(arr, CPU)))


@pytest.mark.parametrize("layout", ["consecutive", "strided"])
def test_packing_layouts_match_jax(pps, layout):
    pp, jp = pps
    vals = _ints(np.random.default_rng(13), 16)
    port_fn = getattr(packing, f"pack_{layout}")
    jax_fn = getattr(jpacking, f"pack_{layout}")
    shares = port_fn(pp, fr().encode(vals, CPU))
    jshares = jax_fn(jp, jfr().encode(vals))
    assert shares.shape == (N, 8, 16)
    np.testing.assert_array_equal(_limbs(shares), _limbs(jshares))
    np.testing.assert_array_equal(
        _limbs(packing.unpack_shares(pp, shares)),
        _limbs(jpacking.unpack_shares(jp, jshares)),
    )


def _host_points(which: str, rng, count: int):
    host, gen = (rm.G1, G1_GENERATOR) if which == "g1" else (rm.G2, G2_GENERATOR)
    return [host.scalar_mul(gen, k) for k in _ints(rng, count)]


def _apply_host(which: str, mat, pts):
    """out[o] = sum_i mat[o][i] * pts[i] with host integer arithmetic."""
    host = rm.G1 if which == "g1" else rm.G2
    return [host.msm(pts, row) for row in mat]


def _apply(pp, curve, transform, x):
    if transform == "packexp":
        return pp.packexp_from_public(curve, x)
    return pp.unpackexp(curve, x, degree2=True)


@pytest.fixture(scope="module")
def jax_transforms(pps):
    """(host points, the JAX package's output as affine points) of each
    in-exponent transform on one batch row, computed once per case."""
    _, jp = pps
    cache = {}

    def get(which, transform):
        if (which, transform) not in cache:
            seed = {"packexp": 5, "unpackexp2": 6}[transform] + (which == "g2")
            k = L if transform == "packexp" else N
            pts = _host_points(which, np.random.default_rng(seed), k)
            jcurve = jg1() if which == "g1" else jg2()
            out = _apply(jp, jcurve, transform, jcurve.encode(pts)[None])
            cache[which, transform] = (pts, jcurve.decode(out[0]))
        return cache[which, transform]

    return get


@pytest.mark.parametrize("transform", ["packexp", "unpackexp2"])
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_point_transform_matches_jax(pps, jax_transforms, which, transform):
    """packexp_from_public and unpackexp(degree2) on G1 (GLV halves) and
    G2 (full-width ladder), through ladder_apply, against the JAX
    package's (its row-major dense ladder on the CPU)."""
    pp, _ = pps
    pts, want = jax_transforms(which, transform)
    curve = g1() if which == "g1" else g2()
    x = curve.encode(pts, CPU)[None]  # one batch row: (1, k) + point
    out = _apply(pp, curve, transform, x)
    assert out.shape == (1, 8 if transform == "packexp" else L) + x.shape[2:]
    assert curve.decode(out[0]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_ladder_apply_on_the_card_matches_the_cpu(pps, which):
    """Kernels 1 and 2 inside ladder_apply give the plain versions' limbs,
    so the card's packed points equal the CPU's limb for limb."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    pp, _ = pps
    curve = g1() if which == "g1" else g2()
    enc = curve.encode(_host_points(which, np.random.default_rng(8), 4 * L),
                       CPU)
    x = enc.reshape((4, L) + enc.shape[1:])
    want = pp.packexp_from_public(curve, x)
    got = pp.packexp_from_public(curve, x.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_point_ntt_route_choice(pps, monkeypatch):
    """"auto" takes the point NTT from n = 64 parties over BN254 Fr and
    the dense ladder over Fr381, where "ntt" raises (the point NTT's
    domains are over BN254 Fr), as in the JAX package."""
    from distributed_groth16_tpu_torch.ops.bls12_381 import pss381
    from distributed_groth16_tpu_torch.parallel import pointntt

    pp, _ = pps
    big, b381 = pss.PackedSharingParams(16), pss381(16)
    assert [big._pick_exp_method(m) for m in ("auto", "dense", "ntt")] == \
        ["ntt", "dense", "ntt"]
    assert pp._pick_exp_method("auto") == "dense"  # n = 8
    assert b381._pick_exp_method("auto") == "dense"
    with pytest.raises(NotImplementedError, match="BN254-Fr-only"):
        b381._pick_exp_method("ntt")
    with pytest.raises(ValueError, match="unknown method"):
        pp._pick_exp_method("fast")
    seen = []
    monkeypatch.setattr(pointntt, "packexp_ntt",
                        lambda *a: seen.append("pack") or "ntt")
    monkeypatch.setattr(pointntt, "unpackexp_ntt",
                        lambda *a: seen.append(("unpack", a[3])) or "ntt")
    assert big.packexp_from_public(g1(), None) == "ntt"
    assert big.unpackexp(g1(), None, degree2=True) == "ntt"
    assert pp.packexp_from_public(g1(), None, method="ntt") == "ntt"
    assert seen == ["pack", ("unpack", True), "pack"]


M = 16


def _jax_parties(closure, shares):
    return jax_round(N, closure, [shares[i] for i in range(N)])


@pytest.fixture(scope="module")
def fft_inputs(pps):
    pp, jp = pps
    vals = _ints(np.random.default_rng(21), M)
    return (packing.pack_strided(pp, fr().encode(vals, CPU)),
            jpacking.pack_strided(jp, jfr().encode(vals)))


@pytest.mark.parametrize("case", ["fft", "ifft", "fft_degree2"])
def test_d_fft_matches_jax_per_party(pps, fft_inputs, case):
    pp, jp = pps
    shares, jshares = fft_inputs
    inverse, degree2 = case == "ifft", case == "fft_degree2"
    if degree2:
        shares, jshares = fr().mul(shares, shares), jfr().mul(jshares, jshares)
    port_fn = dfft.d_ifft if inverse else dfft.d_fft
    jax_fn = jdfft.d_ifft if inverse else jdfft.d_fft

    async def port_party(net, s):
        return await port_fn(s, False, 1, degree2, domain(M), pp, net)

    async def jax_party(net, s):
        return await jax_fn(s, False, 1, degree2, jdomain(M), jp, net)

    got = simulate_network_round(N, port_party, [shares[i] for i in range(N)])
    want = _jax_parties(jax_party, jshares)
    for i in range(N):
        np.testing.assert_array_equal(_limbs(got[i]), _limbs(want[i]))


def test_d_ifft_pad_rearrange_then_king_clear_matches_jax(pps, fft_inputs):
    """The ext_wit chain: d_ifft(rearrange=True, pad=2) on the m-domain
    feeds d_fft on the 2m-domain, whose clear result stays on the king."""
    pp, jp = pps
    shares, jshares = fft_inputs

    async def port_party(net, s):
        mid = await dfft.d_ifft(s, True, 2, False, domain(M), pp, net)
        out = await dfft.d_fft(mid, False, 1, False, domain(2 * M), pp, net,
                               king_clear=True)
        return mid, out

    async def jax_party(net, s):
        mid = await jdfft.d_ifft(s, True, 2, False, jdomain(M), jp, net)
        out = await jdfft.d_fft(mid, False, 1, False, jdomain(2 * M), jp,
                                net, king_clear=True)
        return mid, out

    got = simulate_network_round(N, port_party, [shares[i] for i in range(N)])
    want = _jax_parties(jax_party, jshares)
    for i in range(N):
        assert got[i][0].shape == (2 * M // L, 16)
        np.testing.assert_array_equal(_limbs(got[i][0]), _limbs(want[i][0]))
        if i:
            assert got[i][1] is None and want[i][1] is None
    np.testing.assert_array_equal(_limbs(got[0][1]), _limbs(want[0][1]))
    assert got[0][1].shape == (2 * M, 16)


def test_d_msm_matches_refmath(pps, card_routes):
    """d_msm over n = 8 parties: bases packed in the exponent and scalars
    packed consecutively, as pack_proving_key and pack_from_witness lay
    them out; every party gets the clear MSM."""
    pp, _ = pps
    rng = np.random.default_rng(31)
    k = 4
    pts = _host_points("g1", rng, k)
    scalars = _ints(rng, k)
    # host in-exponent packing of the bases, chunk by chunk
    base_shares = [
        _apply_host("g1", pp.pack_matrix, pts[c * L : (c + 1) * L])
        for c in range(k // L)
    ]  # (c, n) affine
    C = g1()
    bases = C.encode(
        [base_shares[c][i] for i in range(N) for c in range(k // L)], CPU
    ).reshape(N, k // L, 3, 16)
    s_sh = packing.pack_consecutive(pp, fr().encode(scalars, CPU))

    async def party(net, data):
        return await d_msm(C, data[0], data[1], pp, net)

    outs = simulate_network_round(
        N, party, [(bases[i], s_sh[i]) for i in range(N)]
    )
    want = rm.G1.msm(pts, scalars)
    assert all(o is outs[0] for o in outs)  # one tensor handed to all
    assert C.decode(outs[0]) == want
