"""The port's in-exponent point NTT (parallel/pointntt.py and the per-lane
ladder ops/limb_kernels.lane_ladder), the route choice of the PSS
in-exponent maps, deg_red and d_pp, against the JAX package at l = 2,
n = 8.

Every comparison is exact. Points are compared as decoded affine points
(projective representatives depend on the order of operations); field
shares are canonical row-major limbs, compared limb for limb. The JAX
package runs its point NTT as plain XLA on the CPU (no Pallas kernel is on
that path); the port runs the plain versions of kernels 1 and 2."""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, G2_GENERATOR, R
from distributed_groth16_tpu.ops.curve import (
    fixed_scalar_ladder_tensors as jax_ladder_tensors,
    g1 as jg1,
    g2 as jg2,
)
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.parallel import pointntt as jpn
from distributed_groth16_tpu.parallel import pss as jpss
from distributed_groth16_tpu.parallel.degred import deg_red as jdeg_red
from distributed_groth16_tpu.parallel.dmsm import d_msm as jd_msm
from distributed_groth16_tpu.parallel.dpp import d_pp as jd_pp
from distributed_groth16_tpu.parallel.net import (
    simulate_network_round as jax_round,
)
from distributed_groth16_tpu.parallel.packing import (
    pack_consecutive as jpack_consecutive,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.curve import (
    fixed_scalar_ladder_tensors,
    g1,
    g2,
)
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.parallel import pointntt, pss
from distributed_groth16_tpu_torch.parallel.degred import deg_red
from distributed_groth16_tpu_torch.parallel.dmsm import d_msm
from distributed_groth16_tpu_torch.parallel.dpp import d_pp
from distributed_groth16_tpu_torch.parallel.net import simulate_network_round
from distributed_groth16_tpu_torch.parallel.packing import (
    pack_consecutive,
    unpack_shares,
)

torch.set_num_threads(1)

L = 2
N = 4 * L
CPU = torch.device("cpu")


def _ints(rng, count, lo=0):
    return [lo + int.from_bytes(rng.bytes(40), "little") % (R - lo)
            for _ in range(count)]


def _host_points(which, rng, count):
    host, gen = (rm.G1, G1_GENERATOR) if which == "g1" else (rm.G2, G2_GENERATOR)
    return [host.scalar_mul(gen, k) for k in _ints(rng, count, 1)]


def _limbs(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def pps():
    return pss.pss(L), jpss.PackedSharingParams(L)


@pytest.fixture(scope="module")
def packed(pps):
    """Host points (one batch row of l on G1), the JAX package's point-NTT
    pack of them as affine points, and the port's packed tensor."""
    pp, jp = pps
    pts = _host_points("g1", np.random.default_rng(5), L)
    want = jg1().decode(jp.packexp_from_public(
        jg1(), jg1().encode(pts)[None], method="ntt")[0])
    got = pp.packexp_from_public(g1(), g1().encode(pts, CPU)[None],
                                 method="ntt")
    return pts, want, got


def test_packexp_ntt_matches_jax(pps, packed):
    pp, _ = pps
    pts, want, got = packed
    assert got.shape == (1, N, 3, 16)
    assert g1().decode(got[0]) == want
    # the dense matrix ladder gives the same shares
    dense = pp.packexp_from_public(g1(), g1().encode(pts, CPU)[None],
                                   method="dense")
    assert g1().decode(dense[0]) == want


def test_unpackexp_ntt_degree1_inverts_packexp(pps, packed):
    pp, _ = pps
    pts, _, got = packed
    back = pp.unpackexp(g1(), got, method="ntt")
    assert back.shape == (1, L, 3, 16)
    assert g1().decode(back[0]) == pts


def test_point_domain_g2_matches_jax():
    """G2 has no GLV: the lane ladder runs the full 256-bit scalars (the
    inverse's 1/n scaling) and a stage of twiddle one."""
    pts = _host_points("g2", np.random.default_rng(6), 2)
    dom, jdom = pointntt.point_domain(2), jpn.point_domain(2)
    x, jx = g2().encode(pts, CPU), jg2().encode(pts)
    fwd = dom.fft(g2(), x)
    assert g2().decode(fwd) == jg2().decode(jdom.fft(jg2(), jx))
    assert g2().decode(dom.ifft(g2(), fwd)) == pts


def test_lane_ladder_matches_jax_fixed_scalar_mul():
    """A batch of two rows of three lanes, with GLV halves of both signs
    among the scalars, against the JAX package's fixed_scalar_mul."""
    rng = np.random.default_rng(7)
    scalars = _ints(rng, 3)
    pts = _host_points("g1", rng, 6)
    tensors = fixed_scalar_ladder_tensors(g1(), scalars)
    assert tensors[1].any() and not tensors[1].all()  # both signs
    got = pointntt.fixed_scalar_mul(
        g1(), g1().encode(pts, CPU).reshape(2, 3, 3, 16), tensors)
    jout = jpn.fixed_scalar_mul(
        jg1(), jg1().encode(pts).reshape(2, 3, 3, 16),
        jax_ladder_tensors(jg1(), scalars))
    assert g1().decode(got.reshape(6, 3, 16)) == \
        jg1().decode(jout.reshape(6, 3, 16))
    assert g1().decode(got.reshape(6, 3, 16)) == [
        rm.G1.scalar_mul(p, scalars[i % 3]) for i, p in enumerate(pts)]


def test_d_msm_through_the_point_ntt_matches_jax(pps, monkeypatch):
    """Both packages' threshold lowered to n = 8, so every king unpack
    (degree 2) runs the point NTT; the two d_msm results are equal, and
    equal to the clear MSM. The local MSMs take the tree MSM, as on the
    card at full size."""
    pp, jp = pps
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    monkeypatch.setattr(pss.PackedSharingParams, "_NTT_THRESHOLD", 8)
    monkeypatch.setattr(jpss.PackedSharingParams, "_NTT_THRESHOLD", 8)
    calls = []
    unpack = pointntt.unpackexp_ntt
    monkeypatch.setattr(pointntt, "unpackexp_ntt",
                        lambda *a: calls.append(a[3]) or unpack(*a))
    rng = np.random.default_rng(31)
    k = 4
    pts = _host_points("g1", rng, k)
    scalars = _ints(rng, k)
    # host in-exponent packing of the bases, chunk by chunk
    base_shares = [[rm.G1.msm(pts[c * L : (c + 1) * L], row)
                    for row in pp.pack_matrix] for c in range(k // L)]
    flat = [base_shares[c][i] for i in range(N) for c in range(k // L)]
    bases = g1().encode(flat, CPU).reshape(N, k // L, 3, 16)
    jbases = jg1().encode(flat).reshape(N, k // L, 3, 16)
    s_sh = pack_consecutive(pp, fr().encode(scalars, CPU))
    js_sh = jpack_consecutive(jp, jfr().encode(scalars))

    async def party(net, d):
        return await d_msm(g1(), d[0], d[1], pp, net)

    async def jparty(net, d):
        return await jd_msm(jg1(), d[0], d[1], jp, net)

    got = simulate_network_round(N, party, [(bases[i], s_sh[i])
                                            for i in range(N)])
    want = jax_round(N, jparty, [(jbases[i], js_sh[i]) for i in range(N)])
    assert calls == [True]  # one king unpack, degree 2, through the NTT
    assert g1().decode(got[0]) == jg1().decode(want[0]) == \
        rm.G1.msm(pts, scalars)


@pytest.fixture(scope="module")
def field_shares(pps):
    """Degree-2(t+l) product shares of two packed vectors, in both
    packages, and the clear products."""
    pp, jp = pps
    rng = np.random.default_rng(47)
    a, b = _ints(rng, 4 * L), _ints(rng, 4 * L)
    prod = [x * y % R for x, y in zip(a, b)]
    sa, sb = (pack_consecutive(pp, fr().encode(v, CPU)) for v in (a, b))
    ja, jb = (jpack_consecutive(jp, jfr().encode(v)) for v in (a, b))
    return fr().mul(sa, sb), jfr().mul(ja, jb), prod


def test_deg_red_matches_jax(pps, field_shares):
    pp, jp = pps
    sprod, jsprod, prod = field_shares

    async def party(net, s):
        return await deg_red(s, pp, net)

    async def jparty(net, s):
        return await jdeg_red(s, jp, net)

    got = simulate_network_round(N, party, [sprod[i] for i in range(N)])
    want = jax_round(N, jparty, [jsprod[i] for i in range(N)])
    for i in range(N):
        np.testing.assert_array_equal(_limbs(got[i]), _limbs(want[i]))
    clear = unpack_shares(pp, torch.stack(got))
    assert [int(v) for v in fr().decode(clear)] == prod


@pytest.mark.parametrize("case", ["random", "equal"])
def test_d_pp_matches_jax(pps, case):
    """Random num and den against the JAX package and the host prefix
    products; num = den = 1..m gives all ones (dpp_test.rs:25-26)."""
    pp, jp = pps
    m = 4 * L
    rng = np.random.default_rng(48)
    if case == "random":
        num, den = _ints(rng, m, 1), _ints(rng, m, 1)
    else:
        num = den = list(range(1, m + 1))
    want, acc = [], 1
    for x, y in zip(num, den):
        acc = acc * x * rm.finv(y, R) % R
        want.append(acc)
    sn, sd = (pack_consecutive(pp, fr().encode(v, CPU)) for v in (num, den))
    jn, jd = (jpack_consecutive(jp, jfr().encode(v)) for v in (num, den))

    async def party(net, d):
        return await d_pp(d[0], d[1], pp, net)

    async def jparty(net, d):
        return await jd_pp(d[0], d[1], jp, net)

    got = simulate_network_round(N, party, [(sn[i], sd[i]) for i in range(N)])
    jgot = jax_round(N, jparty, [(jn[i], jd[i]) for i in range(N)])
    for i in range(N):
        np.testing.assert_array_equal(_limbs(got[i]), _limbs(jgot[i]))
    clear = unpack_shares(pp, torch.stack(got))
    assert [int(v) for v in fr().decode(clear)] == want


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_point_ntt_on_the_card_matches_the_cpu(pps, which):
    """Kernels 1 and 2 inside the lane ladders and butterflies give the
    plain versions' limbs, so the card's packed points equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    pp, _ = pps
    curve = g1() if which == "g1" else g2()
    enc = curve.encode(_host_points(which, np.random.default_rng(8), 2 * L),
                       CPU)
    x = enc.reshape((2, L) + enc.shape[1:])
    want = pp.packexp_from_public(curve, x, method="ntt")
    got = pp.packexp_from_public(curve, x.cuda(), method="ntt")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
