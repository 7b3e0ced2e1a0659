"""The port's BLS12-377 and BLS12-381 configurations (ops/bls12_377.py,
ops/bls12_381.py, ops/scalar_pack.py of distributed_groth16_tpu_torch)
against the JAX package and the host ground truth, bit for bit (tolerance
zero throughout: these are integers):

  * 24-limb Fq377 / Fq381 and 17-limb Fr381 fields against the JAX
    PrimeField, limb for limb;
  * the 24-limb limb field and the G1 limb groups' plain add, doubling and
    Horner (the plain versions of the 12-word kernels 1-3) against the JAX
    LimbGroup XLA bodies, on redundant [0, 2p) inputs including 0, p - 1,
    p and 2p - 1;
  * the G2 limb group (lg2_381) against the host G2 law, as affine points
    (the JAX G2 limb path's XLA compile is marked slow in its own tests);
  * the Fr377 / Fr381 PSS matrices and scalar packs against the JAX
    package's, exactly; the in-exponent pack against the host;
  * d_msm over BLS12-377 G1 and BLS12-381 G1 (n = 8 parties, l = 2) as
    affine points against the host sum, with the small-MSM threshold
    lowered so that every local MSM takes the card's route (the tree MSM,
    c = 4: W = 64 windows for Fr377 shares and W = 68 for the 17-limb
    standard form of Fr381 shares through plain_horner).
"""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import bls12_377 as jb7
from distributed_groth16_tpu.ops import bls12_381 as jb8
from distributed_groth16_tpu.ops import limb_kernels as jlk
from distributed_groth16_tpu_torch.ops import bls12_377 as b7
from distributed_groth16_tpu_torch.ops import bls12_381 as b8
from distributed_groth16_tpu_torch.ops import limb_kernels as lk
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.parallel.dmsm import d_msm
from distributed_groth16_tpu_torch.parallel.net import simulate_network_round
from distributed_groth16_tpu_torch.parallel.pss import pack_host

torch.set_num_threads(1)

CPU = torch.device("cpu")
Q377, Q381, R377, R381 = b7.Q377, b8.Q381, b7.R377, b8.R381


def _t(x):
    return x.numpy().astype(np.int64)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _rand(rng, n, bound):
    return [int.from_bytes(rng.bytes(56), "little") % bound for _ in range(n)]


def test_generators_lie_in_the_r_torsion():
    """r G = infinity, with r not reduced mod r as the host scalar_mul
    would: the port's G1 and G2 generators have order r. The JAX
    package's G2 generator (its cofactor reduced mod r when cleared) does
    not, so the port derives its own (ROADMAP queue 3)."""
    mul = b8._mul_unreduced
    for host, gen, r in ((b7.G1_HOST, b7.g1_generator_377(), R377),
                         (b8.G1_HOST, b8.g1_generator_381(), R381),
                         (b8.G2_HOST, b8.g2_generator_381(), R381)):
        assert host.is_on_curve(gen) and mul(host, gen, r) is None
    assert b7.g1_generator_377() == jb7.g1_generator_377()
    assert b8.g1_generator_381() == jb8.g1_generator_381()
    jgen = jb8.g2_generator_381()
    assert b8.G2_HOST.is_on_curve(jgen)
    assert mul(b8.G2_HOST, jgen, R381) is not None


# -- row-major fields --------------------------------------------------------

FIELDS = {
    "fq377": (b7.fq377, jb7.fq377, 24),
    "fq381": (b8.fq381, jb8.fq381, 24),
    "fr381": (b8.fr381, jb8.fr381, 17),
    "fr377": (b7.fr377, jb7.fr377, 16),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_field_matches_jax_limb_for_limb(name):
    port_f, jax_f, nl = FIELDS[name]
    T, J = port_f(), jax_f()
    assert T.nl == J.nl == nl
    rng = np.random.default_rng(1)
    a = [0, 1, T.p - 1] + _rand(rng, 6, T.p)
    b = [T.p - 1, 0, 2] + _rand(rng, 6, T.p)
    ta, tb = T.encode(a, CPU), T.encode(b, CPU)
    ja, jb = J.encode(a), J.encode(b)
    np.testing.assert_array_equal(_t(ta), _np(ja))
    for op in ("mul", "add", "sub"):
        got, want = getattr(T, op)(ta, tb), getattr(J, op)(ja, jb)
        np.testing.assert_array_equal(_t(got), _np(want), err_msg=op)
    assert list(T.decode(T.mul(ta, tb))) == [x * y % T.p for x, y in zip(a, b)]
    np.testing.assert_array_equal(_t(T.from_mont(ta)), _np(J.from_mont(ja)))


def test_encode_scalars_matches_jax():
    rng = np.random.default_rng(2)
    for port_enc, jax_enc, r in ((b7.encode_scalars_377, jb7.encode_scalars_377,
                                  R377),
                                 (b8.encode_scalars_381, jb8.encode_scalars_381,
                                  R381)):
        vals = [0, r - 1, r, r + 5] + _rand(rng, 5, 1 << 300)
        got = port_enc(vals, CPU)
        assert got.dtype == torch.int32 and got.shape == (9, 16)
        np.testing.assert_array_equal(_t(got), _np(jax_enc(vals)))


# -- limb-major field and G1 groups (plain kernels 1-3) ------------------------


def _limb_major(vals, nl):
    buf = b"".join(int(v).to_bytes(2 * nl, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").astype(np.int32).reshape(
        len(vals), nl).T.copy()


def _redundant(p, n, seed):
    """Values in [0, 2p): the edges 0, 1, p - 1, p, p + 1, 2p - 1, then
    random ones."""
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1, p, p + 1, 2 * p - 1] + _rand(rng, n, 2 * p)


G1_GROUPS = {
    "g1_377": (lk.lg1_377, jlk.lg1_377, Q377),
    "g1_381": (lk.lg1_381, jlk.lg1_381, Q381),
}


@pytest.mark.parametrize("group", list(G1_GROUPS))
def test_limb_field_ops_match_jax(group):
    tg, jg, p = (f() if callable(f) else f for f in G1_GROUPS[group])
    T, J = tg.F, jg.F
    assert T.nl == J.nl == 24
    a = _limb_major(_redundant(p, 6, 3), 24)
    b = _limb_major(list(reversed(_redundant(p, 6, 4))), 24)
    ta, tb = torch.as_tensor(a).long(), torch.as_tensor(b).long()
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    want = {
        "mul": J.mul(ja, jb, J.p_col, unroll=False),
        "add": J.add(ja, jb, J.p2_col, unroll=False),
        "sub": J.sub(ja, jb, J.p2_col, unroll=False),
        "neg": J.neg(ja, J.p2_col, unroll=False),
        "canon": J.canon(ja),
    }
    got = {"mul": T.mul(ta, tb), "add": T.add(ta, tb), "sub": T.sub(ta, tb),
           "neg": T.neg(ta), "canon": T.canon(ta)}
    for op in want:
        np.testing.assert_array_equal(_t(got[op]), _np(want[op]), err_msg=op)


def _g1_points(group, n, seed):
    """(ROWS, n + 6) limb-major operands: points with redundant
    coordinates (sums of random multiples of the generator, infinity and a
    repeat), then six columns whose every coordinate is one of the edge
    values 0, 1, p - 1, p, p + 1, 2p - 1 (the formulas are field ops:
    both packages must agree on any limbs)."""
    tg = G1_GROUPS[group][0]()
    curve, host, gen = (
        (b7.g1_377(), b7.G1_HOST, b7.g1_generator_377()) if group == "g1_377"
        else (b8.g1_381(), b8.G1_HOST, b8.g1_generator_381())
    )
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**60)))
           for _ in range(n - 3)] + [None, gen, gen]
    lm = tg.from_rowmajor(curve.encode(pts, CPU))
    red = tg.plain_add(lm, torch.roll(lm, 1, dims=1))
    edges = torch.as_tensor(_limb_major(_redundant(tg.F.p, 0, 0), 24))
    edge_cols = torch.cat([edges, torch.roll(edges, 2, 1),
                           torch.roll(edges, 4, 1)], dim=0)
    return torch.cat([red, edge_cols], dim=1), torch.cat(
        [lm, torch.roll(edge_cols, 1, 1)], dim=1)


@pytest.mark.parametrize("group", list(G1_GROUPS))
def test_plain_g1_group_law_matches_jax_xla_body(group):
    tg, jg = G1_GROUPS[group][0](), G1_GROUPS[group][1]()
    red, other = _g1_points(group, 6, 5)
    jred, jother = _t(red).astype(np.uint32), _t(other).astype(np.uint32)
    np.testing.assert_array_equal(_t(tg.plain_add(red, other)),
                                  _np(jg._xla_add(jred, jother)))
    np.testing.assert_array_equal(_t(tg.plain_double(red)),
                                  _np(jg._xla_double(jred)))


def _jax_horner(jg, s, c):
    """The JAX horner_body's steps, driven from Python on 8 lanes (the
    XLA bodies of the test above are reused)."""
    W = s.shape[1]
    acc = np.broadcast_to(s[:, W - 1 : W], (s.shape[0], 8))
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = jg._xla_double(acc)
        acc = jg._xla_add(acc, np.broadcast_to(s[:, w : w + 1], acc.shape))
    return np.asarray(acc)[:, :1]


@pytest.mark.parametrize("group,c", [("g1_377", 8), ("g1_381", 4)])
def test_plain_horner_matches_jax(group, c):
    tg, jg = G1_GROUPS[group][0](), G1_GROUPS[group][1]()
    red, _ = _g1_points(group, 6, 6)
    s = red[:, [0, 3, 1, 7]].contiguous()  # a point, infinity, edge values
    got = tg.horner(s, c)
    want = _jax_horner(jg, _t(s).astype(np.uint32), c)
    np.testing.assert_array_equal(_t(got), _np(want))


def test_digits_of_a_17_limb_standard_form_match_jax():
    """Fr381 shares de-Montgomery to 17 limbs: 68 windows at c = 4, the
    top 17 all zero."""
    rng = np.random.default_rng(8)
    sc = b8.fr381().from_mont(b8.fr381().encode(_rand(rng, 5, R381), CPU))
    assert sc.shape == (5, 17)
    for c in (4, 8):
        got = lk._digits(sc, c)
        assert got.shape == (17 * 16 // c, 5)
        assert not got[16 * 16 // c :].any()
        np.testing.assert_array_equal(
            _t(got), _np(jlk._digits(_t(sc).astype(np.uint32), c)))


# -- G2 over Fq2 381 against the host law ----------------------------------


def _g2_setup(n, seed):
    C, host, gen = b8.g2_381(), b8.G2_HOST, b8.g2_generator_381()
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**60)))
           for _ in range(n - 3)] + [None, gen, gen]
    return C, host, pts


def _lm_decode(g, C, lm):
    return C.decode(g.to_rowmajor(lm))


def test_plain_g2_group_law_matches_host():
    g = lk.lg2_381()
    C, host, pts = _g2_setup(6, 9)
    lm = g.from_rowmajor(C.encode(pts, CPU))
    other = torch.roll(lm, 1, dims=1)
    red = g.plain_add(lm, other)  # redundant [0, 2p) coordinates
    want = [host.add(a, b) for a, b in zip(pts, pts[-1:] + pts[:-1])]
    assert _lm_decode(g, C, red) == want
    assert _lm_decode(g, C, g.plain_double(red)) == [host.double(p)
                                                     for p in want]
    again = g.plain_add(red, lm)
    assert _lm_decode(g, C, again) == [host.add(a, b)
                                       for a, b in zip(want, pts)]
    s = red[:, [0, 3, 4, 5]].contiguous()  # with infinity and gen + gen
    cols = [want[i] for i in (0, 3, 4, 5)]
    acc = None
    for w, col in enumerate(cols):
        acc = host.add(acc, host.scalar_mul(col, 1 << (4 * w)))
    assert _lm_decode(g, C, g.plain_horner(s, 4)) == [acc]


def test_g2_tree_msm_matches_host(monkeypatch):
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    C, host, pts = _g2_setup(6, 10)
    rng = np.random.default_rng(11)
    scs = _rand(rng, len(pts), R381)
    got = tmsm.msm(C, C.encode(pts, CPU), b8.encode_scalars_381(scs, CPU))
    assert C.decode(got) == host.msm(pts, scs)


# -- PSS over Fr377 / Fr381 and the scalar packs -----------------------------

CURVES = {
    "377": (b7, jb7, "377", R377),
    "381": (b8, jb8, "381", R381),
}


@pytest.mark.parametrize("curve", list(CURVES))
def test_pss_matrices_and_scalar_pack_match_jax(curve):
    mod, jmod, tag, r = CURVES[curve]
    pp, jp = getattr(mod, f"pss{tag}")(2), getattr(jmod, f"pss{tag}")(2)
    assert pp.modulus == r
    for m in ("pack_matrix", "unpack_matrix", "unpack2_matrix"):
        assert getattr(pp, m) == getattr(jp, m), m
    rng = np.random.default_rng(12)
    vals = _rand(rng, 7, r)  # odd: the tail chunk is zero-padded
    got = getattr(mod, f"pack_scalars_{tag}")(pp, vals, CPU)
    want = getattr(jmod, f"pack_scalars_{tag}")(jp, vals)
    assert tuple(got.shape) == (8, 4, 16 if tag == "377" else 17)
    np.testing.assert_array_equal(_t(got), _np(want))
    with pytest.raises(NotImplementedError, match="BN254-Fr-only"):
        pp.pack_from_public(torch.zeros((1, 2, 16), dtype=torch.int32))


def test_unknown_curve_has_no_limb_group():
    from distributed_groth16_tpu_torch.ops.curve import CurvePoints
    from distributed_groth16_tpu_torch.ops.field import PrimeField

    q = (1 << 255) - 19
    with pytest.raises(NotImplementedError, match="no limb group"):
        tmsm._limb_group_for(CurvePoints(PrimeField(q), 7, (16,)))


def test_packexp_over_fr377_matches_host():
    """The in-exponent pack of one chunk of l = 2 BLS12-377 points: the
    full 256-step ladder through ladder_apply (kernels 1 and 2's plain
    versions here), against pack_host over r377 in the exponent."""
    pp, C, host, gen = (b7.pss377(2), b7.g1_377(), b7.G1_HOST,
                        b7.g1_generator_377())
    ks = [123456789, R377 - 5]
    pts = [host.scalar_mul(gen, k) for k in ks]
    got = pp.packexp_from_public(C, C.encode(pts, CPU))
    assert C.decode(got) == [host.scalar_mul(gen, e)
                             for e in pack_host(pp, ks)]


# -- d_msm over the BLS curves ----------------------------------------------


@pytest.mark.parametrize("curve", list(CURVES))
def test_d_msm_matches_host(curve, monkeypatch):
    """d_msm over n = 8 parties (l = 2) at 8 points, all the generator as
    in the reference's dmsm_bench (so the result is (sum s_i) G): the base
    shares (sum_i M[j][i]) G are packed on the host (the device ladder is
    held above), the scalar shares by pack_scalars; every local MSM is a
    tree MSM (W = 64 for the 16-limb Fr377 standard form, 68 for Fr381's
    17 limbs) and the king's unpack a ladder_apply."""
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    mod, _, tag, r = CURVES[curve]
    pp = getattr(mod, f"pss{tag}")(2)
    C = getattr(mod, f"g1_{tag}")()
    host, gen = mod.G1_HOST, getattr(mod, f"g1_generator_{tag}")()
    fr = getattr(mod, f"fr{tag}")()
    k = 8
    scalars = _rand(np.random.default_rng(13), k, r)
    want = host.scalar_mul(gen, sum(scalars) % r)
    b_shares = [
        C.encode([host.scalar_mul(gen, sum(row) % r)], CPU).expand(
            (k // pp.l, 3) + C.elem_shape)
        for row in pp.pack_matrix
    ]
    s_shares = getattr(mod, f"pack_scalars_{tag}")(pp, scalars, CPU)

    async def party(net, d):
        return await d_msm(C, d[0], d[1], pp, net, scalar_field=fr)

    outs = simulate_network_round(
        pp.n, party, [(b_shares[i], s_shares[i]) for i in range(pp.n)])
    assert all(o is outs[0] for o in outs)
    assert C.decode(outs[0]) == want
