"""The port's limb-major arithmetic and tree MSM (ops/limb_kernels.py of
distributed_groth16_tpu_torch) against the JAX package's XLA bodies — the
same functions its Pallas kernels compile — limb for limb on redundant
[0, 2p) inputs, plus kernels 1-3 against their plain versions on a card
(skipped without one): kernel 1 on msm_tree's strided pair halves and on a
broadcast column, kernel 2 at ragged widths, on a strided view and at the
MPC ladder's widest doubling, Horner at W in {2, 3, 32, 64} and c in
{4, 8} on window sums with infinity, equal columns and a final P + P."""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import curve as jcurve
from distributed_groth16_tpu.ops import limb_kernels as jlk
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, G2_GENERATOR, Q, R
from distributed_groth16_tpu.ops.msm import encode_scalars_std as j_scalars
from distributed_groth16_tpu_torch.ops import curve as tcurve
from distributed_groth16_tpu_torch.ops import limb_kernels as tlk

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.numpy().astype(np.int64)


def _limb_major(vals, nl=16):
    """ints -> (nl, n) int32 limbs, values as given (may be redundant)."""
    buf = b"".join(int(v).to_bytes(2 * nl, "little") for v in vals)
    limbs = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return limbs.reshape(len(vals), nl).T.copy()


def _redundant(n, seed):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(40), "little") % (2 * Q) for _ in range(n)]
    return [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1] + rand


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg", "canon"])
def test_limb_field_matches_jax(op):
    J, T = jlk.lfq(), tlk.lfq()
    a = _limb_major(_redundant(9, 1))
    b = _limb_major(list(reversed(_redundant(9, 2))))
    ta, tb = torch.as_tensor(a).long(), torch.as_tensor(b).long()
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    p, p2 = J.p_col, J.p2_col
    want = {
        "mul": lambda: J.mul(ja, jb, p, unroll=False),
        "add": lambda: J.add(ja, jb, p2, unroll=False),
        "sub": lambda: J.sub(ja, jb, p2, unroll=False),
        "neg": lambda: J.neg(ja, p2, unroll=False),
        "canon": lambda: J.canon(ja),
    }[op]()
    got = getattr(T, op)(ta, tb) if op in ("mul", "add", "sub") else (
        getattr(T, op)(ta)
    )
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_limb_fq2_matches_jax(op):
    J, T = jlk.lfq2(), tlk.lfq2()
    a = np.concatenate([_limb_major(_redundant(5, 3)),
                        _limb_major(_redundant(5, 4))])
    b = np.concatenate([_limb_major(_redundant(5, 5)),
                        _limb_major(_redundant(5, 6))])
    jops = dict(zip(("mul", "add", "sub"),
                    J.make_ops(J.p_col, J.p2_col, unroll=False)))
    tops = dict(zip(("mul", "add", "sub"), T.make_ops()))
    want = jops[op](a.astype(np.uint32), b.astype(np.uint32))
    got = tops[op](torch.as_tensor(a).long(), torch.as_tensor(b).long())
    np.testing.assert_array_equal(_t(got), _np(want))


def _groups(group):
    if group == "g1":
        return jlk.lg1(), tlk.lg1(), jcurve.g1(), rm.G1, G1_GENERATOR
    return jlk.lg2(), tlk.lg2(), jcurve.g2(), rm.G2, G2_GENERATOR


def _lm_points(group, n, seed):
    """Limb-major points with redundant coordinates: sums of random
    multiples of the generator, plus infinity and a repeated point."""
    jg, _, C, host, gen = _groups(group)
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**62))) for _ in range(n)]
    pts += [None, gen, gen]
    lm = jg.from_rowmajor(C.encode(pts))
    shifted = _roll(lm)
    return np.asarray(jg._xla_add(lm, shifted)), np.asarray(lm)


def _roll(x):
    return np.roll(np.asarray(x), 1, axis=1)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", ["add", "double"])
def test_plain_group_law_matches_jax_xla_body(group, op):
    jg, tg = _groups(group)[:2]
    red, canon = _lm_points(group, 5, 7)
    t_red = torch.as_tensor(red.astype(np.int32))
    t_canon = torch.as_tensor(canon.astype(np.int32))
    if op == "add":
        want = jg._xla_add(red, canon)
        got = tg.add(t_red, t_canon)
    else:
        want = jg._xla_double(red)
        got = tg.double(t_red)
    np.testing.assert_array_equal(_t(got), _np(want))


def _jax_horner(jg, s, c):
    """The JAX package's horner_body, step for step, driven from Python:
    its fori loop over W-1 windows of c doublings and one add, on the
    point broadcast across 8 lanes like the TPU kernel's 128 (so the XLA
    bodies compiled for the tests above are reused)."""
    W = s.shape[1]
    acc = np.broadcast_to(s[:, W - 1 : W], (s.shape[0], 8))
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = jg._xla_double(acc)
        acc = jg._xla_add(acc, np.broadcast_to(s[:, w : w + 1], acc.shape))
    return np.asarray(acc)[:, :1]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("c", [4, 8])
def test_plain_horner_matches_jax(group, c):
    jg, tg = _groups(group)[:2]
    red, _ = _lm_points(group, 5, 8 + c)
    s = np.ascontiguousarray(red[:, :4])  # (ROWS, 4) window sums
    got = tg.horner(torch.as_tensor(s.astype(np.int32)), c)
    np.testing.assert_array_equal(_t(got), _np(_jax_horner(jg, s, c)))
    if group == "g1" and c == 4:  # and the JAX package's own fori kernel
        np.testing.assert_array_equal(_t(got), _np(jg.horner(s, c)))


def test_digits_match_jax():
    rng = np.random.default_rng(9)
    vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(7)]
    sc = j_scalars(vals)
    for c in (4, 8):
        got = tlk._digits(torch.as_tensor(np.asarray(sc).astype(np.int32)), c)
        np.testing.assert_array_equal(_t(got), _np(jlk._digits(sc, c)))


@pytest.mark.parametrize("group,n", [("g1", 20), ("g2", 9)])
def test_msm_tree_matches_host(group, n):
    """Compared with the pure-bigint MSM, the ground truth the JAX
    package's msm_tree is held to by its own tests (its XLA build of the
    whole tree compiles for 40 s (G1) to 6 min (G2) on a CPU, too long to
    repeat here)."""
    _, _, C, host, gen = _groups(group)
    T = tcurve.g1() if group == "g1" else tcurve.g2()
    rng = np.random.default_rng(10)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**61))) for _ in range(n)]
    scs = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
    P, sc = C.encode(pts), j_scalars(scs)
    got = tlk.msm_tree(
        torch.as_tensor(np.asarray(P).astype(np.int32)),
        torch.as_tensor(np.asarray(sc).astype(np.int32)),
    )
    assert T.decode(got) == host.msm(pts, scs)


# -- kernels 1-3 on a card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _window_sums(tg, red, W, c):
    """(ROWS, W) window sums for Horner: redundant [0, 2p) limbs; for
    W >= 3 the top column is infinity (the combine starts there); for
    W >= 4 two equal columns; and S_0 = 2^c S_1, so that the last add
    meets P + P."""
    s = red[:, torch.arange(W) % red.shape[1]].clone()
    if W >= 3:
        s[:, W - 1] = torch.as_tensor(tg.inf_col[:, 0])
    if W >= 4:
        s[:, 2] = s[:, 3]
    col = s[:, 1:2]
    for _ in range(c):
        col = tg.plain_double(col)
    s[:, 0:1] = col
    return s


KERNEL_CASES = (
    ["add", "add_pair_halves", "add_broadcast_q", "double", "horner",
     "horner_W65_raises"]
    + [f"horner_W{W}_c{c}" for W in (2, 3, 32, 64) for c in (4, 8)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", KERNEL_CASES)
def test_kernel_matches_plain_version(cuda, group, op):
    _, tg = _groups(group)[:2]
    red, canon = _lm_points(group, 300, 11)
    a = torch.as_tensor(red.astype(np.int32), device=cuda)
    b = torch.as_tensor(canon.astype(np.int32), device=cuda)
    RR = tg.ROWS
    if op == "add":
        got, want = tg.add(a, b), tg.plain_add(a, b)
    elif op == "add_pair_halves":  # msm_tree's strided views, no copies
        pair = a[:, :256].reshape(RR, 4, 32, 2)
        got = tg.add(pair[..., 0], pair[..., 1])
        want = tg.plain_add(pair[..., 0], pair[..., 1])
    elif op == "add_broadcast_q":  # one q column broadcast over p
        got, want = tg.add(a, b[:, 5:6]), tg.plain_add(a, b[:, 5:6])
    elif op == "double":
        got, want = tg.double(a), tg.plain_double(a)
    elif op == "horner":
        got, want = tg.horner(a[:, :32], 8), tg.plain_horner(a[:, :32], 8)
    elif op == "horner_W65_raises":  # more window sums than it stages
        with pytest.raises(ValueError, match="W <= 64"):
            tg.horner(a[:, :65], 4)
        return
    else:
        W, c = (int(v[1:]) for v in op.split("_")[1:])
        s = _window_sums(tg, a, W, c)
        got, want = tg.horner(s, c), tg.plain_horner(s, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# kernel 2 gives a point a lane in each of a block's three warps, 32 points
# a block: widths that leave warps and blocks partly idle
DOUBLE_WIDTHS = [1, 2, 3, 4, 5, 9, 33, 4097]
# ladder_apply's widest doubling when the CRS pack of SHA-256 (m = 2^15,
# l = 2) runs on the card: h_query's B*K on G1, b_g2_query's on G2
LADDER_DOUBLE = {"g1": 65536, "g2": 27626}


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("width", DOUBLE_WIDTHS + ["strided", "ladder"])
def test_double_kernel_matches_plain_version(cuda, group, width):
    """Kernel 2 on redundant coordinates with infinity in every third
    column: at ragged widths, on every other column of a batch (column
    stride 2) and at the ladder's widest doubling."""
    _, tg = _groups(group)[:2]
    red, _ = _lm_points(group, 300, 11)
    n = {"strided": 2 * 4097, "ladder": LADDER_DOUBLE[group]}.get(width, width)
    a = torch.as_tensor(red.astype(np.int32), device=cuda)
    a = a[:, torch.arange(n, device=cuda) % a.shape[1]]
    a[:, 1::3] = torch.as_tensor(tg.inf_col, device=cuda)
    if width == "strided":
        a = a[:, ::2]
    got, want = tg.double(a), tg.plain_double(a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
