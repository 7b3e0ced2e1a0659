"""The registered perf-kernel cases — the real hot-path primitives; the
counterpart of the JAX package's telemetry/perf_kernels.py.

Each builder constructs one `KernelCase` for `telemetry/perf.py` on the
device it is given: setup (random scalars, distinct bases, twiddle/limb
layout) happens here, OUTSIDE the timed region. Device cases hand the
port's entry points themselves (`_msm_pippenger`, `msm_tree`,
`domain(n).fft`, `ntt_limb`, `fixed_base_mul`, `msm_batched`,
`ladder_apply`), so a case runs exactly the program the prover runs;
host cases (GLV decomposition, the Miller loop, scalar limb packing) are
pure-Python reference kernels timed for trend, not roofline.

The JAX package's 13 cases keep their names, sizes, quick sizes, units
and host flags, and draw their scalars from the same seeds (`_rng`,
`_rand_ints`), so the port's scalars are the JAX cases' scalars as
integers. One departure: the JAX `ntt_limb_*` cases draw raw 16-bit
limbs up to 2^256, more than 4r; the port's draw reduced values, which
is what kernel 4's contract covers. Seven cases are the port's own, so
that every hand-written kernel (each ops/_cuda.KERNELS counter) launches
in some case, each at the shape of a port path: the tree MSM on BN254
G2 and on BLS12-381 G1 and G2 (kernels 1 and 3), and ladder_apply at
the MPC path's point-route CRS pack (BN254 G1 and G2) and at the BLS12
d_msm king's unpack (BLS12-377 G1, BLS12-381 G2): kernels 1 and 2.

Every device case declares its `cost`, the work its inputs need (not the
most the kernel could do, nor the padded columns it launches over):
32-bit multiply-adds (telemetry/roofline.py: 4 nw^2 + nw a Montgomery
product, 14 products a G1 add, 9 a doubling, G2 three times that) and
the bytes of its inputs read once and its output written once. A
bucket-method MSM needs, per window with a nonzero digit, one add per
nonzero digit into its bucket and the running-sum combine up to the
highest occupied bucket, then the windows' Horner; a ladder one add per
set bit beyond the first of each scalar, one doubling per bit below the
highest set one of each base, and the sums of its outputs; an NTT n/2
log2 n products (and n more for the 1/n of an inverse domain
transform).

Sizes are log2(n). `sizes=` is the full (card-scale) sweep; `quick=` is
the smoke subset `benchgate --quick` and chip_smoke.py's phase 13 run.
"""

from __future__ import annotations

import numpy as np
import torch

from .perf import KernelCase, perf_kernel
from .roofline import FQ_MULS, imad_per_fq_mul


def _rng(log2n: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng(0xD616 + 257 * salt + log2n)


def _rand_ints(n: int, mod: int, rng: np.random.Generator) -> list[int]:
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(n)]


def _scalars_std(log2n: int, device, salt: int = 0):
    from ..ops.constants import R
    from ..ops.msm import encode_scalars_std

    n = 1 << log2n
    return encode_scalars_std(_rand_ints(n, R, _rng(log2n, salt)), device)


def _distinct_bases(which: str, log2n: int, device):
    """n DISTINCT random points k_i * G via one windowed fixed-base batch
    mul — setup-only, excluded from timing (an MSM over a broadcast
    generator flatters the memory system)."""
    from ..ops.fixedbase import fixed_base_mul

    return fixed_base_mul(which, _scalars_std(log2n, device, salt=1))


def _bls(name: str):
    """(row-major curve, limb group, host ops, generator, r) of a BLS12
    group: g1_377, g1_381 or g2_381."""
    from ..ops import bls12_377 as b7
    from ..ops import bls12_381 as b8
    from ..ops import limb_kernels as lk

    if name == "g1_377":
        return (b7.g1_377(), lk.lg1_377(), b7.G1_HOST, b7.g1_generator_377(),
                b7.R377)
    if name == "g1_381":
        return (b8.g1_381(), lk.lg1_381(), b8.G1_HOST, b8.g1_generator_381(),
                b8.R381)
    return (b8.g2_381(), lk.lg2_381(), b8.G2_HOST, b8.g2_generator_381(),
            b8.R381)


def _bls_points(name: str, n: int, device, seed: int, windows: int = 4):
    """n random points sum_w d_w 2^(8w) G (d_w random bytes) on a BLS12
    group, row-major canonical, from a host table of d 2^(8w) G and
    `windows` batched adds on the limb group (setup only)."""
    C, g, host, gen, _ = _bls(name)
    rows, bw = [], gen
    for _ in range(windows):
        row = [None, bw]
        for _ in range(254):
            row.append(host.add(row[-1], bw))
        rows.append(row)
        for _ in range(8):
            bw = host.double(bw)
    table = g.from_rowmajor(C.encode([p for r in rows for p in r], device))
    digits = np.random.default_rng(seed).integers(0, 256, size=(windows, n))
    acc = g.infinity(n, device)
    for w in range(windows):
        idx = torch.as_tensor(w * 256 + digits[w], device=device)
        acc = g.add(acc, table[:, idx])
    return g.to_rowmajor(acc)


# -- the work model ----------------------------------------------------------


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _cost(adds: int, doubles: int, nw: int, deg: int, *ts) -> dict:
    """cost of `adds` complete adds and `doubles` doublings on a group of
    nw-word base field and extension degree deg, moving the tensors ts
    once."""
    muls = (adds * FQ_MULS["add"] + doubles * FQ_MULS["double"]) * deg
    return {"flops": float(muls * imad_per_fq_mul(nw)),
            "bytes_accessed": float(_nbytes(*ts))}


def _bucket_ops(scalars_std, c: int) -> tuple[int, int]:
    """(adds, doubles) a bucket-method MSM over these standard-form
    scalars needs at c-bit windows: per window with a nonzero digit, one
    add per nonzero digit into its bucket beyond each bucket's first and
    the running-sum combine (occupied buckets - 1 adds into the running
    sum, highest occupied bucket - 1 into the total), then Horner over
    the windows up to the highest nonzero one: c doublings and one add a
    window."""
    from ..ops.limb_kernels import _digits

    d = _digits(scalars_std, c)  # (W, n)
    W, B = d.shape[0], 1 << c
    flat = (d + torch.arange(W, device=d.device)[:, None] * B).reshape(-1)
    counts = torch.bincount(flat, minlength=W * B).reshape(W, B)[:, 1:]
    nnz = counts.sum(1)
    occupied = counts > 0
    idx = torch.arange(1, B, device=d.device)
    top = torch.where(occupied, idx, 0).amax(1)
    live = nnz > 0
    adds = int(torch.where(live, nnz + top - 2, 0).sum())
    nwin = int(live.nonzero().max()) + 1 if bool(live.any()) else 0
    steps = max(nwin - 1, 0)
    return adds + steps, steps * c


def _ladder_ops(bits) -> tuple[int, int]:
    """(adds, doubles) of one row of ladder_apply: bits (o, K, nbits)
    0/1. Each (o, k) entry needs one add per set bit beyond its first,
    each base k a doubling per bit below its highest set one (over all
    o), and each output o the sum of its nonzero entries."""
    b = bits.long()
    pop = b.sum(-1)  # (o, K)
    adds = int((pop - 1).clamp(min=0).sum())
    adds += int(((pop > 0).sum(1) - 1).clamp(min=0).sum())
    pos = torch.arange(1, b.shape[-1] + 1, device=b.device)
    top = (b * pos).amax(-1).amax(0)  # (K,) highest set bit + 1
    return adds, int((top - 1).clamp(min=0).sum())


def _scalar_ladder_ops(scalars_std) -> tuple[int, int, int]:
    """(adds, doubles, nonzero) of a double-and-add over each standard-
    form scalar: popcount - 1 adds and bit length - 1 doublings each."""
    from ..ops.curve import scalar_bits

    b = scalar_bits(scalars_std).long().reshape(-1, 256)
    pop = b.sum(-1)
    top = (b * torch.arange(1, 257, device=b.device)).amax(-1)
    return (int((pop - 1).clamp(min=0).sum()),
            int((top - 1).clamp(min=0).sum()), int((pop > 0).sum()))


def _ntt_cost(n: int, x, extra_muls: int = 0) -> dict:
    """n/2 log2 n butterfly products over BN254 Fr (8 words), plus
    extra_muls, reading x and writing an output of x's size once."""
    muls = n // 2 * (n.bit_length() - 1) + extra_muls
    return {"flops": float(muls * imad_per_fq_mul(8)),
            "bytes_accessed": float(2 * _nbytes(x))}


# -- MSM ---------------------------------------------------------------------


def _msm_case(which: str, log2n: int, device) -> KernelCase:
    from ..ops.curve import g1, g2
    from ..ops.msm import _msm_pippenger

    n = 1 << log2n
    c = 16 if n >= (1 << 14) else 8
    curve = g1() if which == "g1" else g2()
    bases, scalars = (_distinct_bases(which, log2n, device),
                      _scalars_std(log2n, device))
    adds, dbls = _bucket_ops(scalars, c)
    out = torch.empty((3,) + curve.elem_shape, dtype=torch.int32)
    return KernelCase(
        _msm_pippenger, (curve, bases, scalars, c), n,
        _cost(adds, dbls, 8, 1 if which == "g1" else 3, bases, scalars, out),
    )


@perf_kernel("msm_g1", sizes=(12, 14, 16), quick=(8,),
             unit="scalar-muls/sec")
def _msm_g1(log2n: int, device) -> KernelCase:
    return _msm_case("g1", log2n, device)


@perf_kernel("msm_g2", sizes=(12, 14), quick=(8,), unit="scalar-muls/sec")
def _msm_g2(log2n: int, device) -> KernelCase:
    return _msm_case("g2", log2n, device)


def _tree_case(points, scalars, g, c: int | None) -> KernelCase:
    from ..ops.limb_kernels import msm_tree

    n = points.shape[0]
    cc = c if c is not None else (8 if n >= 4096 else 4)
    adds, dbls = _bucket_ops(scalars, cc)
    out = torch.empty((g.ROWS,), dtype=torch.int32)
    return KernelCase(
        msm_tree, (points, scalars, c, g), n,
        _cost(adds, dbls, g.nw, 3 if g.deg == 2 else 1, points, scalars,
              out),
    )


@perf_kernel("msm_g1_tree", sizes=(12, 16, 20), quick=(10,),
             unit="scalar-muls/sec")
def _msm_g1_tree(log2n: int, device) -> KernelCase:
    """The limb-major tree path (kernels 1 and 3) — the main path's MSM
    (runs as its bit-identical plain version on the CPU)."""
    from ..ops.limb_kernels import lg1

    return _tree_case(_distinct_bases("g1", log2n, device),
                      _scalars_std(log2n, device), lg1(), 8)


@perf_kernel("msm_g2_tree", sizes=(12, 15), quick=(8,),
             unit="scalar-muls/sec")
def _msm_g2_tree(log2n: int, device) -> KernelCase:
    """The tree MSM on BN254 G2 (kernels 1 and 3 at <8, 2>), as the main
    path's b_g2_query runs it (window width by size)."""
    from ..ops.limb_kernels import lg2

    return _tree_case(_distinct_bases("g2", log2n, device),
                      _scalars_std(log2n, device), lg2(), None)


def _tree_381_case(name: str, log2n: int, device) -> KernelCase:
    from ..ops.scalar_pack import encode_scalars

    _, g, _, _, r = _bls(name)
    n = 1 << log2n
    scalars = encode_scalars(_rand_ints(n, r, _rng(log2n, salt=7)), r,
                             device)
    return _tree_case(_bls_points(name, n, device, log2n), scalars, g, None)


@perf_kernel("msm_g1_381_tree", sizes=(16, 20), quick=(8,),
             unit="scalar-muls/sec")
def _msm_g1_381_tree(log2n: int, device) -> KernelCase:
    """The BLS12-381 G1 tree MSM (kernels 1 and 3 at 12 words), as the
    local BLS12-381 msm runs it."""
    return _tree_381_case("g1_381", log2n, device)


@perf_kernel("msm_g2_381_tree", sizes=(16, 20), quick=(8,),
             unit="scalar-muls/sec")
def _msm_g2_381_tree(log2n: int, device) -> KernelCase:
    """The BLS12-381 G2 tree MSM (kernels 1 and 3 at <12, 2>)."""
    return _tree_381_case("g2_381", log2n, device)


# -- ladders: the in-exponent PSS transforms ---------------------------------


def _ladder_case(group: str, which: str, log2n: int, device,
                 l: int = 2) -> KernelCase:
    """ladder_apply over B = 2^log2n rows of the named PSS matrix's
    ladder for n = 4l parties (parallel/pss.py `_apply_point_matrix`):
    bits (o, K, nbits), bases (ROWS, B, K) distinct random points."""
    from ..ops.limb_kernels import ladder_apply
    from ..ops.msm import _limb_group_for

    if group in ("g1", "g2"):
        from ..ops.curve import g1, g2
        from ..parallel.pss import pss

        curve, pp = (g1() if group == "g1" else g2()), pss(l)
    elif group == "g1_377":
        from ..ops.bls12_377 import pss377

        curve, pp = _bls(group)[0], pss377(l)
    else:
        from ..ops.bls12_381 import pss381

        curve, pp = _bls(group)[0], pss381(l)
    g = _limb_group_for(curve)
    bits, signs, nbits = pp._ladder_tensors(curve, which)
    o, K = bits.shape[:2]
    B = 1 << log2n
    if group in ("g1", "g2"):
        pts = _distinct_bases(group, (B * K - 1).bit_length(), device)
        pts = pts[: B * K]
    else:
        pts = _bls_points(group, B * K, device, log2n)
    lm = g.from_rowmajor(pts).reshape(g.ROWS, B, K)
    bits = bits.to(device)
    signs = None if signs is None else signs.to(device)
    adds, dbls = _ladder_ops(bits)
    out = torch.empty((g.ROWS, B, o), dtype=torch.int32)
    ts = (lm, bits, out) if signs is None else (lm, bits, signs, out)
    return KernelCase(
        ladder_apply, (g, lm, bits, signs, nbits), B * o,
        _cost(B * adds, B * dbls, g.nw, 3 if g.deg == 2 else 1, *ts),
    )


@perf_kernel("ladder_g1", sizes=(14,), quick=(8,), unit="points/sec")
def _ladder_g1(log2n: int, device) -> KernelCase:
    """The point-route CRS pack's ladder on BN254 G1 (kernels 1 and 2):
    2^14 chunks is h_query's at m = 2^15, l = 2 (8 outputs, 4 bases with
    GLV)."""
    return _ladder_case("g1", "pack", log2n, device)


@perf_kernel("ladder_g2", sizes=(14,), quick=(8,), unit="points/sec")
def _ladder_g2(log2n: int, device) -> KernelCase:
    """The same on BN254 G2 (2 bases, 256 bits; b_g2_query's 13,813
    chunks for the SHA-256 circuit, 2^14 here)."""
    return _ladder_case("g2", "pack", log2n, device)


@perf_kernel("ladder_g1_377", sizes=(0,), quick=(0,), unit="points/sec")
def _ladder_g1_377(log2n: int, device) -> KernelCase:
    """The BLS12-377 G1 d_msm king's unpack (degree 2; kernels 1 and 2 at
    12 words): 2^log2n d_msm results of n = 8 shares each."""
    return _ladder_case("g1_377", "unpack2", log2n, device)


@perf_kernel("ladder_g2_381", sizes=(0,), quick=(0,), unit="points/sec")
def _ladder_g2_381(log2n: int, device) -> KernelCase:
    """The BLS12-381 G2 d_msm king's unpack (kernels 1 and 2 at
    <12, 2>)."""
    return _ladder_case("g2_381", "unpack2", log2n, device)


# -- NTT ---------------------------------------------------------------------


def _fr_vector(log2n: int, device, salt: int = 2):
    from ..ops.constants import R
    from ..ops.field import fr

    n = 1 << log2n
    return fr().encode(_rand_ints(n, R, _rng(log2n, salt=salt)), device)


def _ntt_case(log2n: int, device, inverse: bool) -> KernelCase:
    from ..ops.ntt import domain

    n = 1 << log2n
    d = domain(n)
    x = _fr_vector(log2n, device)
    return KernelCase(d.ifft if inverse else d.fft, (x,), n,
                      _ntt_cost(n, x, n if inverse else 0))


@perf_kernel("ntt_fwd", sizes=(12, 15, 20), quick=(10,), unit="coeffs/sec")
def _ntt_fwd(log2n: int, device) -> KernelCase:
    return _ntt_case(log2n, device, inverse=False)


@perf_kernel("ntt_inv", sizes=(12, 15, 20), quick=(10,), unit="coeffs/sec")
def _ntt_inv(log2n: int, device) -> KernelCase:
    return _ntt_case(log2n, device, inverse=True)


def _limb_vector(log2n: int, device):
    """(16, n) limb-major Montgomery values below r (salt 3, as the JAX
    case's raw limbs)."""
    return _fr_vector(log2n, device, salt=3).t().contiguous()


def _ntt_limb_case(log2n: int, device, inverse: bool) -> KernelCase:
    from ..ops.ntt_limb import ntt_limb

    n = 1 << log2n
    x = _limb_vector(log2n, device)
    return KernelCase(ntt_limb, (x, n, inverse), n, _ntt_cost(n, x))


@perf_kernel("ntt_limb_fwd", sizes=(12, 15, 20), quick=(10,),
             unit="coeffs/sec")
def _ntt_limb_fwd(log2n: int, device) -> KernelCase:
    return _ntt_limb_case(log2n, device, inverse=False)


@perf_kernel("ntt_limb_inv", sizes=(12, 15, 20), quick=(10,),
             unit="coeffs/sec")
def _ntt_limb_inv(log2n: int, device) -> KernelCase:
    return _ntt_limb_case(log2n, device, inverse=True)


# -- fixed-base / setup ------------------------------------------------------


@perf_kernel("fixedbase_g1", sizes=(12, 15), quick=(10,),
             unit="scalar-muls/sec")
def _fixedbase_g1(log2n: int, device) -> KernelCase:
    """The setup's windowed fixed-base multiply (kernel 1): one add per
    nonzero window digit beyond a scalar's first, reading the generator
    table once."""
    from ..ops.fixedbase import _digits, fixed_base_mul, generator_table

    n = 1 << log2n
    scalars = _scalars_std(log2n, device)
    nz = (_digits(scalars) != 0).sum(1)
    adds = int((nz - 1).clamp(min=0).sum())
    out = torch.empty((n, 3, 16), dtype=torch.int32)
    return KernelCase(
        fixed_base_mul, ("g1", scalars), n,
        _cost(adds, 0, 8, 1, scalars, generator_table("g1", device), out),
    )


# -- host reference kernels --------------------------------------------------


@perf_kernel("glv_decompose", sizes=(12,), quick=(10,), unit="scalars/sec",
             host=True)
def _glv_decompose(log2n: int, device) -> KernelCase:
    from ..ops.constants import R
    from ..ops.glv import bn254_g1_glv

    n = 1 << log2n
    params = bn254_g1_glv()  # precompute (lattice basis) outside timing
    ks = _rand_ints(n, R, _rng(log2n, salt=4))

    def run():
        for k in ks:
            params.decompose(k)

    return KernelCase(run, (), n)


@perf_kernel("pairing_miller_loop", sizes=(0,), quick=(0,),
             unit="pairings/sec", host=True)
def _pairing_miller_loop(log2n: int, device) -> KernelCase:
    from ..ops.constants import G1_GENERATOR, G2_GENERATOR
    from ..ops.pairing import miller_loop

    def run():
        miller_loop(G2_GENERATOR, G1_GENERATOR)

    return KernelCase(run, (), 1)


@perf_kernel("verify_prepare_inputs", sizes=(6, 8), quick=(4,),
             unit="proofs/sec")
def _verify_prepare_inputs(log2n: int, device) -> KernelCase:
    """The verification plane's device half: B proofs' public-input MSMs
    over one broadcast gamma_abc row as a single batched call — the shape
    PvkCache + prepare_inputs_batched run (the plain batched ladder on
    the card; no kernel of ours)."""
    from ..ops.constants import R
    from ..ops.curve import g1
    from ..ops.msm import encode_scalars_std, msm_batched

    b = 1 << log2n
    n_inputs = 16  # gamma_abc rows per proof (1 + public inputs)
    row = _distinct_bases("g1", 4, device)  # (16, 3) + elem
    bases = row.expand((b,) + row.shape)
    rng = _rng(log2n, salt=6)
    scalars = torch.stack(
        [
            encode_scalars_std(_rand_ints(n_inputs, R, rng), device)
            for _ in range(b)
        ]
    )
    adds, dbls, nonzero = _scalar_ladder_ops(scalars)
    adds += max(nonzero - b, 0)  # each proof's sum of its nonzero terms
    out = torch.empty((b, 3, 16), dtype=torch.int32)
    return KernelCase(msm_batched, (g1(), bases, scalars), b,
                      _cost(adds, dbls, 8, 1, row, scalars, out))


@perf_kernel("verify_fold_miller", sizes=(2,), quick=(0,),
             unit="proofs/sec", host=True)
def _verify_fold_miller(log2n: int, device) -> KernelCase:
    """The folded batch-verification equation: ONE multi-pairing of n+3
    Miller loops + one final exponentiation covers n proofs — vs 4n
    loops checked one by one. Generator pairs stand in for real proofs:
    the Miller loop cost does not depend on the points."""
    from ..ops.constants import G1_GENERATOR, G2_GENERATOR
    from ..ops.pairing import multi_pairing

    n = 1 << log2n
    pairs = [(G2_GENERATOR, G1_GENERATOR)] * (n + 3)

    def run():
        multi_pairing(pairs)

    return KernelCase(run, (), n)


@perf_kernel("scalar_pack", sizes=(14,), quick=(12,), unit="scalars/sec",
             host=True)
def _scalar_pack(log2n: int, device) -> KernelCase:
    """Host-side limb conversion (int -> (n, 16) standard-form int32 on
    the run's device): the per-job scalar packing tax every submission
    pays before any kernel."""
    from ..ops.constants import R
    from ..ops.msm import encode_scalars_std

    n = 1 << log2n
    vals = _rand_ints(n, R, _rng(log2n, salt=5))

    def run():
        encode_scalars_std(vals, device)

    return KernelCase(run, (), n)
