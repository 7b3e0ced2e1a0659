"""BLS12-381 G1/G2 for the PyTorch/CUDA port — the counterpart of
distributed_groth16_tpu/ops/bls12_381.py (BASELINE config 5: G1/G2 MSM
with packed secret sharing).

Every constant is DERIVED from the BLS seed at import and self-checked:

    x  = -0xD201000000010000                     (the BLS parameter, negative)
    r  = x^4 - x^2 + 1                           (scalar field, 255 bits,
                                                  two-adicity 32)
    q  = ((x - 1)^2 * r) / 3 + x                 (base field, 381 bits)
    G1 : y^2 = x^3 + 4         over Fq,  cofactor (x-1)^2 / 3
    G2 : y^2 = x^3 + 4(1 + u)  over Fq2 = Fq[u]/(u^2+1)

The parameter derivation, the self-checks, the host ground truth and the
smallest-x G1 generator are an exact copy of the JAX package's module;
the G2 generator follows the same convention but clears the cofactor
without reducing it mod r, which the JAX package's does (see
g2_generator_381), so that it lies in G2. The
device instances below are the port's: base-field elements are int32
tensors of 24 16-bit limbs (radix 2^384); Fr381 Montgomery elements take
17 limbs (radix 2^272: the 255-bit r needs 4r below the radix), while
STANDARD-form scalars from encode_scalars_381 fit 16 limbs. A 17-limb
standard form (from_mont of an Fr381 share) is accepted too: the tree
MSM's digits are width-aware. G1 and G2 MSMs run on the 12-word kernels
through ops/limb_kernels.lg1_381 / lg2_381.
"""

from __future__ import annotations

import functools

from . import refmath as rm
from .primemath import (
    factor,
    fq2_inv,
    fq2_mul,
    is_probable_prime,
    smallest_generator,
    sqrt_mod,
)

# --------------------------------------------------------------------------
# parameter derivation from the seed
# --------------------------------------------------------------------------

X = -0xD201000000010000
R381 = X**4 - X**2 + 1
Q381 = ((X - 1) ** 2 * R381) // 3 + X
G1_B381 = 4
G2_B381 = (4, 4)  # 4 * (1 + u)
G1_COFACTOR = (X - 1) ** 2 // 3
# standard G2 cofactor: (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13)/9
G2_COFACTOR = (
    X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13
) // 9

FR_TWO_ADICITY_381 = ((R381 - 1) & -(R381 - 1)).bit_length() - 1  # = 32


@functools.cache
def _fr_generator() -> int:
    """Smallest multiplicative generator of Fr381: r-1 = x^2 (x-1)(x+1)
    factors through |x|-sized integers."""
    return smallest_generator(
        R381, factor(-X) | factor(abs(X - 1)) | factor(abs(X + 1))
    )


# --------------------------------------------------------------------------
# self-checks (import-time; cheap)
# --------------------------------------------------------------------------

assert R381.bit_length() == 255 and Q381.bit_length() == 381
assert ((X - 1) ** 2 * R381) % 3 == 0, "q derivation divisibility"
assert is_probable_prime(R381), "r not prime"
assert is_probable_prime(Q381), "q not prime"
assert Q381 % 4 == 3, "fast sqrt + u^2=-1 tower assumption"
# curve/group consistency: #E(Fq) = h * r = q + 1 - t with t = x + 1
assert G1_COFACTOR * R381 == Q381 + 1 - (X + 1), "Hasse/trace identity"
assert (R381 - 1) % (1 << FR_TWO_ADICITY_381) == 0
assert FR_TWO_ADICITY_381 >= 25, "2^24 product domains must fit"


# --------------------------------------------------------------------------
# host ground truth
# --------------------------------------------------------------------------

G1_HOST = rm._CurveOps(
    add=lambda a, b: (a + b) % Q381,
    sub=lambda a, b: (a - b) % Q381,
    mul=lambda a, b: a * b % Q381,
    sq=lambda a: a * a % Q381,
    neg=lambda a: (-a) % Q381,
    inv=lambda a: rm.finv(a, Q381),
    scalar=lambda a, k: a * k % Q381,
    zero=0,
    one=1,
    b=G1_B381,
    order=R381,
)


def _f2_add(a, b):
    return ((a[0] + b[0]) % Q381, (a[1] + b[1]) % Q381)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % Q381, (a[1] - b[1]) % Q381)


def _f2_mul(a, b):
    return fq2_mul(a, b, Q381)


def _f2_inv(a):
    return fq2_inv(a, Q381)


G2_HOST = rm._CurveOps(
    add=_f2_add,
    sub=_f2_sub,
    mul=_f2_mul,
    sq=lambda a: _f2_mul(a, a),
    neg=lambda a: ((-a[0]) % Q381, (-a[1]) % Q381),
    inv=_f2_inv,
    scalar=lambda a, k: (a[0] * k % Q381, a[1] * k % Q381),
    zero=(0, 0),
    one=(1, 0),
    b=G2_B381,
    order=R381,
)


def _sqrt_fq2(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) (q ≡ 3 mod 4 method)."""
    a0, a1 = a[0] % Q381, a[1] % Q381
    if a1 == 0:
        s = sqrt_mod(a0, Q381)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue: sqrt is purely imaginary, (0, t) with
        # t^2 = -a0
        t = sqrt_mod((-a0) % Q381, Q381)
        return None if t is None else (0, t)
    n = sqrt_mod((a0 * a0 + a1 * a1) % Q381, Q381)
    if n is None:
        return None
    inv2 = rm.finv(2, Q381)
    for sign in (1, -1):
        x0sq = (a0 + sign * n) % Q381 * inv2 % Q381
        x0 = sqrt_mod(x0sq, Q381)
        if x0 is not None and x0 != 0:
            x1 = a1 * rm.finv(2 * x0 % Q381, Q381) % Q381
            if _f2_mul((x0, x1), (x0, x1)) == (a0, a1):
                return (x0, x1)
    return None


@functools.cache
def g1_generator_381() -> tuple[int, int]:
    """Deterministic G1 generator: smallest x with x^3 + 4 square, smaller
    root, cofactor-cleared into the r-torsion."""
    gx = 0
    while True:
        rhs = (gx * gx * gx + G1_B381) % Q381
        y = sqrt_mod(rhs, Q381)
        if y is not None:
            pt = G1_HOST.scalar_mul((gx, min(y, Q381 - y)), G1_COFACTOR)
            if pt is not None:
                assert G1_HOST.is_on_curve(pt)
                assert G1_HOST.scalar_mul(pt, R381) is None, "not r-torsion"
                return pt
        gx += 1


def _mul_unreduced(ops, p, k: int):
    """k p by double-and-add with k NOT reduced mod the group order
    (ops.scalar_mul reduces k mod r first, which turns the G2 cofactor h2
    into h2 mod r, and r itself into 0)."""
    acc, base = None, p
    while k:
        if k & 1:
            acc = ops.add(acc, base)
        base = ops.double(base)
        k >>= 1
    return acc


@functools.cache
def g2_generator_381():
    """Deterministic G2 generator: smallest x = (k, 1) with a square RHS,
    cofactor-cleared into the r-torsion.

    Not a copy of the JAX package's function: there G2_HOST.scalar_mul
    clears the cofactor, and it reduces h2 mod r (h2 is 508 bits), so that
    point lies outside the r-torsion, and its check r pt = infinity holds
    for any point (r mod r = 0). Here the same raw point is multiplied by
    h2 itself, and r pt = infinity is checked without the reduction."""
    k = 0
    while True:
        x = (k, 1)
        rhs = _f2_add(_f2_mul(_f2_mul(x, x), x), G2_B381)
        y = _sqrt_fq2(rhs)
        if y is not None:
            pt = _mul_unreduced(G2_HOST, (x, y), G2_COFACTOR)
            if pt is not None:
                assert G2_HOST.is_on_curve(pt)
                assert _mul_unreduced(G2_HOST, pt, R381) is None, (
                    "not r-torsion")
                return pt
        k += 1


# --------------------------------------------------------------------------
# device instances (the port's)
# --------------------------------------------------------------------------


@functools.cache
def fq381():
    from .field import PrimeField

    return PrimeField(Q381)  # 24 limbs, Montgomery radix 2^384


@functools.cache
def fr381():
    from .field import PrimeField

    return PrimeField(R381)  # 17 limbs (radix 2^272): 4r < radix


@functools.cache
def fq2_381():
    from .field import Fq2Ops

    return Fq2Ops(fq381())  # u^2 = -1 tower (Q381 = 3 mod 4)


@functools.cache
def g1_381():
    from .curve import CurvePoints

    nl = fq381().nl
    return CurvePoints(fq381(), G1_B381, (nl,), scalar_order=R381)


@functools.cache
def g2_381():
    from .curve import CurvePoints

    nl = fq381().nl
    return CurvePoints(fq2_381(), G2_B381, (2, nl), scalar_order=R381)


def encode_scalars_381(values, device=None):
    """Python ints -> (n, 16) standard-form int32 limbs mod r381 on
    `device` (None: CUDA)."""
    from .scalar_pack import encode_scalars

    return encode_scalars(values, R381, device)


@functools.cache
def pss381(l: int):
    """PackedSharingParams over the BLS12-381 scalar field (host domains
    and in-exponent ladders; device field-share transforms raise, as for
    pss377)."""
    from ..parallel.pss import PackedSharingParams

    return PackedSharingParams(l, modulus=R381, generator=_fr_generator())


def pack_scalars_381(pp, values, device=None):
    """Pack Fr381 secrets into n Montgomery share tensors (n, ceil(k/l), 17)
    on `device` (scalar_pack.pack_scalars over the 17-limb Fr381;
    CONSECUTIVE chunking)."""
    from .scalar_pack import pack_scalars

    return pack_scalars(pp, values, fr381(), R381, device)
