"""BLS12-377 G1 for the PyTorch/CUDA port — the counterpart of
distributed_groth16_tpu/ops/bls12_377.py, the reference's distributed-MSM
curve (dist-primitives/examples/dmsm_bench.rs:1,48).

Every constant is DERIVED from the BLS12-377 seed at import and
self-checked (primality, curve membership, subgroup order):

    x  = 0x8508C00000000001                      (the BLS parameter)
    r  = x^4 - x^2 + 1                           (scalar field, 253 bits)
    q  = ((x - 1)^2 * r) / 3 + x                 (base field, 377 bits)
    G1 : y^2 = x^3 + 1 over Fq, cofactor (x-1)^2 / 3

The parameter derivation, the self-checks, the host ground truth and the
smallest-x generator are an exact copy of the JAX package's module (so
both packages pick the same generator). The device instances below are
the port's: Fq377 elements are int32 tensors of 24 16-bit limbs
(Montgomery radix 2^384), Fr377 elements 16 limbs, and the G1 MSM runs on
the 12-word kernels through ops/limb_kernels.lg1_377.
"""

from __future__ import annotations

import functools

from . import refmath as rm

# --------------------------------------------------------------------------
# parameter derivation from the seed
# --------------------------------------------------------------------------

X = 0x8508C00000000001
R377 = X**4 - X**2 + 1
Q377 = ((X - 1) ** 2 * R377) // 3 + X
G1_B377 = 1
G1_COFACTOR = (X - 1) ** 2 // 3

FR_TWO_ADICITY_377 = ((R377 - 1) & -(R377 - 1)).bit_length() - 1  # = 47


from .primemath import (
    factor as _factor,
    is_probable_prime as _is_probable_prime,
    smallest_generator,
    sqrt_mod,
)


@functools.cache
def _fr_generator() -> int:
    """Smallest multiplicative generator of Fr377 (arkworks convention).
    r-1 = x^2 (x-1)(x+1) factors through 64-bit integers."""
    return smallest_generator(
        R377, _factor(X) | _factor(X - 1) | _factor(X + 1)
    )


# --------------------------------------------------------------------------
# self-checks (import-time; cheap)
# --------------------------------------------------------------------------

assert R377.bit_length() == 253 and Q377.bit_length() == 377
assert ((X - 1) ** 2 * R377) % 3 == 0, "q derivation divisibility"
assert _is_probable_prime(R377), "r not prime"
assert _is_probable_prime(Q377), "q not prime"
# curve/group consistency: #E(Fq) = h * r = q + 1 - t with t = x + 1
assert G1_COFACTOR * R377 == Q377 + 1 - (X + 1), "Hasse/trace identity"
assert (R377 - 1) % (1 << FR_TWO_ADICITY_377) == 0


# --------------------------------------------------------------------------
# host ground truth
# --------------------------------------------------------------------------

G1_HOST = rm._CurveOps(
    add=lambda a, b: (a + b) % Q377,
    sub=lambda a, b: (a - b) % Q377,
    mul=lambda a, b: a * b % Q377,
    sq=lambda a: a * a % Q377,
    neg=lambda a: (-a) % Q377,
    inv=lambda a: rm.finv(a, Q377),
    scalar=lambda a, k: a * k % Q377,
    zero=0,
    one=1,
    b=G1_B377,
    order=R377,
)


def _sqrt_fq(a: int) -> int | None:
    """Square root in Fq377 (Tonelli-Shanks via primemath.sqrt_mod)."""
    return sqrt_mod(a, Q377)


@functools.cache
def g1_generator_377() -> tuple[int, int]:
    """Deterministic G1 generator: smallest x with x^3 + 1 square, smaller
    root, cofactor-cleared into the r-torsion."""
    gx = 0
    while True:
        rhs = (gx * gx * gx + G1_B377) % Q377
        y = _sqrt_fq(rhs)
        if y is not None:
            pt = G1_HOST.scalar_mul((gx, min(y, Q377 - y)), G1_COFACTOR)
            if pt is not None:
                assert G1_HOST.is_on_curve(pt)
                assert G1_HOST.scalar_mul(pt, R377) is None, "not r-torsion"
                return pt
        gx += 1


# --------------------------------------------------------------------------
# device instances (the port's)
# --------------------------------------------------------------------------


@functools.cache
def fq377():
    from .field import PrimeField

    return PrimeField(Q377)  # 24 limbs, Montgomery radix 2^384


@functools.cache
def fr377():
    from .field import PrimeField

    return PrimeField(R377)  # 16 limbs, the BN254 scalar layout


@functools.cache
def g1_377():
    """BLS12-377 G1 CurvePoints: fixed-scalar ladders reduce mod this
    curve's own r; MSMs route to ops/limb_kernels.lg1_377."""
    from .curve import CurvePoints

    nl = fq377().nl
    return CurvePoints(fq377(), G1_B377, (nl,), scalar_order=R377)


def encode_scalars_377(values, device=None):
    """Python ints -> (n, 16) standard-form int32 limbs mod r377 on
    `device` (None: CUDA)."""
    from .scalar_pack import encode_scalars

    return encode_scalars(values, R377, device)


# --------------------------------------------------------------------------
# Packed secret sharing over Fr377 — the reference's BLS12-377 d_msm
# configuration (dmsm_bench.rs:42-50 packs over BLS12-377 Fr)
# --------------------------------------------------------------------------


@functools.cache
def pss377(l: int):
    """PackedSharingParams over the BLS12-377 scalar field: host domains,
    pack/unpack matrices and the in-exponent ladders over r377. Device
    field-share transforms raise NotImplementedError; scalar shares come
    from pack_scalars_377."""
    from ..parallel.pss import PackedSharingParams

    return PackedSharingParams(l, modulus=R377, generator=_fr_generator())


def pack_scalars_377(pp, values, device=None):
    """Pack Fr377 secrets into n Montgomery share tensors (n, ceil(k/l), 16)
    on `device` (scalar_pack.pack_scalars; CONSECUTIVE chunking)."""
    from .scalar_pack import pack_scalars

    return pack_scalars(pp, values, fr377(), R377, device)
