"""Arkworks-style compressed point (de)serialization for the wire format.

The reference's service DTOs carry proofs as ark-serialize compressed bytes
(common/src/utils/serializer.rs ark_se/ark_de). Convention implemented here
(ark-serialize 0.4 short-Weierstrass compressed):

  * G1: 32 bytes — x little-endian, flags in the top 2 bits of the LAST
    byte. G2: 64 bytes — x = c0 || c1 little-endian, flags likewise.
  * flags: 0x40 = point at infinity (x serialized as 0);
           0x80 = y is the lexicographically "negative" (larger) root;
           0x00 = smaller root.
  * proof = a (G1) || b (G2) || c (G1) = 128 bytes.

Decompression recovers y by square root (BN254: q ≡ 3 mod 4, so
sqrt = x^((q+1)/4) in Fq; Fq2 via the complex-norm method) and picks the
root per the flag.
"""

from __future__ import annotations

from ..ops.constants import G1_B, G2_B, Q
from ..ops.refmath import fq2_mul, fq2_sq, fq2_add
from ..models.groth16.keys import Proof

_HALF = (Q - 1) // 2


def _is_neg(y: int) -> bool:
    """'negative' = the larger of {y, -y} (y > q/2)."""
    return y > _HALF


def _fq2_is_neg(y) -> bool:
    """Lexicographic on (c1, c0): larger root flagged."""
    c0, c1 = y
    if c1 != 0:
        return _is_neg(c1)
    return _is_neg(c0)


def _sqrt_fq(a: int) -> int | None:
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a else None


def _sqrt_fq2(a) -> tuple | None:
    a0, a1 = a[0] % Q, a[1] % Q
    if a1 == 0:
        r = _sqrt_fq(a0)
        if r is not None:
            return (r, 0)
        # sqrt of a non-residue lands in the u-axis: a0 = -(x1^2)
        r = _sqrt_fq((-a0) % Q)
        return None if r is None else (0, r)
    norm = (a0 * a0 + a1 * a1) % Q
    n = _sqrt_fq(norm)
    if n is None:
        return None
    inv2 = pow(2, Q - 2, Q)
    for sign in (1, -1):
        t = (a0 + sign * n) % Q * inv2 % Q
        x0 = _sqrt_fq(t)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0 % Q, Q - 2, Q) % Q
        if fq2_sq((x0, x1)) == (a0, a1):
            return (x0, x1)
    return None


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(32)
        out[-1] = 0x40
        return bytes(out)
    x, y = pt
    out = bytearray(int(x).to_bytes(32, "little"))
    if _is_neg(y):
        out[-1] |= 0x80
    return bytes(out)


def g1_from_bytes(b: bytes):
    assert len(b) == 32
    flags = b[31] & 0xC0
    x = int.from_bytes(bytes(b[:31]) + bytes([b[31] & 0x3F]), "little")
    if flags & 0x40:
        return None
    if x >= Q:
        raise ValueError("G1 x coordinate out of range")
    y2 = (pow(x, 3, Q) + G1_B) % Q
    y = _sqrt_fq(y2)
    if y is None:
        raise ValueError("not a point on G1")
    if bool(flags & 0x80) != _is_neg(y):
        y = (Q - y) % Q
    return (x, y)  # G1 cofactor is 1: on-curve == in-subgroup


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(64)
        out[-1] = 0x40
        return bytes(out)
    (x0, x1), y = pt
    out = bytearray(
        int(x0).to_bytes(32, "little") + int(x1).to_bytes(32, "little")
    )
    if _fq2_is_neg(y):
        out[-1] |= 0x80
    return bytes(out)


def g2_from_bytes(b: bytes):
    assert len(b) == 64
    flags = b[63] & 0xC0
    x0 = int.from_bytes(b[:32], "little")
    x1 = int.from_bytes(bytes(b[32:63]) + bytes([b[63] & 0x3F]), "little")
    if flags & 0x40:
        return None
    if x0 >= Q or x1 >= Q:
        raise ValueError("G2 x coordinate out of range")
    x = (x0, x1)
    y2 = fq2_add(fq2_mul(fq2_sq(x), x), G2_B)
    y = _sqrt_fq2(y2)
    if y is None:
        raise ValueError("not a point on G2")
    if bool(flags & 0x80) != _fq2_is_neg(y):
        y = ((Q - y[0]) % Q, (Q - y[1]) % Q)
    pt = (x, y)
    # BN254 G2 has a large cofactor: enforce the prime-order subgroup, as
    # the ark-serialize validated deserializer does
    from ..ops.refmath import G2 as _G2
    from ..ops.constants import R as _R

    if _G2.scalar_mul(pt, _R) is not None:
        raise ValueError("G2 point not in the prime-order subgroup")
    return pt


def proof_to_bytes(proof: Proof) -> bytes:
    return (
        g1_to_bytes(proof.a) + g2_to_bytes(proof.b) + g1_to_bytes(proof.c)
    )


def proof_from_bytes(b: bytes) -> Proof:
    assert len(b) == 128, f"proof must be 128 bytes, got {len(b)}"
    return Proof(
        a=g1_from_bytes(b[:32]),
        b=g2_from_bytes(b[32:96]),
        c=g1_from_bytes(b[96:128]),
    )
