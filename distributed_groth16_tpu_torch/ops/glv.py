"""GLV scalar decomposition for BN254 G1 — host-side precomputation.

The in-the-exponent PSS transforms (parallel/pss.py) and the point-domain
NTT apply FIXED Fr scalars to runtime curve points. A straight double-and-
add ladder costs 256 sequential point-add rounds; BN254 G1 carries the GLV
endomorphism phi(x, y) = (beta*x, y) with phi(P) = lambda*P (beta a cube
root of unity in Fq, lambda the matching cube root of unity mod r), so any
scalar k splits as k = k1 + k2*lambda with |k1|, |k2| ~ sqrt(r) ~ 2^128.
The ladder then runs over the doubled base set {P, phi(P)} at HALF the
sequential depth — the dominant latency of every unpackexp king step.

All of this is host-side integer math executed once per (matrix, domain);
nothing here runs on device. The reference delegates the same role to
arkworks' glv-lattice-basis precomputation inside ark-ec (consumed via
G::msm in dist-primitives/src/dmsm/mod.rs:82); here the decomposition is
derived from first principles (Tonelli–Shanks for the cube roots, the
classic GLV extended-Euclid lattice basis) and verified against the host
curve at import time.
"""

from __future__ import annotations

import functools
import math

from .constants import G1_GENERATOR, Q, R


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks square root mod an odd prime p (None if non-residue)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # write p-1 = q * 2^s with q odd
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue z
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r_ = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i with t^(2^i) = 1
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r_ = t * c % p, r_ * b % p
    return r_


def _cube_roots_of_unity(p: int) -> tuple[int, int]:
    """The two primitive cube roots of unity mod p (roots of x^2 + x + 1)."""
    s = sqrt_mod(p - 3, p)
    assert s is not None, "p = 1 mod 3 required"
    inv2 = pow(2, p - 2, p)
    r1 = (s - 1) * inv2 % p
    r2 = (-s - 1) * inv2 % p
    for r_ in (r1, r2):
        assert (r_ * r_ + r_ + 1) % p == 0
    return r1, r2


def _glv_basis(n: int, lam: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Two short vectors spanning the lattice {(x, y) : x + y*lam = 0 mod n}.

    Classic GLV (Gallant–Lambert–Vanstone 2001) half-GCD construction: run
    the extended Euclidean algorithm on (n, lam); every remainder r_i
    satisfies r_i = s_i*n + t_i*lam, i.e. (r_i, -t_i) is a lattice vector;
    stop around sqrt(n) where both components are ~sqrt(n)."""
    sqrt_n = math.isqrt(n)
    rs = [n, lam]
    ts = [0, 1]
    while rs[-1] != 0:
        q_ = rs[-2] // rs[-1]
        rs.append(rs[-2] - q_ * rs[-1])
        ts.append(ts[-2] - q_ * ts[-1])
    # index l: last remainder >= sqrt(n)
    l_idx = max(i for i, r_ in enumerate(rs) if r_ >= sqrt_n)
    v1 = (rs[l_idx + 1], -ts[l_idx + 1])
    c1 = (rs[l_idx], -ts[l_idx])
    c2 = (rs[l_idx + 2], -ts[l_idx + 2]) if l_idx + 2 < len(rs) else c1
    v2 = c1 if c1[0] ** 2 + c1[1] ** 2 <= c2[0] ** 2 + c2[1] ** 2 else c2
    for a, b in (v1, v2):
        assert (a + b * lam) % n == 0
    return v1, v2


class GlvParams:
    """Decomposition parameters for one (modulus, lambda, beta) triple."""

    def __init__(self, n: int, lam: int, beta: int):
        self.n = n
        self.lam = lam
        self.beta = beta
        self.v1, self.v2 = _glv_basis(n, lam)
        # max bit length of a decomposed half (+1 safety): ladder trip count
        self.max_bits = max(abs(c).bit_length() for c in self.v1 + self.v2) + 2

    def decompose(self, k: int) -> tuple[int, int]:
        """k -> (k1, k2) with k1 + k2*lam = k (mod n), |ki| < 2^max_bits.

        Babai round-off against the lattice basis: (k, 0) - c1*v1 - c2*v2
        with ci the nearest-integer coefficients of (k, 0) in the basis."""
        k %= self.n
        (a1, b1), (a2, b2) = self.v1, self.v2
        det = a1 * b2 - a2 * b1
        # (k,0) = x*v1 + y*v2 with x = k*b2/det, y = -k*b1/det
        c1 = _round_div(k * b2, det)
        c2 = _round_div(-k * b1, det)
        k1 = k - c1 * a1 - c2 * a2
        k2 = -c1 * b1 - c2 * b2
        assert (k1 + k2 * self.lam - k) % self.n == 0
        assert abs(k1).bit_length() <= self.max_bits
        assert abs(k2).bit_length() <= self.max_bits
        return k1, k2


def _round_div(a: int, b: int) -> int:
    """Nearest-integer division (ties toward +inf), exact for big ints."""
    if b < 0:
        a, b = -a, -b
    return (2 * a + b) // (2 * b)


@functools.cache
def bn254_g1_glv() -> GlvParams:
    """GLV parameters for BN254 G1, with the (beta, lambda) pairing verified
    against the host curve: (beta*x, y) == lambda * (x, y) on the generator."""
    from . import refmath as rm

    lams = _cube_roots_of_unity(R)
    betas = _cube_roots_of_unity(Q)
    gx, gy = G1_GENERATOR
    for lam in lams:
        target = rm.G1.scalar_mul((gx, gy), lam)
        for beta in betas:
            if target == (beta * gx % Q, gy):
                return GlvParams(R, lam, beta)
    raise AssertionError("no (beta, lambda) pair matched on the generator")
