"""Host number-theory helpers shared by the derived curve configurations
(ops/bls12_377.py, ops/bls12_381.py): primality, factoring, square roots.
Pure-bigint, import-time cheap."""

from __future__ import annotations

import math
import random


def is_probable_prime(n: int, rounds: int = 40) -> bool:
    """Deterministic-enough Miller-Rabin (fixed small bases + pseudorandom)."""
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    rng = random.Random(0xB15B377)
    for i in range(rounds):
        a = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)[i] if i < 12 else (
            rng.randrange(2, n - 1)
        )
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def pollard_rho(n: int) -> int:
    """One nontrivial factor of composite n (Brent's variant)."""
    if n % 2 == 0:
        return 2
    rng = random.Random(n)
    while True:
        y, c, m = rng.randrange(1, n), rng.randrange(1, n), 128
        g, r, q = 1, 1, 1
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m
            r <<= 1
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g


def factor(n: int) -> set[int]:
    """Prime factors of n (recursive rho; intended for <= ~128-bit n)."""
    if n == 1:
        return set()
    if is_probable_prime(n):
        return {n}
    d = pollard_rho(n)
    return factor(d) | factor(n // d)


def smallest_generator(r: int, phi_primes: set[int]) -> int:
    """Smallest multiplicative generator of F_r given the prime factors of
    r - 1 (arkworks' GENERATOR convention)."""
    phi = r - 1
    g = 2
    while True:
        if all(pow(g, phi // p, r) != 1 for p in phi_primes):
            return g
        g += 1


def sqrt_mod(a: int, q: int) -> int | None:
    """Square root mod prime q (Tonelli-Shanks; None for non-residues)."""
    a %= q
    if a == 0:
        return 0
    if pow(a, (q - 1) // 2, q) == q - 1:
        return None
    if q % 4 == 3:
        return pow(a, (q + 1) // 4, q)
    s = ((q - 1) & -(q - 1)).bit_length() - 1
    qodd = (q - 1) >> s
    z = 2
    while pow(z, (q - 1) // 2, q) != q - 1:
        z += 1
    m, c = s, pow(z, qodd, q)
    t, r = pow(a, qodd, q), pow(a, (qodd + 1) // 2, q)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % q
            i += 1
        b = pow(c, 1 << (m - i - 1), q)
        m, c = i, b * b % q
        t, r = t * c % q, r * b % q
    return r


def fq2_mul(a, b, q: int):
    """(a0 + a1 u)(b0 + b1 u) in Fq[u]/(u^2+1), any prime q — the shared
    tower multiply (refmath's fq2_* are BN254-bound)."""
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % q, (a0 * b1 + a1 * b0) % q)


def fq2_inv(a, q: int):
    """1/(a0 + a1 u) via the conjugate/norm map, any prime q."""
    a0, a1 = a
    n = pow((a0 * a0 + a1 * a1) % q, q - 2, q)
    return (a0 * n % q, (-a1) * n % q)
