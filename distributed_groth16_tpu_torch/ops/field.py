"""Prime-field arithmetic on torch tensors — the counterpart of
distributed_groth16_tpu/ops/field.py.

Field elements are int32 tensors of shape (..., nl): nl 16-bit
little-endian limbs in Montgomery form (R = 2^(16*nl)), the JAX package's
layout, so keys and vectors cross between the two packages unchanged.

Arithmetic runs in int64 on a limb-major view (limb axis first) with a
small integer core shared by the row-major PrimeField here and the
limb-major LimbField of ops/limb_kernels.py:

  * `_prod` forms every 16x16-bit partial product at once and sums the
    anti-diagonals, leaving uncarried columns;
  * `_carry` turns uncarried columns (each < 2^48) into exact digits with
    a few parallel carry rounds and one prefix pass (cummax over the
    "propagate" limbs) instead of a 16-step ripple;
  * a conditional subtraction carries both candidates in one pass;
  * `_mont_mul` is Montgomery multiplication with the full 256-bit
    M = -ab/p mod R. (ab + Mp)/R is the same integer for any word size,
    so it matches the JAX package's 16-bit CIOS exactly, redundant
    [0, 2p) results included.

Each field operation is a fixed, small number of tensor ops whatever the
limb count, which keeps both CPU test runs and eager GPU runs short.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import LIMB_BITS, LIMB_MASK, N_LIMBS, Q, R, to_limbs

MASK = LIMB_MASK


def resolve_device(device) -> torch.device:
    """The port's default device: None means CUDA. Nothing here probes for
    a card; only an explicit "cpu" runs on the CPU."""
    return torch.device("cuda") if device is None else torch.device(device)


def inclusive_scan(op, x):
    """Inclusive scan of x along axis 0 under an associative op, as
    Hillis-Steele: log2(len) batched calls of op (earlier operand first),
    the counterpart of the JAX package's lax.associative_scan."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], op(x[:-d], x[d:])])
        d *= 2
    return x


# ---------------------------------------------------------------------------
# Integer core: int64 tensors, limb axis 0, nonnegative entries. Constant
# operands are limb columns (k, 1, ...) that broadcast over the batch.
# ---------------------------------------------------------------------------


@functools.cache
def _pairs(k: int, k_out: int, device: torch.device):
    """Index pairs (i, j) with i + j < k_out, and their column i + j."""
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    keep = (ii + jj) < k_out
    ii, jj = ii[keep], jj[keep]
    to = functools.partial(torch.as_tensor, dtype=torch.int64, device=device)
    return to(ii), to(jj), to(ii + jj)


@functools.cache
def _positions(k: int, ndim: int, device: torch.device):
    return torch.arange(k, device=device).view((k,) + (1,) * (ndim - 1))


def _prod(a, b, k_out: int):
    """Uncarried columns 0..k_out-1 of the product a*b (limbs < 2^16)."""
    k = a.shape[0]
    if max(a[0].numel(), b[0].numel()) >= 2048:
        # large batches: k shifted multiply-adds instead of one scatter
        # over a k^2-row temporary
        out = torch.zeros((k_out,) + (a[:1] * b[:1]).shape[1:],
                          dtype=torch.int64, device=a.device)
        for i in range(min(k, k_out)):
            n = min(k, k_out - i)
            if a.device.type == "cpu":
                out[i : i + n].addcmul_(a[i : i + 1], b[:n])
            else:
                out[i : i + n] += a[i : i + 1] * b[:n]
        return out
    ii, jj, col = _pairs(k, k_out, a.device)
    terms = a[ii] * b[jj]
    out = torch.zeros(
        (k_out,) + terms.shape[1:], dtype=torch.int64, device=a.device
    )
    return out.index_add_(0, col, terms)


def _carry(v, k_out: int, rounds: int = 3):
    """Exact base-2^16 digits (mod 2^(16*k_out)) of lazily accumulated
    columns v. Entries must be below 2^32 (rounds=2), 2^48 (rounds=3) or
    2^63 (rounds=4)."""
    k = min(v.shape[0], k_out)
    # digits live in rows 1..k_out; row 0 is a zero that `lo` feeds in
    vv = torch.nn.functional.pad(
        v[:k], (0, 0) * (v.ndim - 1) + (1, k_out - k)
    )
    lo, hi = vv[:-1], vv[1:]
    # parallel rounds bring every digit into [0, 2^16]
    for _ in range(rounds):
        c = lo >> LIMB_BITS
        vv &= MASK
        hi += c
    # what is left are 1-bit carries rippling through 0xffff digits: the
    # carry into digit i is the overflow bit of the nearest row of vv below
    # it that is not 0xffff (row 0, the zero, if none)
    pos = _positions(k_out, v.ndim, v.device)
    last = ((lo != MASK) * pos).cummax(0).values
    hi += torch.gather(vv >> LIMB_BITS, 0, last)
    return hi & MASK


def _cond_sub(x, m, mneg):
    """x - m if x >= m else x; x carried, mneg the digits of 2^(16k) - m."""
    k = x.shape[0]
    d = _carry(x + mneg, k + 1, rounds=2)  # top digit 1 iff x >= m
    return torch.where(d[k:] == 1, d[:k], x)


def _add_mod(a, b, m, mneg):
    """cond_sub(a + b, m): canonical add for m = p, redundant for m = 2p.
    Both candidates share one carry pass."""
    k = a.shape[0]
    s = a + b
    r = _carry(torch.stack([s, s + mneg], dim=1), k + 1, rounds=2)
    return torch.where(r[k:, 1] == 1, r[:k, 1], r[:k, 0])


def _sub_mod(a, b, m, comp):
    """cond_sub(a + (m - b), m), b <= m: a - b if a >= b else a - b + m.
    comp = digits (2^16, 2^16 - 1, ...) so a - b + comp = a - b + 2^(16k)."""
    k = a.shape[0]
    x = a - b + comp
    r = _carry(torch.stack([x, x + m], dim=1), k + 1, rounds=2)
    return torch.where(r[k:, 0] == 1, r[:k, 0], r[:k, 1])


def _neg_mod(b, m, comp):
    """(m - b) mod 2^(16*nl), b <= m (b = 0 gives m itself)."""
    return _carry(m + comp - b, b.shape[0], rounds=2)


def _mont_mul(a, b, p, pinv, pneg=None):
    """(ab + Mp) / R with M = -ab/p mod R: the Montgomery product. Inputs
    < 2p give an output < 2p (4p < R). With pneg (digits of R - p) the
    result is also reduced below p, in the same final carry pass."""
    k = p.shape[0]
    t = _prod(a, b, 2 * k)  # columns < 2^36
    # M = (ab mod R) * pinv mod R, straight from t's uncarried low
    # columns: their products with pinv stay below 2^56
    m = _carry(_prod(t[:k], pinv, k), k, rounds=4)
    u = _prod(m, p, 2 * k) + t
    if pneg is None:
        return _carry(u, 2 * k)[k:]
    # u/R - p = (u + (R - p) R) / R - R: one more candidate, one carry
    hi = u[k:] + pneg
    both = torch.stack([u, torch.cat([u[:k], hi])], dim=1)
    r = _carry(both, 2 * k + 1)
    return torch.where(r[2 * k :, 1] == 1, r[k : 2 * k, 1], r[k : 2 * k, 0])


class _Consts:
    """Limb columns of a modulus, cached per device (limb axis 0)."""

    def __init__(self, **cols: np.ndarray):
        self._np = cols
        self._cache: dict = {}

    def get(self, name: str, device, ndim: int):
        key = (name, device)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(self._np[name], dtype=torch.int64,
                                device=device)
            self._cache[key] = t
        return t.view((t.shape[0],) + (1,) * (ndim - 1))


def _comp_np(nl: int) -> np.ndarray:
    """Digits (2^16, 2^16 - 1, ...): a - b + comp = a - b + 2^(16*nl)."""
    comp = np.full(nl, MASK, dtype=np.int64)
    comp[0] += 1
    return comp


def _limbs_np(x: int, n_limbs: int = N_LIMBS) -> np.ndarray:
    return np.array(to_limbs(x, n_limbs), dtype=np.int32)


# ---------------------------------------------------------------------------
# Row-major prime field
# ---------------------------------------------------------------------------


class PrimeField:
    """Montgomery arithmetic over a fixed prime, vectorized over leading
    axes. Public methods take/return int32 tensors of shape (..., nl)
    holding canonical (< p) Montgomery values."""

    def __init__(self, modulus: int, n_limbs: int | None = None):
        self.nl = n_limbs or max(
            N_LIMBS, -(-(modulus.bit_length() + 2) // LIMB_BITS)
        )
        assert 4 * modulus < 1 << (LIMB_BITS * self.nl)
        self.p = modulus
        self.mont_bits = LIMB_BITS * self.nl
        self.mont_r = (1 << self.mont_bits) % modulus
        self.mont_r2 = self.mont_r * self.mont_r % modulus
        self.mont_rinv = pow(self.mont_r, modulus - 2, modulus)
        self.p_limbs = _limbs_np(modulus, self.nl)
        self.one = _limbs_np(self.mont_r, self.nl)
        self.zero = np.zeros(self.nl, dtype=np.int32)
        self.r2 = _limbs_np(self.mont_r2, self.nl)
        e = modulus - 2
        self._inv_bits = [(e >> i) & 1 for i in range(e.bit_length())]
        bits = self.mont_bits
        pinv = (-pow(modulus, -1, 1 << bits)) % (1 << bits)
        self._c = _Consts(
            p=self.p_limbs, pneg=_limbs_np((1 << bits) - modulus, self.nl),
            pinv=_limbs_np(pinv, self.nl), comp=_comp_np(self.nl),
        )

    # -- host <-> device conversion -------------------------------------------

    def encode_np(self, values) -> np.ndarray:
        """Python ints / nested lists -> Montgomery limb array (numpy
        int32, shape values.shape + (nl,))."""
        arr = np.asarray(values, dtype=object)
        p, r = self.p, self.mont_r
        nb = 2 * self.nl
        buf = b"".join(
            ((int(v) % p) * r % p).to_bytes(nb, "little")
            for v in arr.reshape(-1)
        )
        out = np.frombuffer(buf, dtype="<u2").astype(np.int32)
        return out.reshape(arr.shape + (self.nl,))

    def encode(self, values, device=None) -> torch.Tensor:
        """Python ints -> Montgomery limb tensor on `device` (None: CUDA)."""
        return torch.as_tensor(
            self.encode_np(values), device=resolve_device(device)
        )

    def decode(self, x) -> np.ndarray:
        """Montgomery limb tensor/array -> numpy object array of ints."""
        arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        nl, nb = self.nl, 2 * self.nl
        flat = arr.reshape(-1, nl).astype("<u2").tobytes()
        n = arr.size // nl
        rinv, p = self.mont_rinv, self.p
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = (
                int.from_bytes(flat[nb * i : nb * (i + 1)], "little")
                * rinv % p
            )
        return out.reshape(arr.shape[:-1])

    def consts(self, shape=(), device=None):
        """(zero, one) broadcast to the given batch shape."""
        dev = resolve_device(device)
        z = torch.as_tensor(self.zero, device=dev).expand(shape + (self.nl,))
        o = torch.as_tensor(self.one, device=dev).expand(shape + (self.nl,))
        return z, o

    # -- layout plumbing ------------------------------------------------------

    @staticmethod
    def _lm(*xs):
        """Broadcast row-major operands, view them limb-major in int64."""
        xs = torch.broadcast_tensors(*xs)
        return [x.movedim(-1, 0).to(torch.int64) for x in xs]

    @staticmethod
    def _rm(v):
        return v.movedim(0, -1).to(torch.int32).contiguous()

    def _col(self, name, v):
        return self._c.get(name, v.device, v.ndim)

    # -- ring ops -------------------------------------------------------------

    def add(self, a, b):
        a, b = self._lm(a, b)
        return self._rm(_add_mod(a, b, self._col("p", a),
                                 self._col("pneg", a)))

    def sub(self, a, b):
        a, b = self._lm(a, b)
        return self._rm(_sub_mod(a, b, self._col("p", a),
                                 self._col("comp", a)))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product abR^{-1} mod p, canonical."""
        a, b = self._lm(a, b)
        return self._rm(_mont_mul(
            a, b, self._col("p", a), self._col("pinv", a),
            self._col("pneg", a),
        ))

    def sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a_std):
        return self.mul(a_std, torch.as_tensor(self.r2, device=a_std.device))

    def from_mont(self, a_mont):
        one_std = torch.zeros(self.nl, dtype=torch.int32,
                              device=a_mont.device)
        one_std[0] = 1
        return self.mul(a_mont, one_std)

    # -- predicates -----------------------------------------------------------

    def is_zero(self, a):
        return torch.all(a == 0, dim=-1)

    # -- exponentiation / inversion -------------------------------------------

    def pow_bits(self, x, bits):
        """x^e, e given LSB-first as a sequence of 0/1."""
        acc = torch.as_tensor(self.one, device=x.device).expand(x.shape)
        base = x
        for bit in bits:
            if bit:
                acc = self.mul(acc, base)
            base = self.mul(base, base)
        return acc

    def inv(self, x):
        """Elementwise Fermat inversion x^(p-2); inv(0) = 0."""
        return self.pow_bits(x, self._inv_bits)

    def batch_inv(self, x):
        """Inversion over the leading axis with a product tree: ~3n muls
        in log2(n) batched rounds plus one Fermat inversion. Zero entries
        map to zero."""
        one = torch.as_tensor(self.one, device=x.device)
        zmask = self.is_zero(x)
        cur = torch.where(zmask[..., None], one, x)
        levels = []
        while cur.shape[0] > 1:
            if cur.shape[0] % 2:
                cur = torch.cat([cur, one.expand((1,) + cur.shape[1:])])
            levels.append(cur)
            cur = self.mul(cur[0::2], cur[1::2])
        inv = self.inv(cur)
        for lvl in reversed(levels):
            inv = inv[: lvl.shape[0] // 2]  # drop the parent's padding
            pair = torch.stack(
                [self.mul(inv, lvl[1::2]), self.mul(inv, lvl[0::2])], dim=1
            )
            inv = pair.reshape(lvl.shape)
        inv = inv[: x.shape[0]]
        return torch.where(zmask[..., None], torch.zeros_like(inv), inv)


@functools.cache
def fq() -> PrimeField:
    return PrimeField(Q)


@functools.cache
def fr() -> PrimeField:
    return PrimeField(R)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1): elements are (..., 2, 16) int32 (Montgomery limbs).
# ---------------------------------------------------------------------------


class Fq2Ops:
    def __init__(self, base: PrimeField):
        self.fq = base

    def encode(self, values, device=None):
        """List/array of (c0, c1) int pairs -> (..., 2, 16)."""
        return self.fq.encode(values, device)

    def decode(self, x):
        return self.fq.decode(x)

    def add(self, a, b):
        return self.fq.add(a, b)

    def sub(self, a, b):
        return self.fq.sub(a, b)

    def neg(self, a):
        return self.fq.neg(a)

    def mul(self, a, b):
        f = self.fq
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t = f.mul(
            torch.stack([a0, a1, f.add(a0, a1)]),
            torch.stack([b0, b1, f.add(b0, b1)]),
        )
        c0 = f.sub(t[0], t[1])
        c1 = f.sub(t[2], f.add(t[0], t[1]))
        return torch.stack([c0, c1], dim=-2)

    def sqr(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t = f.mul(torch.stack([a0, f.add(a0, a1)]),
                  torch.stack([a1, f.sub(a0, a1)]))
        return torch.stack([t[1], f.add(t[0], t[0])], dim=-2)

    def inv(self, a):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        norm = f.add(f.sqr(a0), f.sqr(a1))
        ninv = f.inv(norm)
        return torch.stack([f.mul(a0, ninv), f.neg(f.mul(a1, ninv))], dim=-2)

    def consts(self, shape=(), device=None):
        dev = resolve_device(device)
        nl = self.fq.nl
        z = torch.zeros(shape + (2, nl), dtype=torch.int32, device=dev)
        one = np.zeros((2, nl), np.int32)
        one[0] = self.fq.one
        o = torch.as_tensor(one, device=dev).expand(shape + (2, nl))
        return z, o


@functools.cache
def fq2() -> Fq2Ops:
    return Fq2Ops(fq())
