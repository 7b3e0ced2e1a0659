"""Radix-2 NTT over BN254 Fr — the counterpart of
distributed_groth16_tpu/ops/ntt.py, with ark-poly Radix2EvaluationDomain
semantics.

A `Domain(size, offset)` evaluates polynomials at offset * w^i, w =
g^((r-1)/size), g = 5. Vectors are (..., n, 16) int32 Montgomery limbs,
canonical. Transforms of at least LIMB_NTT_MIN_N points take the
limb-major four-step route of ops/ntt_limb.py (kernel 4 on a CUDA tensor);
smaller ones the row-major `_ntt_core`. Each transform counts its route in
kernel_route_total{kernel="ntt", path="limb" | "row"}, as the JAX package
does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..telemetry import metrics as _tm
from .constants import FR_GENERATOR, FR_TWO_ADICITY, N_LIMBS, R
from .field import fr
from .refmath import finv

# same family ops/msm.py registers (idempotent): which NTT path ran
_ROUTE = _tm.registry().counter(
    "kernel_route_total",
    "Kernel-path routing decisions at dispatch/trace time, per kernel "
    "and chosen implementation path",
    ("kernel", "path"),
)
_R_LIMB = _ROUTE.labels(kernel="ntt", path="limb")
_R_ROW = _ROUTE.labels(kernel="ntt", path="row")

# transforms this large or larger take the limb-major route (the JAX
# package's TPU threshold; a test may lower it to reach the route cheaply)
LIMB_NTT_MIN_N = 2048


def bitrev_perm(n: int) -> np.ndarray:
    """Bit-reversal permutation indices (matches dfft/mod.rs:258-271)."""
    assert n > 0 and n & (n - 1) == 0, f"bitrev needs a power of two, got {n}"
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros((n,), dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


def _ntt_core(x, perm, wpows, logn: int, inverse: bool = False):
    """Row-major DIT radix-2 NTT with a dense root table.

    x: (..., n, 16); perm: (n,) bit reversal; wpows: (n, 16) powers
    w^0..w^{n-1} of the forward root (the inverse reads w^{-k} =
    wpows[(n-k) mod n])."""
    F = fr()
    n = x.shape[-2]
    x = x[..., perm, :]
    j = torch.arange(n, device=x.device)
    for s in range(logn):
        span = 1 << s
        k = (j & (span - 1)) * (n >> (s + 1))
        if inverse:
            k = (n - k) & (n - 1)
        t = F.mul(x[..., j | span, :], wpows[k])
        lo = x[..., j & ~span, :]
        is_lo = ((j & span) == 0)[:, None]
        x = torch.where(is_lo, F.add(lo, t), F.sub(lo, t))
    return x


class Domain:
    """Radix-2 evaluation domain over Fr (ark semantics). Device tables
    are built on first use and kept per device."""

    def __init__(self, size: int, offset: int = 1):
        assert size & (size - 1) == 0 and size > 0
        assert size <= (1 << FR_TWO_ADICITY)
        self.size = size
        self.logn = size.bit_length() - 1
        self.offset = offset % R
        self.group_gen = pow(FR_GENERATOR, (R - 1) // size, R)
        self._perm = bitrev_perm(size)
        self._size_inv = fr().encode_np([finv(size, R)])[0]
        self._tables: dict = {}

    def elements(self) -> list[int]:
        out, acc = [], self.offset
        for _ in range(self.size):
            out.append(acc)
            acc = acc * self.group_gen % R
        return out

    def _table(self, key, device, make):
        t = self._tables.get((key, device))
        if t is None:
            t = make()
            self._tables[(key, device)] = t
        return t

    def _off(self, inverse: bool, device):
        if self.offset == 1:
            return None
        base = finv(self.offset, R) if inverse else self.offset
        return self._table(
            ("off", inverse), device,
            lambda: _powers_device(base, self.size, device),
        )

    def _live_wpows(self, device):
        """(n, 16) powers w^0..w^{n-1} of the domain's root on `device`
        (the d_fft twiddle table)."""
        return self._table(
            "wpows", device,
            lambda: _powers_device(self.group_gen, self.size, device),
        )

    def _core(self, x, inverse: bool):
        dev = x.device
        perm = self._table(
            "perm", dev, lambda: torch.as_tensor(self._perm, device=dev)
        )
        return _ntt_core(x, perm, self._live_wpows(dev), self.logn, inverse)

    def fft(self, coeffs):
        """Evaluate: (..., k<=n, 16) coeffs -> (..., n, 16) evals."""
        F = fr()
        x = _zpad(coeffs, self.size)
        off = self._off(False, x.device)
        if off is not None:
            x = F.mul(x, off)
        if _limb_ntt_ok(self.size):
            _R_LIMB.inc()
            return _limb_ntt_route(x, self.size, False)
        _R_ROW.inc()
        return self._core(x, False)

    def ifft(self, evals):
        """Interpolate: (..., k<=n, 16) evals -> (..., n, 16) coeffs."""
        F = fr()
        x = _zpad(evals, self.size)
        if _limb_ntt_ok(self.size):
            _R_LIMB.inc()
            x = _limb_ntt_route(x, self.size, True)
        else:
            _R_ROW.inc()
            x = self._core(x, True)
        x = F.mul(x, torch.as_tensor(self._size_inv, device=x.device))
        off = self._off(True, x.device)
        if off is not None:
            x = F.mul(x, off)
        return x

    def get_coset(self, offset: int) -> "Domain":
        return domain(self.size, offset * self.offset % R)


def _limb_ntt_ok(n: int) -> bool:
    return n >= LIMB_NTT_MIN_N


def _limb_ntt_route(x, n: int, inverse: bool):
    """(..., n, 16) row-major <-> limb-major shim around ntt_limb (no 1/n
    scaling). The batch rides the limb NTT's column axis. The limb
    pipeline works in the redundant [0, 2p) class and the row-major world
    needs CANONICAL limbs (a redundant value once corrupted a proof in the
    JAX package), so canon() at the boundary."""
    from .ntt_limb import _ntt_rec, lfr

    batch = x.shape[:-2]
    flat = x.reshape((-1, n, N_LIMBS))
    lm = flat.permute(2, 1, 0)  # (16, n, L)
    out = _ntt_rec(lm, n, inverse, lm.shape[2])
    out = lfr().canon(out.long()).to(torch.int32)
    return out.permute(2, 1, 0).reshape(batch + (n, N_LIMBS)).contiguous()


def _zpad(x, n):
    k = x.shape[-2]
    assert k <= n, f"input length {k} exceeds domain size {n}"
    if k == n:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, n - k))


def _powers_device(base: int, n: int, device) -> torch.Tensor:
    """(n, 16) table of base^0..base^{n-1}, built with O(log n) batched
    device muls (canonical)."""
    F = fr()
    logn = max(1, (n - 1).bit_length())
    bit_pows = [F.encode([base % R], device)]
    for _ in range(logn - 1):
        bit_pows.append(F.mul(bit_pows[-1], bit_pows[-1]))
    k = torch.arange(n, device=device)
    tbl = torch.as_tensor(F.one, device=device).expand(n, N_LIMBS)
    for b in range(logn):
        hit = (((k >> b) & 1) == 1)[:, None]
        tbl = torch.where(hit, F.mul(tbl, bit_pows[b]), tbl)
    return tbl


@functools.cache
def domain(size: int, offset: int = 1) -> Domain:
    return Domain(size, offset)
