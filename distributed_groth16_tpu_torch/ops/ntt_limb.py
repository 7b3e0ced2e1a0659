"""Limb-major radix-2 NTT over BN254 Fr and kernel 4 — the counterpart of
distributed_groth16_tpu/ops/ntt_limb.py.

Layout: an Fr vector lives limb-major as int32 (16, n), Montgomery form,
redundant [0, 2p) — LimbField instantiated for the SCALAR field r.

Structure (four-step Cooley-Tukey):
  * n <= _S_MAX: one small NTT (`_SmallNTT`): bit-reversal, then log2(n)
    butterfly stages with per-stage twiddle tables. On a CUDA tensor this
    is kernel 4 (csrc/ntt_small.cu, the replacement of the Pallas kernel
    _SmallNTT._pallas); on a CPU tensor its plain version `_ntt_body`.
  * n > _S_MAX: n = A*B (A = _S_MAX): batched NTT_A over the B columns,
    one elementwise twiddle multiply w^{k1*j2}, transpose, NTT_B — output
    in natural order with no final permutation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from .constants import FR_GENERATOR, R, to_limbs
from .limb_kernels import NL, LimbField
from .ntt import bitrev_perm
from .refmath import finv

# largest single-kernel size: a column of 256 elements is 8 KB of shared
# memory in kernel 4 (the JAX package's VMEM-bound cap, kept so both
# packages split transforms the same way)
_S_MAX = 256


@functools.cache
def lfr() -> LimbField:
    """Limb-major field ops for Fr (scalar field)."""
    return LimbField(R)


def _w_root(n: int) -> int:
    return pow(FR_GENERATOR, (R - 1) // n, R)


@functools.cache
def _stage_twiddles(n: int, inverse: bool) -> np.ndarray:
    """(16, logn, n//2) per-stage butterfly twiddles, Montgomery limb rows.

    Stage s (span = 2^s) uses w_{2span}^t at hi-offset t in [0, span);
    entries beyond span are padding (never read)."""
    F = lfr()
    logn = n.bit_length() - 1
    w = _w_root(n)
    if inverse:
        w = finv(w, R)
    out = np.zeros((NL, logn, max(1, n // 2)), np.int32)
    for s in range(logn):
        span = 1 << s
        wspan = pow(w, n // (2 * span), R)
        acc = 1
        for t in range(span):
            out[:, s, t] = to_limbs(acc * F.mont_r % R)
            acc = acc * wspan % R
    return out


def _ntt_body(x, tw, logn: int):
    """Plain version of kernel 4's butterflies. x: (16, S, L) int64,
    bit-reversed along axis 1; tw: (16, logn, S//2). Returns natural
    order."""
    F = lfr()
    S, L = x.shape[1], x.shape[2]
    for s in range(logn):
        span = 1 << s
        xr = x.reshape(NL, S // (2 * span), 2, span, L)
        lo, hi = xr[:, :, 0], xr[:, :, 1]  # (16, blocks, span, L)
        twb = tw[:, s, :span, None][:, None]  # (16, 1, span, 1)
        t = F.mul(hi, twb)
        x = torch.stack([F.add(lo, t), F.sub(lo, t)], dim=2).reshape(NL, S, L)
    return x


class _SmallNTT:
    """Size-S NTT (transform on axis 1, batch on axis 2) — kernel 4's
    wrapper."""

    def __init__(self, S: int, inverse: bool):
        self.S = S
        self.logn = S.bit_length() - 1
        self.inverse = inverse
        self.tw_np = _stage_twiddles(S, inverse)
        self.perm = bitrev_perm(S)
        self.cpb = max(1, 256 // S)  # kernel 4's columns a block: 128 threads
        self._dev: dict = {}  # device -> (twiddles, bit-reversal index)

    def _tables(self, device):
        t = self._dev.get(device)
        if t is None:
            t = (torch.as_tensor(self.tw_np, device=device),
                 torch.as_tensor(self.perm, device=device))
            self._dev[device] = t
        return t

    def plain(self, x):
        """(16, S, L) natural-order columns -> NTT'd along axis 1."""
        tw, perm = self._tables(x.device)
        y = _ntt_body(x.long()[:, perm], tw.long(), self.logn)
        return y.to(torch.int32)

    def __call__(self, x):
        """Kernel 4 on a CUDA tensor, its plain version on a CPU tensor."""
        if x.device.type == "cpu":
            return self.plain(x)
        _cuda.check_cuda_int32("ntt x", x)
        if self.S < 2:
            raise ValueError("kernel 4 needs S >= 2")
        x = x.contiguous()
        L = x.shape[2]
        out = torch.empty_like(x)
        tw, _ = self._tables(x.device)
        _cuda.KERNELS["ntt_small"](
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), self.S, self.logn,
            L, self.cpb, _ntt_consts().ctypes.data, _cuda.stream_ptr(out),
        )
        return out


@functools.cache
def _ntt_consts() -> np.ndarray:
    return np.array(lfr().kernel_words, dtype=np.uint32)


@functools.cache
def _small(S: int, inverse: bool) -> _SmallNTT:
    return _SmallNTT(S, inverse)


def _wpows_lm_traced(n: int, inverse: bool, device):
    """(16, n) limb-major Montgomery table of w^0..w^{n-1}, built with
    O(log n) batched muls on the device, redundant [0, 2p) — the same
    sequence of products as the JAX package, hence the same limbs."""
    F = lfr()
    w = _w_root(n)
    if inverse:
        w = finv(w, R)
    logn = max(1, (n - 1).bit_length())
    k = torch.arange(n, device=device)
    one = torch.as_tensor(to_limbs(F.mont_r), device=device).view(NL, 1)
    tbl = one.expand(NL, n).long()
    for b in range(logn):
        wb = torch.as_tensor(
            to_limbs(pow(w, 1 << b, R) * F.mont_r % R), device=device
        ).view(NL, 1)
        hit = ((k >> b) & 1) == 1
        tbl = torch.where(hit[None, :], F.mul(tbl, wb), tbl)
    return tbl


@functools.cache
def _wpows(n: int, inverse: bool, device) -> torch.Tensor:
    """_wpows_lm_traced kept per (size, direction, device): every
    transform of a proof reuses it."""
    return _wpows_lm_traced(n, inverse, device).to(torch.int32)


def _ntt_rec(x, n: int, inverse: bool, L: int):
    """(16, n, L) int32 batched NTT along axis 1, natural order in/out."""
    F = lfr()
    if n <= _S_MAX:
        return _small(n, inverse)(x)
    A = _S_MAX
    B = n // A
    y = _small(A, inverse)(x.reshape(NL, A, B * L)).reshape(NL, A, B, L)
    # twiddle w^{k1*j2}: indices into this level's dense root table mod n
    k1 = torch.arange(A, device=x.device)[:, None]
    j2 = torch.arange(B, device=x.device)[None, :]
    idx = (k1 * j2) % n
    tw = _wpows(n, inverse, x.device)[:, idx.reshape(-1)]
    y = F.mul(y.long(), tw.reshape(NL, A, B, 1)).to(torch.int32)
    z = _ntt_rec(
        y.transpose(1, 2).reshape(NL, B, A * L), B, inverse, A * L
    )
    return z.reshape(NL, n, L)


def ntt_limb(x, n: int, inverse: bool = False):
    """Full-size NTT: x (16, n) Montgomery limb-major, natural order in and
    out. No 1/n scaling on inverse (the caller applies size_inv, as the
    Domain decomposition of ifft does)."""
    return _ntt_rec(x[:, :, None], n, inverse, 1)[:, :, 0]


def fft_rm(coeffs_rm, n: int, inverse: bool = False):
    """(n, 16) row-major Montgomery -> (n, 16) canonical: ntt_limb on the
    limb-major transpose (kernel 4 on a CUDA tensor), scaled by 1/n on
    inverse."""
    F = lfr()
    out = ntt_limb(coeffs_rm.t().contiguous(), n, inverse).long()
    if inverse:
        size_inv = torch.as_tensor(
            to_limbs(finv(n, R) * F.mont_r % R), device=out.device
        ).view(NL, 1)
        out = F.mul(out, size_inv)
    return F.canon(out).to(torch.int32).t().contiguous()
