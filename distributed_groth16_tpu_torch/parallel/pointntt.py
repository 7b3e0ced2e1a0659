"""Radix-2 NTT "in the exponent": FFTs directly on curve points — the
counterpart of distributed_groth16_tpu/parallel/pointntt.py (the
reference's group-element pack/unpack, dist-primitives/src/dmsm/
mod.rs:7-68, over ark-poly's Radix2EvaluationDomain on a ProjectiveCurve).

An IFFT on the share domain and an FFT on the secret / secret2 coset,
every butterfly (lo, hi) -> (lo + w hi, lo - w hi) acting on points: the
twiddle multiply is a fixed-scalar curve multiplication. Each stage's lane
twiddles are fixed BN254 Fr scalars, so a stage is one per-lane ladder
(ops/limb_kernels.lane_ladder; GLV-halved to ~129 steps on G1) and one
complete add. The op count is O(n log n) against the dense matrix
ladder's O(l n), so PackedSharingParams takes this route from n = 64
parties (_NTT_THRESHOLD).

A transform runs limb-major from end to end (one from_rowmajor on entry,
one to_rowmajor on exit): the bit-reversal gather, the lo/hi gathers, the
lane ladders, the conditional negation and the butterfly adds act on the
curve's limb group, so on a CUDA tensor every add is a kernel-1 launch
and every doubling a kernel-2 launch. Semantics are those of ops/ntt.py
Domain (bit-reversal DIT, coset offsets, 1/n scaling on the inverse).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import msm as _msm
from ..ops.constants import FR_GENERATOR, R
from ..ops.curve import CurvePoints, fixed_scalar_ladder_tensors
from ..ops.limb_kernels import lane_ladder
from ..ops.ntt import bitrev_perm
from ..ops.refmath import finv


def _trim(tensors):
    """Ladder tensors cut after the highest bit any lane sets (at least
    one step): the steps above it add nothing."""
    bits, signs, nbits = tensors
    used = torch.nonzero(bits.reshape(-1, nbits).any(0))
    top = int(used.max()) + 1 if used.numel() else 1
    return bits[..., :top].contiguous(), signs, top


def _ladder(curve: CurvePoints, g, x_lm, tensors):
    """Lane j of every row of x_lm (ROWS, B, n) times the j-th fixed
    scalar of `tensors` (host ladder tensors)."""
    bits, signs, nbits = tensors
    dev = x_lm.device
    return lane_ladder(
        g, x_lm, bits.to(dev), None if signs is None else signs.to(dev),
        nbits, curve.glv.beta if curve.glv is not None else None,
    )


def fixed_scalar_mul(curve: CurvePoints, pts, tensors):
    """Per-lane fixed-scalar multiplication of row-major points: pts
    (..., n) + point, tensors from fixed_scalar_ladder_tensors for the n
    lane scalars; out[..., j] = s_j * pts[..., j], canonical."""
    g = _msm._limb_group_for(curve)
    x, batch = _to_lm(curve, g, pts)
    return _from_lm(curve, g, _ladder(curve, g, x, tensors), batch)


def _to_lm(curve: CurvePoints, g, pts):
    """(..., k) + point row-major -> ((ROWS, B, k) limb-major, batch)."""
    ax = pts.ndim - 2 - curve.coord_axes
    batch, k = tuple(pts.shape[:ax]), pts.shape[ax]
    flat = pts.reshape((-1, 3) + curve.elem_shape)
    return g.from_rowmajor(flat).reshape(g.ROWS, -1, k), batch


def _from_lm(curve: CurvePoints, g, x, batch):
    """(ROWS, B, k) limb-major -> (..., k) + point row-major, canonical."""
    k = x.shape[2]
    out = g.to_rowmajor(x.reshape(g.ROWS, -1))
    return out.reshape(batch + (k, 3) + curve.elem_shape)


class PointDomain:
    """Radix-2 evaluation domain over BN254 Fr acting on curve points."""

    def __init__(self, size: int, offset: int = 1):
        assert size > 0 and size & (size - 1) == 0
        self.size = size
        self.logn = size.bit_length() - 1
        self.offset = offset % R
        self.group_gen = pow(FR_GENERATOR, (R - 1) // size, R)
        self._perm = torch.as_tensor(bitrev_perm(size))
        j = np.arange(size)
        self._stage_idx = [
            tuple(torch.as_tensor(a) for a in
                  (j & ~(1 << s), j | (1 << s), (j & (1 << s)) == 0))
            for s in range(self.logn)
        ]

    # host-side per-stage lane twiddles, mirroring ops/ntt.py _ntt_core
    def _stage_scalars(self, s: int, inverse: bool) -> list[int]:
        n = self.size
        out = []
        span = 1 << s
        for j in range(n):
            k = (j & (span - 1)) * (n >> (s + 1))
            if inverse:
                k = (n - k) & (n - 1)
            out.append(pow(self.group_gen, k, R))
        return out

    def _lane_scale(self, inverse: bool) -> list[int] | None:
        """Per-lane pre/post scaling: offset^i forward, (1/n) offset^-i
        inverse."""
        if inverse:
            n_inv = finv(self.size, R)
            off_inv = finv(self.offset, R) if self.offset != 1 else 1
            return [n_inv * pow(off_inv, i, R) % R for i in range(self.size)]
        if self.offset == 1:
            return None
        return [pow(self.offset, i, R) for i in range(self.size)]

    def _tensors(self, curve: CurvePoints, inverse: bool):
        """Host ladder tensors of every stage and of the lane scaling,
        cached on the curve object, keyed by (size, offset, inverse)."""
        cache = curve.__dict__.setdefault("_pntt_cache", {})
        key = (self.size, self.offset, inverse)
        if key not in cache:
            stages = [
                _trim(fixed_scalar_ladder_tensors(
                    curve, self._stage_scalars(s, inverse)))
                for s in range(self.logn)
            ]
            scale = self._lane_scale(inverse)
            scale_t = (_trim(fixed_scalar_ladder_tensors(curve, scale))
                       if scale is not None else None)
            cache[key] = (stages, scale_t)
        return cache[key]

    def _transform_lm(self, curve: CurvePoints, g, x, inverse: bool):
        """(ROWS, B, size) limb-major -> the same, transformed."""
        stages, scale_t = self._tensors(curve, inverse)
        dev = x.device
        if not inverse and scale_t is not None:
            x = _ladder(curve, g, x, scale_t)
        x = x[:, :, self._perm.to(dev)]
        for s in range(self.logn):
            lo_idx, hi_idx, is_lo = (a.to(dev) for a in self._stage_idx[s])
            t = _ladder(curve, g, x[:, :, hi_idx], stages[s])
            t = torch.where(is_lo, t, g.neg(t))
            x = g.add(x[:, :, lo_idx], t)
        if inverse and scale_t is not None:
            x = _ladder(curve, g, x, scale_t)
        return x

    def fft_lm(self, curve: CurvePoints, g, x):
        """Evaluate: (ROWS, B, k <= size) limb-major coefficients ->
        (ROWS, B, size) evaluations."""
        return self._transform_lm(curve, g, _zpad_lm(g, x, self.size), False)

    def ifft_lm(self, curve: CurvePoints, g, x):
        """Interpolate: (ROWS, B, size) limb-major -> coefficients."""
        return self._transform_lm(curve, g, _zpad_lm(g, x, self.size), True)

    def fft(self, curve: CurvePoints, pts):
        """Evaluate: (..., k <= size) + point coefficients -> (..., size)
        + point evaluations, canonical."""
        g = _msm._limb_group_for(curve)
        x, batch = _to_lm(curve, g, pts)
        return _from_lm(curve, g, self.fft_lm(curve, g, x), batch)

    def ifft(self, curve: CurvePoints, pts):
        """Interpolate: (..., size) + point evaluations -> coefficients."""
        g = _msm._limb_group_for(curve)
        x, batch = _to_lm(curve, g, pts)
        return _from_lm(curve, g, self.ifft_lm(curve, g, x), batch)


def _zpad_lm(g, x, n: int):
    """Pad the lane axis of (ROWS, B, k) with infinity up to n (the JAX
    package's _zpad_points, on the limb-major layout)."""
    k = x.shape[2]
    assert k <= n
    if k == n:
        return x
    inf = g.infinity(1, x.device).view(g.ROWS, 1, 1)
    return torch.cat([x, inf.expand(g.ROWS, x.shape[1], n - k)], dim=2)


@functools.cache
def point_domain(size: int, offset: int = 1) -> PointDomain:
    return PointDomain(size, offset)


# -- PSS pack/unpack in the exponent via point NTTs --------------------------


def packexp_ntt(pp, curve: CurvePoints, pts):
    """(..., l) + point -> (..., n) + point: secret-coset IFFT then share
    FFT (dmsm/mod.rs:61-68)."""
    g = _msm._limb_group_for(curve)
    sec = point_domain(pp.secret.size, pp.secret.offset)
    sha = point_domain(pp.n)
    x, batch = _to_lm(curve, g, pts)
    coeffs = sec.ifft_lm(curve, g, x)
    return _from_lm(curve, g, sha.fft_lm(curve, g, coeffs), batch)


def unpackexp_ntt(pp, curve: CurvePoints, shares, degree2: bool):
    """(..., n) + point -> (..., l) + point: share IFFT then secret(2)-coset
    FFT, truncated as the field-side unpack / unpack2 (dmsm/mod.rs:7-48)."""
    g = _msm._limb_group_for(curve)
    sha = point_domain(pp.n)
    x, batch = _to_lm(curve, g, shares)
    coeffs = sha.ifft_lm(curve, g, x)
    if degree2:
        sec2 = point_domain(pp.secret2.size, pp.secret2.offset)
        evals = sec2.fft_lm(curve, g, coeffs)[:, :, 0 : 2 * pp.l : 2]
    else:
        sec = point_domain(pp.secret.size, pp.secret.offset)
        evals = sec.fft_lm(curve, g, coeffs[:, :, : sec.size])[:, :, : pp.l]
    return _from_lm(curve, g, evals, batch)
