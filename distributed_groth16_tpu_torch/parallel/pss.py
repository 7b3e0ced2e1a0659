"""Packed secret sharing (PSS) over BN254 Fr, or another scalar field for
the group-element maps — the counterpart of
distributed_groth16_tpu/parallel/pss.py (the zkSaaS scheme of the
reference's secret-sharing/src/pss.rs:13-148).

`l` secrets are packed into one degree-(t+l) polynomial and dealt as
n = 4l shares (threshold t = l-1):

  * shares    = evaluations on the size-n `share` domain,
  * secrets   = evaluations on a coset (offset = Fr generator) of the
                size-(l+t+1) `secret` domain,
  * products  = evaluations on the size-2(l+t+1) `secret2` coset.

pack   : IFFT on `secret` (zero-padded), FFT on `share`
unpack : IFFT on `share`, truncate to 2l coeffs, FFT on `secret`, keep l
unpack2: IFFT on `share`, FFT on `secret2`, keep the even indices of the
         first 2l entries

Field-vector transforms run batched over leading axes through ops/ntt.py
(tiny row-major NTTs, vectorized over the chunk axis), over BN254 Fr only.
The group-element ("in the exponent") maps are the same linear maps,
applied two ways: as precomputed o x k matrices over the scalar field in
one batched fixed-scalar double-and-add ladder, limb-major through
ops/limb_kernels.ladder_apply, on any curve with a limb group (BN254,
BLS12-377 G1, BLS12-381 G1/G2); or, over BN254 Fr from n = 64 parties
up, as the point-domain NTT of parallel/pointntt.py. Kernels 1 and 2
carry both on a CUDA tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import msm as _msm
from ..ops import refmath as rm
from ..ops.constants import FR_GENERATOR, R
from ..ops.curve import CurvePoints, fixed_scalar_ladder_tensors
from ..ops.field import fr
from ..ops.ntt import domain
from . import pointntt


class PackedSharingParams:
    """PSS parameters and transforms for packing factor l (n = 4l parties).

    Over BN254 Fr by default. Another (modulus, generator), e.g.
    BLS12-377's (ops/bls12_377.pss377), builds the host domains over that
    field, and with them every pack/unpack matrix and in-exponent ladder;
    the device field-share transforms stay BN254-only (their NTT tables
    are built over ops/constants.R) and raise NotImplementedError."""

    # "auto" takes the point-domain NTT (parallel/pointntt.py) from this
    # many parties up, as the JAX package does
    _NTT_THRESHOLD = 64

    def __init__(self, l: int, modulus: int = R,
                 generator: int = FR_GENERATOR):
        assert l >= 1 and (l & (l - 1)) == 0, "packing factor must be a power of 2"
        self.l = l
        self.t = l - 1
        self.n = 4 * l
        self.modulus = modulus
        assert self.n == 2 * (self.t + self.l + 1)
        if modulus == R:
            self.share = domain(self.n)
            self.secret = domain(self.l + self.t + 1, offset=FR_GENERATOR)
            self.secret2 = domain(
                2 * (self.l + self.t + 1), offset=FR_GENERATOR
            )
        else:
            self.share = self.secret = self.secret2 = None
        # host-side mirrors for matrix construction / ground truth
        self.share_h = rm.Domain(self.n, modulus=modulus, generator=generator)
        self.secret_h = rm.Domain(self.l + self.t + 1, offset=generator,
                                  modulus=modulus, generator=generator)
        self.secret2_h = rm.Domain(2 * (self.l + self.t + 1),
                                   offset=generator, modulus=modulus,
                                   generator=generator)

    def _device_domains(self):
        if self.share is None:
            raise NotImplementedError(
                "device field-share transforms are BN254-Fr-only; this "
                "PackedSharingParams was built over another scalar field "
                "(pack its scalars with ops/scalar_pack.pack_scalars, e.g. "
                "bls12_377.pack_scalars_377)"
            )
        return self.share, self.secret, self.secret2

    # -- field-vector transforms (batched over leading axes) ------------------

    def pack_from_public(self, secrets):
        """(..., l, 16) secrets -> (..., n, 16) shares."""
        assert secrets.shape[-2] == self.l
        share, secret, _ = self._device_domains()
        return share.fft(secret.ifft(secrets))

    def pack_from_public_rand(self, secrets, rng: np.random.Generator):
        """Packing with t+1 uniform-in-Fr random filler points (the hiding
        randomness of the scheme). The fillers are drawn as the JAX package
        draws them — one bulk rng.bytes of 40 bytes per filler, read
        little-endian, reduced mod r — so one seed gives the same shares
        in both packages."""
        assert secrets.shape[-2] == self.l
        share, secret, _ = self._device_domains()
        batch = tuple(secrets.shape[:-2])
        count = int(np.prod(batch, dtype=np.int64)) * (self.t + 1)
        raw = rng.bytes(count * 40)
        vals = np.empty(count, dtype=object)
        for i in range(count):
            vals[i] = int.from_bytes(raw[40 * i : 40 * (i + 1)], "little") % R
        rand = fr().encode(vals.reshape(batch + (self.t + 1,)), secrets.device)
        full = torch.cat([secrets, rand], dim=-2)
        return share.fft(secret.ifft(full))

    def unpack(self, shares):
        """(..., n, 16) degree-(t+l) shares -> (..., l, 16) secrets."""
        assert shares.shape[-2] == self.n
        share, secret, _ = self._device_domains()
        coeffs = share.ifft(shares)[..., : secret.size, :]
        return secret.fft(coeffs)[..., : self.l, :]

    def unpack2(self, shares):
        """(..., n, 16) degree-2(t+l) shares -> (..., l, 16) secrets."""
        assert shares.shape[-2] == self.n
        share, _, secret2 = self._device_domains()
        evals = secret2.fft(share.ifft(shares))
        return evals[..., : 2 * self.l : 2, :]

    # -- linear maps as explicit scalar-field matrices (group elements) -----

    @functools.cached_property
    def pack_matrix(self) -> list[list[int]]:
        """(n, l) ints: shares = M @ secrets."""
        cols = []
        for i in range(self.l):
            e = [0] * self.l
            e[i] = 1
            cols.append(self.share_h.fft(self.secret_h.ifft(e)))
        return [[cols[i][p] for i in range(self.l)] for p in range(self.n)]

    @functools.cached_property
    def unpack_matrix(self) -> list[list[int]]:
        """(l, n) ints: secrets = M @ shares (degree t+l shares)."""
        cols = []
        for j in range(self.n):
            e = [0] * self.n
            e[j] = 1
            coeffs = self.share_h.ifft(e)[: self.secret_h.size]
            cols.append(self.secret_h.fft(coeffs)[: self.l])
        return [[cols[j][i] for j in range(self.n)] for i in range(self.l)]

    @functools.cached_property
    def unpack2_matrix(self) -> list[list[int]]:
        """(l, n) ints: secrets = M @ shares (degree 2(t+l) shares)."""
        cols = []
        for j in range(self.n):
            e = [0] * self.n
            e[j] = 1
            evals = self.secret2_h.fft(self.share_h.ifft(e))
            cols.append(evals[: 2 * self.l : 2])
        return [[cols[j][i] for j in range(self.n)] for i in range(self.l)]

    # -- group-element ("in the exponent") transforms -------------------------

    def _ladder_tensors(self, curve: CurvePoints, which: str):
        """Host tensors (bits, signs, nbits) of the dense ladder of the
        named matrix. bits: (o, K, nbits) int32; signs: (o, K) bool (GLV
        halves can be negative) or None; K = 2k with GLV (bases, then
        their endomorphism images), k without. Cached on the curve object,
        keyed by (l, which); callers move them to their device."""
        cache = curve.__dict__.setdefault("_pss_ladder_cache", {})
        key = (self.l, which)
        if key in cache:
            return cache[key]
        mat = {
            "pack": self.pack_matrix,
            "unpack": self.unpack_matrix,
            "unpack2": self.unpack2_matrix,
        }[which]
        o, k = len(mat), len(mat[0])
        flat = [mat[a][b] for a in range(o) for b in range(k)]
        bits, signs, nbits = fixed_scalar_ladder_tensors(curve, flat)
        # (P, o*k, nbits) -> per output row [part0 | part1 entries]
        P = bits.shape[0]
        bits = (
            bits.reshape(P, o, k, nbits).permute(1, 0, 2, 3)
            .reshape(o, P * k, nbits).contiguous()
        )
        if signs is not None:
            signs = (
                signs.reshape(P, o, k).permute(1, 0, 2).reshape(o, P * k)
                .contiguous()
            )
        cache[key] = (bits, signs, nbits)
        return cache[key]

    def _apply_point_matrix(self, curve: CurvePoints, which: str, pts):
        """out[..., o, :] = sum_i mat[o][i] * pts[..., i, :].

        pts: (..., k) + point shape. One nbits-step ladder through
        ladder_apply on the curve's limb group: the doubling chain runs on
        the (..., K) base set only; the sign-adjusted conditional adds run
        batched over (..., o, K); then a sum over K. K = 2k with GLV
        (BN254 G1), K = k and the full 256-bit ladder without (G2, the
        BLS12 curves)."""
        from ..ops.limb_kernels import ladder_apply

        bits, signs, nbits = self._ladder_tensors(curve, which)
        dev = pts.device
        bits = bits.to(dev)
        signs = None if signs is None else signs.to(dev)
        o = bits.shape[0]
        ax = pts.ndim - 2 - curve.coord_axes  # index of the k axis
        batch = tuple(pts.shape[:ax])
        base = pts
        if curve.glv is not None:
            base = torch.cat([pts, curve.endo(pts)], dim=ax)
        K = base.shape[ax]
        B = int(np.prod(batch, dtype=np.int64))
        g = _msm._limb_group_for(curve)
        rm_flat = base.reshape((B * K, 3) + curve.elem_shape)
        lm = g.from_rowmajor(rm_flat).reshape(g.ROWS, B, K)
        out_lm = ladder_apply(g, lm, bits, signs, nbits)
        out_rm = g.to_rowmajor(out_lm.reshape(g.ROWS, B * o))
        return out_rm.reshape(batch + (o, 3) + curve.elem_shape)

    def packexp_from_public(self, curve: CurvePoints, pts, method="auto"):
        """(..., l) + point -> (..., n) + point (dmsm/mod.rs:61-68)."""
        if self._pick_exp_method(method) == "ntt":
            return pointntt.packexp_ntt(self, curve, pts)
        return self._apply_point_matrix(curve, "pack", pts)

    def unpackexp(
        self, curve: CurvePoints, shares, degree2: bool = False, method="auto"
    ):
        """(..., n) + point -> (..., l) + point (dmsm/mod.rs:7-48)."""
        if self._pick_exp_method(method) == "ntt":
            return pointntt.unpackexp_ntt(self, curve, shares, degree2)
        which = "unpack2" if degree2 else "unpack"
        return self._apply_point_matrix(curve, which, shares)

    def _pick_exp_method(self, method: str) -> str:
        """"dense" (the matrix ladder) or "ntt" (parallel/pointntt.py):
        "auto" takes the point NTT from _NTT_THRESHOLD parties up. The
        point NTT's domains are over BN254 Fr, so over another scalar
        field "ntt" raises and "auto" takes the dense ladder."""
        if method not in ("auto", "dense", "ntt"):
            raise ValueError(f"unknown method {method!r}")
        if self.modulus != R:
            if method == "ntt":
                raise NotImplementedError(
                    "the in-exponent point NTT is BN254-Fr-only; use the "
                    "dense ladder for this scalar field"
                )
            return "dense"
        if method == "auto":
            return "ntt" if self.n >= self._NTT_THRESHOLD else "dense"
        return method


@functools.cache
def pss(l: int) -> PackedSharingParams:
    return PackedSharingParams(l)


# ---------------------------------------------------------------------------
# Host-side ground truth (pure ints) for differential tests
# ---------------------------------------------------------------------------


def pack_host(pp: PackedSharingParams, secrets: list[int]) -> list[int]:
    assert len(secrets) == pp.l
    return pp.share_h.fft(pp.secret_h.ifft(secrets))


def unpack_host(pp: PackedSharingParams, shares: list[int]) -> list[int]:
    coeffs = pp.share_h.ifft(shares)[: pp.secret_h.size]
    return pp.secret_h.fft(coeffs)[: pp.l]


def unpack2_host(pp: PackedSharingParams, shares: list[int]) -> list[int]:
    coeffs = pp.share_h.ifft(shares)
    return pp.secret2_h.fft(coeffs)[: 2 * pp.l : 2]
