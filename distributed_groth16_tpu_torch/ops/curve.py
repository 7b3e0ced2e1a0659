"""Branchless projective arithmetic for short-Weierstrass G1/G2 (a = 0) on
row-major tensors — the counterpart of distributed_groth16_tpu/ops/curve.py.

Points are homogeneous projective (X : Y : Z) int32 limb tensors — G1:
(..., 3, nl), G2: (..., 3, 2, nl); nl = 16 for BN254, 24 for the BLS12
curves (ops/bls12_377.py, ops/bls12_381.py) — under the complete RCB16
formulas for a = 0 (algorithms 7 and 9); infinity is (0 : 1 : 0). Every
coordinate is canonical, so any correct evaluation order gives the same
limbs as the JAX package; independent products of a formula step run as
one stacked field multiply.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import G1_B, G2_B, N_LIMBS, R, to_limbs
from .field import fq, fq2


class CurvePoints:
    """Vectorized projective point ops over a coordinate field: a
    PrimeField (G1, elem_shape (nl,)) or Fq2Ops (G2, elem_shape (2, nl)).
    scalar_order is the order r of the scalar group (None: BN254 Fr)."""

    def __init__(self, field, b, elem_shape, glv=None, scalar_order=None):
        self.F = field
        self.r = scalar_order if scalar_order is not None else R
        self.elem_shape = elem_shape
        self.coord_axes = len(elem_shape)
        p = field.p if hasattr(field, "p") else field.fq.p
        self.base_p = p
        b3 = tuple(3 * c % p for c in b) if isinstance(b, tuple) else 3 * b % p
        base = field.fq if self.coord_axes == 2 else field
        self._b_np = base.encode_np([b])[0]  # b, Montgomery
        self._b3_np = base.encode_np([b3])[0]  # 3b, Montgomery
        # GLV endomorphism parameters (ops/glv.py), or None (G2): fixed-
        # scalar ladders then run full-width double-and-add
        self.glv = glv
        self._beta_np = field.encode_np([glv.beta])[0] if glv else None

    # -- construction / conversion -------------------------------------------

    def encode(self, points, device=None) -> torch.Tensor:
        """List of affine (x, y) tuples / None (infinity) -> tensor."""
        flat = []
        for pt in points:
            if pt is None:
                flat.append((0, 1, 0) if self.coord_axes == 1
                            else ((0, 0), (1, 0), (0, 0)))
            else:
                x, y = pt
                flat.append((x, y, 1) if self.coord_axes == 1
                            else (x, y, (1, 0)))
        return self.F.encode(flat, device)

    def decode(self, pts):
        """Projective points -> list of affine int tuples / None (host)."""
        from .primemath import fq2_inv as f2inv, fq2_mul as f2mul
        from .refmath import finv

        arr = np.asarray(self.F.decode(pts), dtype=object)
        batch = arr.shape[: arr.ndim - 1 - (self.coord_axes - 1)]
        flat = arr.reshape((-1, 3) + ((2,) if self.coord_axes == 2 else ()))
        p_mod = self.base_p
        out = []
        for row in flat:
            if self.coord_axes == 1:
                x, y, z = int(row[0]), int(row[1]), int(row[2])
                if z == 0:
                    out.append(None)
                else:
                    zi = finv(z, p_mod)
                    out.append((x * zi % p_mod, y * zi % p_mod))
            else:
                x = (int(row[0][0]), int(row[0][1]))
                y = (int(row[1][0]), int(row[1][1]))
                z = (int(row[2][0]), int(row[2][1]))
                if z == (0, 0):
                    out.append(None)
                else:
                    zi = f2inv(z, p_mod)
                    out.append((f2mul(x, zi, p_mod), f2mul(y, zi, p_mod)))
        if batch == ():
            return out[0]
        if len(batch) == 1:
            return out
        obj = np.empty(len(out), dtype=object)
        for i, v in enumerate(out):
            obj[i] = v
        return obj.reshape(batch).tolist()

    def infinity(self, shape=(), device=None):
        """(0 : 1 : 0) broadcast to the given batch shape."""
        z, o = self.F.consts(shape, device)
        ax = -1 - self.coord_axes
        return torch.stack([z, o, z], dim=ax)

    def _coords(self, p):
        ax = -1 - self.coord_axes
        return p.select(ax, 0), p.select(ax, 1), p.select(ax, 2)

    def _pack(self, x, y, z):
        return torch.stack([x, y, z], dim=-1 - self.coord_axes)

    def _eq(self, a, b):
        """Equality of canonical coordinate-field elements (batch shape)."""
        return torch.all((a == b).flatten(-self.coord_axes), dim=-1)

    def is_infinity(self, p):
        _, _, z = self._coords(p)
        return torch.all((z == 0).flatten(-self.coord_axes), dim=-1)

    # -- group law (complete, branchless) ------------------------------------

    def _many(self, op, lhs, rhs):
        """One stacked field op over a new leading axis."""
        xs = torch.broadcast_tensors(*lhs, *rhs)
        return op(torch.stack(xs[: len(lhs)]), torch.stack(xs[len(lhs) :]))

    def add(self, p, q):
        """Complete projective addition (RCB16 algorithm 7, a = 0)."""
        F = self.F
        p, q = torch.broadcast_tensors(p, q)
        X1, Y1, Z1 = self._coords(p)
        X2, Y2, Z2 = self._coords(q)
        b3 = torch.as_tensor(self._b3_np, device=p.device)
        s = self._many(F.add, [X1, Y1, X1, X2, Y2, X2],
                       [Y1, Z1, Z1, Y2, Z2, Z2])
        r1 = self._many(F.mul, [X1, Y1, Z1, s[0], s[1], s[2]],
                        [X2, Y2, Z2, s[3], s[4], s[5]])
        t0, t1, t2 = r1[0], r1[1], r1[2]
        u = self._many(F.add, [t0, t1, t0], [t1, t2, t2])
        d = F.sub(r1[3:6], u)  # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1
        t3, t4, ty = d[0], d[1], d[2]
        t0 = F.add(F.add(t0, t0), t0)  # 3 X1X2
        r2 = self._many(F.mul, [t2, ty], [b3, b3])
        t2b, yb = r2[0], r2[1]
        Z3 = F.add(t1, t2b)
        t1 = F.sub(t1, t2b)
        r3 = self._many(F.mul, [t3, t4, yb, t1, t0, Z3],
                        [t1, yb, t0, Z3, t3, t4])
        X3 = F.sub(r3[0], r3[1])
        yz = self._many(F.add, [r3[2], r3[5]], [r3[3], r3[4]])
        return self._pack(X3, yz[0], yz[1])

    def double(self, p):
        """Complete projective doubling (RCB16 algorithm 9, a = 0)."""
        F = self.F
        X, Y, Z = self._coords(p)
        b3 = torch.as_tensor(self._b3_np, device=p.device)
        r1 = self._many(F.mul, [Y, Y, Z, X], [Y, Z, Z, Y])
        t0, t1, t2, txy = r1[0], r1[1], r1[2], r1[3]
        z8 = F.add(t0, t0)
        z8 = F.add(z8, z8)
        z8 = F.add(z8, z8)  # 8 Y^2
        t2b = F.mul(t2, b3)
        y3a = F.add(t0, t2b)
        t0 = F.sub(t0, F.add(F.add(t2b, t2b), t2b))
        r3 = self._many(F.mul, [t2b, t1, t0, t0], [z8, z8, y3a, txy])
        Y3 = F.add(r3[0], r3[2])
        X3 = F.add(r3[3], r3[3])
        return self._pack(X3, Y3, r3[1])

    def neg(self, p):
        X, Y, Z = self._coords(p)
        return self._pack(X, self.F.neg(Y), Z)

    def endo(self, p):
        """The GLV endomorphism phi(X:Y:Z) = (beta*X : Y : Z) with
        phi(P) = lambda*P (ops/glv.py). Only for curves with `glv` set."""
        X, Y, Z = self._coords(p)
        beta = torch.as_tensor(self._beta_np, device=p.device)
        return self._pack(self.F.mul(X, beta), Y, Z)

    def select(self, cond, p, q):
        """where(cond, p, q) with cond of batch shape."""
        c = cond
        for _ in range(self.coord_axes + 1):
            c = c[..., None]
        return torch.where(c, p, q)

    # -- derived ops ----------------------------------------------------------

    def scalar_mul_bits(self, p, bits):
        """p * k with k a (..., nbits) 0/1 tensor (LSB first), broadcast
        against p's batch shape. Double-and-add over every bit."""
        nb = p.ndim - 1 - self.coord_axes
        batch = torch.broadcast_shapes(p.shape[:nb], bits.shape[:-1])
        shape = batch + p.shape[nb:]
        acc = self.infinity(batch, p.device)
        base = p.expand(shape)
        for i in range(bits.shape[-1]):
            acc = self.select(bits[..., i] == 1, self.add(acc, base), acc)
            base = self.double(base)
        return acc

    def sum(self, pts, axis=0):
        """Tree-reduce point sum along a batch axis (log n add rounds)."""
        ax = axis % (pts.ndim - 1 - self.coord_axes)
        pts = torch.movedim(pts, ax, 0)
        n = pts.shape[0]
        while n > 1:
            half = n // 2
            s = self.add(pts[:half], pts[half : 2 * half])
            if n % 2:
                s = torch.cat([s, pts[2 * half :][:1]], dim=0)
            pts = s
            n = pts.shape[0]
        return pts[0]

    def sum_sequential(self, pts, axis=0):
        """Point sum along an axis, one add at a time."""
        ax = axis % (pts.ndim - 1 - self.coord_axes)
        pts = torch.movedim(pts, ax, 0)
        acc = self.infinity(pts.shape[1 : pts.ndim - 1 - self.coord_axes],
                            pts.device)
        for i in range(pts.shape[0]):
            acc = self.add(acc, pts[i])
        return acc

    def from_affine(self, aff, inf_mask=None):
        """(..., 2) + elem affine coordinates (and an optional infinity
        mask of batch shape) -> projective points."""
        ax = -1 - self.coord_axes
        x, y = aff.select(ax, 0), aff.select(ax, 1)
        batch = x.shape[: x.ndim - self.coord_axes]
        _, one = self.F.consts(batch, aff.device)
        p = self._pack(x, y, one)
        if inf_mask is not None:
            p = self.select(inf_mask, self.infinity(batch, aff.device), p)
        return p

    def is_on_curve(self, p):
        """Y^2 Z == X^3 + b Z^3 (holds at infinity)."""
        F = self.F
        X, Y, Z = self._coords(p)
        b = torch.as_tensor(self._b_np, device=p.device)
        lhs = F.mul(F.mul(Y, Y), Z)
        z3 = F.mul(F.mul(Z, Z), Z)
        rhs = F.add(F.mul(F.mul(X, X), X), F.mul(b, z3))
        return self._eq(lhs, rhs)

    def eq(self, p, q):
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1, and
        infinity equals only infinity."""
        F = self.F
        X1, Y1, Z1 = self._coords(p)
        X2, Y2, Z2 = self._coords(q)
        ex = self._eq(F.mul(X1, Z2), F.mul(X2, Z1))
        ey = self._eq(F.mul(Y1, Z2), F.mul(Y2, Z1))
        i1, i2 = self.is_infinity(p), self.is_infinity(q)
        return (i1 & i2) | (ex & ey & ~(i1 ^ i2))

    def to_affine(self, pts):
        """Projective -> affine (x, y) coords; infinity -> (0, 0).
        One batched inversion over the flattened batch."""
        X, Y, Z = self._coords(pts)
        nl = self.elem_shape[-1]
        if self.coord_axes == 1:
            zinv = self.F.batch_inv(Z.reshape(-1, nl)).reshape(Z.shape)
        else:
            f = self.F.fq
            a0 = Z[..., 0, :].reshape(-1, nl)
            a1 = Z[..., 1, :].reshape(-1, nl)
            ninv = f.batch_inv(f.add(f.sqr(a0), f.sqr(a1)))
            zinv = torch.stack(
                [f.mul(a0, ninv), f.neg(f.mul(a1, ninv))], dim=-2
            ).reshape(Z.shape)
        xy = self.F.mul(torch.stack([X, Y]), zinv)
        return torch.stack([xy[0], xy[1]], dim=-1 - self.coord_axes)


@functools.cache
def g1() -> CurvePoints:
    from .glv import bn254_g1_glv

    return CurvePoints(fq(), G1_B, (N_LIMBS,), glv=bn254_g1_glv())


@functools.cache
def g2() -> CurvePoints:
    return CurvePoints(fq2(), G2_B, (2, N_LIMBS))


def fixed_scalar_ladder_tensors(curve: CurvePoints, scalars):
    """Ladder tensors for a flat list of FIXED scalars: (bits, signs,
    nbits), host (CPU) tensors.

    The shared precomputation of the fixed-scalar point transforms
    (parallel/pss.py dense matrices). Under GLV (curve.glv set) each
    scalar splits into two signed ~129-bit halves applied to {P, phi(P)}:
    bits (2, S, nbits) int32, signs (2, S) bool, part 0 = k1 on P, part
    1 = k2 on phi(P). Without GLV: bits (1, S, nbits=256), signs None.
    Scalars are reduced mod curve.r, the curve's own group order (not
    through encode_scalars_std, which reduces mod BN254 Fr: r381 is
    larger).
    """

    def raw_limbs(vals):
        return torch.as_tensor(
            np.array([to_limbs(v) for v in vals], dtype=np.int32)
        )

    s = [v % curve.r for v in scalars]
    n = len(s)
    if curve.glv is not None:
        nbits = curve.glv.max_bits
        halves = [curve.glv.decompose(v) for v in s]
        flat = [abs(h[p]) for p in (0, 1) for h in halves]
        sgn = [h[p] < 0 for p in (0, 1) for h in halves]
        bits = scalar_bits(raw_limbs(flat), nbits).reshape(2, n, nbits)
        signs = torch.as_tensor(np.array(sgn, dtype=bool).reshape(2, n))
        return bits, signs, nbits
    bits = scalar_bits(raw_limbs(s), 256).reshape(1, n, 256)
    return bits, None, 256


def scalar_bits(scalars, nbits: int = 256) -> torch.Tensor:
    """Standard-form scalar limbs (..., 16) -> bit tensor (..., nbits)."""
    from .constants import LIMB_BITS

    i = torch.arange(nbits, device=scalars.device)
    limb = scalars[..., i // LIMB_BITS]
    return (limb >> (i % LIMB_BITS)) & 1
