"""Multi-scalar multiplication for BN254 G1/G2 and the BLS12-377 G1 /
BLS12-381 G1, G2 groups — the counterpart of
distributed_groth16_tpu/ops/msm.py.

Routing (module constants, so a test can lower them to reach a route at a
small size):

  * n >= TREE_MSM_MIN_N: the limb-major tree MSM (ops/limb_kernels.py,
    kernels 1 and 3 on a CUDA tensor, at 8 words for BN254 and 12 for
    the BLS12 curves);
  * n <= LADDER_MSM_MAX_N: one batched double-and-add ladder and a
    sequential sum;
  * between the two the JAX package runs its row-major Pippenger
    (_msm_jit); the port takes the tree there too;
  * an explicit window_bits or chunk pins the row-major Pippenger
    (_msm_pippenger, plain PyTorch as the JAX package's is plain XLA),
    chunk running it on consecutive chunks and adding the parts.

Above TREE_MSM_MAX_N points the tree route runs msm_tree over consecutive
chunks of at most that many points and adds the partial results on the
limb group (kernel 1 on the card). The JAX package runs one tree over
all points; the tree keeps every level of its sum tree, so one 2^24-point
BLS12-381 tree does not fit on an 80 GB card. An MSM is linear, so the
result is the same point.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import LIMB_BITS, N_LIMBS, R
from .curve import CurvePoints, g1, g2, scalar_bits
from .field import inclusive_scan, resolve_device

TREE_MSM_MIN_N = 1024
LADDER_MSM_MAX_N = 128
TREE_MSM_MAX_N = 1 << 23

# scalar bits the Pippenger windows cover (every supported r < 2^256)
_SCALAR_BITS = 256


def _limb_group_for(curve: CurvePoints):
    """The LimbGroup of this curve's base field and extension degree, as
    the JAX package's ops/msm.py picks it: BN254 G1/G2, BLS12-377 G1,
    BLS12-381 G1/G2. Any other curve raises."""
    from . import limb_kernels as lk
    from .bls12_377 import Q377
    from .bls12_381 import Q381
    from .constants import Q

    ext2 = curve.coord_axes == 2
    if curve.base_p == Q:
        return lk.lg2() if ext2 else lk.lg1()
    if curve.base_p == Q377 and not ext2:
        return lk.lg1_377()
    if curve.base_p == Q381:
        return lk.lg2_381() if ext2 else lk.lg1_381()
    raise NotImplementedError(
        "no limb group for this curve (BN254 G1/G2, BLS12-377 G1 and "
        "BLS12-381 G1/G2 have one)"
    )


def _msm_ladder(curve: CurvePoints, points, scalars):
    """Small-n MSM as one batched ladder + a sequential accumulation."""
    acc = curve.scalar_mul_bits(points, scalar_bits(scalars))
    return curve.sum_sequential(acc, axis=0)


def _msm_tree(curve: CurvePoints, points, scalars):
    """The tree MSM, over chunks of at most TREE_MSM_MAX_N points whose
    results are added on the limb group."""
    from .limb_kernels import msm_tree

    g = _limb_group_for(curve)
    n = points.shape[0]
    if n <= TREE_MSM_MAX_N:
        return msm_tree(points, scalars, group=g)
    acc = None
    for s in range(0, n, TREE_MSM_MAX_N):
        e = s + TREE_MSM_MAX_N
        part = g.from_rowmajor(msm_tree(points[s:e], scalars[s:e],
                                        group=g)[None])
        acc = part if acc is None else g.add(acc, part)
    return g.to_rowmajor(acc)[0]


def _digits_for_window(scalars, w: int, c: int):
    """The w-th c-bit digit of each standard-form scalar (n, k) -> (n,)
    int64 in [0, 2^c)."""
    per_limb = LIMB_BITS // c
    limb = scalars[:, w // per_limb].long()
    return (limb >> ((w % per_limb) * c)) & ((1 << c) - 1)


def _msm_pippenger(curve: CurvePoints, points, scalars, c: int):
    """Row-major Pippenger, the JAX package's _msm_jit: per c-bit window
    the points are sorted by digit and prefix-summed; with T the sum of
    all points and C_j the prefix through bucket j,
    sum_b b S_b = sum_{j=0..B-2} (T - C_j); the windows combine by
    Horner (c doublings and one add a window)."""
    dev = points.device
    B = 1 << c
    buckets = torch.arange(B - 1, device=dev)
    inf = curve.infinity((B - 1,), dev)
    acc = curve.infinity((), dev)
    for w in range(_SCALAR_BITS // c - 1, -1, -1):
        for _ in range(c):
            acc = curve.double(acc)
        digits = _digits_for_window(scalars, w, c)
        order = torch.argsort(digits, stable=True)
        prefix = inclusive_scan(curve.add, points[order])
        ends = torch.searchsorted(digits[order], buckets, right=True)
        cum = curve.select(ends > 0, prefix[(ends - 1).clamp(min=0)], inf)
        terms = curve.add(prefix[-1].expand(cum.shape), curve.neg(cum))
        acc = curve.add(acc, curve.sum(terms, axis=0))
    return acc


def msm(curve: CurvePoints, points, scalars, window_bits: int | None = None,
        chunk: int | None = None):
    """sum_i scalars[i] * points[i].

    points:  (n, 3) + elem_shape projective points.
    scalars: (n, k) limbs in STANDARD (non-Montgomery) form, k >= 16
             (the 17-limb standard form of an Fr381 share is accepted:
             every supported r is below 2^256, so the extra limb is zero).
    window_bits: Pippenger window c (must divide 16); chunk: Pippenger
             over chunks of this many points. Either pins the Pippenger.
    Returns one projective point (3,) + elem_shape.
    """
    n = points.shape[0]
    assert scalars.shape[-1] >= N_LIMBS and scalars.shape[0] == n
    if window_bits is None and chunk is None:
        if n >= TREE_MSM_MIN_N or n > LADDER_MSM_MAX_N:
            return _msm_tree(curve, points, scalars)
        return _msm_ladder(curve, points, scalars)
    if window_bits is None:
        window_bits = 16 if n >= (1 << 14) else 8 if n >= 64 else 4
    assert LIMB_BITS % window_bits == 0, "window must divide the 16-bit limb"
    if chunk is None or chunk >= n:
        return _msm_pippenger(curve, points, scalars, window_bits)
    acc = curve.infinity((), points.device)
    for s in range(0, n, chunk):
        part = _msm_pippenger(curve, points[s : s + chunk],
                              scalars[s : s + chunk], window_bits)
        acc = curve.add(acc, part)
    return acc


def msm_batched(curve: CurvePoints, bases, scalars_std):
    """B same-length MSMs: (B, n, 3) + elem bases and (B, n, k)
    standard-form scalars -> (B, 3) + elem. Routed as msm: the tree MSM
    per batch entry above LADDER_MSM_MAX_N points (where the JAX package
    runs one vmapped Pippenger below TREE_MSM_MIN_N, the port's tree takes
    those sizes as msm's does), else one batched ladder and a sequential
    sum."""
    B, n = scalars_std.shape[0], scalars_std.shape[1]
    if n >= TREE_MSM_MIN_N or n > LADDER_MSM_MAX_N:
        return torch.stack([_msm_tree(curve, bases[b], scalars_std[b])
                            for b in range(B)])
    acc = curve.scalar_mul_bits(bases, scalar_bits(scalars_std))
    return curve.sum_sequential(acc, axis=1)


def msm_g1(points, scalars, **kw):
    return msm(g1(), points, scalars, **kw)


def msm_g2(points, scalars, **kw):
    return msm(g2(), points, scalars, **kw)


def encode_scalars_std(values, device=None) -> torch.Tensor:
    """Python ints -> (n, 16) standard-form int32 limbs (reduced mod r)."""
    buf = b"".join((int(v) % R).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return torch.as_tensor(
        arr.reshape(-1, N_LIMBS), device=resolve_device(device)
    )
