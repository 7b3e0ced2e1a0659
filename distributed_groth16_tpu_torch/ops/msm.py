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
  * an explicit window_bits or chunk pins the JAX package's Pippenger
    (_msm_pippenger; its group ops on the limb group, kernels 1 and 2 on
    a CUDA tensor), chunk running it on consecutive chunks and adding
    the parts.

Above TREE_MSM_MAX_N points the tree route runs msm_tree over consecutive
chunks of at most that many points and adds the partial results on the
limb group (kernel 1 on the card). The JAX package runs one tree over
all points; the tree keeps every level of its sum tree, so one 2^24-point
BLS12-381 tree does not fit on an 80 GB card. An MSM is linear, so the
result is the same point.

Each call counts its route in kernel_route_total{kernel, path} at
dispatch, as the JAX package does. kernel="msm": "tree", "ladder",
"pippenger" and "pippenger_chunked" where the port runs what the JAX
package's path of that name runs; "tree" also for 128 < n < 1024, where
the JAX package runs (and counts) its Pippenger; "tree_chunked" for the
tree over chunks above TREE_MSM_MAX_N, which the JAX package does not
have. kernel="msm_batched": "tree" (one batched tree), "tree_chunked"
(a tree per entry, entries above TREE_MSM_MAX_N) and "ladder"; the JAX
package's "pippenger_vmap" has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..telemetry import metrics as _tm
from .constants import LIMB_BITS, N_LIMBS, R
from .curve import CurvePoints, g1, g2, scalar_bits
from .field import inclusive_scan, resolve_device

TREE_MSM_MIN_N = 1024
LADDER_MSM_MAX_N = 128
TREE_MSM_MAX_N = 1 << 23

# scalar bits the Pippenger windows cover (every supported r < 2^256)
_SCALAR_BITS = 256

# which implementation ran, counted at dispatch (the module docstring lists
# the paths); pre-bound children: one dict lookup + add per call
_ROUTE = _tm.registry().counter(
    "kernel_route_total",
    "Kernel-path routing decisions at dispatch/trace time, per kernel "
    "and chosen implementation path",
    ("kernel", "path"),
)
_R_TREE = _ROUTE.labels(kernel="msm", path="tree")
_R_TREE_CHUNKED = _ROUTE.labels(kernel="msm", path="tree_chunked")
_R_LADDER = _ROUTE.labels(kernel="msm", path="ladder")
_R_PIPPENGER = _ROUTE.labels(kernel="msm", path="pippenger")
_R_CHUNKED = _ROUTE.labels(kernel="msm", path="pippenger_chunked")
_RB_TREE = _ROUTE.labels(kernel="msm_batched", path="tree")
_RB_TREE_CHUNKED = _ROUTE.labels(kernel="msm_batched", path="tree_chunked")
_RB_LADDER = _ROUTE.labels(kernel="msm_batched", path="ladder")


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
    """The JAX package's row-major Pippenger (_msm_jit): per c-bit window
    the points are sorted by digit and prefix-summed; with T the sum of
    all points and C_j the prefix through bucket j,
    sum_b b S_b = sum_{j=0..B-2} (T - C_j); the windows combine by
    Horner (c doublings and one add a window). Its group ops run on the
    curve's limb group, one point a column (kernels 1 and 2 on a card:
    a group op is one launch where the row-major ops take ~100 small
    ones; their plain versions on the CPU), in the JAX package's order,
    so the result is the same point, canonical row-major."""
    g = _limb_group_for(curve)
    dev = points.device
    B = 1 << c
    pts = g.from_rowmajor(points)  # (ROWS, n)
    buckets = torch.arange(B - 1, device=dev)
    inf = g.infinity(B - 1, dev)
    acc = g.infinity(1, dev)

    def col_add(a, b):  # group add on (k, ROWS) views, as inclusive_scan
        return g.add(a.t(), b.t()).t()

    for w in range(_SCALAR_BITS // c - 1, -1, -1):
        for _ in range(c):
            acc = g.double(acc)
        digits = _digits_for_window(scalars, w, c)
        order = torch.argsort(digits, stable=True)
        prefix = inclusive_scan(col_add, pts[:, order].t()).t()
        ends = torch.searchsorted(digits[order], buckets, right=True)
        cum = torch.where(ends > 0, prefix[:, (ends - 1).clamp(min=0)], inf)
        terms = g.add(prefix[:, -1:].expand(cum.shape), g.neg(cum))
        # curve.sum's pairwise tree over the B - 1 columns
        while terms.shape[1] > 1:
            half = terms.shape[1] // 2
            s = g.add(terms[:, :half], terms[:, half : 2 * half])
            terms = torch.cat([s, terms[:, 2 * half :]], dim=1)
        acc = g.add(acc, terms)
    return g.to_rowmajor(acc)[0]


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
            (_R_TREE if n <= TREE_MSM_MAX_N else _R_TREE_CHUNKED).inc()
            return _msm_tree(curve, points, scalars)
        _R_LADDER.inc()
        return _msm_ladder(curve, points, scalars)
    if window_bits is None:
        window_bits = 16 if n >= (1 << 14) else 8 if n >= 64 else 4
    assert LIMB_BITS % window_bits == 0, "window must divide the 16-bit limb"
    if chunk is None or chunk >= n:
        _R_PIPPENGER.inc()
        return _msm_pippenger(curve, points, scalars, window_bits)
    _R_CHUNKED.inc()
    acc = curve.infinity((), points.device)
    for s in range(0, n, chunk):
        part = _msm_pippenger(curve, points[s : s + chunk],
                              scalars[s : s + chunk], window_bits)
        acc = curve.add(acc, part)
    return acc


def msm_batched(curve: CurvePoints, bases, scalars_std, bases_of=None):
    """B same-length MSMs: (P, n, 3) + elem bases and (B, n, k)
    standard-form scalars -> (B, 3) + elem, entry b over the base set
    bases_of[b] (None: P == B, set b). Routed as msm: above
    LADDER_MSM_MAX_N points all B entries go through one batched tree MSM
    (limb_kernels.msm_tree_batched: a shared base set is gathered in
    place, not copied per entry), entry by entry above TREE_MSM_MAX_N;
    the JAX package runs one vmapped Pippenger below TREE_MSM_MIN_N, where
    the port's tree takes those sizes as msm's does. Else one batched
    ladder and a sequential sum. The ladder stops after the highest bit
    any scalar sets (one read of the device): a later step would only
    double its base, so the result is the same limbs as the JAX package's
    256-step ladder."""
    from .limb_kernels import msm_tree_batched

    B, n = scalars_std.shape[0], scalars_std.shape[1]
    if n >= TREE_MSM_MIN_N or n > LADDER_MSM_MAX_N:
        if n <= TREE_MSM_MAX_N:
            _RB_TREE.inc()
            return msm_tree_batched(bases, scalars_std, bases_of,
                                    group=_limb_group_for(curve))
        _RB_TREE_CHUNKED.inc()
        return torch.stack([
            _msm_tree(curve, bases[b if bases_of is None else bases_of[b]],
                      scalars_std[b])
            for b in range(B)
        ])
    _RB_LADDER.inc()
    if bases_of is not None:
        bases = bases[bases_of]
    bits = scalar_bits(scalars_std)
    used = torch.nonzero(bits.flatten(0, -2).any(0))
    top = int(used.max()) + 1 if used.numel() else 0
    acc = curve.scalar_mul_bits(bases, bits[..., :top])
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
