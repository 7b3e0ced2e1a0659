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
    (_msm_jit), which is not ported: the tree takes those sizes too.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import N_LIMBS, R
from .curve import CurvePoints, scalar_bits
from .field import resolve_device

TREE_MSM_MIN_N = 1024
LADDER_MSM_MAX_N = 128


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


def msm(curve: CurvePoints, points, scalars):
    """sum_i scalars[i] * points[i].

    points:  (n, 3) + elem_shape projective points.
    scalars: (n, k) limbs in STANDARD (non-Montgomery) form, k >= 16
             (the 17-limb standard form of an Fr381 share is accepted:
             every supported r is below 2^256, so the extra limb is zero).
    Returns one projective point (3,) + elem_shape.
    """
    n = points.shape[0]
    assert scalars.shape[-1] >= N_LIMBS and scalars.shape[0] == n
    if n >= TREE_MSM_MIN_N or n > LADDER_MSM_MAX_N:
        from .limb_kernels import msm_tree

        return msm_tree(points, scalars, group=_limb_group_for(curve))
    return _msm_ladder(curve, points, scalars)


def encode_scalars_std(values, device=None) -> torch.Tensor:
    """Python ints -> (n, 16) standard-form int32 limbs (reduced mod r)."""
    buf = b"".join((int(v) % R).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return torch.as_tensor(
        arr.reshape(-1, N_LIMBS), device=resolve_device(device)
    )
