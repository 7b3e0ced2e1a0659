"""Distributed MSM over packed shares — the counterpart of
distributed_groth16_tpu/parallel/dmsm.py (the reference's d_msm,
dist-primitives/src/dmsm/mod.rs:70-98).

Every party runs one local MSM over its c = ceil(k/l) packed-share (base,
scalar) pairs — the tree MSM, kernels 1 and 3, on a CUDA tensor at
c >= TREE_MSM_MIN_N — giving one group element whose sharing polynomial
has degree 2(t+l). The king gathers the n points, unpacks them in the
exponent (degree2), sums the l partial MSMs and hands the one result
tensor back to every party.
"""

from __future__ import annotations

import torch

from ..ops.curve import CurvePoints
from ..ops.field import fr
from ..ops.msm import msm
from .net import Net
from .pss import PackedSharingParams


async def d_msm(curve: CurvePoints, bases, scalar_shares,
                pp: PackedSharingParams, net: Net, sid: int = 0,
                scalar_field=None):
    """bases: (c, 3) + elem packed-in-the-exponent CRS shares;
    scalar_shares: (c, nl) Montgomery packed witness shares. Returns the
    clear MSM result (3,) + elem on every party (the same tensor object).

    scalar_field: the PrimeField the shares live in (None: BN254 Fr);
    bls12_377.fr377() with pss377(l) is the reference's BLS12-377
    configuration (dmsm_bench.rs:42-50). A wide standard form (17-limb
    Fr381) passes to the local MSM as it is."""
    F = scalar_field or fr()
    local = msm(curve, bases, F.from_mont(scalar_shares))

    def king(points):
        stacked = torch.stack(points, dim=0)  # (n, 3) + elem
        partials = pp.unpackexp(curve, stacked, degree2=True)  # (l, 3) + elem
        total = curve.sum(partials, axis=0)
        return [total] * pp.n

    return await net.king_compute(local, king, sid)
