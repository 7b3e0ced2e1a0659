"""King-mediated degree reduction — the counterpart of
distributed_groth16_tpu/parallel/degred.py (the reference's
dist-primitives/src/utils/deg_red.rs:10-28): gather degree-2(t+l)
shares, unpack2 and re-pack every chunk on the king (batched field NTTs),
scatter fresh degree-(t+l) shares."""

from __future__ import annotations

import torch

from .net import Net
from .pss import PackedSharingParams


def _per_party(pp: PackedSharingParams, out):
    """(c, n, 16) king output -> one (c, 16) share vector per party."""
    return [out[:, i].contiguous() for i in range(pp.n)]


async def deg_red(px, pp: PackedSharingParams, net: Net, sid: int = 0):
    """px: (c, 16) per-party share vector -> (c, 16) reduced-degree
    shares."""

    def king(vals):
        x = torch.stack(vals, dim=1)  # (c, n, 16)
        return _per_party(pp, pp.pack_from_public(pp.unpack2(x)))

    return await net.king_compute(px, king, sid)
