"""Distributed partial (prefix) products — the counterpart of
distributed_groth16_tpu/parallel/dpp.py (the reference's
dist-primitives/src/dpp/mod.rs:17-88): given packed shares of num and
den, returns packed shares of num[0]/den[0], (num[0]num[1])/(den[0]den[1]),
...

Protocol: mask with preprocessed randomness s (dummy s = 1, as in the
reference, dpp/mod.rs:24-26), gather num || den to the king, which
unpack2s, divides, computes the prefix products in the clear (a
Hillis-Steele scan under the Montgomery multiply: log2 of the length in
batched products, where the JAX package runs an associative scan and the
reference a sequential loop), re-packs consecutively and scatters; the
parties then run deg_red."""

from __future__ import annotations

import torch

from ..ops.field import fr, inclusive_scan
from .degred import _per_party, deg_red
from .net import Net
from .pss import PackedSharingParams


async def d_pp(num, den, pp: PackedSharingParams, net: Net, sid: int = 0):
    """num, den: (c, 16) per-party packed share vectors."""
    F = fr()
    numden = torch.cat([num, den], dim=0)  # (2c, 16)

    def king(vals):
        x = torch.stack(vals, dim=1)  # (2c, n, 16)
        secrets = pp.unpack2(x).reshape(-1, F.nl)  # chunk-major
        half = secrets.shape[0] // 2  # nums, then dens
        ratio = F.mul(secrets[:half], F.inv(secrets[half:]))
        prefix = inclusive_scan(F.mul, ratio)
        return _per_party(pp, pp.pack_from_public(
            prefix.reshape(-1, pp.l, F.nl)))

    masked = await net.king_compute(numden, king, sid)
    return await deg_red(masked, pp, net, sid)
