"""Extended witness: distributed computation of the h vector — the
counterpart of distributed_groth16_tpu/models/groth16/ext_wit.py (the
reference's groth16/src/ext_wit.rs:16-101).

Three concurrent d_ifft(rearrange=True, pad=2) on channels 0/1/2, three
concurrent d_fft on the doubled domain that leave the clear 2m
evaluations on the king (king_clear), then the king forms
h = p * q - w and keeps the odd-root entries (the snarkjs /
CircomReduction semantics), packs them consecutively and scatters.
"""

from __future__ import annotations

import asyncio

import torch

from ...ops.field import fr
from ...ops.ntt import domain
from ...parallel.dfft import d_fft, d_ifft
from ...parallel.net import Net
from ...parallel.pss import PackedSharingParams
from .qap import PackedQAPShare


async def h(qap_share: PackedQAPShare, pp: PackedSharingParams, net: Net):
    """Returns this party's (m/l, 16) packed share of the h vector."""
    dom = qap_share.domain
    dom2 = domain(2 * dom.size)
    p_c, q_c, w_c = await asyncio.gather(
        d_ifft(qap_share.a, True, 2, False, dom, pp, net, 0),
        d_ifft(qap_share.b, True, 2, False, dom, pp, net, 1),
        d_ifft(qap_share.c, True, 2, False, dom, pp, net, 2),
    )
    p, q, w = await asyncio.gather(
        d_fft(p_c, False, 1, False, dom2, pp, net, 0, king_clear=True),
        d_fft(q_c, False, 1, False, dom2, pp, net, 1, king_clear=True),
        d_fft(w_c, False, 1, False, dom2, pp, net, 2, king_clear=True),
    )
    out = None
    if net.is_king:
        per_party = king_combine_h(p, q, w, pp)
        out = [per_party[i] for i in range(pp.n)]
    return await net.scatter_from_king(out, 0)


def king_combine_h(p, q, w, pp: PackedSharingParams) -> torch.Tensor:
    """King-side combine: h = (p * q - w) at the ODD 2m-th roots, packed
    consecutively per party. Inputs are clear (..., 2m, 16) evaluation
    vectors in NATURAL domain order, where the odd-coset entries (those at
    w_2m^(2i+1)) are every second element, [..., 1::2, :]. Output is
    (n, ..., m/l, 16)."""
    F = fr()
    h_odd = F.sub(F.mul(p, q), w)[..., 1::2, :]  # (..., m, 16)
    packed = pp.pack_from_public(
        h_odd.reshape(h_odd.shape[:-2] + (-1, pp.l, 16))
    )  # (..., m/l, n, 16)
    return torch.movedim(packed, -2, 0)
