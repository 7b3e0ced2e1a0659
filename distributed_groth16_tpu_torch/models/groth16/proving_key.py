"""CRS sharding: pack the proving key for every party — the counterpart
of distributed_groth16_tpu/models/groth16/proving_key.py (the reference's
groth16/src/proving_key.rs:19-110). Per party,

  s = pack(a_query[1..]),  u = pack(h_query),  w = pack(l_query),
  h = pack(b_g1_query[1..]),  v = pack(b_g2_query[1..])  (G2)

each chunked by l, through the in-exponent PSS transform (parallel/pss.py
packexp_from_public: one batched GLV ladder per G1 query, a full-width
ladder for the G2 query). This is the JAX package's point route, the one
it takes for every key without dealer scalars — every loaded key. Its
scalar route (field-NTT pack of the setup's query discrete logs, then
fixed-base muls) is not ported yet.

Tail chunks are padded with the point at infinity, which is sound because
the per-chunk inner product the PSS encodes is unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.curve import CurvePoints, g1, g2
from ...parallel.pss import PackedSharingParams
from .keys import ProvingKey


def _pack_query(curve: CurvePoints, pp: PackedSharingParams, pts):
    """(k, 3) + elem projective points -> (n, ceil(k/l), 3) + elem shares,
    each party's share contiguous."""
    k = pts.shape[0]
    rem = (-k) % pp.l
    if rem:
        inf = curve.infinity((rem,), pts.device)
        pts = torch.cat([pts, inf], dim=0)
    chunks = pts.reshape((pts.shape[0] // pp.l, pp.l) + pts.shape[1:])
    shares = pp.packexp_from_public(curve, chunks)  # (c, n, 3) + elem
    return shares.transpose(0, 1).contiguous()


@dataclass
class PackedProvingKeyShare:
    """One party's CRS share (proving_key.rs:19-25)."""

    s: torch.Tensor  # (c_s, 3, 16) G1
    u: torch.Tensor  # (m/l, 3, 16) G1
    v: torch.Tensor  # (c_v, 3, 2, 16) G2
    w: torch.Tensor  # (c_w, 3, 16) G1
    h: torch.Tensor  # (c_h, 3, 16) G1


def pack_proving_key(
    pk: ProvingKey, pp: PackedSharingParams, strip: bool = False,
    timings: dict | None = None,
) -> list[PackedProvingKeyShare]:
    """All-party CRS shares (proving_key.rs:35-110), in the exponent.

    strip=True clears pk.query_scalars afterwards (ProvingKey.strip), as
    the JAX package does for one-shot dealer flows. `timings`, if given,
    receives ms per query (s, u, w, h, v), the device drained at each."""
    from .prove import _Phases

    C1, C2 = g1(), g2()
    ph = _Phases(timings, pk.device)
    s_all = _pack_query(C1, pp, pk.a_query[1:])
    ph.mark("s")
    u_all = _pack_query(C1, pp, pk.h_query)
    ph.mark("u")
    w_all = _pack_query(C1, pp, pk.l_query)
    ph.mark("w")
    h_all = _pack_query(C1, pp, pk.b_g1_query[1:])
    ph.mark("h")
    v_all = _pack_query(C2, pp, pk.b_g2_query[1:])
    ph.mark("v")
    if strip:
        pk.strip()
    return [
        PackedProvingKeyShare(
            s=s_all[i], u=u_all[i], v=v_all[i], w=w_all[i], h=h_all[i]
        )
        for i in range(pp.n)
    ]
