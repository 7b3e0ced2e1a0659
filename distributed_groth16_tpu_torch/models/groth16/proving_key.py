"""CRS sharding: pack the proving key for every party — the counterpart
of distributed_groth16_tpu/models/groth16/proving_key.py (the reference's
groth16/src/proving_key.rs:19-110). Per party,

  s = pack(a_query[1..]),  u = pack(h_query),  w = pack(l_query),
  h = pack(b_g1_query[1..]),  v = pack(b_g2_query[1..])  (G2)

each chunked by l. Two routes to the same shares, as in the JAX package:

  * scalar route (a key from an in-process setup(), which keeps the
    dealer's query discrete logs s_i): each share point
    sum_i M[o,i] (s_i G) = (sum_i M[o,i] s_i) G, so the SCALARS are
    packed with the device field NTT (pss.pack_from_public) and each
    share point is one windowed fixed-base multiply (ops/fixedbase.py:
    32 adds a point on kernel 1, no doubling);
  * point route (scalars unknown: every loaded key): the in-exponent PSS
    transform (parallel/pss.py packexp_from_public), one batched GLV
    ladder per G1 query and a full-width ladder for the G2 query, through
    ladder_apply (kernels 1 and 2 on the card).

Tail chunks are padded with the point at infinity / scalar zero, which is
sound because the per-chunk inner product the PSS encodes is unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.curve import CurvePoints, g1, g2
from ...ops.field import fr
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
class QueryScalars:
    """Dealer-side discrete logs of the proving-key query arrays, all
    (k, 16) Montgomery Fr tensors on the key's device (b also covers the
    G2 b query: the same scalars on another generator). Trapdoor-derived:
    see ProvingKey.query_scalars."""

    a: torch.Tensor  # (num_wires, 16)
    b: torch.Tensor  # (num_wires, 16)
    l: torch.Tensor  # (num_witness, 16)
    h: torch.Tensor  # (m, 16)


def _pack_share_scalars_std(pp: PackedSharingParams, scal_mont):
    """(k, 16) Montgomery Fr -> (n, ceil(k/l), 16) standard-form share
    scalars: zero-pad the tail chunk, field-NTT pack, de-Montgomery."""
    F = fr()
    k = scal_mont.shape[0]
    rem = (-k) % pp.l
    if rem:
        scal_mont = torch.cat([
            scal_mont,
            torch.zeros((rem, F.nl), dtype=scal_mont.dtype,
                        device=scal_mont.device),
        ])
    c = scal_mont.shape[0] // pp.l
    share_scal = pp.pack_from_public(scal_mont.reshape(c, pp.l, F.nl))
    return F.from_mont(share_scal.transpose(0, 1))  # (n, c, 16)


def _fixed_base_shares(which: str, std):
    """(n, c, 16) standard-form share scalars -> (n, c, 3) + elem."""
    from ...ops.fixedbase import fixed_base_mul

    n, c = std.shape[:2]
    pts = fixed_base_mul(which, std.reshape(n * c, std.shape[-1]))
    return pts.reshape((n, c) + tuple(pts.shape[1:]))


def _pack_query_scalars(which: str, pp: PackedSharingParams, scal_mont):
    """(k, 16) Montgomery Fr -> (n, ceil(k/l), 3) + elem share points by
    field-NTT pack and windowed fixed-base multiply (the scalar route)."""
    return _fixed_base_shares(which, _pack_share_scalars_std(pp, scal_mont))


def pack_proving_key_from_scalars(
    qs: QueryScalars, pp: PackedSharingParams, timings: dict | None = None,
) -> list["PackedProvingKeyShare"]:
    """All-party CRS shares from the dealer's query scalars (the scalar
    route): the same shares as the point route on the matching key, as
    group elements (projective representatives may differ). `timings`
    as for pack_proving_key; b's share scalars feed both h and v."""
    from .prove import _Phases

    ph = _Phases(timings, qs.a.device)
    s_all = _pack_query_scalars("g1", pp, qs.a[1:])
    ph.mark("s")
    u_all = _pack_query_scalars("g1", pp, qs.h)
    ph.mark("u")
    w_all = _pack_query_scalars("g1", pp, qs.l)
    ph.mark("w")
    b_std = _pack_share_scalars_std(pp, qs.b[1:])  # packed once for h, v
    h_all = _fixed_base_shares("g1", b_std)
    ph.mark("h")
    v_all = _fixed_base_shares("g2", b_std)
    ph.mark("v")
    return [
        PackedProvingKeyShare(
            s=s_all[i], u=u_all[i], v=v_all[i], w=w_all[i], h=h_all[i]
        )
        for i in range(pp.n)
    ]


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
    """All-party CRS shares (proving_key.rs:35-110): the scalar route when
    the key carries its dealer scalars (in-process setup), the in-exponent
    point route otherwise (every loaded key).

    strip=True clears pk.query_scalars once they have been consumed: they
    are trapdoor-derived (see ProvingKey.query_scalars), so one-shot
    dealer flows should not keep them alive on a key that may later cross
    a trust boundary. `timings`, if given, receives ms per query (s, u,
    w, h, v), the device drained at each."""
    from .prove import _Phases

    qs = pk.query_scalars
    if qs is not None:
        shares = pack_proving_key_from_scalars(qs, pp, timings)
        if strip:
            pk.strip()
        return shares
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
