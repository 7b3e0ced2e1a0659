"""Distributed two-stage FFT over packed shares — the counterpart of
distributed_groth16_tpu/parallel/dfft.py (the reference's d_fft/d_ifft,
dist-primitives/src/dfft/mod.rs:17-256).

  Stage 1 (every party): `log m - log l` butterfly levels applied
  share-wise to the party's (m/l)-long share vector, each level one batched
  gather / multiply / select.

  Stage 2 (king): gather all share vectors, batched-unpack every chunk,
  run the remaining `log l` butterfly levels and the rotate-right-by-1
  fixup in the clear, optionally zero-pad by `pad` and re-layout
  (`rearrange`) for the next transform, re-pack, scatter.

Layout contract (parallel/packing.py): inputs arrive bit-reversed and
strided; rearrange=True produces the same layout on the (padded) output
so transforms chain; rearrange=False produces consecutive chunking. The
twiddles are the reference's: factor = w^(2^(i-1)*(k+1)) and the final
rotate (dfft/mod.rs:142-182). Every gather index is in range by
construction (torch raises where jnp.take would clamp).

Each transform records a dfft.fft / dfft.ifft span (host time: stage 1's
launches may still run on the card when the span closes).
"""

from __future__ import annotations

import torch

from ..ops.field import fr
from ..ops.ntt import bitrev_perm, domain
from ..telemetry import tracing as _tracing
from .net import Net
from .pss import PackedSharingParams


def _fft1_local(v, wpows, logm: int, logl: int, inverse: bool):
    """Stage-1 butterflies on a (..., m/l, 16) share vector.

    Level t (t = 0 .. logm-logl-1) mirrors reference level i = logm - t:
    poly_size = 2^t, butterfly partners at stride poly_size inside blocks
    of 2*poly_size, twiddle w^(2^(logm-t-1) * (k+1))."""
    F = fr()
    m = 1 << logm
    o = torch.arange(v.shape[-2], device=v.device)
    for t in range(logm - logl):
        ps = 1 << t
        j = o >> (t + 1)
        k = o & (ps - 1)
        b = (o >> t) & 1
        lo = (j << (t + 1)) + k
        hi = lo + ps
        e = (k + 1) << (logm - 1 - t)
        if inverse:
            e = (m - e) & (m - 1)
        x = v[..., lo, :]
        y = F.mul(v[..., hi, :], wpows[e])
        v = torch.where((b == 0)[:, None], F.add(x, y), F.sub(x, y))
    return v


def _fft2_king(s, wpows, logm: int, logl: int, inverse: bool):
    """Stage-2 butterflies + rotate on the full (..., m, 16) clear vector.

    Level i = logl .. 1 (descending): reads pairs s[k*2^i + 2j], writes
    x+y at k*2^(i-1)+j and x-y at (k+ps)*2^(i-1)+j, twiddle
    w^(2^(i-1)*(k+1)); ends with rotate_right(1) (dfft/mod.rs:177)."""
    F = fr()
    m = 1 << logm
    o = torch.arange(m, device=s.device)
    half = m >> 1
    b = (o >= half).long()
    op = o - b * half
    for i in range(logl, 0, -1):
        k = op >> (i - 1)
        j = op & ((1 << (i - 1)) - 1)
        lo = (k << i) + 2 * j
        e = (k + 1) << (i - 1)
        if inverse:
            e = (m - e) & (m - 1)
        x = s[..., lo, :]
        y = F.mul(s[..., lo + 1, :], wpows[e])
        s = torch.where((b == 0)[:, None], F.add(x, y), F.sub(x, y))
    return torch.roll(s, 1, dims=-2)


def _king_clear_array(x, pp: PackedSharingParams, logm: int, degree2: bool,
                      inverse: bool, wpows):
    """Unpack a stacked (n, ..., m/l, 16) share tensor and run the stage-2
    butterflies in the clear. Returns (..., m, 16) in natural order."""
    chunks = torch.movedim(x, 0, -2)  # (..., m/l, n, 16)
    secrets = pp.unpack2(chunks) if degree2 else pp.unpack(chunks)
    s1 = secrets.reshape(secrets.shape[:-3] + (1 << logm, 16))
    return _fft2_king(s1, wpows, logm, pp.l.bit_length() - 1, inverse)


def _king_tail_array(x, pp: PackedSharingParams, logm: int, rearrange: bool,
                     pad: int, degree2: bool, inverse: bool, wpows):
    """King-side tail on a stacked (n, ..., m/l, 16) share tensor ->
    (n, ..., c, 16) per-party output shares, c = pad*m/l."""
    m = 1 << logm
    s1 = _king_clear_array(x, pp, logm, degree2, inverse, wpows)
    batch = s1.shape[:-2]
    if pad > 1:
        s1 = torch.nn.functional.pad(s1, (0, 0, 0, (pad - 1) * m))
    mp = pad * m
    c = mp // pp.l
    if rearrange:
        s1 = s1[..., torch.as_tensor(bitrev_perm(mp), device=s1.device), :]
        out_chunks = s1.reshape(batch + (pp.l, c, 16)).transpose(-3, -2)
    else:
        out_chunks = s1.reshape(batch + (c, pp.l, 16))
    out_shares = pp.pack_from_public(out_chunks)  # (..., c, n, 16)
    return torch.movedim(out_shares, -2, 0)  # (n, ..., c, 16)


def _king_tail(shares_list, pp, logm, rearrange, pad, degree2, inverse, wpows):
    """List-of-shares wrapper for the star backend."""
    per_party = _king_tail_array(
        torch.stack(shares_list, dim=0), pp, logm, rearrange, pad, degree2,
        inverse, wpows,
    )
    return [per_party[i] for i in range(pp.n)]


async def _d_transform(share_vec, rearrange: bool, pad: int, degree2: bool,
                       dom, pp: PackedSharingParams, net: Net, sid: int,
                       inverse: bool, king_clear: bool = False):
    m = dom.size
    assert share_vec.shape[-2] * pp.l == m, (
        f"Mismatch of size in FFT: {share_vec.shape[-2] * pp.l} vs {m}"
    )
    assert dom.offset == 1, "d_fft runs on plain (non-coset) domains"
    logm = m.bit_length() - 1
    logl = pp.l.bit_length() - 1
    dev = share_vec.device
    wpows = domain(m)._live_wpows(dev)
    F = fr()
    with _tracing.span(
        "dfft.ifft" if inverse else "dfft.fft", party=net.party_id, sid=sid
    ):
        if inverse:
            share_vec = F.mul(
                share_vec, torch.as_tensor(dom._size_inv, device=dev)
            )
        local = _fft1_local(share_vec, wpows, logm, logl, inverse)

        gathered = await net.gather_to_king(local, sid)
        if king_clear:
            # fused mode: leave the clear natural-order result on the king
            # (the caller's next step is a king-side combine)
            if not net.is_king:
                return None
            return _king_clear_array(
                torch.stack(gathered, dim=0), pp, logm, degree2, inverse,
                wpows,
            )
        out = None
        if net.is_king:
            out = _king_tail(
                gathered, pp, logm, rearrange, pad, degree2, inverse, wpows
            )
        return await net.scatter_from_king(out, sid)


async def d_fft(pcoeff_share, rearrange: bool, pad: int, degree2: bool, dom,
                pp: PackedSharingParams, net: Net, sid: int = 0,
                king_clear: bool = False):
    """Packed shares of coefficients (bitrev+strided layout) -> packed
    shares of evaluations on `dom` (dfft/mod.rs:17-54).

    king_clear=True skips the re-pack + scatter and returns the clear
    natural-order evaluations on the king (None on clients)."""
    return await _d_transform(
        pcoeff_share, rearrange, pad, degree2, dom, pp, net, sid,
        inverse=False, king_clear=king_clear,
    )


async def d_ifft(peval_share, rearrange: bool, pad: int, degree2: bool, dom,
                 pp: PackedSharingParams, net: Net, sid: int = 0):
    """Packed shares of evaluations -> packed shares of coefficients
    (dfft/mod.rs:56-95): scale by 1/m, run with the inverse root."""
    return await _d_transform(
        peval_share, rearrange, pad, degree2, dom, pp, net, sid, inverse=True
    )
