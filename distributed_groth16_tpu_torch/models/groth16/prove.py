"""Groth16 prove — the counterpart of distributed_groth16_tpu/models/
groth16/prove.py: the single-node prover and the MPC prover over packed
shares.

prove_single (the role the plain arkworks prover plays in the reference's
service and examples) runs on the device of the key's tensors: the QAP
matvec, the h polynomial (three inverse and three coset NTTs — kernel 4 at
m >= LIMB_NTT_MIN_N), and four MSMs (a, b_g2, l, h; b_g1 as a fifth when
r != 0) — the tree MSM with kernels 1 and 3 at n >= TREE_MSM_MIN_N.

The MPC prover follows the reference's groth16/src/prove.rs:

  A = L + r*N + dmsm_G1(S, a)
  B = Z + s*K + dmsm_G2(V, a)
  C = w + u + s*A + r*M + r*h  where
      w = dmsm_G1(W, ax), u = dmsm_G1(U, h_vec), h = dmsm_G1(H, a)

plus the witness-packing helper (sha256.rs:97-121) and the proof
reassembly a += a_query[0] + alpha_g1, b += b_g2_query[0] + beta_g2
(sha256.rs:208-212). d_msm hands the clear MSM value to every party, so
any party's (A, B, C) is the clear proof core.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

import torch

from ...ops.curve import CurvePoints, g1, g2
from ...ops.field import fr
from ...ops.msm import msm as _msm
from ...ops.ntt import domain as _domain
from ...parallel.dmsm import d_msm
from ...parallel.net import Net
from ...parallel.packing import pack_consecutive
from ...parallel.pss import PackedSharingParams
from .ext_wit import h as ext_wit_h
from .keys import Proof, ProvingKey
from .proving_key import PackedProvingKeyShare
from .qap import PackedQAPShare


def _maybe_mul(curve: CurvePoints, p, k: int):
    """k * p for a host int k; None point or k == 0 contributes infinity.
    Single-point work runs on the host (refmath) and comes back on p's
    device."""
    if p is None or k % fr().p == 0:
        return None
    from ...ops import refmath as rm

    host = rm.G1 if curve.coord_axes == 1 else rm.G2
    return curve.encode([host.scalar_mul(curve.decode(p), k)], p.device)[0]


def _acc(curve: CurvePoints, device, *pts):
    """Sum of optional device points (None = infinity)."""
    live = [p for p in pts if p is not None]
    if not live:
        return curve.infinity((), device)
    out = live[0]
    for p in live[1:]:
        out = curve.add(out, p)
    return out


class _Phases:
    """Wall-clock per phase in ms, the device drained at each boundary;
    inert when no dict is given."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = (now - self.t) * 1e3
        self.t = now


def prove_single(
    pk: ProvingKey, compiled, z_mont: torch.Tensor, r: int = 0, s: int = 0,
    timings: dict | None = None,
) -> Proof:
    """Single-node prove on the key's device (r = s = 0 by default).

    h is the CircomReduction witness map: the odd-2m-th-root evaluations
    are one coset FFT (offset = the 2m-th root) of the m-domain
    coefficients. `timings`, if given, receives ms per phase (qap, h_poly,
    msm_a, msm_b_g2, msm_l, msm_h, rest)."""
    F = fr()
    C1, C2 = g1(), g2()
    dev = pk.device
    ph = _Phases(timings, dev)
    qap = compiled.qap(z_mont)
    ph.mark("qap")
    m = pk.domain_size
    dom = _domain(m)
    dom_shift = _domain(m, offset=_domain(2 * m).group_gen)
    p_ev = dom_shift.fft(dom.ifft(qap.a))
    q_ev = dom_shift.fft(dom.ifft(qap.b))
    w_ev = dom_shift.fft(dom.ifft(qap.c))
    h_vec = F.sub(F.mul(p_ev, q_ev), w_ev)  # (m, 16) Montgomery
    ph.mark("h_poly")

    z_std = F.from_mont(z_mont)
    ni = pk.num_instance
    msm_a = _msm(C1, pk.a_query, z_std)
    ph.mark("msm_a")
    msm_b = _msm(C2, pk.b_g2_query, z_std)
    ph.mark("msm_b_g2")
    msm_l = _msm(C1, pk.l_query, z_std[ni:])
    ph.mark("msm_l")
    msm_h = _msm(C1, pk.h_query, F.from_mont(h_vec))
    ph.mark("msm_h")
    a_pt = C1.add(msm_a, C1.encode([pk.vk.alpha_g1], dev)[0])
    b_pt = C2.add(msm_b, C2.encode([pk.vk.beta_g2], dev)[0])
    c_pt = C1.add(msm_l, msm_h)
    if r % F.p != 0:
        a_pt = C1.add(a_pt, _maybe_mul(C1, pk.delta_g1, r))
    if s % F.p != 0:
        b_pt = C2.add(
            b_pt, _maybe_mul(C2, C2.encode([pk.vk.delta_g2], dev)[0], s)
        )
    if r % F.p != 0 or s % F.p != 0:
        # C += s*A + r*B1 - rs*delta; with B1 = beta + sum z v + s*delta the
        # delta terms cancel, leaving s*A + r*(beta + sum z v)
        extra = _acc(
            C1,
            dev,
            _maybe_mul(C1, a_pt, s),
            _maybe_mul(
                C1, C1.add(pk.beta_g1, _msm(C1, pk.b_g1_query, z_std)), r
            ),
        )
        c_pt = C1.add(c_pt, extra)
    proof = Proof(a=C1.decode(a_pt), b=C2.decode(b_pt), c=C1.decode(c_pt))
    ph.mark("rest")
    return proof


# ---------------------------------------------------------------------------
# MPC prover
# ---------------------------------------------------------------------------


async def compute_A(pp: PackedSharingParams, S, a_share, net: Net,
                    sid: int = 0, L=None, N=None, r: int = 0):
    prod = await d_msm(g1(), S, a_share, pp, net, sid)
    return _acc(g1(), prod.device, L, _maybe_mul(g1(), N, r), prod)


async def compute_B(pp: PackedSharingParams, V, a_share, net: Net,
                    sid: int = 0, Z=None, K=None, s: int = 0):
    prod = await d_msm(g2(), V, a_share, pp, net, sid)
    return _acc(g2(), prod.device, Z, _maybe_mul(g2(), K, s), prod)


async def compute_C(pp: PackedSharingParams, W, U, H, a_share, ax_share,
                    h_share, net: Net, A=None, M=None, r: int = 0,
                    s: int = 0):
    msms = [
        d_msm(g1(), W, ax_share, pp, net, 0),
        d_msm(g1(), U, h_share, pp, net, 1),
    ]
    # the H-query MSM only feeds the r-weighted term: skip the whole
    # distributed round when r == 0
    if r % fr().p != 0:
        msms.append(d_msm(g1(), H, a_share, pp, net, 2))
    results = await asyncio.gather(*msms)
    w, u = results[0], results[1]
    h_msm = results[2] if len(results) > 2 else None
    return _acc(
        g1(), w.device, w, u,
        _maybe_mul(g1(), A, s), _maybe_mul(g1(), M, r),
        _maybe_mul(g1(), h_msm, r),
    )


def pack_from_witness(pp: PackedSharingParams, values: torch.Tensor):
    """(k, 16) Montgomery vector -> (n, ceil(k/l), 16) consecutive-chunk
    shares, zero-padding the tail chunk (sha256.rs:97-121)."""
    rem = (-values.shape[0]) % pp.l
    if rem:
        values = torch.nn.functional.pad(values, (0, 0, 0, rem))
    return pack_consecutive(pp, values)


@dataclass
class PartyProofShare:
    a: torch.Tensor  # (3, 16) G1: clear values after the d_msm fan-out
    b: torch.Tensor  # (3, 2, 16) G2
    c: torch.Tensor  # (3, 16) G1


def _a_completion(pk: ProvingKey):
    """a_query[0] + alpha_g1: the public term completing a party's S-MSM to
    the full A. One definition shared by the zk C-term and
    reassemble_proof: they must agree or randomized proofs stop
    verifying."""
    C1 = g1()
    return C1.add(pk.a_query[0], C1.encode([pk.vk.alpha_g1], pk.device)[0])


def public_prove_consts(pk: ProvingKey) -> dict:
    """The clear CRS values every party receives for a randomized proof
    (prove.rs:9,51,90): N = delta_g1, K = delta_g2, and the
    constant-wire-completed alpha / beta terms that enter A and C."""
    return {
        "N": pk.delta_g1,
        "K": g2().encode([pk.vk.delta_g2], pk.device)[0],
        "A0": _a_completion(pk),
        # beta_g1 + b_g1_query[0]: with the H-query d_msm over
        # b_g1_query[1:], r*(M + h_msm) = r*B_g1 - r*s*delta exactly
        "M": g1().add(pk.beta_g1, pk.b_g1_query[0]),
    }


async def distributed_prove_party(
    pp: PackedSharingParams,
    crs_share: PackedProvingKeyShare,
    qap_share: PackedQAPShare,
    a_share: torch.Tensor,
    ax_share: torch.Tensor,
    net: Net,
    pub: dict | None = None,
    r: int = 0,
    s: int = 0,
    timings: dict | None = None,
) -> PartyProofShare:
    """One party's full proving round (sha256.rs:26-99): h, then A and B
    on two channels at once, then C. For a zero-knowledge proof pass
    r, s != 0 together with `pub` = public_prove_consts(pk). `timings`,
    if given, receives this party's ms per phase (h, ab, c). In-process,
    all parties share one event loop, so a phase also counts the other
    parties' work that the loop runs before this party resumes."""
    zk = (r % fr().p, s % fr().p) != (0, 0)
    if zk and pub is None:
        raise ValueError("randomized proof needs pub=public_prove_consts(pk)")
    ph = _Phases(timings, a_share.device)
    h_share = await ext_wit_h(qap_share, pp, net)
    ph.mark("h")
    pi_a, pi_b = await asyncio.gather(
        compute_A(pp, crs_share.s, a_share, net, 0,
                  N=pub["N"] if zk else None, r=r),
        compute_B(pp, crs_share.v, a_share, net, 1,
                  K=pub["K"] if zk else None, s=s),
    )
    ph.mark("ab")
    pi_c = await compute_C(
        pp, crs_share.w, crs_share.u, crs_share.h, a_share, ax_share,
        h_share, net,
        A=g1().add(pi_a, pub["A0"]) if zk else None,
        M=pub["M"] if zk else None,
        r=r, s=s,
    )
    ph.mark("c")
    return PartyProofShare(a=pi_a, b=pi_b, c=pi_c)


def reassemble_proof(share: PartyProofShare, pk: ProvingKey) -> Proof:
    """Final client-side assembly (sha256.rs:208-212): add the
    constant-wire query terms and the vk offsets, decode to host affine."""
    C1, C2 = g1(), g2()
    a = C1.add(share.a, _a_completion(pk))
    b = C2.add(
        share.b,
        C2.add(pk.b_g2_query[0], C2.encode([pk.vk.beta_g2], pk.device)[0]),
    )
    return Proof(a=C1.decode(a), b=C2.decode(b), c=C1.decode(share.c))
