"""Single-node Groth16 prove — the counterpart of prove_single in
distributed_groth16_tpu/models/groth16/prove.py (the role the plain
arkworks prover plays in the reference's service and examples).

The proof runs on the device of the key's tensors: the QAP matvec, the
h polynomial (three inverse and three coset NTTs — kernel 4 at m >=
LIMB_NTT_MIN_N), and four MSMs (a, b_g2, l, h; b_g1 as a fifth when r !=
0) — the tree MSM with kernels 1 and 3 at n >= TREE_MSM_MIN_N.
"""

from __future__ import annotations

import time

import torch

from ...ops.curve import CurvePoints, g1, g2
from ...ops.field import fr
from ...ops.msm import msm as _msm
from ...ops.ntt import domain as _domain
from .keys import Proof, ProvingKey


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
