"""Groth16 circuit-specific setup (trusted dealer) with CircomReduction
semantics — the counterpart of distributed_groth16_tpu/models/groth16/
setup.py. Same seed, same toxic waste, same key, limb for limb.

  * QAP polynomials at tau via Lagrange evaluation on the size-m domain
    (host bigint), with the input-consistency rows of qap.rs:69-73.
  * h_query uses the snarkjs/CircomReduction basis (ark-circom
    qap.rs:94-110): IFFT of delta^{-1} tau^i over the size-2m domain, odd
    coefficients — on the device NTT.
  * Every query point comes from the windowed fixed-base multiply
    (ops/fixedbase.py) on the device.
  * The key keeps the query discrete logs (query_scalars) for the scalar
    route of pack_proving_key; save() drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from ...frontend.r1cs import R1CS
from ...ops import refmath as rm
from ...ops.constants import R
from ...ops.curve import g1, g2
from ...ops.field import fr, resolve_device
from ...ops.fixedbase import fixed_base_mul
from ...ops.msm import encode_scalars_std
from ...ops.ntt import _powers_device, domain
from .keys import ProvingKey, VerifyingKey
from .qap import _next_pow2


def _lagrange_at(tau: int, m: int) -> list[int]:
    """L_j(tau) for the size-m domain: L_j = w^j (tau^m - 1) / (m (tau - w^j))."""
    dom = rm.Domain(m)
    zt = (pow(tau, m, R) - 1) % R
    els = dom.elements()
    invs = rm.batch_inv([(tau - w) % R for w in els], R)
    zt_over_m = zt * rm.finv(m, R) % R
    return [els[j] * zt_over_m % R * invs[j] % R for j in range(m)]


def _qap_polys_at_tau(r1cs: R1CS, tau: int, m: int):
    """u_i(tau), v_i(tau), w_i(tau) for every wire i (host sparse eval)."""
    lag = _lagrange_at(tau, m)
    nw = r1cs.num_wires
    u, v, w = [0] * nw, [0] * nw, [0] * nw
    for mat, out in ((r1cs.a, u), (r1cs.b, v), (r1cs.c, w)):
        for j, row in enumerate(mat):
            lj = lag[j]
            for coeff, wire in row:
                out[wire] = (out[wire] + coeff * lj) % R
    # input-consistency rows (qap.rs:69-73): u_i += L_{nc+i} for instances
    for i in range(r1cs.num_instance):
        u[i] = (u[i] + lag[r1cs.num_constraints + i]) % R
    return u, v, w


def _h_query_scalars_device(tau: int, delta_inv: int, m: int, device):
    """CircomReduction h basis: IFFT over the 2m domain of
    [delta_inv * tau^i, i < 2m-1], odd coefficients -> (m, 16) Montgomery."""
    F = fr()
    pows = _powers_device(tau, 2 * m, device)
    scal = F.mul(pows, F.encode([delta_inv], device)[0])
    # the reference builds 2*max_power+1 = 2m-1 scalars and lets the IFFT
    # zero-pad to 2m
    scal[2 * m - 1] = 0
    return domain(2 * m).ifft(scal)[1::2]


def setup(r1cs: R1CS, seed: int = 42, device=None) -> ProvingKey:
    """Circuit-specific setup on `device` (None: CUDA); deterministic per
    seed and equal to the JAX package's setup(r1cs, seed)."""
    dev = resolve_device(device)
    torch.empty(0, device=dev)  # fail here, before the host work, if absent
    rng = np.random.default_rng(seed)

    def rand_fr() -> int:
        return int.from_bytes(rng.bytes(40), "little") % R

    alpha, beta, gamma, delta, tau = (rand_fr() for _ in range(5))
    gamma_inv = rm.finv(gamma, R)
    delta_inv = rm.finv(delta, R)

    m = _next_pow2(r1cs.num_constraints + r1cs.num_instance)
    ni, nw = r1cs.num_instance, r1cs.num_wires
    u, v, w = _qap_polys_at_tau(r1cs, tau, m)
    l_query_s = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R
        for i in range(ni, nw)
    ]
    gamma_abc_s = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R
        for i in range(ni)
    ]

    g1_pts = fixed_base_mul(
        "g1",
        encode_scalars_std(
            u + v + l_query_s + gamma_abc_s + [alpha, beta, delta], dev
        ),
    )
    ofs = 0
    a_query = g1_pts[ofs : ofs + nw]; ofs += nw
    b_g1_query = g1_pts[ofs : ofs + nw]; ofs += nw
    l_query = g1_pts[ofs : ofs + nw - ni]; ofs += nw - ni
    gamma_abc = g1_pts[ofs : ofs + ni]; ofs += ni
    alpha_g1, beta_g1, delta_g1 = g1_pts[ofs], g1_pts[ofs + 1], g1_pts[ofs + 2]

    g2_pts = fixed_base_mul(
        "g2", encode_scalars_std(v + [beta, gamma, delta], dev)
    )
    h_scal = _h_query_scalars_device(tau, delta_inv, m, dev)
    h_query = fixed_base_mul("g1", fr().from_mont(h_scal))

    C1, C2 = g1(), g2()
    vk = VerifyingKey(
        alpha_g1=C1.decode(alpha_g1),
        beta_g2=C2.decode(g2_pts[nw]),
        gamma_g2=C2.decode(g2_pts[nw + 1]),
        delta_g2=C2.decode(g2_pts[nw + 2]),
        gamma_abc_g1=list(C1.decode(gamma_abc)),
    )
    # The dealer keeps the query discrete logs: pack_proving_key then
    # shards the CRS in the field (device NTT pack + windowed fixed-base,
    # proving_key.py) instead of in the exponent. Trapdoor-derived: see
    # ProvingKey.query_scalars.
    from .proving_key import QueryScalars

    F = fr()
    query_scalars = QueryScalars(
        a=F.encode(u, dev), b=F.encode(v, dev), l=F.encode(l_query_s, dev),
        h=h_scal,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=g2_pts[:nw],
        h_query=h_query,
        l_query=l_query,
        domain_size=m,
        num_instance=ni,
        query_scalars=query_scalars,
    )
