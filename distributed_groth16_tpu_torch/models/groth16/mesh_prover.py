"""The Groth16 prover over a parties mesh — the counterpart of
distributed_groth16_tpu/models/groth16/mesh_prover.py.

The whole distributed proving round of groth16/examples/sha256.rs:26-99
(the h-poly FFT pipelines and the A/B/C MSMs) over the parties split into
device shards (parallel/mesh.py: one process drives every shard), where
the JAX package runs it as one jitted shard_map program over a "parties"
mesh axis. The star's network rounds become the mesh's gather onto the
king's device and scatter back; on a one-shard mesh both are the
identity.

The builders return plain closures (nothing is jitted); they keep the JAX
names because the batch prover's ProverCache stores what they return.
Inputs are the JAX package's global (n, ...) shapes, on any device (the
closures shard them on entry), or already sharded by `PartyMesh.shard`.
Every output has the leading party axis, an `expand` view of the one clear
result on the king's device, so `pa[0, j]` indexes as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.curve import g1, g2
from ...ops.ntt import domain
from ...parallel.mesh import (  # noqa: F401  (make_mesh re-exported)
    PartyMesh,
    _mesh_dfft,
    _mesh_dmsm,
    _mesh_dmsm_batched,
    make_mesh,
)
from ...parallel.pss import PackedSharingParams
from .ext_wit import king_combine_h


@dataclass
class MeshProverInputs:
    """All-party stacked tensors, parties on axis 0."""

    qap_a: torch.Tensor  # (n, m/l, 16)
    qap_b: torch.Tensor
    qap_c: torch.Tensor
    a_share: torch.Tensor  # (n, c_a, 16)
    ax_share: torch.Tensor  # (n, c_w, 16)
    s: torch.Tensor  # (n, c_a, 3, 16)
    u: torch.Tensor  # (n, m/l, 3, 16)
    v: torch.Tensor  # (n, c_a, 3, 2, 16)
    w: torch.Tensor  # (n, c_w, 3, 16)
    h: torch.Tensor | None = None  # (n, c_a, 3, 16) b_g1_query shares (zk)


def _transform_consts(m: int, devices) -> tuple:
    """The d_fft twiddles of the m and 2m domains and 1/m, each a
    {device: tensor} dict over the mesh's devices."""
    dom, dom2 = domain(m), domain(2 * m)
    devs = dict.fromkeys(devices)
    return (
        {d: dom._live_wpows(d) for d in devs},
        {d: dom2._live_wpows(d) for d in devs},
        {d: torch.as_tensor(dom._size_inv, device=d) for d in devs},
    )


def _h_share(qabc, pp: PackedSharingParams, logm: int, mesh: PartyMesh,
             wpows_m, wpows_2m, size_inv_m):
    """ext_wit::h over the shards of stacked (n, ..., 3, m/l, 16) QAP
    shares: the inverse transforms re-laid out and padded to 2m, the
    forward transforms left clear on the king, the king's combine
    scattered back. Returns the shards of the (n, ..., m/l, 16) h
    shares."""
    coeffs = _mesh_dfft(
        qabc, pp, logm, True, True, 2, False, False, wpows_m, size_inv_m,
    )  # shards of (n, ..., 3, 2m/l, 16)
    evals = _mesh_dfft(
        coeffs, pp, logm + 1, False, False, 1, False, True, wpows_2m, None,
    )  # king_clear: (..., 3, 2m, 16) on the king
    p, q, w = evals[..., 0, :, :], evals[..., 1, :, :], evals[..., 2, :, :]
    return mesh.scatter(king_combine_h(p, q, w, pp))


def _pad_bases(x, cmax: int):
    """(n, c, 3)+elem G1 points -> (n, cmax, 3)+elem, padded with the
    INFINITY encoding (0, 1, 0) in Montgomery form, never zeros: an
    all-zero row absorbs under the complete add (it is not the identity)
    and would poison the tree MSM's pairwise sum tree."""
    C1 = g1()
    extra = C1.infinity((x.shape[0], cmax - x.shape[1]), x.device)
    return torch.cat([x, extra], dim=1)


def _pad_scalars(x, cmax: int):
    """(..., c, 16) scalars -> (..., cmax, 16); a zero scalar is inert."""
    return torch.nn.functional.pad(x, (0, 0, 0, cmax - x.shape[-2]))


def _expand_parties(x, n: int):
    """The one clear result as every party's row: (n,) + x.shape, a view."""
    return x.unsqueeze(0).expand((n,) + x.shape)


def _cmax(s_q, w_q, u_q) -> int:
    """The common length of the three G1 queries' shards."""
    return max(s_q[0].shape[1], w_q[0].shape[1], u_q[0].shape[1])


def build_mesh_prover(pp: PackedSharingParams, m: int, mesh: PartyMesh,
                      zk: bool = False):
    """Returns f(qa, qb, qc, a_sh, ax_sh, s, u, v, w[, h]) computing the
    clear proof cores (pi_a, pi_b, pi_c) from MeshProverInputs' tensors
    (or their shards), each (n, ...) with every row equal.

    zk=True also computes the H-query MSM (b_g1_query shares · a_share)
    as a 4th row of the batched G1 d_msm and returns it 4th; it feeds the
    r-weighted C term. The r/s randomization itself is host arithmetic on
    the clear cores (mesh_prove_zk), as in the JAX package."""
    logm = m.bit_length() - 1
    consts = _transform_consts(m, mesh.devices)

    def step(qa, qb, qc, a_sh, ax_sh, s_q, u_q, v_q, w_q, h_q=None):
        qa, qb, qc, a_sh, ax_sh, s_q, u_q, v_q, w_q = map(
            mesh.shard, (qa, qb, qc, a_sh, ax_sh, s_q, u_q, v_q, w_q))
        # the a/b/c pipelines are shape-identical: one batched transform
        if zk:
            h_q = mesh.shard(h_q)
        qabc = tuple(torch.stack(t, dim=1) for t in zip(qa, qb, qc))
        h_share = _h_share(qabc, pp, logm, mesh, *consts)  # (n, m/l, 16)
        # the three G1 MSMs as one batched d_msm over a common length
        cmax = _cmax(s_q, w_q, u_q)
        bases, scalars = [], []
        for j in range(mesh.k):
            g1_bases = [_pad_bases(s_q[j], cmax), _pad_bases(w_q[j], cmax),
                        _pad_bases(u_q[j], cmax)]
            g1_scalars = [_pad_scalars(a_sh[j], cmax),
                          _pad_scalars(ax_sh[j], cmax),
                          _pad_scalars(h_share[j], cmax)]
            if zk:
                g1_bases.append(_pad_bases(h_q[j], cmax))
                g1_scalars.append(_pad_scalars(a_sh[j], cmax))
            bases.append(torch.stack(g1_bases, dim=1))
            scalars.append(torch.stack(g1_scalars, dim=1))
        out = _mesh_dmsm_batched(g1(), tuple(bases), tuple(scalars), pp)
        pi_a, c_w, c_u = out[0], out[1], out[2]
        pi_b = _mesh_dmsm(g2(), v_q, a_sh, pp)
        pi_c = g1().add(c_w, c_u)
        res = [pi_a, pi_b, pi_c] + ([out[3]] if zk else [])
        return tuple(_expand_parties(x, mesh.n) for x in res)

    return step


def build_batch_mesh_prover(pp: PackedSharingParams, m: int,
                            mesh: PartyMesh, batch: int):
    """B same-circuit proofs in one pass over the mesh
    (scheduler/batch_prover.py).

    The witness-dependent tensors carry a batch axis B after the party
    axis, while the CRS shares stay un-batched (one shared packed CRS per
    bucket): the FFT pipeline batches over (B, 3), and the A/B/C MSMs run
    as one batched d_msm of (B, 3) entries per party against the three G1
    query tables, each read in place by every job's entry: JAX's
    broadcast_to + reshape would copy them B times in torch (n x B x 3 x
    cmax points). Deterministic (r = s = 0) cores only: the service's
    proving path, so each demuxed proof equals the sequential route's.

    Returns f(qabc, a_share, ax_share, s, u, v, w) with shapes (each a
    tensor or its shards)
        qabc     (n, B, 3, m/l, 16)   stacked per-job qap a/b/c shares
        a_share  (n, B, c_a, 16)      per-job packed witness shares
        ax_share (n, B, c_w, 16)
        s/u/v/w  as in MeshProverInputs (shared CRS, no batch axis)
    producing (n, B, ...) clear cores (pi_a, pi_b, pi_c), every party row
    equal."""
    logm = m.bit_length() - 1
    consts = _transform_consts(m, mesh.devices)

    def step(qabc, a_sh, ax_sh, s_q, u_q, v_q, w_q):
        qabc, a_sh, ax_sh, s_q, u_q, v_q, w_q = map(
            mesh.shard, (qabc, a_sh, ax_sh, s_q, u_q, v_q, w_q))
        if qabc[0].shape[1] != batch:
            raise ValueError(
                f"prover built for batch {batch}, got {qabc[0].shape[1]}"
            )
        h_share = _h_share(qabc, pp, logm, mesh, *consts)  # (n, B, m/l, 16)
        # 3B G1 MSMs per party: entry (j, k) is job j's k-th MSM (A, C's
        # witness part, C's h part); the result's row j is job j's
        cmax = _cmax(s_q, w_q, u_q)
        bases = tuple(
            torch.stack([_pad_bases(s, cmax), _pad_bases(w, cmax),
                         _pad_bases(u, cmax)], dim=1).unsqueeze(1)
            for s, w, u in zip(s_q, w_q, u_q)
        )  # (n/k, 1, 3, cmax, 3)+elem: one table set for all B jobs
        scalars = tuple(
            torch.stack([_pad_scalars(a, cmax), _pad_scalars(ax, cmax),
                         _pad_scalars(h, cmax)], dim=2)
            for a, ax, h in zip(a_sh, ax_sh, h_share)
        )  # (n/k, B, 3, cmax, 16)
        out = _mesh_dmsm_batched(g1(), bases, scalars, pp)
        pi_a, c_w, c_u = out[:, 0], out[:, 1], out[:, 2]
        pi_b = _mesh_dmsm_batched(
            g2(), tuple(v.unsqueeze(1) for v in v_q), a_sh, pp)
        pi_c = g1().add(c_w, c_u)
        return tuple(_expand_parties(x, mesh.n) for x in (pi_a, pi_b, pi_c))

    return step


def mesh_prove(pp, m, mesh, inp: MeshProverInputs):
    """One-shot helper: build, run, return the clear (pi_a, pi_b, pi_c)
    (party 0's row; every row holds the same values)."""
    prover = build_mesh_prover(pp, m, mesh)
    pa, pb, pc = prover(
        inp.qap_a, inp.qap_b, inp.qap_c, inp.a_share, inp.ax_share,
        inp.s, inp.u, inp.v, inp.w,
    )
    return pa[0], pb[0], pc[0]


def mesh_prove_zk(pp, m, mesh, inp: MeshProverInputs, pk, r: int, s: int):
    """Full zero-knowledge mesh prove: the mesh's cores + host r/s
    randomization.

    Same algebra as the async-star zk path (prove.rs:10-137):
        A = core_A + (a_query[0] + alpha) + r*delta_g1
        B = core_B + (b_g2_query[0] + beta)  + s*delta_g2
        C = core_C + s*A + r*(beta_g1 + b_g1_query[0]) + r*h_msm
    where core_C = w + u and h_msm = d_msm(b_g1_query[1:] shares, a_share)
    (the 4th batched MSM row). All completion terms are public CRS values
    and the cores are clear, so randomization is exact host bigint math
    (refmath), as in the JAX package. r = s = 0 degenerates to the
    deterministic reassembly.
    """
    from ...ops import refmath as rm
    from ...ops.field import fr
    from .keys import Proof

    p = fr().p
    r, s = r % p, s % p
    C1, C2 = g1(), g2()
    if inp.h is None:
        raise ValueError("mesh_prove_zk needs MeshProverInputs.h "
                         "(b_g1_query shares)")
    prover = build_mesh_prover(pp, m, mesh, zk=True)
    pa, pb, pc, ph = prover(
        inp.qap_a, inp.qap_b, inp.qap_c, inp.a_share, inp.ax_share,
        inp.s, inp.u, inp.v, inp.w, inp.h,
    )
    a_core = C1.decode(pa[0])
    b_core = C2.decode(pb[0])
    c_core = C1.decode(pc[0])
    h_msm = C1.decode(ph[0])
    vk = pk.vk
    a0 = rm.G1.add(C1.decode(pk.a_query[0]), vk.alpha_g1)
    b0 = rm.G2.add(C2.decode(pk.b_g2_query[0]), vk.beta_g2)
    delta_g1 = C1.decode(pk.delta_g1)
    m_term = rm.G1.add(C1.decode(pk.beta_g1), C1.decode(pk.b_g1_query[0]))
    a_full = rm.G1.add(rm.G1.add(a_core, a0), rm.G1.scalar_mul(delta_g1, r))
    b_full = rm.G2.add(rm.G2.add(b_core, b0),
                       rm.G2.scalar_mul(vk.delta_g2, s))
    c_full = rm.G1.add(
        rm.G1.add(c_core, rm.G1.scalar_mul(a_full, s)),
        rm.G1.scalar_mul(rm.G1.add(m_term, h_msm), r),
    )
    return Proof(a=a_full, b=b_full, c=c_full)
