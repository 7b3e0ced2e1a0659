"""The SPMD mesh with the parties on one tensor axis — the counterpart of
distributed_groth16_tpu/parallel/mesh.py.

The JAX package runs the n parties as shards of a `jax.sharding.Mesh`
inside one `shard_map` program, and the three star collectives become
XLA collectives. On one card the port holds all n parties' shares as axis
0 of one tensor instead:

  gather_to_king    -> the identity: the (n, ...) stack is already the
                       king's gathered input
  king computes     -> the king's tail runs ONCE on that stack (each JAX
                       shard repeats it; the values are the same)
  scatter_from_king -> row i of the tail's (n, ...) output is party i's
                       share (the JAX `_own_row` slice is not needed)

Stage 1 of a d_fft runs once over the stacked (n, ..., m/l, 16) tensor,
not once per party, and the local MSMs of a d_msm run as the n * B tree
MSMs of one batched call (kernels 1 and 3 on the card), then the king's
unpack in the exponent (`ladder_apply`: kernels 1 and 2).

Nothing is jitted, so a "mesh program" is a plain closure. In-mesh all
parties live in one trust domain (one process on one card), the
reference's king-node model, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.field import fr, resolve_device
from .dfft import _fft1_local, _king_clear_array, _king_tail_array
from .pss import PackedSharingParams

@dataclass(frozen=True)
class PartyMesh:
    """n parties on one device: the stand-in for the JAX package's
    one-axis `Mesh`."""

    device: torch.device
    n: int


def make_mesh(n_parties: int, device=None) -> PartyMesh:
    """n_parties parties on one device (None: the card)."""
    if n_parties < 1:
        raise ValueError(f"need at least one party, got {n_parties}")
    return PartyMesh(resolve_device(device), n_parties)


def make_mesh_from_devices(devices) -> PartyMesh:
    """A parties mesh over an explicit device list, one party per entry,
    as the JAX package's. The port holds every party on one device, so
    every entry must name the same device (parties across cards come with
    torch.distributed)."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("empty device slice")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            "the port's mesh holds all parties on one device; got "
            f"{sorted(set(map(str, devs)))}"
        )
    return PartyMesh(devs[0], len(devs))


def _mesh_dfft(
    x,
    pp: PackedSharingParams,
    logm: int,
    inverse: bool,
    rearrange: bool,
    pad: int,
    degree2: bool,
    king_clear: bool,
    wpows,
    size_inv,
):
    """x: (n, ..., m/l, 16) stacked share blocks (extra axes batch
    independent transforms). Returns (n, ..., c, 16) shares, or the clear
    (..., m, 16) when king_clear."""
    F = fr()
    logl = pp.l.bit_length() - 1
    if inverse:
        x = F.mul(x, size_inv)
    local = _fft1_local(x, wpows, logm, logl, inverse)  # all n at once
    if king_clear:
        return _king_clear_array(local, pp, logm, degree2, inverse, wpows)
    return _king_tail_array(
        local, pp, logm, rearrange, pad, degree2, inverse, wpows
    )


def _mesh_dmsm(curve, bases_block, scalar_block, pp: PackedSharingParams):
    """bases: (n, c, 3)+elem, scalars: (n, c, 16) Montgomery -> the clear
    (3,)+elem group element."""
    return _mesh_dmsm_batched(
        curve, bases_block[:, None], scalar_block[:, None], pp
    )[0]


def _mesh_dmsm_batched(curve, bases_block, scalar_block,
                       pp: PackedSharingParams):
    """Independent d_msms of identical length over any batch shape.

    scalars: (n, *batch, c, 16) Montgomery; bases: (n, *sets, c, 3)+elem
    with `sets` broadcastable to `batch` (a 1 where one CRS table serves a
    batch of jobs) -> clear (*batch, 3)+elem. All n * B local MSMs run as
    ONE msm_batched (the tree MSM above LADDER_MSM_MAX_N points: kernels 1
    and 3 on the card), each entry reading its base set in place; the king
    unpacks all B in one ladder (kernels 1 and 2) and sums the l partials
    one add at a time."""
    from ..ops.msm import msm_batched

    F = fr()
    std = F.from_mont(scalar_block)  # (n, *batch, c, 16)
    lead = tuple(std.shape[:-2])  # (n, *batch)
    sets = tuple(bases_block.shape[: len(lead)])
    c = std.shape[-2]
    bases_of = torch.arange(
        int(np.prod(sets)), device=std.device
    ).reshape(sets).expand(lead).reshape(-1)
    flat = msm_batched(
        curve, bases_block.reshape((-1, c) + bases_block.shape[len(lead) + 1:]),
        std.reshape(-1, c, std.shape[-1]), bases_of,
    )  # (n * B,)+pt
    local = flat.reshape(lead + flat.shape[1:])  # (n, *batch)+pt
    allg = torch.movedim(local, 0, len(lead) - 1)  # (*batch, n)+pt
    partials = pp.unpackexp(curve, allg, degree2=True)  # (*batch, l)+pt
    return curve.sum_sequential(partials, axis=len(lead) - 1)
