"""The SPMD mesh with the parties split over device shards — the
counterpart of distributed_groth16_tpu/parallel/mesh.py.

The JAX package runs the n parties as shards of a `jax.sharding.Mesh`
inside one `shard_map` program, one party a device, and the three star
collectives become XLA collectives. The port's mesh is one process that
drives k device shards; shard j holds the parties j*n/k ... (j+1)*n/k - 1
as axis 0 of one tensor on its device:

  in_specs          -> `PartyMesh.shard`: an (n, ...) tensor split into k
                       blocks, each a view where it already sits on its
                       device
  gather_to_king    -> `PartyMesh.gather`: the blocks copied into one
                       (n, ...) stack on the king's device, devices[0]
                       (the identity for k = 1)
  king computes     -> the king's tail runs ONCE there (each JAX shard
                       repeats it; the values are the same)
  scatter_from_king -> `PartyMesh.scatter`: each shard's rows of the
                       tail's (n, ...) output copied back to its device
                       (the JAX `_own_row`)

Stage 1 of a d_fft runs once a shard over its stacked (n/k, ..., m/l, 16)
block, and the local MSMs of a d_msm run as one batched call a shard (the
tree MSM: kernels 1 and 3 on a card), then the king's unpack in the
exponent (`ladder_apply`: kernels 1 and 2). With k = 1 that is one stage-1
call and one `msm_batched` over all n parties.

A sharded value is a tuple of k blocks, one a shard in shard order. One
host thread issues the shards' work in turn; each shard's work runs under
its card's device guard, so the hand-written kernels launch on the card
that holds their operands. Nothing is jitted, so a "mesh program" is a
plain closure. In-mesh all parties live in one trust domain (one
process), the reference's king-node model, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.field import fr, resolve_device
from .dfft import _fft1_local, _king_clear_array, _king_tail_array
from .pss import PackedSharingParams


def _check_device(d) -> torch.device:
    """A device that exists on this host, a CUDA one with its index."""
    d = torch.device(d)
    if d.type == "cuda":
        count = torch.cuda.device_count()
        if d.index is None and count:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index is None or d.index >= count:
            raise RuntimeError(f"no device {d}: this host has {count} CUDA "
                               "device(s)")
    return d


@dataclass(frozen=True)
class PartyMesh:
    """n parties over k = len(devices) shards: shard j, on devices[j],
    holds the parties j*n/k ... (j+1)*n/k - 1. The stand-in for the JAX
    package's one-axis `Mesh`."""

    devices: tuple
    n: int

    def __post_init__(self):
        devs = tuple(_check_device(d) for d in self.devices)
        if not devs:
            raise RuntimeError("empty device slice")
        if self.n < 1:
            raise ValueError(f"need at least one party, got {self.n}")
        if self.n % len(devs):
            raise ValueError(f"{len(devs)} shards do not divide {self.n} "
                             "parties")
        object.__setattr__(self, "devices", devs)

    @property
    def device(self) -> torch.device:
        """The king's device: shard 0's."""
        return self.devices[0]

    @property
    def k(self) -> int:
        return len(self.devices)

    def shard(self, x) -> tuple:
        """An (n, ...) tensor on any device -> its k blocks, each on its
        shard's device (a view where it already sits there). A tuple of
        blocks, already sharded, is returned as it is."""
        if not isinstance(x, torch.Tensor):
            blocks = tuple(x)
            if tuple(b.device for b in blocks) != self.devices:
                raise ValueError(
                    f"blocks on {[str(b.device) for b in blocks]}, mesh "
                    f"shards on {[str(d) for d in self.devices]}")
            return blocks
        if x.shape[0] != self.n:
            raise ValueError(f"{x.shape[0]} rows for {self.n} parties")
        return _split(x, self.devices)

    def gather(self, blocks) -> torch.Tensor:
        """The shards' blocks -> the (n, ...) stack on the king's device."""
        return _gather(self.shard(blocks))

    def scatter(self, x) -> tuple:
        """The king's (n, ...) output -> each shard's rows on its device."""
        return _scatter(x, self.devices)


def _place(x, dev):
    """x on dev: itself where it already sits there. An (r, ...) `expand`
    view along axis 0 moves one row and expands it again, never r copies."""
    if x.device == dev:
        return x
    if x.shape[0] > 1 and x.stride(0) == 0:
        return x[:1].to(dev).expand(x.shape)
    return x.to(dev)


def _split(x, devices) -> tuple:
    """Axis 0 of x in len(devices) equal blocks, block j on devices[j]."""
    rows = x.shape[0] // len(devices)
    return tuple(_place(x[j * rows:(j + 1) * rows], d)
                 for j, d in enumerate(devices))


def _gather(blocks) -> torch.Tensor:
    """The all_gather: one (n, ...) stack of the blocks on the first
    block's device (the king's)."""
    if len(blocks) == 1:
        return blocks[0]
    king = blocks[0].device
    return torch.cat([_place(b, king) for b in blocks])


def _scatter(x, devices) -> tuple:
    """The king's (n, ...) output -> each shard's rows on its device."""
    return _split(x, devices)


def _guard(dev):
    """Make dev the current CUDA device while a shard's work is issued:
    the kernels launch on the current device's stream."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _at(const, dev):
    """A per-device constant (a {device: tensor} dict or one tensor) on
    dev."""
    if isinstance(const, dict):
        return const[dev]
    return None if const is None else _place(const, dev)


def make_mesh(n_parties: int, device=None) -> PartyMesh:
    """n_parties parties on one device (None: the card): one shard."""
    return PartyMesh((resolve_device(device),), n_parties)


def make_mesh_from_devices(devices) -> PartyMesh:
    """A parties mesh over an explicit device list, one party per entry,
    as the JAX package's: k = n = len(devices), shard j on devices[j],
    entries may repeat (several shards on one card)."""
    devs = tuple(devices)
    return PartyMesh(devs, len(devs))


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
    independent transforms), or a mesh's shards of such a stack. wpows
    and size_inv: a tensor, or a {device: tensor} dict holding every
    shard's device. Returns (n, ..., c, 16) shares, sharded as x came, or
    the clear (..., m, 16) on the king's device when king_clear."""
    F = fr()
    logl = pp.l.bit_length() - 1
    blocks = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    local = []
    for b in blocks:  # stage 1, once a shard
        with _guard(b.device):
            if inverse:
                b = F.mul(b, _at(size_inv, b.device))
            local.append(
                _fft1_local(b, _at(wpows, b.device), logm, logl, inverse))
    allg = _gather(local)
    king = allg.device
    with _guard(king):
        if king_clear:
            return _king_clear_array(allg, pp, logm, degree2, inverse,
                                     _at(wpows, king))
        out = _king_tail_array(allg, pp, logm, rearrange, pad, degree2,
                               inverse, _at(wpows, king))
    if isinstance(x, torch.Tensor):
        return out
    return _scatter(out, tuple(b.device for b in blocks))


def _mesh_dmsm(curve, bases_block, scalar_block, pp: PackedSharingParams):
    """bases: (n, c, 3)+elem, scalars: (n, c, 16) Montgomery (or a mesh's
    shards of them) -> the clear (3,)+elem group element."""
    return _mesh_dmsm_batched(
        curve, _each(bases_block, lambda b: b[:, None]),
        _each(scalar_block, lambda s: s[:, None]), pp,
    )[0]


def _each(x, f):
    """f over a tensor, or over each block of a sharded value."""
    return f(x) if isinstance(x, torch.Tensor) else tuple(f(b) for b in x)


def _local_msms(curve, bases_block, scalar_block):
    """One shard's local MSMs: scalars (p, *batch, c, 16) Montgomery,
    bases (p, *sets, c, 3)+elem -> (p, *batch)+pt, in one msm_batched."""
    from ..ops.msm import msm_batched

    std = fr().from_mont(scalar_block)  # (p, *batch, c, 16)
    lead = tuple(std.shape[:-2])  # (p, *batch)
    sets = tuple(bases_block.shape[: len(lead)])
    c = std.shape[-2]
    bases_of = torch.arange(
        int(np.prod(sets)), device=std.device
    ).reshape(sets).expand(lead).reshape(-1)
    flat = msm_batched(
        curve, bases_block.reshape((-1, c) + bases_block.shape[len(lead) + 1:]),
        std.reshape(-1, c, std.shape[-1]), bases_of,
    )  # (p * B,)+pt
    return flat.reshape(lead + flat.shape[1:])


def _mesh_dmsm_batched(curve, bases_block, scalar_block,
                       pp: PackedSharingParams):
    """Independent d_msms of identical length over any batch shape.

    scalars: (n, *batch, c, 16) Montgomery; bases: (n, *sets, c, 3)+elem
    with `sets` broadcastable to `batch` (a 1 where one CRS table serves a
    batch of jobs), each a tensor or a mesh's shards of one -> clear
    (*batch, 3)+elem on the king's device. Each shard's p * B local MSMs
    run as ONE msm_batched (the tree MSM above LADDER_MSM_MAX_N points:
    kernels 1 and 3 on the card), each entry reading its base set in
    place; the king gathers the points, unpacks all B in one ladder
    (kernels 1 and 2) and sums the l partials one add at a time."""
    if isinstance(scalar_block, torch.Tensor):
        bases_block, scalar_block = (bases_block,), (scalar_block,)
    local = []
    for b, s in zip(bases_block, scalar_block):
        with _guard(s.device):
            local.append(_local_msms(curve, b, s))
    allg = _gather(local)  # (n, *batch)+pt on the king
    nb = scalar_block[0].ndim - 3  # batch axes: (n, *batch, c, 16)
    with _guard(allg.device):
        allg = torch.movedim(allg, 0, nb)  # (*batch, n)+pt
        partials = pp.unpackexp(curve, allg, degree2=True)  # (*batch, l)+pt
        return curve.sum_sequential(partials, axis=nb)
