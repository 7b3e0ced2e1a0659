"""What the examples share: a rank's command-line flags, its device, its
connection to the star and its last output line; the device fence and
counters; the scalar draw of the JAX examples."""

# dg16lint: disable-file=DG108 — report() prints a rank's last JSON line,
# the examples' output contract that launch.py reads

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops import _cuda
from ..ops.field import resolve_device
from ..parallel.prodnet import ProdNet
from ..utils.config import read_address_file


def add_star_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--id", type=int, required=True, help="party id, 0 = king")
    p.add_argument("--input", required=True,
                   help="address file: one host:port per rank")
    p.add_argument("--certs", default="certs",
                   help="directory of <rank>.cert.pem / <rank>.key.pem")
    p.add_argument("--n", type=int, default=None,
                   help="number of parties (default: the address count)")
    p.add_argument("--plain", action="store_true", help="TCP without TLS")
    p.add_argument("--device", default=None,
                   help="torch device of this rank (default: cuda)")


def open_device(name: str | None) -> torch.device:
    """The rank's device, touched once so an absent one fails here, before
    the rank dials the star."""
    dev = resolve_device(name)
    torch.empty(0, device=dev)
    return dev


async def connect(opt, n: int, dev: torch.device) -> ProdNet:
    """This rank's node of the star: the king binds the address file's
    first entry, every other rank dials it. mTLS unless --plain: the king
    pins the roster of client certs, clients pin the king's."""
    king_addr = read_address_file(opt.input)[0]
    ctx = None
    if not opt.plain:
        # only a TLS star needs the cryptography package
        from ..utils.certs import king_ssl_context, peer_ssl_context

        def cert(i):
            return os.path.join(opt.certs, f"{i}.cert.pem")

        def key(i):
            return os.path.join(opt.certs, f"{i}.key.pem")

        if opt.id == 0:
            ctx = king_ssl_context(cert(0), key(0),
                                   [cert(i) for i in range(1, n)])
        else:
            ctx = peer_ssl_context(cert(opt.id), key(opt.id), cert(0))
    if opt.id == 0:
        return await ProdNet.new_king(king_addr, n, ctx, device=dev)
    return await ProdNet.new_peer(opt.id, king_addr, n, ctx, device=dev)


def party_count(opt) -> int:
    return opt.n or len(read_address_file(opt.input))


def drain(dev: torch.device) -> None:
    """Wait for the device, so a host clock around device work reads it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_scalars(rng: np.random.Generator, n: int, r: int) -> list[int]:
    """n scalars mod r, each from 40 little-endian bytes: the JAX example's
    n calls of rng.bytes(40) give the same bytes as this one call (each
    takes ten whole 32-bit words), at a tenth of the host time."""
    raw = rng.bytes(40 * n)
    return [int.from_bytes(raw[i : i + 40], "little") % r
            for i in range(0, 40 * n, 40)]


def reset_peak(dev: torch.device) -> None:
    """Restart the device's peak-memory count (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_stats(dev: torch.device) -> dict:
    """The kernels' launch counts in this process and its peak device
    memory (0 on the CPU)."""
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"launches": {k: v.launches for k, v in _cuda.KERNELS.items()},
            "peak_bytes": peak}


def report(line: dict) -> None:
    """The rank's last output line: one JSON object (launch.py reads it)."""
    print(json.dumps(line), flush=True)
