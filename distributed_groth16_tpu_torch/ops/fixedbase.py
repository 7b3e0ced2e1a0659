"""Windowed fixed-base scalar multiplication — the setup workhorse; the
counterpart of distributed_groth16_tpu/ops/fixedbase.py.

Every scalar multiplication in Groth16 setup shares one base (the G1/G2
generator): precompute T[w][d] = d * 2^(c*w) * G once on the host
(ops/refmath.py), then each scalar costs N_WINDOWS batched complete
additions of table gathers. The adds run on the limb-major batches of
ops/limb_kernels.py: kernel 1 on a CUDA tensor, its plain version on a
CPU tensor. The result equals the row-major curve adds' (ops/curve.py,
which the JAX package's fixed_base_mul runs) limb for limb: both are
RCB16 algorithm 7, canonicalised.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import refmath as rm
from .constants import G1_GENERATOR, G2_GENERATOR, LIMB_BITS
from .curve import g1, g2
from .limb_kernels import lg1, lg2

WINDOW_C = 8  # digits per window; divides the 16-bit limb
N_WINDOWS = 256 // WINDOW_C


def _host_table(host_ops, base_affine):
    """(W, 2^c) affine host points: row w holds d * 2^(c*w) * B."""
    rows = []
    bw = base_affine
    for _ in range(N_WINDOWS):
        row = [None, bw]
        for _ in range(2, 1 << WINDOW_C):
            row.append(host_ops.add(row[-1], bw))
        rows.append(row)
        for _ in range(WINDOW_C):
            bw = host_ops.double(bw)
    return rows


@functools.cache
def _table_np(which: str) -> np.ndarray:
    """(ROWS, W * 2^c) limb-major table of the G1/G2 generator: entry
    (w, d) = d * 2^(c*w) * G in column w * 2^c + d."""
    if which == "g1":
        rows, curve, g = _host_table(rm.G1, G1_GENERATOR), g1(), lg1()
    else:
        rows, curve, g = _host_table(rm.G2, G2_GENERATOR), g2(), lg2()
    return g.from_rowmajor(
        curve.encode([p for row in rows for p in row], "cpu")).numpy()


@functools.cache
def generator_table(which: str, device) -> torch.Tensor:
    """_table_np on `device`."""
    return torch.as_tensor(_table_np(which), device=device)


def _digits(scalars_std) -> torch.Tensor:
    """(n, 16) standard-form limbs -> (n, W) c-bit digits."""
    w = torch.arange(N_WINDOWS, device=scalars_std.device)
    limbs = scalars_std.long()[:, (w * WINDOW_C) // LIMB_BITS]
    return (limbs >> ((w * WINDOW_C) % LIMB_BITS)) & ((1 << WINDOW_C) - 1)


def fixed_base_mul(which: str, scalars_std, chunk: int = 1 << 19):
    """scalars (n, 16) standard form -> (n, 3)+elem canonical projective
    points scalar * G on the named generator ("g1" | "g2"), on the
    scalars' device. Chunked to bound peak memory."""
    g = lg1() if which == "g1" else lg2()
    dev = scalars_std.device
    table = generator_table(which, dev)
    parts = []
    for s in range(0, scalars_std.shape[0], chunk):
        digits = _digits(scalars_std[s : s + chunk])  # (n, W)
        col = digits + torch.arange(N_WINDOWS, device=dev) * (1 << WINDOW_C)
        acc = g.infinity(digits.shape[0], dev)
        for w in range(N_WINDOWS):
            acc = g.add(acc, table[:, col[:, w]])
        parts.append(g.to_rowmajor(acc))
    return torch.cat(parts, dim=0)


# -- host-side windowed mul for arbitrary fixed bases ------------------------
# The verifier's prepare_inputs (models/groth16/verify.py): gamma_abc bases
# are fixed per circuit, so a c = 4 table per base pays from the third
# multiplication on.

_HOST_WINDOW_C = 4
_HOST_N_WINDOWS = 256 // _HOST_WINDOW_C


@functools.lru_cache(maxsize=256)
def _host_mul_table(which: str, base_affine):
    host_ops = rm.G1 if which == "g1" else rm.G2
    rows = []
    bw = base_affine
    for _ in range(_HOST_N_WINDOWS):
        row = [None, bw]
        for _ in range(2, 1 << _HOST_WINDOW_C):
            row.append(host_ops.add(row[-1], bw))
        rows.append(row)
        for _ in range(_HOST_WINDOW_C):
            bw = host_ops.double(bw)
    return rows


def host_windowed_mul(which: str, base_affine, k: int):
    """k * base on host ("g1" | "g2") through the cached windowed table;
    None base or k == 0 mod order gives None."""
    host_ops = rm.G1 if which == "g1" else rm.G2
    k %= host_ops.order
    if base_affine is None or k == 0:
        return None
    rows = _host_mul_table(which, base_affine)
    mask = (1 << _HOST_WINDOW_C) - 1
    acc = None
    for w in range(_HOST_N_WINDOWS):
        d = (k >> (w * _HOST_WINDOW_C)) & mask
        if d:
            acc = host_ops.add(acc, rows[w][d])
    return acc
