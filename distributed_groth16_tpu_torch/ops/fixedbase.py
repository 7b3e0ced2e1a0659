"""Windowed fixed-base scalar multiplication — the setup workhorse; the
counterpart of distributed_groth16_tpu/ops/fixedbase.py.

Every scalar multiplication in Groth16 setup shares one base (the G1/G2
generator): precompute T[w][d] = d * 2^(c*w) * G once on the host
(ops/refmath.py), then each scalar costs N_WINDOWS batched complete
additions of table gathers. These are row-major curve adds (ops/curve.py),
plain PyTorch: the JAX package has no TPU kernel here either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import refmath as rm
from .constants import G1_GENERATOR, G2_GENERATOR, LIMB_BITS
from .curve import g1, g2

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
    if which == "g1":
        rows, curve = _host_table(rm.G1, G1_GENERATOR), g1()
    else:
        rows, curve = _host_table(rm.G2, G2_GENERATOR), g2()
    enc = curve.encode([p for row in rows for p in row], "cpu").numpy()
    return enc.reshape((N_WINDOWS, 1 << WINDOW_C) + enc.shape[1:])


@functools.cache
def generator_table(which: str, device) -> torch.Tensor:
    """Table (W, 2^c, 3) + elem for the G1/G2 generator on `device`."""
    return torch.as_tensor(_table_np(which), device=device)


def _digits(scalars_std) -> torch.Tensor:
    """(n, 16) standard-form limbs -> (n, W) c-bit digits."""
    w = torch.arange(N_WINDOWS, device=scalars_std.device)
    limbs = scalars_std.long()[:, (w * WINDOW_C) // LIMB_BITS]
    return (limbs >> ((w * WINDOW_C) % LIMB_BITS)) & ((1 << WINDOW_C) - 1)


def fixed_base_mul(which: str, scalars_std, chunk: int = 1 << 19):
    """scalars (n, 16) standard form -> (n, 3)+elem projective points
    scalar * G on the named generator ("g1" | "g2"), on the scalars'
    device. Chunked to bound peak memory."""
    curve = g1() if which == "g1" else g2()
    table = generator_table(which, scalars_std.device)
    parts = []
    for s in range(0, scalars_std.shape[0], chunk):
        digits = _digits(scalars_std[s : s + chunk])  # (n, W)
        acc = curve.infinity((digits.shape[0],), scalars_std.device)
        for w in range(N_WINDOWS):
            acc = curve.add(acc, table[w][digits[:, w]])
        parts.append(acc)
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
