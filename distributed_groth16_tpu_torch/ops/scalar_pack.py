"""Curve-generic scalar encoding and packed-share construction for the BLS
curve configurations (ops/bls12_377.py, ops/bls12_381.py) — the
counterpart of distributed_groth16_tpu/ops/scalar_pack.py.

The BN254 path packs field shares with its device NTT (parallel/pss.py);
for another scalar field the pack map is applied as an explicit (n, l)
matrix mul-add over that field's PrimeField tensors."""

from __future__ import annotations

import numpy as np
import torch

from .constants import N_LIMBS
from .field import resolve_device


def encode_scalars(values, r: int, device=None) -> torch.Tensor:
    """Python ints -> (n, 16) standard-form int32 limbs mod r (r < 2^256)
    on `device` (None: CUDA)."""
    assert r < 1 << (16 * N_LIMBS)
    buf = b"".join((int(v) % r).to_bytes(2 * N_LIMBS, "little")
                   for v in values)
    arr = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return torch.as_tensor(arr.reshape(-1, N_LIMBS),
                           device=resolve_device(device))


def pack_scalars(pp, values, F, r: int, device=None) -> torch.Tensor:
    """Pack secrets l at a time into n Montgomery share tensors on `device`:
    out[p, j] = sum_i M[p][i] * chunk_j[i] over PrimeField F (F.nl is the
    limb count: 16 for r377, 17 for r381).

    CONSECUTIVE chunking: chunk j packs values[j*l : (j+1)*l] (pair it with
    identically chunked packexp_from_public base shares). Returns
    (n, c, F.nl)."""
    nl = F.nl
    vals = [int(v) % r for v in values]
    vals += [0] * ((-len(vals)) % pp.l)
    c = len(vals) // pp.l
    chunks = F.encode(vals, device).reshape(c, pp.l, nl)
    mat = F.encode(
        [pp.pack_matrix[p][i] for p in range(pp.n) for i in range(pp.l)],
        device,
    ).reshape(pp.n, pp.l, nl)
    out = []
    for p in range(pp.n):
        acc = F.mul(chunks[:, 0, :], mat[p, 0][None, :])
        for i in range(1, pp.l):
            acc = F.add(acc, F.mul(chunks[:, i, :], mat[p, i][None, :]))
        out.append(acc)
    return torch.stack(out, dim=0)
