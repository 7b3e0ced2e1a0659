"""Groth16 key material: device-resident proving key, host verifying key —
the counterpart of distributed_groth16_tpu/models/groth16/keys.py.

`ProvingKey.save` / `load` use exactly the JAX package's .npz format
(uint32 limb arrays, a meta vector and the raw vk bytes), so a key saved
by either package loads in the other. `ProvingKey.from_numpy` takes that
dict of arrays and is what `load` is built on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops.field import resolve_device

_QUERIES = (
    "beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
    "h_query", "l_query",
)


@dataclass
class VerifyingKey:
    """Host affine points: G1 = (x, y) ints, G2 = ((c0,c1),(c0,c1));
    None = infinity."""

    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # one per instance wire (incl. the constant 1)


@dataclass
class ProvingKey:
    """Device projective query arrays (int32 limbs) + the clear vk."""

    vk: VerifyingKey
    beta_g1: torch.Tensor  # (3, 16)
    delta_g1: torch.Tensor  # (3, 16)
    a_query: torch.Tensor  # (num_wires, 3, 16)
    b_g1_query: torch.Tensor  # (num_wires, 3, 16)
    b_g2_query: torch.Tensor  # (num_wires, 3, 2, 16)
    h_query: torch.Tensor  # (m, 3, 16)
    l_query: torch.Tensor  # (num_witness, 3, 16)
    domain_size: int
    num_instance: int
    # Dealer-side discrete logs of the query arrays (QueryScalars in
    # proving_key.py), kept ONLY when this key was produced by an
    # in-process setup(). They let pack_proving_key run in the field (NTT
    # pack + windowed fixed-base) instead of in the exponent. Not
    # persisted by save(): a loaded key (external CRS) has None and packs
    # via the in-exponent ladder.
    #
    # SECURITY HAZARD: these are trapdoor-derived values (u_i(tau),
    # v_i(tau), the l/h scalars). Anyone holding them can forge proofs —
    # the CRS soundness assumption is exactly that they are destroyed.
    # save() deliberately omits them (and to() leaves them behind), but
    # ANY other serialization or transport of a live ProvingKey object
    # (pickle, cross-process handoff, a debug dump) would leak them. Call
    # strip() the moment the dealer no longer needs the fast pack route —
    # one-shot flows should use pack_proving_key(..., strip=True).
    query_scalars: object | None = None

    @property
    def num_wires(self) -> int:
        return self.a_query.shape[0]

    @property
    def device(self) -> torch.device:
        return self.a_query.device

    def strip(self) -> "ProvingKey":
        """Destroy the trapdoor-derived query_scalars (see the field's
        hazard note). After this the key packs via the in-exponent point
        route, like a loaded external CRS. Returns self for chaining."""
        self.query_scalars = None
        return self

    def to(self, device) -> "ProvingKey":
        """A copy of this key with every query array on `device`; the
        query scalars stay behind (the copy packs via the point route)."""
        moved = {k: getattr(self, k).to(device) for k in _QUERIES}
        return ProvingKey(
            vk=self.vk, domain_size=self.domain_size,
            num_instance=self.num_instance, **moved,
        )

    def save(self, path: str) -> None:
        """Persist to one .npz in the JAX package's format."""
        meta = np.array([self.domain_size, self.num_instance], dtype=np.int64)
        arrays = {
            k: getattr(self, k).cpu().numpy().astype(np.uint32)
            for k in _QUERIES
        }
        np.savez_compressed(path, meta=meta, vk=_vk_to_bytes(self.vk),
                            **arrays)

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "ProvingKey":
        """Key from the arrays of a saved .npz (e.g. a JAX-made key):
        uint32 limb arrays become int32 tensors on `device` (None: CUDA)."""
        dev = resolve_device(device)
        meta = arrays["meta"]
        queries = {
            k: torch.as_tensor(
                np.asarray(arrays[k]).astype(np.int32), device=dev
            )
            for k in _QUERIES
        }
        return ProvingKey(
            vk=_vk_from_bytes(np.asarray(arrays["vk"])),
            domain_size=int(meta[0]),
            num_instance=int(meta[1]),
            **queries,
        )

    @staticmethod
    def load(path: str, device=None) -> "ProvingKey":
        with np.load(path) as d:  # no pickle: keys may cross trust boundaries
            return ProvingKey.from_numpy({k: d[k] for k in d.files}, device)


# vk (de)serialization as raw 32-byte LE coordinate words. Infinity encodes
# as all-zero coordinates (x = y = 0 is on neither curve, both have b != 0).


def _flatten_pt(pt) -> list[int]:
    """G1 (x, y) -> [x, y]; G2 ((c0,c1),(c0,c1)) -> [x0, x1, y0, y1]."""
    if pt is None:
        return []
    out = []
    for coord in pt:
        if isinstance(coord, tuple):
            out.extend(coord)
        else:
            out.append(coord)
    return out


def _vk_to_bytes(vk: VerifyingKey) -> np.ndarray:
    def enc(pt, nwords):
        words = _flatten_pt(pt) or [0] * nwords
        return b"".join(int(w).to_bytes(32, "little") for w in words)

    blob = (
        enc(vk.alpha_g1, 2)
        + enc(vk.beta_g2, 4)
        + enc(vk.gamma_g2, 4)
        + enc(vk.delta_g2, 4)
        + b"".join(enc(p, 2) for p in vk.gamma_abc_g1)
    )
    return np.frombuffer(blob, dtype=np.uint8)


def _vk_from_bytes(arr: np.ndarray) -> VerifyingKey:
    blob = arr.tobytes()
    words = [
        int.from_bytes(blob[32 * i : 32 * (i + 1)], "little")
        for i in range(len(blob) // 32)
    ]

    def g1_pt(ws):
        return None if ws == [0, 0] else (ws[0], ws[1])

    def g2_pt(ws):
        if ws == [0, 0, 0, 0]:
            return None
        return ((ws[0], ws[1]), (ws[2], ws[3]))

    return VerifyingKey(
        alpha_g1=g1_pt(words[0:2]),
        beta_g2=g2_pt(words[2:6]),
        gamma_g2=g2_pt(words[6:10]),
        delta_g2=g2_pt(words[10:14]),
        gamma_abc_g1=[
            g1_pt(words[14 + 2 * i : 16 + 2 * i])
            for i in range((len(words) - 14) // 2)
        ],
    )


@dataclass
class Proof:
    """Host affine proof (a: G1, b: G2, c: G1)."""

    a: tuple
    b: tuple
    c: tuple
