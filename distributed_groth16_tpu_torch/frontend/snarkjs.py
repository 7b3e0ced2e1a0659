"""snarkjs JSON interop: parse `proof.json` / `public.json` /
`verification_key.json` into this framework's host types.

This is the external differential surface: a proof produced by snarkjs (an
independent Groth16 implementation) must verify under our pairing stack,
which is the role the reference's `ark-circom/tests/groth16.rs:1-109` and
`test-vectors/prove.sh` pipeline play for arkworks.

snarkjs point encoding: decimal strings, projective with an explicit z
coordinate — G1 as [x, y, z], G2 as [[x0, x1], [y0, y1], [z0, z1]] with
each Fq2 element listed as [c0, c1]. z == 0 encodes infinity; z is
otherwise almost always 1, but we normalize generally.
"""

from __future__ import annotations

import json

from ..models.groth16.keys import Proof, VerifyingKey
from ..ops import refmath as rm
from ..ops.constants import Q, R


def _mul_unreduced(ops, p, k: int):
    """Double-and-add WITHOUT reducing k mod the group order — unlike
    _CurveOps.scalar_mul, so [r]P is a meaningful subgroup test."""
    acc, base = None, p
    while k:
        if k & 1:
            acc = ops.add(acc, base)
        base = ops.double(base)
        k >>= 1
    return acc


def _g1_from_json(coords) -> tuple | None:
    x, y, z = (int(c) % Q for c in coords)
    if z == 0:
        return None
    if z != 1:
        zinv = rm.finv(z, Q)
        x, y = x * zinv % Q, y * zinv % Q
    pt = (x, y)
    if not rm.G1.is_on_curve(pt):
        raise ValueError("snarkjs G1 point not on curve")
    return pt


def _fq2_from_json(pair) -> tuple:
    return (int(pair[0]) % Q, int(pair[1]) % Q)


def _g2_from_json(coords) -> tuple | None:
    x, y, z = (_fq2_from_json(c) for c in coords)
    if z == (0, 0):
        return None
    if z != (1, 0):
        zinv = rm.fq2_inv(z)
        x, y = rm.fq2_mul(x, zinv), rm.fq2_mul(y, zinv)
    pt = (x, y)
    if not rm.G2.is_on_curve(pt):
        raise ValueError("snarkjs G2 point not on curve")
    # BN254 G2 has a large cofactor: on-curve does NOT imply prime-order.
    # Without this, a crafted proof/vk can smuggle a small-subgroup point
    # into the pairing (arkworks/snarkjs both reject at deserialization).
    if _mul_unreduced(rm.G2, pt, R) is not None:
        raise ValueError("snarkjs G2 point not in the r-order subgroup")
    return pt


def _load(path_or_obj):
    if isinstance(path_or_obj, (dict, list)):
        return path_or_obj
    with open(path_or_obj) as f:
        return json.load(f)


def load_proof(path_or_obj) -> Proof:
    """Parse a snarkjs `proof.json` (groth16 / bn128 only)."""
    obj = _load(path_or_obj)
    if obj.get("protocol", "groth16") != "groth16":
        raise ValueError(f"unsupported protocol {obj['protocol']!r}")
    return Proof(
        a=_g1_from_json(obj["pi_a"]),
        b=_g2_from_json(obj["pi_b"]),
        c=_g1_from_json(obj["pi_c"]),
    )


def load_public(path_or_obj) -> list[int]:
    """Parse a snarkjs `public.json` (list of decimal field strings)."""
    return [int(s) for s in _load(path_or_obj)]


def load_verification_key(path_or_obj) -> VerifyingKey:
    """Parse a snarkjs `verification_key.json`.

    Ignores `vk_alphabeta_12` (a precomputed pairing snarkjs carries as an
    optimization); our verifier recomputes e(alpha, beta) inside the single
    multi-pairing check.
    """
    obj = _load(path_or_obj)
    if obj.get("protocol") != "groth16":
        raise ValueError(f"unsupported protocol {obj.get('protocol')!r}")
    if obj.get("curve") not in ("bn128", "bn254", None):
        raise ValueError(f"unsupported curve {obj.get('curve')!r}")
    return VerifyingKey(
        alpha_g1=_g1_from_json(obj["vk_alpha_1"]),
        beta_g2=_g2_from_json(obj["vk_beta_2"]),
        gamma_g2=_g2_from_json(obj["vk_gamma_2"]),
        delta_g2=_g2_from_json(obj["vk_delta_2"]),
        gamma_abc_g1=[_g1_from_json(p) for p in obj["IC"]],
    )


def _g1_to_json(pt) -> list[str]:
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def _g2_to_json(pt) -> list[list[str]]:
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = pt
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


def dump_proof(proof: Proof) -> dict:
    """Emit the snarkjs `proof.json` shape (round-trips with load_proof)."""
    return {
        "pi_a": _g1_to_json(proof.a),
        "pi_b": _g2_to_json(proof.b),
        "pi_c": _g1_to_json(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }
