"""Ethereum/Solidity export: proofs, verifying keys, and public inputs as
the uint256 tuples Groth16 verifier contracts expect.

Role parity with the reference's ethereum.rs (ark-circom/src/ethereum.rs:
10-174): G1 -> (x, y), G2 -> ([x.c1, x.c0], [y.c1, y.c0]) — Solidity
pairing precompiles take the Fq2 c1 limb FIRST (ethereum.rs:82-85) —
infinity as all-zero coordinates, and field elements as uint256 integers
(decimal strings in the snarkjs-style JSON, 0x-words in calldata).
Conversions are bijective: from_* functions accept
the exported form back into the native Proof / VerifyingKey types.
"""

from __future__ import annotations

from ..models.groth16.keys import Proof, VerifyingKey
from ..ops.constants import Q, R


def _g1_tuple(pt) -> tuple[int, int]:
    if pt is None:
        return (0, 0)
    x, y = pt
    return (int(x) % Q, int(y) % Q)


def _g2_tuple(pt) -> tuple[tuple[int, int], tuple[int, int]]:
    """c1 limb serialized first (ethereum.rs:82-85)."""
    if pt is None:
        return ((0, 0), (0, 0))
    (x0, x1), (y0, y1) = pt
    return ((int(x1) % Q, int(x0) % Q), (int(y1) % Q, int(y0) % Q))


def _g1_from_tuple(t):
    x, y = t
    if x == 0 and y == 0:
        return None
    return (x % Q, y % Q)


def _g2_from_tuple(t):
    (x1, x0), (y1, y0) = t
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0 % Q, x1 % Q), (y0 % Q, y1 % Q))


def proof_to_eth(proof: Proof):
    """(a, b, c) uint256 tuples — the calldata layout of a Solidity
    Groth16 verifier's verifyProof (ethereum.rs Proof::as_tuple)."""
    return (
        _g1_tuple(proof.a),
        _g2_tuple(proof.b),
        _g1_tuple(proof.c),
    )


def proof_from_eth(t) -> Proof:
    a, b, c = t
    return Proof(a=_g1_from_tuple(a), b=_g2_from_tuple(b), c=_g1_from_tuple(c))


def vk_to_eth(vk: VerifyingKey):
    """(alpha1, beta2, gamma2, delta2, ic) uint256 tuples
    (ethereum.rs VerifyingKey::as_tuple)."""
    return (
        _g1_tuple(vk.alpha_g1),
        _g2_tuple(vk.beta_g2),
        _g2_tuple(vk.gamma_g2),
        _g2_tuple(vk.delta_g2),
        [_g1_tuple(p) for p in vk.gamma_abc_g1],
    )


def vk_from_eth(t) -> VerifyingKey:
    alpha, beta, gamma, delta, ic = t
    return VerifyingKey(
        alpha_g1=_g1_from_tuple(alpha),
        beta_g2=_g2_from_tuple(beta),
        gamma_g2=_g2_from_tuple(gamma),
        delta_g2=_g2_from_tuple(delta),
        gamma_abc_g1=[_g1_from_tuple(p) for p in ic],
    )


def inputs_to_eth(values) -> list[int]:
    """Public inputs as uint256 ints (ethereum.rs Inputs)."""
    return [int(v) % R for v in values]


# -- snarkjs-style JSON forms ------------------------------------------------


def proof_to_json(proof: Proof) -> dict:
    """snarkjs-compatible proof JSON (pi_a/pi_b/pi_c, projective with
    z = 1; pi_b rows keep snarkjs' c0-first JSON order). Delegates to
    frontend.snarkjs.dump_proof — one emitter for the external format."""
    from .snarkjs import dump_proof

    return dump_proof(proof)


def solidity_calldata(proof: Proof, public_inputs) -> str:
    """The exact string `snarkjs generatecall` emits: four bracketed
    groups joined by bare commas with NO enclosing outer brackets —
    `[A.x, A.y],[[B.x.c1, B.x.c0],[B.y.c1, B.y.c0]],[C.x, C.y],[inputs]`
    — each word a quoted 0x-padded 32-byte hex, a space after the comma
    inside the 2-element pairs, none between inputs (snarkjs
    groth16ExportSolidityCallData). Paste-compatible with Remix /
    verifier tooling expecting generatecall output."""

    def word(v: int) -> str:
        return '"0x' + int(v).to_bytes(32, "big").hex() + '"'

    a, b, c = proof_to_eth(proof)
    inputs = ",".join(word(v) for v in inputs_to_eth(public_inputs))
    return (
        f"[{word(a[0])}, {word(a[1])}],"
        f"[[{word(b[0][0])}, {word(b[0][1])}],"
        f"[{word(b[1][0])}, {word(b[1][1])}]],"
        f"[{word(c[0])}, {word(c[1])}],"
        f"[{inputs}]"
    )
