"""Groth16 verification: e(A, B) == e(alpha, beta) * e(L_pub, gamma) *
e(C, delta), checked as one multi-pairing on the host (ops/pairing.py) —
the counterpart of distributed_groth16_tpu/models/groth16/verify.py."""

from __future__ import annotations

from ...ops import refmath as rm
from ...ops.pairing import pairing_check
from .keys import Proof, VerifyingKey

# below this many public inputs the 256-bit ladder per input is cheaper
# than warming ops/fixedbase.py's per-base windowed tables
_FIXEDBASE_MIN_INPUTS = 8


def prepare_inputs(vk: VerifyingKey, public_inputs: list[int]):
    """L_pub = gamma_abc[0] + sum_i x_i * gamma_abc[i+1]."""
    if len(public_inputs) + 1 != len(vk.gamma_abc_g1):
        raise ValueError(
            f"{len(public_inputs)} public inputs for "
            f"{len(vk.gamma_abc_g1) - 1} instance wires"
        )
    if len(public_inputs) >= _FIXEDBASE_MIN_INPUTS:
        from ...ops.fixedbase import host_windowed_mul

        mul = lambda pt, x: host_windowed_mul("g1", pt, x)  # noqa: E731
    else:
        mul = lambda pt, x: rm.G1.scalar_mul(pt, x)  # noqa: E731
    acc = vk.gamma_abc_g1[0]
    for x, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = rm.G1.add(acc, mul(pt, x))
    return acc


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    l_pub = prepare_inputs(vk, public_inputs)
    return pairing_check(
        [
            (proof.b, proof.a),
            (vk.beta_g2, rm.G1.neg(vk.alpha_g1)),
            (vk.gamma_g2, rm.G1.neg(l_pub)),
            (vk.delta_g2, rm.G1.neg(proof.c)),
        ]
    )
