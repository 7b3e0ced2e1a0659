"""Host-side pure-int Groth16 ground truth (CircomReduction semantics).

The single-node oracle every distributed stage is differentially tested
against — the role arkworks' `create_proof_with_reduction_and_matrices` and
`CircomReduction::witness_map_from_matrices` play in the reference's tests
(groth16/examples/sha256.rs:158-169, groth16/src/ext_wit.rs:137-144).
Slow bigint code for small circuits only.
"""

from __future__ import annotations

from ...frontend.r1cs import R1CS
from ...ops import refmath as rm
from ...ops.constants import R
from .keys import Proof, ProvingKey


def qap_vectors_host(r1cs: R1CS, z: list[int], m: int):
    """a, b, c size-m vectors (qap.rs:44-91 semantics)."""
    nc, ni = r1cs.num_constraints, r1cs.num_instance
    a = [0] * m
    b = [0] * m
    for j in range(nc):
        a[j] = r1cs.eval_lc(r1cs.a[j], z)
        b[j] = r1cs.eval_lc(r1cs.b[j], z)
    a[nc : nc + ni] = [x % R for x in z[:ni]]
    c = [a[i] * b[i] % R for i in range(m)]
    return a, b, c


def witness_map_host(r1cs: R1CS, z: list[int], m: int) -> list[int]:
    """CircomReduction::witness_map_from_matrices (ark-circom qap.rs:27-92):
    evaluations of AB - C at the ODD 2m-th roots of unity, in the order
    g*w_m^i — the h vector of length m."""
    a, b, c = qap_vectors_host(r1cs, z, m)
    dom = rm.Domain(m)
    g = rm.Domain(2 * m).group_gen  # the 2m-th root: shift to the odd coset
    shifted = rm.Domain(m, offset=g)
    a_ev = shifted.fft(dom.ifft(a))
    b_ev = shifted.fft(dom.ifft(b))
    c_ev = shifted.fft(dom.ifft(c))
    return [
        (a_ev[i] * b_ev[i] - c_ev[i]) % R for i in range(m)
    ]


def decode_pk_host(pk: ProvingKey) -> dict:
    """Device proving key -> host affine int points (for the oracle MSMs)."""
    from ...ops.curve import g1, g2

    return {
        "a_query": list(g1().decode(pk.a_query)),
        "b_g1_query": list(g1().decode(pk.b_g1_query)),
        "b_g2_query": list(g2().decode(pk.b_g2_query)),
        "h_query": list(g1().decode(pk.h_query)),
        "l_query": list(g1().decode(pk.l_query)),
    }


def prove_host(
    pk: ProvingKey, r1cs: R1CS, z: list[int], pk_host: dict | None = None
) -> Proof:
    """Non-MPC prove with r = s = 0, matching the reference's examples and
    service (sha256.rs:152-153, mpc-api/src/main.rs:344-345)."""
    hostpk = pk_host if pk_host is not None else decode_pk_host(pk)
    m = pk.domain_size
    ni = pk.num_instance
    h = witness_map_host(r1cs, z, m)
    a_pt = rm.G1.msm(hostpk["a_query"], z)
    a_pt = rm.G1.add(a_pt, pk.vk.alpha_g1)
    b_pt = rm.G2.msm(hostpk["b_g2_query"], z)
    b_pt = rm.G2.add(b_pt, pk.vk.beta_g2)
    c_pt = rm.G1.msm(hostpk["l_query"], z[ni:])
    c_pt = rm.G1.add(c_pt, rm.G1.msm(hostpk["h_query"], h))
    return Proof(a=a_pt, b=b_pt, c=c_pt)
