"""Circuit introspection + single-node prove — the port of the JAX
package's examples/introspect.py, the reference's
groth16/examples/test.rs:1-261 analog.

test.rs loads a circom fixture, prints constraint-system statistics
(matrix row counts, assignment length, input/constraint counts, struct
sizes), builds a SECOND setup-only circuit from the same config (no
inputs pushed) and compares its stats, then times a proof "without MPC"
(create_proof_with_reduction_and_matrices, r = s = 0) and
pairing-verifies it twice (once through a reconstructed Proof struct).
This does the same over the mycircuit artifacts (mycircuit.wasm and
mycircuit.r1cs in the directory $DG16_VECTORS names). Sizes are byte
sizes of the key's device tensors.

When the artifacts are absent the example does NOT silently pass: it
falls back to the in-repo fixture — the same c <== a*b multiplier
circuit built natively (frontend/r1cs.py) — and runs the identical
introspect/prove/verify ladder. Set DG16_REQUIRE_VECTORS=1 to fail
(exit 3) instead of falling back.

  python -m distributed_groth16_tpu_torch.examples.introspect \\
      [--a 3] [--b 11] [--device cpu]

The flags, defaults and printed lines are the JAX example's, plus --device
(default cuda; only an explicit cpu runs on the CPU). The last output
line is JSON: run()'s dict.

Departures from the JAX example:
  * DG16_EXAMPLE_TPU and the jax_platforms pin are gone: the device is
    --device;
  * DG16_VECTORS has no default directory: unset, the in-repo fixture
    runs (or, with DG16_REQUIRE_VECTORS=1, the example exits 3);
  * the proof's time ends in torch.cuda.synchronize().
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..models.groth16 import CompiledR1CS, Proof, prove_single, setup, verify
from ..ops.field import fr
from ..utils.config import env_str
from ._star import drain, open_device


class MissingVectors(RuntimeError):
    """DG16_REQUIRE_VECTORS=1 and no circom artifacts were found."""


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _circom_circuits(vectors: str, a: int, b: int):
    """(r1cs, full_assignment, setup_only_r1cs) from the circom
    artifacts — the test.rs builder/builder2 pair."""
    from ..frontend.builder import CircomBuilder, CircomConfig

    cfg = CircomConfig(f"{vectors}/mycircuit.wasm",
                       f"{vectors}/mycircuit.r1cs", sanity_check=True)
    builder = CircomBuilder(cfg)
    builder.push_input("a", a)
    builder.push_input("b", b)
    circuit = builder.build()

    # second, setup-only circuit from the same config (test.rs builder2:
    # no inputs pushed, no witness computed)
    circuit2 = CircomBuilder(cfg).setup()
    assert circuit2.witness is None
    return circuit.r1cs, circuit.witness, circuit2.r1cs


def _fixture_circuits(a: int, b: int):
    """The in-repo fallback fixture: mycircuit's c <== a*b multiplier,
    built natively with the ConstraintSystem API — same instance/witness
    shape as the circom artifact, no external files needed."""
    from ..frontend.r1cs import ConstraintSystem
    from ..ops.constants import R

    def build():
        cs = ConstraintSystem()
        c = cs.new_instance(a * b % R)
        aw = cs.new_witness(a)
        bw = cs.new_witness(b)
        cs.enforce([(1, aw)], [(1, bw)], [(1, c)])
        return cs.finish()

    r1cs, z = build()
    r1cs2, _ = build()  # the setup-only twin
    return r1cs, z, r1cs2


def run(a: int = 3, b: int = 11, device=None) -> dict:
    vectors = env_str("DG16_VECTORS")
    have_vectors = bool(vectors) and all(
        os.path.exists(f"{vectors}/mycircuit.{ext}") for ext in ("wasm",
                                                                 "r1cs"))
    if not have_vectors and env_str("DG16_REQUIRE_VECTORS") == "1":
        raise MissingVectors(
            f"introspect: FAIL — circom artifacts not found under "
            f"{vectors} and DG16_REQUIRE_VECTORS=1 (set DG16_VECTORS to "
            f"the ark-circom test-vectors directory)")
    dev = open_device(device)

    print(f"Current working directory: {os.getcwd()}")
    if have_vectors:
        print(f"using circom artifacts from {vectors}")
        r1cs, full_assignment, r1cs2 = _circom_circuits(vectors, a, b)
    else:
        print(
            f"circom artifacts not found under {vectors}; using the "
            f"in-repo multiplier fixture (set DG16_VECTORS to override)"
        )
        r1cs, full_assignment, r1cs2 = _fixture_circuits(a, b)

    pk = setup(r1cs, seed=42, device=dev)

    # -- introspection block (test.rs:171-205) -----------------------------
    pk_bytes = sum(
        _nbytes(t)
        for t in (
            pk.a_query, pk.b_g1_query, pk.b_g2_query, pk.h_query, pk.l_query
        )
    )
    nnz = sum(len(row) for row in r1cs.a + r1cs.b + r1cs.c)
    stats = {
        "pk_bytes": pk_bytes, "gamma_abc": len(pk.vk.gamma_abc_g1),
        "matrix_a": len(r1cs.a), "matrix_b": len(r1cs.b),
        "matrix_c": len(r1cs.c), "nonzeros": nnz,
        "assignment": len(full_assignment), "inputs": r1cs.num_instance,
        "constraints": r1cs.num_constraints, "inputs2": r1cs2.num_instance,
        "constraints2": r1cs2.num_constraints,
    }
    print(f"Size of pk (query tensors): {pk_bytes} bytes")
    print(f"Size of vk: {stats['gamma_abc']} gamma_abc points")
    print(f"Matrix A len: {len(r1cs.a)}")
    print(f"Matrix B len: {len(r1cs.b)}")
    print(f"Matrix C len: {len(r1cs.c)}")
    print(f"Matrix nonzeros (A+B+C): {nnz}")
    print(f"Full assignment len: {len(full_assignment)}")
    print(f"Number of inputs: {r1cs.num_instance}")
    print(f"Number of constraints: {r1cs.num_constraints}")
    print(f"Number of inputs2: {r1cs2.num_instance}")
    print(f"Number of constraints2: {r1cs2.num_constraints}")

    # -- proof without MPC, r = s = 0 (test.rs:211-231) --------------------
    comp = CompiledR1CS(r1cs, dev)
    z_mont = fr().encode(full_assignment, dev)
    drain(dev)
    t0 = time.time()
    proof = prove_single(pk, comp, z_mont, r=0, s=0)
    drain(dev)
    dt = time.time() - t0
    print(f"Proof: a={proof.a} b={proof.b} c={proof.c}")
    print(f"Time taken to create proof without MPC: {dt:.3f}s")

    public = full_assignment[1 : r1cs.num_instance]
    if not verify(pk.vk, proof, public):
        raise AssertionError("Proof verification failed!")
    # reconstructed-proof second verification (test.rs:246-260)
    proof2 = Proof(a=proof.a, b=proof.b, c=proof.c)
    if not verify(pk.vk, proof2, public):
        raise AssertionError("Reconstructed proof verification failed!")
    print("both verifications passed")
    return {"vectors": vectors if have_vectors else None, **stats,
            "prove_s": dt, "ok": True, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--a", type=int, default=3)
    ap.add_argument("--b", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    try:
        res = run(args.a, args.b, args.device)
    except MissingVectors as e:
        print(e, file=sys.stderr)
        return 3
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
