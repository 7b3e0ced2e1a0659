"""One-call circuit facade: load a Circom (.wasm, .r1cs) pair, push
inputs, get a witness-populated circuit — the ergonomic front door the
reference exposes as CircomConfig/CircomBuilder
(ark-circom/src/circom/builder.rs:20-97).

    cfg = CircomConfig("circuit.wasm", "circuit.r1cs")
    b = CircomBuilder(cfg)
    b.push_input("a", 3)
    circuit = b.build()            # witness computed + (optionally) checked
    pk = setup(circuit.r1cs)       # models/groth16 setup
    proof = prove_single(pk, CompiledR1CS(circuit.r1cs),
                         fr().encode(circuit.witness))
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .r1cs import R1CS
from .readers import read_r1cs
from .witness_calculator import WitnessCalculator


@dataclass
class CircomCircuit:
    """An R1CS plus (optionally) its computed witness — the builder's
    product (builder.rs CircomCircuit). `witness` is a flat list of ints
    (wire 0 = the constant 1) or None for the setup-only circuit."""

    r1cs: R1CS
    witness: list[int] | None = None

    def public_inputs(self) -> list[int]:
        """The instance wires (excluding the constant wire), as the
        verifier consumes them."""
        if self.witness is None:
            raise ValueError("no witness set — call CircomBuilder.build()")
        return self.witness[1 : self.r1cs.num_instance]


class CircomConfig:
    """Loaded (witness calculator, R1CS) pair (builder.rs:26-37).

    sanity_check=True makes build() verify the witness against every
    constraint (the reference runs this as a debug_assert)."""

    def __init__(self, wasm_path: str, r1cs_path: str,
                 sanity_check: bool = False):
        self.wtns = WitnessCalculator.from_file(wasm_path)
        self.r1cs, _ = read_r1cs(r1cs_path)
        self.sanity_check = sanity_check


@dataclass
class CircomBuilder:
    """Accumulates named inputs, then builds the witness-populated circuit
    (builder.rs:39-100). push_input may be called repeatedly with the
    same name to build array inputs, matching the reference's
    Vec-per-name semantics."""

    cfg: CircomConfig
    inputs: dict = field(default_factory=dict)

    def push_input(self, name: str, value) -> None:
        self.inputs.setdefault(name, []).append(int(value))

    def setup(self) -> CircomCircuit:
        """Witness-less circuit for parameter generation (builder.rs:57-68)."""
        return CircomCircuit(r1cs=self.cfg.r1cs)

    def build(self) -> CircomCircuit:
        """Compute the witness for the pushed inputs and attach it
        (builder.rs:70-100). The calculator accepts the per-name lists
        directly (the reference's Vec<BigInt> semantics)."""
        witness = self.cfg.wtns.calculate_witness(self.inputs)
        circuit = CircomCircuit(r1cs=self.cfg.r1cs, witness=witness)
        if self.cfg.sanity_check and not self.cfg.r1cs.is_satisfied(witness):
            raise ValueError("witness does not satisfy the R1CS")
        return circuit
