"""Native R1CS representation and constraint-system builder.

The TPU build owns the constraint-system algebra natively (the reference
leans on the forked ark-relations ConstraintSystem; the observable surface
is ConstraintMatrices: num_instance_variables, num_constraints, and sparse
A/B/C rows of (coeff, wire) pairs — groth16/src/qap.rs:44-91 consumes
exactly that). Wire convention (arkworks/circom): wire 0 is the constant 1,
wires 1..num_instance are public inputs, the rest are private witness.

`ConstraintSystem` is the Python circuit-writing frontend (the role arkworks'
ConstraintSynthesizer plays for the reference's test circuits); `R1CS` is the
interchange struct shared with the .r1cs file reader (frontend/readers.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.constants import R

# A linear combination is a list of (coeff, wire) pairs; coeff is an int mod r.
LinearCombination = list[tuple[int, int]]


@dataclass
class R1CS:
    """Sparse R1CS: for every constraint j, <A_j, z> * <B_j, z> == <C_j, z>
    where z = [1, public..., private...]."""

    num_instance: int  # includes the constant-1 wire 0
    num_witness: int
    a: list[LinearCombination]
    b: list[LinearCombination]
    c: list[LinearCombination]

    @property
    def num_constraints(self) -> int:
        return len(self.a)

    @property
    def num_wires(self) -> int:
        return self.num_instance + self.num_witness

    def eval_lc(self, lc: LinearCombination, z: list[int]) -> int:
        return sum(coeff * z[wire] for coeff, wire in lc) % R

    def is_satisfied(self, z: list[int]) -> bool:
        if len(z) != self.num_wires or z[0] != 1:
            return False
        for aj, bj, cj in zip(self.a, self.b, self.c):
            if self.eval_lc(aj, z) * self.eval_lc(bj, z) % R != self.eval_lc(
                cj, z
            ):
                return False
        return True


@dataclass
class ConstraintSystem:
    """Imperative circuit builder producing an R1CS + full assignment.

    Usage:
        cs = ConstraintSystem()
        x = cs.new_instance(3)
        y = cs.new_witness(9)
        cs.enforce([(1, x)], [(1, x)], [(1, y)])   # x * x == y
        r1cs, assignment = cs.finish()
    """

    instance: list[int] = field(default_factory=lambda: [1])
    witness: list[int] = field(default_factory=list)
    a: list[LinearCombination] = field(default_factory=list)
    b: list[LinearCombination] = field(default_factory=list)
    c: list[LinearCombination] = field(default_factory=list)
    _finished: bool = False

    ONE = 0  # wire index of the constant 1

    def new_instance(self, value: int) -> int:
        assert not self._finished, "instance wires must precede finish()"
        assert not self.witness, "allocate all instance wires before witness"
        self.instance.append(value % R)
        return len(self.instance) - 1

    def new_witness(self, value: int) -> int:
        assert not self._finished
        self.witness.append(value % R)
        return len(self.instance) + len(self.witness) - 1

    def enforce(
        self, a: LinearCombination, b: LinearCombination, c: LinearCombination
    ) -> None:
        self.a.append([(int(co) % R, w) for co, w in a])
        self.b.append([(int(co) % R, w) for co, w in b])
        self.c.append([(int(co) % R, w) for co, w in c])

    # convenience gadgets ----------------------------------------------------

    def mul(self, x: int, y: int) -> int:
        """Allocate z = x * y with its constraint; returns the wire."""
        z = self.new_witness(self.value(x) * self.value(y) % R)
        self.enforce([(1, x)], [(1, y)], [(1, z)])
        return z

    def add_const(self, x: int, k: int) -> int:
        """Allocate z = x + k (one constraint via multiplication by 1)."""
        z = self.new_witness((self.value(x) + k) % R)
        self.enforce([(1, x), (k % R, self.ONE)], [(1, self.ONE)], [(1, z)])
        return z

    def enforce_equal_const(self, x: int, k: int) -> None:
        self.enforce([(1, x)], [(1, self.ONE)], [(k % R, self.ONE)])

    def value(self, wire: int) -> int:
        ni = len(self.instance)
        return self.instance[wire] if wire < ni else self.witness[wire - ni]

    def finish(self) -> tuple[R1CS, list[int]]:
        self._finished = True
        r1cs = R1CS(
            num_instance=len(self.instance),
            num_witness=len(self.witness),
            a=self.a,
            b=self.b,
            c=self.c,
        )
        assignment = self.instance + self.witness
        assert r1cs.is_satisfied(assignment), "circuit is not satisfied"
        return r1cs, assignment


def mult_chain_circuit(x0: int, length: int) -> ConstraintSystem:
    """The fixtures/million-style chain: x_{i+1} = x_i * x_i + x_i, public
    output = final value (fixtures/million/million.circom shape — a long
    multiplicative chain whose constraint count is `length`)."""
    # compute final value first so it can be an instance wire (instance
    # wires must be allocated before witness wires)
    acc = x0 % R
    for _ in range(length):
        acc = (acc * acc + acc) % R
    cs = ConstraintSystem()
    out = cs.new_instance(acc)
    x = cs.new_witness(x0)
    for i in range(length):
        v = cs.value(x)
        nxt = (v * v + v) % R
        if i == length - 1:
            cs.enforce([(1, x)], [(1, x)], [(1, out), (R - 1, x)])
        else:
            y = cs.new_witness(nxt)
            cs.enforce([(1, x)], [(1, x)], [(1, y), (R - 1, x)])
            x = y
    return cs
