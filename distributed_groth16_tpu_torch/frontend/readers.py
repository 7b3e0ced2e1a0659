"""Binary circuit-artifact readers: iden3 `.r1cs` and snarkjs `.wtns`.

Format parity with the reference's ark-circom readers
(ark-circom/src/circom/r1cs_reader.rs — iden3 r1cs_bin_format spec;
`.wtns` is the snarkjs witness container the same toolchain emits). Both are
little-endian section files: magic, version u32, n_sections u32, then
(type u32, size u64, payload) sections. Field elements are 32-byte LE
standard-form integers (BN254 only, as in the reference,
r1cs_reader.rs:163-189).

WASM witness calculation (the reference's wasmer-based WitnessCalculator,
ark-circom/src/witness/witness_calculator.rs) runs on the vendored
pure-Python interpreter (wasm_vm.py — no host WASM runtime ships in this
environment). Witnesses can also be supplied via `.wtns` files or the
native frontend (frontend/r1cs.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..ops.constants import R
from .r1cs import R1CS

_BN254_PRIME_LE = R.to_bytes(32, "little")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("unexpected EOF")
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes(8))[0]

    def field(self, n8: int = 32) -> int:
        return int.from_bytes(self.bytes(n8), "little")


def _sections(rd: _Reader, magic: bytes) -> dict[int, tuple[int, int]]:
    """Parse the container frame; returns {section_type: (offset, size)}."""
    if rd.bytes(4) != magic:
        raise ValueError(f"bad magic, expected {magic!r}")
    version = rd.u32()
    if version > 2:
        raise ValueError(f"unsupported version {version}")
    n_sections = rd.u32()
    out = {}
    for _ in range(n_sections):
        typ = rd.u32()
        size = rd.u64()
        out[typ] = (rd.pos, size)
        rd.pos += size
    return out


@dataclass
class R1CSHeader:
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int


def read_r1cs(path_or_bytes) -> tuple[R1CS, R1CSHeader]:
    """Parse an iden3 `.r1cs` file into the native R1CS struct.

    num_instance = 1 + n_pub_out + n_pub_in (wire 0 = constant 1), matching
    the reference (r1cs_reader.rs:29-31).
    """
    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    rd = _Reader(bytes(data))
    secs = _sections(rd, b"r1cs")
    # header (type 1)
    off, _ = secs[1]
    rd.pos = off
    n8 = rd.u32()
    if n8 != 32:
        raise ValueError("only 32-byte fields supported")
    prime = rd.bytes(32)
    if prime != _BN254_PRIME_LE:
        raise ValueError("only BN254 supported")
    hdr = R1CSHeader(
        n_wires=rd.u32(),
        n_pub_out=rd.u32(),
        n_pub_in=rd.u32(),
        n_prv_in=rd.u32(),
        n_labels=rd.u64(),
        n_constraints=rd.u32(),
    )
    # constraints (type 2): per constraint three LCs of (n u32, then
    # (wire u32, coeff 32B LE) entries)
    off, _ = secs[2]
    rd.pos = off

    def lc():
        n = rd.u32()
        out = []
        for _ in range(n):
            wire = rd.u32()
            coeff = rd.field(n8)
            out.append((coeff % R, wire))
        return out

    a_rows, b_rows, c_rows = [], [], []
    for _ in range(hdr.n_constraints):
        a_rows.append(lc())
        b_rows.append(lc())
        c_rows.append(lc())

    num_instance = 1 + hdr.n_pub_out + hdr.n_pub_in
    r1cs = R1CS(
        num_instance=num_instance,
        num_witness=hdr.n_wires - num_instance,
        a=a_rows,
        b=b_rows,
        c=c_rows,
    )
    return r1cs, hdr


def read_wtns(path_or_bytes) -> list[int]:
    """Parse a snarkjs `.wtns` witness file -> full assignment (wire order,
    starting with the constant 1)."""
    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    rd = _Reader(bytes(data))
    secs = _sections(rd, b"wtns")
    off, _ = secs[1]
    rd.pos = off
    n8 = rd.u32()
    prime = rd.field(n8)
    if prime != R:
        raise ValueError("only BN254 supported")
    n_witness = rd.u32()
    off, _ = secs[2]
    rd.pos = off
    return [rd.field(n8) for _ in range(n_witness)]


def write_r1cs(r1cs: R1CS, num_private_inputs: int | None = None) -> bytes:
    """Serialize a native R1CS to the iden3 `.r1cs` binary format — lets
    circuits built with frontend.r1cs.ConstraintSystem flow through every
    artifact path (service store, CLI) as standard files.

    num_private_inputs: the header's nPrvIn. The native ConstraintSystem
    does not distinguish private inputs from internal wires, so this
    defaults to num_witness (an over-count external iden3 tools will show);
    pass the true count for spec-exact headers.
    """
    import io

    def lc_bytes(lc):
        out = struct.pack("<I", len(lc))
        for coeff, wire in lc:
            out += struct.pack("<I", wire) + int(coeff).to_bytes(32, "little")
        return out

    header = struct.pack("<I", 32) + _BN254_PRIME_LE
    n_pub_out = 0
    n_pub_in = r1cs.num_instance - 1
    n_prv_in = (
        num_private_inputs
        if num_private_inputs is not None
        else r1cs.num_witness
    )
    header += struct.pack(
        "<IIIIQI",
        r1cs.num_wires,
        n_pub_out,
        n_pub_in,
        n_prv_in,
        r1cs.num_wires,
        r1cs.num_constraints,
    )
    constraints = b"".join(
        lc_bytes(r1cs.a[j]) + lc_bytes(r1cs.b[j]) + lc_bytes(r1cs.c[j])
        for j in range(r1cs.num_constraints)
    )
    wire_map = b"".join(
        struct.pack("<Q", i) for i in range(r1cs.num_wires)
    )
    buf = io.BytesIO()
    buf.write(b"r1cs" + struct.pack("<II", 1, 3))
    for typ, payload in ((1, header), (2, constraints), (3, wire_map)):
        buf.write(struct.pack("<IQ", typ, len(payload)))
        buf.write(payload)
    return buf.getvalue()


def write_wtns(assignment: list[int]) -> bytes:
    """Serialize a full assignment to the snarkjs `.wtns` binary format."""
    import io

    sec1 = struct.pack("<I", 32) + _BN254_PRIME_LE + struct.pack(
        "<I", len(assignment)
    )
    sec2 = b"".join(int(v % R).to_bytes(32, "little") for v in assignment)
    buf = io.BytesIO()
    buf.write(b"wtns" + struct.pack("<II", 2, 2))
    for typ, payload in ((1, sec1), (2, sec2)):
        buf.write(struct.pack("<IQ", typ, len(payload)))
        buf.write(payload)
    return buf.getvalue()


# Circom WASM witness calculation runs on the vendored pure-Python WASM
# interpreter (wasm_vm.py) — the wasmer role of witness_calculator.rs:17.
from .witness_calculator import WitnessCalculator  # noqa: E402,F401
