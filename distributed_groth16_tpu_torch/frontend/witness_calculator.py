"""Circom WASM witness calculator on the pure-Python interpreter.

Mirrors the reference's wasmer-based calculator
(ark-circom/src/witness/witness_calculator.rs:17-299) including both ABIs:

* **Circom 2** (`getVersion() == 2`): field elements move through the shared
  RW memory as big-endian sequences of u32 (witness_calculator.rs:219-255);
  inputs via `setInputSignal(fnv_msb, fnv_lsb, index)`.
* **Circom 1**: field elements live in linear memory in the snarkjs tagged
  layout (short / long / long-Montgomery, memory.rs:108-196); inputs via
  `getSignalOffset32` + `setSignal`, outputs via `getPWitness` + a tagged
  read.

Signal names are addressed by their 64-bit FNV-1a hash split into two u32s
(witness/mod.rs:18-24).
"""

from __future__ import annotations

from .wasm_vm import HostExit, Instance, Module

__all__ = ["WitnessCalculator", "fnv1a_64"]

# BN254 Fr — the only prime circom's snarkjs toolchain emits for these
# fixtures; the generic path reads the prime from the module itself.
_R_INV = 9915499612839321149637521777990102151350674507940716049588462388200839649614


def fnv1a_64(s: str) -> tuple[int, int]:
    """64-bit FNV-1a of a signal name -> (msb32, lsb32)."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF


def _host_funcs(collector):
    def error(*a):
        raise HostExit(a)

    def exception_handler(code):
        if code:
            raise HostExit(code)

    def noop(*a):
        return 0

    return {
        ("runtime", "error"): error,
        ("runtime", "exceptionHandler"): exception_handler,
        ("runtime", "logSetSignal"): noop,
        ("runtime", "logGetSignal"): noop,
        ("runtime", "logFinishComponent"): noop,
        ("runtime", "logStartComponent"): noop,
        ("runtime", "log"): noop,
        ("runtime", "showSharedRWMemory"): noop,
        ("runtime", "printErrorMessage"): noop,
        ("runtime", "writeBufferMessage"): noop,
    }


class WitnessCalculator:
    def __init__(self, wasm_bytes: bytes, engine: str = "auto"):
        """engine: "auto" (C tier when buildable — ~100x the throughput of
        the Python VM — else Python), "c", or "python". DG16_NO_CWASM=1
        forces the Python VM globally."""
        from ..utils import config as _config

        self.module = Module(wasm_bytes)
        use_c = engine == "c" or (
            engine == "auto" and not _config.env_flag("DG16_NO_CWASM")
        )
        self.inst = None
        self._auto = engine == "auto"
        if use_c:
            try:
                from .wasm_cexec import CInstance

                self.inst = CInstance(self.module, _host_funcs(self))
            except ImportError:
                if engine == "c":
                    raise
        if self.inst is None:
            self.inst = Instance(self.module, _host_funcs(self))
            self._auto = False
        try:
            self.version = self.inst.call("getVersion")[0]
        except KeyError:
            self.version = 1
        if self.version >= 2:
            self.n32 = self.inst.call("getFieldNumLen32")[0]
            self.inst.call("getRawPrime")
            words = [
                self.inst.call("readSharedRWMemory", [i])[0]
                for i in range(self.n32)
            ]
            self.prime = 0
            for w in reversed(words):  # words are little-endian u32s
                self.prime = (self.prime << 32) | w
        else:
            self.n32 = (self.inst.call("getFrLen")[0] >> 2) - 2
            ptr = self.inst.call("getPRawPrime")[0]
            self.prime = int.from_bytes(
                self.inst.memory[ptr : ptr + self.n32 * 4], "little"
            )

    @classmethod
    def from_file(cls, path) -> "WitnessCalculator":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- Circom 1 tagged memory (memory.rs:108-196) --------------------------

    def _read_fr(self, ptr: int) -> int:
        mem = self.inst.memory
        if mem[ptr + 7] & 0x80:
            num = int.from_bytes(mem[ptr + 8 : ptr + 8 + self.n32 * 4], "little")
            if mem[ptr + 7] & 0x40:
                num = num * _R_INV % self.prime
            return num
        num = int.from_bytes(mem[ptr : ptr + 4], "little")
        if mem[ptr + 3] & 0x40:
            num -= 0x100000000  # small negative
        return num

    def _write_fr(self, ptr: int, value: int):
        mem = self.inst.memory
        short_max = 0x80000000
        short_min = self.prime - short_max  # as signed: -(2^31)
        v = value % self.prime
        signed = v if v < short_max else v - self.prime
        if -short_max < signed < short_max and abs(signed) < short_min:
            # short form: i32 value, tag word 0
            mem[ptr : ptr + 4] = (signed & 0xFFFFFFFF).to_bytes(4, "little")
            mem[ptr + 4 : ptr + 8] = b"\x00\x00\x00\x00"
        else:
            mem[ptr : ptr + 4] = b"\x00\x00\x00\x00"
            mem[ptr + 4 : ptr + 8] = b"\x00\x00\x00\x80"  # long tag
            mem[ptr + 8 : ptr + 8 + self.n32 * 4] = v.to_bytes(
                self.n32 * 4, "little"
            )

    def _read_u32(self, ptr):
        return int.from_bytes(self.inst.memory[ptr : ptr + 4], "little")

    def _write_u32(self, ptr, v):
        self.inst.memory[ptr : ptr + 4] = v.to_bytes(4, "little")

    # -- witness computation --------------------------------------------------

    def calculate_witness(self, inputs: dict, sanity_check: bool = False):
        """inputs: {signal name: int | list[int]} -> list of witness ints."""
        try:
            self.inst.call("init", [1 if sanity_check else 0])
            if self.version >= 2:
                return self._calculate_circom2(inputs)
            return self._calculate_circom1(inputs)
        except Exception as e:
            from .wasm_cexec import WasmMemoryLimit

            # the C tier caps linear memory; the Python VM grows without
            # bound — retry there so huge circuits keep working under the
            # default engine. Any other trap re-raises as-is.
            if not (self._auto and isinstance(e, WasmMemoryLimit)):
                raise
            self.inst = Instance(self.module, _host_funcs(self))
            self._auto = False
            self.inst.call("init", [1 if sanity_check else 0])
            if self.version >= 2:
                return self._calculate_circom2(inputs)
            return self._calculate_circom1(inputs)

    def _values(self, v):
        if isinstance(v, (list, tuple)):
            out = []
            for x in v:
                out.extend(self._values(x))
            return out
        return [int(v)]

    def _calculate_circom2(self, inputs):
        n32 = self.n32
        for name, v in inputs.items():
            msb, lsb = fnv1a_64(name)
            for i, value in enumerate(self._values(v)):
                val = value % self.prime
                for j in range(n32):
                    self.inst.call(
                        "writeSharedRWMemory",
                        [j, (val >> (32 * j)) & 0xFFFFFFFF],
                    )
                self.inst.call("setInputSignal", [msb, lsb, i])
        size = self.inst.call("getWitnessSize")[0]
        out = []
        for i in range(size):
            self.inst.call("getWitness", [i])
            acc = 0
            for j in range(n32):
                acc |= self.inst.call("readSharedRWMemory", [j])[0] << (32 * j)
            out.append(acc)
        return out

    def _calculate_circom1(self, inputs):
        old_free = self._read_u32(0)
        p_sig = self._alloc(8)
        p_fr = self._alloc(self.n32 * 4 + 8)
        for name, v in inputs.items():
            msb, lsb = fnv1a_64(name)
            self.inst.call("getSignalOffset32", [p_sig, 0, msb, lsb])
            sig_offset = self._read_u32(p_sig)
            for i, value in enumerate(self._values(v)):
                self._write_fr(p_fr, value)
                self.inst.call("setSignal", [0, 0, sig_offset + i, p_fr])
        n_vars = self.inst.call("getNVars")[0]
        out = []
        for i in range(n_vars):
            ptr = self.inst.call("getPWitness", [i])[0]
            out.append(self._read_fr(ptr) % self.prime)
        self._write_u32(0, old_free)
        return out

    def _alloc(self, size):
        p = self._read_u32(0)
        self._write_u32(0, p + size)
        return p
