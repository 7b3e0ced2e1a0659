"""ctypes binding for the native WASM execution tier (csrc/wasm_exec.c).

`CInstance` is drop-in for wasm_vm.Instance (same `call`/`memory`/`globals`
surface the witness calculator uses) but executes function bodies in C —
the wasmer role of the reference (witness_calculator.rs:56-153) without a
binary dependency: the .so is built on demand from the checked-in C source
with the system compiler and cached beside it. Falls back (ImportError
from `load_engine`) when no compiler is available; callers then keep the
pure-Python VM.

The C engine consumes wasm_vm.Module's pre-decoded instruction quads
verbatim, so the two engines are differential-testable against each other
(tests/test_wasm_cexec.py) and share all parsing/validation logic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from .wasm_vm import PAGE, HostExit, Module, WasmTrap

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "wasm_exec.c",
)

_TRAP_MSG = {
    1: "unreachable",
    2: "division by zero",
    3: "integer overflow",
    4: "undefined table element",
    5: "unsupported opcode",
    6: "stack overflow",
    8: "memory.grow beyond maximum",
    9: "out-of-bounds memory access",
}


class WasmMemoryLimit(WasmTrap):
    """The C tier's linear-memory ceiling was hit (trap 8). Auto-engine
    callers fall back to the unbounded Python VM on this — and only
    this — trap class."""

_HOSTFN = ctypes.CFUNCTYPE(
    ctypes.c_uint64,
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32),
)

_lib = None


def load_engine():
    """Compile (once, cached by source hash) and load the C engine."""
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    build_dir = os.path.join(os.path.dirname(_SRC), "build")
    so_path = os.path.join(build_dir, f"wasm_exec-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        cc = os.environ.get("CC", "cc")
        tmp = so_path + f".tmp{os.getpid()}"
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise ImportError(f"cannot build wasm_exec.so: {e}") from e
        os.replace(tmp, so_path)  # atomic vs concurrent builders
    lib = ctypes.CDLL(so_path)
    lib.wx_new.restype = ctypes.c_void_p
    I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.wx_new.argtypes = [
        I64P, ctypes.c_int64,          # ins_flat, n_ins
        I64P, ctypes.c_int64,          # func_off, nfuncs
        I64P, I64P, I64P,              # func_locals/nparams/nresults
        I64P, I64P,                    # type_nparams/nresults
        I64P, I64P, ctypes.c_int64,    # imp_nparams/nresults, n_imports
        I64P, ctypes.c_int64,          # br_pool, n_pool
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # table, ntable
        ctypes.POINTER(ctypes.c_int64),                  # globals
        ctypes.POINTER(ctypes.c_uint8),                  # memory
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # cur_pages, max
        _HOSTFN,
    ]
    lib.wx_call.restype = ctypes.c_int32
    lib.wx_call.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wx_free.restype = None
    lib.wx_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _serialize(m: Module):
    """Module -> the flat int64 arrays the C engine consumes.

    Validates every module-supplied index here, at load time: the C
    executor trusts local/global/call indices (the Python VM's IndexError
    safety net doesn't exist there), and the module may be
    client-uploaded."""
    ins_rows = []
    func_off = [0]
    br_pool = []
    nglobals = len(m.globals_init)
    nfuncs_total = len(m.func_imports) + len(m.functions)
    for fn in m.functions:
        nloc = len(m.types[fn.type_idx].params) + fn.locals_n
        for op, a, b, c in fn.code:
            if op in (0x20, 0x21, 0x22) and not 0 <= a < nloc:
                raise WasmTrap(f"local index {a} out of range")
            if op in (0x23, 0x24) and not 0 <= a < nglobals:
                raise WasmTrap(f"global index {a} out of range")
            if op == 0x10 and not 0 <= a < nfuncs_total:
                raise WasmTrap(f"call target {a} out of range")
            if op == 0x11 and not 0 <= a < len(m.types):
                raise WasmTrap(f"call_indirect type {a} out of range")
            if op in (0x02, 0x04, 0x05) and b < 0:
                # a truncated body leaves end/else pcs unpatched (-1); the
                # C engine would jump to pc=-1 and execute garbage quads
                raise WasmTrap("unterminated control structure")
            if op == 0x0E:  # br_table: a=targets list, b=default
                ins_rows.append((op, len(br_pool), len(a), b))
                br_pool.extend(a)
            else:
                if a >= 1 << 63:  # u64 const -> two's-complement int64
                    a -= 1 << 64
                ins_rows.append((op, a, b, c))
        func_off.append(len(ins_rows))
    ins = np.array(ins_rows, dtype=np.int64).reshape(-1, 4)
    ntypes_pad = 1024  # engine copies a fixed 1024-entry block
    tnp = np.zeros(ntypes_pad, np.int64)
    tnr = np.zeros(ntypes_pad, np.int64)
    for i, t in enumerate(m.types):
        tnp[i], tnr[i] = len(t.params), len(t.results)
    fl = np.array([f.locals_n for f in m.functions], np.int64)
    fnp = np.array(
        [len(m.types[f.type_idx].params) for f in m.functions], np.int64
    )
    fnr = np.array(
        [len(m.types[f.type_idx].results) for f in m.functions], np.int64
    )
    inp = np.array(
        [len(m.types[ti].params) for _, _, ti in m.func_imports] or [0],
        np.int64,
    )
    inr = np.array(
        [len(m.types[ti].results) for _, _, ti in m.func_imports] or [0],
        np.int64,
    )
    pool = np.array(br_pool or [0], np.int64)
    return ins, np.array(func_off, np.int64), fl, fnp, fnr, tnp, tnr, \
        inp, inr, pool


class CInstance:
    """wasm_vm.Instance-compatible instance backed by the C engine."""

    def __init__(self, module: Module, host_funcs=None, memory_pages=2000,
                 max_pages=32768):
        lib = load_engine()
        self.m = module
        self.host = host_funcs or {}
        pages = module.mem_limits[0] if module.mem_limits else memory_pages
        if module.mem_import:
            pages = max(pages, memory_pages)
        mx = module.mem_limits[1] if module.mem_limits else None
        self.max_pages = min(mx, max_pages) if mx else max_pages
        self.max_pages = max(self.max_pages, pages)
        # anonymous mmap: 2 GB of ADDRESS SPACE, but pages are only backed
        # when touched — an instance costs what the module actually uses,
        # not max_pages (a create_string_buffer here zero-filled 256 MB
        # per WitnessCalculator)
        import mmap

        self._mm = mmap.mmap(-1, self.max_pages * PAGE)
        self.memory = memoryview(self._mm)
        self._membacking = (
            ctypes.c_uint8 * (self.max_pages * PAGE)
        ).from_buffer(self._mm)
        self._memptr = ctypes.cast(
            self._membacking, ctypes.POINTER(ctypes.c_uint8)
        )
        self._cur_pages = ctypes.c_int64(pages)
        self.n_imports = len(module.func_imports)

        glb = [int(v) for _, v in module.globals_init]
        self._globals = (ctypes.c_int64 * max(1, len(glb)))(*glb)
        table = list(module.tables[0]) if module.tables else []
        for off, idxs in module.elems:
            need = off + len(idxs)
            if len(table) < need:
                table.extend([None] * (need - len(table)))
            for k, fi in enumerate(idxs):
                table[off + k] = fi
        self._table = (ctypes.c_int64 * max(1, len(table)))(
            *[-1 if t is None else t for t in table]
        )
        for off, blob in module.datas:
            self.memory[off : off + len(blob)] = blob

        self._pending_exc = None

        def host_cb(idx, args_p, nargs, trap_p):
            mod, name, ti = module.func_imports[idx]
            fn = self.host.get((mod, name))
            try:
                if fn is None:
                    raise WasmTrap(f"unresolved import {mod}.{name}")
                args = [args_p[i] for i in range(nargs)]
                r = fn(*args)
                return (r or 0) & 0xFFFFFFFFFFFFFFFF
            except BaseException as e:  # noqa: BLE001 — carried across C
                self._pending_exc = e
                trap_p[0] = 1
                return 0

        self._host_cb = _HOSTFN(host_cb)  # keep a ref (GC safety)

        (ins, off, fl, fnp, fnr, tnp, tnr, inp, inr, pool) = _serialize(
            module
        )
        self._eng = lib.wx_new(
            np.ascontiguousarray(ins.reshape(-1)), ins.shape[0],
            off, len(module.functions),
            fl if len(fl) else np.zeros(0, np.int64),
            fnp if len(fnp) else np.zeros(0, np.int64),
            fnr if len(fnr) else np.zeros(0, np.int64),
            tnp, tnr, inp, inr, self.n_imports,
            pool, len(pool),
            self._table, len(self._table),
            self._globals,
            self._memptr,
            ctypes.byref(self._cur_pages), self.max_pages,
            self._host_cb,
        )
        if not self._eng:
            raise ImportError("wx_new failed")
        self._lib = lib
        if module.start_func is not None:
            self.call_index(module.start_func, [])

    def __del__(self):
        try:
            if getattr(self, "_eng", None):
                self._lib.wx_free(self._eng)
        except Exception:
            pass

    @property
    def globals(self):
        return list(self._globals)

    # -- Instance-compatible API -------------------------------------------

    def exported(self, name):
        kind, idx = self.m.exports[name]
        assert kind == 0
        return idx

    def call(self, name, args=()):
        return self.call_index(self.exported(name), list(args))

    def call_index(self, fi, args):
        if fi < self.n_imports:
            mod, name, ti = self.m.func_imports[fi]
            fn = self.host.get((mod, name))
            if fn is None:
                raise WasmTrap(f"unresolved import {mod}.{name}")
            res = fn(*args)
            nres = len(self.m.types[ti].results)
            return [] if nres == 0 else [res & 0xFFFFFFFF]
        abuf = (ctypes.c_uint64 * max(1, len(args)))(
            *[a & 0xFFFFFFFFFFFFFFFF for a in args]
        )
        rbuf = (ctypes.c_uint64 * 8)()
        nr = ctypes.c_int32(0)
        self._pending_exc = None
        rc = self._lib.wx_call(
            self._eng, fi, abuf, len(args), rbuf, ctypes.byref(nr)
        )
        if rc == 7:  # host exception carried across the C boundary
            exc = self._pending_exc or HostExit("unknown")
            self._pending_exc = None
            raise exc
        if rc == 8:
            raise WasmMemoryLimit(_TRAP_MSG[8])
        if rc != 0:
            raise WasmTrap(_TRAP_MSG.get(rc, f"trap code {rc}"))
        return [int(rbuf[i]) for i in range(nr.value)]
