"""Minimal pure-Python WebAssembly interpreter for circom-emitted modules.

The reference executes circom `.wasm` witness generators under wasmer
(ark-circom/src/witness/witness_calculator.rs:56-153). No WASM runtime is
available in this image, so this module implements the small WASM subset
circom actually emits (verified by scanning every `.wasm` in the reference
checkout): integer-only MVP — i32/i64 arithmetic and comparisons, linear
memory with all integer load/store widths, structured control flow
(block/loop/if/br/br_if/br_table), direct and indirect calls, globals, and
imported host functions (`runtime.*` callbacks + optionally `env.memory`).
No floats, no SIMD, no reference types, no multi-value.

Design: function bodies are decoded once into flat instruction lists;
execution is a value-stack machine with an explicit control-frame stack
(frames record the branch-target pc, the value-stack height to unwind to,
and the block arity), which sidesteps static stack-height analysis while
staying faithful to structured-control semantics.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = ["Module", "Instance", "WasmTrap", "HostExit"]

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
PAGE = 65536


class WasmTrap(RuntimeError):
    pass


class HostExit(RuntimeError):
    """Raised by host callbacks (runtime.exceptionHandler / runtime.error)."""

    def __init__(self, code):
        super().__init__(f"wasm runtime exception, code {code}")
        self.code = code


def _uleb(data, i):
    r = s = 0
    while True:
        b = data[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _sleb(data, i):
    r = s = 0
    while True:
        b = data[i]
        i += 1
        r |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            if b & 0x40:
                r -= 1 << s
            return r, i


@dataclass
class FuncType:
    params: tuple
    results: tuple


@dataclass
class Function:
    type_idx: int
    locals_n: int = 0
    code: list = field(default_factory=list)  # flat (op, arg) list
    name: str = ""


# control-flow ops get structure metadata during pre-decode
_BLOCK, _LOOP, _IF = 0x02, 0x03, 0x04


class Module:
    """Parsed (and pre-decoded) WASM module."""

    def __init__(self, data: bytes):
        assert data[:8] == b"\x00asm\x01\x00\x00\x00", "bad wasm magic"
        self.types: list[FuncType] = []
        self.imports: list[tuple] = []  # (module, name, kind, extra)
        self.func_imports: list[tuple] = []
        self.functions: list[Function] = []
        self.tables: list[list] = []
        self.mem_limits = None  # (initial, max) if module defines memory
        self.mem_import = False
        self.globals_init: list[tuple] = []  # (mutable, init_value)
        self.exports: dict[str, tuple] = {}
        self.elems: list[tuple] = []  # (offset, [funcidx])
        self.datas: list[tuple] = []  # (offset, bytes)
        self.start_func: int | None = None
        self._parse(data)

    def _parse(self, data):
        i = 8
        code_bodies = []
        while i < len(data):
            sec, i = _uleb(data, i)
            size, i = _uleb(data, i)
            end = i + size
            j = i
            if sec == 1:  # types
                n, j = _uleb(data, j)
                for _ in range(n):
                    assert data[j] == 0x60
                    j += 1
                    np_, j = _uleb(data, j)
                    params = tuple(data[j : j + np_])
                    j += np_
                    nr, j = _uleb(data, j)
                    results = tuple(data[j : j + nr])
                    j += nr
                    self.types.append(FuncType(params, results))
            elif sec == 2:  # imports
                n, j = _uleb(data, j)
                for _ in range(n):
                    ml, j = _uleb(data, j)
                    mod = data[j : j + ml].decode()
                    j += ml
                    nl, j = _uleb(data, j)
                    name = data[j : j + nl].decode()
                    j += nl
                    kind = data[j]
                    j += 1
                    if kind == 0:  # function
                        ti, j = _uleb(data, j)
                        self.func_imports.append((mod, name, ti))
                    elif kind == 2:  # memory
                        flags = data[j]
                        j += 1
                        mn, j = _uleb(data, j)
                        mx = None
                        if flags & 1:
                            mx, j = _uleb(data, j)
                        self.mem_import = True
                        self.mem_limits = (mn, mx)
                    elif kind == 1:  # table
                        j += 1  # elemtype
                        flags = data[j]
                        j += 1
                        _, j = _uleb(data, j)
                        if flags & 1:
                            _, j = _uleb(data, j)
                    elif kind == 3:  # global
                        j += 2
                    self.imports.append((mod, name, kind))
            elif sec == 3:  # function decls
                n, j = _uleb(data, j)
                for _ in range(n):
                    ti, j = _uleb(data, j)
                    self.functions.append(Function(ti))
            elif sec == 4:  # tables
                n, j = _uleb(data, j)
                for _ in range(n):
                    j += 1  # elemtype 0x70
                    flags = data[j]
                    j += 1
                    mn, j = _uleb(data, j)
                    if flags & 1:
                        _, j = _uleb(data, j)
                    self.tables.append([None] * mn)
            elif sec == 5:  # memories
                n, j = _uleb(data, j)
                for _ in range(n):
                    flags = data[j]
                    j += 1
                    mn, j = _uleb(data, j)
                    mx = None
                    if flags & 1:
                        mx, j = _uleb(data, j)
                    self.mem_limits = (mn, mx)
            elif sec == 6:  # globals
                n, j = _uleb(data, j)
                for _ in range(n):
                    j += 1  # valtype
                    mut = data[j]
                    j += 1
                    val, j = self._const_expr(data, j)
                    self.globals_init.append((mut, val))
            elif sec == 7:  # exports
                n, j = _uleb(data, j)
                for _ in range(n):
                    nl, j = _uleb(data, j)
                    name = data[j : j + nl].decode()
                    j += nl
                    kind = data[j]
                    j += 1
                    idx, j = _uleb(data, j)
                    self.exports[name] = (kind, idx)
            elif sec == 8:  # start
                self.start_func, j = _uleb(data, j)
            elif sec == 9:  # elems
                n, j = _uleb(data, j)
                for _ in range(n):
                    flags, j = _uleb(data, j)
                    assert flags == 0, "only active funcref elems supported"
                    off, j = self._const_expr(data, j)
                    cnt, j = _uleb(data, j)
                    idxs = []
                    for _ in range(cnt):
                        fi, j = _uleb(data, j)
                        idxs.append(fi)
                    self.elems.append((off, idxs))
            elif sec == 10:  # code
                n, j = _uleb(data, j)
                for _ in range(n):
                    bsize, j = _uleb(data, j)
                    code_bodies.append((j, j + bsize))
                    j += bsize
            elif sec == 11:  # data
                n, j = _uleb(data, j)
                for _ in range(n):
                    flags, j = _uleb(data, j)
                    assert flags == 0, "only active data segments supported"
                    off, j = self._const_expr(data, j)
                    ln, j = _uleb(data, j)
                    self.datas.append((off, data[j : j + ln]))
                    j += ln
            i = end
        for fn, (s, e) in zip(self.functions, code_bodies):
            self._decode_body(fn, data, s, e)

    @staticmethod
    def _const_expr(data, j):
        op = data[j]
        j += 1
        if op == 0x41:
            v, j = _sleb(data, j)
        elif op == 0x42:
            v, j = _sleb(data, j)
        elif op == 0x23:
            v, j = _uleb(data, j)  # global.get — circom doesn't chain these
        else:
            raise WasmTrap(f"unsupported const expr opcode {op:#x}")
        assert data[j] == 0x0B
        return v, j + 1

    def _decode_body(self, fn: Function, data, j, end):
        nloc, j = _uleb(data, j)
        total = 0
        for _ in range(nloc):
            cnt, j = _uleb(data, j)
            j += 1
            total += cnt
        fn.locals_n = total
        code = []
        # control stack entries: [op, pc, else_pc] — patched on else/end
        ctrl = []
        while j < end:
            op = data[j]
            j += 1
            if op in (_BLOCK, _LOOP, _IF):
                bt, j = _sleb(data, j)
                arity = 0 if bt == -64 else 1  # 0x40 empty vs value type
                code.append([op, arity, -1, -1])  # [op, arity, end_pc, else_pc]
                ctrl.append(len(code) - 1)
            elif op == 0x05:  # else
                k = ctrl[-1]
                code.append([0x05, k, -1, -1])  # [2] patched to end_pc below
                code[k][3] = len(code)  # else body starts after the marker
            elif op == 0x0B:  # end
                if ctrl:
                    k = ctrl.pop()
                    code[k][2] = len(code)  # pc of this end instruction
                    if code[k][0] == _IF and code[k][3] != -1:
                        code[code[k][3] - 1][2] = len(code)  # else -> end
                    code.append([0x0B, k, -1, -1])
                else:
                    code.append([0x0B, -1, -1, -1])  # function end
            elif op in (0x0C, 0x0D):  # br / br_if
                depth, j = _uleb(data, j)
                code.append([op, depth, -1, -1])
            elif op == 0x0E:  # br_table
                cnt, j = _uleb(data, j)
                targets = []
                for _ in range(cnt):
                    d, j = _uleb(data, j)
                    targets.append(d)
                dflt, j = _uleb(data, j)
                code.append([op, targets, dflt, -1])
            elif op in (0x00, 0x01, 0x0F, 0x1A, 0x1B):  # unreachable/nop/ret/drop/select
                code.append([op, 0, -1, -1])
            elif op == 0x10:  # call
                fi, j = _uleb(data, j)
                code.append([op, fi, -1, -1])
            elif op == 0x11:  # call_indirect
                ti, j = _uleb(data, j)
                j += 1  # table byte
                code.append([op, ti, -1, -1])
            elif op in (0x20, 0x21, 0x22, 0x23, 0x24):  # local/global access
                idx, j = _uleb(data, j)
                code.append([op, idx, -1, -1])
            elif 0x28 <= op <= 0x3E:  # loads/stores
                _, j = _uleb(data, j)  # align
                off, j = _uleb(data, j)
                code.append([op, off, -1, -1])
            elif op in (0x3F, 0x40):  # memory.size / grow
                j += 1  # mem idx 0x00
                code.append([op, 0, -1, -1])
            elif op == 0x41:
                v, j = _sleb(data, j)
                code.append([op, v & M32, -1, -1])
            elif op == 0x42:
                v, j = _sleb(data, j)
                code.append([op, v & M64, -1, -1])
            else:
                code.append([op, 0, -1, -1])  # plain numeric op
        fn.code = code


class Instance:
    """An instantiated module: memory, globals, table, host imports.

    host_funcs: dict mapping (module, name) -> python callable.
    """

    def __init__(self, module: Module, host_funcs=None, memory_pages=2000):
        self.m = module
        self.host = host_funcs or {}
        pages = module.mem_limits[0] if module.mem_limits else memory_pages
        if module.mem_import:
            pages = max(pages, memory_pages)
        self.memory = bytearray(pages * PAGE)
        self.globals = [v for _, v in module.globals_init]
        self.table = list(module.tables[0]) if module.tables else []
        for off, idxs in module.elems:
            need = off + len(idxs)
            if len(self.table) < need:
                self.table.extend([None] * (need - len(self.table)))
            for k, fi in enumerate(idxs):
                self.table[off + k] = fi
        for off, blob in module.datas:
            self.memory[off : off + len(blob)] = blob
        self.n_imports = len(module.func_imports)
        if module.start_func is not None:
            self.call_index(module.start_func, [])

    # -- public API ---------------------------------------------------------

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
            return [] if nres == 0 else [res & M32]
        f = self.m.functions[fi - self.n_imports]
        ftype = self.m.types[f.type_idx]
        frame_locals = list(args) + [0] * f.locals_n
        result = self._exec(f, frame_locals)
        nres = len(ftype.results)
        return result[len(result) - nres :] if nres else []

    # -- interpreter core ---------------------------------------------------

    def _exec(self, f: Function, loc):
        code = f.code
        mem = self.memory
        stack = []
        # control frames: (is_loop, target_pc, stack_height, arity)
        frames = []
        pc = 0
        ncode = len(code)
        m = self.m

        def do_branch(depth, pc):
            if depth >= len(frames):
                # branch to the implicit function-level label: return from
                # the function (results are the top-of-stack values)
                frames.clear()
                return ncode
            for _ in range(depth):
                frames.pop()
            is_loop, target, height, arity = frames[-1]
            if is_loop:
                del stack[height:]
                return target
            vals = stack[len(stack) - arity :] if arity else []
            del stack[height:]
            stack.extend(vals)
            frames.pop()
            return target

        while pc < ncode:
            ins = code[pc]
            op = ins[0]
            pc += 1
            if op == 0x20:  # local.get
                stack.append(loc[ins[1]])
            elif op == 0x41 or op == 0x42:  # const
                stack.append(ins[1])
            elif op == 0x21:  # local.set
                loc[ins[1]] = stack.pop()
            elif op == 0x22:  # local.tee
                loc[ins[1]] = stack[-1]
            elif op == 0x28:  # i32.load
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 4], "little")
            elif op == 0x36:  # i32.store
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 4] = v.to_bytes(4, "little")
            elif op == 0x29:  # i64.load
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 8], "little")
            elif op == 0x37:  # i64.store
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 8] = v.to_bytes(8, "little")
            elif op == 0x6A:  # i32.add
                v = stack.pop()
                stack[-1] = (stack[-1] + v) & M32
            elif op == 0x7C:  # i64.add
                v = stack.pop()
                stack[-1] = (stack[-1] + v) & M64
            elif op == 0x02:  # block: branch target is after the end instr
                frames.append((False, ins[2] + 1, len(stack), ins[1]))
            elif op == 0x03:  # loop: branch target is the body start
                frames.append((True, pc, len(stack), 0))
            elif op == 0x04:  # if
                c = stack.pop()
                frames.append((False, ins[2] + 1, len(stack), ins[1]))
                if not c:
                    # jump to else body, or to the end instr (which pops)
                    pc = ins[3] if ins[3] != -1 else ins[2]
            elif op == 0x05:  # else marker: then-branch done, go to end instr
                pc = ins[2]
            elif op == 0x0B:  # end
                if ins[1] == -1:
                    return stack  # function-level end
                frames.pop()
            elif op == 0x0C:  # br
                pc = do_branch(ins[1], pc)
            elif op == 0x0D:  # br_if
                if stack.pop():
                    pc = do_branch(ins[1], pc)
            elif op == 0x0E:  # br_table
                k = stack.pop()
                targets, dflt = ins[1], ins[2]
                d = targets[k] if k < len(targets) else dflt
                pc = do_branch(d, pc)
            elif op == 0x0F:  # return
                return stack
            elif op == 0x10:  # call
                fi = ins[1]
                if fi < self.n_imports:
                    mod_, name, ti = m.func_imports[fi]
                    hf = self.host.get((mod_, name))
                    if hf is None:
                        raise WasmTrap(f"unresolved import {mod_}.{name}")
                    ftype = m.types[ti]
                    np_ = len(ftype.params)
                    args = stack[len(stack) - np_ :] if np_ else []
                    del stack[len(stack) - np_ :]
                    r = hf(*args)
                    if ftype.results:
                        stack.append(r & M32)
                else:
                    fn = m.functions[fi - self.n_imports]
                    ftype = m.types[fn.type_idx]
                    np_ = len(ftype.params)
                    args = stack[len(stack) - np_ :] if np_ else []
                    del stack[len(stack) - np_ :]
                    res = self._exec(fn, args + [0] * fn.locals_n)
                    nres = len(ftype.results)
                    if nres:
                        stack.extend(res[len(res) - nres :])
            elif op == 0x11:  # call_indirect
                k = stack.pop()
                if k >= len(self.table) or self.table[k] is None:
                    raise WasmTrap("undefined table element")
                fi = self.table[k]
                ftype = m.types[ins[1]]
                np_ = len(ftype.params)
                args = stack[len(stack) - np_ :] if np_ else []
                del stack[len(stack) - np_ :]
                res = self.call_index(fi, args)
                if ftype.results:
                    stack.extend(res[len(res) - len(ftype.results) :])
            elif op == 0x1A:  # drop
                stack.pop()
            elif op == 0x1B:  # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == 0x23:  # global.get
                stack.append(self.globals[ins[1]])
            elif op == 0x24:  # global.set
                self.globals[ins[1]] = stack.pop()
            elif op == 0x2C:  # i32.load8_s
                a = stack[-1] + ins[1]
                v = mem[a]
                stack[-1] = (v - 256 if v & 0x80 else v) & M32
            elif op == 0x2D:  # i32.load8_u
                stack[-1] = mem[stack[-1] + ins[1]]
            elif op == 0x2E:  # i32.load16_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 2], "little")
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M32
            elif op == 0x2F:  # i32.load16_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 2], "little")
            elif op == 0x30:  # i64.load8_s
                a = stack[-1] + ins[1]
                v = mem[a]
                stack[-1] = (v - 256 if v & 0x80 else v) & M64
            elif op == 0x31:  # i64.load8_u
                stack[-1] = mem[stack[-1] + ins[1]]
            elif op == 0x32:  # i64.load16_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 2], "little")
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M64
            elif op == 0x33:  # i64.load16_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 2], "little")
            elif op == 0x34:  # i64.load32_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 4], "little")
                stack[-1] = (v - (1 << 32) if v & 0x80000000 else v) & M64
            elif op == 0x35:  # i64.load32_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 4], "little")
            elif op == 0x38 or op == 0x39:
                raise WasmTrap("floats unsupported")
            elif op == 0x3A:  # i32.store8
                v = stack.pop()
                mem[stack.pop() + ins[1]] = v & 0xFF
            elif op == 0x3B:  # i32.store16
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
            elif op == 0x3C:  # i64.store8
                v = stack.pop()
                mem[stack.pop() + ins[1]] = v & 0xFF
            elif op == 0x3D:  # i64.store16
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
            elif op == 0x3E:  # i64.store32
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 4] = (v & M32).to_bytes(4, "little")
            elif op == 0x3F:  # memory.size
                stack.append(len(mem) // PAGE)
            elif op == 0x40:  # memory.grow
                delta = stack.pop()
                old = len(mem) // PAGE
                self.memory.extend(bytes(delta * PAGE))
                mem = self.memory
                stack.append(old)
            elif op == 0x45:  # i32.eqz
                stack[-1] = 1 if stack[-1] == 0 else 0
            elif op == 0x46:  # i32.eq
                v = stack.pop()
                stack[-1] = 1 if stack[-1] == v else 0
            elif op == 0x47:  # i32.ne
                v = stack.pop()
                stack[-1] = 1 if stack[-1] != v else 0
            elif op == 0x48:  # i32.lt_s
                v = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) < v else 0
            elif op == 0x49:  # i32.lt_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] < v else 0
            elif op == 0x4A:  # i32.gt_s
                v = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) > v else 0
            elif op == 0x4B:  # i32.gt_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] > v else 0
            elif op == 0x4C:  # i32.le_s
                v = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) <= v else 0
            elif op == 0x4D:  # i32.le_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] <= v else 0
            elif op == 0x4E:  # i32.ge_s
                v = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) >= v else 0
            elif op == 0x4F:  # i32.ge_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] >= v else 0
            elif op == 0x50:  # i64.eqz
                stack[-1] = 1 if stack[-1] == 0 else 0
            elif op == 0x51:  # i64.eq
                v = stack.pop()
                stack[-1] = 1 if stack[-1] == v else 0
            elif op == 0x52:  # i64.ne
                v = stack.pop()
                stack[-1] = 1 if stack[-1] != v else 0
            elif op == 0x53:  # i64.lt_s
                v = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) < v else 0
            elif op == 0x54:  # i64.lt_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] < v else 0
            elif op == 0x55:  # i64.gt_s
                v = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) > v else 0
            elif op == 0x56:  # i64.gt_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] > v else 0
            elif op == 0x57:  # i64.le_s
                v = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) <= v else 0
            elif op == 0x58:  # i64.le_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] <= v else 0
            elif op == 0x59:  # i64.ge_s
                v = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) >= v else 0
            elif op == 0x5A:  # i64.ge_u
                v = stack.pop()
                stack[-1] = 1 if stack[-1] >= v else 0
            elif op == 0x67:  # i32.clz
                v = stack[-1]
                stack[-1] = 32 - v.bit_length() if v else 32
            elif op == 0x68:  # i32.ctz
                v = stack[-1]
                stack[-1] = (v & -v).bit_length() - 1 if v else 32
            elif op == 0x69:  # i32.popcnt
                stack[-1] = bin(stack[-1]).count("1")
            elif op == 0x6B:  # i32.sub
                v = stack.pop()
                stack[-1] = (stack[-1] - v) & M32
            elif op == 0x6C:  # i32.mul
                v = stack.pop()
                stack[-1] = (stack[-1] * v) & M32
            elif op == 0x6D:  # i32.div_s
                v = _s32(stack.pop())
                a = _s32(stack[-1])
                if v == 0:
                    raise WasmTrap("division by zero")
                if a == -(1 << 31) and v == -1:
                    raise WasmTrap("integer overflow")
                stack[-1] = _idiv_trunc(a, v) & M32
            elif op == 0x6E:  # i32.div_u
                v = stack.pop()
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = stack[-1] // v
            elif op == 0x6F:  # i32.rem_s
                v = _s32(stack.pop())
                a = _s32(stack[-1])
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = (a - _idiv_trunc(a, v) * v) & M32
            elif op == 0x70:  # i32.rem_u
                v = stack.pop()
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = stack[-1] % v
            elif op == 0x71:  # i32.and
                v = stack.pop()
                stack[-1] &= v
            elif op == 0x72:  # i32.or
                v = stack.pop()
                stack[-1] |= v
            elif op == 0x73:  # i32.xor
                v = stack.pop()
                stack[-1] ^= v
            elif op == 0x74:  # i32.shl
                v = stack.pop() & 31
                stack[-1] = (stack[-1] << v) & M32
            elif op == 0x75:  # i32.shr_s
                v = stack.pop() & 31
                stack[-1] = (_s32(stack[-1]) >> v) & M32
            elif op == 0x76:  # i32.shr_u
                v = stack.pop() & 31
                stack[-1] >>= v
            elif op == 0x77:  # i32.rotl
                v = stack.pop() & 31
                a = stack[-1]
                stack[-1] = ((a << v) | (a >> (32 - v))) & M32 if v else a
            elif op == 0x78:  # i32.rotr
                v = stack.pop() & 31
                a = stack[-1]
                stack[-1] = ((a >> v) | (a << (32 - v))) & M32 if v else a
            elif op == 0x79:  # i64.clz
                v = stack[-1]
                stack[-1] = 64 - v.bit_length() if v else 64
            elif op == 0x7A:  # i64.ctz
                v = stack[-1]
                stack[-1] = (v & -v).bit_length() - 1 if v else 64
            elif op == 0x7B:  # i64.popcnt
                stack[-1] = bin(stack[-1]).count("1")
            elif op == 0x7D:  # i64.sub
                v = stack.pop()
                stack[-1] = (stack[-1] - v) & M64
            elif op == 0x7E:  # i64.mul
                v = stack.pop()
                stack[-1] = (stack[-1] * v) & M64
            elif op == 0x7F:  # i64.div_s
                v = _s64(stack.pop())
                a = _s64(stack[-1])
                if v == 0:
                    raise WasmTrap("division by zero")
                if a == -(1 << 63) and v == -1:
                    raise WasmTrap("integer overflow")
                stack[-1] = _idiv_trunc(a, v) & M64
            elif op == 0x80:  # i64.div_u
                v = stack.pop()
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = stack[-1] // v
            elif op == 0x81:  # i64.rem_s
                v = _s64(stack.pop())
                a = _s64(stack[-1])
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = (a - _idiv_trunc(a, v) * v) & M64
            elif op == 0x82:  # i64.rem_u
                v = stack.pop()
                if v == 0:
                    raise WasmTrap("division by zero")
                stack[-1] = stack[-1] % v
            elif op == 0x83:  # i64.and
                v = stack.pop()
                stack[-1] &= v
            elif op == 0x84:  # i64.or
                v = stack.pop()
                stack[-1] |= v
            elif op == 0x85:  # i64.xor
                v = stack.pop()
                stack[-1] ^= v
            elif op == 0x86:  # i64.shl
                v = stack.pop() & 63
                stack[-1] = (stack[-1] << v) & M64
            elif op == 0x87:  # i64.shr_s
                v = stack.pop() & 63
                stack[-1] = (_s64(stack[-1]) >> v) & M64
            elif op == 0x88:  # i64.shr_u
                v = stack.pop() & 63
                stack[-1] >>= v
            elif op == 0xA7:  # i32.wrap_i64
                stack[-1] &= M32
            elif op == 0xAC:  # i64.extend_i32_s
                stack[-1] = _s32(stack[-1]) & M64
            elif op == 0xAD:  # i64.extend_i32_u
                pass  # stored unsigned already
            elif op == 0x00:  # unreachable
                raise WasmTrap("unreachable")
            elif op == 0x01:  # nop
                pass
            else:
                raise WasmTrap(f"unsupported opcode {op:#x}")
        return stack



def _idiv_trunc(a: int, v: int) -> int:
    """Truncating (toward-zero) signed integer division — exact for the
    full i64 range (float-based int(a / v) loses precision above 2^53)."""
    q = abs(a) // abs(v)
    return -q if (a < 0) != (v < 0) else q

def _s32(v):
    return v - 0x100000000 if v & 0x80000000 else v


def _s64(v):
    return v - 0x10000000000000000 if v & 0x8000000000000000 else v
