#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distributed_groth16_tpu_torch) on
one NVIDIA card — the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device: the card's name, power limit and clocks;
  2. build: nvcc compiles the kernels of distributed_groth16_tpu_torch/
     csrc/ for sm_90a (one process per source, in parallel);
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card, at the shapes the main path gives it (and Horner also at
     W = 2 and W = 64 window sums, c = 4), compared limb for limb
     (tolerance zero: these are integers), and timed; Horner's chain bound
     from the measured latency of one Montgomery product;
  4. main path: the SHA-256 single-block circuit (m = 2^15) through
     setup -> CompiledR1CS -> prove_single (cold, warm, and r, s != 0) ->
     verify, with the kernels' launch counters zeroed just before and read
     just after; then one more warm proof with CUDA events around every
     kernel launch, for each kernel's device time per proof;
  5. byte identity: at m = 2^11 the card's proof equals the CPU's (plain
     versions) for the same key and witness;
  6. MPC path: phase 4's key saved and loaded as the proof service loads
     it, packed in the exponent for l = 2 (n = 8 parties, kernels 1 and 2
     through ladder_apply), the QAP and witness shares packed, one 8-party
     round over LocalSimNet (d_fft, the local tree MSMs with kernels 1 and
     3, the king's unpack), reassemble_proof -> verify; the proof equals
     phase 4's prove_single proof byte for byte; then a round at
     r, s != 0 that must verify. Counters zeroed before, read after.

Output: phase lines, then a {"kernels": [...]} line (launches on the main
path and, as launches_mpc, on the MPC path; ms_per_proof, the summed
device time in one warm proof from torch.profiler's kernel records;
ptxas' registers and spills), the
nvidia-smi name/power-limit line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

# 32-bit integer multiply(-add) results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table); the clock is the card's max SM clock from nvidia-smi
IMAD_PER_SM_CLOCK = 64
# H100 SXM HBM3 bandwidth (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# 32-bit multiply-adds of one 8-word CIOS Montgomery product: 128
# 32x32->64 products (a_j*b_i and m*p_j, two halves each) + 8 for m
IMAD_PER_FQ_MUL = 2 * 128 + 8
FQ_MULS = {"add": 14, "double": 9}  # per G1 point (RCB16); G2 triples

SOURCES = {
    "limb_group": "distributed_groth16_tpu_torch/csrc/limb_group.cu",
    "ntt_small": "distributed_groth16_tpu_torch/csrc/ntt_small.cu",
}
REPLACES = {
    "add": "distributed_groth16_tpu/ops/limb_kernels.py:568",
    "double": "distributed_groth16_tpu/ops/limb_kernels.py:599",
    "horner": "distributed_groth16_tpu/ops/limb_kernels.py:694",
    "ntt_small": "distributed_groth16_tpu/ops/ntt_limb.py:153",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Bound:
    """Least time for a kernel's work: max(bytes / HBM rate, 32-bit
    multiply-adds / integer peak)."""

    def __init__(self, sms: int, clock_mhz: float):
        self.imad_per_s = sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6

    def __call__(self, nbytes: float, fq_muls: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = fq_muls * IMAD_PER_FQ_MUL / self.imad_per_s
        if t_ops >= t_bytes:
            return t_ops * 1e3, "operations"
        return t_bytes * 1e3, "bytes"


def compare(name, kern, plain) -> int:
    if kern.shape != plain.shape:
        raise AssertionError(f"{name}: shape {kern.shape} != {plain.shape}")
    err = int((kern.long() - plain.long()).abs().max().item())
    if err:
        raise AssertionError(f"{name}: kernel differs from plain, {err}")
    return err


# mangled-name fragment of each kernel row's function in ptxas -v output
PTXAS_NAMES = {
    f"limb_{op}_g{deg}": f"{op}_kernelILi8ELi{deg}E"
    for op in ("add", "double", "horner") for deg in (1, 2)
}
PTXAS_NAMES["ntt_small"] = "ntt_small_kernel"


def ptxas_table(log: str) -> dict:
    """ptxas -v output -> {mangled function: {registers, stack_frame,
    spill_stores, spill_loads}}."""
    table, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            cur = table.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return table


def warps_per_sm(registers: int, threads: int = 128) -> int:
    """Resident warps per SM that the register file allows for blocks of
    `threads` (registers are granted per warp in units of 256; at most 64
    warps and 32 blocks per SM on compute capability 9.0)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    blocks = min(32, 65536 // (per_warp * warps))
    return min(64, blocks * warps)


def product_latency_us(dev, g, rng) -> float:
    """Latency of one inlined Montgomery product on the card, as a lane of
    Horner's warp sees it: each lane of one warp squares its own element
    in a dependent chain (dg16_mont_chain), 2n minus n products, so the
    launch cancels."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops.constants import Q

    lib = _cuda.library("limb_group")
    vals = [int.from_bytes(rng.bytes(40), "little") % (2 * Q)
            for _ in range(32)]
    words = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                          dtype="<i4")
    x = torch.tensor(words.copy(), dtype=torch.int32, device=dev)

    def chain(n):
        def go():
            rc = lib.dg16_mont_chain(8, x.data_ptr(), n,
                                     g.kernel_consts.ctypes.data,
                                     _cuda.stream_ptr(x))
            if rc:
                raise RuntimeError(f"dg16_mont_chain: CUDA error {rc}")
        return cuda_ms(go, 3)

    n = 20000
    return (chain(2 * n) - chain(n)) * 1e3 / n


def random_fr_limbs(rng, shape, bound: int):
    """int32 limb-major (16,) + shape of uniform values below `bound`."""
    import numpy as np

    n = int(np.prod(shape))
    raw = rng.integers(0, 2**63, size=(n, 5), dtype=np.int64)
    vals = [
        int.from_bytes(row.tobytes(), "little") % bound for row in raw
    ]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    limbs = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return limbs.reshape(n, 16).T.reshape((16,) + tuple(shape)).copy()


def ladder_shapes(r1cs, m: int, l: int = 2) -> dict:
    """(B, o, K) of ladder_apply's widest launch per group when
    pack_proving_key packs this circuit's key for n = 4l parties: B =
    ceil(k/l) chunks of the query, o = n outputs, K = 2l bases with GLV
    (G1) or l without (G2); it adds over B*o*K columns and doubles over
    B*K. G1's widest query is h_query (k = m); G2's only one is
    b_g2_query[1:] (k = num_wires - 1)."""
    n = 4 * l
    b1, b2 = -(-m // l), -(-(r1cs.num_wires - 1) // l)
    return {"g1": (b1, n, 2 * l), "g2": (b2, n, l)}


def point_columns(g, base, n, dev, seed):
    """(ROWS, n) points drawn from `base`, with the edge cases of the
    complete formulas mixed in: P + P, infinity on either side, both."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    P = base[:, torch.randint(base.shape[1], (n,), device=dev, generator=gen)]
    Q = base[:, torch.randint(base.shape[1], (n,), device=dev, generator=gen)]
    inf = torch.as_tensor(g.inf_col, device=dev)
    Q[:, :1024] = P[:, :1024]  # P + P
    P[:, 1024:2048] = inf
    Q[:, 2048:3072] = inf
    P[:, 3072:3100] = inf
    Q[:, 3072:3100] = inf
    return P.contiguous(), Q.contiguous()


def phase_kernels(dev, bound, rng, ladder, n=32 * 16384,
                  ntt=((256, 128), (128, 256))):
    """Phase 3: every kernel against its plain version on the card, by
    default at the main path's shapes: n columns is the first tree level of
    a 2^15-point MSM over 32 windows, and (S, L) the two halves of a 2^15
    transform. `ladder` maps each group to ladder_apply's (add, double)
    columns on the MPC path (ladder_shapes): kernels 1 and 2 are held and
    timed there too."""
    import torch

    from distributed_groth16_tpu_torch.ops.fixedbase import fixed_base_mul
    from distributed_groth16_tpu_torch.ops.limb_kernels import lg1, lg2
    from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.ops.ntt_limb import _small

    def measure(kind, RR, f, cols, kern, plain, err, reps=5):
        nbytes = (3 if kind == "add" else 2) * RR * cols * 4
        b_ms, b_by = bound(nbytes, FQ_MULS[kind] * f * cols)
        return dict(shape=[RR, cols], ms=cuda_ms(kern, reps),
                    plain_ms=cuda_ms(plain, 1), bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err)

    entries = {}
    for gname, g in (("g1", lg1()), ("g2", lg2())):
        RR, f = g.ROWS, 3 if g.deg == 2 else 1
        scal = encode_scalars_std(
            [int.from_bytes(rng.bytes(40), "little") % R for _ in range(4096)],
            dev,
        )
        base = g.from_rowmajor(fixed_base_mul(gname, scal))  # (RR, 4096)
        P, Q = point_columns(g, base, n, dev, 1)
        red = g.add(P, Q)  # redundant [0, 2p) operands for the next checks
        cases = {
            "add": (lambda: g.add(P, Q), lambda: g.plain_add(P, Q)),
            "add_redundant": (lambda: g.add(red, P),
                              lambda: g.plain_add(red, P)),
            "double": (lambda: g.double(red), lambda: g.plain_double(red)),
        }
        for cname, (kern, plain) in cases.items():
            err = compare(f"{cname}_{gname}", kern(), plain())
            kind = cname.split("_")[0]
            if cname == "add_redundant":
                continue
            entries[f"limb_{kind}_{gname}"] = dict(
                measure(kind, RR, f, n, kern, plain, err), kind=kind,
                source=SOURCES["limb_group"],
            )
        # ladder_apply's shapes on the MPC path: the accumulator add over
        # (ROWS, B*o*K) and the base doubling over (ROWS, B*K), on
        # redundant operands as the ladder feeds them
        B, o, K = ladder[gname]
        n_add, n_dbl = B * o * K, B * K
        LP, LQ = point_columns(g, base, n_add, dev, 2)
        lred = g.add(LP, LQ)
        dred = lred[:, :n_dbl].contiguous()
        for kind, kern, plain in (
            ("add", lambda: g.add(lred, LQ), lambda: g.plain_add(lred, LQ)),
            ("double", lambda: g.double(dred), lambda: g.plain_double(dred)),
        ):
            err = compare(f"ladder {kind}_{gname}", kern(), plain())
            entries[f"limb_{kind}_{gname}"]["ladder"] = measure(
                kind, RR, f, n_add if kind == "add" else n_dbl, kern, plain,
                err,
            )
        # without GLV signs (G2) the ladder's addend (ROWS, B, 1, K) is
        # broadcast to the accumulator, and the add wrapper copies it to
        # (ROWS, B*o*K) once per ladder step: the time of that copy
        if gname == "g2":
            addend = dred.reshape(RR, B, 1, K)
            entries["limb_add_g2"]["ladder"]["broadcast_copy_ms"] = cuda_ms(
                lambda: addend.expand(RR, B, o, K).reshape(RR, -1), 5
            )
        # Horner: the main path's W = 32, c = 8, then the two ends of what
        # the kernel stages (c = 4: W = 2, and W = 64 as msm_tree takes for
        # n < 4096) on window sums with infinity, equal columns, and a last
        # add that meets P + P (S_0 = 2^c S_1)
        hs = {(32, 8): red[:, :32].contiguous()}
        s2 = red[:, 5000:5002].clone()
        col = s2[:, 1:2]
        for _ in range(4):
            col = g.plain_double(col)
        s2[:, 0:1] = col
        hs[(2, 4)] = s2
        s64 = red[:, 1000:1064].clone()  # 1024.. are infinity + Q
        s64[:, 63] = torch.as_tensor(g.inf_col[:, 0], device=dev)
        s64[:, 7] = s64[:, 8]
        hs[(64, 4)] = s64
        cases = []
        for (W, c), s in hs.items():
            err = compare(f"horner_{gname} W={W} c={c}", g.horner(s, c),
                          g.plain_horner(s, c))
            cases.append(dict(W=W, c=c, ms=cuda_ms(lambda: g.horner(s, c), 3),
                              max_abs_err=err))
        W, c = 32, 8
        s = hs[(W, c)]
        p_ms = cuda_ms(lambda: g.plain_horner(s, c), 1)
        muls = (W - 1) * (c * FQ_MULS["double"] + FQ_MULS["add"]) * f
        b_ms, b_by = bound(RR * (W + 1) * 4, muls)
        # the warp-spread chain is 3 dependent products per doubling and
        # per add, each Fq2 product's Fp products side by side
        depth = (W - 1) * (3 * c + 3)
        entries[f"limb_horner_{gname}"] = dict(
            shape=[RR, W], ms=cases[0]["ms"], plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, max_abs_err=0, kind="horner", cases=cases,
            chain_depth=depth, source=SOURCES["limb_group"],
        )
        log(f"phase kernels {gname}: ok")
    lat = product_latency_us(dev, lg1(), rng)
    for gname in ("g1", "g2"):
        e = entries[f"limb_horner_{gname}"]
        e["product_latency_us"] = lat
        e["chain_bound_ms"] = e["chain_depth"] * lat * 1e-3

    ntt_runs = []
    for S, L in ntt:
        # values below 2p: the second stage of a transform sees redundant
        # inputs after the twiddle multiply
        x = torch.as_tensor(random_fr_limbs(rng, (S, L), 2 * R), device=dev)
        for inverse in (False, True):
            nt = _small(S, inverse)
            err = compare(f"ntt_small {S}x{L} inv={inverse}", nt(x),
                          nt.plain(x))
            k_ms = cuda_ms(lambda: nt(x), 10)
            p_ms = cuda_ms(lambda: nt.plain(x), 1)
            logS = S.bit_length() - 1
            nbytes = 2 * 16 * S * L * 4 + 16 * logS * (S // 2) * 4
            b_ms, b_by = bound(nbytes, (S // 2) * logS * L)
            ntt_runs.append(dict(
                shape=[16, S, L], inverse=inverse, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            ))
    fwd = [r for r in ntt_runs if not r["inverse"]]
    entries["ntt_small"] = dict(
        shape=[fwd[0]["shape"], fwd[1]["shape"]],
        # one 2^15 transform = the two forward launches above
        ms=fwd[0]["ms"] + fwd[1]["ms"],
        plain_ms=fwd[0]["plain_ms"] + fwd[1]["plain_ms"],
        bound_ms=fwd[0]["bound_ms"] + fwd[1]["bound_ms"],
        bound_by=fwd[0]["bound_by"], max_abs_err=0, kind="ntt_small",
        source=SOURCES["ntt_small"],
    )
    log("phase kernels ntt: " + json.dumps(ntt_runs))
    return entries


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def probes(dev, targets: dict):
    """While active, each callable named in `targets` (label -> (owner,
    attribute)) adds the wall ms of its calls, device drained before and
    after, to the yielded dict under its label. The targets must not call
    one another, so the totals are disjoint."""
    totals = {label: 0.0 for label in targets}
    saved = []
    for label, (owner, name) in targets.items():
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            sync(dev)
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                sync(dev)
                totals[_label] += (time.perf_counter() - t0) * 1e3

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield totals
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def kernel_row(kname: str):
    """The kernels-line row of a demangled device function name, or None."""
    k = kname.replace(" ", "")
    for op in ("add", "double", "horner"):
        for deg in (1, 2):
            if f"dg16::{op}_kernel<8,{deg}>" in k:
                return f"limb_{op}_g{deg}"
    return "ntt_small" if "dg16::ntt_small_kernel" in k else None


def width_bucket(columns: int) -> str:
    return (">=65536" if columns >= 65536
            else "4096-65535" if columns >= 4096 else "<4096")


@contextmanager
def kernel_trace():
    """torch.profiler (CUPTI) over the block. Yields a dict that is filled
    on exit with each kernel's summed device time (per_kernel, ms), kernel
    1's split by launch width (add_by_columns: {row: {columns: [launches,
    ms]}}), and busy_ms, the union of every device activity's interval."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_groth16_tpu_torch.ops import _cuda

    names = {id(k): name for name, k in _cuda.KERNELS.items()}
    order = []  # (row, columns) of each launch, in launch order
    call = _cuda.Kernel.__call__

    def recorded(self, *args):
        call(self, *args)
        name = names[id(self)]
        order.append((name, args[9] if name.startswith("limb_add") else None))

    res = {"per_kernel": {}, "add_by_columns": {}, "busy_ms": None}
    _cuda.Kernel.__call__ = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield res
    finally:
        _cuda.Kernel.__call__ = call
    spans = sorted(
        (e.time_range.start, e.time_range.end, kernel_row(e.name))
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, None
    for a, b, _ in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    res["busy_ms"] = busy * 1e-3
    ours = [(row, (b - a) * 1e-3) for a, b, row in spans if row]
    for row, ms in ours:
        res["per_kernel"][row] = res["per_kernel"].get(row, 0.0) + ms
    if [r for r, _ in ours] == [r for r, _ in order]:
        for (row, ms), (_, width) in zip(ours, order):
            if width is not None:
                cell = res["add_by_columns"].setdefault(row, {}).setdefault(
                    width_bucket(width), [0, 0.0])
                cell[0] += 1
                cell[1] += ms


def sha256_abc():
    from distributed_groth16_tpu_torch.frontend.sha256 import sha256_circuit

    cs, pubs = sha256_circuit(b"abc")
    r1cs, z = cs.finish()
    return r1cs, z, pubs


def phase_main_path(dev, circuit, log_m=15):
    """Phase 4: a circuit (r1cs, z, pubs), by default SHA-256 at m = 2^15,
    through the port's entry points on `dev`. Returns the launch counts and
    what phase 6 reuses: the circuit, key, compiled R1CS, witness and the
    r = s = 0 proof."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.models.groth16 import (
        CompiledR1CS, prove_single, setup, verify,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.ops.field import fr

    r1cs, z, pubs = circuit
    log(f"main path: constraints={r1cs.num_constraints} "
        f"instances={r1cs.num_instance} wires={r1cs.num_wires}")
    for k in _cuda.KERNELS.values():
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pk = setup(r1cs, seed=42, device=dev)
    sync(dev)
    t_setup = (time.perf_counter() - t0) * 1e3
    assert pk.domain_size == 1 << log_m, pk.domain_size
    t0 = time.perf_counter()
    comp = CompiledR1CS(r1cs, dev)
    z_mont = fr().encode(z, dev)
    sync(dev)
    t_compile = (time.perf_counter() - t0) * 1e3
    cold = {}
    proof0 = prove_single(pk, comp, z_mont, timings=cold)
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    warm = {}
    t0 = time.perf_counter()
    proof1 = prove_single(pk, comp, z_mont, timings=warm)
    t_warm = (time.perf_counter() - t0) * 1e3
    per_proof = {k: v.launches - before[k] for k, v in _cuda.KERNELS.items()}
    rng = np.random.default_rng(2024)
    r = int.from_bytes(rng.bytes(40), "little") % R
    s = int.from_bytes(rng.bytes(40), "little") % R
    proof2 = prove_single(pk, comp, z_mont, r=r, s=s)
    sync(dev)
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # each kernel's device time in one more warm proof, from the profiler's
    # kernel records; the launch counts above are already read
    per_proof_ms = {k: 0.0 for k in _cuda.KERNELS}
    if dev.type == "cuda":
        with kernel_trace() as tr:
            t0 = time.perf_counter()
            proof3 = prove_single(pk, comp, z_mont)
            sync(dev)
            t_probed = (time.perf_counter() - t0) * 1e3
        if not tr["per_kernel"]:
            raise AssertionError("torch.profiler recorded no kernel")
        per_proof_ms.update(tr["per_kernel"])
        if proof3 != proof1:
            raise AssertionError("probed warm proof differs")
        log("main path kernel device ms per warm proof: " + json.dumps(dict(
            method="torch.profiler", per_kernel=per_proof_ms,
            total=sum(per_proof_ms.values()),
            add_by_columns=tr["add_by_columns"],
            device_busy_ms=tr["busy_ms"], probed_proof_wall=t_probed,
        )))
    if proof0 != proof1:
        raise AssertionError("cold and warm proofs differ")
    if not verify(pk.vk, proof1, pubs):
        raise AssertionError("r = s = 0 proof does not verify")
    if not verify(pk.vk, proof2, pubs):
        raise AssertionError("r, s != 0 proof does not verify")
    for k in ("limb_add_g1", "limb_add_g2", "limb_horner_g1",
              "limb_horner_g2", "ntt_small"):
        if per_proof[k] == 0 and dev.type == "cuda":
            raise AssertionError(f"prove_single never launched {k}")
    log("main path phases ms: " + json.dumps(dict(
        setup=t_setup, compile_r1cs=t_compile, cold=cold,
        warm=warm, warm_total=t_warm,
    )))
    log(f"main path launches per warm proof: {json.dumps(per_proof)}")
    log(f"main path launches (setup + 3 proofs): {json.dumps(launches)}")
    log(f"main path peak device memory: {peak} bytes")
    log("main path: both proofs verify")
    return launches, per_proof_ms, dict(r1cs=r1cs, pubs=pubs, pk=pk,
                                        comp=comp, z_mont=z_mont,
                                        proof=proof1)


def phase_mpc(dev, ctx, l=2):
    """Phase 6: the MPC prover as the proof service runs it for an
    "mpc_prove" job: the key loaded from its .npz (no dealer scalars, so
    packed in the exponent), QAP and witness shares, one n = 4l party round
    over LocalSimNet, reassembly and verification. The r = s = 0 proof must
    equal phase 4's prove_single proof byte for byte; a second round at
    r, s != 0 must verify. Returns the launch counts of the r = s = 0
    pack and round."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.models.groth16 import (
        ProvingKey, distributed_prove_party, pack_from_witness,
        pack_proving_key, public_prove_consts, reassemble_proof, verify,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.parallel.net import (
        simulate_network_round,
    )
    from distributed_groth16_tpu_torch.parallel.pss import pss

    r1cs, pubs, comp, z_mont = (ctx[k] for k in ("r1cs", "pubs", "comp",
                                                   "z_mont"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pk.npz")
        ctx["pk"].save(path)
        pk = ProvingKey.load(path, device=dev)
    assert pk.query_scalars is None
    pp = pss(l)
    ni = r1cs.num_instance
    log(f"mpc path: m={pk.domain_size} l={pp.l} n={pp.n} t={pp.t}")

    for k in _cuda.KERNELS.values():
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    split, pack = {}, {}
    t0 = time.perf_counter()
    crs = pack_proving_key(pk, pp, timings=pack)
    split["pack"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    qap_shares = comp.qap(z_mont).pss(pp)
    a_sh = pack_from_witness(pp, z_mont[1:])
    ax_sh = pack_from_witness(pp, z_mont[ni:])
    sync(dev)
    split["qap_pss"] = (time.perf_counter() - t0) * 1e3
    data = [(crs[i], qap_shares[i], a_sh[i], ax_sh[i]) for i in range(pp.n)]

    def round_(**kw):
        king = {}

        async def party(net, d):
            return await distributed_prove_party(
                pp, *d, net, timings=king if net.is_king else None, **kw
            )

        t0 = time.perf_counter()
        res = simulate_network_round(pp.n, party, data)
        sync(dev)
        king["round"] = (time.perf_counter() - t0) * 1e3
        return res, king

    res, king = round_()
    split.update(h=king["h"], ab=king["ab"], c=king["c"],
                 round=king["round"])
    t0 = time.perf_counter()
    proof = reassemble_proof(res[0], pk)
    split["reassemble"] = (time.perf_counter() - t0) * 1e3
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not verify(pk.vk, proof, pubs):
        raise AssertionError("MPC proof at r = s = 0 does not verify")
    if proof_bytes(proof) != proof_bytes(ctx["proof"]):
        raise AssertionError("MPC proof differs from prove_single's")
    if dev.type == "cuda":
        for k in ("limb_add_g1", "limb_add_g2", "limb_double_g1",
                  "limb_double_g2", "limb_horner_g1", "limb_horner_g2"):
            if launches[k] == 0:
                raise AssertionError(f"the MPC path never launched {k}")
    log("mpc path pack ms per query: " + json.dumps(pack))
    log("mpc path phases ms: " + json.dumps(split))
    log(f"mpc path launches per proof (pack + round): {json.dumps(launches)}")
    log(f"mpc path peak device memory (pack + round): {peak} bytes")
    log(f"mpc path: proof verifies and equals prove_single's "
        f"({len(proof_bytes(proof))} bytes)")

    rng = np.random.default_rng(2025)
    r = int.from_bytes(rng.bytes(40), "little") % R
    s = int.from_bytes(rng.bytes(40), "little") % R
    res, king = round_(pub=public_prove_consts(pk), r=r, s=s)
    zk = reassemble_proof(res[0], pk)
    if not verify(pk.vk, zk, pubs):
        raise AssertionError("MPC proof at r, s != 0 does not verify")
    if proof_bytes(zk) == proof_bytes(proof):
        raise AssertionError("r, s != 0 gave the r = s = 0 proof")
    log(f"mpc path r, s != 0: verifies, round {king['round']:.1f} ms")

    # where the time goes, from a warm pack and a third r = s = 0 round
    # with the device drained around each probed call (so these totals
    # run a little slower than the unprobed ones above)
    from distributed_groth16_tpu_torch.ops import limb_kernels
    from distributed_groth16_tpu_torch.parallel import dfft, dmsm
    from distributed_groth16_tpu_torch.parallel.pss import (
        PackedSharingParams,
    )

    with probes(dev, {"ladder_apply": (limb_kernels, "ladder_apply")}) as t:
        t0 = time.perf_counter()
        pack_proving_key(pk, pp)
        sync(dev)
        t["pack"] = (time.perf_counter() - t0) * 1e3
    log("mpc path warm pack, ms in ladder_apply: " + json.dumps(t))
    P = PackedSharingParams
    with probes(dev, {
        "local_fft": (dfft, "_fft1_local"),
        "king_fft": (dfft, "_fft2_king"),
        "pss_unpack": (P, "unpack"),
        "pss_pack": (P, "pack_from_public"),
        "local_msm": (dmsm, "msm"),
        "king_unpackexp": (P, "unpackexp"),
    }) as t:
        res, king = round_()
        t["round"] = king["round"]
    if proof_bytes(reassemble_proof(res[0], pk)) != proof_bytes(proof):
        raise AssertionError("probed MPC round gave another proof")
    log("mpc path round, ms by work: " + json.dumps(t))
    return launches


def phase_byte_identity(dev, length=2046, log_m=11):
    """Phase 5: at m = 2^11 the card's proof equals the CPU's (the CPU
    runs every kernel's plain version) for one key and witness."""
    from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
    from distributed_groth16_tpu_torch.models.groth16 import (
        CompiledR1CS, prove_single, setup, verify,
    )
    from distributed_groth16_tpu_torch.ops.field import fr

    r1cs, z = mult_chain_circuit(3, length).finish()
    pk = setup(r1cs, seed=11, device=dev)
    assert pk.domain_size == 1 << log_m, pk.domain_size
    proof_gpu = prove_single(pk, CompiledR1CS(r1cs, dev), fr().encode(z, dev))
    t0 = time.perf_counter()
    proof_cpu = prove_single(
        pk.to("cpu"), CompiledR1CS(r1cs, "cpu"), fr().encode(z, "cpu")
    )
    t_cpu = time.perf_counter() - t0
    if proof_bytes(proof_gpu) != proof_bytes(proof_cpu):
        raise AssertionError("card and CPU proofs differ at m = 2^11")
    if not verify(pk.vk, proof_gpu, z[1 : r1cs.num_instance]):
        raise AssertionError("m = 2^11 proof does not verify")
    log(f"byte identity m=2^11: card == cpu ({len(proof_bytes(proof_gpu))} "
        f"bytes), cpu prove {t_cpu:.1f} s")


def proof_bytes(proof) -> bytes:
    """Affine coordinates as 32-byte little-endian words, a | b | c."""
    words = [*proof.a, *proof.b[0], *proof.b[1], *proof.c]
    return b"".join(int(w).to_bytes(32, "little") for w in words)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from distributed_groth16_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: port package not found: {exc}", file=sys.stderr)
        return 1
    import numpy as np

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"device: {name} | {smi} | {sms} SMs | max SM clock {clock} MHz | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    bound = Bound(sms, clock)

    t0 = time.perf_counter()
    _cuda.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for text in _cuda.build_log.values():
        ptxas.update(ptxas_table(text))
    for fn, info in sorted(ptxas.items()):
        log(f"  ptxas {fn}: {json.dumps(info)}")
    for k in _cuda.KERNELS.values():
        _cuda.library(k.source)

    rng = np.random.default_rng(42)
    circuit = sha256_abc()
    ladder = ladder_shapes(circuit[0], 1 << 15)
    entries = phase_kernels(dev, bound, rng, ladder)
    launches, per_proof_ms, ctx = phase_main_path(dev, circuit)
    phase_byte_identity(dev)
    launches_mpc = phase_mpc(dev, ctx)

    # every kernel launches on at least one path: kernel 2 (double) only on
    # the MPC path's ladder, kernel 4 (ntt_small) only on the main path.
    # Every row's own numbers are at the main path's shape (as in slice 1);
    # kernels 1 and 2 carry theirs at ladder_apply's widest shape in
    # at_ladder
    rows = []
    for key, e in entries.items():
        err = max(e["max_abs_err"], e.get("ladder", e)["max_abs_err"])
        row = dict(
            name=key, route="cuda", source=e["source"],
            replaces=REPLACES[e["kind"]], shape=e["shape"],
            launches=launches[key], launches_mpc=launches_mpc[key],
            max_abs_err=err, match=err == 0, ms=e["ms"], kernel_ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=None,
            ms_per_proof=per_proof_ms[key],
        )
        for extra in ("cases", "chain_depth", "product_latency_us",
                      "chain_bound_ms"):
            if extra in e:
                row[extra] = e[extra]
        if "ladder" in e:
            row["at_ladder"] = e["ladder"]
        info = [v for f, v in ptxas.items() if PTXAS_NAMES[key] in f]
        if info:  # empty when the libraries were built by an earlier run
            row["ptxas"] = dict(info[0])
            if "registers" in info[0] and key.startswith(("limb_add",
                                                          "limb_double")):
                row["ptxas"]["warps_per_sm"] = warps_per_sm(
                    info[0]["registers"])
        if row["launches"] + row["launches_mpc"] == 0:
            raise AssertionError(f"no path launched {key}")
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
