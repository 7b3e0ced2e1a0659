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
     W = 2 and W = 64 window sums, c = 4), kernels 1 and 2 also at the MPC
     ladder's widths (kernel 2 at the pack's and the king's unpack's, and
     at ragged widths and on a strided view) and at phase 8's lane-ladder
     widths (its pack's widest and its king unpack's), kernel 4 also over S = 2 ...
     256 and ragged column counts, compared limb for limb (tolerance zero:
     these are integers), and timed: device time per launch from
     torch.profiler's kernel records, and the wall time of a wrapper call;
     chain bounds (Horner, kernels 2 and 4) from the measured latency of
     one Montgomery product;
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
     Between them four r = s = 0 rounds with the aggregation plane on,
     idle, idle, on: the same proof; with the plane on, 8 merged tracks,
     each prove.party holding prove.h and the dfft / dmsm / net.* spans,
     and a critical path; each round's ms. Then a pack and a round under
     torch.profiler, for
     each kernel's device time per MPC proof (kernels 1 and 2 split by
     launch width);
  7. BLS12 paths (the 12-word kernels, checked in phase 3 too), each run
     once under torch.profiler with the counters zeroed before and read
     after: (a) examples/dmsm_bench.py --curve bls12-377 at its top size,
     a BLS12-377 G1 d_msm over 2^19 distinct points of known discrete
     logs, l = 2, n = 8: scalar pack, in-exponent base pack (kernels 1,
     2), eight local tree MSMs (kernels 1, 3) and the king's unpack
     (kernels 1, 2), equal to the host sum and to the port's local msm;
     (b) BASELINE config 5: BLS12-381 local msm at 2^24 distinct points
     (two tree chunks of 2^23, their sums added on kernel 1), G1 and G2,
     each equal to the host ground truth; (c) a BLS12-381 G2 d_msm at 2^16 distinct points,
     l = 2; (d) the scalar route of the CRS pack of phase 4's key (which
     keeps its dealer scalars; fixed-base multiplies on kernel 1), its
     shares equal to phase 6's point route as affine points, and one
     8-party round over them whose proof equals phase 4's prove_single
     proof byte for byte;
  8. MPC path at n = 64 parties (l = 16, t = 15), where "auto" takes the
     in-exponent point NTT: phase 4's key loaded from .npz and packed by
     parallel/pointntt.py (lane ladders and butterflies on kernels 1 and
     2), QAP and witness shares, one 64-party round over LocalSimNet whose
     every king unpack runs unpackexp_ntt; the proof equals phase 4's
     prove_single proof byte for byte (r, s != 0 only at n = 8). The
     pack and the round run under a device-only trace, counters zeroed
     before and read after; each must launch kernels 1 and 2 on G1 and
     G2. Then one G1 query's pack and one king unpack by the dense ladder
     and by the point NTT (equal as affine points, both timed warm), and
     d_pp at m = 2^15, l = 16 over num = den = 1..m (all ones) and at
     m = 2^10, l = 2 on random num, den (the host prefix products);
  9. the reference's deployment, one OS process per party: stars of
     n = 8 ranks on the card over mTLS sockets on localhost
     (examples/launch.py spawns fresh interpreters, each with its own
     CUDA context): add_ids; nonlocal_kernel dfft, dmsm and dpp at the
     example's default sizes, each checked by rank 0 against refmath; and
     nonlocal_sha256 on phase 4's circuit with a fresh key cache (rank 0
     runs setup and packs by the scalar route, ranks 1-7 load the key and
     pack in the exponent): the proof verifies and equals phase 4's
     prove_single proof byte for byte, every rank launched kernels 1 and 3
     on G1 and G2 and the king kernel 2 on both. Its ranks run the
     aggregation plane: the king merges 8 tracks (clients rebased by
     their clock offsets, each with a clock sample), at least 7
     TELEMETRY frames, non-zero wire bytes per peer. Logs each rank's
     phase ms and peak memory, the star's wall time, nvidia-smi's
     memory.used, the king's critical path and the socket round beside
     phase 6's in-process one;
 10. a circom/snarkjs user's path on phase 4's circuit and key: .r1cs,
     .wtns and .zkey written to a temporary directory and read back (the
     key onto the card by ProvingKey.from_zkey), each equal to the
     original; warm prove_single with the .zkey key (the .r1cs's C, the
     .wtns's witness) equal to phase 4's proof at r = s = 0, launching
     kernels 1, 3 and 4 as often as phase 4's warm proof, and to phase
     4's key's proof at one r, s != 0; the proof through snarkjs JSON,
     arkworks bytes and Ethereum tuples and calldata and back; then 32
     SHA-256 statements of the same circuit proved with the .zkey key at
     distinct r, s and checked by one RLC fold (verify_batch, its
     prepare_inputs MSM on the card), then with one proof made false:
     the fold false, verify_each naming it among the first 8, bundles
     built and checked, and VerifyBatchRunner over four stand-in jobs of
     2 of those 8 proofs, of which only the one holding the false proof
     fails (8, not all 32: each bisection step pays a launch-bound
     plain ladder, and the script must stay well inside its time limit).
     Logs the artifacts'
     bytes and ms, the phase split beside phase 4's key's, and the fold's
     ms split (device prepare_inputs, host fold, pairings) beside single
     verifies;
 11. the batch and mesh provers, the n = 8 parties (l = 2) on one tensor
     axis of the card for (a)-(c) and split over device shards for
     (d)-(h), and the job service below its HTTP layer, on phase 4's
     circuit: (a) 8 distinct SHA-256 statements (phase 10's) proved
     in ONE batch by prove_batch through build_batch_mesh_prover over the
     CRS phase 6 packed from the loaded key (one batched stage-1 d_fft,
     the king's tails once, n * (3B + B) = 256 local tree MSMs in batched
     launches of kernels 1 and 3, the king's unpacks on kernels 1 and 2),
     each proof verifying and equal to prove_single's, counters zeroed
     before and read after; then a batch of 3 (padded to 4); the batch
     again under the profiler and with its parts probed; (b)
     mesh_prove_zk at r, s != 0 equal to prove_single(r, s); (c) a
     CircuitStore in a temporary directory, ProofExecutor + JobQueue +
     WorkerPool + BatchScheduler(batch_max=4, 500 ms linger) on the card:
     8 "prove" jobs carrying .wtns bytes DONE in at most 2 batched
     executions with no BatchFault, each proof equal to prove_single's;
     then, batching off, one "prove" job (kernels 1, 3 and 4) and one
     "mpc_prove" job through the per-job funnel, both equal to
     prove_single's; (d) mesh_prove_zk at r, s != 0 over 1, 2 and 8
     shards on the card, each equal to prove_single(r, s) (wall ms,
     device-busy ms, launches, bytes gathered and scattered per k); (e)
     prove_batch of 2 jobs over 4 shards, equal to prove_single's; (f)
     _mesh_dfft and _mesh_dmsm_batched at m = 16 over the shards (card,
     cpu), equal limb for limb to the one-shard mesh on the card; (g)
     examples/multichip.run(8), its JAX line and one shard a party on
     the card; (h) with two or more
     cards, (d) at k = 2 over two cards, else "cards: 1". Logs the batch
     wall and per-proof time beside phase 6's round, the split, device
     busy ms, peak memory, the jobs' phases and the scheduler's stats;
 12. the serving plane over HTTP on localhost (api/server.py, api/cli.py,
     fleet/, telemetry/profiler.py), on phase 4's circuit and witness:
     replica 1, an ApiServer on the card with batching off, runs
     /save_circuit (setup on the card), /create_proof_without_mpc and
     /create_proof_with_naive_mpc (both equal to phase 4's proof; the
     naive-MPC job's trace one pid track per party, its criticalPath over
     the 8 parties),
     /verify_proof (true; false with a public input plus one), /healthz,
     /readyz (buildInfo names the card) and /metrics (dg16_build_info,
     device_memory_bytes); replica 2 on the same card and store, batching
     on (batch_max 4), proves 4 /jobs/prove jobs; a POST /profile capture
     on replica 1 while a prove job runs, whose .tar.gz Chrome trace holds
     kernels 1, 3 and 4 and the job's load/witness/prove spans; a
     FleetRouter over both replicas routes 4 jobs to both, then drains
     replica 2, and one job goes straight to replica 1 beside one through
     the router (the router's overhead); the CLI in a subprocess proves
     against replica 1 and prints the router's fleet table. Every proof
     equals phase 4's. Counters zeroed before the phase, read after.
     Logs each route's wall ms, the save's setup ms, the batch's submit
     to last DONE, the capture's artifact bytes and the phase's seconds;
 13. the perf observatory (telemetry/perf.py, perf_kernels.py,
     roofline.py, benchgate.py, the CLI's `perf` group): every registered
     case at its quick size on the card, counters zeroed before and read
     after; no record errors, every kernel launches (over the phase and
     in the records' own launch counts), every device record has a work
     model and stays at or under 105% of its roofline roof; the CLI's
     `perf top`, `perf diff` and `perf roofline` read the run document,
     benchgate passes it against its own baseline and fails a copy with
     every median x3. Logs each record and the phase's seconds;
 14. the reference's workloads (BASELINE configs 2-4) through the run(...)
     of the port's examples (distributed_groth16_tpu_torch/examples/), the
     parties of each simulated in one process: (a) config 2, dmsm_bench's
     BN254 G1 d_msm at 2^20 points with l = 1 (n = 4), equal with the
     local msm to (sum s_i)*G from the host; (b) config 3, dfft_test's
     d_fft at 2^22, l = 2, equal to the card's limb NTT and to refmath at
     two points; (c) config 4, million's chain proved by the 8-party round
     at 2^WORKLOAD_MILLION_LOG2 constraints (cut from 2^20 for the time
     limit; 2^20 runs as its own call), verifying and equal to
     prove_single's, with --agg-out: 8 merged tracks and the round's
     critical path beside the part's wall and busy time; (d)
     local_groth_bench at 2^15 and profile_msm at 2^20. Each part under a device-only trace: its wall ms, device-busy
     ms, peak bytes, host bigint seconds, launches and device ms per
     kernel. Counters zeroed before the phase, read after.

Output: phase lines, then a {"kernels": [...]} line (launches on the row's
own path: phase 4 for the 8-word kernels, phase 7 for the 12-word ones;
launches_mpc, launches_bls and launches_mpc64 on the MPC, BLS and n = 64
MPC paths; launches_star, summed over the ranks of phase 9's SHA-256
star; launches_zkey over phase 10; launches_batch over phase 11's batch
of 8 (kernels 1-3), launches_shards over its sharded runs (d) at k > 1,
(e), (f), (g) and (h), launches_service_prove over its per-job prove job
(kernels 1, 3 and 4), launches_http over phase 12 (kernels 1-4),
launches_perf over phase 13 (every kernel), launches_workloads over
phase 14 (the 8-word kernels); ms,
the device time of one launch at the row's shape;
ms_per_proof, ms_per_mpc_proof, ms_per_bls_path, ms_per_mpc64_proof and
ms_per_batch, the summed device time in one warm proof, one MPC proof
(pack + round), each BLS path, one n = 64 MPC proof and phase 11's batch
of 8, from torch.profiler's kernel records; kernels 1 and 2 also at the lane ladder's widths, at_lane and
at_lane_unpack;
ptxas' registers and spills), the nvidia-smi name/power-limit line, and
last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from contextlib import contextmanager, nullcontext, redirect_stdout

from distributed_groth16_tpu_torch.telemetry.roofline import (
    FQ_MULS, HBM_BYTES_PER_S, imad_peak, bound as roofline_bound,
)
from distributed_groth16_tpu_torch.utils.benchtools import (
    cuda_ms, device_ms, device_spans,
)

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


def smi_sample() -> dict:
    """The card's SM and memory clocks (MHz), power draw (W) and
    temperature (C) as nvidia-smi reads them now."""
    keys = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")
    vals = nvidia_smi(",".join(keys)).split(",")
    return {k: float(v.split()[0]) for k, v in zip(keys, vals)}


def card_bound(sms: int, clock_mhz: float):
    """roofline.bound at this card's peaks: its SM count and maximum SM
    clock (nvidia-smi) for the multiply-add rate, the H100's HBM rate:
    (nbytes, fq_muls, nw=8) -> (least ms, "bytes" | "operations")."""
    return functools.partial(roofline_bound, peak={
        "flops": imad_peak(sms, clock_mhz), "bw": HBM_BYTES_PER_S})


def event_ms(fn):
    """(fn(), the ms of that one call from CUDA events around it)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(name, kern, plain) -> int:
    if kern.shape != plain.shape:
        raise AssertionError(f"{name}: shape {kern.shape} != {plain.shape}")
    err = int((kern.long() - plain.long()).abs().max().item())
    if err:
        raise AssertionError(f"{name}: kernel differs from plain, {err}")
    return err


def ptxas_name(key: str) -> str:
    """Mangled-name fragment of a kernel row's function in ptxas -v output:
    limb_add_g2_w12 -> add_kernelILi12ELi2E."""
    if key == "ntt_small":
        return "ntt_small_kernel"
    m = re.fullmatch(r"limb_(add|double|horner)_g(\d)(?:_w(\d+))?", key)
    return f"{m.group(1)}_kernelILi{m.group(3) or 8}ELi{m.group(2)}E"


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
    """Latency of one inlined Montgomery product over g's base field (8 or
    12 words) on the card, as a lane of Horner's warp sees it: each lane
    of one warp squares its own element in a dependent chain
    (dg16_mont_chain), 2n minus n products, so the launch cancels."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.ops import _cuda

    lib = _cuda.library("limb_group")
    p = g.F.p if hasattr(g.F, "p") else g.F.fq.p
    vals = [int.from_bytes(rng.bytes(56), "little") % (2 * p)
            for _ in range(32)]
    words = np.frombuffer(
        b"".join(v.to_bytes(4 * g.nw, "little") for v in vals), dtype="<i4")
    x = torch.tensor(words.copy(), dtype=torch.int32, device=dev)

    def chain(n):
        def go():
            rc = lib.dg16_mont_chain(g.nw, x.data_ptr(), n,
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


def lane_shapes(r1cs, m: int, l: int = 16) -> dict:
    """Columns (add and double alike) of lane_ladder's widest launch per
    group in phase 8's point-NTT pack for n = 4l parties, and in its
    king's unpack: B rows of P*n lanes, P = 2 with GLV (G1), 1 without;
    B = ceil(k/l) chunks of the widest query (h_query, k = m, on G1;
    b_g2_query[1:] on G2), n lanes in the share FFT; one row of n shares
    in an unpack."""
    n = 4 * l
    b1, b2 = -(-m // l), -(-(r1cs.num_wires - 1) // l)
    return {"g1": (b1 * 2 * n, 2 * n), "g2": (b2 * n, n)}


# kernel 2's columns in the king's unpackexp of every MPC round (d_msm:
# B*K = 1 x n shares, doubled by GLV on G1, at n = 8 parties)
UNPACK_COLUMNS = {"g1": 16, "g2": 8}
# kernel 2 is also held at these widths (partial warps and blocks)
DOUBLE_RAGGED = (1, 2, 3, 4, 5, 9, 31, 33, 4097)
# kernel 4 is also held at these sizes and column counts, both directions
NTT_SIZES, NTT_RAGGED_L = (2, 4, 32, 64, 128, 256), (1, 3, 33, 129)


def phase_kernels(dev, bound, rng, ladder, lane, n=32 * 16384,
                  ntt=((256, 128), (128, 256))):
    """Phase 3: every kernel against its plain version on the card, by
    default at the main path's shapes: n columns is the first tree level of
    a 2^15-point MSM over 32 windows, and (S, L) the two halves of a 2^15
    transform. `ladder` maps each group to ladder_apply's (add, double)
    columns on the MPC path (ladder_shapes): kernels 1 and 2 are held and
    timed there too, and kernel 2 at the unpack's UNPACK_COLUMNS; `lane`
    to lane_ladder's columns in phase 8's pack and unpack (lane_shapes),
    where kernels 1 and 2 are held and timed too."""
    import torch

    from distributed_groth16_tpu_torch.ops.fixedbase import fixed_base_mul
    from distributed_groth16_tpu_torch.ops.limb_kernels import lg1, lg2
    from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.ops.ntt_limb import _small

    def measure(kind, RR, f, cols, kern, plain, err, reps=5):
        nbytes = (3 if kind == "add" else 2) * RR * cols * 4
        b_ms, b_by = bound(nbytes, FQ_MULS[kind] * f * cols)
        return dict(shape=[RR, cols], ms=device_ms(kern, reps, kernel_row),
                    call_ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, 1),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

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
        # lane_ladder's widths in phase 8's point-NTT pack and unpack: the
        # add and the doubling at the same columns
        for where, cols in zip(("lane", "lane_unpack"), lane[gname]):
            x, y = lred[:, :cols].contiguous(), LQ[:, :cols].contiguous()
            for kind, kern, plain in (
                ("add", lambda: g.add(x, y), lambda: g.plain_add(x, y)),
                ("double", lambda: g.double(x), lambda: g.plain_double(x)),
            ):
                err = compare(f"{where} {kind}_{gname}", kern(), plain())
                entries[f"limb_{kind}_{gname}"][where] = measure(
                    kind, RR, f, cols, kern, plain, err)
        # kernel 2 at the unpack's width, at ragged widths (a point per
        # lane of a block's three warps: partial warps and blocks) and on a
        # column-strided view, with infinity among redundant coordinates
        inf = torch.as_tensor(g.inf_col, device=dev)
        for m in DOUBLE_RAGGED:
            x = lred[:, :m].clone()
            x[:, 1::3] = inf
            compare(f"double_{gname} n={m}", g.double(x), g.plain_double(x))
        xs = lred[:, : 2 * 4097 : 2]
        compare(f"double_{gname} column stride 2", g.double(xs),
                g.plain_double(xs))
        m = UNPACK_COLUMNS[gname]
        x = lred[:, 3099 : 3099 + m].contiguous()  # an infinity, then points
        err = compare(f"unpack double_{gname}", g.double(x), g.plain_double(x))
        entries[f"limb_double_{gname}"]["unpack"] = measure(
            "double", RR, f, m, lambda: g.double(x),
            lambda: g.plain_double(x), err, reps=20)
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
        s64[:, 63] = inf[:, 0]
        s64[:, 7] = s64[:, 8]
        hs[(64, 4)] = s64
        cases = []
        for (W, c), s in hs.items():
            err = compare(f"horner_{gname} W={W} c={c}", g.horner(s, c),
                          g.plain_horner(s, c))
            cases.append(dict(W=W, c=c, ms=device_ms(lambda: g.horner(s, c),
                                                     3, kernel_row),
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
            shape=[RR, W], ms=cases[0]["ms"],
            call_ms=cuda_ms(lambda: g.horner(s, c), 3), plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=0, kind="horner",
            cases=cases, chain_depth=depth, source=SOURCES["limb_group"],
        )
        # kernel 2's chain: 3 dependent products (t2, t2b, Y3m), each an
        # Fq2 product of 3 Fp products in a row on G2
        entries[f"limb_double_{gname}"]["chain_depth"] = 3 * f
        log(f"phase kernels {gname}: ok")
    lat = product_latency_us(dev, lg1(), rng)

    for S in NTT_SIZES:
        for L in NTT_RAGGED_L:
            x = torch.as_tensor(random_fr_limbs(rng, (S, L), 2 * R),
                                device=dev)
            for inverse in (False, True):
                nt = _small(S, inverse)
                compare(f"ntt_small {S}x{L} inv={inverse}", nt(x),
                        nt.plain(x))
    ntt_runs = []
    for S, L in ntt:
        # values below 2p: the second stage of a transform sees redundant
        # inputs after the twiddle multiply
        x = torch.as_tensor(random_fr_limbs(rng, (S, L), 2 * R), device=dev)
        for inverse in (False, True):
            nt = _small(S, inverse)
            err = compare(f"ntt_small {S}x{L} inv={inverse}", nt(x),
                          nt.plain(x))
            logS = S.bit_length() - 1
            nbytes = 2 * 16 * S * L * 4 + 16 * logS * (S // 2) * 4
            b_ms, b_by = bound(nbytes, (S // 2) * logS * L)
            ntt_runs.append(dict(
                shape=[16, S, L], inverse=inverse, ms=device_ms(
                    lambda: nt(x), 10, kernel_row), call_ms=cuda_ms(lambda: nt(x), 10),
                plain_ms=cuda_ms(lambda: nt.plain(x), 1), bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, chain_depth=logS,
            ))
    fwd = [r for r in ntt_runs if not r["inverse"]]
    # one 2^15 transform = the two forward launches above; its chain is
    # log2(S) dependent products in each
    entries["ntt_small"] = dict(
        shape=[fwd[0]["shape"], fwd[1]["shape"]],
        **{k: fwd[0][k] + fwd[1][k] for k in ("ms", "call_ms", "plain_ms",
                                              "bound_ms", "chain_depth")},
        bound_by=fwd[0]["bound_by"], max_abs_err=0, kind="ntt_small",
        source=SOURCES["ntt_small"],
    )
    for e in entries.values():
        if "chain_depth" in e:
            e["product_latency_us"] = lat
            e["chain_bound_ms"] = e["chain_depth"] * lat * 1e-3
    log("phase kernels ntt: " + json.dumps(ntt_runs))
    return entries


def in_blocks(fn, *xs, step: int = 1 << 18):
    """fn over column blocks of (ROWS, n) operands, concatenated: a plain
    version at the widest path shapes without its int64 temporaries of all
    n columns at once (the same function of the same inputs)."""
    import torch

    n = xs[0].shape[1]
    return torch.cat([fn(*(x[:, i : i + step] for x in xs))
                      for i in range(0, n, step)], dim=1)


def bls_groups():
    """name -> (limb group, row-major curve, host ops, generator) of the
    BLS12 groups: the 12-word kernel instantiations."""
    from distributed_groth16_tpu_torch.ops import bls12_377 as b7
    from distributed_groth16_tpu_torch.ops import bls12_381 as b8
    from distributed_groth16_tpu_torch.ops import limb_kernels as lk

    return {
        "g1_377": (lk.lg1_377(), b7.g1_377(), b7.G1_HOST,
                   b7.g1_generator_377()),
        "g1_381": (lk.lg1_381(), b8.g1_381(), b8.G1_HOST,
                   b8.g1_generator_381()),
        "g2_381": (lk.lg2_381(), b8.g2_381(), b8.G2_HOST,
                   b8.g2_generator_381()),
    }


def small_log_points(g, C, host, gen, n, dev, seed, windows=4):
    """n distinct points P_i = a_i G (a_i < 2^(8 windows), random) made on
    the card from a host table of d 2^(8w) G through kernel 1: the
    row-major canonical points (n, 3, ...) and the logs a_i (numpy
    int64). Run before a path's counters are zeroed."""
    import numpy as np
    import torch

    rows, bw = [], gen
    for _ in range(windows):
        row = [None, bw]
        for _ in range(254):
            row.append(host.add(row[-1], bw))
        rows.append(row)
        for _ in range(8):
            bw = host.double(bw)
    table = g.from_rowmajor(C.encode([p for row in rows for p in row], dev))
    digits = np.random.default_rng(seed).integers(0, 256, size=(windows, n))
    acc = g.infinity(n, dev)
    for w in range(windows):
        idx = torch.as_tensor(w * 256 + digits[w], device=dev)
        acc = g.add(acc, table[:, idx])
    logs = sum(digits[w].astype(np.int64) << (8 * w) for w in range(windows))
    # to row-major in column blocks: canonicalising all 2^24 G2 columns at
    # once would hold ~40 GB of int64 temporaries
    out = torch.empty((n,) + g.rm_shape, dtype=torch.int32, device=dev)
    step = 1 << 21
    for i in range(0, n, step):
        out[i : i + step] = g.to_rowmajor(acc[:, i : i + step])
    return out, logs


# phase 3's 12-word plain versions check (and time) at most this many
# columns of a launch: at the path widths (up to 2^24.3 columns) they took
# about 27 s more of the script's time limit
W12_PLAIN_COLUMNS = 1 << 20


def phase_kernels_w12(dev, bound, rng, widths):
    """Phase 3, 12 words: kernels 1-3 at <12, 1> and <12, 2> against their
    plain versions on the card (limb for limb) at ragged widths and at the
    widths phase 7's paths give them, there on the first W12_PLAIN_COLUMNS
    columns of each launch (`widths`: group -> kind -> columns;
    kernel 1 also on msm_tree's strided pair halves and on a broadcast
    operand, Horner at W in {2, 32, 34, 64, 68}), and timed at the widest
    path width of each (device ms per launch)."""
    import torch

    entries = {}
    for gname, (g, C, host, gen) in bls_groups().items():
        RR, f = g.ROWS, 3 if g.deg == 2 else 1
        suffix = "g2_w12" if g.deg == 2 else "g1_w12"
        base_rm, _ = small_log_points(g, C, host, gen, 4096, dev, 3)
        base = g.from_rowmajor(base_rm)
        P, Q = point_columns(g, base, 4096, dev, 1)
        red = g.add(P, Q)  # redundant [0, 2p) operands
        wd = widths[gname]

        def cols(n, seed):
            gen_ = torch.Generator(device=dev).manual_seed(seed)
            i = torch.randint(4096, (n,), device=dev, generator=gen_)
            return red[:, i], base[:, i]

        # ragged widths, strided pair halves, a broadcast operand
        for n in DOUBLE_RAGGED:
            x, y = cols(n, n)
            x[:, 1::3] = torch.as_tensor(g.inf_col, device=dev)
            compare(f"add_{gname} n={n}", g.add(x, y), g.plain_add(x, y))
            compare(f"double_{gname} n={n}", g.double(x), g.plain_double(x))
        pair = red[:, :4096].reshape(RR, 8, 256, 2)
        compare(f"add_{gname} pair halves", g.add(pair[..., 0], pair[..., 1]),
                g.plain_add(pair[..., 0], pair[..., 1]))
        compare(f"add_{gname} broadcast q", g.add(red, base[:, 7:8]),
                g.plain_add(red, base[:, 7:8]))
        xs = red[:, : 2 * 4095 : 2]
        compare(f"double_{gname} column stride 2", g.double(xs),
                g.plain_double(xs))
        # every path width; the row is timed at the widest. The kernel
        # runs at the whole width, its first W12_PLAIN_COLUMNS columns held
        # against the plain version (which runs once a width: that call is
        # its time)
        for kind in ("add", "double"):
            key = f"limb_{kind}_{suffix}"
            for n in sorted(wd[kind]):
                x, y = cols(n, n + 1)
                k = min(n, W12_PLAIN_COLUMNS)
                if kind == "add":
                    kern, plain = (lambda: g.add(x, y),
                                   lambda: in_blocks(g.plain_add, x[:, :k],
                                                     y[:, :k]))
                else:
                    kern, plain = (lambda: g.double(x),
                                   lambda: in_blocks(g.plain_double,
                                                     x[:, :k]))
                widest = n == max(wd[kind]) and key not in entries
                want, p_ms = event_ms(plain) if widest else (plain(), None)
                err = compare(f"{kind}_{gname} n={n}", kern()[:, :k], want)
                del want
                if not widest:
                    continue
                nbytes = (3 if kind == "add" else 2) * RR * n * 4
                b_ms, b_by = bound(nbytes, FQ_MULS[kind] * f * n, g.nw)
                entries[key] = dict(
                    shape=[RR, n], ms=device_ms(kern, 5, kernel_row),
                    call_ms=cuda_ms(kern, 5), plain_ms=p_ms, plain_columns=k,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err, kind=kind,
                    source=SOURCES["limb_group"], group=gname,
                )
        # Horner: window sums with infinity, equal columns, a final P + P
        inf = torch.as_tensor(g.inf_col, device=dev)
        cases = []
        for W, c in ((2, 4), (32, 8), (34, 8), (64, 4), (68, 4)):
            hs = red[:, 100 : 100 + W].clone()
            if W > 2:
                hs[:, W - 1] = inf[:, 0]
                hs[:, 2] = hs[:, 3]
            col = hs[:, 1:2]
            for _ in range(c):
                col = g.plain_double(col)
            hs[:, 0:1] = col
            err = compare(f"horner_{gname} W={W} c={c}", g.horner(hs, c),
                          g.plain_horner(hs, c))
            cases.append(dict(W=W, c=c, ms=device_ms(
                lambda: g.horner(hs, c), 3, kernel_row), max_abs_err=err))
            if (W, c) == wd["horner"] and f"limb_horner_{suffix}" not in \
                    entries:
                muls = (W - 1) * (c * FQ_MULS["double"] + FQ_MULS["add"]) * f
                b_ms, b_by = bound(RR * (W + 1) * 4, muls, g.nw)
                entries[f"limb_horner_{suffix}"] = dict(
                    shape=[RR, W], ms=cases[-1]["ms"],
                    call_ms=cuda_ms(lambda: g.horner(hs, c), 3),
                    plain_ms=cuda_ms(lambda: g.plain_horner(hs, c), 1),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=0,
                    kind="horner", source=SOURCES["limb_group"],
                    chain_depth=(W - 1) * (3 * c + 3), group=gname,
                )
        entries[f"limb_horner_{suffix}"].setdefault("cases", []).extend(
            dict(cs, group=gname) for cs in cases)
        entries[f"limb_double_{suffix}"]["chain_depth"] = 3 * f
        log(f"phase kernels {gname} (12 words): ok")
    lat = product_latency_us(dev, bls_groups()["g1_381"][0], rng)
    for e in entries.values():
        if "chain_depth" in e:
            e["product_latency_us"] = lat
            e["chain_bound_ms"] = e["chain_depth"] * lat * 1e-3
    return entries


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def probes(dev, targets: dict, peaks: dict | None = None):
    """While active, each callable named in `targets` (label -> (owner,
    attribute)) adds the wall ms of its calls, device drained before and
    after, to the yielded dict under its label, and its number of calls
    under label + "_calls". The targets must not call one another, so the
    totals are disjoint. With `peaks` (on a card), each label also gets
    the most device memory one of its calls allocated above what was
    allocated when it began (bytes)."""
    import torch

    totals = {label: 0.0 for label in targets}
    totals.update({f"{label}_calls": 0 for label in targets})
    saved = []
    for label, (owner, name) in targets.items():
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            sync(dev)
            if peaks is not None:
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                sync(dev)
                totals[_label] += (time.perf_counter() - t0) * 1e3
                totals[f"{_label}_calls"] += 1
                if peaks is not None:
                    peaks[_label] = max(
                        peaks.get(_label, 0),
                        torch.cuda.max_memory_allocated(dev) - base)

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield totals
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def kernel_row(kname: str):
    """The kernels-line row of a demangled device function name, or None:
    dg16::add_kernel<12, 2> is limb_add_g2_w12."""
    from distributed_groth16_tpu_torch.ops._cuda import kernel_name

    k = kname.replace(" ", "")
    m = re.search(r"dg16::(add|double|horner)_kernel<(\d+),(\d+)>", k)
    if m:
        return kernel_name(m.group(1), int(m.group(3)), int(m.group(2)))
    return "ntt_small" if "dg16::ntt_small_kernel" in k else None


def width_bucket(columns: int) -> str:
    return (">=65536" if columns >= 65536
            else "4096-65535" if columns >= 4096
            else "5-4095" if columns > 4 else "<=4")


# argument of a kernel entry that holds its launch's columns (kernels 1, 2)
WIDTH_ARG = {"limb_add": 9, "limb_double": 6}


@contextmanager
def kernel_trace(host_ops: bool = True):
    """torch.profiler (CUPTI) over the block. Yields a dict that is filled
    on exit with each kernel's summed device time (per_kernel, ms), kernels
    1 and 2 split by launch width (by_columns: {row: {columns: [launches,
    ms]}}), busy_ms, the union of every device activity's interval, and
    trace_s, the seconds spent reading the trace after the block.
    host_ops=False records the device alone, not every host-side torch op:
    after a path of hundreds of thousands of small ops, collecting those
    records takes minutes."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_groth16_tpu_torch.ops import _cuda

    names = {id(k): name for name, k in _cuda.KERNELS.items()}
    order = []  # (row, columns) of each launch, in launch order
    call = _cuda.Kernel.__call__

    def recorded(self, *args):
        call(self, *args)
        name = names[id(self)]
        arg = WIDTH_ARG.get(name.split("_g")[0])
        order.append((name, None if arg is None else args[arg]))

    res = {"per_kernel": {}, "by_columns": {}, "busy_ms": None}
    _cuda.Kernel.__call__ = recorded
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    try:
        with profile(activities=acts) as prof:
            yield res
    finally:
        _cuda.Kernel.__call__ = call
    t0 = time.perf_counter()
    spans = sorted((a, b, kernel_row(name))
                   for a, b, name in device_spans(prof))
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
                cell = res["by_columns"].setdefault(row, {}).setdefault(
                    width_bucket(width), [0, 0.0])
                cell[0] += 1
                cell[1] += ms
    res["trace_s"] = time.perf_counter() - t0


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
            by_columns=tr["by_columns"],
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
    return launches, per_proof_ms, dict(r1cs=r1cs, z=z, pubs=pubs, pk=pk,
                                        comp=comp, z_mont=z_mont,
                                        proof=proof1, warm=warm,
                                        per_proof_launches=per_proof,
                                        per_proof_ms=per_proof_ms)


# the spans every party's track holds after a full proving round with the
# aggregation plane on (a dfft.fft or dfft.ifft besides)
ROUND_SPANS = ("prove.party", "prove.h", "prove.A", "prove.B", "prove.C",
               "dmsm", "net.gather_to_king", "net.scatter_from_king",
               "net.king_compute")


def span_names(events) -> dict:
    """{party: {span name: count}} of a list of trace events."""
    out = {}
    for e in events:
        names = out.setdefault(int(e["pid"]), {})
        names[e["name"]] = names.get(e["name"], 0) + 1
    return out


def check_tracks(what, names, n, cp) -> None:
    """names: {party: {span name: count}} of one merged round, cp its
    critical path. Fails unless there is one track per party, each with
    the round's spans, and the critical path covers the n parties."""
    if sorted(int(p) for p in names) != list(range(n)):
        raise AssertionError(f"{what}: tracks {sorted(names)}, not 0..{n - 1}")
    for p, got in names.items():
        missing = [k for k in ROUND_SPANS if not got.get(k)]
        if not any(k.startswith("dfft.") for k in got):
            missing.append("dfft.*")
        if missing:
            raise AssertionError(f"{what}: party {p}'s track lacks {missing}")
    if not cp or cp.get("parties") != n or not cp.get("wall"):
        raise AssertionError(f"{what}: critical path {cp}")


def phase_mpc(dev, ctx, l=2):
    """Phase 6: the MPC prover as the proof service runs it for an
    "mpc_prove" job: the key loaded from its .npz (no dealer scalars, so
    packed in the exponent), QAP and witness shares, one n = 4l party round
    over LocalSimNet, reassembly and verification. The r = s = 0 proof must
    equal phase 4's prove_single proof byte for byte; a second round at
    r, s != 0 must verify. Between the two, four more r = s = 0 rounds,
    the aggregation plane (DG16_AGG's in-process half) on, idle, idle, on:
    each gives the same proof, and each with the plane on one merged
    track per party holding prove.party around prove.h and the dfft /
    dmsm / net.* spans, and a critical path over the 8 parties; the four
    rounds' ms are logged. Returns the launch counts of the r = s = 0
    pack and round."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
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
    ctx["point_crs"] = crs  # phase 7 holds the scalar route against it
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
    ctx["mpc_round"] = dict(round=king["round"], h=king["h"], ab=king["ab"],
                            c=king["c"])  # phase 9 sets its star against it
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

    # the round with the aggregation plane on, in turns with the plane
    # idle (on, idle, idle, on: rounds vary by more than the plane costs).
    # Its spans mark host time: a span can close before the device work it
    # launched (the king's phase marks drain the card, as in every round)
    from distributed_groth16_tpu_torch.telemetry import aggregate

    turns = {True: [], False: []}
    for on in (True, False, False, True):
        if on:
            aggregate.set_enabled(True)
            agg = aggregate.reset_aggregator()
        try:
            res, king_turn = round_()
            if on:
                events, cp = agg.events(), agg.last_critical_path
        finally:
            if on:
                aggregate.set_enabled(False)
                aggregate.reset_aggregator()
        turns[on].append(king_turn["round"])
        if proof_bytes(reassemble_proof(res[0], pk)) != proof_bytes(proof):
            raise AssertionError("a round with the plane "
                                 f"{'on' if on else 'idle'} gave another "
                                 "proof")
        if not on:
            continue
        names = span_names(events)
        check_tracks("mpc path, plane on", names, pp.n, cp)
        for p in range(pp.n):
            outer = [e for e in events
                     if e["pid"] == p and e["name"] == "prove.party"]
            inner = [e for e in events
                     if e["pid"] == p and e["name"] == "prove.h"]
            if len(outer) != 1 or len(inner) != 1 or not (
                    outer[0]["ts"] <= inner[0]["ts"]
                    and inner[0]["ts"] + inner[0]["dur"]
                    <= outer[0]["ts"] + outer[0]["dur"]):
                raise AssertionError(f"party {p}: prove.party does not hold "
                                     "prove.h")
    ctx["mpc_round_agg"] = dict(round=turns[True], critical_path=cp)
    log("mpc path round, aggregation plane on: " + json.dumps(dict(
        round_ms_plane_on=turns[True], round_ms_plane_idle=turns[False],
        round_ms_first=king["round"], critical_path_s=cp,
        spans=len(events), spans_per_party=names[0])))

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

    # each kernel's device time in one MPC proof: a pack and an r = s = 0
    # round under the profiler (the launch counts above are already read)
    per_mpc_ms = {k: 0.0 for k in _cuda.KERNELS}
    if dev.type == "cuda":
        traces = {}
        for part in ("pack", "round"):
            with kernel_trace() as tr:
                t0 = time.perf_counter()
                if part == "pack":
                    pack_proving_key(pk, pp)
                else:
                    res, _ = round_()
                sync(dev)
                tr["wall_ms"] = (time.perf_counter() - t0) * 1e3
            if not tr["per_kernel"]:
                raise AssertionError("torch.profiler recorded no kernel")
            traces[part] = tr
            for k, ms in tr["per_kernel"].items():
                per_mpc_ms[k] += ms
        if proof_bytes(reassemble_proof(res[0], pk)) != proof_bytes(proof):
            raise AssertionError("profiled MPC round gave another proof")
        log("mpc path kernel device ms per MPC proof (pack + round): "
            + json.dumps(dict(method="torch.profiler", per_kernel=per_mpc_ms,
                              total=sum(per_mpc_ms.values()),
                              **{part: dict(per_kernel=tr["per_kernel"],
                                            by_columns=tr["by_columns"],
                                            device_busy_ms=tr["busy_ms"],
                                            wall_ms=tr["wall_ms"])
                                 for part, tr in traces.items()})))

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
    return launches, per_mpc_ms


# phase 7's sizes (log2 of the points): (a) examples/dmsm_bench.py --curve
# bls12-377's top size; (b) BASELINE config 5 at its own size, 2^24 points
# (the tree MSM runs two chunks of ops/msm.TREE_MSM_MAX_N = 2^23: one tree
# over 2^24 would not fit on an 80 GB card); (c) a BLS12-381 G2 d_msm
BLS_LOG_N = {"a": 19, "b": 24, "c": 16}


def msm_level0(npts: int, rows: int, W: int) -> int:
    """Columns of the first add level of msm_tree over npts points: a
    window group of W windows (all of them up to 2^17 points, else
    384 // rows) times half the padded points."""
    npad = 1 << max(1, (npts - 1).bit_length())
    group = W if npad <= 1 << 17 else max(1, 8 * 48 // rows)
    return group * npad // 2


def w12_widths(l: int = 2) -> dict:
    """Columns of kernels 1 and 2, and Horner's (W, c), on phase 7's paths
    for n = 4l parties: a d_msm's base pack adds over B*o*K = N*n columns
    and doubles over B*K = N (no GLV: K = l); the king's unpack adds over
    l*n and doubles over n; each local MSM adds first over msm_level0, (b)
    over that of one tree chunk."""
    from distributed_groth16_tpu_torch.ops.msm import TREE_MSM_MAX_N

    n = 4 * l
    a, b, c = (1 << BLS_LOG_N[k] for k in "abc")
    b = min(b, TREE_MSM_MAX_N)
    return {
        "g1_377": {"add": {a * n, msm_level0(a // l, 72, 32), l * n},
                   "double": {a, n}, "horner": (32, 8)},
        "g1_381": {"add": {msm_level0(b, 72, 32)}, "double": set(),
                   "horner": (32, 8)},
        "g2_381": {"add": {msm_level0(b, 144, 32), c * n,
                           msm_level0(c // l, 144, 34), l * n},
                   "double": {c, n}, "horner": (34, 8)},
    }


# the kernels each phase 7 path must launch
BLS_PATH_KERNELS = {
    "a": ("limb_add_g1_w12", "limb_double_g1_w12", "limb_horner_g1_w12"),
    "a_local": ("limb_add_g1_w12", "limb_horner_g1_w12"),
    "b_g1": ("limb_add_g1_w12", "limb_horner_g1_w12"),
    "b_g2": ("limb_add_g2_w12", "limb_horner_g2_w12"),
    "c": ("limb_add_g2_w12", "limb_double_g2_w12", "limb_horner_g2_w12"),
    "d": ("limb_add_g1", "limb_add_g2", "limb_double_g1", "limb_double_g2",
          "limb_horner_g1", "limb_horner_g2"),
}


def random_scalars(rng, n: int, r: int) -> list[int]:
    raw = rng.bytes(40 * n)
    return [int.from_bytes(raw[40 * i : 40 * (i + 1)], "little") % r
            for i in range(n)]


def random_scalar_limbs(rng, n: int):
    """n random 254-bit scalars (below r381 and r377) as (n, 16) 16-bit
    standard-form limbs, numpy int64: encode_scalars' layout, made without
    a Python int each."""
    import numpy as np

    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] &= (1 << 14) - 1
    return limbs


def dot_mod(limbs, logs, r: int) -> int:
    """sum_i s_i a_i mod r for scalars s_i given as (n, 16) 16-bit limbs
    and logs 0 <= a_i < 2^32, exact in int64: each limb times a 16-bit half
    of a_i is below 2^32, so a column sum of up to 2^31 rows fits."""
    import numpy as np

    halves = np.stack([logs & 0xFFFF, logs >> 16])  # (2, n)
    cols = halves @ limbs  # (2, 16)
    return sum((int(cols[h, k]) << (16 * k + 16 * h))
               for h in range(2) for k in range(16)) % r


def phase_bls(dev, ctx, l=2):
    """Phase 7: the BLS12 paths (a)-(c) and the scalar route of the CRS
    pack (d); see the module docstring. Each path runs once under
    torch.profiler, its counters zeroed just before and read just after.
    Returns {path: {launches, device_ms, ...}}."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
    from distributed_groth16_tpu_torch.models.groth16 import (
        distributed_prove_party, pack_from_witness, pack_proving_key,
        reassemble_proof, verify,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops import bls12_377 as b7
    from distributed_groth16_tpu_torch.ops import bls12_381 as b8
    from distributed_groth16_tpu_torch.ops.curve import g1, g2
    from distributed_groth16_tpu_torch.ops.msm import msm
    from distributed_groth16_tpu_torch.parallel.dmsm import d_msm
    from distributed_groth16_tpu_torch.parallel.net import (
        simulate_network_round,
    )
    from distributed_groth16_tpu_torch.parallel.pss import pss

    rng = np.random.default_rng(7)
    groups = bls_groups()
    paths = {}

    @contextmanager
    def path(name):
        for k in _cuda.KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        rec = {}
        with kernel_trace(host_ops=False) as tr:
            t0 = time.perf_counter()
            yield rec
            sync(dev)
            t1 = time.perf_counter()
            rec["wall_ms"] = (t1 - t0) * 1e3
        rec["trace_s"] = time.perf_counter() - t1
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        missing = [k for k in BLS_PATH_KERNELS[name] if launches[k] == 0]
        if missing:
            raise AssertionError(f"path {name} never launched {missing}")
        if not tr["per_kernel"]:
            raise AssertionError("torch.profiler recorded no kernel")
        rec.update(launches={k: v for k, v in launches.items() if v},
                   device_ms=tr["per_kernel"], by_columns=tr["by_columns"],
                   device_busy_ms=tr["busy_ms"],
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   smi_after=smi_sample())
        paths[name] = rec
        log(f"bls path {name}: " + json.dumps(rec))

    def dmsm_round(C, pp, F, b_sh, s_sh):
        async def party(net, d):
            return await d_msm(C, d[0], d[1], pp, net, scalar_field=F)

        return simulate_network_round(
            pp.n, party, [(b_sh[i], s_sh[i]) for i in range(pp.n)])

    def dmsm_path(name, gname, pp, F, r, pack_scalars, logn):
        """dmsm_bench's loop body over 2^logn distinct points P_i = a_i G
        of known logs a_i, so the result must be (sum s_i a_i) G."""
        N = 1 << logn
        g, C, host, gen = groups[gname]
        pts, logs = small_log_points(g, C, host, gen, N, dev, 5)
        scalars = random_scalars(rng, N, r)
        want = host.scalar_mul(
            gen, sum(s * int(a) for s, a in zip(scalars, logs)) % r)
        with path(name) as rec:
            t0 = time.perf_counter()
            s_sh = pack_scalars(pp, scalars, dev)
            chunks = pts.reshape((N // l, l, 3) + C.elem_shape)
            b_sh = pp.packexp_from_public(C, chunks).transpose(0, 1)
            sync(dev)
            rec["pack_ms"] = (time.perf_counter() - t0) * 1e3
            outs = dmsm_round(C, pp, F, b_sh, s_sh)
        if any(o is not outs[0] for o in outs) or C.decode(outs[0]) != want:
            raise AssertionError(f"path {name}: d_msm differs from the host")
        log(f"bls path {name}: d_msm over 2^{logn} points equals the host "
            "sum")
        return pts, scalars, want

    # (a) BLS12-377 G1 d_msm, the reference's dmsm_bench configuration
    pts, scalars, want = dmsm_path("a", "g1_377", b7.pss377(l), b7.fr377(),
                                   b7.R377, b7.pack_scalars_377,
                                   BLS_LOG_N["a"])
    sc = b7.encode_scalars_377(scalars, dev)
    with path("a_local"):
        local = msm(b7.g1_377(), pts, sc)
    if b7.g1_377().decode(local) != want:
        raise AssertionError("path a: local msm differs from the host sum")
    del pts, scalars, sc, local

    # (b) BLS12-381 local MSMs over 2^24 distinct points, G1 and G2, on
    # one set of scalars and logs
    N = 1 << BLS_LOG_N["b"]
    limbs = random_scalar_limbs(rng, N)
    sc = torch.as_tensor(limbs.astype(np.int32), device=dev)
    exponent = None
    for name, gname in (("b_g1", "g1_381"), ("b_g2", "g2_381")):
        g, C, host, gen = groups[gname]
        pts, logs = small_log_points(g, C, host, gen, N, dev, 11)
        if exponent is None:
            exponent = dot_mod(limbs, logs, b8.R381)
        want = host.scalar_mul(gen, exponent)
        with path(name):
            out = msm(C, pts, sc)
        if C.decode(out) != want:
            raise AssertionError(f"path {name}: msm differs from the host")
        log(f"bls path {name}: msm over 2^{BLS_LOG_N['b']} points equals "
            f"the host; peak device memory {paths[name]['peak_bytes']} bytes")
        del pts, logs, out
    del limbs, sc

    # (c) BLS12-381 G2 d_msm
    dmsm_path("c", "g2_381", b8.pss381(l), b8.fr381(), b8.R381,
              b8.pack_scalars_381, BLS_LOG_N["c"])

    # (d) the scalar route of the CRS pack, BN254, phase 4's key
    pk, comp, z_mont = ctx["pk"], ctx["comp"], ctx["z_mont"]
    if pk.query_scalars is None:
        raise AssertionError("phase 4's setup kept no query scalars")
    pp = pss(l)
    ni = ctx["r1cs"].num_instance
    with path("d") as rec:
        pack = {}
        crs = pack_proving_key(pk, pp, timings=pack)
        rec["pack_ms_per_query"] = pack
        qap_shares = comp.qap(z_mont).pss(pp)
        a_sh = pack_from_witness(pp, z_mont[1:])
        ax_sh = pack_from_witness(pp, z_mont[ni:])

        async def party(net, d):
            return await distributed_prove_party(pp, *d, net)

        res = simulate_network_round(pp.n, party, [
            (crs[i], qap_shares[i], a_sh[i], ax_sh[i]) for i in range(pp.n)])
        proof = reassemble_proof(res[0], pk)
    for q in ("s", "u", "v", "w", "h"):
        curve = g2() if q == "v" else g1()
        got = torch.stack([getattr(c, q) for c in crs])
        want = torch.stack([getattr(c, q) for c in ctx["point_crs"]])
        if got.shape != want.shape or not torch.equal(
                curve.to_affine(got), curve.to_affine(want)):
            raise AssertionError(f"scalar route: query {q} differs from the "
                                 "point route")
    if proof_bytes(proof) != proof_bytes(ctx["proof"]):
        raise AssertionError("scalar-route MPC proof differs from "
                             "prove_single's")
    if not verify(pk.vk, proof, ctx["pubs"]):
        raise AssertionError("scalar-route MPC proof does not verify")
    log("bls path d: scalar-route shares equal the point route's as affine "
        "points; the proof equals prove_single's byte for byte")
    return paths


# the kernels phase 8's pack and round must each launch
MPC64_KERNELS = ("limb_add_g1", "limb_add_g2", "limb_double_g1",
                 "limb_double_g2")


def phase_mpc64(dev, ctx, l=16, dpp_log_m=15):
    """Phase 8: the MPC prover at n = 4l = 64 parties, where "auto" takes
    the in-exponent point NTT (parallel/pointntt.py): phase 4's key loaded
    from its .npz (no dealer scalars) and packed by the point route, QAP
    and witness shares, one r = s = 0 round over LocalSimNet whose every
    king unpack runs unpackexp_ntt, reassemble_proof -> verify; the proof
    equals phase 4's prove_single proof byte for byte (the round at
    r, s != 0 runs at n = 8 in phase 6; at n = 64 it cost ~28 s of the
    script's time limit). The pack and the r = s = 0 round each run under a
    device-only trace, counters zeroed before and read after; each must
    launch kernels 1 and 2 on G1 and G2. Then one G1 query's pack and one
    king unpack by both routes (equal as affine points, both timed), and
    d_pp over num = den = 1..m at m = 2^dpp_log_m (all ones) and on random
    num, den at m = 2^10, l = 2 (the host prefix products). Returns the
    launch counts and device ms of the pack + round."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
    from distributed_groth16_tpu_torch.models.groth16 import (
        ProvingKey, distributed_prove_party, pack_from_witness,
        pack_proving_key, reassemble_proof, verify,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.ops.curve import g1
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.ops.refmath import finv
    from distributed_groth16_tpu_torch.parallel import pointntt
    from distributed_groth16_tpu_torch.parallel.dpp import d_pp
    from distributed_groth16_tpu_torch.parallel.net import (
        simulate_network_round,
    )
    from distributed_groth16_tpu_torch.parallel.packing import (
        pack_consecutive, unpack_shares,
    )
    from distributed_groth16_tpu_torch.parallel.pss import (
        PackedSharingParams, pss,
    )

    r1cs, pubs, comp, z_mont = (ctx[k] for k in ("r1cs", "pubs", "comp",
                                                   "z_mont"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pk.npz")
        ctx["pk"].save(path)
        pk = ProvingKey.load(path, device=dev)
    assert pk.query_scalars is None
    pp = pss(l)
    if pp._pick_exp_method("auto") != "ntt":
        raise AssertionError(f"n = {pp.n}: auto does not take the point NTT")
    ni = r1cs.num_instance
    log(f"mpc64 path: m={pk.domain_size} l={pp.l} n={pp.n} t={pp.t}")
    torch.cuda.reset_peak_memory_stats(dev)
    routes = {"unpackexp_ntt": (pointntt, "unpackexp_ntt"),
              "packexp_ntt": (pointntt, "packexp_ntt"),
              "dense": (PackedSharingParams, "_apply_point_matrix")}

    def traced(part, fn):
        for k in _cuda.KERNELS.values():
            k.launches = 0
        with probes(dev, routes) as calls, \
                kernel_trace(host_ops=False) as tr:
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            tr["wall_ms"] = (time.perf_counter() - t0) * 1e3
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        missing = [k for k in MPC64_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"mpc64 {part} never launched {missing}")
        if not tr["per_kernel"]:
            raise AssertionError("torch.profiler recorded no kernel")
        if calls["dense_calls"]:
            raise AssertionError(f"mpc64 {part} ran the dense ladder")
        rec = dict(launches={k: v for k, v in launches.items() if v},
                   device_ms=tr["per_kernel"], by_columns=tr["by_columns"],
                   device_busy_ms=tr["busy_ms"], wall_ms=tr["wall_ms"],
                   trace_s=tr["trace_s"], smi_after=smi_sample(),
                   route_calls={k: v for k, v in calls.items()
                                if k.endswith("_calls")})
        log(f"mpc64 {part}: " + json.dumps(rec))
        return out, launches, rec

    pack = {}
    crs, l_pack, rec_pack = traced(
        "pack", lambda: pack_proving_key(pk, pp, timings=pack))
    if rec_pack["route_calls"]["packexp_ntt_calls"] != 5:
        raise AssertionError("the pack did not take the point NTT for "
                             "every query")
    log("mpc64 pack ms per query: " + json.dumps(pack))
    t0 = time.perf_counter()
    qap_shares = comp.qap(z_mont).pss(pp)
    a_sh = pack_from_witness(pp, z_mont[1:])
    ax_sh = pack_from_witness(pp, z_mont[ni:])
    sync(dev)
    t_shares = (time.perf_counter() - t0) * 1e3
    data = [(crs[i], qap_shares[i], a_sh[i], ax_sh[i]) for i in range(pp.n)]

    def round_(**kw):
        king = {}

        async def party(net, d):
            return await distributed_prove_party(
                pp, *d, net, timings=king if net.is_king else None, **kw
            )

        res = simulate_network_round(pp.n, party, data)
        return res, king

    (res, king), l_round, rec_round = traced("round", round_)
    n_unpack = rec_round["route_calls"]["unpackexp_ntt_calls"]
    if n_unpack == 0:
        raise AssertionError("no king unpack took the point NTT")
    proof = reassemble_proof(res[0], pk)
    if proof_bytes(proof) != proof_bytes(ctx["proof"]):
        raise AssertionError("n = 64 MPC proof differs from prove_single's")
    if not verify(pk.vk, proof, pubs):
        raise AssertionError("n = 64 MPC proof does not verify")
    peak = torch.cuda.max_memory_allocated(dev)
    log("mpc64 phases ms: " + json.dumps(dict(
        pack=rec_pack["wall_ms"], qap_pss=t_shares, round=rec_round[
            "wall_ms"], h=king["h"], ab=king["ab"], c=king["c"])))
    log(f"mpc64 peak device memory (pack + round): {peak} bytes")
    log(f"mpc64: proof verifies and equals prove_single's; {n_unpack} king "
        "unpacks through unpackexp_ntt")

    # one G1 query's pack (h_query, the widest) and one king unpack of 64
    # shares by both routes, each timed warm (its second call)
    C = g1()

    def both(fn):
        out, ms = {}, {}
        for method in ("dense", "ntt"):
            fn(method)
            sync(dev)
            t0 = time.perf_counter()
            out[method] = fn(method)
            sync(dev)
            ms[method] = (time.perf_counter() - t0) * 1e3
        if not torch.equal(C.to_affine(out["dense"]),
                           C.to_affine(out["ntt"])):
            raise AssertionError("dense and ntt routes differ")
        return ms

    hq = pk.h_query  # m points, a multiple of l
    chunks = hq.reshape((hq.shape[0] // pp.l, pp.l) + tuple(hq.shape[1:]))
    pack_ms = both(lambda m: pp.packexp_from_public(C, chunks, method=m))
    shares = torch.stack([crs[i].u[0] for i in range(pp.n)])  # (64, 3, 16)
    unpack_ms = both(lambda m: pp.unpackexp(C, shares, degree2=True,
                                            method=m))
    log("mpc64 routes, warm ms (equal as affine points): " + json.dumps(dict(
        pack_h_query=pack_ms, king_unpack=unpack_ms)))

    # d_pp: num = den = 1..m (dpp_test.rs:20-26), then random num, den
    F = fr()
    rng = np.random.default_rng(2026)
    for lp, log_m, rand in ((l, dpp_log_m, False), (2, 10, True)):
        m = 1 << log_m
        qp = pss(lp)
        if rand:
            num = random_scalars(rng, m, R - 1)
            den = random_scalars(rng, m, R - 1)
            num, den = [v + 1 for v in num], [v + 1 for v in den]
        else:
            num = den = list(range(1, m + 1))
        want, acc = [], 1
        if rand:
            for x, y in zip(num, den):
                acc = acc * x % R * finv(y, R) % R
                want.append(acc)
        else:
            want = [1] * m
        sn = pack_consecutive(qp, F.encode(num, dev))
        sd = pack_consecutive(qp, F.encode(den, dev))

        async def party(net, d, qp=qp):
            return await d_pp(d[0], d[1], qp, net)

        t0 = time.perf_counter()
        outs = simulate_network_round(qp.n, party,
                                      [(sn[i], sd[i]) for i in range(qp.n)])
        sync(dev)
        t_dpp = (time.perf_counter() - t0) * 1e3
        got = [int(v) for v in F.decode(unpack_shares(qp,
                                                      torch.stack(outs)))]
        if got != want:
            raise AssertionError(f"d_pp m=2^{log_m} l={lp}: wrong prefix "
                                 "products")
        log(f"mpc64 d_pp m=2^{log_m} l={lp} n={qp.n} "
            f"{'random' if rand else 'num = den = 1..m'}: "
            f"{t_dpp:.1f} ms, equals the host")
    per_ms = {k: rec_pack["device_ms"].get(k, 0.0)
              + rec_round["device_ms"].get(k, 0.0) for k in _cuda.KERNELS}
    launches = {k: l_pack[k] + l_round[k] for k in _cuda.KERNELS}
    return launches, per_ms


# phase 9's transport: mTLS, as the reference deploys it (the card's
# machine has the cryptography package that utils/certs.py needs)
STAR_PLAIN = False
# what every rank of phase 9's SHA-256 star must launch, and the king too
STAR_KERNELS = ("limb_add_g1", "limb_add_g2", "limb_horner_g1",
                "limb_horner_g2")
KING_KERNELS = ("limb_double_g1", "limb_double_g2")
# the SHA-256 star's ranks run the aggregation plane (DG16_AGG) with
# heartbeats this often, so the king has every client's clock sample
# before the round ends (the default, 15 s, outlasts the round)
STAR_AGG_ENV = {"DG16_AGG": "1", "DG16_NET_HEARTBEAT_S": "0.25"}


@contextmanager
def smi_memory_peak():
    """Samples nvidia-smi memory.used (MiB, all processes on the card)
    every 0.5 s while the block runs; yields a dict whose "max_mib" holds
    the largest sample on exit."""
    import threading

    res = {"max_mib": 0.0, "samples": 0}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            mib = float(nvidia_smi("memory.used").split()[0])
            res["max_mib"] = max(res["max_mib"], mib)
            res["samples"] += 1
            stop.wait(0.5)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield res
    finally:
        stop.set()
        th.join(timeout=70)


def phase_star(dev, ctx, n=8):
    """Phase 9: the reference's deployment, one OS process per party on
    the card, over a ProdNet star on localhost (examples/launch.py spawns
    n ranks, each a fresh interpreter with its own CUDA context on
    `dev`): (a) add_ids; (b) nonlocal_kernel dfft, dmsm and dpp at the
    example's default sizes, rank 0 checking each against refmath; (c)
    nonlocal_sha256 on phase 4's circuit (m = 2^15, l = 2) with a fresh
    key cache, so rank 0 runs setup (seed 42) and ranks 1.. load its .npz:
    every rank exits 0, rank 0's proof verifies and equals phase 4's
    prove_single proof byte for byte, every rank launched kernels 1 and 3
    on G1 and G2, and the king kernel 2 on both. (c)'s ranks run with the
    aggregation plane on (STAR_AGG_ENV, in their environment only): the
    king merges 8 tracks, each client's spans rebased by its clock
    offset, every client has a clock sample, the king received at least
    7 TELEMETRY frames, and every peer's wire bytes are non-zero; the
    king's king / straggler / wire / wall split is logged. Returns the
    kernels' launches summed over the ranks of (c)."""
    import torch

    from distributed_groth16_tpu_torch.examples.launch import launch
    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
    from distributed_groth16_tpu_torch.ops import _cuda

    torch.cuda.empty_cache()
    log(f"star: n={n} ranks on {dev}, plain TCP={STAR_PLAIN}, "
        f"nvidia-smi memory.used before: {nvidia_smi('memory.used')}")
    star = dict(plain=STAR_PLAIN, deadline_s=300.0)
    t0 = time.perf_counter()
    lines = launch("add_ids", n, **star)
    if [x["sum"] for x in lines] != [n * (n - 1) // 2] * n:
        raise AssertionError(f"add_ids star: {lines}")
    log(f"star add_ids: every rank has the sum {n * (n - 1) // 2}, "
        f"{time.perf_counter() - t0:.1f} s")
    for kernel in ("dfft", "dmsm", "dpp"):
        t0 = time.perf_counter()
        lines = launch("nonlocal_kernel", n, ["--kernel", kernel], **star)
        if not all(x["ok"] for x in lines):
            raise AssertionError(f"nonlocal_kernel {kernel}: {lines[0]}")
        log(f"star {kernel}: rank 0 equals refmath; star "
            f"{time.perf_counter() - t0:.1f} s, rank ms "
            + json.dumps([x["ms"] for x in lines]))

    # launch.py hands the ranks a copy of os.environ: set the plane's knobs
    # for them, and put the parent's environment back afterwards
    saved = {k: os.environ.get(k) for k in STAR_AGG_ENV}
    os.environ.update(STAR_AGG_ENV)
    try:
        with tempfile.TemporaryDirectory() as cache, \
                smi_memory_peak() as mem:
            t0 = time.perf_counter()
            lines = launch("nonlocal_sha256", n,
                           ["--circuit", "sha256", "--msg", "abc",
                            "--cache-dir", cache], **star)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    king = lines[0]
    if not king.get("verified"):
        raise AssertionError("the star's proof does not verify")
    if bytes.fromhex(king["proof"]) != proof_bytes(ctx["proof"]):
        raise AssertionError("the star's proof differs from prove_single's")
    for x in lines:
        missing = [k for k in STAR_KERNELS if x["launches"][k] == 0]
        if missing:
            raise AssertionError(f"rank {x['party']} never launched {missing}")
    missing = [k for k in KING_KERNELS if king["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the king never launched {missing}")
    for x in lines:
        log(f"star sha256 rank {x['party']}: " + json.dumps(dict(
            phases_ms=x["phases_ms"], round_ms=x["round_ms"],
            peak_bytes=x["peak_bytes"],
            launches={k: v for k, v in x["launches"].items() if v})))
    agg = king.get("agg")
    if not agg or not agg["complete"]:
        raise AssertionError(f"the king's plane did not close the round: "
                             f"{agg}")
    check_tracks("star sha256", agg["spans"], n, agg["critical_path"])
    peers = agg["peers"]
    if sorted(peers) != [str(i) for i in range(1, n)]:
        raise AssertionError(f"the king's peers: {sorted(peers)}")
    unsampled = [p for p, v in peers.items() if v["clock_samples"] < 1]
    if unsampled:
        raise AssertionError(f"no clock sample from clients {unsampled}")
    frames = sum(v["telemetry_frames_recv"] for v in peers.values())
    if frames < n - 1:
        raise AssertionError(f"the king merged {frames} TELEMETRY frames")
    silent = [p for p, v in peers.items()
              if not (v["bytes_sent"] and v["bytes_recv"])]
    if silent:
        raise AssertionError(f"no wire bytes counted for peers {silent}")
    log("star sha256 critical path: " + json.dumps(dict(
        critical_path_s=agg["critical_path"], telemetry_frames=frames,
        peers=peers)))
    rounds = [x["phases_ms"]["MPC prove (over sockets)"] for x in lines]
    log("star sha256: " + json.dumps(dict(
        wall_ms=wall, socket_round_ms_max=max(rounds),
        socket_round_ms_king=rounds[0], king_round_ms=king["round_ms"],
        in_process_round_phase6=ctx.get("mpc_round"),
        smi_memory_used_max_mib=mem["max_mib"], smi_samples=mem["samples"],
    )))
    log("star sha256: every rank exited 0; the proof verifies and equals "
        "prove_single's")
    return {k: sum(x["launches"][k] for x in lines) for k in _cuda.KERNELS}


def phase_byte_identity(dev, length=2046, log_m=11):
    """Phase 5: at m = 2^11 the card's proof equals the CPU's (the CPU
    runs every kernel's plain version) for one key and witness."""
    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
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


# the kernels a .zkey key's warm proof must launch as phase 4's key's does
ZKEY_KERNELS = ("limb_add_g1", "limb_add_g2", "limb_horner_g1",
                "limb_horner_g2", "ntt_small")


def fold_statement(i: int):
    """The i-th statement of phase 10's fold: SHA-256 of one single-block
    message of at most 55 bytes, so every statement has phase 4's
    circuit (A, B and C) and its own publics."""
    from distributed_groth16_tpu_torch.frontend.sha256 import sha256_circuit

    msg = f"dg16 fold {i:03d}: one SHA-256 block".encode()
    cs, pubs = sha256_circuit(msg)
    r1cs, z = cs.finish()
    return r1cs, z, pubs


def stand_in_job(circuit_id, items):
    """The part of a service job (distributed_groth16_tpu/service/jobs.py
    ProofJob) that VerifyBatchRunner reads: its circuit id and its
    proofs_file payload of (proof, publics) items."""
    from distributed_groth16_tpu_torch.frontend.ark_serde import (
        proof_to_bytes,
    )

    return types.SimpleNamespace(circuit_id=circuit_id, fields={
        "proofs_file": json.dumps([
            {"proof": proof_to_bytes(p).hex(),
             "publicInputs": [str(x) for x in pub]} for p, pub in items
        ]).encode()})


def phase_zkey(dev, ctx, statement=fold_statement, n_fold=32, jobs=4,
               tampered=5, n_each=8):
    """Phase 10: a circom/snarkjs user's path on phase 4's circuit and key.
    (a) .r1cs, .wtns and .zkey written to a temporary directory and read
    back (ProvingKey.from_zkey onto `dev`), each equal to the original;
    (b) warm prove_single with the .zkey key, equal to phase 4's proof at
    r = s = 0 and to phase 4's key's proof at one r, s != 0, launching
    the kernels phase 4's warm proof launches, as often; (c) the proof
    through snarkjs JSON, arkworks bytes and Ethereum tuples and back;
    (d) n_fold statements (`statement(i)`: r1cs, witness, publics) proved
    with the .zkey key at distinct r, s != 0 and checked by one RLC fold
    (verify_batch), then with proof `tampered` made false: verify_batch
    false, verify_each naming it among the first n_each proofs, bundles,
    and VerifyBatchRunner over `jobs` stand-in jobs sharing those n_each
    proofs, of which only the one holding the false proof fails (n_each
    cuts the bisections' depth: both pay one launch-bound plain ladder a
    fold). Counters zeroed before, read after. Returns the launches."""
    import numpy as np

    from distributed_groth16_tpu_torch.frontend import (
        ark_serde, ethereum, readers, snarkjs,
    )
    from distributed_groth16_tpu_torch.frontend.zkey import (
        read_zkey, write_zkey,
    )
    from distributed_groth16_tpu_torch.models.groth16 import (
        CompiledR1CS, Proof, ProvingKey, prove_single, verify,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops import refmath as rm
    from distributed_groth16_tpu_torch.ops.constants import G1_GENERATOR, R
    from distributed_groth16_tpu_torch.ops.curve import g1, g2
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.verifier import (
        InvalidProofError, PreparedVerifyingKey, PvkCache, VerifyBatchRunner,
        VerifyExecutor, build_bundle, check_bundle, verify_batch, verify_each,
    )
    from distributed_groth16_tpu_torch.verifier import batch as vbatch

    r1cs, z, pubs, pk4 = (ctx[k] for k in ("r1cs", "z", "pubs", "pk"))
    proof_bytes = ark_serde.proof_to_bytes
    for k in _cuda.KERNELS.values():
        k.launches = 0
    ms = {}

    def timed(name, fn, *a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    # (a) artifacts
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, f"sha256.{ext}")
                 for ext in ("r1cs", "wtns", "zkey")}
        blobs = {
            "r1cs": timed("write_r1cs", readers.write_r1cs, r1cs),
            "wtns": timed("write_wtns", readers.write_wtns, z),
            "zkey": timed("write_zkey", write_zkey, pk4, r1cs),
        }
        for ext, blob in blobs.items():
            with open(paths[ext], "wb") as f:
                f.write(blob)
        sizes = {ext: os.path.getsize(p) for ext, p in paths.items()}
        r1cs_z, _ = timed("read_r1cs", readers.read_r1cs, paths["r1cs"])
        z_z = timed("read_wtns", readers.read_wtns, paths["wtns"])
        _, mats = timed("read_zkey", read_zkey, paths["zkey"], dev)
        pk = timed("from_zkey", ProvingKey.from_zkey, paths["zkey"], dev)
    if vars(r1cs_z) != vars(r1cs) or z_z != list(z):
        raise AssertionError(".r1cs or .wtns differs after its round trip")
    if (mats.a, mats.b) != (r1cs.a, r1cs.b) or any(mats.c):
        raise AssertionError(".zkey matrices differ from the circuit's A, B")
    if pk.device != dev or vars(pk.vk) != vars(pk4.vk) or (
            pk.domain_size, pk.num_instance) != (pk4.domain_size,
                                                 pk4.num_instance):
        raise AssertionError(".zkey key's header or vk differs")
    for q in ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
              "h_query", "l_query"):
        C = g2() if q == "b_g2_query" else g1()
        if not bool(C.eq(getattr(pk, q), getattr(pk4, q)).all()):
            raise AssertionError(f".zkey key's {q} differs from phase 4's")
    log("zkey artifacts: " + json.dumps(dict(
        bytes=sizes, ms={k: ms[k] for k in (
            "write_r1cs", "write_wtns", "write_zkey", "read_r1cs",
            "read_wtns", "read_zkey", "from_zkey")})))

    # (b) proving: the .r1cs gives C, the .wtns the witness
    comp = CompiledR1CS(r1cs_z, dev)
    z_mont = fr().encode(z_z, dev)
    proof0 = prove_single(pk, comp, z_mont)  # first proof of this key
    splits = {"zkey": [], "phase4_key": []}
    for turn in ("phase4_key", "zkey", "zkey", "phase4_key") * 2:
        t = {}
        args = ((pk, comp, z_mont) if turn == "zkey"
                else (pk4, ctx["comp"], ctx["z_mont"]))
        before = {k: v.launches for k, v in _cuda.KERNELS.items()}
        proof = prove_single(*args, timings=t)
        t["total"] = sum(t.values())
        splits[turn].append(t)
        if turn == "zkey" and len(splits["zkey"]) == 1:
            warm_launches = {k: v.launches - before[k]
                             for k, v in _cuda.KERNELS.items()}
            warm = proof
    if not proof_bytes(proof0) == proof_bytes(warm) == proof_bytes(
            ctx["proof"]):
        raise AssertionError(".zkey key's proof differs from phase 4's")
    if dev.type == "cuda":
        if warm_launches != ctx["per_proof_launches"]:
            raise AssertionError(
                f".zkey proof launched {warm_launches}, phase 4's "
                f"{ctx['per_proof_launches']}")
        for k in ZKEY_KERNELS:
            if warm_launches[k] == 0:
                raise AssertionError(f".zkey proof never launched {k}")
    rng = np.random.default_rng(1010)
    r, s = (int.from_bytes(rng.bytes(40), "little") % R for _ in range(2))
    p_rs = prove_single(pk, comp, z_mont, r=r, s=s)
    if proof_bytes(p_rs) != proof_bytes(prove_single(pk4, comp, z_mont,
                                                     r=r, s=s)):
        raise AssertionError(".zkey key's r, s != 0 proof differs")
    if not verify(pk.vk, p_rs, pubs):
        raise AssertionError(".zkey key's r, s != 0 proof does not verify")
    log("zkey prove launches per warm proof: " + json.dumps(warm_launches))
    if dev.type == "cuda":
        with kernel_trace() as tr:
            traced = prove_single(pk, comp, z_mont)
            sync(dev)
        if proof_bytes(traced) != proof_bytes(warm):
            raise AssertionError("traced .zkey proof differs")
        ours = tr["per_kernel"]
        log("zkey prove kernel device ms per warm proof (phase 4's key in "
            "phase 4): " + json.dumps(dict(
                zkey=ours, zkey_total=sum(ours.values()),
                zkey_device_busy_ms=tr["busy_ms"],
                phase4={k: v for k, v in ctx["per_proof_ms"].items() if v},
                phase4_total=sum(ctx["per_proof_ms"].values()))))
    medians = {key: {ph: statistics.median(t[ph] for t in turns)
                     for ph in turns[0]} for key, turns in splits.items()}
    log("zkey prove phases ms (warm, r = s = 0, 4 turns each in ABBA "
        "order: medians, then the turns; phase 4's key in phase 4): "
        + json.dumps(dict(median=medians, turns=splits, phase4=ctx["warm"])))

    # (c) codecs
    vk = pk.vk
    text = timed("snarkjs", lambda: json.dumps(snarkjs.dump_proof(warm)))
    raw = timed("ark_bytes", ark_serde.proof_to_bytes, warm)
    eth = timed("eth", ethereum.proof_to_eth, warm)
    call = ethereum.solidity_calldata(warm, pubs)
    if (snarkjs.load_proof(json.loads(text)) != warm
            or ark_serde.proof_from_bytes(raw) != warm
            or ethereum.proof_from_eth(eth) != warm
            or ethereum.vk_from_eth(ethereum.vk_to_eth(vk)) != vk):
        raise AssertionError("a codec round trip changed the proof or vk")
    groups = json.loads(f"[{call}]")
    if ([len(g) for g in groups] != [2, 2, 2, len(pubs)]
            or [int(w, 16) for w in groups[3]] != [x % R for x in pubs]
            or int(groups[1][0][0], 16) != warm.b[0][1]):
        raise AssertionError("solidity calldata malformed")
    log(f"zkey codecs: snarkjs {len(text)} chars, ark {len(raw)} bytes, "
        f"calldata {len(call)} chars: every round trip equal")

    # (d) the verifier: n_fold statements of one circuit, one fold
    t0 = time.perf_counter()
    stmts = [statement(i) for i in range(n_fold)]
    t_witness = time.perf_counter() - t0
    for r1cs_i, _, _ in stmts:
        if (r1cs_i.a, r1cs_i.b, r1cs_i.c) != (r1cs.a, r1cs.b, r1cs.c):
            raise AssertionError("a fold statement has another circuit")
    publics = [[int(x) for x in p] for _, _, p in stmts]
    if len({tuple(p) for p in publics}) != n_fold:
        raise AssertionError("fold statements share publics")
    t0 = time.perf_counter()
    proofs = []
    for i, (_, z_i, _) in enumerate(stmts):
        r_i, s_i = (int.from_bytes(rng.bytes(40), "little") % R
                    for _ in range(2))
        proofs.append(prove_single(pk, comp, fr().encode(z_i, dev),
                                   r=r_i or 1, s=s_i or 1))
    t_prove = time.perf_counter() - t0
    cid = "sha256"
    cache = PvkCache()
    pvk = cache.get_or_prepare(
        cid, lambda: PreparedVerifyingKey.prepare(cid, vk, dev))
    split = {"prepare_inputs_batched": (vbatch, "prepare_inputs_batched"),
             "host_fold": (vbatch, "folded_pairs"),
             "pairing_check": (vbatch, "pairing_check")}
    with probes(dev, split) as fold_ms:
        ok = timed("fold", verify_batch, pvk, proofs, publics)
    if ok is not True:
        raise AssertionError(f"{n_fold}-proof fold is not true")
    singles = []
    for i in range(4):
        t0 = time.perf_counter()
        if not verify(vk, proofs[i], publics[i]):
            raise AssertionError(f"proof {i} does not verify")
        singles.append((time.perf_counter() - t0) * 1e3)
    bad = list(proofs)
    p = bad[tampered]
    bad[tampered] = Proof(a=p.a, b=p.b, c=rm.G1.add(p.c, G1_GENERATOR))
    if timed("fold_tampered", verify_batch, pvk, bad, publics) is not False:
        raise AssertionError("the fold with a false proof is true")
    n_each = min(n_each, n_fold)
    assert tampered < n_each
    verdicts = timed("verify_each", verify_each, pvk, bad[:n_each],
                     publics[:n_each])
    if [i for i, v in enumerate(verdicts) if not v] != [tampered]:
        raise AssertionError(f"verify_each names {verdicts}")
    bundle = timed("build_bundle", build_bundle, pvk, proofs, publics)
    swapped = json.loads(json.dumps(bundle))
    pairs = swapped["pairs"]
    pairs[0][1], pairs[1][1] = pairs[1][1], pairs[0][1]
    if (timed("check_bundle", check_bundle, bundle) is not True
            or check_bundle(swapped) is not False):
        raise AssertionError("bundle check wrong")
    # the job runner over stand-in jobs, its executor sharing the cache
    store = types.SimpleNamespace(load=lambda c: (None, pk))
    per = n_each // jobs
    items = list(zip(bad, publics))
    batch = [stand_in_job(cid, items[j * per : (j + 1) * per])
             for j in range(jobs)]
    runner = VerifyBatchRunner(VerifyExecutor(store, cache))
    outcomes = timed("run_batch", runner.run_batch, batch,
                     types.SimpleNamespace(circuit_id=cid))
    for j, (job, out) in enumerate(outcomes):
        if job is not batch[j]:
            raise AssertionError("run_batch reordered its jobs")
        if j == tampered // per:
            if not (isinstance(out, InvalidProofError)
                    and out.indices == [tampered % per]):
                raise AssertionError(f"job {j}: {out!r}")
        elif not (isinstance(out, dict) and out["verdicts"] == [True] * per):
            raise AssertionError(f"job {j}: {out!r}")
    sync(dev)
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    single = sorted(singles)
    median = (single[1] + single[2]) / 2
    log("zkey fold: " + json.dumps(dict(
        proofs=n_fold, each_and_runner_proofs=n_each, witness_s=t_witness,
        prove_s=t_prove,
        fold_ms=ms["fold"], fold_split_ms={k: fold_ms[k] for k in split},
        fold_tampered_ms=ms["fold_tampered"],
        verify_each_ms=ms["verify_each"], single_verify_ms=singles,
        single_verify_median_ms=median,
        singles_over_fold=n_fold * median / ms["fold"],
        build_bundle_ms=ms["build_bundle"],
        check_bundle_ms=ms["check_bundle"], run_batch_ms=ms["run_batch"],
        jobs=jobs, failed_job=tampered // per,
        failed_message=str(outcomes[tampered // per][1]))))
    log(f"zkey path launches: {json.dumps(launches)}")
    log(f"zkey: the .zkey key proves phase 4's proofs; the {n_fold}-proof "
        "fold is true, false with one false proof, whose index verify_each "
        "and the job runner name")
    return launches


def run_service(jobs, store, dev, batch_max=1, crs_cache=None):
    """Drive the port's job service as an API server would, below its HTTP
    layer: a JobQueue drained by a WorkerPool and, when batch_max > 1, a
    BatchScheduler placing batches on the card (500 ms linger). Submits
    `jobs`, waits (at most 10 minutes) for every one to reach a terminal
    state, stops the pool. Returns the scheduler (None with batching off)
    and the executor."""
    import asyncio

    from distributed_groth16_tpu_torch.scheduler import BatchScheduler
    from distributed_groth16_tpu_torch.service import (
        JobQueue, ProofExecutor, WorkerPool,
    )
    from distributed_groth16_tpu_torch.utils.config import SchedulerConfig

    async def main():
        q = JobQueue(bound=64, workers=2)
        ex = ProofExecutor(store, crs_cache=crs_cache, device=dev)
        sched = None
        if batch_max > 1:
            sched = BatchScheduler(
                ex, q, SchedulerConfig(batch_max=batch_max,
                                       batch_linger_ms=500.0),
                devices=[dev],
            )
        pool = WorkerPool(q, ex, workers=2, scheduler=sched)
        await pool.start()
        try:
            for job in jobs:
                q.submit(job)
            await asyncio.wait_for(
                asyncio.gather(*(job.wait() for job in jobs)), 600.0
            )
        finally:
            await pool.stop()
        return sched, ex

    return asyncio.run(main())


@contextmanager
def counted_batches():
    """While active, every BatchProver.run_batch call is counted and its
    outcomes kept: yields {"executions", "sizes", "faults"}, faults being
    the BatchFault outcomes (a batch-wide failure the scheduler would
    bisect)."""
    from distributed_groth16_tpu_torch.scheduler import batch_prover

    seen = {"executions": 0, "sizes": [], "faults": []}
    run = batch_prover.BatchProver.run_batch

    def counted(self, jobs, key, mesh):
        out = run(self, jobs, key, mesh)
        seen["executions"] += 1
        seen["sizes"].append(len(jobs))
        seen["faults"] += [o for _, o in out
                           if isinstance(o, batch_prover.BatchFault)]
        return out

    batch_prover.BatchProver.run_batch = counted
    try:
        yield seen
    finally:
        batch_prover.BatchProver.run_batch = run


@contextmanager
def copy_bytes():
    """While active, the mesh's gathers and scatters (parallel/mesh.py
    `_gather`, `_scatter`) are counted: yields {"gathered", "scattered",
    "peer"}, the bytes of the blocks of shards other than the king's that
    a gather brings onto the king's device and a scatter sends back, and
    of those the bytes that crossed between two distinct devices."""
    from distributed_groth16_tpu_torch.parallel import mesh as pmesh

    seen = {"gathered": 0, "scattered": 0, "peer": 0}
    gather, scatter = pmesh._gather, pmesh._scatter

    def nbytes(t):
        return t.numel() * t.element_size()

    def counted_gather(blocks):
        for b in blocks[1:]:
            seen["gathered"] += nbytes(b)
            if b.device != blocks[0].device:
                seen["peer"] += nbytes(b)
        return gather(blocks)

    def counted_scatter(x, devices):
        out = scatter(x, devices)
        for b in out[1:]:
            seen["scattered"] += nbytes(b)
            if b.device != x.device:
                seen["peer"] += nbytes(b)
        return out

    pmesh._gather, pmesh._scatter = counted_gather, counted_scatter
    try:
        yield seen
    finally:
        pmesh._gather, pmesh._scatter = gather, scatter


# phase 11's shard counts: the zk mesh proof over k shards of the n = 8
# parties (k = 1 is the one-shard path (b) runs), the batch over k = 4
SHARD_KS = (1, 2, 8)
SHARD_BATCH_K = 4
MULTICHIP_N = 8  # (g)'s parties, one a shard
# (f)'s d_msm scalars are below 2^SHARD_SCALAR_BITS: its 8-point MSMs
# take msm_batched's plain ladder, one step a scalar bit, and on the CPU
# shard a full 254-step ladder costs ~15 s of the script's time limit
SHARD_SCALAR_BITS = 16
# the kernels the sharded paths must launch (kernel 4 is not on a mesh)
SHARD_KERNELS = ("limb_add_g1", "limb_add_g2", "limb_double_g1",
                 "limb_double_g2", "limb_horner_g1", "limb_horner_g2")


def phase_shards(dev, ctx, pp, crs, inp, r, s, want_zk, z_monts, singles):
    """Phase 11 (d)-(f), (h): the parties mesh split over device shards
    (parallel/mesh.py), on phase 4's circuit with phase 6's CRS.
    (d) mesh_prove_zk at r, s != 0 over k in SHARD_KS shards of the
    n = 8 parties on `dev` (k = 1: one shard), each proof equal to
    prove_single(r, s)'s bytes (`want_zk`), each run under a device-only
    trace: for each k the wall ms, the device-busy ms, the launches per
    kernel and the bytes gathered and scattered in the round.
    (e) prove_batch of the first two statements over SHARD_BATCH_K
    shards, equal to prove_single's proofs (`singles`).
    (f) _mesh_dfft (the inverse, re-laid out and padded to 2m, and the
    forward left clear) and _mesh_dmsm_batched at m = 16, n = 8 over the
    shards (dev, cpu), each equal to the one-shard mesh on `dev` limb for
    limb.
    (g) examples/multichip.run(8): the zk step at m = 16 over 8 shards,
    one party a shard on the cards, printing the JAX line.
    (h) the cards: with two or more, (d) at k = 2 over two cards; with
    one, the shards share it.
    Counters zeroed before each run of (d) at k > 1 and of (e)-(h), read
    after; their sum is returned."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
    from distributed_groth16_tpu_torch.models.groth16 import mesh_prover
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops.curve import g1
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.ops.ntt import domain
    from distributed_groth16_tpu_torch.parallel import mesh as pmesh
    from distributed_groth16_tpu_torch.scheduler import batch_prover

    pk, comp = ctx["pk"], ctx["comp"]
    m, n = pk.domain_size, pp.n
    total = {k: 0 for k in _cuda.KERNELS}

    def counted(fn, trace=False):
        """fn() with the counters zeroed before and read after: (result,
        {wall_ms, device_busy_ms, launches, gathered, scattered, peer});
        with trace, under a device-only trace (busy ms on a card)."""
        for kern in _cuda.KERNELS.values():
            kern.launches = 0
        sync(dev)
        traced = trace and dev.type == "cuda"
        with copy_bytes() as moved, (
                kernel_trace(host_ops=False) if traced
                else nullcontext({"busy_ms": None})) as tr:
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        got = {k: v.launches for k, v in _cuda.KERNELS.items()}
        return out, dict(wall_ms=wall, device_busy_ms=tr["busy_ms"],
                         launches={k: v for k, v in got.items() if v},
                         **moved)

    def add(launches):
        for key, v in launches.items():
            total[key] += v

    def zk_over(mesh):
        return mesh_prover.mesh_prove_zk(pp, m, mesh, inp, pk, r, s)

    # (d) the zk mesh proof over k shards of the card
    per_k = {}
    for k in SHARD_KS:
        mesh = pmesh.PartyMesh((dev,) * k, n)
        proof, per_k[k] = counted(lambda: zk_over(mesh), trace=True)
        if proof_bytes(proof) != want_zk:
            raise AssertionError(f"mesh_prove_zk over {k} shards differs "
                                 "from prove_single(r, s)")
        if k > 1:
            add(per_k[k]["launches"])
    log("shards (d): mesh_prove_zk at r, s != 0 over k shards of "
        f"{dev}, each equal to prove_single(r, s): " + json.dumps(per_k))

    # (e) the batch prover over SHARD_BATCH_K shards
    mesh = pmesh.PartyMesh((dev,) * SHARD_BATCH_K, n)
    proofs, info = counted(
        lambda: batch_prover.prove_batch(pk, comp, pp, mesh, crs, z_monts))
    for j, (got, want) in enumerate(zip(proofs, singles)):
        if proof_bytes(got) != proof_bytes(want):
            raise AssertionError(f"batch proof {j} over {SHARD_BATCH_K} "
                                 "shards differs from prove_single's")
    add(info["launches"])
    log("shards (e): " + json.dumps(dict(
        batch=len(proofs), shards=SHARD_BATCH_K, **info)))

    # (f) two distinct devices, (dev, cpu), against the one-shard mesh
    cpu = torch.device("cpu")
    one, mixed = pmesh.make_mesh(n, dev), pmesh.PartyMesh((dev, cpu), n)
    small, B = 16, 2
    rng = np.random.default_rng(14)

    def shares(shape, bits=254):
        """Fr elements below 2^bits drawn with numpy, Montgomery on dev."""
        raw = rng.integers(0, 2**63, size=(int(np.prod(shape)), 4),
                           dtype=np.int64)
        ints = [int.from_bytes(v.tobytes(), "little") % fr().p
                % (1 << bits) for v in raw]
        return fr().encode(np.array(ints, dtype=object).reshape(shape), dev)

    def consts(size):
        d = domain(size)
        return ({x: d._live_wpows(x) for x in (dev, cpu)},
                {x: torch.as_tensor(d._size_inv, device=x)
                 for x in (dev, cpu)})

    (w16, inv16), (w32, _) = consts(small), consts(2 * small)
    x = shares((n, B, 3, small // pp.l))
    y = shares((n, B, 3, 2 * small // pp.l))
    npts = min(small // pp.l, int(crs[0].s.shape[0]))
    bases = torch.stack([c.s[:npts] for c in crs])[:, None]
    sc = shares((n, B, npts), SHARD_SCALAR_BITS)
    checks = {}

    def both(fn):
        want = fn(one)
        got, checks[fn.__name__] = counted(lambda: fn(mixed))
        add(checks[fn.__name__]["launches"])
        if got.device != dev or not torch.equal(got, want):
            raise AssertionError(f"{fn.__name__} over ({dev}, cpu) differs "
                                 "from the one-shard mesh")

    def dfft_inverse(me):
        return me.gather(pmesh._mesh_dfft(
            me.shard(x), pp, 4, True, True, 2, False, False, w16, inv16))

    def dfft_forward_clear(me):
        return pmesh._mesh_dfft(me.shard(y), pp, 5, False, False, 1, False,
                                True, w32, None)

    def dmsm_batched(me):
        return pmesh._mesh_dmsm_batched(g1(), me.shard(bases), me.shard(sc),
                                        pp)

    for fn in (dfft_inverse, dfft_forward_clear, dmsm_batched):
        both(fn)
    if dev != cpu and min(c["peer"] for c in checks.values()) == 0:
        raise AssertionError("the (dev, cpu) mesh moved no bytes between "
                             "its devices")
    log(f"shards (f): m = {small}, n = {n} over ({dev}, cpu) equal to the "
        "one-shard mesh limb for limb: " + json.dumps(checks))

    # (g) the multi-device dry run, one party a shard
    res, info = counted(lambda: multichip_dry_run(dev))
    add(info["launches"])
    log("shards (g): " + json.dumps(dict(res, **info)))

    # (h) the cards this machine has
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= 2:
        mesh = pmesh.PartyMesh(
            tuple(torch.device("cuda", j) for j in range(2)), n)
        proof, info = counted(lambda: zk_over(mesh), trace=True)
        if proof_bytes(proof) != want_zk:
            raise AssertionError("mesh_prove_zk over two cards differs")
        add(info["launches"])
        log("shards (h): " + json.dumps(dict(
            cards=cards, shards=[str(d) for d in mesh.devices], **info)))
    else:
        log(f"shards (h): cards: {cards}; the shards of (d), (e) and (g) "
            "share one device, so no copy crossed between cards")
    return total


def multichip_dry_run(dev, n=MULTICHIP_N) -> dict:
    """Phase 11 (g): examples/multichip.run(n) with its shards on `dev`'s
    kind of device; checks the JAX line it prints and one shard a party
    (card j mod the card count) with the cores on the king. Returns
    run()'s dict."""
    from distributed_groth16_tpu_torch.examples import multichip

    text = io.StringIO()
    with redirect_stdout(text):
        res = multichip.run(n, dev)
    if (f"dryrun_multichip: n={n} parties (l={n // 4}) over {n}-device "
            "mesh") not in text.getvalue():
        raise AssertionError("multichip printed no JAX line: "
                             + text.getvalue()[-2000:])
    want = [str(d) for d in multichip.shard_devices(n, dev)]
    if res["shards"] != want or res["output_device"] != want[0]:
        raise AssertionError(f"multichip shards {res['shards']}, "
                             f"expected {want}")
    log("shards (g): " + text.getvalue().strip())
    return res


def phase_batch(dev, ctx, statement=fold_statement, B=8, small=3,
                n_jobs=8, batch_max=4):
    """Phase 11: the batch and mesh provers with the n = 8 parties on one
    tensor axis of the card, and the job service below the HTTP layer, on
    phase 4's circuit.
    (a) B distinct statements (`statement(i)`: r1cs, witness, publics)
    proved by prove_batch through build_batch_mesh_prover over the CRS
    packed once from phase 4's loaded key (phase 6's pack): each proof
    verifies and equals prove_single's; then a batch of `small` (padded
    to a power of two). Counters zeroed before the B-batch and read after
    (launches_batch); the same batch again under the profiler (kernel
    device ms, busy ms) and with its parts probed (the split).
    (b) mesh_prove_zk at r, s != 0 equal to prove_single(r, s).
    (c) the service: a CircuitStore in a temporary directory holding the
    circuit (setup on the card), ProofExecutor + JobQueue + WorkerPool +
    BatchScheduler(batch_max, 500 ms linger) on the card: n_jobs "prove"
    jobs carrying .wtns bytes all DONE in at most ceil(n_jobs /
    batch_max) batched executions with no BatchFault, each proof equal to
    prove_single's; then, batching off, one "prove" job (counters zeroed
    before it: kernel 4's launches) and one "mpc_prove" job through the
    per-job funnel, both equal to prove_single's.
    Then (d)-(h), the mesh over device shards (phase_shards).
    Returns the launch counts of (a)'s B-batch and of (c)'s per-job prove,
    (a)'s kernel device ms, and the launches of (d)-(h)."""
    import numpy as np
    import torch

    from distributed_groth16_tpu_torch.api.store import CircuitStore
    from distributed_groth16_tpu_torch.examples.nonlocal_sha256 import (
        proof_bytes,
    )
    from distributed_groth16_tpu_torch.frontend.ark_serde import (
        proof_from_bytes,
    )
    from distributed_groth16_tpu_torch.frontend.readers import (
        write_r1cs, write_wtns,
    )
    from distributed_groth16_tpu_torch.models.groth16 import (
        QAP, CompiledR1CS, ProvingKey, pack_from_witness, pack_proving_key,
        prove_single, verify,
    )
    from distributed_groth16_tpu_torch.models.groth16 import mesh_prover
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.ops import msm as tmsm
    from distributed_groth16_tpu_torch.ops.constants import R
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.parallel import mesh as pmesh
    from distributed_groth16_tpu_torch.parallel.pss import (
        PackedSharingParams, pss,
    )
    from distributed_groth16_tpu_torch.scheduler import batch_prover
    from distributed_groth16_tpu_torch.service import JobState, ProofJob

    assert small <= B and n_jobs <= B
    pk, comp, r1cs = ctx["pk"], ctx["comp"], ctx["r1cs"]
    pp = pss(2)
    mesh = pmesh.make_mesh(pp.n, dev)
    t0 = time.perf_counter()
    stmts = [statement(i) for i in range(B)]
    for s_r1cs, _, _ in stmts:
        if (s_r1cs.a, s_r1cs.b, s_r1cs.c) != (r1cs.a, r1cs.b, r1cs.c):
            raise AssertionError("a statement is not phase 4's circuit")
    z_monts = [fr().encode(z, dev) for _, z, _ in stmts]
    t_witness = time.perf_counter() - t0
    crs = ctx.get("point_crs")
    if crs is None:  # phase 6 did not run: pack the loaded key here
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "pk.npz")
            pk.save(path)
            crs = pack_proving_key(ProvingKey.load(path, device=dev), pp)
    m = pk.domain_size
    cmax = max(int(crs[0].s.shape[0]), int(crs[0].w.shape[0]),
               int(crs[0].u.shape[0]))
    log(f"batch path: m={m} l={pp.l} n={pp.n} B={B}, local tree MSMs per "
        f"batch n*(3B+B)={pp.n * 4 * B} at {cmax} points, witnesses "
        f"{t_witness:.1f} s")

    # (a) B proofs in one batch, counters zeroed just before
    prover = mesh_prover.build_batch_mesh_prover(pp, m, mesh, B)
    for k in _cuda.KERNELS.values():
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    proofs = batch_prover.prove_batch(pk, comp, pp, mesh, crs, z_monts[:B],
                                      prover=prover)
    sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    singles, t_single = [], []
    for zm in z_monts[:B]:
        sync(dev)
        t0 = time.perf_counter()
        singles.append(prove_single(pk, comp, zm))
        sync(dev)
        t_single.append((time.perf_counter() - t0) * 1e3)
    for j, (proof, want) in enumerate(zip(proofs, singles)):
        if proof_bytes(proof) != proof_bytes(want):
            raise AssertionError(f"batch proof {j} differs from prove_single's")
        if not verify(pk.vk, proof, stmts[j][2]):
            raise AssertionError(f"batch proof {j} does not verify")
    if len({proof_bytes(p) for p in proofs}) != B:
        raise AssertionError("two jobs of the batch got one proof")
    if dev.type == "cuda":
        for k in ("limb_add_g1", "limb_add_g2", "limb_double_g1",
                  "limb_double_g2", "limb_horner_g1", "limb_horner_g2"):
            if launches[k] == 0:
                raise AssertionError(f"the batch path never launched {k}")
    t0 = time.perf_counter()
    small_proofs = batch_prover.prove_batch(pk, comp, pp, mesh, crs,
                                            z_monts[:small])
    sync(dev)
    t_small = (time.perf_counter() - t0) * 1e3
    if len(small_proofs) != small or any(
            proof_bytes(p) != proof_bytes(w)
            for p, w in zip(small_proofs, singles)):
        raise AssertionError(f"the batch of {small} differs from prove_single")
    log("batch path (a): " + json.dumps(dict(
        batch=B, wall_ms=wall, per_proof_ms=wall / B,
        prove_single_warm_ms=t_single,
        mpc_round_ms_phase6=ctx.get("mpc_round", {}).get("round"),
        small=small, padded_to=batch_prover._next_pow2(small),
        small_wall_ms=t_small, peak_bytes=peak, launches_batch=launches)))

    # the same batch under the profiler: kernel device ms and busy time
    per_kernel = {k: 0.0 for k in _cuda.KERNELS}
    if dev.type == "cuda":
        with kernel_trace(host_ops=False) as tr:
            t0 = time.perf_counter()
            again = batch_prover.prove_batch(pk, comp, pp, mesh, crs,
                                             z_monts[:B], prover=prover)
            sync(dev)
            tr["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if not tr["per_kernel"]:
            raise AssertionError("torch.profiler recorded no kernel")
        per_kernel.update(tr["per_kernel"])
        if [proof_bytes(p) for p in again] != [proof_bytes(p) for p in proofs]:
            raise AssertionError("the profiled batch gave other proofs")
        log("batch path kernel device ms per batch: " + json.dumps(dict(
            method="torch.profiler", per_kernel=per_kernel,
            total=sum(per_kernel.values()), by_columns=tr["by_columns"],
            device_busy_ms=tr["busy_ms"], wall_ms=tr["wall_ms"],
            busy_share=tr["busy_ms"] / tr["wall_ms"])))

    # and with its parts probed (the device drained around each call; on
    # a card each part's own peak above what it found allocated)
    peaks = {} if dev.type == "cuda" else None
    with probes(dev, {
        "qap": (CompiledR1CS, "qap"),
        "qap_pss": (QAP, "pss"),
        "witness_packs": (batch_prover, "pack_from_witness"),
        "stage1_dfft": (pmesh, "_fft1_local"),
        "king_tail": (pmesh, "_king_tail_array"),
        "king_clear": (pmesh, "_king_clear_array"),
        "king_combine_h": (mesh_prover, "king_combine_h"),
        "local_tree_msms": (tmsm, "msm_batched"),
        "king_unpackexp": (PackedSharingParams, "unpackexp"),
        "demux": (batch_prover, "reassemble_proof"),
    }, peaks) as split:
        t0 = time.perf_counter()
        batch_prover.prove_batch(pk, comp, pp, mesh, crs, z_monts[:B],
                                 prover=prover)
        sync(dev)
        split["wall"] = (time.perf_counter() - t0) * 1e3
    log("batch path split ms: " + json.dumps(split))
    if peaks is not None:
        log("batch path peak bytes by part: " + json.dumps(peaks))

    # (b) the zero-knowledge mesh proof
    rng = np.random.default_rng(2026)
    r = int.from_bytes(rng.bytes(40), "little") % R
    s = int.from_bytes(rng.bytes(40), "little") % R
    zm = ctx["z_mont"]
    qs = comp.qap(zm).pss(pp)
    inp = mesh_prover.MeshProverInputs(
        qap_a=torch.stack([q.a for q in qs]),
        qap_b=torch.stack([q.b for q in qs]),
        qap_c=torch.stack([q.c for q in qs]),
        a_share=pack_from_witness(pp, zm[1:]),
        ax_share=pack_from_witness(pp, zm[r1cs.num_instance:]),
        **{f: torch.stack([getattr(c, f) for c in crs])
           for f in ("s", "u", "v", "w", "h")},
    )
    t0 = time.perf_counter()
    zk = mesh_prover.mesh_prove_zk(pp, m, mesh, inp, pk, r, s)
    t_zk = (time.perf_counter() - t0) * 1e3
    want_zk = proof_bytes(prove_single(pk, comp, zm, r=r, s=s))
    if proof_bytes(zk) != want_zk:
        raise AssertionError("mesh_prove_zk differs from prove_single(r, s)")
    if not verify(pk.vk, zk, ctx["pubs"]):
        raise AssertionError("mesh_prove_zk's proof does not verify")
    log(f"batch path (b): mesh_prove_zk at r, s != 0 equals "
        f"prove_single(r, s), {t_zk:.1f} ms")

    # (d)-(h) the mesh over device shards
    launches_shards = phase_shards(dev, ctx, pp, crs, inp, r, s, want_zk,
                                   z_monts[:2], singles[:2])

    # (c) the service on the card
    with tempfile.TemporaryDirectory() as tmp:
        store = CircuitStore(tmp, device=dev)
        t0 = time.perf_counter()
        cid = store.save_circuit("sha256", write_r1cs(r1cs), b"")
        t_save = (time.perf_counter() - t0) * 1e3
        wtns = [write_wtns(z) for _, z, _ in stmts[:n_jobs]]
        jobs = [ProofJob(kind="prove", circuit_id=cid,
                         fields={"witness_file": w}, l=pp.l) for w in wtns]
        with counted_batches() as seen:
            t0 = time.perf_counter()
            sched, ex = run_service(jobs, store, dev, batch_max=batch_max)
            t_jobs = (time.perf_counter() - t0) * 1e3
        stats = sched.stats()
        bound = -(-n_jobs // batch_max)
        for j, job in enumerate(jobs):
            if job.state is not JobState.DONE:
                raise AssertionError(f"service job {j}: {job.error}")
            got = proof_from_bytes(bytes(job.result["proof"]))
            if proof_bytes(got) != proof_bytes(singles[j]):
                raise AssertionError(f"service job {j} differs from "
                                     "prove_single's")
        if seen["faults"] or stats["jobsPoisoned"]:
            raise AssertionError(f"batch faults: {seen['faults']}")
        if seen["executions"] > bound or stats["batchesDispatched"] > bound:
            raise AssertionError(f"{seen['executions']} batched executions "
                                 f"for {n_jobs} jobs (at most {bound})")
        log("batch service: " + json.dumps(dict(
            jobs=n_jobs, batch_max=batch_max, save_circuit_ms=t_save,
            all_jobs_ms=t_jobs, executions=seen["executions"],
            sizes=seen["sizes"], scheduler=stats,
            phases=[job.result["phases"] for job in jobs],
            device_memory=[job.to_dict()["metrics"].get("deviceMemory")
                           for job in jobs[:1]])))

        # batching off: the per-job funnel, a prove job then an mpc_prove
        one = ProofJob(kind="prove", circuit_id=cid, l=pp.l,
                       fields={"witness_file": write_wtns(ctx["z"])})
        for k in _cuda.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        run_service([one], store, dev, crs_cache=ex.crs_cache)
        t_one = (time.perf_counter() - t0) * 1e3
        launches_job = {k: v.launches for k, v in _cuda.KERNELS.items()}
        mpc = ProofJob(kind="mpc_prove", circuit_id=cid, l=pp.l,
                       fields={"witness_file": write_wtns(ctx["z"])})
        t0 = time.perf_counter()
        run_service([mpc], store, dev, crs_cache=ex.crs_cache)
        t_mpc = (time.perf_counter() - t0) * 1e3
    for job in (one, mpc):
        if job.state is not JobState.DONE:
            raise AssertionError(f"per-job {job.kind}: {job.error}")
        got = proof_from_bytes(bytes(job.result["proof"]))
        if proof_bytes(got) != proof_bytes(ctx["proof"]):
            raise AssertionError(f"per-job {job.kind} differs from "
                                 "prove_single's")
    if dev.type == "cuda" and launches_job["ntt_small"] == 0:
        raise AssertionError("the per-job prove never launched kernel 4")
    log("batch service per-job funnel: " + json.dumps(dict(
        prove_ms=t_one, prove_phases=one.result["phases"],
        mpc_prove_ms=t_mpc, mpc_prove_phases=mpc.result["phases"],
        launches_prove_job=launches_job)))
    log(f"batch: {B} + {small} batched proofs, the zk mesh proof over "
        f"1, 2 and 8 shards and {n_jobs + 2} service jobs equal "
        "prove_single's")
    return launches, launches_job, per_kernel, launches_shards


def artifact_names(blob: bytes) -> tuple:
    """The event names of a profiler artifact's Chrome trace and the
    kernels-line rows of its device kernels."""
    import tarfile

    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        member = [m for m in tar.getmembers()
                  if m.name.endswith("/trace.json")]
        if len(member) != 1:
            raise AssertionError(f"artifact holds {tar.getnames()}")
        trace = json.load(tar.extractfile(member[0]))
    events = trace.get("traceEvents", [])
    names = {e.get("name") for e in events}
    rows = {}
    for e in events:
        row = kernel_row(e.get("name", "")) if e.get("cat") == "kernel" else None
        if row:
            rows[row] = rows.get(row, 0) + 1
    return names, rows, len(events)


HTTP_KERNELS = ("limb_add_g1", "limb_add_g2", "limb_horner_g1",
                "limb_horner_g2", "ntt_small")
PROFILE_KERNELS = ("limb_add_g1", "limb_horner_g1", "ntt_small")


def phase_http(dev, ctx, n_batch=4, n_router=4, profile_s=3.0, n_pairs=3):
    """Phase 12: the serving plane above the job service, on phase 4's
    circuit and witness, over HTTP on localhost. (a) Replica 1, an
    ApiServer on the card with batching off: /save_circuit (setup on the
    card), /create_proof_without_mpc and /create_proof_with_naive_mpc
    (the per-job funnel: prove_single, and the 8-party round), each proof
    equal to phase 4's prove_single proof, the naive-MPC job's trace one
    pid track per party and its criticalPath over the 8 parties (GET
    /jobs/{id}, /jobs/{id}/trace); /verify_proof true, and false
    with a public input plus one; /healthz, /readyz (buildInfo names the
    card), /metrics (dg16_build_info, device_memory_bytes). (b) Replica 2
    on the same card and store, batching on (batch_max 4): /readyz
    devices 1; n_batch /jobs/prove all DONE, each result equal. (c) A
    profiler capture on replica 1 (POST /profile) while a prove job runs:
    its .tar.gz holds kernels 1, 3 and 4 and the job's spans. (d) A
    FleetRouter over both replicas: n_router jobs through its /jobs/prove
    DONE with equal proofs, landing on both replicas; then replica 2
    drained through the router, and n_pairs times one job direct to
    replica 1 beside one through the router (each job's submit-to-DONE
    beside its runtime on the replica, and the router's spans). (e) The CLI
    in a subprocess: `prove` against replica 1 writes the same proof
    bytes, `fleet status` against the router prints both replicas.
    Returns the kernels' launches over the phase."""
    import asyncio

    import aiohttp
    import torch
    from aiohttp import web

    from distributed_groth16_tpu_torch.api.server import ApiServer
    from distributed_groth16_tpu_torch.api.store import CircuitStore
    from distributed_groth16_tpu_torch.fleet import FleetRouter
    from distributed_groth16_tpu_torch.fleet.router import ROUTER_PID
    from distributed_groth16_tpu_torch.frontend.ark_serde import (
        proof_to_bytes,
    )
    from distributed_groth16_tpu_torch.frontend.readers import (
        write_r1cs, write_wtns,
    )
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.utils.config import (
        FleetConfig, SchedulerConfig, ServiceConfig, TenantConfig,
    )

    want = proof_to_bytes(ctx["proof"])
    r1cs_blob, wtns = write_r1cs(ctx["r1cs"]), write_wtns(ctx["z"])
    pubs = [str(x) for x in ctx["pubs"]]
    out = {"route_ms": {}}

    async def start(app):
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        return runner, f"http://127.0.0.1:{runner.addresses[0][1]}"

    async def main(tmp):
        http = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=600))

        async def call(name, method, url, **kw):
            t0 = time.perf_counter()
            async with http.request(method, url, **kw) as resp:
                body = (await resp.read() if name == "profile_artifact"
                        else await resp.text() if name == "metrics"
                        else await resp.json(content_type=None))
                status = resp.status
            out["route_ms"].setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return status, body

        async def done(base, jid, poll_s=0.01):
            while True:
                status, body = await call("job_status", "GET",
                                          f"{base}/jobs/{jid}")
                if status == 200 and body["state"] in ("DONE", "FAILED",
                                                       "CANCELLED"):
                    if body["state"] != "DONE":
                        raise AssertionError(f"job {jid}: {body}")
                    return body
                await asyncio.sleep(poll_s)

        async def result(base, jid):
            status, body = await call("job_result", "GET",
                                      f"{base}/jobs/{jid}/result")
            if status != 200 or bytes(body["proof"]) != want:
                raise AssertionError(f"job {jid}'s proof differs from "
                                     f"prove_single's: {status}")

        def job_form():
            return {"circuit_id": cid, "witness_file": wtns}

        r1 = ApiServer(CircuitStore(tmp, device=dev),
                       ServiceConfig(workers=2, replica_id="r-1"),
                       SchedulerConfig(batch_max=1), device=dev)
        run1, url1 = await start(r1.app())
        runners = [run1]
        try:
            # (a) the legacy routes on replica 1
            status, body = await call(
                "save_circuit", "POST", f"{url1}/save_circuit",
                data={"circuit_name": "sha256", "r1cs_file": r1cs_blob})
            if status != 200:
                raise AssertionError(f"save_circuit: {body}")
            cid = body["circuitId"]
            out["save_setup_ms"] = body["timeTaken"]
            for route in ("create_proof_without_mpc",
                          "create_proof_with_naive_mpc"):
                status, body = await call(route, "POST", f"{url1}/{route}",
                                          data=job_form())
                if status != 200 or bytes(body["proof"]) != want:
                    raise AssertionError(f"{route} differs from "
                                         f"prove_single's: {status}")
                out[f"{route}_phases"] = body.get("phases")
            # the naive-MPC job's party tracks: its trace holds one pid
            # track per party and its critical path covers the n parties
            jobs = [j for j in r1.queue.jobs.values()
                    if j.kind == "mpc_prove"]
            if len(jobs) != 1:
                raise AssertionError(f"{len(jobs)} naive-MPC jobs")
            status, st = await call("job_status", "GET",
                                    f"{url1}/jobs/{jobs[0].id}")
            status_t, tr = await call("job_trace", "GET",
                                      f"{url1}/jobs/{jobs[0].id}/trace")
            if status != 200 or status_t != 200:
                raise AssertionError(f"naive-MPC job: {status} {status_t}")
            cp = st["metrics"]["criticalPath"]
            check_tracks("naive-MPC job", span_names(
                e for e in tr["traceEvents"] if e.get("ph") == "X"), 8, cp)
            out["mpc_job_critical_path"] = cp
            for publics, valid in ((pubs, True),
                                   ([str(int(pubs[0]) + 1)] + pubs[1:],
                                    False)):
                status, body = await call(
                    "verify_proof", "POST", f"{url1}/verify_proof",
                    json={"circuitId": cid, "proof": list(want),
                          "publicInputs": publics})
                if status != 200 or body["isValid"] is not valid:
                    raise AssertionError(f"verify_proof: {status} {body}")
            status, health = await call("healthz", "GET", f"{url1}/healthz")
            if status != 200 or health["status"] != "ok":
                raise AssertionError(f"/healthz: {health}")
            status, ready = await call("readyz", "GET", f"{url1}/readyz")
            build = ready["buildInfo"]
            card = torch.cuda.get_device_name(0) if dev.type == "cuda" \
                else None
            if status != 200 or card is not None and (
                    build["backend"], build["deviceKind"]) != ("cuda", card):
                raise AssertionError(f"/readyz: {ready}")
            out["build_info"] = build

            # (b) replica 2: same card and store, batching on
            r2 = ApiServer(CircuitStore(tmp, device=dev),
                           ServiceConfig(workers=2, replica_id="r-2"),
                           SchedulerConfig(batch_max=n_batch,
                                           batch_linger_ms=500.0),
                           device=dev)
            run2, url2 = await start(r2.app())
            runners.append(run2)
            status, ready2 = await call("readyz", "GET", f"{url2}/readyz")
            if status != 200 or ready2["devices"] != 1:
                raise AssertionError(f"replica 2 /readyz: {ready2}")
            t0 = time.perf_counter()
            ids = []
            for _ in range(n_batch):
                status, body = await call("jobs_prove", "POST",
                                          f"{url2}/jobs/prove",
                                          data=job_form())
                if status != 202:
                    raise AssertionError(f"/jobs/prove: {status} {body}")
                ids.append(body["jobId"])
            for jid in ids:
                await done(url2, jid)
            out["batch_submit_to_last_done_ms"] = (
                time.perf_counter() - t0) * 1e3
            for jid in ids:
                await result(url2, jid)
            _, st2 = await call("stats", "GET", f"{url2}/stats")
            out["batch_scheduler"] = {
                k: st2["scheduler"].get(k)
                for k in ("batchesDispatched", "jobsBatched", "jobsPoisoned")}

            # (c) a profiler capture on replica 1 while a prove job runs
            status, cap = await call("profile_start", "POST",
                                     f"{url1}/profile",
                                     json={"durationS": profile_s})
            if status != 202:
                raise AssertionError(f"POST /profile: {status} {cap}")
            status, busy = await call("profile_start", "POST",
                                      f"{url1}/profile",
                                      json={"durationS": 1})
            if status != 409:
                raise AssertionError(f"a second capture got {status}")
            t0 = time.perf_counter()
            status, body = await call("jobs_prove", "POST",
                                      f"{url1}/jobs/prove", data=job_form())
            await done(url1, body["jobId"])
            job_s = time.perf_counter() - t0
            await result(url1, body["jobId"])
            while True:
                status, blob = await call("profile_artifact", "GET",
                                          f"{url1}/profile/{cap['id']}")
                if status != 202:
                    break
                await asyncio.sleep(0.05)
            if status != 200:
                raise AssertionError(f"GET /profile/{cap['id']}: {status}")
            t0 = time.perf_counter()
            names, rows, n_events = artifact_names(blob)
            missing = ({"job", "load", "witness", "prove"} - names) | (
                set(PROFILE_KERNELS) - set(rows) if dev.type == "cuda"
                else set())
            if missing:
                raise AssertionError(f"the capture lacks {sorted(missing)}")
            _, prof = await call("profile_status", "GET", f"{url1}/profile")
            out["profile"] = dict(
                artifact_bytes=len(blob), events=n_events,
                kernel_events=rows, job_s_under_capture=job_s,
                read_s=time.perf_counter() - t0,
                capture=prof["captures"][-1])

            # (d) the fleet router over both replicas
            router = FleetRouter(FleetConfig(replicas=((url1, None),
                                                       (url2, None)),
                                             poll_s=0.2), TenantConfig())
            run3, url3 = await start(router.app())
            runners.append(run3)
            while router.registry.active_count() < 2:
                await asyncio.sleep(0.05)
            before = []
            for url in (url1, url2):
                _, st = await call("stats", "GET", f"{url}/stats")
                before.append(st["queue"]["submitted"])
            t0 = time.perf_counter()
            ids = []
            for _ in range(n_router):
                status, body = await call("router_jobs_prove", "POST",
                                          f"{url3}/jobs/prove",
                                          data=job_form(),
                                          headers={"X-DG16-Tenant": "smoke"})
                if status != 202:
                    raise AssertionError(f"router: {status} {body}")
                ids.append(body["jobId"])
            for jid in ids:
                await done(url3, jid)
            out["router_submit_to_last_done_ms"] = (
                time.perf_counter() - t0) * 1e3
            for jid in ids:
                await result(url3, jid)
            landed = []
            for url, b in zip((url1, url2), before):
                _, st = await call("stats", "GET", f"{url}/stats")
                landed.append(st["queue"]["submitted"] - b)
            if sum(landed) != n_router or 0 in landed:
                raise AssertionError(f"router jobs landed {landed}")
            _, fleet = await call("fleet_stats", "GET", f"{url3}/fleet/stats")
            if sorted(r["replicaId"] for r in fleet["replicas"]) != \
                    ["r-1", "r-2"]:
                raise AssertionError(f"/fleet/stats: {fleet['replicas']}")
            out["router_landed"] = dict(zip(("r-1", "r-2"), landed))
            out["fleet_replicas"] = [
                {k: r[k] for k in ("replicaId", "state", "score", "devices",
                                   "version")} for r in fleet["replicas"]]
            # the router's overhead: replica 2 drained, one job straight
            # to replica 1 beside one through the router (it lands there)
            status, body = await call("fleet_drain", "POST",
                                      f"{url3}/fleet/drain/r-2")
            if status != 200:
                raise AssertionError(f"fleet drain: {status} {body}")
            # each job's submit-to-DONE beside its own runtime on the
            # replica (the DTO's startedAt to finishedAt), and a routed
            # job's router-tier spans (admission, queue, dispatch)
            walls = {}
            for name, base in (("direct", url1), ("routed", url3)) * n_pairs:
                t0 = time.perf_counter()
                _, body = await call("overhead_submit", "POST",
                                     f"{base}/jobs/prove", data=job_form())
                dto = await done(base, body["jobId"])
                wall = (time.perf_counter() - t0) * 1e3
                run = (dto["finishedAt"] - dto["startedAt"]) * 1e3
                rec = dict(wall_ms=wall, runtime_ms=run,
                           beyond_runtime_ms=wall - run, phases=dto["phases"])
                if name == "routed":
                    _, tr = await call(
                        "fleet_job_trace", "GET",
                        f"{url3}/fleet/jobs/{body['jobId']}/trace")
                    spans = {}
                    for e in tr["traceEvents"]:
                        if e.get("pid") == ROUTER_PID and e.get("ph") == "X":
                            spans[e["name"]] = spans.get(e["name"], 0.0) + \
                                e["dur"] / 1e3
                    rec["router_spans_ms"] = spans
                walls.setdefault(name, []).append(rec)
                await result(base, body["jobId"])
            out["submit_to_done"] = walls

            # (e) the CLI in a subprocess
            with tempfile.TemporaryDirectory() as d:
                wpath, ppath = os.path.join(d, "w.wtns"), os.path.join(
                    d, "proof.bin")
                with open(wpath, "wb") as f:
                    f.write(wtns)
                cli = [sys.executable, "-m",
                       "distributed_groth16_tpu_torch.api.cli"]
                here = os.path.dirname(os.path.abspath(__file__))
                t0 = time.perf_counter()
                proc = await asyncio.create_subprocess_exec(
                    *cli, "--url", url1, "prove", "--circuit-id", cid,
                    "--witness", wpath, "--out", ppath, cwd=here,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE)
                so, se = await proc.communicate()
                out["cli_prove_ms"] = (time.perf_counter() - t0) * 1e3
                if proc.returncode != 0:
                    raise AssertionError(f"cli prove: {se.decode()[-2000:]}")
                with open(ppath, "rb") as f:
                    if f.read() != want:
                        raise AssertionError("the CLI's proof differs")
                proc = await asyncio.create_subprocess_exec(
                    *cli, "--url", url3, "fleet", "status", cwd=here,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE)
                so, se = await proc.communicate()
                table = so.decode()
                if proc.returncode != 0 or "r-1" not in table \
                        or "r-2" not in table:
                    raise AssertionError(f"cli fleet status: {table} "
                                         f"{se.decode()[-2000:]}")
                out["cli_fleet_status"] = table.splitlines()

            _, metrics = await call("metrics", "GET", f"{url1}/metrics")
        finally:
            await http.close()
            for runner in reversed(runners):
                await runner.cleanup()
        for series in ("dg16_build_info{", "device_memory_bytes{"):
            if series not in metrics and (dev.type == "cuda"
                                          or series.startswith("dg16")):
                raise AssertionError(f"/metrics lacks {series}")

    saved = os.environ.get("DG16_DEVMEM_SAMPLE_S")
    os.environ["DG16_DEVMEM_SAMPLE_S"] = "0.5"
    for k in _cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            asyncio.run(main(tmp))
    finally:
        if saved is None:
            del os.environ["DG16_DEVMEM_SAMPLE_S"]
        else:
            os.environ["DG16_DEVMEM_SAMPLE_S"] = saved
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        for k in HTTP_KERNELS:
            if launches[k] == 0:
                raise AssertionError(f"the HTTP path never launched {k}")
    out["route_ms"] = {k: dict(n=len(v), median=statistics.median(v),
                               max=max(v))
                       for k, v in out["route_ms"].items()}
    out["launches_http"] = launches
    log("http: " + json.dumps(out))
    n = 2 + n_batch + 1 + n_router + 2 * n_pairs + 1
    log(f"http: {n} proofs over HTTP equal prove_single's")
    return launches


# phase 13: the registry's quick sizes, their warm reps, and the share of
# its roof above which a record's work model counts more than its inputs
# need
PERF_REPS = 3
PERF_MAX_UTILIZATION = 1.05


def phase_perf(dev, reps=PERF_REPS):
    """Phase 13: the perf observatory on the card. The kernel counters
    zeroed, then perf.run_suite(quick=True) in-process over every
    registered case; fails on an errored record, a kernel that no case
    launched (over the phase, and in the records' own `launches`), or a
    device record without a work model or above PERF_MAX_UTILIZATION of
    its roof. Then the document, written to a temporary directory, is
    read by the CLI's `perf top`, `perf diff --markdown` (against itself:
    every ratio 1.0) and `perf roofline --run`, and gated by benchgate:
    --write-baseline, --check of the same document (exit 0), --check of a
    copy with every median x3 (exit 1); each a subprocess, started
    together where they do not depend on one another. Logs each record's
    median, items/s, utilization and launches, the build's seconds and
    the phase's. Returns the launches over the phase."""
    from distributed_groth16_tpu_torch.ops import _cuda
    from distributed_groth16_tpu_torch.telemetry import perf

    t0 = time.perf_counter()
    for k in _cuda.KERNELS.values():
        k.launches = 0
    run = perf.run_suite(quick=True, device=dev, reps=reps)
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    suite_s = time.perf_counter() - t0
    recs = run["kernels"]
    errors = {k: r["error"] for k, r in recs.items() if "error" in r}
    if errors:
        raise AssertionError(f"perf: errored records {errors}")
    idle = sorted(k for k, v in launches.items() if v == 0)
    in_records = set().union(*(r["launches"] for r in recs.values()))
    if idle or in_records != set(_cuda.KERNELS):
        raise AssertionError(
            f"perf: kernels never launched: over the phase {idle}, in the "
            f"records {sorted(set(_cuda.KERNELS) - in_records)}")
    for key, r in sorted(recs.items()):
        att = r["roofline"]
        if not r["host"] and (r["cost"] is None or att is None
                              or att["utilization"] > PERF_MAX_UTILIZATION):
            raise AssertionError(f"perf {key}: roofline {att} of cost "
                                 f"{r['cost']} in {r['median_seconds']} s")
        log(f"perf {key}: " + json.dumps(dict(
            median_s=r["median_seconds"], items_per_s=r["items_per_sec"],
            utilization=att and att["utilization"],
            bound=att and att["bound"], launches=r["launches"],
            first_call_s=r["compile_seconds"],
            peak_bytes=(r["memory"] or {}).get("peak_bytes"))))
    here = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "distributed_groth16_tpu_torch.api.cli",
           "perf"]
    gate = [sys.executable, "-m",
            "distributed_groth16_tpu_torch.telemetry.benchgate"]

    def start(argv):
        return subprocess.Popen(argv, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(name, proc, rc=0):
        so, se = proc.communicate(timeout=120)
        if proc.returncode != rc:
            raise AssertionError(f"perf {name}: exit {proc.returncode}, "
                                 f"expected {rc}: {so[-1500:]} {se[-1500:]}")
        return so

    with tempfile.TemporaryDirectory() as d:
        doc, slow, base = (os.path.join(d, f) for f in
                           ("perf.json", "slow.json", "baseline.json"))
        with open(doc, "w") as f:
            json.dump(run, f)
        slower = json.loads(json.dumps(run))
        for r in slower["kernels"].values():
            r["median_seconds"] *= 3
        with open(slow, "w") as f:
            json.dump(slower, f)
        t1 = time.perf_counter()
        wave = {"diff": start(cli + ["diff", doc, doc, "--markdown"]),
                "roofline": start(cli + ["roofline", "--run", doc]),
                "write": start(gate + ["--check", doc, "--baseline", base,
                                       "--write-baseline"])}
        diff = finish("diff", wave["diff"])
        table = finish("roofline", wave["roofline"])
        finish("write-baseline", wave["write"])
        wave = {"top": start(cli + ["top", "--run", doc, "--baseline", base,
                                    "-n", "3"]),
                "same": start(gate + ["--check", doc, "--baseline", base]),
                "slow": start(gate + ["--check", slow, "--baseline", base])}
        top = json.loads(finish("top", wave["top"]))
        same = finish("check", wave["same"])
        regressed = finish("check x3", wave["slow"], rc=1)
        cli_s = time.perf_counter() - t1
    rows = [ln for ln in diff.splitlines() if ln.startswith("| `")]
    if len(rows) != len(recs) or any(not ln.endswith("| 1.0 |")
                                     for ln in rows):
        raise AssertionError(f"perf diff of a run against itself: {diff}")
    missing = [k for k, r in recs.items()
               if not r["host"] and f"\n{k} " not in table]
    if missing or "device:NVIDIA H100" not in table:
        raise AssertionError(f"perf roofline lacks {missing}: {table}")
    if len(top["top"]) != 3 or any(e["vsBaseline"] != 1.0
                                   for e in top["top"]):
        raise AssertionError(f"perf top: {top}")
    if "benchgate: PASS" not in same or "benchgate: FAIL" not in regressed:
        raise AssertionError(f"benchgate: {same} {regressed}")
    log("perf roofline:\n" + table)
    log("perf: " + json.dumps(dict(
        records=len(recs), build_seconds=run["build_seconds"],
        peaks=run["peaks"], suite_s=suite_s, cli_and_gate_s=cli_s,
        top=[e["key"] for e in top["top"]],
        regressions=regressed.count("REGRESSION"),
        phase_s=time.perf_counter() - t0)))
    return launches


# phase 14: the reference's workloads (BASELINE configs 2-4) through the
# port's examples. Configs 2 and 3 run at their full sizes; config 4 at
# 2^WORKLOAD_MILLION_LOG2 constraints (2^20 at full size) so the script
# stays inside its time limit, its full size running as its own call
WORKLOAD_MILLION_LOG2 = 18
WORKLOAD_DMSM_LOG2 = 20
WORKLOAD_DFFT_LOG2 = 22
WORKLOAD_LGB_LOG2 = 15
WORKLOAD_PROFILE_MSM_LOG2 = 20

# the kernels each part must launch (8 words: no BLS12 curve on the path)
WORKLOAD_KERNELS = {
    "config2_dmsm": ("limb_add_g1", "limb_double_g1", "limb_horner_g1"),
    "config3_dfft": ("ntt_small",),
    "config4_million": ("limb_add_g1", "limb_add_g2", "limb_double_g1",
                        "limb_double_g2", "limb_horner_g1",
                        "limb_horner_g2", "ntt_small"),
    "local_groth_bench": ("limb_add_g1", "limb_add_g2", "limb_horner_g1",
                          "limb_horner_g2", "ntt_small"),
    "profile_msm": ("limb_add_g1", "limb_horner_g1"),
}


def phase_workloads(dev, million_log2=WORKLOAD_MILLION_LOG2,
                    dmsm_log2=WORKLOAD_DMSM_LOG2,
                    dfft_log2=WORKLOAD_DFFT_LOG2, lgb_log2=WORKLOAD_LGB_LOG2,
                    profile_log2=WORKLOAD_PROFILE_MSM_LOG2):
    """Phase 14: the reference's workloads through the run(...) of the
    port's examples (distributed_groth16_tpu_torch/examples/), the n
    parties of each simulated in one process:
    (a) config 2, dmsm_bench: a BN254 G1 d_msm at 2^dmsm_log2 points with
        l = 1 (1 king + 3 clients), its bases one generator packed in the
        exponent; the d_msm result and the local msm both equal
        (sum s_i mod r)*G from the host;
    (b) config 3, dfft_test: a d_fft at m = 2^dfft_log2, l = 2, n = 8,
        equal as canonical limbs to the card's limb NTT (kernel 4) of the
        same input and to refmath at two points w^k;
    (c) config 4, million: the chain of 2^million_log2 constraints proved
        by the 8-party MPC round (scalar-route pack, strip=True); the
        proof verifies and equals prove_single's on the same key; with
        --agg-out, the merged trace has 8 tracks and the round's critical
        path (king / straggler / wire / wall) is logged beside the part's
        wall and device-busy time;
    (d) local_groth_bench at m = 2^lgb_log2 (6 FFTs and 5 MSMs, G2 too)
        and profile_msm at 2^profile_log2 (the tree MSM's stages).
    Each part runs under a device-only trace, the counters zeroed before
    the phase: logs its wall ms, device-busy ms, peak device bytes, host
    bigint seconds (draws, encodes, refmath checks; for (c) also the
    circuit's build, setup's QAP-at-tau and scalar encodes, and the
    verify), launches and device ms per kernel, and its example's dict.
    Fails on an example's failed check or a part that launched none of the
    kernels it must. Returns the launches over the phase."""
    import torch

    from distributed_groth16_tpu_torch.examples import (
        dfft_test, dmsm_bench, local_groth_bench, million, profile_msm,
    )
    from distributed_groth16_tpu_torch.ops import _cuda

    # the module, not the function the package re-exports under its name
    setup_mod = importlib.import_module(
        "distributed_groth16_tpu_torch.models.groth16.setup")
    t_phase = time.perf_counter()
    for k in _cuda.KERNELS.values():
        k.launches = 0
    parts = {}

    def part(name, fn):
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: v.launches for k, v in _cuda.KERNELS.items()}
        t0 = time.perf_counter()
        with kernel_trace(host_ops=False) as tr:
            res = fn()
            sync(dev)
        wall = (time.perf_counter() - t0 - tr["trace_s"]) * 1e3
        launches = {k: v.launches - before[k]
                    for k, v in _cuda.KERNELS.items()}
        rec = dict(wall_ms=wall, busy_ms=tr["busy_ms"],
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   host_s=res.get("host_s"), trace_s=tr["trace_s"],
                   launches={k: v for k, v in launches.items() if v},
                   device_ms=tr["per_kernel"], result=res)
        log(f"workload {name}: " + json.dumps(rec))
        idle = [k for k in WORKLOAD_KERNELS[name] if launches[k] == 0]
        if idle:
            raise AssertionError(f"workload {name} never launched {idle}")
        if not res["ok"]:
            raise AssertionError(f"workload {name} failed its check: {res}")
        parts[name] = rec
        return res

    part("config2_dmsm", lambda: dmsm_bench.run(
        dmsm_log2, dmsm_log2, l=1, device=dev))
    part("config3_dfft", lambda: dfft_test.run(
        1 << dfft_log2, 2, check="ntt", device=dev))

    def chain():
        probed = {"qap_at_tau": (setup_mod, "_qap_polys_at_tau"),
                  "setup_encode": (setup_mod, "encode_scalars_std")}
        with probes(dev, probed) as ms, tempfile.TemporaryDirectory() as tmp:
            res = million.run(million_log2, 2, match_single=True, device=dev,
                              agg_out=os.path.join(tmp, "million.json"))
            with open(os.path.join(tmp, "million.json")) as f:
                merged = json.load(f)["traceEvents"]
        res["agg_trace_events"] = len(merged)
        ph = res["phases_ms"]
        res["host_s"] = (ph["build circuit"] + ms["qap_at_tau"]
                         + ms["setup_encode"] + ph["verify"]) * 1e-3
        res["setup_host_ms"] = {k: ms[k] for k in probed}
        return res

    res = part("config4_million", chain)
    if not (res["verified"] and res["matches_single"]):
        raise AssertionError(f"config 4: {res}")
    cp = res["critical_path"]
    if res["agg_tracks"] != 8 or not cp or cp["parties"] != 8:
        raise AssertionError(f"config 4's merged trace: {res['agg_tracks']} "
                             f"tracks, critical path {cp}")
    rec = parts["config4_million"]
    log("workload config4_million round: " + json.dumps(dict(
        critical_path_s=cp, round_ms=res["phases_ms"]["MPC Proof"],
        part_wall_ms=rec["wall_ms"], part_busy_ms=rec["busy_ms"],
        tracks=res["agg_tracks"], trace_events=res["agg_trace_events"])))
    part("local_groth_bench", lambda: dict(
        local_groth_bench.run(lgb_log2, device=dev), ok=True))
    part("profile_msm", lambda: dict(
        profile_msm.run(profile_log2, device=dev), ok=True))
    launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
    log("workloads: " + json.dumps(dict(
        million_log2=million_log2, seconds=time.perf_counter() - t_phase,
        wall_ms={k: v["wall_ms"] for k, v in parts.items()},
        busy_ms={k: v["busy_ms"] for k, v in parts.items()},
        peak_bytes={k: v["peak_bytes"] for k, v in parts.items()},
        host_s={k: v["host_s"] for k, v in parts.items()})))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distributed_groth16_tpu_torch.ops import _cuda

    import numpy as np

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"device: {name} | {smi} | {sms} SMs | max SM clock {clock} MHz | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    bound = card_bound(sms, clock)

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
    lane = lane_shapes(circuit[0], 1 << 15)
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        log(f"{name}: {now - clock[0]:.1f} s")
        clock[0] = now

    entries = phase_kernels(dev, bound, rng, ladder, lane)
    lap("phase 3, 8 words")
    entries.update(phase_kernels_w12(dev, bound, rng, w12_widths()))
    lap("phase 3, 12 words")
    launches, per_proof_ms, ctx = phase_main_path(dev, circuit)
    lap("phase 4")
    phase_byte_identity(dev)
    lap("phase 5")
    launches_mpc, per_mpc_ms = phase_mpc(dev, ctx)
    lap("phase 6")
    bls = phase_bls(dev, ctx)
    lap("phase 7")
    launches_bls = {k: sum(p["launches"].get(k, 0) for p in bls.values())
                    for k in _cuda.KERNELS}
    launches_mpc64, per_mpc64_ms = phase_mpc64(dev, ctx)
    lap("phase 8")
    launches_star = phase_star(dev, ctx)
    lap("phase 9")
    launches_zkey = phase_zkey(dev, ctx)
    lap("phase 10")
    launches_batch, launches_job, per_batch_ms, launches_shards = \
        phase_batch(dev, ctx)
    for key in SHARD_KERNELS:
        if launches_shards[key] == 0:
            raise AssertionError(f"the sharded paths never launched {key}")
    log("shards: " + json.dumps(dict(launches_shards=launches_shards)))
    lap("phase 11")
    launches_http = phase_http(dev, ctx)
    lap("phase 12")
    launches_perf = phase_perf(dev)
    lap("phase 13")
    launches_wl = phase_workloads(dev)
    lap("phase 14")

    # every kernel launches on at least one path: kernel 2 (double) only on
    # the MPC and BLS paths' ladders, kernel 4 (ntt_small) only on the main
    # path, the 12-word kernels only on the BLS paths. The 8-word rows' own
    # numbers are at the main path's shape (as in slice 1) and their
    # launches the main path's; kernels 1 and 2 carry theirs at
    # ladder_apply's widest shape in at_ladder, kernel 2 at the king's
    # unpack in at_unpack, and both at phase 8's lane ladder in at_lane and
    # at_lane_unpack. The 12-word rows' numbers are at the widest
    # shape of a BLS path and their launches the BLS paths'.
    rows = []
    for key, e in entries.items():
        err = max(e[k]["max_abs_err"] if k else e["max_abs_err"]
                  for k in (None, "ladder", "unpack", "lane", "lane_unpack")
                  if k is None or k in e)
        w12 = key.endswith("_w12")
        row = dict(
            name=key, route="cuda", source=e["source"],
            replaces=REPLACES[e["kind"]], shape=e["shape"],
            launches=launches_bls[key] if w12 else launches[key],
            launches_mpc=launches_mpc[key], launches_bls=launches_bls[key],
            launches_mpc64=launches_mpc64[key],
            launches_star=launches_star[key],
            launches_zkey=launches_zkey[key],
            launches_batch=launches_batch[key],
            launches_shards=launches_shards[key],
            launches_service_prove=launches_job[key],
            launches_http=launches_http[key],
            launches_perf=launches_perf[key],
            launches_workloads=launches_wl[key],
            launches_by_bls_path={p: r["launches"].get(key, 0)
                                  for p, r in bls.items()},
            max_abs_err=err, match=err == 0, ms=e["ms"], kernel_ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=None,
            call_ms=e["call_ms"], ms_per_proof=per_proof_ms[key],
            ms_per_mpc_proof=per_mpc_ms[key],
            ms_per_mpc64_proof=per_mpc64_ms[key],
            ms_per_batch=per_batch_ms[key],
            ms_per_bls_path={p: r["device_ms"].get(key, 0.0)
                             for p, r in bls.items()},
        )
        for extra in ("cases", "chain_depth", "product_latency_us",
                      "chain_bound_ms", "group", "plain_columns"):
            if extra in e:
                row[extra] = e[extra]
        if "ladder" in e:
            row["at_ladder"] = e["ladder"]
        for where in ("unpack", "lane", "lane_unpack"):
            if where in e:
                row[f"at_{where}"] = e[where]
        info = [v for f, v in ptxas.items() if ptxas_name(key) in f]
        if info:  # empty when the libraries were built by an earlier run
            row["ptxas"] = dict(info[0])
            if "registers" in info[0] and key.startswith(("limb_add",
                                                          "limb_double")):
                row["ptxas"]["warps_per_sm"] = warps_per_sm(
                    info[0]["registers"],
                    96 if key.startswith("limb_double") else 128)
        if (row["launches"] + row["launches_mpc"] + row["launches_bls"]
                + row["launches_mpc64"] + row["launches_star"]
                + row["launches_zkey"] + row["launches_batch"]
                + row["launches_shards"] + row["launches_service_prove"]
                + row["launches_http"] + row["launches_perf"]
                + row["launches_workloads"]) == 0:
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
