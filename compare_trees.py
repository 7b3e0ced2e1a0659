#!/usr/bin/env python3
"""Kernel times of two or more checkouts in one call on one card, in turns,
so they can be compared.

    python3 compare_trees.py [--main] [--out DIR] A B B A

Each argument is the root of a checkout (for example the parent commit
unpacked with `git archive`). Each turn runs in a fresh process from that
root and builds that tree's kernels. It first times every kernel through
that tree's own wrappers (LimbGroup.add / double / horner, _small(S,
inverse)) at the shapes the paths launch, with the same harness code for
every tree: the median device time of one launch from torch.profiler's
kernel records (`same_shapes`, µs). Then it runs the tree's own
chip_smoke.phase_kernels; with --main also its phase_main_path (SHA-256,
m = 2^15), five more warm prove_single calls, each timed on the host
clock with the device drained, and one CRS pack (l = 2) and one
r = s = 0 MPC round under the profiler: each kernel's summed device time
in each (`mpc_us`). The results go to
DIR/compare_trees.json (DIR defaults to .bench_cache/compare_trees), each
turn's log to DIR/compare_trees.turn<i>.log, and one summary line per turn
to standard output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from distributed_groth16_tpu_torch.ops import _cuda
from distributed_groth16_tpu_torch.ops.constants import R
from distributed_groth16_tpu_torch.ops.fixedbase import fixed_base_mul
from distributed_groth16_tpu_torch.ops.limb_kernels import lg1, lg2
from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std
from distributed_groth16_tpu_torch.ops.ntt_limb import _small


def device_us(fn, reps=20, tries=3):
    # median device time of one launch; a trace that holds no kernel
    # record is taken again, and after `tries` such traces None is kept
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        d = sorted(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "dg16::" in e.name)
        if d:
            return d[len(d) // 2]
        print("no kernel record in a trace", file=sys.stderr)
    return None


def same_shapes(dev, ladder):
    # kernel 1 at the main path's and the ladder's widths, kernel 2 at the
    # king's unpack (16 on G1, 8 on G2; and 2, 4), the CRS pack's (G1: the
    # a, b and l queries' 55,256, h's B*K; G2: B*K) and 524,288, Horner at
    # W = 32, c = 8, kernel 4 at the two halves of a 2^15 transform
    rng = np.random.default_rng(7)
    out = {}
    for gname, g in (("g1", lg1()), ("g2", lg2())):
        scal = encode_scalars_std(
            [int.from_bytes(rng.bytes(40), "little") % R
             for _ in range(4096)], dev)
        base = g.from_rowmajor(fixed_base_mul(gname, scal))
        P, Q = cs.point_columns(g, base, 524288, dev, 1)
        red = g.add(P, Q)
        B, o, K = ladder[gname]
        for m in (524288, B * o * K):
            a, b = red[:, :m].contiguous(), P[:, :m].contiguous()
            out[f"add_{gname}@{m}"] = device_us(lambda: g.add(a, b), 5)
        widths = (2, 4, 8, 16, B * K, 524288) + (
            (55256,) if gname == "g1" else ())
        for m in widths:
            x = red[:, :m].contiguous()
            out[f"double_{gname}@{m}"] = device_us(lambda: g.double(x))
        s = red[:, :32].contiguous()
        out[f"horner_{gname}@W32c8"] = device_us(lambda: g.horner(s, 8), 5)
    # kernel 1 at 12 words (BLS12-381 G1 and G2) at 65,536 and 2^20 columns
    for gname in ("g1_381", "g2_381"):
        g, C, host, gen = cs.bls_groups()[gname]
        base = g.from_rowmajor(
            cs.small_log_points(g, C, host, gen, 4096, dev, 3)[0])
        P, Q = cs.point_columns(g, base, 1 << 20, dev, 1)
        red = g.add(P, Q)
        for m in (65536, 1 << 20):
            a, b = red[:, :m].contiguous(), P[:, :m].contiguous()
            out[f"add_{gname}@{m}"] = device_us(lambda: g.add(a, b), 5)
        del P, Q, red, a, b
    for S, L in ((256, 128), (128, 256)):
        x = torch.as_tensor(cs.random_fr_limbs(rng, (S, L), 2 * R),
                            device=dev)
        for inverse in (False, True):
            nt = _small(S, inverse)
            key = f"ntt_{S}x{L}" + ("_inv" if inverse else "")
            out[key] = device_us(lambda: nt(x))
    return out


def kernel_us(prof):
    # summed device time (µs) of each of the repo's kernels in a trace
    per = {}
    for e in prof.events():
        name = e.name.replace(" ", "")
        if e.device_type != DeviceType.CUDA or "dg16::" not in name:
            continue
        row = next((f"{op}_g{deg}" for op in ("add", "double", "horner")
                    for deg in (1, 2) if f"{op}_kernel<8,{deg}>" in name),
                   "ntt_small")
        per[row] = per.get(row, 0.0) + e.time_range.end - e.time_range.start
    return per


def mpc_us(dev, ctx, l=2):
    # each kernel's device time in one CRS pack and one r = s = 0 round
    # (n = 4l parties over LocalSimNet), each traced after a warm-up run
    import os, tempfile
    from distributed_groth16_tpu_torch.models.groth16 import (
        ProvingKey, distributed_prove_party, pack_from_witness,
        pack_proving_key)
    from distributed_groth16_tpu_torch.parallel.net import (
        simulate_network_round)
    from distributed_groth16_tpu_torch.parallel.pss import pss

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pk.npz")
        ctx["pk"].save(path)
        pk = ProvingKey.load(path, device=dev)
    pp = pss(l)
    z, ni = ctx["z_mont"], ctx["r1cs"].num_instance

    def traced(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, kernel_us(prof)

    crs, pack = traced(lambda: pack_proving_key(pk, pp))
    shares = ctx["comp"].qap(z).pss(pp)
    a_sh, ax_sh = pack_from_witness(pp, z[1:]), pack_from_witness(pp, z[ni:])
    data = [(crs[i], shares[i], a_sh[i], ax_sh[i]) for i in range(pp.n)]

    async def party(net, d):
        return await distributed_prove_party(pp, *d, net)

    _, round_ = traced(lambda: simulate_network_round(pp.n, party, data))
    return dict(pack=pack, round=round_)


t0 = time.perf_counter()
_cuda.build()
build_s = time.perf_counter() - t0
dev = torch.device("cuda", 0)
clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
sms = torch.cuda.get_device_properties(0).multi_processor_count
ladder = cs.ladder_shapes(cs.sha256_abc()[0], 1 << 15)
same = same_shapes(dev, ladder)
entries = cs.phase_kernels(dev, cs.Bound(sms, clock),
                           np.random.default_rng(42), ladder)
warm, mpc = [], None
if sys.argv[1] == "main":
    from distributed_groth16_tpu_torch.models.groth16 import prove_single
    ctx = cs.phase_main_path(dev, cs.sha256_abc())[-1]
    for _ in range(5):
        t = {}
        t0 = time.perf_counter()
        prove_single(ctx["pk"], ctx["comp"], ctx["z_mont"], timings=t)
        torch.cuda.synchronize()
        t["total"] = (time.perf_counter() - t0) * 1e3
        warm.append(t)
    mpc = mpc_us(dev, ctx)
print("RESULT " + json.dumps(dict(
    smi=cs.nvidia_smi("name,power.limit"), build_s=build_s,
    build_log=_cuda.build_log, same_shapes=same, entries=entries,
    warm=warm, mpc_us=mpc)))
"""


def summary(entries: dict) -> dict:
    out = {}
    for k, e in entries.items():
        out[k] = round(e["ms"], 4)
        for at in ("ladder", "unpack"):
            if at in e:
                out[f"{k}@{at}"] = round(e[at]["ms"], 4)
        for case in e.get("cases", [])[1:]:
            out[f"{k}@W{case['W']}c{case['c']}"] = round(case["ms"], 4)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--main", action="store_true")
    ap.add_argument("--out", default=".bench_cache/compare_trees")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    mode = "main" if args.main else "kernels"
    trees = [str(Path(t).resolve()) for t in args.trees]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, tree in enumerate(trees):
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, mode], cwd=tree,
            capture_output=True, text=True, timeout=1500,
        )
        (out / f"compare_trees.turn{i}.log").write_text(
            proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({tree}) failed")
        res = json.loads(lines[-1][len("RESULT "):])
        res.update(turn=i, tree=tree)
        runs.append(res)
        line = dict(turn=i, tree=tree, smi=res["smi"],
                    build_s=round(res["build_s"], 1),
                    same_shapes_us=res["same_shapes"],
                    ms=summary(res["entries"]))
        if res["mpc_us"]:
            line["mpc_us"] = res["mpc_us"]
        if res["warm"]:
            totals = sorted(t["total"] for t in res["warm"])
            line["warm_proof_ms"] = dict(
                median=totals[len(totals) // 2], min=totals[0],
                msm=sorted(sum(t[k] for k in t if k.startswith("msm"))
                           for t in res["warm"])[len(totals) // 2])
        print(json.dumps(line), flush=True)
    (out / "compare_trees.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
