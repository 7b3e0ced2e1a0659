#!/usr/bin/env python3
"""chip_smoke.py phase 3 (every kernel against its plain version, timed at
the main path's and the ladder's shapes) of two or more checkouts in one
call on one card, in turns, so their kernel times can be compared.

    python3 compare_trees.py [--main] [--out DIR] A B B A

Each argument is the root of a checkout (for example the parent commit
unpacked with `git archive`). Each turn runs in a fresh process from that
root, builds that tree's kernels and runs its own chip_smoke.phase_kernels;
with --main also its phase_main_path (SHA-256, m = 2^15) and then five
more warm prove_single calls, each timed on the host clock with the device
drained. The results go to DIR/compare_trees.json (DIR defaults to
.bench_cache/compare_trees), each turn's log to
DIR/compare_trees.turn<i>.log, and one summary line per turn to standard
output.
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
sys.path.insert(0, ".")
import chip_smoke as cs
from distributed_groth16_tpu_torch.ops import _cuda
t0 = time.perf_counter()
_cuda.build()
build_s = time.perf_counter() - t0
dev = torch.device("cuda", 0)
clock = float(cs.nvidia_smi("clocks.max.sm").split()[0])
sms = torch.cuda.get_device_properties(0).multi_processor_count
ladder = cs.ladder_shapes(cs.sha256_abc()[0], 1 << 15)
entries = cs.phase_kernels(dev, cs.Bound(sms, clock),
                           np.random.default_rng(42), ladder)
warm = []
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
print("RESULT " + json.dumps(dict(
    smi=cs.nvidia_smi("name,power.limit"), build_s=build_s,
    build_log=_cuda.build_log, entries=entries, warm=warm)))
"""


def summary(entries: dict) -> dict:
    out = {}
    for k, e in entries.items():
        out[k] = round(e["ms"], 4)
        if "ladder" in e:
            out[k + "@ladder"] = round(e["ladder"]["ms"], 4)
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
                    ms=summary(res["entries"]))
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
