"""Piece-wise timing of the tree MSM on the card — the port of the JAX
package's scripts/profile_msm.py: which stage owns the per-MSM
milliseconds (sort / sort+gather / up-sweep / Fenwick+combine+Horner)?

  PROF_LOG2N=20 python -m distributed_groth16_tpu_torch.examples.profile_msm \\
      [--device cpu]

Run on an idle card. Prints one line per variant, each the marginal cost
of one MSM (utils/benchtools.py marginal_cost: a K=1 and a K=3 loop,
each fenced by torch.cuda.synchronize()), then run()'s dict as the last
line. PROF_LOG2N (default 16) is the MSM's log2 size, c = 8 its window.

The variants rebuild the stages of ops/limb_kernels.msm_tree_batched for
one entry over all W windows at once, as the JAX script does over
lk._msm_tree_jit: _digits, a stable argsort, the limb-major gather,
the pairwise up-sweep on the group's add (kernel 1 on the card). The
full variant is msm_tree itself, which goes on with the Fenwick
prefixes, the bucket combine and Horner (kernel 3), 8 windows at a time
above 2^17 points.

Departures from the JAX script: setup_compile_cache (XLA's persistent
compile cache) is gone (the kernels' libraries are already named by a
digest of their sources, ops/_cuda.py); there is no jit, so each
variant's K-loop is a Python loop of eager calls.
"""

# dg16lint: disable-file=DG108 — the printed lines are the script's output
# contract, as in the JAX script

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..ops.constants import G1_GENERATOR, R
from ..ops.curve import g1
from ..ops.limb_kernels import _digits, lg1, msm_tree
from ..ops.msm import encode_scalars_std
from ..utils.benchtools import marginal_cost
from ._star import draw_scalars, open_device

C = 8


def marginal(make_fn, *args):
    return marginal_cost(make_fn, args, reps=3)


def run(log2_n: int = 16, device=None) -> dict:
    dev = open_device(device)
    n = 1 << log2_n
    rng = np.random.default_rng(0)
    scalars = encode_scalars_std(draw_scalars(rng, n, R), dev)
    points = g1().encode([G1_GENERATOR], dev)[0].expand(n, 3, 16)
    g = lg1()
    W = 256 // C

    def first(t):
        # eager ops run whole, so one element consumes a stage's result; a
        # sum would add a full read of it to the stage's time
        return t.reshape(-1)[0]

    def var_full(k):
        def run_k(points, scalars):
            acc = 0
            for i in range(k):
                acc += first(msm_tree(points, scalars ^ i, C, group=g))
            return acc

        return run_k

    def sorted_digits(scalars, i):
        digits = _digits(scalars ^ i, C)  # (W, n)
        return digits, digits.argsort(dim=-1, stable=True)

    def var_sort_only(k):
        def run_k(points, scalars):
            acc = 0
            for i in range(k):
                acc += first(sorted_digits(scalars, i)[1])
            return acc

        return run_k

    def var_sort_gather(k):
        def run_k(points, scalars):
            lm = g.from_rowmajor(points)
            acc = 0
            for i in range(k):
                order = sorted_digits(scalars, i)[1]
                acc += first(lm[:, order.reshape(-1)])
            return acc

        return run_k

    def var_upsweep(k):
        # up-sweep only: tree adds over (ROWS, W, n) without Fenwick/combine
        def run_k(points, scalars):
            lm = g.from_rowmajor(points)
            acc = 0
            for i in range(k):
                order = sorted_digits(scalars, i)[1]
                x = lm[:, order.reshape(-1)].reshape(g.ROWS, W, n)
                while x.shape[-1] > 1:
                    half = x.shape[-1] // 2
                    pair = x.reshape(g.ROWS, W, half, 2)
                    x = g.add(pair[..., 0], pair[..., 1])
                acc += first(x)
            return acc

        return run_k

    full = marginal(var_full, points, scalars)
    sort_only = marginal(var_sort_only, points, scalars)
    sort_gather = marginal(var_sort_gather, points, scalars)
    upsweep = marginal(var_upsweep, points, scalars)
    print(f"n=2^{log2_n} c={C}  (per-MSM marginal seconds)")
    print(f"full tree msm      : {full*1e3:9.1f} ms  ({n/full:,.0f} muls/s)")
    print(f"sort only          : {sort_only*1e3:9.1f} ms")
    print(f"sort+gather        : {sort_gather*1e3:9.1f} ms")
    print(f"sort+gather+upsweep: {upsweep*1e3:9.1f} ms")
    print(f"=> fenwick+combine+horner ≈ {(full-upsweep)*1e3:9.1f} ms")
    return {"log2_n": log2_n, "c": C, "full_ms": full * 1e3,
            "sort_ms": sort_only * 1e3, "sort_gather_ms": sort_gather * 1e3,
            "upsweep_ms": upsweep * 1e3,
            "rest_ms": (full - upsweep) * 1e3, "device": str(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(int(os.environ.get("PROF_LOG2N", "16")),
                         args.device)))


if __name__ == "__main__":
    main()
