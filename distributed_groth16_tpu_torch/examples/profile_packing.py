"""CRS in-the-exponent packing micro-bench — the port of the JAX
package's scripts/profile_packing.py.

Times pp.packexp_from_public over BN254 G1 at --log2-m points (the
S-query shape: m points packed l at a time into n-share groups; the
point route, ladders on kernels 1 and 2 on the card), reporting
points/sec, cold (first call) and warm; then the scalar route the dealer
takes when it knows the discrete logs (field-NTT pack + windowed
fixed-base multiply on kernel 1, models/groth16/proving_key.py
_pack_query_scalars) at the same m. Compare against the per-proof MSM
time at the same m: the done-bar is packing <= prove.

  python -m distributed_groth16_tpu_torch.examples.profile_packing \\
      [--log2-m 15] [--n 8] [--l 2] [--device cpu]

Prints the JAX script's one JSON line (metric
crs_packexp_points_per_sec), unrounded; its "platform" is the device's
name. Every timed call ends in torch.cuda.synchronize(); a cold call
holds the kernels' first use (their nvcc build when none is cached)
where JAX's held jit compile. setup_compile_cache is gone (no XLA
cache).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.groth16.proving_key import _pack_query_scalars
from ..ops.constants import G1_GENERATOR
from ..ops.curve import g1
from ..ops.field import fr
from ..parallel.pss import pss
from ._star import drain, open_device


def run(log2_m: int = 15, n: int = 8, l: int = 2, device=None) -> dict:
    if n != 4 * l:
        raise ValueError("PSS requires n = 4l")
    dev = open_device(device)
    m = 1 << log2_m
    pp = pss(l)
    C1 = g1()

    def timed(fn):
        drain(dev)
        t0 = time.perf_counter()
        fn()
        drain(dev)
        return time.perf_counter() - t0

    # m points arranged (m/l, l) for pack-consecutive semantics
    base = C1.encode([G1_GENERATOR], dev)[0]
    pts = base.expand(m // l, l, 3, 16)
    cold = timed(lambda: pp.packexp_from_public(C1, pts))
    warm = timed(lambda: pp.packexp_from_public(C1, pts))

    # scalar route: what the same m costs when the dealer knows the
    # discrete logs — field-NTT pack + windowed fixed-base
    scal = fr().encode(list(range(2, m + 2)), dev)
    scalar_cold = timed(lambda: _pack_query_scalars("g1", pp, scal))
    scalar_warm = timed(lambda: _pack_query_scalars("g1", pp, scal))

    platform = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    return {
        "metric": "crs_packexp_points_per_sec",
        "platform": platform,
        "log2_m": log2_m,
        "n": n,
        "l": l,
        "warm_s": warm,
        "cold_s": cold,
        "points_per_sec": m / warm,
        "scalar_route_warm_s": scalar_warm,
        "scalar_route_cold_s": scalar_cold,
        "scalar_route_points_per_sec": m / scalar_warm,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log2-m", type=int, default=15)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--l", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.n != 4 * args.l:
        ap.error("PSS requires n = 4l")
    print(json.dumps(run(args.log2_m, args.n, args.l, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
