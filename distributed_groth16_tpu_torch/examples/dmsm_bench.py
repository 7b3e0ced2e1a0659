"""Distributed + local MSM sweep — the port of the JAX package's
examples/dmsm_bench.py (the dmsm_bench.rs / msm_bench.rs roles,
dist-primitives/examples): d_msm over n = 4l parties simulated in one
process and the plain local MSM, swept over sizes 2^10..2^19 (reference
loop, dmsm_bench.rs:42-50).

  python -m distributed_groth16_tpu_torch.examples.dmsm_bench \\
      [--min 10] [--max 19] [--l 2] [--local-only] \\
      [--curve bn254|bls12-377|bls12-381 [--g2]] [--device cpu]

BASELINE config 2 is --l 1 --min 20 --max 20 (BN254 G1, 1 king + 3
clients). --curve bls12-377 is the reference's own configuration (d_msm
over BLS12-377 with packed sharing over Fr377, dmsm_bench.rs:1,48).

The flags, defaults and printed lines are the JAX example's, plus
--device (default cuda; only an explicit cpu runs on the CPU). The last
output line is JSON: run()'s dict.

Departures from the JAX example:
  * every size is checked: all bases are one generator G, so the d_msm
    result and the local msm must both equal (sum s_i mod r)*G, one host
    refmath scalar multiplication (the JAX example checks nothing). A
    mismatch makes the exit code 1;
  * the timed windows (the warm second local msm, as in JAX, and the
    d_msm round) end in torch.cuda.synchronize(); the scalar draw, their
    encode and the ground truth are host_s; the first local msm is
    local_cold_ms, the scalar shares' pack scalar_pack_ms, the base pack
    in the exponent (packexp_from_public, kernels 1 and 2) pack_ms;
  * the bases are a torch expand view of one encoded generator (JAX's
    broadcast_to); nothing writes into it.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..ops import refmath as rm
from ..ops.constants import G1_GENERATOR, G2_GENERATOR, R
from ..ops.curve import g1, g2
from ..ops.field import fr
from ..ops.msm import encode_scalars_std, msm
from ..parallel.dmsm import d_msm
from ..parallel.net import simulate_network_round
from ..parallel.packing import pack_consecutive
from ..parallel.pss import pss
from ._star import drain, draw_scalars, open_device


def curve_config(curve: str, g2_group: bool, l: int, dev):
    """(CurvePoints, generator, host group, r, encode_scalars, scalar
    field, PackedSharingParams, pack_scalar_shares) of --curve."""
    if curve == "bls12-377":
        from ..ops import bls12_377 as b

        pp = b.pss377(l)
        return (b.g1_377(), b.g1_generator_377(), b.G1_HOST, b.R377,
                b.encode_scalars_377, b.fr377(), pp,
                lambda s: b.pack_scalars_377(pp, s, dev))
    if curve == "bls12-381":
        from ..ops import bls12_381 as b

        pp = b.pss381(l)
        C, gen, host = ((b.g2_381(), b.g2_generator_381(), b.G2_HOST)
                        if g2_group else
                        (b.g1_381(), b.g1_generator_381(), b.G1_HOST))
        return (C, gen, host, b.R381, b.encode_scalars_381, b.fr381(), pp,
                lambda s: b.pack_scalars_381(pp, s, dev))
    pp = pss(l)
    C, gen, host = ((g2(), G2_GENERATOR, rm.G2) if g2_group
                    else (g1(), G1_GENERATOR, rm.G1))
    return (C, gen, host, R, encode_scalars_std, fr(), pp,
            lambda s: pack_consecutive(pp, fr().encode(s, dev)))


def run(min_log: int = 10, max_log: int = 19, l: int = 2,
        local_only: bool = False, curve: str = "bn254", g2_group: bool = False,
        device=None) -> dict:
    if g2_group and curve != "bls12-381":
        raise ValueError("--g2 requires --curve bls12-381")
    dev = open_device(device)
    C, gen, host, r_mod, enc, sf, pp, pack_scalar_shares = curve_config(
        curve, g2_group, l, dev)
    rng = np.random.default_rng(0)
    pt_shape = (3,) + C.elem_shape
    base = C.encode([gen], dev)[0]
    sizes, ok_all = [], True

    for logn in range(min_log, max_log + 1):
        n = 1 << logn
        t0 = time.perf_counter()
        scalars_int = draw_scalars(rng, n, r_mod)
        std = enc(scalars_int, dev)
        host_s = time.perf_counter() - t0
        points = base.expand((n,) + pt_shape)

        # local MSM (msm_bench.rs role): the second call is timed
        drain(dev)
        t0 = time.perf_counter()
        out = msm(C, points, std)
        drain(dev)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = msm(C, points, std)
        drain(dev)
        t_local = time.perf_counter() - t0
        line = f"2^{logn}: local {t_local*1e3:9.1f} ms"
        row = {"log2_n": logn, "local_ms": t_local * 1e3,
               "local_cold_ms": t_cold * 1e3}

        t0 = time.perf_counter()
        want = host.scalar_mul(gen, sum(scalars_int) % r_mod)
        ok = C.decode(out) == want
        host_s += time.perf_counter() - t0
        if not local_only:
            # distributed MSM (dmsm_bench.rs role)
            t0 = time.perf_counter()
            s_shares = pack_scalar_shares(scalars_int)
            drain(dev)
            row["scalar_pack_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            base_chunks = points.reshape((n // pp.l, pp.l) + pt_shape)
            b_shares = pp.packexp_from_public(C, base_chunks).transpose(0, 1)
            drain(dev)
            row["pack_ms"] = (time.perf_counter() - t0) * 1e3

            async def party(net, d):
                return await d_msm(C, d[0], d[1], pp, net, scalar_field=sf)

            data = [(b_shares[i], s_shares[i]) for i in range(pp.n)]
            t0 = time.perf_counter()
            outs = simulate_network_round(pp.n, party, data)
            drain(dev)
            t_dist = time.perf_counter() - t0
            line += f"   d_msm(n={pp.n}) {t_dist*1e3:9.1f} ms"
            row["dmsm_ms"] = t_dist * 1e3
            t0 = time.perf_counter()
            ok = ok and C.decode(outs[0]) == want
            host_s += time.perf_counter() - t0
            del b_shares, s_shares, data, outs
        row.update(ok=ok, host_s=host_s)
        ok_all = ok_all and ok
        sizes.append(row)
        print(line + ("" if ok else "   MISMATCH against (sum s_i)*G"),
              flush=True)
    return {"curve": curve, "g2": g2_group, "l": pp.l, "n": pp.n,
            "ok": ok_all, "sizes": sizes,
            "host_s": sum(row["host_s"] for row in sizes),
            "device": str(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--min", type=int, default=10)
    p.add_argument("--max", type=int, default=19)
    p.add_argument("--l", type=int, default=2)
    p.add_argument("--local-only", action="store_true")
    p.add_argument(
        "--curve",
        choices=("bn254", "bls12-377", "bls12-381"),
        default="bn254",
    )
    p.add_argument(
        "--g2",
        action="store_true",
        help="bls12-381 only: sweep the G2 MSM instead of G1 "
        "(BASELINE config 5 is G1/G2 at 2^24)",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.g2 and args.curve != "bls12-381":
        p.error("--g2 requires --curve bls12-381")
    res = run(args.min, args.max, args.l, args.local_only, args.curve,
              args.g2, args.device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
