"""Distributed kernels over real sockets, one OS process per party — the
port of the JAX package's examples/nonlocal_kernel.py (the reference's
dist-primitives/examples/{dfft_test,dmsm_bench,dpp_test}.rs, launched one
process per rank).

Every rank builds the full input from --seed (the trusted-dealer
convention of nonlocal_sha256.py), keeps its own share row, runs the
selected kernel over a ProdNet star, and rank 0 checks the revealed
result against the pure-bigint refmath ground truth.

  python -m distributed_groth16_tpu_torch.examples.nonlocal_kernel \\
      --kernel dfft|dmsm|dpp --id <rank> --input <addressfile> \\
      --certs <certdir> --n 8 [--m 256] [--plain] [--device cpu]

The last output line is JSON: {"party", "ok", "kernel", "ms" (the
kernel's wall ms on this rank, connect excluded), "launches",
"peak_bytes"}; rank 0's "ok" is its check against refmath.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import asyncio
import random
import sys
import time

import torch

from ..models.groth16.proving_key import _pack_query_scalars
from ..ops import refmath as rm
from ..ops.constants import G1_GENERATOR, R
from ..ops.curve import g1
from ..ops.field import fr
from ..ops.ntt import domain
from ..parallel.dfft import d_fft
from ..parallel.dmsm import d_msm
from ..parallel.dpp import d_pp
from ..parallel.packing import pack_consecutive, pack_strided, unpack_shares
from ..parallel.pss import pss
from ._star import (
    add_star_args, connect, device_stats, drain, open_device,
    party_count, report,
)


async def _run_dfft(opt, pp, net, dev):
    """d_fft with king_clear: the king receives the clear evaluations and
    compares them with the host NTT (dfft_test.rs semantics)."""
    F = fr()
    rng = random.Random(opt.seed)
    x = [rng.randrange(R) for _ in range(opt.m)]
    share = pack_strided(pp, F.encode(x, dev))[opt.id]
    clear = await d_fft(
        share, False, 1, False, domain(opt.m), pp, net, king_clear=True
    )
    if opt.id != 0:
        return True
    return [int(v) for v in F.decode(clear)] == rm.Domain(opt.m).fft(x)


async def _run_dmsm(opt, pp, net, dev):
    """d_msm over generator multiples: every rank derives its base shares
    by the scalar route of the CRS pack and its witness shares by
    consecutive packing; the clear result must equal (sum b_i x_i) * G."""
    F = fr()
    rng = random.Random(opt.seed)
    base_s = [rng.randrange(R) for _ in range(opt.m)]  # discrete logs
    wit = [rng.randrange(R) for _ in range(opt.m)]
    bases = _pack_query_scalars("g1", pp, F.encode(base_s, dev))[opt.id]
    scal_shares = pack_consecutive(pp, F.encode(wit, dev))[opt.id]
    out = await d_msm(g1(), bases, scal_shares, pp, net)
    if opt.id != 0:
        return True
    s = sum(b * w for b, w in zip(base_s, wit)) % R
    return g1().decode(out) == rm.G1.scalar_mul(G1_GENERATOR, s)


async def _run_dpp(opt, pp, net, dev):
    """d_pp (partial products): reveal the output shares on the king in a
    second round and compare with the host prefix products (dpp_test.rs
    semantics)."""
    F = fr()
    rng = random.Random(opt.seed)
    num = [rng.randrange(1, R) for _ in range(opt.m)]
    den = [rng.randrange(1, R) for _ in range(opt.m)]
    out_share = await d_pp(
        pack_consecutive(pp, F.encode(num, dev))[opt.id],
        pack_consecutive(pp, F.encode(den, dev))[opt.id], pp, net,
    )

    def king_reveal(shares):
        return [unpack_shares(pp, torch.stack(shares))] * pp.n

    clear = await net.king_compute(out_share, king_reveal, 1)
    if opt.id != 0:
        return True
    want, acc = [], 1
    for nu, de in zip(num, den):
        acc = acc * nu % R * rm.finv(de, R) % R
        want.append(acc)
    return [int(v) for v in F.decode(clear)] == want


KERNELS = {"dfft": _run_dfft, "dmsm": _run_dmsm, "dpp": _run_dpp}


async def run(opt) -> int:
    dev = open_device(opt.device)
    n = party_count(opt)
    if n % 4 != 0:
        raise ValueError(f"party count {n} is not 4l")
    pp = pss(n // 4)
    if opt.m % pp.l != 0:
        raise ValueError(f"--m {opt.m} is not a multiple of l = {pp.l}")
    net = await connect(opt, n, dev)
    try:
        t0 = time.perf_counter()
        ok = await KERNELS[opt.kernel](opt, pp, net, dev)
        drain(dev)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        await net.close()
    if opt.id == 0:
        print(f"rank 0: {opt.kernel} vs host ground truth: "
              f"{'OK' if ok else 'FAILED'}")
    report({"party": opt.id, "ok": ok, "kernel": opt.kernel, "ms": ms,
            **device_stats(dev)})
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_star_args(p)
    p.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    p.add_argument("--m", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    return asyncio.run(run(p.parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
