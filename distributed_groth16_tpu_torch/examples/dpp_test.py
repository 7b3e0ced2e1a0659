"""d_pp correctness example — the port of the JAX package's
examples/dpp_test.py (dist-primitives/examples/dpp_test.rs): the
distributed partial-products protocol with num = den = (1..m), whose
prefix ratios are identically one, checked after unpacking at the king.

  python -m distributed_groth16_tpu_torch.examples.dpp_test \\
      [--m 1024] [--l 2] [--device cpu]

The flags, defaults and printed lines are the JAX example's, plus --device
(default cuda; only an explicit cpu runs on the CPU). The last output
line is JSON: run()'s dict. The timed window ends in
torch.cuda.synchronize(); the encode and the check are host_s.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops.field import fr
from ..parallel.dpp import d_pp
from ..parallel.net import simulate_network_round
from ..parallel.packing import pack_consecutive, unpack_shares
from ..parallel.pss import pss
from ._star import drain, open_device


def run(m: int = 1 << 10, l: int = 2, device=None) -> dict:
    dev = open_device(device)
    F = fr()
    pp = pss(l)
    t0 = time.perf_counter()
    x = list(range(1, m + 1))  # dpp_test.rs:20-22
    x_mont = F.encode(x, dev)
    host_s = time.perf_counter() - t0
    shares = pack_consecutive(pp, x_mont)

    async def party(net, share):
        return await d_pp(share, share, pp, net)

    drain(dev)
    t0 = time.perf_counter()
    outs = simulate_network_round(pp.n, party,
                                  [shares[i] for i in range(pp.n)])
    drain(dev)
    dpp_s = time.perf_counter() - t0
    print(f"d_pp (n={pp.n}, m={m}) in {dpp_s:.2f}s")

    t0 = time.perf_counter()
    got = [int(v) for v in F.decode(unpack_shares(pp, torch.stack(outs, 0)))]
    ok = got == [1] * m  # dpp_test.rs:25-26
    host_s += time.perf_counter() - t0
    print(f"prefix products of x/x are all one: {ok}")
    return {"m": m, "l": l, "n": pp.n, "ok": ok, "dpp_s": dpp_s,
            "host_s": host_s, "device": str(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=1 << 10)
    p.add_argument("--l", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    res = run(args.m, args.l, args.device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
