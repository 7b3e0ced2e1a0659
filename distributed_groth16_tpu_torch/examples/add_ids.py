"""Prod-net smoke test: every party contributes its id, the king sums and
broadcasts — the mpc-net/examples/add_ids.rs protocol, as the JAX
package's examples/add_ids.py runs it.

Run one process per rank (or all of them with launch.py):
  python -m distributed_groth16_tpu_torch.examples.add_ids --id 0 \\
      --input addresses --certs certs_dir --n 4 [--plain] [--device cpu]
The address file holds one host:port per rank (rank 0 = the king's bind
address); certs_dir holds <rank>.cert.pem / <rank>.key.pem for every rank
(python -m distributed_groth16_tpu_torch.utils.certs <rank> certs_dir).
The last output line is JSON: {"party", "ok", "sum"}.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import asyncio
import sys

from ._star import add_star_args, connect, open_device, party_count, report


async def run(opt) -> int:
    dev = open_device(opt.device)
    n = party_count(opt)
    net = await connect(opt, n, dev)
    try:
        total = await net.king_compute(
            net.party_id, lambda ids: [sum(ids)] * n
        )
    finally:
        await net.close()
    expected = n * (n - 1) // 2
    print(f"party {opt.id}: sum of ids = {total} (expected {expected})")
    report({"party": opt.id, "ok": total == expected, "sum": total})
    return 0 if total == expected else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="prod-net sum-of-ids smoke test")
    add_star_args(p)
    return asyncio.run(run(p.parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
