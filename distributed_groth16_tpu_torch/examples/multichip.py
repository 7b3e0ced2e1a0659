"""Multi-device dry run — the port of the JAX package's
`__graft_entry__.py` `dryrun_multichip(n)`: the FULL zero-knowledge proving
step of the mesh prover (`build_mesh_prover(..., zk=True)`: the h-poly
pipelines, the 4-row batched G1 d_msm and the G2 d_msm) over an n-party
mesh with one party a device shard, on generator-filled inputs at m = 16.

  python -m distributed_groth16_tpu_torch.examples.multichip \\
      [--n 8] [--device cpu]

n is a power of two >= 4 and l = n/4, as the JAX assertion demands. Shard
j sits on card j mod torch.cuda.device_count(), so on a host with fewer
cards than parties several shards share a card; under --device cpu every
shard is on the CPU. Prints the JAX line, then a JSON line naming each
shard's device, with the process's kernel launches and the king's peak
memory; run() returns that line's dict.

Departures from the JAX entry point:
  * the JAX dry run forces n virtual CPU devices
    (--xla_force_host_platform_device_count) and pins JAX to the CPU; the
    port drives real shards from one process (parallel/mesh.py) and sets
    no environment. setup_compile_cache is gone (no XLA cache);
  * nothing is jitted: the step's first use of the kernels and tables
    stands where JAX's compile stood;
  * the inputs are encoded once on the king's device and sharded on
    entry; the generator-filled CRS tables are `expand` views, placed one
    row a shard.
"""

# dg16lint: disable-file=DG108 — the printed lines are the script's output
# contract, as in the JAX entry point

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.groth16.mesh_prover import MeshProverInputs, build_mesh_prover
from ..ops.constants import G1_GENERATOR, G2_GENERATOR
from ..ops.curve import g1, g2
from ..ops.field import fr, resolve_device
from ..parallel.mesh import make_mesh_from_devices
from ..parallel.pss import PackedSharingParams
from ._star import device_stats, drain, reset_peak

M = 16  # the JAX dry run's tiny QAP domain


def shard_devices(n: int, device=None) -> list:
    """One device a party: card j mod the card count, or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device (pass --device cpu)")
    return [torch.device("cuda", j % cards) for j in range(n)]


def run(n_devices: int = 8, device=None) -> dict:
    if n_devices < 4 or n_devices & (n_devices - 1):
        raise ValueError("party count must be a power of two >= 4 (n = 4l)")
    l = n_devices // 4
    pp = PackedSharingParams(l)
    mesh = make_mesh_from_devices(shard_devices(n_devices, device))
    king = mesh.device
    F = fr()
    c = M // l
    rng = np.random.default_rng(0)

    def rand_shares(k):
        return F.encode(rng.integers(1, 1 << 62, size=(pp.n, k)), king)

    def pts(k, curve, gen):
        g = curve.encode([gen], king)[0]
        return g.expand((pp.n, k) + g.shape)

    inp = MeshProverInputs(
        qap_a=rand_shares(c),
        qap_b=rand_shares(c),
        qap_c=rand_shares(c),
        a_share=rand_shares(c),
        ax_share=rand_shares(c),
        s=pts(c, g1(), G1_GENERATOR),
        u=pts(M // l, g1(), G1_GENERATOR),
        v=pts(c, g2(), G2_GENERATOR),
        w=pts(c, g1(), G1_GENERATOR),
        h=pts(c, g1(), G1_GENERATOR),
    )
    reset_peak(king)  # after the first op on the card: it needs a context
    t0 = time.perf_counter()
    prover = build_mesh_prover(pp, M, mesh, zk=True)
    out = prover(
        inp.qap_a, inp.qap_b, inp.qap_c, inp.a_share, inp.ax_share,
        inp.s, inp.u, inp.v, inp.w, inp.h,
    )
    for d in dict.fromkeys(mesh.devices):
        drain(d)
    seconds = time.perf_counter() - t0
    print(
        f"dryrun_multichip: n={pp.n} parties (l={l}) over "
        f"{n_devices}-device mesh — full zk proving step compiled and ran"
    )
    return {
        "n": pp.n, "l": l, "m": M,
        "shards": [str(d) for d in mesh.devices],
        "cards": len({d for d in mesh.devices if d.type == "cuda"}),
        "outputs": [list(x.shape) for x in out],
        "output_device": str(out[0].device),
        "seconds": seconds,
        **device_stats(king),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=8,
                   help="parties = shards (a power of two >= 4)")
    p.add_argument("--device", default=None,
                   help="cpu puts every shard on the CPU (default: the "
                        "cards, shard j on card j mod their count)")
    args = p.parse_args(argv)
    print(json.dumps(run(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
