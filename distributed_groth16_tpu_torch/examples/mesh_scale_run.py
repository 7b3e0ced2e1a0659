"""Mesh-prover scale run — the port of the JAX package's
scripts/mesh_scale_run.py: the FULL proving step of the mesh prover
(models/groth16/mesh_prover.py) at a real domain size over the n = 8
parties' mesh (parallel/mesh.py), checked against the single-node proof.

  python -m distributed_groth16_tpu_torch.examples.mesh_scale_run \\
      [--m 4096] [--check] [--device cpu] [--devices cuda:0,cuda:1,...]

The flags, defaults and printed lines are the JAX script's, plus
--device (default cuda; only an explicit cpu runs on the CPU) and
--devices. The last output line is JSON: run()'s dict.

Departures from the JAX script:
  * the JAX mesh puts one party on each of 8 devices, forced on the host
    with --xla_force_host_platform_device_count=8 and pinned to the CPU
    (jax_platforms). The port's default mesh is one shard holding all 8
    parties on --device; --devices gives a comma list with one party an
    entry, as make_mesh_from_devices takes it (8 entries; they may
    repeat, e.g. cpu,cpu,... or cuda:0 eight times), and the key, the
    circuit and the inputs stay on --device, the king's. Nothing forces
    virtual devices. setup_compile_cache is gone (no XLA cache);
  * nothing is jitted: "mesh prove (first call)" holds the first use of
    the kernels and tables where JAX's held the compile;
  * every phase ends in torch.cuda.synchronize().
"""

# dg16lint: disable-file=DG108 — the printed lines are the script's output
# contract, as in the JAX script

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..frontend.r1cs import mult_chain_circuit
from ..models.groth16 import (
    CompiledR1CS,
    pack_from_witness,
    pack_proving_key,
    prove_single,
    reassemble_proof,
    setup,
    verify,
)
from ..models.groth16.mesh_prover import MeshProverInputs, mesh_prove
from ..models.groth16.prove import PartyProofShare
from ..ops.field import fr
from ..parallel.mesh import make_mesh, make_mesh_from_devices
from ..parallel.pss import pss
from ..utils.timers import PhaseTimings, phase
from ._star import device_stats, drain, open_device, reset_peak


def run(m: int = 4096, check: bool = False, device=None,
        devices=None) -> dict:
    dev = open_device(device)
    reset_peak(dev)
    timings = PhaseTimings()
    pp = pss(2)
    nc = m - 2
    with phase("build circuit", timings):
        r1cs, z = mult_chain_circuit(999992, nc).finish()
    with phase("setup", timings):
        pk = setup(r1cs, device=dev)
        drain(dev)
    m = pk.domain_size
    z_mont = fr().encode(z, dev)
    comp = CompiledR1CS(r1cs, dev)

    with phase("packing", timings):
        qap_shares = comp.qap(z_mont).pss(pp)
        # strip=True: nothing below reads the dealer's query scalars
        crs = pack_proving_key(pk, pp, strip=True)

        def stack(get):
            return torch.stack([get(i) for i in range(pp.n)])

        inp = MeshProverInputs(
            qap_a=stack(lambda i: qap_shares[i].a),
            qap_b=stack(lambda i: qap_shares[i].b),
            qap_c=stack(lambda i: qap_shares[i].c),
            a_share=pack_from_witness(pp, z_mont[1:]),
            ax_share=pack_from_witness(pp, z_mont[r1cs.num_instance:]),
            s=stack(lambda i: crs[i].s),
            u=stack(lambda i: crs[i].u),
            v=stack(lambda i: crs[i].v),
            w=stack(lambda i: crs[i].w),
        )
        drain(dev)
        del qap_shares, crs

    mesh = (make_mesh(pp.n, dev) if devices is None
            else make_mesh_from_devices(devices))
    if mesh.n != pp.n:
        raise ValueError(f"--devices names {mesh.n} parties, the mesh "
                         f"prover runs n = {pp.n}")
    with phase("mesh prove (first call)", timings):
        pa, pb, pc = mesh_prove(pp, m, mesh, inp)
        drain(dev)
    first_ms = timings.as_millis()["mesh prove (first call)"]
    with phase("mesh prove (steady-state rerun)", timings):
        pa, pb, pc = mesh_prove(pp, m, mesh, inp)
        drain(dev)

    print(f"mesh proving step ran at m={m}, n={pp.n} parties "
          f"(first call: {first_ms / 1e3:.1f}s)")
    out = {"m": m, "n": pp.n, "l": pp.l, "ok": True}
    if check:
        with phase("host-oracle check", timings):
            single = prove_single(pk, comp, z_mont)
            proof = reassemble_proof(PartyProofShare(a=pa, b=pb, c=pc), pk)
            ok = verify(pk.vk, proof, z[1 : r1cs.num_instance])
            match = (proof.a, proof.b, proof.c) == (
                single.a, single.b, single.c,
            )
        print(f"pairing verify: {ok}; matches single-node: {match}")
        out.update(ok=ok and match, verified=ok, matches_single=match)
    print("phase timings (ms):")
    for k, v in timings.as_millis().items():
        print(f"  {k:34s} {v:12.1f}")
    out.update(phases_ms=timings.as_millis(), device=str(dev),
               shards=[str(d) for d in mesh.devices], **device_stats(dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=4096)
    p.add_argument("--check", action="store_true",
                   help="verify the proof cores against the host oracle")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--devices", default=None,
                   help="comma list of the shards' devices, one party an "
                        "entry (default: one shard on --device)")
    args = p.parse_args(argv)
    res = run(args.m, args.check, args.device,
              None if args.devices is None else args.devices.split(","))
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
