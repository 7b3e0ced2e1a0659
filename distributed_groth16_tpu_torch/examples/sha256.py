"""End-to-end SHA-256 proving — the port of the JAX package's
examples/sha256.py, the reference's flagship example
(groth16/examples/sha256.rs): build the circuit, setup, prove
single-node, then pack everything and prove with n = 4l parties simulated
in one process (LocalSimNet); verify both via the pairing check, require
the MPC proof to equal the single-node one, print phase timings.

  python -m distributed_groth16_tpu_torch.examples.sha256 \\
      [--msg "hello world"] [--l 2] [--skip-mpc] [--cache-dir DIR] \\
      [--device cpu]

The proving key is cached as pk_<digest>.npz under --cache-dir (default
.bench_cache/torch/ at the root of the checkout, never the JAX package's
.bench_cache/), so repeat runs skip setup. A fresh key keeps its dealer
scalars and packs by the scalar route; a cached one was saved without
them (ProvingKey.save) and packs in the exponent (the point route). The
shares are equal as affine points, so the proof is the same; the example
prints which route ran.

The flags, defaults and printed lines are the JAX example's, plus --device
(default cuda; only an explicit cpu runs on the CPU) and --cache-dir. The
last output line is JSON: run()'s dict. Every phase ends in
torch.cuda.synchronize().
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from ..frontend.sha256 import sha256_circuit
from ..models.groth16 import (
    CompiledR1CS,
    ProvingKey,
    distributed_prove_party,
    pack_from_witness,
    pack_proving_key,
    prove_single,
    reassemble_proof,
    setup,
    verify,
)
from ..ops.field import fr
from ..parallel.net import simulate_network_round
from ..parallel.pss import pss
from ..utils.timers import PhaseTimings, phase
from ._star import device_stats, drain, open_device, reset_peak
from .nonlocal_sha256 import DEFAULT_CACHE


def run(msg: str = "hello world", l: int = 2, skip_mpc: bool = False,
        cache_dir: str = str(DEFAULT_CACHE), device=None) -> dict:
    dev = open_device(device)
    reset_peak(dev)
    timings = PhaseTimings()

    with phase("build circuit", timings):
        cs, pubs = sha256_circuit(msg.encode())
        r1cs, z = cs.finish()
    print(f"sha256 circuit: {r1cs.num_constraints} constraints")

    cache_key = hashlib.sha256(
        f"sha256-{r1cs.num_constraints}-{r1cs.num_wires}".encode()
    ).hexdigest()[:16]
    os.makedirs(cache_dir, exist_ok=True)
    pk_path = os.path.join(cache_dir, f"pk_{cache_key}.npz")

    with phase("setup", timings):
        cached = os.path.exists(pk_path)
        if cached:
            pk = ProvingKey.load(pk_path, device=dev)
        else:
            pk = setup(r1cs, device=dev)
            pk.save(pk_path)
        drain(dev)
    print(f"setup done (m = {pk.domain_size})")

    z_mont = fr().encode(z, dev)
    comp = CompiledR1CS(r1cs, dev)

    with phase("Arkworks-role single-node proof", timings):
        proof_single = prove_single(pk, comp, z_mont)
        drain(dev)
    if not verify(pk.vk, proof_single, pubs):
        raise AssertionError("single-node proof invalid")
    print("single-node proof verifies")
    out = {"constraints": r1cs.num_constraints, "m": pk.domain_size,
           "key_cached": cached, "ok": True}

    if not skip_mpc:
        pp = pss(l)
        route = "scalar" if pk.query_scalars is not None else "point"
        with phase("packing", timings):
            qap_shares = comp.qap(z_mont).pss(pp)
            crs_shares = pack_proving_key(pk, pp, strip=True)
            a_sh = pack_from_witness(pp, z_mont[1:])
            ax_sh = pack_from_witness(pp, z_mont[r1cs.num_instance:])
            drain(dev)
        print(f"CRS packed by the {route} route")

        async def party(net, d):
            return await distributed_prove_party(pp, d[0], d[1], d[2], d[3],
                                                 net)

        with phase("MPC Proof", timings):
            res = simulate_network_round(
                pp.n,
                party,
                [(crs_shares[i], qap_shares[i], a_sh[i], ax_sh[i])
                 for i in range(pp.n)],
            )
            drain(dev)
        proof = reassemble_proof(res[0], pk)
        if not verify(pk.vk, proof, pubs):
            raise AssertionError("MPC proof invalid")
        if (proof.a, proof.b, proof.c) != (proof_single.a, proof_single.b,
                                           proof_single.c):
            raise AssertionError("MPC proof differs from the single-node one")
        print(f"MPC proof (n={pp.n}, l={pp.l}) verifies, matches single-node")
        out.update(l=pp.l, n=pp.n, pack_route=route)

    print("phase timings (ms):")
    for k, v in timings.as_millis().items():
        print(f"  {k:38s} {v:12.1f}")
    out.update(phases_ms=timings.as_millis(), device=str(dev),
               **device_stats(dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--msg", default="hello world")
    p.add_argument("--l", type=int, default=2)
    p.add_argument("--skip-mpc", action="store_true")
    p.add_argument("--cache-dir", default=str(DEFAULT_CACHE),
                   help="where the proving key is cached")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    res = run(args.msg, args.l, args.skip_mpc, args.cache_dir, args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    t0 = time.time()
    code = main()
    print(f"total {time.time() - t0:.1f}s")
    sys.exit(code)
