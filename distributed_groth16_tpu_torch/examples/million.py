"""Million-constraint chain proof — the port of the JAX package's
examples/million.py, the fixtures/million workload
(groth16/examples/million.rs: a 1M-constraint multiplicative chain,
public input = the chain output), proved by n = 4l parties simulated in
one process (LocalSimNet), or single-node with --skip-mpc.

  python -m distributed_groth16_tpu_torch.examples.million \\
      [--log2-constraints 20] [--l 2] [--x0 999992] [--skip-mpc] \\
      [--round-retries 2] [--trace-out t.json] [--agg-out m.json] \\
      [--match-single] [--device cpu]

BASELINE config 4 is the default: 2^20 constraints, l = 2, n = 8. Use a
smaller --log2-constraints on the CPU.

The flags, defaults and printed lines are the JAX example's, plus --device
(default cuda; only an explicit cpu runs on the CPU) and --match-single.
The last output line is JSON: run()'s dict (phases_ms, the king's round
marks round_ms, the pack's ms per query pack_ms, the kernels' launch
counts and the peak device bytes; with --agg-out also agg_tracks and
critical_path, the round's king / straggler / wire / wall split in
seconds).

--agg-out turns the aggregation plane on (DG16_AGG), drops the dealer's
spans before the round, and after it writes the merged per-party trace
(one track per party) and prints the round's critical path. Its spans
mark host time: a span can close before the device work it launched.

Departures from the JAX example:
  * --match-single also proves single-node on the same key and requires
    the MPC proof to equal it (both at r = s = 0);
  * two more phases: "compile" (the witness encode and CompiledR1CS,
    outside any phase in JAX) and "verify" (the host pairing check);
  * every phase ends in torch.cuda.synchronize(), so its wall time holds
    its device work; the in-process round runs with op_timeout_s = 0
    unless DG16_NET_OP_TIMEOUT_S is set, as in JAX.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace

from ..frontend.r1cs import mult_chain_circuit
from ..models.groth16 import (
    CompiledR1CS,
    distributed_prove_party,
    pack_from_witness,
    pack_proving_key,
    prove_single,
    reassemble_proof,
    setup,
    verify,
)
from ..ops.field import fr
from ..parallel.net import run_round_with_retries
from ..parallel.pss import pss
from ..telemetry import aggregate, tracing
from ..utils.config import NetConfig, env_str
from ..utils.timers import PhaseTimings, phase
from ._star import device_stats, drain, open_device, reset_peak


def run(log2_constraints: int = 20, l: int = 2, x0: int = 999992,
        skip_mpc: bool = False, round_retries: int = 2,
        trace_out: str | None = None, match_single: bool = False,
        device=None, agg_out: str | None = None) -> dict:
    dev = open_device(device)
    reset_peak(dev)
    if trace_out:
        tracing.enable_global(trace_out)
    agg_was_on = aggregate.enabled()
    if agg_out:
        aggregate.set_enabled(True)
        aggregate.reset_aggregator()
    timings = PhaseTimings()
    nc = (1 << log2_constraints) - 2  # domain = 2^log2_constraints

    with phase("build circuit", timings):
        r1cs, z = mult_chain_circuit(x0, nc).finish()
    print(f"chain circuit: {r1cs.num_constraints} constraints")

    with phase("setup", timings):
        pk = setup(r1cs, device=dev)
        drain(dev)
    print(f"setup done (m = {pk.domain_size})")

    with phase("compile", timings):
        z_mont = fr().encode(z, dev)
        comp = CompiledR1CS(r1cs, dev)
        drain(dev)
    pubs = z[1 : r1cs.num_instance]
    out = {"log2_constraints": log2_constraints,
           "constraints": r1cs.num_constraints, "m": pk.domain_size,
           "mpc": not skip_mpc}

    if skip_mpc:
        with phase("single-node prove", timings):
            proof = prove_single(pk, comp, z_mont)
            drain(dev)
        with phase("verify", timings):
            ok = verify(pk.vk, proof, pubs)
        print(f"single-node proof verifies: {ok}")
        out.update(ok=ok, verified=ok)
    else:
        pp = pss(l)
        pack_ms: dict = {}
        with phase("packing", timings):
            qap_shares = comp.qap(z_mont).pss(pp)
            # strip=True: the dealer's trapdoor-derived query scalars are
            # destroyed the moment the shares exist (keys.py hazard note)
            crs_shares = pack_proving_key(pk, pp, strip=True,
                                          timings=pack_ms)
            a_sh = pack_from_witness(pp, z_mont[1:])
            ax_sh = pack_from_witness(pp, z_mont[r1cs.num_instance:])
            drain(dev)

        round_ms: dict = {}

        async def party(net, d):
            # the king's h / ab / c marks
            return await distributed_prove_party(
                pp, d[0], d[1], d[2], d[3], net,
                timings=round_ms if net.party_id == 0 else None)

        # In-process round: all parties share ONE event loop, so a long
        # synchronous compute phase blocks every timer and an op deadline
        # can false-fire on loop resume even though the data arrived.
        # Deadlines also can't detect a dead peer here (there is no peer
        # process) — default them off unless explicitly configured.
        net_cfg = NetConfig.from_env()
        if not env_str("DG16_NET_OP_TIMEOUT_S"):
            net_cfg = replace(net_cfg, op_timeout_s=0.0)

        if agg_out:
            # the dealer phases above (setup, packing) are king-process
            # spans too; drop them so the merged trace and the
            # critical-path decomposition cover exactly the MPC round
            aggregate.drain()

        with phase("MPC Proof", timings):
            # a transient transport fault (timeout, dead link) re-runs the
            # round on a fresh fabric instead of losing a long proof
            res = run_round_with_retries(
                pp.n,
                party,
                [(crs_shares[i], qap_shares[i], a_sh[i], ax_sh[i])
                 for i in range(pp.n)],
                retries=round_retries,
                net_cfg=net_cfg,
                on_retry=lambda a, e: print(
                    f"MPC round attempt {a + 1} failed ({e}); retrying"
                ),
            )
            drain(dev)
        del crs_shares, qap_shares, a_sh, ax_sh
        with phase("verify", timings):
            proof = reassemble_proof(res[0], pk)
            ok = verify(pk.vk, proof, pubs)
        print(f"MPC proof verifies: {ok}")
        out.update(ok=ok, verified=ok, l=pp.l, n=pp.n, pack_ms=pack_ms,
                   round_ms=round_ms)
        if agg_out:
            agg = aggregate.aggregator()
            agg.dump(agg_out)
            print(f"merged star trace ({len(agg.parties())} tracks) "
                  f"written to {agg_out}")
            cp = agg.last_critical_path
            if cp:
                print("round critical path (s): "
                      f"king {cp['king']:.3f}  "
                      f"straggler {cp['straggler']:.3f} "
                      f"(party {cp['stragglerParty']})  "
                      f"wire {cp['wire']:.3f}  wall {cp['wall']:.3f}")
            out.update(agg_tracks=len(agg.parties()), critical_path=cp)
            aggregate.set_enabled(agg_was_on)
        if match_single:
            with phase("single-node prove", timings):
                single = prove_single(pk, comp, z_mont)
                drain(dev)
            same = (proof.a, proof.b, proof.c) == (single.a, single.b,
                                                   single.c)
            print(f"MPC proof equals the single-node proof: {same}")
            out.update(ok=ok and same, matches_single=same)

    print("phase timings (ms):")
    for k, v in timings.as_millis().items():
        print(f"  {k:30s} {v:12.1f}")
    if trace_out:
        print(f"trace written to {tracing.flush_global()}")
    out.update(phases_ms=timings.as_millis(), device=str(dev),
               **device_stats(dev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2-constraints", type=int, default=20)
    p.add_argument("--l", type=int, default=2)
    p.add_argument("--x0", type=int, default=999992)
    p.add_argument("--skip-mpc", action="store_true",
                   help="setup + single-node prove only")
    p.add_argument("--round-retries", type=int, default=2,
                   help="re-run the MPC round up to this many times on a "
                        "transient transport fault (MpcNetError) instead "
                        "of losing the whole proof")
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome trace-event JSON timeline of the "
                        "proof (open in chrome://tracing or Perfetto)")
    p.add_argument("--agg-out", default=None,
                   help="enable the star-wide aggregation plane (DG16_AGG) "
                        "and write the merged per-party trace here, with a "
                        "critical-path summary — king vs straggler vs wire")
    p.add_argument("--match-single", action="store_true",
                   help="also prove single-node on the same key; the MPC "
                        "proof must equal it")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    res = run(args.log2_constraints, args.l, args.x0, args.skip_mpc,
              args.round_retries, args.trace_out, args.match_single,
              args.device, args.agg_out)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    t0 = time.time()
    code = main()
    print(f"total {time.time() - t0:.1f}s")
    sys.exit(code)
