"""The distributed Groth16 prover over real sockets, one OS process per
party — the port of the JAX package's examples/nonlocal_sha256.py, the
reference's headline deployment (groth16/examples/nonlocal_sha256.rs:126,
launched by scripts/sha256.zsh).

Every rank builds the circuit and witness deterministically, gets the
proving key (rank 0 runs setup and publishes it; the others wait for it
and load it), packs the same PSS dealing, keeps its own row, and runs the
proving round over a ProdNet star (mTLS unless --plain). Rank 0
reassembles the proof and checks the pairing.

  python -m distributed_groth16_tpu_torch.examples.nonlocal_sha256 \\
      --id <rank> --input <addressfile> --certs <certdir> --n 8 \\
      [--circuit sha256|chain] [--msg abc] [--plain] [--device cpu] \\
      [--cache-dir DIR]

The key is cached as pk_<digest>.npz under --cache-dir (default
.bench_cache/torch/ at the root of the checkout). Rank 0's key keeps its
dealer scalars, so rank 0 packs by the scalar route; the loaded .npz has
none, so ranks 1.. pack in the exponent. The shares are equal as affine
points, so the proof is the same.

The last output line is JSON: {"party", "ok", "phases_ms", "round_ms"
(this rank's h / ab / c), "launches", "peak_bytes"}, and on rank 0 also
"verified" and "proof" (the hex of the affine proof, a | b | c as 32-byte
little-endian words). With DG16_AGG set (the aggregation plane) every
rank drops its dealer spans before the round, each client ships its
round's spans to the king in a TELEMETRY frame, and rank 0 waits for
them and adds "agg": the parties merged, each track's span names, the
last critical path, and per peer the clock estimate and wire counters
(star_telemetry below). A client's frame merges once the king has a
clock sample from it, so set DG16_NET_HEARTBEAT_S well below the
round's length.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import asyncio
import hashlib
import os
import sys
import time
from pathlib import Path

from ..models.groth16 import (
    CompiledR1CS,
    ProvingKey,
    distributed_prove_party,
    pack_from_witness,
    pack_proving_key,
    reassemble_proof,
    setup,
    verify,
)
from ..ops.field import fr
from ..parallel.pss import pss
from ..parallel.prodnet import ProdNet
from ..telemetry import aggregate
from ..telemetry import metrics as _tm
from ..utils.timers import PhaseTimings, phase
from ._star import (
    add_star_args, connect, device_stats, drain, open_device, party_count,
    report, reset_peak,
)

DEFAULT_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache" / "torch"


def build_circuit(opt):
    """(r1cs, z, public inputs) of --circuit."""
    if opt.circuit == "sha256":
        from ..frontend.sha256 import sha256_circuit

        cs, pubs = sha256_circuit(opt.msg.encode())
        r1cs, z = cs.finish()
        return r1cs, z, pubs
    from ..frontend.r1cs import mult_chain_circuit

    nc = (1 << opt.log2_constraints) - 2
    r1cs, z = mult_chain_circuit(opt.x0, nc).finish()
    return r1cs, z, z[1:r1cs.num_instance]


def load_or_make_pk(r1cs, opt, dev) -> ProvingKey:
    """Rank 0 computes the (deterministic, seed 42) key and publishes it
    by an atomic rename; the other ranks wait for the file and load it —
    the trusted-dealer role the reference's examples play in-process."""
    key = hashlib.sha256(
        f"{opt.circuit}-{r1cs.num_constraints}-{r1cs.num_wires}".encode()
    ).hexdigest()[:16]
    os.makedirs(opt.cache_dir, exist_ok=True)
    path = os.path.join(opt.cache_dir, f"pk_{key}.npz")
    if os.path.exists(path):
        return ProvingKey.load(path, device=dev)
    if opt.id == 0:
        pk = setup(r1cs, device=dev)
        tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
        pk.save(tmp)  # savez keeps the name verbatim (.npz suffix present)
        os.replace(tmp, path)
        return pk
    deadline = time.time() + opt.setup_timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError("rank 0 never published the proving key")
        time.sleep(0.5)
    return ProvingKey.load(path, device=dev)


async def await_tracks(net: ProdNet, timeout_s: float) -> bool:
    """King side, aggregation plane on: wait until every party's
    TELEMETRY has merged and the round is closed (a client's frame waits
    for its first clock sample, so this takes up to a heartbeat interval
    or two). False when `timeout_s` passes first; close() then merges any
    frame still held, unaligned."""
    agg = aggregate.aggregator()
    end = asyncio.get_running_loop().time() + timeout_s
    while set(agg.parties()) < set(range(net.n_parties)) or (
        agg.last_critical_path is None
    ):
        if asyncio.get_running_loop().time() > end:
            return False
        await asyncio.sleep(0.05)
    return True


def _peer_sum(name: str, peer: int) -> float:
    """A per-peer counter summed over its other labels (0 when the
    family was never registered)."""
    fam = _tm.registry().family(name)
    if fam is None:
        return 0.0
    i = fam.labelnames.index("peer")
    return sum(child.value for key, child in fam.items()
               if key[i] == str(peer))


def star_telemetry(net: ProdNet) -> dict:
    """The king's aggregation plane after a round: the tracks merged, each
    track's span names with their counts, the last round's critical path
    (seconds), and per peer the clock estimate (samples, offset and rtt
    in ns) and the wire counters."""
    agg = aggregate.aggregator()
    spans: dict[str, dict[str, int]] = {}
    for e in agg.events():
        names = spans.setdefault(str(e["pid"]), {})
        names[e["name"]] = names.get(e["name"], 0) + 1
    peers = {}
    for peer, clock in sorted(net._clocks.items()):
        peers[str(peer)] = {
            "clock_samples": clock.n_samples,
            "offset_ns": clock.offset_ns,
            "rtt_ns": clock.rtt_ns,
            **{key: _peer_sum(name, peer) for key, name in (
                ("bytes_sent", "net_bytes_sent_total"),
                ("bytes_recv", "net_bytes_recv_total"),
                ("frames_sent", "net_frames_sent_total"),
                ("frames_recv", "net_frames_recv_total"),
                ("heartbeats_sent", "net_heartbeats_sent_total"),
                ("telemetry_frames_recv", "telemetry_frames_recv_total"),
            )},
        }
    return {"parties": len(agg.parties()), "tracks": agg.parties(),
            "spans": spans, "critical_path": agg.last_critical_path,
            "peers": peers}


def proof_bytes(proof) -> bytes:
    """Affine coordinates as 32-byte little-endian words, a | b | c."""
    words = [*proof.a, *proof.b[0], *proof.b[1], *proof.c]
    return b"".join(int(w).to_bytes(32, "little") for w in words)


async def run(opt) -> int:
    dev = open_device(opt.device)
    reset_peak(dev)
    n = party_count(opt)
    if n % 4 != 0:
        raise ValueError(f"party count {n} is not 4l")
    pp = pss(n // 4)
    timings = PhaseTimings()

    with phase("build circuit", timings):
        r1cs, z, pubs = build_circuit(opt)
    with phase("setup/load pk", timings):
        pk = load_or_make_pk(r1cs, opt, dev)
        drain(dev)
    with phase("packing", timings):
        z_mont = fr().encode(z, dev)
        qap_share = CompiledR1CS(r1cs, dev).qap(z_mont).pss(pp)[opt.id]
        crs_share = pack_proving_key(pk, pp, strip=True)[opt.id]
        a_share = pack_from_witness(pp, z_mont[1:])[opt.id]
        ax_share = pack_from_witness(pp, z_mont[r1cs.num_instance:])[opt.id]
        drain(dev)
    with phase("connect", timings):
        net = await connect(opt, n, dev)
    round_ms: dict = {}
    agg = None
    if aggregate.enabled():
        # the dealer phases and the connect are this process's spans too:
        # drop them so the merged trace covers exactly the round
        aggregate.drain()
    try:
        with phase("MPC prove (over sockets)", timings):
            share = await distributed_prove_party(
                pp, crs_share, qap_share, a_share, ax_share, net,
                timings=round_ms,
            )
            drain(dev)
        if aggregate.enabled():
            # the phase span wraps the whole round: keep it out of the
            # shutdown flush, as the dealer's spans are kept out above
            aggregate.drain()
            if opt.id == 0:
                waited = await await_tracks(
                    net, 10.0 + 4 * net.net_cfg.heartbeat_interval_s)
                agg = dict(star_telemetry(net), complete=waited)
    finally:
        await net.close()

    line = {"party": opt.id, "ok": True, "phases_ms": timings.as_millis(),
            "round_ms": round_ms}
    if agg is not None:
        line["agg"] = agg
    if opt.id == 0:
        proof = reassemble_proof(share, pk)
        ok = verify(pk.vk, proof, pubs)
        print(f"rank 0: pairing verification {'OK' if ok else 'FAILED'}")
        line.update(ok=ok, verified=ok, proof=proof_bytes(proof).hex())
    print(f"rank {opt.id} phase timings (ms):")
    for k, v in timings.as_millis().items():
        print(f"  {k:30s} {v:10.1f}")
    report({**line, **device_stats(dev)})
    return 0 if line["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_star_args(p)
    p.add_argument("--circuit", choices=("sha256", "chain"), default="sha256")
    p.add_argument("--msg", default="hello world")
    p.add_argument("--log2-constraints", type=int, default=10)
    p.add_argument("--x0", type=int, default=999992)
    p.add_argument("--setup-timeout", type=float, default=1800.0)
    p.add_argument("--cache-dir", default=str(DEFAULT_CACHE),
                   help="where the proving key is cached")
    return asyncio.run(run(p.parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
