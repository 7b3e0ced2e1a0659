"""The port's telemetry plane on the MPC path (parallel/net.py and
prodnet.py, the prove / dfft / dmsm spans, the route and verifier
metrics of distributed_groth16_tpu_torch) against the JAX package's.

Seeded numpy inputs go through both packages where both run the same
round: the span names per party and the collective histograms' counts
per op must be equal. The rest holds the port to the behaviour the JAX
package's tests/test_agg_trace.py pins: a skewed client's spans rebased
by its clock estimate, a TELEMETRY frame held until the first clock
sample, no frame and no drain with the plane off, flight-recorder dumps
on a peer's death and on retry exhaustion, a retry dropping the failed
attempt's spans.

Both packages keep a process-global aggregation plane and flight
recorder; every test enables what it uses, and the autouse fixture puts
both packages' planes back to idle (the JAX package's allocation guard
on its hot path depends on that idle default).
"""

import asyncio
import collections
import glob
import json

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, R
from distributed_groth16_tpu.ops.curve import g1 as jg1
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.ntt import domain as jdomain
from distributed_groth16_tpu.parallel import dfft as jdfft
from distributed_groth16_tpu.parallel import dmsm as jdmsm
from distributed_groth16_tpu.parallel import net as jnet
from distributed_groth16_tpu.parallel import packing as jpacking
from distributed_groth16_tpu.parallel import pss as jpss
from distributed_groth16_tpu.telemetry import aggregate as jaggregate
from distributed_groth16_tpu.telemetry import flight as jflight
from distributed_groth16_tpu.telemetry import metrics as jtm
from distributed_groth16_tpu.telemetry import tracing as jtracing
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops import ntt as tntt
from distributed_groth16_tpu_torch.ops.curve import g1
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.ntt import domain
from distributed_groth16_tpu_torch.parallel import dfft, dmsm, net, packing
from distributed_groth16_tpu_torch.parallel.faults import FaultyIO
from distributed_groth16_tpu_torch.parallel.prodnet import ChannelIO, ProdNet
from distributed_groth16_tpu_torch.parallel.pss import pss
from distributed_groth16_tpu_torch.telemetry import aggregate, flight
from distributed_groth16_tpu_torch.telemetry import metrics as tm
from distributed_groth16_tpu_torch.telemetry import tracing
from distributed_groth16_tpu_torch.utils import serde
from distributed_groth16_tpu_torch.utils.config import NetConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
REG, JREG = tm.registry(), jtm.registry()
FAST = NetConfig(op_timeout_s=5.0, connect_timeout_s=5.0,
                 heartbeat_interval_s=0.0)
OPS = ("send_to", "recv_from", "gather_to_king", "scatter_from_king",
       "king_compute")


@pytest.fixture(autouse=True)
def _planes_off():
    """Both packages' aggregation planes, flight recorders and global
    trace buffers start and end idle."""
    for t, a, f in ((tracing, aggregate, flight),
                    (jtracing, jaggregate, jflight)):
        t.disable_global()
        a.set_enabled(False)
        f.disable()
    yield
    for t, a, f in ((tracing, aggregate, flight),
                    (jtracing, jaggregate, jflight)):
        t.disable_global()
        a.set_enabled(False)
        f.disable()
        a.reset_aggregator()


def _counter(name: str, **labels) -> float:
    fam = REG.family(name)
    if fam is None:
        return 0.0
    return (fam.labels(**labels) if labels else fam).value


def _collective_counts(reg) -> dict:
    fam = reg.family("collective_seconds")
    return {op: fam.labels(op=op).count for op in OPS}


def _bounded(coro, s: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, s))


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(count)]


def _names_by_party(events) -> dict:
    out = collections.defaultdict(collections.Counter)
    for e in events:
        out[e["pid"]][e["name"]] += 1
    return dict(out)


def _ev(name, ts, dur, pid, id, parent=0):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": pid, "tid": 1, "args": {"id": id, "parent": parent}}


def test_dfft_dmsm_round_spans_and_histograms_match_jax(monkeypatch):
    """n = 8, l = 2, m = 16: a d_fft and a d_msm per party over
    LocalSimNet with the plane on in both packages. Each party's
    multiset of span names and the collective histograms' counts per op
    are the JAX round's, and the round merges one track per party."""
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)  # the card's route
    L, M, k = 2, 16, 4
    pp, jp = pss(L), jpss.PackedSharingParams(L)
    n = pp.n
    rng = np.random.default_rng(7)
    vals = _ints(rng, M)
    pts = [rm.G1.scalar_mul(G1_GENERATOR, s) for s in _ints(rng, k)]
    scalars = _ints(rng, k)
    base_sh = [[rm.G1.msm(pts[c * L:(c + 1) * L], row)
                for row in pp.pack_matrix] for c in range(k // L)]
    flat = [base_sh[c][i] for i in range(n) for c in range(k // L)]
    t_in = (packing.pack_strided(pp, fr().encode(vals, CPU)),
            g1().encode(flat, CPU).reshape(n, k // L, 3, 16),
            packing.pack_consecutive(pp, fr().encode(scalars, CPU)))
    j_in = (jpacking.pack_strided(jp, jfr().encode(vals)),
            jg1().encode(flat).reshape(n, k // L, 3, 16),
            jpacking.pack_consecutive(jp, jfr().encode(scalars)))

    def closure(fft, msm, C, dom, p):
        async def party(nt, d):
            ev = await fft(d[0], False, 1, False, dom, p, nt)
            pt = await msm(C, d[1], d[2], p, nt)
            return ev, pt
        return party

    out = {}
    for name, agg, reg, sim, fft, msm, C, dom, p, x in (
        ("port", aggregate, REG, net.simulate_network_round, dfft.d_fft,
         dmsm.d_msm, g1(), domain(M), pp, t_in),
        ("jax", jaggregate, JREG, jnet.simulate_network_round, jdfft.d_fft,
         jdmsm.d_msm, jg1(), jdomain(M), jp, j_in),
    ):
        agg.set_enabled(True)
        a = agg.reset_aggregator()
        before = _collective_counts(reg)
        res = sim(n, closure(fft, msm, C, dom, p),
                  [tuple(v[i] for v in x) for i in range(n)])
        after = _collective_counts(reg)
        out[name] = dict(res=res, parties=a.parties(), cp=a.last_critical_path,
                         names=_names_by_party(a.events()),
                         coll={op: after[op] - before[op] for op in OPS})
    port, jax = out["port"], out["jax"]
    assert port["parties"] == jax["parties"] == list(range(n))
    assert port["names"] == jax["names"]
    assert set(port["names"][0]) == {"dfft.fft", "dmsm", "net.gather_to_king",
                                     "net.scatter_from_king",
                                     "net.king_compute"}
    assert port["coll"] == jax["coll"] and port["coll"]["send_to"] > 0
    assert port["cp"]["parties"] == n and port["cp"]["wall"] > 0
    for i in range(n):
        np.testing.assert_array_equal(
            port["res"][i][0].numpy().astype(np.int64),
            np.asarray(jax["res"][i][0]).astype(np.int64))
    assert g1().decode(port["res"][0][1]) == rm.G1.msm(pts, scalars)


def test_prodnet_star_rebases_a_skewed_client():
    """A 4-party ProdNet d_fft star over ChannelIO (n = 4, l = 1). Each
    party ships its own spans: the clients through TELEMETRY frames, the
    king into its aggregator. Client 2's clock, its heartbeat clock and
    its span timestamps, runs 2 s ahead: the king's estimate converges to
    the skew within 0.1 s (the JAX test's bound) and rebases its spans
    onto the king's timeline. The transform equals the LocalSimNet one."""
    SKEW_NS, SKEWED, n, M = 2_000_000_000, 2, 4, 8
    pp = pss(1)
    vals = _ints(np.random.default_rng(3), M)
    shares = packing.pack_strided(pp, fr().encode(vals, CPU))
    cfg = NetConfig(op_timeout_s=10.0, connect_timeout_s=10.0,
                    heartbeat_interval_s=0.05, idle_timeout_s=30.0)

    class SkewedNet(ProdNet):
        def _now_ns(self):
            return aggregate.now_ns() + SKEW_NS

    async def party(nt, s):
        return await dfft.d_fft(s, False, 1, False, domain(M), pp, nt)

    want = net.simulate_network_round(n, party, [shares[i] for i in range(n)])
    aggregate.set_enabled(True)
    agg = aggregate.reset_aggregator()

    async def run():
        pairs = {i: ChannelIO.pair() for i in range(1, n)}
        king_t = asyncio.create_task(ProdNet.king_from_ios(
            {i: p[0] for i, p in pairs.items()}, n, cfg, device=CPU))
        peer_ts = [asyncio.create_task(
            (SkewedNet if i == SKEWED else ProdNet).peer_from_io(
                i, pairs[i][1], n, cfg, device=CPU)) for i in range(1, n)]
        nets = [await king_t] + [await t for t in peer_ts]
        try:
            got = await asyncio.gather(*(party(nets[i], shares[i])
                                         for i in range(n)))
            groups = aggregate.group_by_pid(aggregate.drain())
            true_ts = min(e["ts"] for e in groups[SKEWED])
            for e in groups[SKEWED]:  # that process's clock runs ahead
                e["ts"] += SKEW_NS / 1e3
            for i in (1, 2, 3, 0):  # every party flushes only its own
                aggregate.requeue(groups[i])
                await nets[i].flush_telemetry()
            for _ in range(200):
                if agg.parties() == list(range(n)):
                    break
                await asyncio.sleep(0.02)
            return got, true_ts, nets[0]._clocks[SKEWED].offset_ns
        finally:
            for nt in nets:
                await nt.close()

    got, true_ts, offset = _bounded(run())
    for i in range(n):
        assert torch.equal(got[i], want[i])
    assert agg.parties() == [0, 1, 2, 3]
    assert abs(offset - SKEW_NS) < 100_000_000, offset
    merged = min(e["ts"] for e in agg.events() if e["pid"] == SKEWED)
    assert abs(merged - true_ts) < 100_000, (merged, true_ts)  # in µs
    names = _names_by_party(agg.events())
    assert all(names[i]["dfft.fft"] == 1 for i in range(n))
    assert agg.last_critical_path["parties"] == n
    assert _counter("telemetry_frames_recv_total", peer=str(SKEWED)) >= 1


def test_telemetry_frame_held_until_clock_sample_then_rebased():
    """Before any heartbeat echo completes, a peer's timestamps are on
    another process's epoch: the frame is held, then merged with the
    estimated offset once a sample exists (the JAX test, on the port)."""
    aggregate.set_enabled(True)
    agg = aggregate.reset_aggregator()
    cfg = NetConfig(op_timeout_s=5.0, connect_timeout_s=5.0,
                    heartbeat_interval_s=30.0)  # on, but never fires

    async def run():
        a, b = ChannelIO.pair()
        king_t = asyncio.create_task(
            ProdNet.king_from_ios({1: a}, 2, cfg, device=CPU))
        peer_t = asyncio.create_task(
            ProdNet.peer_from_io(1, b, 2, cfg, device=CPU))
        king, peer = await king_t, await peer_t
        try:
            payload = serde.dumps(json.dumps({
                "party": 1, "spans": [_ev("client.work", 5_000_100, 40, 1, 9)],
                "metrics": {},
            }))
            king._on_telemetry(1, payload)
            assert 1 not in agg.parties()  # held: no clock sample yet
            assert len(king._pending_tlm[1]) == 1
            t0 = aggregate.now_ns()
            king._on_heartbeat(1, serde.dumps(
                (t0 + 5_000_000_200, t0, t0 + 5_000_000_100)))
            assert king._clocks[1].n_samples == 1
            assert 1 in agg.parties() and king._pending_tlm == {}
            assert agg.events()[0]["ts"] == pytest.approx(100, abs=500)
        finally:
            await king.close()
            await peer.close()

    _bounded(run())


def test_plane_off_sends_no_frames_and_drains_nothing():
    assert not aggregate.enabled() and aggregate.drain() == []
    assert not tracing.active()
    tx_before = _counter("telemetry_frames_sent_total", peer="0")
    bytes_before = _counter("net_bytes_sent_total", peer="0", sid="0")

    async def run():
        a, b = ChannelIO.pair()
        king_t = asyncio.create_task(
            ProdNet.king_from_ios({1: a}, 2, FAST, device=CPU))
        peer_t = asyncio.create_task(
            ProdNet.peer_from_io(1, b, 2, FAST, device=CPU))
        king, peer = await king_t, await peer_t
        with tracing.span("client.compute", party=1):
            pass  # the no-op singleton: nothing buffered anywhere
        await peer.send_to(0, 7)
        assert await king.recv_from(1) == 7
        await peer.flush_telemetry()
        await king.flush_telemetry()
        await king.close()
        await peer.close()

    _bounded(run())
    assert _counter("telemetry_frames_sent_total", peer="0") == tx_before
    # the wire counters stay on: the SynAck and the DATA frame were counted
    assert _counter("net_bytes_sent_total", peer="0", sid="0") > bytes_before
    assert aggregate.drain() == []


def test_flight_dump_on_injected_peer_death(tmp_path):
    flight.configure(str(tmp_path))
    dumps_before = _counter("flight_dumps_total", trigger="peer_death")
    deaths_before = _counter("net_peer_deaths_total", peer="1")

    async def run():
        a, b = ChannelIO.pair()
        king_t = asyncio.create_task(
            ProdNet.king_from_ios({1: a}, 2, FAST, device=CPU))
        peer_t = asyncio.create_task(ProdNet.peer_from_io(
            1, FaultyIO(b, disconnect_write_at=1), 2, FAST, device=CPU))
        king, peer = await king_t, await peer_t
        with pytest.raises(net.MpcDisconnectError):
            await peer.send_to(0, 42)  # write #1 disconnects
        with pytest.raises(net.MpcDisconnectError):
            await king.recv_from(1, timeout=5.0)
        await king.close()
        await peer.close()

    _bounded(run())
    assert _counter("flight_dumps_total", trigger="peer_death") > dumps_before
    assert _counter("net_peer_deaths_total", peer="1") == deaths_before + 1
    records = [json.load(open(f))
               for f in sorted(glob.glob(str(tmp_path / "flight-*.json")))]
    king_side = [r for r in records if r["trigger"] == "peer_death"
                 and r["extra"].get("peer") == 1]
    assert king_side, records
    assert any(e["kind"] == "peer_death" for e in king_side[0]["netEvents"])
    assert king_side[0]["metrics"] and king_side[0]["extra"]["reason"]


def test_flight_dump_on_round_retry_exhaustion(tmp_path):
    flight.configure(str(tmp_path))
    fails_before = _counter("net_round_failures_total")
    retries_before = _counter("net_round_retries_total")

    async def party(nt, _):
        raise net.MpcDisconnectError("permanently dead", party=nt.party_id)

    with pytest.raises(net.MpcDisconnectError):
        net.run_round_with_retries(2, party, retries=1, net_cfg=FAST)
    files = glob.glob(str(tmp_path / "flight-*round_retry_exhausted.json"))
    assert files
    rec = json.load(open(files[0]))
    assert rec["extra"]["attempts"] == 2
    assert any(e["kind"] == "round_retry" for e in rec["netEvents"])
    assert _counter("net_round_failures_total") == fails_before + 1
    assert _counter("net_round_retries_total") == retries_before + 1


def test_retry_drops_failed_attempt_spans():
    aggregate.set_enabled(True)
    agg = aggregate.reset_aggregator()
    state = {"attempt": 0}

    async def party(nt, _):
        if nt.party_id == 0:
            state["attempt"] += 1
        with tracing.span(f"attempt{state['attempt']}.p{nt.party_id}",
                          party=nt.party_id):
            await asyncio.sleep(0)
        if state["attempt"] == 1 and nt.party_id == 1:
            raise net.MpcTimeoutError("transient", party=1)
        return nt.party_id

    assert net.run_round_with_retries(2, party, retries=2,
                                      net_cfg=FAST) == [0, 1]
    names = {e["name"] for e in agg.events()}
    assert "attempt2.p0" in names
    assert not any(n.startswith("attempt1") for n in names)


def test_timeouts_count_per_op():
    before = _counter("net_timeouts_total", op="recv_from")
    hist = REG.family("collective_seconds").labels(op="recv_from")
    n_before = hist.count

    async def run():
        nets = net.make_local_nets(2)
        with pytest.raises(net.MpcTimeoutError):
            await nets[0].recv_from(1, timeout=0.01)

    _bounded(run())
    assert _counter("net_timeouts_total", op="recv_from") == before + 1
    assert hist.count == n_before + 1


def _routes() -> dict:
    fam = REG.family("kernel_route_total")
    return {k: c.value for k, c in fam.items()}


def test_kernel_route_total_counts_each_call_by_route(monkeypatch):
    """One count per MSM and NTT call, under the route that ran. The
    count is taken at dispatch, so the Pippenger's body is a stand-in
    here (its plain version costs seconds on the CPU; the tests of
    ops/msm.py hold it against the JAX package's)."""
    monkeypatch.setattr(tmsm, "_msm_pippenger",
                        lambda C, p, s, c: C.infinity((), p.device))
    monkeypatch.setattr(tmsm, "TREE_MSM_MAX_N", 4)
    monkeypatch.setattr(tntt, "LIMB_NTT_MIN_N", 8)
    rng = np.random.default_rng(5)
    pts = g1().encode(
        [rm.G1.scalar_mul(G1_GENERATOR, s) for s in _ints(rng, 6)], CPU)
    sc = tmsm.encode_scalars_std(_ints(rng, 6), CPU)
    calls = [
        (lambda: tmsm.msm(g1(), pts[:2], sc[:2]), ("msm", "ladder")),
        (lambda: tmsm.msm(g1(), pts[:3], sc[:3], window_bits=4),
         ("msm", "pippenger")),
        (lambda: tmsm.msm(g1(), pts[:4], sc[:4], window_bits=4, chunk=2),
         ("msm", "pippenger_chunked")),
        (lambda: tmsm.msm_batched(g1(), pts[:2][None], sc[:2][None]),
         ("msm_batched", "ladder")),
        (lambda: domain(4).fft(fr().encode([1, 2, 3], CPU)), ("ntt", "row")),
        (lambda: domain(8).ifft(fr().encode([1, 2, 3], CPU)), ("ntt", "limb")),
    ]
    tree = [
        (lambda: tmsm.msm(g1(), pts[:4], sc[:4]), ("msm", "tree")),
        (lambda: tmsm.msm(g1(), pts[:6], sc[:6]), ("msm", "tree_chunked")),
        (lambda: tmsm.msm_batched(g1(), pts[:2][None], sc[:2][None]),
         ("msm_batched", "tree")),
        (lambda: tmsm.msm_batched(g1(), pts[:6][None], sc[:6][None]),
         ("msm_batched", "tree_chunked")),
    ]
    for fn, key in calls + [(None, None)] + tree:
        if fn is None:
            monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)  # tree above 1
            continue
        before = _routes()
        fn()
        after = _routes()
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        assert delta == {key: 1.0}, (key, delta)


def test_verify_batch_metrics_match_jax():
    """verify_batch_size and verify_pairings_saved_total after folds of
    N = 1 and N = 3 equal the JAX package's: one observation a fold, and
    4N - (N + 3) Miller loops saved (3N - 3). The operands are valid
    curve points of no real key, so both folds reject, equally."""
    from distributed_groth16_tpu.models.groth16 import keys as jkeys
    from distributed_groth16_tpu.ops.constants import G2_GENERATOR
    from distributed_groth16_tpu.verifier import batch as jbatch
    from distributed_groth16_tpu_torch.models.groth16 import keys as tkeys
    from distributed_groth16_tpu_torch.verifier import batch as tbatch

    rng = np.random.default_rng(11)
    s = _ints(rng, 12)
    G1p = [rm.G1.scalar_mul(G1_GENERATOR, k) for k in s[:6]]
    G2p = [rm.G2.scalar_mul(G2_GENERATOR, k) for k in s[6:12]]
    vk = dict(alpha_g1=G1p[0], beta_g2=G2p[0], gamma_g2=G2p[1],
              delta_g2=G2p[2], gamma_abc_g1=[G1p[1], G1p[2]])
    proofs = [dict(a=G1p[3 + i], b=G2p[3 + i], c=G1p[(4 + i) % 6])
              for i in range(3)]
    pubs = [[5 + i] for i in range(3)]
    seed = b"\x01" * 32

    def metrics(reg):
        h = reg.family("verify_batch_size")
        c = reg.family("verify_pairings_saved_total")
        return (h._default.count if h is not None else 0,
                c.value if c is not None else 0.0)

    got = {}
    for name, keys, batch, reg, kw in (
        ("port", tkeys, tbatch, REG, {"device": "cpu"}),
        ("jax", jkeys, jbatch, JREG, {}),
    ):
        pvk = batch.PreparedVerifyingKey.prepare("c", keys.VerifyingKey(**vk),
                                                 **kw)
        ps = [keys.Proof(**p) for p in proofs]
        before = metrics(reg)
        oks = [batch.verify_batch(pvk, ps[:1], pubs[:1], seed=seed),
               batch.verify_batch(pvk, ps, pubs, seed=seed)]
        after = metrics(reg)
        got[name] = (oks, after[0] - before[0], after[1] - before[1])
    assert got["port"] == got["jax"] == ([False, False], 2, 4 * 3 - (3 + 3))
