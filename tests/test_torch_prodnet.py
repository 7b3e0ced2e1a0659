"""The port's socket transport (parallel/prodnet.py, utils/serde.py,
utils/certs.py of distributed_groth16_tpu_torch) against the JAX
package's, and the one-process-per-party launcher (examples/launch.py).

Every comparison is exact: wire bytes byte for byte, field shares limb for
limb, curve points as decoded affine points. Every async body runs under
asyncio.wait_for and every spawned star under the launcher's deadline, so
a hang fails its test instead of wedging the suite."""

import asyncio
import os
import random
import socket
import struct
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.ntt import domain as jdomain
from distributed_groth16_tpu.parallel import dfft as jdfft
from distributed_groth16_tpu.parallel import packing as jpacking
from distributed_groth16_tpu.parallel import prodnet as jprodnet
from distributed_groth16_tpu.parallel.net import (
    simulate_network_round as jax_round,
)
from distributed_groth16_tpu.parallel.pss import PackedSharingParams as JPP
from distributed_groth16_tpu.utils import config as jconfig
from distributed_groth16_tpu.utils import serde as jserde
from distributed_groth16_tpu_torch.models.groth16.proving_key import (
    _pack_query_scalars,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops import refmath as rm
from distributed_groth16_tpu_torch.ops.constants import G1_GENERATOR, R
from distributed_groth16_tpu_torch.ops.curve import g1
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.ntt import domain
from distributed_groth16_tpu_torch.parallel import prodnet
from distributed_groth16_tpu_torch.parallel.dfft import d_fft
from distributed_groth16_tpu_torch.parallel.dmsm import d_msm
from distributed_groth16_tpu_torch.parallel.net import (
    MpcNetError,
    simulate_network_round,
)
from distributed_groth16_tpu_torch.parallel.packing import (
    pack_consecutive,
    pack_strided,
)
from distributed_groth16_tpu_torch.parallel.pss import pss
from distributed_groth16_tpu_torch.utils import serde
from distributed_groth16_tpu_torch.utils.config import NetConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
BOUND_S = 30.0  # no test body may run (or hang) longer
# heartbeats on and fast, so they cross the links while a test runs
FAST = dict(op_timeout_s=5.0, connect_timeout_s=5.0,
            connect_base_delay_s=0.05, connect_max_delay_s=0.5,
            heartbeat_interval_s=0.05, idle_timeout_s=5.0)
# the stars that compute: all their parties share one thread, so an op
# waits for every other party's local work (seconds each on a loaded CPU)
COMPUTE = dict(FAST, op_timeout_s=120.0, idle_timeout_s=120.0)
COMPUTE_BOUND_S = 240.0


def _bounded(coro, bound_s=BOUND_S):
    return asyncio.run(asyncio.wait_for(coro, bound_s))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _nested_value():
    """One nested wire value: None, ints, strs, the four wire dtypes,
    lists and tuples, from a numpy seed."""
    rng = np.random.default_rng(7)
    return [
        None, 0, -(1 << 62), 12345, "", "ünïcôde reason ✓",
        rng.integers(0, 1 << 32, (3, 16), dtype=np.uint32),
        (rng.integers(-(1 << 31), 1 << 31, (2, 4), dtype=np.int32),
         rng.integers(0, 256, 5, dtype=np.uint8)),
        [rng.integers(-(1 << 62), 1 << 62, (2, 2, 3), dtype=np.int64),
         (np.zeros(0, np.int32), [None, "nested", 7])],
        np.array(5, dtype=np.int64),
    ]


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_serde_bytes_equal_the_jax_package():
    v = _nested_value()
    wire = serde.dumps(v)
    assert wire == jserde.dumps(v)
    assert _same(serde.loads(wire), jserde.loads(wire))
    assert _same(serde.loads(wire), v)


def test_to_wire_and_back_gives_a_writable_tensor_on_the_device():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (4, 3, 16),
                                      dtype=np.int32))
    value = [x, (x[1], 5), "tag"]
    wire = serde.dumps(prodnet._to_wire(value))
    # the port's int32 limbs cross as wire dtype code 1
    assert wire == jserde.dumps([x.numpy(), (x[1].numpy(), 5), "tag"])
    with warnings.catch_warnings():
        # torch warns when it wraps a read-only array (the frame's bytes)
        warnings.simplefilter("error")
        back = prodnet._from_wire(serde.loads(wire), CPU)
    assert isinstance(back, list) and isinstance(back[1], tuple)
    for got, want in ((back[0], x), (back[1][0], x[1])):
        assert got.dtype == torch.int32 and got.device == CPU
        assert torch.equal(got, want)
    back[0].add_(1)  # writable, and not an alias of the frame
    assert torch.equal(back[0], x + 1)
    # serde carries exactly four dtypes: nothing is cast
    for bad in (torch.zeros(3, dtype=torch.bool),
                torch.zeros(3, dtype=torch.int16)):
        with pytest.raises(TypeError):
            serde.dumps(prodnet._to_wire([bad]))


class _Sink:
    def __init__(self):
        self.data = b""

    async def write(self, b):
        self.data += bytes(b)


def test_frames_equal_the_jax_package():
    """DATA, HEARTBEAT (with its clock-echo payload) and ERR frames carry
    the same bytes from both packages; both refuse an oversized frame and
    reject a hostile length header."""
    assert prodnet.MAX_FRAME_LEN == jprodnet.MAX_FRAME_LEN == 256 << 20
    assert (prodnet.SYN, prodnet.SYNACK, prodnet.DATA, prodnet.HEARTBEAT,
            prodnet.ERR, prodnet.TELEMETRY) == (
        jprodnet.SYN, jprodnet.SYNACK, jprodnet.DATA, jprodnet.HEARTBEAT,
        jprodnet.ERR, jprodnet.TELEMETRY)
    frames = [
        (prodnet.DATA, 2, serde.dumps(_nested_value())),
        (prodnet.HEARTBEAT, 0, serde.dumps((123456789, 42, 43))),
        (prodnet.ERR, 0, serde.dumps("party 3 aborted: boom")),
        (prodnet.SYN, 0, b""),
    ]

    async def run():
        ours, theirs = _Sink(), _Sink()
        for f in frames:
            await prodnet._send_frame(ours, *f)
            await jprodnet._send_frame(theirs, *f)
        assert ours.data == theirs.data
        with pytest.raises(ValueError):
            await prodnet._send_frame(ours, 2, 0,
                                      b"x" * (prodnet.MAX_FRAME_LEN - 1))
        a, b = prodnet.ChannelIO.pair()
        await a.write(ours.data)
        for f in frames:
            assert await prodnet._recv_frame(b) == f
        await a.write((prodnet.MAX_FRAME_LEN + 1).to_bytes(4, "big"))
        with pytest.raises(ConnectionError):
            await prodnet._recv_frame(b)

    _bounded(run())


async def _sum_ids(nets, timeout=5.0):
    out = await asyncio.gather(*(
        n.king_compute(n.party_id, lambda ids: [sum(ids)] * n.n_parties,
                       timeout=timeout)
        for n in nets
    ))
    for n in nets:
        await n.close()
    return out


def test_mixed_star_jax_king_port_peers_over_channel_io():
    """A JAX ProdNet king and three port peers run add_ids over ChannelIO,
    heartbeats crossing between the packages while the star idles."""
    n = 4

    async def run():
        pairs = {i: prodnet.ChannelIO.pair() for i in range(1, n)}
        king_t = asyncio.create_task(jprodnet.ProdNet.king_from_ios(
            {i: pairs[i][0] for i in pairs}, n, jconfig.NetConfig(**FAST)))
        peers = await asyncio.gather(*(
            prodnet.ProdNet.peer_from_io(i, pairs[i][1], n, NetConfig(**FAST),
                                         device=CPU)
            for i in range(1, n)
        ))
        king = await king_t
        await asyncio.sleep(0.3)  # several heartbeats each way
        assert all(p._hb_rx.get(0) for p in peers)
        # the JAX king closed clock echoes on the port's heartbeats
        assert all(king._clocks[i].n_samples > 0 for i in range(1, n))
        assert not king._dead and not any(p._dead for p in peers)
        return await _sum_ids([king, *peers])

    assert _bounded(run()) == [6] * n


async def _tcp_star(n, king_ctx=None, peer_ctx=lambda i: None):
    port = _free_port()
    cfg = NetConfig(**FAST)
    king_t = asyncio.create_task(prodnet.ProdNet.new_king(
        ("127.0.0.1", port), n, king_ctx, cfg, device=CPU))
    peers = await asyncio.gather(*(
        prodnet.ProdNet.new_peer(i, ("127.0.0.1", port), n, peer_ctx(i),
                                 net_cfg=cfg, device=CPU)
        for i in range(1, n)
    ))
    return [await king_t, *peers]


def test_tcp_star_sum_ids_and_star_enforcement():
    async def run():
        nets = await _tcp_star(4)
        with pytest.raises(MpcNetError):  # client -> client is refused
            await nets[1].send_to(2, 123)
        return await _sum_ids(nets)

    assert _bounded(run()) == [6] * 4


def test_mtls_star_sum_ids_with_the_ports_certs(tmp_path):
    from distributed_groth16_tpu_torch.utils.certs import (
        gen_self_signed,
        king_ssl_context,
        peer_ssl_context,
    )

    n = 4
    files = {}
    for i in range(n):
        cert, key = gen_self_signed(str(i))
        (tmp_path / f"{i}.cert.pem").write_bytes(cert)
        (tmp_path / f"{i}.key.pem").write_bytes(key)
        files[i] = (str(tmp_path / f"{i}.cert.pem"),
                    str(tmp_path / f"{i}.key.pem"))

    async def run():
        nets = await _tcp_star(
            n, king_ssl_context(*files[0], [files[i][0] for i in range(1, n)]),
            lambda i: peer_ssl_context(*files[i], files[0][0]))
        return await _sum_ids(nets)

    assert _bounded(run()) == [6] * n


def _raw_clients(port, n, deadline_s=5.0):
    """Clients 1..n-1 of the wire protocol on blocking sockets: each dials
    (until the king listens) and writes its id; then each answers the
    king's Syn with a SynAck."""
    socks = []
    end = time.monotonic() + deadline_s
    for i in range(1, n):
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=BOUND_S)
                break
            except OSError:
                if time.monotonic() > end:
                    raise
                time.sleep(0.02)
        s.sendall(struct.pack("!I", i))
        socks.append(s)
    for s in socks:
        syn = b""
        while len(syn) < 6:
            chunk = s.recv(6 - len(syn))
            assert chunk, "king closed before Syn"
            syn += chunk
        assert syn == struct.pack("!IBB", 2, prodnet.SYN, 0)
        s.sendall(struct.pack("!IBB", 2, prodnet.SYNACK, 0))
    return socks


def _data_frame(value) -> bytes:
    payload = serde.dumps(value)
    return struct.pack("!IBB", len(payload) + 2, prodnet.DATA, 0) + payload


def test_clients_closing_after_their_last_send_lose_no_frame():
    """Over TCP, three clients send their last frame and close at once
    while the king is busy with synchronous work; client 3's frame (8 MiB)
    is still being read when clients 1 and 2's closes reach the king. The
    king gathers all three frames. Had it relayed those closes, its writes
    to client 3 would have met a closed socket, and the reset or the
    failed write would have cost client 3's frame."""
    n, port = 4, _free_port()
    cfg = NetConfig(**dict(FAST, heartbeat_interval_s=0.0))
    big = np.random.default_rng(13).integers(0, 256, 8 << 20, dtype=np.uint8)
    up, go, out = threading.Event(), threading.Event(), {}

    async def king():
        net = await prodnet.ProdNet.new_king(("127.0.0.1", port), n,
                                             net_cfg=cfg, device=CPU)
        try:
            up.set()
            go.wait(BOUND_S)  # blocks the loop: the king reads nothing
            return await net.gather_to_king(0)
        finally:
            await net.close()

    def king_thread():
        try:
            out["got"] = _bounded(king())
        except BaseException as e:  # noqa: BLE001 — reported below
            out["error"] = e

    def last_send(s, frame):
        s.sendall(frame)
        s.close()

    kt = threading.Thread(target=king_thread)
    kt.start()
    socks = _raw_clients(port, n)
    assert up.wait(BOUND_S)
    for i in (1, 2):
        last_send(socks[i - 1], _data_frame(i))
    sender = threading.Thread(target=last_send,
                              args=(socks[2], _data_frame(big)))
    sender.start()
    go.set()
    sender.join(BOUND_S)
    kt.join(BOUND_S)
    assert not kt.is_alive() and not sender.is_alive()
    assert "error" not in out, out.get("error")
    got = out["got"]
    assert got[:3] == [0, 1, 2]
    assert torch.equal(got[3], torch.from_numpy(big))


async def _channel_round(n, party, data):
    """party(net, data[i]) on every node of a ProdNet star over
    ChannelIO; results by party id."""
    pairs = {i: prodnet.ChannelIO.pair() for i in range(1, n)}
    cfg = NetConfig(**COMPUTE)
    king_t = asyncio.create_task(prodnet.ProdNet.king_from_ios(
        {i: pairs[i][0] for i in pairs}, n, cfg, device=CPU))
    peers = await asyncio.gather(*(
        prodnet.ProdNet.peer_from_io(i, pairs[i][1], n, cfg, device=CPU)
        for i in range(1, n)
    ))
    nets = [await king_t, *peers]
    try:
        return await asyncio.gather(*(party(net, data[net.party_id])
                                      for net in nets))
    finally:
        for net in nets:
            await net.close()


def test_d_fft_over_prodnet_equals_localsimnet_and_jax():
    """d_fft runs unchanged over the socket transport (l = 1, n = 4): every
    party's share equals LocalSimNet's and the JAX d_fft's, limb for
    limb."""
    pp, jp, m = pss(1), JPP(1), 16
    rng = random.Random(50)
    x = [rng.randrange(R) for _ in range(m)]
    shares = pack_strided(pp, fr().encode(x, CPU))
    jshares = jpacking.pack_strided(jp, jfr().encode(x))

    async def party(net, s):
        return await d_fft(s, False, 1, False, domain(m), pp, net)

    async def jparty(net, s):
        return await jdfft.d_fft(s, False, 1, False, jdomain(m), jp, net)

    data = [shares[i] for i in range(pp.n)]
    got = _bounded(_channel_round(pp.n, party, data), COMPUTE_BOUND_S)
    local = simulate_network_round(pp.n, party, data)
    want = jax_round(pp.n, jparty, [jshares[i] for i in range(pp.n)])
    for i in range(pp.n):
        assert torch.equal(got[i], local[i])
        np.testing.assert_array_equal(
            got[i].numpy().astype(np.int64),
            np.asarray(want[i]).astype(np.int64))


def test_d_msm_over_prodnet_equals_localsimnet(monkeypatch):
    """A small d_msm (l = 1, n = 4, 6 bases packed by the scalar route of
    the CRS pack): every party's result equals LocalSimNet's as affine
    points, and the host ground truth. The local MSMs take the tree route,
    as on the card at full size."""
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    pp, C, F, k = pss(1), g1(), fr(), 6
    rng = random.Random(60)
    logs = [rng.randrange(R) for _ in range(k)]
    wit = [rng.randrange(R) for _ in range(k)]
    bases = _pack_query_scalars("g1", pp, F.encode(logs, CPU))
    scal = pack_consecutive(pp, F.encode(wit, CPU))
    data = [(bases[i], scal[i]) for i in range(pp.n)]

    async def party(net, d):
        return await d_msm(C, d[0], d[1], pp, net)

    got = _bounded(_channel_round(pp.n, party, data), COMPUTE_BOUND_S)
    local = simulate_network_round(pp.n, party, data)
    want = rm.G1.scalar_mul(G1_GENERATOR,
                            sum(a * b for a, b in zip(logs, wit)) % R)
    assert C.decode(local[0]) == want
    for out in got:
        assert torch.equal(C.to_affine(out), C.to_affine(local[0]))


@pytest.fixture
def one_thread(monkeypatch):
    """Ranks of a CPU star each take one core."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_launch_runs_an_add_ids_star_of_four_processes(one_thread, tmp_path):
    from distributed_groth16_tpu_torch.examples.launch import launch

    lines = launch("add_ids", 4, ["--device", "cpu"], plain=True,
                   work_dir=str(tmp_path), deadline_s=120)
    assert lines == [{"party": i, "ok": True, "sum": 6} for i in range(4)]
    assert sorted(os.listdir(tmp_path)) == [
        "addresses", *(f"rank{i}.log" for i in range(4))]


def test_launch_reports_a_failed_rank_and_reaps_every_rank(one_thread,
                                                            tmp_path):
    """Rank 2 is given a device this machine lacks and fails at start; the
    others wait on the star (their connect deadline is 120 s). The
    launcher names rank 2, kills the rest and returns before its own
    deadline, every rank reaped."""
    import psutil

    from distributed_groth16_tpu_torch.examples.launch import (
        StarFailed,
        launch,
    )

    before = {p.pid for p in psutil.Process().children(recursive=True)}
    t0 = time.monotonic()
    with pytest.raises(StarFailed) as ei:
        launch("add_ids", 4, ["--device", "cpu"], plain=True,
               work_dir=str(tmp_path), deadline_s=120,
               rank_args={2: ["--device", "no_such_device"]})
    assert time.monotonic() - t0 < 120
    assert "rank 2 exited with" in str(ei.value)
    assert "--- rank 0" in str(ei.value) and "--- rank 3" in str(ei.value)
    left = {p.pid for p in psutil.Process().children(recursive=True)}
    assert left <= before
