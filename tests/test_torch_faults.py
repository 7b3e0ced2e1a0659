"""Chaos scenarios of the star transport, run on both packages: the port's
ProdNet (distributed_groth16_tpu_torch/parallel/prodnet.py, with the copy
of FaultyIO) and the JAX package's, over the same faults.

Each scenario of tests/test_faults.py that needs no telemetry injects a
fault (FaultyIO, an abrupt close, silence, a missing party) and returns
what every failing op raised: the exception class and its party, peer,
sid and op. The port must raise exactly what the JAX package raises, and
within the scenario's deadline; the scenario asserts both packages'
deadlines itself. Every scenario runs under asyncio.wait_for.

FaultyIO write indices are deterministic because these configs disable
heartbeats (except where liveness is the point): a client's write #0 is
its SYNACK, so DATA frames start at write #1.
"""

import asyncio
import functools
import socket
import time
import types

import pytest

from distributed_groth16_tpu.parallel import faults as jfaults
from distributed_groth16_tpu.parallel import net as jnet
from distributed_groth16_tpu.parallel import prodnet as jprodnet
from distributed_groth16_tpu.utils import config as jconfig
from distributed_groth16_tpu_torch.parallel import faults, net, prodnet
from distributed_groth16_tpu_torch.utils import config

BOUND_S = 30.0  # no scenario may run (or hang) longer


def _package(prod, netmod, faultmod, cfgmod, **device):
    """The transport of one package behind one namespace; the port's
    constructors place received tensors on the CPU."""
    P = prod.ProdNet
    return types.SimpleNamespace(
        king_from_ios=functools.partial(P.king_from_ios, **device),
        peer_from_io=functools.partial(P.peer_from_io, **device),
        new_king=functools.partial(P.new_king, **device),
        new_peer=functools.partial(P.new_peer, **device),
        ChannelIO=prod.ChannelIO, FaultyIO=faultmod.FaultyIO,
        NetConfig=cfgmod.NetConfig, MpcNetError=netmod.MpcNetError,
    )


PACKAGES = {
    "jax": _package(jprodnet, jnet, jfaults, jconfig),
    "port": _package(prodnet, net, faults, config, device="cpu"),
}


def _fast(pkg, **kw):
    """Fast deadlines, no heartbeats."""
    return pkg.NetConfig(**{**dict(
        op_timeout_s=2.0, connect_timeout_s=5.0, connect_base_delay_s=0.05,
        connect_max_delay_s=0.5, heartbeat_interval_s=0.0), **kw})


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _raised(pkg, coro, within_s, *, needle=None):
    """Await `coro`, which must raise an MpcNetError within `within_s`
    seconds (with `needle` in its message); returns (class, party, peer,
    sid, op)."""
    t0 = time.monotonic()
    with pytest.raises(pkg.MpcNetError) as ei:
        await coro
    assert time.monotonic() - t0 < within_s
    e = ei.value
    if needle is not None:
        assert needle in str(e), str(e)
    return (type(e).__name__, e.party, e.peer, e.sid, e.op)


async def _channel_star(pkg, n, cfg, wrap=None):
    """king + clients over ChannelIO pairs; `wrap` maps a client id to a
    function wrapping that client's IO (the fault injection point)."""
    pairs = {i: pkg.ChannelIO.pair() for i in range(1, n)}
    client_ios = {i: pairs[i][1] for i in pairs}
    for i, w in (wrap or {}).items():
        client_ios[i] = w(client_ios[i])
    king_t = asyncio.create_task(
        pkg.king_from_ios({i: pairs[i][0] for i in pairs}, n, cfg))
    peers = await asyncio.gather(*(
        pkg.peer_from_io(i, client_ios[i], n, cfg) for i in range(1, n)))
    return [await king_t, *peers]


async def _tcp_star(pkg, n, cfg):
    port = _free_port()
    king_t = asyncio.create_task(
        pkg.new_king(("127.0.0.1", port), n, net_cfg=cfg))
    peers = await asyncio.gather(*(
        pkg.new_peer(i, ("127.0.0.1", port), n, net_cfg=cfg)
        for i in range(1, n)))
    return [await king_t, *peers]


async def _close_all(nets):
    for x in nets:
        await x.close()


async def _sum_ids(nets, timeout=2.0):
    return await asyncio.gather(*(
        x.king_compute(x.party_id, lambda ids: [sum(ids)] * x.n_parties,
                       timeout=timeout)
        for x in nets))


# -- the scenarios: each returns what its failing ops raised ----------------


async def recv_deadline(pkg):
    nets = await _channel_star(pkg, 2, _fast(pkg))
    out = [await _raised(pkg, nets[0].recv_from(1, sid=1, timeout=0.3), 2.0)]
    await _close_all(nets)
    return out


async def gather_deadline_names_the_silent_party(pkg):
    nets = await _channel_star(pkg, 4, _fast(pkg))
    out = []

    async def client(x):
        if x.party_id != 1:  # party 1 never contributes
            await x.send_to(0, x.party_id)

    async def king():
        out.append(await _raised(
            pkg, nets[0].gather_to_king(0, timeout=0.5), 2.0))

    await asyncio.gather(king(), *(client(x) for x in nets[1:]))
    await _close_all(nets)
    return out


async def drop_surfaces_as_timeout(pkg):
    # SYNACK (write #0) passes; every DATA frame after it is swallowed
    wrap = {1: lambda io: pkg.FaultyIO(io, drop_writes_from=1)}
    nets = await _channel_star(pkg, 3, _fast(pkg), wrap)
    await nets[1].send_to(0, 11)  # silently dropped on the wire
    await nets[2].send_to(0, 22)
    assert await nets[0].recv_from(2, timeout=1.0) == 22
    out = [await _raised(pkg, nets[0].recv_from(1, timeout=0.5), 2.0)]
    await _close_all(nets)
    return out


async def corrupt_length_prefix(pkg):
    wrap = {1: lambda io: pkg.FaultyIO(io, corrupt_len_at=1)}
    nets = await _channel_star(pkg, 2, _fast(pkg), wrap)
    await nets[1].send_to(0, 123)  # length prefix corrupted in flight
    # detected by frame validation, well before the deadline; the queues
    # stay poisoned, so a second recv fails too
    out = [await _raised(pkg, nets[0].recv_from(1, timeout=5.0), 2.0,
                         needle="bad frame length") for _ in range(2)]
    await _close_all(nets)
    return out


async def truncated_frame(pkg):
    wrap = {1: lambda io: pkg.FaultyIO(io, truncate_write_at=1)}
    nets = await _channel_star(pkg, 2, _fast(pkg), wrap)
    await nets[1].send_to(0, [1, 2, 3])  # half a frame, then EOF
    out = [await _raised(pkg, nets[0].recv_from(1, timeout=5.0), 2.0)]
    await _close_all(nets)
    return out


async def disconnect_mid_collective(pkg):
    wrap = {1: lambda io: pkg.FaultyIO(io, disconnect_write_at=1)}
    nets = await _channel_star(pkg, 3, _fast(pkg), wrap)
    out = [
        # the failing client's own send, as a structured error
        await _raised(pkg, nets[1].send_to(0, 99), 2.0),
        # the king sees EOF and names the dead party
        await _raised(pkg, nets[0].recv_from(1, timeout=5.0), 2.0),
        # the surviving client hears it through the king's ERR relay
        await _raised(pkg, nets[2].recv_from(0, timeout=5.0), 2.0,
                      needle="party 1"),
    ]
    await _close_all(nets)
    return out


async def abort_relays_the_death(pkg):
    nets = await _channel_star(pkg, 4, _fast(pkg))
    await nets[1].abort("simulated fatal app error")
    out = [await _raised(pkg, nets[0].recv_from(1, timeout=5.0), 2.0)]
    for x in nets[2:]:
        out.append(await _raised(pkg, x.recv_from(0, timeout=5.0), 2.0,
                                 needle="party 1"))
    await _close_all(nets)
    return out


async def idle_peer_detected(pkg):
    # client 1 goes silent after its SYNACK: no data, no heartbeats; the
    # pending recv is released well before its 10 s deadline
    cfg = pkg.NetConfig(op_timeout_s=10.0, connect_timeout_s=5.0,
                        heartbeat_interval_s=0.05, idle_timeout_s=0.3)
    wrap = {1: lambda io: pkg.FaultyIO(io, drop_writes_from=1)}
    nets = await _channel_star(pkg, 2, cfg, wrap)
    out = [await _raised(pkg, nets[0].recv_from(1, timeout=10.0), 3.0,
                         needle="idle timeout")]
    await _close_all(nets)
    return out


async def client_dials_before_the_king_listens(pkg):
    port = _free_port()
    cfg = _fast(pkg)
    peer_t = asyncio.create_task(
        pkg.new_peer(1, ("127.0.0.1", port), 2, net_cfg=cfg))
    await asyncio.sleep(0.4)  # several dials fail first
    king = await pkg.new_king(("127.0.0.1", port), 2, net_cfg=cfg)
    peer = await peer_t
    assert await _sum_ids([king, peer]) == [1, 1]
    await _close_all([king, peer])
    return []


async def king_startup_deadline_names_the_missing(pkg):
    cfg = pkg.NetConfig(connect_timeout_s=0.5, heartbeat_interval_s=0.0)
    return [await _raised(
        pkg, pkg.new_king(("127.0.0.1", _free_port()), 3, net_cfg=cfg), 2.0,
        needle="[1, 2]")]


async def kill_client_mid_gather_over_tcp(pkg):
    nets = await _tcp_star(pkg, 4, _fast(pkg))
    out = []

    async def client(x):
        if x.party_id == 1:
            await x.close()  # crash: the socket goes mid-collective
        else:
            await x.send_to(0, x.party_id * 10)

    async def king():
        out.append(await _raised(
            pkg, nets[0].gather_to_king(0, timeout=5.0), 3.0))

    await asyncio.gather(king(), *(client(x) for x in nets[1:]))
    await _close_all(nets)
    return out


# what each scenario's failing ops raise, (class, party, peer, sid, op)
EXPECTED = {
    recv_deadline: [("MpcTimeoutError", 0, 1, 1, "recv_from")],
    gather_deadline_names_the_silent_party: [
        ("MpcTimeoutError", 0, 1, 0, "gather_to_king")],
    drop_surfaces_as_timeout: [("MpcTimeoutError", 0, 1, 0, "recv_from")],
    corrupt_length_prefix: [("MpcDisconnectError", 0, 1, 0, None)] * 2,
    truncated_frame: [("MpcDisconnectError", 0, 1, 0, None)],
    disconnect_mid_collective: [("MpcDisconnectError", 1, 0, 0, None),
                                ("MpcDisconnectError", 0, 1, 0, None),
                                ("MpcDisconnectError", 2, 0, 0, None)],
    abort_relays_the_death: [("MpcDisconnectError", 0, 1, 0, None),
                             ("MpcDisconnectError", 2, 0, 0, None),
                             ("MpcDisconnectError", 3, 0, 0, None)],
    idle_peer_detected: [("MpcDisconnectError", 0, 1, 0, None)],
    client_dials_before_the_king_listens: [],
    king_startup_deadline_names_the_missing: [
        ("MpcTimeoutError", 0, None, None, "new_king")],
    kill_client_mid_gather_over_tcp: [
        ("MpcDisconnectError", 0, 1, 0, "gather_to_king")],
}


@pytest.mark.parametrize("scenario", list(EXPECTED),
                         ids=[s.__name__ for s in EXPECTED])
def test_fault_scenario_raises_what_the_jax_package_raises(scenario):
    got = {name: asyncio.run(asyncio.wait_for(scenario(pkg), BOUND_S))
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"] == EXPECTED[scenario]
