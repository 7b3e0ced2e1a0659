"""Production star transport: king <-> clients over (m)TLS sockets — the
counterpart of distributed_groth16_tpu/parallel/prodnet.py (the mpc-net
ProdNet role, mpc-net/src/prod.rs:119-296), on asyncio:

  * star topology — only king(0) <-> client connections (prod.rs:135-184);
  * transport-generic core over an IO-stream interface (prod.rs:97-117,
    190-243): `StreamIO` wraps asyncio TCP/TLS streams, `ChannelIO` is the
    in-memory fake the tests use (prod.rs:409-491), `FaultyIO` (faults.py)
    wraps either to inject faults;
  * id handshake: a connecting client writes its u32 id (prod.rs:211);
  * framing: u32 big-endian length prefix around a 2-byte envelope
    (packet_type, sid) + payload; the CHANNELS sub-streams are logical sid
    tags with per-(peer, sid) inbound queues;
  * Syn/SynAck startup barrier (prod.rs:246-296);
  * mTLS: the king requires client certs from a pinned roster, clients
    pin the king's cert (prod.rs:41-78); contexts from utils/certs.py.

Fault tolerance: client redial with exponential backoff and jitter under
the startup deadline; the king accepts clients in any order, replaces a
re-dialed one, and names the missing parties when the roster is
incomplete at the deadline; HEARTBEAT frames keep idle links alive and a
peer silent past idle_timeout_s is declared dead; ERR frames carry an
abort reason and the king relays a client's death to the others; any pump
failure (EOF, corrupt frame, hostile sid) poisons every (peer, sid) queue
so pending and future recvs raise MpcDisconnectError.

A socket that closes between two frames is a client that has finished, or
one that died at a frame boundary, which the king cannot tell apart: the
king poisons that client's queues behind the frames it already received,
and relays nothing. The JAX package relays it as a death, and that relay
can lose frames: a client that finished and closed answers the relay's
write with a reset, the king's next write to it fails, and asyncio then
drops the bytes of that client it had not parsed yet (a StreamReader
raises its exception ahead of its buffer; a transport that failed a write
stops reading). Every other pump failure is still relayed. ChannelIO's
close reads as a reset (ConnectionResetError), so it is relayed as in the
JAX package.

The frames are byte for byte the JAX package's, so JAX and port parties
can share one star. The HEARTBEAT payload keeps its clock-echo layout,
serde (t_send_ns, echo_t0_ns, echo_rx_ns): each heartbeat echoes the
peer's last one. The JAX package's telemetry plane is left out: no wire
counters, no ClockSync offsets from the echoes, no TELEMETRY frames sent,
no flight recorder; a received TELEMETRY frame is dropped, as the JAX
package drops it when aggregation is off.

Values cross as utils/serde.py wire values. A torch tensor is sent as
its host numpy array (the port's limbs are int32, wire dtype code 1; the
JAX package sends uint32); a received array becomes a tensor on the
net's `device`. serde carries uint32, int32, uint8 and int64 arrays only:
any other dtype raises TypeError.
"""

from __future__ import annotations

import asyncio
import logging
import random
import ssl
import struct
import time
from typing import Any

import numpy as np
import torch

from ..ops.field import resolve_device
from ..utils import serde
from ..utils.config import NetConfig
from .net import (
    CHANNELS,
    BaseNet,
    MpcDisconnectError,
    MpcNetError,
    MpcTimeoutError,
)

log = logging.getLogger(__name__)

SYN, SYNACK, DATA, HEARTBEAT, ERR, TELEMETRY = 0, 1, 2, 3, 4, 5

# Frame-length ceiling: a hostile or corrupt peer must not be able to
# demand a 4 GB allocation with one u32 header (the reference bounds frames
# via LengthDelimitedCodec::max_frame_length, mpc-net/src/multi.rs:26-33).
MAX_FRAME_LEN = 256 << 20


class StreamIO:
    """asyncio stream pair (TCP or TLS) behind the minimal IO interface."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def read_exactly(self, n: int) -> bytes:
        return await self.reader.readexactly(n)

    async def write(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()

    async def close(self) -> None:
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except Exception:  # noqa: BLE001 — peer may already be gone
            pass


class ChannelIO:
    """In-memory duplex IO over asyncio.Queues. close() delivers an EOF
    sentinel so a closed channel behaves like a closed socket: reads fail,
    they do not hang."""

    def __init__(self, inbox: asyncio.Queue, outbox: asyncio.Queue):
        self._inbox = inbox
        self._outbox = outbox
        self._buf = b""
        self._closed = False

    @staticmethod
    def pair() -> tuple["ChannelIO", "ChannelIO"]:
        a, b = asyncio.Queue(), asyncio.Queue()
        return ChannelIO(a, b), ChannelIO(b, a)

    async def read_exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = await self._inbox.get()
            if chunk is None:  # EOF from a closed peer — keep it sticky
                self._inbox.put_nowait(None)
                raise ConnectionResetError("channel closed by peer")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    async def write(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionResetError("channel closed")
        await self._outbox.put(bytes(data))

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._outbox.put_nowait(None)


async def _send_frame(io, packet_type: int, sid: int, payload: bytes) -> None:
    if len(payload) + 2 > MAX_FRAME_LEN:
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME_LEN; "
            "chunk the payload"
        )
    env = struct.pack("!IBB", len(payload) + 2, packet_type, sid)
    await io.write(env + payload)


class PeerClosed(ConnectionError):
    """The stream ended between two frames."""


async def _recv_frame(io) -> tuple[int, int, bytes]:
    try:
        head = await io.read_exactly(4)
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise
        raise PeerClosed("stream closed between frames") from None
    (length,) = struct.unpack("!I", head)
    if length < 2 or length > MAX_FRAME_LEN:
        raise ConnectionError(
            f"bad frame length {length} (cap {MAX_FRAME_LEN}); "
            "stream corrupt or peer hostile"
        )
    body = await io.read_exactly(length)
    return body[0], body[1], body[2:]


class ProdNet(BaseNet):
    """Star network node. Use `new_king` / `new_peer` (optionally with ssl
    contexts from utils/certs.py for mTLS) or the transport-generic
    `king_from_ios` / `peer_from_io`. `device` is where received tensors
    are placed (None: CUDA)."""

    def __init__(
        self, party_id: int, n_parties: int,
        net_cfg: NetConfig | None = None, device=None,
    ):
        self.party_id = party_id
        self.n_parties = n_parties
        self.net_cfg = net_cfg if net_cfg is not None else NetConfig.from_env()
        self.device = resolve_device(device)
        self._ios: dict[int, Any] = {}  # peer id -> IO (clients: only {0})
        self._queues: dict[tuple[int, int], asyncio.Queue] = {}
        self._pumps: list[asyncio.Task] = []
        self._heartbeats: list[asyncio.Task] = []
        self._dead: set[int] = set()  # peers whose stream died
        self._death_reason: dict[int, str] = {}
        self._last_seen: dict[int, float] = {}
        self._closed = False
        # the last heartbeat received from each peer (their_send_ns,
        # our_rx_ns), echoed back on our next heartbeat
        self._hb_rx: dict[int, tuple[int, int]] = {}

    # -- bring-up ------------------------------------------------------------

    @classmethod
    async def new_king(
        cls,
        bind: tuple[str, int],
        n_parties: int,
        ssl_context: ssl.SSLContext | None = None,
        net_cfg: NetConfig | None = None,
        *,
        device=None,
    ) -> "ProdNet":
        """Accept n_parties-1 client connections, read each id handshake,
        run the Syn/SynAck barrier (prod.rs:135-157). Clients may arrive in
        any order and re-dial after a failed handshake (the newest
        connection for an id wins); if the roster is still incomplete at
        connect_timeout_s, raises a structured error naming the missing
        parties."""
        self = cls(0, n_parties, net_cfg, device)
        cfg = self.net_cfg
        accepted: dict[int, StreamIO] = {}
        done = asyncio.Event()

        async def on_conn(reader, writer):
            io = StreamIO(reader, writer)
            try:
                raw = await asyncio.wait_for(
                    io.read_exactly(4), cfg.connect_timeout_s
                )
            except Exception:  # noqa: BLE001 — half-open dial; let it re-try
                await io.close()
                return
            (cid,) = struct.unpack("!I", raw)
            if not (1 <= cid < n_parties):
                await io.close()
                return
            stale = accepted.pop(cid, None)
            if stale is not None:
                # re-dial after a handshake failure: the old connection is
                # presumed dead (mTLS pins identity, so a duplicate id is
                # the same principal, not an impostor)
                log.warning("king: party %d re-dialed; dropping stale "
                            "connection", cid)
                await stale.close()
            accepted[cid] = io
            log.debug("king: accepted party %d (%d/%d)", cid,
                      len(accepted), n_parties - 1)
            if len(accepted) == n_parties - 1:
                done.set()

        server = await asyncio.start_server(
            on_conn, bind[0], bind[1], ssl=ssl_context
        )
        try:
            await asyncio.wait_for(done.wait(), cfg.connect_timeout_s)
        except (asyncio.TimeoutError, TimeoutError):
            missing = sorted(set(range(1, n_parties)) - set(accepted))
            server.close()
            for io in accepted.values():
                await io.close()
            raise MpcTimeoutError(
                f"king: parties {missing} never connected within "
                f"{cfg.connect_timeout_s}s",
                party=0, op="new_king",
            ) from None
        # stop listening; do NOT await wait_closed() — since Python 3.12 it
        # blocks until every accepted connection closes, and ours stay open
        server.close()
        self._ios = dict(accepted)
        await self._finish_setup()
        return self

    @classmethod
    async def new_peer(
        cls,
        party_id: int,
        king_addr: tuple[str, int],
        n_parties: int,
        ssl_context: ssl.SSLContext | None = None,
        server_hostname: str | None = None,
        net_cfg: NetConfig | None = None,
        *,
        device=None,
    ) -> "ProdNet":
        """Dial the king with exponential backoff and jitter under the
        total connect_timeout_s deadline: a client that starts before the
        king is listening connects as soon as the king comes up."""
        if party_id == 0:
            raise ValueError("party 0 is the king: use new_king")
        self = cls(party_id, n_parties, net_cfg, device)
        cfg = self.net_cfg
        loop = asyncio.get_running_loop()
        deadline = loop.time() + cfg.connect_timeout_s
        delay = cfg.connect_base_delay_s
        attempt = 0
        while True:
            io = None
            try:
                reader, writer = await asyncio.open_connection(
                    king_addr[0],
                    king_addr[1],
                    ssl=ssl_context,
                    server_hostname=server_hostname if ssl_context else None,
                )
                io = StreamIO(reader, writer)
                await io.write(struct.pack("!I", party_id))  # id handshake
                break
            except ssl.SSLError:
                # authentication/misconfig failures are permanent: fail fast
                if io is not None:
                    await io.close()
                raise
            except OSError as e:
                # close a connection whose handshake write failed before
                # the re-dial, or every backoff iteration leaks a socket
                if io is not None:
                    await io.close()
                attempt += 1
                now = loop.time()
                if now >= deadline:
                    raise MpcTimeoutError(
                        f"party {party_id}: king at {king_addr[0]}:"
                        f"{king_addr[1]} unreachable after {attempt} "
                        f"dials over {cfg.connect_timeout_s}s "
                        f"(last error: {e})",
                        party=party_id, peer=0, op="new_peer",
                    ) from None
                sleep = min(delay, cfg.connect_max_delay_s, deadline - now)
                sleep *= 1.0 + cfg.connect_jitter * random.random()
                log.debug("party %d: dial %d failed (%s); retrying in "
                          "%.2fs", party_id, attempt, e, sleep)
                await asyncio.sleep(sleep)
                delay *= 2.0
        self._ios = {0: io}
        await self._finish_setup()
        return self

    @classmethod
    async def king_from_ios(
        cls, ios: dict[int, Any], n_parties: int,
        net_cfg: NetConfig | None = None, *, device=None,
    ) -> "ProdNet":
        self = cls(0, n_parties, net_cfg, device)
        self._ios = dict(ios)
        await self._finish_setup()
        return self

    @classmethod
    async def peer_from_io(
        cls, party_id: int, io: Any, n_parties: int,
        net_cfg: NetConfig | None = None, *, device=None,
    ) -> "ProdNet":
        self = cls(party_id, n_parties, net_cfg, device)
        self._ios = {0: io}
        await self._finish_setup()
        return self

    async def _finish_setup(self) -> None:
        loop = asyncio.get_running_loop()
        for peer, io in self._ios.items():
            for sid in range(CHANNELS):
                self._queues[(peer, sid)] = asyncio.Queue()
            self._last_seen[peer] = loop.time()
            self._pumps.append(asyncio.create_task(self._pump(peer, io)))
            if self.net_cfg.heartbeat_interval_s > 0:
                self._heartbeats.append(
                    asyncio.create_task(self._heartbeat(peer, io))
                )
        try:
            await self._synchronize()
        except BaseException:
            # a failed barrier must not leak pumps, heartbeats or sockets
            # on the half-built node: the caller only ever sees the error
            await self.close()
            raise

    def _fail_peer(self, peer: int, reason: str, relay: bool = True) -> None:
        """Declare a peer dead: poison every (peer, sid) queue so pending
        AND future recvs raise with the reason, and — king only — relay
        the death to the other clients via ERR frames so the whole star
        fails fast instead of each rank timing out on its own."""
        if peer in self._dead or self._closed:
            return
        self._dead.add(peer)
        self._death_reason[peer] = reason
        log.warning("party %d: stream to peer %d died: %s",
                    self.party_id, peer, reason)
        for sid in range(CHANNELS):
            self._queues[(peer, sid)].put_nowait((None, reason))
        if relay and self.is_king:
            msg = f"king relay: party {peer} died ({reason})"
            for other, io in self._ios.items():
                if other != peer and other not in self._dead:
                    # tracked so close() can cancel an unflushed relay
                    self._pumps.append(
                        asyncio.create_task(self._send_err(io, msg))
                    )

    async def _send_err(self, io, reason: str) -> None:
        try:
            await _send_frame(io, ERR, 0, serde.dumps(reason))
        except Exception:  # noqa: BLE001 — best-effort death notice
            pass

    async def _pump(self, peer: int, io) -> None:
        """Per-connection reader: route inbound frames to (peer, sid)
        queues so the logical channels never block each other. ANY failure
        (EOF, malformed frame, bad sid — the peer may be hostile) marks all
        of the peer's queues dead with a descriptive reason."""
        loop = asyncio.get_running_loop()
        try:
            while True:
                ptype, sid, payload = await _recv_frame(io)
                self._last_seen[peer] = loop.time()
                if ptype == HEARTBEAT:
                    self._on_heartbeat(peer, payload)
                    continue
                if ptype == TELEMETRY:
                    continue  # no telemetry plane here: dropped
                if ptype == ERR:
                    try:
                        reason = serde.loads(payload)
                    except Exception:  # noqa: BLE001 — reason is best-effort
                        reason = "peer aborted (unreadable ERR payload)"
                    self._fail_peer(peer, str(reason))
                    return
                q = self._queues.get((peer, sid))
                if q is None:
                    raise MpcNetError(f"bad sid {sid} from {peer}",
                                      party=self.party_id, peer=peer)
                await q.put((ptype, payload))
        except asyncio.CancelledError:
            raise
        except PeerClosed as e:
            # finished or dead, the king cannot tell: no relay (module doc)
            self._fail_peer(peer, f"{type(e).__name__}: {e}", relay=False)
        except Exception as e:  # noqa: BLE001 — death sentinel on every failure
            self._fail_peer(peer, f"{type(e).__name__}: {e}")

    def _on_heartbeat(self, peer: int, payload: bytes) -> None:
        """Keep (their_send_ns, our_rx_ns) of the peer's heartbeat for our
        next one to echo. Empty or malformed payloads are ignored: the
        liveness role of the frame never depends on the echo."""
        if not payload:
            return
        try:
            t_send = serde.loads(payload)[0]
            self._hb_rx[peer] = (int(t_send), time.perf_counter_ns())
        except Exception:  # noqa: BLE001 — the echo is best-effort
            pass

    async def _heartbeat(self, peer: int, io) -> None:
        """Keepalive and liveness: send a HEARTBEAT every interval; declare
        the peer dead if nothing (data or heartbeat) arrived for
        idle_timeout_s."""
        cfg = self.net_cfg
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            if self._closed or peer in self._dead:
                return
            idle = loop.time() - self._last_seen[peer]
            if cfg.idle_timeout_s > 0 and idle > cfg.idle_timeout_s:
                # our own loop may just have resumed from a long
                # synchronous compute phase with the peer's frames still
                # in the socket buffer: give the pump a real scheduling
                # window to drain before declaring death
                await asyncio.sleep(min(1.0, cfg.heartbeat_interval_s))
                idle = loop.time() - self._last_seen[peer]
                if idle <= cfg.idle_timeout_s:
                    continue
                self._fail_peer(
                    peer,
                    f"idle timeout: no frames from {peer} for "
                    f"{idle:.1f}s (> {cfg.idle_timeout_s}s)",
                )
                return
            try:
                last = self._hb_rx.get(peer)
                payload = serde.dumps((
                    time.perf_counter_ns(),
                    last[0] if last else 0,
                    last[1] if last else 0,
                ))
                await _send_frame(io, HEARTBEAT, 0, payload)
            except Exception as e:  # noqa: BLE001 — write failure = death
                self._fail_peer(peer, f"heartbeat write failed: {e}")
                return

    async def _synchronize(self) -> None:
        """Syn/SynAck barrier (prod.rs:246-296), bounded by the connect
        deadline so a peer that dialed but wedged cannot hang bring-up."""
        try:
            await asyncio.wait_for(
                self._synchronize_inner(), self.net_cfg.connect_timeout_s
            )
        except (asyncio.TimeoutError, TimeoutError):
            raise MpcTimeoutError(
                "Syn/SynAck barrier timed out",
                party=self.party_id, op="synchronize",
            ) from None

    async def _synchronize_inner(self) -> None:
        if self.is_king:
            for io in self._ios.values():
                await _send_frame(io, SYN, 0, b"")
            for peer in self._ios:
                ptype, detail = await self._queues[(peer, 0)].get()
                if ptype != SYNACK:
                    raise MpcDisconnectError(
                        f"no SynAck from {peer} ({detail})",
                        party=0, peer=peer, op="synchronize",
                    )
        else:
            ptype, detail = await self._queues[(0, 0)].get()
            if ptype != SYN:
                raise MpcDisconnectError(
                    f"no Syn from king ({detail})",
                    party=self.party_id, peer=0, op="synchronize",
                )
            await _send_frame(self._ios[0], SYNACK, 0, b"")

    # -- MpcNet surface ------------------------------------------------------

    async def _send_impl(self, to: int, value: Any, sid: int) -> None:
        io = self._ios.get(to)
        if io is None:
            raise MpcNetError(
                f"party {self.party_id} has no connection to {to} (star)",
                party=self.party_id, peer=to, sid=sid,
            )
        if to in self._dead:
            raise MpcDisconnectError(
                f"stream to {to} died ({self._death_reason.get(to, '?')})",
                party=self.party_id, peer=to, sid=sid,
            )
        try:
            await _send_frame(io, DATA, sid, serde.dumps(_to_wire(value)))
        except (ConnectionError, OSError) as e:
            self._fail_peer(to, f"send failed: {type(e).__name__}: {e}")
            raise MpcDisconnectError(
                f"stream to {to} died mid-send ({e})",
                party=self.party_id, peer=to, sid=sid,
            ) from None

    async def _recv_impl(self, frm: int, sid: int) -> Any:
        q = self._queues.get((frm, sid))
        if q is None:
            raise MpcNetError(
                f"party {self.party_id} has no connection to {frm} (star)",
                party=self.party_id, peer=frm, sid=sid,
            )
        if frm in self._dead and q.empty():
            raise MpcDisconnectError(
                f"stream from {frm} died "
                f"({self._death_reason.get(frm, '?')})",
                party=self.party_id, peer=frm, sid=sid,
            )
        ptype, payload = await q.get()
        if ptype != DATA:
            # keep the queue poisoned: every later recv must also fail,
            # not hang on an empty queue with a dead pump
            q.put_nowait((ptype, payload))
            raise MpcDisconnectError(
                f"stream from {frm} died ({payload})",
                party=self.party_id, peer=frm, sid=sid,
            )
        return _from_wire(serde.loads(payload), self.device)

    async def abort(self, reason: str) -> None:
        """Tell every live peer this party is giving up (ERR frame), then
        close: peers fail their pending recvs at once with the reason
        instead of waiting out their deadlines."""
        for peer, io in self._ios.items():
            if peer not in self._dead:
                await self._send_err(
                    io, f"party {self.party_id} aborted: {reason}"
                )
        await self.close()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._pumps + self._heartbeats:
            t.cancel()
        for io in self._ios.values():
            await io.close()


def _to_wire(v):
    """Tensors (on any device) become host numpy arrays, recursively
    through lists and tuples; other values pass as they are."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        t = [_to_wire(x) for x in v]
        return t if isinstance(v, list) else tuple(t)
    return v


def _from_wire(v, device: torch.device):
    """Arrays become tensors on `device`, recursively. serde's arrays are
    read-only views of the frame: each is copied, so the tensor is
    writable and owns its memory."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy()).to(device)
    if isinstance(v, (list, tuple)):
        t = [_from_wire(x, device) for x in v]
        return t if isinstance(v, list) else tuple(t)
    return v
