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
can share one star.

Telemetry plane, as in the JAX package:
  * wire counters per peer and logical channel (bytes and frames each
    way, heartbeats, redials, ERR frames, peer deaths, idle seconds);
  * HEARTBEAT payloads carry an NTP-style clock echo — serde (t_send_ns,
    echo_t0_ns, echo_rx_ns) — feeding a per-peer ClockSync so the king
    can rebase client span timestamps into its own clock;
  * TELEMETRY frames (type 5, DG16_AGG-gated) ship each client's
    compacted span buffer and metric snapshot to the king at round
    boundaries and on shutdown; the king holds a frame until the peer's
    clock has a sample, then merges it into the process TraceAggregator
    with the offset applied;
  * fault events (peer death, ERR frames, redials) feed the flight
    recorder's ring; a peer death triggers a post-mortem dump
    (DG16_FLIGHT_DIR).

Values cross as utils/serde.py wire values. A torch tensor is sent as
its host numpy array (the port's limbs are int32, wire dtype code 1; the
JAX package sends uint32); a received array becomes a tensor on the
net's `device`. serde carries uint32, int32, uint8 and int64 arrays only:
any other dtype raises TypeError.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import ssl
import struct
from typing import Any

import numpy as np
import torch

from ..ops.field import resolve_device
from ..telemetry import aggregate as _agg
from ..telemetry import flight as _flight
from ..telemetry import metrics as _tm
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

# -- network accounting ------------------------------------------------------
# Wire-level counters (the JAX package's names): bytes/frames per peer and
# logical channel, heartbeat liveness, and fault events. Per-(peer, sid)
# children are pre-bound at _finish_setup so the frame path pays one dict
# lookup per send/recv; cold paths (dial retries, deaths) bind inline.
_REG = _tm.registry()
_BYTES_TX = _REG.counter(
    "net_bytes_sent_total", "Frame bytes written, per peer and channel",
    ("peer", "sid"),
)
_BYTES_RX = _REG.counter(
    "net_bytes_recv_total", "Frame bytes read, per peer and channel",
    ("peer", "sid"),
)
_FRAMES_TX = _REG.counter(
    "net_frames_sent_total", "Frames written, per peer and channel",
    ("peer", "sid"),
)
_FRAMES_RX = _REG.counter(
    "net_frames_recv_total", "Frames read, per peer and channel",
    ("peer", "sid"),
)
_HB_SENT = _REG.counter(
    "net_heartbeats_sent_total", "HEARTBEAT frames written, per peer",
    ("peer",),
)
_PEER_IDLE = _REG.gauge(
    "net_peer_idle_seconds",
    "Seconds since the last frame from peer (sampled each heartbeat tick)",
    ("peer",),
)
_RECONNECTS = _REG.counter(
    "net_reconnects_total", "Client re-dials of the king, per party",
    ("party",),
)
_ERR_FRAMES = _REG.counter(
    "net_err_frames_total", "ERR death-notice frames received, per peer",
    ("peer",),
)
_PEER_DEATHS = _REG.counter(
    "net_peer_deaths_total", "Peers declared dead, per peer", ("peer",)
)
_TLM_TX = _REG.counter(
    "telemetry_frames_sent_total",
    "TELEMETRY frames (compacted spans + metrics) written, per peer",
    ("peer",),
)
_TLM_RX = _REG.counter(
    "telemetry_frames_recv_total",
    "TELEMETRY frames received and merged, per peer",
    ("peer",),
)

SYN, SYNACK, DATA, HEARTBEAT, ERR, TELEMETRY = 0, 1, 2, 3, 4, 5

# frame overhead: u32 length prefix + (packet_type, sid) envelope
_FRAME_OVERHEAD = 6

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
        # clock alignment: per-peer NTP-style estimators fed by heartbeat
        # echoes, and the last heartbeat received from each peer
        # (their_send_ns, our_rx_ns) — echoed back on our next heartbeat
        # to close the loop
        self._clocks: dict[int, _agg.ClockSync] = {}
        self._hb_rx: dict[int, tuple[int, int]] = {}
        # TELEMETRY frames held until the peer's clock offset has at
        # least one sample (bounded per peer) — merging with offset 0
        # would put another process's perf_counter epoch on our timeline
        self._pending_tlm: dict[int, list[dict]] = {}
        # king-side round close: parties (self included) that contributed
        # telemetry since the last finish_round — when every live party
        # has, the round's critical path is computed and recorded
        self._tlm_since_close: set[int] = set()
        # pre-bound per-(peer, sid) accounting children (populated in
        # _finish_setup): (bytes, frames) counter pairs per direction
        self._acct_tx: dict[tuple[int, int], tuple] = {}
        self._acct_rx: dict[tuple[int, int], tuple] = {}
        self._acct_hb: dict[int, Any] = {}
        self._acct_idle: dict[int, Any] = {}

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
                _RECONNECTS.labels(party=str(party_id)).inc()
                _flight.note("redial", party=party_id, attempt=attempt,
                             error=str(e))
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
            p = str(peer)
            self._acct_hb[peer] = _HB_SENT.labels(peer=p)
            self._acct_idle[peer] = _PEER_IDLE.labels(peer=p)
            self._clocks[peer] = _agg.ClockSync(label=p)
            for sid in range(CHANNELS):
                self._queues[(peer, sid)] = asyncio.Queue()
                s = str(sid)
                self._acct_tx[(peer, sid)] = (
                    _BYTES_TX.labels(peer=p, sid=s),
                    _FRAMES_TX.labels(peer=p, sid=s),
                )
                self._acct_rx[(peer, sid)] = (
                    _BYTES_RX.labels(peer=p, sid=s),
                    _FRAMES_RX.labels(peer=p, sid=s),
                )
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

    def _account_tx(self, peer: int, sid: int, payload_len: int) -> None:
        """Count one written frame — every write path must call this so
        tx and rx accounting reconcile frame-for-frame on a healthy link
        (the pump counts the receive side)."""
        acct = self._acct_tx.get((peer, sid))
        if acct is not None:
            acct[0].inc(payload_len + _FRAME_OVERHEAD)
            acct[1].inc()

    def _now_ns(self) -> int:
        """The telemetry clock (perf_counter_ns — the span clock). A
        method so tests can subclass in a skewed clock and watch the
        estimator converge."""
        return _agg.now_ns()

    def _fail_peer(self, peer: int, reason: str, relay: bool = True) -> None:
        """Declare a peer dead: poison every (peer, sid) queue so pending
        AND future recvs raise with the reason, and — king only — relay
        the death to the other clients via ERR frames so the whole star
        fails fast instead of each rank timing out on its own."""
        if peer in self._dead or self._closed:
            return
        self._dead.add(peer)
        self._death_reason[peer] = reason
        _PEER_DEATHS.labels(peer=str(peer)).inc()
        log.warning("party %d: stream to peer %d died: %s",
                    self.party_id, peer, reason)
        # the fault machinery firing is the flight recorder's trigger:
        # queue poisoning below is exactly the moment the post-mortem ring
        # still holds the lead-up
        _flight.note(
            "peer_death", party=self.party_id, peer=peer, reason=reason
        )
        _flight.dump_soon(
            "peer_death", party=self.party_id,
            extra={"peer": peer, "reason": reason},
        )
        for sid in range(CHANNELS):
            self._queues[(peer, sid)].put_nowait((None, reason))
        if relay and self.is_king:
            msg = f"king relay: party {peer} died ({reason})"
            for other, io in self._ios.items():
                if other != peer and other not in self._dead:
                    # tracked so close() can cancel an unflushed relay
                    self._pumps.append(
                        asyncio.create_task(self._send_err(other, io, msg))
                    )

    async def _send_err(self, peer: int, io, reason: str) -> None:
        try:
            payload = serde.dumps(reason)
            await _send_frame(io, ERR, 0, payload)
            self._account_tx(peer, 0, len(payload))
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
                acct = self._acct_rx.get((peer, sid))
                if acct is not None:
                    acct[0].inc(len(payload) + _FRAME_OVERHEAD)
                    acct[1].inc()
                if ptype == HEARTBEAT:
                    self._on_heartbeat(peer, payload)
                    continue
                if ptype == TELEMETRY:
                    self._on_telemetry(peer, payload)
                    continue
                if ptype == ERR:
                    _ERR_FRAMES.labels(peer=str(peer)).inc()
                    _flight.note("err_frame", party=self.party_id, peer=peer)
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
        """Clock-echo half of the heartbeat: the payload is (t_send_ns,
        echo_t0_ns, echo_rx_ns) in the sender's / our clock. Recording
        (their_send, our_rx) arms OUR next heartbeat to echo; a completed
        echo yields one (offset, rtt) sample. Empty or malformed payloads
        are ignored: the liveness role of the frame never depends on the
        echo."""
        if not payload:
            return
        try:
            t_send, echo_t0, echo_rx = serde.loads(payload)
            now = self._now_ns()
            self._hb_rx[peer] = (int(t_send), now)
            if echo_t0 and echo_rx:
                off, rtt = _agg.ClockSync.from_echo(
                    int(echo_t0), int(echo_rx), int(t_send), now
                )
                self._clocks[peer].add_sample(off, rtt)
                # a clock estimate exists now: merge any TELEMETRY frames
                # that arrived before it did
                for body in self._pending_tlm.pop(peer, ()):
                    self._merge_telemetry(peer, body)
        except Exception:  # noqa: BLE001 — the echo is best-effort
            pass

    def _on_telemetry(self, peer: int, payload: bytes) -> None:
        """Merge one TELEMETRY frame: the peer's compacted span events are
        rebased into OUR clock (−ClockSync.offset_ns) and handed to the
        process aggregator, with its metric snapshot alongside. Frames
        arriving with aggregation off are counted and dropped."""
        _TLM_RX.labels(peer=str(peer)).inc()
        if not _agg.enabled():
            return
        try:
            body = json.loads(serde.loads(payload))
        except Exception as e:  # noqa: BLE001 — telemetry must not kill the pump
            log.warning("party %d: unreadable TELEMETRY frame from %d: %s",
                        self.party_id, peer, e)
            return
        # No clock sample yet means timestamps are on another process's
        # perf_counter epoch — hold the frame until the heartbeat echo
        # delivers an offset (bounded; with heartbeats disabled there
        # will never be one, so merge unaligned — the in-process tests'
        # shared-clock case, where offset 0 is in fact correct).
        if (
            self.net_cfg.heartbeat_interval_s > 0
            and self._clocks[peer].n_samples == 0
        ):
            held = self._pending_tlm.setdefault(peer, [])
            held.append(body)
            del held[:-8]  # cap per peer; oldest frames drop first
            return
        self._merge_telemetry(peer, body)

    def _merge_telemetry(self, peer: int, body: dict) -> None:
        try:
            _agg.aggregator().add_party(
                peer,
                body.get("spans", []),
                offset_ns=-self._clocks[peer].offset_ns,
                metrics=body.get("metrics"),
            )
        except Exception as e:  # noqa: BLE001
            log.warning("party %d: failed to merge TELEMETRY from %d: %s",
                        self.party_id, peer, e)
            return
        self._note_tlm_contribution(peer)

    def _note_tlm_contribution(self, party: int) -> None:
        """King-side round close over the real transport: once every
        live party (dead peers excluded — a killed star must still close
        its last round) has flushed since the previous close, compute
        and record the round's critical path. The in-process backend
        closes rounds in simulate_network_round instead."""
        if not self.is_king:
            return
        self._tlm_since_close.add(party)
        live = {p for p in self._ios if p not in self._dead} | {0}
        if live <= self._tlm_since_close:
            _agg.aggregator().finish_round()
            self._tlm_since_close.clear()

    async def flush_telemetry(self) -> None:
        """Round-boundary (and shutdown) telemetry flush. Clients compact
        their aggregation buffer + a metric snapshot into one TELEMETRY
        frame to the king; the king folds its own buffer straight into
        the aggregator (client frames merge as they arrive in the pump).
        A no-op — no frame, no drain — when DG16_AGG is off."""
        if not _agg.enabled() or self._closed:
            return
        if self.is_king:
            agg = _agg.aggregator()
            for party, group in _agg.group_by_pid(_agg.drain()).items():
                agg.add_party(party, group)
            self._note_tlm_contribution(0)
            return
        # deliberately NOT gated on `0 in self._dead`: a relayed death of
        # ANOTHER party fails the star fast and marks the king dead here,
        # but this client's socket to the king is usually still healthy —
        # and a post-fault flush is exactly the post-mortem telemetry the
        # flight recorder wants. A genuinely dead socket just fails the
        # best-effort write below.
        io = self._ios.get(0)
        if io is None:
            return  # nothing drained: the spans keep for the next flush
        events = _agg.drain()
        payload = serde.dumps(json.dumps({
            "party": self.party_id,
            "spans": events,
            "metrics": _tm.registry().snapshot(),
        }))
        try:
            await _send_frame(io, TELEMETRY, 0, payload)
            self._account_tx(0, 0, len(payload))
            _TLM_TX.labels(peer="0").inc()
        except Exception as e:  # noqa: BLE001 — telemetry is best-effort
            # the send failed but the spans need not die with it: put
            # them back so the shutdown flush (or the next round's) can
            # retry on whatever transport is left
            _agg.requeue(events)
            log.debug("party %d: telemetry flush failed: %s",
                      self.party_id, e)

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
            self._acct_idle[peer].set(idle)
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
                # piggyback the NTP-style clock echo: our send time plus
                # the echo of the peer's last heartbeat (_on_heartbeat)
                last = self._hb_rx.get(peer)
                payload = serde.dumps((
                    self._now_ns(),
                    last[0] if last else 0,
                    last[1] if last else 0,
                ))
                await _send_frame(io, HEARTBEAT, 0, payload)
                self._acct_hb[peer].inc()
                self._account_tx(peer, 0, len(payload))
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
            for peer, io in self._ios.items():
                await _send_frame(io, SYN, 0, b"")
                self._account_tx(peer, 0, 0)
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
            self._account_tx(0, 0, 0)

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
            payload = serde.dumps(_to_wire(value))
            await _send_frame(io, DATA, sid, payload)
            self._account_tx(to, sid, len(payload))
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
                    peer, io, f"party {self.party_id} aborted: {reason}"
                )
        await self.close()

    async def close(self) -> None:
        if self._closed:
            return
        # ship whatever spans the aggregation buffer still holds before
        # the sockets go away ("at round boundaries AND on shutdown")
        if _agg.enabled():
            try:
                await self.flush_telemetry()
            except Exception:  # noqa: BLE001 — closing must never fail
                pass
            # frames still held for a clock sample that never came:
            # merging unaligned beats losing the round's spans outright
            for peer, bodies in list(self._pending_tlm.items()):
                for body in bodies:
                    self._merge_telemetry(peer, body)
            self._pending_tlm.clear()
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
