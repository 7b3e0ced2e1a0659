"""Transport-agnostic star-topology collectives — the counterpart of
distributed_groth16_tpu/parallel/net.py (the reference's mpc-net crate,
mpc-net/src/lib.rs:37-155).

The collective vocabulary is the reference's three primitives plus
point-to-point sends:

  * gather_to_king    — every party contributes one value; the king gets
                        the list ordered by party id (own value included),
                        clients get None.
  * scatter_from_king — the king provides one value per party (keeps its
                        own), clients receive theirs.
  * king_compute      — gather -> f on the king -> scatter.

Three logical channels (CHANNELS = 3) let three independent collectives
overlap — the a/b/c FFT pipelines and the W/U/H MSMs of the prover.

Values are arbitrary Python objects, typically torch tensors or lists of
them. LocalSimNet hands them over BY REFERENCE: all parties run in one
process (on one card), and a gathered or scattered tensor is the very
object its sender holds — d_msm's king even returns one tensor object to
all n parties. Torch tensors are mutable where JAX arrays are not, so the
rule of the port is: nothing writes in place to a tensor that crossed the
net (tests/test_torch_mpc.py checks every value sent in a full proving
round against a copy taken at send time).

Fault tolerance: every collective takes a per-op `timeout=` (falling back
to the net's NetConfig.op_timeout_s) and raises a structured MpcNetError —
MpcTimeoutError / MpcDisconnectError carrying (party, peer, sid, op, job)
— instead of hanging on a silent peer.

Left out of this port so far: the JAX package's telemetry hooks
(collective latency histograms, timeout and retry counters, net.* spans,
the flight recorder and the trace aggregator) and the socket transport
(prodnet.py); `flush_telemetry` is a no-op.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
from contextlib import contextmanager
from typing import Any, Awaitable, Callable, Protocol, Sequence

from ..utils.config import NetConfig

log = logging.getLogger(__name__)

CHANNELS = 3

# The job the current dynamic extent is proving for, so a transport
# failure deep inside a collective names the job that died. Contextvars
# flow into asyncio tasks, so one `with job_context(id):` around the round
# suffices.
CURRENT_JOB_ID: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "dg16_job_id", default=None
)


@contextmanager
def job_context(job_id: str | None):
    """Label every MpcNetError raised in this extent with `job_id`."""
    token = CURRENT_JOB_ID.set(job_id)
    try:
        yield
    finally:
        CURRENT_JOB_ID.reset(token)


class MpcNetError(RuntimeError):
    """Structured transport failure: names the local party, the peer the
    op was against, the logical channel, the collective and, inside a
    job_context, the job's correlation id."""

    def __init__(
        self,
        msg: str,
        *,
        party: int | None = None,
        peer: int | None = None,
        sid: int | None = None,
        op: str | None = None,
        job_id: str | None = None,
    ):
        self.party = party
        self.peer = peer
        self.sid = sid
        self.op = op
        self.job_id = job_id if job_id is not None else CURRENT_JOB_ID.get()
        ctx = ", ".join(
            f"{k}={v}"
            for k, v in (
                ("party", party), ("peer", peer), ("sid", sid), ("op", op),
                ("job", self.job_id),
            )
            if v is not None
        )
        super().__init__(f"{msg} [{ctx}]" if ctx else msg)
        self.msg = msg

    def with_op(self, op: str) -> "MpcNetError":
        """Same failure, re-labelled with the enclosing collective."""
        return type(self)(
            self.msg, party=self.party, peer=self.peer, sid=self.sid, op=op,
            job_id=self.job_id,
        )


class MpcTimeoutError(MpcNetError):
    """An op exceeded its configured deadline (peer alive but silent)."""


class MpcDisconnectError(MpcNetError):
    """The peer's stream died (EOF, corrupt frame, reported failure)."""


class Net(Protocol):
    """The MpcNet-shaped async interface every distributed kernel takes."""

    party_id: int
    n_parties: int

    @property
    def is_king(self) -> bool: ...

    async def send_to(
        self, to: int, value: Any, sid: int = 0,
        timeout: float | None = None,
    ) -> None: ...

    async def recv_from(
        self, frm: int, sid: int = 0, timeout: float | None = None
    ) -> Any: ...

    async def gather_to_king(
        self, value: Any, sid: int = 0, timeout: float | None = None
    ): ...

    async def scatter_from_king(
        self, values, sid: int = 0, timeout: float | None = None
    ): ...


class BaseNet:
    """Collectives implemented over send_to/recv_from. Subclasses implement
    `_send_impl` / `_recv_impl`; the deadline and structured-error wrapping
    live here so every backend gets them."""

    party_id: int
    n_parties: int
    net_cfg: NetConfig | None = None

    @property
    def is_king(self) -> bool:
        return self.party_id == 0

    async def _send_impl(self, to: int, value: Any, sid: int) -> None:
        raise NotImplementedError

    async def _recv_impl(self, frm: int, sid: int) -> Any:
        raise NotImplementedError

    def _resolve_timeout(self, timeout: float | None) -> float | None:
        """Per-op override > config default; <= 0 means no deadline."""
        if timeout is None and self.net_cfg is not None:
            timeout = self.net_cfg.op_timeout_s
        if timeout is not None and timeout <= 0:
            return None
        return timeout

    async def send_to(
        self, to: int, value: Any, sid: int = 0,
        timeout: float | None = None,
    ) -> None:
        t = self._resolve_timeout(timeout)
        try:
            if t is None:
                await self._send_impl(to, value, sid)
            else:
                await asyncio.wait_for(self._send_impl(to, value, sid), t)
        except (asyncio.TimeoutError, TimeoutError):
            raise MpcTimeoutError(
                f"send deadline ({t}s) exceeded",
                party=self.party_id, peer=to, sid=sid, op="send_to",
            ) from None

    async def recv_from(
        self, frm: int, sid: int = 0, timeout: float | None = None
    ) -> Any:
        t = self._resolve_timeout(timeout)
        try:
            if t is None:
                return await self._recv_impl(frm, sid)
            return await asyncio.wait_for(self._recv_impl(frm, sid), t)
        except (asyncio.TimeoutError, TimeoutError):
            raise MpcTimeoutError(
                f"recv deadline ({t}s) exceeded",
                party=self.party_id, peer=frm, sid=sid, op="recv_from",
            ) from None

    async def gather_to_king(
        self, value: Any, sid: int = 0, timeout: float | None = None
    ):
        """King returns [v_0, ..., v_{n-1}] (own value at index 0);
        clients send and return None."""
        try:
            return await self._gather_impl(value, sid, timeout)
        except MpcNetError as e:
            raise e.with_op("gather_to_king") from None

    async def _gather_impl(self, value, sid, timeout):
        if self.is_king:
            out = [value]
            recvs = [
                asyncio.create_task(self.recv_from(i, sid, timeout=timeout))
                for i in range(1, self.n_parties)
            ]
            try:
                out.extend(await asyncio.gather(*recvs))
            except BaseException:
                # reap the sibling recvs: a leaked task would consume a
                # healthy peer's NEXT frame and desync later collectives
                for t in recvs:
                    t.cancel()
                await asyncio.gather(*recvs, return_exceptions=True)
                raise
            return out
        await self.send_to(0, value, sid, timeout=timeout)
        return None

    async def scatter_from_king(
        self, values, sid: int = 0, timeout: float | None = None
    ):
        """King passes one value per party (or None if client); every party
        returns its own value."""
        if self.is_king:
            if values is None:
                raise MpcNetError("scatter_from_king: king must provide values")
            if len(values) != self.n_parties:
                raise MpcNetError(
                    f"scatter_from_king: {len(values)} values for "
                    f"{self.n_parties} parties"
                )
        try:
            return await self._scatter_impl(values, sid, timeout)
        except (MpcTimeoutError, MpcDisconnectError) as e:
            raise e.with_op("scatter_from_king") from None

    async def _scatter_impl(self, values, sid, timeout):
        if self.is_king:
            sends = [
                asyncio.create_task(
                    self.send_to(i, values[i], sid, timeout=timeout)
                )
                for i in range(1, self.n_parties)
            ]
            try:
                await asyncio.gather(*sends)
            except BaseException:
                for t in sends:
                    t.cancel()
                await asyncio.gather(*sends, return_exceptions=True)
                raise
            return values[0]
        if values is not None:
            raise MpcNetError("scatter_from_king: client must pass None")
        return await self.recv_from(0, sid, timeout=timeout)

    async def king_compute(
        self,
        value: Any,
        f: Callable[[list], list],
        sid: int = 0,
        timeout: float | None = None,
    ):
        """gather -> f on king -> scatter (MpcNet::king_compute)."""
        gathered = await self.gather_to_king(value, sid, timeout=timeout)
        out = f(gathered) if gathered is not None else None
        return await self.scatter_from_king(out, sid, timeout=timeout)

    async def broadcast_from_king(
        self, value: Any, sid: int = 0, timeout: float | None = None
    ):
        """King's value to everyone."""
        vals = [value] * self.n_parties if self.is_king else None
        return await self.scatter_from_king(vals, sid, timeout=timeout)

    async def flush_telemetry(self) -> None:
        """Round-boundary telemetry flush: a no-op until the telemetry
        port lands."""
        return None


class LocalSimNet(BaseNet):
    """In-process n-party network: one shared mailbox fabric, one instance
    per party. Values cross by reference (see the module docstring)."""

    def __init__(
        self, party_id: int, n_parties: int, fabric,
        net_cfg: NetConfig | None = None,
    ):
        self.party_id = party_id
        self.n_parties = n_parties
        self._fabric = fabric
        self.net_cfg = net_cfg

    async def _send_impl(self, to: int, value: Any, sid: int) -> None:
        if not (0 <= to < self.n_parties) or to == self.party_id:
            raise MpcNetError(f"bad destination {to}",
                              party=self.party_id, peer=to, sid=sid)
        await self._fabric[(self.party_id, to, sid)].put(value)

    async def _recv_impl(self, frm: int, sid: int) -> Any:
        if not (0 <= frm < self.n_parties) or frm == self.party_id:
            raise MpcNetError(f"bad source {frm}",
                              party=self.party_id, peer=frm, sid=sid)
        return await self._fabric[(frm, self.party_id, sid)].get()


def make_local_nets(
    n_parties: int, net_cfg: NetConfig | None = None
) -> list[LocalSimNet]:
    """One LocalSimNet per party over a fresh shared fabric."""
    fabric = {
        (s, d, c): asyncio.Queue()
        for s in range(n_parties)
        for d in range(n_parties)
        for c in range(CHANNELS)
        if s != d
    }
    return [
        LocalSimNet(i, n_parties, fabric, net_cfg) for i in range(n_parties)
    ]


def simulate_network_round(
    n_parties: int,
    closure: Callable[[Net, Any], Awaitable[Any]],
    per_party_data: Sequence[Any] | None = None,
    net_cfg: NetConfig | None = None,
) -> list:
    """Run `closure(net, data)` concurrently for every party in one asyncio
    loop; return results ordered by party id. Call it from synchronous
    code only (it runs asyncio.run)."""

    async def _run():
        nets = make_local_nets(n_parties, net_cfg)
        tasks = [
            closure(
                nets[i],
                per_party_data[i] if per_party_data is not None else None,
            )
            for i in range(n_parties)
        ]
        return await asyncio.gather(*tasks)

    return asyncio.run(_run())


def run_round_with_retries(
    n_parties: int,
    closure: Callable[[Net, Any], Awaitable[Any]],
    per_party_data: Sequence[Any] | None = None,
    *,
    retries: int = 2,
    net_cfg: NetConfig | None = None,
    on_retry: Callable[[int, MpcNetError], None] | None = None,
) -> list:
    """`simulate_network_round` with bounded re-runs on transport faults.

    A transient fault (MpcTimeoutError / MpcDisconnectError) re-runs the
    WHOLE round on a fresh fabric. Application errors — including plain
    MpcNetError protocol misuse, which would fail identically on every
    re-run — propagate at once; after `retries` re-runs the last transient
    error propagates too."""
    attempts = retries + 1
    for attempt in range(attempts):
        try:
            return simulate_network_round(
                n_parties, closure, per_party_data, net_cfg
            )
        except (MpcTimeoutError, MpcDisconnectError) as e:
            if attempt == attempts - 1:
                raise
            log.warning(
                "round attempt %d/%d failed (%s); retrying",
                attempt + 1, attempts, e,
            )
            if on_retry is not None:
                on_retry(attempt, e)
    raise AssertionError("unreachable")
