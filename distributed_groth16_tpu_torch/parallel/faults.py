"""Fault injection for the star transport — the chaos-testing harness.

`FaultyIO` wraps any object with the minimal IO interface of prodnet.py
(`read_exactly` / `write` / `close`: StreamIO, ChannelIO, or another
FaultyIO) and injects transport faults on a deterministic, seeded
schedule. The chaos suite (tests/test_faults.py) uses it to prove every
failure mode surfaces as a structured MpcNetError within its deadline —
no hangs, no silent corruption.

Faults are keyed by *write index*: prodnet frames each cross the wire as
exactly one `write()` call (length prefix + envelope + payload), so write
#i is frame #i and the length prefix is bytes [0, 4) of that write. This
makes scripted faults line up with protocol frames without the wrapper
having to parse them.

Supported faults:
  * delay    — seeded random sleep before any read/write (delay_p /
               max_delay_s): latency jitter that must stay under op
               deadlines.
  * drop     — writes from `drop_writes_from` on are swallowed: the peer
               sees silence (deadline / idle-timeout territory).
  * truncate — write `truncate_write_at` sends only half its bytes, then
               the connection behaves disconnected: the peer sees a
               partial frame then EOF.
  * corrupt  — write `corrupt_len_at` has its 4-byte length prefix
               overwritten with an over-cap value: the peer's framing
               layer must reject it without allocating.
  * disconnect — from `disconnect_write_at` / `disconnect_read_at` on,
               ops raise ConnectionResetError and the inner IO is closed:
               a mid-collective crash.
"""

from __future__ import annotations

import asyncio
import random
import struct


class FaultyIO:
    """Deterministic fault-injecting wrapper over a prodnet IO object."""

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        delay_p: float = 0.0,
        max_delay_s: float = 0.01,
        drop_writes_from: int | None = None,
        truncate_write_at: int | None = None,
        corrupt_len_at: int | None = None,
        disconnect_write_at: int | None = None,
        disconnect_read_at: int | None = None,
    ):
        self.inner = inner
        self._rng = random.Random(seed)
        self.delay_p = delay_p
        self.max_delay_s = max_delay_s
        self.drop_writes_from = drop_writes_from
        self.truncate_write_at = truncate_write_at
        self.corrupt_len_at = corrupt_len_at
        self.disconnect_write_at = disconnect_write_at
        self.disconnect_read_at = disconnect_read_at
        self.writes = 0  # frames attempted (faulted or not)
        self.reads = 0
        self._disconnected = False

    async def _maybe_delay(self) -> None:
        if self.delay_p > 0 and self._rng.random() < self.delay_p:
            await asyncio.sleep(self._rng.random() * self.max_delay_s)

    async def _disconnect(self) -> None:
        if not self._disconnected:
            self._disconnected = True
            await self.inner.close()  # peer sees EOF, not silence

    @staticmethod
    def _hit(mark: int | None, index: int) -> bool:
        return mark is not None and index == mark

    def _from(self, mark: int | None, index: int) -> bool:
        return mark is not None and index >= mark

    async def read_exactly(self, n: int) -> bytes:
        i = self.reads
        self.reads += 1
        if self._disconnected or self._from(self.disconnect_read_at, i):
            await self._disconnect()
            raise ConnectionResetError("fault injection: read disconnect")
        await self._maybe_delay()
        return await self.inner.read_exactly(n)

    async def write(self, data: bytes) -> None:
        i = self.writes
        self.writes += 1
        if self._disconnected or self._from(self.disconnect_write_at, i):
            await self._disconnect()
            raise ConnectionResetError("fault injection: write disconnect")
        await self._maybe_delay()
        if self._from(self.drop_writes_from, i):
            return  # swallowed: the peer sees silence
        if self._hit(self.truncate_write_at, i):
            await self.inner.write(data[: max(1, len(data) // 2)])
            await self._disconnect()
            return
        if self._hit(self.corrupt_len_at, i):
            # hostile/garbage length prefix, over the frame cap
            data = struct.pack("!I", 0xFFFFFFFF) + bytes(data[4:])
        await self.inner.write(data)

    async def close(self) -> None:
        await self.inner.close()
