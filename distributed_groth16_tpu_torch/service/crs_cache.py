"""Packed-CRS LRU cache.

`pack_proving_key` is the dominant fixed cost of an MPC proof on a warm
circuit (the r4 profile put CRS packing at 84% of million-2^13 wall-clock
before the scalar route): it depends only on the stored proving key and
the packing params, not on the witness — so repeat proofs on a hot
circuit can skip it entirely. Entries are keyed by (circuit_id, packing
params); distinct packing factors on one circuit are distinct entries.

Thread-safety + single-flight: worker threads race on a hot key, and
packing is seconds-to-minutes, so the first thread to miss becomes the
leader (computes outside the lock) while followers wait on a per-key
event and then read the cached value — N concurrent proofs on one
circuit cost exactly one pack. A leader failure wakes followers, which
retry leadership so one transient fault doesn't poison the key.

Hit/miss/eviction counters feed `/stats`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

from ..telemetry import metrics as _tm

# Process-wide counters (docs/OBSERVABILITY.md) — the /metrics view of the
# per-instance ints below. A process runs one service cache, so summing
# across instances (tests build throwaways) is the intended semantics.
_REG = _tm.registry()
_HITS = _REG.counter("crs_cache_hits_total", "Packed-CRS cache hits")
_MISSES = _REG.counter("crs_cache_misses_total", "Packed-CRS cache misses")
_EVICTIONS = _REG.counter(
    "crs_cache_evictions_total", "Packed-CRS cache LRU evictions"
)


class CrsCache:
    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._data: OrderedDict[Any, Any] = OrderedDict()
        self._pending: dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_pack(self, key: Any, factory: Callable[[], Any]) -> Any:
        """Return the cached value for `key`, computing it with `factory`
        on a miss. Concurrent callers on one missing key run `factory`
        once. With capacity 0, caching is disabled and every call packs."""
        if self.capacity <= 0:
            with self._lock:
                self.misses += 1
            _MISSES.inc()
            return factory()
        while True:
            with self._lock:
                if key in self._data:
                    self._data.move_to_end(key)
                    self.hits += 1
                    _HITS.inc()
                    return self._data[key]
                ev = self._pending.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._pending[key] = ev
                    self.misses += 1
                    _MISSES.inc()
                    break  # we are the leader
            # follower: wait for the leader, then re-check (a dead leader
            # leaves the key absent and we retry for leadership)
            ev.wait()
        try:
            value = factory()
        except BaseException:
            with self._lock:
                del self._pending[key]
            ev.set()
            raise
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1
                _EVICTIONS.inc()
            del self._pending[key]
        ev.set()
        return value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hitRate": (self.hits / total) if total else None,
            }
