"""Device memory telemetry: HBM state as gauges, snapshots, and deltas —
the JAX package's telemetry/devmem.py over the CUDA caching allocator
(`torch.cuda.memory_stats`, `max_memory_allocated`) where the JAX module
reads `jax.devices()` and `memory_stats()`.

`telemetry/perf.py` sampled `memory_stats()` exactly once per bench run;
nothing else in the repo could say what device memory looked like while a
job OOMed or a batch peaked. This module is the one reader of the backend
memory API everything else goes through:

  * `sample()` — read `memory_stats()` per device and export
    `device_memory_bytes{device,kind=in_use|peak|limit}` gauges. A
    background sampler (ApiServer, `DG16_DEVMEM_SAMPLE_S`) keeps the
    gauges fresh for scrapes.
  * `snapshot()` — the same read as a JSON-able document, never raising:
    attached to every flight-recorder post-mortem so an OOM post-mortem
    carries the HBM state, and to bench.py's JSON line.
  * `peak_bytes()` — summed `peak_bytes_in_use`; the executor and batch
    prover bracket a job with it and stamp the peak DELTA into the
    ProofJob DTO (`metrics.deviceMemory`).

Every reader is None-safe by contract: the CPU has no memory stats, so
CPU records carry nulls and nothing downstream may assume numbers, as
with the JAX package on XLA:CPU.
"""

from __future__ import annotations

from . import metrics as _tm

_REG = _tm.registry()
_DEVICE_MEMORY = _REG.gauge(
    "device_memory_bytes",
    "Backend memory_stats() per device: bytes in use, process peak, and "
    "the allocator limit (absent on the CPU, which reports no stats)",
    ("device", "kind"),
)

# gauge `kind` label -> memory_stats() key
_KINDS = (
    ("in_use", "bytes_in_use"),
    ("peak", "peak_bytes_in_use"),
    ("limit", "bytes_limit"),
)


def _devices():
    """The CUDA devices, or none: the CPU reports no memory stats."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001 — no backend is "no data", not a fault
        return []


def _stats_of(dev) -> dict | None:
    """The JAX `memory_stats()` keys from the CUDA caching allocator:
    bytes_in_use and peak_bytes_in_use are its allocated bytes (current
    and peak since the last reset), bytes_limit the card's memory. None
    for a device that is not a CUDA device."""
    try:
        import torch

        dev = torch.device(dev)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        }
    except Exception:  # noqa: BLE001 — some backends raise instead of None
        return None


def device_label(dev) -> str:
    dev = str(dev)
    return dev if ":" in dev else f"{dev}:0"


def sample(devices=None) -> dict:
    """Read every device's memory stats, set the gauges, and return
    `{device_label: {inUseBytes, peakBytes, limitBytes} | None}` — None
    per device whose backend reports nothing (the CPU)."""
    out: dict = {}
    for dev in (devices if devices is not None else _devices()):
        label = device_label(dev)
        stats = _stats_of(dev)
        if not stats:
            out[label] = None
            continue
        doc = {}
        for kind, key in _KINDS:
            v = stats.get(key)
            if v is None:
                continue
            doc[f"{_CAMEL[kind]}Bytes"] = int(v)
            _DEVICE_MEMORY.labels(device=label, kind=kind).set(float(v))
        out[label] = doc or None
    return out


_CAMEL = {"in_use": "inUse", "peak": "peak", "limit": "limit"}


def snapshot() -> dict:
    """`sample()` that never raises — the flight-dump / bench attachment."""
    try:
        return sample()
    except Exception:  # noqa: BLE001 — telemetry must not become the fault
        return {}


def peak_bytes(devices=None) -> int | None:
    """Summed `peak_bytes_in_use` across devices; None when no backend
    reports it (the CPU answer). Bracket a job with two calls and the
    difference is how much the job RAISED the process peak — zero for a
    job that fit inside already-reached headroom."""
    total = None
    for dev in (devices if devices is not None else _devices()):
        stats = _stats_of(dev)
        if not stats:
            continue
        v = stats.get("peak_bytes_in_use")
        if v is not None:
            total = (total or 0) + int(v)
    return total


def peak_delta(before: int | None, after: int | None) -> dict | None:
    """The per-job stamp: {peakBytes, peakDeltaBytes} or None when the
    backend reports nothing (None-safe on the CPU by construction)."""
    if after is None:
        return None
    return {
        "peakBytes": after,
        "peakDeltaBytes": after - (before or 0),
    }
