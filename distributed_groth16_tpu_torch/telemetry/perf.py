"""Per-kernel performance observatory: declarative bench registry +
runner; the counterpart of the JAX package's telemetry/perf.py, with its
`dg16-perf/1` record schema, so a run document from either package reads
in the other.

  * `@perf_kernel("msm_g1", sizes=(12, 14, 16), ...)` registers a case
    builder; the builder gets a log2-size and a device and returns a
    `KernelCase` (a callable + concrete args + items-per-call + the work
    model of its inputs). Builders run their setup (random bases, twiddle
    tables) OUTSIDE the timed region.
  * `run_kernel` executes one case: the first call goes through
    `telemetry/compile.timed_first_call`, so first-use cost is measured
    separately (`compile_seconds{fn}`) and excluded from the warm reps;
    warm throughput is reported as median + IQR over K host-synced reps
    (a rep is synchronize, the call, synchronize; before each, outside
    the timed window, a 64 MB scratch tensor is rewritten on a card, so
    no case reads its inputs warm from the H100's 50 MB L2). The first
    warm rep also counts the hand-written kernels' launches (the delta of
    each ops/_cuda.KERNELS counter, the record's `launches`: the port's
    way of showing which kernels a case's path went through) and, on a
    card, the peak of device memory.
  * The JAX package reads work and memory off XLA's compiled executable
    (`cost_analysis()`, `memory_analysis()`). The port has no XLA: each
    device case declares its `cost` ({"flops": 32-bit multiply-adds,
    "bytes_accessed": bytes}, telemetry/roofline.py), computed from what
    its inputs need, and `memory` holds the tensors' argument and output
    bytes, with `peak_bytes` from torch.cuda.max_memory_allocated() on a
    card (None on the CPU, as the JAX record has it on XLA:CPU) and
    `temp_bytes` that peak less what was allocated before the call and
    the output.
  * Every record is mirrored into the process metrics registry
    (`perf_kernel_*`) and serialized under the versioned `dg16-perf/1`
    JSON schema that `telemetry/benchgate.py` speaks.

The registered default cases live in `telemetry/perf_kernels.py` (they
import ops/ and are loaded lazily so importing the telemetry spine stays
cheap). Entry points run on the card unless the caller passes a CPU
device; `run_suite` raises where no card is present.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from . import compile as _compile
from . import metrics as _tm
from . import roofline as _roofline
from ..utils import config as _config

PERF_SCHEMA = "dg16-perf/1"

# bytes rewritten before each warm rep on a card: more than the H100's
# 50 MB L2
SCRATCH_BYTES = 64 << 20

_REG = _tm.registry()
_KERNEL_SECONDS = _REG.histogram(
    "perf_kernel_seconds",
    "Warm (first-call-excluded) wall seconds per registered kernel rep",
    ("kernel", "size"),
    buckets=_tm.DEFAULT_KERNEL_BUCKETS,
)
_KERNEL_RATE = _REG.gauge(
    "perf_kernel_items_per_sec",
    "Median warm throughput of the last run, per kernel and size",
    ("kernel", "size"),
)
_KERNEL_COMPILE = _REG.gauge(
    "perf_kernel_compile_seconds",
    "First-call (setup+run) seconds of the last run, per kernel and size",
    ("kernel", "size"),
)
_KERNEL_FLOPS = _REG.gauge(
    "perf_kernel_flops",
    "Work model of the case: 32-bit multiply-adds its inputs need",
    ("kernel", "size"),
)
_KERNEL_BYTES = _REG.gauge(
    "perf_kernel_bytes",
    "Work model of the case: bytes its inputs and output move once",
    ("kernel", "size"),
)
_KERNEL_UTIL = _REG.gauge(
    "perf_kernel_utilization",
    "Fraction of the binding roofline roof the kernel achieved in the "
    "last run (telemetry/roofline.py; DG16_PEAK_FLOPS/DG16_PEAK_BW)",
    ("kernel", "size"),
)


@dataclass
class KernelCase:
    """One concrete benchmarkable instance of a registered kernel.

    fn:    the callable to time (the port's entry point itself).
    args:  concrete, already-materialized arguments — setup cost (random
           bases, tables, host->device transfer) stays outside the timed
           region.
    items: work items per call (scalar-muls, coefficients, pairings) —
           the throughput denominator.
    cost:  {"flops": 32-bit multiply-adds, "bytes_accessed": bytes} the
           inputs need (telemetry/perf_kernels.py work model); None for a
           host case.
    """

    fn: Callable
    args: tuple
    items: int
    cost: dict | None = None


@dataclass(frozen=True)
class KernelSpec:
    """A registered kernel: builder + the sizes it runs at."""

    name: str
    builder: Callable[[int, torch.device], KernelCase]
    sizes: tuple
    quick_sizes: tuple
    unit: str
    host: bool


_KERNELS: dict[str, KernelSpec] = {}


def perf_kernel(
    name: str,
    sizes: Sequence[int],
    quick: Sequence[int] | None = None,
    unit: str = "items/sec",
    host: bool = False,
):
    """Register a kernel-case builder under `name`.

    sizes: log2 work sizes for the full suite (card-scale); `quick` is
    the smoke subset (default: the smallest full size). `host=True` marks
    pure-Python kernels (GLV, the Miller loop): they are timed the same
    way but carry no first-call cost and no work model.
    """

    def deco(builder):
        q = tuple(quick) if quick is not None else (min(sizes),)
        _KERNELS[name] = KernelSpec(
            name, builder, tuple(sizes), q, unit, host
        )
        return builder

    return deco


def kernels() -> dict[str, KernelSpec]:
    """Registered specs (default set loaded on first use)."""
    _ensure_defaults()
    return dict(_KERNELS)


def _ensure_defaults() -> None:
    from . import perf_kernels  # noqa: F401 — registers on import


def size_key(kernel: str, log2n: int) -> str:
    return f"{kernel}@2e{log2n}"


# -- the runner --------------------------------------------------------------


def default_reps(quick: bool = False) -> int:
    return _config.env_int("DG16_PERF_REPS", 3 if quick else 5)


def resolve_device(device=None) -> torch.device:
    """None means the card (cuda:0); raises when there is none. Only an
    explicit CPU device runs on the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "perf: no CUDA device; pass device='cpu' to run on the CPU"
        )
    return dev


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    return 0


def _launch_counts() -> dict:
    from ..ops import _cuda

    return {k: v.launches for k, v in _cuda.KERNELS.items()}


def run_kernel(spec: KernelSpec, log2n: int, reps: int | None = None,
               device=None) -> dict:
    """Execute one registered case at one size on `device` and return its
    record, attributed against the device's peak table."""
    reps = reps if reps is not None else default_reps()
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    scratch = (torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device=dev)
               if cuda else None)
    case = spec.builder(log2n, dev)
    label = size_key(spec.name, log2n)
    if spec.host:
        case.fn(*case.args)  # warm (allocator, functools caches)
        compile_s = 0.0
    else:
        tf = _compile.timed_first_call(label, case.fn)
        # timed_first_call observes the first-call cost into
        # compile_seconds{fn}; read the number back as the histogram-sum
        # delta so the record and the /metrics series can never disagree
        child = _REG.family("compile_seconds").labels(fn=label)
        before = child.sum
        tf(*case.args)
        compile_s = max(0.0, child.sum - before)
    times = []
    for rep in range(max(1, reps)):
        if scratch is not None:
            scratch.add_(1)  # evict the inputs from L2, outside the timing
        sync()
        if rep == 0:
            # the first warm rep also counts the kernels it launches and,
            # on a card, its peak device memory (host-side counters, read
            # outside the timed window)
            counts = _launch_counts()
            if cuda:
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = case.fn(*case.args)
        sync()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = {k: v - counts[k] for k, v in _launch_counts().items()
                        if v != counts[k]}
            out_bytes = _tensor_bytes(out)
            peak_bytes = temp = None
            if cuda:
                peak_bytes = int(torch.cuda.max_memory_allocated(dev))
                temp = max(0, peak_bytes - base - out_bytes)
        del out
    memory = None if spec.host else {
        "argument_bytes": _tensor_bytes(case.args),
        "output_bytes": out_bytes,
        "temp_bytes": temp,
        "generated_code_bytes": None,
        "peak_bytes": peak_bytes,
    }
    return make_record(
        kernel=spec.name,
        size=log2n,
        items=case.items,
        unit=spec.unit,
        seconds=times,
        compile_seconds=compile_s,
        cost=None if spec.host else case.cost,
        memory=memory,
        host=spec.host,
        extra={"launches": launches},
        peak=_roofline.peaks(_roofline.device_kind(dev)),
    )


def make_record(
    *,
    kernel: str,
    size: int,
    items: int,
    unit: str,
    seconds,
    compile_seconds: float | None = None,
    cost: dict | None = None,
    memory: dict | None = None,
    host: bool = False,
    extra: dict | None = None,
    peak: dict | None = None,
) -> dict:
    """Build one standardized per-kernel record and mirror it into the
    metrics registry — the single record shape `run_suite` and
    `telemetry/benchgate.py` share, so the emitters cannot drift.
    `seconds` is a list of warm rep timings (or a single float for
    marginal-cost emitters); `peak` is the roofline peak table (None:
    roofline.peaks())."""
    times = [float(seconds)] if isinstance(seconds, (int, float)) \
        else [float(t) for t in seconds]
    med = statistics.median(times)
    iqr = 0.0
    if len(times) >= 4:
        q = statistics.quantiles(times, n=4)
        iqr = q[2] - q[0]
    rate = items / med if med > 0 else 0.0
    rec = {
        "schema": PERF_SCHEMA,
        "kernel": kernel,
        "size": size,
        "key": size_key(kernel, size),
        "items": items,
        "unit": unit,
        "reps": len(times),
        "median_seconds": med,
        "iqr_seconds": iqr,
        "min_seconds": min(times),
        "items_per_sec": rate,
        "compile_seconds": compile_seconds,
        "cost": cost,
        "memory": memory,
        "host": host,
    }
    # roofline attribution (telemetry/roofline.py): device records with a
    # cost model also say which roof they lean on and how hard
    rec["roofline"] = (
        _roofline.attribute(cost, med, peak) if not host else None
    )
    if extra:
        rec.update(extra)
    sz = f"2e{size}"
    hist = _KERNEL_SECONDS.labels(kernel=kernel, size=sz)
    for t in times:
        hist.observe(t)
    _KERNEL_RATE.labels(kernel=kernel, size=sz).set(rate)
    if compile_seconds is not None:
        _KERNEL_COMPILE.labels(kernel=kernel, size=sz).set(compile_seconds)
    if cost is not None:
        _KERNEL_FLOPS.labels(kernel=kernel, size=sz).set(cost["flops"])
        _KERNEL_BYTES.labels(kernel=kernel, size=sz).set(
            cost["bytes_accessed"]
        )
    if rec["roofline"] is not None:
        _KERNEL_UTIL.labels(kernel=kernel, size=sz).set(
            rec["roofline"]["utilization"]
        )
    return rec


def run_suite(
    quick: bool = False,
    select: Sequence[str] | None = None,
    reps: int | None = None,
    device=None,
) -> dict:
    """Run every registered kernel (or the `select` subset) at its
    configured sizes on `device` (None: the card, cuda:0; raises without
    one) and return the versioned suite document. A kernel that raises
    records an `error` entry instead of killing the suite — benchgate
    decides whether that's a regression (it had a baseline) or an
    advisory (it never worked here). On a card the kernels are built
    first (nvcc), and the build's seconds recorded as `build_seconds`, so
    no case's first call holds them."""
    _ensure_defaults()
    if select:
        unknown = sorted(set(select) - set(_KERNELS))
        if unknown:
            raise KeyError(
                f"unknown perf kernel(s) {unknown}; "
                f"registered: {sorted(_KERNELS)}"
            )
    dev = resolve_device(device)
    build_s = None
    if dev.type == "cuda":
        from ..ops import _cuda

        torch.cuda.set_device(dev)
        build_s = _cuda.build()
    out = {
        "schema": PERF_SCHEMA,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "quick": bool(quick),
        # the peak table this run's roofline attribution used, so a
        # recorded document is self-describing (and re-attributable)
        "peaks": _roofline.peaks(_roofline.device_kind(dev)),
        "build_seconds": build_s,
        "kernels": {},
    }
    reps = reps if reps is not None else default_reps(quick)
    for name in sorted(_KERNELS):
        spec = _KERNELS[name]
        if select and name not in select:
            continue
        for log2n in (spec.quick_sizes if quick else spec.sizes):
            key = size_key(name, log2n)
            try:
                out["kernels"][key] = run_kernel(spec, log2n, reps=reps,
                                                 device=dev)
            except Exception as e:  # noqa: BLE001 — isolate per kernel
                out["kernels"][key] = {
                    "schema": PERF_SCHEMA,
                    "kernel": name,
                    "size": log2n,
                    "key": key,
                    "error": f"{type(e).__name__}: {e}",
                }
    return out
