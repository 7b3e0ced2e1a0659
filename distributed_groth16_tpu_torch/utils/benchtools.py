"""Shared timing for on-card benchmarks; the counterpart of the JAX
package's utils/benchtools.py.

  * marginal_cost: the cost of one iteration as the MARGINAL cost between
    a K=1 and a K=3 back-to-back loop, each timed host-synced after a
    warm call; its fence is torch.cuda.synchronize() (a host clock
    without one measures only the enqueue);
  * cuda_ms: mean ms per call from CUDA events around a loop of calls;
  * device_ms: median device time of one launch of this repo's kernels,
    from torch.profiler's kernel records;
  * device_spans: (start_us, end_us, name) of every device activity of a
    finished torch.profiler trace.
"""

from __future__ import annotations

import logging
import time

import torch

log = logging.getLogger(__name__)


def _fence() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def marginal_cost(make_fn, args, reps: int = 4) -> float:
    """Seconds per iteration: make_fn(k) must return a callable running
    its workload k times back-to-back; cost = (t3 - t1) / 2 with each t
    the best of `reps` host-synced timings after a warm-up call."""

    def timed(k: int) -> float:
        fn = make_fn(k)
        fn(*args)  # warm (kernel libraries, cached tables)
        _fence()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            _fence()
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t3 = timed(1), timed(3)
    return max((t3 - t1) / 2, 1e-9)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, keep, tries: int = 6) -> float:
    """Median device time (ms) of one launch of the kernels whose device
    function name `keep` accepts, over `reps` calls of fn, each launching
    one of them, after one warm-up call, from torch.profiler's kernel
    records (a wrapper call's wall time also holds its Python dispatch,
    which exceeds the kernel at narrow widths). On the H100 a trace
    usually lacks one launch's record, now and then holds none at all (up
    to several traces in a row), and once gave a median of twice the
    kernel's time; a trace with no record, or whose median exceeds 1.5
    times the CUDA-event time of a call (which holds the kernel), is
    taken again with twice the calls, up to `tries` traces, each retry
    reported on stdout."""
    from torch.profiler import ProfilerActivity, profile

    event = cuda_ms(fn, reps)  # includes the warm-up call
    for t in range(tries):
        calls = reps << t
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        d = sorted(b - a for a, b, name in device_spans(prof) if keep(name))
        if d and d[len(d) // 2] * 1e-3 <= 1.5 * event:
            return d[len(d) // 2] * 1e-3
        log.warning("device_ms: a trace held %d kernel records of %d "
                    "launches, median %s ms, event time %s ms a call; "
                    "tracing again", len(d), calls,
                    d[len(d) // 2] * 1e-3 if d else None, event)
    raise AssertionError(f"torch.profiler gave no usable trace in {tries} "
                         "traces")


def device_spans(prof):
    """(start_us, end_us, name) of every device activity a finished
    torch.profiler trace holds, read from its raw kineto events: building
    the profiler's FunctionEvent tree instead takes minutes for a trace of
    a few million launches."""
    from torch.autograd import DeviceType

    return [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
