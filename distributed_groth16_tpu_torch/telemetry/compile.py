"""First-use cost telemetry: make "it's build-bound" measurable; the
counterpart of the JAX package's telemetry/compile.py.

The port has no jit. Its first-use cost is two things: the nvcc build of
the hand-written kernels (ops/_cuda.py `build()` returns its seconds),
and a callable's first call per argument signature (kernel libraries
loaded, twiddle and generator tables built and cached on the device).
`timed_first_call` wraps a callable and keys calls by the argument
signature (the shapes and dtypes of its tensor arguments, the repr of
anything else): the first call per signature is a miss, timed to
`torch.cuda.synchronize()` (so the number is setup + first execution)
and observed into `compile_seconds{fn}`; later calls are cache hits. The
metric families keep the JAX package's names, so a dashboard reads
either package.
"""

from __future__ import annotations

import time

import torch

from . import metrics as _tm
from . import tracing as _tracing

_REG = _tm.registry()
_COMPILE_SECONDS = _REG.histogram(
    "compile_seconds",
    "First-call (setup+run, host-synced) seconds per wrapped fn and "
    "argument signature",
    ("fn",),
)
_HITS = _REG.counter(
    "compile_cache_hits_total",
    "Calls served by an already-seen signature, per fn",
    ("fn",),
)
_MISSES = _REG.counter(
    "compile_cache_misses_total",
    "Calls with a new argument signature (first use), per fn",
    ("fn",),
)


def _signature(obj):
    """Hashable signature of an argument tree: a tensor is its shape,
    dtype and device type, a tuple/list its items', anything else its
    repr."""
    if isinstance(obj, torch.Tensor):
        return ("T", tuple(obj.shape), str(obj.dtype), obj.device.type)
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(_signature(o) for o in obj)
    return repr(obj)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_first_call(fn_name: str, fn):
    """Wrap a callable with first-use accounting (see module docstring).
    The wrapper is transparent for positional call sites."""
    seen: set = set()
    hits = _HITS.labels(fn=fn_name)
    misses = _MISSES.labels(fn=fn_name)
    hist = _COMPILE_SECONDS.labels(fn=fn_name)

    def wrapper(*args):
        key = _signature(args)
        if key in seen:
            hits.inc()
            return fn(*args)
        with _tracing.span("compile", attrs={"fn": fn_name}):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args)
            _sync()
            dt = time.perf_counter() - t0
        seen.add(key)
        misses.inc()
        hist.observe(dt)
        return out

    wrapper.__wrapped__ = fn
    wrapper.__name__ = f"timed_first_call({fn_name})"
    return wrapper
