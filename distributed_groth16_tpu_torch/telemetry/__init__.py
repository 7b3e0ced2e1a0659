"""Telemetry spine: the process-wide metrics registry (metrics.py), span
tracing with Chrome trace-event export (tracing.py), the star-wide
aggregation plane — clock alignment, cross-party trace merging, critical
path (aggregate.py) — the fault flight recorder (flight.py), and JAX
compile-cost accounting (compile.py). Every layer — transport,
distributed kernels, prover, service, API, bench — records through here;
docs/OBSERVABILITY.md is the catalog and naming convention.

The device observatory (docs/OBSERVABILITY.md "Device observatory")
rides the same spine: devmem.py (HBM gauges/snapshots), transfer.py
(host<->device boundary accounting), profiler.py (on-demand XLA capture),
roofline.py and buildinfo.py. devmem/transfer register their families
here; profiler/roofline/perf stay lazy like the performance observatory
(perf.py registry + runner, perf_kernels.py cases, benchgate.py
regression gate), which pulls in ops/ and is loaded by its consumers
(`tools/benchgate`, `dg16-cli perf`, bench.py) so importing the spine
stays cheap.
"""

from . import aggregate, devmem, flight, metrics, tracing, transfer  # noqa: F401
from .metrics import registry  # noqa: F401
from .tracing import TraceBuffer, collect, span  # noqa: F401
