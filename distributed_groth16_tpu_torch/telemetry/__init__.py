"""Telemetry spine: the process-wide metrics registry (metrics.py), span
tracing with Chrome trace-event export (tracing.py), the star-wide
aggregation plane — clock alignment, cross-party trace merging, critical
path (aggregate.py) — the fault flight recorder (flight.py), and
first-use cost accounting (compile.py: a callable's first call per
argument signature, timed to torch.cuda.synchronize()). Every layer —
transport, distributed kernels, prover, service, API, bench — records
through here; docs/OBSERVABILITY.md is the catalog and naming
convention.

The device observatory (docs/OBSERVABILITY.md "Device observatory")
rides the same spine: devmem.py (HBM gauges/snapshots), transfer.py
(host<->device boundary accounting), profiler.py (on-demand
torch.profiler capture), roofline.py and buildinfo.py. devmem/transfer
register their families here; profiler/roofline/perf stay lazy like the
performance observatory (perf.py registry + runner, perf_kernels.py
cases, benchgate.py regression gate), which pulls in ops/ and is loaded
by its consumers (`python -m
distributed_groth16_tpu_torch.telemetry.benchgate`, the CLI's `perf`
group, chip_smoke.py) so importing the spine stays cheap.
"""

from . import aggregate, devmem, flight, metrics, tracing, transfer  # noqa: F401
from .metrics import registry  # noqa: F401
from .tracing import TraceBuffer, collect, span  # noqa: F401
