"""Fleet plane: a multi-replica front door over the proof service.

One crash-safe replica serves one device inventory; the fleet
package (docs/FLEET.md) is the layer above that turns N of them into one
horizontally scaled service:

  registry.py  pull-based replica discovery: every replica's /readyz
               capacity document folds into a scored table (load
               weighted by SLO burn rate) with breaker-style ejection,
               plus a per-replica ClockSync fed by poll clock echoes
  tenants.py   tenant admission at the door — token-bucket rate limits,
               in-flight quotas, and weighted-fair dispatch across
               (tenant, priority class)
  federate.py  metrics federation: per-replica /metrics scrapes
               re-exported with a `replica` label at /fleet/metrics,
               plus merged-histogram fleet rollups (p50/p95, job rate,
               max burn, open breakers)
  router.py    the aiohttp front-door process: admit -> schedule ->
               dispatch -> proxy, plus journal-backed handoff so a dead
               or draining replica's accepted jobs finish elsewhere —
               and the fleet observatory: end-to-end trace ids
               (X-DG16-Trace), stitched GET /fleet/jobs/{id}/trace,
               fleet-anomaly flight dumps

Run it with `python -m distributed_groth16_tpu_torch.fleet` (DG16_FLEET_*
knobs in utils/config.py). The router owns no proving code: it never
packs a CRS, runs a round, or touches a device — the heaviest thing it
does is parse a dead replica's journal off the event loop.
"""

from .federate import MetricsFederator
from .registry import Replica, ReplicaRegistry
from .router import FleetRouter, RoutedJob
from .tenants import (
    TenantAdmission,
    TenantQuotaError,
    TokenBucket,
    WeightedFairQueue,
)

__all__ = [
    "FleetRouter",
    "MetricsFederator",
    "Replica",
    "ReplicaRegistry",
    "RoutedJob",
    "TenantAdmission",
    "TenantQuotaError",
    "TokenBucket",
    "WeightedFairQueue",
]
