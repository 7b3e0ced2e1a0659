"""Tenant admission + priority scheduling — the fairness half of the
fleet router (docs/FLEET.md).

One replica's queue bound protects a PROCESS; it cannot stop one
noisy tenant from eating the whole fleet's admission budget. This module
enforces fairness at the front door, before any replica sees the job:

  * **Token-bucket rate limits** per tenant: a bucket of `burst` tokens
    refilled at `rate` tokens/second; each submission spends one. An
    empty bucket rejects with the seconds-until-next-token as the
    retryAfter hint (the router takes the max over this and the replica
    hints — one 429 shape everywhere, docs/SERVICE.md).
  * **In-flight quotas** per tenant: at most `inflight` routed jobs may
    be non-terminal at once, so a tenant that submits slowly but runs
    forever still cannot monopolize the fleet's workers.
  * **Weighted-fair dequeue** across (tenant, priority class): admitted
    jobs wait in per-tenant FIFOs per class, and the dispatcher pops
    classes by smooth weighted round-robin (`interactive` > `batch` >
    `bulk` by DG16_FLEET_WEIGHTS) and tenants within a class by plain
    round-robin — a bulk flood from one tenant delays neither another
    tenant's bulk jobs nor anyone's interactive jobs.

Everything here runs on the router's event-loop thread; the clock is
injectable so bucket refill and quota math are unit-testable without
sleeping.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

from ..telemetry import metrics as _tm
from ..utils.config import TenantConfig

_REG = _tm.registry()
_REJECTED = _REG.counter(
    "fleet_jobs_rejected_total",
    "Submissions rejected at the router door, per tenant and reason "
    "(rate | inflight | backlog | draining)",
    ("tenant", "reason"),
)
_PENDING = _REG.gauge(
    "fleet_pending_jobs",
    "Admitted jobs waiting in the router's dispatch backlog",
)

DEFAULT_TENANT = "anonymous"
DEFAULT_PRIORITY = "interactive"


class TenantQuotaError(Exception):
    """Structured router-door rejection — mapped to HTTP 429 with a
    retryAfter hint, mirroring the replica-side QueueFullError shape."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float,
                 detail: str):
        self.tenant = tenant
        self.reason = reason  # "rate" | "inflight" | "backlog"
        self.retry_after_s = retry_after_s
        super().__init__(detail)


class TokenBucket:
    """Classic token bucket with lazy refill (no timer task): `take()`
    refills from the elapsed time since the last call, then spends."""

    def __init__(self, rate: float, burst: int, clock=time.monotonic):
        self.rate = rate
        self.burst = max(1, burst)
        self._clock = clock
        self._tokens = float(self.burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def take(self) -> bool:
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until one token exists (0 when rate is unlimited —
        the caller only asks after a failed take, so rate > 0 here)."""
        self._refill()
        if self._tokens >= 1.0 or self.rate <= 0:
            return 0.0
        return (1.0 - self._tokens) / self.rate


class TenantAdmission:
    """Per-tenant rate + in-flight accounting at the router door."""

    def __init__(self, cfg: TenantConfig | None = None, clock=time.monotonic):
        self.cfg = cfg or TenantConfig()
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self.admitted = 0
        self.rejected = 0

    def _bucket(self, tenant: str, rate: float, burst: int) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                rate, burst, clock=self._clock
            )
        return b

    def admit(self, tenant: str) -> None:
        """Charge one submission against the tenant's rate bucket and
        in-flight quota. Raises TenantQuotaError; on success the caller
        OWNS one in-flight slot and must `release(tenant)` exactly once
        when the job reaches a terminal state (or fails to dispatch)."""
        rate, burst, inflight = self.cfg.limits_for(tenant)
        if inflight > 0 and self._inflight.get(tenant, 0) >= inflight:
            self.rejected += 1
            _REJECTED.labels(tenant=tenant, reason="inflight").inc()
            raise TenantQuotaError(
                tenant, "inflight",
                # no token math can predict a proof finishing; hint one
                # poll period's worth of patience and let the next 429
                # re-estimate
                5.0,
                f"tenant {tenant!r} at its in-flight quota "
                f"({inflight} jobs running)",
            )
        if rate > 0:
            bucket = self._bucket(tenant, rate, burst)
            if not bucket.take():
                self.rejected += 1
                _REJECTED.labels(tenant=tenant, reason="rate").inc()
                raise TenantQuotaError(
                    tenant, "rate", max(0.1, bucket.retry_after_s()),
                    f"tenant {tenant!r} over its submission rate "
                    f"({rate}/s, burst {burst})",
                )
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self.admitted += 1

    def release(self, tenant: str) -> None:
        n = self._inflight.get(tenant, 0)
        if n <= 1:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = n - 1

    def note_rejected(self, tenant: str, reason: str) -> None:
        """Count a rejection decided outside admit() (dispatch-backlog
        full, router draining) under the same metric family."""
        self.rejected += 1
        _REJECTED.labels(tenant=tenant, reason=reason).inc()

    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "inflightByTenant": dict(self._inflight),
        }


class WeightedFairQueue:
    """Smooth weighted round-robin over priority classes, plain
    round-robin over tenants inside a class.

    Each non-empty class accumulates its weight in credits per pop; the
    richest class dispatches and pays the total weight of the non-empty
    set. Over W total weight, a class of weight w gets w dispatches —
    so `bulk` (weight 1) is throttled under load but NEVER starved,
    which is the whole point versus strict priority. Within a class,
    tenant FIFOs rotate so one tenant's backlog cannot shadow another's.
    """

    def __init__(self, weights: tuple = ()):  # (("interactive", 8), ...)
        self._weights = dict(weights)
        # class -> tenant -> FIFO of entries; OrderedDict gives the
        # round-robin rotation order over tenants
        self._classes: dict[str, OrderedDict[str, deque]] = {}
        self._credits: dict[str, float] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def weight(self, priority: str) -> int:
        return max(1, int(self._weights.get(priority, 1)))

    def push(self, tenant: str, priority: str, entry) -> None:
        tenants = self._classes.setdefault(priority, OrderedDict())
        q = tenants.get(tenant)
        if q is None:
            q = tenants[tenant] = deque()
        q.append(entry)
        self._len += 1
        _PENDING.set(self._len)

    def pop(self):
        """Next entry by weighted fairness, or None when empty."""
        live = [c for c, t in self._classes.items() if t]
        if not live:
            return None
        total = sum(self.weight(c) for c in live)
        best = None
        for c in live:
            self._credits[c] = self._credits.get(c, 0.0) + self.weight(c)
            if best is None or self._credits[c] > self._credits[best]:
                best = c
        self._credits[best] -= total
        tenants = self._classes[best]
        # round-robin: serve the first tenant, then rotate it to the back
        tenant, q = next(iter(tenants.items()))
        entry = q.popleft()
        tenants.move_to_end(tenant)
        if not q:
            del tenants[tenant]
        if not tenants:
            # drop the empty class AND its credit: a class that drained
            # must not hoard credit while idle and then burst past the
            # weights when traffic returns
            del self._classes[best]
            self._credits.pop(best, None)
        self._len -= 1
        _PENDING.set(self._len)
        return entry

    def drain(self) -> list:
        """Every queued entry, dispatch order (shutdown path)."""
        out = []
        while self._len:
            out.append(self.pop())
        return out

    def occupancy(self) -> dict:
        """{priority: {tenant: depth}} — the /fleet/stats spelling."""
        return {
            c: {t: len(q) for t, q in tenants.items()}
            for c, tenants in self._classes.items()
            if tenants
        }
