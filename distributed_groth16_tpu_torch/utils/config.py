"""Transport configuration — the part of the JAX package's NetConfig
(distributed_groth16_tpu/utils/config.py) that the port's transport reads.

The socket transport's bring-up and liveness knobs (connect_*, heartbeat,
idle timeout) and their DG16_NET_* environment overrides come with that
transport (parallel/prodnet.py, not ported yet).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NetConfig:
    """Knobs of the star transport (parallel/net.py), set by its caller.
    Per-op `timeout=` arguments on the collectives override them again.

      * op_timeout_s — deadline for one point-to-point send/recv inside a
        collective; <= 0 disables it.
    """

    op_timeout_s: float = 600.0
