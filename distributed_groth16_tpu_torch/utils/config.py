"""Transport configuration and the distributed runs' CLI surface — the
part of the JAX package's utils/config.py that the port has so far.

  * KNOBS, the registry of the DG16_* environment knobs the port reads,
    with the JAX package's text, and the typed accessors env_flag and
    env_float (reading an undeclared knob raises);
  * NetConfig, the star transport's deadlines and liveness knobs, each
    with a DG16_NET_* override (NetConfig.from_env);
  * read_address_file: the address-file format of network-address/4|8,
    one `host:port` per rank.

env_str, env_int, Opt and parse_opt come with their first caller: the
examples take the JAX examples' flags (examples/_star.py), not the
reference's structopt `Opt {id, input, l, t, m}`. ServiceConfig,
SchedulerConfig, SLOConfig, FleetConfig and TenantConfig come with the
service, scheduler and fleet planes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

KNOBS: dict[str, str] = {
    # transport
    "DG16_NET_OP_TIMEOUT_S": "per-collective send/recv deadline, <=0 off",
    "DG16_NET_CONNECT_TIMEOUT_S": "total bring-up budget (dial + barrier)",
    "DG16_NET_CONNECT_BASE_DELAY_S": "client redial backoff base",
    "DG16_NET_CONNECT_MAX_DELAY_S": "client redial backoff cap",
    "DG16_NET_CONNECT_JITTER": "redial backoff jitter fraction",
    "DG16_NET_HEARTBEAT_S": "idle-link keepalive period, <=0 off",
    "DG16_NET_IDLE_TIMEOUT_S": "declare a silent peer dead after this",
    # phase timers
    "DG16_TRACE": "print Start:/End: phase lines",
    # frontend
    "DG16_NO_CWASM": "force the pure-Python WASM witness VM",
}


def _declared(name: str) -> str:
    if name not in KNOBS:
        raise KeyError(
            f"{name} is not declared in utils.config.KNOBS — add it there "
            "(and to the docs) before reading it"
        )
    return name


def env_flag(name: str, default: bool = False) -> bool:
    """'', unset -> default; '0'/'false' (any case) -> False; else True."""
    v = os.environ.get(_declared(name))
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false")


def env_float(name: str, default: float) -> float:
    v = os.environ.get(_declared(name))
    return float(v) if v not in (None, "") else default


@dataclass(frozen=True)
class NetConfig:
    """Fault-tolerance knobs of the star transport (parallel/net.py,
    parallel/prodnet.py). Every field has a DG16_NET_* override read by
    from_env(); per-op `timeout=` arguments on the collectives override
    the config value again.

      * op_timeout_s — deadline for one point-to-point send/recv inside a
        collective; <= 0 disables it. Long compute phases legitimately
        stall the wire, so the default is generous; liveness between ops
        is the heartbeat's job.
      * connect_timeout_s — TOTAL bring-up budget: a client's dial with
        backoff, the king's wait for all clients, and the Syn/SynAck
        barrier each run under it.
      * connect_base_delay_s / connect_max_delay_s / connect_jitter — the
        client's redial backoff: sleep min(base * 2^attempt, max) *
        (1 + jitter * U[0,1)).
      * heartbeat_interval_s — idle-link keepalive period. <= 0 disables
        heartbeats AND idle detection.
      * idle_timeout_s — a peer silent (no frames, heartbeats included)
        this long is declared dead and its pending recvs fail. A rank's
        heartbeat task shares its asyncio loop with the prover's
        synchronous GPU work, so a long compute phase blocks its own
        heartbeats: keep this ABOVE the workload's longest synchronous
        phase and well above heartbeat_interval_s. <= 0 disables idle
        detection only.
    """

    op_timeout_s: float = 600.0
    connect_timeout_s: float = 120.0
    connect_base_delay_s: float = 0.1
    connect_max_delay_s: float = 5.0
    connect_jitter: float = 0.5
    heartbeat_interval_s: float = 15.0
    idle_timeout_s: float = 600.0

    @staticmethod
    def from_env() -> "NetConfig":
        return NetConfig(
            op_timeout_s=env_float("DG16_NET_OP_TIMEOUT_S", 600.0),
            connect_timeout_s=env_float("DG16_NET_CONNECT_TIMEOUT_S", 120.0),
            connect_base_delay_s=env_float(
                "DG16_NET_CONNECT_BASE_DELAY_S", 0.1
            ),
            connect_max_delay_s=env_float("DG16_NET_CONNECT_MAX_DELAY_S", 5.0),
            connect_jitter=env_float("DG16_NET_CONNECT_JITTER", 0.5),
            heartbeat_interval_s=env_float("DG16_NET_HEARTBEAT_S", 15.0),
            idle_timeout_s=env_float("DG16_NET_IDLE_TIMEOUT_S", 600.0),
        )


def read_address_file(path: str) -> list[tuple[str, int]]:
    """network-address/4|8 format: one host:port per line, rank order."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            host, port = line.rsplit(":", 1)
            out.append((host, int(port)))
    return out
