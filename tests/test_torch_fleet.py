"""The port's fleet plane (distributed_groth16_tpu_torch/fleet) on the CPU,
after tests/test_fleet.py: the token bucket, tenant admission, weighted
fair queue and replica registry driven side by side with the JAX modules
on the same inputs and fake clock (every answer equal); the federated
exposition text equal to the JAX MetricsFederator's; the router's route
table equal to the JAX router's and its rate limit at the door; a replica
killed mid-flight with zero loss, and one real proof through the router
— both proofs equal to the port's prove_single's (tolerance zero: proof
bytes).

Replicas are port ApiServers on the CPU sharing one circuit store; every
local MSM takes the tree route, as on the card (~0.35-1 s a tree MSM on
the CPU whatever its size)."""

import asyncio
import threading
import time

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from distributed_groth16_tpu.fleet import registry as j_registry
from distributed_groth16_tpu.fleet import tenants as j_tenants
from distributed_groth16_tpu.fleet.federate import (
    MetricsFederator as JaxFederator,
)
from distributed_groth16_tpu.utils.config import TenantConfig as JaxTenants
from distributed_groth16_tpu_torch.api.server import ApiServer
from distributed_groth16_tpu_torch.api.store import CircuitStore
from distributed_groth16_tpu_torch.fleet import (
    FleetRouter,
    MetricsFederator,
    ReplicaRegistry,
    TenantAdmission,
    TenantQuotaError,
    TokenBucket,
    WeightedFairQueue,
)
from distributed_groth16_tpu_torch.fleet.registry import EJECTED
from distributed_groth16_tpu_torch.frontend.ark_serde import proof_to_bytes
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.frontend.readers import (
    write_r1cs,
    write_wtns,
)
from distributed_groth16_tpu_torch.models.groth16 import (
    CompiledR1CS,
    prove_single,
)
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.telemetry.metrics import MetricsRegistry
from distributed_groth16_tpu_torch.utils.config import (
    FleetConfig,
    ServiceConfig,
    TenantConfig,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
POLL_DEADLINE_S = 300.0


@pytest.fixture(autouse=True)
def _card_routes(monkeypatch):
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)


@pytest.fixture(scope="module")
def circuit(tmp_path_factory):
    """One saved circuit in ONE store shared by every replica, and the
    port's prove_single proof of its witness under the stored key."""
    r1cs, z = mult_chain_circuit(9, 7).finish()
    root = str(tmp_path_factory.mktemp("fleet_store"))
    store = CircuitStore(root, device=CPU)
    cid = store.save_circuit("fleet", write_r1cs(r1cs), b"")
    _, pk = store.load(cid)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
        want = proof_to_bytes(prove_single(pk, CompiledR1CS(r1cs, CPU),
                                           fr().encode(z, CPU)))
    return dict(root=root, cid=cid, wtns=write_wtns(z), want=want)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _quota(fn):
    """What one admission call answers: None, or the rejection's fields."""
    try:
        fn()
    except (TenantQuotaError, j_tenants.TenantQuotaError) as e:
        return (e.tenant, e.reason, round(e.retry_after_s, 9), str(e))
    return None


@pytest.mark.parametrize("unit", ["token_bucket", "tenant_admission",
                                  "weighted_fair_queue"])
def test_tenant_units_answer_as_the_jax_module(unit):
    def script(mod, cfg_cls):
        clk, out = _Clock(), []
        if unit == "token_bucket":
            b = mod.TokenBucket(rate=2.0, burst=4, clock=clk)
            for dt in (0, 0, 0, 0, 0, 0.25, 0.2, 1.0, 100.0):
                clk.t += dt
                out.append((b.take(), round(b.retry_after_s(), 9)))
        elif unit == "tenant_admission":
            adm = mod.TenantAdmission(cfg_cls(
                rate=2.0, burst=2, inflight=3,
                limits=(("acme", 5.0, None, 1), ("free", None, 1, None))),
                clock=clk)
            for tenant, dt in (("t", 0), ("t", 0), ("t", 0), ("t", 0.5),
                               ("t", 10), ("acme", 0), ("acme", 0),
                               ("free", 0), ("free", 0), ("free", 0.6)):
                clk.t += dt
                out.append(_quota(lambda: adm.admit(tenant)))
            adm.release("t")
            adm.release("acme")
            out += [_quota(lambda: adm.admit("t")),
                    _quota(lambda: adm.admit("acme")), adm.stats()]
        else:
            q = mod.WeightedFairQueue(
                (("interactive", 8), ("batch", 3), ("bulk", 1)))
            for i in range(30):
                q.push("heavy", "interactive", ("interactive", i))
            for i in range(6):
                q.push("small" if i % 2 else "other", "bulk", ("bulk", i))
                q.push("t", "batch", ("batch", i))
                q.push("u", "custom", ("custom", i))
            out += [q.pop() for _ in range(25)]
            out += [len(q), q.occupancy(), q.drain(), q.pop()]
        return out

    assert script(j_tenants, JaxTenants) == script(
        __import__("distributed_groth16_tpu_torch.fleet.tenants",
                   fromlist=["x"]), TenantConfig)


def _registry_script(mod) -> list:
    clk, out = _Clock(), []
    reg = mod.ReplicaRegistry(
        (("http://a", "/j/a"), ("http://b", None), ("http://c", None)),
        eject_threshold=2, eject_cooldown_s=10.0, clock=clk)
    a, b, c = reg.replicas
    docs = [
        (a, {"replicaId": "a", "workers": 2, "queueDepth": 4, "running": 2,
             "maxBurnRate": 0.0, "devices": 1,
             "buildInfo": {"version": "0.1.0"}}),
        (b, {"replicaId": "b", "workers": 2, "queueDepth": 0, "running": 1,
             "maxBurnRate": 0.0}),
        (c, {"replicaId": "c", "workers": 4, "queueDepth": 1, "running": 1,
             "maxBurnRate": 3.0}),
    ]
    for r, doc in docs:
        reg.note_doc(r, doc)
    out.append((reg.pick().url, [round(r.score(), 9) for r in reg.replicas]))
    reg.note_doc(b, {"replicaId": "b", "draining": True})
    out.append((reg.pick().url, [r.url for r in reg.needs_handoff()]))
    out.append([reg.note_failure(a) for _ in range(2)])
    out.append((a.state, reg.pick().url, [r.url for r in reg.pollable()]))
    clk.t += 10.5
    out.append(([r.url for r in reg.pollable()], a.probing,
                [r.url for r in reg.pollable()]))
    reg.note_failure(a)
    clk.t += 10.5
    out.append([r.url for r in reg.pollable()])
    reg.note_doc(a, {"replicaId": "a", "workers": 2})
    out.append((a.state, a.handoff_done, reg.active_count(),
                reg.find("a").url, reg.find("http://c").url))
    out.append(reg.stats())
    return out


def test_registry_scoring_ejection_and_probe_answer_as_the_jax_module():
    import distributed_groth16_tpu_torch.fleet.registry as p_registry

    port = _registry_script(p_registry)
    assert port == _registry_script(j_registry)
    assert port[3][0] == EJECTED


def _replica_exposition(n_jobs, runtime=0.5, burn=0.0, breaker_open=False):
    reg = MetricsRegistry()
    h = reg.histogram("job_seconds", "x", ("kind",), buckets=(1.0, 10.0))
    for _ in range(n_jobs):
        h.labels(kind="prove").observe(runtime)
    reg.counter("jobs_finished_total", "x", ("state",)).labels(
        state="DONE").inc(n_jobs)
    if burn:
        reg.gauge("slo_burn_rate", "x", ("kind",)).labels(
            kind="prove").set(burn)
    reg.gauge("mesh_breaker_state", "x", ("slice",)).labels(
        slice="4p0").set(2 if breaker_open else 0)
    st = reg.counter("party_straggler_total", "x", ("party",))
    st.labels(party="3").inc(n_jobs)
    return reg.render_prometheus()


def test_federated_exposition_equals_the_jax_federators():
    feds = []
    for cls in (MetricsFederator, JaxFederator):
        clk = _Clock()
        fed = cls(clock=clk)
        fed.note_scrape("r-a", _replica_exposition(4))
        fed.note_scrape("r-b", _replica_exposition(
            6, runtime=5.0, burn=1.5, breaker_open=True))
        fed.tick()
        clk.t += 2.0
        fed.note_scrape("r-b", _replica_exposition(
            10, runtime=5.0, burn=1.5, breaker_open=True))
        fed.note_scrape("r-c", "job_seconds{kind=unquoted} 1\n")
        fed.tick()
        texts = [fed.render(), fed.replica_p95(min_count=1),
                 fed.replica_burn(), fed.replicas()]
        fed.retain({"r-a"})
        texts += [fed.render(), fed.scrapes_failed]
        feds.append(texts)
    assert feds[0] == feds[1]
    assert "fleet_jobs_per_second 2" in feds[0][0]
    assert 'replica="r-b"' in feds[0][0]
    assert 'replica="r-b"' not in feds[0][4]


def _routes(app) -> list:
    return sorted((r.method, r.resource.canonical) for r in app.router.routes())


def test_router_routes_equal_the_jax_routers_and_rate_limit_at_the_door():
    from distributed_groth16_tpu.fleet import FleetRouter as JaxRouter
    from distributed_groth16_tpu.utils.config import (
        FleetConfig as JaxFleet,
    )

    replicas = (("http://127.0.0.1:1", None),)
    router = FleetRouter(FleetConfig(replicas=replicas),
                         TenantConfig(rate=1.0, burst=2))
    assert _routes(router.app()) == _routes(
        JaxRouter(JaxFleet(replicas=replicas), JaxTenants()).app())

    async def run():
        client = TestClient(TestServer(router.app()))
        await client.start_server()
        try:
            async def submit(tenant):
                return await client.post(
                    "/jobs/prove",
                    data={"circuit_id": "c", "witness_file": b"x"},
                    headers={"X-DG16-Tenant": tenant})

            assert (await submit("acme")).status == 202
            assert (await submit("acme")).status == 202
            resp = await submit("acme")
            body = await resp.json()
            assert resp.status == 429, body
            assert body["reason"] == "rate" and body["retryAfter"] > 0
            assert "Retry-After" in resp.headers
            assert (await submit("other")).status == 202
        finally:
            await client.close()

    asyncio.run(run())


class _BlockingExecutor:
    """A replica that accepts but never finishes: every job it starts
    blocks until released — the doomed replica."""

    def __init__(self):
        self.release = threading.Event()

    def run(self, job):
        assert self.release.wait(timeout=600)
        raise RuntimeError("doomed replica released at teardown")


class _Replica:
    """A port ApiServer on a real TCP port whose listener can be torn
    down WITHOUT running app cleanup — a crash, not a shutdown."""

    def __init__(self, server, runner, site):
        self.server, self.runner, self.site = server, runner, site
        self.url = f"http://127.0.0.1:{runner.addresses[0][1]}"

    async def kill_listener(self):
        await self.site.stop()

    async def cleanup(self):
        await self.runner.cleanup()


async def _start_replica(root, jdir, rid, executor=None) -> _Replica:
    server = ApiServer(
        CircuitStore(root, device=CPU),
        ServiceConfig(workers=2, journal_dir=str(jdir), journal_fsync=False,
                      replica_id=rid),
        device=CPU,
    )
    if executor is not None:
        server.pool.executor = executor
    runner = web.AppRunner(server.app())
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return _Replica(server, runner, site)


async def _poll_terminal(client, job_id: str) -> dict:
    deadline = time.monotonic() + POLL_DEADLINE_S
    while time.monotonic() < deadline:
        resp = await client.get(f"/jobs/{job_id}")
        body = await resp.json()
        if resp.status == 503:  # replica unreachable: the handoff re-routes
            await asyncio.sleep(0.1)
            continue
        assert resp.status == 200, body
        if body["state"] in ("DONE", "FAILED", "CANCELLED"):
            return body
        await asyncio.sleep(0.1)
    raise AssertionError(f"job {job_id} never reached a terminal state")


async def _results(client, ids) -> set:
    blobs = set()
    for jid in ids:
        resp = await client.get(f"/jobs/{jid}/result")
        result = await resp.json()
        assert resp.status == 200, result
        blobs.add(bytes(result["proof"]))
    return blobs


def test_killing_a_replica_mid_flight_loses_no_accepted_job(
        circuit, tmp_path):
    async def run():
        doomed_exec = _BlockingExecutor()
        jdirs = [tmp_path / "j-a", tmp_path / "j-doomed"]
        replicas = [
            await _start_replica(circuit["root"], jdirs[0], "r-a"),
            await _start_replica(circuit["root"], jdirs[1], "r-doomed",
                                 executor=doomed_exec),
        ]
        router = FleetRouter(FleetConfig(
            replicas=tuple((h.url, str(j)) for h, j in zip(replicas, jdirs)),
            poll_s=0.2, eject_threshold=2, eject_cooldown_s=60.0))
        client = TestClient(TestServer(router.app()))
        await client.start_server()
        try:
            while router.registry.active_count() < 2:  # first polls
                await asyncio.sleep(0.05)
            accepted = []
            for i in range(6):
                resp = await client.post(
                    "/jobs/prove",
                    data={"circuit_id": circuit["cid"],
                          "witness_file": circuit["wtns"]},
                    headers={"X-DG16-Tenant": f"t{i % 2}",
                             "X-DG16-Priority": ("interactive", "batch",
                                                 "bulk")[i % 3]})
                body = await resp.json()
                assert resp.status == 202, body
                accepted.append(body["jobId"])
            doomed = router.registry.replicas[1]
            deadline = time.monotonic() + 60
            owned = []
            while time.monotonic() < deadline and not owned:
                owned = [j for j in router.jobs.values()
                         if j.replica is doomed and not j.terminal]
                await asyncio.sleep(0.05)
            assert owned, "the router never routed a job to r-doomed"
            # CRASH: no cleanup, no checkpoint, the journal as it stands
            await replicas[1].kill_listener()
            for jid in accepted:
                status = await _poll_terminal(client, jid)
                assert status["state"] == "DONE", status
            assert router.handoffs >= len(owned)
            assert doomed.state == EJECTED
            assert await _results(client, accepted) == {circuit["want"]}
            stats = await (await client.get("/fleet/stats")).json()
            states = {r["replicaId"]: r["state"] for r in stats["replicas"]}
            assert states == {"r-a": "active", "r-doomed": "ejected"}
            assert stats["handoffs"] == router.handoffs
            assert stats["tenants"]["inflightByTenant"] == {}
        finally:
            doomed_exec.release.set()
            await client.close()
            for h in replicas:
                await h.cleanup()

    asyncio.run(run())


def test_a_proof_through_the_router_equals_prove_single(circuit, tmp_path):
    async def run():
        replica = await _start_replica(circuit["root"], tmp_path / "j", "r-1")
        router = FleetRouter(FleetConfig(
            replicas=((replica.url, str(tmp_path / "j")),), poll_s=0.2))
        client = TestClient(TestServer(router.app()))
        await client.start_server()
        try:
            resp = await client.post(
                "/jobs/prove",
                data={"circuit_id": circuit["cid"],
                      "witness_file": circuit["wtns"]},
                headers={"X-DG16-Tenant": "acme"})
            body = await resp.json()
            assert resp.status == 202, body
            status = await _poll_terminal(client, body["jobId"])
            assert status["state"] == "DONE", status
            assert status["traceId"] == body["traceId"]
            assert await _results(client, [body["jobId"]]) == \
                {circuit["want"]}
            stats = await (await client.get("/fleet/stats")).json()
            assert [r["replicaId"] for r in stats["replicas"]] == ["r-1"]
            text = await (await client.get("/fleet/metrics")).text()
            assert 'replica="r-1"' in text
        finally:
            await client.close()
            await replica.cleanup()

    asyncio.run(run())
