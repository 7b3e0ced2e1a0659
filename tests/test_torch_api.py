"""The port's HTTP layer (distributed_groth16_tpu_torch/api/server.py,
api/cli.py, telemetry/profiler.py and buildinfo.py) on the CPU, held
against the JAX package's server and CLI on the same inputs: the legacy
routes end to end at mult_chain_circuit(9, 7) (tests/test_api.py), whose
proofs equal the port's prove_single's and the host reference's
(tolerance zero: proof bytes); the route table and the idle documents'
keys equal the JAX server's; backpressure, drain, idempotent submission,
a profiler capture holding a job's spans, the build identity, the CLI
over a real socket, and the CLI's table formatters.

Every local MSM takes the tree route (as on the card at full size): on
the CPU a tree MSM costs ~0.35-1 s whatever its size, the ladder ~5 s."""

import asyncio
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tarfile
import threading
import time

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from distributed_groth16_tpu_torch.api import store as store_mod
from distributed_groth16_tpu_torch.api.server import ApiServer
from distributed_groth16_tpu_torch.api.store import CircuitStore
from distributed_groth16_tpu_torch.frontend.ark_serde import (
    proof_from_bytes,
    proof_to_bytes,
)
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.frontend.readers import (
    write_r1cs,
    write_wtns,
)
from distributed_groth16_tpu_torch.models.groth16 import (
    CompiledR1CS,
    pack_proving_key,
    prove_single,
)
from distributed_groth16_tpu_torch.models.groth16.reference import prove_host
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.parallel.pss import PackedSharingParams
from distributed_groth16_tpu_torch.telemetry import buildinfo
from distributed_groth16_tpu_torch.utils.config import ServiceConfig
from distributed_groth16_tpu_torch.utils.timers import phase

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
L = 2


@pytest.fixture(scope="module")
def chain():
    r1cs, z = mult_chain_circuit(9, 7).finish()
    return dict(r1cs=r1cs, z=z, r1cs_blob=write_r1cs(r1cs),
                wtns=write_wtns(z),
                publics=[str(x) for x in z[1:r1cs.num_instance]])


@pytest.fixture(autouse=True)
def _card_routes(monkeypatch):
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)


@contextlib.contextmanager
def _keys_made_by_the_store():
    """The keys the store's setup makes while active (the in-memory key
    keeps its dealer scalars, which the saved .npz drops)."""
    made = []
    real = store_mod.setup

    def capture(*args, **kwargs):
        pk = real(*args, **kwargs)
        made.append(pk)
        return pk

    store_mod.setup = capture
    try:
        yield made
    finally:
        store_mod.setup = real


def _server(root, **kw) -> ApiServer:
    return ApiServer(CircuitStore(str(root), device=CPU), device=CPU, **kw)


async def _client(server) -> TestClient:
    client = TestClient(TestServer(server.app()))
    await client.start_server()
    return client


class _Blocking:
    """A job body that blocks until released: admitted jobs stay RUNNING."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, job):
        assert self.release.wait(timeout=120)
        raise RuntimeError("released at teardown")


def test_legacy_flow_equals_prove_single_and_the_reference(chain, tmp_path):
    async def run():
        server = _server(tmp_path)
        client = await _client(server)
        try:
            with _keys_made_by_the_store() as made:
                resp = await client.post("/save_circuit", data={
                    "circuit_name": "chain", "r1cs_file": chain["r1cs_blob"],
                    "witness_generator": b"\0fake-wasm"})
            body = await resp.json()
            assert resp.status == 200, body
            assert body["circuitName"] == "chain"
            cid, (dealer,) = body["circuitId"], made
            # a warm service: the key's CRS pack cached, packed by the
            # scalar route from the dealer's in-memory key. The server's
            # own pack of the key it loads from .npz takes the point route,
            # ~25 s on one core at this size; test_torch_mpc.py holds that
            # route against the JAX pack, and the card runs it in the
            # server (chip_smoke.py phase 12)
            server.crs_cache.get_or_pack(
                (cid, L), lambda: pack_proving_key(dealer,
                                                   PackedSharingParams(L)))

            resp = await client.post("/create_proof_without_mpc", data={
                "circuit_id": cid, "witness_file": chain["wtns"]})
            body = await resp.json()
            assert resp.status == 200, body
            assert set(body) == {"circuitId", "proof", "timeTaken"}
            plain = bytes(body["proof"])

            resp = await client.post("/create_proof_with_naive_mpc", data={
                "circuit_id": cid, "witness_file": chain["wtns"]})
            body = await resp.json()
            assert resp.status == 200, body
            assert set(body["phases"]) >= {"load", "witness", "packing",
                                           "MPC Proof"}
            assert bytes(body["proof"]) == plain

            for publics, valid in ((chain["publics"], True),
                                   ([str(int(chain["publics"][0]) + 1)],
                                    False)):
                resp = await client.post("/verify_proof", json={
                    "circuitId": cid, "proof": list(plain),
                    "publicInputs": publics})
                body = await resp.json()
                assert resp.status == 200, body
                assert body["isValid"] is valid

            resp = await client.get(f"/get_circuit_files/{cid}")
            body = await resp.json()
            assert bytes(body["r1csFile"]) == chain["r1cs_blob"]
            assert bytes(body["witnessGenerator"]) == b"\0fake-wasm"

            resp = await client.post("/create_proof_without_mpc", data={
                "circuit_id": cid,
                "witness_file": write_wtns([1] * chain["r1cs"].num_wires)})
            assert resp.status == 500
            assert "error" in await resp.json()
            return plain, dealer
        finally:
            await client.close()

    plain, dealer = asyncio.run(run())
    z = chain["z"]
    direct = prove_single(dealer, CompiledR1CS(chain["r1cs"], CPU),
                          fr().encode(z, CPU))
    assert proof_to_bytes(direct) == plain
    host = prove_host(dealer, chain["r1cs"], z)
    got = proof_from_bytes(plain)
    assert (got.a, got.b, got.c) == (host.a, host.b, host.c)


def _routes(app) -> list:
    return sorted((r.method, r.resource.canonical) for r in app.router.routes())


def test_route_table_equals_the_jax_servers(tmp_path):
    from distributed_groth16_tpu.api.server import ApiServer as JaxServer
    from distributed_groth16_tpu.api.store import CircuitStore as JaxStore

    port = _routes(_server(tmp_path / "port").app())
    ref = _routes(JaxServer(JaxStore(str(tmp_path / "jax"))).app())
    assert port == ref
    assert ("POST", "/create_proof_with_naive_mpc") in port
    assert ("GET", "/profile/{capture_id}") in port


def _shape(doc):
    """A JSON document's keys, nested (values dropped)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return None


def test_idle_documents_have_the_jax_servers_keys(tmp_path):
    from distributed_groth16_tpu.api.server import ApiServer as JaxServer
    from distributed_groth16_tpu.api.store import CircuitStore as JaxStore

    async def docs(server):
        client = await _client(server)
        try:
            out = {}
            for route in ("/healthz", "/readyz", "/stats", "/slo"):
                resp = await client.get(route)
                assert resp.status == 200, route
                out[route] = _shape(await resp.json())
            return out
        finally:
            await client.close()

    port = asyncio.run(docs(_server(tmp_path / "port")))
    ref = asyncio.run(docs(JaxServer(JaxStore(str(tmp_path / "jax")))))
    # the build identity names torch and CUDA where the JAX one names jax
    ref_build = ref["/readyz"].pop("buildInfo")
    build = port["/readyz"].pop("buildInfo")
    assert set(build) == set(ref_build) - {"jax"} | {"torch", "cuda"}
    assert port == ref


def test_queue_bound_429_and_drain_503(chain, tmp_path):
    async def run():
        server = _server(tmp_path, cfg=ServiceConfig(workers=1,
                                                     queue_bound=1))
        blocking = _Blocking()
        server.executor._run = blocking
        client = await _client(server)
        fields = {"circuit_id": "c", "witness_file": chain["wtns"]}
        try:
            first = await client.post("/jobs/prove", data=fields)
            assert first.status == 202
            jid = (await first.json())["jobId"]
            for _ in range(200):  # the worker takes the first job
                if (await (await client.get(f"/jobs/{jid}")).json())[
                        "state"] == "RUNNING":
                    break
                await asyncio.sleep(0.01)
            assert (await client.post("/jobs/prove", data=fields)).status \
                == 202
            resp = await client.post("/jobs/prove", data=fields)
            body = await resp.json()
            assert resp.status == 429, body
            assert body["queueBound"] == 1 and body["queueDepth"] == 1
            assert body["retryAfter"] > 0 and "Retry-After" in resp.headers

            resp = await client.post("/drain")
            assert (await resp.json())["alreadyDraining"] is False
            resp = await client.post("/jobs/prove", data=fields)
            assert resp.status == 503
            resp = await client.post("/create_proof_without_mpc",
                                     data=fields)
            assert resp.status == 503
            assert (await client.get("/readyz")).status == 503
            resp = await client.get("/healthz")
            assert resp.status == 200
            assert (await resp.json())["status"] == "draining"
        finally:
            blocking.release.set()
            await client.close()

    asyncio.run(run())


def test_submission_is_idempotent_by_job_id(chain, tmp_path):
    async def run():
        server = _server(tmp_path)
        blocking = _Blocking()
        server.executor._run = blocking
        client = await _client(server)
        headers = {"X-DG16-Tenant": "acme", "X-DG16-Priority": "batch",
                   "X-DG16-Trace": "t-1"}
        fields = {"circuit_id": "c", "witness_file": chain["wtns"],
                  "job_id": "job-7"}
        try:
            ids = []
            for _ in range(2):
                resp = await client.post("/jobs/prove", data=fields,
                                         headers=headers)
                assert resp.status == 202
                ids.append((await resp.json())["jobId"])
            assert ids == ["job-7", "job-7"]
            assert list(server.queue.jobs) == ["job-7"]
            body = await (await client.get("/jobs/job-7")).json()
            assert (body["tenant"], body["priority"], body["traceId"]) == \
                ("acme", "batch", "t-1")
            resp = await client.get("/jobs/job-7/result")
            assert resp.status == 409
        finally:
            blocking.release.set()
            await client.close()

    asyncio.run(run())


def test_profiler_capture_is_single_flight_and_holds_the_jobs_spans(
        chain, tmp_path):
    def body(job):
        # the executor's phases, on its worker thread, with torch ops
        for name in ("load", "witness", "prove"):
            with phase(name, job.timings):
                torch.arange(64).reshape(8, 8).sum()
        return {"circuitId": job.circuit_id, "proof": [0],
                "phases": job.timings.as_millis()}

    async def run():
        server = _server(tmp_path)
        server.executor._run = body
        client = await _client(server)
        try:
            resp = await client.post("/profile", json={"durationS": 1.5})
            cap = await resp.json()
            assert resp.status == 202, cap
            resp = await client.post("/profile", json={"durationS": 1})
            assert resp.status == 409
            assert (await client.post("/profile", data=b"x")).status == 400
            resp = await client.post("/jobs/prove", data={
                "circuit_id": "c", "witness_file": chain["wtns"]})
            job = server.queue.jobs[(await resp.json())["jobId"]]
            await asyncio.wait_for(job.wait(), 60)
            assert job.result is not None, job.error
            for _ in range(600):
                resp = await client.get(f"/profile/{cap['id']}")
                if resp.status != 202:
                    break
                await asyncio.sleep(0.05)
            assert resp.status == 200
            blob = await resp.read()
            status = await (await client.get("/profile")).json()
            metrics = await (await client.get("/metrics")).text()
        finally:
            await client.close()
        return cap["id"], blob, status, metrics

    cid, blob, status, metrics = asyncio.run(run())
    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        assert tar.getnames() == [cid, f"{cid}/trace.json"]
        trace = json.load(tar.extractfile(f"{cid}/trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"job", "load", "witness", "prove"} <= names
    assert status["running"] is None
    assert status["captures"][0]["state"] == "done"
    assert status["captures"][0]["artifactBytes"] == len(blob)
    assert 'profiler_captures_total{outcome="rejected"}' in metrics
    assert "profiler_active 0" in metrics


def test_build_info_names_torch_cuda_and_the_device():
    import distributed_groth16_tpu_torch as port
    from distributed_groth16_tpu_torch.telemetry import metrics

    doc = buildinfo.build_info(CPU)
    assert buildinfo.build_info(CPU) is doc
    assert doc == {"version": port.__version__, "torch": torch.__version__,
                   "cuda": torch.version.cuda or "none",
                   "backend": "cpu", "deviceKind": "cpu"}
    text = metrics.registry().render_prometheus()
    assert (f'dg16_build_info{{version="{doc["version"]}",'
            f'torch="{doc["torch"]}",cuda="{doc["cuda"]}",'
            f'backend="{doc["backend"]}",device="{doc["deviceKind"]}"}} 1'
            ) in text


def test_build_info_follows_the_servers_device(tmp_path, monkeypatch):
    """The identity is that of the device the server proves on: a CPU
    server reports the CPU even where torch sees a card, a server on the
    card names the card."""
    monkeypatch.setattr(buildinfo, "_docs", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")

    async def readyz():
        client = await _client(_server(tmp_path))
        try:
            resp = await client.get("/readyz")
            return (await resp.json())["buildInfo"]
        finally:
            await client.close()

    doc = asyncio.run(readyz())
    assert (doc["backend"], doc["deviceKind"]) == ("cpu", "cpu")
    for dev in (None, "cuda:0"):
        doc = buildinfo.build_info(dev)
        assert (doc["backend"], doc["deviceKind"]) == (
            "cuda", "NVIDIA H100 80GB HBM3")
    assert buildinfo.build_info(CPU)["backend"] == "cpu"


class _Live:
    """An ApiServer on a real socket, its loop on a thread of its own."""

    def __init__(self, server):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

        async def up():
            runner = web.AppRunner(server.app())
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            return runner

        self.runner = asyncio.run_coroutine_threadsafe(
            up(), self.loop).result(60)
        self.url = f"http://127.0.0.1:{self.runner.addresses[0][1]}"

    def close(self):
        asyncio.run_coroutine_threadsafe(
            self.runner.cleanup(), self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def _cli(url, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "distributed_groth16_tpu_torch.api.cli",
         "--url", url, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def test_cli_save_and_prove_against_the_port_server(chain, tmp_path):
    (tmp_path / "c.r1cs").write_bytes(chain["r1cs_blob"])
    (tmp_path / "w.wtns").write_bytes(chain["wtns"])
    live = _Live(_server(tmp_path / "store"))
    try:
        with _keys_made_by_the_store() as made:
            saved = _cli(live.url, "save", "--name", "chain", "--r1cs",
                         str(tmp_path / "c.r1cs"))
        out = tmp_path / "proof.bin"
        body = _cli(live.url, "prove", "--circuit-id", saved["circuitId"],
                    "--witness", str(tmp_path / "w.wtns"), "--out", str(out))
    finally:
        live.close()
    assert bytes(body["proof"]) == out.read_bytes()
    got = proof_from_bytes(out.read_bytes())
    want = prove_host(made[0], chain["r1cs"], chain["z"])
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)


def test_cli_formatters_give_the_jax_packages_strings():
    from distributed_groth16_tpu.api import cli as ref
    from distributed_groth16_tpu_torch.api import cli as port
    from distributed_groth16_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )

    stats = {
        "replicas": [
            {"replicaId": "r-a", "url": "http://a:8000", "state": "active",
             "score": 1.25, "queueDepth": 3, "running": 2, "workers": 4,
             "devices": 1, "openBreakers": 0, "maxBurnRate": 0.1,
             "version": "0.1.0"},
            {"replicaId": "r-b", "url": "http://b:8000", "state": "ejected",
             "score": None, "queueDepth": None, "running": None,
             "workers": None, "devices": None, "openBreakers": None,
             "maxBurnRate": None},
        ],
        "tenants": {"admitted": 30, "rejected": 2},
        "pending": 3, "handoffs": 5,
    }
    reg = MetricsRegistry()
    h = reg.histogram("job_seconds", "x", ("kind", "replica"),
                      buckets=(1.0, 10.0))
    for v in (0.5, 0.5, 2.0, 0.7):
        h.labels(kind="prove", replica="r-a").observe(v)
    st = reg.counter("party_straggler_total", "x", ("party", "replica"))
    st.labels(party="3", replica="r-a").inc(7)
    st.labels(party="1", replica="r-a").inc(2)
    reg.gauge("fleet_jobs_per_second", "x").set(1.25)
    q = reg.gauge("fleet_job_quantile_seconds", "x", ("kind", "q"))
    q.labels(kind="prove", q="0.5").set(0.4)
    q.labels(kind="prove", q="0.95").set(0.9)
    text = reg.render_prometheus()
    assert port.format_fleet_table(stats) == ref.format_fleet_table(stats)
    assert port.format_fleet_top(stats, text) == \
        ref.format_fleet_top(stats, text)
    assert port.format_fleet_top({"replicas": [], "pending": 0}, "") == \
        ref.format_fleet_top({"replicas": [], "pending": 0}, "")
    now = time.time()
    for rec in ({"ts": now, "level": "ERROR", "logger": "x.worker",
                 "msg": "job j failed: boom", "trace": "t-1", "job": "j",
                 "replica": "r-a", "source": "replica r-a"},
                {"ts": now, "level": "INFO", "logger": "x", "msg": "hello"}):
        assert port._fmt_log_line(rec) == ref._fmt_log_line(rec)
