"""The PyTorch/CUDA port's boundary: it imports neither JAX nor the JAX
package, keeps exact copies of the host math it needs, defaults its entry
points to CUDA without falling back to the CPU, and its kernel wrappers
refuse tensors they cannot launch on."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_groth16_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "compare_trees.py"]
PORT_MODULES = [
    "distributed_groth16_tpu_torch",
    "distributed_groth16_tpu_torch.ops._cuda",
    "distributed_groth16_tpu_torch.ops.constants",
    "distributed_groth16_tpu_torch.ops.refmath",
    "distributed_groth16_tpu_torch.ops.primemath",
    "distributed_groth16_tpu_torch.ops.glv",
    "distributed_groth16_tpu_torch.ops.pairing",
    "distributed_groth16_tpu_torch.ops.field",
    "distributed_groth16_tpu_torch.ops.curve",
    "distributed_groth16_tpu_torch.ops.limb_kernels",
    "distributed_groth16_tpu_torch.ops.ntt_limb",
    "distributed_groth16_tpu_torch.ops.ntt",
    "distributed_groth16_tpu_torch.ops.msm",
    "distributed_groth16_tpu_torch.ops.fixedbase",
    "distributed_groth16_tpu_torch.ops.bls12_377",
    "distributed_groth16_tpu_torch.ops.bls12_381",
    "distributed_groth16_tpu_torch.ops.scalar_pack",
    "distributed_groth16_tpu_torch.frontend.r1cs",
    "distributed_groth16_tpu_torch.frontend.sha256",
    "distributed_groth16_tpu_torch.frontend.wasm_vm",
    "distributed_groth16_tpu_torch.frontend.witness_calculator",
    "distributed_groth16_tpu_torch.frontend.readers",
    "distributed_groth16_tpu_torch.frontend.builder",
    "distributed_groth16_tpu_torch.frontend.wasm_cexec",
    "distributed_groth16_tpu_torch.frontend.ark_serde",
    "distributed_groth16_tpu_torch.frontend.snarkjs",
    "distributed_groth16_tpu_torch.frontend.ethereum",
    "distributed_groth16_tpu_torch.frontend.zkey",
    "distributed_groth16_tpu_torch.verifier",
    "distributed_groth16_tpu_torch.verifier.batch",
    "distributed_groth16_tpu_torch.verifier.executor",
    "distributed_groth16_tpu_torch.models.groth16",
    "distributed_groth16_tpu_torch.models.groth16.keys",
    "distributed_groth16_tpu_torch.models.groth16.qap",
    "distributed_groth16_tpu_torch.models.groth16.setup",
    "distributed_groth16_tpu_torch.models.groth16.prove",
    "distributed_groth16_tpu_torch.models.groth16.verify",
    "distributed_groth16_tpu_torch.models.groth16.proving_key",
    "distributed_groth16_tpu_torch.models.groth16.ext_wit",
    "distributed_groth16_tpu_torch.models.groth16.reference",
    "distributed_groth16_tpu_torch.utils.config",
    "distributed_groth16_tpu_torch.parallel.net",
    "distributed_groth16_tpu_torch.parallel.pss",
    "distributed_groth16_tpu_torch.parallel.packing",
    "distributed_groth16_tpu_torch.parallel.dfft",
    "distributed_groth16_tpu_torch.parallel.dmsm",
    "distributed_groth16_tpu_torch.parallel.pointntt",
    "distributed_groth16_tpu_torch.parallel.degred",
    "distributed_groth16_tpu_torch.parallel.dpp",
    "distributed_groth16_tpu_torch.utils.serde",
    "distributed_groth16_tpu_torch.utils.certs",
    "distributed_groth16_tpu_torch.utils.timers",
    "distributed_groth16_tpu_torch.parallel.faults",
    "distributed_groth16_tpu_torch.parallel.prodnet",
    "distributed_groth16_tpu_torch.examples",
    "distributed_groth16_tpu_torch.examples._star",
    "distributed_groth16_tpu_torch.examples.add_ids",
    "distributed_groth16_tpu_torch.examples.nonlocal_kernel",
    "distributed_groth16_tpu_torch.examples.nonlocal_sha256",
    "distributed_groth16_tpu_torch.examples.launch",
    "distributed_groth16_tpu_torch.examples.dfft_test",
    "distributed_groth16_tpu_torch.examples.dmsm_bench",
    "distributed_groth16_tpu_torch.examples.dpp_test",
    "distributed_groth16_tpu_torch.examples.million",
    "distributed_groth16_tpu_torch.examples.multichip",
    "distributed_groth16_tpu_torch.examples.local_groth_bench",
    "distributed_groth16_tpu_torch.examples.sha256",
    "distributed_groth16_tpu_torch.examples.introspect",
    "distributed_groth16_tpu_torch.examples.profile_msm",
    "distributed_groth16_tpu_torch.examples.profile_packing",
    "distributed_groth16_tpu_torch.examples.mesh_scale_run",
    "distributed_groth16_tpu_torch.parallel.mesh",
    "distributed_groth16_tpu_torch.models.groth16.mesh_prover",
    "distributed_groth16_tpu_torch.telemetry",
    "distributed_groth16_tpu_torch.telemetry.metrics",
    "distributed_groth16_tpu_torch.telemetry.tracing",
    "distributed_groth16_tpu_torch.telemetry.aggregate",
    "distributed_groth16_tpu_torch.telemetry.flight",
    "distributed_groth16_tpu_torch.telemetry.logbus",
    "distributed_groth16_tpu_torch.telemetry.devmem",
    "distributed_groth16_tpu_torch.telemetry.transfer",
    "distributed_groth16_tpu_torch.service",
    "distributed_groth16_tpu_torch.service.jobs",
    "distributed_groth16_tpu_torch.service.queue",
    "distributed_groth16_tpu_torch.service.crs_cache",
    "distributed_groth16_tpu_torch.service.journal",
    "distributed_groth16_tpu_torch.service.slo",
    "distributed_groth16_tpu_torch.service.worker",
    "distributed_groth16_tpu_torch.scheduler",
    "distributed_groth16_tpu_torch.scheduler.bucketer",
    "distributed_groth16_tpu_torch.scheduler.placement",
    "distributed_groth16_tpu_torch.scheduler.batch_prover",
    "distributed_groth16_tpu_torch.api",
    "distributed_groth16_tpu_torch.api.store",
    "distributed_groth16_tpu_torch.api.server",
    "distributed_groth16_tpu_torch.api.cli",
    "distributed_groth16_tpu_torch.telemetry.buildinfo",
    "distributed_groth16_tpu_torch.telemetry.profiler",
    "distributed_groth16_tpu_torch.telemetry.compile",
    "distributed_groth16_tpu_torch.telemetry.roofline",
    "distributed_groth16_tpu_torch.telemetry.perf",
    "distributed_groth16_tpu_torch.telemetry.perf_kernels",
    "distributed_groth16_tpu_torch.telemetry.benchgate",
    "distributed_groth16_tpu_torch.utils.benchtools",
    "distributed_groth16_tpu_torch.fleet",
    "distributed_groth16_tpu_torch.fleet.tenants",
    "distributed_groth16_tpu_torch.fleet.registry",
    "distributed_groth16_tpu_torch.fleet.federate",
    "distributed_groth16_tpu_torch.fleet.router",
    "distributed_groth16_tpu_torch.fleet.__main__",
    "distributed_groth16_tpu_torch.analysis",
    "distributed_groth16_tpu_torch.analysis.core",
    "distributed_groth16_tpu_torch.analysis.cli",
    "distributed_groth16_tpu_torch.analysis.baseline",
    "distributed_groth16_tpu_torch.analysis.report",
    "distributed_groth16_tpu_torch.analysis.rules",
    "distributed_groth16_tpu_torch.analysis.rules.dg101_async_blocking",
    "distributed_groth16_tpu_torch.analysis.rules.dg102_secret_taint",
    "distributed_groth16_tpu_torch.analysis.rules.dg103_env_knobs",
    "distributed_groth16_tpu_torch.analysis.rules.dg104_metric_catalog",
    "distributed_groth16_tpu_torch.analysis.rules.dg105_lock_discipline",
    "distributed_groth16_tpu_torch.analysis.rules.dg106_tracer_hygiene",
    "distributed_groth16_tpu_torch.analysis.rules.dg107_collective_pairing",
    "distributed_groth16_tpu_torch.analysis.rules.dg108_print_discipline",
    "distributed_groth16_tpu_torch.tools.dg16lint",
]
COPIES = ["constants", "refmath", "primemath", "glv", "pairing"]
FRONTEND_COPIES = ["r1cs", "sha256", "wasm_vm", "witness_calculator",
                   "readers", "builder", "wasm_cexec", "ark_serde", "snarkjs",
                   "ethereum"]
MODEL_COPIES = ["reference"]
UTIL_COPIES = ["serde", "certs"]
PARALLEL_COPIES = ["faults"]
VERIFIER_COPIES = ["__init__"]
# the service plane's copies, by subpackage
SERVICE_COPIES = {
    "telemetry": ["metrics", "tracing", "__init__"],
    "service": ["jobs", "queue", "crs_cache", "journal", "__init__"],
    "scheduler": ["bucketer"],
    "api": ["__init__"],
}
# copies whose code is the JAX module's but whose docstring describes the
# port (the telemetry spine's names torch.profiler and the port's
# first-use accounting where the JAX text names XLA)
OWN_DOCSTRING = {("telemetry", "__init__")}
# copies that differ from the JAX module only where its text names an
# earlier PR of the JAX package: program files of the port name no PR
REWORDED = {
    "telemetry/aggregate.py": [
        ("PR 3 made one process legible;",
         "The telemetry subsystem made one process legible;")],
    "telemetry/flight.py": [
        ("round-retry exhaustion — PR 1's fault\nmachinery)",
         "round-retry exhaustion — the transport's fault\nmachinery)")],
    "scheduler/__init__.py": [
        ("PR 2's service funnels every proof",
         "The service's executor funnels every proof"),
        ("the service behaves exactly as PR 2 built\nit",
         "the service behaves exactly as its per-job\nfunnel does"),
        ("admission bound (PR 2) keeps rejecting",
         "admission bound keeps rejecting")],
    "service/slo.py": [
        ("the `jobs_*_total` counters (PR 3) — but",
         "the `jobs_*_total` counters — but")],
}


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "distributed_groth16_tpu"
        or name.startswith("distributed_groth16_tpu.")
    )


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert "distributed_groth16_tpu_torch.models.groth16.prove" in out
    assert "distributed_groth16_tpu_torch.frontend.zkey" in out
    assert "distributed_groth16_tpu_torch.verifier.batch" in out
    assert "distributed_groth16_tpu_torch.scheduler.batch_prover" in out
    assert "distributed_groth16_tpu_torch.service.worker" in out
    assert "distributed_groth16_tpu_torch.api.server" in out
    assert "distributed_groth16_tpu_torch.api.cli" in out
    assert "distributed_groth16_tpu_torch.fleet.router" in out
    assert "distributed_groth16_tpu_torch.telemetry.profiler" in out
    assert "distributed_groth16_tpu_torch.analysis.rules.dg104_metric_catalog" \
        in out
    assert [m for m in out if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


def test_source_scan_covers_every_port_module():
    """The source scan above globs the package, so it reaches every module
    the port has, the MPC modules included."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in PORT_MODULES:
        rel = mod.replace(".", "/")
        assert f"{rel}.py" in scanned or f"{rel}/__init__.py" in scanned, mod


def test_net_config_matches_the_jax_package(monkeypatch):
    """The port's NetConfig has the JAX package's seven fields, with the
    same types and defaults, and from_env() reads the same DG16_NET_*
    overrides into the same values; the knobs the port reads are declared
    with the JAX package's text (but PORT_KNOB_TEXT)."""
    import dataclasses

    from distributed_groth16_tpu.utils import config as ref
    from distributed_groth16_tpu_torch.utils import config as port

    ref_fields = {f.name: (f.type, f.default)
                  for f in dataclasses.fields(ref.NetConfig)}
    fields = dataclasses.fields(port.NetConfig)
    assert [f.name for f in fields] == [
        "op_timeout_s", "connect_timeout_s", "connect_base_delay_s",
        "connect_max_delay_s", "connect_jitter", "heartbeat_interval_s",
        "idle_timeout_s",
    ]
    assert [f.name for f in fields] == list(ref_fields)
    for f in fields:
        assert (f.type, f.default) == ref_fields[f.name], f.name
    assert port.KNOBS == {k: PORT_KNOB_TEXT.get(k, v)
                          for k, v in ref.KNOBS.items()
                          if k.startswith(PORT_KNOB_PREFIXES)
                          or k in PORT_KNOBS}
    assert dataclasses.asdict(port.NetConfig.from_env()) == \
        dataclasses.asdict(ref.NetConfig.from_env())
    overrides = {"DG16_NET_OP_TIMEOUT_S": "7.5",
                 "DG16_NET_CONNECT_TIMEOUT_S": "3",
                 "DG16_NET_CONNECT_BASE_DELAY_S": "0.25",
                 "DG16_NET_CONNECT_MAX_DELAY_S": "2",
                 "DG16_NET_CONNECT_JITTER": "0",
                 "DG16_NET_HEARTBEAT_S": "-1",
                 "DG16_NET_IDLE_TIMEOUT_S": "42"}
    for k, v in overrides.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(port.NetConfig.from_env())
    assert got == dataclasses.asdict(ref.NetConfig.from_env())
    assert got == {"op_timeout_s": 7.5, "connect_timeout_s": 3.0,
                   "connect_base_delay_s": 0.25, "connect_max_delay_s": 2.0,
                   "connect_jitter": 0.0, "heartbeat_interval_s": -1.0,
                   "idle_timeout_s": 42.0}
    # the witness calculator's engine switch
    assert port.env_flag("DG16_NO_CWASM") is False
    monkeypatch.setenv("DG16_NO_CWASM", "1")
    assert port.env_flag("DG16_NO_CWASM") is ref.env_flag("DG16_NO_CWASM")
    assert port.env_flag("DG16_NO_CWASM") is True


# the knobs the port reads: the transport's, the service plane's (service,
# journal, batching scheduler, verify buckets, SLO), the fleet router's and
# its tenant admission's, the telemetry and log-spine copies', the
# profiler's and device-memory sampler's, the store's and the frontend's,
# the perf observatory's and its roofline's
PORT_KNOB_PREFIXES = ("DG16_NET_", "DG16_SERVICE_", "DG16_JOURNAL",
                      "DG16_BATCH_", "DG16_SCHED_", "DG16_BREAKER_",
                      "DG16_VERIFY_", "DG16_SLO_", "DG16_LOG_", "DG16_FLEET_",
                      "DG16_TENANT_", "DG16_PERF_", "DG16_PEAK_")
PORT_KNOBS = ("DG16_TRACE", "DG16_NO_CWASM", "DG16_METRICS", "DG16_TRACE_OUT",
              "DG16_AGG", "DG16_FLIGHT_DIR", "DG16_STORE", "DG16_PROF_DIR",
              "DG16_PROF_MAX_S", "DG16_DEVMEM_SAMPLE_S", "DG16_VECTORS",
              "DG16_REQUIRE_VECTORS")
# the port's own text where the JAX text names XLA, or flops where the
# port's roofline counts 32-bit multiply-adds
PORT_KNOB_TEXT = {
    "DG16_PROF_DIR": "on-demand torch.profiler artifact directory",
    "DG16_PEAK_FLOPS": "roofline peak 32-bit multiply-adds/s override for "
                       "this backend",
}


@pytest.mark.parametrize("cls", ["ServiceConfig", "SchedulerConfig",
                                 "SLOConfig", "FleetConfig", "TenantConfig"])
def test_service_configs_match_the_jax_package(cls, monkeypatch):
    """The service plane's configs have the JAX package's fields and
    defaults, and from_env() reads the same overrides into the same
    values."""
    import dataclasses

    from distributed_groth16_tpu.utils import config as ref
    from distributed_groth16_tpu_torch.utils import config as port

    P, R = getattr(port, cls), getattr(ref, cls)
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(P)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(R)]
    assert dataclasses.asdict(P.from_env()) == \
        dataclasses.asdict(R.from_env())
    overrides = {
        "ServiceConfig": {"DG16_SERVICE_WORKERS": "5",
                          "DG16_SERVICE_QUEUE_BOUND": "9",
                          "DG16_SERVICE_CRS_CACHE": "0",
                          "DG16_SERVICE_ROUND_RETRIES": "1",
                          "DG16_SERVICE_RETRY_AFTER_S": "0.5",
                          "DG16_SERVICE_JOB_HISTORY": "3",
                          "DG16_JOURNAL": "1", "DG16_JOURNAL_FSYNC": "0",
                          "DG16_JOURNAL_SEGMENT_RECORDS": "17",
                          "DG16_FLEET_REPLICA_ID": "r7"},
        "SchedulerConfig": {"DG16_BATCH_MAX": "8",
                            "DG16_BATCH_LINGER_MS": "250",
                            "DG16_SCHED_MESHES": "2",
                            "DG16_SCHED_INFLIGHT": "11",
                            "DG16_SCHED_POISON_RETRIES": "4",
                            "DG16_BREAKER_THRESHOLD": "0",
                            "DG16_BREAKER_COOLDOWN_S": "1.5",
                            "DG16_VERIFY_BATCH_MAX": "1",
                            "DG16_VERIFY_LINGER_MS": "3"},
        "SLOConfig": {"DG16_SLO_TARGET_S": "2",
                      "DG16_SLO_TARGETS": "prove=30, mpc_prove=120",
                      "DG16_SLO_OBJECTIVE": "0.9",
                      "DG16_SLO_WINDOW_S": "60", "DG16_SLO_SAMPLE_S": "0.25"},
        "FleetConfig": {"DG16_FLEET_REPLICAS":
                        "http://a:8001=/var/j1, http://b:8002/",
                        "DG16_FLEET_POLL_S": "0.5",
                        "DG16_FLEET_EJECT_THRESHOLD": "2",
                        "DG16_FLEET_COOLDOWN_S": "7",
                        "DG16_FLEET_PENDING_BOUND": "9",
                        "DG16_FLEET_WEIGHTS": "interactive=5,bulk=2",
                        "DG16_FLEET_HISTORY": "11",
                        "DG16_FLEET_ANOMALY_FACTOR": "0"},
        "TenantConfig": {"DG16_TENANT_RATE": "0.5",
                         "DG16_TENANT_BURST": "3",
                         "DG16_TENANT_INFLIGHT": "4",
                         "DG16_TENANT_LIMITS": "acme=5:20:50,free=::8"},
    }[cls]
    for k, v in overrides.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(P.from_env())
    assert got == dataclasses.asdict(R.from_env())
    assert got != dataclasses.asdict(P())
    for name in ("env_str", "env_int"):
        assert getattr(port, name)("DG16_STORE", 3) == \
            getattr(ref, name)("DG16_STORE", 3)


def _code_of(path: pathlib.Path) -> str:
    return ast.dump(ast.parse(path.read_text()))


@pytest.mark.parametrize("mod", COPIES + FRONTEND_COPIES + MODEL_COPIES
                         + UTIL_COPIES + PARALLEL_COPIES + VERIFIER_COPIES)
def test_host_module_is_an_exact_copy(mod):
    sub = ("ops" if mod in COPIES else "frontend" if mod in FRONTEND_COPIES
           else "utils" if mod in UTIL_COPIES
           else "parallel" if mod in PARALLEL_COPIES
           else "verifier" if mod in VERIFIER_COPIES else "models/groth16")
    ref = ROOT / "distributed_groth16_tpu" / sub / f"{mod}.py"
    assert _code_of(PORT / sub / f"{mod}.py") == _code_of(ref)
    assert (PORT / sub / f"{mod}.py").read_bytes() == ref.read_bytes()


# the BLS12 modules: their host part (parameters derived from the seed,
# the import-time self-checks, the host ground truth and the generators)
# is copied; these device instances are the port's own
BLS_DEVICE = {
    "bls12_377": {"fq377", "fr377", "g1_377", "encode_scalars_377",
                  "pss377", "pack_scalars_377"},
    "bls12_381": {"fq381", "fr381", "fq2_381", "g1_381", "g2_381",
                  "encode_scalars_381", "pss381", "pack_scalars_381"},
}


# and the port's own fix of a fault of the JAX package: its G2 generator
# clears the cofactor mod r and so lies outside G2 (ROADMAP queue 3)
BLS_FIXED = {"bls12_377": set(),
             "bls12_381": {"g2_generator_381", "_mul_unreduced"}}


def _host_part(path: pathlib.Path, skip: set) -> list[str]:
    """Top-level statements after the docstring, minus the named ones; a
    class is compared member by member, so "Class.method" skips one."""
    body = ast.parse(path.read_text()).body[1:]  # after the docstring
    out = []
    for n in body:
        name = getattr(n, "name", None)
        if name in skip:
            continue
        if isinstance(n, ast.ClassDef):
            out.append(f"class {name}" + "".join(
                ast.dump(x) for x in n.bases + n.decorator_list))
            out += [ast.dump(m) for m in n.body
                    if f"{name}.{getattr(m, 'name', None)}" not in skip]
        else:
            out.append(ast.dump(n))
    return out


def _functions(path: pathlib.Path) -> set:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("mod", sorted(BLS_DEVICE))
def test_bls_host_part_is_an_exact_copy(mod):
    ref = ROOT / "distributed_groth16_tpu" / "ops" / f"{mod}.py"
    port = PORT / "ops" / f"{mod}.py"
    skip = BLS_DEVICE[mod] | BLS_FIXED[mod]
    assert _host_part(port, skip) == _host_part(ref, skip)
    names, ported = _functions(ref), _functions(port)
    assert BLS_DEVICE[mod] <= names <= ported
    assert ported - names <= BLS_FIXED[mod]


@pytest.mark.parametrize("sub, mod", [
    (sub, mod) for sub, mods in sorted(SERVICE_COPIES.items())
    for mod in mods
])
def test_service_plane_module_is_an_exact_copy(sub, mod):
    ref = (ROOT / "distributed_groth16_tpu" / sub / f"{mod}.py").read_text()
    port = (PORT / sub / f"{mod}.py").read_text()
    if (sub, mod) in OWN_DOCSTRING:
        ref, port = _without_docstring(ref), _without_docstring(port)
        assert ref.strip()
    assert port == ref


def _without_docstring(text: str) -> str:
    """The module's source after its docstring."""
    doc = ast.parse(text).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return "\n".join(text.splitlines()[doc.end_lineno:])


@pytest.mark.parametrize("rel", sorted(REWORDED))
def test_reworded_copy_differs_only_where_it_names_a_pr(rel):
    ref = (ROOT / "distributed_groth16_tpu" / rel).read_text()
    port = (PORT / rel).read_text()
    assert port != ref
    for jax_text, port_text in REWORDED[rel]:
        assert ref.count(jax_text) == 1 and port.count(port_text) == 1
        ref = ref.replace(jax_text, port_text)
    assert port == ref


# modules whose host part is copied: the members named here are the
# port's own (a device= for the witness, the compiled circuit, the
# verifier's prepared keys and the store's keys)
HOST_PART = {
    "service/worker.py": {"ProofExecutor.__init__", "ProofExecutor._run"},
    "verifier/executor.py": {"VerifyExecutor.__init__",
                             "VerifyExecutor.load_pvk"},
    "api/store.py": {"CircuitStore.__init__", "CircuitStore.save_circuit",
                     "CircuitStore.load"},
}


@pytest.mark.parametrize("rel", sorted(HOST_PART))
def test_service_host_part_is_an_exact_copy(rel):
    ref = ROOT / "distributed_groth16_tpu" / rel
    port = PORT / rel
    skip = HOST_PART[rel]
    assert _host_part(port, skip) == _host_part(ref, skip)
    assert _host_part(port, set()) != _host_part(ref, set())


# copies that differ only in the package's own name: the logbus names the
# logger it installs on and the module it reads the MPC job id from, the
# phase timers the logger they write to (after the module docstring)
RENAMED = {
    "telemetry/logbus.py": ['PACKAGE_LOGGER = "distributed_groth16_tpu_torch"',
                            '"distributed_groth16_tpu_torch.parallel.net"'],
    "utils/timers.py": ['getLogger("distributed_groth16_tpu_torch")'],
}


@pytest.mark.parametrize("rel", sorted(RENAMED))
def test_renamed_copy_differs_only_in_the_package_name(rel):
    def body(text):
        return text[text.index('"""', 3) + 3:]

    ref = body((ROOT / "distributed_groth16_tpu" / rel).read_text())
    port = body((PORT / rel).read_text())
    for name in RENAMED[rel]:
        assert port.count(name) == 1, name
        port = port.replace(name, name.replace(
            "distributed_groth16_tpu_torch", "distributed_groth16_tpu"))
    assert port == ref


# the serving plane above the job service: copies of the JAX modules but
# for the edits listed here (the port's device=, torch.profiler, the
# package's own name, the phrases that name an earlier PR of the JAX
# package) and, in the CLI, the cut perf group
SERVER_EDITS = [
    ('"""HTTP proving service — the mpc-api role (mpc-api/src/main.rs:795-805),\n'
     'now fronting the proof-job service layer (service/, docs/SERVICE.md).\n',
     '"""HTTP proving service — the mpc-api role (mpc-api/src/main.rs:795-805),\n'
     'now fronting the proof-job service layer (service/, docs/SERVICE.md);\n'
     'the counterpart of the JAX package\'s api/server.py, whose routes, DTOs,\n'
     'status codes and headers it keeps. `ApiServer(..., device=None)` proves\n'
     'on `device` (None: the card): it hands the device to the default\n'
     'CircuitStore, the ProofExecutor and the batching scheduler\'s placement.\n'
     'Run it with `python -m distributed_groth16_tpu_torch.api.server\n'
     '[--device cpu]` (PORT, DG16_STORE and the DG16_SERVICE_* knobs as for the\n'
     'JAX server).\n'),
    ("start one bounded on-demand XLA profiler capture",
     "start one bounded on-demand torch.profiler capture"),
    ("        slo_cfg: SLOConfig | None = None,\n    ):\n"
     "        self.store = store or CircuitStore()\n",
     "        slo_cfg: SLOConfig | None = None,\n        device=None,\n    ):\n"
     "        # jobs prove on `device` (None: the card): the default store's\n"
     "        # keys, the executor's witnesses and circuits, the scheduler's meshes\n"
     "        self.store = store or CircuitStore(device=device)\n"),
    ("ProofExecutor(self.store, self.crs_cache, self.cfg)",
     "ProofExecutor(\n            self.store, self.crs_cache, self.cfg, device=device\n        )"),
    ("DG16_BATCH_MAX <= 1 the pool runs PR 2's per-job funnel exactly",
     "DG16_BATCH_MAX <= 1 the pool runs its per-job funnel exactly"),
    ("            from ..scheduler import BatchScheduler\n\n"
     "            self.scheduler = BatchScheduler(\n"
     "                self.executor, self.queue, self.sched_cfg,\n"
     "                slo_target_s=self.slo_cfg.target_s,\n",
     "            import torch\n\n"
     "            from ..scheduler import BatchScheduler\n\n"
     "            self.scheduler = BatchScheduler(\n"
     "                self.executor, self.queue, self.sched_cfg,\n"
     "                devices=None if device is None else [torch.device(device)],\n"
     "                slo_target_s=self.slo_cfg.target_s,\n"),
    ("on-demand XLA\n        # profiler (artifacts",
     "on-demand\n        # torch.profiler (artifacts"),
    ("telemetry_buildinfo.build_info()",
     "telemetry_buildinfo.build_info(device)"),
    ("single-flight XLA capture\n        mid-job; 409 while another runs. The start itself is cheap but\n"
     "        runs off the loop (jax.profiler spins up collector threads).",
     "single-flight torch.profiler\n        capture mid-job; 409 while another runs. The start runs off the\n"
     "        loop (the capture's own thread starts the profiler and CUPTI)."),
    ("a no-op data-wise on XLA:CPU, where the\n        backend reports no stats",
     "a no-op data-wise on the CPU, which\n        reports no stats"),
    ("def main() -> None:\n    telemetry_logbus.setup()  # console handler + ring for a real server\n"
     "    port = int(os.environ.get(\"PORT\", \"8000\"))\n"
     "    web.run_app(ApiServer().app(), port=port)\n",
     "def main(argv=None) -> None:\n"
     "    p = argparse.ArgumentParser(\n"
     "        prog=\"python -m distributed_groth16_tpu_torch.api.server\"\n"
     "    )\n"
     "    p.add_argument(\"--device\", default=None,\n"
     "                   help=\"where jobs prove: a torch device such as cpu or \"\n"
     "                        \"cuda:1 (default: the card)\")\n"
     "    args = p.parse_args(argv)\n"
     "    telemetry_logbus.setup()  # console handler + ring for a real server\n"
     "    port = int(os.environ.get(\"PORT\", \"8000\"))\n"
     "    web.run_app(ApiServer(device=args.device).app(), port=port)\n"),
    ("from __future__ import annotations\n\nimport asyncio\n",
     "from __future__ import annotations\n\nimport argparse\nimport asyncio\n"),
]

# the port's CLI: the JAX module's text but its docstring, the package's
# name, the profiler's, and its `perf` group's device option and the
# places where the JAX text names the JAX package's tools and docs
CLI_EDITS = [
    ('"""CLI client — the zk-cli role (zk-cli/src/main.rs:30-208).\n',
     '"""CLI client — the zk-cli role (zk-cli/src/main.rs:30-208); the\n'
     'counterpart of the JAX package\'s api/cli.py. It speaks HTTP to a port\n'
     'server or router and needs no card itself, but for `perf run` and\n'
     '`perf roofline` without --run, which run the per-kernel perf registry\n'
     '(telemetry/perf.py) on the card unless --device names another.\n'),
    ("      [--select msm_g1 ...] [--out perf.json]\n"
     "  python -m distributed_groth16_tpu.api.cli perf top --run perf.json "
     "[-n 10]\n"
     "  python -m distributed_groth16_tpu.api.cli perf diff before.json "
     "after.json \\\n"
     "      [--markdown]\n"
     "  python -m distributed_groth16_tpu.api.cli perf roofline "
     "[--run perf.json]\n",
     "      [--select msm_g1 ...] [--device cpu] [--out perf.json]\n"
     "  python -m distributed_groth16_tpu.api.cli perf top --run perf.json "
     "\\\n      [-n 10]\n"
     "  python -m distributed_groth16_tpu.api.cli perf diff before.json "
     "\\\n      after.json [--markdown]\n"
     "  python -m distributed_groth16_tpu.api.cli perf roofline \\\n"
     "      [--run perf.json | --device cpu]\n"),
    ("python -m distributed_groth16_tpu.api.cli",
     "python -m distributed_groth16_tpu_torch.api.cli"),
    ('help="on-demand XLA profiling of a LIVE server "',
     'help="on-demand torch.profiler profiling of a LIVE server "'),
    ("    \"\"\"Run the per-kernel bench registry locally (no server) and print a\n"
     "    compact summary; --out writes the full dg16-perf/1 document — gate it\n"
     "    later with `tools/benchgate --check` (docs/PERF.md).\"\"\"\n",
     "    \"\"\"Run the per-kernel bench registry locally (no server; on the card\n"
     "    unless --device names another) and print a compact summary; --out\n"
     "    writes the full dg16-perf/1 document — gate it later with\n"
     "    `python -m distributed_groth16_tpu_torch.telemetry.benchgate "
     "--check`.\"\"\"\n"),
    ("quick=args.quick, select=args.select, reps=args.reps\n",
     "quick=args.quick, select=args.select, reps=args.reps,\n"
     "            device=args.device,\n"),
    ("quick=True, select=args.select, reps=args.reps\n",
     "quick=True, select=args.select, reps=args.reps,\n"
     "                device=args.device,\n"),
    ("    # anchored to the repo root, not the CWD — `perf top` run from\n"
     "    # anywhere still finds the checked-in baseline\n",
     "    # anchored to the package, not the CWD — `perf top` run from\n"
     "    # anywhere still finds the port's baseline\n"),
    ("instead of JSON (the CI perf-smoke\n"
     "    lane pipes it into the step summary).",
     "instead of JSON (for a CI step\n    summary)."),
    ("    fresh quick run when --run is absent): achieved FLOP/s and B/s,\n"
     "    arithmetic intensity, fraction of the binding roof, and whether each\n"
     "    kernel is compute- or memory-bound — against DG16_PEAK_FLOPS /\n"
     "    DG16_PEAK_BW or the device-kind peak table (docs/PERF.md \"Roofline\n"
     "    workflow\").",
     "    fresh quick run on --device, the card by default, when --run is\n"
     "    absent): achieved multiply-adds/s and B/s, arithmetic intensity,\n"
     "    fraction of the binding roof, and whether each kernel is compute- or\n"
     "    memory-bound — against DG16_PEAK_FLOPS / DG16_PEAK_BW or the\n"
     "    device-kind peak table of this machine (telemetry/roofline.py)."),
    ("diff two runs (docs/PERF.md)", "diff two runs, roofline"),
    ('help="CPU smoke subset of sizes"', 'help="smoke subset of sizes"'),
    ('                    help="write the full dg16-perf/1 run document here")\n',
     '                    help="write the full dg16-perf/1 run document here")\n'
     '    sp.add_argument("--device", default=None,\n'
     '                    help="device to run on (default: the card, cuda:0; "\n'
     '                         "cpu runs the plain versions)")\n'),
    ('help="baseline file (default tools/perf-baseline.json)"',
     'help="baseline file (default distributed_groth16_tpu_"\n'
     '                         "torch/tools/perf-baseline.json)"'),
    ("per device kernel (docs/PERF.md)", "per device kernel"),
    ('                    help="warm reps per case (no --run only)")\n',
     '                    help="warm reps per case (no --run only)")\n'
     '    sp.add_argument("--device", default=None,\n'
     '                    help="device of the quick run (no --run only; "\n'
     '                         "default: the card, cuda:0)")\n'),
]

# the fleet plane: copies but for the package's name and the phrases that
# name an earlier PR of the JAX package
FLEET_EDITS = {
    "fleet/__init__.py": [
        ("One crash-safe replica (PR 7) serves one device inventory;",
         "One crash-safe replica serves one device inventory;"),
        ("`python -m distributed_groth16_tpu.fleet`",
         "`python -m distributed_groth16_tpu_torch.fleet`"),
    ],
    "fleet/__main__.py": [
        ("`python -m distributed_groth16_tpu.fleet`",
         "`python -m distributed_groth16_tpu_torch.fleet`"),
    ],
    "fleet/federate.py": [],
    "fleet/registry.py": [
        ("(slo_burn_rate > 1, PR 8)", "(slo_burn_rate > 1)"),
        ("Ejection reuses the PR 7 breaker state machine shape",
         "Ejection reuses the mesh breakers' state machine shape"),
    ],
    "fleet/router.py": [
        ("is a full PR 7 crash-safe ApiServer",
         "is a full crash-safe ApiServer"),
        ("(NTP-style, the PR 4\n        # heartbeat shape)",
         "(NTP-style, the\n        # transport heartbeat's shape)"),
        ("# (the PR 4 add_party convention)",
         "# (the aggregator's add_party convention)"),
    ],
    "fleet/tenants.py": [
        ("One replica's queue bound (PR 2) protects a PROCESS;",
         "One replica's queue bound protects a PROCESS;"),
    ],
}


SERVING_COPIES = {"api/server.py": ([], SERVER_EDITS),
                  "api/cli.py": ([], CLI_EDITS)}
SERVING_COPIES.update({rel: ([], e) for rel, e in FLEET_EDITS.items()})


@pytest.mark.parametrize("rel", sorted(SERVING_COPIES))
def test_serving_plane_copy_differs_only_in_its_listed_edits(rel):
    ref = (ROOT / "distributed_groth16_tpu" / rel).read_text()
    cuts, edits = SERVING_COPIES[rel]
    for start, end in cuts:
        i = ref.index(start)
        ref = ref[:i] + ref[ref.index(end, i):]
    for jax_text, port_text in edits:
        assert jax_text in ref, jax_text
        ref = ref.replace(jax_text, port_text)
    assert (PORT / rel).read_text() == ref


# the port's dg16lint: the JAX package's analysis/ pointed at the port
# (its default target, its config module, its metric catalog, its
# baseline and their spelling in the help texts), the DG106 docstring's
# note that the port jits nothing, and DG107's docstring where it names an
# earlier PR of the JAX package; every other module is the same bytes
ANALYSIS_EDITS = {
    "analysis/__init__.py": [
        ('"""dg16lint — project-native static analysis for distributed_groth16_tpu.\n',
         '"""dg16lint — project-native static analysis for distributed_groth16_tpu,\nrun over the PyTorch port (distributed_groth16_tpu_torch): the JAX\npackage\'s analysis/, its rules DG101-DG108 unchanged, pointed at the\nport\'s package, its utils/config.py, its metric catalog\n(docs/torch/OBSERVABILITY.md) and its baseline.\n'),
        ('Run it with ``python -m distributed_groth16_tpu.analysis`` or\n``tools/dg16lint`` (the latter needs no third-party deps — the whole\npackage is stdlib-only and self-contained; nothing here may import jax or\nany sibling package). Findings are suppressed inline with\n',
         'Run it with ``python -m distributed_groth16_tpu_torch.analysis`` or\n``python distributed_groth16_tpu_torch/tools/dg16lint.py`` (the latter\nneeds no third-party deps — the whole package is stdlib-only and\nself-contained; nothing here may import jax, torch or any sibling\npackage). Findings are suppressed inline with\n'),
        ('checked-in baseline (``tools/dg16lint-baseline.json``). See\n',
         'checked-in baseline\n(``distributed_groth16_tpu_torch/tools/dg16lint-baseline.json``). See\n'),
    ],
    "analysis/__main__.py": [
        ('"""``python -m distributed_groth16_tpu.analysis`` entry point."""\n',
         '"""``python -m distributed_groth16_tpu_torch.analysis`` entry point."""\n'),
    ],
    "analysis/baseline.py": [
        ('DEFAULT_BASELINE = "tools/dg16lint-baseline.json"\n',
         'DEFAULT_BASELINE = "distributed_groth16_tpu_torch/tools/dg16lint-baseline.json"\n'),
        ('    # non-module paths (DG104 rows in docs/OBSERVABILITY.md) have no line\n',
         '    # non-module paths (DG104 rows in docs/torch/OBSERVABILITY.md) have no line\n'),
        ('            "`python -m distributed_groth16_tpu.analysis --write-baseline`"\n',
         '            "`python -m distributed_groth16_tpu_torch.analysis "\n            "--write-baseline`"\n'),
    ],
    "analysis/cli.py": [
        ('    python -m distributed_groth16_tpu.analysis [paths...] [options]\n    tools/dg16lint [paths...] [options]          # no-deps spelling\n',
         '    python -m distributed_groth16_tpu_torch.analysis [paths...] [options]\n    python distributed_groth16_tpu_torch/tools/dg16lint.py [paths...]\n        [options]                                # no-deps spelling\n'),
        ('            "Project-native static analysis for distributed_groth16_tpu "\n',
         '            "Project-native static analysis for "\n            "distributed_groth16_tpu_torch "\n'),
        ('        help="files/dirs to lint (default: the distributed_groth16_tpu "\n',
         '        help="files/dirs to lint (default: the "\n        "distributed_groth16_tpu_torch "\n'),
        ('        default = Path("distributed_groth16_tpu")\n',
         '        default = Path("distributed_groth16_tpu_torch")\n'),
        ('            # itself lives in (what tools/dg16lint relies on)\n',
         '            # itself lives in (what tools/dg16lint.py relies on)\n'),
    ],
    "analysis/core.py": [
        ("bare interpreter — CI's lint lane and ``tools/dg16lint`` load it without\njax installed — so nothing in ``analysis/`` may import the rest of the\n",
         'bare interpreter — ``tools/dg16lint.py`` loads it without torch\ninstalled — so nothing in ``analysis/`` may import the rest of the\n'),
    ],
    "analysis/rules/dg103_env_knobs.py": [
        ('    "distributed_groth16_tpu/utils/config.py",\n',
         '    "distributed_groth16_tpu_torch/utils/config.py",\n'),
    ],
    "analysis/rules/dg104_metric_catalog.py": [
        ('docs/OBSERVABILITY.md is the contract dashboards and alerts are built\n',
         "docs/torch/OBSERVABILITY.md, the port's copy of the JAX package's\ndocs/OBSERVABILITY.md catalog, is the contract dashboards and alerts are built\n"),
        ('_CATALOG_DOC = "docs/OBSERVABILITY.md"\n',
         '_CATALOG_DOC = "docs/torch/OBSERVABILITY.md"\n'),
        ('    "docs/OBSERVABILITY.md catalog — name, type, and label set, in both "\n    "directions.",\n',
         '    "docs/torch/OBSERVABILITY.md catalog — name, type, and label set, in "\n    "both directions.",\n'),
    ],
    "analysis/rules/dg107_collective_pairing.py": [
        ("the bug class PR 1's chaos suite",
         "the bug class the transport's chaos suite"),
    ],
    "analysis/rules/dg106_tracer_hygiene.py": [
        ('``shard_map(f, ...)``).\n',
         '``shard_map(f, ...)``).\n\nThe PyTorch port jits nothing, so over its package the rule finds no\njitted function and reports nothing; it stays so that a jit wrapper\nadded later is held to the same hygiene.\n'),
    ],
}


ANALYSIS_FILES = sorted(
    str(p.relative_to(ROOT / "distributed_groth16_tpu"))
    for p in (ROOT / "distributed_groth16_tpu" / "analysis").rglob("*.py")
)


@pytest.mark.parametrize("rel", ANALYSIS_FILES)
def test_analysis_copy_differs_only_in_its_listed_edits(rel):
    ref = (ROOT / "distributed_groth16_tpu" / rel).read_text()
    for jax_text, port_text in ANALYSIS_EDITS.get(rel, []):
        assert ref.count(jax_text) == 1, jax_text
        ref = ref.replace(jax_text, port_text)
    assert (PORT / rel).read_text() == ref


_CONSTANTS = [
    "Q", "R", "BN_X", "FR_GENERATOR", "FQ_GENERATOR", "FR_TWO_ADICITY",
    "FR_TWO_ADIC_ROOT", "G1_B", "G1_GENERATOR", "FQ2_NON_RESIDUE", "G2_B",
    "G2_GENERATOR", "ATE_LOOP_COUNT", "LIMB_BITS", "N_LIMBS", "LIMB_MASK",
    "MONT_BITS",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constants_equal_the_jax_package(name):
    from distributed_groth16_tpu.ops import constants as ref
    from distributed_groth16_tpu_torch.ops import constants as port

    assert getattr(port, name) == getattr(ref, name)


def test_routing_thresholds_match_the_jax_package():
    from distributed_groth16_tpu_torch.ops import msm, ntt

    assert msm.TREE_MSM_MIN_N == 1024  # ops/msm.py:162
    assert msm.LADDER_MSM_MAX_N == 128  # ops/msm.py:112
    assert ntt.LIMB_NTT_MIN_N == 2048  # ops/ntt.py:228


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_setup_without_device_raises_before_any_cpu_work(monkeypatch):
    _no_card()
    from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
    from distributed_groth16_tpu_torch.models.groth16 import setup as setup_mod

    setup_module = sys.modules["distributed_groth16_tpu_torch.models.groth16.setup"]
    ran = []
    monkeypatch.setattr(
        setup_module, "_qap_polys_at_tau", lambda *a: ran.append(a)
    )
    r1cs, _ = mult_chain_circuit(3, 5).finish()
    with pytest.raises((RuntimeError, AssertionError)):
        setup_mod(r1cs)
    assert ran == []


@pytest.mark.parametrize("entry", ["encode", "load", "compile", "scalars",
                                   "zkey", "verifier"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    _no_card()
    from distributed_groth16_tpu_torch.frontend.r1cs import (
        R1CS, mult_chain_circuit,
    )
    from distributed_groth16_tpu_torch.frontend.zkey import write_zkey
    from distributed_groth16_tpu_torch.models.groth16 import (
        CompiledR1CS, ProvingKey,
    )
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std
    from distributed_groth16_tpu_torch.verifier import PreparedVerifyingKey

    r1cs, _ = mult_chain_circuit(3, 5).finish()
    empty = R1CS(num_instance=1, num_witness=0, a=[], b=[], c=[])
    calls = {
        "encode": lambda: fr().encode([1, 2, 3]),
        "load": lambda: ProvingKey.load(str(tmp_path / "missing.npz")),
        "compile": lambda: CompiledR1CS(r1cs),
        "scalars": lambda: encode_scalars_std([5, 6]),
        "zkey": lambda: ProvingKey.from_zkey(write_zkey(_tiny_key(), empty)),
        "verifier": lambda: PreparedVerifyingKey.prepare(
            "c", _tiny_key().vk),
    }
    if entry == "load":
        _tiny_key().save(str(tmp_path / "missing.npz"))
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()


def _tiny_key():
    from distributed_groth16_tpu_torch.models.groth16.keys import (
        ProvingKey, VerifyingKey,
    )

    pt = torch.zeros((1, 3, 16), dtype=torch.int32)
    vk = VerifyingKey((1, 2), None, None, None, [(1, 2)])
    return ProvingKey(
        vk=vk, beta_g1=pt[0], delta_g1=pt[0], a_query=pt, b_g1_query=pt,
        b_g2_query=torch.zeros((1, 3, 2, 16), dtype=torch.int32),
        h_query=pt, l_query=pt, domain_size=1, num_instance=1,
    )


@pytest.mark.parametrize("kernel", ["add", "double", "horner", "ntt"])
def test_wrappers_refuse_tensors_they_cannot_launch_on(kernel):
    from distributed_groth16_tpu_torch.ops.limb_kernels import lg1
    from distributed_groth16_tpu_torch.ops.ntt_limb import _small

    g = lg1()
    pts = torch.zeros((48, 4), dtype=torch.int32, device="meta")
    calls = {
        "add": lambda: g.add(pts, pts),
        "double": lambda: g.double(pts),
        "horner": lambda: g.horner(pts, 4),
        "ntt": lambda: _small(8, False)(
            torch.zeros((16, 8, 2), dtype=torch.int32, device="meta")
        ),
    }
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        calls[kernel]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from distributed_groth16_tpu_torch.ops import _cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", ["limb_add_g1", "limb_double_g2",
                                  "limb_horner_g1", "ntt_small",
                                  "limb_add_g2", "limb_double_g1",
                                  "limb_horner_g2", "limb_add_g1_w12",
                                  "limb_add_g2_w12", "limb_double_g1_w12",
                                  "limb_double_g2_w12", "limb_horner_g1_w12",
                                  "limb_horner_g2_w12"])
def test_kernel_entries_exist_in_the_sources(name):
    from distributed_groth16_tpu_torch.ops import _cuda

    k = _cuda.KERNELS[name]
    src = (_cuda.CSRC / f"{k.source}.cu").read_text()
    assert f"int {k.symbol}(" in src
    args = _cuda._ENTRIES[k.source][k.symbol]
    decl = src[src.index(f"int {k.symbol}(") :].split(")")[0]
    assert decl.count(",") + 1 == len(args)


def test_key_npz_roundtrip_keeps_the_jax_format(tmp_path):
    from distributed_groth16_tpu_torch.models.groth16 import ProvingKey

    key = _tiny_key()
    key.a_query[0, 1, 0] = 7
    key.save(str(tmp_path / "k.npz"))
    with np.load(tmp_path / "k.npz") as d:
        assert d["a_query"].dtype == np.uint32
        assert d["meta"].dtype == np.int64
        assert sorted(d.files) == sorted([
            "meta", "vk", "beta_g1", "delta_g1", "a_query", "b_g1_query",
            "b_g2_query", "h_query", "l_query",
        ])
    back = ProvingKey.load(str(tmp_path / "k.npz"), device="cpu")
    assert back.a_query.dtype == torch.int32
    assert torch.equal(back.a_query, key.a_query)
    assert back.vk == key.vk


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py alone, or on a machine without a card, exits non-zero
    and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
