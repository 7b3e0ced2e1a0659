"""The port's dg16lint (distributed_groth16_tpu_torch/analysis/) against
the JAX package's analysis/.

The port's analysis is a copy of the JAX one pointed at the port: its
default target, its config module (DG103), its metric catalog
docs/torch/OBSERVABILITY.md (DG104) and its baseline. On one positive and
one negative source per rule, written to tmp_path, both give the same
findings (rule, line, column, message) once the catalog's path is set
aside. The port's catalog is the JAX catalog row for row but the named
departures, and the port lints clean with an empty baseline. Both
analyses load by file path, as their stdlib launchers do, so this file
imports neither package.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_ANALYSIS = ROOT / "distributed_groth16_tpu_torch" / "analysis"
JAX_ANALYSIS = ROOT / "distributed_groth16_tpu" / "analysis"
PORT_CATALOG = "docs/torch/OBSERVABILITY.md"
JAX_CATALOG = "docs/OBSERVABILITY.md"
# catalog rows where the port departs from the JAX package (README and
# ROADMAP "Known departures"): the build-info gauge's labels
DEPARTURES = {"dg16_build_info"}


def _load(pkg_dir: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mod.all_rules()  # imports the rules subpackage
    return mod


PORT = _load(PORT_ANALYSIS, "dg16lint_torch_under_test")
JAX = _load(JAX_ANALYSIS, "dg16lint_jax_under_test")

CATALOG = """
| Series | Type | Labels | Meaning |
| --- | --- | --- | --- |
| `frames_total` | counter | `peer` | Frames shipped per peer. |
| `queue_depth` | gauge |  | Jobs waiting. |
"""

# rule -> (positive sources, negative sources), each {relpath: source}
CASES = {
    "DG101": ({"pkg/mod.py": """
        import subprocess
        import time

        async def pump(path):
            time.sleep(0.1)
            open(path).read()
            subprocess.run(["true"])
        """}, {"pkg/mod.py": """
        import asyncio
        import time

        async def pump():
            await asyncio.sleep(0.1)

        def sync_path():
            time.sleep(0.1)
        """}),
    "DG102": ({"pkg/mod.py": """
        def f(witness_share, log, span, fam, pk, secret_id):
            log.debug("share=%s", witness_share)
            with span("pack", beta=witness_share):
                pass
            fam.labels(secret_id).inc()
            return pack_proving_key(pk)
        """}, {"pkg/mod.py": """
        def f(num_witness, log, pk):
            log.debug("wires=%d", num_witness)
            return pack_proving_key(pk, strip=True)
        """}),
    "DG103": ({"pkg/mod.py": """
        import os

        FLAG = os.environ.get("DG16_TEST_KNOB")
        OTHER = os.getenv("DG16_OTHER_KNOB", "1")
        HAS = "DG16_THIRD" in os.environ
        """, "utils/config.py": """
        KNOBS = {"DG16_SOMETHING": "does a thing"}
        """}, {"pkg/mod.py": """
        from utils.config import env_str

        FLAG = env_str("DG16_SOMETHING")
        """, "utils/config.py": """
        KNOBS = {"DG16_SOMETHING": "does a thing"}
        """, "README.md": "Set `DG16_SOMETHING=1` to do a thing.\n"}),
    "DG104": ({"pkg/mod.py": """
        def setup(reg):
            reg.counter("frames_total", "frames", ("sid",))
            reg.histogram("orphan_seconds", "not in the catalog")
        """, "@catalog": CATALOG}, {"pkg/mod.py": """
        def setup(reg):
            reg.counter("frames_total", "frames", ("peer",))
            reg.gauge("queue_depth", "jobs")
        """, "@catalog": CATALOG}),
    "DG105": ({"pkg/mod.py": """
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._events = []  # guarded-by: _lock

            def push(self, e):
                self._events.append(e)

            def reset(self):
                self._events = []
        """}, {"pkg/mod.py": """
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._events = []  # guarded-by: _lock

            def push(self, e):
                with self._lock:
                    self._events.append(e)
        """}),
    "DG106": ({"pkg/mod.py": """
        import functools

        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x

        @functools.partial(jax.jit, static_argnums=(1,))
        def g(x, n):
            while x.sum() > n:
                x = x - 1
            return x
        """}, {"pkg/mod.py": """
        import jax

        @jax.jit
        def f(x):
            if x.shape[0] == 4:
                return x
            return -x

        def plain(x):
            if x > 0:
                return x
            return -x
        """}),
    "DG107": ({"pkg/mod.py": """
        async def exchange(net, xs):
            if net.is_king:
                return await net.gather_to_king(xs, 1)
            else:
                return xs

        async def relay(net, data):
            if net.is_king:
                await net.send_to(1, data, sid=0)
            else:
                await net.recv_from(0, sid=2)
        """}, {"pkg/mod.py": """
        async def exchange(net, xs):
            out = await net.gather_to_king(xs, 1)
            return out

        async def relay(net, data):
            if net.is_king:
                await net.send_to(1, data, sid=0)
            else:
                await net.recv_from(0, sid=0)
        """}),
    "DG108": ({"pkg/mod.py": """
        def helper(x):
            print(x)
        """}, {"pkg/mod.py": """
        import logging

        log = logging.getLogger(__name__)

        def helper(x):
            log.info("x=%s", x)

        def main():
            print("the CLI's output")
        """, "pkg/cli.py": """
        print("stdout is the product")
        """}),
}


def _findings(analysis, root: Path, files: dict, catalog: str, rule: str):
    for rel, text in files.items():
        p = root / (catalog if rel == "@catalog" else rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    project = analysis.core.load_project([root], root)
    found, suppressed = analysis.core.run_rules(project, {rule})
    return [(f.rule, f.path.replace(catalog, "@catalog"), f.line, f.col,
             f.message.replace(catalog, "@catalog")) for f in found]


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_findings_equal_the_jax_analysis(rule, tmp_path):
    """The positive source fires, the negative is clean, and the port's
    findings are the JAX analysis's, line, column and message."""
    for i, files in enumerate(CASES[rule]):
        got = _findings(PORT, tmp_path / f"port{i}", files, PORT_CATALOG,
                        rule)
        want = _findings(JAX, tmp_path / f"jax{i}", files, JAX_CATALOG, rule)
        assert got == want
        assert bool(got) == (i == 0), got


def _table_rows(path: Path) -> list[str]:
    """The catalog's rows: table lines whose Type cell names a kind."""
    return [line for line in path.read_text().splitlines()
            if line.startswith("|") and line.split("|")[2].strip()
            in ("counter", "gauge", "histogram")]


def test_catalog_equals_the_jax_catalog_but_its_departures():
    port_rows = _table_rows(ROOT / PORT_CATALOG)
    jax_rows = _table_rows(ROOT / JAX_CATALOG)
    name = PORT.rules.dg104_metric_catalog._NAME_RE
    assert len(port_rows) == len(jax_rows)
    differ = set()
    for got, want in zip(port_rows, jax_rows):
        series = name.findall(got.split("|")[1])
        assert series == name.findall(want.split("|")[1])
        if got != want:
            differ.update(series)
    assert differ == DEPARTURES
    port = PORT.rules.dg104_metric_catalog.parse_catalog(
        (ROOT / PORT_CATALOG).read_text())
    jax = JAX.rules.dg104_metric_catalog.parse_catalog(
        (ROOT / JAX_CATALOG).read_text())
    assert set(port) == set(jax)
    assert {k: v[:2] for k, v in port.items() if k not in DEPARTURES} == \
        {k: v[:2] for k, v in jax.items() if k not in DEPARTURES}
    assert port["dg16_build_info"][:2] == (
        "gauge", ("version", "torch", "cuda", "backend", "device"))


def test_analysis_loads_without_jax_torch_or_either_package():
    code = (
        "import importlib.util, sys\n"
        f"d = {str(PORT_ANALYSIS)!r}\n"
        "spec = importlib.util.spec_from_file_location('a', d + '/__init__.py',"
        " submodule_search_locations=[d])\n"
        "m = importlib.util.module_from_spec(spec); sys.modules['a'] = m\n"
        "spec.loader.exec_module(m)\n"
        "assert sorted(m.all_rules()) == "
        "['DG101', 'DG102', 'DG103', 'DG104', 'DG105', 'DG106', 'DG107', "
        "'DG108']\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'torch', 'numpy', 'distributed_groth16_tpu', "
        "'distributed_groth16_tpu_torch')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_lints_clean_with_an_empty_baseline(tmp_path):
    """`python -m distributed_groth16_tpu_torch.analysis --strict` exits 0
    over the port, and the committed baseline grandfathers nothing; the
    stdlib launcher gives the same verdict."""
    baseline = ROOT / PORT.baseline.DEFAULT_BASELINE
    assert json.loads(baseline.read_text())["findings"] == []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    report = tmp_path / "report.json"
    for cmd in ([sys.executable, "-m", "distributed_groth16_tpu_torch.analysis",
                 "--strict", "--json", str(report)],
                [sys.executable,
                 "distributed_groth16_tpu_torch/tools/dg16lint.py",
                 "--strict"]):
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "0 new finding(s), 0 baselined" in out.stdout
    doc = json.loads(report.read_text())
    assert doc["counts"]["new"] == doc["counts"]["baselined"] == 0
    assert doc["staleBaseline"] == []
