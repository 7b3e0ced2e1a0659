"""DG103 — DG16_* env-knob discipline.

One authoritative config surface: every ``DG16_*`` knob is declared in
``utils/config.py`` (the KNOBS registry) and read through its typed
accessors. A raw ``os.environ`` read anywhere else re-scatters the
config system the service/scheduler PRs centralized — and a knob nobody
documented is a knob nobody can operate. Two checks:

  (a) per-module: ``os.environ.get/[]``, ``os.getenv``, or
      ``"DG16_X" in os.environ`` with a DG16_* literal outside
      utils/config.py;
  (b) project-wide: every DG16_* literal in utils/config.py must appear
      in README.md or docs/*.md.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, Module, Project, dotted_name, rule, str_const

# THE config module, at the repo layout's two spellings (package checkout
# vs a fixture tree rooted above utils/) — deliberately not a bare
# endswith: `scheduler/myutils/config.py` must NOT inherit the exemption
_CONFIG_PATHS = (
    "utils/config.py",
    "distributed_groth16_tpu_torch/utils/config.py",
)


def _is_config_module(relpath: str) -> bool:
    return relpath in _CONFIG_PATHS


def _env_read_key(node: ast.AST) -> str | None:
    """The string key of an environ read expression, if literal."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in ("os.environ.get", "environ.get", "os.getenv", "getenv"):
            return str_const(node.args[0]) if node.args else None
    if isinstance(node, ast.Subscript):
        base = dotted_name(node.value)
        if base in ("os.environ", "environ"):
            return str_const(node.slice)
    if isinstance(node, ast.Compare):
        base = node.comparators and dotted_name(node.comparators[0])
        if (
            len(node.ops) == 1
            and isinstance(node.ops[0], (ast.In, ast.NotIn))
            and base in ("os.environ", "environ")
        ):
            return str_const(node.left)
    return None


@rule(
    "DG103",
    "env-knob discipline",
    "DG16_* environment reads outside utils/config.py (declare the knob "
    "in config.KNOBS and read it via config.env_str/env_flag/env_int/"
    "env_float), and knobs declared but documented nowhere under docs/.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    if _is_config_module(module.relpath):
        return
    assert module.tree is not None
    for node in ast.walk(module.tree):
        key = _env_read_key(node)
        if key is not None and key.startswith("DG16_"):
            yield Finding(
                module.relpath,
                node.lineno,
                node.col_offset,
                "DG103",
                f"raw environment read of {key} outside utils/config.py — "
                "declare it in config.KNOBS and read it via the typed "
                "config.env_* accessors",
            )


@rule(
    "DG103",
    "env-knob discipline",
    "(project half — declared-but-undocumented knobs)",
    project_wide=True,
)
def check_project(project: Project) -> Iterator[Finding]:
    cfg = next(
        (m for m in project.modules if _is_config_module(m.relpath)), None
    )
    if cfg is None or cfg.tree is None:
        return

    docs_text = ""
    for rel in ("README.md",):
        docs_text += project.doc_text(rel) or ""
    docs_dir = project.root / "docs"
    if docs_dir.is_dir():
        for p in sorted(docs_dir.glob("*.md")):
            try:
                docs_text += p.read_text()
            except OSError:
                pass

    seen: set[str] = set()
    for node in ast.walk(cfg.tree):
        if not (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value.startswith("DG16_")
        ):
            continue
        knob = node.value
        if knob in seen:
            continue
        seen.add(knob)
        # word-boundary match: DG16_TRACE must not count as documented
        # just because DG16_TRACE_OUT has a row
        if not re.search(rf"{re.escape(knob)}(?![A-Z0-9_])", docs_text):
            yield Finding(
                cfg.relpath,
                node.lineno,
                node.col_offset,
                "DG103",
                f"knob {knob} is declared in utils/config.py but "
                "documented in neither README.md nor docs/*.md — "
                "an operator cannot discover it",
            )
