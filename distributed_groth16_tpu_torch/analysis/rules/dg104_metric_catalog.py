"""DG104 — metric-catalog drift.

docs/torch/OBSERVABILITY.md, the port's copy of the JAX package's
docs/OBSERVABILITY.md catalog, is the contract dashboards and alerts are built
against; a series registered in code but missing from the catalog is
invisible to operators, and a catalog row whose series no longer exists
is an alert that can never fire. This rule parses both sides:

  * code: every ``registry().counter/gauge/histogram("name", help,
    (labels...))`` call with a literal name;
  * docs: every catalog table row (4+ cells whose Type cell is
    counter/gauge/histogram; the Series cell may hold ``a`` / ``b``
    pairs).

and reports name drift in both directions plus type/label-set
mismatches.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, Module, Project, call_kw, rule, str_const

_KINDS = {"counter", "gauge", "histogram"}
_CATALOG_DOC = "docs/torch/OBSERVABILITY.md"
_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")
_LABEL_RE = re.compile(r"`([a-zA-Z_][a-zA-Z0-9_]*)`")


def _labels_from(node: ast.AST | None) -> tuple | None:
    """Literal label tuple, () for absent, None for non-literal."""
    if node is None:
        return ()
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            s = str_const(el)
            if s is None:
                return None
            out.append(s)
        return tuple(out)
    return None


def registrations(module: Module) -> Iterator[tuple[str, str, tuple | None, int, int]]:
    """(name, kind, labels-or-None, line, col) per metric registration."""
    assert module.tree is not None
    for node in ast.walk(module.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _KINDS
        ):
            continue
        name = str_const(node.args[0]) if node.args else None
        if name is None:
            continue
        labels_node = (
            node.args[2] if len(node.args) >= 3 else call_kw(node, "labelnames")
        )
        yield (
            name,
            node.func.attr,
            _labels_from(labels_node),
            node.lineno,
            node.col_offset,
        )


def parse_catalog(text: str) -> dict[str, tuple[str, tuple, int]]:
    """{series: (kind, labels, line)} from the markdown catalog tables."""
    out: dict[str, tuple[str, tuple, int]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) < 4 or cells[1] not in _KINDS:
            continue
        labels = tuple(_LABEL_RE.findall(cells[2]))
        for name in _NAME_RE.findall(cells[0]):
            out[name] = (cells[1], labels, lineno)
    return out


@rule(
    "DG104",
    "metric-catalog drift",
    "Metric series registered in code must match the "
    "docs/torch/OBSERVABILITY.md catalog — name, type, and label set, in "
    "both directions.",
    project_wide=True,
)
def check_project(project: Project) -> Iterator[Finding]:
    text = project.doc_text(_CATALOG_DOC)
    if text is None:
        return  # fixture trees without docs: rule is inert
    catalog = parse_catalog(text)

    registered: dict[str, tuple[str, tuple | None, str, int, int]] = {}
    for mod in project.modules:
        if mod.tree is None:
            continue
        for name, kind, labels, line, col in registrations(mod):
            registered.setdefault(name, (kind, labels, mod.relpath, line, col))

    for name, (kind, labels, relpath, line, col) in sorted(registered.items()):
        row = catalog.get(name)
        if row is None:
            yield Finding(
                relpath, line, col, "DG104",
                f"metric `{name}` is registered in code but has no row in "
                f"{_CATALOG_DOC} — add it to the catalog",
            )
            continue
        doc_kind, doc_labels, _ = row
        if doc_kind != kind:
            yield Finding(
                relpath, line, col, "DG104",
                f"metric `{name}` is a {kind} in code but a {doc_kind} in "
                f"{_CATALOG_DOC}",
            )
        if labels is not None and tuple(sorted(labels)) != tuple(
            sorted(doc_labels)
        ):
            yield Finding(
                relpath, line, col, "DG104",
                f"metric `{name}` labels {sorted(labels)} in code but "
                f"{sorted(doc_labels)} in {_CATALOG_DOC}",
            )

    for name, (_, _, lineno) in sorted(catalog.items()):
        if name not in registered:
            yield Finding(
                _CATALOG_DOC, lineno, 0, "DG104",
                f"catalog row `{name}` has no registration in the scanned "
                "code — dead series, delete the row (or lint the module "
                "that registers it)",
            )
