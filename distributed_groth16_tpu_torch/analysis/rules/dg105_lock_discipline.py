"""DG105 — lock discipline for ``# guarded-by:`` annotated attributes.

Shared mutable state in the service/telemetry layers is documented at
the declaration site::

    self._events = []  # guarded-by: _lock

and this rule enforces the annotation: any *mutation* of ``self._events``
(assignment, augmented assignment, ``del``, item assignment, or a
mutating method call — append/pop/update/...) anywhere in the class must
sit lexically inside ``with self._lock:``. ``__init__`` is exempt
(construction happens-before sharing). Reads are not checked — many are
intentionally racy snapshots; the annotation is about lost updates.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, Module, Project, rule

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "add",
    "setdefault", "sort",
}


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _guarded_attrs(cls: ast.ClassDef, module: Module) -> dict[str, str]:
    """{attr: lock_attr} from `# guarded-by:` comments on `self.X = ...`
    lines anywhere in the class body (typically __init__)."""
    out: dict[str, str] = {}
    for node in ast.walk(cls):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        m = _GUARD_RE.search(module.line_text(node.lineno))
        if not m:
            continue
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out[attr] = m.group(1)
    return out


def _held_locks(module: Module, node: ast.AST, fn: ast.AST) -> set[str]:
    """Lock attrs of `self` held via `with self.X:` around `node`,
    walking ancestors up to (and excluding) the enclosing function."""
    held: set[str] = set()
    for anc in module.ancestors(node):
        if anc is fn:
            break
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                attr = _self_attr(item.context_expr)
                if attr is not None:
                    held.add(attr)
    return held


def _mutations(fn: ast.AST) -> Iterator[tuple[str, ast.AST, str]]:
    """(attr, node, how) for every mutation of a self attribute in fn."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    yield attr, node, "assignment"
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr is not None:
                        yield attr, node, "item assignment"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    yield attr, node, "del"
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr is not None:
                        yield attr, node, "item del"
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
            ):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    yield attr, node, f".{node.func.attr}()"


@rule(
    "DG105",
    "lock-discipline",
    "An attribute annotated `# guarded-by: _lock` is mutated outside "
    "`with self._lock:` — a lost-update race under the thread pool / "
    "event-loop mix.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    assert module.tree is not None
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = _guarded_attrs(cls, module)
        if not guarded:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            for attr, node, how in _mutations(fn):
                lock = guarded.get(attr)
                if lock is None:
                    continue
                if lock in _held_locks(module, node, fn):
                    continue
                yield Finding(
                    module.relpath,
                    node.lineno,
                    node.col_offset,
                    "DG105",
                    f"{how} of `self.{attr}` (guarded-by: {lock}) outside "
                    f"`with self.{lock}:` in {cls.name}.{fn.name}",
                )
