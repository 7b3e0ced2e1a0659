"""Rule framework: findings, module/project model, registry, suppressions.

Deliberately stdlib-only (ast + re + pathlib): the lint must run on a
bare interpreter — ``tools/dg16lint.py`` loads it without torch
installed — so nothing in ``analysis/`` may import the rest of the
package. Rules that need project context (docs files, utils/config.py)
read those files as text/AST, never import them.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator

# -- findings ----------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Finding:
    """One lint hit. `line` is 1-based (0 = whole file), `col` 0-based."""

    path: str  # project-root-relative posix path
    line: int
    col: int
    rule: str  # "DG101"
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"


# -- suppressions ------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*dg16lint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\s]+)"
)


def _parse_suppressions(lines: list[str]) -> tuple[dict[int, set], set]:
    """Per-line {lineno: {rule ids}} and the whole-file suppression set.
    The id ``all`` wildcards every rule."""
    per_line: dict[int, set] = {}
    per_file: set = set()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {t.strip().upper() for t in m.group(2).split(",") if t.strip()}
        if m.group(1) == "disable-file":
            per_file |= ids
        else:
            per_line.setdefault(i, set()).update(ids)
    return per_line, per_file


# -- module / project model --------------------------------------------------


class Module:
    """One parsed source file: path, text, AST, lazy parent map."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.parse_error: SyntaxError | None = None
        try:
            self.tree: ast.Module | None = ast.parse(source)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        self._parents: dict[ast.AST, ast.AST] | None = None
        self.suppress_line, self.suppress_file = _parse_suppressions(self.lines)

    def parent(self, node: ast.AST) -> ast.AST | None:
        if self._parents is None:
            self._parents = {}
            if self.tree is not None:
                for p in ast.walk(self.tree):
                    for c in ast.iter_child_nodes(p):
                        self._parents[c] = p
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        p = self.parent(node)
        while p is not None:
            yield p
            p = self.parent(p)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        for ids in (
            self.suppress_file,
            self.suppress_line.get(lineno, ()),
        ):
            if rule_id in ids or "ALL" in ids:
                return True
        return False


class Project:
    """The scanned tree: a root dir (holding docs/, the package, ...) and
    the parsed modules under the target paths."""

    def __init__(self, root: Path, modules: list[Module]):
        self.root = root
        self.modules = modules

    def module(self, relpath_suffix: str) -> Module | None:
        for m in self.modules:
            if m.relpath.endswith(relpath_suffix):
                return m
        return None

    def doc_text(self, relpath: str) -> str | None:
        p = self.root / relpath
        try:
            return p.read_text()
        except OSError:
            return None


# -- rule registry -----------------------------------------------------------


@dataclass
class Rule:
    id: str
    name: str
    doc: str
    # per-module hook: (module, project) -> findings
    check_module: Callable | None = None
    # once-per-run hook: (project) -> findings
    check_project: Callable | None = None


_RULES: dict[str, Rule] = {}


def rule(id: str, name: str, doc: str, *, project_wide: bool = False):
    """Register the decorated checker under `id`. The checker is the
    per-module hook unless `project_wide`, then it runs once per project."""

    def wrap(fn):
        r = _RULES.get(id) or Rule(id, name, doc)
        if project_wide:
            r.check_project = fn
        else:
            r.check_module = fn
        _RULES[id] = r
        return fn

    return wrap


def all_rules() -> dict[str, Rule]:
    from . import rules  # noqa: F401 — importing registers every DG1xx

    return dict(_RULES)


# -- file walking + runner ---------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", "node_modules"}


def iter_py_files(target: Path) -> Iterator[Path]:
    if target.is_file():
        if target.suffix == ".py":
            yield target
        return
    for p in sorted(target.rglob("*.py")):
        # judge only components below the scan target: an ancestor like
        # ~/.jenkins must not silently blank the whole run
        parts = p.relative_to(target).parts
        if not any(part in _SKIP_DIRS or part.startswith(".") for part in parts):
            yield p


def find_root(target: Path) -> Path:
    """Project root: nearest ancestor (incl. target) carrying repo
    markers; else the target's parent directory."""
    t = target if target.is_dir() else target.parent
    for d in (t, *t.parents):
        if (d / "pytest.ini").exists() or (d / ".git").exists() or (
            d / "docs"
        ).is_dir():
            return d
    return t


def load_project(paths: Iterable[Path], root: Path | None = None) -> Project:
    paths = [Path(p) for p in paths]
    root = Path(root) if root is not None else find_root(paths[0])
    modules: list[Module] = []
    seen: set = set()
    for target in paths:
        for f in iter_py_files(target):
            f = f.resolve()
            if f in seen:
                continue
            seen.add(f)
            try:
                rel = f.relative_to(root.resolve()).as_posix()
            except ValueError:
                rel = f.as_posix()
            try:
                modules.append(Module(f, rel, f.read_text()))
            except (OSError, UnicodeDecodeError) as e:
                m = Module(f, rel, "")
                m.parse_error = SyntaxError(f"unreadable: {e}")
                modules.append(m)
    return Project(root, modules)


def run_rules(
    project: Project, select: set | None = None
) -> tuple[list[Finding], int]:
    """All unsuppressed findings (sorted) + the count suppressed inline."""
    rules = all_rules()
    if select:
        rules = {k: v for k, v in rules.items() if k in select}
    raw: list[Finding] = []
    for mod in project.modules:
        if mod.parse_error is not None:
            raw.append(
                Finding(
                    mod.relpath,
                    getattr(mod.parse_error, "lineno", 0) or 0,
                    0,
                    "DG000",
                    f"could not parse file: {mod.parse_error.msg}",
                )
            )
            continue
        for r in rules.values():
            if r.check_module is not None:
                raw.extend(r.check_module(mod, project))
    for r in rules.values():
        if r.check_project is not None:
            raw.extend(r.check_project(project))

    by_rel = {m.relpath: m for m in project.modules}
    findings: list[Finding] = []
    suppressed = 0
    for f in raw:
        mod = by_rel.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            suppressed += 1
            continue
        findings.append(f)
    return sorted(set(findings)), suppressed


# -- shared AST helpers (used by several rules) ------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains; None for anything dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.AST | None) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def call_kw(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk, but do not descend into nested function/lambda bodies
    (their execution context is the caller's, not this scope's)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
