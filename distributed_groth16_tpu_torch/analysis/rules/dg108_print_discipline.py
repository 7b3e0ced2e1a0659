"""DG108 — ``print()`` in package code.

The logging spine (telemetry/logbus.py) only sees records that go
through the stdlib ``logging`` tree: a ``print()`` bypasses the ring,
the level filter, the storm suppressor, the secret redactor, and every
query surface (`GET /logs`, the job DTO tail, flight dumps) at once. In
a service whose debugging story is "give me the job's correlated log
stream", an un-ringed print is telemetry that silently never happened.

Allowed:
  * CLI surfaces — modules named ``cli.py`` / ``__main__.py``, where
    stdout IS the product;
  * code lexically inside a function named ``main`` (the argparse entry
    points of benchgate.py, certs.py, ...);
  * deliberate stdout emitters carrying ``# dg16lint: disable=DG108``.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from ..core import Finding, Module, Project, rule

_CLI_BASENAMES = {"cli.py", "__main__.py"}
_CLI_FUNCS = {"main"}


def _prints(node: ast.AST, allowed: bool) -> Iterator[ast.Call]:
    for child in ast.iter_child_nodes(node):
        child_allowed = allowed or (
            isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            and child.name in _CLI_FUNCS
        )
        if (
            not child_allowed
            and isinstance(child, ast.Call)
            and isinstance(child.func, ast.Name)
            and child.func.id == "print"
        ):
            yield child
        yield from _prints(child, child_allowed)


@rule(
    "DG108",
    "print-discipline",
    "print() in package code bypasses the logging spine — the record "
    "never reaches the ring, GET /logs, the job DTO tail, or a flight "
    "dump. Use a module logger; CLI entry points (cli.py, __main__.py, "
    "functions named main) are exempt.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    assert module.tree is not None
    if os.path.basename(module.relpath) in _CLI_BASENAMES:
        return
    for call in _prints(module.tree, False):
        yield Finding(
            module.relpath,
            call.lineno,
            call.col_offset,
            "DG108",
            "print() in package code never reaches the structured log "
            "ring — use `log = logging.getLogger(__name__)` so the "
            "record is queryable (or justify with a disable comment)",
        )
