"""DG101 — blocking calls inside ``async def``.

The service layer is one event loop shared by every job's admission,
heartbeats, and cancellation; a single synchronous ``time.sleep`` /
file read / ``block_until_ready`` in a coroutine stalls all of them at
once (the ProdNet heartbeat CAVEAT in utils/config.py is this failure
mode observed from the other side). Blocking work belongs behind
``asyncio.to_thread`` / ``run_in_executor`` — calls inside *nested*
(non-async) functions are exempt because closures are exactly what gets
handed to an executor.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, Module, Project, dotted_name, rule

# exact dotted names that block the loop
_EXACT = {
    "time.sleep",
    "os.system",
    "os.popen",
    "os.wait",
    "os.waitpid",
    "socket.socket",
    "socket.create_connection",
    "urllib.request.urlopen",
    "asyncio.run",
}
# any call under these module prefixes blocks
_PREFIXES = ("subprocess.", "requests.")
# method names that block regardless of receiver (device syncs, loops)
_METHODS = {"block_until_ready", "run_until_complete"}
# bare builtins that do synchronous file IO
_BUILTINS = {"open"}


def _blocking_reason(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name is not None:
        if name in _EXACT:
            return name
        if any(name.startswith(p) for p in _PREFIXES):
            return name
        if name in _BUILTINS:
            return name
    if isinstance(call.func, ast.Attribute) and call.func.attr in _METHODS:
        return call.func.attr
    return None


def _own_scope_walk(fn: ast.AsyncFunctionDef) -> Iterator[ast.AST]:
    """Nodes executed in the coroutine's own frame: prune nested defs and
    lambdas (run elsewhere) but keep comprehensions and loop bodies."""
    stack: list[ast.AST] = []
    for stmt in fn.body:
        stack.append(stmt)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


@rule(
    "DG101",
    "async-blocking",
    "Blocking call (time.sleep, sync file/socket IO, subprocess, "
    "block_until_ready) directly inside an `async def` — stalls the whole "
    "event loop; wrap it in asyncio.to_thread / run_in_executor.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    assert module.tree is not None
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for sub in _own_scope_walk(node):
            if not isinstance(sub, ast.Call):
                continue
            reason = _blocking_reason(sub)
            if reason is None:
                continue
            yield Finding(
                module.relpath,
                sub.lineno,
                sub.col_offset,
                "DG101",
                f"blocking call {reason}() inside `async def {node.name}` "
                "— move it to asyncio.to_thread / run_in_executor",
            )
