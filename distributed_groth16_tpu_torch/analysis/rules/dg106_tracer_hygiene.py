"""DG106 — tracer hygiene in jitted functions.

``if``/``while``/``bool()``/``assert`` on a *value* derived from a
parameter of a ``jax.jit`` / ``mesh_jit`` / ``shard_map`` function
forces a trace-time concretization: under jit it either raises a
ConcretizationTypeError or — worse, with weak typing through ``int()``
or numpy coercion — silently bakes one branch into the compiled program
and recompiles per value, the "jitted code falling back to Python
control flow" failure mode the kernel roadmap work must not reintroduce.

Shape/dtype-derived branching (``x.shape[0] == 4``, ``x.ndim``,
``len(x)``) is static under tracing and exempt, as are parameters named
by ``static_argnums`` / ``static_argnames``. Jitted functions are found
by decorator (including ``functools.partial(jax.jit, ...)``) and by
same-module wrapper calls (``jax.jit(f)``, ``mesh_jit("name", f)``,
``shard_map(f, ...)``).

The PyTorch port jits nothing, so over its package the rule finds no
jitted function and reports nothing; it stays so that a jit wrapper
added later is held to the same hygiene.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, Module, Project, call_kw, dotted_name, rule

_JIT_NAMES = {"jit", "pjit", "mesh_jit", "timed_jit", "shard_map"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
_STATIC_CALLS = {"len", "isinstance"}


def _is_jit_ref(node: ast.AST) -> bool:
    name = dotted_name(node)
    return name is not None and name.split(".")[-1] in _JIT_NAMES


def _static_params(call: ast.Call, fn: ast.arguments) -> set[str]:
    """Parameter names excluded from tracing via static_argnums/names."""
    out: set[str] = set()
    posnames = [a.arg for a in fn.posonlyargs + fn.args]
    nums = call_kw(call, "static_argnums")
    items = []
    if isinstance(nums, ast.Constant):
        items = [nums.value]
    elif isinstance(nums, (ast.Tuple, ast.List)):
        items = [e.value for e in nums.elts if isinstance(e, ast.Constant)]
    for i in items:
        if isinstance(i, int) and 0 <= i < len(posnames):
            out.add(posnames[i])
    names = call_kw(call, "static_argnames")
    elts = []
    if isinstance(names, ast.Constant):
        elts = [names]
    elif isinstance(names, (ast.Tuple, ast.List)):
        elts = list(names.elts)
    for e in elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            out.add(e.value)
    return out


def _jitted_functions(
    module: Module,
) -> Iterator[tuple[ast.FunctionDef, set[str]]]:
    """(function, static-param-names) for every jit-compiled function:
    decorated directly, via functools.partial(jax.jit, ...), or passed to
    a jit wrapper call elsewhere in the module."""
    assert module.tree is not None
    defs: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.FunctionDef):
            defs.setdefault(node.name, node)

    seen: set[ast.FunctionDef] = set()

    for node in ast.walk(module.tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                static: set[str] = set()
                target = dec
                if isinstance(dec, ast.Call):
                    fn_name = dotted_name(dec.func)
                    if fn_name is not None and fn_name.split(".")[-1] == "partial":
                        if dec.args and _is_jit_ref(dec.args[0]):
                            static = _static_params(dec, node.args)
                            target = dec.args[0]
                        else:
                            continue
                    else:
                        static = _static_params(dec, node.args)
                        target = dec.func
                if _is_jit_ref(target) and node not in seen:
                    seen.add(node)
                    yield node, static
        elif isinstance(node, ast.Call) and _is_jit_ref(node.func):
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in defs:
                    fn = defs[arg.id]
                    if fn not in seen:
                        seen.add(fn)
                        yield fn, _static_params(node, fn.args)


def _value_refs(expr: ast.AST, tainted: set[str], module: Module) -> set[str]:
    """Tainted names referenced *by value* in expr — occurrences whose
    every use is via .shape/.ndim/.dtype/.size or len() are static and
    don't count."""
    hits: set[str] = set()
    parents: dict[ast.AST, ast.AST] = {}
    for p in ast.walk(expr):
        for c in ast.iter_child_nodes(p):
            parents[c] = p
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Name) and node.id in tainted):
            continue
        parent = parents.get(node)
        if isinstance(parent, ast.Attribute) and parent.attr in _STATIC_ATTRS:
            continue
        if isinstance(parent, ast.Call) and parent.func is not node:
            fname = dotted_name(parent.func)
            if fname in _STATIC_CALLS:
                continue
        hits.add(node.id)
    return hits


def _check_fn(
    fn: ast.FunctionDef, static: set[str], module: Module
) -> Iterator[Finding]:
    args = fn.args
    tainted = {
        a.arg
        for a in args.posonlyargs + args.args + args.kwonlyargs
        if a.arg not in static and a.arg != "self"
    }
    if args.vararg:
        tainted.add(args.vararg.arg)

    def visit(body: list[ast.stmt]):
        for stmt in body:
            # propagate taint through simple assignments, in order
            if isinstance(stmt, ast.Assign) and _value_refs(
                stmt.value, tainted, module
            ):
                for t in stmt.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            tainted.add(sub.id)
            test = None
            what = None
            if isinstance(stmt, (ast.If, ast.While)):
                test, what = stmt.test, type(stmt).__name__.lower()
            elif isinstance(stmt, ast.Assert):
                test, what = stmt.test, "assert"
            if test is not None:
                for name in sorted(_value_refs(test, tainted, module)):
                    yield Finding(
                        module.relpath, stmt.lineno, stmt.col_offset,
                        "DG106",
                        f"Python `{what}` on traced value `{name}` inside "
                        f"jitted `{fn.name}` — use jnp.where/lax.cond or "
                        "make it a static argument",
                    )
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.Call):
                    fname = dotted_name(sub.func)
                    if fname == "bool":
                        for name in sorted(
                            _value_refs(sub, tainted, module)
                        ):
                            yield Finding(
                                module.relpath, sub.lineno, sub.col_offset,
                                "DG106",
                                f"bool() on traced value `{name}` inside "
                                f"jitted `{fn.name}` — concretizes at "
                                "trace time",
                            )
            # recurse into nested blocks (same taint scope)
            for field_name in ("body", "orelse", "finalbody"):
                sub_body = getattr(stmt, field_name, None)
                if sub_body and not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    yield from visit(sub_body)
            for handler in getattr(stmt, "handlers", []) or []:
                yield from visit(handler.body)

    yield from visit(fn.body)


@rule(
    "DG106",
    "tracer-hygiene",
    "Python if/while/bool/assert on a value derived from a jitted "
    "function's traced parameters — concretization error or silent "
    "per-value recompilation; shape/dtype/static-arg branching is exempt.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    for fn, static in _jitted_functions(module):
        yield from _check_fn(fn, static, module)
