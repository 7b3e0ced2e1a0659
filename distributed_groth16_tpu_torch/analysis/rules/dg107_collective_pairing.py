"""DG107 — king/client collective pairing (static MPC deadlock detector).

The star collectives are rendezvous points: ``gather_to_king`` /
``scatter_from_king`` / ``king_compute`` / ``broadcast_from_king`` must
be entered by *every* party, and a king-side ``send_to`` must meet a
client-side ``recv_from`` on the same logical channel
(``sid`` — the MultiplexedStreamID). A function that branches on
``is_king`` and calls a symmetric collective on only one side, or whose
directional sends/recvs don't pair across the branch, hangs the whole
star until the op deadline fires — the bug class the transport's chaos suite
catches dynamically, caught here at parse time.

Per ``if <...is_king...>`` statement (``not`` swaps the branches; an
early-``return`` king body treats the block's tail as the client side)
the rule compares the two branches' collective call multisets:

  * a symmetric collective present on one side and absent from the
    other → finding;
  * king ``send_to`` without client ``recv_from`` (and vice versa,
    king ``recv_from`` without client ``send_to``) → finding;
  * when every ``sid`` involved is a literal and no loop multiplies the
    calls, the literal ``sid`` multisets must match too.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator

from ..core import Finding, Module, Project, call_kw, rule

_SYMMETRIC = (
    "gather_to_king",
    "scatter_from_king",
    "king_compute",
    "broadcast_from_king",
)
_DIRECTIONAL = ("send_to", "recv_from")
# positional index of `sid` in each collective's signature
_SID_POS = {
    "send_to": 2,
    "recv_from": 1,
    "gather_to_king": 1,
    "scatter_from_king": 1,
    "king_compute": 2,
    "broadcast_from_king": 1,
}


@dataclass
class Coll:
    op: str
    sid: int | None  # literal sid, None when dynamic or defaulted-0? (0)
    line: int
    col: int
    in_loop: bool


def _sid_of(call: ast.Call, op: str) -> int | None:
    node = call_kw(call, "sid")
    pos = _SID_POS[op]
    if node is None and len(call.args) > pos:
        node = call.args[pos]
    if node is None:
        return 0  # every collective defaults sid=0
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _collect(body: list[ast.stmt], in_loop: bool = False) -> list[Coll]:
    """Collective calls in a statement list, descending into loops/with/
    try and comprehensions but not nested function defs."""
    out: list[Coll] = []

    def visit_expr(node: ast.AST, loop: bool):
        parents: dict[ast.AST, ast.AST] = {}
        for p in ast.walk(node):
            for c in ast.iter_child_nodes(p):
                parents[c] = p
        for sub in ast.walk(node):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
            ):
                continue
            op = sub.func.attr
            if op not in _SYMMETRIC and op not in _DIRECTIONAL:
                continue
            in_comp = loop
            anc = parents.get(sub)
            while anc is not None:
                if isinstance(
                    anc,
                    (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp),
                ):
                    in_comp = True
                anc = parents.get(anc)
            out.append(
                Coll(op, _sid_of(sub, op), sub.lineno, sub.col_offset, in_comp)
            )

    def visit(stmts: list[ast.stmt], loop: bool):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            is_loop = loop or isinstance(
                stmt, (ast.For, ast.AsyncFor, ast.While)
            )
            for field, value in ast.iter_fields(stmt):
                if isinstance(value, list) and value and isinstance(
                    value[0], ast.stmt
                ):
                    visit(value, is_loop)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.excepthandler):
                            visit(v.body, is_loop)
                        elif isinstance(v, ast.AST):
                            visit_expr(v, is_loop)
                elif isinstance(value, ast.AST):
                    visit_expr(value, is_loop)

    visit(body, in_loop)
    return out


def _is_king_test(test: ast.AST) -> tuple[bool, bool]:
    """(is a king-branch test, negated)."""
    negated = False
    while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        negated = not negated
        test = test.operand
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr == "is_king":
            return True, negated
        if isinstance(sub, ast.Name) and sub.id == "is_king":
            return True, negated
    return False, False


def _terminates(body: list[ast.stmt]) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _pair_findings(
    module: Module,
    king: list[Coll],
    client: list[Coll],
    check_king: bool,
    check_client: bool,
    sid_sound: bool,
) -> Iterator[Finding]:
    """check_king / check_client say which side's calls must find a
    counterpart on the other side. Both are on when the two lists are
    genuinely exclusive (explicit else, or the tail after an early-
    returning branch); in the fall-through case only the branch side is
    checked — the "other side" then is shared code the branch's party
    also runs, so absence from the branch proves nothing, and sid
    multiset comparison (sid_sound) is off too."""

    def ops(side: list[Coll], op: str) -> list[Coll]:
        return [c for c in side if c.op == op]

    def sid_mismatch(a: list[Coll], b: list[Coll]) -> bool:
        if not sid_sound or any(c.in_loop or c.sid is None for c in a + b):
            return False
        return sorted(c.sid for c in a) != sorted(c.sid for c in b)

    for op in _SYMMETRIC:
        k, c = ops(king, op), ops(client, op)
        if k and not c and check_king:
            for call in k:
                yield Finding(
                    module.relpath, call.line, call.col, "DG107",
                    f"king-side `{op}` has no client-side `{op}` — a "
                    "symmetric collective entered by one side deadlocks "
                    "the star",
                )
        elif c and not k and check_client:
            for call in c:
                yield Finding(
                    module.relpath, call.line, call.col, "DG107",
                    f"client-side `{op}` has no king-side `{op}` — a "
                    "symmetric collective entered by one side deadlocks "
                    "the star",
                )
        elif k and c and sid_mismatch(k, c):
            yield Finding(
                module.relpath, k[0].line, k[0].col, "DG107",
                f"`{op}` sids differ between king side "
                f"({sorted(x.sid for x in k)}) and client side "
                f"({sorted(x.sid for x in c)}) — the parties rendezvous "
                "on different channels",
            )

    # directional rendezvous: king send_to <-> client recv_from and
    # king recv_from <-> client send_to
    for king_op, client_op in (("send_to", "recv_from"),
                               ("recv_from", "send_to")):
        k, c = ops(king, king_op), ops(client, client_op)
        if k and not c and check_king:
            for call in k:
                yield Finding(
                    module.relpath, call.line, call.col, "DG107",
                    f"king-side `{king_op}` has no matching client-side "
                    f"`{client_op}` — the client never meets this "
                    "point-to-point op",
                )
        elif c and not k and check_client:
            for call in c:
                yield Finding(
                    module.relpath, call.line, call.col, "DG107",
                    f"client-side `{client_op}` has no matching king-side "
                    f"`{king_op}` — the king never meets this "
                    "point-to-point op",
                )
        elif k and c and sid_mismatch(k, c):
            yield Finding(
                module.relpath, k[0].line, k[0].col, "DG107",
                f"king `{king_op}` sids {sorted(x.sid for x in k)} don't "
                f"pair with client `{client_op}` sids "
                f"{sorted(x.sid for x in c)}",
            )


def _visit_block(
    module: Module, body: list[ast.stmt], fn_calls: list[Coll]
) -> Iterator[Finding]:
    for i, stmt in enumerate(body):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested functions are analyzed on their own
        if isinstance(stmt, ast.If):
            king_test, negated = _is_king_test(stmt.test)
            if king_test:
                # side_a runs when the test is true, side_b otherwise
                side_a = _collect(stmt.body)
                exclusive = True
                if stmt.orelse:
                    side_b = _collect(stmt.orelse)
                elif _terminates(stmt.body):
                    # `if <test>: ...; return` — the block's tail is the
                    # other side's path
                    side_b = _collect(body[i + 1:])
                else:
                    # no else, no early return: both sides run the rest of
                    # the function — only branch-has/rest-lacks is sound
                    side_b = _collect_outside(fn_calls, stmt)
                    exclusive = False
                king, client = (
                    (side_b, side_a) if negated else (side_a, side_b)
                )
                # in the fall-through case only the branch side (side_a)
                # must find counterparts
                check_king = exclusive or not negated
                check_client = exclusive or negated
                yield from _pair_findings(
                    module, king, client, check_king, check_client,
                    sid_sound=exclusive,
                )
        # recurse into every nested statement block (nested ifs get their
        # own analysis at their own block level)
        for _field, value in ast.iter_fields(stmt):
            if isinstance(value, list) and value and isinstance(
                value[0], ast.stmt
            ):
                yield from _visit_block(module, value, fn_calls)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from _visit_block(module, handler.body, fn_calls)


def _collect_outside(fn_calls: list[Coll], stmt: ast.If) -> list[Coll]:
    """Calls of the function that are not inside stmt's king body."""
    inside = {
        (c.line, c.col, c.op) for c in _collect(stmt.body)
    }
    return [
        c for c in fn_calls if (c.line, c.col, c.op) not in inside
    ]


@rule(
    "DG107",
    "collective-pairing",
    "Within a function branching on is_king, king-side and client-side "
    "MpcNet collective sequences (and their literal sids) must pair up — "
    "an unpaired collective is a static deadlock.",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    assert module.tree is not None
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fn_calls = _collect(fn.body)
        yield from _visit_block(module, fn.body, fn_calls)
