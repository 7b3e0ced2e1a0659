"""DG102 — secret values reaching observable sinks.

The paper's security property: no single server may learn the witness,
and the CRS trapdoor ("toxic waste") must never leave setup. The repo's
telemetry plane, flight recorder, and HTTP DTOs are all one careless
call away from shipping a share somewhere persistent. This rule flags
identifiers that *name* secret material (witness / wtns / trapdoor /
toxic / secret) flowing into:

  * logging calls (``log.debug(...)``, ``print(...)``),
  * ``tracing.span(...)`` attributes,
  * metric label values (``family.labels(...)``),
  * flight-recorder notes/dumps (``flight.note/dump/dump_soon``),
  * serialization / DTO sinks (``json.dumps``, ``json_response``),

plus the packing special case: ``pack_proving_key(...)`` without
``strip=True`` ships trapdoor-derived scalars to every party — call
sites that intentionally keep them (setup, tests) must carry a
justifying ``# dg16lint: disable=DG102`` comment.

Matching is word-based on snake/camel segments, with a small benign list
(``num_witness`` et al: sizes and module names, not values).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, Module, Project, call_kw, dotted_name, rule

_SECRET_PARTS = {"witness", "wtns", "trapdoor", "toxic", "secret"}
_EXTRA_SECRET_NAMES = {"z_mont"}  # the full witness vector, post-encode
# identifiers that contain a secret word but name sizes/machinery, not values
_BENIGN = {
    "num_witness",
    "n_witness",
    "num_wtns",
    "witness_calculator",
    "WitnessCalculator",
    "witness_calculator_py",
    "witness_generator",
    "calculate_witness",
    "witness_count",
}

_LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical"}
_LOG_RECEIVERS = {"log", "logger", "logging"}
_FLIGHT_METHODS = {"note", "dump", "dump_soon"}
_SERIALIZE = {"json.dumps", "json_response", "web.json_response"}

_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _secret_identifier(name: str) -> bool:
    if name in _BENIGN:
        return False
    if name in _EXTRA_SECRET_NAMES:
        return True
    words = _CAMEL_RE.sub("_", name).lower().split("_")
    return any(w in _SECRET_PARTS for w in words)


def _secret_refs(expr: ast.AST) -> Iterator[str]:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and _secret_identifier(sub.id):
            yield sub.id
        elif isinstance(sub, ast.Attribute) and _secret_identifier(sub.attr):
            yield sub.attr


def _sink_kind(call: ast.Call) -> str | None:
    """Which sink family this call is, or None."""
    name = dotted_name(call.func)
    if name in _SERIALIZE:
        return "serialization"
    if name == "print":
        return "log"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        recv = dotted_name(call.func.value)
        if attr in _LOG_METHODS and recv is not None and (
            recv in _LOG_RECEIVERS
            or recv.split(".")[-1] in _LOG_RECEIVERS
            or recv.endswith("log")
        ):
            return "log"
        if attr == "labels":
            return "metric label"
        if attr == "span" or (name is not None and name.endswith("tracing.span")):
            return "span attr"
        if attr in _FLIGHT_METHODS and recv is not None and (
            "flight" in recv or recv == "self"
        ):
            return "flight-recorder"
        if attr == "bind" and recv is not None and "logbus" in recv:
            # logbus.bind(tenant=...) stamps its kwargs onto every
            # subsequent ring record — a log sink in slow motion
            return "log"
    else:
        if name == "span":
            return "span attr"
        if name in _FLIGHT_METHODS:
            return "flight-recorder"
    return None


def _sink_args(call: ast.Call, kind: str) -> Iterator[ast.AST]:
    """The value expressions a sink would record."""
    if kind == "span attr":
        # span("name", party=..., attrs={...}) — the kwargs are recorded
        for kw in call.keywords:
            yield kw.value
        return
    for a in call.args:
        yield a
    for kw in call.keywords:
        yield kw.value


@rule(
    "DG102",
    "secret-taint",
    "Identifier naming witness/trapdoor/toxic-waste material flows into a "
    "log line, span attribute, metric label, flight-recorder dump, or "
    "serialization sink — the zkSaaS no-single-server-learns-the-witness "
    "property, enforced at the code layer. Also flags pack_proving_key "
    "without strip=True (trapdoor scalars shipped to every party).",
)
def check(module: Module, project: Project) -> Iterator[Finding]:
    assert module.tree is not None
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue

        # unstripped ProvingKey reaching the packing/serialization layer
        fname = dotted_name(node.func)
        if fname is not None and fname.split(".")[-1] == "pack_proving_key":
            strip = call_kw(node, "strip")
            if not (isinstance(strip, ast.Constant) and strip.value is True):
                yield Finding(
                    module.relpath,
                    node.lineno,
                    node.col_offset,
                    "DG102",
                    "pack_proving_key(...) without strip=True ships "
                    "trapdoor-derived scalars (beta/delta ext rows) to "
                    "every party — pass strip=True or justify with a "
                    "disable comment",
                )
            continue

        kind = _sink_kind(node)
        if kind is None:
            continue
        for arg in _sink_args(node, kind):
            for ident in _secret_refs(arg):
                yield Finding(
                    module.relpath,
                    node.lineno,
                    node.col_offset,
                    "DG102",
                    f"secret-named identifier `{ident}` reaches a {kind} "
                    "sink — witness/trapdoor material must never be "
                    "logged, labelled, or serialized",
                )
