"""Text and JSON reporters for a lint run."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from .baseline import fingerprints
from .core import Finding, Project


def render_text(
    new: list[Finding],
    grandfathered: list[Finding],
    stale: list[str],
    suppressed: int,
    *,
    show_grandfathered: bool = False,
) -> str:
    out: list[str] = []
    for f in new:
        out.append(f.format())
    if show_grandfathered:
        for f in grandfathered:
            out.append(f"{f.format()} [baselined]")
    counts = Counter(f.rule for f in new)
    summary = (
        f"dg16lint: {len(new)} new finding(s), "
        f"{len(grandfathered)} baselined, {suppressed} suppressed inline"
    )
    if counts:
        summary += " — " + ", ".join(
            f"{r}×{n}" for r, n in sorted(counts.items())
        )
    out.append(summary)
    if stale:
        out.append(
            f"dg16lint: {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'} no longer fire — "
            "regenerate with --write-baseline"
        )
    return "\n".join(out)


def render_json(
    new: list[Finding],
    grandfathered: list[Finding],
    stale: list[str],
    suppressed: int,
    project: Project,
) -> str:
    fps = fingerprints(sorted(set(new) | set(grandfathered)), project)

    def enc(f: Finding, status: str) -> dict:
        return {
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "col": f.col,
            "message": f.message,
            "fingerprint": fps[f],
            "status": status,
        }

    doc = {
        "version": 1,
        "findings": [enc(f, "new") for f in new]
        + [enc(f, "baselined") for f in grandfathered],
        "staleBaseline": sorted(stale),
        "suppressedInline": suppressed,
        "counts": {
            "new": len(new),
            "baselined": len(grandfathered),
            "byRule": dict(sorted(Counter(f.rule for f in new).items())),
        },
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def write_json(path: str, payload: str) -> None:
    if path == "-":
        print(payload)  # dg16lint: disable=DG108 — "-" means stdout
    else:
        Path(path).write_text(payload + "\n")
