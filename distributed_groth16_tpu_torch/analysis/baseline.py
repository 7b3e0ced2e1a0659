"""Checked-in baseline: grandfathered findings that don't fail the run.

A baseline entry is a *fingerprint*, not a line number — the hash covers
(rule, file, the finding line's stripped text, duplicate index) so code
moving up or down a file doesn't churn the baseline, while editing the
offending line invalidates its entry (the finding resurfaces as new,
which is the point: touched code must come clean).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from .core import Finding, Project

BASELINE_VERSION = 1
DEFAULT_BASELINE = "distributed_groth16_tpu_torch/tools/dg16lint-baseline.json"


def fingerprint(f: Finding, project: Project) -> str:
    mod = next((m for m in project.modules if m.relpath == f.path), None)
    # non-module paths (DG104 rows in docs/torch/OBSERVABILITY.md) have no line
    # text to anchor on — hash the message so distinct doc findings don't
    # collapse into one grandfathering entry
    anchor = mod.line_text(f.line).strip() if mod is not None else f.message
    body = f"{f.rule}|{f.path}|{anchor}"
    h = hashlib.sha1(body.encode()).hexdigest()[:16]
    return h


def fingerprints(findings: list[Finding], project: Project) -> dict[str, str]:
    """finding -> fingerprint, de-duplicating identical lines with a
    positional suffix so two equal hits on one line get distinct ids."""
    seen: dict[str, int] = {}
    out: dict[Finding, str] = {}
    for f in findings:  # findings arrive sorted — stable indices
        fp = fingerprint(f, project)
        n = seen.get(fp, 0)
        seen[fp] = n + 1
        out[f] = fp if n == 0 else f"{fp}#{n}"
    return out


class BaselineError(Exception):
    """The baseline file exists but can't be used (bad JSON / shape)."""


def load(path: Path) -> dict[str, dict]:
    """{fingerprint: entry} from a baseline file; {} when absent.

    Raises BaselineError (not a raw traceback) on a corrupt or
    hand-mangled file — trailing comma, entry missing "fingerprint" —
    so the CLI can say which file to fix or regenerate."""
    try:
        data = json.loads(Path(path).read_text())
    except FileNotFoundError:
        return {}
    except OSError as e:
        # an unreadable file must not silently report everything as new
        raise BaselineError(
            f"unreadable baseline file {path}: {e}"
        ) from e
    except ValueError as e:
        raise BaselineError(
            f"invalid baseline file {path}: {e} — fix it or regenerate "
            "with --write-baseline"
        ) from e
    try:
        return {e["fingerprint"]: e for e in data.get("findings", [])}
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        raise BaselineError(
            f"invalid baseline file {path}: {e!r} — fix it or regenerate "
            "with --write-baseline"
        ) from e


def save(
    path: Path,
    findings: list[Finding],
    project: Project,
    keep: list[dict] | None = None,
) -> None:
    """Write the baseline; `keep` carries pre-existing entries to retain
    verbatim (the un-selected rules' grandfathered findings when the run
    was narrowed with --select)."""
    fps = fingerprints(findings, project)
    entries = [
        {
            "fingerprint": fps[f],
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
        }
        for f in findings
    ] + list(keep or [])
    doc = {
        "version": BASELINE_VERSION,
        "comment": (
            "dg16lint grandfathered findings; regenerate with "
            "`python -m distributed_groth16_tpu_torch.analysis "
            "--write-baseline`"
        ),
        "findings": entries,
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def split(
    findings: list[Finding], project: Project, baseline: dict[str, dict]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """(new, grandfathered, stale-fingerprints) against the baseline."""
    fps = fingerprints(findings, project)
    new: list[Finding] = []
    old: list[Finding] = []
    used: set = set()
    for f in findings:
        fp = fps[f]
        if fp in baseline:
            old.append(f)
            used.add(fp)
        else:
            new.append(f)
    stale = [fp for fp in baseline if fp not in used]
    return new, old, stale
