"""dg16lint command line.

    python -m distributed_groth16_tpu_torch.analysis [paths...] [options]
    python distributed_groth16_tpu_torch/tools/dg16lint.py [paths...]
        [options]                                # no-deps spelling

Exit codes: 0 clean (or report-only flags), 1 new findings (and, under
--strict, stale baseline entries), 2 usage error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import baseline as bl
from .core import all_rules, find_root, load_project, run_rules
from .report import render_json, render_text, write_json


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dg16lint",
        description=(
            "Project-native static analysis for "
            "distributed_groth16_tpu_torch "
            "(docs/STATIC_ANALYSIS.md has the rule catalog)."
        ),
    )
    p.add_argument(
        "paths", nargs="*", default=None,
        help="files/dirs to lint (default: the "
        "distributed_groth16_tpu_torch "
        "package next to the current directory)",
    )
    p.add_argument(
        "--root", default=None,
        help="project root for docs/ + baseline resolution "
        "(default: auto-detected from the first path)",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: <root>/{bl.DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: every finding is new",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="grandfather the current findings into the baseline and exit 0",
    )
    p.add_argument(
        "--strict", action="store_true",
        help="also fail on stale baseline entries (CI mode)",
    )
    p.add_argument(
        "--json", metavar="FILE", default=None,
        help="write the JSON report to FILE ('-' for stdout)",
    )
    p.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--show-baselined", action="store_true",
        help="also print grandfathered findings",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for r in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{r.id}  {r.name}")
            for line in r.doc.strip().splitlines():
                print(f"       {line.strip()}")
        return 0

    paths = [Path(p) for p in args.paths] if args.paths else None
    if paths is None:
        default = Path("distributed_groth16_tpu_torch")
        if not default.is_dir():
            # not run from the repo root — lint the package this module
            # itself lives in (what tools/dg16lint.py relies on)
            default = Path(__file__).resolve().parent.parent
        paths = [default]
    for p in paths:
        if not p.exists():
            print(f"dg16lint: no such path: {p}", file=sys.stderr)
            return 2

    root = Path(args.root) if args.root else find_root(paths[0])
    project = load_project(paths, root)

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
        unknown = select - set(all_rules()) - {"DG000"}
        if unknown:
            print(
                f"dg16lint: unknown rule(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2

    findings, suppressed = run_rules(project, select)

    baseline_path = Path(args.baseline) if args.baseline else (
        root / bl.DEFAULT_BASELINE
    )
    if args.write_baseline:
        keep: list[dict] = []
        if select:
            # a --select run only saw the selected rules: retain the other
            # rules' grandfathered entries instead of wiping them
            try:
                existing = bl.load(baseline_path)
            except bl.BaselineError:
                existing = {}  # overwriting a corrupt baseline is the fix
            keep = [
                e for e in existing.values() if e.get("rule") not in select
            ]
        bl.save(baseline_path, findings, project, keep=keep)
        kept = f" (+{len(keep)} kept from unselected rules)" if keep else ""
        print(
            f"dg16lint: wrote {len(findings)} finding(s){kept} to "
            f"{baseline_path}"
        )
        if args.json:
            # snapshot of what was grandfathered, for scripted consumers
            write_json(
                args.json, render_json(findings, [], [], suppressed, project)
            )
        return 0

    try:
        baseline = {} if args.no_baseline else bl.load(baseline_path)
    except bl.BaselineError as e:
        print(f"dg16lint: {e}", file=sys.stderr)
        return 2
    if select:
        # unselected rules never ran: their entries can't be judged stale
        baseline = {
            fp: e for fp, e in baseline.items() if e.get("rule") in select
        }
    new, old, stale = bl.split(findings, project, baseline)

    print(
        render_text(
            new, old, stale, suppressed,
            show_grandfathered=args.show_baselined,
        )
    )
    if args.json:
        write_json(args.json, render_json(new, old, stale, suppressed, project))

    if new:
        return 1
    if args.strict and stale:
        return 1
    return 0
