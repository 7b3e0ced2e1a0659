"""benchgate — the per-kernel performance regression gate; the counterpart
of the JAX package's telemetry/benchgate.py, with its gating logic, exit
codes and report strings.

    python -m distributed_groth16_tpu_torch.telemetry.benchgate \
        [--quick] [--select KERNEL ...] [--device cpu] [--out run.json] \
        [--check run.json] [--write-baseline] [--baseline FILE]

Runs the `telemetry/perf.py` kernel registry on the card (or on the
device `--device` names), or re-gates a previously recorded run via
`--check`, and compares every record against the port's own baseline,
`distributed_groth16_tpu_torch/tools/perf-baseline.json` (the repo
root's `tools/perf-baseline.json` holds the JAX package's numbers and is
never read here). The gate is noise-aware by construction:

  * a kernel regresses only when it is BOTH relatively slower than
    baseline (`median > base * (1 + rel_threshold)`) AND absolutely
    slower by more than the noise floor (`median - base > abs_floor_s`)
    — sub-millisecond kernels jitter by large ratios that mean nothing;
  * per-kernel `rel_threshold` / `abs_floor_s` overrides live in the
    baseline entry itself (a known-noisy kernel documents its own slack);
  * a kernel with no baseline entry — or a baseline file that doesn't
    exist at all — is ADVISORY, never a failure: new kernels land first,
    the ratchet (`--write-baseline`) records them second;
  * `--write-baseline` merges: it updates entries for the kernels this
    run exercised and keeps everything else (including override fields),
    so a `--quick` run can ratchet the quick subset without wiping the
    full-size entries.

Exit codes mirror dg16lint's contract: 0 pass/advisory, 1 regression,
2 corrupt baseline or run file (`PerfBaselineError` — a mangled file must
fail loudly, not silently gate nothing) or an unknown `--select` name.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..utils import config as _config

BASELINE_SCHEMA = "dg16-perf-baseline/1"
DEFAULT_BASELINE = "distributed_groth16_tpu_torch/tools/perf-baseline.json"
DEFAULT_REL_THRESHOLD = 0.5
DEFAULT_ABS_FLOOR_S = 0.02


class PerfBaselineError(Exception):
    """The baseline (or --check run) file exists but can't be used."""


def default_baseline_path() -> str:
    """The port's baseline, anchored to the package (not the CWD):
    `benchgate` run from a build/scratch directory must still find the
    gate, not silently pass in advisory mode."""
    return str(Path(__file__).resolve().parents[1] / "tools"
               / "perf-baseline.json")


def _load_json(path, what: str) -> dict:
    try:
        text = Path(path).read_text()
    except FileNotFoundError:
        raise
    except OSError as e:
        raise PerfBaselineError(f"unreadable {what} {path}: {e}") from e
    try:
        data = json.loads(text)
    except ValueError as e:
        raise PerfBaselineError(
            f"invalid {what} {path}: {e} — fix it or regenerate"
        ) from e
    if not isinstance(data, dict) or not isinstance(
        data.get("kernels"), dict
    ):
        raise PerfBaselineError(
            f"invalid {what} {path}: expected an object with a "
            '"kernels" map — fix it or regenerate'
        )
    return data


def load_baseline(path) -> dict | None:
    """Baseline document, or None when the file is absent (advisory mode).
    Raises PerfBaselineError on a corrupt/mangled file (exit 2)."""
    try:
        data = _load_json(path, "perf baseline")
    except FileNotFoundError:
        return None
    for key, entry in data["kernels"].items():
        if not isinstance(entry, dict) or not isinstance(
            entry.get("median_seconds"), (int, float)
        ):
            raise PerfBaselineError(
                f"invalid perf baseline {path}: entry {key!r} has no "
                "numeric median_seconds — fix it or regenerate with "
                "--write-baseline"
            )
    return data


def load_run(path) -> dict:
    """A recorded run document (--check path). Missing file is an error
    here — the caller explicitly named it — and structurally-bad records
    exit 2 like a corrupt baseline, not a traceback mislabelled exit 1."""
    try:
        data = _load_json(path, "perf run")
    except FileNotFoundError as e:
        raise PerfBaselineError(f"perf run file not found: {path}") from e
    for key, rec in data["kernels"].items():
        if not isinstance(rec, dict) or (
            "error" not in rec
            and not isinstance(rec.get("median_seconds"), (int, float))
        ):
            raise PerfBaselineError(
                f"invalid perf run {path}: record {key!r} has neither a "
                "numeric median_seconds nor an error field — regenerate it"
            )
    return data


def compare(
    run: dict,
    baseline: dict | None,
    rel_threshold: float | None = None,
    abs_floor_s: float | None = None,
) -> dict:
    """Gate one run against a baseline. Returns the report dict:
    regressions (gate failures), improvements (candidates for a
    `--write-baseline` ratchet), and advisories (new kernels, kernels
    that errored without a baseline, baseline entries not exercised)."""
    rel_default = rel_threshold if rel_threshold is not None else \
        _config.env_float("DG16_PERF_REL_THRESHOLD", DEFAULT_REL_THRESHOLD)
    floor_default = abs_floor_s if abs_floor_s is not None else \
        _config.env_float("DG16_PERF_ABS_FLOOR_S", DEFAULT_ABS_FLOOR_S)
    base_kernels = (baseline or {}).get("kernels", {})
    regressions: list[dict] = []
    improvements: list[dict] = []
    advisories: list[str] = []
    checked = 0
    # cross-platform numbers are not comparable (the CPU run is orders of
    # magnitude off the card's): gating a card run against a CPU baseline
    # would produce spurious verdicts in both directions
    run_plat = run.get("platform")
    base_plat = (baseline or {}).get("platform")
    if baseline is not None and run_plat and base_plat \
            and run_plat != base_plat:
        return {
            "checked": 0,
            "regressions": [],
            "improvements": [],
            "advisories": [
                f"platform mismatch: run is {run_plat!r}, baseline is "
                f"{base_plat!r} — gating skipped (record a matching "
                "baseline with --write-baseline on that platform)"
            ],
            "passed": True,
        }
    for key in sorted(run.get("kernels", {})):
        rec = run["kernels"][key]
        base = base_kernels.get(key)
        if "error" in rec:
            if base is not None:
                # a kernel that USED to run and now dies is the worst
                # regression there is — never advisory
                regressions.append({
                    "key": key,
                    "run_seconds": None,
                    "base_seconds": base["median_seconds"],
                    "ratio": None,
                    "error": rec["error"],
                })
            else:
                advisories.append(f"{key}: errored, no baseline "
                                  f"({rec['error']})")
            continue
        if base is None:
            advisories.append(
                f"{key}: no baseline entry (new kernel) — ratchet with "
                "--write-baseline"
            )
            continue
        checked += 1
        # `is not None`, not `or`: an explicit 0 override means "this
        # kernel must never regress", not "use the default"
        b_rel = base.get("rel_threshold")
        b_floor = base.get("abs_floor_s")
        rel = float(b_rel if b_rel is not None else rel_default)
        floor = float(b_floor if b_floor is not None else floor_default)
        med = float(rec["median_seconds"])
        bmed = float(base["median_seconds"])
        ratio = med / bmed if bmed > 0 else float("inf")
        entry = {
            "key": key,
            "run_seconds": med,
            "base_seconds": bmed,
            "ratio": round(ratio, 3),
            "rel_threshold": rel,
            "abs_floor_s": floor,
        }
        if med > bmed * (1.0 + rel) and (med - bmed) > floor:
            regressions.append(entry)
        elif med * (1.0 + rel) < bmed and (bmed - med) > floor:
            improvements.append(entry)
    for key in sorted(base_kernels):
        if key not in run.get("kernels", {}):
            advisories.append(
                f"{key}: in baseline but not exercised by this run"
            )
    return {
        "checked": checked,
        "regressions": regressions,
        "improvements": improvements,
        "advisories": advisories,
        "passed": not regressions,
    }


def write_baseline(path, run: dict, existing: dict | None) -> dict:
    """Merge-ratchet: update/insert entries for the kernels this run
    exercised (skipping errored records), preserve every other entry and
    any per-kernel override fields on the updated ones."""
    old = (existing or {}).get("kernels", {})
    kernels = dict(old)
    for key, rec in run.get("kernels", {}).items():
        if "error" in rec:
            continue
        entry = {
            "kernel": rec["kernel"],
            "size": rec["size"],
            "median_seconds": rec["median_seconds"],
            "items_per_sec": rec.get("items_per_sec"),
            "unit": rec.get("unit"),
        }
        prev = old.get(key)
        if prev:
            # overrides are operator intent — a ratchet must not drop them
            for k in ("rel_threshold", "abs_floor_s"):
                if prev.get(k) is not None:
                    entry[k] = prev[k]
        kernels[key] = entry
    doc = {
        "schema": BASELINE_SCHEMA,
        "comment": (
            "benchgate perf baseline; ratchet with `python -m "
            "distributed_groth16_tpu_torch.telemetry.benchgate "
            "--write-baseline` after a verified win"
        ),
        "platform": run.get("platform", "unknown"),
        "kernels": {k: kernels[k] for k in sorted(kernels)},
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return doc


def render_report(report: dict) -> str:
    lines = []
    for r in report["regressions"]:
        if r.get("error"):
            lines.append(f"REGRESSION {r['key']}: errored ({r['error']}) "
                         f"but has a baseline of {r['base_seconds']:.6g}s")
        else:
            lines.append(
                f"REGRESSION {r['key']}: {r['run_seconds']:.6g}s vs "
                f"baseline {r['base_seconds']:.6g}s "
                f"({r['ratio']:.2f}x > 1+{r['rel_threshold']:g})"
            )
    for r in report["improvements"]:
        lines.append(
            f"improved  {r['key']}: {r['run_seconds']:.6g}s vs "
            f"baseline {r['base_seconds']:.6g}s ({r['ratio']:.2f}x) — "
            "consider --write-baseline"
        )
    for a in report["advisories"]:
        lines.append(f"advisory  {a}")
    verdict = "PASS" if report["passed"] else "FAIL"
    lines.append(
        f"benchgate: {verdict} — {report['checked']} gated, "
        f"{len(report['regressions'])} regression(s), "
        f"{len(report['improvements'])} improvement(s), "
        f"{len(report['advisories'])} advisory"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="benchgate",
        description="per-kernel perf registry runner + regression gate "
                    "of the PyTorch/CUDA port",
    )
    ap.add_argument("--quick", action="store_true",
                    help="CPU smoke subset: each kernel's quick sizes")
    ap.add_argument("--select", nargs="+", metavar="KERNEL",
                    help="run only these registered kernels")
    ap.add_argument("--reps", type=int, default=None,
                    help="warm reps per case (default DG16_PERF_REPS)")
    ap.add_argument("--device", default=None,
                    help="device to run the kernels on (default: the "
                         "card, cuda:0; cpu runs the plain versions)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="merge this run into the baseline (ratchet) "
                         "instead of gating against it")
    ap.add_argument("--out", default=None,
                    help="write the run document (dg16-perf/1 JSON) here")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the kernel "
                         "run and write the .tar.gz artifact under DIR "
                         "(telemetry/profiler.py; ignored with --check)")
    ap.add_argument("--check", metavar="RUN_JSON", default=None,
                    help="gate a previously recorded run instead of "
                         "running kernels")
    ap.add_argument("--json", action="store_true",
                    help="emit the gate report as JSON on stdout")
    ap.add_argument("--list", action="store_true",
                    help="list registered kernels and sizes, then exit")
    args = ap.parse_args(argv)
    baseline_path = args.baseline or default_baseline_path()

    try:
        if args.list:
            from . import perf

            for name, spec in sorted(perf.kernels().items()):
                host = " (host)" if spec.host else ""
                print(f"{name}{host}: sizes 2^{list(spec.sizes)} "
                      f"quick 2^{list(spec.quick_sizes)} [{spec.unit}]")
            return 0
        if args.check:
            run = load_run(args.check)
        else:
            from . import perf

            try:
                if args.profile:
                    # one artifact per gated run: the device timeline that
                    # explains the numbers the gate is about to judge
                    from . import profiler as _profiler

                    with _profiler.capture_during(args.profile) as cd:
                        run = perf.run_suite(
                            quick=args.quick, select=args.select,
                            reps=args.reps, device=args.device,
                        )
                    cap = cd.capture
                    if cap is not None and cap.state == "done":
                        print(f"benchgate: profiler artifact {cap.artifact}")
                    elif cap is not None:
                        print(
                            f"benchgate: profiler capture failed: {cap.error}",
                            file=sys.stderr,
                        )
                else:
                    run = perf.run_suite(
                        quick=args.quick, select=args.select,
                        reps=args.reps, device=args.device,
                    )
            except KeyError as e:
                # a --select typo must not exit 1 — that code means
                # "perf regression" to CI scripting
                print(f"benchgate: {e.args[0]}", file=sys.stderr)
                return 2
        if args.out:
            Path(args.out).write_text(
                json.dumps(run, indent=2, sort_keys=True) + "\n"
            )
        if args.write_baseline:
            existing = load_baseline(baseline_path)
            doc = write_baseline(baseline_path, run, existing)
            print(f"benchgate: baseline {baseline_path} updated "
                  f"({len(doc['kernels'])} entries)")
            return 0
        baseline = load_baseline(baseline_path)
        if baseline is None:
            print(f"benchgate: no baseline at {baseline_path} — advisory "
                  "run only (ratchet with --write-baseline)")
            return 0
        report = compare(run, baseline)
        print(json.dumps(report, indent=2) if args.json
              else render_report(report))
        return 0 if report["passed"] else 1
    except PerfBaselineError as e:
        print(f"benchgate: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
