"""CLI client — the zk-cli role (zk-cli/src/main.rs:30-208); the
counterpart of the JAX package's api/cli.py. It speaks HTTP to a port
server or router and needs no card itself, but for `perf run` and
`perf roofline` without --run, which run the per-kernel perf registry
(telemetry/perf.py) on the card unless --device names another.

Subcommands `save / prove / mpc-prove / verify` posting multipart/JSON to
the proving service (default http://localhost:8000). The reference's
`mpc-prove` accidentally posts to the non-MPC endpoint
(zk-cli/src/main.rs:158-159 — copy-paste bug); here it hits
/create_proof_with_naive_mpc as intended (SURVEY §2.13).

Usage:
  python -m distributed_groth16_tpu_torch.api.cli save --name mul \
      --r1cs circuit.r1cs [--wasm gen.wasm]
  python -m distributed_groth16_tpu_torch.api.cli prove --circuit-id ID \
      --witness w.wtns [--out proof.bin]
  python -m distributed_groth16_tpu_torch.api.cli mpc-prove --circuit-id ID \
      --witness w.wtns [--l 2]
  python -m distributed_groth16_tpu_torch.api.cli verify --circuit-id ID \
      --proof proof.bin --public 33 [--public ...]
  python -m distributed_groth16_tpu_torch.api.cli verify --batch --circuit-id ID \
      proof1.bin:33,44 proof2.bin:55 [...]
  python -m distributed_groth16_tpu_torch.api.cli aggregate ID \
      proof1.bin:33 proof2.bin:55 [--out bundle.json]
  python -m distributed_groth16_tpu_torch.api.cli job submit --circuit-id ID \
      --witness w.wtns [--mpc] [--l 2]
  python -m distributed_groth16_tpu_torch.api.cli job status --job-id JOB
  python -m distributed_groth16_tpu_torch.api.cli job watch --job-id JOB \
      [--interval 2] [--out proof.bin]
  python -m distributed_groth16_tpu_torch.api.cli job recover --dry-run \
      [--journal DIR | --store DIR]
  python -m distributed_groth16_tpu_torch.api.cli trace JOB [--out trace.json] \
      [--router http://router:8080]
  python -m distributed_groth16_tpu_torch.api.cli logs [--level WARNING] \
      [--trace ID | --job ID] [--follow] [--router http://router:8080]
  python -m distributed_groth16_tpu_torch.api.cli metrics
  python -m distributed_groth16_tpu_torch.api.cli fleet status
  python -m distributed_groth16_tpu_torch.api.cli fleet top [--interval 2] [--once]
  python -m distributed_groth16_tpu_torch.api.cli fleet drain REPLICA
  python -m distributed_groth16_tpu_torch.api.cli perf run [--quick] \
      [--select msm_g1 ...] [--device cpu] [--out perf.json]
  python -m distributed_groth16_tpu_torch.api.cli perf top --run perf.json \
      [-n 10]
  python -m distributed_groth16_tpu_torch.api.cli perf diff before.json \
      after.json [--markdown]
  python -m distributed_groth16_tpu_torch.api.cli perf roofline \
      [--run perf.json | --device cpu]
  python -m distributed_groth16_tpu_torch.api.cli profile capture [--seconds 3] \
      [--out prof.tar.gz]
  python -m distributed_groth16_tpu_torch.api.cli profile status

Queue-full submissions (HTTP 429) exit with the server's retryAfter hint
(docs/SERVICE.md describes the backpressure semantics).
"""

from __future__ import annotations

import argparse
import json
import sys

import requests


def _body(resp) -> dict:
    try:
        body = resp.json()
    except ValueError:
        raise SystemExit(
            f"server error: HTTP {resp.status_code} — {resp.text[:300]}"
        )
    if resp.status_code == 429:
        # queue-full backpressure (docs/SERVICE.md): surface the server's
        # retryAfter hint instead of a generic error
        hint = body.get("retryAfter")
        raise SystemExit(
            f"server busy: {body.get('error', 'job queue full')}"
            + (f" — retry after {hint}s" if hint is not None else "")
        )
    if resp.status_code not in (200, 202):
        raise SystemExit(f"server error: {body.get('error', body)}")
    return body


def _post_multipart(url: str, fields: dict) -> dict:
    files = {k: (k, v) for k, v in fields.items()}
    return _body(requests.post(url, files=files, timeout=3600))


def cmd_save(args) -> dict:
    fields = {
        "circuit_name": args.name.encode(),
        "r1cs_file": open(args.r1cs, "rb").read(),
    }
    if args.wasm:
        fields["witness_generator"] = open(args.wasm, "rb").read()
    return _post_multipart(f"{args.url}/save_circuit", fields)


def _prove(args, endpoint: str) -> dict:
    fields = {
        "circuit_id": args.circuit_id.encode(),
        "witness_file": open(args.witness, "rb").read(),
    }
    if endpoint.endswith("naive_mpc"):
        fields["l"] = str(args.l).encode()
    body = _post_multipart(f"{args.url}/{endpoint}", fields)
    if args.out:
        with open(args.out, "wb") as f:
            f.write(bytes(body["proof"]))
    return body


def cmd_prove(args) -> dict:
    return _prove(args, "create_proof_without_mpc")


def cmd_mpc_prove(args) -> dict:
    return _prove(args, "create_proof_with_naive_mpc")


def cmd_verify(args) -> dict:
    if args.batch:
        if not args.proofs:
            raise SystemExit(
                "--batch needs proof specs: verify --batch "
                "--circuit-id ID proof.bin:33,44 [...]"
            )
        return _proofs_job(args, "verify", args.proofs)
    if not args.proof:
        raise SystemExit("--proof is required (or use --batch with specs)")
    proof = list(open(args.proof, "rb").read())
    return _body(
        requests.post(
            f"{args.url}/verify_proof",
            json={
                "circuitId": args.circuit_id,
                "proof": proof,
                "publicInputs": [str(x) for x in args.public],
            },
            timeout=600,
        )
    )


def _parse_proof_spec(spec: str) -> dict:
    """`path[:pub,pub,...]` -> one proofs_file item. The publics ride
    after the colon so a batch line stays one token per proof."""
    path, _, pubs = spec.partition(":")
    publics = [s.strip() for s in pubs.split(",") if s.strip()]
    return {
        "proof": list(open(path, "rb").read()),
        "publicInputs": publics,
    }


def _proofs_job(args, kind: str, specs: list) -> dict:
    """Submit N proofs as ONE kind=verify|aggregate job (docs/VERIFY.md)
    and follow it to a terminal state — the whole batch folds into a
    single multi-pairing server-side."""
    import time as _time

    items = [_parse_proof_spec(s) for s in specs]
    fields = {
        "circuit_id": args.circuit_id.encode(),
        "proofs_file": json.dumps(items).encode(),
    }
    body = _post_multipart(f"{args.url}/jobs/{kind}", fields)
    job_id = body["jobId"]
    while True:
        status = _job_status(args.url, job_id)
        state = status.get("state")
        if state in ("DONE", "FAILED", "CANCELLED"):
            break
        _time.sleep(args.interval)
    if state != "DONE":
        # an invalid proof is a FAILED job whose error names the bad
        # indices (InvalidProofError) — surface that, not a traceback
        return status
    result = _body(
        requests.get(f"{args.url}/jobs/{job_id}/result", timeout=600)
    )
    out = getattr(args, "out", None)
    if out and "bundle" in result:
        with open(out, "w") as f:
            json.dump(result["bundle"], f, indent=2)
        result["bundleOut"] = out
    return result


def cmd_aggregate(args) -> dict:
    """`aggregate CIRCUIT proof.bin:33,44 [...]` — verify N proofs and
    compress them into one RLC-folded bundle attestation, re-checkable
    offline by a single multi-pairing (docs/VERIFY.md)."""
    return _proofs_job(args, "aggregate", args.proofs)


def cmd_job_submit(args) -> dict:
    """POST /jobs/prove — returns {jobId, state} immediately; pair with
    `job watch` to follow it to completion."""
    fields = {
        "circuit_id": args.circuit_id.encode(),
        "witness_file": open(args.witness, "rb").read(),
    }
    if args.mpc:
        fields["mpc"] = b"1"
        fields["l"] = str(args.l).encode()
    return _post_multipart(f"{args.url}/jobs/prove", fields)


def _job_status(url: str, job_id: str) -> dict:
    return _body(requests.get(f"{url}/jobs/{job_id}", timeout=60))


def cmd_job_status(args) -> dict:
    return _job_status(args.url, args.job_id)


def cmd_job_watch(args) -> dict:
    """Poll GET /jobs/{id} until the job is terminal; on DONE, fetch the
    result (optionally writing the proof bytes to --out)."""
    import time

    while True:
        body = _job_status(args.url, args.job_id)
        state = body.get("state")
        print(f"{args.job_id}: {state}", file=sys.stderr, flush=True)
        if state in ("DONE", "FAILED", "CANCELLED"):
            break
        time.sleep(args.interval)
    if state != "DONE":
        return body
    result = _body(
        requests.get(f"{args.url}/jobs/{args.job_id}/result", timeout=600)
    )
    if args.out:
        with open(args.out, "wb") as f:
            f.write(bytes(result["proof"]))
    return result


def cmd_job_recover(args) -> dict:
    """Inspect a crashed replica's job journal OFFLINE (no server):
    print exactly what a startup replay would re-enqueue. Read-only by
    default (`--dry-run` spells that out explicitly); `--compact`
    additionally rewrites the journal in place (terminal records
    dropped) — never run THAT against a journal a live service still
    owns."""
    from ..service.journal import JobJournal, read_journal

    if args.dry_run and args.compact:
        raise SystemExit("--dry-run and --compact are mutually exclusive")
    jdir = args.journal or f"{args.store}/_journal"
    entries = read_journal(jdir)
    replayable = [e for e in entries if e.replayable]
    out = {
        "journal": jdir,
        "liveJobs": len(entries),
        "wouldReplay": [
            {
                "jobId": e.id,
                "kind": e.kind,
                "circuitId": e.circuit_id,
                "l": e.l,
                "state": e.state,
                "createdAt": e.created_at,
                "payloadBytes": sum(len(v) for v in e.fields.values()),
            }
            for e in replayable
        ],
        "quarantined": [e.id for e in entries if e.quarantined],
        "dryRun": not args.compact,
    }
    if args.compact:
        j = JobJournal(jdir)
        j.checkpoint()
        j.close()
        out["compacted"] = True
    return out


def cmd_trace(args) -> dict:
    """Fetch a job's Chrome trace-event JSON and write it to --out
    (default trace-<jobId>.json); open the file in chrome://tracing or
    Perfetto (docs/OBSERVABILITY.md). With --router, the STITCHED fleet
    trace (router + replica + MPC-party tiers) is fetched from
    GET /fleet/jobs/{id}/trace first, falling back to the replica route
    at --url when the id is unknown to the router (a job submitted
    straight to a replica)."""
    trace = None
    source = args.url
    router = getattr(args, "router", None)
    if router:
        resp = requests.get(
            f"{router}/fleet/jobs/{args.job_id}/trace", timeout=600
        )
        if resp.status_code == 200:
            trace = resp.json()
            source = router
        elif resp.status_code != 404:
            raise SystemExit(
                f"router error: HTTP {resp.status_code} — {resp.text[:300]}"
            )
    if trace is None:
        trace = _body(
            requests.get(f"{args.url}/jobs/{args.job_id}/trace", timeout=600)
        )
    out = args.out or f"trace-{args.job_id}.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    result = {
        "jobId": args.job_id,
        "source": source,
        "out": out,
        "events": len(trace.get("traceEvents", [])),
    }
    if trace.get("traceId"):
        result["traceId"] = trace["traceId"]
    return result


def _fmt_log_line(r: dict) -> str:
    """One human-readable line per structured record: wall time, level,
    logger, message, then whatever correlation ids the record carries."""
    import time as _time

    ts = r.get("ts")
    stamp = (
        _time.strftime("%H:%M:%S", _time.localtime(ts))
        + f".{int((ts % 1) * 1000):03d}"
        if isinstance(ts, (int, float))
        else "--:--:--"
    )
    line = (
        f"{stamp} {r.get('level', '?'):7s} "
        f"{r.get('logger', '?')}: {r.get('msg', '')}"
    )
    tags = [
        f"{k}={r[k]}"
        for k in ("source", "trace", "job", "party", "replica", "tenant")
        if k in r
    ]
    if tags:
        line += "  [" + " ".join(tags) + "]"
    if "exc" in r:
        line += "\n" + str(r["exc"]).rstrip()
    return line


def cmd_logs(args) -> dict:
    """Print the structured log ring (GET /logs) filtered by
    --level/--trace/--job; --follow tails it on the `since` seq cursor.
    With --router AND --job, the federated cross-tier stream
    (GET /fleet/jobs/{id}/logs — router + owning replica, one clock) is
    printed instead (docs/OBSERVABILITY.md "Logging spine")."""
    import time as _time

    if args.router:
        if not args.job:
            raise SystemExit("--router needs --job (the routed job id)")
        resp = requests.get(
            f"{args.router}/fleet/jobs/{args.job}/logs",
            params={
                k: v
                for k, v in (
                    ("level", args.level), ("limit", str(args.limit)),
                )
                if v
            },
            timeout=120,
        )
        body = _body(resp)
        for r in body.get("records", []):
            print(_fmt_log_line(r))
        if body.get("warning"):
            print(f"warning: {body['warning']}", file=sys.stderr)
        raise SystemExit(0)
    params = {
        k: v
        for k, v in (
            ("level", args.level),
            ("trace", args.trace),
            ("job", args.job),
            ("limit", str(args.limit)),
        )
        if v
    }
    since = None
    while True:
        if since is not None:
            params["since"] = str(since)
        body = _body(requests.get(f"{args.url}/logs", params=params,
                                  timeout=120))
        for r in body.get("records", []):
            print(_fmt_log_line(r), flush=True)
        since = body.get("nextSince", since)
        if not args.follow:
            raise SystemExit(0)
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            raise SystemExit(0)


def cmd_metrics(args) -> dict:
    """GET /metrics — print the server's Prometheus text exposition
    verbatim (pipe into promtool or grep; docs/OBSERVABILITY.md)."""
    resp = requests.get(f"{args.url}/metrics", timeout=60)
    if resp.status_code != 200:
        raise SystemExit(
            f"server error: HTTP {resp.status_code} — {resp.text[:300]}"
        )
    print(resp.text, end="")
    raise SystemExit(0)


def cmd_profile_capture(args) -> dict:
    """POST /profile against a LIVE server (mid-job is the point), poll
    until the bounded capture finishes, and download the .tar.gz trace
    artifact — open it in TensorBoard's profile plugin / Perfetto
    (docs/OBSERVABILITY.md "Device observatory")."""
    import time as _time

    body = _body(
        requests.post(
            f"{args.url}/profile",
            json={"durationS": args.seconds},
            timeout=60,
        )
    )
    capture_id = body["id"]
    deadline = _time.monotonic() + args.seconds + args.pack_timeout
    while True:
        resp = requests.get(
            f"{args.url}/profile/{capture_id}", timeout=120
        )
        ctype = resp.headers.get("Content-Type", "")
        if resp.status_code == 200 and not ctype.startswith(
            "application/json"
        ):
            break  # the artifact bytes
        if resp.status_code not in (200, 202):
            raise SystemExit(
                f"profile capture {capture_id} failed: "
                f"HTTP {resp.status_code} — {resp.text[:300]}"
            )
        if _time.monotonic() > deadline:
            raise SystemExit(
                f"profile capture {capture_id} still not ready after "
                f"{args.seconds + args.pack_timeout:.0f}s"
            )
        _time.sleep(min(0.5, max(0.05, args.seconds / 4)))
    out = args.out or f"profile-{capture_id}.tar.gz"
    with open(out, "wb") as f:
        f.write(resp.content)
    return {
        "id": capture_id,
        "durationS": body["durationS"],
        "out": out,
        "bytes": len(resp.content),
    }


def cmd_profile_status(args) -> dict:
    """GET /profile — the capture history + whichever capture runs now."""
    return _body(requests.get(f"{args.url}/profile", timeout=60))


_FLEET_COLUMNS = (
    # (header, /fleet/stats replica-row key)
    ("REPLICA", "replicaId"),
    ("STATE", "state"),
    ("SCORE", "score"),
    ("QUEUED", "queueDepth"),
    ("RUNNING", "running"),
    ("WORKERS", "workers"),
    ("DEVICES", "devices"),
    ("BREAKERS", "openBreakers"),
    ("BURN", "maxBurnRate"),
    ("URL", "url"),
)


def format_fleet_table(stats: dict) -> str:
    """The `fleet status` table: one row per replica plus a footer of
    router-level counters. Pure string building — unit-testable without
    a server."""
    rows = [[h for h, _ in _FLEET_COLUMNS]]
    for r in stats.get("replicas", []):
        rows.append(
            ["-" if r.get(k) is None else str(r[k]) for _, k in _FLEET_COLUMNS]
        )
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    tenants = stats.get("tenants", {})
    lines.append(
        f"pending={stats.get('pending', 0)} "
        f"handoffs={stats.get('handoffs', 0)} "
        f"admitted={tenants.get('admitted', 0)} "
        f"rejected={tenants.get('rejected', 0)}"
    )
    return "\n".join(lines)


def cmd_fleet_status(args) -> dict:
    """GET /fleet/stats off the ROUTER (--url should point at the fleet
    front door, not a replica) and print the replica table."""
    stats = _body(requests.get(f"{args.url}/fleet/stats", timeout=60))
    print(format_fleet_table(stats))
    raise SystemExit(0)


_TOP_COLUMNS = (
    "REPLICA", "VER", "STATE", "SCORE", "QUEUED", "RUNNING",
    "P95(s)", "BURN", "BREAKERS", "STRAGGLER",
)


def _fmt_cell(v, digits=3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def format_fleet_top(stats: dict, metrics_text: str) -> str:
    """The `fleet top` frame: the /fleet/stats replica table enriched
    with the federated /fleet/metrics view — per-replica job p95 (merged
    across kinds), SLO burn, open breakers, and the party that straggles
    most — plus a fleet-rollup footer. Pure string building, so it is
    unit-testable with canned documents."""
    from ..telemetry.metrics import (
        histogram_quantile,
        histogram_snapshots,
        parse_exposition,
    )

    fams = parse_exposition(metrics_text) if metrics_text else {}
    p95 = {}
    js = fams.get("job_seconds")
    if js is not None:
        for (rep,), snap in histogram_snapshots(
            js, group_by=("replica",)
        ).items():
            if snap.count:
                p95[rep] = histogram_quantile(snap, 0.95)
    stragglers: dict[str, tuple[float, str]] = {}
    st = fams.get("party_straggler_total")
    if st is not None:
        for _, labels, value in st.samples:
            rep, party = labels.get("replica", ""), labels.get("party")
            if party is None:
                continue
            if value > stragglers.get(rep, (0.0, ""))[0]:
                stragglers[rep] = (value, party)
    rows = [list(_TOP_COLUMNS)]
    for r in stats.get("replicas", []):
        rid = r.get("replicaId", "")
        rows.append([
            _fmt_cell(rid),
            # the /readyz buildInfo version per replica — a rolling
            # upgrade reads as a mixed VER column, not a mystery
            _fmt_cell(r.get("version")),
            _fmt_cell(r.get("state")),
            _fmt_cell(r.get("score")),
            _fmt_cell(r.get("queueDepth")),
            _fmt_cell(r.get("running")),
            _fmt_cell(p95.get(rid)),
            _fmt_cell(r.get("maxBurnRate")),
            _fmt_cell(r.get("openBreakers")),
            _fmt_cell(stragglers.get(rid, (0.0, None))[1]),
        ])
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    # fleet-rollup footer from the federated families
    footer = []
    fq = fams.get("fleet_job_quantile_seconds")
    if fq is not None:
        by_kind: dict[str, dict[str, float]] = {}
        for _, labels, value in fq.samples:
            by_kind.setdefault(labels.get("kind", ""), {})[
                labels.get("q", "")
            ] = value
        for kind in sorted(by_kind):
            qs = by_kind[kind]
            footer.append(
                f"{kind}: p50={_fmt_cell(qs.get('0.5'))}s "
                f"p95={_fmt_cell(qs.get('0.95'))}s"
            )
    for gname, label in (
        ("fleet_jobs_per_second", "jobs/s"),
        ("fleet_max_burn_rate", "max-burn"),
        ("fleet_open_breakers", "open-breakers"),
    ):
        fam = fams.get(gname)
        if fam is not None and fam.samples:
            footer.append(f"{label}={_fmt_cell(fam.samples[0][2])}")
    footer.append(f"pending={stats.get('pending', 0)}")
    # per-kind depth: how much prove vs verify work waits at the front
    # door (docs/VERIFY.md)
    by_kind = stats.get("pendingByKind", {})
    for kind in sorted(by_kind):
        footer.append(f"pending[{kind}]={by_kind[kind]}")
    footer.append(f"handoffs={stats.get('handoffs', 0)}")
    lines.append("  ".join(footer))
    return "\n".join(lines)


def cmd_fleet_top(args) -> dict:
    """Live operator view: re-render the enriched replica table from
    /fleet/stats + /fleet/metrics every --interval seconds (--once for a
    single frame, e.g. in scripts)."""
    import time as _time

    while True:
        stats = _body(requests.get(f"{args.url}/fleet/stats", timeout=60))
        resp = requests.get(f"{args.url}/fleet/metrics", timeout=60)
        table = format_fleet_top(
            stats, resp.text if resp.status_code == 200 else ""
        )
        if args.once:
            print(table)
            raise SystemExit(0)
        # clear + home, then the frame — a plain-ANSI `top`
        print("\x1b[2J\x1b[H" + table, flush=True)
        _time.sleep(args.interval)


def cmd_fleet_drain(args) -> dict:
    """POST /fleet/drain/{replica} — ask the router to drain one replica
    (by reported id or URL) and hand its journaled backlog off NOW; no
    SIGTERM access to the replica host needed (docs/FLEET.md)."""
    return _body(
        requests.post(
            f"{args.url}/fleet/drain/{args.replica}", timeout=120
        )
    )


def cmd_perf_run(args) -> dict:
    """Run the per-kernel bench registry locally (no server; on the card
    unless --device names another) and print a compact summary; --out
    writes the full dg16-perf/1 document — gate it later with
    `python -m distributed_groth16_tpu_torch.telemetry.benchgate --check`."""
    from ..telemetry import perf

    try:
        run = perf.run_suite(
            quick=args.quick, select=args.select, reps=args.reps,
            device=args.device,
        )
    except KeyError as e:
        raise SystemExit(f"perf: {e.args[0]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(run, f, indent=2, sort_keys=True)
    summary = {}
    for key, r in sorted(run["kernels"].items()):
        if "error" in r:
            summary[key] = {"error": r["error"]}
        else:
            summary[key] = {
                "medianSeconds": round(r["median_seconds"], 6),
                "itemsPerSec": round(r["items_per_sec"], 1),
                "compileSeconds": (
                    round(r["compile_seconds"], 3)
                    if r.get("compile_seconds") is not None
                    else None
                ),
            }
    return {
        "platform": run["platform"],
        "quick": run["quick"],
        "out": args.out,
        "kernels": summary,
    }


def _load_perf(path: str) -> dict:
    from ..telemetry.benchgate import PerfBaselineError, load_run

    try:
        return load_run(path)
    except PerfBaselineError as e:
        raise SystemExit(f"perf: {e}")


def cmd_perf_top(args) -> dict:
    """Slowest kernels of a recorded run, with the vs-baseline ratio —
    the 'where is the time going NOW' view."""
    from ..telemetry.benchgate import (
        PerfBaselineError,
        default_baseline_path,
        load_baseline,
    )

    run = _load_perf(args.run)
    # anchored to the package, not the CWD — `perf top` run from
    # anywhere still finds the port's baseline
    base_path = args.baseline or default_baseline_path()
    try:
        baseline = load_baseline(base_path)
    except PerfBaselineError as e:
        raise SystemExit(f"perf: {e}")
    base_kernels = (baseline or {}).get("kernels", {})
    entries = []
    for key, r in run["kernels"].items():
        if "error" in r:
            continue
        base = base_kernels.get(key)
        entries.append(
            {
                "key": key,
                "medianSeconds": round(r["median_seconds"], 6),
                "itemsPerSec": round(r.get("items_per_sec", 0), 1),
                "unit": r.get("unit"),
                "vsBaseline": (
                    round(r["median_seconds"] / base["median_seconds"], 3)
                    if base and base["median_seconds"] > 0
                    else None
                ),
            }
        )
    entries.sort(key=lambda e: e["medianSeconds"], reverse=True)
    return {
        "run": args.run,
        # null when the baseline file is absent — every vsBaseline is
        # null then, and the caller can see why
        "baseline": base_path if baseline is not None else None,
        "top": entries[: args.n],
    }


def cmd_perf_diff(args) -> dict:
    """Per-kernel ratio between two recorded runs (B/A: < 1 means B is
    faster) — the before/after view a perf PR ships with. `--markdown`
    prints a GitHub-flavored table instead of JSON (for a CI step
    summary)."""
    run_a, run_b = _load_perf(args.run_a), _load_perf(args.run_b)
    ka, kb = run_a["kernels"], run_b["kernels"]
    rows = {}
    for key in sorted(set(ka) & set(kb)):
        a, b = ka[key], kb[key]
        if "error" in a or "error" in b:
            rows[key] = {"error": a.get("error") or b.get("error")}
            continue
        rows[key] = {
            "aSeconds": round(a["median_seconds"], 6),
            "bSeconds": round(b["median_seconds"], 6),
            "ratio": (
                round(b["median_seconds"] / a["median_seconds"], 3)
                if a["median_seconds"] > 0
                else None
            ),
        }
    out = {
        "a": args.run_a,
        "b": args.run_b,
        "kernels": rows,
        "onlyInA": sorted(set(ka) - set(kb)),
        "onlyInB": sorted(set(kb) - set(ka)),
    }
    if getattr(args, "markdown", False):
        print(format_perf_diff_markdown(out))
        raise SystemExit(0)
    return out


def format_perf_diff_markdown(diff: dict) -> str:
    """The `perf diff --markdown` table — pure string building so the CI
    step-summary path is unit-testable without a runner."""
    lines = [
        f"### perf diff — `{diff['a']}` vs `{diff['b']}`",
        "",
        "| kernel | A (s) | B (s) | B/A |",
        "| --- | --- | --- | --- |",
    ]
    for key in sorted(diff["kernels"]):
        row = diff["kernels"][key]
        if "error" in row:
            lines.append(f"| `{key}` | — | — | errored: {row['error']} |")
            continue
        ratio = row["ratio"]
        flag = ""
        if ratio is not None:
            flag = " 🔺" if ratio > 1.25 else (" ✅" if ratio < 0.8 else "")
        lines.append(
            f"| `{key}` | {row['aSeconds']:.6g} | {row['bSeconds']:.6g} "
            f"| {ratio if ratio is not None else '—'}{flag} |"
        )
    for label, keys in (("only in A", diff["onlyInA"]),
                        ("only in B", diff["onlyInB"])):
        if keys:
            lines.append("")
            lines.append(f"_{label}: {', '.join(keys)}_")
    return "\n".join(lines)


def cmd_perf_roofline(args) -> dict:
    """Roofline attribution table over a recorded dg16-perf/1 run (or a
    fresh quick run on --device, the card by default, when --run is
    absent): achieved multiply-adds/s and B/s, arithmetic intensity,
    fraction of the binding roof, and whether each kernel is compute- or
    memory-bound — against DG16_PEAK_FLOPS / DG16_PEAK_BW or the
    device-kind peak table of this machine (telemetry/roofline.py)."""
    from ..telemetry import roofline

    if args.run:
        run = _load_perf(args.run)
    else:
        from ..telemetry import perf

        try:
            run = perf.run_suite(
                quick=True, select=args.select, reps=args.reps,
                device=args.device,
            )
        except KeyError as e:
            raise SystemExit(f"perf: {e.args[0]}")
    print(roofline.format_table(run))
    raise SystemExit(0)


def cmd_export_eth(args) -> dict:
    """Local conversion — no server round-trip needed."""
    from ..frontend.ark_serde import proof_from_bytes
    from ..frontend.ethereum import proof_to_json, solidity_calldata

    with open(args.proof, "rb") as f:
        proof = proof_from_bytes(f.read())
    return {
        # the raw generatecall string (bracket-less groups) — paste into
        # verifyProof tooling as-is
        "calldata": solidity_calldata(proof, args.public),
        "proof_json": proof_to_json(proof),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dg16-cli")
    p.add_argument("--url", default="http://localhost:8000")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("save")
    sp.add_argument("--name", required=True)
    sp.add_argument("--r1cs", required=True)
    sp.add_argument("--wasm", default=None)
    sp.set_defaults(fn=cmd_save)

    for cmd, fn in (("prove", cmd_prove), ("mpc-prove", cmd_mpc_prove)):
        sp = sub.add_parser(cmd)
        sp.add_argument("--circuit-id", required=True)
        sp.add_argument("--witness", required=True, help=".wtns file")
        sp.add_argument("--out", default=None, help="write proof bytes here")
        sp.add_argument("--l", type=int, default=2)
        sp.set_defaults(fn=fn)

    jp = sub.add_parser(
        "job", help="async jobs API: submit / status / watch (docs/SERVICE.md)"
    )
    jsub = jp.add_subparsers(dest="job_cmd", required=True)

    sp = jsub.add_parser("submit")
    sp.add_argument("--circuit-id", required=True)
    sp.add_argument("--witness", required=True, help=".wtns file")
    sp.add_argument("--mpc", action="store_true", help="packed-MPC proof")
    sp.add_argument("--l", type=int, default=2)
    sp.set_defaults(fn=cmd_job_submit)

    sp = jsub.add_parser("status")
    sp.add_argument("--job-id", required=True)
    sp.set_defaults(fn=cmd_job_status)

    sp = jsub.add_parser("watch")
    sp.add_argument("--job-id", required=True)
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--out", default=None, help="write proof bytes here")
    sp.set_defaults(fn=cmd_job_watch)

    sp = jsub.add_parser(
        "recover",
        help="offline journal inspection: what would a replay re-enqueue "
             "(docs/ROBUSTNESS.md); read-only unless --compact",
    )
    sp.add_argument("--journal", default=None,
                    help="journal directory (default <store>/_journal)")
    sp.add_argument("--store", default="./circuit_store",
                    help="circuit store root holding the journal")
    sp.add_argument("--dry-run", action="store_true",
                    help="read-only inspection (the default; the flag "
                         "exists to spell the intent out)")
    sp.add_argument("--compact", action="store_true",
                    help="ALSO rewrite the journal in place, dropping "
                         "terminal records — only on a journal no live "
                         "service owns")
    sp.set_defaults(fn=cmd_job_recover)

    sp = sub.add_parser(
        "trace",
        help="fetch a job's merged Chrome trace (GET /jobs/{id}/trace); "
             "--router fetches the stitched fleet trace instead",
    )
    sp.add_argument("job_id", help="job id from `job submit`")
    sp.add_argument("--router", default=None,
                    help="fleet router URL: fetch the stitched "
                         "router+replica+MPC trace from "
                         "/fleet/jobs/{id}/trace, falling back to the "
                         "replica route at --url when the router does "
                         "not know the id")
    sp.add_argument("--out", default=None,
                    help="output path (default trace-<jobId>.json)")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "logs",
        help="print the server's structured log ring (GET /logs); "
             "--follow tails it; --router + --job prints the federated "
             "cross-tier stream",
    )
    sp.add_argument("--level", default=None,
                    help="minimum level (DEBUG/INFO/WARNING/ERROR)")
    sp.add_argument("--trace", default=None, help="filter by trace id")
    sp.add_argument("--job", default=None, help="filter by job id")
    sp.add_argument("--limit", type=int, default=256,
                    help="tail cap per fetch (default 256)")
    sp.add_argument("--follow", action="store_true",
                    help="poll the since cursor until interrupted")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="--follow poll period seconds")
    sp.add_argument("--router", default=None,
                    help="fleet router URL: fetch the federated "
                         "router+replica stream from "
                         "/fleet/jobs/{id}/logs (requires --job)")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser(
        "metrics", help="dump the server's /metrics Prometheus text"
    )
    sp.set_defaults(fn=cmd_metrics)

    fp = sub.add_parser(
        "fleet",
        help="fleet-router control plane: replica table, operator drain "
             "(docs/FLEET.md; --url points at the router)",
    )
    fsub = fp.add_subparsers(dest="fleet_cmd", required=True)

    sp = fsub.add_parser("status", help="tabular replica table")
    sp.set_defaults(fn=cmd_fleet_status)

    sp = fsub.add_parser(
        "top",
        help="live-refreshing operator view: replica table enriched "
             "with federated p95/burn/straggler from /fleet/metrics",
    )
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period seconds")
    sp.add_argument("--once", action="store_true",
                    help="print one frame and exit (for scripts)")
    sp.set_defaults(fn=cmd_fleet_top)

    sp = fsub.add_parser(
        "drain",
        help="drain one replica via the router and hand its journaled "
             "jobs off to healthy replicas",
    )
    sp.add_argument("replica", help="replica id (or config URL)")
    sp.set_defaults(fn=cmd_fleet_drain)

    perf_p = sub.add_parser(
        "perf",
        help="per-kernel perf observatory: run the bench registry, rank "
             "slowest kernels, diff two runs, roofline",
    )
    perf_sub = perf_p.add_subparsers(dest="perf_cmd", required=True)

    sp = perf_sub.add_parser("run", help="run the kernel registry locally")
    sp.add_argument("--quick", action="store_true",
                    help="smoke subset of sizes")
    sp.add_argument("--select", nargs="+", metavar="KERNEL", default=None,
                    help="only these registered kernels")
    sp.add_argument("--reps", type=int, default=None,
                    help="warm reps per case (default DG16_PERF_REPS)")
    sp.add_argument("--out", default=None,
                    help="write the full dg16-perf/1 run document here")
    sp.add_argument("--device", default=None,
                    help="device to run on (default: the card, cuda:0; "
                         "cpu runs the plain versions)")
    sp.set_defaults(fn=cmd_perf_run)

    sp = perf_sub.add_parser(
        "top", help="slowest kernels of a recorded run vs baseline"
    )
    sp.add_argument("--run", required=True, help="dg16-perf/1 run JSON")
    sp.add_argument("--baseline", default=None,
                    help="baseline file (default distributed_groth16_tpu_"
                         "torch/tools/perf-baseline.json)")
    sp.add_argument("-n", type=int, default=10, help="rows to show")
    sp.set_defaults(fn=cmd_perf_top)

    sp = perf_sub.add_parser("diff", help="per-kernel ratio of two runs")
    sp.add_argument("run_a", help="baseline-side run JSON (A)")
    sp.add_argument("run_b", help="candidate-side run JSON (B)")
    sp.add_argument("--markdown", action="store_true",
                    help="print a GitHub-flavored table (for CI step "
                         "summaries) instead of JSON")
    sp.set_defaults(fn=cmd_perf_diff)

    sp = perf_sub.add_parser(
        "roofline",
        help="roofline attribution: utilization + compute/memory-bound "
             "classification per device kernel",
    )
    sp.add_argument("--run", default=None,
                    help="dg16-perf/1 run JSON to attribute (default: "
                         "run the quick suite now)")
    sp.add_argument("--select", nargs="+", metavar="KERNEL", default=None,
                    help="only these registered kernels (no --run only)")
    sp.add_argument("--reps", type=int, default=None,
                    help="warm reps per case (no --run only)")
    sp.add_argument("--device", default=None,
                    help="device of the quick run (no --run only; "
                         "default: the card, cuda:0)")
    sp.set_defaults(fn=cmd_perf_roofline)

    pp = sub.add_parser(
        "profile",
        help="on-demand torch.profiler profiling of a LIVE server "
             "(docs/OBSERVABILITY.md \"Device observatory\")",
    )
    psub = pp.add_subparsers(dest="profile_cmd", required=True)

    sp = psub.add_parser(
        "capture",
        help="start a bounded capture mid-job, wait, download the "
             ".tar.gz trace artifact",
    )
    sp.add_argument("--seconds", type=float, default=3.0,
                    help="capture duration (server clamps to "
                         "DG16_PROF_MAX_S)")
    sp.add_argument("--out", default=None,
                    help="artifact path (default profile-<id>.tar.gz)")
    sp.add_argument("--pack-timeout", type=float, default=120.0,
                    help="extra seconds to wait for the artifact pack "
                         "after the capture window closes")
    sp.set_defaults(fn=cmd_profile_capture)

    sp = psub.add_parser("status", help="capture history (GET /profile)")
    sp.set_defaults(fn=cmd_profile_status)

    sp = sub.add_parser(
        "verify",
        help="single proof via POST /verify_proof, or --batch to fold N "
             "proofs into one kind=verify job (docs/VERIFY.md)",
    )
    sp.add_argument("--circuit-id", required=True)
    sp.add_argument("--proof", default=None,
                    help="single-proof mode: ark-compressed proof file")
    sp.add_argument("--public", action="append", default=[], type=int,
                    help="single-proof mode public input (repeatable)")
    sp.add_argument("--batch", action="store_true",
                    help="submit the positional specs as ONE batched "
                         "verify job")
    sp.add_argument("proofs", nargs="*", metavar="PROOF[:PUB,PUB]",
                    help="--batch proof specs: path, optionally "
                         "':'-joined comma-separated public inputs")
    sp.add_argument("--interval", type=float, default=1.0,
                    help="--batch poll period seconds")
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser(
        "aggregate",
        help="verify N proofs and emit one RLC-folded bundle "
             "attestation (POST /jobs/aggregate, docs/VERIFY.md)",
    )
    sp.add_argument("circuit_id", help="circuit id the proofs belong to")
    sp.add_argument("proofs", nargs="+", metavar="PROOF[:PUB,PUB]",
                    help="proof specs: path, optionally ':'-joined "
                         "comma-separated public inputs")
    sp.add_argument("--out", default=None,
                    help="write the bundle JSON here")
    sp.add_argument("--interval", type=float, default=1.0,
                    help="poll period seconds")
    sp.set_defaults(fn=cmd_aggregate)

    sp = sub.add_parser(
        "export-eth",
        help="proof file -> Solidity verifyProof calldata + snarkjs JSON "
             "(the ethereum.rs role, ark-circom/src/ethereum.rs)",
    )
    sp.add_argument("--proof", required=True, help="ark-compressed proof file")
    sp.add_argument("--public", action="append", default=[], type=int)
    sp.set_defaults(fn=cmd_export_eth)

    args = p.parse_args(argv)
    out = json.dumps(args.fn(args), indent=2)
    # machine-consumed outputs (calldata) must never be truncated; the cap
    # only trims chatty server-status bodies
    print(out if args.cmd == "export-eth" else out[:2000])


if __name__ == "__main__":
    sys.exit(main())
