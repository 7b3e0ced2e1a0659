"""Spawn a star of one example, one fresh interpreter per rank, and
collect each rank's last JSON line — the role of the JAX package's
scripts/_launch_ranks.sh and scripts/nonlocal_sha256.sh, in Python.

  python -m distributed_groth16_tpu_torch.examples.launch --n 8 \\
      [--plain] [--work-dir DIR] [--deadline S] \\
      nonlocal_sha256 -- --circuit sha256 --msg abc [--device cpu]

It writes the certs (unless --plain) and an address file of free
localhost ports into the work directory, starts the ranks with
`sys.executable -m distributed_groth16_tpu_torch.examples.<example>
--id i --input <addresses> --certs <dir> --n N [--plain] <args>`, each
with its output in <work>/rank<i>.log, and waits under the deadline.
When one rank fails (or the deadline passes) it kills the others and
raises with the tail of every log. It prints, and `launch` returns, each
rank's last JSON line in rank order.

Ranks are fresh interpreters, never forks: a process that has touched
CUDA must not fork.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "distributed_groth16_tpu_torch.examples"


class StarFailed(RuntimeError):
    """A rank exited non-zero, printed no JSON line, or the star outlived
    its deadline; the message holds the tail of every rank's log."""


def free_ports(n: int) -> list[int]:
    """n distinct free localhost ports: each bound to port 0 and held
    until all are chosen, then released for the ranks to bind."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def write_certs(n: int, cert_dir: Path) -> None:
    """<rank>.cert.pem / <rank>.key.pem for every rank."""
    from ..utils.certs import gen_self_signed

    cert_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        cert, key = gen_self_signed(str(i))
        (cert_dir / f"{i}.cert.pem").write_bytes(cert)
        (cert_dir / f"{i}.key.pem").write_bytes(key)


def _tail(path: Path, lines: int = 20) -> str:
    try:
        text = path.read_text(errors="replace").splitlines()
    except OSError:
        return "(no log)"
    return "\n".join(text[-lines:])


def _last_json(path: Path) -> dict | None:
    for line in reversed(path.read_text(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def _run_star(example: str, n: int, args: list[str], work: Path,
              plain: bool, deadline_s: float,
              rank_args: dict[int, list[str]]) -> list[dict]:
    addr = work / "addresses"
    addr.write_text("".join(f"127.0.0.1:{p}\n" for p in free_ports(n)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["PYTHONUNBUFFERED"] = "1"  # a failed rank's log holds its last words
    logs = [work / f"rank{i}.log" for i in range(n)]
    procs: dict[int, subprocess.Popen] = {}
    failed, lines = None, []
    try:
        for i in reversed(range(n)):  # clients first, the king last
            cmd = [sys.executable, "-m", f"{PACKAGE}.{example}",
                   "--id", str(i), "--input", str(addr),
                   "--certs", str(work / "certs"), "--n", str(n),
                   *(["--plain"] if plain else []), *args,
                   *rank_args.get(i, [])]
            with open(logs[i], "wb") as out:
                procs[i] = subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT),
                )
        end = time.monotonic() + deadline_s
        while True:
            codes = {i: p.poll() for i, p in procs.items()}
            bad = [i for i, c in codes.items() if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes.values()):
                break
            if time.monotonic() > end:
                failed = f"deadline of {deadline_s} s passed"
                break
            time.sleep(0.1)
        if failed is None:
            lines = [_last_json(log) for log in logs]
            if None in lines:
                failed = f"rank {lines.index(None)} printed no JSON line"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            p.wait(timeout=30)
    if failed:
        tails = "\n".join(f"--- rank {i} ({logs[i]}) ---\n{_tail(logs[i])}"
                          for i in range(n))
        raise StarFailed(f"{example} star of {n}: {failed}\n{tails}")
    return lines


def launch(example: str, n: int, args: list[str] = (), *,
           work_dir: str | None = None, plain: bool = False,
           deadline_s: float = 600.0,
           rank_args: dict[int, list[str]] | None = None) -> list[dict]:
    """Run one star of `example` over n ranks; returns each rank's last
    JSON line in rank order. `rank_args` appends arguments to the given
    ranks' command lines (e.g. a device per rank). A failed star raises
    StarFailed: it is not run again."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(work_dir or tmp)
        work.mkdir(parents=True, exist_ok=True)
        if not plain:
            write_certs(n, work / "certs")
        return _run_star(example, n, list(args), work, plain, deadline_s,
                         rank_args or {})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="spawn a star of one example, one process per rank")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--plain", action="store_true", help="TCP without TLS")
    p.add_argument("--work-dir", default=None,
                   help="certs, address file and rank logs (default: a "
                        "temporary directory, removed afterwards)")
    p.add_argument("--deadline", type=float, default=600.0,
                   help="seconds the whole star may take")
    p.add_argument("example",
                   choices=("add_ids", "nonlocal_kernel", "nonlocal_sha256"))
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="the example's own arguments, after --")
    a = p.parse_args(argv)
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    lines = launch(a.example, a.n, args, work_dir=a.work_dir, plain=a.plain,
                   deadline_s=a.deadline)
    for line in lines:
        print(json.dumps(line))
    return 0 if all(line.get("ok") for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
