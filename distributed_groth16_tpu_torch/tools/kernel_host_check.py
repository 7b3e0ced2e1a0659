#!/usr/bin/env python3
"""Logic check of kernels 1-3 without a GPU: csrc/limb_group.cu compiled
by a host C++ compiler (g++ 12 or newer, C++20) with DG16_HOST_CHECK, which
swaps the field core's inline PTX for portable C++ with an emulated carry
flag (tools/host_check.cpp holds the shims), run on random points and held
limb for limb against the plain PyTorch versions.

    python3 -m distributed_groth16_tpu_torch.tools.kernel_host_check

It checks the arithmetic and the warp-spread Horner's step order, not the
PTX: only a run on the card (chip_smoke.py phase 3) shows that. The
package never builds or loads this host build.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import refmath
from ..ops.constants import G1_GENERATOR, G2_GENERATOR
from ..ops.curve import g1, g2
from ..ops.limb_kernels import lg1, lg2

HERE = Path(__file__).resolve().parent
OPS = {"add": 0, "double": 1, "horner": 2}


def build(out_dir: Path) -> Path:
    exe = out_dir / "host_check"
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-Wno-unknown-pragmas", "-o", str(exe),
         str(HERE / "host_check.cpp"), "-lpthread"],
        check=True,
    )
    return exe


def points(gname: str, n: int, seed: int) -> torch.Tensor:
    """(ROWS, n) limb-major points with redundant [0, 2p) coordinates and
    the complete formulas' edge cases: infinity, and repeated points."""
    host, gen, curve = (
        (refmath.G1, G1_GENERATOR, g1()) if gname == "g1"
        else (refmath.G2, G2_GENERATOR, g2())
    )
    g = lg1() if gname == "g1" else lg2()
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**62)))
           for _ in range(n - 3)] + [None, gen, gen]
    lm = g.from_rowmajor(curve.encode(pts, "cpu"))
    return g.plain_add(lm, torch.roll(lm, 1, dims=1))  # redundant limbs


def run(exe: Path, g, op: str, c: int, *arrays) -> torch.Tensor:
    n = arrays[0].shape[1]
    hdr = np.array([OPS[op], g.deg, n, c], np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        src.write_bytes(
            hdr.tobytes() + g.kernel_consts.astype(np.uint32).tobytes()
            + b"".join(a.contiguous().numpy().astype(np.int32).tobytes()
                       for a in arrays)
        )
        subprocess.run([str(exe), str(src), str(dst)], check=True)
        out = np.frombuffer(dst.read_bytes(), np.int32)
    return torch.from_numpy(out.copy()).reshape(g.ROWS, -1)


def check(exe: Path, n: int) -> list[str]:
    done = []
    for gname, g in (("g1", lg1()), ("g2", lg2())):
        red = points(gname, n, 1 if gname == "g1" else 2)
        P, Q = red, torch.roll(red, 3, dims=1)
        Q[:, :2] = P[:, :2]  # P + P
        cases = [
            ("add", 0, (P, Q), g.plain_add(P, Q)),
            ("double", 0, (P,), g.plain_double(P)),
        ]
        for W, c in ((2, 4), (3, 8), (5, 4), (32, 8), (64, 4)):
            s = red[:, torch.arange(W) % red.shape[1]]  # equal columns
            cases.append(("horner", c, (s,), g.plain_horner(s, c)))
        for op, c, args, want in cases:
            got = run(exe, g, op, c, *args)
            if not torch.equal(got, want.reshape(got.shape)):
                raise AssertionError(f"{op} {gname} W/n={args[0].shape[1]} "
                                     f"c={c}: host build differs from plain")
            done.append(f"{op}_{gname}[{args[0].shape[1]}, c={c}]")
    return done


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=24, help="points per batch")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(Path(tmp))
        done = check(exe, args.n)
    print("host build == plain versions: " + ", ".join(done))
    return 0


if __name__ == "__main__":
    sys.exit(main())
