#!/usr/bin/env python3
"""Logic check of kernels 1-4 without a GPU: csrc/limb_group.cu and
csrc/ntt_small.cu compiled by a host C++ compiler (g++ 12 or newer, C++20)
with DG16_HOST_CHECK, which swaps the field core's inline PTX for portable
C++ with an emulated carry flag (tools/host_check.cpp holds the shims and
runs warps and blocks as host threads), run on random inputs and held limb
for limb against the plain PyTorch versions.

    python3 -m distributed_groth16_tpu_torch.tools.kernel_host_check

Cases: kernel 1 at 24 columns; kernel 2 at ragged widths (a point per lane
of a block's three warps: partial warps and blocks) and on a strided
input; Horner at W = 2, 3, 5, 32, 64; kernel 4 at S = 2 ... 256 on ragged
column counts (an odd and an even number of stages), both directions.
Inputs carry redundant [0, 2p) values, and the points infinity and
repeats.

It checks the arithmetic, the step order and the lane and thread
exchanges, not the PTX: only a run on the card (chip_smoke.py phase 3)
shows that. The package never builds or loads this host build.
"""

from __future__ import annotations

import argparse
import random
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import refmath
from ..ops.constants import G1_GENERATOR, G2_GENERATOR, R
from ..ops.curve import g1, g2
from ..ops.limb_kernels import lg1, lg2
from ..ops.ntt_limb import _ntt_consts, _small

HERE = Path(__file__).resolve().parent
OPS = {"add": 0, "double": 1, "horner": 2, "ntt_small": 3}
# (kernel, group): one check each; kernel 4 runs over Fr
CASES = [(k, gname) for k in ("add", "double", "horner")
         for gname in ("g1", "g2")] + [("ntt_small", "fr")]
DOUBLE_WIDTHS = (1, 2, 3, 4, 5, 9, 33, 41, 4097)
HORNER_CASES = ((2, 4), (3, 8), (5, 4), (32, 8), (64, 4))
NTT_SHAPES = ((2, 3), (4, 1), (32, 33), (64, 3), (128, 129), (256, 1),
              (256, 3))
BASE_POINTS = 24


def gxx() -> str | None:
    """A g++ of major version 12 or newer on PATH, else None."""
    exe = shutil.which("g++")
    if exe is None:
        return None
    ver = subprocess.run([exe, "-dumpversion"], capture_output=True,
                         text=True).stdout.strip()
    try:
        return exe if int(ver.split(".")[0]) >= 12 else None
    except ValueError:
        return None


def build(out_dir: Path) -> Path:
    exe, cxx = out_dir / "host_check", gxx()
    if cxx is None:
        raise RuntimeError("kernel_host_check needs g++ 12 or newer")
    subprocess.run(
        [cxx, "-std=c++20", "-O2", "-Wno-unknown-pragmas", "-o", str(exe),
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


def run(exe: Path, hdr, *arrays) -> np.ndarray:
    """One host_check run: the 6-word header, then the words of each
    array in turn; returns the output words."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        src.write_bytes(np.array(hdr, np.int32).tobytes() + b"".join(
            np.ascontiguousarray(a).tobytes() for a in arrays))
        subprocess.run([str(exe), str(src), str(dst)], check=True)
        return np.frombuffer(dst.read_bytes(), np.int32).copy()


def _consts(g) -> np.ndarray:
    return g.kernel_consts.astype(np.uint32)


def _i32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().astype(np.int32)


def group_cases(kernel: str, gname: str):
    """(label, header, arrays, want) of each run of a group kernel."""
    g = lg1() if gname == "g1" else lg2()
    red = points(gname, BASE_POINTS, 1 if gname == "g1" else 2)
    op, deg = OPS[kernel], g.deg
    if kernel == "add":
        P, Q = red, torch.roll(red, 3, dims=1)
        Q[:, :2] = P[:, :2]  # P + P
        n = P.shape[1]
        yield (f"n={n}", [op, deg, n, 0, 1, 0], (_consts(g), _i32(P),
                                                 _i32(Q)), g.plain_add(P, Q))
    elif kernel == "double":
        for n in DOUBLE_WIDTHS:
            P = red[:, torch.arange(n) % BASE_POINTS]
            yield (f"n={n}", [op, deg, n, 0, 1, 0], (_consts(g), _i32(P)),
                   g.plain_double(P))
        # a strided view: every other column of a (ROWS, 2n) batch
        n = 33
        wide = red[:, torch.arange(2 * n) % BASE_POINTS]
        yield (f"n={n} column stride 2", [op, deg, n, 0, 2, 0],
               (_consts(g), _i32(wide)), g.plain_double(wide[:, ::2]))
    else:
        for W, c in HORNER_CASES:
            s = red[:, torch.arange(W) % BASE_POINTS]  # equal columns
            yield (f"W={W} c={c}", [op, deg, W, c, 1, 0],
                   (_consts(g), _i32(s)), g.plain_horner(s, c))


def _fr_limbs(rng: random.Random, S: int, L: int) -> np.ndarray:
    """int32[16, S, L] of values in [0, 2r): redundant, as the second
    half of a transform sees them after its twiddle multiply."""
    vals = [rng.randrange(2 * R) for _ in range(S * L)]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    limbs = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return limbs.reshape(S * L, 16).T.reshape(16, S, L).copy()


def ntt_cases():
    rng = random.Random(4)
    for S, L in NTT_SHAPES:
        x = _fr_limbs(rng, S, L)
        for inverse in (False, True):
            nt = _small(S, inverse)
            yield (f"S={S} L={L} inverse={inverse}",
                   [OPS["ntt_small"], 0, S, L, nt.cpb, 0],
                   (_ntt_consts(), nt.tw_np, x), nt.plain(torch.from_numpy(x)))


def check(exe: Path, kernel: str, gname: str) -> list[str]:
    """Runs the host build on every case of one kernel and group; raises on
    the first that differs from the plain version."""
    cases = ntt_cases() if kernel == "ntt_small" else group_cases(kernel,
                                                                  gname)
    done = []
    for label, hdr, arrays, want in cases:
        got = run(exe, hdr, *arrays)
        if not np.array_equal(got, want.numpy().reshape(-1)):
            raise AssertionError(f"{kernel} {gname} {label}: host build "
                                 "differs from the plain version")
        done.append(f"{kernel}_{gname}[{label}]")
    return done


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(Path(tmp))
        done = [d for k, gname in CASES for d in check(exe, k, gname)]
    print("host build == plain versions: " + ", ".join(done))
    return 0


if __name__ == "__main__":
    sys.exit(main())
