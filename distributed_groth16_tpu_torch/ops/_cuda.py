"""Builder and loader for the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, bound with ctypes (no PyTorch headers, so a build takes
seconds). Libraries are built at the first launch on a CUDA tensor, never
at import, into _build/ next to the sources, named by a digest of every
csrc file so an edited source is rebuilt. `build()` compiles all sources
at once (one nvcc process each, started together).

Each kernel entry is a `Kernel`: calling it launches on the current
stream, raises if the C side reports a CUDA error, and counts the launch
in `Kernel.launches` — the counters a run reads to show which kernels its
main path went through. There is no fallback: a missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# source -> {symbol: argtypes}
_ENTRIES = {
    "limb_group": {
        "dg16_limb_add": [_I, _I, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _P],
        "dg16_limb_double": [_I, _I, _P, _LL, _LL, _P, _LL, _P, _P],
        "dg16_limb_horner": [_I, _I, _P, _LL, _I, _P, _P, _P],
        "dg16_mont_chain": [_I, _P, _LL, _P, _P],
    },
    "ntt_small": {
        "dg16_ntt_small": [_P, _P, _P, _I, _I, _LL, _I, _P, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source -> nvcc/ptxas output of its build


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _lib_path(source: str) -> Path:
    return BUILD / f"{source}-{_digest()}.so"


def build() -> float:
    """Compile every source whose library is missing; returns seconds."""
    t0 = time.perf_counter()
    todo = [s for s in _ENTRIES if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for s in todo:
        tmp = BUILD / f"{s}.{os.getpid()}.tmp.so"
        cmd = [
            nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(CSRC / f"{s}.cu"),
        ]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[s] = out
        if proc.returncode != 0:
            failed.append(f"{s}.cu:\n{out}")
        else:
            tmp.replace(_lib_path(s))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(source)))
        for sym, argtypes in _ENTRIES[source].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


class Kernel:
    """One C entry point; `launches` counts its successful launches."""

    def __init__(self, source: str, symbol: str):
        self.source, self.symbol = source, symbol
        self.launches = 0

    def __call__(self, *args) -> None:
        rc = getattr(library(self.source), self.symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1


# the 32-bit word counts of the base fields the group kernels are built
# for: 8 (BN254), 12 (BLS12-377/381)
GROUP_WORDS = (8, 12)


def kernel_name(op: str, deg: int, nw: int) -> str:
    """Counter name of a group kernel instantiation: limb_add_g1 is kernel
    1 on BN254 G1 (8 words), limb_add_g2_w12 on a BLS12 G2 (12 words)."""
    return f"limb_{op}_g{deg}" + ("" if nw == 8 else f"_w{nw}")


# one counter per kernel instantiation
KERNELS = {
    kernel_name(op, deg, nw): Kernel("limb_group", f"dg16_limb_{op}")
    for nw in GROUP_WORDS
    for op in ("add", "double", "horner")
    for deg in (1, 2)
}
KERNELS["ntt_small"] = Kernel("ntt_small", "dg16_ntt_small")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of tensor t's device, as an int pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_int32(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
