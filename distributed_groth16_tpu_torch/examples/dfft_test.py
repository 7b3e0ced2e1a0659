"""d_fft correctness example — the port of the JAX package's
examples/dfft_test.py (dist-primitives/examples/dfft_test.rs): the
distributed FFT over n = 4l parties simulated in one process
(LocalSimNet), against the plain domain FFT.

  python -m distributed_groth16_tpu_torch.examples.dfft_test \\
      [--m 32768] [--l 2] [--check refmath|ntt] [--device cpu]

BASELINE config 3 is --m 4194304 (2^22) --l 2.

The flags, defaults and printed lines are the JAX example's, plus
--device (default cuda; only an explicit cpu runs on the CPU) and
--check. The last output line is JSON: run()'s dict.

Departures from the JAX example:
  * the inputs are drawn with numpy (seed 0) as standard-form limbs
    below 2^253 (< r) and put in Montgomery form on the device, where the
    JAX example draws Python ints with random.Random(0): at 2^22 the ints,
    their encode and the ground truth's decode are minutes of host work;
  * --check ntt holds the result against the card's limb NTT
    (ops/ntt.py domain(m).fft, kernel 4) as canonical limbs, plus a
    refmath spot check at SPOT_POINTS points w^k (Horner over the m
    coefficients on the host). The default, refmath, compares every
    value with rm.Domain(m).fft as the JAX example does;
  * the timed windows end in torch.cuda.synchronize() (block_until_ready
    in JAX); host work (the draw, the ground truth) is timed apart as
    host_s.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import refmath as rm
from ..ops.constants import N_LIMBS, R
from ..ops.field import fr
from ..ops.ntt import domain
from ..parallel.dfft import d_fft
from ..parallel.net import simulate_network_round
from ..parallel.packing import pack_strided, unpack_shares
from ..parallel.pss import pss
from ._star import drain, open_device

# the top limb of a draw keeps 13 bits: values below 2^253 < r
_TOP_MASK = (1 << 13) - 1
# --check ntt: refmath spot checks at w^1 and one more point
SPOT_POINTS = 2


def draw_fr(m: int) -> np.ndarray:
    """(m, 16) int32 standard-form limbs of m values below 2^253, from
    numpy's generator at seed 0."""
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(m, N_LIMBS), dtype=np.int32)
    limbs[:, -1] &= _TOP_MASK
    return limbs


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """Standard-form limb rows -> Python ints."""
    raw = limbs.astype("<u2").tobytes()
    nb = 2 * N_LIMBS
    return [int.from_bytes(raw[i : i + nb], "little")
            for i in range(0, len(raw), nb)]


def spot_values(x: list[int], m: int, ks) -> list[int]:
    """FFT outputs k of `ks` on the host: sum_i x_i w^(ik) by Horner."""
    w = rm.Domain(m).group_gen
    out = []
    for k in ks:
        wk, acc = pow(w, k, R), 0
        for c in reversed(x):
            acc = (acc * wk + c) % R
        out.append(acc)
    return out


def run(m: int = 1 << 15, l: int = 2, check: str = "refmath",
        device=None) -> dict:
    dev = open_device(device)
    F = fr()
    pp = pss(l)
    host_s = 0.0

    t0 = time.perf_counter()
    limbs = draw_fr(m)
    host_s += time.perf_counter() - t0
    x_mont = F.to_mont(torch.as_tensor(limbs, device=dev))

    drain(dev)
    t0 = time.perf_counter()
    shares = pack_strided(pp, x_mont)
    drain(dev)
    pack_s = time.perf_counter() - t0
    print(f"packed {m} elements in {pack_s:.2f}s")

    async def party(net, share):
        return await d_fft(share, False, 1, False, domain(m), pp, net)

    t0 = time.perf_counter()
    outs = simulate_network_round(pp.n, party,
                                  [shares[i] for i in range(pp.n)])
    drain(dev)
    dfft_s = time.perf_counter() - t0
    print(f"d_fft (n={pp.n}) in {dfft_s:.2f}s")
    got = unpack_shares(pp, torch.stack(outs, 0))
    del outs, shares

    check_s = 0.0
    if check == "refmath":
        t0 = time.perf_counter()
        x = limbs_to_ints(limbs)
        ok = [int(v) for v in F.decode(got)] == rm.Domain(m).fft(x)
        host_s += time.perf_counter() - t0
        print(f"matches host NTT ground truth: {ok}")
    elif check == "ntt":
        t0 = time.perf_counter()
        want = domain(m).fft(x_mont)
        ok_ntt = torch.equal(got, want)
        drain(dev)
        check_s = time.perf_counter() - t0
        del want
        t0 = time.perf_counter()
        ks = [1] + [int(k) for k in np.random.default_rng(1).integers(
            2, m, SPOT_POINTS - 1)]
        host = spot_values(limbs_to_ints(limbs), m, ks)
        idx = torch.as_tensor(ks, device=dev)
        ok_spot = [int(v) for v in F.decode(got[idx])] == host
        host_s += time.perf_counter() - t0
        ok = ok_ntt and ok_spot
        print(f"matches the card's limb NTT: {ok_ntt}; "
              f"refmath at w^k, k in {ks}: {ok_spot}")
    else:
        raise ValueError(f"unknown check {check!r}")
    return {"m": m, "l": l, "n": pp.n, "check": check, "ok": ok,
            "pack_s": pack_s, "dfft_s": dfft_s, "check_s": check_s,
            "host_s": host_s, "device": str(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--m", type=int, default=1 << 15)
    p.add_argument("--l", type=int, default=2)
    p.add_argument("--check", choices=("refmath", "ntt"), default="refmath")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    res = run(args.m, args.l, args.check, args.device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
