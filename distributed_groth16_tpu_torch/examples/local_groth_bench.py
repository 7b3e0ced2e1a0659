"""Per-party Groth16 cost model — the port of the JAX package's
examples/local_groth_bench.py (groth16/examples/local_groth_bench.rs:
54-158): the 6 FFTs + 5 MSMs one party executes per distributed proof,
timed phase by phase on the device.

Same operation inventory: 3 IFFT(m) + 3 FFT(2m) + 1 IFFT(2m) over Fr,
then the five query MSMs S(m)·G1, V(m)·G2, H(m)·G1, W(m)·G1, U(2m)·G1 —
plus the reference's preprocessing/memory accounting (its rs:55-80
comment block) evaluated for the chosen (m, l).

  python -m distributed_groth16_tpu_torch.examples.local_groth_bench \\
      [--log2-m 15] [--l 2] [--no-g2] [--device cpu]

Prints one JSON line per phase and a final summary line (the JAX
example's), then run()'s dict as the last line. --device (default cuda;
only an explicit cpu runs on the CPU) is the one flag added.

Departures from the JAX example:
  * every timed phase ends in torch.cuda.synchronize() (JAX blocks on the
    result when it has block_until_ready); the summary's "backend" is the
    device's name and "note" says that first calls include the kernels'
    nvcc build and table set-up, where JAX's say jit compile;
  * the dummy CRS's pool of random multiples of G (the JAX example's
    draws) comes from the device's fixed-base multiply (ops/fixedbase.py)
    where JAX takes host refmath scalar multiplications: the same points,
    without 1,088 host multiplications (~12 s on a CPU core); it is
    reported as crs_setup, as in JAX.
"""

# dg16lint: disable-file=DG108 — the printed lines are the example's output
# contract, as in the JAX example

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.constants import R
from ..ops.curve import g1, g2
from ..ops.field import fr
from ..ops.fixedbase import fixed_base_mul
from ..ops.msm import encode_scalars_std, msm
from ..ops.ntt import domain
from ._star import drain, draw_scalars, open_device


def accounting(m: int, l: int) -> dict:
    """Field-element counts, in units of m/l shares per party (rs:55-80)."""
    return {
        "preprocessing_uvw_shares": 21 * m // l,  # 3x (m/l + 2*2m/l + 2m/l)
        "preprocessing_h_shares": 4 * m // l,
        "uvw_live_shares": 3 * (2 * m // l),
        "h_live_shares": 2 * m // l,
        "crs_g1_points": 4 * m + m,  # s + w + h (m each) + u (2m)
        "crs_g2_points": m,
    }


def run(log2_m: int = 15, l: int = 2, g2_msm: bool = True,
        device=None) -> dict:
    dev = open_device(device)
    m = 1 << log2_m
    F = fr()
    dom = domain(m)
    dom2 = domain(2 * m)

    # --- memory / preprocessing accounting (rs:55-80) ----------------------
    acct = accounting(m, l)
    print(json.dumps({"phase": "accounting", "m": m, "l": l, **acct}))
    phases: dict = {}

    def timed(name, fn):
        drain(dev)
        t0 = time.perf_counter()
        out = fn()
        drain(dev)
        dt = time.perf_counter() - t0
        print(json.dumps({"phase": name, "seconds": round(dt, 4)}))
        phases[name] = dt
        return out, dt

    total = 0.0

    # --- 6 FFTs + h combine (rs:85-122) ------------------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ev = F.encode([int(x) for x in rng.integers(0, 1 << 62, size=m)], dev)
    host_s = time.perf_counter() - t0
    p_ev = q_ev = w_ev = ev

    c_p, dt = timed("ifft_m_p", lambda: dom.ifft(p_ev)); total += dt
    c_q, dt = timed("ifft_m_q", lambda: dom.ifft(q_ev)); total += dt
    c_w, dt = timed("ifft_m_w", lambda: dom.ifft(w_ev)); total += dt
    e_p, dt = timed("fft_2m_p", lambda: dom2.fft(c_p)); total += dt
    e_q, dt = timed("fft_2m_q", lambda: dom2.fft(c_q)); total += dt
    e_w, dt = timed("fft_2m_w", lambda: dom2.fft(c_w)); total += dt
    h_ev, dt = timed(
        "h_combine", lambda: F.sub(F.mul(e_p, e_q), e_w)
    ); total += dt
    h_coeff, dt = timed("ifft_2m_h", lambda: dom2.ifft(h_ev)); total += dt

    # --- dummy CRS (rs:21-52: doubling chains off a random base) -----------
    C1, C2 = g1(), g2()

    def chain(which, k, pool):
        # the reference builds its dummy CRS as a doubling chain off one
        # random point (rs:21-52); distribution-equivalent: a small pool
        # of random multiples of G (the JAX example's draws), tiled to
        # length k
        ks = rng.integers(1, 1 << 30, size=k)
        pts = fixed_base_mul(
            which, encode_scalars_std([int(x) for x in ks[:pool]], dev))
        return pts[torch.arange(k, device=dev) % pool]

    def chain_g1(k):
        return chain("g1", k, 256)

    def chain_g2(k):
        return chain("g2", k, 64)

    t0 = time.perf_counter()
    s_q = chain_g1(m)
    w_q = chain_g1(m)
    h_q = chain_g1(m)
    u_q = chain_g1(2 * m)
    v_q = chain_g2(m) if g2_msm else None
    crs_s = time.perf_counter() - t0
    print(json.dumps({"phase": "crs_setup", "seconds": round(crs_s, 4)}))

    t0 = time.perf_counter()
    a_share = encode_scalars_std(draw_scalars(rng, m, R), dev)
    host_s += time.perf_counter() - t0
    h_std = F.from_mont(h_coeff)

    # --- the 5 MSMs (rs:140-152) -------------------------------------------
    _, dt = timed("msm_s_g1_m", lambda: msm(C1, s_q, a_share)); total += dt
    if g2_msm:
        _, dt = timed("msm_v_g2_m", lambda: msm(C2, v_q, a_share))
        total += dt
    _, dt = timed("msm_h_g1_m", lambda: msm(C1, h_q, a_share)); total += dt
    _, dt = timed("msm_w_g1_m", lambda: msm(C1, w_q, a_share)); total += dt
    _, dt = timed("msm_u_g1_2m", lambda: msm(C1, u_q, h_std[: 2 * m]))
    total += dt

    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu")
    print(json.dumps({
        "phase": "total",
        "seconds": round(total, 3),
        "m": m,
        "backend": backend,
        "note": "first-call timings include the kernels' build and table "
                "set-up; rerun for steady state",
    }))
    return {"m": m, "l": l, "accounting": acct, "phases_s": phases,
            "total_s": total, "crs_setup_s": crs_s, "host_s": host_s,
            "device": str(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log2-m", type=int, default=15)
    ap.add_argument("--l", type=int, default=2,
                    help="packing parameter (memory accounting only)")
    ap.add_argument("--no-g2", dest="g2", action="store_false",
                    default=True, help="skip the V·G2 MSM (fast smoke runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.log2_m, args.l, args.g2, args.device)))


if __name__ == "__main__":
    main()
