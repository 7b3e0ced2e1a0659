"""Roofline attribution: name each kernel compute- or memory-bound; the
counterpart of the JAX package's telemetry/roofline.py.

The perf registry records each device case's work (`cost`: the work
model of telemetry/perf_kernels.py, computed from the case's inputs)
next to its measured warm seconds; this module closes the loop against
per-device peak tables so a perf run and `perf roofline` can say not
just *that* a kernel is slow but *which wall it leans on*:

    arithmetic intensity  AI   = flops / bytes_accessed
    ridge intensity             = peak_flops / peak_bw
    bound                       = compute if AI >= ridge else memory
    utilization                 = achieved / roof-at-AI  (fraction of the
                                  binding roof)

In the port a record's `flops` field counts 32-bit integer multiply-adds
(IMAD), not floating-point operations: the limb kernels do no floating
point, and the H100's peak for their work is its IMAD rate. One
nw-word Montgomery product is 4 nw^2 + nw multiply-adds
(`imad_per_fq_mul`), a complete G1 add 14 products and a doubling 9
(`FQ_MULS`), a G2 (Fq2) point op three times that.

Peaks come from `DG16_PEAK_FLOPS` / `DG16_PEAK_BW` when set, else the
device-kind table below (the H100: 132 SMs x 64 IMAD a clock x its
1,980 MHz maximum SM clock, and 3.35 TB/s of HBM3), else a deliberately
conservative host-class default for the CPU, whose utilization numbers
are for trend only. `bound` is the least time of a kernel's work at a
peak; chip_smoke.py computes its bound column with it, from the card's
own SM count and maximum clock.
"""

from __future__ import annotations

from ..utils import config as _config

# 32-bit integer multiply(-add) results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table)
IMAD_PER_SM_CLOCK = 64
# H100 SXM: 132 SMs, 1,980 MHz maximum SM clock, HBM3 bandwidth (NVIDIA
# data sheet)
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0
HBM_BYTES_PER_S = 3.35e12
# Montgomery products per complete point op on G1 (RCB16); G2 triples
FQ_MULS = {"add": 14, "double": 9}


def imad_per_fq_mul(nw: int) -> int:
    """32-bit multiply-adds of one nw-word CIOS Montgomery product: 2 nw^2
    32x32->64 products (a_j*b_i and m*p_j), two halves each, + nw for m:
    264 at 8 words, 588 at 12."""
    return 4 * nw * nw + nw


def imad_peak(sms: int, clock_mhz: float) -> float:
    """32-bit multiply-adds per second of a card of `sms` SMs at
    `clock_mhz`."""
    return sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6


# (device_kind prefix, peak multiply-adds/sec, peak memory bytes/sec),
# matched by prefix against torch.cuda.get_device_name()
PEAKS_BY_DEVICE_KIND: tuple = (
    ("NVIDIA H100", imad_peak(H100_SMS, H100_MAX_SM_MHZ), HBM_BYTES_PER_S),
)

# host-class fallback (the CPU, unknown kinds): a few-core x86 container —
# utilization against it is a trend signal, not a contract
DEFAULT_PEAK_FLOPS = 1e11
DEFAULT_PEAK_BW = 5e10


def device_kind(device=None) -> str:
    """The device's kind: torch.cuda.get_device_name() for a CUDA device
    (None: the current card), "cpu" for a CPU device, "unknown" when
    there is no card to name."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    try:
        return str(torch.cuda.get_device_name(device))
    except Exception:  # noqa: BLE001 — no card: attribute against defaults
        return "unknown"


def peaks(kind: str | None = None) -> dict:
    """The peak table one attribution run uses:
    {flops, bw, deviceKind, source} with source one of `env`,
    `device:<kind>`, `default`. Env knobs override per-field."""
    kind = kind if kind is not None else device_kind()
    flops = bw = None
    source = "default"
    for prefix, f, b in PEAKS_BY_DEVICE_KIND:
        if kind.startswith(prefix):
            flops, bw = f, b
            source = f"device:{prefix}"
            break
    if flops is None:
        flops, bw = DEFAULT_PEAK_FLOPS, DEFAULT_PEAK_BW
    env_flops = _config.env_float("DG16_PEAK_FLOPS", 0.0)
    env_bw = _config.env_float("DG16_PEAK_BW", 0.0)
    if env_flops > 0 or env_bw > 0:
        source = "env"
        if env_flops > 0:
            flops = env_flops
        if env_bw > 0:
            bw = env_bw
    return {"flops": flops, "bw": bw, "deviceKind": kind, "source": source}


def bound(nbytes: float, fq_muls: float, nw: int = 8,
          peak: dict | None = None) -> tuple[float, str]:
    """Least time (ms) for a kernel's work and what binds it: the larger
    of nbytes over the memory rate and fq_muls nw-word Montgomery
    products (imad_per_fq_mul multiply-adds each) over the multiply-add
    rate, from `peak` ({flops, bw}; None: peaks())."""
    pk = peak if peak is not None else peaks()
    t_bytes = nbytes / pk["bw"]
    t_ops = fq_muls * imad_per_fq_mul(nw) / pk["flops"]
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def attribute(
    cost: dict | None, median_seconds: float, peak: dict | None = None
) -> dict | None:
    """One kernel's roofline attribution from its work model and measured
    warm seconds; None when there is nothing to attribute (host kernel,
    no cost model, zero time)."""
    if not cost or median_seconds <= 0:
        return None
    flops = float(cost.get("flops") or 0.0)
    nbytes = float(cost.get("bytes_accessed") or 0.0)
    if flops <= 0 and nbytes <= 0:
        return None
    pk = peak if peak is not None else peaks()
    achieved_flops = flops / median_seconds
    achieved_bw = nbytes / median_seconds
    ridge = pk["flops"] / pk["bw"]
    if nbytes <= 0:
        bound = "compute"
        utilization = achieved_flops / pk["flops"]
    elif flops <= 0:
        bound = "memory"
        utilization = achieved_bw / pk["bw"]
    else:
        ai = flops / nbytes
        bound = "compute" if ai >= ridge else "memory"
        # the roof at this AI: min(peak_flops, AI * peak_bw) flops/sec
        roof = min(pk["flops"], ai * pk["bw"])
        utilization = achieved_flops / roof
    out = {
        "flops_per_sec": achieved_flops,
        "bytes_per_sec": achieved_bw,
        "arithmetic_intensity": (flops / nbytes) if nbytes > 0 else None,
        "ridge_intensity": ridge,
        "bound": bound,
        "utilization": utilization,
        "peak_flops": pk["flops"],
        "peak_bw": pk["bw"],
        "peak_source": pk["source"],
    }
    return out


def _fmt_rate(v: float | None, unit: str) -> str:
    if v is None:
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if v >= scale:
            return f"{v / scale:.2f}{suffix}{unit}"
    return f"{v:.2f}{unit}"


_COLUMNS = (
    "KERNEL", "SECONDS", "FLOP/S", "B/S", "AI", "UTIL%", "BOUND",
)


def format_table(run: dict, peak: dict | None = None) -> str:
    """The `perf roofline` table from a dg16-perf/1 run document. Pure
    string building (unit-testable): device records with a cost model get
    attribution rows (re-derived against `peak`, so a recorded run can be
    re-attributed under different peak tables); host/errored/costless
    records are footnoted, never silently dropped. The strings are the
    JAX package's, so a document from either package reads the same."""
    pk = peak if peak is not None else peaks()
    rows = [list(_COLUMNS)]
    skipped: list[str] = []
    for key in sorted(run.get("kernels", {})):
        rec = run["kernels"][key]
        if "error" in rec:
            skipped.append(f"{key} (errored)")
            continue
        if rec.get("host"):
            skipped.append(f"{key} (host kernel, no XLA cost model)")
            continue
        att = attribute(rec.get("cost"), rec.get("median_seconds", 0.0), pk)
        if att is None:
            skipped.append(f"{key} (no cost model)")
            continue
        ai = att["arithmetic_intensity"]
        rows.append([
            key,
            f"{rec['median_seconds']:.6g}",
            _fmt_rate(att["flops_per_sec"], ""),
            _fmt_rate(att["bytes_per_sec"], ""),
            f"{ai:.2f}" if ai is not None else "-",
            f"{att['utilization'] * 100:.3g}",
            att["bound"],
        ])
    widths = [max(len(r[i]) for r in rows) for i in range(len(_COLUMNS))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    lines.append(
        f"peaks: {_fmt_rate(pk['flops'], 'FLOP/s')} / "
        f"{_fmt_rate(pk['bw'], 'B/s')} "
        f"(ridge {pk['flops'] / pk['bw']:.2f} flop/byte, "
        f"{pk['source']}, device {pk['deviceKind']})"
    )
    for s in skipped:
        lines.append(f"  - {s}")
    return "\n".join(lines)
