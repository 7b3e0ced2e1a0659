"""The port's perf observatory (telemetry/perf.py, perf_kernels.py,
roofline.py, compile.py, benchgate.py and the CLI's `perf` group of
distributed_groth16_tpu_torch) against the JAX package's on the CPU, on
the same inputs: the registry's cases, the gate's verdicts and reports,
the roofline's attribution and table, the record, the CLI's `top` and
`diff` output. Where a case reaches a kernel, its plain version runs here
and its result is held to the JAX package or refmath exactly (integers:
tolerance zero)."""

import json

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.api import cli as jcli
from distributed_groth16_tpu.telemetry import benchgate as jbg
from distributed_groth16_tpu.telemetry import perf as jperf
from distributed_groth16_tpu.telemetry import perf_kernels as jpk
from distributed_groth16_tpu.telemetry import roofline as jroof
from distributed_groth16_tpu_torch.api import cli as tcli
from distributed_groth16_tpu_torch.telemetry import benchgate as tbg
from distributed_groth16_tpu_torch.telemetry import compile as tcompile
from distributed_groth16_tpu_torch.telemetry import metrics as tm
from distributed_groth16_tpu_torch.telemetry import perf as tperf
from distributed_groth16_tpu_torch.telemetry import perf_kernels as tpk
from distributed_groth16_tpu_torch.telemetry import roofline as troof

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the cases the port adds so that every hand-written kernel launches in one
PORT_CASES = {"msm_g2_tree", "msm_g1_381_tree", "msm_g2_381_tree",
              "ladder_g1", "ladder_g2", "ladder_g1_377", "ladder_g2_381"}


def _rec(kernel="k", size=3, med=0.1, **over):
    rec = {
        "schema": "dg16-perf/1", "kernel": kernel, "size": size,
        "key": f"{kernel}@2e{size}", "items": 1 << size,
        "unit": "items/sec", "reps": 3, "median_seconds": med,
        "iqr_seconds": 0.0, "min_seconds": med,
        "items_per_sec": (1 << size) / med, "compile_seconds": 0.0,
        "cost": None, "memory": None, "host": True,
    }
    rec.update(over)
    return rec


def _doc(*recs, platform="cpu"):
    return {"schema": "dg16-perf/1", "platform": platform, "quick": True,
            "kernels": {r["key"]: r for r in recs}}


def test_registry_mirrors_the_jax_registry():
    """The JAX package's 13 cases under the same names, sizes, quick
    sizes, units and host flags; the port adds only its seven; every
    device case declares a positive cost (built here at a tiny size)."""
    jspecs, tspecs = jperf.kernels(), tperf.kernels()
    assert len(jspecs) == 13 and set(tspecs) == set(jspecs) | PORT_CASES
    for name, j in jspecs.items():
        t = tspecs[name]
        assert (t.sizes, t.quick_sizes, t.unit, t.host) == \
            (j.sizes, j.quick_sizes, j.unit, j.host), name
    for name, t in sorted(tspecs.items()):
        if t.host:
            continue
        case = t.builder(0 if name.startswith("ladder") else 2, CPU)
        assert case.cost["flops"] > 0 and case.cost["bytes_accessed"] > 0, \
            name


# synthetic (run, baseline) pairs covering every branch of the gate
def _gate_docs():
    base = _doc(_rec(med=0.1), _rec(kernel="slow", med=2.0),
                _rec(kernel="noisy", med=0.001, rel_threshold=3.0),
                _rec(kernel="strict", med=1.0, rel_threshold=0.0,
                     abs_floor_s=0.0),
                _rec(kernel="dies", med=0.5), _rec(kernel="gone", med=0.3))
    return [
        # regression past the threshold, at it (not one), the noise floor,
        # an override, a zero override, an error with a baseline, an
        # improvement, an entry not exercised, a new kernel, an error
        # without a baseline
        (_doc(_rec(med=0.1500001 + 0.02), _rec(kernel="slow", med=3.0),
              _rec(kernel="noisy", med=0.0035),
              _rec(kernel="strict", med=1.0000001),
              {"key": "dies@2e3", "kernel": "dies", "size": 3,
               "error": "RuntimeError: boom"},
              _rec(kernel="new", med=0.2),
              {"key": "bad@2e3", "kernel": "bad", "size": 3,
               "error": "ValueError: x"}), base),
        (_doc(_rec(med=0.15), _rec(kernel="slow", med=0.9)), base),
        (_doc(_rec(med=0.1)), _doc(_rec(med=0.01), platform="tpu")),
        (_doc(_rec(med=0.1)), None),
    ]


def test_benchgate_compare_report_and_baseline_equal_jax(tmp_path):
    for i, (run, base) in enumerate(_gate_docs()):
        want = jbg.compare(run, base)
        got = tbg.compare(run, base)
        assert got == want, i
        assert tbg.render_report(got) == jbg.render_report(want)
        for kw in ({"rel_threshold": 0.1}, {"abs_floor_s": 0.5}):
            assert tbg.compare(run, base, **kw) == jbg.compare(run, base, **kw)
        j = jbg.write_baseline(tmp_path / f"j{i}.json", run, base)
        t = tbg.write_baseline(tmp_path / f"t{i}.json", run, base)
        assert t.pop("comment") != j.pop("comment") and t == j
        assert tbg.load_baseline(tmp_path / f"t{i}.json") == \
            json.loads((tmp_path / f"t{i}.json").read_text())
    assert tbg.default_baseline_path().endswith(
        "distributed_groth16_tpu_torch/tools/perf-baseline.json")


def test_roofline_attribute_and_table_equal_jax():
    peak = {"flops": 2e12, "bw": 4e11, "deviceKind": "x", "source": "env"}
    recs = [
        _rec(kernel="cmp", host=False, med=0.01,
             cost={"flops": 1e10, "bytes_accessed": 1e6}),
        _rec(kernel="mem", host=False, med=0.02,
             cost={"flops": 1e6, "bytes_accessed": 1e9}),
        _rec(kernel="ops", host=False, med=0.5,
             cost={"flops": 3e9, "bytes_accessed": 0}),
        _rec(kernel="bytes", host=False, med=0.5,
             cost={"flops": 0, "bytes_accessed": 3e9}),
        _rec(kernel="nocost", host=False),
        _rec(kernel="host"),
        {"key": "err@2e3", "kernel": "err", "size": 3, "error": "E: x"},
    ]
    for r in recs[:4]:
        assert troof.attribute(r["cost"], r["median_seconds"], peak) == \
            jroof.attribute(r["cost"], r["median_seconds"], peak)
    assert troof.attribute(None, 1.0, peak) is None
    assert troof.format_table(_doc(*recs), peak) == \
        jroof.format_table(_doc(*recs), peak)
    assert troof.peaks("NVIDIA H100 80GB HBM3")["flops"] == \
        132 * 64 * 1980e6
    assert troof.peaks("cpu")["source"] == "default"


def test_bound_gives_the_kernel_1_bounds_of_perf_md():
    """Kernel 1 at the main path's first tree level, 48 x 524288 (G1) and
    96 x 524288 (G2): 0.116 and 0.348 ms, by operations, at the H100's
    peaks (chip_smoke.py's bound column)."""
    h100 = troof.peaks("NVIDIA H100 80GB HBM3")
    n = 524288
    for rows, f, want in ((48, 1, 0.116), (96, 3, 0.348)):
        ms, by = troof.bound(3 * rows * n * 4,
                             troof.FQ_MULS["add"] * f * n, 8, h100)
        assert (round(ms, 3), by) == (want, "operations")
    assert troof.imad_per_fq_mul(8) == 264 and troof.imad_per_fq_mul(12) == 588


def test_benchgate_main_exit_codes(tmp_path, capsys):
    """0 on a pass and on a missing baseline (advisory), 1 on a
    regression, 2 on a corrupt baseline and on a --select typo — the same
    codes and output from both packages."""
    run, slow = tmp_path / "r.json", tmp_path / "s.json"
    run.write_text(json.dumps(_doc(_rec(med=0.1))))
    slow.write_text(json.dumps(_doc(_rec(med=0.3))))
    outs = []
    for gate in (jbg, tbg):
        base = tmp_path / f"b-{gate.__name__}.json"
        assert gate.main(["--check", str(run), "--baseline",
                          str(tmp_path / "none.json")]) == 0
        assert "advisory run only" in capsys.readouterr().out
        assert gate.main(["--check", str(run), "--baseline", str(base),
                          "--write-baseline"]) == 0
        capsys.readouterr()
        assert gate.main(["--check", str(run), "--baseline", str(base)]) == 0
        assert gate.main(["--check", str(slow), "--baseline", str(base)]) \
            == 1
        outs.append(capsys.readouterr().out)
        base.write_text("{not json")
        assert gate.main(["--check", str(run), "--baseline", str(base)]) == 2
        assert gate.main(["--select", "msm_g9", "--device", "cpu"]
                         if gate is tbg else ["--select", "msm_g9"]) == 2
        assert "unknown perf kernel" in capsys.readouterr().err
    assert outs[0] == outs[1] and "REGRESSION k@2e3" in outs[1]


def test_make_record_equals_jax_and_mirrors_metrics(monkeypatch):
    monkeypatch.setenv("DG16_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DG16_PEAK_BW", "1e11")
    kw = dict(kernel="_t_rec", size=5, items=32, unit="items/sec",
              seconds=[0.01, 0.02, 0.015, 0.03], compile_seconds=0.5,
              cost={"flops": 1e9, "bytes_accessed": 1e6},
              memory={"argument_bytes": 8}, host=False)
    want = jperf.make_record(**kw)
    got = tperf.make_record(**kw)
    assert got == want and got["roofline"]["peak_source"] == "env"
    snap = tm.registry().snapshot()
    assert snap['perf_kernel_seconds_count{kernel="_t_rec",size="2e5"}'] == 4
    assert snap['perf_kernel_items_per_sec{kernel="_t_rec",size="2e5"}'] \
        == got["items_per_sec"]
    assert snap['perf_kernel_flops{kernel="_t_rec",size="2e5"}'] == 1e9
    assert snap['perf_kernel_utilization{kernel="_t_rec",size="2e5"}'] \
        == got["roofline"]["utilization"]
    assert tperf.make_record(**dict(kw, seconds=0.2, host=True)) == \
        jperf.make_record(**dict(kw, seconds=0.2, host=True))


def test_timed_first_call_counts_one_miss_then_hits():
    reg = tm.registry()
    fn = tcompile.timed_first_call("_t_first", lambda x, k: x * k)
    child = reg.family("compile_seconds").labels(fn="_t_first")
    hits = reg.family("compile_cache_hits_total").labels(fn="_t_first")
    misses = reg.family("compile_cache_misses_total").labels(fn="_t_first")
    x = torch.arange(8)
    assert torch.equal(fn(x, 2), x * 2)
    first = child.sum
    assert first > 0 and misses.value == 1 and hits.value == 0
    for _ in range(2):
        fn(torch.arange(8, 16), 2)
    assert child.sum == first and misses.value == 1 and hits.value == 2
    fn(torch.arange(9), 2)  # a new shape is a new signature
    assert misses.value == 2


def test_cli_perf_top_diff_and_markdown_equal_jax(tmp_path, capsys):
    a = _doc(_rec(med=0.1), _rec(kernel="slow", med=2.0),
             _rec(kernel="onlya", med=1.0))
    b = _doc(_rec(med=0.2), _rec(kernel="slow", med=1.0),
             {"key": "e@2e3", "kernel": "e", "size": 3, "error": "E: x"})
    pa, pb, base = (tmp_path / f for f in ("a.json", "b.json", "c.json"))
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    jbg.write_baseline(base, a, None)
    for argv in (["perf", "top", "--run", str(pb), "--baseline", str(base),
                  "-n", "2"],
                 ["perf", "top", "--run", str(pa), "--baseline",
                  str(tmp_path / "none.json")],
                 ["perf", "diff", str(pa), str(pb)]):
        jcli.main(argv)
        want = capsys.readouterr().out
        tcli.main(argv)
        assert capsys.readouterr().out == want, argv
    outs = []
    for mod in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            mod.main(["perf", "diff", str(pa), str(pb), "--markdown"])
        assert exc.value.code == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "| `slow@2e3` |" in outs[1]


def test_cli_perf_run_on_the_cpu_writes_a_readable_document(tmp_path, capsys):
    out = tmp_path / "run.json"
    tcli.main(["perf", "run", "--device", "cpu", "--select", "glv_decompose",
               "scalar_pack", "--reps", "1", "--out", str(out)])
    body = json.loads(capsys.readouterr().out)
    assert body["platform"] == "cpu"
    assert set(body["kernels"]) == {"glv_decompose@2e12", "scalar_pack@2e14"}
    doc = tbg.load_run(out)
    assert jbg.load_run(out) == doc and doc["build_seconds"] is None
    assert doc["peaks"]["deviceKind"] == "cpu"
    for rec in doc["kernels"].values():
        assert rec["median_seconds"] > 0 and rec["launches"] == {}
        assert rec["host"] and rec["roofline"] is None


def test_msm_g1_tree_case_has_the_jax_scalars_and_the_refmath_sum():
    from distributed_groth16_tpu_torch.ops import refmath as rm
    from distributed_groth16_tpu_torch.ops.constants import G1_GENERATOR, R
    from distributed_groth16_tpu_torch.ops.curve import g1

    log2n = 2
    case = tpk._msm_g1_tree(log2n, CPU)
    points, scalars = case.args[:2]
    np.testing.assert_array_equal(scalars.numpy(),
                                  np.asarray(jpk._scalars_std(log2n)))
    ks = tpk._rand_ints(1 << log2n, R, tpk._rng(log2n, 1))
    assert g1().decode(points) == [rm.G1.scalar_mul(G1_GENERATOR, k)
                                   for k in ks]
    ss = tpk._rand_ints(1 << log2n, R, tpk._rng(log2n, 0))
    want = rm.G1.scalar_mul(G1_GENERATOR,
                            sum(k * s for k, s in zip(ks, ss)) % R)
    assert g1().decode(case.fn(*case.args)[None]) == [want]


def test_ntt_limb_fwd_case_equals_the_jax_ntt_limb():
    from distributed_groth16_tpu.ops.ntt_limb import ntt_limb

    log2n = 9
    case = tpk._ntt_limb_fwd(log2n, CPU)
    x, n, inverse = case.args
    assert (n, inverse) == (1 << log2n, False) and x.shape == (16, n)
    want = np.asarray(ntt_limb(x.numpy().astype(np.uint32), n, inverse))
    np.testing.assert_array_equal(case.fn(*case.args).numpy(),
                                  want.astype(np.int64))


def test_run_suite_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tperf.run_suite(quick=True, select=["scalar_pack"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["perf", "roofline", "--select", "scalar_pack"])
