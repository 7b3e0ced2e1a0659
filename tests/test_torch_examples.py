"""The port's examples (distributed_groth16_tpu_torch/examples/: the
reference's workloads) through their run(..., device="cpu") at small
sizes, held against the JAX package where its function runs in seconds
on the CPU (d_fft, d_pp, mult_chain_circuit, the accounting formula) and
against refmath elsewhere.

Tolerances: field values are compared as exact limbs (Montgomery, int64
views of both packages' arrays) or exact integers; curve points as exact
affine points; proofs through the host pairing check. Every MSM takes the
tree route (LADDER_MSM_MAX_N = 1), as on the card; the plain ladder it
replaces costs seconds a call here. The MPC route of million (l = 1,
2^4: ~40 s on one core) is held on the card only, in chip_smoke.py's
phase 14."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as jax_chain,
)
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.ntt import domain as jdomain
from distributed_groth16_tpu.parallel import packing as jpacking
from distributed_groth16_tpu.parallel import pss as jpss
from distributed_groth16_tpu.parallel.dfft import d_fft as jd_fft
from distributed_groth16_tpu.parallel.dpp import d_pp as jd_pp
from distributed_groth16_tpu.parallel.net import (
    simulate_network_round as jax_round,
)
from distributed_groth16_tpu_torch.examples import (
    dfft_test, dmsm_bench, dpp_test, introspect, local_groth_bench,
    million, mesh_scale_run, profile_msm, profile_packing, sha256,
)
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def tree_route(monkeypatch):
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)


@pytest.fixture
def unpacked(monkeypatch):
    """Records what an example's unpack_shares returns (the clear result)."""
    seen = []

    def wrap(module):
        real = module.unpack_shares

        def recording(*a, **kw):
            out = real(*a, **kw)
            seen.append(out)
            return out

        monkeypatch.setattr(module, "unpack_shares", recording)
        return seen

    return wrap


def _limbs(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def test_dfft_test_equals_the_jax_round_and_refmath(unpacked):
    m, l = 64, 2
    seen = unpacked(dfft_test)
    res = dfft_test.run(m, l, check="refmath", device="cpu")
    assert res["ok"] and res["n"] == 8  # every value equals rm.Domain.fft

    x = dfft_test.limbs_to_ints(dfft_test.draw_fr(m))
    pp, F = jpss.PackedSharingParams(l), jfr()
    shares = jpacking.pack_strided(pp, F.encode(x))

    async def party(net, share):
        return await jd_fft(share, False, 1, False, jdomain(m), pp, net)

    outs = jax_round(pp.n, party, [shares[i] for i in range(pp.n)])
    want = jpacking.unpack_shares(pp, jnp.stack(outs, 0))
    np.testing.assert_array_equal(_limbs(seen[0]), _limbs(want))


def test_dpp_test_gives_all_ones_as_the_jax_round_does(unpacked):
    m, l = 64, 2
    seen = unpacked(dpp_test)
    assert dpp_test.run(m, l, device="cpu")["ok"]

    pp, F = jpss.PackedSharingParams(l), jfr()
    shares = jpacking.pack_consecutive(pp, F.encode(list(range(1, m + 1))))

    async def party(net, share):
        return await jd_pp(share, share, pp, net)

    outs = jax_round(pp.n, party, [shares[i] for i in range(pp.n)])
    want = jpacking.unpack_shares(pp, jnp.stack(outs, 0))
    assert [int(v) for v in F.decode(want)] == [1] * m
    np.testing.assert_array_equal(_limbs(seen[0]), _limbs(want))


@pytest.mark.parametrize("l", [1, 2])
def test_dmsm_bench_equals_the_host_ground_truth(tree_route, l):
    res = dmsm_bench.run(6, 6, l=l, device="cpu")
    assert res["ok"] and (res["l"], res["n"]) == (l, 4 * l)
    (row,) = res["sizes"]
    assert row["ok"] and row["log2_n"] == 6 and row["dmsm_ms"] > 0


def test_million_skip_mpc_verifies_on_the_jax_circuit(tree_route):
    res = million.run(5, skip_mpc=True, device="cpu")
    assert res["ok"] and res["verified"] and res["m"] == 32
    assert res["constraints"] == 30 and not res["mpc"]
    assert set(res["phases_ms"]) == {"build circuit", "setup", "compile",
                                     "single-node prove", "verify"}
    (r1cs, z), (jr1cs, jz) = (mult_chain_circuit(999992, 30).finish(),
                              jax_chain(999992, 30).finish())
    assert z == jz
    assert (r1cs.a, r1cs.b, r1cs.c) == (jr1cs.a, jr1cs.b, jr1cs.c)
    assert (r1cs.num_instance, r1cs.num_wires) == (jr1cs.num_instance,
                                                   jr1cs.num_wires)


def _jax_accounting():
    """The JAX example's accounting dict, read from its source."""
    tree = ast.parse((ROOT / "examples" / "local_groth_bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["acct"]):
            code = compile(ast.Expression(node.value), "acct", "eval")
            return lambda m, l: eval(code, {}, {"m": m, "l": l})
    raise AssertionError("no acct dict in the JAX example")


def test_local_groth_bench_keeps_the_jax_accounting(tree_route):
    formula = _jax_accounting()
    for m, l in [(8, 2), (1 << 15, 2), (1 << 20, 16), (96, 3)]:
        assert local_groth_bench.accounting(m, l) == formula(m, l)
    res = local_groth_bench.run(3, 2, g2_msm=False, device="cpu")
    assert res["accounting"] == formula(8, 2)
    assert set(res["phases_s"]) == {
        "ifft_m_p", "ifft_m_q", "ifft_m_w", "fft_2m_p", "fft_2m_q",
        "fft_2m_w", "h_combine", "ifft_2m_h", "msm_s_g1_m", "msm_h_g1_m",
        "msm_w_g1_m", "msm_u_g1_2m"}


def test_introspect_falls_back_to_the_in_repo_fixture(tree_route, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("DG16_VECTORS", str(tmp_path))  # no artifacts there
    monkeypatch.setenv("DG16_REQUIRE_VECTORS", "1")
    assert introspect.main(["--device", "cpu"]) == 3
    monkeypatch.delenv("DG16_REQUIRE_VECTORS")
    res = introspect.run(3, 11, device="cpu")
    assert res["ok"] and res["vectors"] is None
    assert (res["constraints"], res["inputs"], res["assignment"],
            res["nonzeros"], res["constraints2"]) == (1, 2, 4, 3, 1)


def _flags(path: pathlib.Path) -> dict:
    """--flag -> the source of its default, from add_argument calls."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            out[node.args[0].value] = kw.get("default")
    return out


def test_examples_keep_the_jax_flags_and_defaults():
    port = ROOT / "distributed_groth16_tpu_torch" / "examples"
    pairs = {
        "examples/dfft_test.py": "dfft_test.py",
        "examples/dmsm_bench.py": "dmsm_bench.py",
        "examples/dpp_test.py": "dpp_test.py",
        "examples/million.py": "million.py",
        "examples/local_groth_bench.py": "local_groth_bench.py",
        "examples/sha256.py": "sha256.py",
        "examples/introspect.py": "introspect.py",
        "scripts/profile_packing.py": "profile_packing.py",
        "scripts/mesh_scale_run.py": "mesh_scale_run.py",
    }
    left_out = {"million.py": {"--agg-out"}}
    for jax_file, port_file in pairs.items():
        want = _flags(ROOT / jax_file)
        got = _flags(port / port_file)
        for flag in left_out.get(port_file, ()):
            del want[flag]
        assert {k: got.get(k, "absent") for k in want} == want, port_file
        assert got["--device"] == "None", port_file


def test_examples_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    runs = [
        lambda: dfft_test.run(64), lambda: dpp_test.run(64),
        lambda: dmsm_bench.run(6, 6), lambda: million.run(4),
        lambda: local_groth_bench.run(3), lambda: sha256.run(),
        lambda: introspect.run(), lambda: profile_msm.run(6),
        lambda: profile_packing.run(4), lambda: mesh_scale_run.run(16),
    ]
    for run in runs:
        with pytest.raises((AssertionError, RuntimeError)):
            run()
