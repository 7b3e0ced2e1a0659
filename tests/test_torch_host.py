"""The PyTorch/CUDA port's boundary: it imports neither JAX nor the JAX
package, keeps exact copies of the host math it needs, defaults its entry
points to CUDA without falling back to the CPU, and its kernel wrappers
refuse tensors they cannot launch on."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_groth16_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "compare_trees.py"]
PORT_MODULES = [
    "distributed_groth16_tpu_torch",
    "distributed_groth16_tpu_torch.ops._cuda",
    "distributed_groth16_tpu_torch.ops.constants",
    "distributed_groth16_tpu_torch.ops.refmath",
    "distributed_groth16_tpu_torch.ops.primemath",
    "distributed_groth16_tpu_torch.ops.glv",
    "distributed_groth16_tpu_torch.ops.pairing",
    "distributed_groth16_tpu_torch.ops.field",
    "distributed_groth16_tpu_torch.ops.curve",
    "distributed_groth16_tpu_torch.ops.limb_kernels",
    "distributed_groth16_tpu_torch.ops.ntt_limb",
    "distributed_groth16_tpu_torch.ops.ntt",
    "distributed_groth16_tpu_torch.ops.msm",
    "distributed_groth16_tpu_torch.ops.fixedbase",
    "distributed_groth16_tpu_torch.ops.bls12_377",
    "distributed_groth16_tpu_torch.ops.bls12_381",
    "distributed_groth16_tpu_torch.ops.scalar_pack",
    "distributed_groth16_tpu_torch.frontend.r1cs",
    "distributed_groth16_tpu_torch.frontend.sha256",
    "distributed_groth16_tpu_torch.models.groth16",
    "distributed_groth16_tpu_torch.models.groth16.keys",
    "distributed_groth16_tpu_torch.models.groth16.qap",
    "distributed_groth16_tpu_torch.models.groth16.setup",
    "distributed_groth16_tpu_torch.models.groth16.prove",
    "distributed_groth16_tpu_torch.models.groth16.verify",
    "distributed_groth16_tpu_torch.models.groth16.proving_key",
    "distributed_groth16_tpu_torch.models.groth16.ext_wit",
    "distributed_groth16_tpu_torch.models.groth16.reference",
    "distributed_groth16_tpu_torch.utils.config",
    "distributed_groth16_tpu_torch.parallel.net",
    "distributed_groth16_tpu_torch.parallel.pss",
    "distributed_groth16_tpu_torch.parallel.packing",
    "distributed_groth16_tpu_torch.parallel.dfft",
    "distributed_groth16_tpu_torch.parallel.dmsm",
    "distributed_groth16_tpu_torch.parallel.pointntt",
    "distributed_groth16_tpu_torch.parallel.degred",
    "distributed_groth16_tpu_torch.parallel.dpp",
]
COPIES = ["constants", "refmath", "primemath", "glv", "pairing"]
FRONTEND_COPIES = ["r1cs", "sha256"]
MODEL_COPIES = ["reference"]


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "distributed_groth16_tpu"
        or name.startswith("distributed_groth16_tpu.")
    )


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert "distributed_groth16_tpu_torch.models.groth16.prove" in out
    assert [m for m in out if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


def test_source_scan_covers_every_port_module():
    """The source scan above globs the package, so it reaches every module
    the port has, the MPC modules included."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in PORT_MODULES:
        rel = mod.replace(".", "/")
        assert f"{rel}.py" in scanned or f"{rel}/__init__.py" in scanned, mod


def test_net_config_matches_the_jax_package():
    """Every field the port's NetConfig has, the JAX package's has too,
    with the same type and default."""
    import dataclasses

    from distributed_groth16_tpu.utils import config as ref
    from distributed_groth16_tpu_torch.utils import config as port

    ref_fields = {f.name: (f.type, f.default)
                  for f in dataclasses.fields(ref.NetConfig)}
    fields = dataclasses.fields(port.NetConfig)
    assert [f.name for f in fields] == ["op_timeout_s"]
    for f in fields:
        assert (f.type, f.default) == ref_fields[f.name], f.name


def _code_of(path: pathlib.Path) -> str:
    return ast.dump(ast.parse(path.read_text()))


@pytest.mark.parametrize("mod", COPIES + FRONTEND_COPIES + MODEL_COPIES)
def test_host_module_is_an_exact_copy(mod):
    sub = ("ops" if mod in COPIES else "frontend" if mod in FRONTEND_COPIES
           else "models/groth16")
    ref = ROOT / "distributed_groth16_tpu" / sub / f"{mod}.py"
    assert _code_of(PORT / sub / f"{mod}.py") == _code_of(ref)


# the BLS12 modules: their host part (parameters derived from the seed,
# the import-time self-checks, the host ground truth and the generators)
# is copied; these device instances are the port's own
BLS_DEVICE = {
    "bls12_377": {"fq377", "fr377", "g1_377", "encode_scalars_377",
                  "pss377", "pack_scalars_377"},
    "bls12_381": {"fq381", "fr381", "fq2_381", "g1_381", "g2_381",
                  "encode_scalars_381", "pss381", "pack_scalars_381"},
}


# and the port's own fix of a fault of the JAX package: its G2 generator
# clears the cofactor mod r and so lies outside G2 (ROADMAP queue 3)
BLS_FIXED = {"bls12_377": set(),
             "bls12_381": {"g2_generator_381", "_mul_unreduced"}}


def _host_part(path: pathlib.Path, skip: set) -> list[str]:
    body = ast.parse(path.read_text()).body[1:]  # after the docstring
    return [ast.dump(n) for n in body if getattr(n, "name", None) not in skip]


def _functions(path: pathlib.Path) -> set:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("mod", sorted(BLS_DEVICE))
def test_bls_host_part_is_an_exact_copy(mod):
    ref = ROOT / "distributed_groth16_tpu" / "ops" / f"{mod}.py"
    port = PORT / "ops" / f"{mod}.py"
    skip = BLS_DEVICE[mod] | BLS_FIXED[mod]
    assert _host_part(port, skip) == _host_part(ref, skip)
    names, ported = _functions(ref), _functions(port)
    assert BLS_DEVICE[mod] <= names <= ported
    assert ported - names <= BLS_FIXED[mod]


_CONSTANTS = [
    "Q", "R", "BN_X", "FR_GENERATOR", "FQ_GENERATOR", "FR_TWO_ADICITY",
    "FR_TWO_ADIC_ROOT", "G1_B", "G1_GENERATOR", "FQ2_NON_RESIDUE", "G2_B",
    "G2_GENERATOR", "ATE_LOOP_COUNT", "LIMB_BITS", "N_LIMBS", "LIMB_MASK",
    "MONT_BITS",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constants_equal_the_jax_package(name):
    from distributed_groth16_tpu.ops import constants as ref
    from distributed_groth16_tpu_torch.ops import constants as port

    assert getattr(port, name) == getattr(ref, name)


def test_routing_thresholds_match_the_jax_package():
    from distributed_groth16_tpu_torch.ops import msm, ntt

    assert msm.TREE_MSM_MIN_N == 1024  # ops/msm.py:162
    assert msm.LADDER_MSM_MAX_N == 128  # ops/msm.py:112
    assert ntt.LIMB_NTT_MIN_N == 2048  # ops/ntt.py:228


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_setup_without_device_raises_before_any_cpu_work(monkeypatch):
    _no_card()
    from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
    from distributed_groth16_tpu_torch.models.groth16 import setup as setup_mod

    setup_module = sys.modules["distributed_groth16_tpu_torch.models.groth16.setup"]
    ran = []
    monkeypatch.setattr(
        setup_module, "_qap_polys_at_tau", lambda *a: ran.append(a)
    )
    r1cs, _ = mult_chain_circuit(3, 5).finish()
    with pytest.raises((RuntimeError, AssertionError)):
        setup_mod(r1cs)
    assert ran == []


@pytest.mark.parametrize("entry", ["encode", "load", "compile", "scalars"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    _no_card()
    from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
    from distributed_groth16_tpu_torch.models.groth16 import (
        CompiledR1CS, ProvingKey,
    )
    from distributed_groth16_tpu_torch.ops.field import fr
    from distributed_groth16_tpu_torch.ops.msm import encode_scalars_std

    r1cs, _ = mult_chain_circuit(3, 5).finish()
    calls = {
        "encode": lambda: fr().encode([1, 2, 3]),
        "load": lambda: ProvingKey.load(str(tmp_path / "missing.npz")),
        "compile": lambda: CompiledR1CS(r1cs),
        "scalars": lambda: encode_scalars_std([5, 6]),
    }
    if entry == "load":
        _tiny_key().save(str(tmp_path / "missing.npz"))
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()


def _tiny_key():
    from distributed_groth16_tpu_torch.models.groth16.keys import (
        ProvingKey, VerifyingKey,
    )

    pt = torch.zeros((1, 3, 16), dtype=torch.int32)
    vk = VerifyingKey((1, 2), None, None, None, [(1, 2)])
    return ProvingKey(
        vk=vk, beta_g1=pt[0], delta_g1=pt[0], a_query=pt, b_g1_query=pt,
        b_g2_query=torch.zeros((1, 3, 2, 16), dtype=torch.int32),
        h_query=pt, l_query=pt, domain_size=1, num_instance=1,
    )


@pytest.mark.parametrize("kernel", ["add", "double", "horner", "ntt"])
def test_wrappers_refuse_tensors_they_cannot_launch_on(kernel):
    from distributed_groth16_tpu_torch.ops.limb_kernels import lg1
    from distributed_groth16_tpu_torch.ops.ntt_limb import _small

    g = lg1()
    pts = torch.zeros((48, 4), dtype=torch.int32, device="meta")
    calls = {
        "add": lambda: g.add(pts, pts),
        "double": lambda: g.double(pts),
        "horner": lambda: g.horner(pts, 4),
        "ntt": lambda: _small(8, False)(
            torch.zeros((16, 8, 2), dtype=torch.int32, device="meta")
        ),
    }
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        calls[kernel]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from distributed_groth16_tpu_torch.ops import _cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", ["limb_add_g1", "limb_double_g2",
                                  "limb_horner_g1", "ntt_small",
                                  "limb_add_g2", "limb_double_g1",
                                  "limb_horner_g2", "limb_add_g1_w12",
                                  "limb_add_g2_w12", "limb_double_g1_w12",
                                  "limb_double_g2_w12", "limb_horner_g1_w12",
                                  "limb_horner_g2_w12"])
def test_kernel_entries_exist_in_the_sources(name):
    from distributed_groth16_tpu_torch.ops import _cuda

    k = _cuda.KERNELS[name]
    src = (_cuda.CSRC / f"{k.source}.cu").read_text()
    assert f"int {k.symbol}(" in src
    args = _cuda._ENTRIES[k.source][k.symbol]
    decl = src[src.index(f"int {k.symbol}(") :].split(")")[0]
    assert decl.count(",") + 1 == len(args)


def test_key_npz_roundtrip_keeps_the_jax_format(tmp_path):
    from distributed_groth16_tpu_torch.models.groth16 import ProvingKey

    key = _tiny_key()
    key.a_query[0, 1, 0] = 7
    key.save(str(tmp_path / "k.npz"))
    with np.load(tmp_path / "k.npz") as d:
        assert d["a_query"].dtype == np.uint32
        assert d["meta"].dtype == np.int64
        assert sorted(d.files) == sorted([
            "meta", "vk", "beta_g1", "delta_g1", "a_query", "b_g1_query",
            "b_g2_query", "h_query", "l_query",
        ])
    back = ProvingKey.load(str(tmp_path / "k.npz"), device="cpu")
    assert back.a_query.dtype == torch.int32
    assert torch.equal(back.a_query, key.a_query)
    assert back.vk == key.vk


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py alone, or on a machine without a card, exits non-zero
    and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
