"""The port's circom/snarkjs frontend (distributed_groth16_tpu_torch/
frontend) against the JAX package's on the CPU, at m = 16: the .r1cs,
.wtns and .zkey writers give the same bytes, the .zkey reader the same
limbs, a key read from a .zkey proves the original key's proof, the
proof codecs give the same JSON, bytes and calldata, and one WASM module
assembled here runs alike in the JAX VM, the port's VM and the C engine.

The port key comes from the port's setup; the JAX key is built from its
numpy arrays, so no JAX setup or prove compiles."""

import dataclasses
import json
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_groth16_tpu.frontend import ark_serde as j_ark
from distributed_groth16_tpu.frontend import ethereum as j_eth
from distributed_groth16_tpu.frontend import readers as j_readers
from distributed_groth16_tpu.frontend import snarkjs as j_snarkjs
from distributed_groth16_tpu.frontend import wasm_vm as j_wasm
from distributed_groth16_tpu.frontend import zkey as j_zkey
from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as j_mult_chain,
)
from distributed_groth16_tpu.models.groth16.keys import (
    ProvingKey as JaxProvingKey,
)
from distributed_groth16_tpu_torch.frontend import ark_serde, ethereum
from distributed_groth16_tpu_torch.frontend import readers, snarkjs, wasm_vm
from distributed_groth16_tpu_torch.frontend import zkey
from distributed_groth16_tpu_torch.frontend.r1cs import (
    R1CS,
    mult_chain_circuit,
)
from distributed_groth16_tpu_torch.models import groth16 as port
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops import ntt as tntt
from distributed_groth16_tpu_torch.ops.constants import Q, R
from distributed_groth16_tpu_torch.ops.curve import g1, g2
from distributed_groth16_tpu_torch.ops.field import fr

torch.set_num_threads(1)

CPU = torch.device("cpu")
QUERIES = ("beta_g1", "delta_g1", "a_query", "b_g1_query", "b_g2_query",
           "h_query", "l_query")
LENGTH = 13  # constraints of the chain: m = 16 with its 2 instance rows


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(8)
    x0 = int(rng.integers(2, 2**31))
    r1cs, z = mult_chain_circuit(x0, LENGTH).finish()
    j_r1cs, j_z = j_mult_chain(x0, LENGTH).finish()
    assert j_z == z
    pk = port.setup(r1cs, seed=int(rng.integers(1, 2**31)), device=CPU)
    jpk = _jax_key(pk)
    return dict(r1cs=r1cs, z=z, j_r1cs=j_r1cs, pk=pk, jpk=jpk,
                pubs=z[1 : r1cs.num_instance],
                jbytes=j_zkey.write_zkey(jpk, j_r1cs), rng=rng)


def _jax_key(pk):
    """The JAX package's ProvingKey of the same points: the port's limb
    tensors as uint32 arrays (the layout both packages share)."""
    arrays = {k: jnp.asarray(getattr(pk, k).numpy().astype(np.uint32))
              for k in QUERIES}
    return JaxProvingKey(vk=pk.vk, domain_size=pk.domain_size,
                         num_instance=pk.num_instance, **arrays)


@pytest.fixture(scope="module")
def proved(world):
    """ProvingKey.from_zkey on the CPU, and the proofs of that key and of
    the key it was written from at one r, s != 0. The routing thresholds
    are lowered so the tree MSM (kernels 1, 3) and the limb NTT (kernel
    4) take this tiny circuit through their plain versions, as they take
    m >= 2^11."""
    rng = world["rng"]
    r, s = (int.from_bytes(rng.bytes(40), "little") % R for _ in range(2))
    key = port.ProvingKey.from_zkey(world["jbytes"], device=CPU)
    comp = port.CompiledR1CS(world["r1cs"], CPU)
    z_mont = fr().encode(world["z"], CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmsm, "TREE_MSM_MIN_N", 1)
        mp.setattr(tntt, "LIMB_NTT_MIN_N", 1)
        got = port.prove_single(key, comp, z_mont, r=r, s=s)
        want = port.prove_single(world["pk"], comp, z_mont, r=r, s=s)
    return dict(key=key, got=got, want=want)


def test_r1cs_and_wtns_bytes_equal_the_jax_package(world):
    r1cs, z = world["r1cs"], world["z"]
    blob = readers.write_r1cs(r1cs)
    assert blob == j_readers.write_r1cs(world["j_r1cs"])
    wtns = readers.write_wtns(z)
    assert wtns == j_readers.write_wtns(z)
    back, header = readers.read_r1cs(blob)
    j_back, j_header = j_readers.read_r1cs(blob)
    assert vars(back) == vars(j_back) == vars(r1cs)
    assert vars(header) == vars(j_header)
    assert readers.read_wtns(wtns) == j_readers.read_wtns(wtns) == z


def test_write_zkey_bytes_equal_the_jax_writer(world):
    blob = zkey.write_zkey(world["pk"], world["r1cs"])
    assert blob == world["jbytes"]
    assert blob[:4] == b"zkey"


def test_read_zkey_gives_the_jax_readers_limbs(world):
    pk, mats = zkey.read_zkey(world["jbytes"], device=CPU)
    jpk, j_mats = j_zkey.read_zkey(world["jbytes"])
    for k in QUERIES:
        got = getattr(pk, k)
        assert got.dtype == torch.int32 and got.device == CPU
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jpk, k)).astype(np.int64))
        # canonical: 16-bit limbs of an integer below q
        assert int(got.min()) >= 0 and int(got.max()) < 1 << 16
        words = got.reshape(-1, 16).numpy().astype(np.int64)
        assert max(sum(int(w) << (16 * i) for i, w in enumerate(row))
                   for row in words) < Q
    assert vars(pk.vk) == vars(jpk.vk) == vars(world["pk"].vk)
    assert (pk.domain_size, pk.num_instance) == (16, 2)
    assert vars(mats) == vars(j_mats)
    r1cs = world["r1cs"]
    assert (mats.a, mats.b) == (r1cs.a, r1cs.b)
    assert mats.c == [[] for _ in range(r1cs.num_constraints)]
    # every query of the .zkey key is the original key's point
    for k in QUERIES:
        C = g2() if k == "b_g2_query" else g1()
        assert bool(C.eq(getattr(pk, k), getattr(world["pk"], k)).all()), k


def test_zkey_encodings_infinity_and_synthetic_rows(world):
    """The format's traps: Fr coefficients stored as v R^2 mod r, the
    all-zero point is infinity ((0, 1, 0); on G2 y is Fq2 one), the
    synthetic public-input A-rows are written and stripped, and a
    coefficient naming a signal past nVars is refused."""
    pk, r1cs = world["pk"], world["r1cs"]
    inf = pk.to(CPU)
    inf.l_query = inf.l_query.clone()
    inf.b_g2_query = inf.b_g2_query.clone()
    inf.l_query[0] = g1().infinity((), CPU)
    inf.b_g2_query[1] = g2().infinity((), CPU)
    blob = zkey.write_zkey(inf, r1cs)
    assert blob == j_zkey.write_zkey(_jax_key(inf), world["j_r1cs"])
    secs = zkey._parse_sections(blob)
    pos, _ = secs[8]
    assert blob[pos : pos + 64] == bytes(64)
    back, mats = zkey.read_zkey(blob, device=CPU)
    one = zkey._ONE.astype(np.int64)
    z16 = np.zeros(16, np.int64)
    np.testing.assert_array_equal(back.l_query[0].numpy(),
                                  np.stack([z16, one, z16]))
    np.testing.assert_array_equal(
        back.b_g2_query[1].numpy(),
        np.stack([np.stack([z16, z16]), np.stack([one, z16]),
                  np.stack([z16, z16])]))
    jback, _ = j_zkey.read_zkey(blob)
    for k in ("l_query", "b_g2_query"):
        np.testing.assert_array_equal(
            getattr(back, k).numpy(),
            np.asarray(getattr(jback, k)).astype(np.int64))
    # Coefs: A and B nonzeros, then one synthetic A-row per instance wire
    pos, _ = secs[4]
    (count,) = struct.unpack_from("<I", blob, pos)
    nnz = sum(len(row) for rows in (r1cs.a, r1cs.b) for row in rows)
    assert count == nnz + r1cs.num_instance
    m0, c0, s0 = struct.unpack_from("<III", blob, pos + 4)
    coeff, wire = r1cs.a[0][0]
    assert (m0, c0, s0) == (0, 0, wire)
    raw = int.from_bytes(blob[pos + 16 : pos + 48], "little")
    assert raw == coeff * pow(2, 512, R) % R
    last = pos + 4 + 44 * (count - 1)
    assert struct.unpack_from("<III", blob, last) == (
        0, r1cs.num_constraints + r1cs.num_instance - 1,
        r1cs.num_instance - 1)
    assert len(mats.a) == r1cs.num_constraints
    # a coefficient naming signal nVars: the JAX reader takes it (its QAP
    # gather would clamp the index), the port's refuses it
    bad = bytearray(blob)
    struct.pack_into("<I", bad, pos + 12, pk.num_wires)
    j_zkey.read_zkey(bytes(bad))
    with pytest.raises(ValueError, match="names signal"):
        zkey.read_zkey(bytes(bad), device=CPU)
    # a circuit without witness wires: PointsC holds no point
    one_wire = port.ProvingKey(
        vk=dataclasses.replace(pk.vk, gamma_abc_g1=pk.vk.gamma_abc_g1[:1]),
        beta_g1=pk.beta_g1, delta_g1=pk.delta_g1, a_query=pk.a_query[:1],
        b_g1_query=pk.b_g1_query[:1], b_g2_query=pk.b_g2_query[:1],
        h_query=pk.h_query[:1], l_query=pk.l_query[:0], domain_size=1,
        num_instance=1)
    blob = zkey.write_zkey(one_wire, R1CS(1, 0, [], [], []))
    back, _ = zkey.read_zkey(blob, device=CPU)
    assert back.l_query.shape == (0, 3, 16)
    assert bool(g1().eq(back.a_query, one_wire.a_query).all())
    with pytest.raises(ValueError, match="cannot reshape"):
        j_zkey.read_zkey(blob)


def test_zkey_key_proves_the_original_keys_proof(world, proved):
    """The plain versions of kernels 1, 3 and 4 prove, from the .zkey
    key at r, s != 0, the proof of the key it was written from, and the
    proof verifies."""
    key, got, want = proved["key"], proved["got"], proved["want"]
    assert key.device == CPU and key.query_scalars is None
    assert ark_serde.proof_to_bytes(got) == ark_serde.proof_to_bytes(want)
    assert port.verify(key.vk, got, world["pubs"])


def _corrupt(blob: bytes, what: str) -> bytes:
    b = bytearray(blob)
    pos, size = zkey._parse_sections(blob)[2]
    if what == "magic":
        b[:4] = b"zkez"
    elif what == "version":
        struct.pack_into("<I", b, 4, 3)
    elif what == "base_field":
        b[pos + 4] ^= 1
    elif what == "scalar_field":
        b[pos + 40] ^= 1
    elif what == "truncated":  # section 9 (h_query) shorter than m points
        pos, size = zkey._parse_sections(blob)[9]
        struct.pack_into("<Q", b, pos - 8, size - 64)
    return bytes(b)


@pytest.mark.parametrize("what, message", [
    ("magic", "bad zkey magic"),
    ("version", "unsupported zkey version 3"),
    ("base_field", "zkey base field is not BN254 Fq"),
    ("scalar_field", "zkey scalar field is not BN254 Fr"),
    ("truncated", "zkey section 9 truncated"),
])
def test_zkey_header_and_truncation_errors_as_the_jax_package(
        world, what, message):
    bad = _corrupt(world["jbytes"], what)
    with pytest.raises(ValueError) as want:
        j_zkey.read_zkey(bad)
    with pytest.raises(ValueError) as got:
        zkey.read_zkey(bad, device=CPU)
    assert str(got.value) == str(want.value) == message


def test_proof_codecs_equal_the_jax_package(world, proved):
    """snarkjs JSON, arkworks compressed bytes and Ethereum tuples and
    calldata of one proof and its verifying key."""
    from distributed_groth16_tpu.models.groth16.keys import Proof as JProof

    pk, pubs, proof = world["pk"], world["pubs"], proved["got"]
    jproof = JProof(a=proof.a, b=proof.b, c=proof.c)
    text = json.dumps(snarkjs.dump_proof(proof))
    assert text == json.dumps(j_snarkjs.dump_proof(jproof))
    assert snarkjs.load_proof(json.loads(text)) == proof
    vk_json = {"protocol": "groth16", "curve": "bn128",
               "vk_alpha_1": snarkjs._g1_to_json(pk.vk.alpha_g1),
               "vk_beta_2": snarkjs._g2_to_json(pk.vk.beta_g2),
               "vk_gamma_2": snarkjs._g2_to_json(pk.vk.gamma_g2),
               "vk_delta_2": snarkjs._g2_to_json(pk.vk.delta_g2),
               "IC": [snarkjs._g1_to_json(p) for p in pk.vk.gamma_abc_g1]}
    assert snarkjs.load_verification_key(vk_json) == pk.vk
    assert vars(j_snarkjs.load_verification_key(vk_json)) == vars(pk.vk)
    pub_json = [str(x) for x in pubs]
    assert snarkjs.load_public(pub_json) == j_snarkjs.load_public(pub_json)
    raw = ark_serde.proof_to_bytes(proof)
    assert len(raw) == 128 and raw == j_ark.proof_to_bytes(jproof)
    assert ark_serde.proof_from_bytes(raw) == proof
    eth = ethereum.proof_to_eth(proof)
    assert eth == j_eth.proof_to_eth(jproof)
    assert ethereum.proof_from_eth(eth) == proof
    assert eth[1][0] == (proof.b[0][1], proof.b[0][0])  # G2 c1 limb first
    assert ethereum.vk_to_eth(pk.vk) == j_eth.vk_to_eth(pk.vk)
    assert ethereum.vk_from_eth(ethereum.vk_to_eth(pk.vk)) == pk.vk
    call = ethereum.solidity_calldata(proof, pubs)
    assert call == j_eth.solidity_calldata(jproof, pubs)
    groups = json.loads(f"[{call}]")
    assert [len(g) for g in groups] == [2, 2, 2, len(pubs)]
    assert int(groups[3][0], 16) == pubs[0] % R
    assert ethereum.proof_to_json(proof) == snarkjs.dump_proof(proof)
    assert port.verify(pk.vk, snarkjs.load_proof(json.loads(text)), pubs)


# -- a WASM module assembled here ----------------------------------------

I32 = 0x7F
M32 = (1 << 32) - 1


def _uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _sleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if (n == 0 and not b & 0x40) or (n == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _vec(items) -> bytes:
    return _uleb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    return _uleb(len(s)) + s.encode()


def _section(sid: int, payload: bytes) -> bytes:
    return bytes([sid]) + _uleb(len(payload)) + payload


def _functype(params, results) -> bytes:
    return b"\x60" + _vec([bytes([t]) for t in params]) + _vec(
        [bytes([t]) for t in results])


def _module() -> bytes:
    """Imports env.note (i32) -> (); defines sq(x) = x * x and run(a, b):
    acc = sum_{i < a} i * b in a loop, mem[64] = sq(acc) ^ a, note(mem[64]),
    return mem[64] - 5 (all i32, wrapping)."""
    get, set_, const = 0x20, 0x21, 0x41
    run = bytes([
        0x02, 0x40, 0x03, 0x40,  # block, loop
        get, 3, get, 0, 0x4F, 0x0D, 1,  # i >= a: br_if out
        get, 2, get, 3, get, 1, 0x6C, 0x6A, set_, 2,  # acc += i * b
        get, 3, const, 1, 0x6A, set_, 3, 0x0C, 0, 0x0B, 0x0B,  # i++; br loop
        const, 0xC0, 0x00, get, 2, 0x10, 1, get, 0, 0x73,  # sq(acc) ^ a
        0x36, 2, 0,  # i32.store at 64
        const, 0xC0, 0x00, 0x28, 2, 0, 0x10, 0,  # note(mem[64])
        const, 0xC0, 0x00, 0x28, 2, 0, const, 5, 0x6B, 0x0B,  # - 5
    ])
    sq = bytes([get, 0, get, 0, 0x6C, 0x0B])
    bodies = [_uleb(0) + sq, _vec([_uleb(2) + bytes([I32])]) + run]
    return b"".join([
        b"\x00asm\x01\x00\x00\x00",
        _section(1, _vec([_functype([I32], []), _functype([I32], [I32]),
                          _functype([I32, I32], [I32])])),
        _section(2, _vec([_name("env") + _name("note") + b"\x00" + _uleb(0)])),
        _section(3, _vec([_uleb(1), _uleb(2)])),
        _section(5, _vec([b"\x00" + _uleb(1)])),
        _section(7, _vec([_name("sq") + b"\x00" + _uleb(1),
                          _name("run") + b"\x00" + _uleb(2)])),
        _section(10, _vec([_uleb(len(b)) + b for b in bodies])),
    ])


def test_assembled_wasm_module_runs_alike_in_every_engine(world):
    from distributed_groth16_tpu_torch.frontend import wasm_cexec

    rng = world["rng"]
    args = [(int(rng.integers(300, 2000)), int(rng.integers(2**20, 2**30)))
            for _ in range(3)] + [(0, 7)]
    want = []
    for a, b in args:
        acc = 0
        for i in range(a):
            acc = (acc + i * b) & M32
        v = (acc * acc & M32) ^ a
        want.append((v, (v - 5) & M32))
    data = _module()
    engines = {"jax": (j_wasm.Module, j_wasm.Instance),
               "port": (wasm_vm.Module, wasm_vm.Instance)}
    if shutil.which("cc"):
        engines["port_c"] = (wasm_vm.Module, wasm_cexec.CInstance)
    for name, (module, instance) in engines.items():
        notes = []
        inst = instance(module(data), {("env", "note"): notes.append})
        got = [inst.call("run", [a, b])[0] for a, b in args]
        assert [(n & M32, g & M32) for n, g in zip(notes, got)] == want, name
        assert inst.call("sq", [70000])[0] & M32 == 70000 * 70000 & M32
