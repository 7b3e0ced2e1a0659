"""The port's ops/msm.py routes (the row-major Pippenger pinned by
window_bits and chunk, msm_batched, the chunked tree MSM), fft_rm, the
curve helpers from_affine / is_on_curve / eq and qap_from_r1cs, against
the JAX package.

Every comparison is exact: points as decoded affine points, field
vectors as canonical limbs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_groth16_tpu.frontend.r1cs import (
    mult_chain_circuit as jmult_chain_circuit,
)
from distributed_groth16_tpu.models.groth16 import (
    qap_from_r1cs as jqap_from_r1cs,
)
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, G2_GENERATOR, R
from distributed_groth16_tpu.ops.curve import g1 as jg1
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu.ops.msm import (
    encode_scalars_std as jencode_scalars_std,
    msm as jmsm,
    msm_batched as jmsm_batched,
)
from distributed_groth16_tpu.ops.ntt_limb import fft_rm as jfft_rm
from distributed_groth16_tpu_torch.frontend.r1cs import mult_chain_circuit
from distributed_groth16_tpu_torch.models.groth16 import qap_from_r1cs
from distributed_groth16_tpu_torch.ops import limb_kernels as lk
from distributed_groth16_tpu_torch.ops import msm as tmsm
from distributed_groth16_tpu_torch.ops.curve import g1, g2
from distributed_groth16_tpu_torch.ops.field import fr
from distributed_groth16_tpu_torch.ops.msm import (
    encode_scalars_std,
    msm,
    msm_batched,
    msm_g1,
    msm_g2,
)
from distributed_groth16_tpu_torch.ops.ntt_limb import fft_rm

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(count)]


def _host_points(which, rng, count):
    host, gen = (rm.G1, G1_GENERATOR) if which == "g1" else (rm.G2, G2_GENERATOR)
    return [host.scalar_mul(gen, 1 + int(rng.integers(1, 1 << 40)))
            for _ in range(count)]


def _limbs(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def g1_case():
    """12 host G1 points (one repeated, one infinity) and scalars (zero,
    one and r - 1 among them)."""
    rng = np.random.default_rng(1)
    pts = _host_points("g1", rng, 12)
    pts[3], pts[6] = None, pts[5]
    scalars = _ints(rng, 12)
    scalars[:3] = [0, 1, R - 1]
    return pts, scalars


@pytest.mark.parametrize("kw", [dict(window_bits=4, n=6),
                                dict(chunk=6, n=12)],
                         ids=["window_bits", "chunk"])
def test_msm_pippenger_matches_jax(g1_case, kw):
    """An explicit window_bits or chunk pins the row-major Pippenger (the
    chunk=6 case is tests/test_msm.py:74's)."""
    kw = dict(kw)
    n = kw.pop("n")
    pts, scalars = g1_case[0][:n], g1_case[1][:n]
    got = msm(g1(), g1().encode(pts, CPU),
              encode_scalars_std(scalars, CPU), **kw)
    want = jmsm(jg1(), jg1().encode(pts), jencode_scalars_std(scalars), **kw)
    assert g1().decode(got) == jg1().decode(want) == rm.G1.msm(pts, scalars)


def test_msm_g1_g2_take_the_curve_routes(monkeypatch):
    seen = []
    monkeypatch.setattr(tmsm, "msm", lambda c, p, s, **kw: seen.append(
        (c, p, s, kw)))
    msm_g1("p", "s", window_bits=4)
    msm_g2("p", "s", chunk=6)
    assert seen == [(g1(), "p", "s", dict(window_bits=4)),
                    (g2(), "p", "s", dict(chunk=6))]


@pytest.fixture(scope="module")
def batched_case():
    """B = 3 batch entries of n = 8 G1 points and scalars, and the JAX
    package's msm_batched (its one-ladder route) as affine points."""
    rng = np.random.default_rng(7)
    B, n = 3, 8
    pts = _host_points("g1", rng, B * n)
    scal = [_ints(rng, n) for _ in range(B)]
    jout = jmsm_batched(jg1(), jg1().encode(pts).reshape(B, n, 3, 16),
                        jnp.stack([jencode_scalars_std(s) for s in scal]))
    want = [jg1().decode(jout[b]) for b in range(B)]
    return pts, scal, want


@pytest.mark.parametrize("route", ["ladder", "tree"])
def test_msm_batched_matches_jax(batched_case, monkeypatch, route):
    """One batched ladder at n <= LADDER_MSM_MAX_N, and the tree MSM per
    batch entry above it (the threshold lowered to reach it at n = 8)."""
    pts, scal, want = batched_case
    if route == "tree":
        monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    B, n = len(scal), len(scal[0])
    out = msm_batched(g1(), g1().encode(pts, CPU).reshape(B, n, 3, 16),
                      torch.stack([encode_scalars_std(s, CPU) for s in scal]))
    assert out.shape == (B, 3, 16)
    assert [g1().decode(out[b]) for b in range(B)] == want
    assert want == [rm.G1.msm(pts[b * n : (b + 1) * n], scal[b])
                    for b in range(B)]
    if route == "ladder":
        # the ladder stops after the top bit any scalar sets: 41 steps
        # here, and none for all-zero scalars
        for small in ([[0, 0], [5, 1 << 40]], [[0, 0], [0, 0]]):
            got = msm_batched(
                g1(), g1().encode(pts[:4], CPU).reshape(2, 2, 3, 16),
                torch.stack([encode_scalars_std(s, CPU) for s in small]))
            assert [g1().decode(got[b]) for b in range(2)] == [
                rm.G1.msm(pts[2 * b : 2 * b + 2], small[b]) for b in range(2)]


@pytest.mark.parametrize("which, chunks", [("g1", [4, 4, 2]),
                                           ("g2", [4, 2])])
def test_chunked_tree_equals_the_unchunked_tree(monkeypatch, which, chunks):
    """Above TREE_MSM_MAX_N points the tree MSM runs over consecutive
    chunks of at most that many points and adds the parts on the limb
    group: the same point as one tree over all of them."""
    rng = np.random.default_rng(11)
    curve, host = (g1(), rm.G1) if which == "g1" else (g2(), rm.G2)
    pts = _host_points(which, rng, sum(chunks))
    scalars = _ints(rng, sum(chunks))
    x, s = curve.encode(pts, CPU), encode_scalars_std(scalars, CPU)
    monkeypatch.setattr(tmsm, "LADDER_MSM_MAX_N", 1)
    whole = msm(curve, x, s)
    calls = []
    monkeypatch.setattr(tmsm, "TREE_MSM_MAX_N", 4)
    inner = lk.msm_tree
    monkeypatch.setattr(lk, "msm_tree",
                        lambda p, *a, **k: calls.append(p.shape[0])
                        or inner(p, *a, **k))
    chunked = msm(curve, x, s)
    assert calls == chunks
    assert curve.decode(chunked) == curve.decode(whole) == \
        host.msm(pts, scalars)


@pytest.mark.parametrize("n", [8, 512])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rm_matches_jax(n, inverse):
    """Canonical limbs, one small transform and one four-step transform
    (n > 256)."""
    rng = np.random.default_rng(n + inverse)
    vals = _ints(rng, n)
    got = fft_rm(fr().encode(vals, CPU), n, inverse)
    want = jfft_rm(jfr().encode(vals), n, inverse)
    np.testing.assert_array_equal(_limbs(got), _limbs(want))
    dom = rm.Domain(n)
    host = dom.ifft(vals) if inverse else dom.fft(vals)
    assert [int(v) for v in fr().decode(got)] == host


@pytest.mark.parametrize("which", ["g1", "g2"])
def test_curve_helpers(which):
    """from_affine inverts to_affine (infinity through the mask);
    is_on_curve holds on points and fails off the curve; eq compares
    projective representatives, infinity only with infinity."""
    rng = np.random.default_rng(3)
    C, host = (g1(), rm.G1) if which == "g1" else (g2(), rm.G2)
    pts = _host_points(which, rng, 3) + [None]
    p = C.encode(pts, CPU)
    aff = C.to_affine(p)
    mask = torch.tensor([False, False, False, True])
    back = C.from_affine(aff, mask)
    assert C.decode(back) == pts
    assert C.from_affine(aff[:3]).shape == (3,) + p.shape[1:]
    assert C.is_on_curve(p).tolist() == [True] * 4
    off = p.clone()
    off[0, 0] = C.F.add(off[0, 0], off[0, 2])  # X + Z: off the curve
    assert C.is_on_curve(off).tolist() == [False, True, True, True]
    # another representative of each point: (2X : 2Y : 2Z)
    twice = C.F.add(p, p)
    assert C.eq(p, twice).tolist() == [True] * 4
    shifted = torch.roll(p, 1, dims=0)  # infinity against a point
    assert C.eq(p, shifted).tolist() == [False] * 4
    assert C.eq(p[3], C.infinity((), CPU)).item()
    dbl = C.encode([host.double(pts[0])], CPU)[0]
    assert C.eq(C.add(p[0], p[0]), dbl).item()


def test_qap_from_r1cs_matches_jax():
    r1cs, z = mult_chain_circuit(3, 9).finish()
    jr1cs, jz = jmult_chain_circuit(3, 9).finish()
    assert z == jz
    q = qap_from_r1cs(r1cs, z, CPU)
    jq = jqap_from_r1cs(jr1cs, jz)
    assert (q.num_inputs, q.num_constraints) == (jq.num_inputs,
                                                 jq.num_constraints)
    for name in ("a", "b", "c"):
        np.testing.assert_array_equal(_limbs(getattr(q, name)),
                                      _limbs(getattr(jq, name)))
