"""The port's row-major field and curve arithmetic (ops/field.py,
ops/curve.py of distributed_groth16_tpu_torch) against the JAX package on
the same seeded inputs, limb for limb: these are integers, the tolerance
is zero. Values include 0, 1, p-1, infinity and P+P."""

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import curve as jcurve
from distributed_groth16_tpu.ops import field as jfield
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import G1_GENERATOR, G2_GENERATOR, Q, R
from distributed_groth16_tpu_torch.ops import curve as tcurve
from distributed_groth16_tpu_torch.ops import field as tfield

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.numpy().astype(np.int64)


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    return [0, 1, p - 1, 2, p - 2] + rand


def _fields(which):
    if which == "fr":
        return jfield.fr(), tfield.fr(), R
    return jfield.fq(), tfield.fq(), Q


@pytest.mark.parametrize("which", ["fr", "fq"])
@pytest.mark.parametrize(
    "op", ["add", "sub", "mul", "sqr", "neg", "to_mont", "from_mont"]
)
def test_prime_field_op_matches_jax(which, op):
    J, T, p = _fields(which)
    a = J.encode_np(_values(p, 11, 1))
    b = J.encode_np(list(reversed(_values(p, 11, 2))))
    ta, tb = torch.as_tensor(a.astype(np.int32)), torch.as_tensor(
        b.astype(np.int32)
    )
    if op in ("add", "sub", "mul"):
        want = getattr(J, op)(a, b)
        got = getattr(T, op)(ta, tb)
    else:
        want = getattr(J, op)(a)
        got = getattr(T, op)(ta)
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_prime_field_encode_decode_match_jax(which):
    J, T, p = _fields(which)
    vals = _values(p, 20, 3)
    np.testing.assert_array_equal(T.encode_np(vals), _np(J.encode_np(vals)))
    enc = T.encode(vals, CPU)
    assert enc.dtype == torch.int32 and enc.device == CPU
    assert [int(v) for v in T.decode(enc)] == vals


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_prime_field_inversions_match_jax(which):
    J, T, p = _fields(which)
    a = J.encode_np(_values(p, 6, 4))
    ta = torch.as_tensor(a.astype(np.int32))
    np.testing.assert_array_equal(_t(T.inv(ta[:4])), _np(J.inv(a[:4])))
    np.testing.assert_array_equal(_t(T.batch_inv(ta)), _np(J.batch_inv(a)))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "inv", "neg"])
def test_fq2_op_matches_jax(op):
    J, T = jfield.fq2(), tfield.fq2()
    rng = np.random.default_rng(5)
    vals = [(0, 0), (1, 0), (Q - 1, Q - 1)] + [
        (int(rng.integers(1, 2**62)) * 7919 % Q, int(rng.integers(0, 2**62)))
        for _ in range(5)
    ]
    a = J.encode(vals)
    b = J.encode(list(reversed(vals)))
    ta = torch.as_tensor(np.asarray(a).astype(np.int32))
    tb = torch.as_tensor(np.asarray(b).astype(np.int32))
    if op in ("add", "sub", "mul"):
        want, got = getattr(J, op)(a, b), getattr(T, op)(ta, tb)
    else:
        want, got = getattr(J, op)(a), getattr(T, op)(ta)
    np.testing.assert_array_equal(_t(got), _np(want))


def _points(group, n, seed):
    host, gen = (rm.G1, G1_GENERATOR) if group == "g1" else (rm.G2, G2_GENERATOR)
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(rng.integers(1, 2**62))) for _ in range(n)]
    return pts + [None, gen, None]


def _curves(group):
    if group == "g1":
        return jcurve.g1(), tcurve.g1()
    return jcurve.g2(), tcurve.g2()


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", ["add", "double", "neg"])
def test_curve_op_matches_jax(group, op):
    J, T = _curves(group)
    ps = _points(group, 3, 6)
    qs = _points(group, 3, 7)
    qs[1] = ps[1]  # P + P
    qs[-2] = None  # G + infinity
    P, Qp = J.encode(ps), J.encode(qs)
    tP, tQ = T.encode(ps, CPU), T.encode(qs, CPU)
    np.testing.assert_array_equal(_t(tP), _np(P))
    if op == "add":
        want, got = J.add(P, Qp), T.add(tP, tQ)
    else:
        want, got = getattr(J, op)(P), getattr(T, op)(tP)
    np.testing.assert_array_equal(_t(got), _np(want))
    assert T.decode(got) == J.decode(want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_to_affine_matches_jax(group):
    J, T = _curves(group)
    ps = _points(group, 3, 8)
    P = J.add(J.encode(ps), J.encode(ps))  # Z != 1
    tP = torch.as_tensor(np.asarray(P).astype(np.int32))
    np.testing.assert_array_equal(_t(T.to_affine(tP)), _np(J.to_affine(P)))


def test_scalar_mul_bits_and_ladder_sum_match_host():
    T = tcurve.g1()
    ps = _points("g1", 3, 9)[:3]
    ks = [5, 0, 200]
    bits = tcurve.scalar_bits(
        torch.tensor([[k] + [0] * 15 for k in ks], dtype=torch.int32), 8
    )
    got = T.scalar_mul_bits(T.encode(ps, CPU), bits)
    assert T.decode(got) == [rm.G1.scalar_mul(p, k) for p, k in zip(ps, ks)]
    assert T.decode(T.sum_sequential(got)) == rm.G1.msm(ps, ks)
