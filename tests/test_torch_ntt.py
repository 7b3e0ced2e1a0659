"""The port's NTTs (ops/ntt_limb.py and ops/ntt.py of
distributed_groth16_tpu_torch) against the JAX package on the same seeded
inputs, limb for limb (integers: tolerance zero), plus kernel 4 against its
plain version on a card (skipped without one)."""

import random

import numpy as np
import pytest
import torch

from distributed_groth16_tpu.ops import ntt as jntt
from distributed_groth16_tpu.ops import ntt_limb as jnl
from distributed_groth16_tpu.ops import refmath as rm
from distributed_groth16_tpu.ops.constants import FR_GENERATOR, R
from distributed_groth16_tpu.ops.field import fr as jfr
from distributed_groth16_tpu_torch.ops import ntt as tntt
from distributed_groth16_tpu_torch.ops import ntt_limb as tnl

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.numpy().astype(np.int64)


def _limb_major(vals):
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").astype(np.int32).reshape(-1, 16).T


def _redundant(n, seed):
    """n values in [0, 2r): the small NTT's inputs after a twiddle mul."""
    rng = random.Random(seed)
    return [rng.randrange(2 * R) for _ in range(n)]


@pytest.mark.parametrize("S", [2, 8, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_small_ntt_plain_matches_jax(S, inverse):
    L = 3
    x = np.ascontiguousarray(
        _limb_major(_redundant(S * L, S)).reshape(16, S, L)
    )
    want = jnl._small(S, inverse)._xla(x.astype(np.uint32))
    got = tnl._small(S, inverse)(torch.as_tensor(x))
    np.testing.assert_array_equal(_t(got), _np(want))


def test_stage_twiddles_and_root_table_match_jax():
    for n, inv in ((8, False), (256, True)):
        np.testing.assert_array_equal(
            tnl._stage_twiddles(n, inv), _np(jnl._stage_twiddles(n, inv))
        )
    got = tnl._wpows_lm_traced(512, True, torch.device("cpu"))
    np.testing.assert_array_equal(_t(got), _np(jnl._wpows_lm_traced(512, True)))
    np.testing.assert_array_equal(tntt.bitrev_perm(64), jntt.bitrev_perm(64))


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_limb_four_step_matches_jax(n, inverse):
    x = np.ascontiguousarray(_limb_major(_redundant(n, n + inverse)))
    want = jnl.ntt_limb(x.astype(np.uint32), n, inverse)
    got = tnl.ntt_limb(torch.as_tensor(x), n, inverse)
    np.testing.assert_array_equal(_t(got), _np(want))


def _batch(n, seeds):
    F = jfr()
    rng = [random.Random(s) for s in seeds]
    return np.stack([F.encode_np([r.randrange(R) for _ in range(n)])
                     for r in rng])


@pytest.mark.parametrize("offset", [1, FR_GENERATOR])
@pytest.mark.parametrize("route", ["row", "limb"])
def test_domain_matches_jaxdomain(offset, route, monkeypatch):
    """Domain.fft/ifft (batched, coset or not) equal JaxDomain's row-major
    results limb for limb on either route: the limb route hands back
    canonical values."""
    n = 64
    if route == "limb":
        monkeypatch.setattr(tntt, "LIMB_NTT_MIN_N", 1)
    x = _batch(n, (1, 2, 3))
    jd = jntt.domain(n, offset)
    td = tntt.domain(n, offset)
    tx = torch.as_tensor(x.astype(np.int32))
    np.testing.assert_array_equal(_t(td.fft(tx)), _np(jd.fft(x)))
    np.testing.assert_array_equal(_t(td.ifft(tx)), _np(jd.ifft(x)))
    np.testing.assert_array_equal(_t(td.fft(tx[0, :40])), _np(jd.fft(x[0, :40])))


def test_domain_coset_and_elements_match_host():
    td = tntt.domain(16).get_coset(FR_GENERATOR)
    ref = rm.Domain(16, FR_GENERATOR)
    assert td.elements() == ref.elements()
    vals = [random.Random(7).randrange(R) for _ in range(16)]
    F = jfr()
    got = td.fft(torch.as_tensor(F.encode_np(vals).astype(np.int32)))
    assert [int(v) for v in F.decode(got.numpy())] == ref.fft(vals)


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(256, 128), (128, 256), (8, 5)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_version(S, L, inverse):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    x = torch.as_tensor(
        _limb_major(_redundant(S * L, S + L)).reshape(16, S, L).copy(),
        device="cuda",
    )
    nt = tnl._small(S, inverse)
    got, want = nt(x), nt.plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
