"""RLC batch verification: N Groth16 checks folded into one multi-pairing
— the counterpart of distributed_groth16_tpu/verifier/batch.py.

Each proof i satisfies (models/groth16/verify.py)

    e(A_i, B_i) * e(-alpha, beta) * e(-L_i, gamma) * e(-C_i, delta) == 1

Raise check i to a random 128-bit scalar r_i and multiply: the shared
verifying-key slots (beta, gamma, delta) combine, so N proofs cost

    prod_i e(r_i A_i, B_i)
      * e(-(sum r_i) alpha, beta)
      * e(-(sum r_i L_i), gamma)
      * e(-(sum r_i C_i), delta)  == 1

— N+3 Miller loops and ONE final exponentiation instead of 4N loops and
N final exps (`ops/pairing.py` multi_pairing). Soundness: a batch with an
invalid member passes only if the adversary predicts the r_i, i.e. with
probability 2^-128 over a fresh seed per fold — which is why the seed is
sampled per batch (and per bisection level) and why a FIXED seed is only
ever accepted for aggregation bundles, where the fold is an attestation
over proofs already verified individually. Per-proof verdicts are always
exact: a failing fold bisects down to single-proof `verify()` leaves
(`verify_each`), the batch math is purely an accelerator.

`prepare_inputs` — the MSM-shaped inner loop L_i = gamma_abc[0] +
sum_j x_ij * gamma_abc[j+1] — is lifted off the host onto the device as
one batched MSM over a cached `PreparedVerifyingKey` (the CRS-cache
mold) on its device (None: CUDA); the fold and the pairings stay on the
host, as in the JAX package. verify_batch observes the JAX package's
verification metrics: verify_batch_size and verify_pairings_saved_total.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

from ..frontend.ark_serde import (
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_to_bytes,
    proof_to_bytes,
)
from ..models.groth16.keys import Proof, VerifyingKey
from ..models.groth16.verify import verify
from ..ops import refmath as rm
from ..ops.constants import R
from ..ops.curve import g1
from ..ops.field import resolve_device
from ..ops.msm import encode_scalars_std, msm_batched
from ..ops.pairing import pairing_check
from ..telemetry import metrics as _tm

# Verification-plane metrics (the JAX package's names and buckets).
_REG = _tm.registry()
_BATCH_SIZE = _REG.histogram(
    "verify_batch_size",
    "Proofs folded per RLC batch-verification multi-pairing",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_PAIRINGS_SAVED = _REG.counter(
    "verify_pairings_saved_total",
    "Miller loops avoided by RLC batch verification: 4N per-proof loops "
    "minus the N+3 folded ones, accumulated per fold",
)


# -- prepared verifying keys -------------------------------------------------


@dataclass(frozen=True, eq=False)
class PreparedVerifyingKey:
    """A circuit's VerifyingKey plus its device-resident gamma_abc stack
    — the fixed operand of every `prepare_inputs` MSM for that circuit,
    encoded once and reused across batches (the packed-CRS idea applied
    to the verify path)."""

    circuit_id: str
    vk: VerifyingKey
    num_inputs: int  # public inputs expected = len(gamma_abc_g1) - 1
    gamma_abc_dev: Any  # (num_inputs+1, 3, 16) device projective stack

    @staticmethod
    def prepare(
        circuit_id: str, vk: VerifyingKey, device=None
    ) -> "PreparedVerifyingKey":
        return PreparedVerifyingKey(
            circuit_id=circuit_id,
            vk=vk,
            num_inputs=len(vk.gamma_abc_g1) - 1,
            gamma_abc_dev=g1().encode(
                list(vk.gamma_abc_g1), resolve_device(device)
            ),
        )


class PvkCache:
    """PreparedVerifyingKey LRU, keyed by circuit id — the CrsCache mold
    (thread-safe, single-flight: concurrent verifiers on one cold circuit
    encode its gamma_abc stack exactly once) without the crs_cache_*
    counters, which belong to the packed-CRS cache alone. Capacity 0
    disables caching; `stats()` feeds `/stats`."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._data: OrderedDict[str, PreparedVerifyingKey] = OrderedDict()
        self._pending: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_prepare(
        self, circuit_id: str, factory: Callable[[], PreparedVerifyingKey]
    ) -> PreparedVerifyingKey:
        if self.capacity <= 0:
            with self._lock:
                self.misses += 1
            return factory()
        while True:
            with self._lock:
                if circuit_id in self._data:
                    self._data.move_to_end(circuit_id)
                    self.hits += 1
                    return self._data[circuit_id]
                ev = self._pending.get(circuit_id)
                if ev is None:
                    ev = threading.Event()
                    self._pending[circuit_id] = ev
                    self.misses += 1
                    break  # leader
            # follower: wait out the leader, then re-check (a dead leader
            # leaves the key absent and we retry for leadership)
            ev.wait()
        try:
            value = factory()
        except BaseException:
            with self._lock:
                del self._pending[circuit_id]
            ev.set()
            raise
        with self._lock:
            self._data[circuit_id] = value
            self._data.move_to_end(circuit_id)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1
            del self._pending[circuit_id]
        ev.set()
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hitRate": (self.hits / total) if total else None,
            }


# -- batched prepare_inputs --------------------------------------------------


def prepare_inputs_batched(
    pvk: PreparedVerifyingKey, publics_list: list[list[int]]
) -> list:
    """B public-input vectors -> B host affine L_pub points through ONE
    batched device MSM over the prepared gamma_abc stack (leading batch
    axis, shared bases). The constant wire rides as scalar 1 in column 0,
    so L = gamma_abc[0] + sum x_j * gamma_abc[j+1] exactly. The MSM runs
    on the prepared stack's device."""
    for pub in publics_list:
        if len(pub) != pvk.num_inputs:
            raise ValueError(
                f"{len(pub)} public inputs for {pvk.num_inputs} "
                "instance wires"
            )
    n = len(publics_list)
    scalars = encode_scalars_std(
        [v for pub in publics_list for v in [1] + [int(x) for x in pub]],
        pvk.gamma_abc_dev.device,
    ).reshape(n, pvk.num_inputs + 1, -1)  # standard form
    bases = pvk.gamma_abc_dev.expand((n,) + pvk.gamma_abc_dev.shape)
    curve = g1()
    return curve.decode(msm_batched(curve, bases, scalars))


# -- the fold ----------------------------------------------------------------


def fresh_seed() -> bytes:
    """A 32-byte fold seed from the OS CSPRNG — one per batch check."""
    return secrets.token_bytes(32)


def fold_scalars(seed: bytes, n: int) -> list[int]:
    """The n per-proof 128-bit RLC scalars of a fold, derived from its
    seed as SHA-256(seed || i). Deterministic expansion keeps the whole
    batch re-derivable from 32 bytes — an aggregation bundle carries only
    the seed, and a re-checker recomputes the identical fold."""
    out = []
    for i in range(n):
        h = hashlib.sha256(seed + i.to_bytes(4, "big")).digest()
        out.append(int.from_bytes(h[:16], "big") or 1)
    return out


def folded_pairs(
    vk: VerifyingKey, proofs: list[Proof], l_pubs: list, rs: list[int]
) -> list:
    """The N+3 (q2, p1) multi-pairing operands of the folded check, in
    the single-proof `verify()` pair order."""
    G1 = rm.G1
    pairs = [(p.b, G1.scalar_mul(p.a, r)) for p, r in zip(proofs, rs)]
    r_sum = sum(rs) % R
    pairs.append(
        (vk.beta_g2, G1.neg(G1.scalar_mul(vk.alpha_g1, r_sum)))
    )
    pairs.append((vk.gamma_g2, G1.neg(G1.msm(l_pubs, rs))))
    pairs.append(
        (vk.delta_g2, G1.neg(G1.msm([p.c for p in proofs], rs)))
    )
    return pairs


def verify_batch(
    pvk: PreparedVerifyingKey,
    proofs: list[Proof],
    publics_list: list[list[int]],
    seed: bytes | None = None,
) -> bool:
    """True iff ALL N Groth16 checks pass, via one N+3-loop multi-pairing
    (soundness 2^-128 per fold over a fresh seed). N == 1 short-circuits
    to the exact single check — there is nothing to amortize. `seed` is
    for aggregation re-checks and tests ONLY: a production fold must take
    the fresh-seed default or a crafted proof pair can cancel through a
    predictable r_i (the JAX package's tests/test_verifier.py)."""
    n = len(proofs)
    if len(publics_list) != n:
        raise ValueError("one public-input vector per proof required")
    if n == 0:
        return True
    if n == 1:
        _BATCH_SIZE.observe(1)
        return verify(pvk.vk, proofs[0], [int(x) for x in publics_list[0]])
    l_pubs = prepare_inputs_batched(pvk, publics_list)
    rs = fold_scalars(seed if seed is not None else fresh_seed(), n)
    ok = pairing_check(folded_pairs(pvk.vk, proofs, l_pubs, rs))
    _BATCH_SIZE.observe(n)
    _PAIRINGS_SAVED.inc(4 * n - (n + 3))
    return ok


def verify_each(
    pvk: PreparedVerifyingKey,
    proofs: list[Proof],
    publics_list: list[list[int]],
    seed: bytes | None = None,
) -> list[bool]:
    """Exact per-proof verdicts, batch math only an accelerator. A
    passing fold vouches for every member; a failing fold splits in
    half and recurses — the scheduler's bisection ladder shape
    (docs/SCHEDULER.md) at proof granularity — down to single-proof
    leaves checked by the exact `verify()`. Every recursive fold draws
    fresh randomness, so a proof crafted against one fold cannot survive
    the next level. Cost: all-valid batches pay one fold; k invalid
    proofs in n pay O(k log n) extra folds plus k exact leaf checks."""
    n = len(proofs)
    verdicts = [True] * n

    def descend(lo: int, hi: int, ok: bool) -> None:
        if ok:
            return
        if hi - lo == 1:
            verdicts[lo] = verify(
                pvk.vk, proofs[lo], [int(x) for x in publics_list[lo]]
            )
            return
        mid = (lo + hi) // 2
        for a, b in ((lo, mid), (mid, hi)):
            descend(
                a, b, verify_batch(pvk, proofs[a:b], publics_list[a:b])
            )

    if n:
        descend(0, n, verify_batch(pvk, proofs, publics_list, seed=seed))
    return verdicts


# -- aggregation bundles -----------------------------------------------------


def _bundle_digest(
    circuit_id: str, proofs: list[Proof], publics_list: list[list[int]]
) -> str:
    """Binds a bundle to exactly the proofs and publics it folded."""
    h = hashlib.sha256(circuit_id.encode())
    for p, pub in zip(proofs, publics_list):
        h.update(proof_to_bytes(p))
        h.update(json.dumps([str(int(x)) for x in pub]).encode())
    return h.hexdigest()


def build_bundle(
    pvk: PreparedVerifyingKey,
    proofs: list[Proof],
    publics_list: list[list[int]],
    seed: bytes | None = None,
) -> dict:
    """Compress N verified proofs for one circuit into a single RLC-folded
    attestation: the N+3 folded pairing operands, the 32-byte r_i seed,
    and a digest binding the inputs. One `check_bundle` multi-pairing
    re-checks the whole batch; a verifier holding the original proofs can
    additionally re-derive the fold from the seed (`fold_scalars`) and
    compare operands, so the bundle cannot attest to proofs it did not
    fold. Raises if the fold itself fails — callers verify members first
    (the executor does) so a bad proof fails its own job, not the
    aggregate."""
    n = len(proofs)
    if n == 0:
        raise ValueError("cannot aggregate an empty proof list")
    if len(publics_list) != n:
        raise ValueError("one public-input vector per proof required")
    seed = seed if seed is not None else fresh_seed()
    l_pubs = prepare_inputs_batched(pvk, publics_list)
    rs = fold_scalars(seed, n)
    pairs = folded_pairs(pvk.vk, proofs, l_pubs, rs)
    if not pairing_check(pairs):
        raise ValueError("folded pairing check failed; batch not aggregable")
    return {
        "circuitId": pvk.circuit_id,
        "count": n,
        "rSeed": seed.hex(),
        "pairs": [
            [g2_to_bytes(q2).hex(), g1_to_bytes(p1).hex()]
            for q2, p1 in pairs
        ],
        "digest": _bundle_digest(pvk.circuit_id, proofs, publics_list),
    }


def check_bundle(bundle: dict) -> bool:
    """Re-check an aggregation bundle: ONE multi-pairing over its folded
    operands (count+3 Miller loops for the whole batch). Deserialization
    runs the ark_serde validators, so off-curve or wrong-subgroup operands
    raise rather than verify."""
    pairs = [
        (g2_from_bytes(bytes.fromhex(q2)), g1_from_bytes(bytes.fromhex(p1)))
        for q2, p1 in bundle["pairs"]
    ]
    return pairing_check(pairs)
