"""Verification plane: batched Groth16 verification + proof aggregation.

The prove path got queues, bucketed batching, bisection, fleet routing,
and observability over PRs 2-12; this package gives the verify path the
same treatment (docs/VERIFY.md). `batch.py` holds the math — a
random-linear-combination fold of N proofs into ONE multi-pairing of
N+3 Miller loops instead of 4N, with `prepare_inputs` lifted onto the
device as a batched MSM — and `executor.py` runs job kinds "verify"
and "aggregate" through the same worker/scheduler/fleet machinery as
"prove".
"""

from .batch import (
    PreparedVerifyingKey,
    PvkCache,
    build_bundle,
    check_bundle,
    fold_scalars,
    fresh_seed,
    prepare_inputs_batched,
    verify_batch,
    verify_each,
)
from .executor import InvalidProofError, VerifyBatchRunner, VerifyExecutor

__all__ = [
    "PreparedVerifyingKey",
    "PvkCache",
    "build_bundle",
    "check_bundle",
    "fold_scalars",
    "fresh_seed",
    "prepare_inputs_batched",
    "verify_batch",
    "verify_each",
    "InvalidProofError",
    "VerifyBatchRunner",
    "VerifyExecutor",
]
