"""Proof-job service layer: async queue, bounded workers, packed-CRS cache.

Turns the one-shot proving API into a serving stack (docs/SERVICE.md):
requests enqueue `ProofJob`s, a bounded `WorkerPool` executes them off the
request path through one `ProofExecutor` proving funnel, and the
`CrsCache` skips `pack_proving_key` for repeat proofs on a hot circuit.
"""

from .crs_cache import CrsCache
from .jobs import JobCancelled, JobState, ProofJob, error_dto
from .journal import JobJournal, JournalEntry, read_journal
from .queue import JobQueue, QueueFullError
from .slo import SloMonitor
from .worker import ProofExecutor, WorkerPool

__all__ = [
    "CrsCache",
    "JobCancelled",
    "JobJournal",
    "JobQueue",
    "JobState",
    "JournalEntry",
    "ProofExecutor",
    "ProofJob",
    "QueueFullError",
    "SloMonitor",
    "WorkerPool",
    "error_dto",
    "read_journal",
]
