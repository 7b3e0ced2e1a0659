"""Durable job journal: the write-ahead log that makes the service plane
crash-safe.

Everything the service knows about a job — the `JobQueue` registry, the
bucketer, the worker pool — lives in process memory, so a replica crash
or redeploy used to silently drop every accepted job. The journal fixes
that with the classic WAL shape:

  * every **submission** is appended (id, kind, circuit, l, the raw
    multipart payload base64'd) and fsynced BEFORE the job is admitted —
    a 202 response means the job survives a crash;
  * every **state transition** (RUNNING, DONE, FAILED, CANCELLED, a
    quarantine mark) is appended as it happens;
  * records live in numbered JSONL **segments**; when the active segment
    exceeds `segment_records`, a **compaction** rewrites only the live
    (non-terminal) jobs into a fresh segment and deletes the old ones —
    terminal jobs cost zero bytes at steady state;
  * on startup the service **replays**: non-terminal, non-quarantined
    jobs (`pending()`) are rebuilt and re-submitted idempotently by job
    id — a job interrupted mid-RUNNING simply proves again.

Threading: every method takes an internal lock, so appends are safe
from any thread. The payload-bearing submit appends — and the
compaction only they may trigger, a rewrite of every live payload — run
on a worker thread (`JobQueue.submit_async`); the small
state-transition appends run on the event-loop thread, paying one
bounded fsync each. Each append is one `write + flush + fsync` (fsync
is the durability contract; `fsync=False` trades it away for tests and
throwaway replicas).

Record grammar (one JSON object per line):

  {"k": "submit", "id", "kind", "cid", "l", "t", "fields": {name: b64},
   ["tenant", "priority", "trace"]}
  {"k": "state",  "id", "state", "t", ["error": {type,message,phase}]}
  {"k": "quarantine", "id", "t", "reason"}
  {"k": "checkpoint", "t"}          # clean-shutdown marker

Last record per id wins; unknown ids in state records are ignored (they
belong to jobs already compacted away).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from ..telemetry import metrics as _tm
from .jobs import JobState

log = logging.getLogger(__name__)

_REG = _tm.registry()
_APPENDS = _REG.counter(
    "journal_appends_total",
    "Journal records durably appended, per record kind",
    ("kind",),
)
_APPEND_SECONDS = _REG.histogram(
    "journal_append_seconds",
    "Wall seconds per journal append (write + flush + fsync) — the "
    "durability lag every admission pays",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
)
_REPLAYED = _REG.counter(
    "journal_replayed_total",
    "Jobs re-enqueued by startup replay, per journaled state",
    ("state",),
)
_COMPACTIONS = _REG.counter(
    "journal_compactions_total", "Segment compactions (rotation + rewrite)"
)
_LIVE = _REG.gauge(
    "journal_live_records", "Non-terminal jobs currently in the journal"
)

_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".jsonl"


def _submit_record(e: "JournalEntry") -> dict:
    """The submit-record shape — shared by the live append and the
    compaction rewrite so the two can never drift."""
    rec = {
        "k": "submit",
        "id": e.id,
        "kind": e.kind,
        "cid": e.circuit_id,
        "l": e.l,
        "t": e.created_at,
        "fields": _encode_fields(e.fields),
    }
    if e.tenant:
        rec["tenant"] = e.tenant
    if e.priority:
        rec["priority"] = e.priority
    if e.trace_id:
        rec["trace"] = e.trace_id
    return rec

_TERMINAL = {JobState.DONE.value, JobState.FAILED.value, JobState.CANCELLED.value}


@dataclass
class JournalEntry:
    """One live job as the journal knows it (the replay unit)."""

    id: str
    kind: str
    circuit_id: str
    l: int
    created_at: float
    fields: dict[str, bytes] = field(default_factory=dict, repr=False)
    state: str = JobState.QUEUED.value
    quarantined: bool = False
    # fleet metadata (docs/FLEET.md): a handoff must re-route the job
    # under the tenant that submitted it, so identity rides the WAL —
    # and under the same end-to-end trace id, so the re-proved job's
    # spans still stitch into the trace the router minted
    tenant: str = ""
    priority: str = ""
    trace_id: str = ""

    @property
    def replayable(self) -> bool:
        return self.state not in _TERMINAL and not self.quarantined


def _encode_fields(fields: dict[str, bytes]) -> dict[str, str]:
    return {k: base64.b64encode(v).decode("ascii") for k, v in fields.items()}


def _decode_fields(enc: dict[str, str]) -> dict[str, bytes]:
    return {k: base64.b64decode(v) for k, v in enc.items()}


def _segment_names(directory: str) -> list[str]:
    return sorted(
        n for n in os.listdir(directory)
        if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX)
    )


def _apply_record(
    live: dict[str, JournalEntry], tombstones: set[str], rec: dict
) -> None:
    k = rec.get("k")
    if k == "submit":
        # tombstone guard (crash-window consistency): a compaction that
        # died after fsyncing its snapshot but before its pending-flush
        # leaves a NEW segment restating the submit of a job whose
        # terminal record is only in the OLD segment — replay must not
        # let the later submit resurrect the finished job
        if rec["id"] in tombstones:
            return
        live[rec["id"]] = JournalEntry(
            id=rec["id"],
            kind=rec["kind"],
            circuit_id=rec["cid"],
            l=int(rec.get("l", 2)),
            created_at=float(rec.get("t", 0.0)),
            fields=_decode_fields(rec.get("fields", {})),
            tenant=rec.get("tenant", ""),
            priority=rec.get("priority", ""),
            trace_id=rec.get("trace", ""),
        )
    elif k == "state":
        e = live.get(rec.get("id"))
        if e is None:
            return
        state = rec.get("state", "")
        if state in _TERMINAL:
            del live[e.id]
            tombstones.add(e.id)
        else:
            e.state = state
    elif k == "quarantine":
        e = live.get(rec.get("id"))
        if e is not None:
            e.quarantined = True
    # "checkpoint" records carry no state — they only mark clean exits


def _load_segments(
    directory: str,
) -> tuple[dict[str, JournalEntry], int, int]:
    """Parse every segment (crash state included) into the live map.
    Returns (live entries, highest segment number, records seen) — the
    shared loader behind both a real JobJournal open and the read-only
    `read_journal` inspection path."""
    live: dict[str, JournalEntry] = {}
    tombstones: set[str] = set()
    seg_no = 0
    records = 0
    for name in _segment_names(directory):
        seg_no = max(
            seg_no, int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
        )
        with open(os.path.join(directory, name), "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # a torn final line is the expected crash artifact:
                    # everything before it was fsynced and parses
                    log.warning("journal: dropping torn record in %s", name)
                    continue
                _apply_record(live, tombstones, rec)
                records += 1
    return live, seg_no, records


class JobJournal:
    """Append-only WAL of job submissions + transitions under `directory`.

    Opening loads every existing segment (crash state included) and
    starts a fresh segment for new appends; `pending()` is what a replay
    should re-enqueue. All appends are idempotent by job id: a submit
    for a known-live id degrades to a requeue state record, terminal
    records for unknown ids are dropped.
    """

    def __init__(
        self,
        directory: str,
        fsync: bool = True,
        segment_records: int = 4096,
    ):
        self.directory = directory
        self.fsync = fsync
        self.segment_records = max(16, segment_records)
        self._lock = threading.Lock()
        self._live: dict[str, JournalEntry] = {}
        self._fh = None
        self._records = 0
        self._seg_no = 0
        # snapshot-and-swap compaction state: while a compaction encodes
        # the (potentially payload-heavy) live set WITHOUT the lock,
        # concurrent appends keep landing in the old segment and are
        # additionally stashed here so the new segment replays them
        self._compacting = False
        self._compact_pending: list[str] = []
        os.makedirs(directory, exist_ok=True)
        self._load_existing()
        self._open_segment(self._seg_no + 1)
        _LIVE.set(len(self._live))

    # -- startup -------------------------------------------------------------

    def _segments(self) -> list[str]:
        return _segment_names(self.directory)

    def _load_existing(self) -> None:
        self._live, self._seg_no, self._records = _load_segments(
            self.directory
        )

    # -- the write path ------------------------------------------------------

    def _open_segment(self, n: int) -> None:
        self._seg_no = n
        path = os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}{n:08d}{_SEGMENT_SUFFIX}"
        )
        self._fh = open(path, "a", encoding="utf-8")
        self._records = 0

    def _append(self, rec: dict, kind: str) -> bool:
        """Write one record (caller holds the lock). Returns True when
        the segment is ripe for compaction — the CALLER decides whether
        to run one (only the submit path does: a compaction rewrites
        EVERY live submission payload, far too heavy for the loop-side
        state appends; queue.submit_async runs it on a worker thread)."""
        t0 = time.monotonic()
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        self._fh.write(line)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        if self._compacting:
            self._compact_pending.append(line)
        self._records += 1
        _APPENDS.labels(kind=kind).inc()
        _APPEND_SECONDS.observe(time.monotonic() - t0)
        # ripe only when at least half the segment is reclaimable: a
        # bare records >= segment_records trigger would re-compact on
        # every append once the live set outgrew the segment bound —
        # O(live set) rewrite+fsync per admission instead of amortized
        # O(1)
        return self._records >= max(
            self.segment_records, 4 * len(self._live)
        )

    def append_submit(self, job) -> None:
        """Durably record one admission BEFORE the queue accepts it. For
        an id the journal already holds live (a startup replay
        re-submitting) this degrades to a requeue state record instead of
        duplicating the payload."""
        with self._lock:
            if job.id in self._live:
                self._live[job.id].state = JobState.QUEUED.value
                ripe = self._append(
                    {"k": "state", "id": job.id,
                     "state": JobState.QUEUED.value, "t": time.time()},
                    "state",
                )
            else:
                e = JournalEntry(
                    id=job.id,
                    kind=job.kind,
                    circuit_id=job.circuit_id,
                    l=job.l,
                    created_at=job.created_at,
                    fields=dict(job.fields),
                    tenant=getattr(job, "tenant", ""),
                    priority=getattr(job, "priority", ""),
                    trace_id=getattr(job, "trace_id", ""),
                )
                self._live[job.id] = e
                ripe = self._append(_submit_record(e), "submit")
            _LIVE.set(len(self._live))
        if ripe:
            self._compact()

    def append_state(
        self, job_id: str, state: JobState, error: dict | None = None
    ) -> None:
        """Record one transition. Terminal records drop the job from the
        live set (idempotent: a second terminal append for the same id is
        a no-op — the shutdown paths journal BEFORE the in-memory
        transition, then the normal on_finished path fires again)."""
        with self._lock:
            e = self._live.get(job_id)
            if e is None:
                return
            rec: dict = {"k": "state", "id": job_id,
                         "state": state.value, "t": time.time()}
            if error is not None:
                rec["error"] = error
            if state.terminal:
                del self._live[job_id]
            else:
                e.state = state.value
            self._append(rec, "state")
            _LIVE.set(len(self._live))

    def append_quarantine(self, job_id: str, reason: str) -> None:
        """Mark a poisoned job: it stays in the journal until its terminal
        record lands, but a replay that finds the mark (crash between the
        two appends) must NOT resurrect it."""
        with self._lock:
            e = self._live.get(job_id)
            if e is None:
                return
            e.quarantined = True
            self._append(
                {"k": "quarantine", "id": job_id, "reason": reason,
                 "t": time.time()},
                "quarantine",
            )

    # -- compaction ----------------------------------------------------------

    def _compact(self) -> None:
        """Rewrite only the live jobs into a fresh segment and delete the
        old ones. Snapshot-and-swap: the payload-heavy encode+write of
        the live set happens WITHOUT the lock (concurrent loop-side
        state appends keep landing in the old segment and are stashed
        for replay into the new one), and the lock is only held for the
        snapshot and the final pending-flush + swap. Crash-ordered: the
        new segment is fully written and fsynced before any old segment
        is unlinked, so every crash window leaves at least one complete
        copy of the live set on disk. Replaying old + partial new is
        consistent: the snapshot only restates the old segments, and the
        one divergence — a job whose concurrent terminal record reached
        only the old segment while the new one restates its submit — is
        closed by the loader's tombstone guard (_apply_record)."""
        with self._lock:
            if self._fh is None or self._compacting:
                return
            self._compacting = True
            self._compact_pending = []
            # quarantined entries are terminal-in-spirit: they exist
            # only so a crash between the quarantine mark and the FAILED
            # record can't resurrect the poison. Compaction purges them —
            # without this, one such crash would leave a permanent live
            # record that survives every checkpoint.
            for jid in [e.id for e in self._live.values() if e.quarantined]:
                del self._live[jid]
            snapshot = list(self._live.values())
            old = self._segments()
            new_no = self._seg_no + 1
            _LIVE.set(len(self._live))
        path = os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}{new_no:08d}{_SEGMENT_SUFFIX}"
        )
        nfh = open(path, "a", encoding="utf-8")
        n = 0
        for e in snapshot:
            nfh.write(json.dumps(
                _submit_record(e), separators=(",", ":")
            ) + "\n")
            n += 1
            state = e.state  # one read: may be mutated by a live append,
            # whose record is then in _compact_pending and replayed below
            if state != JobState.QUEUED.value:
                nfh.write(json.dumps(
                    {"k": "state", "id": e.id, "state": state,
                     "t": time.time()},
                    separators=(",", ":"),
                ) + "\n")
                n += 1
        nfh.flush()
        if self.fsync:
            os.fsync(nfh.fileno())
        with self._lock:
            for line in self._compact_pending:
                nfh.write(line)
                n += 1
            nfh.flush()
            if self.fsync:
                os.fsync(nfh.fileno())
            old_fh, self._fh = self._fh, nfh
            self._seg_no = new_no
            self._records = n
            self._compacting = False
            self._compact_pending = []
        old_fh.close()
        mine = os.path.basename(path)
        for name in old:
            if name != mine:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass
        _COMPACTIONS.inc()

    def checkpoint(self) -> None:
        """Clean-shutdown compaction: rewrite the live set (empty after a
        full drain) and stamp a checkpoint marker, so the next boot
        replays exactly the jobs that were still owed work."""
        self._compact()
        with self._lock:
            if self._fh is not None:
                self._append({"k": "checkpoint", "t": time.time()},
                             "checkpoint")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- replay --------------------------------------------------------------

    def pending(self) -> list[JournalEntry]:
        """The jobs a startup replay should re-enqueue: journaled
        non-terminal (QUEUED or interrupted RUNNING), not quarantined,
        oldest first."""
        with self._lock:
            out = [e for e in self._live.values() if e.replayable]
        return sorted(out, key=lambda e: e.created_at)

    def note_replayed(self, state: str) -> None:
        """Count one replayed job by the state the crash interrupted.
        Takes the pre-captured state STRING, not the entry: re-submission
        requeues the live entry in place, so reading entry.state after
        submit would always say QUEUED."""
        _REPLAYED.labels(state=state).inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "liveRecords": len(self._live),
                "segment": self._seg_no,
                "segmentRecords": self._records,
                "fsync": self.fsync,
            }


def read_journal(directory: str) -> list[JournalEntry]:
    """Read-only replay preview of a journal directory — the
    `dg16-cli job recover` path. Never writes: parses every segment and
    returns ALL live entries (callers filter on `.replayable`). Safe to
    run against a crashed replica's store."""
    if not os.path.isdir(directory):
        return []
    live, _, _ = _load_segments(directory)
    return sorted(live.values(), key=lambda e: e.created_at)
