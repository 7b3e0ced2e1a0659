"""On-demand profiling: bounded captures, downloadable artifacts — the
counterpart of the JAX package's telemetry/profiler.py, on
`torch.profiler` where the JAX module drives `jax.profiler`.

A production replica can't be restarted under a profiler wrapper to see
device time per kernel; this is a single-flight, duration-bounded capture
you can trigger against a LIVE ApiServer mid-job —

    POST /profile {"durationS": 3}     -> 202 {id, durationS}
    GET  /profile/{id}                 -> 202 while running,
                                          200 .tar.gz artifact when done
    dg16-cli profile capture --seconds 3 --out prof.tar.gz

The capture records the host's torch ops and, when torch sees a card,
the card's kernels (CUPTI), the hand-written ones of csrc/ included; at
stop the trace is exported as a Chrome trace (`trace.json`, openable in
Perfetto or chrome://tracing) in the capture's directory under
`DG16_PROF_DIR`, and the directory is tarred into one artifact. While a
capture is live, `tracing.set_annotator` bridges every `tracing.span`
into a `torch.profiler.record_function` of the same name, so job phases
(load / witness / prove / packing / MPC Proof ...) line up with the
kernels they launched in ONE timeline. With no capture running the
annotator is None and the span hot path is untouched (the idle
zero-overhead guard stays green).

What torch needs, unlike jax.profiler:

  * torch's profiler session belongs to the thread that started it: a
    `stop()` from another thread finds no session and drops the trace
    with a warning. Each capture therefore runs its session on a thread
    of its own (`_Session`), which starts it, waits for the stop signal
    and stops and exports it; the HTTP start (a worker thread), the timer
    stop (a `threading.Timer` thread) and an explicit stop only signal
    that thread and join it.
  * torch records host ops and `record_function` ranges only on the
    starting thread unless the session is asked to profile every thread
    (`_ExperimentalConfig(profile_all_threads=True)`): jobs run in
    `asyncio.to_thread` workers, so without it the artifact would hold
    the card's kernels but none of the job's spans.

Single-flight by design: the profiler is process-global state, so a
second POST while one capture runs is HTTP 409, not a queue. Durations
are clamped to `DG16_PROF_MAX_S` — a forgotten capture must not trace a
production replica for an hour.
"""

from __future__ import annotations

import os
import tarfile
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field

from . import metrics as _tm
from . import tracing as _tracing
from ..utils import config as _config

_REG = _tm.registry()
_CAPTURES = _REG.counter(
    "profiler_captures_total",
    "On-demand torch.profiler captures, by outcome (ok / error / rejected)",
    ("outcome",),
)
_ACTIVE = _REG.gauge(
    "profiler_active",
    "1 while an on-demand torch.profiler capture is running "
    "(single-flight)",
)

DEFAULT_DURATION_S = 3.0
DEFAULT_MAX_S = 60.0
HISTORY = 8  # capture records kept addressable per profiler
TRACE_FILE = "trace.json"  # the Chrome trace inside a capture's directory


class ProfileError(Exception):
    pass


class ProfileBusyError(ProfileError):
    """A capture is already running (single-flight; HTTP 409)."""


@dataclass
class Capture:
    """One capture's lifecycle record (the GET /profile row)."""

    id: str
    directory: str
    duration_s: float
    started_at: float = field(default_factory=time.time)
    state: str = "running"  # running | done | error
    artifact: str | None = None
    artifact_bytes: int = 0
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "state": self.state,
            "durationS": self.duration_s,
            "startedAt": self.started_at,
            "artifactBytes": self.artifact_bytes,
            "error": self.error,
        }


def _annotation_factory(name: str):
    import torch

    return torch.profiler.record_function(name)


def _torch_profile():
    """A torch.profiler session over the host's ops on every thread and,
    when torch sees a card, the card's activity."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    )


class _Session:
    """One torch.profiler session owned by a thread of its own: the thread
    starts it, waits for `stop()`, then stops it and exports the Chrome
    trace to `trace_path`. The constructor returns once the session runs
    and raises what its start raised."""

    def __init__(self, trace_path: str):
        self.trace_path = trace_path
        self.error: Exception | None = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._own, name="dg16-profiler", daemon=True
        )
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            self._thread.join()
            raise self.error

    def _own(self) -> None:
        try:
            prof = _torch_profile()
            prof.start()
        except Exception as e:  # noqa: BLE001 — handed to the starter
            self.error = e
            return
        finally:
            self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            prof.export_chrome_trace(self.trace_path)
        except Exception as e:  # noqa: BLE001 — handed to the stopper
            self.error = e

    def stop(self) -> None:
        """Signal the owner thread, wait for its stop and export, and
        raise what they raised."""
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise self.error


class Profiler:
    """Single-flight on-demand capture manager (one per process is the
    intended shape — torch's profiler state is global)."""

    def __init__(self, directory: str, max_s: float | None = None):
        self.directory = directory
        self.max_s = (
            max_s
            if max_s is not None
            else _config.env_float("DG16_PROF_MAX_S", DEFAULT_MAX_S)
        )
        self._lock = threading.Lock()
        self._current: Capture | None = None
        # the profiler is process-global: the slot must stay busy from
        # the session's start until its stop RETURNS, even though
        # `_current` clears at the top of stop() (so racing stops are
        # idempotent)
        self._trace_live = False
        self._session: _Session | None = None
        self._timer: threading.Timer | None = None
        self._history: OrderedDict[str, Capture] = OrderedDict()

    # -- lifecycle -----------------------------------------------------------

    def start(self, duration_s: float | None = None) -> Capture:
        """Begin a capture. `duration_s` > 0 arms a timer that stops it
        (the HTTP path — bounded by `DG16_PROF_MAX_S`); <= 0 or None means
        the CALLER stops it (`capture_during`). Raises ProfileBusyError
        while another capture runs."""
        if duration_s is not None and duration_s > 0:
            duration_s = min(float(duration_s), self.max_s)
        cap = Capture(
            id=uuid.uuid4().hex[:12],
            directory="",
            duration_s=float(duration_s or 0.0),
        )
        cap.directory = os.path.join(self.directory, cap.id)
        with self._lock:
            if self._current is not None or self._trace_live:
                _CAPTURES.labels(outcome="rejected").inc()
                raise ProfileBusyError(
                    "a capture is already running (single-flight)"
                )
            # the slot is taken now; the capture becomes current (and
            # stoppable) once its session runs
            self._trace_live = True
            self._history[cap.id] = cap
            while len(self._history) > HISTORY:
                self._history.popitem(last=False)
        try:
            os.makedirs(cap.directory, exist_ok=True)
            session = _Session(os.path.join(cap.directory, TRACE_FILE))
        except Exception as e:  # noqa: BLE001 — a failed start frees the slot
            with self._lock:
                self._trace_live = False
            cap.state = "error"
            cap.error = f"{type(e).__name__}: {e}"
            _CAPTURES.labels(outcome="error").inc()
            raise ProfileError(cap.error) from e
        with self._lock:
            self._current = cap
            self._session = session
        # bridge spans onto the device timeline for the capture's extent
        _tracing.set_annotator(_annotation_factory)
        _ACTIVE.set(1)
        if duration_s is not None and duration_s > 0:
            t = threading.Timer(duration_s, self.stop)
            t.daemon = True
            with self._lock:
                self._timer = t
            t.start()
        return cap

    def stop(self) -> Capture | None:
        """End the current capture, tar its trace directory into the
        downloadable artifact, and return the record (None if no capture
        was running — a late timer racing an explicit stop is benign)."""
        with self._lock:
            cap = self._current
            self._current = None
            timer, self._timer = self._timer, None
            session, self._session = self._session, None
        if cap is None:
            return None
        if timer is not None:
            timer.cancel()
        _tracing.set_annotator(None)
        _ACTIVE.set(0)
        try:
            session.stop()
        except Exception as e:  # noqa: BLE001 — never turn profiling into a fault
            cap.state = "error"
            cap.error = f"{type(e).__name__}: {e}"
            _CAPTURES.labels(outcome="error").inc()
            return cap
        finally:
            with self._lock:
                self._trace_live = False
        try:
            cap.artifact = self._pack(cap)
            cap.artifact_bytes = os.path.getsize(cap.artifact)
            cap.state = "done"
            _CAPTURES.labels(outcome="ok").inc()
        except Exception as e:  # noqa: BLE001 — tarfile raises TarError too;
            # an escaped exception here (timer thread) would strand the
            # capture in "running" and make the CLI poll until timeout
            cap.state = "error"
            cap.error = f"{type(e).__name__}: {e}"
            _CAPTURES.labels(outcome="error").inc()
        return cap

    def _pack(self, cap: Capture) -> str:
        """Tar the trace directory (trace.json) into `<id>.tar.gz` next
        to it — one downloadable file per capture."""
        path = os.path.join(self.directory, f"{cap.id}.tar.gz")
        with tarfile.open(path, "w:gz") as tar:
            tar.add(cap.directory, arcname=cap.id)
        return path

    # -- the read side -------------------------------------------------------

    def get(self, capture_id: str) -> Capture | None:
        with self._lock:
            return self._history.get(capture_id)

    def active(self) -> Capture | None:
        with self._lock:
            return self._current

    def stats(self) -> dict:
        with self._lock:
            caps = list(self._history.values())
            current = self._current
        return {
            "directory": self.directory,
            "maxDurationS": self.max_s,
            "running": current.id if current is not None else None,
            "captures": [c.to_dict() for c in caps],
        }


class capture_during:
    """Context manager for offline runs: capture for the block's extent,
    artifact packed on exit. `.capture` holds the record afterwards."""

    def __init__(self, directory: str):
        self.profiler = Profiler(directory)
        self.capture: Capture | None = None

    def __enter__(self) -> "capture_during":
        self.capture = self.profiler.start(duration_s=0)
        return self

    def __exit__(self, *exc) -> bool:
        self.capture = self.profiler.stop() or self.capture
        return False
