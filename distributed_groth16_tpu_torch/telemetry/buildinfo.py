"""Build/runtime identity: the `dg16_build_info` gauge — the counterpart
of the JAX package's telemetry/buildinfo.py, on torch.

The Prometheus build-info idiom: a constant-1 gauge whose LABELS carry
the identity — package version, torch version, CUDA version, backend,
device name — so a scrape (and the fleet's federated view, where every
series gains a `replica` label) can say which replica runs what. The same
document rides the `/readyz` capacity body (`buildInfo`), which is how
`dg16-cli fleet top` shows a mixed-version fleet during a rolling upgrade.

The JAX module's `jax` label (and document key) is `torch` here, and the
port adds `cuda` (the CUDA version torch was built for, "none" on a CPU
build). The backend and the device name are those of the device the
caller proves on (`build_info(device)`, None: the card): "cuda" and the
card's name (`torch.cuda.get_device_name`), or "cpu" and "cpu", whatever
else the process can see. The fleet registry reads only `version`.

Resolved lazily and exactly once per device; `build_info()` is
idempotent.
"""

from __future__ import annotations

import threading

from . import metrics as _tm

_REG = _tm.registry()
_BUILD_INFO = _REG.gauge(
    "dg16_build_info",
    "Constant 1; the labels carry the package version, torch version, "
    "CUDA version, backend, and device name of this process (join "
    "dashboards on it)",
    ("version", "torch", "cuda", "backend", "device"),
)

_lock = threading.Lock()
_docs: dict[str, dict] = {}


def build_info(device=None) -> dict:
    """Resolve (once per device) and return the identity document of a
    server proving on `device` (None: the card), setting the labeled
    gauge so `/metrics` exports it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    with _lock:
        doc = _docs.get(str(dev))
        if doc is not None:
            return doc
        try:
            from .. import __version__

            if dev.type == "cuda":
                backend, kind = "cuda", torch.cuda.get_device_name(dev)
            else:
                backend, kind = dev.type, dev.type
            torch_version = torch.__version__
            cuda_version = torch.version.cuda or "none"
            version = __version__
        except Exception:  # noqa: BLE001 — identity must never fail a scrape
            version, torch_version, cuda_version, backend, kind = (
                "unknown", "?", "?", "?", "?"
            )
        _BUILD_INFO.labels(
            version=version, torch=torch_version, cuda=cuda_version,
            backend=backend, device=kind,
        ).set(1)
        doc = _docs[str(dev)] = {
            "version": version,
            "torch": torch_version,
            "cuda": cuda_version,
            "backend": backend,
            "deviceKind": kind,
        }
        return doc
