"""Host<->device transfer accounting for the proving hot path — the JAX
package's telemetry/transfer.py, with `tree_nbytes` walking tensors,
numpy arrays, lists, tuples and dicts instead of a JAX pytree.

The perf observatory measures kernels; nothing measured the BOUNDARIES —
packed-CRS upload, witness upload, proof readback — and on the pipelining
roadmap item (overlap witness/transfer/prove) the win is exactly the
transfer time currently serialized with compute. Call sites bracket each
boundary with `account(direction)` and report the bytes that crossed:

    with transfer.account("h2d") as t:
        z_dev = F.encode(z)
        t.add(transfer.tree_nbytes(z_dev))

feeding `device_transfer_bytes_total{direction}` and
`transfer_seconds{direction}` (docs/OBSERVABILITY.md "Device
observatory"). Directions are `h2d` (host to device) and `d2h` (device to
host). The numbers are boundary wall-time, not wire DMA time — on CPU the
"transfer" is a copy/layout pass, on a card it is the PCIe upload; both
are the serialized cost the pipeline work will overlap away.
"""

from __future__ import annotations

import time

from . import metrics as _tm

_REG = _tm.registry()
_BYTES = _REG.counter(
    "device_transfer_bytes_total",
    "Bytes crossing an instrumented host<->device boundary (packed-CRS "
    "and witness uploads, proof readback), per direction",
    ("direction",),
)
_SECONDS = _REG.histogram(
    "transfer_seconds",
    "Wall seconds spent inside an instrumented host<->device boundary, "
    "per direction",
    ("direction",),
    buckets=_tm.DEFAULT_KERNEL_BUCKETS,
)

# pre-bound children: boundaries sit on the per-job hot path
_CHILDREN = {
    d: (_BYTES.labels(direction=d), _SECONDS.labels(direction=d))
    for d in ("h2d", "d2h")
}


def tree_nbytes(tree) -> int:
    """Total array bytes in a nest of tensors, numpy arrays, lists, tuples
    and dicts (the leaves jax.tree_util walks in the JAX module); any
    other leaf counts 0."""
    import numpy as np
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


class _Boundary:
    """The object `account()` yields: call `.add(nbytes)` with what moved."""

    __slots__ = ("direction", "nbytes")

    def __init__(self, direction: str):
        self.direction = direction
        self.nbytes = 0

    def add(self, nbytes: int) -> None:
        self.nbytes += int(nbytes)

    def add_tree(self, tree) -> None:
        self.add(tree_nbytes(tree))


class account:
    """Context manager timing one boundary crossing; on exit it observes
    the wall time and increments the byte counter by whatever the caller
    `.add()`ed (or the `nbytes` hint). Usable from any thread."""

    __slots__ = ("_b", "_hint", "_t0")

    def __init__(self, direction: str, nbytes: int | None = None):
        self._b = _Boundary(direction)
        self._hint = nbytes
        self._t0 = 0.0

    def __enter__(self) -> _Boundary:
        self._t0 = time.perf_counter()
        return self._b

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        b = self._b
        children = _CHILDREN.get(b.direction)
        if children is None:  # an ad-hoc direction label: bind on demand
            children = (
                _BYTES.labels(direction=b.direction),
                _SECONDS.labels(direction=b.direction),
            )
        nbytes, seconds = children
        seconds.observe(dt)
        n = b.nbytes if b.nbytes else (self._hint or 0)
        if n:
            nbytes.inc(n)
        return False
