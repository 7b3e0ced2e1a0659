"""Per-circuit artifact store — the counterpart of
distributed_groth16_tpu/api/store.py, whose host part this module copies;
the store takes a `device` (None: the card) for the keys it makes and
loads. A directory written by the JAX package's store loads here
unchanged: the `.r1cs` and `proving_key.npz` formats are shared.

Parity with the reference's filesystem layout (mpc-api/src/main.rs:155-171,
249-264): each saved circuit gets a `circuit_<name>_<millis>/` directory
holding the uploaded `.r1cs` + witness generator and the setup artifacts;
lookups load the mtime-latest file per extension
(common/src/utils/file.rs:36-63). Setup runs at save time with the fixed
dev seed 42 (main.rs:148-152 — dev-grade, not a ceremony).
"""

from __future__ import annotations

import os
import time
import uuid

from ..frontend.r1cs import R1CS
from ..frontend.readers import read_r1cs
from ..models.groth16.keys import ProvingKey
from ..models.groth16.setup import setup
from ..utils import config as _config

SETUP_SEED = 42


class CircuitStore:
    def __init__(self, root: str | None = None, device=None):
        self.root = root or _config.env_str("DG16_STORE", "./circuit_store")
        self.device = device
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, circuit_id: str) -> str:
        # A circuit id must be exactly one non-dot path component: the old
        # relpath-only check let "" and "." resolve to the store root and
        # ".." to its parent (dirname("..") == "" — no separator to catch).
        if (
            not circuit_id
            or circuit_id in (".", "..")
            or "/" in circuit_id
            or "\\" in circuit_id
            or "\0" in circuit_id
        ):
            raise ValueError(f"bad circuit id {circuit_id!r}")
        path = os.path.normpath(os.path.join(self.root, circuit_id))
        if os.path.dirname(os.path.relpath(path, self.root)):
            raise ValueError(f"bad circuit id {circuit_id!r}")
        return path

    def save_circuit(
        self, name: str, r1cs_bytes: bytes, witness_generator: bytes
    ) -> str:
        if (
            not name.isascii()
            or not name.replace("_", "").replace("-", "").isalnum()
        ):
            raise ValueError(f"bad circuit name {name!r}")
        # millis + random suffix: concurrent same-name saves never collide
        suffix = uuid.uuid4().hex[:8]
        circuit_id = f"circuit_{name}_{int(time.time() * 1000)}_{suffix}"
        d = self._dir(circuit_id)
        os.makedirs(d, exist_ok=False)
        with open(os.path.join(d, f"{name}.r1cs"), "wb") as f:
            f.write(r1cs_bytes)
        if witness_generator:
            with open(os.path.join(d, f"{name}.wasm"), "wb") as f:
                f.write(witness_generator)
        r1cs, _ = read_r1cs(r1cs_bytes)
        pk = setup(r1cs, seed=SETUP_SEED, device=self.device)
        pk.save(os.path.join(d, "proving_key.npz"))
        return circuit_id

    def _latest(self, circuit_id: str, ext: str) -> str:
        d = self._dir(circuit_id)
        cands = [
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(ext)
        ]
        if not cands:
            raise FileNotFoundError(f"no {ext} in {circuit_id}")
        return max(cands, key=os.path.getmtime)

    def load(self, circuit_id: str) -> tuple[R1CS, ProvingKey]:
        r1cs, _ = read_r1cs(self._latest(circuit_id, ".r1cs"))
        pk = ProvingKey.load(
            os.path.join(self._dir(circuit_id), "proving_key.npz"),
            device=self.device,
        )
        return r1cs, pk

    def get_files(self, circuit_id: str) -> tuple[bytes, bytes]:
        r1cs = open(self._latest(circuit_id, ".r1cs"), "rb").read()
        try:
            wasm = open(self._latest(circuit_id, ".wasm"), "rb").read()
        except FileNotFoundError:
            wasm = b""
        return r1cs, wasm
