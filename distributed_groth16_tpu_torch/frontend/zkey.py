"""snarkjs `.zkey` proving-key reader/writer (Groth16, BN254) — the
counterpart of distributed_groth16_tpu/frontend/zkey.py, on tensors.

Binary-format parity with the reference's zkey parser
(ark-circom/src/zkey.rs:53-385): a `zkey` section container holding

  1  ProverType          u32 == 1 (Groth16)
  2  HeaderGroth         n8q, q, n8r, r, nVars, nPub, domainSize, then the
                         vk points alpha1 beta1 beta2 gamma2 delta1 delta2
  3  IC                  (nPub+1) G1   — gamma_abc
  4  Coefs               u32 count, then (matrix, constraint, signal) u32
                         triples + an Fr value per nonzero of A and B,
                         including one synthetic A-row per public signal
                         (the rows arkworks re-adds itself, zkey.rs:164-177)
  5  PointsA             nVars G1
  6  PointsB1            nVars G1
  7  PointsB2            nVars G2
  8  PointsC             (nVars - nPub - 1) G1 — l_query
  9  PointsH             domainSize G1
  10 Contributions       ignored (zkey.rs reads nothing from it)

Field encodings (zkey.rs:330-352): Fq coordinates are stored in Montgomery
form (raw = x * 2^256 mod q), byte-identical to the port's limb layout
(16-bit limbs of the Montgomery form, ops/field.py), so a point section
parses as one `np.frombuffer` and lands on the device as int32 limbs with
no bigint work. Fr matrix coefficients are stored multiplied by R^2
(raw = v * 2^512 mod r, the double-division in zkey.rs:331-334).
Infinity encodes as all-zero coordinates.

Every device tensor lives on the `device` argument (None: CUDA). The
writer converts the query arrays to affine on their own device. The
reader refuses a coefficient that names a signal outside the key's
nVars: the JAX package's QAP gather would clamp such an index, the
port's would raise later, so the port names the file's fault where it
reads it. A section of no points (the PointsC of a circuit without
witness wires) reads as an empty tensor, where the JAX reader's reshape
fails.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

from ..models.groth16.keys import ProvingKey, VerifyingKey
from ..ops.constants import Q, R
from ..ops.field import resolve_device
from .r1cs import R1CS

_MONT = 1 << 256
_MONT_Q = _MONT % Q
_MONT_Q_INV = pow(_MONT_Q, Q - 2, Q)
_MONT_R = _MONT % R
_MONT_R_INV = pow(_MONT_R, R - 2, R)

_MAGIC = b"zkey"


# ---------------------------------------------------------------------------
# low-level field/point codecs
# ---------------------------------------------------------------------------


def _fq_mont_bytes(x_std: int) -> bytes:
    return (x_std * _MONT_Q % Q).to_bytes(32, "little")


def _fr_r2_bytes(v_std: int) -> bytes:
    """Fr coefficient as stored: v * R^2 mod r (zkey.rs:329-334)."""
    return (v_std * _MONT_R % R * _MONT_R % R).to_bytes(32, "little")


def _limbs_to_mont_bytes(limbs: torch.Tensor) -> bytes:
    """int32 limb tensor (..., 16) -> raw Montgomery bytes."""
    return np.ascontiguousarray(limbs.cpu().numpy()).astype("<u2").tobytes()


# Fq one in Montgomery limbs: the z of a finite affine point
_ONE = np.frombuffer(_fq_mont_bytes(1), dtype="<u2").astype(np.int32)


def _g1_array_from_bytes(buf: bytes, n: int, device) -> torch.Tensor:
    """n * 64 bytes of (x, y) Montgomery coords -> (n, 3, 16) projective
    int32 limbs on `device`. Zero coords = infinity -> (0, 1, 0)."""
    raw = np.frombuffer(buf, dtype="<u2", count=n * 32).astype(np.int32)
    xy = raw.reshape(n, 2, 16)
    inf = ~np.any(raw.reshape(n, 32), axis=1)
    z = np.where(inf[:, None], 0, _ONE[None, :]).astype(np.int32)
    y = np.where(inf[:, None], _ONE[None, :], xy[:, 1]).astype(np.int32)
    return torch.as_tensor(np.stack([xy[:, 0], y, z], axis=1), device=device)


def _g2_array_from_bytes(buf: bytes, n: int, device) -> torch.Tensor:
    """n * 128 bytes of (x.c0, x.c1, y.c0, y.c1) -> (n, 3, 2, 16)."""
    raw = np.frombuffer(buf, dtype="<u2", count=n * 64).astype(np.int32)
    xy = raw.reshape(n, 2, 2, 16)
    inf = ~np.any(raw.reshape(n, 64), axis=1)
    fq2_one = np.stack([_ONE, np.zeros_like(_ONE)], axis=0)  # (1, 0)
    z = np.where(inf[:, None, None], 0, fq2_one[None]).astype(np.int32)
    # infinity encodes as the projective (0, 1, 0)
    y = np.where(inf[:, None, None], fq2_one[None], xy[:, 1]).astype(np.int32)
    return torch.as_tensor(np.stack([xy[:, 0], y, z], axis=1), device=device)


def _g1_bytes_from_limbs(pts_proj: torch.Tensor) -> bytes:
    """(n, 3, 16) projective points -> n*64 affine Montgomery bytes."""
    from ..ops.curve import g1

    return _limbs_to_mont_bytes(g1().to_affine(pts_proj))  # inf -> zeros


def _g2_bytes_from_limbs(pts_proj: torch.Tensor) -> bytes:
    from ..ops.curve import g2

    return _limbs_to_mont_bytes(g2().to_affine(pts_proj))  # (n, 2, 2, 16)


def _host_g1(x_mont: int, y_mont: int):
    if x_mont == 0 and y_mont == 0:
        return None
    return (x_mont * _MONT_Q_INV % Q, y_mont * _MONT_Q_INV % Q)


def _host_g2(coords: list[int]):
    if all(c == 0 for c in coords):
        return None
    x0, x1, y0, y1 = (c * _MONT_Q_INV % Q for c in coords)
    return ((x0, x1), (y0, y1))


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


def _parse_sections(data: bytes) -> dict[int, tuple[int, int]]:
    if data[:4] != _MAGIC:
        raise ValueError("bad zkey magic")
    version, n_sections = struct.unpack_from("<II", data, 4)
    if version > 2:
        raise ValueError(f"unsupported zkey version {version}")
    out = {}
    pos = 12
    for _ in range(n_sections):
        typ, size = struct.unpack_from("<IQ", data, pos)
        pos += 12
        out[typ] = (pos, size)
        pos += size
    return out


def read_zkey(path_or_bytes, device=None) -> tuple[ProvingKey, R1CS]:
    """Parse a snarkjs `.zkey` into (ProvingKey on `device`, constraint
    matrices).

    The returned R1CS carries the A/B matrices stored in the Coefs section
    (C is not stored in zkey files — zkey.rs:193-196 returns it empty); its
    `c` rows are empty lists, so a proof takes C from the circuit's .r1cs.
    Mirrors ark-circom's read_zkey (zkey.rs:53-60).
    """
    dev = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    secs = _parse_sections(data)

    # -- header (2) --
    pos, _ = secs[2]
    n8q = struct.unpack_from("<I", data, pos)[0]
    if n8q != 32:
        raise ValueError("only 32-byte base fields supported")
    q = int.from_bytes(data[pos + 4 : pos + 36], "little")
    if q != Q:
        raise ValueError("zkey base field is not BN254 Fq")
    n8r = struct.unpack_from("<I", data, pos + 36)[0]
    r = int.from_bytes(data[pos + 40 : pos + 72], "little")
    if n8r != 32 or r != R:
        raise ValueError("zkey scalar field is not BN254 Fr")
    n_vars, n_public, domain_size = struct.unpack_from("<III", data, pos + 72)
    vkpos = pos + 84
    # alpha1, beta1, beta2, gamma2, delta1, delta2
    w = [
        int.from_bytes(data[vkpos + 32 * i : vkpos + 32 * (i + 1)], "little")
        for i in range(2 + 2 + 4 + 4 + 2 + 4)
    ]
    alpha_g1 = _host_g1(w[0], w[1])
    beta_g1_h = _host_g1(w[2], w[3])
    beta_g2 = _host_g2(w[4:8])
    gamma_g2 = _host_g2(w[8:12])
    delta_g1_h = _host_g1(w[12], w[13])
    delta_g2 = _host_g2(w[14:18])

    # -- point sections --
    def g1_sec(sid: int, n: int) -> torch.Tensor:
        pos, size = secs[sid]
        if size < n * 64:
            raise ValueError(f"zkey section {sid} truncated")
        return _g1_array_from_bytes(data[pos : pos + n * 64], n, dev)

    def g2_sec(sid: int, n: int) -> torch.Tensor:
        pos, size = secs[sid]
        if size < n * 128:
            raise ValueError(f"zkey section {sid} truncated")
        return _g2_array_from_bytes(data[pos : pos + n * 128], n, dev)

    ic = g1_sec(3, n_public + 1)
    a_query = g1_sec(5, n_vars)
    b_g1_query = g1_sec(6, n_vars)
    b_g2_query = g2_sec(7, n_vars)
    l_query = g1_sec(8, n_vars - n_public - 1)
    h_query = g1_sec(9, domain_size)

    from ..ops.curve import g1 as _g1curve

    gamma_abc = _g1curve().decode(ic)
    if not isinstance(gamma_abc, list):
        gamma_abc = [gamma_abc]

    vk = VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc,
    )
    beta_g1_d = _g1curve().encode([beta_g1_h], dev)[0]
    delta_g1_d = _g1curve().encode([delta_g1_h], dev)[0]
    pk = ProvingKey(
        vk=vk,
        beta_g1=beta_g1_d,
        delta_g1=delta_g1_d,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        domain_size=domain_size,
        num_instance=n_public + 1,
    )

    # -- Coefs (4): A/B matrices -- (zkey.rs:150-198)
    pos, _ = secs[4]
    (n_coeffs,) = struct.unpack_from("<I", data, pos)
    pos += 4
    rows_a: dict[int, list] = {}
    rows_b: dict[int, list] = {}
    # one vectorized frombuffer over the fixed 44-byte records, then one
    # Montgomery-correction pass over the UNIQUE coefficient patterns
    # (real circuits use a handful, mostly ±1)
    rec = np.dtype(
        [("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("v", "V32")]
    )
    arr = np.frombuffer(data, dtype=rec, count=n_coeffs, offset=pos)
    if n_coeffs and int(arr["s"].max()) >= n_vars:
        raise ValueError(
            f"zkey coefficient names signal {int(arr['s'].max())} of "
            f"{n_vars}"
        )
    rinv2 = _MONT_R_INV * _MONT_R_INV % R
    max_constraint = int(arr["c"].max()) if n_coeffs else 0
    uniq, inv_idx = np.unique(arr["v"], return_inverse=True)
    uvals = [
        int.from_bytes(u.tobytes(), "little") * rinv2 % R for u in uniq
    ]
    for matrix, constraint, signal, vi in zip(
        arr["m"].tolist(), arr["c"].tolist(), arr["s"].tolist(),
        inv_idx.tolist(),
    ):
        (rows_a if matrix == 0 else rows_b).setdefault(constraint, []).append(
            (uvals[vi], signal)
        )
    # drop the synthetic public-input rows arkworks re-adds (zkey.rs:173-177)
    num_constraints = max_constraint - n_public
    a = [rows_a.get(j, []) for j in range(num_constraints)]
    b = [rows_b.get(j, []) for j in range(num_constraints)]
    matrices = R1CS(
        num_instance=n_public + 1,
        num_witness=n_vars - n_public - 1,
        a=a,
        b=b,
        c=[[] for _ in range(num_constraints)],
    )
    return pk, matrices


def write_zkey(pk: ProvingKey, r1cs: R1CS) -> bytes:
    """Serialize a ProvingKey (+ its circuit's A/B matrices) to the snarkjs
    `.zkey` binary format, inverse of read_zkey. Emits the synthetic
    public-input A-rows the reference reader strips (zkey.rs:164-177) so
    external snarkjs/ark-circom tooling parses the file identically. The
    points go to affine on the key's device."""
    n_public = pk.num_instance - 1
    n_vars = pk.num_wires
    if r1cs.num_instance != pk.num_instance:
        raise ValueError("r1cs/proving-key instance-count mismatch")

    vk = pk.vk

    def g1h(pt) -> bytes:
        if pt is None:
            return b"\x00" * 64
        return _fq_mont_bytes(pt[0]) + _fq_mont_bytes(pt[1])

    def g2h(pt) -> bytes:
        if pt is None:
            return b"\x00" * 128
        (x0, x1), (y0, y1) = pt
        return b"".join(_fq_mont_bytes(c) for c in (x0, x1, y0, y1))

    header = struct.pack("<I", 32) + Q.to_bytes(32, "little")
    header += struct.pack("<I", 32) + R.to_bytes(32, "little")
    header += struct.pack("<III", n_vars, n_public, pk.domain_size)
    header += g1h(vk.alpha_g1)
    header += _g1_bytes_from_limbs(pk.beta_g1[None])
    header += g2h(vk.beta_g2)
    header += g2h(vk.gamma_g2)
    header += _g1_bytes_from_limbs(pk.delta_g1[None])
    header += g2h(vk.delta_g2)

    # Coefs: A and B nonzeros + synthetic A-rows for signals 0..n_public
    coefs = io.BytesIO()
    nc = r1cs.num_constraints
    entries = 0
    for matrix, rows in ((0, r1cs.a), (1, r1cs.b)):
        for j, row in enumerate(rows):
            for coeff, wire in row:
                coefs.write(struct.pack("<III", matrix, j, wire))
                coefs.write(_fr_r2_bytes(coeff))
                entries += 1
    for i in range(n_public + 1):
        coefs.write(struct.pack("<III", 0, nc + i, i))
        coefs.write(_fr_r2_bytes(1))
        entries += 1
    coefs_payload = struct.pack("<I", entries) + coefs.getvalue()

    from ..ops.curve import g1 as _g1curve

    ic_dev = _g1curve().encode(vk.gamma_abc_g1, pk.device)

    sections = [
        (1, struct.pack("<I", 1)),
        (2, header),
        (3, _g1_bytes_from_limbs(ic_dev)),
        (4, coefs_payload),
        (5, _g1_bytes_from_limbs(pk.a_query)),
        (6, _g1_bytes_from_limbs(pk.b_g1_query)),
        (7, _g2_bytes_from_limbs(pk.b_g2_query)),
        (8, _g1_bytes_from_limbs(pk.l_query)),
        (9, _g1_bytes_from_limbs(pk.h_query)),
        (10, struct.pack("<I", 0)),  # zero contributions
    ]
    buf = io.BytesIO()
    buf.write(_MAGIC + struct.pack("<II", 1, len(sections)))
    for typ, payload in sections:
        buf.write(struct.pack("<IQ", typ, len(payload)))
        buf.write(payload)
    return buf.getvalue()
