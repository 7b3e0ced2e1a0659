"""QAP witness reduction on device — the counterpart of
distributed_groth16_tpu/models/groth16/qap.py (the reference's
groth16/src/qap.rs:44-91 semantics).

`CompiledR1CS.qap(z)`: per-constraint inner products a_j = <A_j, z>,
b_j = <B_j, z> on the size-m domain, the input-consistency rows
a[nc..nc+ni] = z[..ni], and c = a * b. The sparse matvec is one batched
Montgomery multiply over the nnz entries, an inclusive prefix sum under
field addition (Hillis-Steele, log2(nnz) batched adds) and a per-row
boundary difference — the same canonical values as the JAX package's
associative scan. `QAP.pss` splits the vectors into per-party packed
shares in the d_fft layout (qap.rs:143-187).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ...frontend.r1cs import R1CS
from ...ops.field import fr, inclusive_scan, resolve_device
from ...ops.ntt import Domain, domain
from ...parallel.packing import pack_strided
from ...parallel.pss import PackedSharingParams


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@dataclass
class SparseMatrixDevice:
    """Sorted-COO device form of one R1CS matrix (rows sorted)."""

    coeffs: torch.Tensor  # (nnz, 16) Montgomery
    cols: torch.Tensor  # (nnz,) wire index
    ends_idx: torch.Tensor  # (num_rows,) clamp(end-1, 0)
    starts_idx: torch.Tensor  # (num_rows,) clamp(start-1, 0)
    nonempty: torch.Tensor  # (num_rows,) bool
    at_origin: torch.Tensor  # (num_rows,) bool: row starts at entry 0
    num_rows: int

    @staticmethod
    def build(rows, device) -> "SparseMatrixDevice":
        coeffs, cols, row_ids = [], [], []
        for j, row in enumerate(rows):
            for coeff, wire in row:
                coeffs.append(coeff)
                cols.append(wire)
                row_ids.append(j)
        if not coeffs:  # fully empty matrix: keep one dummy zero entry
            coeffs, cols, row_ids = [0], [0], [0]
        row_ids = np.asarray(row_ids, dtype=np.int64)
        starts = np.searchsorted(row_ids, np.arange(len(rows)), side="left")
        ends = np.searchsorted(row_ids, np.arange(len(rows)), side="right")

        def t(a):
            return torch.as_tensor(a, device=device)

        return SparseMatrixDevice(
            coeffs=fr().encode(coeffs, device),
            cols=t(np.asarray(cols, dtype=np.int64)),
            ends_idx=t(np.maximum(ends - 1, 0)),
            starts_idx=t(np.maximum(starts - 1, 0)),
            nonempty=t(ends > starts),
            at_origin=t(starts == 0),
            num_rows=len(rows),
        )

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        """(nw, 16) Montgomery assignment -> (num_rows, 16) row inner
        products."""
        F = fr()
        prefix = inclusive_scan(F.add, F.mul(self.coeffs, z[self.cols]))
        hi = prefix[self.ends_idx]
        lo = prefix[self.starts_idx]
        val = torch.where(self.at_origin[:, None], hi, F.sub(hi, lo))
        return torch.where(self.nonempty[:, None], val, torch.zeros_like(val))


@dataclass
class QAP:
    """Evaluated QAP vectors on device (groth16/src/qap.rs:17-29)."""

    num_inputs: int
    num_constraints: int
    a: torch.Tensor  # (m, 16)
    b: torch.Tensor  # (m, 16)
    c: torch.Tensor  # (m, 16)
    domain: Domain

    def pss(self, pp: PackedSharingParams) -> list["PackedQAPShare"]:
        """Per-party packed shares in the bitrev+strided d_fft layout
        (qap.rs:143-187)."""
        sa = pack_strided(pp, self.a)
        sb = pack_strided(pp, self.b)
        sc = pack_strided(pp, self.c)
        return [
            PackedQAPShare(
                num_inputs=self.num_inputs,
                num_constraints=self.num_constraints,
                a=sa[i], b=sb[i], c=sc[i], domain=self.domain,
            )
            for i in range(pp.n)
        ]


@dataclass
class PackedQAPShare:
    """One party's packed shares of the QAP vectors."""

    num_inputs: int
    num_constraints: int
    a: torch.Tensor  # (m/l, 16)
    b: torch.Tensor
    c: torch.Tensor
    domain: Domain


class CompiledR1CS:
    """R1CS lowered to device tensors once, reusable across witnesses."""

    def __init__(self, r1cs: R1CS, device=None):
        dev = resolve_device(device)
        self.r1cs = r1cs
        self.num_inputs = r1cs.num_instance
        self.num_constraints = r1cs.num_constraints
        self.domain_size = _next_pow2(self.num_constraints + self.num_inputs)
        self.A = SparseMatrixDevice.build(r1cs.a, dev)
        self.B = SparseMatrixDevice.build(r1cs.b, dev)

    @cached_property
    def dom(self) -> Domain:
        return domain(self.domain_size)

    def qap(self, z_mont: torch.Tensor) -> QAP:
        """z_mont: (num_wires, 16) Montgomery full assignment."""
        F = fr()
        m = self.domain_size
        nc, ni = self.num_constraints, self.num_inputs
        a = torch.cat([self.A.matvec(z_mont), z_mont[:ni]], dim=0)
        a = torch.nn.functional.pad(a, (0, 0, 0, m - nc - ni))
        b = torch.nn.functional.pad(self.B.matvec(z_mont), (0, 0, 0, m - nc))
        c = F.mul(a, b)  # b is zero past nc, so c too (qap.rs:75-81)
        return QAP(
            num_inputs=ni, num_constraints=nc, a=a, b=b, c=c, domain=self.dom,
        )


def qap_from_r1cs(r1cs: R1CS, assignment: list[int], device=None) -> QAP:
    """One-shot helper: host assignment ints -> QAP on `device` (None:
    CUDA)."""
    return CompiledR1CS(r1cs, device).qap(fr().encode(assignment, device))
