"""Share-vector layout helpers — the counterpart of
distributed_groth16_tpu/parallel/packing.py: the n x (m/l) <-> (m/l) x n
reshapes and the two chunking conventions of the reference
(dist-primitives/src/utils/pack.rs; groth16/src/qap.rs:143-187).

Layouts over a clear vector s of length m (l secrets per share, c = m/l
chunks):

  * consecutive ("pack_vec"): chunk i = s[i*l .. (i+1)*l]
  * strided + bit-reversed ("qap/dfft layout"): first bit-reverse s, then
    chunk i = s_rev[i], s_rev[i+c], s_rev[i+2c], ...

Both pack each chunk with PSS and transpose to per-party share vectors of
shape (n, c, 16).
"""

from __future__ import annotations

import torch

from ..ops.ntt import bitrev_perm
from .pss import PackedSharingParams


def pack_consecutive(pp: PackedSharingParams, vec: torch.Tensor) -> torch.Tensor:
    """(m, 16) clear vector -> (n, m/l, 16) per-party shares, consecutive
    chunking (pack_vec + transpose)."""
    m = vec.shape[0]
    assert m % pp.l == 0
    chunks = vec.reshape(m // pp.l, pp.l, 16)
    shares = pp.pack_from_public(chunks)  # (c, n, 16)
    return shares.transpose(0, 1)


def pack_strided(pp: PackedSharingParams, vec: torch.Tensor) -> torch.Tensor:
    """(m, 16) clear vector -> (n, m/l, 16) per-party shares in the
    bit-reversed strided layout every d_fft/d_ifft input uses."""
    m = vec.shape[0]
    assert m % pp.l == 0
    c = m // pp.l
    perm = torch.as_tensor(bitrev_perm(m), device=vec.device)
    x = vec[perm]
    chunks = x.reshape(pp.l, c, 16).transpose(0, 1)  # chunk i slot j = x[i + j*c]
    shares = pp.pack_from_public(chunks)  # (c, n, 16)
    return shares.transpose(0, 1)


def unpack_shares(
    pp: PackedSharingParams, shares: torch.Tensor, degree2: bool = False
) -> torch.Tensor:
    """(n, c, 16) per-party shares -> (c*l, 16) clear vector in chunk-major
    order (element i*l + j = secret j of chunk i)."""
    chunks = shares.transpose(0, 1)  # (c, n, 16)
    secrets = pp.unpack2(chunks) if degree2 else pp.unpack(chunks)
    return secrets.reshape(-1, 16)
