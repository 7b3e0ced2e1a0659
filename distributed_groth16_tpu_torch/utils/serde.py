"""Typed wire serialization for network collectives — the MpcSerNet role.

The reference's typed channel layer (dist-primitives/src/channel/mod.rs)
canonical-serializes arkworks values at the process boundary; here the
values crossing a real transport are pytrees of uint32 limb tensors
(device arrays), so the wire format is a tiny structure header plus raw
little-endian array buffers. Pickle-free: the transport may span trust
domains.

Format: u8 tag per node — 0 none, 1 array, 2 list, 3 tuple, 4 int,
5 str — arrays as (dtype_code u8, ndim u8, dims u32*, raw bytes),
lists/tuples as (count u32, children), ints as i64, strs as
(byte-count u32, utf-8 bytes; the ERR-frame payload of prodnet.py).
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {0: np.uint32, 1: np.int32, 2: np.uint8, 3: np.int64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def dumps(value) -> bytes:
    out = bytearray()
    _enc(value, out)
    return bytes(out)


def _enc(v, out: bytearray) -> None:
    if v is None:
        out.append(0)
    elif isinstance(v, (list, tuple)):
        out.append(2 if isinstance(v, list) else 3)
        out += struct.pack("<I", len(v))
        for x in v:
            _enc(x, out)
    elif isinstance(v, (int, np.integer)):
        out.append(4)
        out += struct.pack("<q", int(v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(5)
        out += struct.pack("<I", len(b))
        out += b
    else:
        arr = np.asarray(v)
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise TypeError(f"unsupported wire dtype {arr.dtype}")
        out.append(1)
        out.append(code)
        out.append(arr.ndim)
        out += struct.pack(f"<{arr.ndim}I", *arr.shape)
        out += arr.astype(arr.dtype, copy=False).tobytes()


def loads(data: bytes):
    v, pos = _dec(data, 0)
    if pos != len(data):
        raise ValueError("trailing bytes in wire value")
    return v


def _dec(data: bytes, pos: int):
    tag = data[pos]
    pos += 1
    if tag == 0:
        return None, pos
    if tag in (2, 3):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        items = []
        for _ in range(n):
            x, pos = _dec(data, pos)
            items.append(x)
        return (items if tag == 2 else tuple(items)), pos
    if tag == 4:
        (x,) = struct.unpack_from("<q", data, pos)
        return x, pos + 8
    if tag == 5:
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if pos + n > len(data):
            # slicing would silently truncate; fail like every other tag
            raise ValueError("truncated wire string")
        return data[pos : pos + n].decode("utf-8"), pos + n
    if tag == 1:
        code, ndim = data[pos], data[pos + 1]
        pos += 2
        dims = struct.unpack_from(f"<{ndim}I", data, pos)
        pos += 4 * ndim
        dtype = np.dtype(_DTYPES[code])
        count = int(np.prod(dims, dtype=np.int64)) if ndim else 1
        nbytes = count * dtype.itemsize
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
        return arr.reshape(dims), pos + nbytes
    raise ValueError(f"bad wire tag {tag}")
