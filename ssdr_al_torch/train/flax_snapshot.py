"""JAX snapshots read without flax: the `snap-<n>` files that
ssdr_al_tpu/train/trainer.py::save_checkpoint writes (flax.serialization.
to_bytes of {"params", "batch_stats"}, trainer.py:375-391) as the port's
state_dict.

flax writes msgpack: nested maps of str keys whose leaves are msgpack
extension objects, type 1 (an ndarray) or 3 (a numpy scalar), each holding
the packed tuple (shape, dtype name, C-order bytes). The machine with the
card has no msgpack package, so this module carries a decoder for the
part of msgpack those files use: maps, arrays, str, bin, ints, floats,
nil, bool and the two extension types. bfloat16 arrays (a JAX dtype, not
numpy's) are widened to float32 exactly. Anything else, a truncated file
or trailing bytes raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from ssdr_al_torch.models.randlanet import params_from_flax

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos}: "
                             f"{n} bytes needed, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# (struct format of the length, kind) of the sized formats by lead byte
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _sized(r, "map", b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _sized(r, "array", b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        return _sized(r, "str", b & 0x1f)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXEXT:
        return _ext(r.unpack(">b"), bytes(r.take(_FIXEXT[b])))
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        return _sized(r, kind, r.unpack(fmt))
    raise ValueError(f"msgpack: unsupported lead byte 0x{b:02x} at byte "
                     f"{r.pos - 1}")


def _sized(r: _Reader, kind: str, n: int):
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "array":
        return [_decode(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _decode(r)
            out[k] = _decode(r)
        return out
    return _ext(r.unpack(">b"), bytes(r.take(n)))


def _ext(code: int, payload: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported extension type {code}")
    shape, dtype, buf = unpackb(payload)
    if dtype == "bfloat16":
        arr = (np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
               ).view(np.float32)
    else:
        arr = np.frombuffer(buf, np.dtype(dtype))
    arr = arr.reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The one msgpack object that `data` holds."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def load_flax_snapshot(path: str) -> dict:
    """A JAX `snap-<n>` file as the port's state_dict of CPU tensors
    (models/randlanet.py::params_from_flax)."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict) or set(tree) != {"params", "batch_stats"}:
        raise ValueError(f"{path}: not a JAX snapshot of params and "
                         "batch_stats")
    return params_from_flax(tree["params"], tree["batch_stats"])
