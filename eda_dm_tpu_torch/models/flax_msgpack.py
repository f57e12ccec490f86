"""A reader of Flax's ``flax_model.msgpack`` (``flax.serialization.to_bytes``,
what ``transformers``' Flax models write) on the standard library, numpy
and torch: no ``msgpack``, ``flax`` or ``jax``.

The file is one msgpack map.  Its leaves are Flax's ndarray extension
(type 1: a msgpack triple of shape, dtype name and the C-order bytes) or
its numpy-scalar extension (type 3, the same triple of a 0-d array);
arrays over ``2**30`` bytes are split into chunk dictionaries
(``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": ...}}``), which are put back together here.  Each array comes back
as a CPU tensor of its own dtype (bfloat16, which numpy lacks, through
uint16) sharing the file's bytes where they are aligned.  Anything else
raises ``RuntimeError`` naming the file.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict

import numpy as np
import torch

NDARRAY, NPSCALAR = 1, 3                    # flax.serialization._MsgpackExtType
CHUNKED = "__msgpack_chunked_array__"

# dtype name -> (numpy dtype of the bytes, torch dtype to view them as)
DTYPES = {
    "float64": ("<f8", torch.float64), "float32": ("<f4", torch.float32),
    "float16": ("<f2", torch.float16), "bfloat16": ("<u2", torch.bfloat16),
    "int64": ("<i8", torch.int64), "int32": ("<i4", torch.int32),
    "int16": ("<i2", torch.int16), "int8": ("i1", torch.int8),
    "uint8": ("u1", torch.uint8), "bool": ("?", torch.bool),
}

# fixed-width scalars: first byte -> struct format (big-endian, as msgpack is)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length prefixes of str, bin, array, map and ext: first byte -> (kind, struct format)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_MAX_DEPTH = 512


class _Decoder:
    def __init__(self, buf, path: str):
        self.buf, self.pos, self.path = memoryview(buf), 0, path

    def error(self, why: str) -> RuntimeError:
        return RuntimeError(f"{self.path}: not a Flax msgpack checkpoint this reader takes: {why}")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise self.error(f"truncated: {n} bytes wanted at offset {self.pos} of "
                             f"{len(self.buf)}")
        out, self.pos = self.buf[self.pos:end], end
        return out

    def scalar(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, depth: int = 0) -> Any:
        if depth > _MAX_DEPTH:
            raise self.error(f"nested deeper than {_MAX_DEPTH}")
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, depth)
        if 0x90 <= b <= 0x9f:
            return [self.value(depth + 1) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _SCALARS:
            return self.scalar(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _SIZED:
            raise self.error(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")
        kind, fmt = _SIZED[b]
        n = self.scalar(fmt)
        if kind == "str":
            return self.str(n)
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.value(depth + 1) for _ in range(n)]
        if kind == "map":
            return self.map(n, depth)
        return self.ext(n)

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise self.error(f"a string is not UTF-8 ({e})") from None

    def map(self, n: int, depth: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.value(depth + 1)
            if isinstance(k, memoryview):
                k = bytes(k)
            if isinstance(k, (dict, list, torch.Tensor)):
                raise self.error(f"a map key is a {type(k).__name__}")
            out[k] = self.value(depth + 1)
        return self.unchunk(out) if CHUNKED in out else out

    def ext(self, n: int) -> torch.Tensor:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (NDARRAY, NPSCALAR):
            raise self.error(f"extension type {code} is not an array")
        inner = _Decoder(payload, self.path)
        triple = inner.value()
        if inner.pos != len(payload):
            raise self.error(f"{len(payload) - inner.pos} bytes follow an array's header")
        if not (isinstance(triple, list) and len(triple) == 3):
            raise self.error("an array's header is not (shape, dtype, bytes)")
        shape, name, data = triple
        if isinstance(name, memoryview):
            name = str(name, "ascii", "replace")
        if not (isinstance(shape, list) and all(isinstance(s, int) and s >= 0 for s in shape)):
            raise self.error(f"an array's shape is {shape!r}")
        if name not in DTYPES:
            raise self.error(f"an array has dtype {name!r}, which is not read "
                             f"(it reads {', '.join(DTYPES)})")
        if not isinstance(data, memoryview):
            raise self.error("an array's data is not bytes")
        np_dtype, dtype = DTYPES[name]
        count = math.prod(shape)
        if len(data) != count * np.dtype(np_dtype).itemsize:
            raise self.error(f"an array of shape {tuple(shape)} and dtype {name} holds "
                             f"{len(data)} bytes")
        a = np.frombuffer(data, dtype=np_dtype).reshape(shape)
        if not a.flags.aligned:
            a = a.copy()
        t = torch.from_numpy(a)
        return t.view(dtype) if t.dtype != dtype else t

    def unchunk(self, d: Dict[str, Any]) -> torch.Tensor:
        """flax.serialization._unchunk: the chunks in key order, flat, then
        the shape."""
        shape, chunks = d.get("shape"), d.get("chunks")
        if d[CHUNKED] is not True or not isinstance(shape, dict) or not isinstance(chunks, dict):
            raise self.error(f"a chunked array's dictionary is {sorted(map(str, d))}")
        try:
            shape = [shape[str(i)] for i in range(len(shape))]
            parts = [chunks[str(i)] for i in range(len(chunks))]
        except KeyError as e:
            raise self.error(f"a chunked array lacks index {e}") from None
        if not parts or not all(isinstance(p, torch.Tensor) and p.dim() == 1 and
                                p.dtype == parts[0].dtype for p in parts):
            raise self.error("a chunked array's chunks are not flat arrays of one dtype")
        flat = torch.cat(parts)
        if flat.numel() != math.prod(shape):
            raise self.error(f"a chunked array of shape {tuple(shape)} holds {flat.numel()} "
                             f"elements")
        return flat.reshape(shape)


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """The nested dictionary of CPU tensors in the Flax checkpoint at
    ``path``.  A truncated file, trailing bytes, or a type Flax's
    ``to_bytes`` does not write raise ``RuntimeError``."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    dec = _Decoder(data, path)
    tree = dec.value()
    if not isinstance(tree, dict):
        raise dec.error(f"the top value is a {type(tree).__name__}, not a map")
    if dec.pos != len(data):
        raise dec.error(f"{len(data) - dec.pos} bytes follow the top map")
    return tree
