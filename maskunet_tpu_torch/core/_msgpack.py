"""The msgpack subset that flax's checkpoints use, in plain Python.

The JAX package writes its checkpoints with `flax.serialization.to_bytes`
(msgpack with numpy arrays as ext types); the card has neither msgpack nor
flax, so the port reads and writes that format itself:

- maps with str keys, arrays, str, bin, int, float (written as float64),
  bool and nil;
- ext 1: an ndarray, whose payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``; ext 3: a numpy scalar, with the
  same payload; ext 2 (a Python complex) is refused;
- lists and tuples are written as maps keyed "0", "1", ..., as flax's
  `to_state_dict` turns them;
- an array over `MAX_CHUNK_SIZE` bytes is written, and read back, in
  flax's ``__msgpack_chunked_array__`` form (the flat array cut into
  chunks of at most that size, with its shape);
- the dtype name "bfloat16" (which numpy lacks) is read as a
  ``torch.bfloat16`` tensor through a uint16 view, and a bf16 tensor is
  written that way; every other array is read as a numpy array.

`packb` gives the bytes flax's `to_bytes` gives for the same tree (map keys
in the tree's own order); `unpackb` is `flax.serialization.msgpack_restore`.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30          # flax's limit for one leaf, in bytes
_CHUNKED = "__msgpack_chunked_array__"

# (least, greatest, type byte, struct format) in msgpack's order of choice
_INTS = ((0, 0xFF, 0xCC, ">BB"), (-0x80, -1, 0xD0, ">Bb"),
         (0, 0xFFFF, 0xCD, ">BH"), (-0x8000, -1, 0xD1, ">Bh"),
         (0, 0xFFFFFFFF, 0xCE, ">BI"), (-0x80000000, -1, 0xD2, ">Bi"),
         (0, 2 ** 64 - 1, 0xCF, ">BQ"), (-2 ** 63, -1, 0xD3, ">Bq"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(x: int) -> bytes:
    if -0x20 <= x < 0x80:
        return struct.pack("b" if x < 0 else "B", x)
    for lo, hi, code, fmt in _INTS:
        if lo <= x <= hi:
            return struct.pack(fmt, code, x)
    raise OverflowError(f"integer {x} does not fit 64 bits")


def _sized(n: int, fix: tuple | None, c8: int | None, c16: int, c32: int
           ) -> bytes:
    """A length header: the fix form (fix = (limit, base)) below its limit,
    else 8-bit (where the type has one), 16-bit or 32-bit lengths."""
    if fix is not None and n < fix[0]:
        return bytes((fix[1] | n,))
    if c8 is not None and n <= 0xFF:
        return bytes((c8, n))
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    return struct.pack(">BI", c32, n)


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (32, 0xA0), 0xD9, 0xDA, 0xDB) + b


def _bin(n: int) -> bytes:
    return _sized(n, None, 0xC4, 0xC5, 0xC6)


def _array_header(n: int) -> bytes:
    return _sized(n, (16, 0x90), None, 0xDC, 0xDD)


def _map_header(n: int) -> bytes:
    return _sized(n, (16, 0x80), None, 0xDE, 0xDF)


def _ext(code: int, n: int) -> bytes:
    head = (bytes((_FIXEXT[n],)) if n in _FIXEXT
            else _sized(n, None, 0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code)


def _as_numpy(x) -> tuple[np.ndarray, str]:
    """An array leaf as (C-contiguous numpy array, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
        x = x.copy(order="C")
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise TypeError(f"cannot write an array of dtype {x.dtype}")
    return x, x.dtype.name


def _pack_array(out: list, code: int, x) -> None:
    """ext `code` holding msgpack((shape, dtype name, bytes)); the data is
    appended as a view of the array, without a copy."""
    arr, name = _as_numpy(x)
    head = (_array_header(3) + _array_header(arr.ndim)
            + b"".join(_int(int(d)) for d in arr.shape)
            + _str(name) + _bin(arr.nbytes))
    out.append(_ext(code, len(head) + arr.nbytes) + head)
    out.append(memoryview(arr.reshape(-1)).cast("B"))


def _chunked(x) -> dict:
    """flax's `_chunk`: the flat array in pieces of at most MAX_CHUNK_SIZE
    bytes, with its shape."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = x.reshape(-1)
    return {_CHUNKED: True, "shape": tuple(int(d) for d in x.shape),
            "chunks": tuple(flat[i:i + size]
                            for i in range(0, flat.shape[0], size))}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, (bytes, bytearray)):
        out.append(_bin(len(x)) + bytes(x))
    elif isinstance(x, (list, tuple)):
        _pack({str(i): v for i, v in enumerate(x)}, out)
    elif isinstance(x, dict):
        out.append(_map_header(len(x)))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            out.append(_str(k))
            _pack(v, out)
    elif isinstance(x, np.generic):
        _pack_array(out, EXT_NPSCALAR, np.asarray(x))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(_chunked(x), out)
        else:
            _pack_array(out, EXT_NDARRAY, x)
    elif isinstance(x, complex):
        raise TypeError("a Python complex (ext type 2) is not written")
    else:
        raise TypeError(f"cannot write {type(x).__name__}")


def pack_chunks(tree) -> list:
    """The encoding of `tree` as a list of bytes and memoryviews over the
    arrays' own data (for `file.writelines`, without one large copy)."""
    out: list = []
    _pack(tree, out)
    return out


def packb(tree) -> bytes:
    return b"".join(pack_chunks(tree))


# type byte -> struct format of a fixed-size value
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (kind, struct format of its length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def header(self) -> tuple[str, object]:
        """(kind, value or length) of the next object's header."""
        b = self.take(1)[0]
        if b <= 0x7F or b >= 0xE0:
            return "value", b if b <= 0x7F else b - 0x100
        for base, kind in ((0x80, "map"), (0x90, "array")):
            if base <= b <= base + 0x0F:
                return kind, b & 0x0F
        if 0xA0 <= b <= 0xBF:
            return "str", b & 0x1F
        if b in (0xC0, 0xC2, 0xC3):
            return "value", {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return "value", self.unpack(_FIXED[b])
        if b in _FIXEXT.values():
            return "ext", 1 << (b - 0xD4)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return kind, self.unpack(fmt)
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def read(self):
        kind, n = self.header()
        if kind == "value":
            return n
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.read()
                out[key] = self.read()
            return out
        return self.ext(n)

    def ext(self, n: int):
        code = self.unpack("b")
        payload = _Reader(self.take(n))
        if code == EXT_COMPLEX:
            raise ValueError("a Python complex (ext type 2) is not read: no "
                             "checkpoint holds one")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        if payload.header() != ("array", 3):
            raise ValueError("malformed ndarray payload")
        shape, name = payload.read(), payload.read()
        kind, size = payload.header()
        if kind != "bin":
            raise ValueError("malformed ndarray payload")
        data = payload.take(size)
        if name == "bfloat16":
            arr = np.frombuffer(data, np.uint16).reshape(shape)
            return torch.from_numpy(arr.copy()).view(torch.bfloat16)
        arr = np.frombuffer(data, np.dtype(name)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    """Joins flax's chunked arrays back into arrays, everywhere."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts).reshape(shape)
        return np.concatenate(parts).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(buf):
    """Decodes one msgpack object from `buf` (bytes, bytearray or a
    memoryview). Arrays are views of `buf`, so a writable buffer (a
    bytearray) gives writable arrays."""
    reader = _Reader(buf)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)
