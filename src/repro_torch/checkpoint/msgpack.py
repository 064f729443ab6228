"""The port's own msgpack codec, for the checkpoint format.

Covers what ``msgpack.packb(obj, use_bin_type=True)`` and
``msgpack.unpackb(data, raw=...)`` do on checkpoint payloads, without
the ``msgpack`` package: nil, bool, int (positive and negative fixint,
then 8/16/32/64 bits), float64, str (fixstr, str8/16/32), bin8/16/32,
and array and map (fix, 16 and 32).  Encoding always takes the smallest
form, as msgpack does, so the bytes equal ``msgpack.packb``'s for the
same payload.  Decoding raises ``ValueError`` on a truncated buffer, on
trailing bytes and on a type byte it does not handle (ext, float32, the
unused 0xc1); it never guesses.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

_U32 = 0xFFFFFFFF


def _header(out: bytearray, n: int, fix_base: int, fix_limit: int,
            codes: Tuple[Tuple[int, int, str], ...], what: str) -> None:
    """Append the smallest header of a length ``n``: the fix form below
    ``fix_limit`` (when there is one), else the first ``(code, limit,
    struct format)`` whose limit holds ``n``."""
    if fix_limit and n < fix_limit:
        out.append(fix_base | n)
        return
    for code, limit, fmt in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {what} of {n} is too large")


_STR = ((0xD9, 0xFF, ">B"), (0xDA, 0xFFFF, ">H"), (0xDB, _U32, ">I"))
_BIN = ((0xC4, 0xFF, ">B"), (0xC5, 0xFFFF, ">H"), (0xC6, _U32, ">I"))
_ARRAY = ((0xDC, 0xFFFF, ">H"), (0xDD, _U32, ">I"))
_MAP = ((0xDE, 0xFFFF, ">H"), (0xDF, _U32, ">I"))


def _pack_int(out: bytearray, v: int) -> None:
    if -0x20 <= v < 0x80:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= _U32:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif _U32 < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"msgpack: int {v} out of range")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, _STR, "str")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, 0, _BIN, "bin")
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, _ARRAY, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, _MAP, "map")
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos", "raw")

    def __init__(self, data, raw: bool):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated input (needs {end} bytes, "
                             f"has {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def obj(self) -> Any:
        code = self.num(">B")
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code <= 0x8F:
            return self.map(code & 0x0F)
        if code <= 0x9F:
            return [self.obj() for _ in range(code & 0x0F)]
        if code <= 0xBF:
            return self.text(code & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in fixed:
            return fixed[code]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if code in sized:
            return bytes(self.take(self.num(sized[code])))
        if code == 0xCB:
            return self.num(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in ints:
            return self.num(ints[code])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if code in strs:
            return self.text(self.num(strs[code]))
        if code in (0xDC, 0xDD):
            n = self.num(">H" if code == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if code in (0xDE, 0xDF):
            return self.map(self.num(">H" if code == 0xDE else ">I"))
        raise ValueError(f"msgpack: type byte 0x{code:02x} is not handled "
                         f"(ext, float32 or unused)")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data, *, raw: bool = False) -> Any:
    """``msgpack.unpackb(data, raw=raw)``: str as bytes when ``raw``,
    else as str; bin always as bytes; arrays as lists."""
    reader = _Reader(data, raw)
    obj = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing "
                         f"bytes after the object")
    return obj
