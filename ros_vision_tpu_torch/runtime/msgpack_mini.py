"""Minimal MessagePack codec (the subset NetworkTables 4 uses).

Supports: nil, bool, int (all widths), float32/64, str, bin, array, map.
Implemented in-repo because the image ships no msgpack package and the NT4
wire protocol's binary frames are msgpack-encoded arrays.
"""
from __future__ import annotations

import struct
from typing import Any


def pack(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        if 0 <= o <= 0x7F:
            out.append(o)
        elif -32 <= o < 0:
            out.append(0x100 + o)
        elif 0 <= o <= 0xFF:
            out += b"\xcc" + o.to_bytes(1, "big")
        elif 0 <= o <= 0xFFFF:
            out += b"\xcd" + o.to_bytes(2, "big")
        elif 0 <= o <= 0xFFFFFFFF:
            out += b"\xce" + o.to_bytes(4, "big")
        elif 0 <= o:
            out += b"\xcf" + o.to_bytes(8, "big")
        elif -0x80 <= o:
            out += b"\xd0" + o.to_bytes(1, "big", signed=True)
        elif -0x8000 <= o:
            out += b"\xd1" + o.to_bytes(2, "big", signed=True)
        elif -0x80000000 <= o:
            out += b"\xd2" + o.to_bytes(4, "big", signed=True)
        else:
            out += b"\xd3" + o.to_bytes(8, "big", signed=True)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode()
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += b"\xd9" + n.to_bytes(1, "big")
        else:
            out += b"\xda" + n.to_bytes(2, "big")
        out += b
    elif isinstance(o, (bytes, bytearray)):
        n = len(o)
        if n <= 0xFF:
            out += b"\xc4" + n.to_bytes(1, "big")
        else:
            out += b"\xc5" + n.to_bytes(2, "big")
        out += bytes(o)
    elif isinstance(o, (list, tuple)):
        n = len(o)
        if n <= 15:
            out.append(0x90 | n)
        else:
            out += b"\xdc" + n.to_bytes(2, "big")
        for item in o:
            _pack(item, out)
    elif isinstance(o, dict):
        n = len(o)
        if n <= 15:
            out.append(0x80 | n)
        else:
            out += b"\xde" + n.to_bytes(2, "big")
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(o)}")


def unpack(data: bytes, offset: int = 0):
    """Decode one object; returns (obj, next_offset)."""
    b = data[offset]
    offset += 1
    if b <= 0x7F:
        return b, offset
    if b >= 0xE0:
        return b - 0x100, offset
    if 0x80 <= b <= 0x8F:
        return _unpack_map(data, offset, b & 0xF)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(data, offset, b & 0xF)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return data[offset:offset + n].decode(), offset + n
    if b == 0xC0:
        return None, offset
    if b == 0xC2:
        return False, offset
    if b == 0xC3:
        return True, offset
    if b == 0xC4:
        n = data[offset]
        return bytes(data[offset + 1:offset + 1 + n]), offset + 1 + n
    if b == 0xC5:
        n = int.from_bytes(data[offset:offset + 2], "big")
        return bytes(data[offset + 2:offset + 2 + n]), offset + 2 + n
    if b == 0xCA:
        return struct.unpack(">f", data[offset:offset + 4])[0], offset + 4
    if b == 0xCB:
        return struct.unpack(">d", data[offset:offset + 8])[0], offset + 8
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        n = 1 << (b - 0xCC)
        return int.from_bytes(data[offset:offset + n], "big"), offset + n
    if b in (0xD0, 0xD1, 0xD2, 0xD3):
        n = 1 << (b - 0xD0)
        return int.from_bytes(data[offset:offset + n], "big",
                              signed=True), offset + n
    if b == 0xD9:
        n = data[offset]
        return data[offset + 1:offset + 1 + n].decode(), offset + 1 + n
    if b == 0xDA:
        n = int.from_bytes(data[offset:offset + 2], "big")
        return data[offset + 2:offset + 2 + n].decode(), offset + 2 + n
    if b == 0xDC:
        n = int.from_bytes(data[offset:offset + 2], "big")
        return _unpack_array(data, offset + 2, n)
    if b == 0xDE:
        n = int.from_bytes(data[offset:offset + 2], "big")
        return _unpack_map(data, offset + 2, n)
    raise ValueError(f"unsupported msgpack byte {b:#x}")


def _unpack_array(data, offset, n):
    out = []
    for _ in range(n):
        v, offset = unpack(data, offset)
        out.append(v)
    return out, offset


def _unpack_map(data, offset, n):
    out = {}
    for _ in range(n):
        k, offset = unpack(data, offset)
        v, offset = unpack(data, offset)
        out[k] = v
    return out, offset


def unpack_stream(data: bytes):
    """Decode all concatenated objects in a buffer."""
    offset = 0
    out = []
    while offset < len(data):
        v, offset = unpack(data, offset)
        out.append(v)
    return out
