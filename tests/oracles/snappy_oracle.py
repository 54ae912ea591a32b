"""Pure-Python Snappy format oracle (no python-snappy in image).

Implements the raw Snappy format: varint uncompressed length, then tagged
elements (literal / copy with 1-, 2- or 4-byte offsets).  The encoder
mirrors the JAX compressor's emission strategy so sizes are comparable;
the decoder is strict and accepts any valid stream (copy1/copy2/copy4).
"""

from __future__ import annotations


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, p: int = 0):
    val = 0
    shift = 0
    while True:
        b = buf[p]
        p += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, p
        shift += 7
        if shift > 31:
            raise ValueError("varint too long")


def snappy_decompress_oracle(comp: bytes) -> bytes:
    n, p = read_varint(comp)
    out = bytearray()
    while p < len(comp):
        tag = comp[p]
        p += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                k = ln - 59
                if p + k > len(comp):
                    raise ValueError("literal length past the end of the stream")
                ln = int.from_bytes(comp[p : p + k], "little")
                p += k
            ln += 1
            if p + ln > len(comp):
                raise ValueError("literals past the end of the stream")
            out += comp[p : p + ln]
            p += ln
        else:
            if p + (1, 2, 4)[kind - 1] > len(comp):
                raise ValueError("copy offset past the end of the stream")
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | comp[p]
                p += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(comp[p : p + 2], "little")
                p += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(comp[p : p + 4], "little")
                p += 4
            if off == 0 or off > len(out):
                raise ValueError("bad offset")
            src = len(out) - off
            for k in range(ln):
                out.append(out[src + k])
    if len(out) != n:
        raise ValueError(f"length mismatch: {len(out)} vs {n}")
    return bytes(out)


def _emit_copies(out: bytearray, off: int, ml: int):
    """Split a match into copy elements (64-byte pieces; the remainder rule
    keeps every piece >= 4)."""
    while ml >= 68:
        out.append((63 << 2) | 2)
        out += off.to_bytes(2, "little")
        ml -= 64
    if ml > 64:
        out.append((59 << 2) | 2)
        out += off.to_bytes(2, "little")
        ml -= 60
    # 4 <= ml <= 64
    if ml <= 11 and off < 2048:
        out.append((1) | ((ml - 4) << 2) | ((off >> 8) << 5))
        out.append(off & 0xFF)
    else:
        out.append(((ml - 1) << 2) | 2)
        out += off.to_bytes(2, "little")


def _emit_literal(out: bytearray, data: bytes):
    ln = len(data)
    if ln == 0:
        return
    v = ln - 1
    if v < 60:
        out.append(v << 2)
    else:
        k = (v.bit_length() + 7) // 8
        out.append((59 + k) << 2)
        out += v.to_bytes(k, "little")
    out += data


def snappy_compress_oracle(data: bytes, max_match: int = 1 << 30, max_offset: int = 32768) -> bytes:
    """Greedy encoder with the exact nearest-previous-occurrence matcher and
    unbounded match extension (mirrors the JAX compressor)."""
    n = len(data)
    out = bytearray(_varint(n))
    last_pos: dict[bytes, int] = {}
    anchor = 0
    p = 0
    while p + 4 <= n:
        key = data[p : p + 4]
        j = last_pos.get(key)
        last_pos[key] = p
        if j is not None and p - j <= max_offset:
            ml = 4
            limit = n - p
            while ml < limit and data[j + ml] == data[p + ml] and (ml < max_match or p - j <= 8):
                ml += 1
            _emit_literal(out, data[anchor:p])
            _emit_copies(out, p - j, ml)
            for q in range(p + 1, min(p + ml, n - 3)):
                last_pos[data[q : q + 4]] = q
            p += ml
            anchor = p
            continue
        p += 1
    _emit_literal(out, data[anchor:])
    return bytes(out)
