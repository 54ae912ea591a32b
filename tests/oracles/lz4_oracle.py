"""Pure-Python LZ4 block-format oracle (no external lz4 package in image).

Implements the public LZ4 block format: sequences of
[token][litlen LSIC][literals][offset u16 LE][matchlen LSIC], last sequence
literals-only, last 5 bytes literals, match starts >= 12 bytes from end.
The encoder is a simple greedy hash-table matcher (reference semantics
family, src/LZ4Kernels.hiph:794-969); the decoder is strict and used to
validate streams produced by the JAX compressor.
"""

from __future__ import annotations


def _lsic(v: int) -> bytes:
    """Length extension bytes for v >= 15 (token nibble already 15)."""
    r = v - 15
    out = bytearray()
    while r >= 255:
        out.append(255)
        r -= 255
    out.append(r)
    return bytes(out)


def lz4_decompress_oracle(comp: bytes, max_out: int | None = None) -> bytes:
    out = bytearray()
    p = 0
    n = len(comp)
    if n == 0:
        return b""
    while p < n:
        token = comp[p]
        p += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = comp[p]
                p += 1
                ll += b
                if b != 255:
                    break
        if p + ll > n:
            raise ValueError("literals past the end of the stream")
        out += comp[p : p + ll]
        p += ll
        if p >= n:
            break  # last sequence: literals only
        if p + 2 > n:
            raise ValueError("offset past the end of the stream")
        off = comp[p] | (comp[p + 1] << 8)
        p += 2
        if off == 0 or off > len(out):
            raise ValueError("bad offset")
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = comp[p]
                p += 1
                ml += b
                if b != 255:
                    break
        src = len(out) - off
        for k in range(ml):
            out.append(out[src + k])
        if max_out is not None and len(out) > max_out:
            raise ValueError("output overflow")
        if p >= n:  # the block format ends with a literals-only sequence
            raise ValueError("stream ends with a match")
    return bytes(out)


def lz4_compress_oracle(data: bytes, max_match: int = 1 << 30) -> bytes:
    """Greedy LZ4 encoder with an exact nearest-previous-occurrence matcher
    and unbounded match extension (like the JAX compressor's sort-based
    matcher + suffix-id LCP walk, so parses agree on most inputs).
    Produces valid, spec-conformant streams."""
    n = len(data)
    out = bytearray()
    if n == 0:
        return b""
    last_pos: dict[bytes, int] = {}
    anchor = 0
    p = 0
    # matches must start at least 12 bytes from the end and leave 5 literal
    # bytes at the end
    while p + 13 <= n and p + 4 <= n:
        key = data[p : p + 4]
        j = last_pos.get(key)
        last_pos[key] = p
        if j is not None and p - j <= 65535:
            ml = 4
            limit = n - 5 - p
            while ml < limit and data[j + ml] == data[p + ml] and (
                ml < max_match or p - j <= 8
            ):
                ml += 1
            if ml >= 4:
                ll = p - anchor
                token = (min(ll, 15) << 4) | min(ml - 4, 15)
                out.append(token)
                if ll >= 15:
                    out += _lsic(ll)
                out += data[anchor:p]
                off = p - j
                out += bytes([off & 0xFF, off >> 8])
                if ml - 4 >= 15:
                    out += _lsic(ml - 4)
                # insert every interior position into the table (the JAX
                # matcher's sort sees all positions, not just visited ones)
                for q in range(p + 1, min(p + ml, n - 3)):
                    last_pos[data[q : q + 4]] = q
                p += ml
                anchor = p
                continue
        p += 1
    # final literals
    ll = n - anchor
    token = min(ll, 15) << 4
    out.append(token)
    if ll >= 15:
        out += _lsic(ll)
    out += data[anchor:]
    return bytes(out)
