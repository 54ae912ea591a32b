"""Hand-assembled spec-edge golden streams.

Builds LZ4 and Snappy streams byte-by-byte from the format specs --
independent of both the codecs and the test oracles -- hitting the edges
the reference's constants pin (reference src/LZ4Kernels.hiph:162,168-169:
MAX_OFFSET 65535, last-5-literals, last-match-12-bytes;
src/snappy/decompression_decode.hiph large-symbol paths: copy4 tags and
2/3/4-byte literal lengths the GPU compressor never emits, mirroring the
SnappyLargeTokens obligation).

Writes tests/fixtures/{lz4,snappy}_golden.json: {name: {"stream": hex,
"out": hex}}.  The JSON is COMMITTED; tests decode the pinned bytes and
never regenerate them, so decoder conformance is anchored to the spec, not
to our own oracles.  Rerun this script only to add cases; it asserts the
existing pinned entries are reproduced unchanged.
"""

import json
import os

FIXDIR = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")


# --------------------------------------------------------------------------
# LZ4 block-format builder (spec: token, LSIC lengths, LE16 offsets)


def lsic(v: int) -> bytes:
    """Length-field extension bytes for a field value >= 15."""
    out = bytearray()
    v -= 15
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)
    return bytes(out)


def lz4_seq(lit: bytes, mlen: int = 0, off: int = 0, last: bool = False) -> bytes:
    """One LZ4 sequence.  last=True emits the literals-only terminator."""
    ll = len(lit)
    tok_l = min(ll, 15)
    s = bytearray()
    if last:
        s.append(tok_l << 4)
        if ll >= 15:
            s += lsic(ll)
        s += lit
        return bytes(s)
    assert mlen >= 4 and 1 <= off <= 65535
    tok_m = min(mlen - 4, 15)
    s.append((tok_l << 4) | tok_m)
    if ll >= 15:
        s += lsic(ll)
    s += lit
    s += bytes([off & 0xFF, off >> 8])
    if mlen - 4 >= 15:
        s += lsic(mlen - 4)
    return bytes(s)


def apply_lz4(stream: bytes) -> bytes:
    """Tiny spec-literal executor to produce the expected output (kept
    deliberately separate from tests/oracles/lz4_oracle.py)."""
    out = bytearray()
    p = 0
    while p < len(stream):
        tok = stream[p]
        p += 1
        ll = tok >> 4
        if ll == 15:
            while True:
                b = stream[p]
                p += 1
                ll += b
                if b != 255:
                    break
        out += stream[p : p + ll]
        p += ll
        if p >= len(stream):
            break
        off = stream[p] | (stream[p + 1] << 8)
        p += 2
        ml = tok & 15
        if ml == 15:
            while True:
                b = stream[p]
                p += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        for _ in range(ml):
            out.append(out[len(out) - off])
    return bytes(out)


def build_lz4_cases() -> dict:
    cases = {}

    def add(name, *seqs):
        stream = b"".join(seqs)
        cases[name] = {"stream": stream.hex(), "out": apply_lz4(stream).hex()}

    A = bytes(range(65, 91))  # 'A'..'Z'

    # LSIC litlen boundaries: 14 (no ext), 15 (ext 0x00), 269 (ext 0xFE),
    # 270 (ext 0xFF 0x00), 525 (ext 0xFF 0xFF 0x00)
    for n, tag in ((14, "lit14"), (15, "lit15"), (269, "lit269"),
                   (270, "lit270"), (525, "lit525")):
        lit = (A * 30)[:n]
        add(tag, lz4_seq(lit, mlen=8, off=4), lz4_seq(A[:5], last=True))

    # LSIC matchlen boundaries: nibble 14 (mlen 18), 15+0 (19), 15+254 (273),
    # 15+255+0 (274), 15+255+255+0 (529)
    for m, tag in ((18, "match18"), (19, "match19"), (273, "match273"),
                   (274, "match274"), (529, "match529")):
        add(tag, lz4_seq(A[:16], mlen=m, off=8), lz4_seq(A[:5], last=True))

    # offset edges: 1 (RLE splat), 2, 3 (periodic), and the 65535 maximum
    add("off1", lz4_seq(b"x", mlen=40, off=1), lz4_seq(A[:5], last=True))
    add("off2", lz4_seq(b"xy", mlen=33, off=2), lz4_seq(A[:5], last=True))
    add("off3", lz4_seq(b"xyz", mlen=31, off=3), lz4_seq(A[:5], last=True))
    big = (A * 2521)[:65535]  # literal run placing the cursor at 65535
    add("off65535", lz4_seq(big, mlen=64, off=65535), lz4_seq(A[:5], last=True))

    # end rules: a match may end no closer than 5 bytes from the end and
    # must START >= 12 bytes from the end (encoder obligations; the decoder
    # must accept the boundary cases)
    add("end_last5", lz4_seq(A[:12], mlen=7, off=6), lz4_seq(A[:5], last=True))
    # final sequence with zero literals (token 0x00 terminator)
    add("end_empty_final", lz4_seq(A[:10], mlen=6, off=5), lz4_seq(b"", last=True))
    # whole stream is one literal run (no match anywhere)
    add("all_literals", lz4_seq(A * 3, last=True))

    # deep chain: match copying from a match copying from literals
    add(
        "match_chain",
        lz4_seq(A[:16], mlen=16, off=16),
        lz4_seq(b"", mlen=32, off=32),
        lz4_seq(A[:5], last=True),
    )
    return cases


# --------------------------------------------------------------------------
# Snappy builder (spec: varint preamble; tags 00 literal, 01 copy1,
# 10 copy2, 11 copy4)


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def sn_literal(data: bytes, width: int | None = None) -> bytes:
    """Literal with an optionally forced 1/2/3/4-byte length field."""
    n = len(data) - 1
    if width is None:
        width = 0 if n < 60 else (1 if n < 256 else (2 if n < 65536 else 3))
    if width == 0:
        assert n < 60
        return bytes([n << 2]) + data
    tag = (59 + width) << 2
    return bytes([tag]) + n.to_bytes(width, "little") + data


def sn_copy1(length: int, off: int) -> bytes:
    assert 4 <= length <= 11 and off < 2048
    return bytes([(1) | ((length - 4) << 2) | ((off >> 8) << 5), off & 0xFF])


def sn_copy2(length: int, off: int) -> bytes:
    assert 1 <= length <= 64 and off < 65536
    return bytes([(2) | ((length - 1) << 2)]) + off.to_bytes(2, "little")


def sn_copy4(length: int, off: int) -> bytes:
    assert 1 <= length <= 64
    return bytes([(3) | ((length - 1) << 2)]) + off.to_bytes(4, "little")


def apply_snappy(stream: bytes) -> bytes:
    p = 0
    total = 0
    shift = 0
    while True:  # varint preamble
        b = stream[p]
        p += 1
        total |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while p < len(stream):
        tag = stream[p]
        p += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                w = n - 59
                n = int.from_bytes(stream[p : p + w], "little")
                p += w
            n += 1
            out += stream[p : p + n]
            p += n
        else:
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | stream[p]
                p += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                off = int.from_bytes(stream[p : p + 2], "little")
                p += 2
            else:
                length = (tag >> 2) + 1
                off = int.from_bytes(stream[p : p + 4], "little")
                p += 4
            for _ in range(length):
                out.append(out[len(out) - off])
    assert len(out) == total, (len(out), total)
    return bytes(out)


def build_snappy_cases() -> dict:
    cases = {}
    A = bytes(range(97, 123))  # 'a'..'z'

    def add(name, total, *parts):
        stream = varint(total) + b"".join(parts)
        out = apply_snappy(stream)
        cases[name] = {"stream": stream.hex(), "out": out.hex()}

    # forced wide literal-length fields (legal, never emitted by the
    # compressor: its MAX_LITERAL_LENGTH is 256)
    add("lit_w1", 26 + 8, sn_literal(A, width=1), sn_copy1(8, 13))
    lit300 = (A * 12)[:300]
    add("lit_w2", 300 + 10, sn_literal(lit300, width=2), sn_copy2(10, 300))
    add("lit_w3", 70 + 6, sn_literal(A + A + A[:18], width=3), sn_copy2(6, 66))

    # copy1 edges: min/max length, max offset
    add("copy1_edges", 26 + 4 + 11 + 7,
        sn_literal(A), sn_copy1(4, 1), sn_copy1(11, 26), sn_copy1(7, 35))
    # copy2 with the 65535 offset ceiling needs > 64 KB of back output:
    # build 65535 bytes via literals + long copy2 chain, then reach back
    big = (A * 2521)[:65535]
    add("copy2_max_off", 65535 + 64, sn_literal(big, width=2), sn_copy2(64, 65535))
    # copy4: 4-byte offsets, incl. one > 65535 (impossible for copy2)
    add("copy4_small_off", 26 + 20, sn_literal(A), sn_copy4(20, 26))
    add("copy4_big_off", 65535 + 30 + 30,
        sn_literal(big, width=2), sn_copy4(30, 65535), sn_copy4(30, 65550))

    # overlapping copies (period 1 and 3)
    add("overlap", 1 + 40 + 3 + 30,
        sn_literal(b"q"), sn_copy2(40, 1), sn_literal(b"xyz"), sn_copy2(30, 3))
    return cases


def main():
    os.makedirs(FIXDIR, exist_ok=True)
    for name, build in (("lz4", build_lz4_cases), ("snappy", build_snappy_cases)):
        path = os.path.join(FIXDIR, f"{name}_golden.json")
        cases = build()
        if os.path.exists(path):
            old = json.load(open(path))
            for k, v in old.items():
                assert k in cases and cases[k] == v, f"pinned fixture {name}/{k} changed!"
        with open(path, "w") as f:
            json.dump(cases, f, indent=1, sort_keys=True)
        print(f"wrote {path}: {len(cases)} cases")


if __name__ == "__main__":
    main()
