"""Snappy codec tests.

Mirrors the reference suites (tests/test_snappy_app.cpp,
src/test/SnappyLargeTokens_test.cpp): round trips on adversarial profiles,
foreign streams with copy1/copy4 and large literal elements the compressor
never emits, sizing queries, and corruption robustness.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.codecs import snappy
from tpucomp.core.sizing import snappy_max_compressed_chunk_size
from tpucomp.core.types import Status

from oracles.snappy_oracle import snappy_compress_oracle, snappy_decompress_oracle

C = 4096


def _compress(arrays):
    data = np.zeros((len(arrays), C), np.uint8)
    lengths = np.zeros(len(arrays), np.int32)
    for i, a in enumerate(arrays):
        data[i, : a.size] = a
        lengths[i] = a.size
    comp, sizes = snappy.compress(jnp.asarray(data), jnp.asarray(lengths))
    return np.asarray(comp), np.asarray(sizes)


def _roundtrip(arrays):
    comp, sizes = _compress(arrays)
    out, lens, stats = snappy.decompress(
        jnp.asarray(comp), jnp.asarray(sizes), out_capacity=C
    )
    out, lens, stats = np.asarray(out), np.asarray(lens), np.asarray(stats)
    for i, a in enumerate(arrays):
        assert stats[i] == Status.SUCCESS, f"chunk {i}"
        assert out[i, : lens[i]].tobytes() == a.tobytes(), f"chunk {i}"
        assert snappy_decompress_oracle(comp[i, : sizes[i]].tobytes()) == a.tobytes()
        assert sizes[i] <= snappy_max_compressed_chunk_size(int(a.size))
    return comp, sizes


def _profiles(rng):
    return {
        "text": np.frombuffer((b"a snappy stream with repeated words words words. " * 120)[:C], np.uint8),
        "runs": np.repeat(rng.integers(0, 5, 400), rng.integers(1, 40, 400))[:C].astype(np.uint8),
        "zeros": np.zeros(C, np.uint8),
        "random": rng.integers(0, 256, C, dtype=np.uint8),
        "period5": np.tile(np.arange(5, dtype=np.uint8), C // 5 + 1)[:C],
        "long_matches": np.tile(rng.integers(0, 256, 100, dtype=np.uint8), C // 100 + 1)[:C],
    }


def test_roundtrip_profiles(rng):
    _roundtrip(list(_profiles(rng).values()))


def test_small_sizes(rng):
    _roundtrip([rng.integers(0, 4, n).astype(np.uint8) for n in [1, 2, 4, 5, 11, 60, 61, 64]])


def test_sizes_close_to_oracle(rng):
    profs = _profiles(rng)
    comp, sizes = _compress(list(profs.values()))
    for i, (name, a) in enumerate(profs.items()):
        exp = snappy_compress_oracle(a.tobytes())
        assert sizes[i] <= len(exp) + 8, f"{name}: {sizes[i]} vs oracle {len(exp)}"


def test_decode_foreign_streams(rng):
    """Streams with copy1 / copy4 / multi-byte literal lengths that our
    compressor never emits (reference SnappyLargeTokens strategy)."""
    def varint(n):
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    streams = []
    expected = []
    # large literal with a 2-byte length field (tag 61)
    lit = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    s = varint(1000) + bytes([61 << 2]) + (999).to_bytes(2, "little") + lit
    streams.append(s)
    expected.append(lit)
    # copy1: literal "abcd" + copy1 len 4 off 4 -> abcdabcd
    s = varint(8) + bytes([(4 - 1) << 2]) + b"abcd" + bytes([1 | ((4 - 4) << 2) | (0 << 5), 4])
    streams.append(s)
    expected.append(b"abcdabcd")
    # copy4: same but 4-byte offset
    s = varint(8) + bytes([(4 - 1) << 2]) + b"abcd" + bytes([3 | ((4 - 1) << 2)]) + (4).to_bytes(4, "little")
    streams.append(s)
    expected.append(b"abcdabcd")
    # overlapping copy (RLE style): "x" + copy len 7 off 1
    s = varint(8) + bytes([0 << 2]) + b"x" + bytes([((7 - 1) << 2) | 2]) + (1).to_bytes(2, "little")
    streams.append(s)
    expected.append(b"xxxxxxxx")

    cmax = max(len(s) for s in streams) + 8
    comp = np.zeros((len(streams), cmax), np.uint8)
    sizes = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        sizes[i] = len(s)
    out, lens, stats = snappy.decompress(jnp.asarray(comp), jnp.asarray(sizes), out_capacity=2048)
    for i, e in enumerate(expected):
        assert np.asarray(stats)[i] == Status.SUCCESS, f"stream {i}"
        assert np.asarray(out)[i, : np.asarray(lens)[i]].tobytes() == e, f"stream {i}"


def test_get_decompress_size(rng):
    profs = list(_profiles(rng).values())
    comp, sizes = _compress(profs)
    got = np.asarray(snappy.get_decompress_size(jnp.asarray(comp), jnp.asarray(sizes)))
    for i, a in enumerate(profs):
        assert got[i] == a.size


def test_corrupt_streams(rng):
    a = np.repeat(rng.integers(0, 9, 600), rng.integers(1, 12, 600))[:C].astype(np.uint8)
    comp, sizes = _compress([a])
    cases = [
        (comp[0], max(2, sizes[0] // 2)),  # truncated
        (rng.integers(0, 256, comp.shape[1], dtype=np.uint8), sizes[0]),  # garbage
        (np.zeros(comp.shape[1], np.uint8), 0),  # empty
    ]
    # copy with offset 0
    bad = np.zeros(comp.shape[1], np.uint8)
    bad[0] = 4  # varint n=4
    bad[1] = (3 << 2) | 2
    cases.append((bad, 4))
    bufs = np.stack([c[0] for c in cases])
    szs = np.array([c[1] for c in cases], np.int32)
    out, lens, stats = snappy.decompress(jnp.asarray(bufs), jnp.asarray(szs), out_capacity=C)
    stats, lens = np.asarray(stats), np.asarray(lens)
    for i in range(len(cases)):
        if stats[i] == Status.SUCCESS:
            try:
                dec = snappy_decompress_oracle(bufs[i, : szs[i]].tobytes())
            except Exception:
                raise AssertionError(f"case {i}: claimed success on invalid stream")
            assert dec == np.asarray(out)[i, : lens[i]].tobytes()
        else:
            assert stats[i] == Status.ERROR_CANNOT_DECOMPRESS and lens[i] == 0


def test_empty_chunk():
    comp, sizes = _compress([np.zeros(0, np.uint8)])
    assert sizes[0] == 1 and comp[0, 0] == 0  # varint(0)
    out, lens, stats = snappy.decompress(
        jnp.asarray(comp), jnp.asarray(sizes), out_capacity=C
    )
    assert np.asarray(lens)[0] == 0 and np.asarray(stats)[0] == Status.SUCCESS


def test_variable_chunk_sizes(rng):
    """Mixed-length batch (snappy LLIF supports ragged chunk sizes)."""
    arrays = [
        rng.integers(0, 6, n).astype(np.uint8)
        for n in [100, 4096, 1, 2000, 333, 4095]
    ]
    _roundtrip(arrays)


def test_far_match_boundaries():
    """Matches past position 32768 and at exactly the 32768 distance cap
    must be found, and the stream must decode with the oracle."""
    rng = np.random.default_rng(9)
    base = rng.integers(1, 255, 65536, dtype=np.uint8)
    base[32768 : 32768 + 24] = base[0:24]       # distance exactly 32768
    base[50000:50032] = base[45000:45032]       # past position 32768
    data = jnp.asarray(base[None, :])
    lens = jnp.full((1,), 65536, jnp.int32)
    comp, sizes = snappy.compress(data, lens)
    got = np.asarray(comp)[0, : int(np.asarray(sizes)[0])].tobytes()
    assert snappy_decompress_oracle(got) == base.tobytes()
    assert {32768, 5000} <= set(_copy_offsets(got))


def _copy_offsets(comp: bytes):
    """Offsets of the copy elements of a raw snappy stream."""
    p = 0
    while comp[p] & 0x80:  # varint length
        p += 1
    p += 1
    while p < len(comp):
        tag, kind = comp[p], comp[p] & 3
        if kind == 0:
            ln = tag >> 2
            k = ln - 59 if ln >= 60 else 0
            if k:
                ln = int.from_bytes(comp[p + 1 : p + 1 + k], "little")
            p += 1 + k + ln + 1
        elif kind == 1:
            yield ((tag >> 5) << 8) | comp[p + 1]
            p += 2
        elif kind == 2:
            yield int.from_bytes(comp[p + 1 : p + 3], "little")
            p += 3
        else:
            yield int.from_bytes(comp[p + 1 : p + 5], "little")
            p += 5
