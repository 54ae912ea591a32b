"""Fused Cascaded codec tests.

Mirrors the reference's deep-verification suite (tests/test_cascaded_batch.cpp)
plus bit-exactness vs the sequential numpy oracle: predefined RLE cases,
alignment invariants, config sweeps across dtypes, incompressible fallback,
undersized outputs and truncated/corrupt inputs yielding statuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.codecs import cascaded as cc
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import DataType, Status

from oracles.cascaded_oracle import cascaded_compress_oracle, cascaded_decompress_oracle

NP_OF = {
    DataType.CHAR: np.int8,
    DataType.UCHAR: np.uint8,
    DataType.SHORT: np.int16,
    DataType.USHORT: np.uint16,
    DataType.INT: np.int32,
    DataType.UINT: np.uint32,
    DataType.LONGLONG: np.int64,
    DataType.ULONGLONG: np.uint64,
}


def _run(parts, opts, capacity):
    data = np.zeros((len(parts), capacity), np.uint8)
    lengths = np.zeros(len(parts), np.int32)
    for i, p in enumerate(parts):
        a = np.frombuffer(p, np.uint8)
        data[i, : a.size] = a
        lengths[i] = a.size
    comp, sizes = cc.compress(jnp.asarray(data), jnp.asarray(lengths), opts)
    return np.asarray(comp), np.asarray(sizes)


def _check_bitexact_and_roundtrip(parts, opts, capacity):
    comp, sizes = _run(parts, opts, capacity)
    dtype = NP_OF[opts.type]
    for i, p in enumerate(parts):
        exp = cascaded_compress_oracle(
            p, dtype, opts.chunk_size, opts.num_rles, opts.num_deltas, opts.use_bp
        )
        assert comp[i, : sizes[i]].tobytes() == exp, f"partition {i} not bit-exact"
        # compressed size bound (reference src/lowlevel/CascadedBatch.hip:318-327)
        w = np.dtype(dtype).itemsize
        n_valid = len(p) // w * w
        assert sizes[i] <= -(-n_valid // 4) * 4 + 8
        # alignment invariants (reference tests/test_cascaded_batch.cpp:320-325)
        assert sizes[i] % 4 == 0 and sizes[i] % w == 0
        # the oracle decodes our stream
        assert cascaded_decompress_oracle(comp[i, : sizes[i]].tobytes()) == p[: n_valid]

    out, olens, stats = cc.decompress(jnp.asarray(comp), jnp.asarray(sizes), opts, capacity)
    out, olens, stats = np.asarray(out), np.asarray(olens), np.asarray(stats)
    for i, p in enumerate(parts):
        w = np.dtype(dtype).itemsize
        n_valid = len(p) // w * w
        assert stats[i] == Status.SUCCESS
        assert out[i, : olens[i]].tobytes() == p[:n_valid]
    return comp, sizes


@pytest.mark.parametrize("dt", list(NP_OF))
def test_all_dtypes_roundtrip(rng, dt):
    dtype = NP_OF[dt]
    w = np.dtype(dtype).itemsize
    opts = CascadedOpts(type=dt, chunk_size=4096 if w < 8 else 8192)
    n = 4096 // w * 3  # 3 chunks
    runs = np.repeat(rng.integers(0, 20, n), rng.integers(1, 9, n))[:n]
    nbytes = n * w
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8).view(dtype)
    parts = [runs.astype(dtype).tobytes(), raw.tobytes()]
    _check_bitexact_and_roundtrip(parts, opts, nbytes)


@pytest.mark.parametrize("nr,nd,bp", [(0, 0, True), (1, 0, True), (1, 1, True), (2, 1, True),
                                       (2, 2, True), (2, 1, False), (0, 1, True), (0, 2, False),
                                       (3, 1, True), (7, 7, True)])
def test_config_sweep(rng, nr, nd, bp):
    opts = CascadedOpts(num_rles=nr, num_deltas=nd, use_bp=bp)
    n = 3000
    vals = np.repeat(rng.integers(0, 1000, n), rng.integers(1, 5, n))[:n].astype(np.int32)
    ramp = (np.arange(n, dtype=np.int32) * 7 - 1000)
    const = np.full(n, -3, np.int32)
    parts = [vals.tobytes(), ramp.tobytes(), const.tobytes()]
    _check_bitexact_and_roundtrip(parts, opts, n * 4)


def test_predefined_rle_cases():
    """Hand-built inputs (reference tests/test_cascaded_batch.cpp:213-330)."""
    opts = CascadedOpts()
    x = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3] * 10, np.int32)
    comp, sizes = _check_bitexact_and_roundtrip([x.tobytes()], opts, x.nbytes)
    # partition header: [nr, nd, bp, dtype] + uncompressed byte count
    assert list(comp[0, :4]) == [2, 1, 1, int(DataType.INT)]
    assert int(np.frombuffer(comp[0, 4:8].tobytes(), np.uint32)[0]) == x.nbytes


def test_repeated_and_tiny_partitions(rng):
    opts = CascadedOpts()
    tiny = np.array([42], np.int32).tobytes()
    two = np.array([7, 7], np.int32).tobytes()
    parts = [tiny, two, tiny, two]
    _check_bitexact_and_roundtrip(parts, opts, 64)


def test_incompressible_fallback(rng):
    """Random data must take the raw-copy path with exact 8+roundUp4(n) size
    (reference tests/test_cascaded_batch.cpp:492)."""
    opts = CascadedOpts()
    n = 4096
    raw = rng.integers(0, 256, n * 4, dtype=np.uint8)
    comp, sizes = _run([raw.tobytes()], opts, n * 4)
    assert sizes[0] == 8 + n * 4
    assert list(comp[0, :3]) == [0, 0, 0]  # zeroed layer counts
    np.testing.assert_array_equal(comp[0, 8 : 8 + n * 4], raw)


def test_non_multiple_length_truncates(rng):
    """Input bytes beyond a whole element are dropped (reference
    src/CascadedKernels.hiph:846: num_elements = bytes / sizeof(T))."""
    opts = CascadedOpts()
    payload = np.arange(100, dtype=np.int32).tobytes() + b"\x01\x02\x03"
    comp, sizes = _run([payload], opts, 512)
    assert int(np.frombuffer(comp[0, 4:8].tobytes(), np.uint32)[0]) == 400


def test_undersized_output_fails(rng):
    opts = CascadedOpts()
    x = np.repeat(np.arange(50, dtype=np.int32), 40)
    comp, sizes = _run([x.tobytes()], opts, x.nbytes)
    out, olens, stats = cc.decompress(
        jnp.asarray(comp[:, : x.nbytes]), jnp.asarray(sizes), opts, 256
    )
    assert np.asarray(stats)[0] == Status.ERROR_CANNOT_DECOMPRESS
    assert np.asarray(olens)[0] == 0


def test_corrupt_streams_report_status(rng):
    """Garbage and truncated inputs must yield CannotDecompress without
    crashing (reference tests/test_batch_c_api.h:700-704,
    test_cascaded_batch.cpp:718-916)."""
    opts = CascadedOpts()
    x = np.repeat(np.arange(100, dtype=np.int32), 20)
    comp, sizes = _run([x.tobytes()], opts, x.nbytes)
    cases = []
    # truncated compressed buffer
    cases.append((comp[0], max(8, sizes[0] // 2)))
    # pure garbage with plausible header
    garbage = rng.integers(0, 256, comp.shape[1], dtype=np.uint8)
    garbage[:8] = comp[0, :8]
    cases.append((garbage, sizes[0]))
    # zero-length
    cases.append((np.zeros_like(comp[0]), 0))
    # chunk size field zeroed (would stall the reference's pointer walk)
    z = comp[0].copy()
    z[8:12] = 0
    cases.append((z, sizes[0]))
    # flipped bytes mid-stream
    f = comp[0].copy()
    f[20:28] ^= 0xFF
    cases.append((f, sizes[0]))

    bufs = np.stack([c[0] for c in cases])
    szs = np.array([c[1] for c in cases], np.int32)
    out, olens, stats = cc.decompress(jnp.asarray(bufs), jnp.asarray(szs), opts, x.nbytes)
    stats = np.asarray(stats)
    olens = np.asarray(olens)
    for i in range(len(cases)):
        # corrupt streams must never claim success with wrong bytes; most
        # report CannotDecompress (a lucky bitflip may still decode)
        if stats[i] == Status.SUCCESS:
            got = np.asarray(out)[i, : olens[i]].tobytes()
            assert got == x.tobytes(), f"case {i} silently mis-decoded"
        else:
            assert stats[i] == Status.ERROR_CANNOT_DECOMPRESS
            assert olens[i] == 0


def test_get_decompress_size(rng):
    opts = CascadedOpts()
    x = np.repeat(np.arange(64, dtype=np.int32), 64)
    comp, sizes = _run([x.tobytes()], opts, x.nbytes)
    got = np.asarray(cc.get_decompress_size(jnp.asarray(comp), jnp.asarray(sizes)))
    assert got[0] == x.nbytes


def test_chunk_size_sweep(rng):
    for cs in [512, 1024, 4096, 16384]:
        opts = CascadedOpts(chunk_size=cs)
        n = 5000
        x = np.repeat(rng.integers(0, 30, n), rng.integers(1, 7, n))[:n].astype(np.int32)
        _check_bitexact_and_roundtrip([x.tobytes()], opts, n * 4)


def test_mixed_fallback_and_compressed_batch(rng):
    """A batch mixing compressible and incompressible partitions decodes in
    one call (the fallback select is per-partition)."""
    opts = CascadedOpts()
    good = np.repeat(np.arange(64, dtype=np.int32), 64).tobytes()
    bad = rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
    _check_bitexact_and_roundtrip([good, bad, good, bad], opts, 16384)


def test_detect_opts_roundtrip(rng):
    """Opts recovered from stream metadata decode without being passed
    (reference decompress reads them from the stream)."""
    opts = CascadedOpts(num_rles=1, num_deltas=1, type=DataType.SHORT)
    x = np.repeat(rng.integers(0, 50, 500).astype(np.int16), 8)[:2000]
    comp, sizes = _run([x.tobytes()], opts, x.nbytes)
    detected = cc.detect_opts(jnp.asarray(comp), jnp.asarray(sizes))
    assert (detected.num_rles, detected.num_deltas, detected.use_bp, detected.type) == (
        1, 1, True, DataType.SHORT,
    )
    out, olens, stats = cc.decompress(jnp.asarray(comp), jnp.asarray(sizes), detected, x.nbytes)
    assert np.asarray(stats)[0] == Status.SUCCESS
    assert np.asarray(out)[0, : np.asarray(olens)[0]].tobytes() == x.tobytes()


def test_longlong_requires_x64_loudly():
    """8-byte element types must fail fast at compress()/decompress() when
    x64 mode is off: without it JAX silently downcasts
    uint64 and the artifact would be corrupt."""
    import jax

    opts = CascadedOpts(type=DataType.LONGLONG)
    data = jnp.zeros((2, 64), jnp.uint8)
    lens = jnp.full((2,), 64, jnp.int32)
    with jax.enable_x64(False):
        with pytest.raises(ValueError, match="64-bit"):
            cc.compress(data, lens, opts)
        with pytest.raises(ValueError, match="64-bit"):
            cc.decompress(data, lens, opts, 64)
