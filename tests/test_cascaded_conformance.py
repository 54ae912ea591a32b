"""Cascaded stream conformance against the sequential oracle.

Across layer configurations, dtypes, chunk sizes and partition shapes, the
encoder's streams must be byte-identical to
oracles/cascaded_oracle.cascaded_compress_oracle (the reference's fused
kernel executed sequentially, src/CascadedKernels.hiph:766-1058), and the
decoder must turn the oracle's streams back into the input.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.codecs import cascaded
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import DataType, Status, width_of

from oracles.cascaded_oracle import cascaded_compress_oracle

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


def _profile(rng, name, nbytes, width):
    if name == "runs":
        t = {1: np.int8, 2: np.int16, 4: np.int32}[width]
        n = nbytes // width + 8
        return (
            np.repeat(rng.integers(0, 30, n), rng.integers(1, 9, n))
            .astype(t)
            .tobytes()[:nbytes]
        )
    if name == "random":
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    if name == "ramp":
        return (np.arange(nbytes // 4 + 1, dtype=np.int32) * 3 + 7).tobytes()[:nbytes]
    raise ValueError(name)


def _batch(raw, b, c):
    arr = np.zeros((b, c), np.uint8)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        a = np.frombuffer(raw[i * c : (i + 1) * c], np.uint8)
        arr[i, : len(a)] = a
        lens[i] = len(a)
    return arr, lens


def _oracle(opts, part: bytes) -> bytes:
    return cascaded_compress_oracle(
        part, NP_OF[opts.type], opts.chunk_size, opts.num_rles, opts.num_deltas, opts.use_bp
    )


def _assert_oracle_identical(opts, arr, lens):
    comp, sizes = map(np.asarray, cascaded.compress(jnp.asarray(arr), jnp.asarray(lens), opts))
    for i in range(arr.shape[0]):
        exp = _oracle(opts, arr[i, : lens[i]].tobytes()) if lens[i] else b""
        assert comp[i, : sizes[i]].tobytes() == exp, f"partition {i}"
    return comp, sizes


def _assert_decodes_oracle_streams(opts, arr, lens, capacity):
    streams = [_oracle(opts, arr[i, : lens[i]].tobytes()) for i in range(arr.shape[0])]
    pmax = cascaded.partition_output_max(capacity, opts)
    comp = np.zeros((len(streams), pmax), np.uint8)
    for i, st in enumerate(streams):
        comp[i, : len(st)] = np.frombuffer(st, np.uint8)
    sizes = np.array([len(st) for st in streams], np.int32)
    out, olen, stat = map(
        np.asarray, cascaded.decompress(jnp.asarray(comp), jnp.asarray(sizes), opts, capacity)
    )
    w = width_of(opts.type)
    for i in range(arr.shape[0]):
        n = lens[i] // w * w
        assert stat[i] == Status.SUCCESS, f"partition {i}"
        assert olen[i] == n
        assert out[i, :n].tobytes() == arr[i, :n].tobytes(), f"partition {i}"


CONFIGS = [
    (CascadedOpts(), 16384, "runs"),
    (CascadedOpts(), 16384, "random"),  # incompressible fallback
    (CascadedOpts(), 16384, "ramp"),
    (CascadedOpts(num_rles=2, num_deltas=2), 8192, "ramp"),
    (CascadedOpts(num_rles=0, num_deltas=1), 8192, "ramp"),
    (CascadedOpts(num_rles=0, num_deltas=0, use_bp=True), 8192, "runs"),
    (CascadedOpts(use_bp=False), 8192, "runs"),
    (CascadedOpts(type=DataType.SHORT, chunk_size=4096), 8192, "runs"),
    (CascadedOpts(type=DataType.UCHAR, chunk_size=4096), 8192, "runs"),
    (CascadedOpts(type=DataType.UCHAR, num_rles=1, num_deltas=0, chunk_size=512), 4096, "runs"),
    # a partition of one chunk (capacity <= chunk_size): exact and ragged
    (CascadedOpts(), 4096, "runs"),
    (CascadedOpts(), 2048, "runs"),
    (CascadedOpts(type=DataType.USHORT, use_bp=False, num_rles=1, num_deltas=1, chunk_size=2048), 6144, "runs"),
]


def _config_batch(rng, opts, c, profile):
    raw = _profile(rng, profile, 3 * c + 17, width_of(opts.type))
    arr, lens = _batch(raw, 3, c)
    lens[-1] = max(1, lens[-1] - 37)  # ragged tail partition
    return arr, lens


@pytest.mark.parametrize("opts,C,profile", CONFIGS)
def test_compress_matches_oracle(rng, opts, C, profile):
    arr, lens = _config_batch(rng, opts, C, profile)
    _assert_oracle_identical(opts, arr, lens)


@pytest.mark.parametrize("opts,C,profile", CONFIGS)
def test_decompress_oracle_streams(rng, opts, C, profile):
    arr, lens = _config_batch(rng, opts, C, profile)
    _assert_decodes_oracle_streams(opts, arr, lens, C)


def test_edge_partitions(rng):
    """Empty, sub-element-width, and tiny partitions."""
    opts = CascadedOpts()
    arr = np.zeros((4, 8192), np.uint8)
    arr[2] = rng.integers(0, 3, 8192)
    arr[3, :8] = 255
    lens = np.array([0, 3, 8192, 8], np.int32)
    comp, sizes = _assert_oracle_identical(opts, arr, lens)
    out, olen, stat = map(np.asarray, cascaded.decompress(comp, sizes, opts, 8192))
    assert (stat[1:] == Status.SUCCESS).all()
    assert list(olen) == [0, 0, 8192, 8]
    assert (out[2] == arr[2]).all() and (out[3, :8] == 255).all()


def test_capacity_not_chunk_multiple(rng):
    """Capacity that is not a multiple of the chunk size pads with dead
    chunks."""
    opts = CascadedOpts()
    arr, lens = _batch(_profile(rng, "runs", 3 * 10000, 4), 3, 10000)
    _assert_oracle_identical(opts, arr, lens)
    _assert_decodes_oracle_streams(opts, arr, lens, 10000)


def test_corrupt_streams(rng):
    """Garbage, truncated, and size-zero streams report
    ERROR_CANNOT_DECOMPRESS with length 0 and zeroed output; intact rows
    of the same batch still decode."""
    opts = CascadedOpts()
    c = 8192
    arr, lens = _batch(_profile(rng, "runs", 4 * c, 4), 4, c)
    comp, sizes = map(np.asarray, cascaded.compress(jnp.asarray(arr), jnp.asarray(lens), opts))
    comp, sizes = comp.copy(), sizes.copy()
    comp[0] = rng.integers(0, 256, comp.shape[1], dtype=np.uint8)  # garbage
    comp[0, :4] = [2, 1, 1, 4]  # ... behind a plausible header
    sizes[1] = max(9, sizes[1] // 2)  # truncated
    sizes[2] = 0  # empty
    out, olen, stat = map(
        np.asarray, cascaded.decompress(jnp.asarray(comp), jnp.asarray(sizes), opts, c)
    )
    for i in range(3):
        assert stat[i] == Status.ERROR_CANNOT_DECOMPRESS, i
        assert olen[i] == 0 and not out[i].any(), i
    assert stat[3] == Status.SUCCESS and (out[3] == arr[3]).all()


def test_barely_compressible_chunks(rng):
    """Barely-compressible partitions (big final blobs at bit width 32,
    all-count-1 second-RLE blobs): text-like bytes read as int32 must
    round-trip and match the oracle."""
    opts = CascadedOpts()
    c = 65536
    words = rng.integers(97, 123, (3, c), dtype=np.uint8)
    words[0, rng.integers(0, c, c // 8)] = 32  # spaces -> short runs
    lens = np.array([c, c, c - 4], np.int32)
    comp, sizes = _assert_oracle_identical(opts, words, lens)
    out, olen, stat = map(np.asarray, cascaded.decompress(comp, sizes, opts, c))
    assert (stat == Status.SUCCESS).all()
    np.testing.assert_array_equal(olen, lens)
    for i in range(3):
        np.testing.assert_array_equal(out[i, : lens[i]], words[i, : lens[i]])
