"""Large-chunk round-trips (reference supports LZ4 chunks 32 KB-16 MB,
include/hipcomp/lz4.h:67-74 with MAX_CHUNK_SIZE = 1<<24 at
src/LZ4Kernels.hiph:174; cascaded partitions are unbounded).

Validates the 256 KB, 1 MB, 4 MB and 16 MB points on CPU
(scripts/large_chunks_hw.py runs the same points on the GPU).  The
multi-MB tests use compressible data so the sequence-sequential delimit
loop stays fast while the full size range is exercised; peak memory for
the 16 MB LZ4 point is ~3.5 GB (bounded by lz77.MATCH_H_CAP capping the
suffix-doubling levels).
"""

import numpy as np
import jax.numpy as jnp

from tpucomp.codecs import cascaded, lz4
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import Status


def _mixed(rng, n):
    rep = np.repeat(rng.integers(0, 40, n // 6 + 1), rng.integers(1, 9, n // 6 + 1))
    a = np.concatenate([rep.astype(np.uint8), rng.integers(0, 256, n, dtype=np.uint8)])
    return a[:n]


def test_cascaded_256k_and_1m_partitions(rng):
    for c in (256 * 1024, 1024 * 1024):
        a = _mixed(rng, c)
        lens = np.array([c, c - 36], np.int32)
        data = np.stack([a, np.roll(a, 7)])
        opts = CascadedOpts()
        comp, sizes = cascaded.compress(jnp.asarray(data), jnp.asarray(lens), opts)
        out, olen, st = cascaded.decompress(comp, sizes, opts, c)
        out, olen, st = map(np.asarray, (out, olen, st))
        assert (st == Status.SUCCESS).all()
        assert (olen == lens).all()
        for i in range(2):
            assert (out[i, : lens[i]] == data[i, : lens[i]]).all()


def test_lz4_256k_chunk(rng):
    c = 256 * 1024
    a = _mixed(rng, c)
    comp, sizes = lz4.compress(jnp.asarray(a[None, :]), jnp.asarray([c], np.int32))
    out, olen, st = lz4.decompress(comp, sizes, out_capacity=c)
    assert np.asarray(st)[0] == Status.SUCCESS
    assert np.asarray(olen)[0] == c
    assert np.asarray(out)[0].tobytes() == a.tobytes()


def _runny(rng, c):
    """Compressible multi-MB payload: long byte runs with a text-ish tail."""
    nv = c // 1200 + 4
    rep = np.repeat(
        rng.integers(0, 40, nv).astype(np.uint8), rng.integers(800, 2200, nv)
    )[:c].copy()
    tail = _mixed(rng, 8192)
    rep[-tail.size :] = tail
    return rep


def _lz4_roundtrip(a, c):
    comp, sizes = lz4.compress(jnp.asarray(a[None, :]), jnp.asarray([c], np.int32))
    out, olen, st = lz4.decompress(comp, sizes, out_capacity=c)
    assert np.asarray(st)[0] == Status.SUCCESS
    assert np.asarray(olen)[0] == c
    assert np.asarray(out)[0].tobytes() == a.tobytes()
    return int(np.asarray(sizes)[0])


def test_lz4_4m_chunk(rng):
    c = 4 << 20
    size = _lz4_roundtrip(_runny(rng, c), c)
    assert size < c // 10  # run-heavy payload really compresses


def test_lz4_16m_chunk(rng):
    # the reference's MAX_CHUNK_SIZE upper bound (lz4.h:67-74); matches
    # longer than the 2*MATCH_H_CAP+3 walk ceiling split into consecutive
    # sequences, so streams stay valid at any run length
    c = 16 << 20
    size = _lz4_roundtrip(_runny(rng, c), c)
    assert size < c // 10


def test_cascaded_16m_partition(rng):
    c = 16 << 20
    n = c // 4
    nv = n // 12 + 4
    col = np.repeat(
        (np.cumsum(rng.integers(-3, 4, nv)) + 500).astype(np.int32),
        rng.integers(6, 20, nv),
    )[:n]
    a = col.view(np.uint8)[:c].copy()
    opts = CascadedOpts()
    comp, sizes = cascaded.compress(jnp.asarray(a[None, :]), jnp.asarray([c], np.int32), opts)
    out, olen, st = cascaded.decompress(comp, sizes, opts, c)
    assert np.asarray(st)[0] == Status.SUCCESS
    assert np.asarray(olen)[0] == c
    assert np.asarray(out)[0].tobytes() == a.tobytes()
    assert int(np.asarray(sizes)[0]) < c // 5
