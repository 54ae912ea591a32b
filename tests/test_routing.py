"""Certain-fallback classifier tests.

An encoder may skip the pipeline for partitions the classifier
(codecs/cascaded.py _fallback_certain) proves will take the raw fallback.
That is only safe if the classifier never produces a false positive -- a
partition flagged fallback that the pipeline would actually compress would
change emitted bytes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpucomp.codecs import cascaded as cc
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import DataType, Status

from oracles.cascaded_oracle import cascaded_compress_oracle, cascaded_decompress_oracle

SUPPORTED = [
    (1, 0, True),
    (1, 1, True),
    (2, 0, True),
    (2, 1, True),
    (0, 1, True),
    (0, 2, True),
    (0, 0, False),
]


def _corpora(rng, b, c):
    """Partition batches spanning raw, compressible, and boundary regimes."""
    out = []
    # incompressible
    out.append(rng.integers(0, 256, (b, c), dtype=np.uint8))
    # highly structured int32 runs
    base = np.repeat(rng.integers(0, 100, (b, c // 128)), 32, axis=1).astype(np.int32)
    out.append(base.view(np.uint8).reshape(b, -1)[:, :c])
    # boundary straddlers: noisy ramps with per-row noise amplitude so some
    # rows compress marginally and some fall back by a hair
    n = c // 4
    amp = rng.integers(1, 2**28, (b, 1))
    ramp = (
        np.cumsum(rng.integers(-2, 3, (b, n)), axis=1)
        + (rng.integers(0, amp + 1, (b, n)) - amp // 2)
    ).astype(np.int32)
    out.append(ramp.view(np.uint8))
    # text-like bytes
    words = rng.integers(97, 122, (64, 8), dtype=np.uint8)
    idx = rng.integers(0, 64, (b, c // 8))
    out.append(words[idx].reshape(b, -1)[:, :c])
    return out


@pytest.mark.parametrize("nr,nd,bp", SUPPORTED)
@pytest.mark.parametrize("dt", [DataType.UCHAR, DataType.SHORT, DataType.INT])
def test_routing_flags_never_false_positive(rng, nr, nd, bp, dt):
    if 0 < nr < nd:
        pytest.skip("invalid layer combo")
    opts = CascadedOpts(chunk_size=1024, type=dt, num_rles=nr, num_deltas=nd, use_bp=bp)
    b, c = 24, 4096
    lengths = jnp.full((b,), c, jnp.int32)
    for data in _corpora(rng, b, c):
        dj = jnp.asarray(data)
        flags = np.asarray(cc._fallback_certain(dj, lengths, opts))
        comp, sizes = cc._compress_xla(dj, lengths, opts)
        comp = np.asarray(comp)
        actual_fb = comp[:, :3].sum(-1) == 0
        assert not (flags & ~actual_fb).any(), "classifier produced a false fallback"


def test_routing_flag_coverage_on_random(rng):
    """On incompressible data the classifier should flag (nearly) every
    partition -- this guards against silent coverage regressions."""
    opts = CascadedOpts()
    b, c = 16, 64 * 1024
    data = jnp.asarray(rng.integers(0, 256, (b, c), dtype=np.uint8))
    lengths = jnp.full((b,), c, jnp.int32)
    flags = np.asarray(cc._fallback_certain(data, lengths, opts))
    assert flags.all()


@pytest.mark.parametrize("b", [8, 11])
def test_flagged_rows_are_oracle_fallbacks(rng, b):
    """Every row the classifier flags must be, byte for byte, the oracle's
    raw fallback -- including rows with zero, truncating, and non-multiple
    lengths."""
    opts = CascadedOpts(chunk_size=1024)
    c = 8 * 1024
    for data in _corpora(rng, b, c):
        dj = jnp.asarray(data)
        lengths = np.full((b,), c, np.int32)
        lengths[1] = 0
        lengths[2] = 1000  # truncating, sub-chunk
        lengths[3] = 4097  # non-multiple of width
        lj = jnp.asarray(lengths)
        flags = np.asarray(cc._fallback_certain(dj, lj, opts))
        comp, sizes = map(np.asarray, cc._compress_xla(dj, lj, opts))
        for i in np.flatnonzero(flags):
            exp = cascaded_compress_oracle(data[i, : lengths[i]].tobytes(), np.int32, 1024)
            assert comp[i, : sizes[i]].tobytes() == exp, f"row {i}"
            assert exp[:3] == b"\0\0\0" or lengths[i] == 0


def test_routed_roundtrip_mixed_batch(rng):
    """A batch interleaving fallback and pipeline partitions round-trips
    through the routed path."""
    opts = CascadedOpts()
    b, c = 32, 16 * 1024
    data = np.zeros((b, c), np.uint8)
    for i in range(b):
        if i % 3 == 0:
            col = np.repeat(rng.integers(0, 50, c // 4 // 16 + 1), 16)[: c // 4]
            data[i] = col.astype(np.int32).view(np.uint8)
        else:
            data[i] = rng.integers(0, 256, c, dtype=np.uint8)
    lj = jnp.full((b,), c, jnp.int32)
    comp, sizes = cc.compress(jnp.asarray(data), lj, opts)
    out, olens, stats = cc.decompress(comp, sizes, opts, c)
    assert (np.asarray(stats) == 0).all()
    assert (np.asarray(olens) == c).all()
    assert (np.asarray(out) == data).all()


def test_pipeline_decode_matches_oracle(rng):
    """Pure-pipe partitions (a noisy ramp: every RLE count is 1) and runs
    partitions decode to the input; a corrupted blob byte decodes either to
    an error or to exactly the oracle's bytes; a truncated stream fails."""
    opts = CascadedOpts(chunk_size=1024)
    b, c = 10, 8192
    n = c // 4
    ramp = (
        np.cumsum(rng.integers(-2, 3, (b, n)), axis=1) * 64
        + rng.integers(0, 64, (b, n))
    ).astype(np.int32)
    runs = (
        np.repeat(rng.integers(0, 50, (b, n // 8)), 8, axis=1).astype(np.int32)
    )
    lj = jnp.full((b,), c, jnp.int32)
    for data in (ramp.view(np.uint8), runs.view(np.uint8)):
        comp, sizes = cc._compress_xla(jnp.asarray(data), lj, opts)
        comp = np.asarray(comp).copy()
        sizes = np.asarray(sizes).copy()
        assert (comp[:, :3].sum(-1) != 0).all()  # all pipeline-encoded
        comp[1, 40] ^= 0xA5  # corrupt a blob byte
        sizes[2] = 16        # truncate
        out, olen, st = map(
            np.asarray, cc._decompress_xla(jnp.asarray(comp), jnp.asarray(sizes), opts, c)
        )
        for i in range(b):
            if i == 2:
                assert st[i] == Status.ERROR_CANNOT_DECOMPRESS and olen[i] == 0
            elif i == 1:
                if st[i] == Status.SUCCESS:
                    ref = cascaded_decompress_oracle(comp[i, : sizes[i]].tobytes())
                    assert out[i, : olen[i]].tobytes() == ref
                else:
                    assert olen[i] == 0
            else:
                assert st[i] == Status.SUCCESS
                assert out[i, : olen[i]].tobytes() == data[i].tobytes()
