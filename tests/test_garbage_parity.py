"""Decoders against the oracles on corrupt input.

Random garbage, random truncations and single bit flips of valid streams:
the LZ4 and Snappy decoders must succeed exactly where the strict oracle
decoders succeed, with identical bytes there, and report
ERROR_CANNOT_DECOMPRESS with length 0 everywhere else (the reference's
OOB_CHECKING obligations, src/LZ4Kernels.hiph:1004-1096).  The Cascaded
decoder must reject garbage and truncations, and may accept a bit flip only
with the oracle's bytes (a flip inside a raw-fallback body stays valid).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.codecs import cascaded, lz4, snappy
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import Status

from oracles.cascaded_oracle import cascaded_decompress_oracle
from oracles.corrupt import FLIPPED, corrupt_batch, oracle_verdict
from oracles.lz4_oracle import lz4_compress_oracle, lz4_decompress_oracle
from oracles.snappy_oracle import snappy_compress_oracle, snappy_decompress_oracle

CAP = 2048
ROWS = 8
SEEDS = range(10)

LZ = {
    "lz4": (lz4, lz4_compress_oracle, lz4_decompress_oracle),
    "snappy": (snappy, snappy_compress_oracle, snappy_decompress_oracle),
}


def _assert_rejected(out, olen, stat, i):
    assert stat[i] == Status.ERROR_CANNOT_DECOMPRESS, i
    assert olen[i] == 0 and not out[i].any(), i


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(LZ))
def test_lz_decoder_matches_oracle_verdict(name, seed):
    mod, encode, decode = LZ[name]
    rng = np.random.default_rng(100 + seed)
    streams = [encode(rng.integers(0, 64, CAP, dtype=np.uint8).tobytes()) for _ in range(ROWS)]
    comp, sizes, _ = corrupt_batch(rng, streams, CAP + 600)
    out, olen, stat = map(
        np.asarray, mod.decompress(jnp.asarray(comp), jnp.asarray(sizes), out_capacity=CAP)
    )
    for i in range(ROWS):
        want = oracle_verdict(decode, comp[i, : sizes[i]].tobytes(), CAP)
        if want is None:
            _assert_rejected(out, olen, stat, i)
        else:
            assert stat[i] == Status.SUCCESS, i
            assert out[i, : olen[i]].tobytes() == want, i


@pytest.mark.parametrize("seed", SEEDS)
def test_cascaded_decoder_on_corrupt_streams(seed):
    rng = np.random.default_rng(200 + seed)
    opts = CascadedOpts()
    cap = 8192
    n = cap // 4
    data = np.stack(
        [
            np.repeat(rng.integers(0, 40, n), rng.integers(1, 6, n))[:n].astype(np.int32).view(np.uint8)
            if i % 2
            else rng.integers(0, 256, cap, dtype=np.uint8)  # raw fallback
            for i in range(ROWS)
        ]
    )
    comp, sizes = map(
        np.asarray,
        cascaded.compress(jnp.asarray(data), jnp.full((ROWS,), cap, jnp.int32), opts),
    )
    streams = [comp[i, : sizes[i]].tobytes() for i in range(ROWS)]
    bad, bad_sizes, kinds = corrupt_batch(rng, streams, comp.shape[1])
    out, olen, stat = map(
        np.asarray, cascaded.decompress(jnp.asarray(bad), jnp.asarray(bad_sizes), opts, cap)
    )
    for i in range(ROWS):
        if kinds[i] == FLIPPED and stat[i] == Status.SUCCESS:
            want = cascaded_decompress_oracle(bad[i, : bad_sizes[i]].tobytes())
            assert out[i, : olen[i]].tobytes() == want, i
        else:
            _assert_rejected(out, olen, stat, i)
