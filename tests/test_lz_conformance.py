"""LZ4 and Snappy conformance across chunk sizes, match strides and data.

Every chunk goes through the low-level batch API (the LLIF a user calls):
its stream must decode with the independent oracle decoder back to the
input, stay within the reference's worst-case bound, and round-trip
through the batch decoder.  Each (size, stride) pair compiles once; the
profiles vary only the data.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp import lz4_codec
from tpucomp.core.chunking import ChunkBatch
from tpucomp.core.options import LZ4Opts
from tpucomp.core.types import DataType, Status

from oracles.lz4_oracle import lz4_decompress_oracle

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench

SIZES = [1024, 4096, 16384, 65536]
STRIDES = {1: DataType.CHAR, 2: DataType.USHORT, 4: DataType.INT}
PROFILES = ["corpus", "text", "runs", "random"]


def _chunk(name, c, seed):
    rng = np.random.default_rng(seed)
    if name == "corpus":  # a slice of the vendored mixed_v1 corpus
        return np.frombuffer(bench.load_corpus(c, seed=seed), np.uint8)
    if name == "text":
        words = rng.integers(97, 123, (48, 7), dtype=np.uint8)
        words[:, -1] = 32
        return words[rng.integers(0, 48, c // 7 + 1)].reshape(-1)[:c]
    if name == "runs":
        return np.repeat(rng.integers(0, 6, c), rng.integers(1, 40, c))[:c].astype(np.uint8)
    return rng.integers(0, 256, c, dtype=np.uint8)


def _check(codec, decode, opts, profile, c, seed):
    data = np.stack([_chunk(profile, c, seed), _chunk(profile, c, seed + 1)])
    lens = np.array([c, c - c // 3 - 1], np.int32)
    batch = ChunkBatch(jnp.asarray(data), jnp.asarray(lens))
    comp = codec.compress(batch, opts)
    streams, sizes = np.asarray(comp.data), np.asarray(comp.lengths)
    bound = codec.compress_get_max_output_chunk_size(c, opts)
    for i in range(2):
        assert 0 < sizes[i] <= bound, (i, sizes[i], bound)
        assert decode(streams[i, : sizes[i]].tobytes()) == data[i, : lens[i]].tobytes(), i
    out, stat = codec.decompress(comp, c, opts)
    out_d, out_l, stat = map(np.asarray, (out.data, out.lengths, stat))
    assert (stat == Status.SUCCESS).all()
    np.testing.assert_array_equal(out_l, lens)
    for i in range(2):
        np.testing.assert_array_equal(out_d[i, : lens[i]], data[i, : lens[i]])


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("stride", list(STRIDES))
@pytest.mark.parametrize("c", SIZES)
def test_lz4_chunks_decode_with_oracle(c, stride, profile):
    opts = LZ4Opts(data_type=STRIDES[stride])
    _check(lz4_codec, lz4_decompress_oracle, opts, profile, c, seed=c + stride)
