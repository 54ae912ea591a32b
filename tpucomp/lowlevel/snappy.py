"""Snappy low-level batch API.

JAX counterpart of hipcompBatchedSnappy* (reference
src/lowlevel/SnappyBatch.cpp:83-244); temp space is 0 like the reference.
"""

from __future__ import annotations

from tpucomp.codecs import snappy as _snappy
from tpucomp.core.options import SnappyOpts
from tpucomp.core.sizing import snappy_max_compressed_chunk_size
from tpucomp.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts) -> int:
    return snappy_max_compressed_chunk_size(chunk_bytes)


CODEC = BatchCodec(
    name="snappy",
    default_opts=SnappyOpts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=lambda d, l, o: _snappy.compress(d, l),
    decompress_fn=lambda c, s, o, cap: _snappy.decompress(c, s, out_capacity=cap),
    decompress_size_fn=lambda c, s, o: _snappy.get_decompress_size(c, s),
)
