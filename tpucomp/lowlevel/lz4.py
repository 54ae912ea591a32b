"""LZ4 low-level batch API.

JAX counterpart of hipcompBatchedLZ4* (reference
src/lowlevel/LZ4Batch.cpp:71-224).  Temp space is 0 (the reference's
hash-table temp buffer is internal to the matcher here).
"""

from __future__ import annotations

from tpucomp.codecs import lz4 as _lz4
from tpucomp.core.options import LZ4Opts
from tpucomp.core.sizing import lz4_max_compressed_chunk_size
from tpucomp.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts) -> int:
    return lz4_max_compressed_chunk_size(chunk_bytes)


CODEC = BatchCodec(
    name="lz4",
    default_opts=LZ4Opts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=lambda d, l, o: _lz4.compress(d, l, o),
    decompress_fn=lambda c, s, o, cap: _lz4.decompress(c, s, out_capacity=cap),
    decompress_size_fn=lambda c, s, o: _lz4.get_decompress_size(c, s),
)
