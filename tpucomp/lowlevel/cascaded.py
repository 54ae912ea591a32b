"""Cascaded low-level batch API.

JAX counterpart of hipcompBatchedCascaded* (reference
src/lowlevel/CascadedBatch.hip:306-462).
"""

from __future__ import annotations

from tpucomp.codecs import cascaded as _cc
from tpucomp.core.options import CascadedOpts
from tpucomp.core.sizing import cascaded_max_compressed_chunk_size
from tpucomp.lowlevel.api import BatchCodec


def _max_size(chunk_bytes: int, opts: CascadedOpts) -> int:
    return cascaded_max_compressed_chunk_size(chunk_bytes)


def _decompress_size(comp, comp_sizes, opts):
    return _cc.get_decompress_size(comp, comp_sizes)


CODEC = BatchCodec(
    name="cascaded",
    default_opts=CascadedOpts(),
    max_compressed_chunk_size=_max_size,
    compress_fn=_cc.compress,
    decompress_fn=_cc.decompress,
    decompress_size_fn=_decompress_size,
)
