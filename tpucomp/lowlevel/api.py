"""Low-level batch API ("LLIF" equivalent).

The reference exposes a C quintet per format (e.g.
hipcompBatchedCascadedCompressGetTempSize / CompressGetMaxOutputChunkSize /
CompressAsync / DecompressGetTempSize / DecompressAsync /
GetDecompressSizeAsync, reference include/hipcomp/cascaded.h,
include/hipcomp/lz4.h:106-243).  The JAX re-expression is a
``BatchCodec`` object of pure jittable functions over dense chunk batches:

  - caller-owned temp buffers disappear (XLA owns scratch), so the
    *GetTempSize members always report 0 -- like the reference's cascaded
    and snappy paths already do (src/lowlevel/CascadedBatch.hip:306-316,
    SnappyBatch.cpp:83-101)
  - arrays-of-device-pointers become (data uint8[B, C], lengths int32[B])
  - "async on a stream" becomes JAX's asynchronous dispatch; results are
    device arrays the caller may block on or feed onward
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax

from tpucomp.core.chunking import ChunkBatch


@dataclasses.dataclass(frozen=True)
class BatchCodec:
    """Format-generic low-level batch interface."""

    name: str
    default_opts: Any
    # host math: worst-case compressed size for one chunk of n bytes
    max_compressed_chunk_size: Callable[[int, Any], int]
    # (data, lengths, opts) -> (comp, comp_sizes)
    compress_fn: Callable
    # (comp, comp_sizes, opts, out_capacity) -> (data, lengths, statuses)
    decompress_fn: Callable
    # (comp, comp_sizes, opts) -> sizes
    decompress_size_fn: Callable

    def compress_get_temp_size(self, batch_size: int, max_chunk_bytes: int, opts=None) -> int:
        return 0

    def decompress_get_temp_size(self, batch_size: int, max_chunk_bytes: int, opts=None) -> int:
        return 0

    def compress_get_max_output_chunk_size(self, max_chunk_bytes: int, opts=None) -> int:
        return self.max_compressed_chunk_size(max_chunk_bytes, opts or self.default_opts)

    def compress(self, batch: ChunkBatch, opts=None) -> ChunkBatch:
        """Batched compression; returns a ChunkBatch of compressed streams."""
        opts = opts or self.default_opts
        comp, sizes = self.compress_fn(batch.data, batch.lengths, opts)
        return ChunkBatch(comp, sizes)

    def decompress(self, comp: ChunkBatch, out_capacity: int, opts=None):
        """Batched decompression; returns (ChunkBatch, statuses int32[B])."""
        opts = opts or self.default_opts
        data, lengths, statuses = self.decompress_fn(
            comp.data, comp.lengths, opts, out_capacity
        )
        return ChunkBatch(data, lengths), statuses

    def get_decompress_size(self, comp: ChunkBatch, opts=None) -> jax.Array:
        opts = opts or self.default_opts
        return self.decompress_size_fn(comp.data, comp.lengths, opts)
