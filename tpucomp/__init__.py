"""tpucomp: batched lossless compression in JAX.

A from-scratch JAX/XLA framework with the capabilities of hipCOMP-core
(nvCOMP 2.2 lineage): batched LZ4, Snappy and Cascaded
(RLE/Delta/BitPack) codecs over dense chunk batches, a low-level batch
API, high-level managers producing reference-compatible self-describing
artifacts, and data-parallel distribution over device meshes.

Quick start::

    import numpy as np
    from tpucomp import pack_chunks, unpack_chunks, lz4_codec

    batch = pack_chunks([b"hello world " * 100] * 32)
    comp = lz4_codec.compress(batch)
    out, statuses = lz4_codec.decompress(comp, batch.capacity)
    assert unpack_chunks(out)[0] == b"hello world " * 100

High-level (one contiguous buffer, self-describing artifact)::

    from tpucomp import LZ4Manager, create_manager

    artifact, size = LZ4Manager(uncomp_chunk_size=65536).compress(payload)
    data, statuses = create_manager(artifact).decompress(artifact)

Distribution (independent chunks shard data-parallel over a mesh)::

    from tpucomp.parallel import sharding as sh

    mesh = sh.make_mesh()
    comp = sh.sharded_compress(lz4_codec, batch, mesh, gather=True)
"""

from tpucomp.core.chunking import ChunkBatch, join_stream, pack_chunks, split_stream, unpack_chunks
from tpucomp.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp.core.types import DataType, Status
from tpucomp.highlevel.manager import (
    CascadedManager,
    LZ4Manager,
    SnappyManager,
    create_manager,
)
from tpucomp.lowlevel.cascaded import CODEC as cascaded_codec
from tpucomp.lowlevel.lz4 import CODEC as lz4_codec
from tpucomp.lowlevel.snappy import CODEC as snappy_codec

__version__ = "2.2.0"

__all__ = [
    "ChunkBatch",
    "pack_chunks",
    "unpack_chunks",
    "split_stream",
    "join_stream",
    "DataType",
    "Status",
    "LZ4Opts",
    "SnappyOpts",
    "CascadedOpts",
    "lz4_codec",
    "snappy_codec",
    "cascaded_codec",
    "LZ4Manager",
    "SnappyManager",
    "CascadedManager",
    "create_manager",
]
