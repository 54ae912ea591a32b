"""Chunk-batch data parallelism over a device mesh.

The reference's only parallelism strategy is chunk-level data parallelism
(grid(batch_size), SURVEY.md §2.3); it has no multi-device layer at all.
This module is the distribution surface: a batch of independent chunks
shards over the ``data`` axis of a 1-D Mesh, codec options replicate (they
are static), and compressed outputs + sizes gather back in original chunk
order -- XLA inserts the all-gather, which runs as NCCL over NVLink on the
cards of one GPU host (every card reaches every other at the same rate, so
a 1-D mesh loses nothing).

Because every chunk is independent, the sharded result is bit-identical to
the single-chip result by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpucomp.core.chunking import ChunkBatch

DATA_AXIS = "data"


def make_mesh(devices=None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis_name,))


def pad_batch(batch: ChunkBatch, multiple: int) -> tuple[ChunkBatch, int]:
    """Pad the batch dim to a multiple; padded rows have length 0 (codecs
    emit size-0 outputs for them).  Returns (padded, original_size)."""
    b = batch.batch_size
    target = -(-b // multiple) * multiple
    if target == b:
        return batch, b
    pad = target - b
    data = jnp.concatenate([batch.data, jnp.zeros((pad, batch.capacity), jnp.uint8)])
    lengths = jnp.concatenate([batch.lengths, jnp.zeros((pad,), jnp.int32)])
    return ChunkBatch(data, lengths), b


def shard_batch(batch: ChunkBatch, mesh: Mesh, axis_name: str = DATA_AXIS) -> ChunkBatch:
    """Place the batch row-sharded over the mesh's data axis."""
    row = NamedSharding(mesh, P(axis_name, None))
    vec = NamedSharding(mesh, P(axis_name))
    return ChunkBatch(jax.device_put(batch.data, row), jax.device_put(batch.lengths, vec))


def sharded_compress(codec, batch: ChunkBatch, mesh: Mesh, opts=None,
                     axis_name: str = DATA_AXIS, gather: bool = False) -> ChunkBatch:
    """Compress a batch data-parallel over the mesh.

    With ``gather=True`` outputs are replicated (ordered all-gather over the
    interconnect); otherwise they stay row-sharded for downstream sharded
    consumption.
    """
    opts = opts or codec.default_opts
    padded, b = pad_batch(batch, mesh.devices.size)
    padded = shard_batch(padded, mesh, axis_name)
    out_sharding = (
        NamedSharding(mesh, P(None, None)) if gather else NamedSharding(mesh, P(axis_name, None))
    )
    size_sharding = NamedSharding(mesh, P(None) if gather else P(axis_name))
    fn = jax.jit(
        lambda d, l: codec.compress_fn(d, l, opts),
        out_shardings=(out_sharding, size_sharding),
    )
    comp, sizes = fn(padded.data, padded.lengths)
    return ChunkBatch(comp[:b] if gather else comp, sizes[:b] if gather else sizes)


def sharded_decompress(codec, comp: ChunkBatch, out_capacity: int, mesh: Mesh, opts=None,
                       axis_name: str = DATA_AXIS, gather: bool = False):
    """Decompress a batch data-parallel over the mesh; see sharded_compress."""
    opts = opts or codec.default_opts
    padded, b = pad_batch(comp, mesh.devices.size)
    padded = shard_batch(padded, mesh, axis_name)
    out_sharding = (
        NamedSharding(mesh, P(None, None)) if gather else NamedSharding(mesh, P(axis_name, None))
    )
    size_sharding = NamedSharding(mesh, P(None) if gather else P(axis_name))
    fn = jax.jit(
        lambda d, l: codec.decompress_fn(d, l, opts, out_capacity),
        out_shardings=(out_sharding, size_sharding, size_sharding),
    )
    data, lengths, statuses = fn(padded.data, padded.lengths)
    if gather:
        data, lengths, statuses = data[:b], lengths[:b], statuses[:b]
    return ChunkBatch(data, lengths), statuses
