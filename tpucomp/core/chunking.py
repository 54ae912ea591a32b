"""Chunk-batch representation and host-side ragged <-> dense staging.

The reference addresses a batch as arrays of per-chunk device pointers with
per-chunk sizes (reference include/hipcomp/lz4.h:106-243).  XLA wants dense,
statically-shaped arrays, so the JAX representation of a batch of B
chunks with capacity C bytes is::

    ChunkBatch(data: uint8[B, C], lengths: int32[B])

Rows are padded with zeros past ``lengths[b]``.  Ragged gather/scatter to and
from user byte streams happens at the edges (host side), the device only ever
sees dense arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ChunkBatch:
    """A batch of independent chunks in dense padded form."""

    data: jax.Array      # uint8[B, C]
    lengths: jax.Array   # int32[B], valid bytes per row

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    def tree_flatten(self):
        return (self.data, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def pack_chunks(chunks: Sequence[bytes | np.ndarray], capacity: int | None = None) -> ChunkBatch:
    """Pack a list of byte strings / uint8 arrays into a dense ChunkBatch.

    The staging memcpy loop runs in the native host library when available
    (tpucomp/native/src/tpucomp_native.cpp, tc_pack_ragged).
    """
    from tpucomp.native import staging

    arrs = [np.frombuffer(c, dtype=np.uint8) if isinstance(c, (bytes, bytearray)) else np.asarray(c, dtype=np.uint8) for c in chunks]
    lengths = np.array([a.size for a in arrs], dtype=np.int32)
    cap = int(capacity if capacity is not None else (lengths.max() if len(arrs) else 0))
    if len(arrs) and lengths.max() > cap:
        raise ValueError(f"chunk of {lengths.max()} bytes exceeds capacity {cap}")
    concat = np.concatenate(arrs) if arrs else np.zeros(0, np.uint8)
    data = staging.pack_ragged(concat, lengths.astype(np.int64), cap)
    return ChunkBatch(jnp.asarray(data), jnp.asarray(lengths))


def unpack_chunks(batch: ChunkBatch) -> List[bytes]:
    """Extract the valid bytes of every row as Python byte strings."""
    from tpucomp.native import staging

    data = np.asarray(jax.device_get(batch.data))
    lengths = np.asarray(jax.device_get(batch.lengths)).astype(np.int64)
    flat = staging.unpack_ragged(data, lengths)
    out: List[bytes] = []
    off = 0
    for n in np.minimum(lengths, data.shape[1]):
        out.append(flat[off : off + n].tobytes())
        off += int(n)
    return out


def split_stream(stream: bytes | np.ndarray, chunk_size: int) -> ChunkBatch:
    """Split one contiguous byte stream into ``chunk_size`` chunks.

    The high-level manager's chunking step (reference
    src/highlevel/BatchManager.hpp:267-270) expressed on the host.
    """
    buf = np.frombuffer(stream, dtype=np.uint8) if isinstance(stream, (bytes, bytearray)) else np.asarray(stream, dtype=np.uint8)
    n = buf.size
    num_chunks = max(1, -(-n // chunk_size))
    data = np.zeros((num_chunks, chunk_size), dtype=np.uint8)
    flat = data.reshape(-1)
    flat[:n] = buf
    lengths = np.full((num_chunks,), chunk_size, dtype=np.int32)
    lengths[-1] = n - (num_chunks - 1) * chunk_size
    return ChunkBatch(jnp.asarray(data), jnp.asarray(lengths))


def join_stream(batch: ChunkBatch) -> bytes:
    """Concatenate the valid bytes of every row back into one stream."""
    return b"".join(unpack_chunks(batch))
