"""Distribution layer tests on a virtual 8-device CPU mesh.

The reference has no multi-device layer (SURVEY.md §2.3); this is the new
distribution surface: chunk batches shard data-parallel over a Mesh, options
replicate, outputs gather in original chunk order.  Because chunks are
independent, sharded results must be bit-identical to single-device runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.core.chunking import ChunkBatch, pack_chunks, unpack_chunks
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import Status
from tpucomp.lowlevel.cascaded import CODEC as CASCADED
from tpucomp.lowlevel.lz4 import CODEC as LZ4
from tpucomp.parallel import sharding as sh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return sh.make_mesh(jax.devices()[:8])


def _batch(rng, b, cap):
    chunks = []
    for _ in range(b):
        n = int(rng.integers(16, cap + 1)) // 4 * 4
        chunks.append(np.repeat(rng.integers(0, 9, n), rng.integers(1, 7, n))[:n].astype(np.uint8).tobytes())
    return pack_chunks(chunks, capacity=cap), chunks


@pytest.mark.parametrize("codec", [CASCADED, LZ4], ids=["cascaded", "lz4"])
def test_sharded_matches_single_device(rng, mesh, codec):
    cap = 2048
    batch, chunks = _batch(rng, 24, cap)  # divisible by 8

    single = codec.compress(batch)
    shard = sh.sharded_compress(codec, batch, mesh, gather=True)
    np.testing.assert_array_equal(np.asarray(shard.lengths), np.asarray(single.lengths))
    np.testing.assert_array_equal(np.asarray(shard.data), np.asarray(single.data))

    out, statuses = sh.sharded_decompress(codec, shard, cap, mesh, gather=True)
    assert (np.asarray(statuses) == Status.SUCCESS).all()
    assert unpack_chunks(out) == chunks


def test_sharded_with_padding(rng, mesh):
    """Batch not divisible by the mesh: padded rows produce size-0 outputs
    and the gather slices back to the original batch."""
    cap = 1024
    batch, chunks = _batch(rng, 13, cap)
    shard = sh.sharded_compress(CASCADED, batch, mesh, gather=True)
    assert shard.batch_size == 13
    single = CASCADED.compress(batch)
    np.testing.assert_array_equal(np.asarray(shard.lengths), np.asarray(single.lengths))
    out, statuses = sh.sharded_decompress(CASCADED, shard, cap, mesh, gather=True)
    assert (np.asarray(statuses) == Status.SUCCESS).all()
    assert unpack_chunks(out) == chunks


def test_outputs_stay_sharded_without_gather(rng, mesh):
    cap = 1024
    batch, _ = _batch(rng, 16, cap)
    shard = sh.sharded_compress(CASCADED, batch, mesh, gather=False)
    sharding = shard.data.sharding
    # row-sharded over the data axis, 2 rows per device
    assert sharding.shard_shape(shard.data.shape)[0] == 2


def test_device_placement_spans_mesh(rng, mesh):
    cap = 1024
    batch, _ = _batch(rng, 16, cap)
    placed = sh.shard_batch(batch, mesh)
    assert len(placed.data.devices()) == 8
