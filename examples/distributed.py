"""Data-parallel compression over a device mesh, single- and multi-host.

Chunks are independent (the reference's per-warp chunk model,
src/lowlevel/LZ4CompressionKernels.hip:182, becomes per-device batch rows
here), so the batch shards over a 1-D mesh and every device compresses its
rows with the same jitted program; results gather back in original chunk
order.

Keep outputs SHARDED (gather=False) between pipeline stages, or gather
once at the very end: gather=True replicates the full output to every
device, N times the traffic on an N-device mesh.

Run on the GPUs of one host, or on 8 virtual CPU devices:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed.py

Multi-host: run one process per host with tpucomp.parallel.multihost
(initialize -> global_mesh -> make_global_batch -> compress_distributed),
as in tests/test_multihost.py.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tpucomp import CascadedOpts, cascaded_codec, lz4_codec, pack_chunks
from tpucomp.core.types import Status
from tpucomp.parallel import sharding as sh


def main():
    rng = np.random.default_rng(0)
    cap = 4096
    # cascaded is an element-typed scheme (default int32): keep chunk byte
    # lengths element-aligned, as the reference requires (in_bytes % sizeof(T))
    n = rng.integers(64, cap, 64) // 4 * 4
    chunks = [
        np.repeat(rng.integers(0, 9, k), rng.integers(1, 9, k))[:k].astype(np.uint8).tobytes()
        for k in n
    ]
    batch = pack_chunks(chunks, capacity=cap)

    mesh = sh.make_mesh()  # all local devices on a 1-D data axis
    print(f"mesh: {mesh.devices.size} devices")

    for name, codec, opts in (
        ("lz4", lz4_codec, None),
        ("cascaded", cascaded_codec, CascadedOpts(chunk_size=cap)),
    ):
        comp = sh.sharded_compress(codec, batch, mesh, opts=opts, gather=False)
        # comp stays sharded: each device holds its rows' compressed chunks.
        out, statuses = sh.sharded_decompress(
            codec, comp, cap, mesh, opts=opts, gather=True  # gather once, at the end
        )
        st = np.asarray(statuses)[: len(chunks)]
        assert (st == int(Status.SUCCESS)).all(), st
        data = np.asarray(out.data)
        for i, ch in enumerate(chunks):
            assert data[i, : len(ch)].tobytes() == ch, f"chunk {i}"
        # pad_batch may have added rows for even sharding: count only the
        # first len(chunks) rows so the ratio reflects the real payload
        comp_bytes = int(np.asarray(comp.lengths)[: len(chunks)].sum())
        ratio = batch.lengths.sum() / max(1, comp_bytes)
        print(f"{name}: {len(chunks)} chunks round-tripped sharded, ratio {ratio:.2f}")


if __name__ == "__main__":
    main()
