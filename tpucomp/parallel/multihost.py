"""Multi-host distribution: jax.distributed runtime + sharded codec runs.

The reference is strictly single-process/single-GPU (SURVEY.md §2.3); this
is the new surface required by the project north star: a chunk batch
sharded data-parallel across the devices of several hosts, codec options
replicated, compressed outputs + sizes gathered back in original chunk
order over the cluster's interconnect.

Usage (one process per host)::

    from tpucomp.parallel import multihost
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=N, process_id=i)
    mesh = multihost.global_mesh()
    comp = multihost.compress_distributed(codec, my_host_chunks, mesh)

Because every chunk is independent, results are bit-identical to a
single-chip run regardless of process count.  The same code paths run
under multi-process CPU simulation (tests/test_multihost.py spawns
processes with the gloo/tcp backend).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpucomp.core.chunking import ChunkBatch
from tpucomp.parallel.sharding import DATA_AXIS, pad_batch


def free_port() -> int:
    """An ephemeral localhost port for the jax.distributed coordinator.

    Hardcoded ports collide with lingering workers from a previous run;
    binding port 0 on a throwaway socket asks the OS for a currently-free
    one.  Probes on all interfaces ("") so the port is free on whatever
    interface the coordinator binds, not just loopback.  (Inherent TOCTOU: the port can be reclaimed between here
    and the coordinator's bind -- callers that retry should call this
    again for each attempt.)
    """
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op if already up)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()).reshape(-1), (axis_name,))


def make_global_batch(local_data: np.ndarray, local_lengths: np.ndarray, mesh: Mesh,
                      axis_name: str = DATA_AXIS) -> ChunkBatch:
    """Assemble a process-sharded global batch from per-host chunk rows.

    Every process contributes its local rows; the global batch dimension is
    the concatenation in process order (original chunk order preserved).
    """
    row = NamedSharding(mesh, P(axis_name, None))
    vec = NamedSharding(mesh, P(axis_name))
    nproc = jax.process_count()
    b_local = local_data.shape[0]
    global_shape_d = (b_local * nproc, local_data.shape[1])
    global_shape_l = (b_local * nproc,)
    data = jax.make_array_from_process_local_data(row, np.ascontiguousarray(local_data), global_shape_d)
    lengths = jax.make_array_from_process_local_data(vec, np.ascontiguousarray(local_lengths), global_shape_l)
    return ChunkBatch(data, lengths)


def compress_distributed(codec, batch: ChunkBatch, mesh: Mesh, opts=None,
                         axis_name: str = DATA_AXIS) -> ChunkBatch:
    """Sharded batched compression over the global mesh.

    Outputs stay row-sharded; use ``gather_to_host`` for an ordered,
    fully-replicated gather.
    """
    opts = opts or codec.default_opts
    padded, b = pad_batch(batch, mesh.devices.size)
    out_sh = NamedSharding(mesh, P(axis_name, None))
    size_sh = NamedSharding(mesh, P(axis_name))
    fn = jax.jit(lambda d, l: codec.compress_fn(d, l, opts), out_shardings=(out_sh, size_sh))
    comp, sizes = fn(padded.data, padded.lengths)
    return ChunkBatch(comp, sizes)


def decompress_distributed(codec, comp: ChunkBatch, out_capacity: int, mesh: Mesh,
                           opts=None, axis_name: str = DATA_AXIS):
    opts = opts or codec.default_opts
    padded, b = pad_batch(comp, mesh.devices.size)
    out_sh = NamedSharding(mesh, P(axis_name, None))
    size_sh = NamedSharding(mesh, P(axis_name))
    fn = jax.jit(
        lambda d, l: codec.decompress_fn(d, l, opts, out_capacity),
        out_shardings=(out_sh, size_sh, size_sh),
    )
    data, lengths, statuses = fn(padded.data, padded.lengths)
    return ChunkBatch(data, lengths), statuses


def gather_to_host(batch: ChunkBatch, mesh: Mesh, count: int | None = None):
    """Ordered all-gather of a sharded batch; returns host numpy arrays.

    The gather rides the interconnect (XLA inserts it for the replicated
    out-sharding); chunk order is the original batch order.
    """
    rep_row = NamedSharding(mesh, P(None, None))
    rep_vec = NamedSharding(mesh, P(None))
    fn = jax.jit(lambda d, l: (d, l), out_shardings=(rep_row, rep_vec))
    data, lengths = fn(batch.data, batch.lengths)
    data = np.asarray(jax.device_get(data))
    lengths = np.asarray(jax.device_get(lengths))
    if count is not None:
        data, lengths = data[:count], lengths[:count]
    return data, lengths
