"""Multi-process distribution test: 2 CPU processes x 4 virtual devices.

Spawns real jax.distributed processes (something the reference never
needed -- it has no distributed layer) and verifies the globally-sharded
compress/decompress round trip with ordered gather.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]

from tpucomp.parallel import multihost
multihost.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()

from tpucomp.lowlevel.cascaded import CODEC
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import Status

cap = 1024
b_local = 8
rng = np.random.default_rng(42)  # same seed everywhere: global data known to all
all_chunks = []
for i in range(nproc * b_local):
    n = int(rng.integers(16, cap + 1)) // 4 * 4
    all_chunks.append(np.repeat(rng.integers(0, 9, n), rng.integers(1, 7, n))[:n].astype(np.uint8))

local = all_chunks[pid * b_local : (pid + 1) * b_local]
data = np.zeros((b_local, cap), np.uint8)
lengths = np.zeros((b_local,), np.int32)
for i, ch in enumerate(local):
    data[i, : ch.size] = ch
    lengths[i] = ch.size

mesh = multihost.global_mesh()
assert mesh.devices.size == nproc * 4

batch = multihost.make_global_batch(data, lengths, mesh)
comp = multihost.compress_distributed(CODEC, batch, mesh)
out, statuses = multihost.decompress_distributed(CODEC, comp, cap, mesh)
odata, olens = multihost.gather_to_host(out, mesh, count=nproc * b_local)
# statuses are process-sharded; check the addressable shards locally
for sh in statuses.addressable_shards:
    st = np.asarray(sh.data)
    assert (st == int(Status.SUCCESS)).all(), st

for i, ch in enumerate(all_chunks):
    got = odata[i, : olens[i]]
    assert np.array_equal(got, ch), f"chunk {i} mismatch on process {pid}"

print(f"proc {pid} OK", flush=True)
"""


# No pytest-timeout in this image: the hang bound is the in-test
# communicate(timeout=240) + kill below, which caps this test's wall time
# without any plugin.
def test_two_process_distributed_roundtrip(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    from tpucomp.parallel.multihost import free_port

    port = str(free_port())  # ephemeral: avoid collisions
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out
