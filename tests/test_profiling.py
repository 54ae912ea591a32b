"""utils/profiling: steady-state walls and the trace-to-device-op
reduction (checked on hand-built planes shaped like a GPU trace)."""

from types import SimpleNamespace as NS

import jax.numpy as jnp
import pytest

from tpucomp.utils import profiling


def test_wall_reports_median_of_runs():
    r = profiling.wall(lambda x: x + 1, jnp.ones(4), iters=5, warmup=1, bytes_processed=10**9)
    assert len(r.runs) == 5
    assert r.seconds == sorted(r.runs)[2]
    assert r.gbps == pytest.approx(1.0 / r.seconds)


def _ev(name, start, dur):
    return NS(name=name, start_ns=start, duration_ns=dur)


def test_device_op_summary_prefers_xla_ops_line():
    gpu = NS(name="/device:GPU:0", lines=[
        NS(name="XLA Ops", events=[_ev("sort.1", 0, 60), _ev("fusion.2", 50, 20), _ev("sort.1", 100, 20)]),
        NS(name="Stream #14(Compute)", events=[_ev("kernel_a", 0, 999)]),
    ])
    host = NS(name="/host:CPU", lines=[NS(name="python", events=[_ev("x", 0, 10**6)])])
    s = profiling.device_op_summary([host, gpu], top=1)
    assert s["window_ns"] == 120
    assert s["busy_ns"] == 90  # [0, 70) and [100, 120)
    assert s["idle_share"] == pytest.approx(0.25)
    assert s["op_ns"] == 100
    assert s["top"] == [{"op": "sort.1", "ns": 80, "share": 0.8}]


def test_device_op_summary_falls_back_to_streams():
    gpu = NS(name="/device:GPU:0", lines=[
        NS(name="Stream #7", events=[_ev("k1", 10, 10), _ev("k2", 30, 30)]),
    ])
    s = profiling.device_op_summary([gpu])
    assert s["busy_ns"] == 40 and s["window_ns"] == 50
    assert [t["op"] for t in s["top"]] == ["k2", "k1"]


def test_device_op_summary_needs_a_gpu_plane():
    with pytest.raises(ValueError, match="no GPU device ops"):
        profiling.device_op_summary([NS(name="/host:CPU", lines=[])])
