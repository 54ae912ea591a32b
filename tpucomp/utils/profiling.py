"""Timing and trace instrumentation.

The reference ships no in-tree profiling (SURVEY.md §5); throughput is the
project north star, so walls and traces are built in here.  Every timed run
ends in ``jax.block_until_ready``: dispatch is asynchronous, and a timing
without it measures the enqueue.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import statistics
import time
from typing import Callable

import jax


@dataclasses.dataclass
class WallResult:
    seconds: float  # median of ``runs``
    bytes_processed: int = 0
    runs: tuple[float, ...] = ()

    @property
    def gbps(self) -> float:
        return self.bytes_processed / 1e9 / self.seconds if self.seconds else 0.0


def wall(fn: Callable, *args, iters: int = 3, warmup: int = 1, bytes_processed: int = 0,
         **kwargs) -> WallResult:
    """Steady-state wall time of ``fn(*args)``: the median of ``iters`` runs,
    each ended by ``block_until_ready``, after ``warmup`` untimed runs."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        runs.append(time.perf_counter() - t0)
    return WallResult(statistics.median(runs), bytes_processed, tuple(runs))


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_op_summary(planes, top: int = 10) -> dict:
    """Reduce a profiler trace to device-op time: the ``top`` ops by summed
    duration with their share of all op time, the busy time (union of op
    intervals) and the window from the first op start to the last op end.

    ``planes`` is ``jax.profiler.ProfileData.from_file(path).planes``.  Only
    planes named ``/device:GPU:*`` count; their "XLA Ops" line is used when
    present (one event per HLO op), else every stream line (one event per
    kernel).
    """
    per_op: dict[str, int] = collections.Counter()
    intervals = []
    for plane in planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
            for ev in line.events:
                per_op[ev.name] += int(ev.duration_ns)
                intervals.append((int(ev.start_ns), int(ev.start_ns + ev.duration_ns)))
    if not intervals:
        raise ValueError("trace holds no GPU device ops")
    intervals.sort()
    busy, cur_s, cur_e = 0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in intervals) - intervals[0][0]
    total = sum(per_op.values())
    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "op_ns": total,
        "top": [
            {"op": name, "ns": ns, "share": ns / total}
            for name, ns in per_op.most_common(top)
        ],
    }
