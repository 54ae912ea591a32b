"""Trace each codec direction on the GPU, and sweep LZ4's delimit unroll.

Run from the repository root on a machine with a GPU:

    python scripts/profile_codecs.py [N_CHUNKS]    # default 4096 = 256 MB

For each of Cascaded, LZ4 and Snappy, encode and decode N_CHUNKS 64 KB
chunks of mixed_v1 once to warm up, then trace one steady call with
jax.profiler and print ``TRACE <codec> <direction> {...}``: the device-op
summary of utils/profiling.device_op_summary (top ops and their share,
busy and idle time).  Before that, ``UNROLL <u> {...}`` lines time LZ4
decode with ``_delimit`` unrolled 1, 4, 8 and 16 times.  Traces are
written under scratch/traces/ (gitignored).  PERF.md records the results.
"""

import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

import bench
import chip_smoke as cs
from tpucomp.codecs import cascaded, lz4, snappy
from tpucomp.core.options import CascadedOpts
from tpucomp.utils import profiling


def unroll_sweep(n: int, unrolls=(1, 4, 8, 16)) -> None:
    data = jnp.asarray(cs.corpus_chunks(n, 1))
    lens = jnp.full((n,), cs.CHUNK, jnp.int32)
    comp, sizes = jax.block_until_ready(lz4.compress(data, lens))
    s_max = comp.shape[-1] // 3 + 2
    for u in unrolls:
        delimit = jax.jit(jax.vmap(lambda d, m: lz4._delimit(d, m, cs.CHUNK, s_max, unroll=u)))

        def decode():
            seqs, s, total, ok = delimit(comp, sizes)
            return lz4._jit_materialize(comp, seqs, s, total, ok, cs.CHUNK)

        out = jax.block_until_ready(decode())
        cs.check(bool((out[0] == data).all()) and bool((out[2] == 0).all()), f"unroll {u} round trip")
        dec = profiling.wall(decode, iters=3, warmup=0, bytes_processed=n * cs.CHUNK)
        alone = profiling.wall(lambda: delimit(comp, sizes), iters=3, warmup=0)
        longest = int(np.asarray(delimit(comp, sizes)[1]).max())
        print("UNROLL", u, json.dumps({
            "dec_runs_s": list(dec.runs), "dec_gbps": dec.gbps, "delimit_runs_s": list(alone.runs),
            "max_seqs": longest, "loop_iters": -(-longest // u)}), flush=True)


def trace_directions(n: int, outdir: str) -> None:
    data = jnp.asarray(cs.corpus_chunks(n, 0))
    lens = jnp.full((n,), cs.CHUNK, jnp.int32)
    opts = CascadedOpts()
    for name, enc, dec in (
        ("cascaded", lambda: cascaded.compress(data, lens, opts),
         lambda c: cascaded.decompress(c[0], c[1], opts, cs.CHUNK)),
        ("lz4", lambda: lz4.compress(data, lens),
         lambda c: lz4.decompress(c[0], c[1], out_capacity=cs.CHUNK)),
        ("snappy", lambda: snappy.compress(data, lens),
         lambda c: snappy.decompress(c[0], c[1], out_capacity=cs.CHUNK)),
    ):
        comp = jax.block_until_ready(enc())
        jax.block_until_ready(dec(comp))
        for direction, fn in (("enc", enc), ("dec", lambda: dec(comp))):
            d = os.path.join(outdir, f"{name}_{direction}")
            with profiling.trace(d):
                jax.block_until_ready(fn())
            path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
            summary = profiling.device_op_summary(jax.profiler.ProfileData.from_file(path).planes,
                                                  top=12)
            print("TRACE", name, direction, json.dumps(summary), flush=True)


if __name__ == "__main__":
    cs.require_gpus(1)
    bench.enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    unroll_sweep(n)
    trace_directions(n, os.path.join(cs.ROOT, "scratch", "traces"))
