"""Bring-up smoke test: every codec's main path on the GPU at full size.

Run from the repository root:

    python chip_smoke.py          # phases A-E on one GPU
    python chip_smoke.py --four   # sharded LZ4 + Cascaded on four GPUs

Only the public entry points are driven -- the low-level batch codecs
``tpucomp.lowlevel.{lz4,snappy,cascaded}.CODEC`` and the LZ4, Snappy and
Cascaded managers with ``create_manager`` -- on the vendored mixed_v1
corpus in 64 KB chunks (the reference's recommended chunk size,
include/hipcomp/lz4.h:67-74).  Results are checked byte for byte against
the sequential oracles in tests/oracles/.

  A  Cascaded LLIF: 256 MB of mixed_v1, then 64 MB of run-heavy int32
     columns; round trip, and 16 sampled streams (fallback and pipeline
     partitions) identical to the oracle's and decoded by it.
  B  Cascaded, all eight element types x seven layer combinations, 8
     chunks each, every stream identical to the oracle's.  The two 8-byte
     types run at the very end, after enabling x64 (core/options.py).
  C  LZ4 and Snappy LLIF: 256 MB each, plus an LZ4 pass with USHORT
     matching; round trip, 16 card streams decoded by the oracle, 16 oracle
     streams decoded on the card.
  D  HLIF: one 256 MB buffer per manager; create_manager detects the
     format and decompresses to the same bytes.
  E  Corrupt input: garbage, truncated and bit-flipped rows inside the
     full batches of A and C; each is rejected with length 0 unless the
     oracle accepts it, and every other row still decodes.

Any failed check exits non-zero before the last line.  A phase whose batch
does not fit in device memory reruns at the largest power-of-two size that
fits and prints that size.  The per-phase readings (compile seconds,
median GB/s of 3 runs, peak device memory) are information only.  The last
line of a passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CHUNK = 64 * 1024
MB = 1 << 20
FULL_MB = 256
SAMPLES = 16
RUNS = 3


def fail(msg: str):
    sys.exit(f"chip_smoke FAIL: {msg}")


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def require_gpus(n: int):
    """The first ``n`` JAX devices, which must be GPUs; exits otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r})")
    if len(devices) < n:
        fail(f"need {n} GPUs, JAX found {len(devices)}")
    return devices[:n]


class CompileLog:
    """Backend compile seconds and persistent-cache hits, as JAX reports
    them through jax.monitoring."""

    def __init__(self):
        import threading

        import jax

        self.compiles: list[tuple[str, float]] = []
        self.cache_hits = 0
        self._lock = threading.Lock()  # compiles may run on several threads
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            with self._lock:
                self.compiles.append((kw.get("fun_name", "?"), duration))

    def _on_event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            with self._lock:
                self.cache_hits += 1

    def mark(self) -> tuple[int, int]:
        return len(self.compiles), self.cache_hits

    def since(self, mark, stages: bool = False) -> dict:
        done = self.compiles[mark[0]:]
        out = {
            "compile_s": sum(d for _, d in done),
            "compiles": len(done),
            "cache_hits": self.cache_hits - mark[1],
        }
        if stages:  # seconds per compiled program, by jitted function name
            out["stages"] = done
        return out


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def corpus_chunks(n_chunks: int, seed: int) -> np.ndarray:
    import bench

    raw = bench.load_corpus(n_chunks * CHUNK, seed=seed)
    return np.frombuffer(raw, np.uint8).reshape(n_chunks, CHUNK)


def runheavy_chunks(n_chunks: int) -> np.ndarray:
    import bench

    raw = bench.runheavy_corpus(n_chunks * CHUNK)
    return np.frombuffer(raw, np.uint8).reshape(n_chunks, CHUNK)


def sample_rows(fallback: np.ndarray, k: int = SAMPLES, seed: int = 0) -> np.ndarray:
    """``k`` row indices drawn with a fixed seed, half from rows flagged in
    ``fallback`` and half from the rest where both kinds exist."""
    rng = np.random.default_rng(seed)
    fb, pipe = np.flatnonzero(fallback), np.flatnonzero(~fallback)
    n_fb = min(len(fb), max(k // 2, k - len(pipe)))
    n_pipe = min(len(pipe), k - n_fb)
    pick = np.concatenate(
        [rng.choice(fb, n_fb, replace=False), rng.choice(pipe, n_pipe, replace=False)]
    )
    return np.sort(pick).astype(np.int64)


def stream(comp, sizes, i: int) -> bytes:
    return comp[i, : sizes[i]].tobytes()


def check_roundtrip(name, data, lengths, out, out_lengths, statuses) -> None:
    from tpucomp.core.types import Status

    bad = np.flatnonzero(statuses != int(Status.SUCCESS))
    check(bad.size == 0, f"{name}: {bad.size} rows not SUCCESS (first {bad[:4]})")
    check(np.array_equal(out_lengths, lengths), f"{name}: decompressed lengths differ")
    rows = np.flatnonzero((out != data).any(axis=1))
    check(rows.size == 0, f"{name}: {rows.size} rows differ after round trip (first {rows[:4]})")


def to_host(*arrays):
    import jax

    return [np.asarray(a) for a in jax.device_get(arrays)]


def timed_codec(log, name, encode, decode, n_bytes):
    """First call of each direction (compile + run) then the median of
    RUNS steady runs; returns (comp, decoded, readings)."""
    import jax

    from tpucomp.utils import profiling

    mark = log.mark()
    t0 = time.perf_counter()
    comp = jax.block_until_ready(encode())
    first_enc = time.perf_counter() - t0
    enc_compile = log.since(mark, stages=True)
    mark = log.mark()
    t0 = time.perf_counter()
    out = jax.block_until_ready(decode(comp))
    first_dec = time.perf_counter() - t0
    dec_compile = log.since(mark, stages=True)
    enc = profiling.wall(encode, iters=RUNS, warmup=0, bytes_processed=n_bytes)
    dec = profiling.wall(decode, comp, iters=RUNS, warmup=0, bytes_processed=n_bytes)
    return comp, out, {
        "phase": name,
        "bytes": n_bytes,
        "enc_first_s": first_enc,
        "enc_compile": enc_compile,
        "dec_first_s": first_dec,
        "dec_compile": dec_compile,
        "enc_gbps": enc.gbps,
        "dec_gbps": dec.gbps,
        "enc_runs_s": list(enc.runs),
        "dec_runs_s": list(dec.runs),
    }


def report(readings: dict) -> None:
    readings["peak_bytes_in_use"] = peak_bytes()
    print("PHASE " + json.dumps(readings), flush=True)


def fit(name, run, n_chunks: int):
    """``run(n_chunks)``, halving the size while the device runs out of
    memory; the size that ran is printed with the phase's readings."""
    import jax

    while True:
        try:
            return run(n_chunks)
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e) or n_chunks <= 1:
                raise
            print(f"PHASE {name}: {n_chunks * CHUNK // MB} MB did not fit in device memory; "
                  f"retrying at {n_chunks * CHUNK // MB // 2} MB", flush=True)
            n_chunks //= 2


# ---------------------------------------------------------------------------
# phases


def phase_cascaded(log, name, data, min_ratio=None):
    """A: Cascaded LLIF round trip + oracle identity of sampled streams."""
    import jax.numpy as jnp

    from tpucomp.core.chunking import ChunkBatch
    from tpucomp.core.options import CascadedOpts
    from tpucomp.lowlevel.cascaded import CODEC
    from oracles.cascaded_oracle import cascaded_compress_oracle, cascaded_decompress_oracle

    opts = CascadedOpts()
    lengths = np.full((data.shape[0],), data.shape[1], np.int32)
    batch = ChunkBatch(jnp.asarray(data), jnp.asarray(lengths))
    comp, (out, statuses), r = timed_codec(
        log, name,
        lambda: CODEC.compress(batch, opts),
        lambda c: CODEC.decompress(c, data.shape[1], opts),
        data.size,
    )
    cd, cs, od, ol, st = to_host(comp.data, comp.lengths, out.data, out.lengths, statuses)
    check_roundtrip(name, data, lengths, od, ol, st)
    fallback = cd[:, :3].sum(axis=1) == 0
    picks = sample_rows(fallback)
    for i in picks:
        exp = cascaded_compress_oracle(data[i].tobytes(), np.int32, opts.chunk_size,
                                       opts.num_rles, opts.num_deltas, opts.use_bp)
        check(stream(cd, cs, i) == exp, f"{name}: row {i} differs from the oracle's stream")
        check(cascaded_decompress_oracle(exp) == data[i].tobytes(),
              f"{name}: oracle does not decode row {i}")
    r["ratio"] = data.size / float(cs.sum())
    r["fallback_rows"] = int(fallback.sum())
    r["sampled"] = {"fallback": int(fallback[picks].sum()), "pipeline": int((~fallback[picks]).sum())}
    if min_ratio is not None:
        check(r["ratio"] > min_ratio, f"{name}: ratio {r['ratio']} <= {min_ratio}")
    report(r)
    return data, cd, cs


LAYERS = [(1, 0, True), (1, 1, True), (2, 0, True), (2, 1, True),
          (0, 1, True), (0, 2, True), (0, 0, False)]


def sweep_chunks(dtype, n_chunks: int, seed: int) -> np.ndarray:
    """Chunks for the dtype x layer sweep: runs of slowly varying values
    (the pipeline compresses), noisy ramps (delta + bitpack bite) and
    mixed_v1 slices (mostly raw fallback)."""
    rng = np.random.default_rng(seed)
    n = CHUNK // np.dtype(dtype).itemsize
    lo = max(int(np.iinfo(dtype).min), -1000)
    rows = []
    corpus = corpus_chunks(n_chunks, seed)
    for i in range(n_chunks):
        if i % 3 == 0:
            vals = np.cumsum(rng.integers(-3, 4, n)) + rng.integers(lo, lo + 2000)
            row = np.repeat(vals, rng.integers(1, 9, n))[:n]
        elif i % 3 == 1:
            row = np.cumsum(rng.integers(-2, 3, n)) * 5 + rng.integers(0, 4, n) + lo + 500
        else:
            rows.append(corpus[i])
            continue
        with np.errstate(over="ignore"):
            rows.append(row.astype(dtype).view(np.uint8))
    return np.stack(rows)


NP_TYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64", "uint64"]


def np_dtype(dt):
    return np.dtype(NP_TYPES[int(dt)])


def phase_sweep(log, name, types, n_chunks: int = 8):
    """B: each (type, layers) pair's streams equal the oracle's and
    round-trip."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from tpucomp.core.chunking import ChunkBatch
    from tpucomp.core.options import CascadedOpts
    from tpucomp.lowlevel.cascaded import CODEC
    from tpucomp.utils import profiling
    from oracles.cascaded_oracle import cascaded_compress_oracle

    jobs = []
    for dt in types:
        dtype = np_dtype(dt)
        data = sweep_chunks(dtype, n_chunks, seed=int(dt))
        lengths = np.full((n_chunks,), CHUNK, np.int32)
        lengths[1] -= 8 * dtype.itemsize  # a partition whose last chunk is short
        batch = ChunkBatch(jnp.asarray(data), jnp.asarray(lengths))
        for nr, nd, bp in LAYERS:
            opts = CascadedOpts(type=dt, num_rles=nr, num_deltas=nd, use_bp=bp)
            jobs.append((f"{name} {dt.name} r{nr}d{nd}{'bp' if bp else ''}", dtype, data,
                         lengths, batch, opts))

    def first_calls(job):
        _, _, _, _, batch, opts = job
        comp = CODEC.compress(batch, opts)
        return jax.block_until_ready((comp, CODEC.decompress(comp, CHUNK, opts)))

    # The first calls of all configs at once: XLA compiles with the GIL
    # released, so the configs' programs compile side by side.
    mark = log.mark()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        firsts = list(ex.map(first_calls, jobs))
    total = {"phase": name, "configs": len(jobs), "first_calls_wall_s": time.perf_counter() - t0,
             **log.since(mark), "bytes": 0, "comp_bytes": 0, "pipeline_rows": 0}
    enc_s = dec_s = 0.0
    for (tag, dtype, data, lengths, batch, opts), (comp, (out, statuses)) in zip(jobs, firsts):
        cd, cs, od, ol, st = to_host(comp.data, comp.lengths, out.data, out.lengths, statuses)
        masked = np.where(np.arange(CHUNK)[None, :] < lengths[:, None], data, 0)
        check_roundtrip(tag, masked, lengths, od, ol, st)
        for i in range(n_chunks):
            exp = cascaded_compress_oracle(data[i, : lengths[i]].tobytes(), dtype, opts.chunk_size,
                                           opts.num_rles, opts.num_deltas, opts.use_bp)
            check(stream(cd, cs, i) == exp, f"{tag}: row {i} differs from the oracle's stream")
        pipeline = int((cd[:, :3].sum(axis=1) != 0).sum())
        check((opts.num_rles, opts.num_deltas, opts.use_bp) == (0, 0, False) or pipeline > 0,
              f"{tag}: every row fell back; the pipeline never compressed")
        enc_s += profiling.wall(CODEC.compress, batch, opts, iters=RUNS, warmup=0).seconds
        dec_s += profiling.wall(CODEC.decompress, comp, CHUNK, opts, iters=RUNS, warmup=0).seconds
        total["bytes"] += data.size
        total["comp_bytes"] += int(cs.sum())
        total["pipeline_rows"] += pipeline
    total["ratio"] = total["bytes"] / total["comp_bytes"]
    total["enc_gbps"] = total["bytes"] / 1e9 / enc_s
    total["dec_gbps"] = total["bytes"] / 1e9 / dec_s
    report(total)


def phase_lz(log, name, codec, data, opts, decode_oracle, encode_oracle):
    """C: LZ4 / Snappy LLIF round trip; sampled card streams decode with the
    oracle; oracle streams substituted into the batch decode on the card."""
    import jax.numpy as jnp

    from tpucomp.core.chunking import ChunkBatch

    lengths = np.full((data.shape[0],), data.shape[1], np.int32)
    batch = ChunkBatch(jnp.asarray(data), jnp.asarray(lengths))
    comp, (out, statuses), r = timed_codec(
        log, name,
        lambda: codec.compress(batch, opts),
        lambda c: codec.decompress(c, data.shape[1], opts),
        data.size,
    )
    cd, cs, od, ol, st = to_host(comp.data, comp.lengths, out.data, out.lengths, statuses)
    check_roundtrip(name, data, lengths, od, ol, st)
    picks = sample_rows(np.zeros(data.shape[0], bool))
    for i in picks:
        check(decode_oracle(stream(cd, cs, i)) == data[i].tobytes(),
              f"{name}: the oracle does not decode row {i} to the input")
    # oracle-made streams in place of the sampled rows, decoded on the card
    foreign, fsizes = cd.copy(), cs.copy()
    for i in sample_rows(np.zeros(data.shape[0], bool), seed=1):
        st_i = encode_oracle(data[i].tobytes())
        check(len(st_i) <= foreign.shape[1], f"{name}: oracle stream {i} exceeds the row")
        foreign[i] = 0
        foreign[i, : len(st_i)] = np.frombuffer(st_i, np.uint8)
        fsizes[i] = len(st_i)
    out2, st2 = codec.decompress(ChunkBatch(jnp.asarray(foreign), jnp.asarray(fsizes)),
                                 data.shape[1], opts)
    od2, ol2, st2 = to_host(out2.data, out2.lengths, st2)
    check_roundtrip(name + " oracle streams", data, lengths, od2, ol2, st2)
    r["ratio"] = data.size / float(cs.sum())
    report(r)
    return data, cd, cs


def phase_hlif(log, name, manager, payload):
    """D: a 256 MB buffer through a manager; create_manager detects the
    format from the artifact and decompresses it to the same bytes."""
    import jax.numpy as jnp

    from tpucomp.core.types import Status
    from tpucomp.highlevel.manager import create_manager

    x = jnp.asarray(payload)
    (artifact, size), (data, statuses), r = timed_codec(
        log, name,
        lambda: manager.compress(x),
        lambda a: create_manager(a[0]).decompress(a[0]),
        payload.size,
    )
    found = create_manager(artifact)
    check(type(found) is type(manager), f"{name}: create_manager found {type(found).__name__}")
    check(found.get_compressed_output_size(artifact) == int(size), f"{name}: artifact size")
    data, statuses = to_host(data, statuses)
    check((statuses == int(Status.SUCCESS)).all(), f"{name}: chunk statuses not SUCCESS")
    check(np.array_equal(data, payload), f"{name}: decompressed buffer differs")
    r["ratio"] = payload.size / int(size)
    report(r)


def phase_corrupt(log, name, codec, opts, data, cd, cs, decode_oracle, rows: int = 64):
    """E: corrupt rows inside a full compressed batch.  LZ4/Snappy rows
    must match the strict oracle's verdict; Cascaded rejects garbage and
    truncations and accepts a bit flip only with the oracle's bytes."""
    import jax
    import jax.numpy as jnp

    from tpucomp.core.chunking import ChunkBatch
    from tpucomp.core.types import Status
    from tpucomp.utils import profiling
    from oracles.cascaded_oracle import cascaded_decompress_oracle
    from oracles.corrupt import FLIPPED, corrupt_batch, oracle_verdict

    rng = np.random.default_rng(7)
    picks = np.sort(rng.choice(data.shape[0], min(rows, data.shape[0]), replace=False))
    bad, bad_sizes, kinds = corrupt_batch(rng, [stream(cd, cs, i) for i in picks], cd.shape[1])
    comp, sizes = cd.copy(), cs.copy()
    comp[picks], sizes[picks] = bad, bad_sizes
    batch = ChunkBatch(jnp.asarray(comp), jnp.asarray(sizes))
    decode = lambda: codec.decompress(batch, data.shape[1], opts)
    mark = log.mark()
    out, statuses = jax.block_until_ready(decode())
    compile_ = log.since(mark)
    od, ol, st = to_host(out.data, out.lengths, statuses)
    keep = np.setdiff1d(np.arange(data.shape[0]), picks)
    check_roundtrip(name + " intact rows", data[keep], np.full(keep.size, data.shape[1], np.int32),
                    od[keep], ol[keep], st[keep])
    accepted, wrong = 0, []
    for j, i in enumerate(picks):
        if decode_oracle is None:  # cascaded
            want = None
            if kinds[j] == FLIPPED and st[i] == int(Status.SUCCESS):
                want = cascaded_decompress_oracle(comp[i, : sizes[i]].tobytes())
        else:
            want = oracle_verdict(decode_oracle, comp[i, : sizes[i]].tobytes(), data.shape[1])
        if want is None:
            ok = st[i] == int(Status.ERROR_CANNOT_DECOMPRESS) and ol[i] == 0 and not od[i].any()
        else:
            accepted += 1
            ok = st[i] == int(Status.SUCCESS) and od[i, : ol[i]].tobytes() == want
        if not ok:
            wrong.append(f"row {i} kind {kinds[j]} size {sizes[i]} of {cs[i]}: status {st[i]} "
                         f"length {ol[i]}, oracle {'rejects' if want is None else len(want)}")
    check(not wrong, f"{name}: {len(wrong)} rows disagree with the oracle: {wrong}")
    dec = profiling.wall(decode, iters=RUNS, warmup=0, bytes_processed=data.size)
    report({"phase": name, "bytes": data.size, "corrupt_rows": int(picks.size),
            "accepted_as_valid": accepted, "dec_compile": compile_,
            "dec_gbps": dec.gbps, "dec_runs_s": list(dec.runs)})


def run_one_card(n_chunks: int = FULL_MB * MB // CHUNK, sweep_chunks_n: int = 8) -> None:
    """Phases A-E."""
    import jax

    from tpucomp import CascadedManager, LZ4Manager, SnappyManager
    from tpucomp.core.options import CascadedOpts, LZ4Opts, SnappyOpts
    from tpucomp.core.types import DataType
    from tpucomp.lowlevel.cascaded import CODEC as CASCADED
    from tpucomp.lowlevel.lz4 import CODEC as LZ4
    from tpucomp.lowlevel.snappy import CODEC as SNAPPY
    from oracles.lz4_oracle import lz4_compress_oracle, lz4_decompress_oracle
    from oracles.snappy_oracle import snappy_compress_oracle, snappy_decompress_oracle

    log = CompileLog()
    casc = fit("A cascaded mixed_v1",
               lambda n: phase_cascaded(log, f"A cascaded mixed_v1 {n * CHUNK / MB:g}MB",
                                        corpus_chunks(n, 0)), n_chunks)
    fit("A cascaded runheavy",
        lambda n: phase_cascaded(log, f"A cascaded runheavy {n * CHUNK / MB:g}MB",
                                 runheavy_chunks(n), min_ratio=2.0), max(1, n_chunks // 4))
    types = [DataType(i) for i in range(len(NP_TYPES))]
    narrow = [t for t in types if np_dtype(t).itemsize < 8]
    phase_sweep(log, "B cascaded types x layers", narrow, sweep_chunks_n)
    lz = fit("C lz4", lambda n: phase_lz(log, f"C lz4 {n * CHUNK / MB:g}MB", LZ4,
                                         corpus_chunks(n, 1), LZ4Opts(),
                                         lz4_decompress_oracle, lz4_compress_oracle), n_chunks)
    fit("C lz4 USHORT", lambda n: phase_lz(log, f"C lz4 USHORT {n * CHUNK / MB:g}MB", LZ4,
                                           corpus_chunks(n, 1), LZ4Opts(data_type=DataType.USHORT),
                                           lz4_decompress_oracle, lz4_compress_oracle), n_chunks)
    sn = fit("C snappy", lambda n: phase_lz(log, f"C snappy {n * CHUNK / MB:g}MB", SNAPPY,
                                            corpus_chunks(n, 1), SnappyOpts(),
                                            snappy_decompress_oracle, snappy_compress_oracle),
             n_chunks)
    for mgr in (LZ4Manager(CHUNK), SnappyManager(CHUNK), CascadedManager(CHUNK, CascadedOpts())):
        fit(f"D {type(mgr).__name__}",
            lambda n: phase_hlif(log, f"D {type(mgr).__name__} {n * CHUNK / MB:g}MB", mgr,
                                 corpus_chunks(n, 3).reshape(-1)), n_chunks)
    for name, codec, opts, res, oracle in (
        ("E cascaded", CASCADED, CascadedOpts(), casc, None),
        ("E lz4", LZ4, LZ4Opts(), lz, lz4_decompress_oracle),
        ("E snappy", SNAPPY, SnappyOpts(), sn, snappy_decompress_oracle),
    ):
        data, cd, cs = res
        phase_corrupt(log, name, codec, opts, data, cd, cs, oracle)
    jax.config.update("jax_enable_x64", True)
    wide = [t for t in types if np_dtype(t).itemsize == 8]
    phase_sweep(log, "B cascaded 8-byte types x layers (x64)", wide, sweep_chunks_n)


def run_four_cards(devices, n_chunks: int = 4 * FULL_MB * MB // CHUNK) -> None:
    """Sharded LZ4 and Cascaded over a 1-D mesh of four cards, with and
    without gather, byte-identical to one card run a quarter at a time."""
    import jax

    from tpucomp.core.chunking import ChunkBatch
    from tpucomp.core.options import CascadedOpts, LZ4Opts
    from tpucomp.core.types import Status
    from tpucomp.lowlevel.cascaded import CODEC as CASCADED
    from tpucomp.lowlevel.lz4 import CODEC as LZ4
    from tpucomp.parallel import sharding as sh

    log = CompileLog()
    mesh = sh.make_mesh(devices)
    data = corpus_chunks(n_chunks, 0)
    lengths = np.full((n_chunks,), CHUNK, np.int32)
    quarter = n_chunks // len(devices)
    for name, codec, opts in (("lz4", LZ4, LZ4Opts()), ("cascaded", CASCADED, CascadedOpts())):
        # one card, a quarter at a time, on device 0
        ref_c, ref_s, ref_o = [], [], []
        for q in range(len(devices)):
            part = slice(q * quarter, (q + 1) * quarter)
            b = ChunkBatch(jax.device_put(data[part], devices[0]),
                           jax.device_put(lengths[part], devices[0]))
            comp = codec.compress(b, opts)
            out, st = codec.decompress(comp, CHUNK, opts)
            c, s, o, ost = to_host(comp.data, comp.lengths, out.data, st)
            check((ost == int(Status.SUCCESS)).all(), f"{name}: single-card statuses")
            ref_c.append(c), ref_s.append(s), ref_o.append(o)
            del comp, out, b
        ref_c, ref_s, ref_o = map(np.concatenate, (ref_c, ref_s, ref_o))
        check(np.array_equal(ref_o, data), f"{name}: single-card round trip")
        batch = ChunkBatch(data, lengths)
        for gather in (False, True):
            tag = f"four {name} gather={gather} {n_chunks * CHUNK / MB:g}MB"
            comp, (out, st), r = timed_codec(
                log, tag,
                lambda: sh.sharded_compress(codec, batch, mesh, opts, gather=gather),
                lambda c: sh.sharded_decompress(codec, c, CHUNK, mesh, opts, gather=gather),
                data.size,
            )
            c, s, o, ost = to_host(comp.data, comp.lengths, out.data, st)
            check(np.array_equal(s, ref_s), f"{tag}: compressed sizes differ from one card")
            width = min(c.shape[1], ref_c.shape[1])
            within = np.arange(width)[None, :] < s[:, None]
            diff = np.flatnonzero(((c[:, :width] != ref_c[:, :width]) & within).any(axis=1))
            check(diff.size == 0, f"{tag}: {diff.size} compressed rows differ from one card")
            check((ost == int(Status.SUCCESS)).all(), f"{tag}: statuses not SUCCESS")
            check(np.array_equal(o, ref_o), f"{tag}: decompressed bytes differ from one card")
            r["ratio"] = data.size / float(s.sum())
            r["identical_to_one_card"] = True
            report(r)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded four-card phase")
    args = p.parse_args(argv)

    devices = require_gpus(4 if args.four else 1)
    import jax

    import bench

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    for line in smi[: len(devices)]:
        print(line, flush=True)
    print(f"jax {jax.__version__}; compile cache {bench.enable_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        run_four_cards(devices)
    else:
        run_one_card()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                                             "count": len(d)}}))


if __name__ == "__main__":
    main()
