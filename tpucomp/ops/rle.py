"""Run-length-encode stage.

JAX re-expression of RunLengthEncodeGPU (reference
src/RunLengthEncodeGPU.hip:167-560) and the fused cascaded RLE blocks
(reference src/CascadedKernels.hiph:129-305).  Semantics match the reference:

  - values are the element of each run, counts are the run lengths
  - the fused cascaded path uses uint16 counts (chunks hold < 65536
    elements); the standalone stage supports 16/32/64-bit counts like the
    reference's ``compressDownstream`` count-type dispatch
    (reference src/RunLengthEncodeGPU.hip:479-560)
  - encode: run *ends* are marked, end positions + 1 adjacent-differenced
    into counts (reference src/CascadedKernels.hiph:233-241)
  - the run count is returned as a device scalar -- the analogue of the
    reference's device-resident ``numOutDevice`` (no host sync needed)

All data-dependent movement is sort-based (see tpucomp.utils.permute):
encode is a stream compaction, decode a merge + forward-fill -- the
vector-machine counterparts of the reference's BlockScan + per-thread run
writes.  Functions operate on a single fixed-size buffer ``x[E]`` with a
traced valid count ``n``; batch via ``jax.vmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpucomp.utils import permute

RUN_DTYPE = jnp.uint16

# count dtypes supported by the standalone stage, mirroring the reference's
# 16/32/64-bit compressDownstream variants (RunLengthEncodeGPU.hip:479-560;
# test src/test/RunLengthEncodeGPU_test.cpp:259-539).  uint64 requires
# jax_enable_x64 (see tpucomp/core/options.py's x64 gate).
COUNT_DTYPES = ("uint16", "uint32", "uint64")


def rle_encode(x, n, count_dtype=RUN_DTYPE):
    """Encode the valid prefix of ``x`` into runs.

    Returns (vals[E] like x, counts[E] ``count_dtype``, num_runs int32).
    Entries past ``num_runs`` are zero.  ``count_dtype`` must be one of
    COUNT_DTYPES; with uint16 counts, runs longer than 65535 elements wrap
    (callers bound input sizes, as the fused cascaded format does).
    """
    if jnp.dtype(count_dtype).name not in COUNT_DTYPES:
        raise ValueError(f"count_dtype must be one of {COUNT_DTYPES}")
    e = x.shape[-1]
    i = jnp.arange(e, dtype=jnp.int32)
    nxt = jnp.roll(x, -1)
    is_end = jnp.where(i == n - 1, True, (i < n - 1) & (x != nxt))
    num_runs = jnp.sum(is_end.astype(jnp.int32))

    # compact (end position, value) pairs to the front in one kv-sort
    key = jnp.where(is_end, i, e + i)
    sk, vals = jax.lax.sort((key, x), num_keys=1, is_stable=True)
    ends = jnp.where(sk < e, sk, 0)

    idx1 = ends + 1
    counts = (idx1 - jnp.roll(idx1, 1).at[0].set(0)).astype(count_dtype)

    run_valid = i < num_runs
    vals = jnp.where(run_valid, vals, 0).astype(x.dtype)
    counts = jnp.where(run_valid, counts, 0).astype(count_dtype)
    return vals, counts, num_runs


def rle_decode(vals, counts, num_runs, out_elements: int | None = None):
    """Expand runs back into elements.

    Accepts any COUNT_DTYPES counts.  Returns (x[out_elements], total int32).
    Mirrors block_rle_decompress (reference src/CascadedKernels.hiph:260-305).
    """
    e = vals.shape[-1] if out_elements is None else out_elements
    i = jnp.arange(vals.shape[-1], dtype=jnp.int32)
    c = jnp.where(i < num_runs, counts.astype(jnp.int32), 0)
    inc = jnp.cumsum(c)
    total = inc[-1]
    starts = inc - c
    x = permute.expand_runs(vals, starts, num_runs, e)
    j = jnp.arange(e, dtype=jnp.int32)
    x = jnp.where(j < total, x, 0).astype(vals.dtype)
    return x, total
