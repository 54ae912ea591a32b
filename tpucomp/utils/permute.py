"""Sort-based data-movement primitives.

Every data-dependent permutation in this library is expressed as a sort
(the library was first tuned on hardware where element gather/scatter cost
far more than a sort; whether that holds on the GPU is measured per
primitive, see PERF.md):

  - compaction  (RLE encode, stream packing)  -> sort by (valid, position)
  - expansion   (RLE decode)                  -> merge-sort + forward-fill
  - placement   (blob/byte assembly)          -> sort by target position

The reference's equivalents are warp ballots + atomics; sorting is the
vector-machine analogue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as _np

BIG = _np.int32(2**30)  # numpy scalar: no backend init at import


def ffill(vals, is_src, axis: int = -1):
    """Forward fill: out[i] = vals[j] for the largest j <= i with is_src[j].

    Positions before the first source keep their own value.  Implemented as
    an associative scan (elementwise log-passes; no gathers).
    """

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    out, _ = jax.lax.associative_scan(comb, (vals, is_src), axis=axis)
    return out


def ffill_multi(vals_list, is_src, axis: int = -1):
    """Forward-fill several same-shaped arrays with one shared source mask
    in a single associative scan (cheaper than per-array fills or gathers).
    """
    vals = jnp.stack(vals_list)
    flags = jnp.broadcast_to(is_src, vals.shape)

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    out, _ = jax.lax.associative_scan(comb, (vals, flags), axis=vals.ndim - 1)
    return tuple(out[k] for k in range(len(vals_list)))


def fill_from_markers(starts, valid, vals_list, out_size: int):
    """Per-position piecewise-constant parameters: for each output position
    t, the values of the last marker with starts[m] <= t.

    Scatters each value at its (distinct, in-bounds) start position and
    forward-fills; positions before the first marker read 0.  The sort-free
    replacement for `gather(param, searchsorted(starts, t))`.
    """
    idx = jnp.where(valid, starts.astype(jnp.int32), out_size)
    flag = jnp.zeros((out_size,), jnp.bool_).at[idx].set(True, mode="drop")
    marks = [
        jnp.zeros((out_size,), v.dtype).at[idx].set(v, mode="drop") for v in vals_list
    ]
    return ffill_multi(marks, flag)


def place(values, targets, valid, out_size: int):
    """Scatter-by-sort: out[targets[m]] = values[m] for valid entries.

    Requires that valid targets cover a prefix [0, total) of the output
    exactly once (alignment gaps must be covered by explicit zero-valued
    entries); positions >= total read 0.  len(values) must be >= out_size.

    One stable (key, value) sort in place of a scatter.
    Passing int64 ``targets`` (requires x64 mode) selects a wide sort key
    whose invalid-sentinel sits above any 63-bit target -- needed once
    outputs can exceed the 2^30 int32 sentinel (>= 1 GiB artifacts).
    """
    if targets.dtype == jnp.int64:
        key = jnp.where(valid, targets, _np.int64(2**62))
    else:
        key = jnp.where(valid, targets.astype(jnp.int32), BIG)
    val = jnp.where(valid, values, 0).astype(values.dtype)
    _, out = jax.lax.sort((key, val), num_keys=1, is_stable=True)
    return out[:out_size]


def expand_runs(vals, starts, num_runs, out_size: int):
    """Run expansion: out[j] = vals[r] for the largest r with starts[r] <= j.

    ``starts`` must be nondecreasing for r < num_runs (an exclusive cumsum
    of run lengths); zero-length runs are skipped naturally because a later
    run with the same start wins the fill.  Positions before starts[0] (only
    possible for corrupt input) read 0.

    Merge-sort + forward-fill + extraction sort; no gathers.
    """
    r_count = vals.shape[-1]
    # markers sort before the queries at the same position: key = 2*pos for
    # markers, 2*pos+1 for queries; the marker flag is the key's parity, so
    # the merge sort carries only two operands.  Invalid markers get an even
    # key past every query (harmless zero-valued sources at the tail).
    mk = jnp.where(jnp.arange(r_count, dtype=jnp.int32) < num_runs,
                   2 * starts.astype(jnp.int32), BIG)
    qk = 2 * jnp.arange(out_size, dtype=jnp.int32) + 1
    keys = jnp.concatenate([mk, qk])
    vv = jnp.concatenate([vals, jnp.zeros((out_size,), vals.dtype)])
    sk, sv = jax.lax.sort((keys, vv), num_keys=1, is_stable=True)
    sm = (sk & 1) == 0
    filled = ffill(sv, sm)
    # extract the queries in position order (each position exactly once)
    qpos = jnp.where(sm, BIG, sk >> 1)
    _, out = jax.lax.sort((qpos, filled), num_keys=1, is_stable=True)
    return out[:out_size]
