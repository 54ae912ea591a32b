"""Delta stage: adjacent differences and their prefix-sum inverse.

JAX re-expression of DeltaGPU (reference src/DeltaGPU.hip:79-142) and
the fused cascaded delta blocks (reference src/CascadedKernels.hiph:318-377).
All arithmetic wraps in the unsigned element type.

Functions operate on a single fixed-size element buffer ``x[E]`` with a traced
valid count ``n``; batch via ``jax.vmap``.
"""

from __future__ import annotations

import jax.numpy as jnp


def delta_encode(x, n):
    """out[i] = x[i+1] - x[i] for i < n-1; the first element x[0] is returned
    separately (the caller stores it in the delta header).

    Returns (deltas[E], first_element, out_count = n - 1).
    """
    d = jnp.roll(x, -1) - x
    i = jnp.arange(x.shape[-1], dtype=jnp.int32)
    d = jnp.where(i < n - 1, d, 0).astype(x.dtype)
    # n == 0 is UB in the reference (stale shared memory); define first = 0.
    first = jnp.where(n > 0, x[0], 0).astype(x.dtype)
    return d, first, jnp.maximum(n - 1, 0)


def delta_decode(d, first, n):
    """Inverse of delta_encode: exclusive prefix sum seeded with ``first``.

    ``n`` is the number of *input* deltas; output has n + 1 valid elements.
    Mirrors block_delta_decompress (reference src/CascadedKernels.hiph:344-377).
    """
    i = jnp.arange(d.shape[-1], dtype=jnp.int32)
    masked = jnp.where(i < n, d, 0).astype(d.dtype)
    # out[i] = first + sum(d[0:i]); implemented as roll of the inclusive scan.
    inc = jnp.cumsum(masked, dtype=d.dtype)
    exc = jnp.roll(inc, 1).at[0].set(0)
    out = (exc + first.astype(d.dtype)).astype(d.dtype)
    # position n holds first + sum(all deltas) == the last original element
    out = jnp.where(i <= n, out, 0).astype(d.dtype)
    # out[n] must be first + inc[n-1]; roll placed inc[n-1] at index n only if
    # n < E.  Recompute explicitly to be safe for n == 0 as well.
    total = jnp.where(n > 0, inc[jnp.clip(n - 1, 0, d.shape[-1] - 1)], 0).astype(d.dtype)
    out = out.at[jnp.clip(n, 0, d.shape[-1] - 1)].set(
        jnp.where(n < d.shape[-1], first.astype(d.dtype) + total, out[-1])
    )
    return out, n + 1
