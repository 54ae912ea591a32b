"""Vectorized bit-twiddling primitives shared by all codecs.

Everything here is dense elementwise jnp math: no data-dependent shapes.
Shift helpers guard the out-of-range shift amounts that XLA leaves undefined.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_UNSIGNED_OF_WIDTH = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32, 8: jnp.uint64}
_SIGNED_OF_WIDTH = {1: jnp.int8, 2: jnp.int16, 4: jnp.int32, 8: jnp.int64}


def unsigned_of_width(width: int):
    return _UNSIGNED_OF_WIDTH[width]


def signed_of_width(width: int):
    return _SIGNED_OF_WIDTH[width]


def bitcast(x, dtype):
    """Reinterpret the bits of ``x`` as ``dtype`` (same element width)."""
    return jax.lax.bitcast_convert_type(x, dtype)


def shl(x, s):
    """Left shift with ``s >= bitwidth`` yielding 0 (XLA leaves it undefined)."""
    nbits = jnp.iinfo(x.dtype).bits
    s = jnp.asarray(s).astype(x.dtype)
    return jnp.where(s < nbits, x << jnp.minimum(s, nbits - 1).astype(x.dtype), jnp.zeros_like(x))


def shr(x, s):
    """Logical right shift with ``s >= bitwidth`` yielding 0.

    ``x`` must be unsigned for logical semantics.
    """
    nbits = jnp.iinfo(x.dtype).bits
    s = jnp.asarray(s).astype(x.dtype)
    return jnp.where(s < nbits, x >> jnp.minimum(s, nbits - 1).astype(x.dtype), jnp.zeros_like(x))


def mask_of_bits(nbits, dtype):
    """(1 << nbits) - 1 with nbits >= width yielding all-ones."""
    width = jnp.iinfo(dtype).bits
    nbits = jnp.asarray(nbits)
    one = jnp.broadcast_to(jnp.asarray(1, dtype), nbits.shape)
    full = ~jnp.asarray(0, dtype)
    return jnp.where(nbits >= width, full, shl(one, nbits) - one)


def bit_width(r):
    """Number of significant bits of unsigned ``r``: 32|64 - clz(r).

    Matches the reference's bitwidth computation
    (src/CascadedKernels.hiph:456-469).  Fully dense binary reduction.
    """
    nbits = jnp.iinfo(r.dtype).bits
    r = r.astype(jnp.uint64) if nbits > 32 else r.astype(jnp.uint32)
    bw = jnp.zeros(r.shape, jnp.int32)
    shift = jnp.iinfo(r.dtype).bits // 2
    while shift:
        has_high = (r >> r.dtype.type(shift)) != 0
        bw = bw + jnp.where(has_high, shift, 0)
        r = jnp.where(has_high, r >> r.dtype.type(shift), r)
        shift //= 2
    return bw + (r != 0)


def bytes_to_units_le(b, width: int):
    """uint8[..., k*width] -> unsigned{width*8}[..., k], little-endian."""
    if width == 1:
        return b.astype(jnp.uint8)
    assert b.shape[-1] % width == 0
    udtype = _UNSIGNED_OF_WIDTH[width]
    # one bitcast instead of a shift/or ladder; XLA folds any adjacent
    # transpose into it
    return jax.lax.bitcast_convert_type(
        b.reshape(*b.shape[:-1], -1, width), udtype
    )


def units_to_bytes_le(u):
    """unsigned[..., k] -> uint8[..., k*width], little-endian."""
    width = jnp.iinfo(u.dtype).bits // 8
    if width == 1:
        return u.astype(jnp.uint8)
    parts = jax.lax.bitcast_convert_type(u, jnp.uint8)  # [..., k, width]
    return parts.reshape(*u.shape[:-1], -1)


def bytes_to_words_le(b):
    """uint8[..., 4*W] -> uint32[..., W], little-endian within each word."""
    return bytes_to_units_le(b, 4)


def words_to_bytes_le(w):
    """uint32[..., W] -> uint8[..., 4*W], little-endian within each word."""
    return units_to_bytes_le(w.astype(jnp.uint32))


def write_section(out, src, offset, size):
    """out[offset + i] = src[i] for i < size; dense gather/select formulation.

    ``out`` and ``src`` are 1-D uint8 buffers with static shapes; ``offset``
    and ``size`` are traced scalars.
    """
    t = jnp.arange(out.shape[0], dtype=jnp.int32)
    idx = t - offset.astype(jnp.int32)
    take = (idx >= 0) & (idx < jnp.minimum(size, src.shape[0]))
    vals = src[jnp.clip(idx, 0, src.shape[0] - 1)]
    return jnp.where(take, vals, out)


def read_section(buf, offset, size: int):
    """Return buf[offset : offset + size] (static size), zero-padded past end."""
    t = jnp.arange(size, dtype=jnp.int32) + offset.astype(jnp.int32)
    ok = t < buf.shape[0]
    return jnp.where(ok, buf[jnp.clip(t, 0, buf.shape[0] - 1)], 0).astype(buf.dtype)
