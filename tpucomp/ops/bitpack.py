"""BitPack stage: frame-of-reference + fixed-width bit packing.

JAX re-expression of BitPackGPU (reference src/BitPackGPU.hip:185-298)
and the fused cascaded bitpack blocks (reference
src/CascadedKernels.hiph:395-553, 556-618).  The on-disk blob layout matches
the reference exactly so artifacts are interchangeable:

    [FOR: W bytes, raw little-endian signed minimum]
    [padding to 4B]
    [u32: (bitwidth << 16) | num_elements]
    [padding to max(4, W)]
    [packed bits: element i occupies bits [i*bw, (i+1)*bw) of a little-endian
     bit stream stored as u32 words]

Header size = roundUpTo(W + 4, max(4, W)) -> 8 bytes for W in {1,2,4},
16 bytes for W == 8 (reference src/CascadedKernels.hiph:516-523).

The minimum/maximum reduction uses the *signed* interpretation of the
elements and the FOR subtraction wraps in the unsigned element type
(reference src/CascadedKernels.hiph:400-405,494-496), so any input profile
packs into ``bitwidth = width(max_s - min_s mod 2^bits)`` bits.

Functions operate on a single fixed-size unsigned element buffer ``x[E]``
(E < 65536) with a traced valid count ``n >= 1``; batch via ``jax.vmap``.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpucomp.core.sizing import round_up_to
from tpucomp.utils import bits


def bitpack_header_size(width: int) -> int:
    return round_up_to(width + 4, max(4, width))


def bitpack_max_blob_size(num_elements: int, width: int) -> int:
    """Worst-case blob size: header + full-width packed data."""
    return bitpack_header_size(width) + round_up_to(num_elements * width, 4)


def for_bitwidth(x, n):
    """Frame of reference and bit width of the valid prefix of ``x``.

    Returns (for_unsigned, bitwidth int32).  ``x`` must be unsigned;
    comparisons happen on the signed reinterpretation, mirroring
    get_for_bitwidth (reference src/CascadedKernels.hiph:395-471).
    """
    width = jnp.iinfo(x.dtype).bits // 8
    sdtype = bits.signed_of_width(width)
    wide_s = jnp.int32 if width <= 4 else jnp.int64
    wide_u = jnp.uint32 if width <= 4 else jnp.uint64
    # The min/max REDUCTIONS must run at >= 32-bit width: signed int8/int16
    # where+min/max reductions MISCOMPILE under jit in this jax/XLA build
    # (0.9.0) -- jit returns garbage extrema while eager is correct (seen
    # as a silent fallback-instead-of-compress on SHORT data; regression
    # test tests/test_ops.py::test_for_bitwidth_narrow_dtypes_under_jit).
    # chip_smoke.py's dtype x layer sweep checks the same on the GPU.
    # Sentinels stay at the ELEMENT-width extrema so semantics are unchanged.
    xs = bits.bitcast(x, sdtype).astype(wide_s)
    i = jnp.arange(x.shape[-1], dtype=jnp.int32)
    valid = i < n
    big = jnp.iinfo(sdtype).max
    small = jnp.iinfo(sdtype).min
    minimum = jnp.min(jnp.where(valid, xs, big))
    maximum = jnp.max(jnp.where(valid, xs, small))
    # range in 32-bit wrapping math for W <= 4, 64-bit for W == 8
    # (reference src/CascadedKernels.hiph:459-469)
    rng = bits.bitcast(maximum, wide_u) - bits.bitcast(minimum, wide_u)
    bw = bits.bit_width(rng)
    # n == 0 is UB in the reference (uninitialized BlockReduce); define it
    # deterministically as FOR = 0, bitwidth = 0.
    frame = jnp.where(
        n > 0, bits.bitcast(minimum.astype(sdtype), x.dtype), 0
    ).astype(x.dtype)
    bw = jnp.where(n > 0, bw, 0)
    return frame, bw


def _pack_words_dispatch(u, n, bw, max_words: int, width: int):
    """Word-granularity scatter pack."""
    return _pack_words_scatter64(u, bw, max_words)


def _pack_words_scatter64(u, bw, max_words: int):
    """Element packing via 2-3 word-granularity scatter-adds.

    Each element's bw bits span at most 2 (width <= 4) or 3 (width 8)
    32-bit output words; parts have disjoint bits so add == or.
    """
    tbits = jnp.iinfo(u.dtype).bits
    i = jnp.arange(u.shape[-1], dtype=jnp.int32)
    bit0 = i * bw
    w0 = bit0 >> 5
    s0 = (bit0 & 31).astype(jnp.int32)
    if tbits <= 32:
        v = u.astype(jnp.uint32)
        parts = [bits.shl(v, s0), bits.shr(v, 32 - s0)]
    else:
        v = u.astype(jnp.uint64)
        parts = [bits.shl(v, s0), bits.shr(v, 32 - s0), bits.shr(v, 64 - s0)]
    words = jnp.zeros((max_words,), jnp.uint32)
    for k, part in enumerate(parts):
        idx = jnp.where(bw > 0, w0 + k, max_words)  # drop when bw == 0
        words = words.at[idx].add(part.astype(jnp.uint32), mode="drop")
    return words


def _unpack_words_gather64(units, bw, out_elements: int):
    """Element unpacking via two monotone unit gathers."""
    udtype = units.dtype
    tbits = jnp.iinfo(udtype).bits
    i = jnp.arange(out_elements, dtype=jnp.int32)
    bit0 = i * bw
    lo = jnp.minimum(bit0 // tbits, units.shape[0] - 1)
    off = bit0 - (bit0 // tbits) * tbits
    hi = jnp.minimum((bit0 + jnp.maximum(bw, 1) - 1) // tbits, units.shape[0] - 1)
    val = bits.shr(units[lo], off)
    high = bits.shl(units[hi], tbits - off)
    v = jnp.where((hi > lo) & (off != 0), val | high, val)
    return v & bits.mask_of_bits(jnp.broadcast_to(bw, v.shape), udtype)


def bitpack(x, n, max_words: int):
    """Pack the valid prefix of unsigned ``x`` into the reference blob format.

    Returns (blob uint8[header + 4*max_words], blob_size int32).
    ``max_words`` must be >= ceil(E * W * 8 / 32).
    """
    width = jnp.iinfo(x.dtype).bits // 8
    hdr = bitpack_header_size(width)
    frame, bw = for_bitwidth(x, n)
    u = (x - frame).astype(x.dtype)

    i = jnp.arange(x.shape[-1], dtype=jnp.int32)
    valid = i < n
    u = jnp.where(valid, u, 0).astype(x.dtype)

    words = _pack_words_dispatch(u, n, bw, max_words, width)
    data_words = (n * bw + 31) >> 5
    blob_size = hdr + 4 * data_words

    header = jnp.zeros((hdr,), jnp.uint8)
    header = header.at[:width].set(bits.units_to_bytes_le(frame[None])[:width])
    bw_off = round_up_to(width, 4)
    bw_word = (bw.astype(jnp.uint32) << 16) | jnp.asarray(n).astype(jnp.uint32)
    header = header.at[bw_off : bw_off + 4].set(bits.units_to_bytes_le(bw_word[None]))

    blob = jnp.concatenate([header, bits.units_to_bytes_le(words)])
    # zero bytes past blob_size so padding is deterministic
    t = jnp.arange(blob.shape[0], dtype=jnp.int32)
    blob = jnp.where(t < blob_size, blob, 0).astype(jnp.uint8)
    return blob, blob_size.astype(jnp.int32)


def bitunpack(blob, out_elements: int, width: int):
    """Unpack a reference-format blob into unsigned elements.

    Returns (x unsigned[out_elements], n int32, bitwidth int32).
    Mirrors block_bitunpack (reference src/CascadedKernels.hiph:556-618):
    the packed stream is read in element-width units, each output pulls from
    at most two units.
    """
    udtype = bits.unsigned_of_width(width)
    tbits = width * 8
    hdr = bitpack_header_size(width)

    frame = bits.bytes_to_units_le(blob[:width], width)[0]
    bw_off = round_up_to(width, 4)
    bw_word = bits.bytes_to_units_le(blob[bw_off : bw_off + 4], 4)[0]
    n = (bw_word & jnp.uint32(0xFFFF)).astype(jnp.int32)
    bw = (bw_word >> 16).astype(jnp.int32)

    data_bytes = blob[hdr:]
    # pad to a unit boundary and guarantee at least one unit (bw == 0 blobs
    # carry no packed data at all)
    pad = (-data_bytes.shape[0]) % width if data_bytes.shape[0] else width
    if pad:
        data_bytes = jnp.concatenate([data_bytes, jnp.zeros((pad,), jnp.uint8)])
    units = bits.bytes_to_units_le(data_bytes, width)

    v = _unpack_words_dispatch(units, bw, out_elements)
    i = jnp.arange(out_elements, dtype=jnp.int32)
    x = (v + frame).astype(udtype)
    x = jnp.where((i < n) & (bw > 0), x, jnp.where(i < n, frame, 0)).astype(udtype)
    return x, n, bw


def _unpack_words_dispatch(units, bw, out_elements: int):
    """Unpack units -> FOR-relative values via two monotone unit gathers
    (reference src/CascadedKernels.hiph:595-612, vectorized)."""
    return _unpack_words_gather64(units, bw, out_elements)
