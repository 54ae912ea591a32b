"""Fused batched Cascaded codec (RLE / Delta / BitPack pipeline).

Dense-XLA re-design of the reference's fused kernels
(do_cascaded_compression_kernel, src/CascadedKernels.hiph:766-1058;
cascaded_decompression_fcn, :1111-1435) producing byte-identical artifacts.

Partition layout (one batch entry; offsets relative to the partition start,
which the API requires to be 4B- and element-aligned):

    byte 0: num_RLEs   byte 1: num_deltas   byte 2: use_bp   byte 3: dtype
    bytes 4..7: uncompressed byte count (u32 LE)
    then, aligned up to the element width, a sequence of chunks:
      chunk metadata: u32 chunk_total | u32 rle_blob_bytes x num_RLEs |
                      u32 final_blob_bytes | delta first-elements
                      (layout per get_chunk_metadata_size, :101-106)
      RLE count blobs (uint16 runs, optionally bitpacked), each 4B-aligned
      final element blob, aligned to max(4, W)
      trailing padding to the element width

Incompressible partitions fall back to a raw copy with zeroed layer counts
(:862-870, 1019-1029), capping output at roundUp4(n) + 8.

Design notes (a re-design, not a port):
  - a batch is a dense (data uint8[B, C], lengths int32[B]) pair; all work is
    dense vectorized math vmapped over partitions and chunks -- the
    threadblock/shared-memory structure of the reference maps to
    chunk-blocked cumsum/searchsorted/gather pipelines that XLA fuses
  - the per-partition chunk packing uses an exclusive cumsum instead of the
    reference's pointer walk; results are identical bytes
  - layer schedules are static Python unrolls (opts are static under jit)

The reference's decompression scheduling only inverts compression when
num_deltas <= num_RLEs or num_RLEs == 0; CascadedOpts.validate enforces that.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpucomp.core.options import CascadedOpts
from tpucomp.core.sizing import round_up_to
from tpucomp.core.types import Status, width_of
from tpucomp.ops import bitpack as bp
from tpucomp.ops import delta as dl
from tpucomp.ops import rle as rl
from tpucomp.utils import bits, permute

PARTITION_HEADER = 8


def chunk_metadata_size(opts: CascadedOpts) -> int:
    w = width_of(opts.type)
    return round_up_to(4 + 4 * (opts.num_rles + 1), w) + round_up_to(w * opts.num_deltas, 4)


def _counts_blob_max(opts: CascadedOpts) -> int:
    e = opts.chunk_num_elements
    return (8 + round_up_to(2 * e, 4)) if opts.use_bp else round_up_to(2 * e, 4)


def _final_blob_max(opts: CascadedOpts) -> int:
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    return (bp.bitpack_header_size(w) + round_up_to(e * w, 4)) if opts.use_bp else round_up_to(e * w, 4)


def chunk_output_max(opts: CascadedOpts) -> int:
    """Worst-case bytes one chunk can occupy (metadata + blobs + padding)."""
    w = width_of(opts.type)
    total = (
        chunk_metadata_size(opts)
        + opts.num_rles * round_up_to(_counts_blob_max(opts), 4)
        + round_up_to(_final_blob_max(opts), 4)
    )
    return round_up_to(total + w, max(4, w))


def partition_output_max(capacity_bytes: int, opts: CascadedOpts) -> int:
    """Output buffer bytes per partition.

    The fallback rule caps every emitted partition at roundUp4(n) + 8 bytes
    -- the reference reports exactly this as the max compressed size
    (src/lowlevel/CascadedBatch.hip:321-324) -- so the buffer does not need
    the chunked-layout worst case (~2x the input), which only materializes
    transiently before the fallback select.  For w == 8 the final chunk's
    element-width trailing pad can push a non-fallback partition up to 4
    bytes past the cap (the incremental oob check tracks blob ends, not the
    trailing pad), hence the slack word.
    """
    w = width_of(opts.type)
    slack = 4 if w == 8 else 0
    return round_up_to(
        PARTITION_HEADER + round_up_to(capacity_bytes, 4) + slack, max(4, w)
    )


def _schedule(opts: CascadedOpts):
    """Static compression op order: RLE before Delta within each layer
    (reference src/CascadedKernels.hiph:910-980)."""
    ops = []
    rle_rem, delta_rem = opts.num_rles, opts.num_deltas
    for _ in range(max(opts.num_rles, opts.num_deltas)):
        if rle_rem > 0:
            ops.append(("rle", opts.num_rles - rle_rem))
            rle_rem -= 1
        if delta_rem > 0:
            ops.append(("delta", opts.num_deltas - delta_rem))
            delta_rem -= 1
    return ops


def _inverse_schedule(opts: CascadedOpts):
    """Static decompression op order (reference
    src/CascadedKernels.hiph:1333-1398): delta when delta_rem >= rle_rem,
    then rle when rle_rem >= delta_rem, per layer."""
    ops = []
    rle_rem, delta_rem = opts.num_rles, opts.num_deltas
    for _ in range(max(opts.num_rles, opts.num_deltas)):
        if delta_rem > 0 and delta_rem >= rle_rem:
            ops.append(("delta", delta_rem - 1))
            delta_rem -= 1
        if rle_rem > 0 and rle_rem >= delta_rem:
            ops.append(("rle", rle_rem - 1))
            rle_rem -= 1
    return ops


def _pack_blob(x, n, opts: CascadedOpts, blob_max: int):
    """block_write equivalent: raw bytes or a bitpack blob. Returns
    (blob uint8[blob_max], size)."""
    w = jnp.iinfo(x.dtype).bits // 8
    if opts.use_bp:
        max_words = (blob_max - bp.bitpack_header_size(int(w))) // 4
        blob, size = bp.bitpack(x, n, max_words)
        if blob.shape[0] < blob_max:
            blob = jnp.concatenate([blob, jnp.zeros((blob_max - blob.shape[0],), jnp.uint8)])
        return blob[:blob_max], size
    raw = bits.units_to_bytes_le(x)
    size = n * w
    t = jnp.arange(raw.shape[0], dtype=jnp.int32)
    raw = jnp.where(t < size, raw, 0).astype(jnp.uint8)
    if raw.shape[0] < blob_max:
        raw = jnp.concatenate([raw, jnp.zeros((blob_max - raw.shape[0],), jnp.uint8)])
    return raw[:blob_max], size.astype(jnp.int32)


def _fetch_units(part_words, data_off, unit_idx, width: int):
    """Fetch element-width units at 4-aligned byte offset ``data_off`` +
    unit_idx * width from the partition's u32 word view (one or two word
    gathers; sub-word extraction is elementwise)."""
    last = part_words.shape[0] - 1
    base = data_off // 4
    if width == 4:
        return part_words[jnp.clip(base + unit_idx, 0, last)]
    if width == 2:
        wv = part_words[jnp.clip(base + (unit_idx >> 1), 0, last)]
        return ((wv >> (16 * (unit_idx & 1)).astype(jnp.uint32)) & jnp.uint32(0xFFFF)).astype(
            jnp.uint16
        )
    if width == 1:
        wv = part_words[jnp.clip(base + (unit_idx >> 2), 0, last)]
        return ((wv >> (8 * (unit_idx & 3)).astype(jnp.uint32)) & jnp.uint32(0xFF)).astype(
            jnp.uint8
        )
    lo32 = part_words[jnp.clip(base + 2 * unit_idx, 0, last)]
    hi32 = part_words[jnp.clip(base + 2 * unit_idx + 1, 0, last)]
    return lo32.astype(jnp.uint64) | (hi32.astype(jnp.uint64) << jnp.uint64(32))


def _read_blob_elems(part_words, off, size, width: int, out_elements: int, use_bp: bool):
    """block_read equivalent reading straight out of the partition words.

    Returns (elems unsigned[out_elements], count).  ``off`` must be
    4-aligned (guaranteed by the format's alignment rules).
    """
    udtype = bits.unsigned_of_width(width)
    tbits = width * 8
    i = jnp.arange(out_elements, dtype=jnp.int32)
    if not use_bp:
        n = size // width
        elems = _fetch_units(part_words, off, i, width)
        return jnp.where(i < n, elems, 0).astype(udtype), n.astype(jnp.int32)

    hdr = bp.bitpack_header_size(width)
    w0 = part_words[jnp.clip(off // 4, 0, part_words.shape[0] - 1)]
    if width == 8:
        w1 = part_words[jnp.clip(off // 4 + 1, 0, part_words.shape[0] - 1)]
        frame = w0.astype(jnp.uint64) | (w1.astype(jnp.uint64) << jnp.uint64(32))
    elif width == 4:
        frame = w0
    else:
        frame = (w0 & jnp.uint32((1 << tbits) - 1)).astype(udtype)
    bw_word = part_words[jnp.clip((off + round_up_to(width, 4)) // 4, 0, part_words.shape[0] - 1)]
    n = (bw_word & jnp.uint32(0xFFFF)).astype(jnp.int32)
    bw = (bw_word >> 16).astype(jnp.int32)
    bw = jnp.minimum(bw, tbits)  # clamp corrupt widths

    da = off + hdr
    bit0 = i * bw
    lo = bit0 // tbits
    offs = bit0 - lo * tbits
    hi = (bit0 + jnp.maximum(bw, 1) - 1) // tbits
    ulo = _fetch_units(part_words, da, lo, width)
    uhi = _fetch_units(part_words, da, hi, width)
    v = bits.shr(ulo, offs)
    v = jnp.where((hi > lo) & (offs != 0), v | bits.shl(uhi, tbits - offs), v)
    v = v & bits.mask_of_bits(jnp.broadcast_to(bw, v.shape), udtype)
    x = (v + frame.astype(udtype)).astype(udtype)
    x = jnp.where((i < n) & (bw > 0), x, jnp.where(i < n, frame.astype(udtype), 0)).astype(udtype)
    return x, n


def _compress_chunk(x, n, opts: CascadedOpts):
    """Compress one chunk of elements into its blobs + layout.

    Returns a dict with the metadata bytes, count/final blobs (zero-padded,
    each with 8 slack bytes so alignment slots stay in-bounds), their
    partition-relative positions, the chunk's total size, and the largest
    end offset of any checked blob write (for the reference's incremental
    output-limit fallback check).
    """
    w = width_of(opts.type)
    meta_size = chunk_metadata_size(opts)
    counts_max = _counts_blob_max(opts)
    final_max = _final_blob_max(opts)

    meta_words = jnp.zeros((2 + opts.num_rles,), jnp.uint32)
    delta_firsts = jnp.zeros((max(opts.num_deltas, 1),), x.dtype)
    counts_blobs = jnp.zeros((max(opts.num_rles, 1), counts_max + 8), jnp.uint8)
    counts_pos = jnp.zeros((max(opts.num_rles, 1),), jnp.int32)

    pos = jnp.int32(meta_size)
    blob_end_max = jnp.int32(0)
    cur_x, cur_n = x, n
    for kind, idx in _schedule(opts):
        if kind == "rle":
            vals, counts, runs = rl.rle_encode(cur_x, cur_n)
            blob, size = _pack_blob(counts, runs, opts, counts_max)
            counts_blobs = counts_blobs.at[idx, :counts_max].set(blob)
            counts_pos = counts_pos.at[idx].set(pos)
            meta_words = meta_words.at[idx + 1].set(size.astype(jnp.uint32))
            blob_end_max = jnp.maximum(blob_end_max, pos + round_up_to_dyn(size, 4))
            pos = pos + round_up_to_dyn(size, 4)
            cur_x, cur_n = vals, runs
        else:
            d, first, cnt = dl.delta_encode(cur_x, cur_n)
            delta_firsts = delta_firsts.at[idx].set(first)
            cur_x, cur_n = d, cnt

    # final array, aligned to the element width (pos is 4B-aligned)
    fpos = round_up_to_dyn(pos, w)
    final_blob, size = _pack_blob(cur_x, cur_n, opts, final_max)
    final_blob = jnp.concatenate([final_blob, jnp.zeros((8,), jnp.uint8)])
    meta_words = meta_words.at[opts.num_rles + 1].set(size.astype(jnp.uint32))
    blob_end_max = jnp.maximum(blob_end_max, fpos + round_up_to_dyn(size, 4))
    total = round_up_to_dyn(fpos + round_up_to_dyn(size, 4), w)
    meta_words = meta_words.at[0].set(total.astype(jnp.uint32))

    # metadata bytes: u32 words then delta first-elements
    meta = jnp.zeros((meta_size,), jnp.uint8)
    meta = bits.write_section(meta, bits.units_to_bytes_le(meta_words),
                              jnp.int32(0), jnp.int32(4 * (2 + opts.num_rles)))
    if opts.num_deltas:
        dh_off = round_up_to(4 + 4 * (opts.num_rles + 1), w)
        meta = bits.write_section(
            meta,
            bits.units_to_bytes_le(delta_firsts[: opts.num_deltas]),
            jnp.int32(dh_off),
            jnp.int32(w * opts.num_deltas),
        )
    return {
        "meta": meta,
        "counts_blobs": counts_blobs,
        "counts_pos": counts_pos,
        "final_blob": final_blob,
        "fpos": fpos,
        "total": total,
        "blob_end_max": blob_end_max,
    }


def round_up_to_dyn(x, y: int):
    return (x + (y - 1)) // y * y


def _compress_partition(data, length, opts: CascadedOpts):
    """data: uint8[C]; length: valid bytes.  Returns (out uint8[PMAX], size)."""
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    c = data.shape[0]
    k = max(1, -(-c // opts.chunk_size))
    pmax = partition_output_max(c, opts)
    meta_size = chunk_metadata_size(opts)

    n_elems = (length // w).astype(jnp.int32)
    input_bytes = n_elems * w

    padded = jnp.zeros((k * e * w,), jnp.uint8).at[:c].set(data)
    elems = bits.bytes_to_units_le(padded, w).reshape(k, e)
    ki = jnp.arange(k, dtype=jnp.int32)
    chunk_n = jnp.clip(n_elems - ki * e, 0, e)

    ch = jax.vmap(lambda xx, nn: _compress_chunk(xx, nn, opts))(elems, chunk_n)
    valid = chunk_n > 0
    totals = jnp.where(valid, ch["total"], 0)

    start0 = round_up_to(PARTITION_HEADER, w)
    offsets = start0 + jnp.cumsum(totals) - totals  # exclusive cumsum
    total_size = start0 + jnp.sum(totals)

    # reference fallback check: any checked blob write ending past the limit
    # (output_limit = 8B metadata + roundUp4(input_bytes))
    limit = PARTITION_HEADER + round_up_to_dyn(input_bytes, 4)
    oob = jnp.any(valid & (offsets + ch["blob_end_max"] > limit))
    no_layers = opts.num_rles == 0 and opts.num_deltas == 0 and not opts.use_bp
    use_fallback = oob | jnp.bool_(no_layers)

    # ---- sort-based byte placement: every byte of every section gets a
    # target position; alignment gaps are covered by the blobs' zero padding
    cb8 = ch["counts_blobs"].shape[-1]
    fb8 = ch["final_blob"].shape[-1]
    # placeholder entries for the partition header region [0, start0) so the
    # placement covers position 0 onward (overwritten with the real header
    # below); place() requires gap-free coverage
    vals_list = [
        jnp.zeros((start0,), jnp.uint8),
        ch["meta"].reshape(-1),
        ch["final_blob"].reshape(-1),
    ]
    hdr_tgts = [jnp.arange(start0, dtype=jnp.int32)]
    hdr_oks = [jnp.ones((start0,), jnp.bool_)]
    tgt_meta = offsets[:, None] + jnp.arange(meta_size, dtype=jnp.int32)[None, :]
    ok_meta = jnp.broadcast_to(valid[:, None], (k, meta_size))
    tgt_final = (offsets + ch["fpos"])[:, None] + jnp.arange(fb8, dtype=jnp.int32)[None, :]
    ok_final = valid[:, None] & (
        jnp.arange(fb8, dtype=jnp.int32)[None, :] < (ch["total"] - ch["fpos"])[:, None]
    )
    tgts_list = hdr_tgts + [tgt_meta.reshape(-1), tgt_final.reshape(-1)]
    oks_list = hdr_oks + [ok_meta.reshape(-1), ok_final.reshape(-1)]
    if opts.num_rles:
        # count-blob slot r extends to the next blob's start (covers padding)
        nxt = jnp.concatenate(
            [ch["counts_pos"][:, 1 : opts.num_rles], ch["fpos"][:, None]], axis=1
        )
        slot = nxt - ch["counts_pos"][:, : opts.num_rles]
        tgt_counts = (
            (offsets[:, None] + ch["counts_pos"][:, : opts.num_rles])[:, :, None]
            + jnp.arange(cb8, dtype=jnp.int32)[None, None, :]
        )
        ok_counts = valid[:, None, None] & (
            jnp.arange(cb8, dtype=jnp.int32)[None, None, :] < slot[:, :, None]
        )
        vals_list.append(ch["counts_blobs"][:, : opts.num_rles].reshape(-1))
        tgts_list.append(tgt_counts.reshape(-1))
        oks_list.append(ok_counts.reshape(-1))

    all_vals = jnp.concatenate(vals_list)
    all_tgts = jnp.concatenate(tgts_list)
    all_oks = jnp.concatenate(oks_list)
    if all_vals.shape[0] < pmax:  # place() needs at least pmax entries
        pad = pmax - all_vals.shape[0]
        all_vals = jnp.concatenate([all_vals, jnp.zeros((pad,), jnp.uint8)])
        all_tgts = jnp.concatenate([all_tgts, jnp.zeros((pad,), jnp.int32)])
        all_oks = jnp.concatenate([all_oks, jnp.zeros((pad,), jnp.bool_)])
    body = permute.place(all_vals, all_tgts, all_oks, pmax)

    header = jnp.zeros((PARTITION_HEADER,), jnp.uint8)
    nr = jnp.where(use_fallback, 0, opts.num_rles).astype(jnp.uint8)
    nd = jnp.where(use_fallback, 0, opts.num_deltas).astype(jnp.uint8)
    ub = jnp.where(use_fallback, 0, int(opts.use_bp)).astype(jnp.uint8)
    header = header.at[0].set(nr).at[1].set(nd).at[2].set(ub).at[3].set(jnp.uint8(int(opts.type)))
    header = header.at[4:8].set(bits.units_to_bytes_le(input_bytes.astype(jnp.uint32)[None]))

    # fallback body: raw elements at roundUp(8, w), padded to 4B.
    # raw_start is static, so this is a concat + mask, not a gather.
    raw_start = round_up_to(PARTITION_HEADER, w)
    t = jnp.arange(pmax, dtype=jnp.int32)
    shifted = jnp.concatenate([jnp.zeros((raw_start,), jnp.uint8), padded])
    if shifted.shape[0] < pmax:
        shifted = jnp.concatenate([shifted, jnp.zeros((pmax - shifted.shape[0],), jnp.uint8)])
    raw_body = jnp.where(
        (t >= raw_start) & (t < raw_start + input_bytes), shifted[:pmax], 0
    ).astype(jnp.uint8)
    fallback_size = round_up_to(PARTITION_HEADER, w) + round_up_to_dyn(input_bytes, 4)

    body = jnp.where(use_fallback, raw_body, body)
    out = body.at[:PARTITION_HEADER].set(header)
    size = jnp.where(use_fallback, fallback_size, total_size)
    # empty *input* gets size 0 (reference :857-861); a sub-element-width
    # input (0 < length < w, so n_elems == 0) still emits the
    # roundUp(8, w)-byte header-only partition that decompresses to 0 bytes
    # (reference src/CascadedKernels.hiph:1183-1192 accepts it).
    size = jnp.where(length > 0, size, 0)
    out = jnp.where(length > 0, out, jnp.zeros_like(out))
    return out, size.astype(jnp.int32)


def _walk_chunks(part_words, total_bytes: int, comp_size, opts: CascadedOpts, k: int):
    """Chunk start offsets via the reference's pointer walk (scan over K)."""
    w = width_of(opts.type)
    start0 = round_up_to(PARTITION_HEADER, w)

    def step(pos, _):
        word = part_words[jnp.clip(pos // 4, 0, part_words.shape[0] - 1)]
        total = jnp.minimum(word, jnp.uint32(total_bytes + 8)).astype(jnp.int32)
        in_range = pos < (comp_size // 4) * 4
        nxt = jnp.where(in_range, round_up_to_dyn(pos + jnp.maximum(total, 4), w), pos)
        return nxt, (pos, in_range)

    end_pos, (offs, live) = jax.lax.scan(step, jnp.int32(start0), None, length=k)
    return offs, live, end_pos


def _decompress_chunk(part, part_words, comp_size, chunk_off, opts: CascadedOpts):
    """Inverse pipeline for one chunk.  Returns (elems[E], count, ok)."""
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    meta_size = chunk_metadata_size(opts)
    end_words = comp_size // 4

    ok = (chunk_off + meta_size) // 4 <= end_words

    meta = bits.read_section(part, chunk_off, meta_size)
    meta_words = bits.bytes_to_units_le(meta[: 4 * (2 + opts.num_rles)], 4)
    cap = jnp.uint32(part.shape[0] + 8)
    blob_sizes = jnp.minimum(meta_words, cap).astype(jnp.int32)  # clamp corrupt sizes
    delta_firsts = jnp.zeros((max(opts.num_deltas, 1),), bits.unsigned_of_width(w))
    if opts.num_deltas:
        dh_off = round_up_to(4 + 4 * (opts.num_rles + 1), w)
        delta_firsts = bits.bytes_to_units_le(
            bits.read_section(part, chunk_off + dh_off, w * opts.num_deltas), w
        )

    # section offsets (reference src/CascadedKernels.hiph:1288-1302)
    rle_offsets = [jnp.int32(0)]
    for kk in range(opts.num_rles - 1):
        rle_offsets.append(round_up_to_dyn(rle_offsets[kk] + blob_sizes[kk + 1], 4))
    if opts.num_rles > 0:
        final_off = round_up_to_dyn(rle_offsets[-1] + blob_sizes[opts.num_rles], max(4, w))
    else:
        final_off = jnp.int32(0)
    base = chunk_off + meta_size

    def in_bounds(off, size):
        return (base + off) // 4 + (size + 3) // 4 <= end_words

    final_size = blob_sizes[opts.num_rles + 1]
    ok &= in_bounds(final_off, final_size)
    cur_x, cur_n = _read_blob_elems(
        part_words, base + final_off, final_size, w, e, opts.use_bp
    )

    for kind, idx in _inverse_schedule(opts):
        if kind == "delta":
            cur_x, cur_n = dl.delta_decode(cur_x, delta_firsts[idx], cur_n)
            cur_n = jnp.minimum(cur_n, e)
        else:
            csize = blob_sizes[idx + 1]
            ok &= in_bounds(rle_offsets[idx], csize)
            counts, _ = _read_blob_elems(
                part_words, base + rle_offsets[idx], csize, 2, e, opts.use_bp
            )
            cur_x, cur_n = rl.rle_decode(cur_x, counts.astype(jnp.uint16), cur_n, e)
    return cur_x, jnp.where(ok, cur_n, 0), ok


def _decompress_partition(part, comp_size, out_capacity: int, opts: CascadedOpts):
    """Returns (out uint8[out_capacity], out_bytes, status int32)."""
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    cap_elems = out_capacity // w
    k = max(1, -(-out_capacity // opts.chunk_size))

    hdr_ok = comp_size >= PARTITION_HEADER
    nr = part[0].astype(jnp.int32)
    nd = part[1].astype(jnp.int32)
    ubp = part[2].astype(jnp.int32)
    dt = part[3].astype(jnp.int32)
    n_bytes = bits.bytes_to_units_le(part[4:8], 4)[0].astype(jnp.int32)
    n_elems = n_bytes // w

    fits = out_capacity >= n_bytes
    is_fallback = (nr == 0) & (nd == 0) & (ubp == 0)
    matches = (nr == opts.num_rles) & (nd == opts.num_deltas) & (ubp == int(opts.use_bp)) & (
        dt == int(opts.type)
    )

    # ---- fallback raw-copy path (reference :1227-1257)
    # raw_start is static: a slice + mask, not a gather
    raw_start = round_up_to(PARTITION_HEADER, w)
    fb_ok = comp_size >= raw_start + n_elems * w
    t = jnp.arange(out_capacity, dtype=jnp.int32)
    src = part[raw_start:]
    if src.shape[0] < out_capacity:
        src = jnp.concatenate([src, jnp.zeros((out_capacity - src.shape[0],), jnp.uint8)])
    fb_out = jnp.where(t < n_elems * w, src[:out_capacity], 0).astype(jnp.uint8)

    # ---- chunked pipeline path
    pad4 = (-part.shape[0]) % 4
    part4 = jnp.concatenate([part, jnp.zeros((pad4,), jnp.uint8)]) if pad4 else part
    part_words = bits.bytes_to_units_le(part4, 4)
    offs, live, end_pos = _walk_chunks(part_words, part.shape[0], comp_size, opts, k)
    elems_k, counts_k, ok_k = jax.vmap(
        lambda off: _decompress_chunk(part, part_words, comp_size, off, opts)
    )(offs)
    counts_k = jnp.where(live, counts_k, 0)
    ok_pipeline = jnp.all(ok_k | ~live)
    cum = jnp.cumsum(counts_k)
    total_elems = cum[-1]
    ok_pipeline &= total_elems == n_elems
    ok_pipeline &= jnp.all(cum <= n_elems)
    ok_pipeline &= end_pos >= (comp_size // 4) * 4  # all chunks consumed

    # ragged concat of chunk element outputs (sort-based placement)
    el_offsets = (cum - counts_k).astype(jnp.int32)
    el_tgts = el_offsets[:, None] + jnp.arange(e, dtype=jnp.int32)[None, :]
    el_ok = jnp.arange(e, dtype=jnp.int32)[None, :] < counts_k[:, None]
    n_entries = max(k * e, cap_elems)
    ev = elems_k.reshape(-1)
    et = el_tgts.reshape(-1)
    eo = el_ok.reshape(-1)
    if ev.shape[0] < n_entries:
        pad = n_entries - ev.shape[0]
        ev = jnp.concatenate([ev, jnp.zeros((pad,), ev.dtype)])
        et = jnp.concatenate([et, jnp.zeros((pad,), jnp.int32)])
        eo = jnp.concatenate([eo, jnp.zeros((pad,), jnp.bool_)])
    out_elems = permute.place(ev, et, eo, cap_elems)
    pipe_out = bits.units_to_bytes_le(out_elems)[:out_capacity]

    ok = jnp.where(is_fallback, fb_ok, ok_pipeline & matches) & hdr_ok & fits & (
        comp_size > 0
    )
    out = jnp.where(is_fallback, fb_out, pipe_out)
    out = jnp.where(ok, out, jnp.zeros_like(out))
    out_bytes = jnp.where(ok, n_elems * w, 0).astype(jnp.int32)
    status = jnp.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS)).astype(
        jnp.int32
    )
    return out, out_bytes, status


@functools.partial(jax.jit, static_argnames=("opts",))
def _compress_xla(data, lengths, opts: CascadedOpts):
    return jax.vmap(lambda d, l: _compress_partition(d, l, opts))(data, lengths)


# ---------------------------------------------------------------------------
# certain-fallback classifier
#
# On mixed/incompressible corpora most 64 KB partitions take the raw
# fallback (a header + shifted byte copy), yet the compress pipeline runs in
# full for every partition before the fallback select.  The classifier
# below proves fallback ahead of time for most such partitions, so an
# encoder can skip the pipeline for them; tests/test_routing.py pins that it
# never flags a partition the pipeline would compress.


def _flags_supported(opts: CascadedOpts) -> bool:
    """Configs with a cheap *certain-fallback* classifier (encode side)."""
    w = width_of(opts.type)
    if w not in (1, 2, 4):
        return False
    if opts.num_rles == 0 and opts.num_deltas == 0 and not opts.use_bp:
        return True  # no layers: every partition falls back (reference :857)
    if not opts.use_bp:
        return False
    if opts.num_rles == 0:
        return True  # pure delta chain: exact elementwise sizes
    return opts.num_rles in (1, 2) and opts.num_deltas in (0, 1)


def _sext32(v, ebits: int):
    if ebits >= 32:
        return v
    m = jnp.int32(1 << (ebits - 1))
    return ((v & jnp.int32((1 << ebits) - 1)) ^ m) - m


def _bitpack_size(count, values, valid, width: int):
    """Exact bitpack blob size for the masked values (ops/bitpack.py
    semantics: signed min/max, range wraps in 32-bit math, hdr + data
    words).  ``values`` are sign-extended int32; ``valid`` masks the live
    entries; ``count`` is the packed element count."""
    big = jnp.int32(2**31 - 1)
    mn = jnp.min(jnp.where(valid, values, big), axis=-1)
    mx = jnp.max(jnp.where(valid, values, -big - 1), axis=-1)
    rng = bits.bitcast(mx, jnp.uint32) - bits.bitcast(mn, jnp.uint32)
    bw = jnp.where(count > 0, bits.bit_width(rng), 0)
    hdr = bp.bitpack_header_size(width)
    return hdr + 4 * ((count * bw + 31) >> 5)


def _fallback_certain(data, lengths, opts: CascadedOpts):
    """bool[B]: True only where the partition CERTAINLY takes the raw
    fallback.

    The fallback rule is exact arithmetic on per-chunk blob sizes
    (reference src/CascadedKernels.hiph:862-870): a partition falls back
    iff the summed chunk totals exceed roundUp4(input_bytes) (for w <= 4
    every blob end equals the running total, so the reference's
    incremental check reduces to the sum).  For *pure* chunks -- no two
    adjacent equal elements, the norm on incompressible data -- every
    stage size is an elementwise formula: RLE counts are all 1 (bitpack
    collapses to its 8-byte header) and the delta stage's value multiset
    equals the elementwise adjacent differences, so frame/bitwidth
    reductions need no compaction.  Impure chunks get a weak lower bound;
    under-estimates only cost fast-path coverage, never correctness
    (false fallbacks are impossible, verified by
    tests/test_routing.py::test_routing_flags_never_false_positive).
    """
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    nr, nd = opts.num_rles, opts.num_deltas
    b, c = data.shape
    k = max(1, -(-c // opts.chunk_size))
    n_el = (lengths // w).astype(jnp.int32)

    if nr == 0 and nd == 0 and not opts.use_bp:
        return jnp.ones((b,), jnp.bool_)

    meta = chunk_metadata_size(opts)
    pad = k * e * w - c
    padded = jnp.pad(data, ((0, 0), (0, pad))) if pad else data
    x = bits.bitcast(
        bits.bytes_to_units_le(padded, w), bits.signed_of_width(w)
    ).astype(jnp.int32).reshape(b, k, e)
    ki = jnp.arange(k, dtype=jnp.int32)[None, :]
    n = jnp.clip(n_el[:, None] - ki * e, 0, e)  # [b, k] chunk element counts

    def diffs(cur, cnt):
        d = _sext32(cur[..., 1:] - cur[..., :-1], 8 * w)
        cnt = jnp.maximum(cnt - 1, 0)
        idx = jnp.arange(d.shape[-1], dtype=jnp.int32)
        return jnp.where(idx < cnt[..., None], d, 0), cnt

    if nr == 0:
        # pure delta chain: exact for every chunk
        cur, cnt = x, n
        for _ in range(nd):
            cur, cnt = diffs(cur, cnt)
        idx = jnp.arange(cur.shape[-1], dtype=jnp.int32)
        f = _bitpack_size(cnt, cur, idx < cnt[..., None], w)
        t_lb = meta + round_up_to_dyn(f, 4)
    else:
        i = jnp.arange(e - 1, dtype=jnp.int32)
        neq = (x[:, :, 1:] != x[:, :, :-1]) & (i < (n[..., None] - 1))
        r0 = jnp.where(n > 0, 1 + neq.sum(-1), 0)
        pure = (r0 == n) & (n > 0)
        if nd == 0:
            # [rle] or [rle, rle]: pure => vals are x itself (runs all 1)
            idx = jnp.arange(e, dtype=jnp.int32)
            f = _bitpack_size(n, x, idx < n[..., None], w)
        else:
            # [rle, delta] or [rle, delta, rle]: pure => deltas are the
            # elementwise diffs; for nr == 2 the final count is the run
            # count of the diff stream and its value range equals the
            # diff range (every diff belongs to a run of its own value)
            d, n_d = diffs(x, n)
            if nr == 1:
                idx = jnp.arange(e - 1, dtype=jnp.int32)
                f = _bitpack_size(n_d, d, idx < n_d[..., None], w)
            else:
                i2 = jnp.arange(e - 2, dtype=jnp.int32)
                neq2 = (d[:, :, 1:] != d[:, :, :-1]) & (i2 < (n_d[..., None] - 1))
                r1 = jnp.where(n_d > 0, 1 + neq2.sum(-1), 0)
                idx = jnp.arange(e - 1, dtype=jnp.int32)
                big = jnp.int32(2**31 - 1)
                valid = idx < n_d[..., None]
                mn = jnp.min(jnp.where(valid, d, big), axis=-1)
                mx = jnp.max(jnp.where(valid, d, -big - 1), axis=-1)
                rng = bits.bitcast(mx, jnp.uint32) - bits.bitcast(mn, jnp.uint32)
                bw1 = jnp.where(r1 > 0, bits.bit_width(rng), 0)
                f = 8 + 4 * ((r1 * bw1 + 31) >> 5)
        # counts blobs: 8 bytes each exactly when pure (all-1 counts pack at
        # bitwidth 0); later-layer counts lower-bounded at their header
        t_pure = meta + 8 * nr + round_up_to_dyn(f, 4)
        t_lb = jnp.where(pure, t_pure, meta + 8 * (nr + 1))

    t_lb = jnp.where(n > 0, t_lb, 0)
    input_bytes = n_el * w
    return t_lb.sum(-1) > round_up_to_dyn(input_bytes, 4)


def compress(data, lengths, opts: CascadedOpts):
    """Batched cascaded compression.

    data: uint8[B, C]; lengths: int32[B].  Returns (comp uint8[B, PMAX],
    comp_sizes int32[B]).  Lengths that are not a multiple of the element
    width are truncated (reference behavior, src/CascadedKernels.hiph:846).
    """
    opts.validate()
    return _compress_xla(data, lengths, opts)


@functools.partial(jax.jit, static_argnames=("opts", "out_capacity"))
def _decompress_xla(comp, comp_sizes, opts: CascadedOpts, out_capacity: int):
    return jax.vmap(lambda p, s: _decompress_partition(p, s, out_capacity, opts))(
        comp, comp_sizes
    )


def decompress(comp, comp_sizes, opts: CascadedOpts, out_capacity: int):
    """Batched cascaded decompression.

    Returns (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B]).  Partitions whose stream metadata does not match ``opts``
    (other than the raw fallback) report ERROR_CANNOT_DECOMPRESS.
    """
    opts.validate()
    return _decompress_xla(comp, comp_sizes, opts, out_capacity)


def detect_opts(comp, comp_sizes, chunk_size: int | None = None) -> CascadedOpts:
    """Recover CascadedOpts from a compressed batch's partition metadata.

    The reference's decompression reads layer counts and dtype from each
    partition on device (src/lowlevel/CascadedBatch.hip:156-260); our static
    pipeline needs them at trace time, so this helper peeks at the first
    non-fallback partition's header bytes on the host.  ``chunk_size`` is
    not recorded in the stream (the reference requires the caller to pass
    the same opts it compressed with); defaults to 4096.
    """
    import numpy as np

    heads = np.asarray(jax.device_get(comp[:, :4]))
    sizes = np.asarray(jax.device_get(comp_sizes))
    from tpucomp.core.types import DataType

    pick = None
    for b in range(heads.shape[0]):
        if sizes[b] >= PARTITION_HEADER:
            pick = heads[b]
            if heads[b][:3].any():  # prefer a non-fallback partition
                break
    if pick is None:
        return CascadedOpts(chunk_size=chunk_size or 4096)
    nr, nd, bp, dt = (int(x) for x in pick)
    if nr == 0 and nd == 0 and bp == 0:
        # all-fallback batch: layer config unknown; defaults still decode
        return CascadedOpts(chunk_size=chunk_size or 4096, type=DataType(dt))
    return CascadedOpts(
        chunk_size=chunk_size or 4096,
        type=DataType(dt),
        num_rles=nr,
        num_deltas=nd,
        use_bp=bool(bp),
    )


@jax.jit
def get_decompress_size(comp, comp_sizes):
    """Uncompressed byte count per partition (reads u32 at offset 4,
    reference src/lowlevel/CascadedBatch.hip:262-281)."""
    sizes = bits.bytes_to_units_le(comp[:, 4:8], 4)[:, 0].astype(jnp.int32)
    return jnp.where(comp_sizes >= PARTITION_HEADER, sizes, 0)
