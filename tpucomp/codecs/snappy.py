"""Batched Snappy codec.

Dense-XLA re-design of the reference's snappy kernels (do_snap, reference
src/snappy/compression.hiph:281-389; do_unsnap 3-warp pipeline,
src/snappy/decompression.hiph:195-213).  Streams are the raw Snappy format:
a varint uncompressed length followed by tagged elements -- literals (tag
kind 0, lengths > 60 use 1-4 extra LE length bytes) and copies with 1-, 2-
or 4-byte offsets.

The compressor mirrors the reference's emission limits (copy pieces <= 64
bytes, offsets <= 32768, reference src/snappy/config.h:88-91) and shares
the sort-based matcher + materializer with LZ4 (tpucomp/codecs/lz77.py).
The decompressor accepts any valid stream, including copy1/copy4 elements
the compressor never emits (mirroring the reference's
SnappyLargeTokens-test obligation).

Worst-case sizing mirrors 32 + n + n/6 (reference
src/lowlevel/SnappyBatch.cpp:71-75).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpucomp.codecs import lz77
from tpucomp.core.sizing import snappy_max_compressed_chunk_size
from tpucomp.core.types import Status
from tpucomp.utils import permute

MAX_OFFSET = 32768  # encoder limit (reference src/snappy/config.h:91)
MIN_MATCH = 4
PARSE_BLOCK = 4096

_INF = np.int32(2**30)  # numpy scalar: no backend init at import


def _varint_len(n):
    return jnp.where(n < (1 << 7), 1, jnp.where(n < (1 << 14), 2, jnp.where(n < (1 << 21), 3, 4))).astype(
        jnp.int32
    )


def _varint_byte(n, k, vlen):
    """Byte k of varint(n) (0-indexed)."""
    part = (n >> (7 * k)) & 0x7F
    more = k < vlen - 1
    return jnp.where(more, part | 0x80, part).astype(jnp.int32)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------


def _copy_pieces(ml, off):
    """Closed-form split of a match into copy elements.

    Returns (k64, has60, final_len, final_is_copy1, total_bytes)."""
    k64 = jnp.where(ml >= 68, (ml - 4) // 64, 0)
    rem1 = ml - 64 * k64
    has60 = rem1 > 64
    final = jnp.where(has60, rem1 - 60, rem1)
    is_c1 = (final <= 11) & (off < 2048)
    total = 3 * k64 + 3 * has60.astype(jnp.int32) + jnp.where(is_c1, 2, 3)
    return k64, has60, final, is_c1, jnp.where(ml > 0, total, 0)


def _lit_hdr(ll):
    v = ll - 1
    extra = jnp.where(
        v < 60, 0, jnp.where(v < (1 << 8), 1, jnp.where(v < (1 << 16), 2, 3))
    ).astype(jnp.int32)
    return jnp.where(ll > 0, 1 + extra, 0)


def _greedy_parse(mlen, dist, cand, n, s_max: int):
    """Greedy parse without end-of-block rules (snappy has none),
    block-parallel (lz77.py)."""
    c = mlen.shape[-1]
    i = jnp.arange(c, dtype=jnp.int32)
    m_clamped = jnp.where(cand, jnp.minimum(mlen, jnp.maximum(n - i, 0)), 0)
    return lz77.block_parallel_parse(m_clamped, dist, n, PARSE_BLOCK, s_max)


def _emit(data, lit_start, lit_len, match_len, offset, num_seqs, n, out_max: int):
    """Position-driven emission of the snappy byte stream."""
    s_max = lit_start.shape[-1]
    si = jnp.arange(s_max, dtype=jnp.int32)
    valid = si < num_seqs

    lhdr = _lit_hdr(lit_len)
    k64, has60, final, is_c1, copy_bytes = _copy_pieces(match_len, offset)
    seq_bytes = jnp.where(valid, lhdr + lit_len + copy_bytes, 0)
    vlen = _varint_len(n)
    inc = jnp.cumsum(seq_bytes)
    out_start = vlen + inc - seq_bytes
    total = vlen + inc[-1]

    t = jnp.arange(out_max, dtype=jnp.int32)
    # per-position sequence params: one scatter + multi-value forward fill
    (p_start, p_ll, p_lh, p_off, p_lsrc, p_k64, p_has60, p_final, p_c1i) = permute.fill_from_markers(
        out_start,
        valid & (seq_bytes > 0),
        [out_start, lit_len, lhdr, offset, lit_start, k64,
         has60.astype(jnp.int32), final, is_c1.astype(jnp.int32)],
        out_max,
    )
    p_c1 = p_c1i != 0

    u = t - p_start
    # literal header
    v = p_ll - 1
    extra = p_lh - 1
    lit_tag = jnp.where(extra == 0, v << 2, (59 + extra) << 2)
    lit_len_byte = (v >> (8 * jnp.maximum(u - 1, 0))) & 0xFF  # LE length bytes
    lit_hdr_byte = jnp.where(u == 0, lit_tag, lit_len_byte)
    # literal data
    lit0 = p_lh
    lit_byte = data[jnp.clip(p_lsrc + (u - lit0), 0, data.shape[-1] - 1)].astype(jnp.int32)
    # copy pieces
    cp0 = lit0 + p_ll
    w = u - cp0
    in64 = w < 3 * p_k64
    r3 = w % 3
    b64 = jnp.where(r3 == 0, (63 << 2) | 2, jnp.where(r3 == 1, p_off & 0xFF, p_off >> 8))
    w60 = w - 3 * p_k64
    in60 = (~in64) & (w60 < 3 * p_has60)
    b60 = jnp.where(w60 == 0, (59 << 2) | 2, jnp.where(w60 == 1, p_off & 0xFF, p_off >> 8))
    wf = w60 - 3 * p_has60
    bc1 = jnp.where(wf == 0, 1 | ((p_final - 4) << 2) | ((p_off >> 8) << 5), p_off & 0xFF)
    bc2 = jnp.where(wf == 0, ((p_final - 1) << 2) | 2, jnp.where(wf == 1, p_off & 0xFF, p_off >> 8))
    bfin = jnp.where(p_c1, bc1, bc2)
    copy_byte = jnp.where(in64, b64, jnp.where(in60, b60, bfin))

    val = jnp.where(u < lit0, lit_hdr_byte, jnp.where(u < cp0, lit_byte, copy_byte))
    # varint header
    vb = _varint_byte(n, jnp.minimum(t, 3), vlen)
    val = jnp.where(t < vlen, vb, val)
    out = jnp.where(t < total, val, 0).astype(jnp.uint8)
    return out, total


# --------------------------------------------------------------------------
# decompression
# --------------------------------------------------------------------------


def _delimit(comp, comp_len, out_cap: int, s_max: int):
    """Element walk: one snappy element per step (batched while_loop)."""
    c = comp.shape[-1]
    cb = comp.astype(jnp.int32)
    last = c - 1

    # varint uncompressed length
    b0, b1, b2, b3 = cb[0], cb[jnp.clip(1, 0, last)], cb[jnp.clip(2, 0, last)], cb[jnp.clip(3, 0, last)]
    vlen = jnp.where(b0 < 128, 1, jnp.where(b1 < 128, 2, jnp.where(b2 < 128, 3, 4)))
    n_out = (b0 & 0x7F) | ((b1 & 0x7F) << 7) | ((b2 & 0x7F) << 14) | ((b3 & 0x7F) << 21)
    n_out = jnp.where(vlen < 2, b0 & 0x7F, n_out)
    n_out = jnp.where(
        vlen == 2, (b0 & 0x7F) | ((b1 & 0x7F) << 7), n_out
    )
    n_out = jnp.where(
        vlen == 3, (b0 & 0x7F) | ((b1 & 0x7F) << 7) | ((b2 & 0x7F) << 14), n_out
    )

    seqs = jnp.zeros((s_max, 5), jnp.int32)
    unroll = 8

    # packed parse table: the 4 bytes after every position, precomputed
    # elementwise so each parse step costs 2 gathers instead of 5
    nxt4 = (
        jnp.roll(cb, -1)
        | (jnp.roll(cb, -2) << 8)
        | (jnp.roll(cb, -3) << 16)
        | (jnp.roll(cb, -4) << 24)
    )

    def step(carry):
        p, o, s, done, ok, rows = carry
        tag = cb[jnp.clip(p, 0, last)]
        kind = tag & 3
        packed = nxt4[jnp.clip(p, 0, last)]
        e1 = packed & 0xFF
        e2 = (packed >> 8) & 0xFF
        e3 = (packed >> 16) & 0xFF
        e4 = (packed >> 24) & 0xFF

        # literal
        lraw = tag >> 2
        lk = jnp.where(lraw < 60, 0, lraw - 59)
        lv = jnp.where(
            lk == 0,
            lraw,
            jnp.where(
                lk == 1,
                e1,
                jnp.where(lk == 2, e1 | (e2 << 8), jnp.where(lk == 3, e1 | (e2 << 8) | (e3 << 16), e1 | (e2 << 8) | (e3 << 16) | (e4 << 24))),
            ),
        )
        ll = lv + 1
        lit_src = p + 1 + lk
        lit_adv = 1 + lk + ll

        # copies
        c1_len = ((tag >> 2) & 7) + 4
        c1_off = ((tag >> 5) << 8) | e1
        c2_len = (tag >> 2) + 1
        c2_off = e1 | (e2 << 8)
        c4_off = e1 | (e2 << 8) | (e3 << 16) | (e4 << 24)
        ml = jnp.where(kind == 1, c1_len, c2_len)
        off = jnp.where(kind == 1, c1_off, jnp.where(kind == 2, c2_off, c4_off))
        copy_adv = jnp.where(kind == 1, 2, jnp.where(kind == 2, 3, 5))

        is_lit = kind == 0
        adv = jnp.where(is_lit, lit_adv, copy_adv)
        add = jnp.where(is_lit, ll, ml)
        step_ok = p + adv <= comp_len
        step_ok &= is_lit | ((off >= 1) & (off <= o))
        o2 = o + add
        step_ok &= o2 <= out_cap

        row = jnp.stack(
            [
                jnp.where(is_lit, lit_src, 0),
                jnp.where(is_lit, ll, 0),
                o,
                jnp.where(is_lit, 0, ml),
                jnp.where(is_lit, 0, off),
            ]
        )
        rows = rows.at[jnp.where(done, s_max, s)].set(row, mode="drop")
        p2 = p + adv
        at_end = p2 >= comp_len
        return (
            jnp.where(done, p, p2),
            jnp.where(done, o, o2),
            jnp.where(done, s, s + 1),
            done | at_end | ~step_ok,
            ok & (done | step_ok),
            rows,
        )

    def body(carry):
        for _ in range(unroll):
            carry = step(carry)
        return carry

    def cond(carry):
        return ~carry[3] & (carry[2] < s_max)

    init = (vlen, jnp.int32(0), jnp.int32(0), (comp_len <= vlen) | (comp_len <= 0), comp_len > 0, seqs)
    p, o, s, done, ok, seqs = jax.lax.while_loop(cond, body, init)
    ok &= done
    ok &= o == n_out  # decompressed bytes must match the varint header
    ok &= n_out <= out_cap
    arrays = (seqs[:, 0], seqs[:, 1], seqs[:, 2], seqs[:, 3], seqs[:, 4])
    return arrays, s, o, ok, n_out


# --------------------------------------------------------------------------
# public batched API (stage-wise jits; see lz4.py for rationale)
# --------------------------------------------------------------------------

_jit_match = jax.jit(
    jax.vmap(
        lambda d, n: (lambda j: lz77.match_lengths(d, n, j, MAX_OFFSET))(
            lz77.nearest_prev_occurrence(d, n)
        )
    )
)


@functools.partial(jax.jit, static_argnames=("s_max",))
def _jit_parse(mlen, dist, cand, lengths, s_max):
    return jax.vmap(lambda m, dd, cc, n: _greedy_parse(m, dd, cc, n, s_max))(
        mlen, dist, cand, lengths
    )


@functools.partial(jax.jit, static_argnames=("out_max",))
def _jit_emit(data, ls, ll, ml, off, s, lengths, out_max):
    out, total = jax.vmap(
        lambda d, a1, a2, a3, a4, ss, n: _emit(d, a1, a2, a3, a4, ss, n, out_max)
    )(data, ls, ll, ml, off, s, lengths)
    return out, total.astype(jnp.int32)


def compress(data, lengths, opts=None):
    """Batched snappy compression.  data: uint8[B, C]; lengths: int32[B].
    Returns (comp uint8[B, CMAX], comp_sizes int32[B])."""
    c = data.shape[-1]
    out_max = snappy_max_compressed_chunk_size(c)
    s_max = c // MIN_MATCH + 2
    lengths = lengths.astype(jnp.int32)
    mlen, dist, cand = _jit_match(data, lengths)
    ls, ll, ml, off, s = _jit_parse(mlen, dist, cand, lengths, s_max)
    return _jit_emit(data, ls, ll, ml, off, s, lengths, out_max)


@functools.partial(jax.jit, static_argnames=("out_cap", "s_max"))
def _jit_delimit(comp, comp_sizes, out_cap, s_max):
    return jax.vmap(lambda d, n: _delimit(d, n, out_cap, s_max))(
        comp, comp_sizes.astype(jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _jit_materialize(comp, seqs, s, total, ok, out_cap):
    out = jax.vmap(
        lambda d, sq, ss, tt: lz77.materialize(d, sq, tt, out_cap, num_seqs=ss)
    )(comp, seqs, s, total)
    out = jnp.where(ok[:, None], out, 0).astype(jnp.uint8)
    total = jnp.where(ok, total, 0).astype(jnp.int32)
    status = jnp.where(
        ok, jnp.int32(int(Status.SUCCESS)), jnp.int32(int(Status.ERROR_CANNOT_DECOMPRESS))
    )
    return out, total, status


def decompress(comp, comp_sizes, opts=None, out_capacity: int = 65536):
    """Batched snappy decompression.
    Returns (data uint8[B, out_capacity], lengths int32[B], statuses)."""
    s_max = comp.shape[-1] // 2 + 2
    seqs, s, total, ok, _ = _jit_delimit(comp, comp_sizes, out_capacity, s_max)
    return _jit_materialize(comp, seqs, s, total, ok, out_capacity)


@jax.jit
def get_decompress_size(comp, comp_sizes, opts=None):
    """Read the varint header (reference src/lowlevel/SnappyBatchKernels.hip:84-134)."""
    cb = comp.astype(jnp.int32)
    b = [cb[:, jnp.minimum(k, comp.shape[-1] - 1)] for k in range(4)]
    vlen = jnp.where(b[0] < 128, 1, jnp.where(b[1] < 128, 2, jnp.where(b[2] < 128, 3, 4)))
    n = b[0] & 0x7F
    n = jnp.where(vlen >= 2, n | ((b[1] & 0x7F) << 7), n)
    n = jnp.where(vlen >= 3, n | ((b[2] & 0x7F) << 14), n)
    n = jnp.where(vlen >= 4, n | ((b[3] & 0x7F) << 21), n)
    return jnp.where(comp_sizes > 0, n, 0).astype(jnp.int32)
