"""Batched LZ4 block codec.

Dense-XLA re-design of the reference's warp-cooperative LZ4 kernels
(compressStream, reference src/LZ4Kernels.hiph:794-969; decompressStream,
:971-1097).  Streams are standard LZ4 block format: sequences of
[token][litlen LSIC][literals][u16 LE offset][matchlen LSIC], last sequence
literals-only, last 5 bytes literal, matches start >= 12 bytes from the end
(reference :162-174 constants; MAX_OFFSET 65535).

Design (dense vector ops + two small batched loops; no warp ballots):

  compress:
    - match finding: one key-value sort of (4-byte window, position) gives
      the exact nearest previous occurrence of every position -- the ideal
      form of the reference's 2^14-entry hash table (:557-561,634-663),
      with no collisions
    - match lengths: exact unbounded extension via a binary greedy walk
      over prefix-doubled suffix-id levels (lz77.suffix_id_levels) --
      full-length matches at any offset, matching lengthOfMatch
      (reference src/LZ4Kernels.hiph:592-617) without its serial walk
    - greedy parse: literals need no steps -- "next match position" is a
      dense reverse cummin -- so the batched while_loop advances one
      *sequence* per iteration
    - emission: position-driven; every output byte classifies itself from
      forward-filled per-sequence parameters (token/LSIC/offset bytes are
      elementwise, literals are one gather)

  decompress:
    - delimit: batched while_loop over sequences; LSIC parsing uses dense
      255-run tables (reverse cummin) so each step is O(1) gathers
    - materialize: per-position match parameters via scatter + forward
      fill; self-referential (periodic) copies collapse in one step with
      modular arithmetic (out[dst-off + (t-dst) mod off]); remaining
      match-of-match chains resolve by pointer doubling with early exit;
      final bytes are one gather from the literal source

Worst-case sizing mirrors maxSizeOfStream (reference :198-202).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpucomp.core.sizing import lz4_max_compressed_chunk_size
from tpucomp.core.types import Status
from tpucomp.codecs import lz77
from tpucomp.utils import permute

MAX_OFFSET = 65535
MIN_MATCH = 4
LAST_LITERALS = 5  # reference src/LZ4Kernels.hiph:168
LAST_VALID_MATCH = 13  # match start <= n - 13 (mirrors the test oracle)
PARSE_BLOCK = 4096  # independent greedy-parse blocks (lz77.block_parallel_parse)

_INF = np.int32(2**30)  # numpy scalar: no backend init at import


def _delimit_unroll() -> int:
    """Sequences decoded per while-loop iteration of _delimit.

    Each iteration also pays for its loop-carried per-sequence table.  On
    the GPU that is a full copy of the table per iteration, so unrolling
    amortizes it: 16 was the fastest of 1/4/8/16 on the H200.  XLA:CPU
    updates the table in place up to about 9 steps per iteration and copies
    it on every step beyond that (16 decodes a mixed 64 KB chunk ~50x slower
    than 8), so 8 there.  Both measurements are in PERF.md.
    """
    return 16 if jax.default_backend() == "gpu" else 8


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------


def _lsic_len(v):
    """Number of LSIC extension bytes for a token nibble value v (v >= 0);
    0 when v < 15."""
    return jnp.where(v >= 15, (v - 15) // 255 + 1, 0).astype(jnp.int32)


def _greedy_parse(mlen, dist, cand, n, s_max: int):
    """Greedy parse with LZ4 end rules, block-parallel (lz77.py)."""
    c = mlen.shape[-1]
    i = jnp.arange(c, dtype=jnp.int32)
    ok_pos = cand & (i <= n - LAST_VALID_MATCH)
    m_clamped = jnp.where(
        ok_pos, jnp.minimum(mlen, jnp.maximum(n - LAST_LITERALS - i, 0)), 0
    )
    return lz77.block_parallel_parse(m_clamped, dist, n, PARSE_BLOCK, s_max)


def _emit(data, lit_start, lit_len, match_len, offset, num_seqs, out_max: int):
    """Position-driven emission of the LZ4 byte stream."""
    s_max = lit_start.shape[-1]
    si = jnp.arange(s_max, dtype=jnp.int32)
    valid = si < num_seqs
    llb = _lsic_len(lit_len)
    mlb = jnp.where(match_len > 0, _lsic_len(match_len - MIN_MATCH), 0)
    seq_bytes = jnp.where(
        valid, 1 + llb + lit_len + jnp.where(match_len > 0, 2 + mlb, 0), 0
    )
    inc = jnp.cumsum(seq_bytes)
    out_start = inc - seq_bytes
    total = inc[-1]

    # forward-fill per-sequence params over output positions: scatter at
    # section starts (distinct for valid seqs) + ffill
    t = jnp.arange(out_max, dtype=jnp.int32)

    def fill(vals):
        marks = jnp.zeros((out_max,), jnp.int32)
        idx = jnp.where(valid & (seq_bytes > 0), out_start, out_max)
        marks = marks.at[idx].set(vals + 1, mode="drop")
        return permute.ffill(marks, marks != 0) - 1

    sid = fill(si)
    sid = jnp.clip(sid, 0, s_max - 1)
    p_start = out_start[sid]
    p_ll = lit_len[sid]
    p_llb = llb[sid]
    p_ml = match_len[sid]
    p_mlb = mlb[sid]
    p_off = offset[sid]
    p_lsrc = lit_start[sid]

    u = t - p_start
    lit0 = 1 + p_llb
    off0 = lit0 + p_ll
    mlx0 = off0 + 2

    tok_l = jnp.minimum(p_ll, 15)
    tok_m = jnp.where(p_ml > 0, jnp.minimum(p_ml - MIN_MATCH, 15), 0)
    token = (tok_l << 4) | tok_m

    # LSIC bytes: all 255 except the last
    lrem = p_ll - 15 - 255 * (p_llb - 1)
    lit_ext = jnp.where(u - 1 < p_llb - 1, 255, lrem)
    mrem = p_ml - MIN_MATCH - 15 - 255 * (p_mlb - 1)
    m_ext = jnp.where(u - mlx0 < p_mlb - 1, 255, mrem)

    lit_byte = data[jnp.clip(p_lsrc + (u - lit0), 0, data.shape[-1] - 1)]
    off_byte = jnp.where(u == off0, p_off & 0xFF, (p_off >> 8) & 0xFF)

    val = jnp.where(
        u == 0,
        token,
        jnp.where(
            u < lit0,
            lit_ext,
            jnp.where(
                u < off0,
                lit_byte.astype(jnp.int32),
                jnp.where(u < mlx0, off_byte, m_ext),
            ),
        ),
    )
    out = jnp.where((t < total) & (sid >= 0), val, 0).astype(jnp.uint8)
    return out, total


# --------------------------------------------------------------------------
# decompression
# --------------------------------------------------------------------------


def _delimit(comp, comp_len, out_cap: int, s_max: int, unroll: int | None = None):
    """Sequence boundaries: batched while_loop, ``unroll`` sequences per
    iteration (default: _delimit_unroll())."""
    unroll = unroll or _delimit_unroll()
    c = comp.shape[-1]
    i = jnp.arange(c, dtype=jnp.int32)
    cb = comp.astype(jnp.int32)
    # dense LSIC helpers: 255-run lengths and terminator values
    nn = lz77.rev_cummin(jnp.where(cb != 255, i, _INF))
    nn = jnp.minimum(nn, c - 1)
    run255 = nn - i
    term = cb[nn]
    ext_total = 255 * run255 + term  # value added beyond the nibble's 15
    ext_bytes = run255 + 1

    last = c - 1
    # packed parse tables, precomputed elementwise so each step costs 3
    # gathers (token-side, offset, matchlen-side) instead of 7:
    #   tok_tbl[p] = token | litlen_ext_bytes(p+1) << 8 | litlen_full(p) << 18
    #   off_tbl[q] = u16 offset at q
    #   mx_tbl[q]  = matchlen_ext_bytes(q+2) | matchlen_ext_total(q+2) << 9
    eb1 = jnp.roll(ext_bytes, -1)
    et1 = jnp.roll(ext_total, -1)
    tok = cb
    lnib_all = tok >> 4
    ll_full_all = jnp.where(lnib_all == 15, 15 + et1, lnib_all)
    lb_all = jnp.where(lnib_all == 15, eb1, 0)
    tok_tbl = tok | (lb_all << 8)
    off_tbl = cb | (jnp.roll(cb, -1) << 8)
    mx_tbl = jnp.roll(ext_bytes, -2) | (jnp.roll(ext_total, -2) << 9)

    # one row per sequence: (lit_src, lit_len, out_start, match_len, offset)
    seqs = jnp.zeros((s_max, 5), jnp.int32)

    def step(carry):
        p, o, s, done, ok, rows = carry
        pc = jnp.clip(p, 0, last)
        ti = tok_tbl[pc]
        token = ti & 0xFF
        lb = (ti >> 8) & 0x3FF
        llen = ll_full_all[pc]
        src = p + 1 + lb
        q = src + llen
        is_last = q >= comp_len
        off = off_tbl[jnp.clip(q, 0, last)]
        mnib = token & 15
        has_m = mnib == 15
        mi = mx_tbl[jnp.clip(q, 0, last)]
        mb = jnp.where(has_m, mi & 0x1FF, 0)
        mlen = jnp.where(
            is_last, 0, MIN_MATCH + jnp.where(has_m, 15 + (mi >> 9), mnib)
        )
        step_ok = q <= comp_len  # literals in bounds
        step_ok &= is_last | ((off >= 1) & (off <= o + llen))
        step_ok &= is_last | (q + 2 + mb <= comp_len)  # offset+ext in bounds
        o2 = o + llen + mlen
        step_ok &= o2 <= out_cap
        row = jnp.stack([src, llen, o, mlen, off])
        rows = rows.at[jnp.where(done, s_max, s)].set(row, mode="drop")
        p2 = jnp.where(is_last, comp_len, q + 2 + mb)
        ok2 = ok & (done | step_ok)
        return (
            jnp.where(done, p, p2),
            jnp.where(done, o, o2),
            jnp.where(done, s, s + 1),
            done | is_last | ~step_ok,
            ok2,
            rows,
        )

    def body(carry):
        for _ in range(unroll):
            carry = step(carry)
        return carry

    def cond(carry):
        p, o, s, done, ok, rows = carry
        return ~done & (s < s_max)

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0), comp_len <= 0, comp_len >= 0, seqs)
    p, o, s, done, ok, seqs = jax.lax.while_loop(cond, body, init)
    ok &= done  # ran off s_max without terminating -> corrupt
    arrays = (seqs[:, 0], seqs[:, 1], seqs[:, 2], seqs[:, 3], seqs[:, 4])
    return arrays, s, o, ok


# --------------------------------------------------------------------------
# public batched API
# --------------------------------------------------------------------------


# Stages are jitted separately: one fused program for the whole codec makes
# XLA's compile time explode (sort + two while loops + emission); staged
# jits compile in bounded time, hit the persistent cache, and add only
# ~ms of dispatch.

@functools.partial(jax.jit, static_argnames=("stride",))
def _jit_match(data, lengths, stride: int = 1):
    return jax.vmap(
        lambda d, n: (lambda j: lz77.match_lengths(d, n, j, MAX_OFFSET))(
            lz77.nearest_prev_occurrence(d, n, stride)
        )
    )(data, lengths)


@functools.partial(jax.jit, static_argnames=("s_max",))
def _jit_parse(mlen, dist, cand, lengths, s_max):
    return jax.vmap(lambda m, dd, cc, n: _greedy_parse(m, dd, cc, n, s_max))(
        mlen, dist, cand, lengths
    )


@functools.partial(jax.jit, static_argnames=("out_max",))
def _jit_emit(data, ls, ll, ml, off, s, lengths, out_max):
    out, total = jax.vmap(
        lambda d, a1, a2, a3, a4, ss: _emit(d, a1, a2, a3, a4, ss, out_max)
    )(data, ls, ll, ml, off, s)
    total = jnp.where(lengths > 0, total, 0)
    return out, total.astype(jnp.int32)


def compress(data, lengths, opts=None):
    """Batched LZ4 compression.  data: uint8[B, C]; lengths: int32[B].
    Returns (comp uint8[B, CMAX], comp_sizes int32[B]).

    ``opts.data_type`` sets the match-finder granularity (element-aligned
    match starts/offsets for 2/4-byte types), mirroring the reference's
    typed kernel dispatch (src/lowlevel/LZ4CompressionKernels.hip:185-219);
    streams are valid LZ4 blocks for any setting.
    """
    from tpucomp.core.types import width_of

    c = data.shape[-1]
    out_max = lz4_max_compressed_chunk_size(c)
    s_max = c // MIN_MATCH + 2
    stride = width_of(opts.data_type) if opts is not None else 1
    lengths = lengths.astype(jnp.int32)
    mlen, dist, cand = _jit_match(data, lengths, stride)
    ls, ll, ml, off, s = _jit_parse(mlen, dist, cand, lengths, s_max)
    return _jit_emit(data, ls, ll, ml, off, s, lengths, out_max)


@functools.partial(jax.jit, static_argnames=("out_cap", "s_max"))
def _jit_delimit(comp, comp_sizes, out_cap, s_max):
    return jax.vmap(lambda d, n: _delimit(d, n, out_cap, s_max))(
        comp, comp_sizes.astype(jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _jit_materialize(comp, seqs, s, total, ok, out_cap):
    out = jax.vmap(lambda d, sq, ss, tt: lz77.materialize(d, sq, tt, out_cap, num_seqs=ss))(
        comp, seqs, s, total
    )
    out = jnp.where(ok[:, None], out, 0).astype(jnp.uint8)
    total = jnp.where(ok, total, 0).astype(jnp.int32)
    status = jnp.where(
        ok, jnp.int32(int(Status.SUCCESS)), jnp.int32(int(Status.ERROR_CANNOT_DECOMPRESS))
    )
    return out, total, status


def decompress(comp, comp_sizes, opts=None, out_capacity: int = 65536):
    """Batched LZ4 decompression.
    Returns (data uint8[B, out_capacity], lengths int32[B], statuses).
    """
    s_max = comp.shape[-1] // 3 + 2
    seqs, s, total, ok = _jit_delimit(comp, comp_sizes, out_capacity, s_max)
    return _jit_materialize(comp, seqs, s, total, ok, out_capacity)


def get_decompress_size(comp, comp_sizes, opts=None, out_capacity: int = 1 << 24):
    s_max = comp.shape[-1] // 3 + 2
    _, _, total, ok = _jit_delimit(comp, comp_sizes, out_capacity, s_max)
    return jnp.where(ok, total, 0).astype(jnp.int32)
