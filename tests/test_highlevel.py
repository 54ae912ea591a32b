"""High-level manager tests.

Mirrors the reference HLIF tier (tests/test_lz4.cpp:93-276,
test_cascaded.cpp): manager round-trips across formats, tiny/unaligned/
multi-chunk buffers, format auto-detection via create_manager, header
invariants, and the NotSupported stubs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import Status
from tpucomp.highlevel import headers as hdr
from tpucomp.highlevel.manager import (
    CascadedManager,
    LZ4Manager,
    SnappyManager,
    create_manager,
)
from tpucomp.lowlevel import stubs


def _mk_payload(rng, n):
    return np.repeat(rng.integers(0, 40, n), rng.integers(1, 9, n))[:n].astype(np.uint8).tobytes()


MANAGERS = [
    lambda: LZ4Manager(uncomp_chunk_size=4096),
    lambda: SnappyManager(uncomp_chunk_size=4096),
    lambda: CascadedManager(uncomp_chunk_size=4096),
]


@pytest.mark.parametrize("mk", MANAGERS)
def test_manager_roundtrip(rng, mk):
    mgr = mk()
    payload = _mk_payload(rng, 20000)  # multi-chunk, unaligned tail
    cfg = mgr.configure_compression(len(payload))
    assert cfg.num_chunks == 5
    artifact, size = mgr.compress(payload)
    assert size <= cfg.max_compressed_buffer_size
    assert mgr.get_compressed_output_size(artifact) == size

    dcfg = mgr.configure_decompression(artifact)
    assert dcfg.decomp_data_size == len(payload)
    assert dcfg.num_chunks == 5
    out, statuses = mgr.decompress(artifact)
    assert (np.asarray(statuses) == Status.SUCCESS).all()
    assert np.asarray(out).tobytes() == payload


@pytest.mark.parametrize("mk", MANAGERS)
def test_create_manager_autodetect(rng, mk):
    mgr = mk()
    payload = _mk_payload(rng, 9000)
    artifact, _ = mgr.compress(payload)
    # a fresh manager reconstructed only from the artifact
    mgr2 = create_manager(artifact)
    assert type(mgr2) is type(mgr)
    assert mgr2.uncomp_chunk_size == mgr.uncomp_chunk_size
    out, statuses = mgr2.decompress(artifact)
    assert (np.asarray(statuses) == Status.SUCCESS).all()
    assert np.asarray(out).tobytes() == payload


def test_header_fields(rng):
    mgr = LZ4Manager(uncomp_chunk_size=4096)
    payload = _mk_payload(rng, 10000)
    artifact, size = mgr.compress(payload)
    head = hdr.CommonHeader.unpack(np.asarray(artifact[:64]).tobytes())
    assert head.magic_number == 0 and (head.major_version, head.minor_version) == (2, 2)
    assert head.format == hdr.FORMAT_LZ4
    assert head.decomp_data_size == 10000
    assert head.num_chunks == 3
    assert head.uncomp_chunk_size == 4096
    assert head.comp_data_offset == hdr.data_region_offset(hdr.FORMAT_LZ4, 3)
    assert head.comp_data_offset + head.comp_data_size == size
    # chunk offsets ascend from 0 and sizes are consistent
    sec = hdr.sections_offset(hdr.FORMAT_LZ4)
    raw = np.asarray(artifact[sec : sec + 48])
    offs = raw[:24].view("<u8")
    szs = raw[24:48].view("<u8")
    assert offs[0] == 0
    assert (offs[1:] == np.cumsum(szs)[:-1]).all()
    assert offs[-1] + szs[-1] == head.comp_data_size


@pytest.mark.parametrize("n", [1, 5, 4095, 4096, 4097])
def test_tiny_and_boundary_sizes(rng, n):
    mgr = SnappyManager(uncomp_chunk_size=4096)
    payload = bytes(rng.integers(0, 5, n).astype(np.uint8))
    artifact, _ = mgr.compress(payload)
    out, statuses = mgr.decompress(artifact)
    assert (np.asarray(statuses) == Status.SUCCESS).all()
    assert np.asarray(out).tobytes() == payload


def test_cascaded_manager_opts_roundtrip(rng):
    opts = CascadedOpts(chunk_size=2048, num_rles=1, num_deltas=1, use_bp=True)
    mgr = CascadedManager(uncomp_chunk_size=8192, opts=opts)
    payload = np.repeat(rng.integers(0, 100, 3000), 4)[:3000].astype(np.int32).tobytes()
    artifact, _ = mgr.compress(payload)
    mgr2 = create_manager(artifact)
    assert mgr2.opts == opts
    out, statuses = mgr2.decompress(artifact)
    assert np.asarray(out).tobytes() == payload


def test_not_supported_stubs():
    for codec in [stubs.ANS, stubs.GDEFLATE, stubs.BITCOMP]:
        with pytest.raises(stubs.NotSupportedError):
            codec.compress(None, None)
        with pytest.raises(stubs.NotSupportedError):
            codec.get_decompress_size(None, None)
    assert stubs.NotSupportedError.status == Status.ERROR_NOT_SUPPORTED


def test_unknown_format_rejected(rng):
    mgr = LZ4Manager(uncomp_chunk_size=4096)
    artifact, _ = mgr.compress(_mk_payload(rng, 100))
    bad = np.asarray(artifact).copy()
    bad[6] = hdr.FORMAT_GDEFLATE  # format byte
    with pytest.raises(ValueError):
        create_manager(jnp.asarray(bad))


def test_header_golden_bytes():
    """Frozen CommonHeader byte layout (regression guard for the
    reference-struct compatibility, hlif_shared_types.hpp:66-82)."""
    h = hdr.CommonHeader(
        format=hdr.FORMAT_CASCADED,
        comp_data_size=0x1122334455,
        decomp_data_size=0x66778899,
        num_chunks=7,
        uncomp_chunk_size=65536,
        comp_data_offset=0x58,
    )
    raw = h.pack()
    assert len(raw) == 64
    golden = (
        b"\x00\x00\x00\x00"          # magic
        b"\x02\x02\x04\x00"          # major, minor, format, pad
        b"\x55\x44\x33\x22\x11\x00\x00\x00"  # comp_data_size
        b"\x99\x88\x77\x66\x00\x00\x00\x00"  # decomp_data_size
        b"\x07\x00\x00\x00\x00\x00\x00\x00"  # num_chunks
        b"\x01\x00\x00\x00"          # include_chunk_starts + pad
        b"\x00\x00\x00\x00" b"\x00\x00\x00\x00"  # checksums (reserved)
        b"\x00\x00\x00\x00"          # per-chunk checksum flags + pad
        b"\x00\x00\x01\x00\x00\x00\x00\x00"  # uncomp_chunk_size (65536)
        b"\x58\x00\x00\x00\x00\x00\x00\x00"  # comp_data_offset + pad
    )
    assert raw == golden
    back = hdr.CommonHeader.unpack(raw)
    assert back == h


def test_wide_placement_bit_identical(rng):
    """The int64 ("wide", >= 1 GiB artifacts) assembly path must produce
    the exact bytes of the int32 path -- verified at small scale by forcing
    wide=True (the magnitude changes only index dtypes, not logic)."""
    from tpucomp.highlevel.manager import _assemble_artifact, LZ4Manager

    m = LZ4Manager(1024)
    data = np.repeat(rng.integers(0, 30, 6000), 2)[:6000].astype(np.uint8)
    # reproduce Manager.compress up to assembly, then A/B the wide flag
    n = data.size
    cfg = m.configure_compression(n)
    k, cs = cfg.num_chunks, m.uncomp_chunk_size
    padded = jnp.zeros((k * cs,), jnp.uint8).at[:n].set(jnp.asarray(data))
    lengths = jnp.clip(n - jnp.arange(k, dtype=jnp.int32) * cs, 0, cs).astype(jnp.int32)
    comp, sizes = m._codec_compress(padded.reshape(k, cs), lengths)
    common = hdr.CommonHeader(
        format=m.format_id, comp_data_size=0, decomp_data_size=n, num_chunks=k,
        uncomp_chunk_size=cs, comp_data_offset=hdr.data_region_offset(m.format_id, k),
    )
    head = bytearray(common.pack())
    head += hdr.pack_format_spec(m.format_id, m.opts)
    head += b"\x00" * (hdr.sections_offset(m.format_id) - len(head))
    static_head = jnp.asarray(np.frombuffer(bytes(head), np.uint8))
    kw = dict(data_off=common.comp_data_offset,
              sections_off=hdr.sections_offset(m.format_id),
              out_max=cfg.max_compressed_buffer_size)
    a32, s32 = _assemble_artifact(comp, sizes, static_head, wide=False, **kw)
    a64, s64 = _assemble_artifact(comp, sizes, static_head, wide=True, **kw)
    assert int(s32) == int(s64)
    assert (np.asarray(a32) == np.asarray(a64)).all()


def test_wide_artifact_requires_x64():
    """>= 1 GiB artifact bounds demand x64 placement with a clear error
    when it is off (reference u64 tables are uncapped)."""
    import jax
    from tpucomp.highlevel.manager import LZ4Manager

    m = LZ4Manager(64 * 1024)
    with jax.enable_x64(False):
        with pytest.raises(ValueError, match="64-bit placement"):
            # 1.1 GiB logical size via a zero-stride view:
            # configure_compression math only -- the raise fires before any
            # buffer of that size is materialized
            big = np.lib.stride_tricks.as_strided(
                np.zeros(1, np.uint8), shape=(1_200_000_000,), strides=(0,)
            )
            m.compress(big)
