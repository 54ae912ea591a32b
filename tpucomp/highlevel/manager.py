"""High-level interface ("HLIF" equivalent): managers over one contiguous
buffer producing self-describing artifacts.

JAX counterpart of hipcompManagerBase / ManagerBase / BatchManager
(reference include/hipcomp/hipcompManager.hpp:141-236,
src/highlevel/ManagerBase.hpp:80-326, BatchManager.hpp:71-331):

  - configure_compression / compress / configure_decompression /
    decompress / get_compressed_output_size mirror the manager API
  - the buffer is chunked at ``uncomp_chunk_size``; chunks batch-compress
    through the low-level codec, and outputs pack gaplessly via an
    exclusive cumsum -- deterministic chunk order, unlike the reference's
    atomicAdd packing (src/hipcomp_common_deps/hlif_shared.hiph:203-210)
  - scratch buffers disappear (XLA owns scratch);
    get_required_scratch_buffer_size reports 0 and set_scratch_buffer is a
    no-op, mirroring the optional-scratch contract
  - headers (CommonHeader + FormatSpecHeader + offset/size/checksum
    sections) are byte-compatible with the reference; see headers.py

Device data stays on device: compress/decompress accept and return JAX
uint8 arrays (or host bytes, converted at the edge).  Checksum fields are
reserved-zero exactly like the reference (hlif_shared.hiph:119-126).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpucomp.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp.core.sizing import (
    cascaded_max_compressed_chunk_size,
    lz4_max_compressed_chunk_size,
    round_up_to,
    snappy_max_compressed_chunk_size,
)
from tpucomp.core.types import Status
from tpucomp.highlevel import headers as hdr
from tpucomp.utils import bits, permute


@dataclasses.dataclass
class CompressionConfig:
    uncompressed_buffer_size: int
    num_chunks: int
    max_compressed_buffer_size: int


@dataclasses.dataclass
class DecompressionConfig:
    decomp_data_size: int
    num_chunks: int


class Manager:
    """Base manager; subclasses bind a format id, codec and options."""

    format_id: int

    def __init__(self, uncomp_chunk_size: int, opts):
        self.uncomp_chunk_size = int(uncomp_chunk_size)
        self.opts = opts

    # ---- format-specific hooks
    def _codec_compress(self, data, lengths):
        raise NotImplementedError

    def _codec_decompress(self, comp, sizes, out_capacity):
        raise NotImplementedError

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        raise NotImplementedError

    # ---- manager API (reference hipcompManager.hpp:141-236)
    def get_required_scratch_buffer_size(self) -> int:
        return 0

    def set_scratch_buffer(self, _buffer) -> None:
        pass

    def configure_compression(self, uncomp_size: int) -> CompressionConfig:
        num_chunks = max(1, -(-uncomp_size // self.uncomp_chunk_size))
        max_chunk = self._max_comp_chunk_size(self.uncomp_chunk_size)
        total = hdr.data_region_offset(self.format_id, num_chunks) + num_chunks * max_chunk
        return CompressionConfig(uncomp_size, num_chunks, total)

    def compress(self, data) -> tuple[jax.Array, int]:
        """Compress one contiguous buffer into a self-describing artifact.

        ``data``: bytes or uint8 array.  Returns (artifact uint8[max_size],
        actual_size).
        """
        if isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(data, np.uint8)
        n = int(np.prod(data.shape)) if hasattr(data, "shape") else len(data)
        cfg = self.configure_compression(n)
        cs = self.uncomp_chunk_size
        k = cfg.num_chunks

        # int32 placement (and its 2^30 sort sentinel) covers artifacts
        # under 1 GiB; larger ones switch to int64 placement, which needs
        # x64 mode (the header format itself is u64 and uncapped, matching
        # the reference's u64 tables, src/highlevel/BatchManager.hpp:212-236)
        wide = cfg.max_compressed_buffer_size >= 2**30
        if wide and not jax.config.jax_enable_x64:
            raise ValueError(
                f"compressed buffer bound {cfg.max_compressed_buffer_size} "
                "needs 64-bit placement for >= 1 GiB artifacts: set "
                "jax.config.update('jax_enable_x64', True) (or split the input)"
            )
        data = jnp.asarray(data, jnp.uint8).reshape(-1)
        padded = jnp.zeros((k * cs,), jnp.uint8).at[:n].set(data)
        chunks = padded.reshape(k, cs)
        lengths = jnp.clip(
            n - jnp.arange(k, dtype=jnp.int32) * cs, 0, cs
        ).astype(jnp.int32)
        comp, sizes = self._codec_compress(chunks, lengths)

        # static header prefix: everything except comp_data_size and the
        # chunk offset/size tables, which are written on device below
        # (reference fills the header device-side too, hlif_shared.hiph:113-130)
        common = hdr.CommonHeader(
            format=self.format_id,
            comp_data_size=0,
            decomp_data_size=n,
            num_chunks=k,
            uncomp_chunk_size=cs,
            comp_data_offset=hdr.data_region_offset(self.format_id, k),
        )
        head = bytearray(common.pack())
        head += hdr.pack_format_spec(self.format_id, self.opts)
        head += b"\x00" * (hdr.sections_offset(self.format_id) - len(head))
        static_head = jnp.asarray(np.frombuffer(bytes(head), np.uint8))

        artifact, total_size = _assemble_artifact(
            comp,
            sizes,
            static_head,
            data_off=common.comp_data_offset,
            sections_off=hdr.sections_offset(self.format_id),
            out_max=cfg.max_compressed_buffer_size,
            wide=wide,
        )
        return artifact, total_size

    def configure_decompression(self, artifact) -> DecompressionConfig:
        head = np.asarray(jax.device_get(artifact[: hdr.COMMON_HEADER_SIZE]))
        common = hdr.CommonHeader.unpack(head.tobytes())
        return DecompressionConfig(common.decomp_data_size, common.num_chunks)

    def decompress(self, artifact):
        """Returns (data uint8[decomp_size], statuses int32[num_chunks])."""
        head = np.asarray(jax.device_get(artifact[: hdr.COMMON_HEADER_SIZE]))
        common = hdr.CommonHeader.unpack(head.tobytes())
        k = common.num_chunks
        cs = common.uncomp_chunk_size
        sec = hdr.sections_offset(self.format_id)
        sec_bytes = np.asarray(jax.device_get(artifact[sec : sec + 16 * k]))
        offsets = sec_bytes[: 8 * k].view("<u8").astype(np.int64)
        sizes = sec_bytes[8 * k : 16 * k].view("<u8").astype(np.int64)
        data_off = common.comp_data_offset

        max_chunk = self._max_comp_chunk_size(cs)
        # slice each chunk's stream out of the packed region (one gather);
        # int64 offsets once the packed region can pass the int32 range
        wide = int(offsets.max(initial=0)) + data_off + max_chunk >= 2**30
        idt = jnp.int64 if wide else jnp.int32
        if wide and not jax.config.jax_enable_x64:
            raise ValueError(
                ">= 1 GiB artifact needs 64-bit mode to decompress: set "
                "jax.config.update('jax_enable_x64', True)"
            )
        t = jnp.arange(max_chunk, dtype=idt)
        src = data_off + jnp.asarray(offsets, idt)[:, None] + t[None, :]
        take = t[None, :] < jnp.asarray(sizes, idt)[:, None]
        flat = artifact
        rows = jnp.where(
            take, flat[jnp.clip(src, 0, flat.shape[0] - 1)], 0
        ).astype(jnp.uint8)

        out, lens, statuses = self._codec_decompress(
            rows, jnp.asarray(sizes, jnp.int32), cs
        )
        data = out.reshape(-1)[: common.decomp_data_size]
        return data, statuses

    def get_compressed_output_size(self, artifact) -> int:
        head = np.asarray(jax.device_get(artifact[: hdr.COMMON_HEADER_SIZE]))
        common = hdr.CommonHeader.unpack(head.tobytes())
        return common.comp_data_offset + common.comp_data_size


class LZ4Manager(Manager):
    format_id = hdr.FORMAT_LZ4

    def __init__(self, uncomp_chunk_size: int = 65536, opts: LZ4Opts | None = None):
        super().__init__(uncomp_chunk_size, opts or LZ4Opts())

    def _codec_compress(self, data, lengths):
        from tpucomp.codecs import lz4

        return lz4.compress(data, lengths)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp.codecs import lz4

        return lz4.decompress(comp, sizes, out_capacity=out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return lz4_max_compressed_chunk_size(chunk_bytes)


class SnappyManager(Manager):
    format_id = hdr.FORMAT_SNAPPY

    def __init__(self, uncomp_chunk_size: int = 65536, opts: SnappyOpts | None = None):
        super().__init__(uncomp_chunk_size, opts or SnappyOpts())

    def _codec_compress(self, data, lengths):
        from tpucomp.codecs import snappy

        return snappy.compress(data, lengths)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp.codecs import snappy

        return snappy.decompress(comp, sizes, out_capacity=out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return snappy_max_compressed_chunk_size(chunk_bytes)


class CascadedManager(Manager):
    format_id = hdr.FORMAT_CASCADED

    def __init__(self, uncomp_chunk_size: int = 4096, opts: CascadedOpts | None = None):
        opts = opts or CascadedOpts()
        # the manager chunk is the partition; the scheme's internal chunking
        # is opts.chunk_size (reference CascadedManager.hpp:65-150)
        super().__init__(uncomp_chunk_size, opts)

    def _codec_compress(self, data, lengths):
        from tpucomp.codecs import cascaded

        return cascaded.compress(data, lengths, self.opts)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp.codecs import cascaded

        return cascaded.decompress(comp, sizes, self.opts, out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return cascaded_max_compressed_chunk_size(chunk_bytes)


from functools import partial


@partial(jax.jit, static_argnames=("data_off", "sections_off", "out_max", "wide"))
def _assemble_artifact(
    comp, sizes, static_head, *, data_off, sections_off, out_max, wide=False
):
    """Assemble the self-describing artifact entirely on device.

    Writes comp_data_size into the CommonHeader (offset 8, u64 LE), the
    chunk offset/size tables (u64 LE each), and places the chunk payloads
    gaplessly after the header region — all as one async dispatch chain,
    mirroring the reference's device-side header fill
    (src/hipcomp_common_deps/hlif_shared.hiph:113-130) without the host
    sync the round-1 implementation had.

    ``wide`` switches placement indices and table math to int64 (requires
    x64 mode) so artifacts past the int32 sort-sentinel bound (>= 1 GiB)
    assemble correctly — the reference's u64 offset tables have no cap
    (src/highlevel/BatchManager.hpp:212-236).
    """
    k, s_max = comp.shape
    idt = jnp.int64 if wide else jnp.int32
    sizes = sizes.astype(idt)
    inc = jnp.cumsum(sizes)
    offsets = inc - sizes
    comp_data_size = inc[-1]

    def u64le(v):  # int[k] -> uint8[k,8] little-endian
        v = v.astype(jnp.uint64 if wide else jnp.uint32)
        n_b = 8 if wide else 4
        lo = jnp.stack(
            [((v >> v.dtype.type(8 * i)) & v.dtype.type(0xFF)).astype(jnp.uint8) for i in range(n_b)],
            axis=-1,
        )
        if n_b == 8:
            return lo
        return jnp.concatenate([lo, jnp.zeros(v.shape + (4,), jnp.uint8)], axis=-1)

    head = jnp.zeros((data_off,), jnp.uint8)
    head = head.at[: static_head.shape[0]].set(static_head)
    head = head.at[8:16].set(u64le(comp_data_size[None]).reshape(8))
    head = head.at[sections_off : sections_off + 8 * k].set(u64le(offsets).reshape(-1))
    head = head.at[sections_off + 8 * k : sections_off + 16 * k].set(u64le(sizes).reshape(-1))
    # per-chunk checksum sections (u32 x k x 2) stay reserved-zero

    # gapless deterministic payload packing via scatter-by-sort
    tgts = offsets[:, None] + jnp.arange(s_max, dtype=idt)[None, :]
    oks = jnp.arange(s_max, dtype=idt)[None, :] < sizes[:, None]
    payload_max = out_max - data_off
    vals = comp.reshape(-1)
    tgts = tgts.reshape(-1)
    oks = oks.reshape(-1)
    if vals.shape[0] < payload_max:
        pad = payload_max - vals.shape[0]
        vals = jnp.concatenate([vals, jnp.zeros((pad,), jnp.uint8)])
        tgts = jnp.concatenate([tgts, jnp.zeros((pad,), idt)])
        oks = jnp.concatenate([oks, jnp.zeros((pad,), jnp.bool_)])
    payload = permute.place(vals, tgts, oks, payload_max)

    artifact = jnp.concatenate([head, payload])
    return artifact, data_off + comp_data_size


def create_manager(artifact) -> Manager:
    """Instantiate the right manager from a self-describing artifact
    (reference src/highlevel/hipcompManagerFactory.cpp:64-146)."""
    head = np.asarray(jax.device_get(artifact[: hdr.COMMON_HEADER_SIZE + 24]))
    common = hdr.CommonHeader.unpack(head[: hdr.COMMON_HEADER_SIZE].tobytes())
    spec = head[hdr.COMMON_HEADER_SIZE :].tobytes()
    opts = hdr.unpack_format_spec(common.format, spec)
    if common.format == hdr.FORMAT_LZ4:
        return LZ4Manager(common.uncomp_chunk_size, opts)
    if common.format == hdr.FORMAT_SNAPPY:
        return SnappyManager(common.uncomp_chunk_size, opts)
    if common.format == hdr.FORMAT_CASCADED:
        return CascadedManager(common.uncomp_chunk_size, opts)
    raise ValueError(
        f"unsupported format {common.format} (ANS/GDeflate/Bitcomp are external "
        "proprietary extensions in the reference too; see tpucomp.lowlevel.stubs)"
    )
