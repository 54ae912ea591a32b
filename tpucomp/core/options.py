"""Per-codec option structs as frozen dataclasses.

JAX mirror of the reference's run-time option structs:
  - hipcompBatchedLZ4Opts_t      (reference include/hipcomp/lz4.h:79-84)
  - hipcompBatchedCascadedOpts_t (reference include/hipcomp/cascaded.h:90-125)
  - hipcompBatchedSnappyOpts_t   (reference include/hipcomp/snappy.h:62-67)

These are static (Python-level) configuration: under ``jax.jit`` they select
the compiled program, they are never traced.
"""

from __future__ import annotations

import dataclasses

from tpucomp.core.types import DataType, width_of
from tpucomp.core import sizing


@dataclasses.dataclass(frozen=True)
class LZ4Opts:
    """LZ4 codec options.

    ``data_type`` is a performance hint for the match finder granularity
    (reference CHANGELOG.md:42-44); output streams are valid LZ4 blocks for
    any setting.
    """

    data_type: DataType = DataType.UCHAR

    def validate(self) -> None:
        if width_of(self.data_type) not in (1, 2, 4):
            raise ValueError("LZ4 data_type must be 1, 2 or 4 bytes wide")


@dataclasses.dataclass(frozen=True)
class SnappyOpts:
    """Snappy codec options (reserved, mirrors the reference's empty struct)."""

    reserved: int = 0


@dataclasses.dataclass(frozen=True)
class CascadedOpts:
    """Cascaded scheme configuration.

    Defaults mirror the reference default {4096, INT, 2 RLEs, 1 delta,
    bitpack on} (reference include/hipcomp/cascaded.h:124-125).

    ``chunk_size`` is the internal chunk the scheme processes at a time
    (512..16384 bytes, multiple of the element width); a partition (= one
    batch entry) is split into such chunks.
    """

    chunk_size: int = 4096
    type: DataType = DataType.INT
    num_rles: int = 2
    num_deltas: int = 1
    use_bp: bool = True

    def validate(self) -> None:
        w = width_of(self.type)
        if w == 8:
            # 64-bit element types require x64 mode; without it JAX silently
            # downcasts uint64 to uint32 and the artifact is corrupt.
            import jax

            if not jax.config.jax_enable_x64:
                raise ValueError(
                    "cascaded LONGLONG/ULONGLONG element types require 64-bit "
                    "mode: set jax.config.update('jax_enable_x64', True) (or "
                    "JAX_ENABLE_X64=1) before compressing 8-byte elements"
                )
        if not (sizing.CASCADED_MIN_CHUNK <= self.chunk_size <= sizing.CASCADED_MAX_CHUNK):
            raise ValueError(
                f"cascaded chunk_size {self.chunk_size} outside "
                f"[{sizing.CASCADED_MIN_CHUNK}, {sizing.CASCADED_MAX_CHUNK}]"
            )
        if self.chunk_size % w != 0:
            raise ValueError("cascaded chunk_size must be a multiple of the element width")
        # Run counts are uint16 and bitpack stores element counts in 16 bits
        # (reference src/CascadedKernels.hiph:779-783).
        if self.chunk_size // w >= 65536:
            raise ValueError("cascaded chunk must hold < 65536 elements")
        if not (0 <= self.num_rles <= 7):
            # Max 7 RLE layers (reference src/CascadedKernels.hiph:1208-1209);
            # layer counts are stored in single header bytes.
            raise ValueError("num_rles must be in [0, 7]")
        if not (0 <= self.num_deltas <= 7):
            raise ValueError("num_deltas must be in [0, 7]")
        if 0 < self.num_rles < self.num_deltas:
            # The reference's decompression layer scheduling
            # (src/CascadedKernels.hiph:1333-1398) only inverts its
            # compression order (RLE before Delta within each layer,
            # :910-980) when num_deltas <= num_RLEs or num_RLEs == 0; other
            # combinations do not round-trip even in the reference.
            raise ValueError("num_deltas must be <= num_rles (or num_rles == 0)")

    @property
    def chunk_num_elements(self) -> int:
        return self.chunk_size // width_of(self.type)
