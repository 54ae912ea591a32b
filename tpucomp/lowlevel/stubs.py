"""ANS / GDeflate / Bitcomp API slots.

These algorithms live in external proprietary nvCOMP extension libraries
that the reference merely wraps; when absent, every entry point returns
hipcompErrorNotSupported (reference src/lowlevel/ansBatch.cpp:67-246,
gdeflateBatch.cpp:67-293, BitcompBatch.hip:55-300; README.md:6-7).  The
framework exposes the same slots with the same behavior.
"""

from __future__ import annotations

import dataclasses

from tpucomp.core.types import Status


class NotSupportedError(NotImplementedError):
    """Raised by stub codecs; carries the reference-compatible status."""

    status = Status.ERROR_NOT_SUPPORTED


@dataclasses.dataclass(frozen=True)
class GdeflateOpts:
    """reference include/hipcomp/gdeflate.h:72-80"""

    algo: int = 0  # 0: high-throughput, 1: high-compression, 2: entropy-only


@dataclasses.dataclass(frozen=True)
class BitcompOpts:
    """reference include/hipcomp/bitcomp.h:69-74,210-218"""

    algorithm_type: int = 0  # 0: default, 1: sparse
    data_type: int = 0


@dataclasses.dataclass(frozen=True)
class AnsOpts:
    reserved: int = 0


class _StubCodec:
    def __init__(self, name: str, default_opts):
        self.name = name
        self.default_opts = default_opts

    def _raise(self):
        raise NotSupportedError(
            f"{self.name} requires a proprietary extension library in the reference "
            "and has no open implementation to mirror (reference README.md:6-7)"
        )

    def compress_get_temp_size(self, *a, **k):
        self._raise()

    def compress_get_max_output_chunk_size(self, *a, **k):
        self._raise()

    def compress(self, *a, **k):
        self._raise()

    def decompress_get_temp_size(self, *a, **k):
        self._raise()

    def decompress(self, *a, **k):
        self._raise()

    def get_decompress_size(self, *a, **k):
        self._raise()


ANS = _StubCodec("ans", AnsOpts())
GDEFLATE = _StubCodec("gdeflate", GdeflateOpts())
BITCOMP = _StubCodec("bitcomp", BitcompOpts())
