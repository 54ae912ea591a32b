"""Every element type under every supported layer combination.

Each of the eight DataTypes x seven (num_rles, num_deltas, use_bp) layer
combinations must encode byte-identically to the sequential oracle.  This
is the check that catches a miscompiled narrow-integer reduction: such a
bug shows up as a raw fallback where the oracle compresses (see
ops/bitpack.for_bitwidth).  chip_smoke.py runs the same sweep on the GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpucomp.codecs import cascaded
from tpucomp.core.options import CascadedOpts
from tpucomp.core.types import DataType

from oracles.cascaded_oracle import cascaded_compress_oracle

NP_OF = {
    DataType.CHAR: np.int8,
    DataType.UCHAR: np.uint8,
    DataType.SHORT: np.int16,
    DataType.USHORT: np.uint16,
    DataType.INT: np.int32,
    DataType.UINT: np.uint32,
    DataType.LONGLONG: np.int64,
    DataType.ULONGLONG: np.uint64,
}

LAYERS = [
    (1, 0, True),
    (1, 1, True),
    (2, 0, True),
    (2, 1, True),
    (0, 1, True),
    (0, 2, True),
    (0, 0, False),
]

C = 8192


def _partitions(rng, dtype):
    """Runs of slowly varying values (the pipeline compresses), a noisy
    signed ramp (delta + bitpack bite, RLE does not), and random bytes (raw
    fallback)."""
    n = C // np.dtype(dtype).itemsize
    info = np.iinfo(dtype)
    lo = max(int(info.min), -1000)
    vals = np.cumsum(rng.integers(-3, 4, n)) + rng.integers(lo, lo + 2000)
    runs = np.repeat(vals, rng.integers(1, 9, n))[:n]
    ramp = np.cumsum(rng.integers(-2, 3, n)) * 5 + rng.integers(0, 4, n) + lo + 500
    with np.errstate(over="ignore"):
        return [
            runs.astype(dtype).tobytes(),
            ramp.astype(dtype).tobytes(),
            rng.integers(0, 256, C, dtype=np.uint8).tobytes(),
        ]


@pytest.mark.parametrize("nr,nd,bp", LAYERS, ids=[f"r{a}d{b}{'bp' if c else ''}" for a, b, c in LAYERS])
@pytest.mark.parametrize("dt", list(NP_OF), ids=[d.name for d in NP_OF])
def test_dtype_layers_match_oracle(rng, dt, nr, nd, bp):
    dtype = NP_OF[dt]
    opts = CascadedOpts(chunk_size=4096, type=dt, num_rles=nr, num_deltas=nd, use_bp=bp)
    parts = _partitions(rng, dtype)
    data = np.stack([np.frombuffer(p, np.uint8) for p in parts])
    lengths = np.full((len(parts),), C, np.int32)
    lengths[1] -= 8  # a partition whose last chunk is short
    comp, sizes = map(
        np.asarray, cascaded.compress(jnp.asarray(data), jnp.asarray(lengths), opts)
    )
    for i, p in enumerate(parts):
        exp = cascaded_compress_oracle(p[: lengths[i]], dtype, 4096, nr, nd, bp)
        assert comp[i, : sizes[i]].tobytes() == exp, f"partition {i}"
    if (nr, nd, bp) != (0, 0, False):
        assert comp[0, :3].any(), "runs partition fell back: the pipeline did not compress"
