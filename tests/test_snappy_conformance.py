"""Snappy conformance across chunk sizes and data (see
test_lz_conformance.py): LLIF streams decode with the oracle, stay within
the reference's bound, and round-trip through the batch decoder."""

import pytest

from tpucomp import snappy_codec
from tpucomp.core.options import SnappyOpts

from oracles.snappy_oracle import snappy_decompress_oracle
from test_lz_conformance import PROFILES, SIZES, _check


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("c", SIZES)
def test_snappy_chunks_decode_with_oracle(c, profile):
    _check(snappy_codec, snappy_decompress_oracle, SnappyOpts(), profile, c, seed=c)
