"""Spec-edge golden byte fixtures.

tests/fixtures/{lz4,snappy}_golden.json hold hand-assembled streams hitting
the format edges the reference's constants pin: LSIC 255-chain boundaries,
the 65535-offset ceiling, last-literal end rules (reference
src/LZ4Kernels.hiph:162,168-169), snappy copy4 tags and multi-byte literal
lengths the compressor never emits (the SnappyLargeTokens obligation,
reference src/test/SnappyLargeTokens_test.cpp).  The bytes are COMMITTED --
decoders are checked against the spec itself, not against our oracles.
Every case decodes as one batch through the codec module, and again on its
own through the low-level batch API (the LLIF a user calls).
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from tpucomp.core.types import Status

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    with open(os.path.join(FIXDIR, f"{name}_golden.json")) as f:
        cases = json.load(f)
    return [
        (k, bytes.fromhex(v["stream"]), bytes.fromhex(v["out"]))
        for k, v in sorted(cases.items())
    ]


def _batchify(streams, pad=8):
    cmax = max(len(s) for s in streams) + pad
    comp = np.zeros((len(streams), cmax), np.uint8)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
    sizes = np.array([len(s) for s in streams], np.int32)
    return jnp.asarray(comp), jnp.asarray(sizes)


def _check(outs, lens, sts, cases):
    outs, lens, sts = map(np.asarray, (outs, lens, sts))
    for i, (name, _, expect) in enumerate(cases):
        assert sts[i] == int(Status.SUCCESS), (name, sts[i])
        assert lens[i] == len(expect), (name, lens[i], len(expect))
        got = outs[i, : lens[i]].tobytes()
        assert got == expect, (
            name,
            next(j for j in range(len(expect)) if got[j] != expect[j]),
        )


@pytest.fixture(scope="module")
def lz4_cases():
    return _load("lz4")


@pytest.fixture(scope="module")
def snappy_cases():
    return _load("snappy")


def test_lz4_golden_xla(lz4_cases):
    from tpucomp.codecs import lz4

    cap = max(len(e) for _, _, e in lz4_cases)
    comp, sizes = _batchify([s for _, s, _ in lz4_cases])
    out, lens, sts = lz4.decompress(comp, sizes, out_capacity=cap)
    _check(out, lens, sts, lz4_cases)
    # size query agrees with the golden lengths
    got = np.asarray(lz4.get_decompress_size(comp, sizes, out_capacity=cap))
    assert (got == np.array([len(e) for _, _, e in lz4_cases])).all()


def test_snappy_golden_xla(snappy_cases):
    from tpucomp.codecs import snappy

    cap = max(len(e) for _, _, e in snappy_cases)
    comp, sizes = _batchify([s for _, s, _ in snappy_cases])
    out, lens, sts = snappy.decompress(comp, sizes, out_capacity=cap)
    _check(out, lens, sts, snappy_cases)
    got = np.asarray(snappy.get_decompress_size(comp, sizes))
    assert (got == np.array([len(e) for _, _, e in snappy_cases])).all()


@pytest.mark.parametrize(
    "fmt,case",
    [("lz4", k) for k, _, _ in _load("lz4")] + [("snappy", k) for k, _, _ in _load("snappy")],
)
def test_golden_case_llif(fmt, case):
    """Each golden stream on its own through the LLIF (one compiled program
    per format: every case is padded to the format's widest stream)."""
    from tpucomp import lz4_codec, snappy_codec
    from tpucomp.core.chunking import ChunkBatch

    codec = {"lz4": lz4_codec, "snappy": snappy_codec}[fmt]
    cases = _load(fmt)
    cap = max(len(e) for _, _, e in cases)
    width = max(len(st) for _, st, _ in cases) + 8
    (name, stream, expect), = [c for c in cases if c[0] == case]
    comp = np.zeros((1, width), np.uint8)
    comp[0, : len(stream)] = np.frombuffer(stream, np.uint8)
    sizes = jnp.asarray([len(stream)], jnp.int32)
    out, sts = codec.decompress(ChunkBatch(jnp.asarray(comp), sizes), cap)
    _check(out.data, out.lengths, sts, [(name, stream, expect)])


def test_fixtures_pinned():
    """The committed bytes reproduce under the generator (provenance)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_golden_fixtures",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "make_golden_fixtures.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, build in (("lz4", mod.build_lz4_cases), ("snappy", mod.build_snappy_cases)):
        pinned = json.load(open(os.path.join(FIXDIR, f"{name}_golden.json")))
        fresh = build()
        assert pinned == fresh, f"{name} fixtures drifted from the generator"
