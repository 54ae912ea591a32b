"""Smoke tests of the benchmark harness (bench.py).

The headline numbers come from bench.py; these tests pin its measurement
path (single-dispatch lax.map tiling, round-trip verification, ratio
accounting, the peak table and the compile cache) on tiny inputs so harness
regressions cannot silently corrupt the recorded numbers.  Absolute GB/s
on the CPU backend are meaningless and not asserted.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench


def test_corpus_deterministic_and_sized():
    a = bench.load_corpus(1 << 20)
    b = bench.load_corpus(1 << 20)
    assert a == b and len(a) == 1 << 20
    # seed rotation decorrelates without changing content length
    c = bench.load_corpus(1 << 20, seed=1)
    assert len(c) == 1 << 20 and c != a


def test_bench_cascaded_roundtrip_smoke():
    r = bench.bench_cascaded(total_mb=1, iters=1, tile=8)
    assert r["roundtrip_ok"] is True
    assert r["encode_gbps"] > 0 and r["decode_gbps"] > 0
    assert r["ratio"] > 0.9  # worst case bounded near 1 by the raw fallback


@pytest.mark.slow
def test_bench_lz_roundtrip_smoke():
    r = bench.bench_lz("lz4", total_mb=1, iters=1, tile=8)
    assert r["roundtrip_ok"] is True
    assert r["ratio"] > 1.0
    r = bench.bench_lz("snappy", total_mb=1, iters=1, tile=8)
    assert r["roundtrip_ok"] is True


def test_bench_cascaded_runheavy_smoke():
    # the run-heavy slice must actually engage the RLE/Delta/BP pipeline:
    # ratio well above the raw-copy fallback's ~1.0
    r = bench.bench_cascaded(total_mb=1, iters=1, tile=8, corpus_kind="runheavy")
    assert r["roundtrip_ok"] is True
    assert r["ratio"] > 2.0, r["ratio"]


def test_chip_roofline_raises_on_unknown_device():
    # the CPU backend's device_kind is not in the table: an error, not a
    # default peak
    with pytest.raises(ValueError, match="no published HBM bandwidth"):
        bench._chip_roofline()


def test_chip_roofline_h200(monkeypatch):
    import jax

    class Dev:
        device_kind = "NVIDIA H200"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert bench._chip_roofline() == 4800.0


def test_compile_cache_follows_env(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert bench.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = bench.enable_compile_cache()
        assert path == str(Path(bench.__file__).resolve().parent / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
