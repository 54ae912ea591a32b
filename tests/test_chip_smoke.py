"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases, sampling and checks work at a tiny size (the GPU run drives the
same functions at 256 MB per codec)."""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs
from tpucomp.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp.lowlevel.cascaded import CODEC as CASCADED
from tpucomp.lowlevel.lz4 import CODEC as LZ4
from tpucomp.lowlevel.snappy import CODEC as SNAPPY
from oracles.lz4_oracle import lz4_compress_oracle, lz4_decompress_oracle
from oracles.snappy_oracle import snappy_compress_oracle, snappy_decompress_oracle


@pytest.fixture(scope="module")
def log():
    return cs.CompileLog()


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_to_run_without_gpu(argv):
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in out.getvalue()


def test_sample_rows_takes_both_kinds():
    fallback = np.arange(100) % 4 != 0  # 75 fallback rows, 25 pipeline rows
    picks = cs.sample_rows(fallback)
    assert len(picks) == cs.SAMPLES == len(set(picks))
    assert fallback[picks].sum() == cs.SAMPLES // 2
    assert (picks == cs.sample_rows(fallback)).all()  # fixed seed


@pytest.mark.parametrize("n_rows,n_fb", [(100, 0), (100, 98), (5, 2)])
def test_sample_rows_when_one_kind_is_scarce(n_rows, n_fb):
    fallback = np.arange(n_rows) < n_fb
    picks = cs.sample_rows(fallback)
    assert len(picks) == min(cs.SAMPLES, n_rows) == len(set(picks))


def test_check_roundtrip_rejects_a_changed_byte():
    data = np.arange(12, dtype=np.uint8).reshape(3, 4)
    lens = np.full(3, 4, np.int32)
    ok = np.zeros(3, np.int32)
    cs.check_roundtrip("same", data, lens, data.copy(), lens, ok)
    bad = data.copy()
    bad[1, 2] ^= 1
    with pytest.raises(SystemExit, match="1 rows differ"):
        cs.check_roundtrip("changed", data, lens, bad, lens, ok)
    with pytest.raises(SystemExit, match="not SUCCESS"):
        cs.check_roundtrip("status", data, lens, data, lens, np.array([0, 12, 0], np.int32))


def test_sweep_chunks_shapes():
    rows = cs.sweep_chunks(np.dtype(np.int16), 5, seed=2)
    assert rows.shape == (5, cs.CHUNK) and rows.dtype == np.uint8


def test_phase_cascaded_and_corrupt_tiny(log, capsys):
    data = np.concatenate([cs.corpus_chunks(1, 0), cs.runheavy_chunks(1)])
    res = cs.phase_cascaded(log, "A tiny", data)
    cs.phase_corrupt(log, "E tiny", CASCADED, CascadedOpts(), *res, None, rows=2)
    out = capsys.readouterr().out
    assert out.count("PHASE ") == 2 and '"sampled": {"fallback": 1, "pipeline": 1}' in out


@pytest.mark.parametrize("name", ["lz4", "snappy"])
def test_phase_lz_and_corrupt_tiny(log, capsys, name):
    codec, opts, dec, enc = {
        "lz4": (LZ4, LZ4Opts(), lz4_decompress_oracle, lz4_compress_oracle),
        "snappy": (SNAPPY, SnappyOpts(), snappy_decompress_oracle, snappy_compress_oracle),
    }[name]
    res = cs.phase_lz(log, f"C tiny {name}", codec, cs.corpus_chunks(2, 1), opts, dec, enc)
    cs.phase_corrupt(log, f"E tiny {name}", codec, opts, *res, dec, rows=2)
    assert capsys.readouterr().out.count("PHASE ") == 2


def test_four_card_phase_on_virtual_devices(capsys):
    cs.run_four_cards(jax.devices()[:4], n_chunks=4)
    out = capsys.readouterr().out
    assert out.count('"identical_to_one_card": true') == 4


def test_fit_halves_until_it_fits(capsys):
    def run(n):
        if n > 1024:
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")
        return n

    assert cs.fit("X", run, 4096) == 1024
    out = capsys.readouterr().out
    assert "256 MB did not fit" in out and "retrying at 64 MB" in out


def test_fit_passes_other_errors_through():
    def run(n):
        raise jax.errors.JaxRuntimeError("INTERNAL: something else")

    with pytest.raises(jax.errors.JaxRuntimeError, match="INTERNAL"):
        cs.fit("X", run, 4096)
