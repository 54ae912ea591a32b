"""Large-chunk validation on the GPU: 32 KB - 16 MB chunk round-trips.

The reference supports LZ4 chunks 32 KB-16 MB (include/hipcomp/lz4.h:67-74)
and cascaded partitions are unbounded.  Validates compress+decompress
round-trips and memory behavior at 32K/256K/1M chunk sizes for all three
codecs, plus the 4M/16M points for lz4+cascaded (lz77.MATCH_H_CAP bounds
the suffix-level memory there).

Run from the repository root: python scripts/large_chunks_hw.py
"""
import os, sys, time
import jax, numpy as np, jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import enable_compile_cache, load_corpus

enable_compile_cache()
from tpucomp.codecs import lz4, snappy, cascaded
from tpucomp.core.options import CascadedOpts

print("devices", jax.devices(), flush=True)

for C in (32 * 1024, 256 * 1024, 1024 * 1024):
    B = max(2, (4 * 1024 * 1024) // C)
    corpus = load_corpus(B * C, seed=2)
    arr = np.frombuffer(corpus, np.uint8).reshape(B, C)
    lens = np.full(B, C, np.int32)
    lens[-1] = C - 13
    # cascaded is element-typed (default INT): trailing partial-element
    # bytes are dropped by contract (olen = (len // w) * w), so give it an
    # element-aligned tail; lz4/snappy are byte-oriented.
    lens_c = np.full(B, C, np.int32)
    lens_c[-1] = C - 16
    da = jnp.asarray(arr)
    dl, dlc = jnp.asarray(lens), jnp.asarray(lens_c)

    for name, lns, enc, dec in (
        ("lz4", lens, lambda: lz4.compress(da, dl), lambda c, s: lz4.decompress(c, s, out_capacity=C)),
        ("snappy", lens, lambda: snappy.compress(da, dl), lambda c, s: snappy.decompress(c, s, out_capacity=C)),
        ("cascaded", lens_c, lambda: cascaded.compress(da, dlc, CascadedOpts()),
         lambda c, s: cascaded.decompress(c, s, CascadedOpts(), C)),
    ):
        t0 = time.time()
        try:
            comp, sizes = jax.block_until_ready(enc())
            out, olen, st = dec(comp, sizes)
            out, olen, st = map(np.asarray, (out, olen, st))
            ok = (st == 0).all() and (olen == lns).all() and all(
                (out[i, : lns[i]] == arr[i, : lns[i]]).all() for i in range(B)
            )
            r = B * C / float(np.asarray(sizes).sum())
            print(f"LARGE {name} C={C//1024}KB B={B}: {'OK' if ok else 'FAIL'} ratio {r:.2f} ({time.time()-t0:.0f}s)", flush=True)
        except Exception as e:
            print(f"LARGE {name} C={C//1024}KB: ERROR {str(e)[:140]}", flush=True)

# 4 MB / 16 MB XLA-route points (B=1, compressible payload so the
# sequence-sequential stages stay fast; validates the reference's
# MAX_CHUNK_SIZE upper bound on real HBM)
rng = np.random.default_rng(0)
for C in (4 << 20, 16 << 20):
    nv = C // 1200 + 4
    arr = np.repeat(rng.integers(0, 40, nv).astype(np.uint8),
                    rng.integers(800, 2200, nv))[:C].copy()
    da = jnp.asarray(arr[None, :])
    dl = jnp.asarray(np.array([C], np.int32))
    n4 = C // 4
    nvi = n4 // 12 + 4
    col = np.repeat((np.cumsum(rng.integers(-3, 4, nvi)) + 500).astype(np.int32),
                    rng.integers(6, 20, nvi))[:n4]
    arr_c = col.view(np.uint8)[:C].copy()
    dc = jnp.asarray(arr_c[None, :])

    for name, src, enc, dec in (
        ("lz4", arr, lambda: lz4.compress(da, dl),
         lambda c, s: lz4.decompress(c, s, out_capacity=C)),
        ("cascaded", arr_c, lambda: cascaded.compress(dc, dl, CascadedOpts()),
         lambda c, s: cascaded.decompress(c, s, CascadedOpts(), C)),
    ):
        t0 = time.time()
        try:
            comp, sizes = jax.block_until_ready(enc())
            out, olen, st = dec(comp, sizes)
            out, olen, st = map(np.asarray, (out, olen, st))
            ok = (st == 0).all() and int(olen[0]) == C and (out[0] == src).all()
            r = C / float(np.asarray(sizes).sum())
            print(f"LARGE {name} C={C//1024}KB B=1: {'OK' if ok else 'FAIL'} ratio {r:.1f} ({time.time()-t0:.0f}s)", flush=True)
        except Exception as e:
            print(f"LARGE {name} C={C//1024}KB: ERROR {str(e)[:180]}", flush=True)
print("DONE", flush=True)
