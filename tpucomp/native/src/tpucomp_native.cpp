// Native host runtime for tpucomp.
//
// The reference's host-side C++ (staging, buffer bookkeeping, CPU-side
// verification) maps here; the device compute path stays in XLA.  Exposed as a
// plain C ABI consumed through ctypes (no pybind11 in this environment).
//
// Components:
//   - ragged <-> dense chunk staging (the host edge of the ChunkBatch
//     representation, replacing Python per-chunk loops)
//   - clean-room LZ4 block codec (greedy nearest-previous-occurrence
//     matcher -- the same family as the device compressor; used for fast
//     golden-vector generation and as a CPU fallback path)
//   - crc32 (reserved checksum fields in the HLIF header)

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ragged <-> dense staging
// ---------------------------------------------------------------------------

// Scatter a contiguous concatenation of chunks into dense [b, cap] rows.
// sizes[i] gives each chunk's byte count; rows are zero-padded.
void tc_pack_ragged(const uint8_t* src, const int64_t* sizes, int64_t b,
                    int64_t cap, uint8_t* dst) {
  int64_t off = 0;
  for (int64_t i = 0; i < b; i++) {
    const int64_t n = sizes[i] < cap ? sizes[i] : cap;
    std::memcpy(dst + i * cap, src + off, static_cast<size_t>(n));
    if (n < cap) std::memset(dst + i * cap + n, 0, static_cast<size_t>(cap - n));
    off += sizes[i];
  }
}

// Gather the valid prefixes of dense rows back into a contiguous buffer.
// Returns the total byte count written.
int64_t tc_unpack_ragged(const uint8_t* src, const int64_t* sizes, int64_t b,
                         int64_t cap, uint8_t* dst) {
  int64_t off = 0;
  for (int64_t i = 0; i < b; i++) {
    const int64_t n = sizes[i] < cap ? sizes[i] : cap;
    std::memcpy(dst + off, src + i * cap, static_cast<size_t>(n));
    off += n;
  }
  return off;
}

// Split one contiguous stream into fixed-size rows (the high-level
// manager's chunking step on the host).
void tc_split_stream(const uint8_t* src, int64_t n, int64_t chunk,
                     int64_t num_chunks, uint8_t* dst) {
  for (int64_t i = 0; i < num_chunks; i++) {
    const int64_t start = i * chunk;
    const int64_t len = start < n ? (n - start < chunk ? n - start : chunk) : 0;
    std::memcpy(dst + i * chunk, src + start, static_cast<size_t>(len));
    if (len < chunk) std::memset(dst + i * chunk + len, 0, static_cast<size_t>(chunk - len));
  }
}

// ---------------------------------------------------------------------------
// clean-room LZ4 block codec (CPU reference path)
// ---------------------------------------------------------------------------

static inline uint32_t tc_hash4(uint32_t v) { return (v * 2654435761u) >> 18; }  // 14-bit

// Greedy LZ4 block compression; returns compressed size (<= worst case
// n + 1 + n/255 + 16).  max_match < 0 disables the cap.
int64_t tc_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap, int64_t max_match) {
  if (n <= 0) return 0;
  std::vector<int64_t> table(1 << 14, -1);
  int64_t op = 0, anchor = 0, p = 0;
  auto emit_lsic = [&](int64_t v) {
    v -= 15;
    while (v >= 255) { dst[op++] = 255; v -= 255; }
    dst[op++] = static_cast<uint8_t>(v);
  };
  while (p + 13 <= n && p + 4 <= n) {
    uint32_t key;
    std::memcpy(&key, src + p, 4);
    const uint32_t h = tc_hash4(key);
    const int64_t j = table[h];
    table[h] = p;
    uint32_t cand_key = 0;
    if (j >= 0) std::memcpy(&cand_key, src + j, 4);
    if (j >= 0 && p - j <= 65535 && cand_key == key) {
      int64_t ml = 4;
      const int64_t limit = n - 5 - p;
      const bool exact = (p - j) <= 8;
      while (ml < limit && src[j + ml] == src[p + ml] &&
             (exact || max_match < 0 || ml < max_match))
        ml++;
      const int64_t ll = p - anchor;
      if (op + 16 + ll + ll / 255 > dst_cap) return -1;
      const uint8_t tok_l = ll < 15 ? static_cast<uint8_t>(ll) : 15;
      const uint8_t tok_m = (ml - 4) < 15 ? static_cast<uint8_t>(ml - 4) : 15;
      dst[op++] = static_cast<uint8_t>((tok_l << 4) | tok_m);
      if (ll >= 15) emit_lsic(ll);
      std::memcpy(dst + op, src + anchor, static_cast<size_t>(ll));
      op += ll;
      const int64_t off = p - j;
      dst[op++] = static_cast<uint8_t>(off & 0xFF);
      dst[op++] = static_cast<uint8_t>(off >> 8);
      if (ml - 4 >= 15) emit_lsic(ml - 4);
      // insert interior positions (matches the exact-matcher family)
      for (int64_t q = p + 1; q < p + ml && q + 4 <= n; q++) {
        uint32_t k2;
        std::memcpy(&k2, src + q, 4);
        table[tc_hash4(k2)] = q;
      }
      p += ml;
      anchor = p;
      continue;
    }
    p++;
  }
  const int64_t ll = n - anchor;
  if (op + 16 + ll + ll / 255 > dst_cap) return -1;
  dst[op++] = static_cast<uint8_t>((ll < 15 ? ll : 15) << 4);
  if (ll >= 15) emit_lsic(ll);
  std::memcpy(dst + op, src + anchor, static_cast<size_t>(ll));
  op += ll;
  return op;
}

// Strict LZ4 block decompression; returns output size or -1 on corruption.
int64_t tc_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t dst_cap) {
  int64_t p = 0, o = 0;
  while (p < n) {
    const uint8_t token = src[p++];
    int64_t ll = token >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (p >= n) return -1;
        b = src[p++];
        ll += b;
      } while (b == 255);
    }
    if (p + ll > n || o + ll > dst_cap) return -1;
    std::memcpy(dst + o, src + p, static_cast<size_t>(ll));
    p += ll;
    o += ll;
    if (p >= n) break;  // last sequence: literals only
    if (p + 2 > n) return -1;
    const int64_t off = src[p] | (src[p + 1] << 8);
    p += 2;
    if (off == 0 || off > o) return -1;
    int64_t ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (p >= n) return -1;
        b = src[p++];
        ml += b;
      } while (b == 255);
    }
    if (o + ml > dst_cap) return -1;
    for (int64_t k = 0; k < ml; k++) dst[o + k] = dst[o - off + k];
    o += ml;
  }
  return o;
}

// ---------------------------------------------------------------------------
// crc32 (IEEE, bit-reflected)
// ---------------------------------------------------------------------------

uint32_t tc_crc32(const uint8_t* data, int64_t n, uint32_t seed) {
  uint32_t crc = ~seed;
  for (int64_t i = 0; i < n; i++) {
    crc ^= data[i];
    for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ (0xEDB88320u & (~(crc & 1) + 1));
  }
  return ~crc;
}

}  // extern "C"
