// Host-side data-path functions of the port: token -> id encoding over
// fixed-width byte matrices, a row gather, and the TFRecord container's
// CRC32C, framing and scan. Built with g++ into a plain-C shared library and
// bound with ctypes by hm_retrieval_tpu_torch/native_ext.py (the build:
// hm_retrieval_tpu_torch/ops/_build.py). No GPU code: these run on the
// card's host, where the pipeline's string and record work lives.
//
//   * vocab_*: string token -> int32 id (0 = OOV) through a hash map,
//     looked up across threads;
//   * gather_rows: dst[i] = src[idx[i]] over raw rows, across threads;
//   * tfrecord_*: masked CRC32C (slice-by-8 tables), whole-file framing
//     (one record a task, across threads) and a whole-file scan that
//     reports the first fault's byte offset.
//
// Every result is independent of the thread count: each thread writes a
// disjoint range of the output.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  // token -> id (1-based; 0 reserved for OOV)
  std::unordered_map<std::string, int32_t> map;
};

// ---------------------------------------------------------------------
// CRC32C (Castagnoli, reflected) for the TFRecord on-disk format, as
// tf.io.TFRecordWriter writes it. Each record is framed as
//   uint64 length | uint32 masked_crc(length) | data | uint32 masked_crc(data)
// with masked_crc(x) = rotr15(crc32c(x)) + 0xa282ead8.
// ---------------------------------------------------------------------
uint32_t g_crc_table[8][256];
std::once_flag g_crc_once;

void init_crc_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1u) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    g_crc_table[0][i] = c;
  }
  // slice-by-8 helper tables
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_crc_table[0][i];
    for (int t = 1; t < 8; ++t) {
      c = g_crc_table[0][c & 0xFFu] ^ (c >> 8);
      g_crc_table[t][i] = c;
    }
  }
}

uint32_t crc32c(const uint8_t* p, uint64_t n) {
  std::call_once(g_crc_once, init_crc_tables);
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = g_crc_table[7][lo & 0xFFu] ^ g_crc_table[6][(lo >> 8) & 0xFFu] ^
        g_crc_table[5][(lo >> 16) & 0xFFu] ^ g_crc_table[4][lo >> 24] ^
        g_crc_table[3][hi & 0xFFu] ^ g_crc_table[2][(hi >> 8) & 0xFFu] ^
        g_crc_table[1][(hi >> 16) & 0xFFu] ^ g_crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = g_crc_table[0][(c ^ *p++) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

int resolve_threads(int n_threads) {
  if (n_threads > 0) return n_threads;
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 4;
}

template <typename F>
void parallel_for(uint64_t n, int n_threads, F&& fn) {
  n_threads = resolve_threads(n_threads);
  if (n < 4096 || n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t lo = static_cast<uint64_t>(t) * chunk;
    if (lo >= n) break;
    uint64_t hi = std::min(n, lo + chunk);
    pool.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// vocab tokens arrive as one contiguous UTF-8 buffer plus n+1 offsets.
void* vocab_create(const char* data, const uint64_t* offsets,
                   uint32_t n) {
  auto* v = new Vocab();
  v->map.reserve(n * 2);
  for (uint32_t i = 0; i < n; ++i) {
    std::string tok(data + offsets[i], offsets[i + 1] - offsets[i]);
    // LAST occurrence wins for duplicate tokens, as in the plain path's
    // dict (schema/features.py Feature._lookup)
    v->map[std::move(tok)] = static_cast<int32_t>(i) + 1;
  }
  return v;
}

void vocab_destroy(void* handle) {
  delete static_cast<Vocab*>(handle);
}

uint32_t vocab_size(void* handle) {
  return static_cast<uint32_t>(
      static_cast<Vocab*>(handle)->map.size());
}

// Encode m tokens to int32 ids (0 when absent). Thread-parallel.
void vocab_encode(void* handle, const char* data,
                  const uint64_t* offsets, uint64_t m,
                  int32_t* out, int n_threads) {
  const auto* v = static_cast<Vocab*>(handle);
  parallel_for(m, n_threads, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::string_view tok(data + offsets[i],
                           offsets[i + 1] - offsets[i]);
      // C++20 heterogenous lookup is not guaranteed for
      // unordered_map<string>; construct a key (small-string opt
      // covers typical ids).
      auto it = v->map.find(std::string(tok));
      out[i] = (it == v->map.end()) ? 0 : it->second;
    }
  });
}

// Fixed-width variants: tokens arrive as an (m, width) byte matrix
// (numpy S dtype), right-padded with NULs, which are dropped: a token with
// an embedded NUL cannot be told from a shorter one.
static inline std::string_view fixed_token(const char* data,
                                           uint64_t width,
                                           uint64_t i) {
  const char* p = data + i * width;
  uint64_t len = 0;
  while (len < width && p[len] != '\0') ++len;
  return std::string_view(p, len);
}

void* vocab_create_fixed(const char* data, uint64_t width,
                         uint32_t n) {
  auto* v = new Vocab();
  v->map.reserve(n * 2);
  for (uint32_t i = 0; i < n; ++i) {
    auto tok = fixed_token(data, width, i);
    v->map[std::string(tok)] = static_cast<int32_t>(i) + 1;
  }
  return v;
}

void vocab_encode_fixed(void* handle, const char* data,
                        uint64_t width, uint64_t m, int32_t* out,
                        int n_threads) {
  const auto* v = static_cast<Vocab*>(handle);
  parallel_for(m, n_threads, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      auto tok = fixed_token(data, width, i);
      auto it = v->map.find(std::string(tok));
      out[i] = (it == v->map.end()) ? 0 : it->second;
    }
  });
}

// dst[i, :] = src[idx[i], :] over raw bytes; thread-parallel.
void gather_rows(const uint8_t* src, uint64_t row_bytes,
                 const int32_t* idx, uint64_t n_idx, uint8_t* dst,
                 int n_threads) {
  parallel_for(n_idx, n_threads, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes,
                  src + static_cast<uint64_t>(idx[i]) * row_bytes,
                  row_bytes);
    }
  });
}

// --- TFRecord container fast paths (see crc32c above) ----------------

uint32_t tfrecord_masked_crc(const uint8_t* data, uint64_t n) {
  return mask_crc(crc32c(data, n));
}

// Scan a whole TFRecord file image: fill data-payload offsets/lengths
// for up to `cap` records. Returns the total record count, or
// -(byte_position + 1) at the first framing/CRC violation.
int64_t tfrecord_scan(const uint8_t* buf, uint64_t n, int verify,
                      uint64_t* offsets, uint64_t* lengths,
                      uint64_t cap) {
  uint64_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    if (pos + 12 > n) return -static_cast<int64_t>(pos + 1);
    uint64_t len;
    uint32_t len_crc;
    std::memcpy(&len, buf + pos, 8);
    std::memcpy(&len_crc, buf + pos + 8, 4);
    if (verify && mask_crc(crc32c(buf + pos, 8)) != len_crc)
      return -static_cast<int64_t>(pos + 1);
    uint64_t data_off = pos + 12;
    if (len > n || data_off + len + 4 > n)
      return -static_cast<int64_t>(pos + 1);
    if (verify) {
      uint32_t data_crc;
      std::memcpy(&data_crc, buf + data_off + len, 4);
      if (mask_crc(crc32c(buf + data_off, len)) != data_crc)
        return -static_cast<int64_t>(pos + 1);
    }
    if (static_cast<uint64_t>(count) < cap) {
      offsets[count] = data_off;
      lengths[count] = len;
    }
    ++count;
    pos = data_off + len + 4;
  }
  return count;
}

// Frame `m` records (concatenated in `data`, boundaries in
// offsets[m+1]) into an output buffer: length/CRC headers + payload +
// payload CRC per record. `out` must hold sum(len) + 16*m bytes.
// Thread-parallel across records (each record's frame is independent).
void tfrecord_frame(const uint8_t* data, const uint64_t* offsets,
                    uint64_t m, uint8_t* out, int n_threads) {
  parallel_for(m, n_threads, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      uint64_t len = offsets[i + 1] - offsets[i];
      uint8_t* dst = out + offsets[i] + 16 * i;
      std::memcpy(dst, &len, 8);
      uint32_t len_crc = mask_crc(crc32c(dst, 8));
      std::memcpy(dst + 8, &len_crc, 4);
      std::memcpy(dst + 12, data + offsets[i], len);
      uint32_t data_crc = mask_crc(crc32c(data + offsets[i], len));
      std::memcpy(dst + 12 + len, &data_crc, 4);
    }
  });
}

}  // extern "C"
