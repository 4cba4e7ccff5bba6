// The port's C++ host tier: the data path's hot loops behind ctypes.
//
// Counterpart of trustworthy_dl_tpu/native/dataloader.cpp, entry for entry:
// splitmix64 streams, the synthetic token chain, epoch permutations,
// multi-threaded row and window gathers, and the byte-level BPE encoder's
// merge loop.  trustworthy_dl_tpu_torch/native/__init__.py builds it with
// g++ into the kernel cache at first use and declares every signature.
//
// Determinism contract: every routine is a pure function of its inputs
// (seed, n, the arrays) using splitmix64; the numpy twins beside the
// wrappers implement the same arithmetic, and tests/test_torch_native.py
// pins C++ == numpy == the JAX package's tier bit for bit.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libtddl_native.so \
//            dataloader.cpp -lpthread

#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// splitmix64 (public-domain algorithm, Steele et al.): the shared
// deterministic generator.  state walks seed + i*GOLDEN.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Raw stream: out[i] = splitmix64(seed + i*GOLDEN) — stateless, so any
// subrange can be regenerated independently (the numpy twin vectorises
// exactly this).
void tddl_splitmix_fill(uint64_t seed, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = splitmix64(seed + (uint64_t)i * 0x9E3779B97F4A7C15ULL);
  }
}

// Learnable synthetic LM stream (data/loader.py contract): affine
// next-token chain t_{i+1} = (a*t_i + b) mod V with 10% uniform resets.
// Noise decisions and reset tokens come from two independent splitmix
// streams so the chain stays sequential but the randomness is O(1)
// addressable.
void tddl_synthetic_tokens(int64_t n, int32_t vocab, uint64_t seed,
                           int32_t* out) {
  const int32_t a = 31, b = 7;
  const uint64_t noise_seed = splitmix64(seed ^ 0xA5A5A5A5A5A5A5A5ULL);
  const uint64_t tok_seed = splitmix64(seed ^ 0x5A5A5A5A5A5A5A5AULL);
  int32_t t = (int32_t)(splitmix64(seed) % (uint64_t)vocab);
  out[0] = t;
  for (int64_t i = 1; i < n; ++i) {
    uint64_t u = splitmix64(noise_seed + (uint64_t)i * 0x9E3779B97F4A7C15ULL);
    if ((u >> 48) < 6554) {  // top 16 bits < 0.1 * 65536
      uint64_t r = splitmix64(tok_seed + (uint64_t)i * 0x9E3779B97F4A7C15ULL);
      t = (int32_t)(r % (uint64_t)vocab);
    } else {
      t = (int32_t)(((int64_t)a * t + b) % vocab);
    }
    out[i] = t;
  }
}

// Fisher-Yates permutation of [0, n) driven by the splitmix stream.
// Rejection-free modulo bias is acceptable here (shuffling quality, not
// cryptography), but the arithmetic must match the numpy twin exactly.
void tddl_permutation(uint64_t seed, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t u = splitmix64(seed + (uint64_t)i * 0x9E3779B97F4A7C15ULL);
    int64_t j = (int64_t)(u % (uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// Batch assembly: gather rows of a contiguous [num_rows, row_bytes] buffer
// into out following idx.  Multi-threaded memcpy — this is the per-batch
// hot path numpy fancy indexing pays a per-row overhead for.
void tddl_gather_rows(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                      int64_t row_bytes, uint8_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_idx < 64) {
    for (int64_t i = 0; i < n_idx; ++i) {
      std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                  (size_t)row_bytes);
    }
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int32_t w = 0; w < n_threads; ++w) {
    int64_t lo = (int64_t)w * chunk;
    int64_t hi = lo + chunk < n_idx ? lo + chunk : n_idx;
    if (lo >= hi) break;
    workers.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                    (size_t)row_bytes);
      }
    });
  }
  for (auto& t : workers) t.join();
}

// Random-window sampling over a contiguous token stream (the nanoGPT-style
// loader): row r of the batch reads seq_len+1 consecutive int32 tokens at
// offset splitmix64(seed + r*GOLDEN) % (stream_len - seq_len - 1), split
// into input (first seq_len) and next-token target (last seq_len).
// Multi-threaded over rows; offsets are O(1) addressable so the numpy twin
// reproduces them bit-for-bit.
void tddl_window_gather(const int32_t* stream, int64_t stream_len,
                        int64_t seq_len, int64_t batch, uint64_t seed,
                        int32_t* out_inputs, int32_t* out_targets,
                        int32_t n_threads) {
  // A window consumes seq_len+1 tokens: valid offsets are
  // [0, stream_len - seq_len - 1], span = stream_len - seq_len of them.
  const int64_t span = stream_len - seq_len;
  if (span <= 0) return;
  auto work = [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      uint64_t u = splitmix64(seed + (uint64_t)r * 0x9E3779B97F4A7C15ULL);
      int64_t off = (int64_t)(u % (uint64_t)span);
      std::memcpy(out_inputs + r * seq_len, stream + off,
                  (size_t)seq_len * sizeof(int32_t));
      std::memcpy(out_targets + r * seq_len, stream + off + 1,
                  (size_t)seq_len * sizeof(int32_t));
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || batch < 64) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int32_t w = 0; w < n_threads; ++w) {
    int64_t lo = (int64_t)w * chunk;
    int64_t hi = lo + chunk < batch ? lo + chunk : batch;
    if (lo >= hi) break;
    workers.emplace_back([=]() { work(lo, hi); });
  }
  for (auto& t : workers) t.join();
}


// ---------------------------------------------------------------------------
// Byte-level BPE encoder (data/tokenizer.py hot path).
//
// Works entirely in token-id space: the Python layer maps byte units to
// their vocabulary ids and hands over (a) the merge table as id pairs with
// each product's id, (b) a flat batch of pre-tokenized words.  The merge
// loop (find the lowest-rank adjacent pair, fuse, repeat) is the
// per-character-quadratic inner loop that dominates corpus tokenization in
// Python.  Merges whose product is absent from the vocabulary are excluded
// by the caller — the tokenizer's Python loop shares that rule, so outputs
// are bit-exact.
// ---------------------------------------------------------------------------

static std::unordered_map<uint64_t, int32_t> g_bpe_ranks;
static std::vector<int32_t> g_bpe_prod;  // rank -> product token id

void tddl_bpe_load(const int32_t* lefts, const int32_t* rights,
                   const int32_t* prods, int64_t n_merges) {
  g_bpe_ranks.clear();
  g_bpe_ranks.reserve((size_t)n_merges * 2);
  g_bpe_prod.assign((size_t)n_merges, 0);
  for (int64_t i = 0; i < n_merges; ++i) {
    uint64_t key =
        ((uint64_t)(uint32_t)lefts[i] << 32) | (uint32_t)rights[i];
    // First occurrence wins (lowest rank), matching dict-of-ranks
    // semantics on duplicate pairs in a merges file.
    g_bpe_ranks.emplace(key, (int32_t)i);
    g_bpe_prod[(size_t)i] = prods[i];
  }
}

// words: flat unit-id stream; offsets[n_words+1] delimit each word.
// out must hold offsets[n_words] ids (output never exceeds input);
// out_offsets[n_words+1] receives the encoded extents.
void tddl_bpe_encode(const int32_t* flat, const int64_t* offsets,
                     int64_t n_words, int32_t* out, int64_t* out_offsets) {
  std::vector<int32_t> buf;
  int64_t w = 0;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n_words; ++i) {
    const int32_t* word = flat + offsets[i];
    const int64_t n = offsets[i + 1] - offsets[i];
    buf.assign(word, word + n);
    while (buf.size() > 1) {
      int32_t best_rank = INT_MAX;
      int64_t best = -1;
      for (int64_t j = 0; j + 1 < (int64_t)buf.size(); ++j) {
        uint64_t key =
            ((uint64_t)(uint32_t)buf[j] << 32) | (uint32_t)buf[j + 1];
        auto it = g_bpe_ranks.find(key);
        if (it != g_bpe_ranks.end() && it->second < best_rank) {
          best_rank = it->second;
          best = j;
        }
      }
      if (best < 0) break;
      buf[(size_t)best] = g_bpe_prod[(size_t)best_rank];
      buf.erase(buf.begin() + best + 1);
    }
    for (int32_t t : buf) out[w++] = t;
    out_offsets[i + 1] = w;
  }
}

}  // extern "C"
