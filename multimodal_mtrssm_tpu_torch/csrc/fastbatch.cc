// fastbatch: multithreaded episode-batch assembly for the host input pipeline
// (the port's copy of native/fastbatch.cc; data/native.py binds it).
//
// The reference covers this path with 4 torch DataLoader worker processes
// (reference src/multimodal_rssm/models/dataset.py:321-342: per-episode .pt
// file loads + per-item transform in each worker). The pipeline holds the
// dataset in contiguous host arrays (or a memory-mapped pack); batch
// assembly is then a gather over the episode axis plus (optionally) an
// affine normalisation and additive Gaussian input noise (reference
// transform.py:55-72). This kernel fuses them into one parallel pass:
// per-row xoshiro128** + Box-Muller, one write per output element.
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -pthread fastbatch.cc -o libfastbatch.so
// (the JAX package's flags, so both libraries give the same bits; no
// -march=native or -ffast-math: an FMA contraction of x * scale + shift or
// of dst += noise_std * g changes the last bit).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro128 {
  uint32_t s[4];
  explicit Xoshiro128(uint64_t seed) {
    // splitmix64 to fill state
    uint64_t x = seed + 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < 4; ++i) {
      uint64_t z = (x += 0x9E3779B97F4A7C15ull);
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      s[i] = static_cast<uint32_t>((z ^ (z >> 31)) >> 16);
    }
    if (!(s[0] | s[1] | s[2] | s[3])) s[0] = 1;
  }
  static uint32_t rotl(uint32_t v, int k) { return (v << k) | (v >> (32 - k)); }
  uint32_t next() {
    uint32_t result = rotl(s[1] * 5, 7) * 9;
    uint32_t t = s[1] << 9;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 11);
    return result;
  }
  // uniform in (0, 1]
  float uniform() { return (next() >> 8) * (1.0f / 16777216.0f) + 1e-9f; }
};

// One Box-Muller pair per call-site loop; caches the second value.
struct Gauss {
  Xoshiro128 rng;
  bool has_spare = false;
  float spare = 0.0f;
  explicit Gauss(uint64_t seed) : rng(seed) {}
  float next() {
    if (has_spare) {
      has_spare = false;
      return spare;
    }
    float u1 = rng.uniform();
    float u2 = rng.uniform();
    float r = std::sqrt(-2.0f * std::log(u1));
    float a = 6.2831853071795864769f * u2;
    spare = r * std::sin(a);
    has_spare = true;
    return r * std::cos(a);
  }
};

}  // namespace

extern "C" {

// Gather episodes idx[0..b) from src [n, t_total, frame_elems] into
// out [b, seq_len, frame_elems], adding N(0, noise_std) when noise_std > 0.
// Deterministic for a given (seed, b, seq_len, frame_elems) regardless of
// thread count (per-row RNG seeded by seed^row).
void fastbatch_gather_noise(const float* src, int64_t n, int64_t t_total,
                            int64_t frame_elems, const int64_t* idx, int64_t b,
                            int64_t seq_len, float noise_std, uint64_t seed,
                            float* out, int64_t n_threads) {
  if (b <= 0) return;  // empty batch: nothing to do (and avoids /0 below)
  const int64_t row_elems = seq_len * frame_elems;
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > b) n_threads = b;

  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const float* ep = src + idx[i] * t_total * frame_elems;
      float* dst = out + i * row_elems;
      std::memcpy(dst, ep, sizeof(float) * row_elems);
      if (noise_std > 0.0f) {
        Gauss g(seed ^ (0x9E3779B97F4A7C15ull * static_cast<uint64_t>(i + 1)));
        for (int64_t j = 0; j < row_elems; ++j) dst[j] += noise_std * g.next();
      }
    }
  };

  if (n_threads == 1) {
    work(0, b);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (b + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t begin = t * per;
    int64_t end = begin + per < b ? begin + per : b;
    if (begin >= end) break;
    threads.emplace_back(work, begin, end);
  }
  for (auto& th : threads) th.join();
}

// Same as fastbatch_gather_noise but with a fused affine preprocess:
// out = src * scale + shift (+ noise). Covers the framework's normalizers
// (NormalizeVisionImage / NormalizeAudioMelSpectrogram are affine), so the
// memmapped-pack path gets gather + normalize + noise in one pass.
void fastbatch_gather_affine_noise(const float* src, int64_t n, int64_t t_total,
                                   int64_t frame_elems, const int64_t* idx,
                                   int64_t b, int64_t seq_len, float scale,
                                   float shift, float noise_std, uint64_t seed,
                                   float* out, int64_t n_threads) {
  if (b <= 0) return;  // empty batch: nothing to do (and avoids /0 below)
  const int64_t row_elems = seq_len * frame_elems;
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > b) n_threads = b;

  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const float* ep = src + idx[i] * t_total * frame_elems;
      float* dst = out + i * row_elems;
      if (noise_std > 0.0f) {
        Gauss g(seed ^ (0x9E3779B97F4A7C15ull * static_cast<uint64_t>(i + 1)));
        for (int64_t j = 0; j < row_elems; ++j)
          dst[j] = ep[j] * scale + shift + noise_std * g.next();
      } else {
        for (int64_t j = 0; j < row_elems; ++j) dst[j] = ep[j] * scale + shift;
      }
    }
  };

  if (n_threads == 1) {
    work(0, b);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (b + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t begin = t * per;
    int64_t end = begin + per < b ? begin + per : b;
    if (begin >= end) break;
    threads.emplace_back(work, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
