// Shared device code of the MRSSM recurrence kernels (recurrence_fwd.cu,
// rollout.cu): weight staging into shared memory, the row-batched dense
// layer, the reference's activation and sampling conventions, Philox4x32-10.
//
// All math is f32 with plain FMA loops: the products are 1..8 rows by
// 22..192 columns, far below a tensor-core tile, and the JAX reference is
// f32 throughout. Built without --use_fast_math so expf/logf/tanhf keep
// their accurate forms and (onehot + p) - p is not reassociated.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mrssm {

constexpr int kThreads = 128;
// -log(3) rounded to f32: the constant of the JAX package's fusion.
constexpr float kLogThird = -1.0986122886681098f;

// ELU as the JAX kernels write it (expm1 is not in their lowering).
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(x) - 1.f; }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Copy a torch Linear weight [out, in] into shared memory as [in, out], so
// that the threads of a warp, which own neighbouring outputs, read
// neighbouring words in the dense loop.
__device__ __forceinline__ void stage_matrix(float* dst, const float* w, int out, int in) {
  for (int i = threadIdx.x; i < out * in; i += blockDim.x) {
    const int o = i / in, k = i - o * in;
    dst[k * out + o] = w[i];
  }
}

__device__ __forceinline__ void stage_vector(float* dst, const float* v, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = v[i];
}

// y[r, o] = act(b[o] + sum_k cat(x0[r], x1[r])[k] * W[k, o]) for r < rows.
// W is [n0 + n1, out] in shared memory; x0/x1 rows have strides s0/s1.
__device__ __forceinline__ void dense_rows(const float* x0, int n0, int s0, const float* x1,
                                           int n1, int s1, const float* W, const float* b,
                                           int out, float* y, int sy, int rows, bool act_elu) {
  for (int i = threadIdx.x; i < rows * out; i += blockDim.x) {
    const int r = i / out, o = i - r * out;
    const float* a = x0 + r * s0;
    float acc = 0.f;
    for (int k = 0; k < n0; ++k) acc = fmaf(a[k], W[k * out + o], acc);
    const float* c = x1 + r * s1;
    for (int k = 0; k < n1; ++k) acc = fmaf(c[k], W[(n0 + k) * out + o], acc);
    const float v = acc + b[o];
    y[r * sy + o] = act_elu ? elu(v) : v;
  }
}

// One GRU step for rows < rows, gate order r, z, n (torch nn.GRUCell):
// gates[r] = gi (3D) ⊕ gh (3D); deter is updated in place.
__device__ __forceinline__ void gru_rows(const float* gates, float* deter, int D, int rows) {
  const int G = 3 * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const float* gi = gates + r * 2 * G;
    const float* gh = gi + G;
    const float rg = sigmoid(gi[d] + gh[d]);
    const float z = sigmoid(gi[D + d] + gh[D + d]);
    const float n = tanhf(gi[2 * D + d] + rg * gh[2 * D + d]);
    deter[r * D + d] = (1.f - z) * n + z * deter[r * D + d];
  }
}

// First-index argmax of scores[j] = logits[j] + noise[j] over one block.
__device__ __forceinline__ int block_argmax(const float* logits, const float* noise, int K) {
  int best = 0;
  float top = logits[0] + noise[0];
  for (int j = 1; j < K; ++j) {
    const float s = logits[j] + noise[j];
    if (s > top) { top = s; best = j; }
  }
  return best;
}

// Straight-through sample value of one block: (onehot + p) - p, with the
// per-block softmax p = e / sum(e), e = exp(l - max).
__device__ __forceinline__ void st_block(const float* logits, int best, int K, float* out) {
  float mx = logits[0];
  for (int j = 1; j < K; ++j) mx = fmaxf(mx, logits[j]);
  float sum = 0.f;
  for (int j = 0; j < K; ++j) sum += expf(logits[j] - mx);
  for (int j = 0; j < K; ++j) {
    const float p = expf(logits[j] - mx) / sum;
    out[j] = ((j == best ? 1.f : 0.f) + p) - p;
  }
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32 with 10
// rounds). Counter c, key k; returns the four output words in c.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int i = 0; i < 10; ++i) {
    if (i > 0) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

// uint32 → uniform in (0, 1): mantissa stuffing with the low bit forced on,
// so u is never 0 (the JAX kernel's _uniform_from_bits).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800001u) - 1.f;
}

}  // namespace mrssm
