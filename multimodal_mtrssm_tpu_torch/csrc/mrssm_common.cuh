// Shared device code of the recurrence kernels (the MRSSM kernels
// recurrence_fwd.cu, recurrence_bwd.cu, rollout.cu and the MMTRSSM kernels
// recurrence_mt_fwd.cu, recurrence_mt_bwd.cu, rollout_mt.cu): the weights'
// shapes, the row-batched dense layer and its transpose, the MTRNN cell, the
// reference's activation, fusion and sampling conventions, their VJPs, the
// fixed-order reduction of per-block weight gradients over blocks,
// Philox4x32-10.
//
// All math is f32 with plain FMA loops: the products are 1..32 rows by
// 16..192 columns, far below a tensor-core tile, and the JAX reference is
// f32 throughout. Built without --use_fast_math so expf/logf/tanhf keep
// their accurate forms and (onehot + p) - p is not reassociated.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mrssm {

constexpr int kThreads = 128;
// -log(3) rounded to f32: the constant of the JAX package's fusion.
constexpr float kLogThird = -1.0986122886681098f;
// The most weight tensors a kernel stages (the MMTRSSM recurrence's 28).
constexpr int kMaxWeights = 28;

// ELU as the JAX kernels write it (expm1 is not in their lowering).
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(x) - 1.f; }

// ELU's derivative at the pre-activation.
__device__ __forceinline__ float d_elu(float pre) { return pre > 0.f ? 1.f : expf(pre); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void elu_rows(const float* pre, float* y, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = elu(pre[i]);
}

// ---- weights ----------------------------------------------------------------

// Device pointers of a kernel's weight tensors (torch layout), in its order.
struct WeightPtrs {
  const float* p[kMaxWeights];
};

// WeightPtrs of the n device pointers in a host array (a C entry point's
// `weights` argument).
inline WeightPtrs weight_ptrs(const void* const* weights, int n) {
  WeightPtrs w;
  for (int i = 0; i < n; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  return w;
}

// Per weight tensor: [in, out] in shared memory (a bias has in = 1), its
// offset in the flat weight (and gradient) buffer, and the total size.
struct WeightDims {
  int n;
  int in[kMaxWeights], out[kMaxWeights], off[kMaxWeights];
  int total;
};

inline WeightDims weight_dims(const int* in, const int* out, int n) {
  WeightDims d;
  d.n = n;
  int off = 0;
  for (int i = 0; i < n; ++i) {
    d.in[i] = in[i];
    d.out[i] = out[i];
    d.off[i] = off;
    off += in[i] * out[i];
  }
  d.total = off;
  return d;
}

// ---- forward building blocks -----------------------------------------------

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

// One MTRNN step for rows < rows, JAX mtrnn_apply's association:
// u = (d·Wd + bd) + (x·Wi + bi), hid' = keep·hid + u·inv (hid updated in
// place), d' = tanh(hid'). d rows (width N) have stride sd, x rows (width
// nx) stride sx; Wd [N, N] and Wi [nx, N] in shared memory. d' must not
// alias d.
__device__ __forceinline__ void mtrnn_rows(const float* d, int sd, const float* x, int nx,
                                           int sx, const float* Wd, const float* bd,
                                           const float* Wi, const float* bi, int N, float* hid,
                                           int shid, float* d_new, int sdn, float inv,
                                           float keep, int rows) {
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    const int r = i / N, o = i - r * N;
    const float* a = d + r * sd;
    float acc_d = 0.f;
    for (int k = 0; k < N; ++k) acc_d = fmaf(a[k], Wd[k * N + o], acc_d);
    const float* c = x + r * sx;
    float acc_x = 0.f;
    for (int k = 0; k < nx; ++k) acc_x = fmaf(c[k], Wi[k * N + o], acc_x);
    const float u = (acc_d + bd[o]) + (acc_x + bi[o]);
    float* h = hid + r * shid + o;
    const float v = keep * *h + u * inv;
    *h = v;
    d_new[r * sdn + o] = tanhf(v);
  }
}

// Full-axis log-softmax statistics of each row's audio and vision logits
// (the reference fusion normalises over all S logits, not per block): audio
// logits at lg[r * sl + s], vision at lg[r * sl + S + s]; stat[r * 4 + 2m]
// is the max and stat[r * 4 + 2m + 1] the log-sum-exp, m = 0 audio, 1 vision.
__device__ __forceinline__ void mopoe_stats(const float* lg, int sl, int S, float* stat,
                                            int rows) {
  for (int i = threadIdx.x; i < rows * 2; i += blockDim.x) {
    const int r = i / 2, m = i - r * 2;
    const float* x = lg + r * sl + m * S;
    float mx = x[0];
    for (int s = 1; s < S; ++s) mx = fmaxf(mx, x[s]);
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += expf(x[s] - mx);
    stat[r * 4 + 2 * m] = mx;
    stat[r * 4 + 2 * m + 1] = logf(sum);
  }
}

// mixed[r * S + s]: the equal-weight mixture of {A}, {V} and the
// unnormalised PoE {A+V} (after mopoe_stats; layout as there).
__device__ __forceinline__ void mopoe_mix(const float* lg, int sl, const float* stat, int S,
                                          float* mixed, int rows) {
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
    const int r = i / S, s = i - r * S;
    const float* st = stat + r * 4;
    const float la = (lg[r * sl + s] - st[0]) - st[1];
    const float lv = (lg[r * sl + S + s] - st[2]) - st[3];
    const float f = la + lv;
    const float m = fmaxf(fmaxf(la, lv), f);
    mixed[i] = (m + kLogThird) + logf(expf(la - m) + expf(lv - m) + expf(f - m));
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

// Per-block softmax p = e / sum(e), e = exp(l - max), of one category block.
__device__ __forceinline__ void block_softmax(const float* logits, int K, float* p) {
  float mx = logits[0];
  for (int j = 1; j < K; ++j) mx = fmaxf(mx, logits[j]);
  float sum = 0.f;
  for (int j = 0; j < K; ++j) sum += expf(logits[j] - mx);
  for (int j = 0; j < K; ++j) p[j] = expf(logits[j] - mx) / sum;
}

// ---- backward building blocks ----------------------------------------------

// dx[r, k] = sum_o dy[r, o] * W[k, o] for k < in, W [in, out] in shared
// memory; times d_elu(pre[r, k]) when pre is given; added to dx when
// accumulate. The o loop starts at k % out so that the threads of a warp
// read different banks.
__device__ __forceinline__ void dense_rows_t(const float* dy, int sdy, const float* W, int in,
                                             int out, float* dx, int sdx, int rows,
                                             const float* pre, int spre, bool accumulate) {
  for (int i = threadIdx.x; i < rows * in; i += blockDim.x) {
    const int r = i / in, k = i - r * in;
    const float* g = dy + r * sdy;
    const float* wk = W + k * out;
    float acc = 0.f;
    int o = k % out;
    for (int j = 0; j < out; ++j) {
      acc = fmaf(g[o], wk[o], acc);
      if (++o == out) o = 0;
    }
    if (pre != nullptr) acc *= d_elu(pre[r * spre + k]);
    float* y = dx + r * sdx + k;
    *y = accumulate ? *y + acc : acc;
  }
}

// d[j] = base[j] + p[j] * (g[j] - <p, g>) over one block: the straight-through
// sample's VJP into its logits (train_step.py::_block_softmax_vjp).
__device__ __forceinline__ void st_vjp(const float* p, const float* g, const float* base, int K,
                                       float* d) {
  float dot = 0.f;
  for (int j = 0; j < K; ++j) dot = fmaf(p[j], g[j], dot);
  for (int j = 0; j < K; ++j) d[j] = base[j] + p[j] * (g[j] - dot);
}

// The largest rows-per-block ≤ R_want whose dynamic shared memory, `fixed`
// floats plus `per_row` floats a row, fits one block on the current device
// (0 if none does).
inline int rows_that_fit(size_t fixed, size_t per_row, int R_want) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  for (int R = R_want; R >= 1; --R) {
    if ((fixed + R * per_row) * sizeof(float) <= (size_t)limit) return R;
  }
  return 0;
}

namespace {

// out (torch layout, [out, in] per tensor) = the blocks' partial sums, added
// in block order; one thread per weight element, reading [in, out] order.
// No float atomics, so two runs give the same bits.
__global__ void reduce_weight_grads(const float* __restrict__ partial, int n_blocks,
                                    WeightDims dims, float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= dims.total) return;
  int i = 0;
  while (i + 1 < dims.n && s >= dims.off[i + 1]) ++i;
  const int local = s - dims.off[i];
  const int k = local / dims.out[i], o = local - k * dims.out[i];
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partial[(size_t)b * dims.total + s];
  out[dims.off[i] + o * dims.in[i] + k] = acc;
}

// The fixed-order reduction of a backward kernel's [n_blocks, dims.total]
// partial weight gradients into d_weights (torch layout, back to back).
cudaError_t reduce_weight_grads_launch(const float* partial, int n_blocks, const WeightDims& dims,
                                       float* d_weights, cudaStream_t stream) {
  reduce_weight_grads<<<(dims.total + 255) / 256, 256, 0, stream>>>(partial, n_blocks, dims,
                                                                  d_weights);
  return cudaGetLastError();
}

}  // namespace

// ---- the MMTRSSM kernels' sizes ------------------------------------------

// Sizes of the MMTRSSM kernels, field for field ops/kernels/build.py::MTDims:
// action A, embed E, higher and lower deter HD/LD, prior/posterior MLP
// width C, modality-head width R, both latents' class × category blocks,
// batch rows per block, and each layer's 1/tau and 1 - 1/tau.
struct MTDims {
  int T, B, A, E, HD, LD, C, R, ls_class, ls_cat, hs_class, hs_cat, rows;
  float l_inv, l_keep, h_inv, h_keep;
};

// The first n (28 for the recurrence, 16 for the rollout) of the MMTRSSM
// weights' [in, out] shapes, in train_step_mt.py::pack_mt_train_params order:
// l_rnn d2h, input2h; h_rnn d2h, input2h; l_prior, h_prior, h_posterior,
// audio and vision heads (two layers each).
inline WeightDims mt_weight_dims(const MTDims& d, int n) {
  const int LS = d.ls_class * d.ls_cat, HS = d.hs_class * d.hs_cat, X = d.A + LS + HS;
  const int in[kMaxWeights] = {d.LD, 1, X, 1, d.HD, 1, HS, 1, d.LD, 1, d.C, 1, d.HD, 1, d.C, 1,
                               d.LD + d.HD, 1, d.C, 1, d.LD + d.E, 1, d.R, 1, d.LD + d.E, 1,
                               d.R, 1};
  const int out[kMaxWeights] = {d.LD, d.LD, d.LD, d.LD, d.HD, d.HD, d.HD, d.HD, d.C, d.C, LS, LS,
                                d.C, d.C, HS, HS, d.C, d.C, HS, HS, d.R, d.R, LS, LS, d.R, d.R,
                                LS, LS};
  return weight_dims(in, out, n);
}

// ---- Philox ---------------------------------------------------------------

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

// Batch row b's Philox key and counter row: its 64-bit seed row_seed[b]
// split into the low and high words, and row_index[b], the row's index
// inside its own request (ops/kernels/rollout.py::row_keys). One request
// has its seed on every row and the index b; rows of coalesced requests
// keep their own request's key and index, and so their own draws.
struct RowKey {
  uint32_t k0, k1, index;
};

__device__ __forceinline__ RowKey row_key(const long long* row_seed, const long long* row_index,
                                          int b) {
  const unsigned long long s = (unsigned long long)__ldg(row_seed + b);
  return {(uint32_t)(s & 0xFFFFFFFFull), (uint32_t)(s >> 32), (uint32_t)__ldg(row_index + b)};
}

// The Gumbel scores -log(-log(u)) that Philox word wd of category block
// `block` gives at step t for a row keyed by `key`: categories 4·wd ..
// 4·wd + 3 of a block of K (those below K), into y[0..3]
// (ops/kernels/rollout.py::philox_block_gumbel).
__device__ __forceinline__ void gumbel_word(float* y, uint32_t t, const RowKey& key,
                                            uint32_t block, int wd, int K) {
  uint32_t ctr[4] = {t, key.index, block, (uint32_t)wd};
  philox4x32_10(ctr, key.k0, key.k1);
  for (int u = 0; u < 4 && 4 * wd + u < K; ++u) y[u] = -logf(-logf(uniform_from_bits(ctr[u])));
}

}  // namespace mrssm
