// What a recurrence forward in three stages needs beside chain_common.cuh
// (recurrence_mt_fwd.cu, the MMTRSSM forward, and recurrence_fwd.cu, the
// MRSSM forward, which the stacked forward runs too), and the imagination
// rollouts in stages (rollout_mt.cu, rollout.cu): the weight blocks a stage
// reads, staged [in, out] in shared memory (the bulk copy brings them in
// torch layout, then the block transposes them) at a row stride that puts a
// phase's lane groups on distinct banks; the per-step prefetch of a step's
// inputs by cp.async; the MoPoE fusion with a warp a row, and the
// straight-through and one-hot samples with a lane an element.
//
// The stages: a prologue computes every step's carry-free partial sums (the
// layers' columns on inputs that no carry feeds) over all T steps of the
// block's rows at once, a warp a row-step; the chain runs the T steps on the
// carries alone, each output a dot split over lanes (chain::dot_part on
// w[k·ws]) or, where a warp takes a row's whole layer, a lane an output
// (dot_lane); an epilogue runs the heads that feed no carry over all T steps
// at once, a warp a row-step.
#pragma once

#include <math.h>

#include "chain_common.cuh"
#include "mrssm_common.cuh"

namespace chain {

// A row stride ≥ out for a weight staged [in, out] whose dots a phase splits
// over P lanes: a warp's 32 / P groups read consecutive outputs of the rows
// k ≡ part (mod P), so a stride ≡ 32 / P (mod 32) puts the warp's 32 reads
// on 32 banks (any stride does for P = 1).
__host__ __device__ inline int lane_stride(int out, int P) {
  if (P == 1) return out;
  const int G = 32 / P;
  return out + ((G - out) % 32 + 32) % 32;
}

// Weight blocks staged [in, out]: entry i is the columns [c0, c0 + nc) of
// weight src (torch layout [out, in]; a bias [out] is [out, 1]), at row
// stride ws from off floats into the staging area; roff is where stage_raw
// puts weight src.
template <int N>
struct StagedWeights {
  int src[N], roff[N], in[N], c0[N], nc[N], out[N], ws[N], off[N];
  int total;  // floats in shared memory
};

// Lay out entry i (the caller fills them in order; `total` grows): the
// columns [c0, c0 + nc) of weight src of `d`, read by dots split over P lanes.
template <int N>
inline void staged_weight(StagedWeights<N>& s, const mrssm::WeightDims& d, int i, int src, int c0,
                          int nc, int P) {
  int roff = 0;
  for (int j = 0; j < src; ++j) roff += round4(d.in[j] * d.out[j]);
  s.src[i] = src;
  s.roff[i] = roff;
  s.in[i] = d.in[src];
  s.c0[i] = c0;
  s.nc[i] = nc;
  s.out[i] = d.out[src];
  s.ws[i] = lane_stride(s.out[i], P);
  s.off[i] = i == 0 ? 0 : s.off[i - 1] + s.nc[i - 1] * s.ws[i - 1];
  s.total = s.off[i] + nc * s.ws[i];
}

// Transpose the staged entries from `raw` (stage_raw's layout) into Wt, in
// 32 × 32 tiles: lane l takes output o0 + l and, at step k, column
// c0 + (l + k) mod 32, so that a warp's reads (row stride `in`) and writes
// (row stride ws) fall on distinct banks for strides ≡ 0, 8 or 16 (mod 32);
// a warp loads four such diagonals before it stores them. Every thread calls
// it; the caller synchronises the block after.
template <int N>
__device__ __forceinline__ void stage_transposed(const StagedWeights<N>& s, const float* raw,
                                                 float* Wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = 0; i < N; ++i) {
    const float* src = raw + s.roff[i] + s.c0[i];
    float* dst = Wt + s.off[i];
    const int nc = s.nc[i], in = s.in[i], ws = s.ws[i], out = s.out[i];
    for (int o0 = 0; o0 < out; o0 += 32) {
      const int o = o0 + lane;
      for (int c0 = 0; c0 < nc; c0 += 32) {
        for (int k = 4 * warp; k < 32; k += 4 * warps) {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + ((lane + k + u) & 31);
            v[u] = o < out && c < nc ? src[o * in + c] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + ((lane + k + u) & 31);
            if (o < out && c < nc) dst[c * ws + o] = v[u];
          }
        }
      }
    }
  }
}

// Start copying n floats from device memory into shared memory over the
// block's threads from `first` on, 4 bytes a cp.async (any alignment); the
// caller commits the group and waits on it.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int first = 0) {
  if ((int)threadIdx.x < first) return;
  for (int i = threadIdx.x - first; i < n; i += blockDim.x - first) {
    fconv::cp_async4(dst + i, src + i);
  }
}

// Σ_k a[k]·w[k·ws] for k < n on one thread, in dot_part's four partial sums.
__device__ __forceinline__ float dot_lane(const float* __restrict__ a,
                                          const float* __restrict__ w, int ws, int n) {
  Split one{};
  one.P = 1;
  return dot_part(a, w, ws, n, one);
}

// Two dots on one thread in one loop, x = Σ_{k<n} a[k]·w[k·ws] and
// y = Σ_{k<m} b[k]·v[k·vs], each in two partial sums (even and odd k): two
// independent chains where one dot_lane would leave the lane waiting.
__device__ __forceinline__ void dot2_lane(const float* __restrict__ a,
                                          const float* __restrict__ w, int ws, int n,
                                          const float* __restrict__ b,
                                          const float* __restrict__ v, int vs, int m, float& x,
                                          float& y) {
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
  const int both = min(n, m);
  int k = 0;
  for (; k + 1 < both; k += 2) {
    x0 = fmaf(a[k], w[k * ws], x0);
    y0 = fmaf(b[k], v[k * vs], y0);
    x1 = fmaf(a[k + 1], w[(k + 1) * ws], x1);
    y1 = fmaf(b[k + 1], v[(k + 1) * vs], y1);
  }
  for (int i = k; i < n; ++i) x0 = fmaf(a[i], w[i * ws], x0);
  for (int i = k; i < m; ++i) y0 = fmaf(b[i], v[i * vs], y0);
  x = x0 + x1;
  y = y0 + y1;
}

// The MoPoE mixture of one row's S audio logits `la` and S vision logits
// `lv` by one warp: the full-axis log-softmax statistics by butterfly
// shuffles (every lane the same bits), then mrssm::mopoe_mix's arithmetic,
// each lane on the logits s ≡ lane (mod 32), into `mixed` (shared) and
// `out`.
__device__ __forceinline__ void mopoe_warp(const float* la, const float* lv, int S, float* mixed,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  float ma = -INFINITY, mv = -INFINITY;
  for (int s = lane; s < S; s += 32) {
    ma = fmaxf(ma, la[s]);
    mv = fmaxf(mv, lv[s]);
  }
  for (int m = 16; m > 0; m >>= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, m));
    mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, m));
  }
  float sa = 0.f, sv = 0.f;
  for (int s = lane; s < S; s += 32) {
    sa += expf(la[s] - ma);
    sv += expf(lv[s] - mv);
  }
  for (int m = 16; m > 0; m >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, m);
    sv += __shfl_xor_sync(0xffffffffu, sv, m);
  }
  const float lsa = logf(sa), lsv = logf(sv);
  for (int s = lane; s < S; s += 32) {
    const float a = (la[s] - ma) - lsa;
    const float v = (lv[s] - mv) - lsv;
    const float f = a + v;
    const float m = fmaxf(fmaxf(a, v), f);
    const float x = (m + mrssm::kLogThird) + logf(expf(a - m) + expf(v - m) + expf(f - m));
    mixed[s] = x;
    out[s] = x;
  }
}

// The first-index argmax of `score` over the K adjacent lanes of this
// lane's block (K a power of two ≤ 32, blocks aligned to K lanes; j this
// lane's index in its block), by butterfly shuffles of the whole warp:
// every lane of the block gets the block's best index.
__device__ __forceinline__ int argmax_lanes(float score, int j, int K) {
  int best = j;
  for (int m = 1; m < K; m <<= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, score, m);
    const int b = __shfl_xor_sync(0xffffffffu, best, m);
    if (t > score || (t == score && b < best)) {
      score = t;
      best = b;
    }
  }
  return best;
}

// Straight-through samples of one row's `classes` blocks of K values `v`
// with the noise `g` (both in shared memory), a lane of the warp an element
// (all lanes loop together over 32-element slices): the first-index argmax
// of v + g in the element's block and the straight-through value
// ((onehot + p) - p), p = exp(v - max) / Σ exp(v - max), into `carry`
// (shared; none if null) and `out`. Where K is a power of two a block is K
// adjacent lanes and its max, sum and argmax go by shuffles within them (the
// sum in another order than mrssm::block_softmax's); else each lane walks
// its block (block_softmax's order).
// The argmax keeps the first index on ties either way.
__device__ __forceinline__ void st_lanes(const float* v, const float* g, int classes, int K,
                                         float* carry, float* out) {
  const int S = classes * K, lane = threadIdx.x & 31;
  const bool shuffle = (K & (K - 1)) == 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane, e = min(s, S - 1), j = e % K;
    const float x = v[e];
    float mx, p;
    int best;
    if (shuffle) {
      mx = x;
      for (int m = 1; m < K; m <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
      best = argmax_lanes(x + g[e], j, K);
      const float ex = expf(x - mx);
      float sum = ex;
      for (int m = 1; m < K; m <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
      p = ex / sum;
    } else {
      const float* vb = v + (e - j);
      mx = vb[0];
      for (int i = 1; i < K; ++i) mx = fmaxf(mx, vb[i]);
      float sum = 0.f;
      for (int i = 0; i < K; ++i) sum += expf(vb[i] - mx);
      best = mrssm::block_argmax(vb, g + (e - j), K);
      p = expf(x - mx) / sum;
    }
    const float y = ((j == best ? 1.f : 0.f) + p) - p;
    if (s < S) {
      if (carry != nullptr) carry[s] = y;
      out[s] = y;
    }
  }
}

// Exact one-hot samples (the imagination rollouts' carries) of one row's
// `classes` blocks of K logits `v` with the noise `g` (both in shared
// memory), a lane of the warp an element (all lanes loop together over
// 32-element slices): the first-index argmax of v + g in each block, as
// st_lanes takes it, written as 1 or 0 into `out`, and the chosen column,
// col0 + its index in v, into sel[block] (shared) for the next step's
// gather of weight columns.
__device__ __forceinline__ void onehot_lanes(const float* v, const float* g, int classes, int K,
                                             int col0, int* sel, float* out) {
  const int S = classes * K, lane = threadIdx.x & 31;
  const bool shuffle = (K & (K - 1)) == 0 && K <= 32;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane, e = min(s, S - 1), j = e % K;
    const int best = shuffle ? argmax_lanes(v[e] + g[e], j, K)
                             : mrssm::block_argmax(v + (e - j), g + (e - j), K);
    if (s < S) {
      out[s] = j == best ? 1.f : 0.f;
      if (j == 0) sel[s / K] = col0 + s + best;
    }
  }
}

}  // namespace chain
