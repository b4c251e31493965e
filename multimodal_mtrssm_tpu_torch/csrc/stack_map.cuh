// Where the 20 MRSSM recurrence weights lie in the 10 stacked tensors
// (ops/kernels/recurrence_stacked.py::stack_train_params), and the pack that
// copies their non-zero blocks back into the 20-tensor layout the MRSSM
// kernels read: shared by the stacked forward (recurrence_stacked_fwd.cu)
// and backward (recurrence_stacked_bwd.cu), which run the MRSSM kernels on
// the packed weights.
#pragma once

#include <cuda_runtime.h>

#include "mrssm_common.cuh"

namespace {

constexpr int kNS = 10;  // stacked tensors
constexpr int kNW = 20;  // unstacked tensors
constexpr int kCopyThreads = 256;

inline int round4(int n) { return (n + 3) & ~3; }

// Per unstacked tensor i (the MRSSM kernels' order, torch layout [out, in]):
// its `in`, its offset among the 20 gradients (back to back, as the GEMMs
// write them; goff[kNW] is their total) and among the packed weights (each
// from a multiple of 4 floats; `packed` floats in all), and where its
// element (o, k) lies in the stacked tensors: tensor tgt, at [out_off + o,
// in_off + k (+ shift for k ≥ split)] of its [out, in] layout, `sin` floats
// a row. soff is each stacked tensor's offset in the stacked gradients.
struct StackMap {
  int in[kNW], goff[kNW + 1], poff[kNW];
  int tgt[kNW], in_off[kNW], out_off[kNW], split[kNW], shift[kNW], sin[kNW];
  int soff[kNS];
  int packed;
};

StackMap stack_map(int A, int E, int H, int D, int S) {
  const int X = A + S, G = 3 * D, G2 = 6 * D, DE = D + E, NO = 1 << 30;
  // The 20 tensors' [in, out] (w1 b1 w2 b2 wih bih whh bhh wp1 bp1 wp2 bp2
  // wa1 ba1 wa2 ba2 wv1 bv1 wv2 bv2), and the 10 stacked tensors' (w1 b1 w2
  // b2 wg bg wc1 bc1 wc2 bc2).
  const int in[kNW] = {X, 1, H, 1, H, 1, D, 1, D, 1, H, 1, DE, 1, H, 1, DE, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S, H, H, S, S, H, H, S, S};
  const int s_in[kNS] = {X, 1, H, 1, H + D, 1, D + 2 * E, 1, 3 * H, 1};
  const int s_out[kNS] = {H, H, H, H, G2, G2, 3 * H, 3 * H, 3 * S, 3 * S};
  const int tgt[kNW] = {0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 6, 7, 8, 9, 6, 7, 8, 9};
  const int in_off[kNW] = {0, 0, 0, 0, 0, 0, H, 0, 0, 0, 0, 0, 0, 0, H, 0, 0, 0, 2 * H, 0};
  const int out_off[kNW] = {0, 0, 0, 0, 0, 0, G, G, 0, 0, 0, 0, H, H, S, S, 2 * H, 2 * H,
                            2 * S, 2 * S};
  StackMap m;
  for (int t = 0, off = 0; t < kNS; off += s_in[t] * s_out[t], ++t) m.soff[t] = off;
  m.goff[0] = m.packed = 0;
  for (int i = 0; i < kNW; ++i) {
    m.in[i] = in[i];
    m.goff[i + 1] = m.goff[i] + in[i] * out[i];
    m.poff[i] = m.packed;
    m.packed += round4(in[i] * out[i]);
    m.tgt[i] = tgt[i];
    m.in_off[i] = in_off[i];
    m.out_off[i] = out_off[i];
    m.split[i] = NO;
    m.shift[i] = 0;
    m.sin[i] = s_in[tgt[i]];
  }
  // wc1's vision rows: wv1's deter columns, E zero columns (the audio
  // embedding's), then its embedding columns.
  m.split[16] = D;
  m.shift[16] = E;
  return m;
}

// Unstacked element s (0 ≤ s < m.goff[kNW]): its tensor i, its offset e in
// that tensor, and (returned) its offset in stacked tensor m.tgt[i].
__device__ __forceinline__ int stacked_at(const StackMap& m, int s, int& i, int& e) {
  i = 0;
  while (i + 1 < kNW && s >= m.goff[i + 1]) ++i;
  e = s - m.goff[i];
  const int o = e / m.in[i], k = e - o * m.in[i];
  return (m.out_off[i] + o) * m.sin[i] + m.in_off[i] + k + (k >= m.split[i] ? m.shift[i] : 0);
}

// packed[poff[i] + e] = element e of unstacked tensor i, read from its
// stacked tensor; one thread an element.
__global__ void __launch_bounds__(kCopyThreads)
stacked_pack_kernel(const __grid_constant__ mrssm::WeightPtrs stacked,
                    const __grid_constant__ StackMap m, float* __restrict__ packed) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m.goff[kNW]) return;
  int i, e;
  const int at = stacked_at(m, s, i, e);
  packed[m.poff[i] + e] = __ldg(stacked.p[m.tgt[i]] + at);
}

// Launch the pack of the 10 stacked tensors (`weights`: a host array of
// their device pointers) into `packed` on `s`; returns the 20 packed
// tensors' device pointers in `w`.
inline cudaError_t pack_stacked(const void* const* weights, const StackMap& m, float* packed,
                                mrssm::WeightPtrs& w, cudaStream_t s) {
  const int blocks = (m.goff[kNW] + kCopyThreads - 1) / kCopyThreads;
  stacked_pack_kernel<<<blocks, kCopyThreads, 0, s>>>(mrssm::weight_ptrs(weights, kNS), m, packed);
  for (int i = 0; i < kNW; ++i) w.p[i] = packed + m.poff[i];
  return cudaGetLastError();
}

}  // namespace
