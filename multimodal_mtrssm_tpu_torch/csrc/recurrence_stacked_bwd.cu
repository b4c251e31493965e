// MoPoE-MRSSM representation recurrence on stacked weights, backward (BPTT).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py::
// _bwd_kernel_stacked (line 190). The stacked layout (recurrence_stacked_fwd.cu)
// folds the 20 weights into 10 tensors so that a TPU step issues fewer,
// wider products; its zero blocks add exact zeros. recurrence_bwd.cu's
// backward gains nothing from the fold: its recompute and its weight-gradient
// GEMMs run over all T·B row-steps at once, and its chain's phase count is
// set by the carries' dataflow, not by the length of a phase's dots. So the
// stacked backward is that backward with other addressing, launched on the
// caller's stream:
//
// 1. stacked_pack_kernel copies the non-zero blocks of the 10 stacked
//    tensors (torch layout) into the 20 tensors recurrence_bwd.cu reads, at
//    the front of the workspace, each from a multiple of 4 floats;
// 2. recurrence_bwd.cu's three passes run on them as they are
//    (mrssm_recurrence_backward_passes: the recompute, the carry-only chain,
//    the deferred GEMMs with their tickets' memset), the 20 gradients into
//    the workspace, the five input cotangents into their outputs;
// 3. stacked_scatter_kernel writes the 20 gradients into the non-zero blocks
//    of the stacked gradients (torch layout, the 10 tensors back to back),
//    whose zero blocks the caller has zeroed. No zero block's gradient is
//    formed: unstack_train_grads would slice it away (the TPU kernel
//    computes it and drops it).
//
// The copies move one float a thread and add nothing, so the unstacked
// gradients and the input cotangents are recurrence_bwd.cu's on the 20
// weights the stacked tensors were made from, bit for bit, and two launches
// give the same bits.
#include "mrssm_common.cuh"

// recurrence_bwd.cu: its three passes on 20 weights, and the scratch they
// need at these sizes.
cudaError_t mrssm_recurrence_backward_passes(
    const mrssm::WeightPtrs& w, const float* actions, const float* a_emb, const float* v_emb,
    const float* prev_deter, const float* prev_stoch, const float* gd, const float* gpl,
    const float* gps, const float* gmx, const float* gpo, float* workspace, float* d_weights,
    float* d_actions, float* d_a_emb, float* d_v_emb, float* d_init_deter, float* d_init_stoch,
    int T, int B, int A, int E, int H, int D, int C, int K, int R, int passes, cudaStream_t s);
extern "C" long long mrssm_recurrence_bwd_workspace(int T, int B, int A, int E, int H, int D,
                                                    int C, int K);

namespace {

constexpr int kNS = 10;  // stacked tensors
constexpr int kNW = 20;  // unstacked tensors
constexpr int kCopyThreads = 256;

inline int round4(int n) { return (n + 3) & ~3; }

// Per unstacked tensor i (recurrence_bwd.cu's order, torch layout [out, in]):
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

// The inverse: the non-zero blocks of d_stacked (the 10 tensors back to
// back) = the 20 gradients (back to back); one thread an element.
__global__ void __launch_bounds__(kCopyThreads)
stacked_scatter_kernel(const float* __restrict__ grads, const __grid_constant__ StackMap m,
                       float* __restrict__ d_stacked) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m.goff[kNW]) return;
  int i, e;
  const int at = stacked_at(m, s, i, e);
  d_stacked[m.soff[m.tgt[i]] + at] = grads[s];
}

}  // namespace

extern "C" {

// Floats of scratch a stacked backward call needs at these sizes: the
// packed weights, the 20 gradients (rounded to 4 floats), then
// recurrence_bwd.cu's workspace.
long long mrssm_stacked_bwd_workspace(int T, int B, int A, int E, int H, int D, int C, int K) {
  const StackMap m = stack_map(A, E, H, D, C * K);
  return (long long)m.packed + round4(m.goff[kNW]) +
         mrssm_recurrence_bwd_workspace(T, B, A, E, H, D, C, K);
}

// Launch on `stream` the pack, the three passes and the scatter. `weights`
// is a host array of the 10 stacked tensors' device pointers (torch layout,
// the order of ops/kernels/recurrence_stacked.py); `workspace` holds
// mrssm_stacked_bwd_workspace floats; d_stacked (the 10 stacked gradients
// back to back) is zeroed by the caller; R is the chain's batch rows a
// block (mrssm_recurrence_bwd_rows). All tensors f32 and contiguous.
// Returns the cudaError_t of the launches (0 on success).
int mrssm_stacked_backward(const void* const* weights, const float* actions, const float* a_emb,
                           const float* v_emb, const float* prev_deter, const float* prev_stoch,
                           const float* gd, const float* gpl, const float* gps, const float* gmx,
                           const float* gpo, float* workspace, float* d_stacked, float* d_actions,
                           float* d_a_emb, float* d_v_emb, float* d_init_deter,
                           float* d_init_stoch, int T, int B, int A, int E, int H, int D, int C,
                           int K, int R, void* stream) {
  const StackMap m = stack_map(A, E, H, D, C * K);
  const int n = m.goff[kNW], blocks = (n + kCopyThreads - 1) / kCopyThreads;
  float* packed = workspace;
  float* grads = packed + m.packed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stacked_pack_kernel<<<blocks, kCopyThreads, 0, s>>>(mrssm::weight_ptrs(weights, kNS), m, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNW; ++i) w.p[i] = packed + m.poff[i];
  err = mrssm_recurrence_backward_passes(w, actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl,
                                         gps, gmx, gpo, grads + round4(n), grads, d_actions,
                                         d_a_emb, d_v_emb, d_init_deter, d_init_stoch, T, B, A, E,
                                         H, D, C, K, R, 7, s);
  if (err != cudaSuccess) return (int)err;
  stacked_scatter_kernel<<<blocks, kCopyThreads, 0, s>>>(grads, m, d_stacked);
  return (int)cudaGetLastError();
}

}  // extern "C"
