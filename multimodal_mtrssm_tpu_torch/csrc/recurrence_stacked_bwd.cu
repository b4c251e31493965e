// MoPoE-MRSSM representation recurrence on stacked weights, backward (BPTT).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py::
// _bwd_kernel_stacked (line 190). The stacked layout (ops/kernels/
// recurrence_stacked.py) folds the 20 weights into 10 tensors so that a TPU
// step issues fewer, wider products; its zero blocks add exact zeros.
// recurrence_bwd.cu's backward gains nothing from the fold: its recompute
// and its weight-gradient GEMMs run over all T·B row-steps at once, and its
// chain's phase count is set by the carries' dataflow, not by the length of
// a phase's dots. So the stacked backward is that backward with other
// addressing, launched on the caller's stream:
//
// 1. stacked_pack_kernel (stack_map.cuh) copies the non-zero blocks of the
//    10 stacked tensors (torch layout) into the 20 tensors recurrence_bwd.cu
//    reads, at the front of the workspace, each from a multiple of 4 floats;
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
#include "stack_map.cuh"

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
  float* grads = workspace + m.packed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mrssm::WeightPtrs w;
  cudaError_t err = pack_stacked(weights, m, workspace, w, s);
  if (err != cudaSuccess) return (int)err;
  err = mrssm_recurrence_backward_passes(w, actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl,
                                         gps, gmx, gpo, grads + round4(n), grads, d_actions,
                                         d_a_emb, d_v_emb, d_init_deter, d_init_stoch, T, B, A, E,
                                         H, D, C, K, R, 7, s);
  if (err != cudaSuccess) return (int)err;
  stacked_scatter_kernel<<<blocks, kCopyThreads, 0, s>>>(grads, m, d_stacked);
  return (int)cudaGetLastError();
}

}  // extern "C"
