// MoPoE-MRSSM representation recurrence on stacked weights, forward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py::
// _fwd_kernel_stacked (line 164). The stacked layout (ops/kernels/
// recurrence_stacked.py) folds the 20 weights into 10 tensors so that a TPU
// step issues five wider products instead of ten; its zero blocks add exact
// zeros. recurrence_fwd.cu's kernel gains nothing from the fold: its chain's
// phase count is set by the carries' dataflow, and a phase costs the same
// whatever the length of its dots. So the stacked forward is that kernel on
// the stacked tensors' non-zero blocks, launched on the caller's stream:
//
// 1. stacked_pack_kernel (stack_map.cuh) copies the non-zero blocks of the
//    10 stacked tensors (torch layout) into the 20 tensors recurrence_fwd.cu
//    reads, at the front of the workspace, each from a multiple of 4 floats;
// 2. recurrence_fwd.cu's kernel runs its three stages on them
//    (mrssm_recurrence_forward_stages), its prologue's sums in the rest of
//    the workspace.
//
// The pack moves one float a thread and adds nothing, so the outputs are
// recurrence_fwd.cu's on the 20 weights the stacked tensors were made from,
// bit for bit.
#include "mrssm_common.cuh"
#include "stack_map.cuh"

// recurrence_fwd.cu: its stages on 20 weights.
cudaError_t mrssm_recurrence_forward_stages(const mrssm::WeightPtrs& w, const float* actions,
                                            const float* a_emb, const float* v_emb,
                                            const float* init_deter, const float* init_stoch,
                                            const float* g_prior, const float* g_post,
                                            float* deter_out, float* prior_logits_out,
                                            float* prior_stoch_out, float* mixed_out,
                                            float* post_stoch_out, float* workspace, int T,
                                            int B, int A, int E, int H, int D, int C, int K,
                                            int R, int stages, cudaStream_t s);

extern "C" {

// Floats of scratch a stacked forward call needs at these sizes: the packed
// weights, then the prologue's sums ([T, B, 3H]).
long long mrssm_stacked_fwd_workspace(int T, int B, int A, int E, int H, int D, int C, int K) {
  return (long long)stack_map(A, E, H, D, C * K).packed + (long long)T * B * 3 * H;
}

// Launch on `stream` the pack and the forward kernel. `weights` is a host
// array of the 10 stacked tensors' device pointers (torch layout, the order
// of ops/kernels/recurrence_stacked.py); `workspace` holds
// mrssm_stacked_fwd_workspace floats; R is the batch rows a block
// (mrssm_recurrence_fwd_rows). All tensors f32 and contiguous. Returns the
// cudaError_t of the launches (0 on success).
int mrssm_stacked_forward(const void* const* weights, const float* actions, const float* a_emb,
                          const float* v_emb, const float* init_deter, const float* init_stoch,
                          const float* g_prior, const float* g_post, float* deter_out,
                          float* prior_logits_out, float* prior_stoch_out, float* mixed_out,
                          float* post_stoch_out, float* workspace, int T, int B, int A, int E,
                          int H, int D, int C, int K, int R, void* stream) {
  const StackMap m = stack_map(A, E, H, D, C * K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mrssm::WeightPtrs w;
  cudaError_t err = pack_stacked(weights, m, workspace, w, s);
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm_recurrence_forward_stages(
      w, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, deter_out,
      prior_logits_out, prior_stoch_out, mixed_out, post_stoch_out, workspace + m.packed, T, B, A,
      E, H, D, C, K, R, 7, s);
}

}  // extern "C"
