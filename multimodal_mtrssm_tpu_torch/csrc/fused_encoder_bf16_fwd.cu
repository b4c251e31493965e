// The conv encoder in bf16, forward (design notes in fused_encoder_bf16.cuh).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) at dtype=bfloat16, as fused_encoder_apply (line 561) reaches
// it: a packing launch, then the forward on the tensor cores, every
// activation of a tile of frames in shared memory; HBM sees the bf16
// frames, the packed bf16 weights (from L2, streamed slice by slice) and
// the bf16 [N, out] embedding.
#include "fused_encoder_bf16.cuh"

extern "C" {

// Sizes for `d`: sizes[0] the bf16 elements a frame of the backward's
// activation record, [1] the floats a frame of its pre-activation
// cotangent record (two bf16 halves each), [2] the gradient elements (all
// tensors back to back, torch layout), [3] the weight-gradient pass's
// partial-sum slots of sizes[2] floats (its frame chunks, and room for the
// first layers' parts of each chunk), [4] the bf16 elements of the packed weights (both
// directions), [5] and [6] the frames a block of the forward and of the
// cotangent pass, [7] the tiles of the weight-gradient pass. Returns 0, or
// -1 where the plan does not fit.
int fused_encoder_bf16_sizes(fbf::EncDims d, long long* sizes) {
  fbf::Plan P;
  if (!fbf::make_plan(d, &P)) return -1;
  sizes[0] = P.stash;
  sizes[1] = P.dstash;
  sizes[2] = P.grads;
  const long long chunks = (d.N + d.chunk - 1) / d.chunk;
  sizes[3] = chunks + (chunks * (fbf::kDwSub - 1) * P.dw_small + P.grads - 1) / P.grads;
  sizes[4] = P.packed;
  sizes[5] = P.F;
  sizes[6] = P.F;
  sizes[7] = P.dw_tiles;
  return 0;
}

// Launch on `stream`: bf16 frames x [N, H, W, C0] → bf16 out [N, out_dim].
// `weights` is a host array of the n_weights device pointers of the bf16
// tensors of ops/kernels/fused_conv.py::encoder_weights; `coords` the
// [H + W] CoordConv values (f32 holding bf16 values); `packed` scratch of
// sizes[4] bf16 elements. Returns the cudaError_t of the launches.
int fused_encoder_bf16_forward(const void* const* weights, int n_weights, const fbf::bf16* x,
                               const float* coords, fbf::bf16* packed, fbf::bf16* out,
                               fbf::EncDims d, void* stream) {
  fbf::Plan P;
  if (!fbf::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fbf::launch_forward(fbf::weight_ptrs(weights, n_weights), P, x, coords, packed, out,
                                  nullptr, d.N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
