// The conv decoder on bf16 features, forward (design notes in
// fused_decoder_bf16.cuh).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) at dtype=bfloat16, as fused_decoder_apply (line 766) reaches
// it for bf16 features: a packing launch, then the forward on the tensor
// cores, every activation of a tile of frames in shared memory; HBM sees
// the bf16 [N, F] features, the packed bf16 weights (from L2, streamed
// slice by slice) and the bf16 [N, 32, 32, 1] frames.
#include "fused_decoder_bf16.cuh"

extern "C" {

// Sizes for `d`: sizes[0] the bf16 elements a frame of the backward's
// activation record, [1] the floats a frame of its pre-activation cotangent
// record (two bf16 terms each, hi and lo), [2] the gradient elements (all
// tensors back to back, torch layout), [3] the weight-gradient pass's
// partial-sum slots of sizes[2] floats (its frame chunks), [4] the bf16
// elements of the packed weights (both directions), [5] and [6] the frames
// a block of the forward and of the cotangent pass, [7] the tiles of the
// weight-gradient pass. Returns 0, or -1 where the plan does not fit.
int fused_decoder_bf16_sizes(fdbf::DecDims d, long long* sizes) {
  fdbf::Plan P;
  if (!fdbf::make_plan(d, &P)) return -1;
  sizes[0] = P.stash;
  sizes[1] = P.dstash / 2;
  sizes[2] = P.grads;
  sizes[3] = (d.N + d.chunk - 1) / d.chunk;
  sizes[4] = P.packed;
  sizes[5] = P.F;
  sizes[6] = P.F;
  sizes[7] = P.dw_tiles;
  return 0;
}

// Launch on `stream`: bf16 features [N, F] → bf16 out [N, 32, 32, 1].
// `weights` is a host array of the n_weights device pointers of the bf16
// tensors of ops/kernels/fused_conv.py::decoder_weights; `packed` scratch of
// sizes[4] bf16 elements. Returns the cudaError_t of the launches.
int fused_decoder_bf16_forward(const void* const* weights, int n_weights,
                               const fdbf::bf16* feats, fdbf::bf16* packed, fdbf::bf16* out,
                               fdbf::DecDims d, void* stream) {
  fdbf::Plan P;
  if (!fdbf::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fdbf::launch_forward(fdbf::weight_ptrs(weights, n_weights), P, feats, packed, out,
                                   nullptr, d.N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
