// The conv decoder on bf16 features, forward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) at dtype=bfloat16, as fused_decoder_apply (line 766) reaches
// it for bf16 features: a packing launch (decoder_pack_kernel<bf16>, the
// bf16 weights widened to f32 slices), then the forward
// (decoder_fwd_kernel<bf16>), every layer's output rounded to bf16. What it
// computes, what bounds it and its design: fused_decoder_bf16.cuh. HBM sees
// the bf16 [N, F] features, the packed weights once per block (from L2) and
// the bf16 [N, 32, 32, 1] frames.
#include "fused_decoder_bf16.cuh"

extern "C" {

// Launch on `stream`: bf16 features [N, F] → bf16 out [N, 32, 32, 1].
// `weights` is a host array of the n_weights device pointers of
// ops/kernels/fused_conv.py::decoder_weights, all bf16; `packed` f32
// scratch of fused_decoder_sizes' sizes[5] floats (16-byte aligned); all
// contiguous. Returns the cudaError_t of the launches (0 on success).
int fused_decoder_bf16_forward(const void* const* weights, int n_weights,
                               const fdbf::bf16* feats, float* packed, fdbf::bf16* out,
                               fdec::DecDims d, void* stream) {
  fdec::Plan P;
  if (!fdec::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fdec::launch_forward<fdbf::bf16>(mrssm::weight_ptrs(weights, n_weights), P, feats,
                                               packed, out, nullptr, d.N,
                                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
