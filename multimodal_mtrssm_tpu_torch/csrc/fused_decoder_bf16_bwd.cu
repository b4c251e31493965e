// The conv decoder on bf16 features, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461) at dtype=bfloat16, the custom VJP of fused_decoder_apply's
// segments (lines 530-558) for bf16 features: the gradients of every
// decoder weight and bias and, when asked, of the features. The f32
// backward's steps (fused_decoder_bwd.cu, fdec::launch_backward) at T =
// bf16, then the rounding:
//
// 1. the bf16 forward (decoder_pack_kernel<bf16>, decoder_fwd_kernel<bf16>)
//    recomputes each tile, every layer's output rounded to bf16, and records
//    it in f32 words;
// 2. decoder_bwd_pack_kernel<bf16> lays out the transposed slices of the
//    bf16 weights, widened to f32;
// 3. decoder_bwd_dx_kernel<bf16> seeds the cotangent pass with the bf16
//    frames' cotangent times the Tanh derivative of the rounded frames and
//    walks the layers in reverse in f32, each activation derivative from
//    the rounded record, into the f32 features' cotangent;
// 4. decoder_bwd_dw_kernel and reduce_weight_grads form the f32 weight and
//    bias gradients over the rounded records and the f32 cotangents, in a
//    fixed order;
// 5. decoder_bf16_round_kernel rounds the weight gradients and the
//    features' cotangent to bf16 (JAX casts its f32 gradient accumulators
//    to the operand dtype, line 555).
//
// What bounds it and its design: fused_decoder_bf16.cuh.
#include "fused_decoder_bf16.cuh"

extern "C" {

// Launch on `stream` the steps above. feats [N, F] and g [N, 32, 32, 1]
// bf16; dfeats [N, F] bf16 or null; d_weights the gradient elements
// (fused_decoder_sizes' sizes[2]) in bf16, torch layout, every tensor back
// to back. f32 scratch: stash, dstash and partial of N·sizes[0],
// N·sizes[1] and sizes[3]·sizes[2] floats, dw32 of sizes[2] floats, dfeats32
// of N·F floats, packed of sizes[4] floats (each 16-byte aligned). All
// contiguous. Returns the cudaError_t of the launches (0 on success).
int fused_decoder_bf16_backward(const void* const* weights, int n_weights,
                                const fdbf::bf16* feats, const fdbf::bf16* g,
                                fdbf::bf16* dfeats, fdbf::bf16* d_weights, float* stash,
                                float* dstash, float* partial, float* dw32, float* dfeats32,
                                float* packed, fdec::DecDims d, void* stream) {
  fdec::Plan P;
  if (!fdec::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fdec::launch_backward<fdbf::bf16>(
      mrssm::weight_ptrs(weights, n_weights), P, d, feats, g,
      dfeats == nullptr ? nullptr : dfeats32, dw32, stash, dstash, partial, packed, s);
  if (err != cudaSuccess) return (int)err;
  err = fdbf::round_to_bf16(dw32, d_weights, fdec::grad_dims(P).total, s);
  if (err != cudaSuccess || dfeats == nullptr) return (int)err;
  return (int)fdbf::round_to_bf16(dfeats32, dfeats, (long long)d.N * d.F, s);
}

}  // extern "C"
