// The conv decoder in bf16: shared code of fused_decoder_bf16_fwd.cu and
// fused_decoder_bf16_bwd.cu.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) and ::_bwd_kernel (line 461) at dtype=bfloat16, as
// fused_decoder_apply (line 766) reaches them for bf16 features (line 781:
// dtype = feats.dtype; build_decoder_operators, line 686, casts every
// operator to it). The numerics are JAX's _layer_fwd (lines 266-299) and
// _walk_bwd (line 331) at bf16: features, weights, activations and frames
// are bf16 values; each layer sums its products in f32, adds the bias and
// applies ELU (the residual skip added before it) or the last layer's Tanh
// in f32, then rounds its output to bf16 (round to nearest even). The
// backward recomputes those activations, keeps every cotangent in f32,
// takes each activation derivative from the rounded output (ELU o > 0 ? 1 :
// o + 1, Tanh 1 − o², JAX's _act_deriv), sums the weight gradients in f32
// (JAX's f32 accumulators, lines 542-546) and rounds the features'
// cotangent and the weight gradients to bf16 at the end. Unlike JAX it does
// not round the cotangent to bf16 where JAX cuts the stack into four
// segments (the linears and the residual stack, then one a transposed conv,
// line 547): here there is one stack, as in the bf16 encoder.
//
// What bounds it: operations, ~5.9 M multiply-adds a frame at 48-wide
// features (83% in the residual 3×3 convs at 4×4), ~0.0029 ms at N=240 at
// the card's 989 TFLOP/s bf16; bytes are a few hundred KB a call. Design:
// the f32 decoder's kernels (fused_decoder.cuh on conv_common.cuh: an
// implicit GEMM a layer, transposed convs by output-parity class, weight
// slices streamed by the bulk copy, split tasks summed in a fixed order),
// instantiated at T = bf16: the packing kernels widen the bf16 weights to
// f32 slices, the forward widens the bf16 features and biases as it loads
// them and rounds every layer's output to bf16 in its epilogue (round_to),
// so that shared memory and the backward's records hold bf16 values in f32
// words, and every product of two of them is exact in the f32 FMA. It is a
// kernel that is right, not a fast one: it runs on the CUDA cores in f32 at
// the f32 kernels' rate and moves the f32 kernels' shared-memory and record
// bytes; the bf16 encoder's tensor-core pieces (fused_encoder_bf16.cuh:
// mma.sync m16n8k16 on bf16 maps, split hi/lo cotangents) are the way to
// its bound. The f32 sums of the cotangent and weight-gradient passes are
// the f32 decoder's, on the rounded records; decoder_bf16_round_kernel
// then rounds the f32 features' cotangent and weight gradients to bf16. No
// float atomics anywhere: two launches give the same bits.
#pragma once

#include <cuda_bf16.h>

#include "fused_decoder.cuh"

namespace fdbf {

typedef __nv_bfloat16 bf16;

namespace {

// out[i] = in[i] rounded to bf16 (to nearest even), i < n.
__global__ void decoder_bf16_round_kernel(const float* __restrict__ in, bf16* __restrict__ out,
                                          long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16_rn(in[i]);
  }
}

// decoder_bf16_round_kernel on `stream`.
inline cudaError_t round_to_bf16(const float* in, bf16* out, long long n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + 255) / 256;
  decoder_bf16_round_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdbf
