// The conv decoder, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461), the custom VJP of fused_decoder_apply's segments (lines
// 530-558): the gradients of every decoder weight and bias and, when asked,
// of the features, which JAX returns from the first segment (_walk_bwd's
// dh0). Like the TPU backward it recomputes the activations from the input
// instead of keeping the forward's. Six launches in five steps, the fused
// encoder's (fused_encoder_bwd.cu), built from the same pieces
// (conv_common.cuh):
//
// 1. the forward (fused_decoder.cuh: decoder_pack_kernel, then
//    decoder_fwd_kernel) recomputes each tile and records every layer's
//    output in device memory (17,520 floats a frame at the reference widths
//    and 48-wide features);
// 2. decoder_bwd_pack_kernel lays out the transposed slices, each layer's
//    weights as [Ci][tap][Co], the last layer first, read from the layer's
//    own torch layout (fdec::weight_index): a conv's taps flipped in space,
//    so that its input cotangent is a stride-1 conv of its pre-activation
//    cotangent; a transposed conv's (k4 s2 p1) in torch order, since its
//    input cotangent is the direct stride-2 conv dx[i] = Σ over t, co of
//    dpre[2i − 1 + t][co] · W[ci][co][t]; the unflatten's in torch order,
//    one output position a tap (dx[ci] = Σ over pos, co of dpre[pos][co] ·
//    W[co·h·w + pos][ci]);
// 3. decoder_bwd_dx_kernel (fconv::cotangent_pass, shared by both stacks)
//    walks the layers in reverse per tile of frames, the cotangents in
//    shared memory: each layer's input cotangent is an
//    implicit GEMM of its pre-activation cotangent with the transposed
//    slices (M = frames × input positions, N = Ci, K = Co × taps), and its
//    epilogue adds the residual skip where the block's input receives it,
//    multiplies by the ELU derivative of the layer below (from the recorded
//    output, as fused_conv.py::_act_deriv) and records that layer's
//    pre-activation cotangent (17,472 floats a frame), or writes the
//    features' cotangent;
// 4. decoder_bwd_dw_kernel forms the weight and bias gradients of each
//    layer as a blocked GEMM a tap (fconv::weight_grad_block) over both
//    records staged in shared memory;
// 5. mrssm::reduce_weight_grads adds the chunks in order and writes torch
//    layout. No float atomics anywhere, so two runs give the same bits.
//
// What bounds it: operations, ~35 MFLOP a frame (the recompute, the input
// cotangents and the weight gradients each about the forward's ~11.8) in
// f32 FMA; the records (~140 KB a frame) stay in L2 at N=240. The first
// forms of steps 3-4 gave a thread one output: in the cotangent pass a
// dependent FMA chain over Co a tap with two scalar shared loads an FMA,
// the weights restaged from torch layout a chunk of input channels at a
// time behind two barriers, every tap tested for divisibility; in the
// weight-gradient pass one gradient element, both records read from device
// memory a float at a time. Here:
// - the cotangent pass is the encoder's: a thread owns one input position
//   of both frames of the tile and 4 input channels and reads float4s of 4
//   output channels; the slices stream through two buffers by the bulk copy
//   (TMA) on mbarriers; narrow tasks are split, their sums added in a fixed
//   order. Input positions go row-major: walked from its small input map, a
//   transposed conv uses every tap inside the border (no parity classes),
//   and a conv walks at stride 1 (no tap tested for divisibility). The last
//   transposed conv has one output channel, so its reduction runs over C =
//   Co = 1 in the scalar form (fconv::dot_scalar). The last layer's Tanh
//   derivative (1 − out²) is applied where the frames' cotangent is read;
// - the weight-gradient pass is the encoder's: a block takes one tap of one
//   layer, a tile of ≤ 64 × ≤ 64 channels and one chunk of frames, stages
//   both records by cp.async into two buffers, and a thread holds 4 × 4
//   accumulators. A transposed conv swaps the records' roles: the block
//   walks its input positions u (the side the tap relation maps directly
//   from), the activation at u and the cotangent at 2u − 1 + t; the
//   unflatten is the same at stride 1 from its 1×1 map, one position a tap,
//   a GEMM over frames. Biases (fconv::DwBias): a conv's from its tap (p,
//   p); a transposed conv's from its tap (1, 1), each input position u
//   adding the 2×2 output block at 2u that the four taps (1|2, 1|2) reach
//   from u (every output position once, in a fixed order); the unflatten's
//   element (co, pos) from its tap pos.
//
// Measured (chip_smoke.py's decoder_timings, NVIDIA H100 80GB HBM3, 700 W,
// PERF.md §6): at N=240 the cotangent pass takes ~0.35 ms of device time
// and the weight-gradient pass ~0.34 (the first forms 3.53 and 3.38), a
// whole call ~1.09 ms against ~7.30; at N=3840 5.3 and 4.6 ms (55.5 and
// 47.8), a call ~14.9 against ~108. Both passes run at ~4-5 TMAC/s, the
// encoder's passes' rate, ~8× their share of the bound: the cotangent pass
// runs one block of 8 warps an SM; the weight-gradient pass restages a
// chunk's records once per tap (k·k times a layer).
//
// The passes live in fused_decoder.cuh (fdec::launch_backward), which the
// bf16 backward (fused_decoder_bf16_bwd.cu) shares.
#include "fused_decoder.cuh"

extern "C" {

// Launch on `stream` the steps above. feats [N, F], g [N, 32, 32, 1];
// dfeats [N, F] or null; d_weights the gradient floats
// (fused_decoder_sizes' sizes[2]) in torch layout, every tensor back to
// back; stash, dstash and partial are scratch of N·sizes[0], N·sizes[1]
// and sizes[3]·sizes[2] floats, packed of sizes[4] floats (16-byte
// aligned). All f32 and contiguous. Returns the cudaError_t of the launches
// (0 on success).
int fused_decoder_backward(const void* const* weights, int n_weights, const float* feats,
                           const float* g, float* dfeats, float* d_weights, float* stash,
                           float* dstash, float* partial, float* packed, fdec::DecDims d,
                           void* stream) {
  fdec::Plan P;
  if (!fdec::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fdec::launch_backward<float>(mrssm::weight_ptrs(weights, n_weights), P, d, feats,
                                           g, dfeats, d_weights, stash, dstash, partial, packed,
                                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
