// The conv encoder, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461), the custom VJP of fused_encoder_apply (lines 530-558): the
// gradients of every encoder weight and bias and, when asked, of the
// frames. Like the TPU backward it recomputes the activations from the
// input instead of keeping the forward's. Five launches:
//
// 1. the forward (fused_encoder.cuh: encoder_pack_kernel, then
//    encoder_fwd_kernel) recomputes each tile and records every layer's
//    output in device memory (13,824 floats a frame at the reference
//    widths);
// 2. encoder_bwd_pack_kernel lays out the transposed slices (Slice, in
//    conv_common.cuh): each layer's weights flipped in space as
//    [Ci][tap][Co], the last layer first;
// 3. encoder_bwd_dx_kernel (fconv::cotangent_pass, shared by both stacks)
//    walks the layers in reverse per tile of frames, the cotangents in
//    shared memory: each layer's input cotangent is a
//    convolution of its pre-activation cotangent with the transposed
//    slices (an implicit GEMM, M = frames × input positions, N = Ci, K =
//    Co × taps), and its epilogue adds the residual skip where the block's
//    input receives it, multiplies by the ELU derivative of the layer
//    below (from the recorded output, as fused_conv.py::_act_deriv) and
//    records that layer's pre-activation cotangent (10,816 floats a
//    frame), or writes the frames' cotangent;
// 4. encoder_bwd_dw_kernel forms the weight and bias gradients of each
//    layer as a blocked GEMM, dW[ci·k·k + tap][co] = Σ over a chunk's
//    frames and output positions of im2col(activation) × pre-activation
//    cotangent, over both records staged in shared memory;
// 5. mrssm::reduce_weight_grads adds the chunks in order and writes torch
//    layout. No float atomics anywhere, so two runs give the same bits.
//
// What bounds it: operations, ~11 MFLOP a frame besides the recompute (the
// weight gradients and the input cotangents each about the forward's
// ~5.5) in f32 FMA; the records (~99 KB a frame) stay in L2 at N=240. What
// held the first form back was the forward's first design in both passes:
// one output a thread with a dependent FMA chain and two shared loads an
// FMA (cotangents), and one thread a gradient element reading both
// operands from device memory (weights). Here:
// - the cotangent pass is the forward's design transposed: a thread owns
//   one input position of every frame of the tile and 4 input channels
//   (F × 4 accumulators) and reads 4 output channels as float4s; the
//   slices stream through two buffers by the bulk copy (TMA) on mbarriers;
//   taps that land between the strided outputs or in the padding are
//   skipped; a stride-2 layer takes its positions by parity class (even
//   and odd rows and columns), so that the threads of a warp share the
//   taps that reach them; narrow tasks are split over threads and their
//   partial sums added in a fixed order;
// - the weight-gradient pass gives a block one tap of one layer, a tile of
//   ≤ 64 input × ≤ 64 output channels, and one chunk of frames, whose two
//   records it stages a few frames at a time with cp.async into two
//   buffers; a thread accumulates 4 × 4 gradient elements (one float4 of
//   activations and one of cotangents a position), and where a tile has
//   fewer such tasks than threads, S threads split the positions and their
//   sums are added in a fixed order. A thread walks only the positions its
//   tap reaches, by pointer increments, and folds its running sums every
//   few frames, so that none takes more than 256 terms (one frame where a
//   layer has 256 positions); the chunks are added in order afterwards.
//
// Measured (chip_smoke.py's encoder_timings, NVIDIA H100 80GB HBM3, 700 W,
// PERF.md §6): at N=240 the cotangent pass takes ~0.16-0.18 ms of device
// time and the weight-gradient pass ~0.15 (the first forms 1.39 and 1.70),
// a whole call ~0.52 ms against ~3.28; at N=3840 2.8 and 1.9 ms (20.9 and
// 25.3). Both passes stay ~8-9× above their share of the bound: the
// weight-gradient pass restages a chunk's records once per tap (k·k times
// a layer) and reads two float4s of shared memory per 16 FMAs; two blocks
// an SM (128 registers) ran faster than three (80, with spills).
#include "fused_encoder.cuh"

namespace {

using fenc::Layer;
using fenc::Plan;
using fenc::Slice;
using fenc::kFwdFrames;
using fenc::kThreads;

// Pack every transposed slice of the torch-layout weights: blockIdx.y is
// the layer, whose slices the block walks in order, one thread per packed
// float, zeros past a chunk's rows and in the row padding.
__global__ void encoder_bwd_pack_kernel(mrssm::WeightPtrs w, Plan P, float* __restrict__ packed) {
  const int l = blockIdx.y;
  const Layer& L = P.L[l];
  const int kk = L.k * L.k;
  for (Slice sl = fconv::make_tslice(P, l, 0, 0, L.bpk); sl.layer == l;
       sl = fconv::next_tslice(P, sl, 0)) {
    const int cols = (sl.t1 - sl.t0) * L.Co, n = fconv::slice_floats(sl);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      const int r = e / sl.sp, col = e - r * sl.sp;
      float v = 0.f;
      if (r < sl.cw && col < cols) {
        const int t = col / L.Co, co = col - t * L.Co;
        v = w.p[2 * l][((size_t)co * L.Ci + sl.co0 + r) * kk + kk - 1 - (sl.t0 + t)];
      }
      packed[sl.off + e] = v;
    }
  }
}

// What the shared cotangent pass (fconv::cotangent_pass) needs of the
// encoder: the head has no activation, so its output's cotangent g [N,
// out_dim] is its pre-activation cotangent; a stride-2 layer takes its input
// positions by parity class (fconv::parity_position), whose positions take
// a fixed subset of the taps, others row-major; tap t of a layer's flipped
// kernel takes output (ty, tx) / s with ty = iy − (k − 1 − p) + t / k
// (likewise tx), where both divide by the stride and fall inside the output
// map; every layer below the head is ELU.
struct EncoderCotangents {
  const float* g;
  __device__ float seed(const Plan& P, int n, int j) const {
    return g[(size_t)n * P.L[P.n - 1].Co + j];
  }
  __device__ static void in_position(const Layer& L, int pos, int& iy, int& ix) {
    fconv::parity_position(L.Hi, L.Wi, L.s, pos, iy, ix);
  }
  __device__ static int walk(const Layer& L, int iy, int ix, int tap) {
    const int pt = L.k - 1 - L.p, ky = tap / L.k, kx = tap - ky * L.k;
    const int ty = iy - pt + ky, tx = ix - pt + kx;
    if (ty < 0 || tx < 0 || ty % L.s != 0 || tx % L.s != 0) return -1;
    const int oy = ty / L.s, ox = tx / L.s;
    return oy >= L.Ho || ox >= L.Wo ? -1 : oy * L.Wo + ox;
  }
  __device__ static float deriv(const Layer&, float o) { return o > 0.f ? 1.f : o + 1.f; }
};

// The cotangent pass over a tile of F frames (see above). g [N, out_dim] is
// the output's cotangent; dx [N, H, W, C0], or null for no input gradient
// (then the walk stops after the second layer, whose epilogue records the
// first layer's pre-activation cotangent). `tpacked` holds the transposed
// slices as encoder_bwd_pack_kernel wrote them. One block an SM, as its
// shared memory leaves it: with the thread count alone ptxas caps a thread
// at 128 registers, where the shared task loop (conv_common.cuh) spills.
__global__ void __launch_bounds__(kThreads, 1)
encoder_bwd_dx_kernel(Plan P, const float* __restrict__ g, float* __restrict__ dx,
                      const float* __restrict__ stash, float* __restrict__ dstash,
                      const float* __restrict__ tpacked, int N) {
  extern __shared__ __align__(16) float smem[];
  fconv::cotangent_pass<kFwdFrames, kThreads>(P, P.bbsz, EncoderCotangents{g}, stash, dstash,
                                              tpacked, dx, N, smem);
}

// ---- the weight-gradient pass --------------------------------------------------------

// What the shared weight-gradient block (fconv::weight_grad_block) needs of
// an encoder layer: every layer is a conv, walked from its outputs; the bias
// falls out of the cotangents staged for the tap (p, p), which reaches
// every output position (every layer has k ≥ 2p + 1, make_plan checks);
// the gradient is [Ci·k·k][Co], the bias [Co].
struct EncoderGrads {
  __device__ static bool swap(const Layer&) { return false; }
  __device__ static int bias(const Layer& L, int tap) {
    return tap == L.p * L.k + L.p ? fconv::kTapBias : fconv::kNoBias;
  }
  __device__ static int weight(const Layer& L, int ci, int co, int tap) {
    return (ci * L.k * L.k + tap) * L.Co + co;
  }
  __device__ static int bias_at(const Layer&, int co, int) { return co; }
};

// Weight and bias gradients of one tile (fconv::dw_tiles) and one chunk of
// frames, as fconv::weight_grad_block forms them: a blocked GEMM, dW[ci·k·k
// + tap][co] = Σ over the chunk's frames and the tap's output positions of
// activation × pre-activation cotangent, over both records staged by
// cp.async. Two blocks an SM (two 48 KB staging buffers each), so ptxas
// caps a thread at 128 registers and spills 4 bytes (PERF.md §6).
__global__ void __launch_bounds__(kThreads, 2)
encoder_bwd_dw_kernel(Plan P, mrssm::WeightDims gd, const float* __restrict__ stash,
                      const float* __restrict__ dstash, float* __restrict__ partial, int N,
                      int chunk) {
  extern __shared__ __align__(16) float smem[];
  fconv::weight_grad_block<kThreads, EncoderGrads>(P, gd, stash, dstash, partial, N, chunk, smem);
}

// The gradient layout: per layer its weight as [in = Ci·k·k, out = Co] and
// its bias [1, Co], back to back in layer order (reduce_weight_grads writes
// each weight as torch's [Co, Ci, k, k]).
mrssm::WeightDims grad_dims(const Plan& P) {
  int in[mrssm::kMaxWeights], out[mrssm::kMaxWeights];
  for (int l = 0; l < P.n; ++l) {
    const Layer& L = P.L[l];
    in[2 * l] = L.Ci * L.k * L.k;
    in[2 * l + 1] = 1;
    out[2 * l] = out[2 * l + 1] = L.Co;
  }
  return mrssm::weight_dims(in, out, 2 * P.n);
}

}  // namespace

extern "C" {

// Launch on `stream` the five steps above. x [N, H, W, C0], coords [H + W],
// g [N, out_dim]; dx [N, H, W, C0] or null; d_weights the gradient floats
// (fused_encoder_sizes' sizes[2]) in torch layout, every tensor back to
// back; stash, dstash and partial are scratch of N·sizes[0], N·sizes[1] and
// sizes[3]·sizes[2] floats, packed of sizes[4] floats (16-byte aligned).
// All f32 and contiguous. Returns the cudaError_t of the launches (0 on
// success).
int fused_encoder_backward(const void* const* weights, int n_weights, const float* x,
                           const float* coords, const float* g, float* dx, float* d_weights,
                           float* stash, float* dstash, float* partial, float* packed,
                           fenc::EncDims d, void* stream) {
  fenc::Plan P;
  if (!fenc::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, n_weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fenc::launch_forward(w, P, x, coords, packed, nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  float* tpacked = packed + P.packed;
  encoder_bwd_pack_kernel<<<dim3(8, P.n), 256, 0, s>>>(w, P, tpacked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.N + kFwdFrames - 1) / kFwdFrames;
  encoder_bwd_dx_kernel<<<blocks, kThreads, P.bsmem, s>>>(P, g, dx, stash, dstash, tpacked, d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.dwsmem);
  if (err != cudaSuccess) return (int)err;
  const mrssm::WeightDims gd = grad_dims(P);
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  encoder_bwd_dw_kernel<<<dim3(fconv::dw_blocks(P), chunks), kThreads, P.dwsmem, s>>>(
      P, gd, stash, dstash, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, chunks, gd, d_weights, s);
}

}  // extern "C"
