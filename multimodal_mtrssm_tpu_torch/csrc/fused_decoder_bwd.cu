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
#include "fused_decoder.cuh"

namespace {

using fconv::Slice;
using fdec::kFrames;
using fdec::kThreads;
using fdec::Layer;
using fdec::Plan;

// The torch tap of a transposed slice's tap t: a conv's flipped in space,
// the other kinds' as they are (step 2 above).
__host__ __device__ __forceinline__ int tslice_tap(const Layer& L, int t) {
  return L.kind == fdec::kConv ? L.k * L.k - 1 - t : t;
}

// Pack every transposed slice of the torch-layout weights: blockIdx.y is
// the layer, whose slices the block walks in order, one thread per packed
// float, zeros past a chunk's rows and in the row padding.
__global__ void decoder_bwd_pack_kernel(mrssm::WeightPtrs w, Plan P, float* __restrict__ packed) {
  const int l = blockIdx.y;
  const Layer& L = P.L[l];
  for (Slice sl = fconv::make_tslice(P, l, 0, 0, L.bpk); sl.layer == l;
       sl = fconv::next_tslice(P, sl, 0)) {
    const int cols = (sl.t1 - sl.t0) * L.Co, n = fconv::slice_floats(sl);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      const int r = e / sl.sp, col = e - r * sl.sp;
      float v = 0.f;
      if (r < sl.cw && col < cols) {
        const int t = col / L.Co, co = col - t * L.Co;
        v = w.p[2 * l][fdec::weight_index(L, sl.co0 + r, co, tslice_tap(L, sl.t0 + t))];
      }
      packed[sl.off + e] = v;
    }
  }
}

// What the shared cotangent pass (fconv::cotangent_pass) needs of the
// decoder (see above): the frames' cotangent g [N, 32, 32, 1] times the last
// layer's Tanh derivative seeds it; input positions go row-major; a task's
// tap reads the unflatten's output position t, a transposed conv's output i·s
// − p + t, a conv's (stride 1, taps flipped) output i − (k − 1 − p) + t; the
// activation derivative from the recorded output o, as
// fused_conv.py::_act_deriv: ELU 1 or o + 1, Tanh 1 − o².
struct DecoderCotangents {
  const float* g;
  const float* stash;
  __device__ static float deriv(const Layer& L, float o) {
    return L.act == fdec::kTanh ? 1.f - o * o : (o > 0.f ? 1.f : o + 1.f);
  }
  __device__ float seed(const Plan& P, int n, int j) const {
    const Layer& last = P.L[P.n - 1];
    const float o = stash[(size_t)n * P.stash + last.out_off + j];
    return g[(size_t)n * last.Ho * last.Wo * last.Co + j] * deriv(last, o);
  }
  __device__ static void in_position(const Layer& L, int pos, int& iy, int& ix) {
    iy = pos / L.Wi;
    ix = pos - iy * L.Wi;
  }
  __device__ static int walk(const Layer& L, int iy, int ix, int tap) {
    if (L.kind == fdec::kUnflatten) return tap;
    const int sh = L.kind == fdec::kDeconv ? L.p : L.k - 1 - L.p;
    const int ky = tap / L.k, kx = tap - ky * L.k;
    const int oy = iy * L.s - sh + ky, ox = ix * L.s - sh + kx;
    return oy < 0 || oy >= L.Ho || ox < 0 || ox >= L.Wo ? -1 : oy * L.Wo + ox;
  }
};

// The cotangent pass over a tile of kFrames frames (see above). g [N, 32,
// 32, 1] is the frames' cotangent; dfeats [N, F], or null for no feature
// gradient (then the walk stops after layer 1, whose epilogue records layer
// 0's pre-activation cotangent). `tpacked` holds the transposed slices as
// decoder_bwd_pack_kernel wrote them. One block an SM, as its shared memory
// leaves it, so the launch bounds say so, as the encoder's cotangent pass,
// which spills at the 128 registers of the thread count alone (this one
// takes 128 and spills none).
__global__ void __launch_bounds__(kThreads, 1)
decoder_bwd_dx_kernel(Plan P, const float* __restrict__ g, float* __restrict__ dfeats,
                      const float* __restrict__ stash, float* __restrict__ dstash,
                      const float* __restrict__ tpacked, int N) {
  extern __shared__ __align__(16) float smem[];
  fconv::cotangent_pass<kFrames, kThreads>(P, P.bsz, DecoderCotangents{g, stash}, stash, dstash,
                                           tpacked, dfeats, N, smem);
}

// What the shared weight-gradient block (fconv::weight_grad_block) needs of
// a decoder layer (see above): a transposed conv and the unflatten walk
// their inputs; the bias of a conv comes from its tap (p, p), of a
// transposed conv from its tap (1, 1) by 2×2 output blocks, of the
// unflatten from each tap; the offsets in grad_dims' layout below.
struct DecoderGrads {
  __device__ static bool swap(const Layer& L) { return L.kind != fdec::kConv; }
  __device__ static int bias(const Layer& L, int tap) {
    if (L.kind == fdec::kUnflatten) return fconv::kTapBias;
    if (tap != L.p * L.k + L.p) return fconv::kNoBias;
    return L.kind == fdec::kDeconv ? fconv::kQuadBias : fconv::kTapBias;
  }
  __device__ static int weight(const Layer& L, int ci, int co, int tap) {
    const int kk = L.k * L.k;
    if (L.kind == fdec::kConv) return (ci * kk + tap) * L.Co + co;
    if (L.kind == fdec::kDeconv) return (co * kk + tap) * L.Ci + ci;
    return (ci * L.Co + co) * kk + tap;
  }
  __device__ static int bias_at(const Layer& L, int co, int tap) {
    return L.kind == fdec::kUnflatten ? co * L.k * L.k + tap : co;
  }
};

// Weight and bias gradients of one tile (fconv::dw_tiles) and one chunk of
// frames, as fconv::weight_grad_block forms them. Two blocks an SM (two 48
// KB staging buffers each), as the encoder's: ptxas caps a thread at 128
// registers and spills 8 bytes (PERF.md §6).
__global__ void __launch_bounds__(kThreads, 2)
decoder_bwd_dw_kernel(Plan P, mrssm::WeightDims gd, const float* __restrict__ stash,
                      const float* __restrict__ dstash, float* __restrict__ partial, int N,
                      int chunk) {
  extern __shared__ __align__(16) float smem[];
  fconv::weight_grad_block<kThreads, DecoderGrads>(P, gd, stash, dstash, partial, N, chunk, smem);
}

// The gradient layout: per layer its weight as [in, out] and its bias as
// [1, out], back to back in layer order, where reduce_weight_grads' write
// of element (k, o) to o·in + k is the torch layout: a conv's [Co, Ci·k·k]
// is (in Ci·k·k, out Co); a transposed conv's [Ci, Co·k·k] is (in Co·k·k,
// out Ci); the unflatten's [Co·k·k, Ci] is (in Ci, out Co·k·k).
mrssm::WeightDims grad_dims(const Plan& P) {
  int in[mrssm::kMaxWeights], out[mrssm::kMaxWeights];
  for (int l = 0; l < P.n; ++l) {
    const Layer& L = P.L[l];
    const int kk = L.k * L.k;
    if (L.kind == fdec::kConv) {
      in[2 * l] = L.Ci * kk; out[2 * l] = L.Co; out[2 * l + 1] = L.Co;
    } else if (L.kind == fdec::kDeconv) {
      in[2 * l] = L.Co * kk; out[2 * l] = L.Ci; out[2 * l + 1] = L.Co;
    } else {
      in[2 * l] = L.Ci; out[2 * l] = L.Co * kk; out[2 * l + 1] = L.Co * kk;
    }
    in[2 * l + 1] = 1;
  }
  return mrssm::weight_dims(in, out, 2 * P.n);
}

}  // namespace

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
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, n_weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fdec::launch_forward(w, P, feats, packed, nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  float* tpacked = packed + P.packed;
  decoder_bwd_pack_kernel<<<dim3(8, P.n), 256, 0, s>>>(w, P, tpacked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(decoder_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.N + kFrames - 1) / kFrames;
  decoder_bwd_dx_kernel<<<blocks, kThreads, P.bsmem, s>>>(P, g, dfeats, stash, dstash, tpacked,
                                                          d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(decoder_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.dwsmem);
  if (err != cudaSuccess) return (int)err;
  const mrssm::WeightDims gd = grad_dims(P);
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  decoder_bwd_dw_kernel<<<dim3(fconv::dw_blocks(P), chunks), kThreads, P.dwsmem, s>>>(
      P, gd, stash, dstash, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, chunks, gd, d_weights, s);
}

}  // extern "C"
