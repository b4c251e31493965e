// Shared code of the fused decoder kernels (fused_decoder_fwd.cu,
// fused_decoder_bwd.cu): the layer plan, the packing of the weights and the
// forward, which the backward also launches to recompute and record the
// activations. What the decoder shares with the encoder (slices forward and
// transposed, the bulk copy, the micro-kernel, the weight-gradient pass) is
// in conv_common.cuh.
//
// The decoder is a chain of three kinds of layer, each reading its torch
// weight in its own layout (weight_index):
// - kConv, a convolution (torch [Co, Ci, k, k]): the first linear ([Co,
//   Ci], a 1×1 conv on a 1×1 map), the 1×1 projection and the residual
//   blocks' 3×3 convs;
// - kUnflatten, the second linear with the reference's (c, h, w) unflatten
//   (torch [Co·h·w, Ci], one bias per output element): a transposed conv
//   from the 1×1 map with an h×w kernel, output position t taking tap t
//   alone;
// - kDeconv, a transposed conv (torch ConvTranspose2d [Ci, Co, k, k]) at k4
//   s2 p1: out[o] += x[(o + p − t)/s] · w[t] where s divides (JAX
//   fused_conv.py:606-611). Output row oy takes the taps ky ≡ oy + 1 (mod 2)
//   at iy = (oy + 1 − ky)/2, two an axis: each output-parity class of
//   positions is a dense 2×2-tap conv, computed by gathering its taps (no
//   scatter, no float atomics).
// Activations are HWC per frame (channel fastest) in three shared-memory
// buffers of a tile of kFrames frames (ping-pong between the first two; the
// residual stream x in one of them and the block's intermediate t in the
// third); at the reference widths 8,192 floats a frame, the largest layer
// output deconv1's 16×16×16. HBM sees the [N, F] features, the packed
// weights once per block (from L2) and the [N, 32, 32, 1] frames.
//
// The forward replaces fused_conv.py::_fwd_kernel (line 455) as
// fused_decoder_apply (line 766) reaches it. It does ~5.9 M multiply-adds a
// frame at 48-wide features, 83% in the six residual 3×3 convs at 4×4
// (64→128→64), so it is bound by operations: f32 FMA (the reference is f32;
// TF32 would keep ~3 digits). One output a thread would make each a
// dependent FMA chain over Ci·k·k taps with two shared loads an FMA, so it
// is built from the fused encoder's pieces (conv_common.cuh):
// - decoder_pack_kernel first lays out every layer's weights as slices
//   [Co][tap][Ci] (bank-padded rows), a transposed conv's taps ordered by
//   output-parity class, 4 a class; the forward streams them through two
//   buffers by the bulk copy (TMA) on mbarriers, slice i + 1 in flight while
//   slice i computes;
// - each layer is an implicit GEMM over the tile (M = frames × output
//   positions, N = Co, K = Ci × taps): a thread owns one position of each
//   frame and 4 output channels and reads float4s of activations and
//   weights, skipping taps in the padding; a transposed conv's positions
//   are taken by parity class, so that a warp walks one class's 4 taps and
//   none is wasted; the last one (one output channel) takes a one-channel
//   micro-tile, J = 1;
// - where a chunk has fewer tasks than threads (the first linear, the
//   unflatten's chunks, the residual 128→64 conv's tap slices), threads
//   split its input channels and the partial sums are added in a fixed
//   order: two launches give the same bits.
// The TPU kernel instead keeps every layer's banded lane operators
// (megabytes) resident in VMEM; here one slice of one layer is resident.
#pragma once

#include <algorithm>

#include "conv_common.cuh"
#include "mrssm_common.cuh"

namespace fdec {

using fconv::padded_k;
using fconv::Slice;
using fconv::slice_floats;

constexpr int kThreads = 256;
// Frames a block of the forward and of the backward's cotangent pass
// (ops/kernels/fused_conv.py FRAMES_PER_BLOCK): at N=240 120 blocks fill
// most of the card's 132 SMs (PERF.md §6).
constexpr int kFrames = 2;
constexpr int kMaxLayers = mrssm::kMaxWeights / 2;  // weight and bias each
// The transposed convs' kernel, stride and padding: ops/kernels/fused_conv.py
// ::fused_decoder_applicable takes only k4 s2 p1. Each output-parity class
// takes kClassTaps of the k·k taps.
constexpr int kDeconvK = 4, kDeconvS = 2, kDeconvP = 1;
constexpr int kClassTaps = (kDeconvK / kDeconvS) * (kDeconvK / kDeconvS);
static_assert(kDeconvS == 2 && kDeconvK == 4, "the parity walk takes k4 s2");
enum Kind { kConv = 0, kDeconv = 1, kUnflatten = 2 };
enum Act { kElu = 0, kTanh = 1 };

// ops/kernels/build.py::DecDims, field for field: N frames of F features,
// the first linear's width, conv_in_shape (c0, h0, w0), the residual
// stack's input and intermediate widths and block count, the three
// transposed convs' output channels, frames per block (kFrames), and frames
// per chunk of the weight-gradient pass.
struct DecDims {
  int N, F, lin0, c0, h0, w0, res_in, res_mid, n_res, ch0, ch1, ch2, frames, chunk;
};

struct Layer {
  int Hi, Wi, Ci, Ho, Wo, Co, k, s, p;
  int kind, act;
  int residual;                 // out = act(x + conv(t)), x the output buffer in place
  int in_buf, out_buf;          // shared-memory buffers of input and output (forward),
                                // of their cotangents (backward)
  int in_off, out_off;          // per-frame offsets of input and output in the activation
                                // record
  int dpre_off;                 // per-frame offset of the output's pre-activation
                                // cotangent in the cotangent record
  int acc_in;                   // backward: add the input cotangent to its buffer (the
                                // input also feeds a residual skip)
  int bias_off;                 // forward: offset of the bias in the bias buffer
  int fcn, fper, fpk;           // forward: output channels a chunk, taps a slice, and the
                                // offset of the layer's first slice in the packed weights
  int bcn, bper, bpk;           // backward, the same of the transposed slices: input
                                // channels a chunk, taps a slice, offset
};

struct Plan {
  int n;
  Layer L[kMaxLayers];
  int F;
  int bsz[3];                   // floats a frame of each shared-memory buffer (multiples
                                // of 4: every frame's buffer is 16-byte aligned)
  int stash, dstash;            // floats a frame of the activation and cotangent records
                                // (multiples of 4, as every offset in them: every record
                                // is 16-byte aligned)
  // The forward: floats of the bias buffer, of the split tasks' partial
  // sums, of each of the two slice buffers and of the packed weights; its
  // dynamic shared memory.
  int fbias, fpart, fslice, packed;
  size_t fsmem;
  // The backward's cotangent pass, on the forward's buffers (the
  // cotangents of the layers' outputs) and partial sums: two
  // transposed-slice buffers of bslice floats, their packed floats (after
  // the forward's), and the dynamic shared memory. The weight-gradient
  // pass: floats of each of its two staging buffers, and its dynamic shared
  // memory.
  int bslice, bpacked;
  size_t bsmem;
  int dwstage;
  size_t dwsmem;

  // Rows of layer l's transposed slices: its input channels.
  __host__ __device__ int t_rows(int l) const { return L[l].Ci; }
};

// Index in the layer's torch weight of (input channel, output channel, tap
// ky·k + kx).
__host__ __device__ inline size_t weight_index(const Layer& L, int ci, int co, int tap) {
  const int kk = L.k * L.k;
  if (L.kind == kConv) return ((size_t)co * L.Ci + ci) * kk + tap;
  if (L.kind == kDeconv) return ((size_t)ci * L.Co + co) * kk + tap;
  return ((size_t)co * kk + tap) * L.Ci + ci;
}

// The torch tap ky·k + kx of a layer's packed tap t: a transposed conv's
// taps are packed by output-parity class (py, px) = (t / 4 >> 1, t / 4 & 1),
// each class's 4 as (a, b) = (t % 4 >> 1, t % 4 & 1) at ky = ((py + p) & 1)
// + 2a, kx = ((px + p) & 1) + 2b; other layers keep torch's order.
__host__ __device__ __forceinline__ int torch_tap(const Layer& L, int t) {
  if (L.kind != kDeconv) return t;
  const int cls = t / kClassTaps, j = t - cls * kClassTaps;
  const int ky = (((cls >> 1) + kDeconvP) & 1) + 2 * (j >> 1);
  const int kx = (((cls & 1) + kDeconvP) & 1) + 2 * (j & 1);
  return ky * kDeconvK + kx;
}

// Floats of a layer's bias: one per output channel, the unflatten's one per
// output element.
__host__ __device__ __forceinline__ int bias_size(const Layer& L) {
  return L.kind == kUnflatten ? L.Co * L.Ho * L.Wo : L.Co;
}

// The plan of a decoder; false where the widths need more layers than the
// table holds, the frames a block are not kFrames, or a block's shared
// memory does not fit: in the forward or the cotangent pass (one slice
// each), or the weight-gradient pass (one frame of a layer's records).
inline bool make_plan(const DecDims& d, Plan* out) {
  Plan p = {};
  p.F = d.F;
  p.bsz[0] = d.F;
  p.stash = (d.F + 3) / 4 * 4;
  int hi = 1, wi = 1, ci = d.F, buf = 0, off = 0;
  auto add = [&](int kind, int co, int ho, int wo, int k, int s, int pad, int act, int residual,
                 int out_buf, int acc_in) -> bool {
    if (p.n == kMaxLayers) return false;
    Layer& L = p.L[p.n++];
    L = Layer{hi, wi, ci, ho, wo, co, k, s, pad, kind, act, residual, buf, out_buf, off,
              p.stash, p.dstash, acc_in};
    const int size = ho * wo * co;
    p.stash += (size + 3) / 4 * 4;
    p.dstash += (size + 3) / 4 * 4;
    if (size > p.bsz[out_buf]) p.bsz[out_buf] = size;
    hi = ho; wi = wo; ci = co; buf = out_buf; off = L.out_off;
    return true;
  };
  auto other = [&]() { return buf == 0 ? 1 : 0; };  // a ping-pong buffer other than the input's
  bool ok = add(kConv, d.lin0, 1, 1, 1, 1, 0, kElu, 0, other(), 0) && d.h0 == d.w0 &&
            add(kUnflatten, d.c0, d.h0, d.w0, d.h0, 1, 0, kElu, 0, other(), 0);
  if (ok && d.n_res > 0 && ci != d.res_in) {
    ok = add(kConv, d.res_in, hi, wi, 1, 1, 0, kElu, 0, other(), 0);
  }
  const int xb = buf, xc = ci;
  for (int r = 0; r < d.n_res && ok; ++r) {
    ok = add(kConv, d.res_mid, hi, wi, 3, 1, 1, kElu, 0, 2, 1) &&
         add(kConv, xc, hi, wi, 3, 1, 1, kElu, 1, xb, 0);
  }
  const int ch[3] = {d.ch0, d.ch1, d.ch2};
  for (int i = 0; i < 3 && ok; ++i) {
    const int ho = (hi - 1) * kDeconvS - 2 * kDeconvP + kDeconvK;
    const int wo = (wi - 1) * kDeconvS - 2 * kDeconvP + kDeconvK;
    ok = add(kDeconv, ch[i], ho, wo, kDeconvK, kDeconvS, kDeconvP, i < 2 ? kElu : kTanh, 0,
             other(), 0);
  }
  if (!ok || d.frames != kFrames) return false;
  for (int i = 0; i < 3; ++i) p.bsz[i] = (p.bsz[i] + 3) / 4 * 4;

  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  const size_t act = (size_t)kFrames * (p.bsz[0] + p.bsz[1] + p.bsz[2]);
  const size_t limit_floats = (size_t)limit / sizeof(float);

  // The forward: every bias, the partial sums, two slice buffers of at most
  // half of what is left (4: the slice buffers' mbarriers). The largest
  // slice of either kind; the largest frame of a layer's records in the
  // weight-gradient pass.
  int largest = 0, tlargest = 0, frame = 0;
  for (int l = 0; l < p.n; ++l) {
    Layer& L = p.L[l];
    const int kk = L.k * L.k;
    // The cotangent pass walks a conv at stride 1; the weight-gradient
    // pass forms a conv's bias at its tap (p, p).
    if (L.kind == kConv && (L.s != 1 || L.k < 2 * L.p + 1)) return false;
    L.bias_off = p.fbias;
    p.fbias += (bias_size(L) + 3) / 4 * 4;
    largest = std::max(largest, 4 * ((L.Co + 3) / 4) * padded_k(L.Ci * kk));
    tlargest = std::max(tlargest, 4 * ((L.Ci + 3) / 4) * padded_k(L.Co * kk));
    frame = std::max(frame, (L.Hi * L.Wi * L.Ci + 3) / 4 * 4 + (L.Ho * L.Wo * L.Co + 3) / 4 * 4);
  }
  p.fpart = kThreads * 4 * kFrames;
  const size_t fact = 4 + act + p.fbias + p.fpart;
  if (fact >= limit_floats) return false;
  p.fslice = (int)std::min<size_t>(largest, (limit_floats - fact) / 8 * 4);
  // Tap slices only for convolutions: a transposed conv's class walk and
  // the unflatten's one tap a position would leave most threads idle.
  if (!fconv::make_slices(p, p.fslice, kThreads, [](const Layer& L) { return L.kind == kConv; })) {
    return false;
  }
  p.fsmem = (fact + 2 * (size_t)p.fslice) * sizeof(float);

  // The cotangent pass: the partial sums, two transposed-slice buffers of at
  // most half of what is left, as the encoder's.
  const size_t bact = 4 + act + p.fpart;
  p.bslice = (int)std::min<size_t>(tlargest, (limit_floats - bact) / 8 * 4);
  if (!fconv::make_tslices(p, p.bslice, kThreads)) return false;
  p.bsmem = (bact + 2 * (size_t)p.bslice) * sizeof(float);

  p.dwstage = std::max(fconv::kDwStage, frame);
  p.dwsmem = 2 * (size_t)p.dwstage * sizeof(float);
  if (p.dwsmem > (size_t)limit) return false;
  *out = p;
  return true;
}

namespace {

// Pack every slice of the torch-layout weights (Slice, [Co][tap][Ci], taps
// in torch_tap's order): blockIdx.y is the layer, whose slices the block
// walks in order, one thread per packed float, zeros past a chunk's
// channels and in the row padding.
__global__ void decoder_pack_kernel(mrssm::WeightPtrs w, Plan P, float* __restrict__ packed) {
  const int l = blockIdx.y;
  const Layer& L = P.L[l];
  for (Slice sl = fconv::make_slice(P, l, 0, 0, L.fpk); sl.layer == l;
       sl = fconv::next_slice(P, sl)) {
    const int cols = (sl.t1 - sl.t0) * L.Ci, n = slice_floats(sl);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      const int r = e / sl.sp, col = e - r * sl.sp;
      float v = 0.f;
      if (r < sl.cw && col < cols) {
        const int t = col / L.Ci, ci = col - t * L.Ci;
        v = w.p[2 * l][weight_index(L, ci, sl.co0 + r, torch_tap(L, sl.t0 + t))];
      }
      packed[sl.off + e] = v;
    }
  }
}

// One slice of the forward over the tile (see the header): its tasks, each
// output position index pos (a transposed conv's by parity class) of every
// frame and J output channels of the slice's chunk, on the slice in shared
// memory at WB. The epilogue adds the bias (per element for the unflatten)
// and applies ELU, act(x + conv(t)) in place on the residual stream, or the
// last layer's Tanh, and writes the output buffer, the record (`stash`) and
// the frames (`out`, the last layer).
template <int J>
__device__ __forceinline__ void forward_slice(const Plan& P, const Slice& sl,
                                              const float* __restrict__ WB, float* const* buf,
                                              const float* __restrict__ bias, float* part,
                                              float* __restrict__ out,
                                              float* __restrict__ stash, int n0, int nf,
                                              float (&acc)[kFrames][J]) {
  constexpr int F = kFrames;
  const Layer& L = P.L[sl.layer];
  const bool last = sl.layer == P.n - 1, deconv = L.kind == kDeconv;
  const int G = J == 4 ? (sl.cw + 3) / 4 : sl.cw, Gsp = G * sl.sp, HWo = L.Ho * L.Wo;
  const bool vec = L.Ci % 4 == 0;
  const float* in = buf[L.in_buf];
  float* ob = buf[L.out_buf];
  const int ibsz = P.bsz[L.in_buf], obsz = P.bsz[L.out_buf];
  auto position = [&](int pos, int& oy, int& ox) {
    fconv::parity_position(L.Ho, L.Wo, deconv ? kDeconvS : 1, pos, oy, ox);
  };
  auto run = [&](int task, int c0, int c1) {
    const int pos = task / G, cg = task - pos * G;
    int oy, ox;
    position(pos, oy, ox);
    // The slice's taps this position takes: the unflatten's one, a
    // transposed conv's parity class, a conv's all (those in the padding
    // are skipped).
    int ta = sl.t0, tb = sl.t1;
    if (L.kind == kUnflatten) {
      ta = max(ta, oy * L.Wo + ox);
      tb = min(tb, oy * L.Wo + ox + 1);
    } else if (deconv) {
      const int t = ((oy & 1) * 2 + (ox & 1)) * kClassTaps;
      ta = max(ta, t);
      tb = min(tb, t + kClassTaps);
    }
    auto walk = [&](int tap) {
      int iy, ix;
      if (L.kind == kUnflatten) return 0;
      if (deconv) {  // class tap (a, b): iy = (oy + p) / 2 − a, ix = (ox + p) / 2 − b
        iy = ((oy + kDeconvP) >> 1) - ((tap & 3) >> 1);
        ix = ((ox + kDeconvP) >> 1) - (tap & 1);
      } else {
        const int ky = tap / L.k, kx = tap - ky * L.k;
        iy = oy * L.s - L.p + ky;
        ix = ox * L.s - L.p + kx;
      }
      return iy < 0 || iy >= L.Hi || ix < 0 || ix >= L.Wi ? -1 : iy * L.Wi + ix;
    };
    const float* wrow = WB + cg * sl.sp;
    if (vec) {
      fconv::conv_taps<F, J, true>(sl.t0, ta, tb, L.Ci, in, ibsz, wrow, Gsp, c0, c1, walk, acc);
    } else {
      fconv::conv_taps<F, J, false>(sl.t0, ta, tb, L.Ci, in, ibsz, wrow, Gsp, c0, c1, walk, acc);
    }
  };
  auto emit = [&](float v, int f, int pos, int c) {
    const int co = sl.co0 + c;
    int oy, ox;
    position(pos, oy, ox);
    const int q = oy * L.Wo + ox;
    v += bias[L.bias_off + (L.kind == kUnflatten ? co * HWo + q : co)];
    float* o = ob + f * obsz + q * L.Co + co;
    const float r = L.act == kTanh ? tanhf(v) : mrssm::elu(L.residual ? *o + v : v);
    *o = r;
    if (f < nf) {
      if (stash != nullptr) stash[(size_t)(n0 + f) * P.stash + L.out_off + q * L.Co + co] = r;
      if (last && out != nullptr) out[((size_t)(n0 + f) * HWo + q) * L.Co + co] = r;
    }
  };
  fconv::slice_tasks<F, J, kThreads>(sl, HWo * G, G, L.Ci, vec ? 4 : 1, part, run, emit, acc);
}

// The forward over a tile of kFrames frames: features [N, F] → out [N, 32,
// 32, 1] (not written when null). With `stash` it also records each frame's
// activations (the features, then every layer's output) at stash[n ·
// P.stash + offset], for the backward. `packed` holds the weights as
// decoder_pack_kernel wrote them. The slices stream through two
// shared-memory buffers: slice i + 1 loads while slice i computes. Its
// shared memory leaves one block an SM, so the launch bounds say so: with
// the thread count alone ptxas caps a thread at 128 registers and spills
// (108 bytes); with one block it takes 158 and none (PERF.md §6).
__global__ void __launch_bounds__(kThreads, 1)
decoder_fwd_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ feats,
                   const float* __restrict__ packed, float* __restrict__ out,
                   float* __restrict__ stash, int N) {
  constexpr int F = kFrames;
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // one a slice buffer
  float* buf[3];
  buf[0] = smem + 4;
  buf[1] = buf[0] + F * P.bsz[0];
  buf[2] = buf[1] + F * P.bsz[1];
  float* bias = buf[2] + F * P.bsz[2];
  float* part = bias + P.fbias;
  float* WB[2] = {part + P.fpart, part + P.fpart + P.fslice};
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);

  auto load_slice = [&](const Slice& sl, int b) {  // thread 0 only
    fconv::bulk_load(WB[b], packed + sl.off, 4 * slice_floats(sl), &bar[b]);
  };
  Slice sl = fconv::make_slice(P, 0, 0, 0, 0);
  if (tid == 0) {
    fconv::mbar_init(&bar[0]);
    fconv::mbar_init(&bar[1]);
    load_slice(sl, 0);
  }
  // The features (zeros past N) and their record; every bias.
  for (int i = tid; i < F * P.F; i += kThreads) {
    const int f = i / P.F, j = i - f * P.F;
    const float v = f < nf ? feats[(size_t)(n0 + f) * P.F + j] : 0.f;
    buf[0][f * P.bsz[0] + j] = v;
    if (stash != nullptr && f < nf) stash[(size_t)(n0 + f) * P.stash + j] = v;
  }
  for (int l = 0; l < P.n; ++l) {
    const Layer& L = P.L[l];
    const int size = bias_size(L);
    for (int c = tid; c < (size + 3) / 4 * 4; c += kThreads) {
      bias[L.bias_off + c] = c < size ? w.p[2 * l + 1][c] : 0.f;
    }
  }
  __syncthreads();  // the mbarriers are initialised before any thread waits on them

  float acc[F][4], acc1[F][1];
  for (int i = 0; sl.layer < P.n; ++i) {
    const Slice next = fconv::next_slice(P, sl);
    if (tid == 0 && next.layer < P.n) load_slice(next, (i + 1) & 1);
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);
    __syncthreads();  // slice i and the previous layer's outputs are in place
    if (P.L[sl.layer].Co == 1) {
      forward_slice<1>(P, sl, WB[i & 1], buf, bias, part, out, stash, n0, nf, acc1);
    } else {
      forward_slice<4>(P, sl, WB[i & 1], buf, bias, part, out, stash, n0, nf, acc);
    }
    __syncthreads();  // slice i's buffer is free for slice i + 2
    sl = next;
  }
}

// Pack the weights, then run the forward (decoder_fwd_kernel) on `stream`.
inline cudaError_t launch_forward(const mrssm::WeightPtrs& w, const Plan& P, const float* feats,
                                  float* packed, float* out, float* stash, int N,
                                  cudaStream_t stream) {
  decoder_pack_kernel<<<dim3(8, P.n), 256, 0, stream>>>(w, P, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.fsmem);
  if (err != cudaSuccess) return err;
  decoder_fwd_kernel<<<(N + kFrames - 1) / kFrames, kThreads, P.fsmem, stream>>>(
      w, P, feats, packed, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdec
