// Shared code of the fused encoder kernels (fused_encoder_fwd.cu,
// fused_encoder_bwd.cu): the layer plan and the forward, which the backward
// also launches to recompute and record the activations. What the encoder
// shares with the decoder (slices forward and transposed, the bulk copy,
// the micro-kernel, the weight-gradient pass) is in conv_common.cuh.
//
// The encoder is a chain of convolutions: the three strided convs, the 1×1
// projection, two 3×3 convs a residual block, and the linear head, which on
// the CHW-flattened 4×4 map is a 4×4 valid conv with `out` channels (its
// torch weight [out, C·16] is [out, C, 4, 4]). Activations are HWC per frame
// (channel fastest) in shared memory, one block of kFwdThreads per tile of
// kFwdFrames frames; HBM sees the frames, the weights and the [N, out] embedding.
//
// The forward replaces fused_conv.py::_fwd_kernel (line 455) on this card.
// It does ~2.76 M multiply-adds a frame at the reference widths, 89% in the
// six 64→64 3×3 convs at 4×4, so it is bound by operations: f32 FMA (the
// reference is f32; TF32 would keep ~3 digits). What held its first form
// back was one output a thread, one dependent FMA chain over up to 576 taps,
// two shared loads an FMA, and every layer's weights staged behind a
// barrier. Here:
// - each layer is an implicit GEMM over the tile (M = frames × positions,
//   N = Co, K = Ci·k·k); a thread owns one position of every frame and 4
//   output channels, F × 4 independent accumulators, and reads 4 input
//   channels of a tap as one float4 of activations and one float4 of each
//   of its 4 channels' weights: F + 4 shared loads per 16·F FMAs. Taps in
//   the padding are skipped, not multiplied by zero;
// - encoder_pack_kernel first rewrites the torch weights [Co, Ci, k, k] into
//   slices [Co][tap][Ci] (so that input channels are contiguous, as in the
//   activations), row stride padded so that a warp's float4 reads of
//   neighbouring rows do not share banks, each slice at most half of what
//   shared memory leaves; the forward streams the slices through two
//   buffers by the Hopper bulk copy (TMA) on mbarriers, slice i + 1 in
//   flight while slice i computes;
// - where a layer has fewer (position, 4 channels) tasks than threads (the
//   head, a narrow layer), S threads split a task's input channels and the
//   S partial sums are added in a fixed order: no float atomics, the same
//   bits on every launch.
// The TPU kernel instead keeps every layer's banded lane operators
// (megabytes) resident in VMEM; here one slice of one layer is resident.
#pragma once

#include <algorithm>

#include "conv_common.cuh"
#include "mrssm_common.cuh"

namespace fenc {

using fconv::padded_k;
using fconv::Slice;
using fconv::slice_floats;

constexpr int kThreads = 256;  // the backward's cotangent and weight-gradient passes
constexpr int kFwdThreads = 256;  // the forward
// Frames a block of the forward and of the backward's cotangent pass: at
// N=240 120 blocks fill most of the card's 132 SMs, where 4 would leave half
// of them idle (PERF.md, PR 8).
constexpr int kFwdFrames = 2;
constexpr int kMaxLayers = mrssm::kMaxWeights / 2;  // weight and bias each
enum Mode { kElu = 0, kResidual = 1, kHead = 2 };

// ops/kernels/build.py::EncDims, field for field: N frames of H×W×C0 (+ 2
// CoordConv channels when coord), the strided convs' widths, the residual
// stream's and intermediate widths and block count, the embedding width,
// frames per block of the cotangent pass (kFwdFrames), and frames per chunk
// of the weight-gradient pass.
struct EncDims {
  int N, H, W, C0, coord, ch0, ch1, ch2, res_out, res_mid, n_res, out_dim, frames, chunk;
};

struct Layer {
  int Hi, Wi, Ci, Ho, Wo, Co, k, s, p;
  int mode;
  int in_buf, out_buf;          // shared-memory buffers of input and output (forward),
                                // of their cotangents (backward cotangent pass)
  int in_off, out_off;          // per-frame offsets of input and output in the activation
                                // record (out_off -1: the head, not recorded)
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
  int H, W, C0, Cin;
  int stash, dstash;            // floats a frame of the activation and cotangent records
                                // (multiples of 4: every frame's record is 16-byte aligned)
  // The forward's own tile of kFwdFrames frames: fbsz[i] floats a frame of
  // buffer i (the input holds only the C0 image channels); the bias buffer;
  // the partial sums of a split task; two slice buffers of fslice floats;
  // the packed weights' floats, and the dynamic shared memory.
  int fbsz[3], fbias, fpart, fslice;
  int packed;
  size_t fsmem;
  // The backward's cotangent pass, on the forward's tile: bbsz[i] floats a
  // frame of buffer i (the cotangents of the layers' outputs, the head's
  // included), two transposed-slice buffers of bslice floats, their packed
  // floats (after the forward's), and the dynamic shared memory. The
  // weight-gradient pass: floats of each of its two staging buffers, and
  // its dynamic shared memory.
  int bbsz[3], bslice, bpacked;
  size_t bsmem;
  int dwstage;
  size_t dwsmem;

  // Rows of layer l's transposed slices: its input channels, only the
  // image channels in the first layer (the CoordConv channels take no
  // cotangent).
  __host__ __device__ int t_rows(int l) const { return l == 0 ? C0 : L[l].Ci; }
};

// The plan of an encoder; false where the widths need more layers than the
// table holds, the frames a block are not kFwdFrames, or a block's shared
// memory does not fit: in the forward or the cotangent pass (one slice
// each), or the weight-gradient pass (one frame of a layer's records).
inline bool make_plan(const EncDims& d, Plan* out) {
  Plan p = {};
  p.H = d.H;
  p.W = d.W;
  p.C0 = d.C0;
  p.Cin = d.C0 + (d.coord ? 2 : 0);
  p.stash = d.H * d.W * p.Cin;
  int hi = d.H, wi = d.W, ci = p.Cin, buf = 0, off = 0;
  auto add = [&](int co, int k, int s, int pad, int mode, int in_buf, int out_buf,
                 int acc_in) -> bool {
    if (p.n == kMaxLayers) return false;
    Layer& L = p.L[p.n++];
    L.Hi = hi; L.Wi = wi; L.Ci = ci;
    L.Ho = (hi + 2 * pad - k) / s + 1;
    L.Wo = (wi + 2 * pad - k) / s + 1;
    L.Co = co; L.k = k; L.s = s; L.p = pad;
    L.mode = mode; L.in_buf = in_buf; L.out_buf = out_buf; L.acc_in = acc_in;
    L.in_off = off;
    const int size = L.Ho * L.Wo * co;
    L.out_off = mode == kHead ? -1 : p.stash;
    if (mode != kHead) p.stash += size;
    L.dpre_off = p.dstash;
    p.dstash += size;
    hi = L.Ho; wi = L.Wo; ci = co; buf = out_buf; off = L.out_off;
    return true;
  };
  const int ch[3] = {d.ch0, d.ch1, d.ch2};
  bool ok = true;
  for (int i = 0; i < 3; ++i) ok = ok && add(ch[i], 3, 2, 1, kElu, buf, buf == 0 ? 1 : 0, 0);
  if (d.n_res > 0 && ci != d.res_out) ok = ok && add(d.res_out, 1, 1, 0, kElu, buf, 1 - buf, 0);
  const int xb = buf, xc = ci;
  for (int r = 0; r < d.n_res && ok; ++r) {
    ok = add(d.res_mid, 3, 1, 1, kElu, xb, 2, 1) && add(xc, 3, 1, 1, kResidual, 2, xb, 0);
  }
  ok = ok && hi == wi && add(d.out_dim, hi, 1, 0, kHead, buf, 2, 0);
  if (!ok || d.frames != kFwdFrames) return false;
  p.stash = (p.stash + 3) / 4 * 4;
  p.dstash = (p.dstash + 3) / 4 * 4;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  const size_t limit_floats = (size_t)limit / sizeof(float);

  // Buffers rounded to float4s: the forward's (activations; the input holds
  // only the C0 image channels), the cotangent pass's (the cotangents of the
  // layers' outputs); every bias; the largest slice of either kind; the
  // largest frame of a layer's records in the weight-gradient pass.
  int fb[3] = {d.H * d.W * d.C0, 0, 0}, bb[3] = {0, 0, 0}, largest = 0, tlargest = 0;
  int frame = 0;
  for (int l = 0; l < p.n; ++l) {
    Layer& L = p.L[l];
    const int kk = L.k * L.k, size = L.Ho * L.Wo * L.Co;
    if (L.k < 2 * L.p + 1) return false;  // the weight-gradient pass's bias tap (p, p)
    if (L.mode != kHead) fb[L.out_buf] = std::max(fb[L.out_buf], size);
    bb[L.out_buf] = std::max(bb[L.out_buf], size);
    L.bias_off = p.fbias;
    p.fbias += 4 * ((L.Co + 3) / 4);
    largest = std::max(largest, 4 * ((L.Co + 3) / 4) * padded_k(L.Ci * kk));
    tlargest = std::max(tlargest, 4 * ((p.t_rows(l) + 3) / 4) * padded_k(L.Co * kk));
    frame = std::max(frame, (L.Hi * L.Wi * L.Ci + 3) / 4 * 4 + (size + 3) / 4 * 4);
  }
  for (int i = 0; i < 3; ++i) {
    p.fbsz[i] = (fb[i] + 3) / 4 * 4;
    p.bbsz[i] = (bb[i] + 3) / 4 * 4;
  }
  p.fpart = kFwdThreads * 4 * kFwdFrames;
  // 4: the two slice buffers' mbarriers.
  const size_t fact =
      4 + (size_t)kFwdFrames * (p.fbsz[0] + p.fbsz[1] + p.fbsz[2]) + p.fbias + p.fpart;
  if (fact >= limit_floats) return false;
  p.fslice = (int)std::min<size_t>(largest, (limit_floats - fact) / 8 * 4);
  if (!fconv::make_slices(p, p.fslice, kFwdThreads, [](const Layer&) { return true; })) {
    return false;
  }
  p.fsmem = (fact + 2 * (size_t)p.fslice) * sizeof(float);

  const size_t bact = 4 + (size_t)kFwdFrames * (p.bbsz[0] + p.bbsz[1] + p.bbsz[2]) + p.fpart;
  if (bact >= limit_floats) return false;
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

// Pack every slice of the torch-layout weights (Slice): blockIdx.y is the
// layer, whose slices the block walks in order, one thread per packed
// float, zeros past a chunk's channels and in the row padding.
__global__ void encoder_pack_kernel(mrssm::WeightPtrs w, Plan P, float* __restrict__ packed) {
  const int l = blockIdx.y;
  const Layer& L = P.L[l];
  const int kk = L.k * L.k;
  for (Slice sl = fconv::make_slice(P, l, 0, 0, L.fpk); sl.layer == l;
       sl = fconv::next_slice(P, sl)) {
    const int cols = (sl.t1 - sl.t0) * L.Ci, n = slice_floats(sl);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      const int r = e / sl.sp, col = e - r * sl.sp;
      float v = 0.f;
      if (r < sl.cw && col < cols) {
        const int t = col / L.Ci, ci = col - t * L.Ci;
        v = w.p[2 * l][((size_t)(sl.co0 + r) * L.Ci + ci) * kk + sl.t0 + t];
      }
      packed[sl.off + e] = v;
    }
  }
}

// The first layer's task of a slice (conv_common.cuh): output position
// (oy, ox) of every frame of the tile and the output channels cg + G·j, j <
// 4, of the slice's chunk, summed over the input channels [c0, c1) of the
// slice's taps that fall inside the input map, one channel at a time, the
// channels from cimg on from the CoordConv values. `wrow` is the slice's row
// cg; row cg + G·j is j·Gsp further. Every sum runs taps in order, then
// channels in order.
template <int F>
__device__ __forceinline__ void conv_scalar(const Layer& L, const Slice& sl,
                                            const float* __restrict__ in, int ibsz,
                                            const float* __restrict__ wrow, int Gsp, int oy,
                                            int ox, int c0, int c1, int cimg,
                                            const float* __restrict__ coords, int H,
                                            float (&acc)[F][4]) {
  for (int tap = sl.t0; tap < sl.t1; ++tap) {
    const int ky = tap / L.k, kx = tap - ky * L.k;
    const int iy = oy * L.s - L.p + ky, ix = ox * L.s - L.p + kx;
    if (iy < 0 || iy >= L.Hi || ix < 0 || ix >= L.Wi) continue;
    const float* a = in + (iy * L.Wi + ix) * cimg;
    const float* wt = wrow + (tap - sl.t0) * L.Ci;
    for (int ci = c0; ci < c1; ++ci) {
      float av[F], wv[4];
      const float cv = ci < cimg ? 0.f : (ci == cimg ? coords[iy] : coords[H + ix]);
#pragma unroll
      for (int f = 0; f < F; ++f) av[f] = ci < cimg ? a[f * ibsz + ci] : cv;
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = wt[j * Gsp + ci];
#pragma unroll
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[f][j] = fmaf(av[f], wv[j], acc[f][j]);
      }
    }
  }
}

// The forward over a tile of F frames: frames x [N, H, W, C0] → out [N,
// out_dim] (not written when null). With `stash` it also records each
// frame's activations (the input with its coordinate channels, then every
// layer's output but the head's) at stash[n · P.stash + offset], for the
// backward. `packed` holds the weights as encoder_pack_kernel wrote them.
//
// Each layer is an implicit GEMM over the tile: M = F frames × Ho·Wo
// positions, N = Co, K = Ci·k·k. A thread owns one position of every frame
// and 4 output channels (F × 4 accumulators); where a chunk has fewer such
// tasks than threads (the head, a narrow layer), the input channels are
// split among S threads a task and the S partial sums added in order. The
// slices stream through two shared-memory buffers: slice i + 1 loads while
// slice i computes.
__global__ void __launch_bounds__(kFwdThreads)
encoder_fwd_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ x,
                   const float* __restrict__ coords, const float* __restrict__ packed,
                   float* __restrict__ out, float* __restrict__ stash, int N) {
  constexpr int F = kFwdFrames;
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // one a slice buffer
  float* buf[3];
  buf[0] = smem + 4;
  buf[1] = buf[0] + F * P.fbsz[0];
  buf[2] = buf[1] + F * P.fbsz[1];
  float* bias = buf[2] + F * P.fbsz[2];
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

  // The frames' image channels (zeros past N); every bias; the record of
  // the input with the CoordConv channels (coords = rows, then columns).
  const int HW = P.H * P.W, isz = HW * P.C0;
  for (int i = tid; i < F * isz; i += kFwdThreads) {
    const int f = i / isz, j = i - f * isz;
    buf[0][f * P.fbsz[0] + j] = f < nf ? x[(size_t)n0 * isz + i] : 0.f;
  }
  for (int l = 0; l < P.n; ++l) {
    const Layer& L = P.L[l];
    for (int c = tid; c < 4 * ((L.Co + 3) / 4); c += kFwdThreads) {
      bias[L.bias_off + c] = c < L.Co ? w.p[2 * l + 1][c] : 0.f;
    }
  }
  if (stash != nullptr) {
    const int ssz = HW * P.Cin;
    for (int i = tid; i < nf * ssz; i += kFwdThreads) {
      const int f = i / ssz, j = i - f * ssz, pix = j / P.Cin, c = j - pix * P.Cin;
      stash[(size_t)(n0 + f) * P.stash + j] =
          c < P.C0 ? x[((size_t)(n0 + f) * HW + pix) * P.C0 + c]
                   : (c == P.C0 ? coords[pix / P.W] : coords[P.H + pix % P.W]);
    }
  }
  __syncthreads();  // the mbarriers are initialised before any thread waits on them

  float acc[F][4];
  for (int i = 0; sl.layer < P.n; ++i) {
    const Slice next = fconv::next_slice(P, sl);
    if (tid == 0 && next.layer < P.n) load_slice(next, (i + 1) & 1);
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);
    __syncthreads();  // slice i and the previous layer's outputs are in place

    const int l = sl.layer;
    const Layer L = P.L[l];
    const int G = (sl.cw + 3) / 4, Gsp = G * sl.sp, tasks = L.Ho * L.Wo * G;
    const bool vec = l > 0 && L.Ci % 4 == 0;
    const float* in = buf[L.in_buf];
    float* ob = buf[L.out_buf];
    const int ibsz = P.fbsz[L.in_buf], obsz = P.fbsz[L.out_buf];
    const float* bl = bias + L.bias_off + sl.co0;
    auto run = [&](int task, int c0, int c1) {
      const int pos = task / G, cg = task - pos * G;
      const int oy = pos / L.Wo, ox = pos - oy * L.Wo;
      const float* wrow = WB[i & 1] + cg * sl.sp;
      if (vec) {
        // Taps in the padding are skipped, not multiplied by zero.
        auto walk = [&](int tap) {
          const int ky = tap / L.k, kx = tap - ky * L.k;
          const int iy = oy * L.s - L.p + ky, ix = ox * L.s - L.p + kx;
          return iy < 0 || iy >= L.Hi || ix < 0 || ix >= L.Wi ? -1 : iy * L.Wi + ix;
        };
        fconv::conv_taps<F, 4, true>(sl.t0, sl.t0, sl.t1, L.Ci, in, ibsz, wrow, Gsp, c0, c1, walk,
                                     acc);
      } else {
        conv_scalar<F>(L, sl, in, ibsz, wrow, Gsp, oy, ox, c0, c1, l == 0 ? P.C0 : L.Ci, coords,
                       P.H, acc);
      }
    };
    // Output sum v of frame f, position pos, chunk channel c, plus the
    // bias: ELU (after the skip in a residual block's second conv), or the
    // embedding.
    auto emit = [&](float v, int f, int pos, int c) {
      const int co = sl.co0 + c;
      v += bl[c];
      if (L.mode == kHead) {
        if (out != nullptr && f < nf) out[(size_t)(n0 + f) * L.Co + co] = v;
        return;
      }
      float* o = ob + f * obsz + pos * L.Co + co;
      const float r = L.mode == kResidual ? mrssm::elu(*o + v) : mrssm::elu(v);
      *o = r;
      if (stash != nullptr && f < nf) {
        stash[(size_t)(n0 + f) * P.stash + L.out_off + pos * L.Co + co] = r;
      }
    };
    fconv::slice_tasks<F, 4, kFwdThreads>(sl, tasks, G, L.Ci, vec ? 4 : 1, part, run, emit, acc);
    __syncthreads();  // slice i's buffer is free for slice i + 2
    sl = next;
  }
}

// Pack the weights, then run the forward (encoder_fwd_kernel) on `stream`.
inline cudaError_t launch_forward(const mrssm::WeightPtrs& w, const Plan& P, const float* x,
                                  const float* coords, float* packed, float* out, float* stash,
                                  int N, cudaStream_t stream) {
  encoder_pack_kernel<<<dim3(8, P.n), 256, 0, stream>>>(w, P, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.fsmem);
  if (err != cudaSuccess) return err;
  encoder_fwd_kernel<<<(N + kFwdFrames - 1) / kFwdFrames, kFwdThreads, P.fsmem, stream>>>(
      w, P, x, coords, packed, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fenc
