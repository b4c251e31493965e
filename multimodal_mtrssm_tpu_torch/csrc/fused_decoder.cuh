// Shared code of the fused decoder kernels (fused_decoder_fwd.cu,
// fused_decoder_bwd.cu): the layer plan and the forward kernel, which the
// backward also launches to recompute and record the activations.
//
// The decoder is a chain of three kinds of layer, each reading its torch
// weight as it is:
// - kConv, a convolution (torch [Co, Ci, k, k]): the first linear ([Co,
//   Ci], a 1×1 conv on a 1×1 map), the 1×1 projection and the residual
//   blocks' 3×3 convs;
// - kUnflatten, the second linear with the reference's (c, h, w) unflatten
//   (torch [Co·h·w, Ci], one bias per output element): a transposed conv
//   from the 1×1 map with an h×w kernel;
// - kDeconv, a transposed conv (torch ConvTranspose2d [Ci, Co, k, k]),
//   out[o] += x[(o + p − t)/s] · w[t] where s divides (JAX fused_conv.py:
//   606-611), computed per output element by gathering its taps: no scatter
//   and no float atomics. At k4 s2 p1 each output pixel has a 2×2 set of
//   taps fixed by its parity; the others fail the divisibility test.
// Activations are HWC per frame (channel fastest), so the threads of a warp,
// which own neighbouring output channels, read one input value (a
// broadcast) and neighbouring weights.
//
// Layout, as the fused encoder's (fused_encoder.cuh): one block of kThreads
// per tile of `frames` frames walks every layer. The tile's activations
// live in three shared-memory buffers (ping-pong between the first two; the
// residual stream x in one of them and the block's intermediate t in the
// third); at the reference widths 8,192 floats a frame, the largest layer
// output deconv1's 16×16×16. A layer's weights are staged into shared
// memory as [Ci·k·k][Co], a chunk of output channels at a time: a residual
// conv (128·64·9 floats, 288 KB) and the second linear (256 KB) do not fit
// a block's 227 KB whole. The TPU kernel keeps every layer's banded lane
// operators resident in VMEM; here one layer's weights are resident at a
// time, read from L2 once per block.
//
// f32 FMA, no tensor cores (the reference is f32; TF32 would keep ~3
// digits). What bounds it: ~5.9 M multiply-adds a frame at 48-wide
// features, 83% in the six residual convs at 4×4 — operations, not bytes
// (features in, 4 KB of frame out).
#pragma once

#include <algorithm>

#include "mrssm_common.cuh"

namespace fdec {

constexpr int kThreads = 256;
constexpr int kMaxLayers = mrssm::kMaxWeights / 2;  // weight and bias each
// The transposed convs' kernel, stride and padding: ops/kernels/fused_conv.py
// ::fused_decoder_applicable takes only k4 s2 p1.
constexpr int kDeconvK = 4, kDeconvS = 2, kDeconvP = 1;
enum Kind { kConv = 0, kDeconv = 1, kUnflatten = 2 };
enum Act { kElu = 0, kTanh = 1 };

// ops/kernels/build.py::DecDims, field for field: N frames of F features,
// the first linear's width, conv_in_shape (c0, h0, w0), the residual
// stack's input and intermediate widths and block count, the three
// transposed convs' output channels, frames per block, and frames per chunk
// of the weight-gradient pass.
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
};

struct Plan {
  int n;
  Layer L[kMaxLayers];
  int F, frames;
  int bsz[3];                   // floats a frame of each shared-memory buffer
  int stash, dstash;            // floats a frame of the activation and cotangent records
  int wcap;                     // floats of the weight staging buffer
};

// Index in the layer's torch weight of (input channel, output channel, tap
// ky·k + kx).
__host__ __device__ inline size_t weight_index(const Layer& L, int ci, int co, int tap) {
  const int kk = L.k * L.k;
  if (L.kind == kConv) return ((size_t)co * L.Ci + ci) * kk + tap;
  if (L.kind == kDeconv) return ((size_t)ci * L.Co + co) * kk + tap;
  return ((size_t)co * kk + tap) * L.Ci + ci;
}

// Along one axis, the index j on the other side of tap t from i, or -1:
// `direct` j = i·s − p + t (a conv's input from its output; a transposed
// conv's output from its input), else j = (i + p − t)/s where s divides it
// (a transposed conv's input from its output; a conv's output from its
// input). n bounds j.
__device__ __forceinline__ int tap_index(int i, int t, int s, int p, int n, bool direct) {
  int j;
  if (direct) {
    j = i * s - p + t;
  } else {
    const int u = i + p - t;
    if (u < 0 || u % s != 0) return -1;
    j = u / s;
  }
  return j >= 0 && j < n ? j : -1;
}

// The plan of a decoder and the dynamic shared memory of its kernels; false
// where the widths need more layers than the table holds or a block's
// shared memory does not fit.
inline bool make_plan(const DecDims& d, Plan* out, size_t* smem_bytes) {
  Plan p = {};
  p.F = d.F;
  p.frames = d.frames;
  p.bsz[0] = d.F;
  p.stash = d.F;
  int hi = 1, wi = 1, ci = d.F, buf = 0, off = 0;
  auto add = [&](int kind, int co, int ho, int wo, int k, int s, int pad, int act, int residual,
                 int out_buf, int acc_in) -> bool {
    if (p.n == kMaxLayers) return false;
    Layer& L = p.L[p.n++];
    L = Layer{hi, wi, ci, ho, wo, co, k, s, pad, kind, act, residual, buf, out_buf, off,
              p.stash, p.dstash, acc_in};
    const int size = ho * wo * co;
    p.stash += size;
    p.dstash += size;
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
  if (!ok || d.frames < 1) return false;

  // Weight staging: the forward takes a chunk of output channels at a time,
  // Ci·k·k·(chunk + 1) floats (row stride chunk + 1); the backward a chunk
  // of input channels, chunk·k·k·(Co + 1).
  size_t need = 0, least = 0;
  for (int l = 0; l < p.n; ++l) {
    const Layer& L = p.L[l];
    const size_t kk = (size_t)L.k * L.k, K = L.Ci * kk;
    need = std::max(need, K * (L.Co + 1));
    least = std::max(least, std::max(K * 2, kk * (L.Co + 1)));
  }
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  const size_t act = (size_t)d.frames * (p.bsz[0] + p.bsz[1] + p.bsz[2]);
  const size_t limit_floats = (size_t)limit / sizeof(float);
  if (act + least > limit_floats) return false;
  p.wcap = (int)std::min(need, limit_floats - act);
  *out = p;
  *smem_bytes = (act + p.wcap) * sizeof(float);
  return true;
}

namespace {

// Stage output channels [co0, co0 + cw) of layer L's weights as
// WB[(ci·k·k + tap)·ws + c], reading the torch weight in its own order
// (consecutive threads on consecutive addresses).
__device__ __forceinline__ void stage_out_chunk(float* WB, const float* __restrict__ W,
                                                const Layer& L, int co0, int cw, int ws) {
  const int kk = L.k * L.k, K = L.Ci * kk;
  for (int i = threadIdx.x; i < cw * K; i += blockDim.x) {
    int c, ci, tap;
    if (L.kind == kConv) {          // [Co][Ci][kk]
      c = i / K;
      const int j = i - c * K;
      ci = j / kk; tap = j - ci * kk;
    } else if (L.kind == kDeconv) {  // [Ci][Co][kk]
      ci = i / (cw * kk);
      const int j = i - ci * cw * kk;
      c = j / kk; tap = j - c * kk;
    } else {                         // [Co][kk][Ci]
      c = i / K;
      const int j = i - c * K;
      tap = j / L.Ci; ci = j - tap * L.Ci;
    }
    WB[(ci * kk + tap) * ws + c] = W[weight_index(L, ci, co0 + c, tap)];
  }
}

// The forward over a tile of frames: features [N, F] → out [N, 32, 32, 1]
// (not written when null). With `stash` it also records each frame's
// activations (the features, then every layer's output) at
// stash[n · P.stash + offset], for the backward.
__global__ void __launch_bounds__(kThreads)
decoder_fwd_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ feats,
                   float* __restrict__ out, float* __restrict__ stash, int N) {
  extern __shared__ float smem[];
  const int F = P.frames;
  float* buf[3];
  buf[0] = smem;
  buf[1] = buf[0] + F * P.bsz[0];
  buf[2] = buf[1] + F * P.bsz[1];
  float* WB = buf[2] + F * P.bsz[2];
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);

  for (int i = threadIdx.x; i < nf * P.F; i += blockDim.x) {
    const int f = i / P.F, j = i - f * P.F;
    const float v = feats[(size_t)(n0 + f) * P.F + j];
    buf[0][f * P.bsz[0] + j] = v;
    if (stash != nullptr) stash[(size_t)(n0 + f) * P.stash + j] = v;
  }

  for (int l = 0; l < P.n; ++l) {
    const Layer L = P.L[l];
    const int kk = L.k * L.k, K = L.Ci * kk, HWo = L.Ho * L.Wo;
    const int cn = min(L.Co, P.wcap / K - 1);
    const bool direct = L.kind == kConv, last = l == P.n - 1;
    const float* in = buf[L.in_buf];
    float* ob = buf[L.out_buf];
    const float* bl = w.p[2 * l + 1];
    for (int co0 = 0; co0 < L.Co; co0 += cn) {
      const int cw = min(cn, L.Co - co0), ws = cw + 1;
      __syncthreads();  // the previous layer's outputs are in place; WB is free
      stage_out_chunk(WB, w.p[2 * l], L, co0, cw, ws);
      __syncthreads();
      for (int i = threadIdx.x; i < nf * HWo * cw; i += blockDim.x) {
        const int c = i % cw, fp = i / cw, pos = fp % HWo, f = fp / HWo;
        const int oy = pos / L.Wo, ox = pos - oy * L.Wo;
        const float* src = in + f * P.bsz[L.in_buf];
        float acc = 0.f;
        for (int ky = 0; ky < L.k; ++ky) {
          const int iy = tap_index(oy, ky, L.s, L.p, L.Hi, direct);
          if (iy < 0) continue;
          for (int kx = 0; kx < L.k; ++kx) {
            const int ix = tap_index(ox, kx, L.s, L.p, L.Wi, direct);
            if (ix < 0) continue;
            const float* a = src + (iy * L.Wi + ix) * L.Ci;
            const float* wr = WB + (ky * L.k + kx) * ws + c;
            // Not unrolled, as the fused encoder's tap loop: the unrolled
            // form faulted with an illegal instruction on an H100 (CUDA 12.9).
#pragma unroll 1
            for (int ci = 0; ci < L.Ci; ++ci) acc = fmaf(a[ci], wr[ci * kk * ws], acc);
          }
        }
        const int co = co0 + c;
        const float v = acc + __ldg(bl + (L.kind == kUnflatten ? co * HWo + pos : co));
        float* o = ob + f * P.bsz[L.out_buf] + pos * L.Co + co;
        const float r = L.act == kTanh ? tanhf(v) : mrssm::elu(L.residual ? *o + v : v);
        *o = r;
        if (stash != nullptr) stash[(size_t)(n0 + f) * P.stash + L.out_off + pos * L.Co + co] = r;
        if (last && out != nullptr) out[((size_t)(n0 + f) * HWo + pos) * L.Co + co] = r;
      }
    }
  }
}

inline cudaError_t launch_forward(const mrssm::WeightPtrs& w, const Plan& P, size_t smem,
                                  const float* feats, float* out, float* stash, int N,
                                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decoder_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + P.frames - 1) / P.frames;
  decoder_fwd_kernel<<<blocks, kThreads, smem, stream>>>(w, P, feats, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdec
