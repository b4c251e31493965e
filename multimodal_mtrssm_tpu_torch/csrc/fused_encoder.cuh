// Shared code of the fused encoder kernels (fused_encoder_fwd.cu,
// fused_encoder_bwd.cu): the layer plan and the forward kernel, which the
// backward also launches to recompute and record the activations.
//
// The encoder is a chain of convolutions: the three strided convs, the 1×1
// projection, two 3×3 convs a residual block, and the linear head, which on
// the CHW-flattened 4×4 map is a 4×4 valid conv with `out` channels (its
// torch weight [out, C·16] is [out, C, 4, 4]). Each layer reads its torch
// weight [Co, Ci, k, k] as it is. Activations are HWC per frame (channel
// fastest), so the threads of a warp, which own neighbouring output
// channels, read one input value (a broadcast) and neighbouring weights.
//
// Layout: one block of kThreads per tile of `frames` frames. The tile's
// activations live in three shared-memory buffers (ping-pong between the
// first two for the strided convs; the residual stream x in one, the
// block's intermediate t in the third). A layer's weights are staged into
// shared memory transposed to [Ci·k·k][Co], a chunk of output channels at a
// time; the widest, a residual conv, is 147 KB and fits whole beside two
// frames' activations (48 KB). This is where the TPU design does not carry
// over: fused_conv.py keeps every layer's banded lane operators (megabytes)
// resident in VMEM at once; here one layer's weights are resident at a
// time, read from L2 once per block.
//
// f32 FMA, no tensor cores (the reference is f32; TF32 would keep ~3
// digits). What bounds it: ~5.5 MFLOP a frame, ~90% in the six 64→64
// residual convs at 4×4 — operations, not bytes.
#pragma once

#include <algorithm>

#include "mrssm_common.cuh"

namespace fenc {

constexpr int kThreads = 256;
constexpr int kMaxLayers = mrssm::kMaxWeights / 2;  // weight and bias each
enum Mode { kElu = 0, kResidual = 1, kHead = 2 };

// ops/kernels/build.py::EncDims, field for field: N frames of H×W×C0 (+ 2
// CoordConv channels when coord), the strided convs' widths, the residual
// stream's and intermediate widths and block count, the embedding width,
// frames per block, and frames per chunk of the weight-gradient pass.
struct EncDims {
  int N, H, W, C0, coord, ch0, ch1, ch2, res_out, res_mid, n_res, out_dim, frames, chunk;
};

struct Layer {
  int Hi, Wi, Ci, Ho, Wo, Co, k, s, p;
  int mode;
  int in_buf, out_buf;          // shared-memory buffers of input and output (forward),
                                // of their cotangents (backward)
  int in_off, out_off;          // per-frame offsets of input and output in the activation
                                // record (out_off -1: the head, not recorded)
  int dpre_off;                 // per-frame offset of the output's pre-activation
                                // cotangent in the cotangent record
  int acc_in;                   // backward: add the input cotangent to its buffer (the
                                // input also feeds a residual skip)
};

struct Plan {
  int n;
  Layer L[kMaxLayers];
  int H, W, C0, Cin, frames;
  int bsz[3];                   // floats a frame of each shared-memory buffer
  int stash, dstash;            // floats a frame of the activation and cotangent records
  int wcap;                     // floats of the weight staging buffer
};

// The plan of an encoder and the dynamic shared memory of its kernels;
// false where the widths need more layers than the table holds or a block's
// shared memory does not fit.
inline bool make_plan(const EncDims& d, Plan* out, size_t* smem_bytes) {
  Plan p = {};
  p.H = d.H;
  p.W = d.W;
  p.C0 = d.C0;
  p.Cin = d.C0 + (d.coord ? 2 : 0);
  p.frames = d.frames;
  p.bsz[0] = d.H * d.W * p.Cin;
  p.stash = p.bsz[0];
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
    if (size > p.bsz[out_buf]) p.bsz[out_buf] = size;
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
  if (!ok || d.frames < 1) return false;

  // Weight staging: the forward takes a chunk of output channels at a time,
  // (Ci·k·k + 1)·(chunk + 1) floats (weights and bias, row stride chunk + 1);
  // the backward a chunk of input channels, chunk·k·k·(Co + 1).
  size_t need = 0, least = 0;
  for (int l = 0; l < p.n; ++l) {
    const Layer& L = p.L[l];
    const size_t K = (size_t)L.Ci * L.k * L.k, kk = (size_t)L.k * L.k;
    const size_t ci_bwd = l == 0 ? p.C0 : L.Ci;
    need = std::max(need, std::max((K + 1) * (L.Co + 1), ci_bwd * kk * (L.Co + 1)));
    least = std::max(least, std::max((K + 1) * 2, kk * (L.Co + 1)));
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

// The forward over a tile of frames: frames x [N, H, W, C0] → out [N,
// out_dim] (not written when null). With `stash` it also records each
// frame's activations (the input with its coordinate channels, then every
// layer's output but the head's) at stash[n · P.stash + offset], for the
// backward.
__global__ void __launch_bounds__(kThreads)
encoder_fwd_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ x,
                   const float* __restrict__ coords, float* __restrict__ out,
                   float* __restrict__ stash, int N) {
  extern __shared__ float smem[];
  const int F = P.frames;
  float* buf[3];
  buf[0] = smem;
  buf[1] = buf[0] + F * P.bsz[0];
  buf[2] = buf[1] + F * P.bsz[1];
  float* WB = buf[2] + F * P.bsz[2];
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);

  // The input frames with the CoordConv channels (coords = rows, then columns).
  const int HW = P.H * P.W, in_sz = HW * P.Cin;
  for (int i = threadIdx.x; i < nf * in_sz; i += blockDim.x) {
    const int f = i / in_sz, j = i - f * in_sz, pix = j / P.Cin, c = j - pix * P.Cin;
    const float v = c < P.C0 ? x[((size_t)(n0 + f) * HW + pix) * P.C0 + c]
                             : (c == P.C0 ? coords[pix / P.W] : coords[P.H + pix % P.W]);
    buf[0][f * P.bsz[0] + j] = v;
    if (stash != nullptr) stash[(size_t)(n0 + f) * P.stash + j] = v;
  }

  for (int l = 0; l < P.n; ++l) {
    const Layer L = P.L[l];
    const int kk = L.k * L.k, K = L.Ci * kk, HWo = L.Ho * L.Wo;
    const int cn = min(L.Co, P.wcap / (K + 1) - 1);
    const float* in = buf[L.in_buf];
    float* ob = buf[L.out_buf];
    const float* Wl = w.p[2 * l];
    const float* bl = w.p[2 * l + 1];
    for (int co0 = 0; co0 < L.Co; co0 += cn) {
      const int cw = min(cn, L.Co - co0), ws = cw + 1;
      __syncthreads();  // the previous layer's outputs are in place; WB is free
      for (int i = threadIdx.x; i < cw * K; i += blockDim.x) {
        const int c = i / K, j = i - c * K;
        WB[j * ws + c] = Wl[(size_t)(co0 + c) * K + j];
      }
      for (int i = threadIdx.x; i < cw; i += blockDim.x) WB[K * ws + i] = bl[co0 + i];
      __syncthreads();
      for (int i = threadIdx.x; i < nf * HWo * cw; i += blockDim.x) {
        const int c = i % cw, fp = i / cw, pos = fp % HWo, f = fp / HWo;
        const int oy = pos / L.Wo, ox = pos - oy * L.Wo;
        const float* src = in + f * P.bsz[L.in_buf];
        float acc = 0.f;
        for (int ky = 0; ky < L.k; ++ky) {
          const int iy = oy * L.s - L.p + ky;
          if (iy < 0 || iy >= L.Hi) continue;
          for (int kx = 0; kx < L.k; ++kx) {
            const int ix = ox * L.s - L.p + kx;
            if (ix < 0 || ix >= L.Wi) continue;
            const float* a = src + (iy * L.Wi + ix) * L.Ci;
            const float* wr = WB + (ky * L.k + kx) * ws + c;
            // Not unrolled: the unrolled form of this loop faulted with an
            // illegal instruction on an H100 (CUDA 12.9, ptxas -O1 and up).
#pragma unroll 1
            for (int ci = 0; ci < L.Ci; ++ci) acc = fmaf(a[ci], wr[ci * kk * ws], acc);
          }
        }
        const float v = acc + WB[K * ws + c];
        const int co = co0 + c;
        if (L.mode == kHead) {
          if (out != nullptr) out[(size_t)(n0 + f) * L.Co + co] = v;
          continue;
        }
        float* o = ob + f * P.bsz[L.out_buf] + pos * L.Co + co;
        const float r = L.mode == kResidual ? mrssm::elu(*o + v) : mrssm::elu(v);
        *o = r;
        if (stash != nullptr) stash[(size_t)(n0 + f) * P.stash + L.out_off + pos * L.Co + co] = r;
      }
    }
  }
}

inline cudaError_t launch_forward(const mrssm::WeightPtrs& w, const Plan& P, size_t smem,
                                  const float* x, const float* coords, float* out, float* stash,
                                  int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(encoder_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + P.frames - 1) / P.frames;
  encoder_fwd_kernel<<<blocks, kThreads, smem, stream>>>(w, P, x, coords, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fenc
