// The conv encoder in bf16 (trainer.precision 16-mixed with
// conv_layout="fused_enc"): shared code of fused_encoder_bf16_fwd.cu and
// fused_encoder_bf16_bwd.cu.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) and ::_bwd_kernel (line 461) at dtype=bfloat16, as
// fused_encoder_apply (line 561) reaches them for bf16 frames. The
// numerics are JAX's _layer_fwd (lines 266-299) and _walk_bwd (line 315):
// frames, weights, activations and the embedding are bf16 values; each
// layer sums its products in f32, adds the bias and applies ELU in f32
// (the residual skip added before the ELU), then rounds its output to bf16
// (round to nearest even). The backward recomputes those activations,
// keeps every cotangent and every weight-gradient sum in f32, takes the
// ELU derivative from the rounded output (o > 0 ? 1 : o + 1, JAX's
// _act_deriv), and rounds dx and the weight gradients to bf16 at the end
// (JAX casts its gradients to the operand dtype, line 554). Unlike JAX it
// does not round the cotangent to bf16 where JAX cuts the stack into two
// segments (act3): here there is one stack.
//
// A design of its own, simpler than the f32 kernels' (fused_encoder.cuh),
// which it leaves untouched: a bf16 product of two bf16 values is exact in
// f32, so every layer is plain f32 FMA over bf16 operands, one output
// (position, channel) of every frame of the tile a thread, walking taps
// in order, then input channels in order. The weights are first packed to
// [tap][Ci][Co] (consecutive threads read consecutive output channels),
// and read through L1/L2; a tile's whole activation record sits in shared
// memory in bf16 (27,648 bytes a frame at the reference widths, 4 frames a
// block where the f32 plan holds 2). No tensor cores yet (mma.sync on bf16
// operands is later work), no float atomics: two launches give the same
// bits.
//
// Backward, four launches after the recompute (the forward, recording
// every activation): the cotangent pass walks the layers in reverse per
// tile of frames with the cotangents in shared memory (f32), recording
// each layer's pre-activation cotangent; the weight-gradient pass gives a
// block one (layer, tap, input channel) row, or a layer's bias row, and
// one chunk of frames, its threads splitting the chunk's (frame, position)
// terms in a fixed stride and summing them in a fixed order; a last launch
// adds the chunks in order and writes the torch-layout bf16 gradients.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace fbf {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxFwdFrames = 4;  // frames a block of the forward, where shared memory fits
constexpr int kMaxBwdFrames = 2;  // frames a block of the cotangent pass
constexpr int kMaxLayers = 14;
enum Mode { kElu = 0, kResidual = 1, kHead = 2 };

// ops/kernels/build.py::EncDims, field for field (the f32 kernels' struct):
// `frames` is not read here (the plan picks its own), `chunk` is the frames
// a chunk of the weight-gradient pass.
struct EncDims {
  int N, H, W, C0, coord, ch0, ch1, ch2, res_out, res_mid, n_res, out_dim, frames, chunk;
};

struct Layer {
  int Hi, Wi, Ci, Ho, Wo, Co, k, s, p, mode;
  int in_off, out_off, skip_off;  // per-frame offsets in the activation record (the head's
                                  // out_off: its cotangent's, past the record)
  int dpre_off;                   // per-frame offset in the pre-activation cotangent record
  int w_off, b_off;               // packed weights [k·k][Ci][Co] and bias [Co] (bf16 elements)
  int g_off;                      // the layer's gradients (weight, then bias) among all
  int row0;                       // its first row of the weight-gradient pass
};

struct Plan {
  int n;
  Layer L[kMaxLayers];
  int H, W, C0, Cin;
  int stash;    // bf16 elements a frame of the activation record (a multiple of 8)
  int drec;     // floats a frame of the cotangent pass's record (the activations' and the
                // head output's cotangents)
  int dstash;   // floats a frame of the pre-activation cotangent record
  int packed;   // bf16 elements of the packed weights and biases
  int grads;    // gradient elements, all tensors back to back
  int rows;     // rows of the weight-gradient pass
  int ffr, bfr; // frames a block of the forward and of the cotangent pass
  size_t fsmem, bsmem;
};

struct WeightPtrs {
  const bf16* p[2 * kMaxLayers];
};

inline WeightPtrs weight_ptrs(const void* const* weights, int n) {
  WeightPtrs w;
  for (int i = 0; i < n; ++i) w.p[i] = static_cast<const bf16*>(weights[i]);
  return w;
}

// The plan of an encoder; false where the widths need more layers than the
// table holds or one frame's records do not fit a block's shared memory.
inline bool make_plan(const EncDims& d, Plan* out) {
  Plan p = {};
  p.H = d.H;
  p.W = d.W;
  p.C0 = d.C0;
  p.Cin = d.C0 + (d.coord ? 2 : 0);
  int stash = d.H * d.W * p.Cin;
  int hi = d.H, wi = d.W, ci = p.Cin, off = 0, grads = 0, rows = 0, packed = 0, dstash = 0;
  auto add = [&](int co, int k, int s, int pad, int mode, int skip) -> bool {
    if (p.n == kMaxLayers) return false;
    Layer& L = p.L[p.n++];
    L.Hi = hi; L.Wi = wi; L.Ci = ci;
    L.Ho = (hi + 2 * pad - k) / s + 1;
    L.Wo = (wi + 2 * pad - k) / s + 1;
    L.Co = co; L.k = k; L.s = s; L.p = pad; L.mode = mode;
    L.in_off = off;
    L.skip_off = skip;
    L.out_off = stash;
    if (mode != kHead) stash += L.Ho * L.Wo * co;
    L.dpre_off = dstash;
    dstash += L.Ho * L.Wo * co;
    L.w_off = packed;
    packed += k * k * ci * co;
    L.b_off = packed;
    packed += co;
    L.g_off = grads;
    grads += co * (ci * k * k + 1);
    L.row0 = rows;
    rows += k * k * ci + 1;
    hi = L.Ho; wi = L.Wo; ci = co; off = L.out_off;
    return true;
  };
  const int ch[3] = {d.ch0, d.ch1, d.ch2};
  bool ok = true;
  for (int i = 0; i < 3; ++i) ok = ok && add(ch[i], 3, 2, 1, kElu, -1);
  if (d.n_res > 0 && ci != d.res_out) ok = ok && add(d.res_out, 1, 1, 0, kElu, -1);
  for (int r = 0; r < d.n_res && ok; ++r) {
    const int x = off, xc = ci;
    ok = add(d.res_mid, 3, 1, 1, kElu, -1) && add(xc, 3, 1, 1, kResidual, x);
  }
  ok = ok && hi == wi && add(d.out_dim, hi, 1, 0, kHead, -1);
  if (!ok) return false;
  p.stash = (stash + 7) / 8 * 8;
  p.drec = (stash + d.out_dim + 3) / 4 * 4;
  p.dstash = dstash;
  p.packed = packed;
  p.grads = grads;
  p.rows = rows;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  p.ffr = std::min<int>(kMaxFwdFrames, limit / (p.stash * (int)sizeof(bf16)));
  p.bfr = std::min<int>(kMaxBwdFrames, limit / (p.drec * (int)sizeof(float)));
  if (p.ffr < 1 || p.bfr < 1) return false;
  p.fsmem = (size_t)p.ffr * p.stash * sizeof(bf16);
  p.bsmem = (size_t)p.bfr * p.drec * sizeof(float);
  *out = p;
  return true;
}

namespace {

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(x) - 1.f; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rn(float v) { return __float2bfloat16_rn(v); }

// Pack each layer's torch-layout weight [Co][Ci][k][k] as [k·k][Ci][Co],
// then its bias.
__global__ void encoder_bf16_pack_kernel(WeightPtrs w, Plan P, bf16* __restrict__ packed) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < P.packed; e += gridDim.x * blockDim.x) {
    int l = 0;
    while (l + 1 < P.n && P.L[l + 1].w_off <= e) ++l;
    const Layer& L = P.L[l];
    if (e >= L.b_off) {
      packed[e] = w.p[2 * l + 1][e - L.b_off];
      continue;
    }
    const int i = e - L.w_off, tap = i / (L.Ci * L.Co), r = i - tap * L.Ci * L.Co;
    const int ci = r / L.Co, co = r - ci * L.Co;
    packed[e] = w.p[2 * l][((size_t)co * L.Ci + ci) * L.k * L.k + tap];
  }
}

// The forward over a tile of F frames: x [N, H, W, C0] → out [N, out_dim]
// (not written when null); with `stash`, each frame's activation record
// (the input with its CoordConv channels, every layer's output but the
// head's) at stash[n · P.stash].
template <int F>
__global__ void __launch_bounds__(kThreads)
encoder_bf16_fwd_kernel(Plan P, const bf16* __restrict__ x, const float* __restrict__ coords,
                const bf16* __restrict__ packed, bf16* __restrict__ out,
                bf16* __restrict__ stash, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, n0 = blockIdx.x * F, nf = min(F, N - n0);
  const int HW = P.H * P.W, isz = HW * P.Cin;
  for (int i = tid; i < F * isz; i += kThreads) {
    const int f = i / isz, j = i - f * isz, pix = j / P.Cin, c = j - pix * P.Cin;
    bf16 v;
    if (c < P.C0) {
      v = f < nf ? x[((size_t)(n0 + f) * HW + pix) * P.C0 + c] : rn(0.f);
    } else {
      v = rn(c == P.C0 ? coords[pix / P.W] : coords[P.H + pix % P.W]);
    }
    act[f * P.stash + j] = v;
    if (stash != nullptr && f < nf) stash[(size_t)(n0 + f) * P.stash + j] = v;
  }
  __syncthreads();
  for (int l = 0; l < P.n; ++l) {
    const Layer L = P.L[l];
    const int total = L.Ho * L.Wo * L.Co;
    for (int o = tid; o < total; o += kThreads) {
      const int pos = o / L.Co, co = o - pos * L.Co, oy = pos / L.Wo, ox = pos - oy * L.Wo;
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
      for (int ky = 0; ky < L.k; ++ky) {
        const int iy = oy * L.s - L.p + ky;
        if (iy < 0 || iy >= L.Hi) continue;
        for (int kx = 0; kx < L.k; ++kx) {
          const int ix = ox * L.s - L.p + kx;
          if (ix < 0 || ix >= L.Wi) continue;
          const bf16* a = act + L.in_off + (iy * L.Wi + ix) * L.Ci;
          const bf16* wt = packed + L.w_off + (size_t)(ky * L.k + kx) * L.Ci * L.Co + co;
          for (int ci = 0; ci < L.Ci; ++ci) {
            const float wv = f32(__ldg(wt + (size_t)ci * L.Co));
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = fmaf(f32(a[f * P.stash + ci]), wv, acc[f]);
          }
        }
      }
      const float b = f32(__ldg(packed + L.b_off + co));
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = acc[f] + b;
        if (L.mode == kHead) {
          if (out != nullptr && f < nf) out[(size_t)(n0 + f) * L.Co + co] = rn(v);
          continue;
        }
        if (L.mode == kResidual) v = f32(act[f * P.stash + L.skip_off + o]) + v;
        const bf16 r = rn(elu(v));
        act[f * P.stash + L.out_off + o] = r;
        if (stash != nullptr && f < nf) stash[(size_t)(n0 + f) * P.stash + L.out_off + o] = r;
      }
    }
    __syncthreads();
  }
}

template <int F>
cudaError_t launch_fwd_kernel(const Plan& P, const bf16* x, const float* coords,
                              const bf16* packed, bf16* out, bf16* stash, int N,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(encoder_bf16_fwd_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P.fsmem);
  if (err != cudaSuccess) return err;
  encoder_bf16_fwd_kernel<F><<<(N + F - 1) / F, kThreads, P.fsmem, stream>>>(
      P, x, coords, packed, out, stash, N);
  return cudaGetLastError();
}

// Pack the weights, then run the forward on `stream`.
inline cudaError_t launch_forward(const WeightPtrs& w, const Plan& P, const bf16* x,
                                  const float* coords, bf16* packed, bf16* out, bf16* stash,
                                  int N, cudaStream_t stream) {
  encoder_bf16_pack_kernel<<<64, kThreads, 0, stream>>>(w, P, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (P.ffr) {
    case 4: return launch_fwd_kernel<4>(P, x, coords, packed, out, stash, N, stream);
    case 3: return launch_fwd_kernel<3>(P, x, coords, packed, out, stash, N, stream);
    case 2: return launch_fwd_kernel<2>(P, x, coords, packed, out, stash, N, stream);
    default: return launch_fwd_kernel<1>(P, x, coords, packed, out, stash, N, stream);
  }
}

}  // namespace
}  // namespace fbf
