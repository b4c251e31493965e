// The conv encoder in one kernel per tile of frames, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461), the custom VJP of fused_encoder_apply (lines 530-558): the
// gradients of every encoder weight and bias and, when asked, of the
// frames. Like the TPU backward it recomputes the activations from the
// input instead of keeping the forward's. Four passes:
//
// 1. the forward (fused_encoder.cuh: encoder_pack_kernel, then
//    encoder_fwd_kernel) recomputes each tile and records every layer's
//    output in device memory (13,824 floats a frame at the reference
//    widths);
// 2. encoder_bwd_dx_kernel walks the layers in reverse per tile of frames,
//    with the cotangents in shared memory and each layer's weights staged
//    a chunk of input channels at a time, transposed as the conv's
//    transpose reads them: it multiplies by the ELU derivative (from the
//    recorded output, as fused_conv.py::_act_deriv), records each layer's
//    pre-activation cotangent (10,816 floats a frame), and propagates it to
//    the layer's input (the skip path of a residual block is added where
//    the block's input receives it) and, when asked, to the frames;
// 3. encoder_bwd_dw_kernel forms the weight and bias gradients: one thread
//    per gradient element and chunk of frames sums over the chunk's frames
//    and output positions in a fixed order (≤ 64 chunks);
// 4. mrssm::reduce_weight_grads adds the chunks in order and writes torch
//    layout. No float atomics anywhere, so two runs give the same bits.
//
// What bounds it: operations, ~11 MFLOP a frame (the weight gradients and
// the input cotangents each cost about the forward's ~5.5) plus the
// recompute; the records (~99 KB a frame) stay in L2 at N=240.
#include "fused_encoder.cuh"

namespace {

using fenc::Layer;
using fenc::Plan;

// Reverse pass over a tile of frames (see above). g [N, out_dim] is the
// output's cotangent; dx [N, H, W, C0], or null for no input gradient.
__global__ void __launch_bounds__(fenc::kThreads)
encoder_bwd_dx_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ g,
                      float* __restrict__ dx, const float* __restrict__ stash,
                      float* __restrict__ dstash, int N) {
  extern __shared__ float smem[];
  const int F = P.frames;
  float* buf[3];
  buf[0] = smem;
  buf[1] = buf[0] + F * P.bsz[0];
  buf[2] = buf[1] + F * P.bsz[1];
  float* WB = buf[2] + F * P.bsz[2];
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);

  {
    const Layer head = P.L[P.n - 1];
    for (int i = threadIdx.x; i < nf * head.Co; i += blockDim.x) {
      const int f = i / head.Co, o = i - f * head.Co;
      buf[head.out_buf][f * P.bsz[head.out_buf] + o] = g[(size_t)(n0 + f) * head.Co + o];
    }
  }
  for (int l = P.n - 1; l >= 0; --l) {
    const Layer L = P.L[l];
    const int kk = L.k * L.k, K = L.Ci * kk, osz = L.Ho * L.Wo * L.Co, ws = L.Co + 1;
    float* dout = buf[L.out_buf];
    __syncthreads();  // the cotangent of this layer's output is complete
    // The pre-activation cotangent, in place, and its record.
    for (int i = threadIdx.x; i < nf * osz; i += blockDim.x) {
      const int f = i / osz, j = i - f * osz;
      float* d = dout + f * P.bsz[L.out_buf] + j;
      float v = *d;
      if (L.mode != fenc::kHead) {
        const float o = stash[(size_t)(n0 + f) * P.stash + L.out_off + j];
        v *= o > 0.f ? 1.f : o + 1.f;
      }
      *d = v;
      dstash[(size_t)(n0 + f) * P.dstash + L.dpre_off + j] = v;
    }
    if (l == 0 && dx == nullptr) break;
    // The input cotangent: the image channels only for the first layer.
    const int cin = l == 0 ? P.C0 : L.Ci;
    const int cn = max(1, min(cin, P.wcap / (kk * ws)));
    const int HWi = L.Hi * L.Wi;
    for (int c0 = 0; c0 < cin; c0 += cn) {
      const int cw = min(cn, cin - c0);
      __syncthreads();  // the pre-activation cotangent is in place; WB is free
      for (int i = threadIdx.x; i < L.Co * cw * kk; i += blockDim.x) {
        const int co = i / (cw * kk), j = i - co * (cw * kk);
        WB[j * ws + co] = w.p[2 * l][(size_t)co * K + c0 * kk + j];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nf * HWi * cw; i += blockDim.x) {
        const int c = i % cw, fp = i / cw, pin = fp % HWi, f = fp / HWi;
        const int iy = pin / L.Wi, ix = pin - iy * L.Wi;
        const float* src = dout + f * P.bsz[L.out_buf];
        float acc = 0.f;
        for (int ky = 0; ky < L.k; ++ky) {
          const int ty = iy + L.p - ky;
          if (ty < 0 || ty % L.s != 0 || ty / L.s >= L.Ho) continue;
          const int oy = ty / L.s;
          for (int kx = 0; kx < L.k; ++kx) {
            const int tx = ix + L.p - kx;
            if (tx < 0 || tx % L.s != 0 || tx / L.s >= L.Wo) continue;
            const float* dp = src + (oy * L.Wo + tx / L.s) * L.Co;
            const float* wr = WB + (c * kk + ky * L.k + kx) * ws;
            // Not unrolled: the unrolled form of the first forward's
            // equivalent loop faulted with an illegal instruction on an H100
            // (CUDA 12.9, ptxas -O1 and up).
#pragma unroll 1
            for (int co = 0; co < L.Co; ++co) acc = fmaf(dp[co], wr[co], acc);
          }
        }
        if (l == 0) {
          dx[((size_t)(n0 + f) * HWi + pin) * P.C0 + c0 + c] = acc;
        } else {
          float* d = buf[L.in_buf] + f * P.bsz[L.in_buf] + pin * L.Ci + c0 + c;
          *d = L.acc_in ? *d + acc : acc;
        }
      }
    }
  }
}

// Weight and bias gradients, one thread per element s of the [in, out]
// layout of `gd` (a layer's weight as [Ci·k·k][Co], then its bias) and one
// chunk of frames (blockIdx.y): the sum over the chunk's frames and the
// layer's output positions of (pre-activation cotangent × input
// activation), in a fixed order, into partial[chunk][s].
__global__ void encoder_bwd_dw_kernel(Plan P, mrssm::WeightDims gd, const float* __restrict__ stash,
                                      const float* __restrict__ dstash,
                                      float* __restrict__ partial, int N, int chunk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= gd.total) return;
  int i = 0;
  while (i + 1 < gd.n && s >= gd.off[i + 1]) ++i;
  const Layer L = P.L[i / 2];
  const int local = s - gd.off[i];
  const int kidx = local / L.Co, co = local - kidx * L.Co;
  const int n_begin = blockIdx.y * chunk, n_end = min(N, n_begin + chunk);
  // Two levels of sums, each frame's positions and then the chunk's frames,
  // so that no running sum takes more than 256 terms (one running sum over
  // a chunk takes up to 60 frames × 256 positions at N=3840).
  float acc = 0.f;
  if (i % 2 == 1) {  // bias
    for (int n = n_begin; n < n_end; ++n) {
      const float* dp = dstash + (size_t)n * P.dstash + L.dpre_off + co;
      float frame = 0.f;
      for (int pos = 0; pos < L.Ho * L.Wo; ++pos) frame += dp[pos * L.Co];
      acc += frame;
    }
  } else {
    const int kk = L.k * L.k, ci = kidx / kk, tap = kidx - ci * kk;
    const int ky = tap / L.k, kx = tap - ky * L.k;
    for (int n = n_begin; n < n_end; ++n) {
      const float* dp = dstash + (size_t)n * P.dstash + L.dpre_off + co;
      const float* a = stash + (size_t)n * P.stash + L.in_off + ci;
      float frame = 0.f;
      for (int oy = 0; oy < L.Ho; ++oy) {
        const int iy = oy * L.s - L.p + ky;
        if (iy < 0 || iy >= L.Hi) continue;
        for (int ox = 0; ox < L.Wo; ++ox) {
          const int ix = ox * L.s - L.p + kx;
          if (ix < 0 || ix >= L.Wi) continue;
          frame = fmaf(dp[(oy * L.Wo + ox) * L.Co], a[(iy * L.Wi + ix) * L.Ci], frame);
        }
      }
      acc += frame;
    }
  }
  partial[(size_t)blockIdx.y * gd.total + s] = acc;
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

// Launch on `stream` the four passes above. x [N, H, W, C0], coords [H + W],
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
  size_t smem = 0;
  if (!fenc::make_plan(d, &P, &smem) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, n_weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fenc::launch_forward(w, P, x, coords, packed, nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.N + P.frames - 1) / P.frames;
  encoder_bwd_dx_kernel<<<blocks, fenc::kThreads, smem, s>>>(w, P, g, dx, stash, dstash, d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const mrssm::WeightDims gd = grad_dims(P);
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  encoder_bwd_dw_kernel<<<dim3((gd.total + 255) / 256, chunks), 256, 0, s>>>(
      P, gd, stash, dstash, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, chunks, gd, d_weights, s);
}

}  // extern "C"
