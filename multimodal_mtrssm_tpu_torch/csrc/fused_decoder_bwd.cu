// The conv decoder in one kernel per tile of frames, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461), the custom VJP of fused_decoder_apply's segments (lines
// 530-558): the gradients of every decoder weight and bias and, when asked,
// of the features, which JAX returns from the first segment (_walk_bwd's
// dh0). Like the TPU backward it recomputes the activations from the input
// instead of keeping the forward's. Five launches in four steps, as the
// fused encoder's backward (fused_encoder_bwd.cu):
//
// 1. the forward (fused_decoder.cuh: decoder_pack_kernel, then
//    decoder_fwd_kernel) recomputes each tile and records every layer's
//    output in device memory (17,520 floats a frame at the reference widths
//    and 48-wide features);
// 2. decoder_bwd_dx_kernel walks the layers in reverse per tile of frames,
//    with the cotangents in shared memory and each layer's weights staged
//    a chunk of input channels at a time: it multiplies by the activation's
//    derivative from the recorded output (ELU: 1 or out + 1; Tanh: 1 − out²,
//    as fused_conv.py::_act_deriv), records each layer's pre-activation
//    cotangent (17,472 floats a frame), and propagates it to the layer's
//    input (the skip path of a residual block is added where the block's
//    input receives it) and, when asked, to the features. A conv's input
//    cotangent gathers through the transposed tap relation and a transposed
//    conv's through the direct one, so no pass scatters;
// 3. decoder_bwd_dw_kernel forms the weight and bias gradients: one thread
//    per gradient element and chunk of frames sums over the chunk's frames
//    and the layer's positions in a fixed order (≤ 64 chunks);
// 4. mrssm::reduce_weight_grads adds the chunks in order and writes torch
//    layout. No float atomics anywhere, so two runs give the same bits.
//
// What bounds it: operations, ~35 MFLOP a frame (the recompute, the input
// cotangents and the weight gradients each cost about the forward's
// ~11.8); the records (~140 KB a frame) stay in L2 at N=240. The recompute
// is the forward's implicit GEMM; steps 2 and 3 keep their first design
// (one output a thread, weights staged from torch layout).
#include "fused_decoder.cuh"

namespace {

using fdec::Layer;
using fdec::Plan;

// Stage input channels [c0, c0 + cw) of layer L's weights as
// WB[(c·k·k + tap)·ws + co], reading the torch weight in runs of
// consecutive addresses.
__device__ __forceinline__ void stage_in_chunk(float* WB, const float* __restrict__ W,
                                               const Layer& L, int c0, int cw, int ws) {
  const int kk = L.k * L.k;
  for (int i = threadIdx.x; i < L.Co * cw * kk; i += blockDim.x) {
    int c, co, tap;
    if (L.kind == fdec::kConv) {          // [Co][Ci][kk]
      co = i / (cw * kk);
      const int j = i - co * cw * kk;
      c = j / kk; tap = j - c * kk;
    } else if (L.kind == fdec::kDeconv) {  // [Ci][Co][kk]
      c = i / (L.Co * kk);
      const int j = i - c * L.Co * kk;
      co = j / kk; tap = j - co * kk;
    } else {                               // [Co][kk][Ci]
      const int q = i / cw;
      c = i - q * cw;
      co = q / kk; tap = q - co * kk;
    }
    WB[(c * kk + tap) * ws + co] = W[fdec::weight_index(L, c0 + c, co, tap)];
  }
}

// Reverse pass over a tile of frames (see above). g [N, 32, 32, 1] is the
// frames' cotangent; dfeats [N, F], or null for no feature gradient.
__global__ void __launch_bounds__(fdec::kThreads)
decoder_bwd_dx_kernel(mrssm::WeightPtrs w, Plan P, const float* __restrict__ g,
                      float* __restrict__ dfeats, const float* __restrict__ stash,
                      float* __restrict__ dstash, int N) {
  extern __shared__ __align__(16) float smem[];
  const int F = P.frames;
  float* buf[3];
  buf[0] = smem;
  buf[1] = buf[0] + F * P.bsz[0];
  buf[2] = buf[1] + F * P.bsz[1];
  float* WB = buf[2] + F * P.bsz[2];
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);

  {
    const Layer last = P.L[P.n - 1];
    const int osz = last.Ho * last.Wo * last.Co;
    for (int i = threadIdx.x; i < nf * osz; i += blockDim.x) {
      const int f = i / osz, j = i - f * osz;
      buf[last.out_buf][f * P.bsz[last.out_buf] + j] = g[(size_t)(n0 + f) * osz + j];
    }
  }
  for (int l = P.n - 1; l >= 0; --l) {
    const Layer L = P.L[l];
    const int kk = L.k * L.k, osz = L.Ho * L.Wo * L.Co, ws = L.Co + 1;
    float* dout = buf[L.out_buf];
    __syncthreads();  // the cotangent of this layer's output is complete
    // The pre-activation cotangent, in place, and its record.
    for (int i = threadIdx.x; i < nf * osz; i += blockDim.x) {
      const int f = i / osz, j = i - f * osz;
      float* d = dout + f * P.bsz[L.out_buf] + j;
      const float o = stash[(size_t)(n0 + f) * P.stash + L.out_off + j];
      const float v = *d * (L.act == fdec::kTanh ? 1.f - o * o : (o > 0.f ? 1.f : o + 1.f));
      *d = v;
      dstash[(size_t)(n0 + f) * P.dstash + L.dpre_off + j] = v;
    }
    if (l == 0 && dfeats == nullptr) break;
    const bool direct = L.kind != fdec::kConv;
    const int cn = max(1, min(L.Ci, P.wcap / (kk * ws)));
    const int HWi = L.Hi * L.Wi;
    for (int c0 = 0; c0 < L.Ci; c0 += cn) {
      const int cw = min(cn, L.Ci - c0);
      __syncthreads();  // the pre-activation cotangent is in place; WB is free
      stage_in_chunk(WB, w.p[2 * l], L, c0, cw, ws);
      __syncthreads();
      for (int i = threadIdx.x; i < nf * HWi * cw; i += blockDim.x) {
        const int c = i % cw, fp = i / cw, pin = fp % HWi, f = fp / HWi;
        const int iy = pin / L.Wi, ix = pin - iy * L.Wi;
        const float* src = dout + f * P.bsz[L.out_buf];
        float acc = 0.f;
        for (int ky = 0; ky < L.k; ++ky) {
          const int oy = fdec::tap_index(iy, ky, L.s, L.p, L.Ho, direct);
          if (oy < 0) continue;
          for (int kx = 0; kx < L.k; ++kx) {
            const int ox = fdec::tap_index(ix, kx, L.s, L.p, L.Wo, direct);
            if (ox < 0) continue;
            const float* dp = src + (oy * L.Wo + ox) * L.Co;
            const float* wr = WB + (c * kk + ky * L.k + kx) * ws;
            // Not unrolled, as the forward's tap loop (fused_decoder.cuh).
#pragma unroll 1
            for (int co = 0; co < L.Co; ++co) acc = fmaf(dp[co], wr[co], acc);
          }
        }
        if (l == 0) {
          dfeats[((size_t)(n0 + f) * HWi + pin) * L.Ci + c0 + c] = acc;
        } else {
          float* d = buf[L.in_buf] + f * P.bsz[L.in_buf] + pin * L.Ci + c0 + c;
          *d = L.acc_in ? *d + acc : acc;
        }
      }
    }
  }
}

// Weight and bias gradients, one thread per element s of the [in, out]
// layout of `gd` (grad_dims below) and one chunk of frames (blockIdx.y):
// the sum over the chunk's frames and the layer's positions of
// (pre-activation cotangent × input activation), in a fixed order, into
// partial[chunk][s].
__global__ void decoder_bwd_dw_kernel(Plan P, mrssm::WeightDims gd, const float* __restrict__ stash,
                                      const float* __restrict__ dstash,
                                      float* __restrict__ partial, int N, int chunk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= gd.total) return;
  int i = 0;
  while (i + 1 < gd.n && s >= gd.off[i + 1]) ++i;
  const Layer L = P.L[i / 2];
  const int local = s - gd.off[i];
  const int k = local / gd.out[i], o = local - k * gd.out[i];
  const int kk = L.k * L.k, HWo = L.Ho * L.Wo;
  const int n_begin = blockIdx.y * chunk, n_end = min(N, n_begin + chunk);
  // Two levels of sums, each frame's positions and then the chunk's frames,
  // so that no running sum takes more than one frame's terms.
  float acc = 0.f;
  if (i % 2 == 1) {  // bias: o is co, or co·Ho·Wo + pos for the unflatten's
    const bool unflat = L.kind == fdec::kUnflatten;
    const int co = unflat ? o / HWo : o;
    const int p_begin = unflat ? o - co * HWo : 0, p_end = unflat ? p_begin + 1 : HWo;
    for (int n = n_begin; n < n_end; ++n) {
      const float* dp = dstash + (size_t)n * P.dstash + L.dpre_off + co;
      float frame = 0.f;
      for (int pos = p_begin; pos < p_end; ++pos) frame += dp[pos * L.Co];
      acc += frame;
    }
  } else {
    int ci, co, tap;
    if (L.kind == fdec::kConv) {          // [in = Ci·k·k, out = Co]
      ci = k / kk; tap = k - ci * kk; co = o;
    } else if (L.kind == fdec::kDeconv) {  // [in = Co·k·k, out = Ci]
      co = k / kk; tap = k - co * kk; ci = o;
    } else {                               // [in = Ci, out = Co·k·k]
      ci = k; co = o / kk; tap = o - co * kk;
    }
    const int ky = tap / L.k, kx = tap - ky * L.k;
    // Walk the side the tap relation maps directly from (a conv's outputs,
    // a transposed conv's inputs) and find the other side's position.
    const bool conv = L.kind == fdec::kConv;
    const int Hu = conv ? L.Ho : L.Hi, Wu = conv ? L.Wo : L.Wi;
    const int Hm = conv ? L.Hi : L.Ho, Wm = conv ? L.Wi : L.Wo;
    for (int n = n_begin; n < n_end; ++n) {
      const float* dp = dstash + (size_t)n * P.dstash + L.dpre_off + co;
      const float* a = stash + (size_t)n * P.stash + L.in_off + ci;
      float frame = 0.f;
      for (int uy = 0; uy < Hu; ++uy) {
        const int my = uy * L.s - L.p + ky;
        if (my < 0 || my >= Hm) continue;
        for (int ux = 0; ux < Wu; ++ux) {
          const int mx = ux * L.s - L.p + kx;
          if (mx < 0 || mx >= Wm) continue;
          const int opos = conv ? uy * L.Wo + ux : my * L.Wo + mx;
          const int ipos = conv ? my * L.Wi + mx : uy * L.Wi + ux;
          frame = fmaf(dp[opos * L.Co], a[ipos * L.Ci], frame);
        }
      }
      acc += frame;
    }
  }
  partial[(size_t)blockIdx.y * gd.total + s] = acc;
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
  err = cudaFuncSetAttribute(decoder_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.N + P.frames - 1) / P.frames;
  decoder_bwd_dx_kernel<<<blocks, fdec::kThreads, P.bsmem, s>>>(w, P, g, dfeats, stash, dstash,
                                                                 d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const mrssm::WeightDims gd = grad_dims(P);
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  decoder_bwd_dw_kernel<<<dim3((gd.total + 255) / 256, chunks), 256, 0, s>>>(
      P, gd, stash, dstash, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, chunks, gd, d_weights, s);
}

}  // extern "C"
