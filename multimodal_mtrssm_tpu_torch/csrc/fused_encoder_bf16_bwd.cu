// The conv encoder in bf16, backward (design notes in
// fused_encoder_bf16.cuh).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461) at dtype=bfloat16, the custom VJP of fused_encoder_apply
// (lines 530-558): the bf16 gradients of every encoder weight and bias and,
// when asked, of the frames. Five launches: the packing and the forward
// recomputing and recording the activations (bf16); encoder_bf16_bwd_dx_kernel,
// the cotangent pass (f32 in shared memory), recording each layer's
// pre-activation cotangent (f32); encoder_bf16_bwd_dw_kernel, the weight-gradient
// pass, one (layer, tap, input channel) row or a bias row and one chunk of
// frames a block; encoder_bf16_reduce_kernel, the chunks added in order and the
// gradients rounded to bf16 in torch layout.
#include "fused_encoder_bf16.cuh"

namespace fbf {
namespace {

// The cotangent pass over a tile of F frames: g [N, out_dim] (bf16) →
// every layer's pre-activation cotangent in dpre (f32, P.dstash a frame)
// and, when dx is not null, the frames' cotangent (bf16, image channels).
template <int F>
__global__ void __launch_bounds__(kThreads)
encoder_bf16_bwd_dx_kernel(Plan P, const bf16* __restrict__ packed, const bf16* __restrict__ stash,
                   const bf16* __restrict__ g, float* __restrict__ dpre, bf16* __restrict__ dx,
                   int N) {
  extern __shared__ __align__(16) float d[];  // F × P.drec
  const int tid = threadIdx.x, n0 = blockIdx.x * F, nf = min(F, N - n0);
  for (int i = tid; i < F * P.drec; i += kThreads) d[i] = 0.f;
  __syncthreads();
  const Layer& H = P.L[P.n - 1];
  for (int i = tid; i < F * H.Co; i += kThreads) {
    const int f = i / H.Co, o = i - f * H.Co;
    d[f * P.drec + H.out_off + o] = f < nf ? f32(g[(size_t)(n0 + f) * H.Co + o]) : 0.f;
  }
  __syncthreads();
  for (int l = P.n - 1; l >= 0; --l) {
    const Layer L = P.L[l];
    const int total = L.Ho * L.Wo * L.Co;
    // The pre-activation cotangent: the output's times the ELU derivative
    // from the recorded (rounded) output; the head's is its output's.
    for (int o = tid; o < total; o += kThreads) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float dd = d[f * P.drec + L.out_off + o];
        if (L.mode != kHead) {
          const float y = f < nf ? f32(stash[(size_t)(n0 + f) * P.stash + L.out_off + o]) : 0.f;
          dd *= y > 0.f ? 1.f : y + 1.f;
        }
        d[f * P.drec + L.out_off + o] = dd;
        if (f < nf) dpre[(size_t)(n0 + f) * P.dstash + L.dpre_off + o] = dd;
      }
    }
    __syncthreads();
    // The input's cotangent: the conv's transpose over the taps that reach
    // each input position, output channels in order; the first layer's
    // only for the frames' image channels, and only when asked.
    if (l > 0 || dx != nullptr) {
      const int cin = l == 0 ? P.C0 : L.Ci, tin = L.Hi * L.Wi * cin;
      for (int e = tid; e < tin; e += kThreads) {
        const int ipos = e / cin, ci = e - ipos * cin, iy = ipos / L.Wi, ix = ipos - iy * L.Wi;
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.f;
        for (int ky = 0; ky < L.k; ++ky) {
          const int ty = iy + L.p - ky;
          if (ty < 0 || ty % L.s != 0 || ty / L.s >= L.Ho) continue;
          for (int kx = 0; kx < L.k; ++kx) {
            const int tx = ix + L.p - kx;
            if (tx < 0 || tx % L.s != 0 || tx / L.s >= L.Wo) continue;
            const float* dp = d + L.out_off + ((ty / L.s) * L.Wo + tx / L.s) * L.Co;
            const bf16* wt = packed + L.w_off + ((size_t)(ky * L.k + kx) * L.Ci + ci) * L.Co;
            for (int co = 0; co < L.Co; ++co) {
              const float wv = f32(__ldg(wt + co));
#pragma unroll
              for (int f = 0; f < F; ++f) acc[f] = fmaf(dp[f * P.drec + co], wv, acc[f]);
            }
          }
        }
#pragma unroll
        for (int f = 0; f < F; ++f) {
          if (l == 0) {
            if (f < nf) dx[((size_t)(n0 + f) * P.H * P.W + ipos) * P.C0 + ci] = rn(acc[f]);
          } else {
            d[f * P.drec + L.in_off + ipos * L.Ci + ci] += acc[f];
          }
        }
      }
      // A residual block's skip: its input also takes the output's
      // pre-activation cotangent.
      if (L.mode == kResidual) {
        for (int o = tid; o < total; o += kThreads) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            d[f * P.drec + L.skip_off + o] += d[f * P.drec + L.out_off + o];
          }
        }
      }
    }
    __syncthreads();
  }
}

// The weight-gradient pass: block (row, chunk). A row is one (tap, input
// channel) of a layer, its gradients over every output channel, or the
// layer's bias. Σ over the chunk's frames and the layer's output positions
// of activation × pre-activation cotangent: the threads of a column split
// the terms in a fixed stride, and their sums are added in order.
__global__ void __launch_bounds__(kThreads)
encoder_bf16_bwd_dw_kernel(Plan P, const bf16* __restrict__ stash, const float* __restrict__ dpre,
                   float* __restrict__ partial, int N, int chunk) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.x, row = blockIdx.x, c = blockIdx.y;
  int l = 0;
  while (l + 1 < P.n && P.L[l + 1].row0 <= row) ++l;
  const Layer L = P.L[l];
  const int r = row - L.row0, taps = L.k * L.k;
  const bool bias = r == taps * L.Ci;
  const int tap = bias ? 0 : r / L.Ci, ci = bias ? 0 : r - tap * L.Ci;
  const int ky = tap / L.k, kx = tap - ky * L.k;
  const int nb = c * chunk, ne = min(N, nb + chunk), npos = L.Ho * L.Wo;
  const int terms = (ne - nb) * npos;
  const int cols = min(L.Co, kThreads), G = kThreads / cols, lane = tid % cols, grp = tid / cols;
  for (int co0 = 0; co0 < L.Co; co0 += cols) {
    const int co = co0 + lane;
    float acc = 0.f;
    if (grp < G && co < L.Co) {
      for (int t = grp; t < terms; t += G) {
        const int n = nb + t / npos, pos = t % npos;
        float a = 1.f;
        if (!bias) {
          const int oy = pos / L.Wo, ox = pos - oy * L.Wo;
          const int iy = oy * L.s - L.p + ky, ix = ox * L.s - L.p + kx;
          if (iy < 0 || iy >= L.Hi || ix < 0 || ix >= L.Wi) continue;
          a = f32(stash[(size_t)n * P.stash + L.in_off + (iy * L.Wi + ix) * L.Ci + ci]);
        }
        acc = fmaf(a, dpre[(size_t)n * P.dstash + L.dpre_off + pos * L.Co + co], acc);
      }
    }
    red[tid] = acc;
    __syncthreads();
    if (grp == 0 && co < L.Co) {
      float s = 0.f;
      for (int q = 0; q < G; ++q) s += red[q * cols + lane];
      const int e = bias ? taps * L.Ci * L.Co + co : (tap * L.Ci + ci) * L.Co + co;
      partial[(size_t)c * P.grads + L.g_off + e] = s;
    }
    __syncthreads();
  }
}

// The chunks added in order, each gradient rounded to bf16, in torch layout
// (a layer's weight [Co][Ci][k][k], then its bias).
__global__ void encoder_bf16_reduce_kernel(Plan P, const float* __restrict__ partial, int chunks,
                                   bf16* __restrict__ grads) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < P.grads; e += gridDim.x * blockDim.x) {
    int l = 0;
    while (l + 1 < P.n && P.L[l + 1].g_off <= e) ++l;
    const Layer& L = P.L[l];
    const int i = e - L.g_off, kk = L.k * L.k, nw = L.Co * L.Ci * kk;
    int src;
    if (i >= nw) {
      src = nw + (i - nw);
    } else {
      const int co = i / (L.Ci * kk), rem = i - co * L.Ci * kk, ci = rem / kk, tap = rem - ci * kk;
      src = (tap * L.Ci + ci) * L.Co + co;
    }
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * P.grads + L.g_off + src];
    grads[e] = rn(s);
  }
}

template <int F>
cudaError_t launch_dx_kernel(const Plan& P, const bf16* packed, const bf16* stash,
                             const bf16* g, float* dpre, bf16* dx, int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(encoder_bf16_bwd_dx_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P.bsmem);
  if (err != cudaSuccess) return err;
  encoder_bf16_bwd_dx_kernel<F><<<(N + F - 1) / F, kThreads, P.bsmem, stream>>>(
      P, packed, stash, g, dpre, dx, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fbf

extern "C" {

// Launch on `stream` the backward of fused_encoder_bf16_forward under the
// bf16 cotangent g [N, out_dim]: dx (bf16, the frames' shape; skipped when
// null), grads (bf16, sizes[2] elements, torch layout, tensor after
// tensor), and the scratch: stash (sizes[0] bf16 elements a frame), dpre
// (sizes[1] floats a frame), partial (sizes[3] × sizes[2] floats), packed
// (sizes[4] bf16 elements). Returns the cudaError_t of the launches.
int fused_encoder_bf16_backward(const void* const* weights, int n_weights, const fbf::bf16* x,
                                const float* coords, const fbf::bf16* g, fbf::bf16* dx,
                                fbf::bf16* grads, fbf::bf16* stash, float* dpre, float* partial,
                                fbf::bf16* packed, fbf::EncDims d, void* stream) {
  fbf::Plan P;
  if (!fbf::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fbf::launch_forward(fbf::weight_ptrs(weights, n_weights), P, x, coords, packed,
                                        nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  err = P.bfr >= 2 ? fbf::launch_dx_kernel<2>(P, packed, stash, g, dpre, dx, d.N, s)
                   : fbf::launch_dx_kernel<1>(P, packed, stash, g, dpre, dx, d.N, s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  fbf::encoder_bf16_bwd_dw_kernel<<<dim3(P.rows, chunks), fbf::kThreads, 0, s>>>(
      P, stash, dpre, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fbf::encoder_bf16_reduce_kernel<<<(P.grads + fbf::kThreads - 1) / fbf::kThreads,
                                    fbf::kThreads, 0, s>>>(P, partial, chunks, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
