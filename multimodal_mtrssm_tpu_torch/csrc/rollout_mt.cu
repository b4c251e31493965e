// MoPoE-MMTRSSM hierarchical prior-only imagination rollout (the imagine path).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/rollout_mt.py::_mt_rollout_kernel:
// for t = 0..T-1, the lower MTRNN on action ⊕ ls ⊕ hs (the previous prior
// samples) → the l-prior MLP → one-hot Gumbel-argmax sample; the higher
// MTRNN on the previous hs → the h-prior MLP → one-hot sample. It writes the
// integrator trajectories too, which make a chained continuation exact.
//
// Noise: Philox4x32-10 keyed by the 64-bit seed, counter (t, b, block, word):
// the lower site's blocks are 0 .. ls_class - 1, the higher site's
// ls_class + c, and a block of K categories takes ceil(K / 4) words.
// ops/kernels/rollout_mt.py::philox_mt_gumbel is the same generator in torch
// integer ops, so a seed draws the same noise on the CPU and here.
//
// What bounds it: the latency of the T dependent steps of small products at
// serving batches; only at B ≥ 256 does the batch fill the SMs. Layout: as
// recurrence_mt_fwd.cu — one block per tile of R batch rows, the T loop
// inside, the 16 weights (7,072 floats, 28.3 KB) staged once in dynamic
// shared memory. Tensors are [B, T, ·], the public layout of
// fused_mt_rollout_transition.
#include "mrssm_common.cuh"

namespace {

using mrssm::MTDims;

constexpr int kNW = 16;

struct MTRolloutIn {
  const float *actions, *hd0, *ld0, *hs0, *ls0, *hidh0, *hidl0;
};
struct MTRolloutOut {
  float *h_deter, *l_deter, *h_logits, *l_logits, *h_stoch, *l_stoch, *h_hidden, *l_hidden;
};

// Per-row shared-memory floats: xl (action ⊕ ls ⊕ hs carry), both deter
// and integrator carries, the new deters, both priors' hidden layers and
// logits.
__host__ __device__ inline int rollout_row_floats(const MTDims& d) {
  const int LS = d.ls_class * d.ls_cat, HS = d.hs_class * d.hs_cat;
  return (d.A + LS + HS) + 3 * (d.LD + d.HD) + 2 * d.C + LS + HS;
}

__global__ void __launch_bounds__(mrssm::kThreads)
mt_rollout_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims, MTRolloutIn in,
                  MTRolloutOut out, uint32_t key0, uint32_t key1, MTDims d) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int A = d.A, HD = d.HD, LD = d.LD, C = d.C, T = d.T, B = d.B;
  const int lK = d.ls_cat, hK = d.hs_cat, LS = d.ls_class * lK, HS = d.hs_class * hK;
  const int X = A + LS + HS, DN = LD + HD, G = LS + HS;
  float* W = smem;
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };
  const int Rt = d.rows;
  float* xl = W + dims.total;      // [R][X]  action ⊕ ls ⊕ hs carry
  float* ld = xl + Rt * X;         // [R][LD] l_deter carry
  float* hd = ld + Rt * LD;        // [R][HD] h_deter carry
  float* hidl = hd + Rt * HD;      // [R][LD] lower integrator carry
  float* hidh = hidl + Rt * LD;    // [R][HD] higher integrator carry
  float* dnew = hidh + Rt * HD;    // [R][LD + HD] the step's deters
  float* hid = dnew + Rt * DN;     // [R][2C] l-prior ⊕ h-prior hidden layers
  float* lg = hid + Rt * 2 * C;    // [R][LS + HS] l-prior ⊕ h-prior logits

  stage_weights(W, w, dims);
  const int row0 = blockIdx.x * Rt;
  const int rows = min(Rt, B - row0);
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    ld[i] = in.ld0[row0 * LD + i];
    hidl[i] = in.hidl0[row0 * LD + i];
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    hd[i] = in.hd0[row0 * HD + i];
    hidh[i] = in.hidh0[row0 * HD + i];
  }
  for (int i = threadIdx.x; i < rows * (LS + HS); i += blockDim.x) {
    const int r = i / (LS + HS), s = i - r * (LS + HS);
    xl[r * X + A + s] = s < LS ? in.ls0[(row0 + r) * LS + s] : in.hs0[(row0 + r) * HS + s - LS];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
      const int r = i / A, a = i - r * A;
      xl[r * X + a] = in.actions[((size_t)(row0 + r) * T + t) * A + a];
    }
    __syncthreads();
    mtrnn_rows(ld, LD, xl, X, X, Wp(0), Wp(1), Wp(2), Wp(3), LD, hidl, LD, dnew, DN, d.l_inv,
               d.l_keep, rows);
    mtrnn_rows(hd, HD, xl + A + LS, HS, X, Wp(4), Wp(5), Wp(6), Wp(7), HD, hidh, HD, dnew + LD,
               DN, d.h_inv, d.h_keep, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      const int r = i / LD, j = i - r * LD;
      const size_t o = ((size_t)(row0 + r) * T + t) * LD + j;
      ld[i] = dnew[r * DN + j];
      out.l_deter[o] = ld[i];
      out.l_hidden[o] = hidl[i];
    }
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      const int r = i / HD, j = i - r * HD;
      const size_t o = ((size_t)(row0 + r) * T + t) * HD + j;
      hd[i] = dnew[r * DN + LD + j];
      out.h_deter[o] = hd[i];
      out.h_hidden[o] = hidh[i];
    }
    __syncthreads();
    dense_rows(ld, LD, LD, nullptr, 0, 0, Wp(8), Wp(9), C, hid, 2 * C, rows, true);
    dense_rows(hd, HD, HD, nullptr, 0, 0, Wp(12), Wp(13), C, hid + C, 2 * C, rows, true);
    __syncthreads();
    dense_rows(hid, C, 2 * C, nullptr, 0, 0, Wp(10), Wp(11), LS, lg, G, rows, false);
    dense_rows(hid + C, C, 2 * C, nullptr, 0, 0, Wp(14), Wp(15), HS, lg + LS, G, rows, false);
    __syncthreads();
    // One thread per (row, category block) of either layer: Gumbel-argmax
    // with Philox noise; the samples are the next step's ls and hs carries.
    const int nb = d.ls_class + d.hs_class;
    for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
      const int r = i / nb, c = i - r * nb;
      const int b = row0 + r;
      const bool lower = c < d.ls_class;
      const int K = lower ? lK : hK, S = lower ? LS : HS;
      const int o = (lower ? c : c - d.ls_class) * K;
      const float* l = lg + r * G + (lower ? 0 : LS) + o;
      float* carry = xl + r * X + A + (lower ? 0 : LS) + o;
      const int best = philox_block_argmax(l, K, (uint32_t)t, (uint32_t)b, (uint32_t)c, key0,
                                           key1);
      const size_t g = ((size_t)b * T + t) * S + o;
      float* logits_out = lower ? out.l_logits : out.h_logits;
      float* stoch_out = lower ? out.l_stoch : out.h_stoch;
      for (int j = 0; j < K; ++j) {
        const float v = j == best ? 1.f : 0.f;
        carry[j] = v;
        stoch_out[g + j] = v;
        logits_out[g + j] = l[j];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Host arrays of device pointers: `weights` (the 16
// MTRNN and prior weights), `ins` (actions, init6) and `outs` (the 8
// outputs), in the order of ops/kernels/rollout_mt.py; tensors f32,
// contiguous, [B, T, ·]. Returns the cudaError_t of the launch (0 on success).
int mt_rollout(const void* const* weights, const void* const* ins, void* const* outs,
               unsigned long long seed, MTDims d, void* stream) {
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNW; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  float* const* y = reinterpret_cast<float* const*>(outs);
  const MTRolloutIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6]};
  const MTRolloutOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const size_t smem =
      ((size_t)dims.total + (size_t)d.rows * rollout_row_floats(d)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mt_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.B + d.rows - 1) / d.rows;
  mt_rollout_kernel<<<blocks, mrssm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, dims, in, out, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), d);
  return (int)cudaGetLastError();
}

}  // extern "C"
