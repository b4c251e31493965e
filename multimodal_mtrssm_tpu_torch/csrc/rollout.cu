// MoPoE-MRSSM prior-only imagination rollout (the imagine path).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/rollout.py::_rollout_kernel: for
// t = 0..T-1, transition MLP(action ⊕ stoch) → GRU → prior MLP → one-hot
// Gumbel-argmax sample, which is the next step's stoch.
//
// Noise: the TPU core PRNG becomes Philox4x32-10 keyed by the 64-bit seed,
// with counter (t, b, block, word): one call gives the four uniforms of a
// 4-category block. ops/kernels/rollout.py implements the same generator in
// torch integer ops, so a seed draws the same noise on the CPU and here.
//
// Layout: as recurrence_fwd.cu — one block per tile of R batch rows, the T
// loop inside, the 12 transition weights (~39 KB at the reference widths)
// staged once in dynamic shared memory. Tensors are [B, T, ·], the public
// layout of fused_rollout_transition.
#include "mrssm_common.cuh"

namespace {

struct RolloutWeights {
  const float* p[12];
};

__global__ void __launch_bounds__(mrssm::kThreads)
rollout_kernel(RolloutWeights w, const float* __restrict__ actions,
               const float* __restrict__ init_deter, const float* __restrict__ init_stoch,
               float* __restrict__ deters, float* __restrict__ logits_out,
               float* __restrict__ stochs, uint32_t key0, uint32_t key1, int T, int B, int A,
               int H, int D, int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int S = C * K, X = A + S, G = 3 * D;

  float* w1 = smem;
  float* b1 = w1 + X * H;
  float* w2 = b1 + H;
  float* b2 = w2 + H * H;
  float* wih = b2 + H;
  float* bih = wih + H * G;
  float* whh = bih + G;
  float* bhh = whh + D * G;
  float* wp1 = bhh + G;
  float* bp1 = wp1 + D * H;
  float* wp2 = bp1 + H;
  float* bp2 = wp2 + H * S;
  float* xin = bp2 + S;             // [R][X]  action ⊕ stoch carry
  float* deter = xin + R * X;       // [R][D]
  float* h1 = deter + R * D;        // [R][H]
  float* x2 = h1 + R * H;           // [R][H]
  float* gates = x2 + R * H;        // [R][2G] gi ⊕ gh
  float* p1 = gates + R * 2 * G;    // [R][H]
  float* lg = p1 + R * H;           // [R][S]

  stage_matrix(w1, w.p[0], H, X);   stage_vector(b1, w.p[1], H);
  stage_matrix(w2, w.p[2], H, H);   stage_vector(b2, w.p[3], H);
  stage_matrix(wih, w.p[4], G, H);  stage_vector(bih, w.p[5], G);
  stage_matrix(whh, w.p[6], G, D);  stage_vector(bhh, w.p[7], G);
  stage_matrix(wp1, w.p[8], H, D);  stage_vector(bp1, w.p[9], H);
  stage_matrix(wp2, w.p[10], S, H); stage_vector(bp2, w.p[11], S);

  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter[i] = init_deter[row0 * D + i];
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
    const int r = i / S, s = i - r * S;
    xin[r * X + A + s] = init_stoch[(row0 + r) * S + s];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
      const int r = i / A, a = i - r * A;
      xin[r * X + a] = actions[((size_t)(row0 + r) * T + t) * A + a];
    }
    __syncthreads();
    dense_rows(xin, X, X, nullptr, 0, 0, w1, b1, H, h1, H, rows, true);
    __syncthreads();
    dense_rows(h1, H, H, nullptr, 0, 0, w2, b2, H, x2, H, rows, false);
    __syncthreads();
    dense_rows(x2, H, H, nullptr, 0, 0, wih, bih, G, gates, 2 * G, rows, false);
    dense_rows(deter, D, D, nullptr, 0, 0, whh, bhh, G, gates + G, 2 * G, rows, false);
    __syncthreads();
    gru_rows(gates, deter, D, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      deters[((size_t)(row0 + r) * T + t) * D + d] = deter[i];
    }
    dense_rows(deter, D, D, nullptr, 0, 0, wp1, bp1, H, p1, H, rows, true);
    __syncthreads();
    dense_rows(p1, H, H, nullptr, 0, 0, wp2, bp2, S, lg, S, rows, false);
    __syncthreads();
    // One thread per (row, category block): Gumbel-argmax with Philox noise.
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const int b = row0 + r;
      const float* l = lg + r * S + c * K;
      const int best =
          philox_block_argmax(l, K, (uint32_t)t, (uint32_t)b, (uint32_t)c, key0, key1);
      const size_t o = ((size_t)b * T + t) * S + c * K;
      for (int j = 0; j < K; ++j) {
        const float v = j == best ? 1.f : 0.f;
        xin[r * X + A + c * K + j] = v;
        stochs[o + j] = v;
        logits_out[o + j] = l[j];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

size_t mrssm_rollout_smem_bytes(int A, int H, int D, int C, int K, int R) {
  const size_t S = (size_t)C * K, X = A + S, G = 3 * (size_t)D;
  const size_t weights = X * H + H + (size_t)H * H + H + (size_t)H * G + G + (size_t)D * G + G +
                         (size_t)D * H + H + (size_t)H * S + S;
  const size_t per_row = X + D + 2 * (size_t)H + 2 * G + H + S;
  return (weights + R * per_row) * sizeof(float);
}

// Launch on `stream`. `weights` is a host array of the 12 transition device
// pointers in the order of ops/kernels/rollout.py; tensors f32, contiguous,
// [B, T, ·]. Returns the cudaError_t of the launch (0 on success).
int mrssm_rollout(const void* const* weights, const float* actions, const float* init_deter,
                  const float* init_stoch, float* deters, float* logits, float* stochs,
                  unsigned long long seed, int T, int B, int A, int H, int D, int C, int K, int R,
                  void* stream) {
  RolloutWeights w;
  for (int i = 0; i < 12; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const size_t smem = mrssm_rollout_smem_bytes(A, H, D, C, K, R);
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  rollout_kernel<<<blocks, mrssm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, actions, init_deter, init_stoch, deters, logits, stochs, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32), T, B, A, H, D, C, K, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
