// MoPoE-MRSSM representation recurrence on stacked weights, forward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py::
// _fwd_kernel_stacked (line 164): recurrence_fwd.cu's recurrence with the
// weights folded as ops/kernels/recurrence_stacked.py::stack_train_params
// folds them. A step runs five products: w1, w2, then the GRU gates as one
// [x2 | deter] @ wg [H+D, 6D] (gi and gh side by side), the three heads'
// first layers as one [deter | a_emb | v_emb] @ wc1 [D+2E, 3H] and their
// second layers as one hc @ wc2 [3H, 3S]. Each runs as one phase with the
// block's threads spread over all its outputs, where the unstacked kernel
// runs two or three narrower products in a phase. The zero blocks are
// multiplied through: fmaf(x, 0, acc) == acc, so the values equal the
// unstacked kernel's, in the same order of sums.
//
// Bound and layout as recurrence_fwd.cu: the latency of ~9 dependent stages
// a step; one block per tile of R batch rows with the T loop inside it, the
// 10 stacked tensors (~137 KB at the reference widths, twice the unstacked
// weights because of the zero blocks) staged once into dynamic shared
// memory as [in, out], [T, B, ·] streamed through device memory.
#include "mrssm_common.cuh"

namespace {

constexpr int kNS = 10;

struct StackedWeights {
  const float* p[kNS];
};

__global__ void __launch_bounds__(mrssm::kThreads)
stacked_fwd_kernel(StackedWeights w, const float* __restrict__ actions,
                   const float* __restrict__ a_emb, const float* __restrict__ v_emb,
                   const float* __restrict__ init_deter, const float* __restrict__ init_stoch,
                   const float* __restrict__ g_prior, const float* __restrict__ g_post,
                   float* __restrict__ deter_out, float* __restrict__ prior_logits_out,
                   float* __restrict__ prior_stoch_out, float* __restrict__ mixed_out,
                   float* __restrict__ post_stoch_out, int T, int B, int A, int E, int H, int D,
                   int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int S = C * K, X = A + S, G2 = 6 * D, XC = D + 2 * E, H3 = 3 * H, S3 = 3 * S;

  // Stacked weights, [in, out].
  float* w1 = smem;
  float* b1 = w1 + X * H;
  float* w2 = b1 + H;
  float* b2 = w2 + H * H;
  float* wg = b2 + H;
  float* bg = wg + (H + D) * G2;
  float* wc1 = bg + G2;
  float* bc1 = wc1 + XC * H3;
  float* wc2 = bc1 + H3;
  float* bc2 = wc2 + H3 * S3;
  // Per-row state and activations.
  float* xin = bc2 + S3;            // [R][X]  action ⊕ stoch carry
  float* emb = xin + R * X;         // [R][2E] audio ⊕ vision embedding
  float* deter = emb + R * 2 * E;   // [R][D]  deter carry
  float* h1 = deter + R * D;        // [R][H]
  float* x2 = h1 + R * H;           // [R][H]
  float* gates = x2 + R * H;        // [R][6D] gi ⊕ gh
  float* hc = gates + R * G2;       // [R][3H] prior ⊕ audio ⊕ vision hidden
  float* lg = hc + R * H3;          // [R][3S] prior ⊕ audio ⊕ vision logits
  float* mixed = lg + R * S3;       // [R][S]
  float* stat = mixed + R * S;      // [R][4]  max, log-sum-exp of audio, vision

  stage_matrix(w1, w.p[0], H, X);    stage_vector(b1, w.p[1], H);
  stage_matrix(w2, w.p[2], H, H);    stage_vector(b2, w.p[3], H);
  stage_matrix(wg, w.p[4], G2, H + D); stage_vector(bg, w.p[5], G2);
  stage_matrix(wc1, w.p[6], H3, XC); stage_vector(bc1, w.p[7], H3);
  stage_matrix(wc2, w.p[8], S3, H3); stage_vector(bc2, w.p[9], S3);

  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter[i] = init_deter[row0 * D + i];
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
    const int r = i / S, s = i - r * S;
    xin[r * X + A + s] = init_stoch[(row0 + r) * S + s];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
    for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
      const int r = i / A, a = i - r * A;
      xin[r * X + a] = actions[(base + r) * A + a];
    }
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      emb[r * 2 * E + e] = a_emb[(base + r) * E + e];
      emb[r * 2 * E + E + e] = v_emb[(base + r) * E + e];
    }
    __syncthreads();
    dense_rows(xin, X, X, nullptr, 0, 0, w1, b1, H, h1, H, rows, true);
    __syncthreads();
    dense_rows(h1, H, H, nullptr, 0, 0, w2, b2, H, x2, H, rows, false);
    __syncthreads();
    // [gi | gh] = [x2 | deter] @ wg + bg: both gate products in one phase.
    dense_rows(x2, H, H, deter, D, D, wg, bg, G2, gates, G2, rows, false);
    __syncthreads();
    gru_rows(gates, deter, D, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter_out[base * D + i] = deter[i];
    // The three heads' hidden layers: [deter | a_emb | v_emb] @ wc1 + bc1.
    dense_rows(deter, D, D, emb, 2 * E, 2 * E, wc1, bc1, H3, hc, H3, rows, true);
    __syncthreads();
    // Their logits: hc @ wc2 + bc2 (block-diagonal).
    dense_rows(hc, H3, H3, nullptr, 0, 0, wc2, bc2, S3, lg, S3, rows, false);
    __syncthreads();
    mopoe_stats(lg + S, S3, S, stat, rows);
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
      const int r = i / S, s = i - r * S;
      prior_logits_out[base * S + i] = lg[r * S3 + s];
    }
    __syncthreads();
    mopoe_mix(lg + S, S3, stat, S, mixed, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) mixed_out[base * S + i] = mixed[i];
    // Straight-through samples, one thread per (row, category block); the
    // posterior sample becomes the next step's stoch carry.
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const size_t o = (base + r) * S + c * K;
      const float* pl = lg + r * S3 + c * K;
      st_block(pl, block_argmax(pl, g_prior + o, K), K, prior_stoch_out + o);
      const float* ml = mixed + r * S + c * K;
      float* carry = xin + r * X + A + c * K;
      st_block(ml, block_argmax(ml, g_post + o, K), K, carry);
      for (int j = 0; j < K; ++j) post_stoch_out[o + j] = carry[j];
    }
    __syncthreads();
  }
}

size_t stacked_weight_floats(int A, int E, int H, int D, int S) {
  const size_t X = A + S, G2 = 6 * (size_t)D, XC = (size_t)D + 2 * E, H3 = 3 * (size_t)H,
               S3 = 3 * (size_t)S;
  return X * H + H + (size_t)H * H + H + (H + (size_t)D) * G2 + G2 + XC * H3 + H3 + H3 * S3 + S3;
}

size_t fwd_row_floats(int A, int E, int H, int D, int S) {
  return (size_t)A + S + 2 * (size_t)E + D + 2 * (size_t)H + 6 * (size_t)D + 3 * (size_t)H +
         3 * (size_t)S + S + 4;
}

}  // namespace

extern "C" {

// The largest rows-per-block ≤ R_want whose shared memory fits one block of
// the forward kernel on the current device (0 if none does).
int mrssm_stacked_rows(int A, int E, int H, int D, int C, int K, int R_want) {
  return mrssm::rows_that_fit(stacked_weight_floats(A, E, H, D, C * K),
                              fwd_row_floats(A, E, H, D, C * K), R_want);
}

// Launch on `stream`. `weights` is a host array of the 10 stacked tensors'
// device pointers in the order of ops/kernels/recurrence_stacked.py; all
// tensors f32 and contiguous. Returns the cudaError_t of the launch.
int mrssm_stacked_forward(const void* const* weights, const float* actions, const float* a_emb,
                          const float* v_emb, const float* init_deter, const float* init_stoch,
                          const float* g_prior, const float* g_post, float* deter_out,
                          float* prior_logits_out, float* prior_stoch_out, float* mixed_out,
                          float* post_stoch_out, int T, int B, int A, int E, int H, int D, int C,
                          int K, int R, void* stream) {
  StackedWeights w;
  for (int i = 0; i < kNS; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const size_t smem =
      (stacked_weight_floats(A, E, H, D, C * K) + R * fwd_row_floats(A, E, H, D, C * K)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stacked_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  stacked_fwd_kernel<<<blocks, mrssm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, deter_out,
      prior_logits_out, prior_stoch_out, mixed_out, post_stoch_out, T, B, A, E, H, D, C, K, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
