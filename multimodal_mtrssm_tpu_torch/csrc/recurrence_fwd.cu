// MoPoE-MRSSM representation recurrence, forward (the observe path).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step.py::_fwd_kernel and
// ::_fwd_kernel_chunked: for t = 0..T-1 it computes _forward_step —
// transition MLP → GRU → prior MLP and its straight-through sample, the
// audio and vision posterior MLPs on deter ⊕ embed, the MoPoE fusion and
// the posterior straight-through sample, whose value is the next carry.
// Gumbel noise is an input ([T, B, S] per sample site).
//
// Layout: one block per tile of R batch rows, the T loop inside the block.
// The 20 weights (~68 KB at the reference widths) are staged once into
// dynamic shared memory, transposed to [in, out]; the deter/stoch carry and
// every per-step activation stay in shared memory. Outputs go straight to
// [T, B, ·] in device memory, so there is no time chunking.
#include "mrssm_common.cuh"

namespace {

struct RecurrenceWeights {
  const float* p[20];
};

__global__ void __launch_bounds__(mrssm::kThreads)
recurrence_fwd_kernel(RecurrenceWeights w, const float* __restrict__ actions,
                      const float* __restrict__ a_emb, const float* __restrict__ v_emb,
                      const float* __restrict__ init_deter, const float* __restrict__ init_stoch,
                      const float* __restrict__ g_prior, const float* __restrict__ g_post,
                      float* __restrict__ deter_out, float* __restrict__ prior_logits_out,
                      float* __restrict__ prior_stoch_out, float* __restrict__ mixed_out,
                      float* __restrict__ post_stoch_out, int T, int B, int A, int E, int H,
                      int D, int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int S = C * K, X = A + S, G = 3 * D, DE = D + E;

  // Weights, [in, out].
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
  float* wa1 = bp2 + S;
  float* ba1 = wa1 + DE * H;
  float* wa2 = ba1 + H;
  float* ba2 = wa2 + H * S;
  float* wv1 = ba2 + S;
  float* bv1 = wv1 + DE * H;
  float* wv2 = bv1 + H;
  float* bv2 = wv2 + H * S;
  // Per-row state and activations.
  float* xin = bv2 + S;             // [R][X]  action ⊕ stoch carry
  float* emb = xin + R * X;         // [R][2E] audio ⊕ vision embedding
  float* deter = emb + R * 2 * E;   // [R][D]  deter carry
  float* h1 = deter + R * D;        // [R][H]
  float* x2 = h1 + R * H;           // [R][H]
  float* gates = x2 + R * H;        // [R][2G] gi ⊕ gh
  float* hid = gates + R * 2 * G;   // [R][3H] prior ⊕ audio ⊕ vision hidden
  float* lg = hid + R * 3 * H;      // [R][3S] prior ⊕ audio ⊕ vision logits
  float* mixed = lg + R * 3 * S;    // [R][S]
  float* stat = mixed + R * S;      // [R][4]  max, log-sum-exp of audio, vision

  stage_matrix(w1, w.p[0], H, X);   stage_vector(b1, w.p[1], H);
  stage_matrix(w2, w.p[2], H, H);   stage_vector(b2, w.p[3], H);
  stage_matrix(wih, w.p[4], G, H);  stage_vector(bih, w.p[5], G);
  stage_matrix(whh, w.p[6], G, D);  stage_vector(bhh, w.p[7], G);
  stage_matrix(wp1, w.p[8], H, D);  stage_vector(bp1, w.p[9], H);
  stage_matrix(wp2, w.p[10], S, H); stage_vector(bp2, w.p[11], S);
  stage_matrix(wa1, w.p[12], H, DE); stage_vector(ba1, w.p[13], H);
  stage_matrix(wa2, w.p[14], S, H); stage_vector(ba2, w.p[15], S);
  stage_matrix(wv1, w.p[16], H, DE); stage_vector(bv1, w.p[17], H);
  stage_matrix(wv2, w.p[18], S, H); stage_vector(bv2, w.p[19], S);

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
    dense_rows(x2, H, H, nullptr, 0, 0, wih, bih, G, gates, 2 * G, rows, false);
    dense_rows(deter, D, D, nullptr, 0, 0, whh, bhh, G, gates + G, 2 * G, rows, false);
    __syncthreads();
    gru_rows(gates, deter, D, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter_out[base * D + i] = deter[i];
    dense_rows(deter, D, D, nullptr, 0, 0, wp1, bp1, H, hid, 3 * H, rows, true);
    dense_rows(deter, D, D, emb, E, 2 * E, wa1, ba1, H, hid + H, 3 * H, rows, true);
    dense_rows(deter, D, D, emb + E, E, 2 * E, wv1, bv1, H, hid + 2 * H, 3 * H, rows, true);
    __syncthreads();
    dense_rows(hid, H, 3 * H, nullptr, 0, 0, wp2, bp2, S, lg, 3 * S, rows, false);
    dense_rows(hid + H, H, 3 * H, nullptr, 0, 0, wa2, ba2, S, lg + S, 3 * S, rows, false);
    dense_rows(hid + 2 * H, H, 3 * H, nullptr, 0, 0, wv2, bv2, S, lg + 2 * S, 3 * S, rows, false);
    __syncthreads();
    // MoPoE fusion of the two posterior heads (audio at lg + S, vision at
    // lg + 2S of each row).
    mopoe_stats(lg + S, 3 * S, S, stat, rows);
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
      const int r = i / S, s = i - r * S;
      prior_logits_out[base * S + i] = lg[r * 3 * S + s];
    }
    __syncthreads();
    mopoe_mix(lg + S, 3 * S, stat, S, mixed, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) mixed_out[base * S + i] = mixed[i];
    // Straight-through samples, one thread per (row, category block); the
    // posterior sample becomes the next step's stoch carry.
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const size_t o = (base + r) * S + c * K;
      const float* pl = lg + r * 3 * S + c * K;
      st_block(pl, block_argmax(pl, g_prior + o, K), K, prior_stoch_out + o);
      const float* ml = mixed + r * S + c * K;
      float* carry = xin + r * X + A + c * K;
      st_block(ml, block_argmax(ml, g_post + o, K), K, carry);
      for (int j = 0; j < K; ++j) post_stoch_out[o + j] = carry[j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

size_t mrssm_recurrence_smem_bytes(int A, int E, int H, int D, int C, int K, int R) {
  const size_t S = (size_t)C * K, X = A + S, G = 3 * (size_t)D, DE = (size_t)D + E;
  const size_t weights = X * H + H + (size_t)H * H + H + (size_t)H * G + G + (size_t)D * G + G +
                         (size_t)D * H + H + (size_t)H * S + S + 2 * (DE * H + H + H * S + S);
  const size_t per_row = X + 2 * (size_t)E + D + 2 * (size_t)H + 2 * G + 3 * (size_t)H + 3 * S + S + 4;
  return (weights + R * per_row) * sizeof(float);
}

// Launch on `stream`. `weights` is a host array of 20 device pointers in the
// order of ops/kernels/recurrence.py; all tensors f32 and contiguous.
// Returns the cudaError_t of the launch (0 on success).
int mrssm_recurrence_forward(const void* const* weights, const float* actions, const float* a_emb,
                             const float* v_emb, const float* init_deter,
                             const float* init_stoch, const float* g_prior, const float* g_post,
                             float* deter_out, float* prior_logits_out, float* prior_stoch_out,
                             float* mixed_out, float* post_stoch_out, int T, int B, int A, int E,
                             int H, int D, int C, int K, int R, void* stream) {
  RecurrenceWeights w;
  for (int i = 0; i < 20; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const size_t smem = mrssm_recurrence_smem_bytes(A, E, H, D, C, K, R);
  cudaError_t err = cudaFuncSetAttribute(recurrence_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  recurrence_fwd_kernel<<<blocks, mrssm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post, deter_out,
      prior_logits_out, prior_stoch_out, mixed_out, post_stoch_out, T, B, A, E, H, D, C, K, R);
  return (int)cudaGetLastError();
}

const char* mrssm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
