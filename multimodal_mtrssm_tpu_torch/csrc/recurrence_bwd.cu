// MoPoE-MRSSM representation recurrence, backward (BPTT of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step.py::_bwd_kernel and
// ::_bwd_kernel_chunked: for t = T-1..0 it recomputes step t from the
// carries into it (prev_deter[t], prev_stoch[t], shifted once on the host),
// with the forward kernel's device functions, and applies _bwd_step's VJPs:
// the block-softmax straight-through VJP of both samples, the MoPoE fusion
// VJP, the three heads, the GRU and the transition MLP. The gradient of a
// straight-through sample flows through its probs only, so no noise and no
// argmax are needed here.
//
// What bounds it: like the forward, the latency of a dependent chain (~25
// stages per step), not FLOPs or bytes. Layout: the forward's — one block per
// tile of R batch rows with the reverse T loop inside, the 20 weights staged
// once into shared memory as [in, out] (~68 KB), beside them the block's own
// weight-gradient accumulators in the same layout (~68 KB), and one record of
// activations and gradients per row (~6.5 KB). [T, B, ·] streams through
// device memory, so one kernel covers the TPU's single-block and time-chunked
// variants. Each block writes its partial weight gradients to
// [n_blocks, n_weights]; a second launch sums them in block order (no float
// atomics, so a run is reproducible) and transposes them to torch layout.
#include "mrssm_common.cuh"

namespace {

constexpr int kNW = 20;

mrssm::WeightDims weight_dims(int A, int E, int H, int D, int S) {
  const int X = A + S, G = 3 * D, DE = D + E;
  const int in[kNW] = {X, 1, H, 1, H, 1, D, 1, D, 1, H, 1, DE, 1, H, 1, DE, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S, H, H, S, S, H, H, S, S};
  return mrssm::weight_dims(in, out, kNW);
}

// The per-row buffers of a block, each [R][width] floats, in this order.
enum Buf {
  kXin, kEmb, kPdeter, kDeter, kH1p, kH1, kX2, kGates, kHp, kHid, kLg, kStat, kMixed,
  kPprob, kQprob, kCot, kDmix, kDlg, kSums, kDhid, kDdp, kDxa, kGdet, kDgi, kDgh, kDx2,
  kDh1, kDx, kCd, kCs, kNumBufs
};

__host__ __device__ inline void buffer_widths(int A, int E, int H, int D, int S, int* w) {
  const int X = A + S, G = 3 * D, DE = D + E;
  w[kXin] = X;          // action ⊕ stoch carry into the step
  w[kEmb] = 2 * E;      // audio ⊕ vision embedding
  w[kPdeter] = D;       // deter carry into the step
  w[kDeter] = D;        // the step's deter
  w[kH1p] = H;          // transition MLP hidden, pre-activation
  w[kH1] = H;           // ... and after ELU
  w[kX2] = H;           // GRU input
  w[kGates] = 2 * G;    // gi ⊕ gh
  w[kHp] = 3 * H;       // prior ⊕ audio ⊕ vision head hidden, pre-activation
  w[kHid] = 3 * H;      // ... and after ELU
  w[kLg] = 3 * S;       // prior ⊕ audio ⊕ vision logits
  w[kStat] = 4;         // max and log-sum-exp of the audio and vision logits
  w[kMixed] = S;        // fused posterior logits
  w[kPprob] = S;        // prior block probs
  w[kQprob] = S;        // posterior block probs
  w[kCot] = D + 4 * S;  // the step's cotangents: deter, prior logits, prior
                        // stoch, mixed logits, post stoch
  w[kDmix] = S;         // d mixed logits
  w[kDlg] = 3 * S;      // d prior ⊕ audio ⊕ vision logits
  w[kSums] = 2;         // sums of d log-softmax (audio, vision)
  w[kDhid] = 3 * H;     // d head hidden pre-activations
  w[kDdp] = D;          // d deter from the prior head
  w[kDxa] = 2 * DE;     // d (deter ⊕ embed) from the audio, vision heads
  w[kGdet] = D;         // total d deter of the step
  w[kDgi] = G;          // d gi
  w[kDgh] = G;          // d gh
  w[kDx2] = H;          // d GRU input
  w[kDh1] = H;          // d transition hidden pre-activation
  w[kDx] = X;           // d (action ⊕ stoch)
  w[kCd] = D;           // carry: d deter into the step
  w[kCs] = S;           // carry: d stoch into the step
}

__global__ void __launch_bounds__(mrssm::kThreads)
recurrence_bwd_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims,
                      const float* __restrict__ actions, const float* __restrict__ a_emb,
                      const float* __restrict__ v_emb,
                      const float* __restrict__ prev_deter, const float* __restrict__ prev_stoch,
                      const float* __restrict__ gd, const float* __restrict__ gpl,
                      const float* __restrict__ gps, const float* __restrict__ gmx,
                      const float* __restrict__ gpo, float* __restrict__ partial,
                      float* __restrict__ d_actions, float* __restrict__ d_a_emb,
                      float* __restrict__ d_v_emb, float* __restrict__ d_init_deter,
                      float* __restrict__ d_init_stoch, int T, int B, int A, int E, int H, int D,
                      int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int S = C * K, X = A + S, G = 3 * D, DE = D + E, NW = dims.total, CW = D + 4 * S;
  float* W = smem;      // weights, [in, out], at dims.off
  float* GW = W + NW;   // this block's weight gradients, same layout
  int width[kNumBufs];
  buffer_widths(A, E, H, D, S, width);
  float* buf[kNumBufs];
  float* p = GW + NW;
  for (int i = 0; i < kNumBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *xin = buf[kXin], *emb = buf[kEmb], *pdeter = buf[kPdeter], *deter = buf[kDeter];
  float *h1p = buf[kH1p], *h1 = buf[kH1], *x2 = buf[kX2], *gates = buf[kGates];
  float *hp = buf[kHp], *hid = buf[kHid], *lg = buf[kLg], *stat = buf[kStat];
  float *mixed = buf[kMixed], *pprob = buf[kPprob], *qprob = buf[kQprob], *cot = buf[kCot];
  float *dmix = buf[kDmix], *dlg = buf[kDlg], *sums = buf[kSums], *dhid = buf[kDhid];
  float *ddp = buf[kDdp], *dxa = buf[kDxa], *gdet = buf[kGdet], *dgi = buf[kDgi];
  float *dgh = buf[kDgh], *dx2 = buf[kDx2], *dh1 = buf[kDh1], *dx = buf[kDx];
  float *cd = buf[kCd], *cs = buf[kCs];
  // Weight i and its gradient (offsets from the kernel parameters, so no
  // registers hold 40 pointers).
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };
  auto Gp = [&](int i) -> float* { return GW + dims.off[i]; };

  stage_weights(W, w, dims);
  for (int i = threadIdx.x; i < NW; i += blockDim.x) GW[i] = 0.f;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) cd[i] = 0.f;
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) cs[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
    for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
      const int r = i / X, j = i - r * X;
      xin[i] = j < A ? actions[(base + r) * A + j] : prev_stoch[(base + r) * S + j - A];
    }
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      emb[r * 2 * E + e] = a_emb[(base + r) * E + e];
      emb[r * 2 * E + E + e] = v_emb[(base + r) * E + e];
    }
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      pdeter[i] = deter[i] = prev_deter[base * D + i];
    }
    for (int i = threadIdx.x; i < rows * CW; i += blockDim.x) {
      const int r = i / CW, j = i - r * CW;
      if (j < D) {
        cot[i] = gd[(base + r) * D + j];
      } else {
        const int q = (j - D) / S, s = (j - D) - q * S;
        const float* src = q == 0 ? gpl : q == 1 ? gps : q == 2 ? gmx : gpo;
        cot[i] = src[(base + r) * S + s];
      }
    }
    __syncthreads();

    // ---- recompute step t (the forward kernel's arithmetic) ----
    dense_rows(xin, X, X, nullptr, 0, 0, Wp(0), Wp(1), H, h1p, H, rows, false);
    __syncthreads();
    elu_rows(h1p, h1, rows * H);
    __syncthreads();
    dense_rows(h1, H, H, nullptr, 0, 0, Wp(2), Wp(3), H, x2, H, rows, false);
    __syncthreads();
    dense_rows(x2, H, H, nullptr, 0, 0, Wp(4), Wp(5), G, gates, 2 * G, rows, false);
    dense_rows(pdeter, D, D, nullptr, 0, 0, Wp(6), Wp(7), G, gates + G, 2 * G, rows, false);
    __syncthreads();
    gru_rows(gates, deter, D, rows);
    __syncthreads();
    dense_rows(deter, D, D, nullptr, 0, 0, Wp(8), Wp(9), H, hp, 3 * H, rows, false);
    dense_rows(deter, D, D, emb, E, 2 * E, Wp(12), Wp(13), H, hp + H, 3 * H, rows, false);
    dense_rows(deter, D, D, emb + E, E, 2 * E, Wp(16), Wp(17), H, hp + 2 * H, 3 * H, rows, false);
    __syncthreads();
    elu_rows(hp, hid, rows * 3 * H);
    __syncthreads();
    dense_rows(hid, H, 3 * H, nullptr, 0, 0, Wp(10), Wp(11), S, lg, 3 * S, rows, false);
    dense_rows(hid + H, H, 3 * H, nullptr, 0, 0, Wp(14), Wp(15), S, lg + S, 3 * S, rows, false);
    dense_rows(hid + 2 * H, H, 3 * H, nullptr, 0, 0, Wp(18), Wp(19), S, lg + 2 * S, 3 * S, rows,
               false);
    __syncthreads();
    mopoe_stats(lg + S, 3 * S, S, stat, rows);
    __syncthreads();
    mopoe_mix(lg + S, 3 * S, stat, S, mixed, rows);
    __syncthreads();

    // ---- backward of step t ----
    // Straight-through samples: the posterior's gradient (output + carry)
    // into the mixed logits, the prior's into the prior logits.
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const float* ct = cot + r * CW;
      const int o = r * S + c * K;
      float g_s[32];  // K ≤ 32
      for (int j = 0; j < K; ++j) g_s[j] = ct[D + 3 * S + c * K + j] + cs[o + j];
      block_softmax(mixed + o, K, qprob + o);
      st_vjp(qprob + o, g_s, ct + D + 2 * S + c * K, K, dmix + o);
      block_softmax(lg + r * 3 * S + c * K, K, pprob + o);
      st_vjp(pprob + o, ct + D + S + c * K, ct + D + c * K, K, dlg + r * 3 * S + c * K);
    }
    __syncthreads();
    // MoPoE fusion: mixture weights from the forward values, then the
    // full-axis log-softmax VJP (train_step.py::_mopoe_backward).
    mopoe_backward(lg + S, 3 * S, stat, mixed, dmix, dlg + S, sums, S, rows);
    __syncthreads();
    // Head output layers, then the hidden layers' gradients.
    accum_grad(hid, H, 3 * H, nullptr, 0, 0, dlg, 3 * S, S, Gp(10), Gp(11), rows);
    accum_grad(hid + H, H, 3 * H, nullptr, 0, 0, dlg + S, 3 * S, S, Gp(14), Gp(15), rows);
    accum_grad(hid + 2 * H, H, 3 * H, nullptr, 0, 0, dlg + 2 * S, 3 * S, S, Gp(18), Gp(19), rows);
    dense_rows_t(dlg, 3 * S, Wp(10), H, S, dhid, 3 * H, rows, hp, 3 * H, false);
    dense_rows_t(dlg + S, 3 * S, Wp(14), H, S, dhid + H, 3 * H, rows, hp + H, 3 * H, false);
    dense_rows_t(dlg + 2 * S, 3 * S, Wp(18), H, S, dhid + 2 * H, 3 * H, rows, hp + 2 * H, 3 * H,
                 false);
    __syncthreads();
    accum_grad(deter, D, D, nullptr, 0, 0, dhid, 3 * H, H, Gp(8), Gp(9), rows);
    accum_grad(deter, D, D, emb, E, 2 * E, dhid + H, 3 * H, H, Gp(12), Gp(13), rows);
    accum_grad(deter, D, D, emb + E, E, 2 * E, dhid + 2 * H, 3 * H, H, Gp(16), Gp(17), rows);
    dense_rows_t(dhid, 3 * H, Wp(8), D, H, ddp, D, rows, nullptr, 0, false);
    dense_rows_t(dhid + H, 3 * H, Wp(12), DE, H, dxa, 2 * DE, rows, nullptr, 0, false);
    dense_rows_t(dhid + 2 * H, 3 * H, Wp(16), DE, H, dxa + DE, 2 * DE, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      d_a_emb[(base + r) * E + e] = dxa[r * 2 * DE + D + e];
      d_v_emb[(base + r) * E + e] = dxa[r * 2 * DE + DE + D + e];
    }
    // Total gradient into the step's deter: output + future carry + heads.
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      gdet[i] = cot[r * CW + d] + cd[i] + dxa[r * 2 * DE + d] + dxa[r * 2 * DE + DE + d] + ddp[i];
    }
    __syncthreads();
    // GRU: deter = (1 - z) * n + z * prev_deter.
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const float* gi = gates + r * 2 * G;
      const float* gh = gi + G;
      const float rg = sigmoid(gi[d] + gh[d]);
      const float z = sigmoid(gi[D + d] + gh[D + d]);
      const float n = tanhf(gi[2 * D + d] + rg * gh[2 * D + d]);
      const float g = gdet[i];
      const float d_pre_n = g * (1.f - z) * (1.f - n * n);
      const float d_pre_z = g * (pdeter[i] - n) * z * (1.f - z);
      const float d_pre_r = d_pre_n * gh[2 * D + d] * rg * (1.f - rg);
      dgi[r * G + d] = d_pre_r;
      dgi[r * G + D + d] = d_pre_z;
      dgi[r * G + 2 * D + d] = d_pre_n;
      dgh[r * G + d] = d_pre_r;
      dgh[r * G + D + d] = d_pre_z;
      dgh[r * G + 2 * D + d] = d_pre_n * rg;
      cd[i] = g * z;
    }
    __syncthreads();
    accum_grad(x2, H, H, nullptr, 0, 0, dgi, G, G, Gp(4), Gp(5), rows);
    accum_grad(pdeter, D, D, nullptr, 0, 0, dgh, G, G, Gp(6), Gp(7), rows);
    dense_rows_t(dgi, G, Wp(4), H, G, dx2, H, rows, nullptr, 0, false);
    dense_rows_t(dgh, G, Wp(6), D, G, cd, D, rows, nullptr, 0, true);
    __syncthreads();
    // Transition MLP.
    accum_grad(h1, H, H, nullptr, 0, 0, dx2, H, H, Gp(2), Gp(3), rows);
    dense_rows_t(dx2, H, Wp(2), H, H, dh1, H, rows, h1p, H, false);
    __syncthreads();
    accum_grad(xin, X, X, nullptr, 0, 0, dh1, H, H, Gp(0), Gp(1), rows);
    dense_rows_t(dh1, H, Wp(0), X, H, dx, X, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
      const int r = i / X, j = i - r * X;
      if (j < A) d_actions[(base + r) * A + j] = dx[i];
      else cs[r * S + j - A] = dx[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) d_init_deter[row0 * D + i] = cd[i];
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) d_init_stoch[row0 * S + i] = cs[i];
  for (int i = threadIdx.x; i < NW; i += blockDim.x) partial[(size_t)blockIdx.x * NW + i] = GW[i];
}

size_t bwd_row_floats(int A, int E, int H, int D, int S) {
  int width[kNumBufs];
  buffer_widths(A, E, H, D, S, width);
  size_t per_row = 0;
  for (int i = 0; i < kNumBufs; ++i) per_row += width[i];
  return per_row;
}

}  // namespace

extern "C" {

// The largest rows-per-block ≤ R_want whose shared memory fits one block on
// the current device (0 if none does).
int mrssm_recurrence_bwd_rows(int A, int E, int H, int D, int C, int K, int R_want) {
  return mrssm::rows_that_fit(2 * (size_t)weight_dims(A, E, H, D, C * K).total,
                              bwd_row_floats(A, E, H, D, C * K), R_want);
}

// Launch on `stream`: the backward kernel, then the reduction of its
// [n_blocks, n_weights] partial sums (`partial`, scratch) into `d_weights`
// (torch layout, the 20 tensors back to back). `weights` is a host array of
// 20 device pointers in the order of ops/kernels/recurrence.py; all tensors
// f32 and contiguous. Returns the cudaError_t of the launches (0 on success).
int mrssm_recurrence_backward(const void* const* weights, const float* actions, const float* a_emb,
                              const float* v_emb, const float* prev_deter, const float* prev_stoch,
                              const float* gd, const float* gpl, const float* gps,
                              const float* gmx, const float* gpo, float* partial,
                              float* d_weights, float* d_actions, float* d_a_emb, float* d_v_emb,
                              float* d_init_deter, float* d_init_stoch, int T, int B, int A, int E,
                              int H, int D, int C, int K, int R, void* stream) {
  if (K > 32) return (int)cudaErrorInvalidValue;  // st_vjp's per-block buffer
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNW; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const mrssm::WeightDims dims = weight_dims(A, E, H, D, C * K);
  const size_t smem =
      (2 * (size_t)dims.total + R * bwd_row_floats(A, E, H, D, C * K)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(recurrence_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  recurrence_bwd_kernel<<<blocks, mrssm::kThreads, smem, s>>>(
      w, dims, actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl, gps, gmx, gpo, partial,
      d_actions, d_a_emb, d_v_emb, d_init_deter, d_init_stoch, T, B, A, E, H, D, C, K, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, blocks, dims, d_weights, s);
}

}  // extern "C"
