// MoPoE-MRSSM representation recurrence on stacked weights, backward (BPTT).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_stacked.py::
// _bwd_kernel_stacked (line 190): recurrence_bwd.cu's reverse-T BPTT with
// the stacked layout of recurrence_stacked_fwd.cu. Step t is recomputed
// from the carries into it (prev_deter[t], prev_stoch[t], shifted once on
// the host) with the stacked products, then the VJPs run on the stacked
// tensors as one phase each: d hc = (d logits @ wc2^T) · elu'(hc_pre) over
// all 3H hidden units, d [deter | a_emb | v_emb] = d hc @ wc1^T (its deter
// columns already hold the sum over the three heads), d [x2 | deter] =
// d [gi | gh] @ wg^T.
//
// Shared memory: the 10 stacked tensors take ~137 KB at the reference
// widths. A second per-block copy of their gradients, as recurrence_bwd.cu
// keeps of its 20 tensors, would bring a block to ~275 KB, above the 227 KB
// it may have. So each block accumulates only the non-zero blocks' weight
// gradients — the 20 unstacked tensors, 16,976 floats (~68 KB), in
// recurrence_bwd.cu's [in, out] layout and with its accum_grad calls — and
// no zero block's gradient is ever formed: unstack_train_grads would slice
// those away in any case (the TPU kernel computes them and drops them).
// Weights, accumulators and ~6.4 KB a row come to ~212 KB for one row.
// Each block writes its partial sums to [n_blocks, 16,976]; a second launch
// adds them in block order (no float atomics, so a run is reproducible) and
// scatters each non-zero block to its place in the stacked gradients (torch
// layout), whose zero blocks the caller leaves at 0.
#include "mrssm_common.cuh"

namespace {

constexpr int kNS = 10;  // stacked tensors
constexpr int kNW = 20;  // unstacked tensors (the gradient accumulators)

// The 10 stacked tensors' [in, out] shapes (kernel order of
// recurrence_stacked.py).
mrssm::WeightDims stacked_dims(int A, int E, int H, int D, int S) {
  const int X = A + S, G2 = 6 * D, XC = D + 2 * E, H3 = 3 * H, S3 = 3 * S;
  const int in[kNS] = {X, 1, H, 1, H + D, 1, XC, 1, H3, 1};
  const int out[kNS] = {H, H, H, H, G2, G2, H3, H3, S3, S3};
  return mrssm::weight_dims(in, out, kNS);
}

// The 20 unstacked tensors' [in, out] shapes (recurrence_bwd.cu's order).
mrssm::WeightDims grad_dims(int A, int E, int H, int D, int S) {
  const int X = A + S, G = 3 * D, DE = D + E;
  const int in[kNW] = {X, 1, H, 1, H, 1, D, 1, D, 1, H, 1, DE, 1, H, 1, DE, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S, H, H, S, S, H, H, S, S};
  return mrssm::weight_dims(in, out, kNW);
}

// Where each unstacked tensor's element (k, o) ([in, out]) sits in the
// stacked gradients: stacked tensor `tgt`, row row_off + k (+ shift for
// k ≥ split), column col_off + o.
struct StackMap {
  int tgt[kNW], row_off[kNW], split[kNW], shift[kNW], col_off[kNW];
};

StackMap stack_map(int E, int H, int D, int S) {
  const int G = 3 * D, NO = 1 << 30;
  StackMap m;
  //                  w1 b1 w2 b2 wih bih whh bhh wp1 bp1 wp2 bp2 wa1 ba1 wa2 ba2 wv1 bv1 wv2 bv2
  const int tgt[kNW] = {0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 6, 7, 8, 9, 6, 7, 8, 9};
  const int row[kNW] = {0, 0, 0, 0, 0, 0, H, 0, 0, 0, 0, 0, 0, 0, H, 0, 0, 0, 2 * H, 0};
  const int col[kNW] = {0, 0, 0, 0, 0, 0, G, G, 0, 0, 0, 0, H, H, S, S, 2 * H, 2 * H, 2 * S,
                        2 * S};
  for (int i = 0; i < kNW; ++i) {
    m.tgt[i] = tgt[i];
    m.row_off[i] = row[i];
    m.col_off[i] = col[i];
    m.split[i] = NO;
    m.shift[i] = 0;
  }
  // The vision head's embedding rows follow the audio embedding's in wc1.
  m.split[16] = D;
  m.shift[16] = E;
  return m;
}

// The per-row buffers of a block, each [R][width] floats, in this order.
enum Buf {
  kXin, kEmb, kPdeter, kDeter, kH1p, kH1, kX2, kGates, kHp, kHid, kLg, kStat, kMixed,
  kPprob, kQprob, kCot, kDmix, kDlg, kSums, kDhid, kDxc, kGdet, kDgg, kDx2d, kDh1, kDx,
  kCd, kCs, kNumBufs
};

__host__ __device__ inline void buffer_widths(int A, int E, int H, int D, int S, int* w) {
  const int X = A + S;
  w[kXin] = X;            // action ⊕ stoch carry into the step
  w[kEmb] = 2 * E;        // audio ⊕ vision embedding
  w[kPdeter] = D;         // deter carry into the step
  w[kDeter] = D;          // the step's deter
  w[kH1p] = H;            // transition MLP hidden, pre-activation
  w[kH1] = H;             // ... and after ELU
  w[kX2] = H;             // GRU input
  w[kGates] = 6 * D;      // gi ⊕ gh
  w[kHp] = 3 * H;         // the heads' hidden layer, pre-activation
  w[kHid] = 3 * H;        // ... and after ELU
  w[kLg] = 3 * S;         // prior ⊕ audio ⊕ vision logits
  w[kStat] = 4;           // max and log-sum-exp of the audio and vision logits
  w[kMixed] = S;          // fused posterior logits
  w[kPprob] = S;          // prior block probs
  w[kQprob] = S;          // posterior block probs
  w[kCot] = D + 4 * S;    // the step's cotangents: deter, prior logits, prior
                          // stoch, mixed logits, post stoch
  w[kDmix] = S;           // d mixed logits
  w[kDlg] = 3 * S;        // d prior ⊕ audio ⊕ vision logits
  w[kSums] = 2;           // sums of d log-softmax (audio, vision)
  w[kDhid] = 3 * H;       // d heads' hidden pre-activations
  w[kDxc] = D + 2 * E;    // d [deter | a_emb | v_emb]
  w[kGdet] = D;           // total d deter of the step
  w[kDgg] = 6 * D;        // d [gi | gh]
  w[kDx2d] = H + D;       // d [x2 | deter carry]
  w[kDh1] = H;            // d transition hidden pre-activation
  w[kDx] = X;             // d (action ⊕ stoch)
  w[kCd] = D;             // carry: d deter into the step
  w[kCs] = S;             // carry: d stoch into the step
}

size_t bwd_row_floats(int A, int E, int H, int D, int S) {
  int width[kNumBufs];
  buffer_widths(A, E, H, D, S, width);
  size_t per_row = 0;
  for (int i = 0; i < kNumBufs; ++i) per_row += width[i];
  return per_row;
}

__global__ void __launch_bounds__(mrssm::kThreads)
stacked_bwd_kernel(mrssm::WeightPtrs w, mrssm::WeightDims sdims, mrssm::WeightDims gdims,
                   const float* __restrict__ actions, const float* __restrict__ a_emb,
                   const float* __restrict__ v_emb, const float* __restrict__ prev_deter,
                   const float* __restrict__ prev_stoch, const float* __restrict__ gd,
                   const float* __restrict__ gpl, const float* __restrict__ gps,
                   const float* __restrict__ gmx, const float* __restrict__ gpo,
                   float* __restrict__ partial, float* __restrict__ d_actions,
                   float* __restrict__ d_a_emb, float* __restrict__ d_v_emb,
                   float* __restrict__ d_init_deter, float* __restrict__ d_init_stoch, int T,
                   int B, int A, int E, int H, int D, int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int S = C * K, X = A + S, G = 3 * D, G2 = 6 * D, XC = D + 2 * E, H3 = 3 * H,
            S3 = 3 * S, HD = H + D, NG = gdims.total, CW = D + 4 * S;
  float* W = smem;            // stacked weights, [in, out], at sdims.off
  float* GW = W + sdims.total;  // this block's unstacked weight gradients, at gdims.off
  int width[kNumBufs];
  buffer_widths(A, E, H, D, S, width);
  float* buf[kNumBufs];
  float* p = GW + NG;
  for (int i = 0; i < kNumBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *xin = buf[kXin], *emb = buf[kEmb], *pdeter = buf[kPdeter], *deter = buf[kDeter];
  float *h1p = buf[kH1p], *h1 = buf[kH1], *x2 = buf[kX2], *gates = buf[kGates];
  float *hp = buf[kHp], *hid = buf[kHid], *lg = buf[kLg], *stat = buf[kStat];
  float *mixed = buf[kMixed], *pprob = buf[kPprob], *qprob = buf[kQprob], *cot = buf[kCot];
  float *dmix = buf[kDmix], *dlg = buf[kDlg], *sums = buf[kSums], *dhid = buf[kDhid];
  float *dxc = buf[kDxc], *gdet = buf[kGdet], *dgg = buf[kDgg], *dx2d = buf[kDx2d];
  float *dh1 = buf[kDh1], *dx = buf[kDx], *cd = buf[kCd], *cs = buf[kCs];
  // Stacked weight i, and unstacked tensor i's gradient accumulator.
  auto Wp = [&](int i) -> const float* { return W + sdims.off[i]; };
  auto Gp = [&](int i) -> float* { return GW + gdims.off[i]; };

  stage_weights(W, w, sdims);
  for (int i = threadIdx.x; i < NG; i += blockDim.x) GW[i] = 0.f;
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

    // ---- recompute step t (the stacked forward kernel's arithmetic) ----
    dense_rows(xin, X, X, nullptr, 0, 0, Wp(0), Wp(1), H, h1p, H, rows, false);
    __syncthreads();
    elu_rows(h1p, h1, rows * H);
    __syncthreads();
    dense_rows(h1, H, H, nullptr, 0, 0, Wp(2), Wp(3), H, x2, H, rows, false);
    __syncthreads();
    dense_rows(x2, H, H, pdeter, D, D, Wp(4), Wp(5), G2, gates, G2, rows, false);
    __syncthreads();
    gru_rows(gates, deter, D, rows);
    __syncthreads();
    dense_rows(deter, D, D, emb, 2 * E, 2 * E, Wp(6), Wp(7), H3, hp, H3, rows, false);
    __syncthreads();
    elu_rows(hp, hid, rows * H3);
    __syncthreads();
    dense_rows(hid, H3, H3, nullptr, 0, 0, Wp(8), Wp(9), S3, lg, S3, rows, false);
    __syncthreads();
    mopoe_stats(lg + S, S3, S, stat, rows);
    __syncthreads();
    mopoe_mix(lg + S, S3, stat, S, mixed, rows);
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
      block_softmax(lg + r * S3 + c * K, K, pprob + o);
      st_vjp(pprob + o, ct + D + S + c * K, ct + D + c * K, K, dlg + r * S3 + c * K);
    }
    __syncthreads();
    mopoe_backward(lg + S, S3, stat, mixed, dmix, dlg + S, sums, S, rows);
    __syncthreads();
    // Heads' output layer: the three diagonal blocks' gradients, and
    // d hc = (d logits @ wc2^T) · elu'(hc_pre) over all 3H units at once.
    accum_grad(hid, H, H3, nullptr, 0, 0, dlg, S3, S, Gp(10), Gp(11), rows);
    accum_grad(hid + H, H, H3, nullptr, 0, 0, dlg + S, S3, S, Gp(14), Gp(15), rows);
    accum_grad(hid + 2 * H, H, H3, nullptr, 0, 0, dlg + 2 * S, S3, S, Gp(18), Gp(19), rows);
    dense_rows_t(dlg, S3, Wp(8), H3, S3, dhid, H3, rows, hp, H3, false);
    __syncthreads();
    // Heads' hidden layer: the non-zero blocks of wc1 (deter rows of every
    // head, each embedding's rows of its own head), and d [deter | a | v].
    accum_grad(deter, D, D, nullptr, 0, 0, dhid, H3, H, Gp(8), Gp(9), rows);
    accum_grad(deter, D, D, emb, E, 2 * E, dhid + H, H3, H, Gp(12), Gp(13), rows);
    accum_grad(deter, D, D, emb + E, E, 2 * E, dhid + 2 * H, H3, H, Gp(16), Gp(17), rows);
    dense_rows_t(dhid, H3, Wp(6), XC, H3, dxc, XC, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      d_a_emb[(base + r) * E + e] = dxc[r * XC + D + e];
      d_v_emb[(base + r) * E + e] = dxc[r * XC + D + E + e];
    }
    // Total gradient into the step's deter: output + future carry + heads.
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      gdet[i] = cot[r * CW + d] + cd[i] + dxc[r * XC + d];
    }
    __syncthreads();
    // GRU: deter = (1 - z) * n + z * prev_deter; d [gi | gh] per row.
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const float* gi = gates + r * G2;
      const float* gh = gi + G;
      const float rg = sigmoid(gi[d] + gh[d]);
      const float z = sigmoid(gi[D + d] + gh[D + d]);
      const float n = tanhf(gi[2 * D + d] + rg * gh[2 * D + d]);
      const float g = gdet[i];
      const float d_pre_n = g * (1.f - z) * (1.f - n * n);
      const float d_pre_z = g * (pdeter[i] - n) * z * (1.f - z);
      const float d_pre_r = d_pre_n * gh[2 * D + d] * rg * (1.f - rg);
      float* dg = dgg + r * G2;
      dg[d] = d_pre_r;
      dg[D + d] = d_pre_z;
      dg[2 * D + d] = d_pre_n;
      dg[G + d] = d_pre_r;
      dg[G + D + d] = d_pre_z;
      dg[G + 2 * D + d] = d_pre_n * rg;
      cd[i] = g * z;
    }
    __syncthreads();
    // The gates: wg's two diagonal blocks, and d [x2 | deter carry].
    accum_grad(x2, H, H, nullptr, 0, 0, dgg, G2, G, Gp(4), Gp(5), rows);
    accum_grad(pdeter, D, D, nullptr, 0, 0, dgg + G, G2, G, Gp(6), Gp(7), rows);
    dense_rows_t(dgg, G2, Wp(4), HD, G2, dx2d, HD, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      cd[i] += dx2d[r * HD + H + d];
    }
    // Transition MLP.
    accum_grad(h1, H, H, nullptr, 0, 0, dx2d, HD, H, Gp(2), Gp(3), rows);
    dense_rows_t(dx2d, HD, Wp(2), H, H, dh1, H, rows, h1p, H, false);
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
  for (int i = threadIdx.x; i < NG; i += blockDim.x) partial[(size_t)blockIdx.x * NG + i] = GW[i];
}

// d_stacked (torch layout, the 10 stacked tensors back to back) at the
// non-zero blocks = the blocks' partial sums of the unstacked gradients,
// added in block order; one thread per unstacked element. No float atomics.
__global__ void reduce_stacked_grads(const float* __restrict__ partial, int n_blocks,
                                     mrssm::WeightDims gdims, mrssm::WeightDims sdims, StackMap map,
                                     float* __restrict__ d_stacked) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= gdims.total) return;
  int i = 0;
  while (i + 1 < gdims.n && s >= gdims.off[i + 1]) ++i;
  const int local = s - gdims.off[i];
  const int k = local / gdims.out[i], o = local - k * gdims.out[i];
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partial[(size_t)b * gdims.total + s];
  const int t = map.tgt[i];
  const int row = map.row_off[i] + k + (k >= map.split[i] ? map.shift[i] : 0);
  const int col = map.col_off[i] + o;
  d_stacked[sdims.off[t] + col * sdims.in[t] + row] = acc;
}

}  // namespace

// Rows per block of the backward kernel (see mrssm_stacked_rows).
int mrssm_stacked_bwd_rows_impl(int A, int E, int H, int D, int C, int K, int R_want) {
  const int S = C * K;
  return mrssm::rows_that_fit(
      (size_t)stacked_dims(A, E, H, D, S).total + grad_dims(A, E, H, D, S).total,
      bwd_row_floats(A, E, H, D, S), R_want);
}

extern "C" {

// Launch on `stream`: the backward kernel, then the reduction of its
// [n_blocks, 16,976] partial sums (`partial`, scratch) into the non-zero
// blocks of `d_stacked` (torch layout, the 10 stacked tensors back to back,
// zeroed by the caller). `weights` is a host array of the 10 stacked
// tensors' device pointers; all tensors f32 and contiguous. Returns the
// cudaError_t of the launches (0 on success).
int mrssm_stacked_backward(const void* const* weights, const float* actions, const float* a_emb,
                           const float* v_emb, const float* prev_deter, const float* prev_stoch,
                           const float* gd, const float* gpl, const float* gps, const float* gmx,
                           const float* gpo, float* partial, float* d_stacked, float* d_actions,
                           float* d_a_emb, float* d_v_emb, float* d_init_deter,
                           float* d_init_stoch, int T, int B, int A, int E, int H, int D, int C,
                           int K, int R, void* stream) {
  if (K > 32) return (int)cudaErrorInvalidValue;  // st_vjp's per-block buffer
  const int S = C * K;
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNS; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const mrssm::WeightDims sdims = stacked_dims(A, E, H, D, S);
  const mrssm::WeightDims gdims = grad_dims(A, E, H, D, S);
  const size_t smem = ((size_t)sdims.total + gdims.total + R * bwd_row_floats(A, E, H, D, S)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stacked_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + R - 1) / R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stacked_bwd_kernel<<<blocks, mrssm::kThreads, smem, s>>>(
      w, sdims, gdims, actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl, gps, gmx, gpo,
      partial, d_actions, d_a_emb, d_v_emb, d_init_deter, d_init_stoch, T, B, A, E, H, D, C, K, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_stacked_grads<<<(gdims.total + 255) / 256, 256, 0, s>>>(
      partial, blocks, gdims, sdims, stack_map(E, H, D, S), d_stacked);
  return (int)cudaGetLastError();
}

}  // extern "C"
