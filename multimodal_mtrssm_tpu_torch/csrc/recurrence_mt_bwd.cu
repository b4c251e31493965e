// MoPoE-MMTRSSM hierarchical recurrence, backward (BPTT of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_mt.py::_bwd_kernel and
// ::_bwd_kernel_chunked: for t = T-1..0 it recomputes step t from the six
// carries into it (prev6[t], shifted once on the host) with the forward
// kernel's device functions, and applies _mt_bwd_step's VJPs: the four
// straight-through samples' block-softmax VJPs, the MoPoE fusion, the five
// MLPs and both MTRNN cells. A straight-through sample's gradient flows
// through its probs only, so no noise and no argmax are needed here.
//
// The cross-layer edges: d l_deter sums the h-posterior's first LD inputs,
// both modality heads and the l-prior; d h_deter the h-posterior's last HD
// inputs and the h-prior; d hs_prev the higher MTRNN's input and the last HS
// columns of the lower MTRNN's input. In both cells d(bias of d2h) equals
// d(bias of input2h) (dw[3] = dw[1], dw[7] = dw[5]): both are accumulated,
// from the same values in the same order, so they are equal bit for bit.
//
// What bounds it: the latency of ~30 dependent stages a step and the
// accumulation of all 16,944 weight gradients every step, not FLOPs or
// bytes. Layout: the forward's — one block per tile of R batch rows with the
// reverse T loop inside, the 28 weights staged once into shared memory as
// [in, out] (67.8 KB), beside them the block's own weight-gradient
// accumulators in the same layout (67.8 KB), and one record of activations
// and gradients per row (~8 KB); the rows per block shrink until it fits.
// [T, B, ·] streams through device memory, so one kernel covers the TPU's
// single-block and time-chunked variants. Each block writes its partial
// weight gradients to [n_blocks, n_weights]; a second launch sums them in
// block order (no float atomics, so a run is reproducible) and transposes
// them to torch layout.
#include "mrssm_common.cuh"

namespace {

using mrssm::MTDims;

constexpr int kNW = 28;
constexpr int kNOut = 12;

struct MTBwdIn {
  const float *actions, *a_emb, *v_emb;
  const float *hd0, *ld0, *hs0, *ls0, *hidh0, *hidl0;  // prev6: carries into each step
};
struct MTCotangents {
  const float* g[kNOut];  // of the forward's 12 outputs, in its order
};
struct MTBwdOut {
  float *d_actions, *d_a_emb, *d_v_emb;
  float *d_hd, *d_ld, *d_hs, *d_ls, *d_hidh, *d_hidl;  // d init6
};

// The per-row buffers of a block, each [R][width] floats, in this order.
enum Buf {
  kXl, kEmb, kLd0, kHd0, kHidl, kHidh, kLdet, kHdet, kPre, kHid, kLg, kStat, kMixed, kCot,
  kCHd, kCLd, kCHs, kCLs, kCHidh, kCHidl, kDlg, kDmix, kSums, kDpre, kDxq, kDxa, kDxv, kDlp,
  kDhp, kSl, kSh, kDx, kDhs, kNumBufs
};

// Widths of the 12 outputs (and cotangents), in the forward's order.
__host__ __device__ inline void out_widths(const MTDims& d, int* w) {
  const int LS = d.ls_class * d.ls_cat, HS = d.hs_class * d.hs_cat;
  const int widths[kNOut] = {d.HD, d.LD, d.HD, d.LD, LS, LS, LS, LS, HS, HS, HS, HS};
  for (int i = 0; i < kNOut; ++i) w[i] = widths[i];
}

__host__ __device__ inline void buffer_widths(const MTDims& d, int* w) {
  const int LS = d.ls_class * d.ls_cat, HS = d.hs_class * d.hs_cat;
  const int X = d.A + LS + HS, H5 = 3 * d.C + 2 * d.R, G5 = 3 * LS + 2 * HS;
  int ow[kNOut];
  out_widths(d, ow);
  int cw = 0;
  for (int i = 0; i < kNOut; ++i) cw += ow[i];
  w[kXl] = X;              // action ⊕ ls ⊕ hs carried into the step
  w[kEmb] = 2 * d.E;       // audio ⊕ vision embedding
  w[kLd0] = d.LD;          // l_deter carried into the step
  w[kHd0] = d.HD;          // h_deter carried into the step
  w[kHidl] = d.LD;         // lower integrator: carried in, then the step's
  w[kHidh] = d.HD;         // higher integrator: carried in, then the step's
  w[kLdet] = d.LD;         // the step's l_deter
  w[kHdet] = d.HD;         // the step's h_deter
  w[kPre] = H5;            // l-prior ⊕ audio ⊕ vision ⊕ h-prior ⊕ h-posterior
                           // hidden layers, pre-activation
  w[kHid] = H5;            // ... and after ELU
  w[kLg] = G5;             // their logits
  w[kStat] = 4;            // max and log-sum-exp of the audio and vision logits
  w[kMixed] = LS;          // fused posterior logits
  w[kCot] = cw;            // the step's 12 cotangents
  w[kCHd] = d.HD;          // carries of the gradient into the step: h_deter,
  w[kCLd] = d.LD;          // l_deter,
  w[kCHs] = HS;            // hs,
  w[kCLs] = LS;            // ls,
  w[kCHidh] = d.HD;        // higher integrator,
  w[kCHidl] = d.LD;        // lower integrator
  w[kDlg] = G5;            // d logits (layout of kLg)
  w[kDmix] = LS;           // d fused logits
  w[kSums] = 2;            // sums of d log-softmax (audio, vision)
  w[kDpre] = H5;           // d hidden pre-activations (layout of kPre)
  w[kDxq] = d.LD + d.HD;   // d (l_deter ⊕ h_deter) from the h-posterior
  w[kDxa] = d.LD + d.E;    // d (l_deter ⊕ embed) from the audio head
  w[kDxv] = d.LD + d.E;    // ... from the vision head
  w[kDlp] = d.LD;          // d l_deter from the l-prior
  w[kDhp] = d.HD;          // d h_deter from the h-prior
  w[kSl] = d.LD;           // d (lower MTRNN pre-activation) = g_hidl · (1/tau_l)
  w[kSh] = d.HD;           // d (higher MTRNN pre-activation) = g_hidh · (1/tau_h)
  w[kDx] = X;              // d (action ⊕ ls ⊕ hs) from the lower MTRNN
  w[kDhs] = HS;            // d hs from the higher MTRNN
}

size_t bwd_row_floats(const MTDims& d) {
  int width[kNumBufs];
  buffer_widths(d, width);
  size_t per_row = 0;
  for (int i = 0; i < kNumBufs; ++i) per_row += width[i];
  return per_row;
}

__global__ void __launch_bounds__(mrssm::kThreads)
mt_recurrence_bwd_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims, MTBwdIn in,
                         MTCotangents gouts, float* __restrict__ partial, MTBwdOut out,
                         MTDims d) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int A = d.A, E = d.E, HD = d.HD, LD = d.LD, C = d.C, R = d.R, B = d.B;
  const int lK = d.ls_cat, hK = d.hs_cat, LS = d.ls_class * lK, HS = d.hs_class * hK;
  const int X = A + LS + HS, H5 = 3 * C + 2 * R, G5 = 3 * LS + 2 * HS, NW = dims.total;
  const int hA = C, hV = C + R, hP = C + 2 * R, hQ = 2 * C + 2 * R;
  const int gA = LS, gV = 2 * LS, gP = 3 * LS, gQ = 3 * LS + HS;
  const int XQ = LD + HD, XA = LD + E;
  float* W = smem;      // weights, [in, out], at dims.off
  float* GW = W + NW;   // this block's weight gradients, same layout
  int ow[kNOut], co[kNOut + 1];
  out_widths(d, ow);
  co[0] = 0;
  for (int i = 0; i < kNOut; ++i) co[i + 1] = co[i] + ow[i];
  const int CW = co[kNOut];
  int width[kNumBufs];
  buffer_widths(d, width);
  float* buf[kNumBufs];
  float* p = GW + NW;
  for (int i = 0; i < kNumBufs; ++i) {
    buf[i] = p;
    p += d.rows * width[i];
  }
  float *xl = buf[kXl], *emb = buf[kEmb], *ld0 = buf[kLd0], *hd0 = buf[kHd0];
  float *hidl = buf[kHidl], *hidh = buf[kHidh], *ldet = buf[kLdet], *hdet = buf[kHdet];
  float *pre = buf[kPre], *hid = buf[kHid], *lg = buf[kLg], *stat = buf[kStat];
  float *mixed = buf[kMixed], *cot = buf[kCot];
  float *chd = buf[kCHd], *cld = buf[kCLd], *chs = buf[kCHs], *cls = buf[kCLs];
  float *chidh = buf[kCHidh], *chidl = buf[kCHidl];
  float *dlg = buf[kDlg], *dmix = buf[kDmix], *sums = buf[kSums], *dpre = buf[kDpre];
  float *dxq = buf[kDxq], *dxa = buf[kDxa], *dxv = buf[kDxv], *dlp = buf[kDlp];
  float *dhp = buf[kDhp], *sl = buf[kSl], *sh = buf[kSh], *dx = buf[kDx], *dhs = buf[kDhs];
  // Weight i and its gradient (offsets from the kernel parameters, so no
  // registers hold 56 pointers).
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };
  auto Gp = [&](int i) -> float* { return GW + dims.off[i]; };

  stage_weights(W, w, dims);
  for (int i = threadIdx.x; i < NW; i += blockDim.x) GW[i] = 0.f;
  const int row0 = blockIdx.x * d.rows;
  const int rows = min(d.rows, B - row0);
  // The gradient carries start at 0; kCHd .. kCHidl lie back to back.
  for (int i = threadIdx.x; i < d.rows * (2 * HD + 2 * LD + HS + LS); i += blockDim.x) {
    chd[i] = 0.f;
  }
  __syncthreads();

  for (int t = d.T - 1; t >= 0; --t) {
    const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
    for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
      const int r = i / X, j = i - r * X;
      xl[i] = j < A ? in.actions[(base + r) * A + j]
              : j < A + LS ? in.ls0[(base + r) * LS + j - A]
                           : in.hs0[(base + r) * HS + j - A - LS];
    }
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      emb[r * 2 * E + e] = in.a_emb[(base + r) * E + e];
      emb[r * 2 * E + E + e] = in.v_emb[(base + r) * E + e];
    }
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      ld0[i] = in.ld0[base * LD + i];
      hidl[i] = in.hidl0[base * LD + i];
    }
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      hd0[i] = in.hd0[base * HD + i];
      hidh[i] = in.hidh0[base * HD + i];
    }
    for (int q = 0; q < kNOut; ++q) {
      for (int i = threadIdx.x; i < rows * ow[q]; i += blockDim.x) {
        const int r = i / ow[q], j = i - r * ow[q];
        cot[r * CW + co[q] + j] = gouts.g[q][base * ow[q] + i];
      }
    }
    __syncthreads();

    // ---- recompute step t (the forward kernel's arithmetic) ----
    mtrnn_rows(ld0, LD, xl, X, X, Wp(0), Wp(1), Wp(2), Wp(3), LD, hidl, LD, ldet, LD, d.l_inv,
               d.l_keep, rows);
    mtrnn_rows(hd0, HD, xl + A + LS, HS, X, Wp(4), Wp(5), Wp(6), Wp(7), HD, hidh, HD, hdet, HD,
               d.h_inv, d.h_keep, rows);
    __syncthreads();
    dense_rows(ldet, LD, LD, nullptr, 0, 0, Wp(8), Wp(9), C, pre, H5, rows, false);
    dense_rows(ldet, LD, LD, emb, E, 2 * E, Wp(20), Wp(21), R, pre + hA, H5, rows, false);
    dense_rows(ldet, LD, LD, emb + E, E, 2 * E, Wp(24), Wp(25), R, pre + hV, H5, rows, false);
    dense_rows(hdet, HD, HD, nullptr, 0, 0, Wp(12), Wp(13), C, pre + hP, H5, rows, false);
    dense_rows(ldet, LD, LD, hdet, HD, HD, Wp(16), Wp(17), C, pre + hQ, H5, rows, false);
    __syncthreads();
    elu_rows(pre, hid, rows * H5);
    __syncthreads();
    dense_rows(hid, C, H5, nullptr, 0, 0, Wp(10), Wp(11), LS, lg, G5, rows, false);
    dense_rows(hid + hA, R, H5, nullptr, 0, 0, Wp(22), Wp(23), LS, lg + gA, G5, rows, false);
    dense_rows(hid + hV, R, H5, nullptr, 0, 0, Wp(26), Wp(27), LS, lg + gV, G5, rows, false);
    dense_rows(hid + hP, C, H5, nullptr, 0, 0, Wp(14), Wp(15), HS, lg + gP, G5, rows, false);
    dense_rows(hid + hQ, C, H5, nullptr, 0, 0, Wp(18), Wp(19), HS, lg + gQ, G5, rows, false);
    __syncthreads();
    mopoe_stats(lg + gA, G5, LS, stat, rows);
    __syncthreads();
    mopoe_mix(lg + gA, G5, stat, LS, mixed, rows);
    __syncthreads();

    // ---- backward of step t ----
    // Straight-through samples, one thread per (row, category block): each
    // posterior's gradient (output + carry) into its logits, each prior's
    // into its logits.
    const int nb = d.ls_class + d.hs_class;
    for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
      const int r = i / nb, c = i - r * nb;
      const float* ct = cot + r * CW;
      float g_s[32], pr[32];  // K ≤ 32
      if (c < d.ls_class) {
        const int o = c * lK;
        for (int j = 0; j < lK; ++j) g_s[j] = ct[co[7] + o + j] + cls[r * LS + o + j];
        block_softmax(mixed + r * LS + o, lK, pr);
        st_vjp(pr, g_s, ct + co[6] + o, lK, dmix + r * LS + o);
        block_softmax(lg + r * G5 + o, lK, pr);
        st_vjp(pr, ct + co[5] + o, ct + co[4] + o, lK, dlg + r * G5 + o);
      } else {
        const int o = (c - d.ls_class) * hK;
        for (int j = 0; j < hK; ++j) g_s[j] = ct[co[11] + o + j] + chs[r * HS + o + j];
        block_softmax(lg + r * G5 + gQ + o, hK, pr);
        st_vjp(pr, g_s, ct + co[10] + o, hK, dlg + r * G5 + gQ + o);
        block_softmax(lg + r * G5 + gP + o, hK, pr);
        st_vjp(pr, ct + co[9] + o, ct + co[8] + o, hK, dlg + r * G5 + gP + o);
      }
    }
    __syncthreads();
    mopoe_backward(lg + gA, G5, stat, mixed, dmix, dlg + gA, sums, LS, rows);
    __syncthreads();
    // The five output layers, then the gradients of their hidden layers.
    accum_grad(hid, C, H5, nullptr, 0, 0, dlg, G5, LS, Gp(10), Gp(11), rows);
    accum_grad(hid + hA, R, H5, nullptr, 0, 0, dlg + gA, G5, LS, Gp(22), Gp(23), rows);
    accum_grad(hid + hV, R, H5, nullptr, 0, 0, dlg + gV, G5, LS, Gp(26), Gp(27), rows);
    accum_grad(hid + hP, C, H5, nullptr, 0, 0, dlg + gP, G5, HS, Gp(14), Gp(15), rows);
    accum_grad(hid + hQ, C, H5, nullptr, 0, 0, dlg + gQ, G5, HS, Gp(18), Gp(19), rows);
    dense_rows_t(dlg, G5, Wp(10), C, LS, dpre, H5, rows, pre, H5, false);
    dense_rows_t(dlg + gA, G5, Wp(22), R, LS, dpre + hA, H5, rows, pre + hA, H5, false);
    dense_rows_t(dlg + gV, G5, Wp(26), R, LS, dpre + hV, H5, rows, pre + hV, H5, false);
    dense_rows_t(dlg + gP, G5, Wp(14), C, HS, dpre + hP, H5, rows, pre + hP, H5, false);
    dense_rows_t(dlg + gQ, G5, Wp(18), C, HS, dpre + hQ, H5, rows, pre + hQ, H5, false);
    __syncthreads();
    // The five hidden layers, into the deters and the embeddings.
    accum_grad(ldet, LD, LD, nullptr, 0, 0, dpre, H5, C, Gp(8), Gp(9), rows);
    accum_grad(ldet, LD, LD, emb, E, 2 * E, dpre + hA, H5, R, Gp(20), Gp(21), rows);
    accum_grad(ldet, LD, LD, emb + E, E, 2 * E, dpre + hV, H5, R, Gp(24), Gp(25), rows);
    accum_grad(hdet, HD, HD, nullptr, 0, 0, dpre + hP, H5, C, Gp(12), Gp(13), rows);
    accum_grad(ldet, LD, LD, hdet, HD, HD, dpre + hQ, H5, C, Gp(16), Gp(17), rows);
    dense_rows_t(dpre, H5, Wp(8), LD, C, dlp, LD, rows, nullptr, 0, false);
    dense_rows_t(dpre + hA, H5, Wp(20), XA, R, dxa, XA, rows, nullptr, 0, false);
    dense_rows_t(dpre + hV, H5, Wp(24), XA, R, dxv, XA, rows, nullptr, 0, false);
    dense_rows_t(dpre + hP, H5, Wp(12), HD, C, dhp, HD, rows, nullptr, 0, false);
    dense_rows_t(dpre + hQ, H5, Wp(16), XQ, C, dxq, XQ, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      out.d_a_emb[(base + r) * E + e] = dxa[r * XA + LD + e];
      out.d_v_emb[(base + r) * E + e] = dxv[r * XA + LD + e];
    }
    // Both MTRNNs: deter = tanh(hid), hid = keep · hid_prev + inv · u. The
    // sums follow _mt_bwd_step's order.
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      const int r = i / LD, j = i - r * LD;
      const float* ct = cot + r * CW;
      const float d_l = ((dxq[r * XQ + j] + dxa[r * XA + j]) + dxv[r * XA + j]) + dlp[i];
      const float g_l = (ct[co[1] + j] + cld[i]) + d_l;
      const float g_hid = (ct[co[3] + j] + chidl[i]) + g_l * (1.f - ldet[i] * ldet[i]);
      chidl[i] = g_hid * d.l_keep;
      sl[i] = g_hid * d.l_inv;
    }
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      const int r = i / HD, j = i - r * HD;
      const float* ct = cot + r * CW;
      const float d_h = dxq[r * XQ + LD + j] + dhp[i];
      const float g_h = (ct[co[0] + j] + chd[i]) + d_h;
      const float g_hid = (ct[co[2] + j] + chidh[i]) + g_h * (1.f - hdet[i] * hdet[i]);
      chidh[i] = g_hid * d.h_keep;
      sh[i] = g_hid * d.h_inv;
    }
    __syncthreads();
    accum_grad(ld0, LD, LD, nullptr, 0, 0, sl, LD, LD, Gp(0), Gp(1), rows);
    accum_grad(xl, X, X, nullptr, 0, 0, sl, LD, LD, Gp(2), Gp(3), rows);
    accum_grad(hd0, HD, HD, nullptr, 0, 0, sh, HD, HD, Gp(4), Gp(5), rows);
    accum_grad(xl + A + LS, HS, X, nullptr, 0, 0, sh, HD, HD, Gp(6), Gp(7), rows);
    dense_rows_t(sl, LD, Wp(0), LD, LD, cld, LD, rows, nullptr, 0, false);
    dense_rows_t(sl, LD, Wp(2), X, LD, dx, X, rows, nullptr, 0, false);
    dense_rows_t(sh, HD, Wp(4), HD, HD, chd, HD, rows, nullptr, 0, false);
    dense_rows_t(sh, HD, Wp(6), HS, HD, dhs, HS, rows, nullptr, 0, false);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
      const int r = i / X, j = i - r * X;
      if (j < A) out.d_actions[(base + r) * A + j] = dx[i];
      else if (j < A + LS) cls[r * LS + j - A] = dx[i];
      else chs[r * HS + j - A - LS] = dhs[r * HS + j - A - LS] + dx[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    out.d_hd[row0 * HD + i] = chd[i];
    out.d_hidh[row0 * HD + i] = chidh[i];
  }
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    out.d_ld[row0 * LD + i] = cld[i];
    out.d_hidl[row0 * LD + i] = chidl[i];
  }
  for (int i = threadIdx.x; i < rows * HS; i += blockDim.x) out.d_hs[row0 * HS + i] = chs[i];
  for (int i = threadIdx.x; i < rows * LS; i += blockDim.x) out.d_ls[row0 * LS + i] = cls[i];
  for (int i = threadIdx.x; i < NW; i += blockDim.x) partial[(size_t)blockIdx.x * NW + i] = GW[i];
}

}  // namespace

extern "C" {

// The largest rows-per-block ≤ R_want whose shared memory fits one block on
// the current device (0 if none does).
int mt_recurrence_bwd_rows(MTDims d, int R_want) {
  return mrssm::rows_that_fit(2 * (size_t)mrssm::mt_weight_dims(d, kNW).total, bwd_row_floats(d),
                              R_want);
}

// Launch on `stream`: the backward kernel, then the reduction of its
// [n_blocks, n_weights] partial sums (`partial`, scratch) into `d_weights`
// (torch layout, the 28 tensors back to back). Host arrays of device
// pointers: `weights` (28), `ins` (actions, a_emb, v_emb, prev6), `gouts`
// (12) and `d_ins` (d_actions, d_a_emb, d_v_emb, d init6), in the order of
// ops/kernels/recurrence_mt.py; all tensors f32 and contiguous. Returns the
// cudaError_t of the launches (0 on success).
int mt_recurrence_backward(const void* const* weights, const void* const* ins,
                           const void* const* gouts, void* partial, void* d_weights,
                           void* const* d_ins, MTDims d, void* stream) {
  if (d.ls_cat > 32 || d.hs_cat > 32) return (int)cudaErrorInvalidValue;  // st_vjp's buffers
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNW; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  const MTBwdIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]};
  MTCotangents g;
  for (int i = 0; i < kNOut; ++i) g.g[i] = static_cast<const float*>(gouts[i]);
  float* const* y = reinterpret_cast<float* const*>(d_ins);
  const MTBwdOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7], y[8]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const size_t smem = (2 * (size_t)dims.total + (size_t)d.rows * bwd_row_floats(d)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mt_recurrence_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.B + d.rows - 1) / d.rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mt_recurrence_bwd_kernel<<<blocks, mrssm::kThreads, smem, s>>>(
      w, dims, in, g, static_cast<float*>(partial), out, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(static_cast<const float*>(partial), blocks, dims,
                                                static_cast<float*>(d_weights), s);
}

}  // extern "C"
