// MoPoE-MMTRSSM hierarchical recurrence, backward (BPTT of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_mt.py::_bwd_kernel and
// ::_bwd_kernel_chunked (the step VJP _mt_bwd_step, the fusion VJP
// train_step.py::_mopoe_backward): the four straight-through samples'
// block-softmax VJPs, the MoPoE fusion, the five MLPs and both MTRNN cells,
// for t = T-1..0 from the six carries into each step (prev6[t], shifted once
// on the host). A straight-through sample's gradient flows through its probs
// only, so no noise and no argmax are needed here.
//
// What bounds it: only six carries make the backward sequential in t — d
// h_deter, d l_deter, d hs, d ls and both integrators' — and at the
// reference batch (B=8) a step is a few thousand multiply-adds a row, so the
// time is the latency of the dependent chain, not FLOPs or bytes. The design
// is recurrence_bwd.cu's, on its shared pieces (chain_common.cuh,
// dense_grads.cuh), in three launches:
//
// 1. mt_recurrence_bwd_recompute_kernel, over all T·B row-steps at once
//    (blocks of 512 threads, about one an SM, each staging the 28 weights
//    once for its rows): the forward step with the forward kernel's device
//    functions, then what of the VJP needs no carry — both prior heads'
//    whole backward (their straight-through VJPs, both transposes, into d
//    l_deter and d h_deter), and the coefficients the chain multiplies by
//    (the posteriors' block probs, the fusion's mixture weights and softmax
//    values, the ELU derivatives of the audio, vision and h-posterior hidden
//    layers, tanh' of both deters). It writes three records a row-step:
//    what the chain reads, the layers' inputs x that are not in device
//    memory already, and the prior heads' cotangents.
// 2. mt_recurrence_bwd_chain_kernel, the reverse-T loop carrying only the six
//    carries: one block of 256 threads per tile of R batch rows (rows never
//    interact), 4 barrier phases a step — both posteriors' straight-through
//    VJPs and the fusion VJP (a warp a row and layer); the three head-output
//    transposes; the deter sums, tanh' and both integrators; the four MTRNN
//    transposes into the carries. Each output of a phase is a dot split over
//    up to 32 adjacent lanes and added by full-mask shuffles in a fixed
//    order. The weight columns it transposes are staged once in torch
//    [out, in] layout by the bulk copy (TMA) into rows padded off a multiple
//    of 32 floats; each step's record arrives by the bulk copy into one of
//    two buffers while the step before computes. It writes every layer's
//    output cotangent dy that pass 1 did not to the third record.
// 3. recurrence_bwd_dw_kernel (dense_grads.cuh): the 28 weight gradients as
//    14 tasks of one batched GEMM over the T·B row-steps, Σ x·dyᵀ with its
//    bias column Σ dy, and the input cotangents that feed no carry (d
//    actions, d a_emb, d v_emb: the stored cotangents times weight columns),
//    summed in a fixed order straight into torch layout (no float atomics, so
//    two launches give the same bits). In both cells d(bias of d2h) equals
//    d(bias of input2h) (dw[3] = dw[1], dw[7] = dw[5]): the two tasks sum the
//    same cotangents in the same order, so they are equal bit for bit.
#include <algorithm>

#include "chain_common.cuh"
#include "dense_grads.cuh"
#include "mrssm_common.cuh"

namespace {

using chain::dot_part;
using chain::for_outputs;
using chain::group_sum;
using chain::make_split;
using chain::raw_floats;
using chain::round4;
using chain::Split;
using mrssm::MTDims;

constexpr int kNW = 28;
constexpr int kNOut = 12;
constexpr int kRecomputeThreads = 512;
constexpr int kChainThreads = 256;

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

// Widths and offsets of one step's quantities. The five MLPs' hidden layers
// lie back to back (l-prior, audio, vision, h-prior, h-posterior; H5 wide),
// and so do their logits (G5 wide).
struct Sizes {
  int A, E, HD, LD, C, R, lK, hK, LS, HS, X, H5, G5;
  int hA, hV, hP, hQ, gA, gV, gP, gQ;
};

__host__ __device__ inline Sizes sizes(const MTDims& d) {
  Sizes z;
  z.A = d.A; z.E = d.E; z.HD = d.HD; z.LD = d.LD; z.C = d.C; z.R = d.R;
  z.lK = d.ls_cat; z.hK = d.hs_cat;
  z.LS = d.ls_class * d.ls_cat; z.HS = d.hs_class * d.hs_cat;
  z.X = z.A + z.LS + z.HS; z.H5 = 3 * z.C + 2 * z.R; z.G5 = 3 * z.LS + 2 * z.HS;
  z.hA = z.C; z.hV = z.C + z.R; z.hP = z.C + 2 * z.R; z.hQ = 2 * z.C + 2 * z.R;
  z.gA = z.LS; z.gV = 2 * z.LS; z.gP = 3 * z.LS; z.gQ = 3 * z.LS + z.HS;
  return z;
}

// The three records of a row-step, each a row of floats rounded to 4, and
// the offset of each field (ops/kernels/recurrence_mt.py::mt_bwd_record_layout
// mirrors it field for field).
struct Layout {
  // What the chain reads: the l-posterior's cotangents (gls, gmx), block
  // probs (ql), the fusion's d mixed → d logit weights (ca, cv) and audio
  // and vision softmax values (ea, ev); the h-posterior's cotangents (ghs,
  // ghql) and block probs (qh); the ELU derivatives of the audio, vision
  // and h-posterior hidden layers (dact); per deter, its cotangent plus its
  // prior head's share (gldb, ghdb), tanh' (tl, th) and the integrator's
  // cotangent (ghidl, ghidh).
  int cw, gls, gmx, ql, ca, cv, ea, ev, ghs, ghql, qh, dact, gldb, tl, ghidl, ghdb, th, ghidh;
  // The layers' inputs: action ⊕ ls ⊕ hs, l_deter ⊕ h_deter, the hiddens.
  int xw, xl, xq, hid;
  // The layers' output cotangents: the hiddens, the logits, and both
  // MTRNNs' pre-activations (sl, sh).
  int dyw, dhid, dlg, sl, sh;
};

__host__ __device__ inline Layout layout(const Sizes& z) {
  Layout L;
  int o = 0;
  auto at = [&o](int w) { const int f = o; o += w; return f; };
  L.gls = at(z.LS); L.gmx = at(z.LS); L.ql = at(z.LS); L.ca = at(z.LS); L.cv = at(z.LS);
  L.ea = at(z.LS); L.ev = at(z.LS); L.ghs = at(z.HS); L.ghql = at(z.HS); L.qh = at(z.HS);
  L.dact = at(2 * z.R + z.C); L.gldb = at(z.LD); L.tl = at(z.LD); L.ghidl = at(z.LD);
  L.ghdb = at(z.HD); L.th = at(z.HD); L.ghidh = at(z.HD);
  L.cw = round4(o);
  o = 0;
  L.xl = at(z.X); L.xq = at(z.LD + z.HD); L.hid = at(z.H5);
  L.xw = round4(o);
  o = 0;
  L.dhid = at(z.H5); L.dlg = at(z.G5); L.sl = at(z.LD); L.sh = at(z.HD);
  L.dyw = round4(o);
  return L;
}

// ---- pass 1: the recompute ---------------------------------------------------------

// The per-row buffers of a recompute block, each [R][width] floats.
enum RBuf { kXl, kEmb, kLd0, kHd0, kHidl, kHidh, kLdet, kHdet, kPre, kHid, kLg, kStat, kMixed,
            kProbs, kDlgp, kDhp, kDdp, kNumRBufs };

__host__ __device__ inline void recompute_widths(const Sizes& z, int* w) {
  w[kXl] = z.X; w[kEmb] = 2 * z.E; w[kLd0] = z.LD; w[kHd0] = z.HD; w[kHidl] = z.LD;
  w[kHidh] = z.HD; w[kLdet] = z.LD; w[kHdet] = z.HD; w[kPre] = z.H5; w[kHid] = z.H5;
  w[kLg] = z.G5; w[kStat] = 4; w[kMixed] = z.LS;
  w[kProbs] = 2 * z.LS + 2 * z.HS;  // l-prior, l-posterior, h-prior, h-posterior
  w[kDlgp] = z.LS + z.HS;           // d l-prior logits, d h-prior logits
  w[kDhp] = 2 * z.C;                // d l-prior hidden, d h-prior hidden (pre-activation)
  w[kDdp] = z.LD + z.HD;            // d l_deter, d h_deter from the two priors
}

size_t recompute_row_floats(const Sizes& z) {
  int w[kNumRBufs];
  recompute_widths(z, w);
  size_t n = 0;
  for (int i = 0; i < kNumRBufs; ++i) n += w[i];
  return n;
}

__global__ void __launch_bounds__(kRecomputeThreads)
mt_recurrence_bwd_recompute_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims, MTBwdIn in,
                                   MTCotangents gouts, float* __restrict__ crec,
                                   float* __restrict__ xrec, float* __restrict__ dyrec, MTDims d,
                                   int N, int R) {
  using namespace mrssm;
  extern __shared__ __align__(16) float smem[];
  const Sizes z = sizes(d);
  const Layout L = layout(z);
  const int A = z.A, E = z.E, HD = z.HD, LD = z.LD, C = z.C, LS = z.LS, HS = z.HS, X = z.X;
  const int H5 = z.H5, G5 = z.G5, lK = z.lK, hK = z.hK;
  // The staging mbarrier, the weights ([in, out] at dims.off), then the
  // per-row buffers, which hold the weights' torch-layout staging area first.
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* W = smem + 4;
  float* rowbase = W + round4(dims.total);
  int width[kNumRBufs];
  recompute_widths(z, width);
  float* buf[kNumRBufs];
  float* p = rowbase;
  for (int i = 0; i < kNumRBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *xl = buf[kXl], *emb = buf[kEmb], *ld0 = buf[kLd0], *hd0 = buf[kHd0];
  float *hidl = buf[kHidl], *hidh = buf[kHidh], *ldet = buf[kLdet], *hdet = buf[kHdet];
  float *pre = buf[kPre], *hid = buf[kHid], *lg = buf[kLg], *stat = buf[kStat];
  float *mixed = buf[kMixed], *probs = buf[kProbs], *dlgp = buf[kDlgp], *dhp = buf[kDhp];
  float* ddp = buf[kDdp];
  const int PW = 2 * LS + 2 * HS;
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };
  const float* const* g = gouts.g;

  chain::stage_weights_bulk(W, rowbase, w, dims, bar);
  const int n0 = blockIdx.x * R;  // first row-step (t·B + b) of this block
  const int rows = min(R, N - n0);
  for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
    const int r = i / X, j = i - r * X;
    const size_t n = (size_t)n0 + r;
    xl[i] = j < A ? in.actions[n * A + j]
            : j < A + LS ? in.ls0[n * LS + j - A] : in.hs0[n * HS + j - A - LS];
  }
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i - r * E;
    emb[r * 2 * E + e] = in.a_emb[(size_t)n0 * E + i];
    emb[r * 2 * E + E + e] = in.v_emb[(size_t)n0 * E + i];
  }
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    ld0[i] = in.ld0[(size_t)n0 * LD + i];
    hidl[i] = in.hidl0[(size_t)n0 * LD + i];
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    hd0[i] = in.hd0[(size_t)n0 * HD + i];
    hidh[i] = in.hidh0[(size_t)n0 * HD + i];
  }
  __syncthreads();

  // The forward step, as the forward kernel computes it (the hidden layers'
  // pre-activations kept: ELU after the sum, the same bits).
  mtrnn_rows(ld0, LD, xl, X, X, Wp(0), Wp(1), Wp(2), Wp(3), LD, hidl, LD, ldet, LD, d.l_inv,
             d.l_keep, rows);
  mtrnn_rows(hd0, HD, xl + A + LS, HS, X, Wp(4), Wp(5), Wp(6), Wp(7), HD, hidh, HD, hdet, HD,
             d.h_inv, d.h_keep, rows);
  __syncthreads();
  dense_rows(ldet, LD, LD, nullptr, 0, 0, Wp(8), Wp(9), C, pre, H5, rows, false);
  dense_rows(ldet, LD, LD, emb, E, 2 * E, Wp(20), Wp(21), z.R, pre + z.hA, H5, rows, false);
  dense_rows(ldet, LD, LD, emb + E, E, 2 * E, Wp(24), Wp(25), z.R, pre + z.hV, H5, rows, false);
  dense_rows(hdet, HD, HD, nullptr, 0, 0, Wp(12), Wp(13), C, pre + z.hP, H5, rows, false);
  dense_rows(ldet, LD, LD, hdet, HD, HD, Wp(16), Wp(17), C, pre + z.hQ, H5, rows, false);
  __syncthreads();
  elu_rows(pre, hid, rows * H5);
  __syncthreads();
  dense_rows(hid, C, H5, nullptr, 0, 0, Wp(10), Wp(11), LS, lg, G5, rows, false);
  dense_rows(hid + z.hA, z.R, H5, nullptr, 0, 0, Wp(22), Wp(23), LS, lg + z.gA, G5, rows, false);
  dense_rows(hid + z.hV, z.R, H5, nullptr, 0, 0, Wp(26), Wp(27), LS, lg + z.gV, G5, rows, false);
  dense_rows(hid + z.hP, C, H5, nullptr, 0, 0, Wp(14), Wp(15), HS, lg + z.gP, G5, rows, false);
  dense_rows(hid + z.hQ, C, H5, nullptr, 0, 0, Wp(18), Wp(19), HS, lg + z.gQ, G5, rows, false);
  __syncthreads();
  mopoe_stats(lg + z.gA, G5, LS, stat, rows);
  __syncthreads();
  mopoe_mix(lg + z.gA, G5, stat, LS, mixed, rows);
  __syncthreads();

  // The four samples' block probs, and both priors' straight-through VJPs
  // into their logits: they need no carry. One thread a (row, block).
  const int nb = d.ls_class + d.hs_class;
  for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
    const int r = i / nb, c = i - r * nb;
    const size_t n = (size_t)n0 + r;
    float* pr = probs + r * PW;
    if (c < d.ls_class) {
      const int o = c * lK;
      block_softmax(lg + r * G5 + o, lK, pr + o);
      block_softmax(mixed + r * LS + o, lK, pr + LS + o);
      st_vjp(pr + o, g[5] + n * LS + o, g[4] + n * LS + o, lK, dlgp + r * (LS + HS) + o);
    } else {
      const int o = (c - d.ls_class) * hK;
      block_softmax(lg + r * G5 + z.gP + o, hK, pr + 2 * LS + o);
      block_softmax(lg + r * G5 + z.gQ + o, hK, pr + 2 * LS + HS + o);
      st_vjp(pr + 2 * LS + o, g[9] + n * HS + o, g[8] + n * HS + o, hK,
             dlgp + r * (LS + HS) + LS + o);
    }
  }
  __syncthreads();
  // The prior heads' transposes: d hidden (times ELU'), then their shares of
  // d l_deter and d h_deter.
  dense_rows_t(dlgp, LS + HS, Wp(10), C, LS, dhp, 2 * C, rows, pre, H5, false);
  dense_rows_t(dlgp + LS, LS + HS, Wp(14), C, HS, dhp + C, 2 * C, rows, pre + z.hP, H5, false);
  __syncthreads();
  dense_rows_t(dhp, 2 * C, Wp(8), LD, C, ddp, LD + HD, rows, nullptr, 0, false);
  dense_rows_t(dhp + C, 2 * C, Wp(12), HD, C, ddp + LD, LD + HD, rows, nullptr, 0, false);
  __syncthreads();

  // The records.
  for (int i = threadIdx.x; i < rows * LS; i += blockDim.x) {
    const int r = i / LS, s = i - r * LS;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    const float* st = stat + r * 4;
    const float la = (lg[r * G5 + z.gA + s] - st[0]) - st[1];
    const float lv = (lg[r * G5 + z.gV + s] - st[2]) - st[3];
    const float mx = mixed[i];
    const float wa = expf(la + kLogThird - mx);
    const float wv = expf(lv + kLogThird - mx);
    const float wf = expf(la + lv + kLogThird - mx);
    c[L.gls + s] = g[7][n * LS + s];
    c[L.gmx + s] = g[6][n * LS + s];
    c[L.ql + s] = probs[r * PW + LS + s];
    c[L.ca + s] = wa + wf;
    c[L.cv + s] = wv + wf;
    c[L.ea + s] = expf(la);
    c[L.ev + s] = expf(lv);
    dyrec[n * L.dyw + L.dlg + s] = dlgp[r * (LS + HS) + s];
  }
  for (int i = threadIdx.x; i < rows * HS; i += blockDim.x) {
    const int r = i / HS, s = i - r * HS;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    c[L.ghs + s] = g[11][n * HS + s];
    c[L.ghql + s] = g[10][n * HS + s];
    c[L.qh + s] = probs[r * PW + 2 * LS + HS + s];
    dyrec[n * L.dyw + L.dlg + z.gP + s] = dlgp[r * (LS + HS) + LS + s];
  }
  for (int i = threadIdx.x; i < rows * H5; i += blockDim.x) {
    const int r = i / H5, j = i - r * H5;
    const size_t n = (size_t)n0 + r;
    xrec[n * L.xw + L.hid + j] = hid[i];
    if (j >= z.hA && j < z.hP) crec[n * L.cw + L.dact + j - z.hA] = d_elu(pre[i]);
    else if (j >= z.hQ) crec[n * L.cw + L.dact + 2 * z.R + j - z.hQ] = d_elu(pre[i]);
    else if (j < z.hA) dyrec[n * L.dyw + L.dhid + j] = dhp[r * 2 * C + j];
    else dyrec[n * L.dyw + L.dhid + j] = dhp[r * 2 * C + C + j - z.hP];
  }
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    const int r = i / LD, j = i - r * LD;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    c[L.gldb + j] = g[1][n * LD + j] + ddp[r * (LD + HD) + j];
    c[L.tl + j] = 1.f - ldet[i] * ldet[i];
    c[L.ghidl + j] = g[3][n * LD + j];
    xrec[n * L.xw + L.xq + j] = ldet[i];
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const int r = i / HD, j = i - r * HD;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    c[L.ghdb + j] = g[0][n * HD + j] + ddp[r * (LD + HD) + LD + j];
    c[L.th + j] = 1.f - hdet[i] * hdet[i];
    c[L.ghidh + j] = g[2][n * HD + j];
    xrec[n * L.xw + L.xq + LD + j] = hdet[i];
  }
  for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
    const int r = i / X, j = i - r * X;
    xrec[((size_t)n0 + r) * L.xw + L.xl + j] = xl[i];
  }
}

// ---- pass 2: the carry-only chain --------------------------------------------------

// The weight columns the chain reads, torch layout [out, in], staged in this
// order: for the head-output transposes hq2, wa2, wv2; for the deters hq1
// (l_deter ⊕ h_deter columns), wa1's and wv1's l_deter columns; for the
// carries wld, wli's ls ⊕ hs columns, whd, whi.
constexpr int kNC = 10;
using ChainWeights = chain::ChainWeights<kNC>;

ChainWeights chain_weights(const mrssm::WeightPtrs& w, const Sizes& z) {
  ChainWeights c;
  chain::chain_weight(c, 0, w.p[18], z.HS, z.C, 0, z.C);
  chain::chain_weight(c, 1, w.p[22], z.LS, z.R, 0, z.R);
  chain::chain_weight(c, 2, w.p[26], z.LS, z.R, 0, z.R);
  chain::chain_weight(c, 3, w.p[16], z.C, z.LD + z.HD, 0, z.LD + z.HD);
  chain::chain_weight(c, 4, w.p[20], z.R, z.LD + z.E, 0, z.LD);
  chain::chain_weight(c, 5, w.p[24], z.R, z.LD + z.E, 0, z.LD);
  chain::chain_weight(c, 6, w.p[0], z.LD, z.LD, 0, z.LD);
  chain::chain_weight(c, 7, w.p[2], z.LD, z.X, z.A, z.LS + z.HS);
  chain::chain_weight(c, 8, w.p[4], z.HD, z.HD, 0, z.HD);
  chain::chain_weight(c, 9, w.p[6], z.HD, z.HS, 0, z.HS);
  return c;
}

// Per-row state of a chain block, each [R][width] floats after the weights
// and the two record buffers: the six carries (both integrators' in two
// halves, read one step and written the next), the phases' scratch and
// outputs.
enum CBuf { kCdl, kCdh, kCsl, kCsh, kChl, kChh, kDm, kDq, kDlav, kDhql, kDhead, kSl, kSh,
            kNumCBufs };

__host__ __device__ inline void chain_widths(const Sizes& z, int* w) {
  w[kCdl] = z.LD; w[kCdh] = z.HD; w[kCsl] = z.LS; w[kCsh] = z.HS; w[kChl] = 2 * z.LD;
  w[kChh] = 2 * z.HD; w[kDm] = z.LS; w[kDq] = z.HS; w[kDlav] = 2 * z.LS; w[kDhql] = z.HS;
  w[kDhead] = 2 * z.R + z.C; w[kSl] = z.LD; w[kSh] = z.HD;
}

size_t chain_row_floats(const Sizes& z) {
  int w[kNumCBufs];
  chain_widths(z, w);
  size_t n = 2 * (size_t)layout(z).cw;  // the two record buffers
  for (int i = 0; i < kNumCBufs; ++i) n += w[i];
  return n;
}

__global__ void __launch_bounds__(kChainThreads)
mt_recurrence_bwd_chain_kernel(const __grid_constant__ ChainWeights cw,
                               const float* __restrict__ crec, float* __restrict__ dyrec,
                               MTBwdOut out, MTDims d) {
  extern __shared__ __align__(16) float smem[];
  const Sizes z = sizes(d);
  const Layout L = layout(z);
  const int LD = z.LD, HD = z.HD, LS = z.LS, HS = z.HS, C = z.C, RH = z.R, B = d.B, T = d.T;
  const int R = d.rows, NH = 2 * RH + C;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // weights, rec 0, rec 1
  float* Wc = smem + 8;
  const float* Whq2 = Wc + cw.off[0];
  const float* Wa2 = Wc + cw.off[1];
  const float* Wv2 = Wc + cw.off[2];
  const float* Whq1 = Wc + cw.off[3];
  const float* Wa1 = Wc + cw.off[4];
  const float* Wv1 = Wc + cw.off[5];
  const float* Wld = Wc + cw.off[6];
  const float* Wli = Wc + cw.off[7];
  const float* Whd = Wc + cw.off[8];
  const float* Whi = Wc + cw.off[9];
  float* recbuf = Wc + cw.total;  // two buffers of R records
  int width[kNumCBufs];
  chain_widths(z, width);
  float* buf[kNumCBufs];
  float* p = recbuf + 2 * R * L.cw;
  for (int i = 0; i < kNumCBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *cdl = buf[kCdl], *cdh = buf[kCdh], *csl = buf[kCsl], *csh = buf[kCsh];
  float *chl = buf[kChl], *chh = buf[kChh], *dmx = buf[kDm], *dqh = buf[kDq];
  float *dlav = buf[kDlav], *dhql = buf[kDhql], *dhead = buf[kDhead], *sl = buf[kSl];
  float* sh = buf[kSh];

  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const int rec_bytes = rows * L.cw * (int)sizeof(float);
  auto rec_src = [&](int t) { return crec + ((size_t)t * B + row0) * L.cw; };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) fconv::mbar_init(&bar[i]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fconv::bulk_load(recbuf, rec_src(T - 1), rec_bytes, &bar[1]);
    if (T > 1) fconv::bulk_load(recbuf + R * L.cw, rec_src(T - 2), rec_bytes, &bar[2]);
  }
  chain::stage_chain_weights(cw, Wc, &bar[0]);
  // The carries start at 0 (kCdl .. kChh lie back to back).
  for (int i = threadIdx.x; i < R * (3 * (LD + HD) + LS + HS); i += blockDim.x) cdl[i] = 0.f;
  // Each phase's split of its outputs over the block, fixed for all steps.
  const Split sB = make_split(rows, NH), sC = make_split(rows, LD + HD);
  const Split sD = make_split(rows, LD + LS + HD + HS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  fconv::mbar_wait(&bar[0], 0);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i, cur = i & 1, prev = cur ^ 1;
    const float* rc = recbuf + cur * R * L.cw;
    fconv::mbar_wait(&bar[1 + cur], (i >> 1) & 1);
    const size_t base = (size_t)t * B + row0;  // first row-step of this tile

    // A. Both posteriors' straight-through VJPs (output + carry) into their
    // logits, a lane an element, each block's dot added in order; the
    // l-posterior's then through the fusion into the audio and vision
    // logits, the full-axis sums by shuffles in a fixed order. A warp a row
    // and layer (even tasks the lower, odd the higher).
    for (int task = warp; task < 2 * rows; task += warps) {
      const int r = task >> 1;
      const float* c = rc + r * L.cw;
      float* y = dyrec + (base + r) * L.dyw + L.dlg;
      if ((task & 1) == 0) {
        float* dm = dmx + r * LS;
        float* dl = dlav + r * 2 * LS;
        const float* cs = csl + r * LS;
        for (int s = lane; s < LS; s += 32) dm[s] = c[L.ql + s] * (c[L.gls + s] + cs[s]);
        __syncwarp();
        float sa = 0.f, sv = 0.f;
        for (int s = lane; s < LS; s += 32) {
          const int o = s - s % z.lK;
          float dot = 0.f;
          for (int j = 0; j < z.lK; ++j) dot += dm[o + j];
          const float m = c[L.gmx + s] + c[L.ql + s] * ((c[L.gls + s] + cs[s]) - dot);
          dl[s] = m * c[L.ca + s];
          dl[LS + s] = m * c[L.cv + s];
          sa += dl[s];
          sv += dl[LS + s];
        }
        for (int m = 16; m > 0; m >>= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, m);
          sv += __shfl_xor_sync(0xffffffffu, sv, m);
        }
        for (int s = lane; s < LS; s += 32) {
          dl[s] -= c[L.ea + s] * sa;
          dl[LS + s] -= c[L.ev + s] * sv;
          y[z.gA + s] = dl[s];
          y[z.gV + s] = dl[LS + s];
        }
      } else {
        float* dq = dqh + r * HS;
        const float* cs = csh + r * HS;
        for (int s = lane; s < HS; s += 32) dq[s] = c[L.qh + s] * (c[L.ghs + s] + cs[s]);
        __syncwarp();
        for (int s = lane; s < HS; s += 32) {
          const int o = s - s % z.hK;
          float dot = 0.f;
          for (int j = 0; j < z.hK; ++j) dot += dq[o + j];
          const float v = c[L.ghql + s] + c[L.qh + s] * ((c[L.ghs + s] + cs[s]) - dot);
          dhql[r * HS + s] = v;
          y[z.gQ + s] = v;
        }
      }
    }
    __syncthreads();
    // B. The audio, vision and h-posterior heads' output layers transposed,
    // times the ELU derivative: d hidden (d_ha, d_hv, d_hq).
    for_outputs(sB, rows, NH, [&](int r, int j, bool valid) {
      const int m = j >= RH;
      const float part = j < 2 * RH
          ? dot_part(dlav + r * 2 * LS + m * LS, (m ? Wv2 : Wa2) + (j - m * RH), cw.ws[1 + m], LS,
                     sB)
          : dot_part(dhql + r * HS, Whq2 + (j - 2 * RH), cw.ws[0], HS, sB);
      const float v = group_sum(part, sB) * rc[r * L.cw + L.dact + j];
      if (valid && sB.part == 0) {
        dhead[r * NH + j] = v;
        dyrec[(base + r) * L.dyw + L.dhid + (j < 2 * RH ? C + j : 2 * C + j)] = v;
      }
    });
    __syncthreads();
    // C. d l_deter and d h_deter (output and prior share, carry, the heads),
    // tanh', the integrators: the MTRNNs' pre-activation cotangents sl, sh.
    for_outputs(sC, rows, LD + HD, [&](int r, int j, bool valid) {
      const float* dh = dhead + r * NH;
      const bool lower = j < LD;
      const int k = lower ? j : j - LD;
      float part = dot_part(dh + 2 * RH, Whq1 + j, cw.ws[3], C, sC);
      if (lower) {
        part += dot_part(dh, Wa1 + k, cw.ws[4], RH, sC) + dot_part(dh + RH, Wv1 + k, cw.ws[5], RH, sC);
      }
      const float heads = group_sum(part, sC);
      const float* c = rc + r * L.cw;
      const int N = lower ? LD : HD;
      const float* cd = lower ? cdl + r * LD : cdh + r * HD;
      float* ch = lower ? chl + r * 2 * LD : chh + r * 2 * HD;
      const float gd = (c[(lower ? L.gldb : L.ghdb) + k] + cd[k]) + heads;
      const float gh = (c[(lower ? L.ghidl : L.ghidh) + k] + ch[prev * N + k]) +
                       gd * c[(lower ? L.tl : L.th) + k];
      if (valid && sC.part == 0) {
        ch[cur * N + k] = gh * (lower ? d.l_keep : d.h_keep);
        const float s = gh * (lower ? d.l_inv : d.h_inv);
        (lower ? sl + r * LD : sh + r * HD)[k] = s;
        dyrec[(base + r) * L.dyw + (lower ? L.sl : L.sh) + k] = s;
      }
    });
    __syncthreads();
    // Every read of this record is done: bring in the one two steps on.
    if (threadIdx.x == 0 && t >= 2) {
      fconv::bulk_load(recbuf + cur * R * L.cw, rec_src(t - 2), rec_bytes, &bar[1 + cur]);
    }
    // D. The carries: d l_deter (wld), d ls (wli's ls columns), d h_deter
    // (whd), d hs (whi, plus wli's hs columns), each the MTRNNs' transposes.
    for_outputs(sD, rows, LD + LS + HD + HS, [&](int r, int j, bool valid) {
      const float* a = sl + r * LD;
      const float* b = sh + r * HD;
      int which = 0, k = j;
      float part;
      if (j < LD) {
        part = dot_part(a, Wld + k, cw.ws[6], LD, sD);
      } else if ((k = j - LD) < LS) {
        which = 1;
        part = dot_part(a, Wli + k, cw.ws[7], LD, sD);
      } else if ((k = j - LD - LS) < HD) {
        which = 2;
        part = dot_part(b, Whd + k, cw.ws[8], HD, sD);
      } else {
        which = 3;
        k = j - LD - LS - HD;
        part = dot_part(b, Whi + k, cw.ws[9], HD, sD) + dot_part(a, Wli + LS + k, cw.ws[7], LD, sD);
      }
      const float v = group_sum(part, sD);
      if (valid && sD.part == 0) {
        float* dst = which == 0 ? cdl + r * LD : which == 1 ? csl + r * LS
                   : which == 2 ? cdh + r * HD : csh + r * HS;
        dst[k] = v;
      }
    });
    __syncthreads();
  }
  const int last = (T - 1) & 1;
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const int r = i / HD, j = i - r * HD;
    out.d_hd[row0 * HD + i] = cdh[i];
    out.d_hidh[row0 * HD + i] = chh[r * 2 * HD + last * HD + j];
  }
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    const int r = i / LD, j = i - r * LD;
    out.d_ld[row0 * LD + i] = cdl[i];
    out.d_hidl[row0 * LD + i] = chl[r * 2 * LD + last * LD + j];
  }
  for (int i = threadIdx.x; i < rows * HS; i += blockDim.x) out.d_hs[row0 * HS + i] = csh[i];
  for (int i = threadIdx.x; i < rows * LS; i += blockDim.x) out.d_ls[row0 * LS + i] = csl[i];
}

// ---- pass 3: the deferred GEMMs --------------------------------------------------

// The 14 dense layers' gradients over the records and the inputs, into
// d_weights (torch layout, back to back in kernel order), and the input
// cotangents that feed no carry: d actions (wli's action columns), d a_emb
// and d v_emb (wa1's and wv1's embedding columns). The inputs that are in
// device memory (prev6, the embeddings) are read in place.
mrssm::DenseGradTable dw_table(const mrssm::WeightPtrs& w, const mrssm::WeightDims& dims,
                               const Sizes& z, const Layout& L, const MTBwdIn& in,
                               const float* xrec, const float* dyrec, float* d_weights,
                               const MTBwdOut& out, int N) {
  mrssm::DenseGradTable tb;
  mrssm::dense_grad_table_init(tb, dims.total);
  const int LD = z.LD, HD = z.HD, C = z.C, RH = z.R, LS = z.LS, HS = z.HS, E = z.E;
  auto layer = [&](int i, const float* x0, int n0, int s0, const float* x1, int n1, int s1,
                   int dy, int outw) {
    mrssm::dense_grad_weight(tb, x0, n0, s0, x1, n1, s1, dyrec + dy, L.dyw, outw, d_weights,
                             dims.off[i], dims.off[i + 1], N);
  };
  layer(0, in.ld0, LD, LD, nullptr, 0, 0, L.sl, LD);
  layer(2, xrec + L.xl, z.X, L.xw, nullptr, 0, 0, L.sl, LD);
  layer(4, in.hd0, HD, HD, nullptr, 0, 0, L.sh, HD);
  layer(6, in.hs0, HS, HS, nullptr, 0, 0, L.sh, HD);
  layer(8, xrec + L.xq, LD, L.xw, nullptr, 0, 0, L.dhid, C);
  layer(10, xrec + L.hid, C, L.xw, nullptr, 0, 0, L.dlg, LS);
  layer(12, xrec + L.xq + LD, HD, L.xw, nullptr, 0, 0, L.dhid + z.hP, C);
  layer(14, xrec + L.hid + z.hP, C, L.xw, nullptr, 0, 0, L.dlg + z.gP, HS);
  layer(16, xrec + L.xq, LD + HD, L.xw, nullptr, 0, 0, L.dhid + z.hQ, C);
  layer(18, xrec + L.hid + z.hQ, C, L.xw, nullptr, 0, 0, L.dlg + z.gQ, HS);
  layer(20, xrec + L.xq, LD, L.xw, in.a_emb, E, E, L.dhid + z.hA, RH);
  layer(22, xrec + L.hid + z.hA, RH, L.xw, nullptr, 0, 0, L.dlg + z.gA, LS);
  layer(24, xrec + L.xq, LD, L.xw, in.v_emb, E, E, L.dhid + z.hV, RH);
  layer(26, xrec + L.hid + z.hV, RH, L.xw, nullptr, 0, 0, L.dlg + z.gV, LS);
  mrssm::dense_grad_rows(tb, dyrec + L.sl, L.dyw, LD, w.p[2], z.X, 0, z.A, out.d_actions, N);
  mrssm::dense_grad_rows(tb, dyrec + L.dhid + z.hA, L.dyw, RH, w.p[20], LD + E, LD, E,
                         out.d_a_emb, N);
  mrssm::dense_grad_rows(tb, dyrec + L.dhid + z.hV, L.dyw, RH, w.p[24], LD + E, LD, E,
                         out.d_v_emb, N);
  return tb;
}

}  // namespace

extern "C" {

// The largest batch rows per chain block ≤ R_want whose shared memory fits
// one block on the current device (0 if none does).
int mt_recurrence_bwd_rows(MTDims d, int R_want) {
  const Sizes z = sizes(d);
  const ChainWeights cw = chain_weights(mrssm::WeightPtrs{}, z);
  return mrssm::rows_that_fit(8 + cw.total, chain_row_floats(z), R_want);
}

// Floats of scratch a backward call needs at these sizes: the three records
// of every row-step, then the deferred GEMMs' partial sums and their tickets
// (ops/kernels/recurrence_mt.py views the records).
long long mt_recurrence_bwd_workspace(MTDims d) {
  const Sizes z = sizes(d);
  const Layout L = layout(z);
  const int N = d.T * d.B;
  const mrssm::DenseGradTable tb = dw_table(mrssm::WeightPtrs{}, mrssm::mt_weight_dims(d, kNW), z,
                                            L, MTBwdIn{}, nullptr, nullptr, nullptr, MTBwdOut{}, N);
  return (long long)N * (L.cw + L.xw + L.dyw) + mrssm::dense_grad_partial_floats(tb) + tb.tiles;
}

// Launch on `stream` the passes in `passes` (1: recompute, 2: chain, 4: the
// deferred GEMMs; 7 for a backward call). `workspace` holds
// mt_recurrence_bwd_workspace floats: the records [N, cw], [N, xw], [N, dyw]
// (N = T·B), then the GEMMs' scratch. Host arrays of device pointers:
// `weights` (28), `ins` (actions, a_emb, v_emb, prev6), `gouts` (12) and
// `d_ins` (d_actions, d_a_emb, d_v_emb, d init6), in the order of
// ops/kernels/recurrence_mt.py; d_weights gets the 28 gradients in torch
// layout, back to back; d.rows is the chain's batch rows a block. All
// tensors f32 and contiguous. Returns the cudaError_t of the launches (0 on
// success).
int mt_recurrence_backward(const void* const* weights, const void* const* ins,
                           const void* const* gouts, void* workspace, void* d_weights,
                           void* const* d_ins, MTDims d, int passes, void* stream) {
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, kNW);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  const MTBwdIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]};
  MTCotangents g;
  for (int i = 0; i < kNOut; ++i) g.g[i] = static_cast<const float*>(gouts[i]);
  float* const* y = reinterpret_cast<float* const*>(d_ins);
  const MTBwdOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7], y[8]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const Sizes z = sizes(d);
  const Layout L = layout(z);
  const int N = d.T * d.B;
  float* crec = static_cast<float*>(workspace);
  float* xrec = crec + (size_t)N * L.cw;
  float* dyrec = xrec + (size_t)N * L.xw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    // About a block an SM: each stages the weights, then recomputes its
    // rows; the row buffers hold the weights' torch-layout staging first.
    const int sms = std::max(chain::sm_count(), 1);
    const size_t fixed = 4 + round4(dims.total), per_row = recompute_row_floats(z);
    const int R1 = mrssm::rows_that_fit(fixed, per_row,
                                        std::max(1, std::min(32, (N + sms - 1) / sms)));
    if (R1 < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (fixed + std::max((size_t)raw_floats(dims), R1 * per_row)) * sizeof(float);
    err = cudaFuncSetAttribute(mt_recurrence_bwd_recompute_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mt_recurrence_bwd_recompute_kernel<<<(N + R1 - 1) / R1, kRecomputeThreads, smem, s>>>(
        w, dims, in, g, crec, xrec, dyrec, d, N, R1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    if (d.rows < 1) return (int)cudaErrorInvalidValue;
    const ChainWeights cw = chain_weights(w, z);
    const size_t smem = (8 + (size_t)cw.total + d.rows * chain_row_floats(z)) * sizeof(float);
    err = cudaFuncSetAttribute(mt_recurrence_bwd_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mt_recurrence_bwd_chain_kernel<<<(d.B + d.rows - 1) / d.rows, kChainThreads, smem, s>>>(
        cw, crec, dyrec, out, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const mrssm::DenseGradTable tb =
        dw_table(w, dims, z, L, in, xrec, dyrec, static_cast<float*>(d_weights), out, N);
    float* partial = dyrec + (size_t)N * L.dyw;
    int* tickets = reinterpret_cast<int*>(partial + mrssm::dense_grad_partial_floats(tb));
    err = mrssm::dense_grads_launch(tb, partial, tickets, s);
  }
  return (int)err;
}

}  // extern "C"
