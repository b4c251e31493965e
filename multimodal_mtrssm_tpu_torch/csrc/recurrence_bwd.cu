// MoPoE-MRSSM representation recurrence, backward (BPTT of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step.py::_bwd_kernel and
// ::_bwd_kernel_chunked (the step VJP _bwd_step, the fusion VJP
// _mopoe_backward). The gradient of a straight-through sample flows through
// its probs only, so no noise and no argmax are needed here.
//
// What bounds it: only the carries d deter (cd) and d stoch (cs) make the
// backward sequential in t, and at the reference batch (B=8) each step is a
// few thousand multiply-adds a row, so the time is the latency of the
// dependent chain, not FLOPs or bytes. The design takes everything that does
// not feed the carries out of the chain, in three launches:
//
// 1. recurrence_bwd_recompute_kernel, over all T·B row-steps at once (the
//    carries into each step, prev_deter[t] and prev_stoch[t], are stored):
//    the forward step with the forward kernel's device functions, then what
//    of the VJP needs no carry — the prior head's whole backward (its
//    straight-through VJP, both transposes), and the coefficients the chain
//    multiplies by (ELU derivatives, the GRU's gate derivatives, the
//    fusion's mixture weights and softmax values). It writes three records a
//    row-step: what the chain reads, the layers' inputs x for the weight
//    gradients, and the prior head's cotangents.
// 2. recurrence_bwd_chain_kernel, the reverse-T loop carrying only d deter
//    and d stoch: one block of 256 threads per tile of R batch rows (rows
//    never interact), 6 barrier phases a step — the posterior's
//    straight-through and fusion VJPs (a warp a row), the two head
//    transposes, d deter and the GRU VJP, d x2 and the deter carry, d h1,
//    the stoch carry. Each output of a phase is a dot split over P adjacent
//    lanes (the most that the phase's outputs leave room for, ≤ 32) and
//    added by shuffles in a fixed order, so a step is ~6 short dots deep.
//    The weights it transposes are staged once in torch [out, in] layout,
//    row by row by the bulk copy (TMA) into rows padded off a multiple of 32
//    floats, so the P lanes of an output read distinct banks; each step's
//    record arrives by the bulk copy into one of two buffers while the step
//    before computes. It writes every layer's output cotangent dy to the
//    third record.
// 3. recurrence_bwd_dw_kernel (dense_grads.cuh): the 20 weight gradients as
//    one batched GEMM over the T·B row-steps, Σ x·dyᵀ and Σ dy, and the
//    input cotangents that feed no carry (d actions, d a_emb, d v_emb: the
//    stored cotangents times weight columns), summed in a fixed order
//    straight into torch layout (no float atomics, so two launches give the
//    same bits).
//
// recurrence_stacked_bwd.cu runs the same three passes, through
// mrssm_recurrence_backward_passes, on its packed copy of the stacked
// weights.
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

constexpr int kNW = 20;

mrssm::WeightDims weight_dims(int A, int E, int H, int D, int S) {
  const int X = A + S, G = 3 * D, DE = D + E;
  const int in[kNW] = {X, 1, H, 1, H, 1, D, 1, D, 1, H, 1, DE, 1, H, 1, DE, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S, H, H, S, S, H, H, S, S};
  return mrssm::weight_dims(in, out, kNW);
}

// The three records of a row-step, each a row of floats rounded to 4, and
// the offset of each field (ops/kernels/recurrence.py::bwd_record_layout
// mirrors it field for field).
struct Layout {
  // What the chain reads: d deter from the step's output and the prior head
  // (gdb), the posterior's output cotangents (gmx, gpo), its block probs
  // (qprob); the fusion's d mixed → d logit weights (ca, cv) and the audio
  // and vision softmax values (ea, ev); the GRU's r and z and the factors
  // of d gates (an, az, ar); the ELU derivatives of the transition hidden
  // layer and of the audio and vision head hidden layers.
  int cw, gdb, gmx, gpo, qprob, ca, cv, ea, ev, rg, z, an, az, ar, dact_h1, dact_hp;
  // The layers' inputs: transition hidden, GRU input, deter, head hiddens.
  int xw, h1, x2, deter, hid;
  // The layers' output cotangents: prior ⊕ audio ⊕ vision logits and head
  // hiddens, GRU input and hidden gates, GRU input, transition hidden.
  int dyw, dlg, dhid, dgi, dgh, dx2, dh1;
};

__host__ __device__ inline Layout layout(int H, int D, int S) {
  Layout L;
  int o = 0;
  auto at = [&o](int w) { const int f = o; o += w; return f; };
  L.gdb = at(D); L.gmx = at(S); L.gpo = at(S); L.qprob = at(S); L.ca = at(S); L.cv = at(S);
  L.ea = at(S); L.ev = at(S); L.rg = at(D); L.z = at(D); L.an = at(D); L.az = at(D);
  L.ar = at(D); L.dact_h1 = at(H); L.dact_hp = at(2 * H);
  L.cw = round4(o);
  o = 0;
  L.h1 = at(H); L.x2 = at(H); L.deter = at(D); L.hid = at(3 * H);
  L.xw = round4(o);
  o = 0;
  L.dlg = at(3 * S); L.dhid = at(3 * H); L.dgi = at(3 * D); L.dgh = at(3 * D); L.dx2 = at(H);
  L.dh1 = at(H);
  L.dyw = round4(o);
  return L;
}

// ---- pass 1: the recompute ---------------------------------------------------------

// The per-row buffers of a recompute block, each [R][width] floats.
enum RBuf { kXin, kEmb, kPdeter, kDeter, kH1p, kH1, kX2, kGates, kHp, kHid, kLg, kStat, kMixed,
            kPprob, kQprob, kDlgp, kDhidp, kDdp, kNumRBufs };

__host__ __device__ inline void recompute_widths(int A, int E, int H, int D, int S, int* w) {
  const int G = 3 * D;
  w[kXin] = A + S; w[kEmb] = 2 * E; w[kPdeter] = D; w[kDeter] = D; w[kH1p] = H; w[kH1] = H;
  w[kX2] = H; w[kGates] = 2 * G; w[kHp] = 3 * H; w[kHid] = 3 * H; w[kLg] = 3 * S; w[kStat] = 4;
  w[kMixed] = S; w[kPprob] = S; w[kQprob] = S; w[kDlgp] = S; w[kDhidp] = H; w[kDdp] = D;
}

size_t recompute_row_floats(int A, int E, int H, int D, int S) {
  int w[kNumRBufs];
  recompute_widths(A, E, H, D, S, w);
  size_t n = 0;
  for (int i = 0; i < kNumRBufs; ++i) n += w[i];
  return n;
}

__global__ void __launch_bounds__(mrssm::kThreads)
recurrence_bwd_recompute_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims,
                                const float* __restrict__ actions, const float* __restrict__ a_emb,
                                const float* __restrict__ v_emb,
                                const float* __restrict__ prev_deter,
                                const float* __restrict__ prev_stoch, const float* __restrict__ gd,
                                const float* __restrict__ gpl, const float* __restrict__ gps,
                                const float* __restrict__ gmx, const float* __restrict__ gpo,
                                float* __restrict__ crec, float* __restrict__ xrec,
                                float* __restrict__ dyrec, int N, int A, int E, int H, int D,
                                int C, int K, int R) {
  using namespace mrssm;
  extern __shared__ __align__(16) float smem[];
  const int S = C * K, X = A + S, G = 3 * D;
  const Layout L = layout(H, D, S);
  // The staging mbarrier, the weights ([in, out] at dims.off), their
  // torch-layout staging area, then the per-row buffers.
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* W = smem + 4;
  float* raw = W + round4(dims.total);
  int width[kNumRBufs];
  recompute_widths(A, E, H, D, S, width);
  float* buf[kNumRBufs];
  float* p = raw + raw_floats(dims);
  for (int i = 0; i < kNumRBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *xin = buf[kXin], *emb = buf[kEmb], *pdeter = buf[kPdeter], *deter = buf[kDeter];
  float *h1p = buf[kH1p], *h1 = buf[kH1], *x2 = buf[kX2], *gates = buf[kGates];
  float *hp = buf[kHp], *hid = buf[kHid], *lg = buf[kLg], *stat = buf[kStat];
  float *mixed = buf[kMixed], *pprob = buf[kPprob], *qprob = buf[kQprob];
  float *dlgp = buf[kDlgp], *dhidp = buf[kDhidp], *ddp = buf[kDdp];
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };

  chain::stage_weights_bulk(W, raw, w, dims, bar);
  const int n0 = blockIdx.x * R;  // first row-step (t·B + b) of this block
  const int rows = min(R, N - n0);
  for (int i = threadIdx.x; i < rows * X; i += blockDim.x) {
    const int r = i / X, j = i - r * X;
    const size_t n = (size_t)n0 + r;
    xin[i] = j < A ? actions[n * A + j] : prev_stoch[n * S + j - A];
  }
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, e = i - r * E;
    emb[r * 2 * E + e] = a_emb[(size_t)n0 * E + i];
    emb[r * 2 * E + E + e] = v_emb[(size_t)n0 * E + i];
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    pdeter[i] = deter[i] = prev_deter[(size_t)n0 * D + i];
  }
  __syncthreads();

  // The forward step, as the forward kernel computes it.
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

  // Both samples' block probs, and the prior sample's straight-through VJP
  // into the prior logits: it needs no carry.
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int o = r * S + c * K;
    const size_t g = ((size_t)n0 + r) * S + c * K;
    block_softmax(mixed + o, K, qprob + o);
    block_softmax(lg + r * 3 * S + c * K, K, pprob + o);
    st_vjp(pprob + o, gps + g, gpl + g, K, dlgp + o);
  }
  __syncthreads();
  // The prior head's transposes: d hidden, then its share of d deter.
  dense_rows_t(dlgp, S, Wp(10), H, S, dhidp, H, rows, hp, 3 * H, false);
  __syncthreads();
  dense_rows_t(dhidp, H, Wp(8), D, H, ddp, D, rows, nullptr, 0, false);
  __syncthreads();

  // The records.
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    const float* gi = gates + r * 2 * G;
    const float* gh = gi + G;
    const float rg = sigmoid(gi[d] + gh[d]);
    const float z = sigmoid(gi[D + d] + gh[D + d]);
    const float nn = tanhf(gi[2 * D + d] + rg * gh[2 * D + d]);
    c[L.gdb + d] = gd[n * D + d] + ddp[i];
    c[L.rg + d] = rg;
    c[L.z + d] = z;
    c[L.an + d] = (1.f - z) * (1.f - nn * nn);
    c[L.az + d] = (pdeter[i] - nn) * z * (1.f - z);
    c[L.ar + d] = gh[2 * D + d] * rg * (1.f - rg);
    xrec[n * L.xw + L.deter + d] = deter[i];
  }
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
    const int r = i / S, s = i - r * S;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    const float* st = stat + r * 4;
    const float la = (lg[r * 3 * S + S + s] - st[0]) - st[1];
    const float lv = (lg[r * 3 * S + 2 * S + s] - st[2]) - st[3];
    const float mx = mixed[i];
    const float wa = expf(la + kLogThird - mx);
    const float wv = expf(lv + kLogThird - mx);
    const float wf = expf(la + lv + kLogThird - mx);
    c[L.gmx + s] = gmx[n * S + s];
    c[L.gpo + s] = gpo[n * S + s];
    c[L.qprob + s] = qprob[i];
    c[L.ca + s] = wa + wf;
    c[L.cv + s] = wv + wf;
    c[L.ea + s] = expf(la);
    c[L.ev + s] = expf(lv);
    dyrec[n * L.dyw + L.dlg + s] = dlgp[i];
  }
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int r = i / H, h = i - r * H;
    const size_t n = (size_t)n0 + r;
    float* c = crec + n * L.cw;
    float* x = xrec + n * L.xw;
    c[L.dact_h1 + h] = d_elu(h1p[i]);
    c[L.dact_hp + h] = d_elu(hp[r * 3 * H + H + h]);
    c[L.dact_hp + H + h] = d_elu(hp[r * 3 * H + 2 * H + h]);
    x[L.h1 + h] = h1[i];
    x[L.x2 + h] = x2[i];
    for (int m = 0; m < 3; ++m) x[L.hid + m * H + h] = hid[r * 3 * H + m * H + h];
    dyrec[n * L.dyw + L.dhid + h] = dhidp[i];
  }
}

// ---- pass 2: the carry-only chain --------------------------------------------------

constexpr int kChainThreads = 256;

// The weight columns the chain reads, torch layout [out, in], staged in this
// order, each a block of columns [c0, c0 + nc) of its `out` rows at a padded
// row stride `ws`: W0's stoch columns, W2, W4, W6, W12's and W16's deter
// columns, W14, W18.
constexpr int kNC = 8;
using ChainWeights = chain::ChainWeights<kNC>;

ChainWeights chain_weights(const mrssm::WeightPtrs& w, const mrssm::WeightDims& dims, int A,
                           int D) {
  const int idx[kNC] = {0, 2, 4, 6, 12, 16, 14, 18};
  ChainWeights c;
  for (int i = 0; i < kNC; ++i) {
    const int k = idx[i];
    chain::chain_weight(c, i, w.p[k], dims.out[k], dims.in[k], i == 0 ? A : 0,
                        i == 0 ? dims.in[k] - A : i == 4 || i == 5 ? D : dims.in[k]);
  }
  return c;
}

// Per-row state of a chain block, each [R][width] floats after the weights
// and the two record buffers.
enum CBuf { kCs, kCd, kDmix, kDlgav, kDhidav, kGz, kCDgi, kCDgh, kCDx2, kCDh1, kNumCBufs };

__host__ __device__ inline void chain_widths(int H, int D, int S, int* w) {
  w[kCs] = S; w[kCd] = D; w[kDmix] = S; w[kDlgav] = 2 * S; w[kDhidav] = 2 * H; w[kGz] = D;
  w[kCDgi] = 3 * D; w[kCDgh] = 3 * D; w[kCDx2] = H; w[kCDh1] = H;
}

size_t chain_row_floats(int H, int D, int S) {
  int w[kNumCBufs];
  chain_widths(H, D, S, w);
  size_t n = 2 * (size_t)layout(H, D, S).cw;  // the two record buffers
  for (int i = 0; i < kNumCBufs; ++i) n += w[i];
  return n;
}

size_t chain_smem_bytes(const ChainWeights& cw, int H, int D, int S, int R) {
  return 32 + ((size_t)cw.total + R * chain_row_floats(H, D, S)) * sizeof(float);
}

__global__ void __launch_bounds__(kChainThreads)
recurrence_bwd_chain_kernel(const __grid_constant__ ChainWeights cw, const float* __restrict__ crec,
                            float* __restrict__ dyrec, float* __restrict__ d_init_deter,
                            float* __restrict__ d_init_stoch, int T, int B, int H, int D, int C,
                            int K, int R) {
  using namespace mrssm;
  extern __shared__ __align__(16) float smem[];
  const int S = C * K, G = 3 * D;
  const Layout L = layout(H, D, S);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // weights, rec 0, rec 1
  float* Wc = smem + 8;
  const float* W0s = Wc + cw.off[0];
  const float* W2 = Wc + cw.off[1];
  const float* W4 = Wc + cw.off[2];
  const float* W6 = Wc + cw.off[3];
  const float* W12d = Wc + cw.off[4];
  const float* W16d = Wc + cw.off[5];
  const float* W14 = Wc + cw.off[6];
  const float* W18 = Wc + cw.off[7];
  float* recbuf = Wc + cw.total;  // two buffers of R records
  int width[kNumCBufs];
  chain_widths(H, D, S, width);
  float* buf[kNumCBufs];
  float* p = recbuf + 2 * R * L.cw;
  for (int i = 0; i < kNumCBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *cs = buf[kCs], *cd = buf[kCd], *dmix = buf[kDmix], *dlg = buf[kDlgav];
  float *dhid = buf[kDhidav], *gz = buf[kGz], *dgi = buf[kCDgi], *dgh = buf[kCDgh];
  float *dx2 = buf[kCDx2], *dh1 = buf[kCDh1];

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
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) cd[i] = 0.f;
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) cs[i] = 0.f;
  // Each phase's split of its outputs over the block, fixed for all steps.
  const Split sB = make_split(rows, 2 * H), sC = make_split(rows, D);
  const Split sD = make_split(rows, H + D), sE = make_split(rows, H), sF = make_split(rows, S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int lane_block = lane - lane % K;  // the first logit of this lane's category block
  fconv::mbar_wait(&bar[0], 0);
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const float* rc = recbuf + (i & 1) * R * L.cw;
    fconv::mbar_wait(&bar[1 + (i & 1)], (i >> 1) & 1);
    const size_t base = (size_t)t * B + row0;  // first row-step of this tile

    // A. The posterior's straight-through VJP (output + carry) into the
    // mixed logits, a lane an element, each block's dot added in order; then
    // the fusion VJP into the audio and vision logits, the full-axis sums by
    // shuffles in a fixed order. A warp a row.
    for (int r = warp; r < rows; r += warps) {
      const float* c = rc + r * L.cw;
      float* dm = dmix + r * S;
      float* dl = dlg + r * 2 * S;
      const float* csr = cs + r * S;
      for (int s = lane; s < S; s += 32) dm[s] = c[L.qprob + s] * (c[L.gpo + s] + csr[s]);
      __syncwarp();
      float sa = 0.f, sv = 0.f;
      for (int s = lane, o = lane_block; s < S; s += 32, o = s - s % K) {
        float dot = 0.f;
        for (int j = 0; j < K; ++j) dot += dm[o + j];
        const float m = c[L.gmx + s] + c[L.qprob + s] * ((c[L.gpo + s] + csr[s]) - dot);
        dl[s] = m * c[L.ca + s];
        dl[S + s] = m * c[L.cv + s];
        sa += dl[s];
        sv += dl[S + s];
      }
      for (int m = 16; m > 0; m >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, m);
        sv += __shfl_xor_sync(0xffffffffu, sv, m);
      }
      float* y = dyrec + (base + r) * L.dyw + L.dlg;
      for (int s = lane; s < S; s += 32) {
        dl[s] -= c[L.ea + s] * sa;
        dl[S + s] -= c[L.ev + s] * sv;
        y[S + s] = dl[s];
        y[2 * S + s] = dl[S + s];
      }
    }
    __syncthreads();
    // B. The audio and vision heads' output layers transposed, times the
    // ELU derivative: d hidden.
    for_outputs(sB, rows, 2 * H, [&](int r, int j, bool valid) {
      const int m = j >= H, h = j - m * H;
      const float v = group_sum(dot_part(dlg + r * 2 * S + m * S, (m ? W18 : W14) + h, cw.ws[6 + m],
                                         S, sB), sB) * rc[r * L.cw + L.dact_hp + j];
      if (valid && sB.part == 0) {
        dhid[r * 2 * H + j] = v;
        dyrec[(base + r) * L.dyw + L.dhid + H + j] = v;
      }
    });
    __syncthreads();
    // C. d deter (output and prior head, carry, both heads) and the GRU VJP.
    for_outputs(sC, rows, D, [&](int r, int j, bool valid) {
      const float* dh = dhid + r * 2 * H;
      const float* c = rc + r * L.cw;
      const float heads = group_sum(dot_part(dh, W12d + j, cw.ws[4], H, sC) +
                                    dot_part(dh + H, W16d + j, cw.ws[5], H, sC), sC);
      const float g = (c[L.gdb + j] + cd[r * D + j]) + heads;
      const float dpn = g * c[L.an + j], dpz = g * c[L.az + j], dpr = dpn * c[L.ar + j];
      const float dgn = dpn * c[L.rg + j];
      if (valid && sC.part == 0) {
        float* gi = dgi + r * G;
        float* gh = dgh + r * G;
        gi[j] = gh[j] = dpr;
        gi[D + j] = gh[D + j] = dpz;
        gi[2 * D + j] = dpn;
        gh[2 * D + j] = dgn;
        gz[r * D + j] = g * c[L.z + j];
        float* y = dyrec + (base + r) * L.dyw;
        y[L.dgi + j] = y[L.dgh + j] = dpr;
        y[L.dgi + D + j] = y[L.dgh + D + j] = dpz;
        y[L.dgi + 2 * D + j] = dpn;
        y[L.dgh + 2 * D + j] = dgn;
      }
    });
    __syncthreads();
    // D. d x2 (GRU input gates transposed) and the deter carry (z·g plus the
    // hidden gates transposed).
    for_outputs(sD, rows, H + D, [&](int r, int j, bool valid) {
      const bool x2 = j < H;
      const float v = group_sum(x2 ? dot_part(dgi + r * G, W4 + j, cw.ws[2], G, sD)
                                   : dot_part(dgh + r * G, W6 + (j - H), cw.ws[3], G, sD), sD);
      if (valid && sD.part == 0) {
        if (x2) {
          dx2[r * H + j] = v;
          dyrec[(base + r) * L.dyw + L.dx2 + j] = v;
        } else {
          cd[r * D + j - H] = gz[r * D + j - H] + v;
        }
      }
    });
    __syncthreads();
    // E. d h1: the transition MLP's output layer transposed, times ELU'.
    for_outputs(sE, rows, H, [&](int r, int j, bool valid) {
      const float v = group_sum(dot_part(dx2 + r * H, W2 + j, cw.ws[1], H, sE), sE) *
                      rc[r * L.cw + L.dact_h1 + j];
      if (valid && sE.part == 0) {
        dh1[r * H + j] = v;
        dyrec[(base + r) * L.dyw + L.dh1 + j] = v;
      }
    });
    __syncthreads();
    // F. The stoch carry: d stoch from the transition MLP's first layer.
    for_outputs(sF, rows, S, [&](int r, int j, bool valid) {
      const float v = group_sum(dot_part(dh1 + r * H, W0s + j, cw.ws[0], H, sF), sF);
      if (valid && sF.part == 0) cs[r * S + j] = v;
    });
    __syncthreads();
    // Every read of this buffer is done: bring in the record two steps on.
    if (threadIdx.x == 0 && t >= 2) {
      fconv::bulk_load(recbuf + (i & 1) * R * L.cw, rec_src(t - 2), rec_bytes, &bar[1 + (i & 1)]);
    }
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) d_init_deter[row0 * D + i] = cd[i];
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) d_init_stoch[row0 * S + i] = cs[i];
}

// ---- pass 3: the deferred GEMMs --------------------------------------------------

// The ten dense layers' gradients over the records and the inputs, into
// d_weights (torch layout, back to back in kernel order), and the input
// cotangents that feed no carry: d actions (W0's action columns), d a_emb
// and d v_emb (W12's and W16's embedding columns).
mrssm::DenseGradTable dw_table(const mrssm::WeightPtrs& w, const mrssm::WeightDims& dims,
                               const Layout& L, const float* actions, const float* a_emb,
                               const float* v_emb, const float* prev_deter,
                               const float* prev_stoch, const float* xrec, const float* dyrec,
                               float* d_weights, float* d_actions, float* d_a_emb,
                               float* d_v_emb, int N, int A, int E, int H, int D, int S) {
  mrssm::DenseGradTable tb;
  mrssm::dense_grad_table_init(tb, dims.total);
  const int G = 3 * D, X = A + S, DE = D + E;
  auto layer = [&](int i, const float* x0, int n0, int s0, const float* x1, int n1, int s1,
                   int dy, int out) {
    mrssm::dense_grad_weight(tb, x0, n0, s0, x1, n1, s1, dyrec + dy, L.dyw, out, d_weights,
                             dims.off[i], dims.off[i + 1], N);
  };
  layer(0, actions, A, A, prev_stoch, S, S, L.dh1, H);
  layer(2, xrec + L.h1, H, L.xw, nullptr, 0, 0, L.dx2, H);
  layer(4, xrec + L.x2, H, L.xw, nullptr, 0, 0, L.dgi, G);
  layer(6, prev_deter, D, D, nullptr, 0, 0, L.dgh, G);
  layer(8, xrec + L.deter, D, L.xw, nullptr, 0, 0, L.dhid, H);
  layer(10, xrec + L.hid, H, L.xw, nullptr, 0, 0, L.dlg, S);
  layer(12, xrec + L.deter, D, L.xw, a_emb, E, E, L.dhid + H, H);
  layer(14, xrec + L.hid + H, H, L.xw, nullptr, 0, 0, L.dlg + S, S);
  layer(16, xrec + L.deter, D, L.xw, v_emb, E, E, L.dhid + 2 * H, H);
  layer(18, xrec + L.hid + 2 * H, H, L.xw, nullptr, 0, 0, L.dlg + 2 * S, S);
  mrssm::dense_grad_rows(tb, dyrec + L.dh1, L.dyw, H, w.p[0], X, 0, A, d_actions, N);
  mrssm::dense_grad_rows(tb, dyrec + L.dhid + H, L.dyw, H, w.p[12], DE, D, E, d_a_emb, N);
  mrssm::dense_grad_rows(tb, dyrec + L.dhid + 2 * H, L.dyw, H, w.p[16], DE, D, E, d_v_emb, N);
  return tb;
}

}  // namespace

// The backward's passes in `passes` (1: recompute, 2: chain, 4: the deferred
// GEMMs) on `s`, on the 20 weights `w` (torch layout, device pointers in the
// order of ops/kernels/recurrence.py): the body of both C entries that run
// them, mrssm_recurrence_backward below and mrssm_stacked_backward
// (recurrence_stacked_bwd.cu, on its packed copy of the stacked weights).
cudaError_t mrssm_recurrence_backward_passes(
    const mrssm::WeightPtrs& w, const float* actions, const float* a_emb, const float* v_emb,
    const float* prev_deter, const float* prev_stoch, const float* gd, const float* gpl,
    const float* gps, const float* gmx, const float* gpo, float* workspace, float* d_weights,
    float* d_actions, float* d_a_emb, float* d_v_emb, float* d_init_deter, float* d_init_stoch,
    int T, int B, int A, int E, int H, int D, int C, int K, int R, int passes, cudaStream_t s) {
  const int S = C * K, N = T * B;
  const mrssm::WeightDims dims = weight_dims(A, E, H, D, S);
  const Layout L = layout(H, D, S);
  float* crec = workspace;
  float* xrec = crec + (size_t)N * L.cw;
  float* dyrec = xrec + (size_t)N * L.xw;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    // About a block an SM: each stages the weights, then recomputes its rows.
    const int sms = std::max(chain::sm_count(), 1);
    const size_t fixed = 4 + round4(dims.total) + raw_floats(dims);
    const int R1 = mrssm::rows_that_fit(fixed, recompute_row_floats(A, E, H, D, S),
                                        std::max(1, std::min(32, (N + sms - 1) / sms)));
    if (R1 < 1) return cudaErrorInvalidValue;
    const size_t smem = (fixed + R1 * recompute_row_floats(A, E, H, D, S)) * sizeof(float);
    err = cudaFuncSetAttribute(recurrence_bwd_recompute_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    recurrence_bwd_recompute_kernel<<<(N + R1 - 1) / R1, mrssm::kThreads, smem, s>>>(
        w, dims, actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl, gps, gmx, gpo, crec,
        xrec, dyrec, N, A, E, H, D, C, K, R1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    const ChainWeights cw = chain_weights(w, dims, A, D);
    const size_t smem = chain_smem_bytes(cw, H, D, S, R);
    err = cudaFuncSetAttribute(recurrence_bwd_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    recurrence_bwd_chain_kernel<<<(B + R - 1) / R, kChainThreads, smem, s>>>(
        cw, crec, dyrec, d_init_deter, d_init_stoch, T, B, H, D, C, K, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 4) {
    const mrssm::DenseGradTable tb =
        dw_table(w, dims, L, actions, a_emb, v_emb, prev_deter, prev_stoch, xrec, dyrec,
                 d_weights, d_actions, d_a_emb, d_v_emb, N, A, E, H, D, S);
    float* partial = dyrec + (size_t)N * L.dyw;
    int* tickets = reinterpret_cast<int*>(partial + mrssm::dense_grad_partial_floats(tb));
    err = mrssm::dense_grads_launch(tb, partial, tickets, s);
  }
  return err;
}

extern "C" {

// The largest batch rows per chain block ≤ R_want whose shared memory fits
// one block on the current device (0 if none does).
int mrssm_recurrence_bwd_rows(int A, int E, int H, int D, int C, int K, int R_want) {
  const int S = C * K;
  const ChainWeights cw = chain_weights(mrssm::WeightPtrs{}, weight_dims(A, E, H, D, S), A, D);
  return mrssm::rows_that_fit(8 + cw.total, chain_row_floats(H, D, S), R_want);
}

// Floats of scratch a backward call needs at these sizes: the three records
// of every row-step, then the deferred GEMMs' partial sums and their
// tickets (ops/kernels/recurrence.py views the records).
long long mrssm_recurrence_bwd_workspace(int T, int B, int A, int E, int H, int D, int C, int K) {
  const int S = C * K, N = T * B;
  const Layout L = layout(H, D, S);
  const mrssm::DenseGradTable tb =
      dw_table(mrssm::WeightPtrs{}, weight_dims(A, E, H, D, S), L, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, N, A, E,
               H, D, S);
  return (long long)N * (L.cw + L.xw + L.dyw) + mrssm::dense_grad_partial_floats(tb) + tb.tiles;
}

// Launch on `stream` the passes in `passes` (1: recompute, 2: chain, 4: the
// deferred GEMMs; 7 for a backward call). `workspace` holds
// mrssm_recurrence_bwd_workspace floats: the records [N, cw], [N, xw],
// [N, dyw] (N = T·B), then the GEMMs' scratch. `weights` is a host array of
// 20 device pointers in the order of ops/kernels/recurrence.py; d_weights
// gets the 20 gradients in torch layout, back to back; R is the chain's
// batch rows a block. All tensors f32 and contiguous. Returns the
// cudaError_t of the launches (0 on success).
int mrssm_recurrence_backward(const void* const* weights, const float* actions, const float* a_emb,
                              const float* v_emb, const float* prev_deter, const float* prev_stoch,
                              const float* gd, const float* gpl, const float* gps,
                              const float* gmx, const float* gpo, float* workspace,
                              float* d_weights, float* d_actions, float* d_a_emb, float* d_v_emb,
                              float* d_init_deter, float* d_init_stoch, int T, int B, int A, int E,
                              int H, int D, int C, int K, int R, int passes, void* stream) {
  return (int)mrssm_recurrence_backward_passes(
      mrssm::weight_ptrs(weights, kNW), actions, a_emb, v_emb, prev_deter, prev_stoch, gd, gpl,
      gps, gmx, gpo, workspace, d_weights, d_actions, d_a_emb, d_v_emb, d_init_deter,
      d_init_stoch, T, B, A, E, H, D, C, K, R, passes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
