// MoPoE-MMTRSSM hierarchical recurrence, forward (observe, and the forward
// of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step_mt.py::_fwd_kernel and
// ::_fwd_kernel_chunked: for t = 0..T-1 it computes _mt_forward_step — the
// lower MTRNN on action ⊕ ls ⊕ hs (the previous posterior samples) → the
// l-prior MLP and its straight-through sample; the audio and vision heads on
// l_deter ⊕ embed → MoPoE fusion → the lower posterior sample; the higher
// MTRNN on the previous hs → the h-prior MLP and its sample; the h-posterior
// MLP on l_deter ⊕ h_deter → the higher posterior sample. Gumbel noise is an
// input ([T, B, ·] for each of the four sites).
//
// What bounds it: at the reference batch (B=8) a step is ~16,600
// multiply-adds a row, so the time is the latency of the step's dependent
// stages, not FLOPs or bytes. Only six carries make the loop sequential:
// both deters, both integrators and the two posterior samples. 44% of a
// step's multiply-adds feed none of them (both prior heads; the embedding
// columns of the audio and vision first layers; the action columns of the
// lower cell), so mt_recurrence_fwd_stages_kernel runs in three stages, one
// block of 256 threads per tile of batch rows (rows never interact), in one
// launch:
//
// 1. Prologue, over all T steps of the block's rows at once, a warp a
//    row-step on inputs staged by cp.async: the carry-free partial sums
//    action·wli[:, :A]ᵀ + bli, a_emb·wa1[:, LD:]ᵀ + ba1 and
//    v_emb·wv1[:, LD:]ᵀ + bv1, into a workspace [T, B, LD + 2R] in device
//    memory (shared memory does not grow with T).
// 2. The carry chain, three barrier phases a step: (a) both MTRNN cells; (b)
//    the audio, vision and h-posterior hidden layers, each output a dot split
//    over lanes and added by full-mask shuffles (chain_common.cuh); (c) a
//    warp a row and layer: its logits (a lane a logit), for the lower layer
//    the fusion's full-axis log-softmax and mixture, and the posterior's
//    straight-through sample (a lane an element, shuffles within a category
//    block). A step's partial sums and posterior noise arrive by cp.async
//    into one of two buffers while the step before computes, issued by the
//    warps that phase (c) leaves idle.
// 3. Epilogue, over all T steps at once, a warp a row-step in chunks of
//    row-steps: the l-prior and h-prior MLPs on the block's deter sequences
//    (which it wrote) and their straight-through samples.
//
// The 28 weights come in by the bulk copy in torch layout and are
// transposed in shared memory to [in, out] blocks (forward_chain.cuh): only
// the columns a stage reads, at a row stride that spreads a phase's lane
// groups over the banks. Outputs go straight to [T, B, ·] in device memory,
// so one kernel covers the TPU's single-block and time-chunked variants.
#include <algorithm>

#include "chain_common.cuh"
#include "forward_chain.cuh"
#include "mrssm_common.cuh"

namespace {

using chain::dot_part;
using chain::for_outputs;
using chain::group_sum;
using chain::make_split;
using chain::round4;
using chain::Split;
using mrssm::MTDims;

constexpr int kNW = 28;
constexpr int kThreads = 256;
constexpr int kChunkRows = 64;  // row-steps a prologue or epilogue chunk

// Input and output tensors, in ops/kernels/recurrence_mt.py order.
struct MTFwdIn {
  const float *actions, *a_emb, *v_emb;
  const float *hd0, *ld0, *hs0, *ls0, *hidh0, *hidl0;  // init6
  const float *g_lp, *g_l, *g_hp, *g_h;                // Gumbel, four sites
};
struct MTFwdOut {
  float *h_deter, *l_deter, *hid_h, *hid_l, *lp_logits, *lp_stoch, *mixed, *l_stoch,
      *hp_logits, *hp_stoch, *hq_logits, *h_stoch;
};

// Widths of one step's quantities: the partial sums a workspace row holds
// (PW: lower cell, audio, vision), the cells' sample input (XS: ls ⊕ hs),
// the chain's hidden layers (H3: audio, vision, h-posterior) and logits
// (G3).
struct Sizes {
  int A, E, HD, LD, C, R, lK, hK, LS, HS, PW, XS, H3, G3;
};

__host__ __device__ inline Sizes sizes(const MTDims& d) {
  Sizes z;
  z.A = d.A; z.E = d.E; z.HD = d.HD; z.LD = d.LD; z.C = d.C; z.R = d.R;
  z.lK = d.ls_cat; z.hK = d.hs_cat;
  z.LS = d.ls_class * d.ls_cat; z.HS = d.hs_class * d.hs_cat;
  z.PW = z.LD + 2 * z.R; z.XS = z.LS + z.HS; z.H3 = 2 * z.R + z.C; z.G3 = 2 * z.LS + z.HS;
  return z;
}

// The staged weight blocks: the chain's (both cells' deter and sample
// columns; the audio and vision first layers' l_deter columns, the
// h-posterior's first layer; the three output layers), the prologue's (the
// action and embedding columns), the epilogue's (both priors), then the 14
// biases. Phases (a) and (b) of a block of R rows read theirs at the strides
// of their splits; the rest, a lane an output, densely.
enum Staged { kWld, kWlx, kWhd, kWhx, kWad, kWvd, kWq1, kWa2, kWv2, kWq2, kWla, kWae, kWve, kWp1,
              kWp2, kWh1, kWh2, kBld, kBli, kBhd, kBhi, kBp1, kBp2, kBh1, kBh2, kBq1, kBq2, kBa1,
              kBa2, kBv1, kBv2, kNumStaged };
using FwdWeights = chain::StagedWeights<kNumStaged>;

FwdWeights fwd_weights(const mrssm::WeightDims& d, const Sizes& z, int R) {
  const int PA = chain::split_lanes(R, z.LD + z.HD, kThreads);
  const int PB = chain::split_lanes(R, z.H3, kThreads);
  FwdWeights s;
  auto at = [&](int i, int src, int c0, int nc, int P) {
    chain::staged_weight(s, d, i, src, c0, nc, P);
  };
  at(kWld, 0, 0, z.LD, PA);
  at(kWlx, 2, z.A, z.XS, PA);
  at(kWhd, 4, 0, z.HD, PA);
  at(kWhx, 6, 0, z.HS, PA);
  at(kWad, 20, 0, z.LD, PB);
  at(kWvd, 24, 0, z.LD, PB);
  at(kWq1, 16, 0, z.LD + z.HD, PB);
  at(kWa2, 22, 0, z.R, 1);
  at(kWv2, 26, 0, z.R, 1);
  at(kWq2, 18, 0, z.C, 1);
  at(kWla, 2, 0, z.A, 1);
  at(kWae, 20, z.LD, z.E, 1);
  at(kWve, 24, z.LD, z.E, 1);
  at(kWp1, 8, 0, z.LD, 1);
  at(kWp2, 10, 0, z.C, 1);
  at(kWh1, 12, 0, z.HD, 1);
  at(kWh2, 14, 0, z.C, 1);
  const int bias[] = {1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27};
  for (int i = kBld; i < kNumStaged; ++i) at(i, bias[i - kBld], 0, 1, 1);
  return s;
}

// Per-row state of the chain, each [R][width] floats (the double buffers
// [2][R][width / 2]): both deters (read one step, written the next), both
// integrators, the samples ls ⊕ hs, the hidden layers, the logits, the
// mixture, and the prefetched partial sums and posterior noise.
enum CBuf { kLd, kHd, kHl, kHh, kXs, kHid, kLg, kMix, kRec, kGl, kGh, kNumCBufs };

__host__ __device__ inline void chain_widths(const Sizes& z, int* w) {
  w[kLd] = 2 * z.LD; w[kHd] = 2 * z.HD; w[kHl] = z.LD; w[kHh] = z.HD; w[kXs] = z.XS;
  w[kHid] = z.H3; w[kLg] = z.G3; w[kMix] = z.LS; w[kRec] = 2 * z.PW; w[kGl] = 2 * z.LS;
  w[kGh] = 2 * z.HS;
}

// Floats a prologue row-step takes (its action and both embeddings) and an
// epilogue row-step (its deters, its prior noise, the priors' hidden layers
// and logits).
__host__ __device__ inline int pro_row_floats(const Sizes& z) { return z.A + 2 * z.E; }
__host__ __device__ inline int epi_row_floats(const Sizes& z) {
  return z.LD + z.HD + 2 * (z.LS + z.HS) + 2 * z.C;
}

// The region after the staged weights holds, in turn, the weights in torch
// layout, the prologue's chunks, the chain's rows, the epilogue's chunks.
size_t region_floats(const mrssm::WeightDims& d, const Sizes& z, int T, int R) {
  int w[kNumCBufs];
  chain_widths(z, w);
  size_t rows = 0;
  for (int i = 0; i < kNumCBufs; ++i) rows += w[i];
  const size_t chunk = (size_t)std::min(kChunkRows, T * R) *
                       std::max(pro_row_floats(z), epi_row_floats(z));
  return std::max({(size_t)chain::raw_floats(d), R * rows, chunk});
}

size_t smem_floats(const mrssm::WeightDims& d, const MTDims& m, int R) {
  const Sizes z = sizes(m);
  return 4 + round4(fwd_weights(d, z, R).total) + region_floats(d, z, m.T, R);
}

__global__ void __launch_bounds__(kThreads)
mt_recurrence_fwd_stages_kernel(const __grid_constant__ FwdWeights sw,
                                const __grid_constant__ mrssm::WeightPtrs w,
                                const __grid_constant__ mrssm::WeightDims dims, MTFwdIn in,
                                MTFwdOut out, float* __restrict__ wsp, MTDims d, int stages) {
  extern __shared__ __align__(16) float smem[];
  const Sizes z = sizes(d);
  const int A = z.A, E = z.E, HD = z.HD, LD = z.LD, C = z.C, RH = z.R, LS = z.LS, HS = z.HS;
  const int PW = z.PW, XS = z.XS, H3 = z.H3, G3 = z.G3, B = d.B, T = d.T;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* Wt = smem + 4;
  float* region = Wt + round4(sw.total);
  auto Wp = [&](int i) -> const float* { return Wt + sw.off[i]; };
  auto ws = [&](int i) { return sw.ws[i]; };
  // Output o of staged block i on a's n floats, on one lane; two such (i, o
  // on a, n; i2, o2 on b, m) in one loop.
  auto dot = [&](const float* a, int i, int o, int n) {
    return chain::dot_lane(a, Wp(i) + o, ws(i), n);
  };
  auto dot2 = [&](const float* a, int i, int o, int n, const float* b, int i2, int o2, int m,
                  float& x, float& y) {
    chain::dot2_lane(a, Wp(i) + o, ws(i), n, b, Wp(i2) + o2, ws(i2), m, x, y);
  };
  const int R = d.rows, row0 = blockIdx.x * R, rows = min(R, B - row0);
  const int N = T * rows;  // this block's row-steps, q = t·rows + r
  auto step_row = [&](int q) {
    const int t = q / rows;
    return (size_t)t * B + row0 + (q - t * rows);
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int QC = min(kChunkRows, T * R);

  chain::stage_raw(region, w, dims, bar);
  chain::stage_transposed(sw, region, Wt);
  __syncthreads();

  // 1. The prologue: every step's partial sums that need no carry, a warp a
  // row-step, its action and embeddings staged first.
  if (stages & 1) {
    const int XW = A + 2 * E;
    float* xin = region;  // [QC][A + 2E]
    for (int q0 = 0; q0 < N; q0 += QC) {
      const int nq = min(QC, N - q0);
      for (int i = threadIdx.x; i < nq * XW; i += blockDim.x) {
        const int q = i / XW, c = i - q * XW;
        const size_t n = step_row(q0 + q);
        fconv::cp_async4(xin + i, c < A       ? in.actions + n * A + c
                                  : c < A + E ? in.a_emb + n * E + c - A
                                              : in.v_emb + n * E + c - A - E);
      }
      fconv::cp_async_commit();
      fconv::cp_async_wait<0>();
      __syncthreads();
      for (int q = warp; q < nq; q += warps) {
        const float* x = xin + q * XW;
        float* y = wsp + step_row(q0 + q) * PW;
        for (int j = lane; j < LD; j += 32) y[j] = dot(x, kWla, j, A) + Wp(kBli)[j];
        for (int j = lane; j < RH; j += 32) {
          float a, v;
          dot2(x + A, kWae, j, E, x + A + E, kWve, j, E, a, v);
          y[LD + j] = a + Wp(kBa1)[j];
          y[LD + RH + j] = v + Wp(kBv1)[j];
        }
      }
      __syncthreads();
    }
  }

  // 2. The carry chain.
  int width[kNumCBufs];
  chain_widths(z, width);
  float* buf[kNumCBufs];
  float* p = region;
  for (int i = 0; i < kNumCBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *ld = buf[kLd], *hd = buf[kHd], *hidl = buf[kHl], *hidh = buf[kHh], *xs = buf[kXs];
  float *hid = buf[kHid], *lg = buf[kLg], *mix = buf[kMix];
  if (stages & 2) {
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      ld[i] = in.ld0[row0 * LD + i];
      hidl[i] = in.hidl0[row0 * LD + i];
    }
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      hd[i] = in.hd0[row0 * HD + i];
      hidh[i] = in.hidh0[row0 * HD + i];
    }
    for (int i = threadIdx.x; i < rows * XS; i += blockDim.x) {
      const int r = i / XS, s = i - r * XS;
      xs[i] = s < LS ? in.ls0[(row0 + r) * LS + s] : in.hs0[(row0 + r) * HS + s - LS];
    }
    // A step's partial sums and posterior noise, into buffer t & 1, over the
    // threads from `first` on.
    auto prefetch = [&](int t, int first) {
      const size_t base = (size_t)t * B + row0;
      const int b = t & 1;
      chain::copy_async(buf[kRec] + b * R * PW, wsp + base * PW, rows * PW, first);
      chain::copy_async(buf[kGl] + b * R * LS, in.g_l + base * LS, rows * LS, first);
      chain::copy_async(buf[kGh] + b * R * HS, in.g_h + base * HS, rows * HS, first);
      fconv::cp_async_commit();
    };
    // Phase (c) takes a warp a row and layer; the warps it leaves idle bring
    // in the next step (where none is idle, every thread, at the step's start).
    const int busy = min(2 * rows, warps);
    const bool early = busy == warps;
    __syncthreads();  // the prologue's sums are in device memory
    prefetch(0, 0);
    // Phases (a) and (b)'s splits of their outputs over the block, fixed for
    // all steps.
    const Split sA = make_split(rows, LD + HD), sB = make_split(rows, H3);
    fconv::cp_async_wait<0>();
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const int cur = t & 1, nxt = cur ^ 1;
      const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
      const float* rec = buf[kRec] + cur * R * PW;
      if (early && t + 1 < T) prefetch(t + 1, 0);
      const float* ldc = ld + cur * R * LD;
      const float* hdc = hd + cur * R * HD;
      float* ldn = ld + nxt * R * LD;
      float* hdn = hd + nxt * R * HD;

      // (a) Both MTRNN cells, JAX mtrnn_apply's association: u = (d·Wd + bd)
      // + (x·Wi + bi), the lower cell's x·Wi + bi being the sample columns'
      // dot plus the prologue's action sum.
      for_outputs(sA, rows, LD + HD, [&](int r, int j, bool valid) {
        const bool lower = j < LD;
        const int k = lower ? j : j - LD;
        const float* x = xs + r * XS;
        const float pd = lower ? dot_part(ldc + r * LD, Wp(kWld) + k, ws(kWld), LD, sA)
                               : dot_part(hdc + r * HD, Wp(kWhd) + k, ws(kWhd), HD, sA);
        const float px = lower ? dot_part(x, Wp(kWlx) + k, ws(kWlx), XS, sA)
                               : dot_part(x + LS, Wp(kWhx) + k, ws(kWhx), HS, sA);
        const float sd = group_sum(pd, sA), sx = group_sum(px, sA);
        if (valid && sA.part == 0) {
          if (lower) {
            const float u = (sd + Wp(kBld)[k]) + (sx + rec[r * PW + k]);
            const float h = d.l_keep * hidl[r * LD + k] + u * d.l_inv;
            const float v = tanhf(h);
            hidl[r * LD + k] = h;
            ldn[r * LD + k] = v;
            out.l_deter[(base + r) * LD + k] = v;
            out.hid_l[(base + r) * LD + k] = h;
          } else {
            const float u = (sd + Wp(kBhd)[k]) + (sx + Wp(kBhi)[k]);
            const float h = d.h_keep * hidh[r * HD + k] + u * d.h_inv;
            const float v = tanhf(h);
            hidh[r * HD + k] = h;
            hdn[r * HD + k] = v;
            out.h_deter[(base + r) * HD + k] = v;
            out.hid_h[(base + r) * HD + k] = h;
          }
        }
      });
      __syncthreads();
      // (b) The audio and vision hidden layers (l_deter columns plus the
      // prologue's embedding sums) and the h-posterior's, ELU.
      for_outputs(sB, rows, H3, [&](int r, int j, bool valid) {
        float part;
        if (j < 2 * RH) {
          const int m = j >= RH;
          part = dot_part(ldn + r * LD, Wp(m ? kWvd : kWad) + j - m * RH, ws(m ? kWvd : kWad), LD,
                          sB);
        } else {
          const float* W = Wp(kWq1) + j - 2 * RH;
          part = dot_part(ldn + r * LD, W, ws(kWq1), LD, sB) +
                 dot_part(hdn + r * HD, W + LD * ws(kWq1), ws(kWq1), HD, sB);
        }
        const float sum = group_sum(part, sB);
        if (valid && sB.part == 0) {
          const float b = j < 2 * RH ? rec[r * PW + LD + j] : Wp(kBq1)[j - 2 * RH];
          hid[r * H3 + j] = mrssm::elu(sum + b);
        }
      });
      __syncthreads();
      // (c) A warp a row and layer (even tasks the lower, odd the higher):
      // the layer's logits, the lower's fusion, the posterior sample, the
      // next step's ls or hs.
      if (!early && warp >= busy && t + 1 < T) prefetch(t + 1, busy * 32);
      for (int task = warp; task < 2 * rows; task += warps) {
        const int r = task >> 1;
        const size_t n = base + r;
        const float* h = hid + r * H3;
        float* l = lg + r * G3;
        if ((task & 1) == 0) {
          for (int j = lane; j < LS; j += 32) {
            float a, v;
            dot2(h, kWa2, j, RH, h + RH, kWv2, j, RH, a, v);
            l[j] = a + Wp(kBa2)[j];
            l[LS + j] = v + Wp(kBv2)[j];
          }
          __syncwarp();
          chain::mopoe_warp(l, l + LS, LS, mix + r * LS, out.mixed + n * LS);
          __syncwarp();
          chain::st_lanes(mix + r * LS, buf[kGl] + cur * R * LS + r * LS, d.ls_class, z.lK,
                          xs + r * XS, out.l_stoch + n * LS);
        } else {
          for (int j = lane; j < HS; j += 32) {
            const float v = dot(h + 2 * RH, kWq2, j, C) + Wp(kBq2)[j];
            l[2 * LS + j] = v;
            out.hq_logits[n * HS + j] = v;
          }
          __syncwarp();
          chain::st_lanes(l + 2 * LS, buf[kGh] + cur * R * HS + r * HS, d.hs_class, z.hK,
                          xs + r * XS + LS, out.h_stoch + n * HS);
        }
      }
      fconv::cp_async_wait<0>();
      __syncthreads();
    }
  }

  // 3. The epilogue: both priors over all T steps, a warp a row-step, in
  // chunks of row-steps.
  if (stages & 4) {
    const int DW = LD + HD, GW = LS + HS;
    float* xq = region;           // [QC][LD + HD] the deters
    float* gp = xq + QC * DW;     // [QC][LS + HS] the prior noise
    float* hp = gp + QC * GW;     // [QC][2C]      the priors' hidden layers
    float* lp = hp + QC * 2 * C;  // [QC][LS + HS] their logits
    __syncthreads();  // the chain's deters are in device memory, its rows done
    for (int q0 = 0; q0 < N; q0 += QC) {
      const int nq = min(QC, N - q0);
      for (int i = threadIdx.x; i < nq * DW; i += blockDim.x) {
        const int q = i / DW, c = i - q * DW;
        const size_t n = step_row(q0 + q);
        fconv::cp_async4(xq + i, c < LD ? out.l_deter + n * LD + c : out.h_deter + n * HD + c - LD);
      }
      for (int i = threadIdx.x; i < nq * GW; i += blockDim.x) {
        const int q = i / GW, c = i - q * GW;
        const size_t n = step_row(q0 + q);
        fconv::cp_async4(gp + i, c < LS ? in.g_lp + n * LS + c : in.g_hp + n * HS + c - LS);
      }
      fconv::cp_async_commit();
      fconv::cp_async_wait<0>();
      __syncthreads();
      for (int q = warp; q < nq; q += warps) {
        const size_t n = step_row(q0 + q);
        const float* x = xq + q * DW;
        float* h = hp + q * 2 * C;
        float* l = lp + q * GW;
        for (int j = lane; j < C; j += 32) {
          float a, b;
          dot2(x, kWp1, j, LD, x + LD, kWh1, j, HD, a, b);
          h[j] = mrssm::elu(a + Wp(kBp1)[j]);
          h[C + j] = mrssm::elu(b + Wp(kBh1)[j]);
        }
        __syncwarp();
        // A lane's l-prior logit j and h-prior logit j in one loop (only the
        // wider latent's past the narrower's width).
        for (int j = lane; j < max(LS, HS); j += 32) {
          float a, b;
          dot2(h, kWp2, min(j, LS - 1), C, h + C, kWh2, min(j, HS - 1), C, a, b);
          if (j < LS) l[j] = out.lp_logits[n * LS + j] = a + Wp(kBp2)[j];
          if (j < HS) l[LS + j] = out.hp_logits[n * HS + j] = b + Wp(kBh2)[j];
        }
        __syncwarp();
        chain::st_lanes(l, gp + q * GW, d.ls_class, z.lK, nullptr, out.lp_stoch + n * LS);
        chain::st_lanes(l + LS, gp + q * GW + LS, d.hs_class, z.hK, nullptr,
                        out.hp_stoch + n * HS);
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// The largest batch rows per block ≤ R_want whose shared memory fits one
// block on the current device (0 if none does).
int mt_recurrence_fwd_rows(MTDims d, int R_want) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  for (int R = R_want; R >= 1; --R) {
    if (smem_floats(dims, d, R) * sizeof(float) <= (size_t)limit) return R;
  }
  return 0;
}

// Launch on `stream` the stages in `stages` (1: the prologue, 2: the chain,
// 4: the epilogue; 7 for a forward call). `weights` is a host array of the
// 28 device pointers, `ins` of the 13 inputs (actions, a_emb, v_emb, init6,
// the four Gumbel tensors) and `outs` of the 12 outputs, in the order of
// ops/kernels/recurrence_mt.py; `workspace` holds the prologue's partial
// sums, [T, B, LD + 2R] floats; d.rows is the batch rows a block
// (mt_recurrence_fwd_rows). All tensors f32 and contiguous. Returns the
// cudaError_t of the launch (0 on success).
int mt_recurrence_forward(const void* const* weights, const void* const* ins,
                          void* const* outs, void* workspace, MTDims d, int stages,
                          void* stream) {
  if (d.rows < 1) return (int)cudaErrorInvalidValue;
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, kNW);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  float* const* y = reinterpret_cast<float* const*>(outs);
  const MTFwdIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8], x[9], x[10], x[11], x[12]};
  const MTFwdOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7], y[8], y[9], y[10], y[11]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const FwdWeights sw = fwd_weights(dims, sizes(d), d.rows);
  const size_t smem = smem_floats(dims, d, d.rows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mt_recurrence_fwd_stages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.B + d.rows - 1) / d.rows;
  mt_recurrence_fwd_stages_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sw, w, dims, in, out, static_cast<float*>(workspace), d, stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
