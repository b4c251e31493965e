// MoPoE-MRSSM representation recurrence, forward (the observe path, and the
// forward of a train step).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/train_step.py::_fwd_kernel and
// ::_fwd_kernel_chunked: for t = 0..T-1 it computes _forward_step — the
// transition MLP on action ⊕ stoch (the previous posterior sample) → GRU →
// the prior MLP and its straight-through sample; the audio and vision
// posterior MLPs on deter ⊕ embed → MoPoE fusion → the posterior
// straight-through sample, the next step's stoch. Gumbel noise is an input
// ([T, B, S] for each of the two sites).
//
// What bounds it: at the reference batch (B=8) a step is ~16,600
// multiply-adds a row, so the time is the latency of the step's dependent
// stages, not FLOPs or bytes. Only two carries make the loop sequential:
// deter and the posterior sample. 35% of a step's multiply-adds feed
// neither (the action columns of the transition's first layer, the
// embedding columns of the audio and vision first layers, the prior MLP),
// so recurrence_fwd_stages_kernel runs in three stages, one block of 256
// threads per tile of batch rows (rows never interact), in one launch:
//
// 1. Prologue, over all T steps of the block's rows at once, a warp a
//    row-step on inputs staged by cp.async: the carry-free partial sums
//    action·w1[:, :A]ᵀ + b1, a_emb·wa1[:, D:]ᵀ + ba1 and v_emb·wv1[:, D:]ᵀ +
//    bv1, into a workspace [T, B, 3H] in device memory (shared memory does
//    not grow with T).
// 2. The carry chain, five barrier phases a step, each output a dot split
//    over lanes and added by full-mask shuffles (chain_common.cuh): (a) the
//    transition's first layer on the stoch carry plus the prologue's sum,
//    beside the GRU's hidden gates on the deter carry (both read only the
//    step's incoming carries); (b) the transition's second layer; (c) the
//    GRU's input gates, a lane group taking the three gates of one deter
//    unit, and the GRU update of that unit; (d) the audio and vision hidden
//    layers on the new deter plus the prologue's embedding sums; (e) a warp
//    a row: both heads' logits (a lane a logit), the fusion's full-axis
//    log-softmax and mixture, and the posterior's straight-through sample (a
//    lane an element), the next step's stoch. A step's prologue sums and
//    posterior noise arrive by cp.async into one of two buffers while the
//    step before computes, issued by the warps that phase (e) leaves idle.
// 3. Epilogue, over all T steps at once, a warp a row-step in chunks of
//    row-steps: the prior MLP on the block's deter sequence (which it wrote)
//    and its straight-through sample.
//
// The 20 weights come in by the bulk copy in torch layout and are
// transposed in shared memory to [in, out] blocks (forward_chain.cuh): only
// the columns a stage reads, at a row stride that spreads a phase's lane
// groups over the banks. Outputs go straight to [T, B, ·] in device memory,
// so one kernel covers the TPU's single-block and time-chunked variants.
// recurrence_stacked_fwd.cu runs the same kernel on the stacked weights'
// packed blocks (mrssm_recurrence_forward_stages).
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

constexpr int kNW = 20;
constexpr int kThreads = 256;
constexpr int kChunkRows = 64;  // row-steps a prologue or epilogue chunk

// Input and output tensors, in ops/kernels/recurrence.py order.
struct FwdIn {
  const float *actions, *a_emb, *v_emb, *init_deter, *init_stoch, *g_prior, *g_post;
};
struct FwdOut {
  float *deter, *prior_logits, *prior_stoch, *mixed, *post_stoch;
};

// The kernel's sizes: action A, embed E, hidden H, deter D, C classes of K
// categories, T steps, B batch rows, `rows` batch rows a block.
struct Dims {
  int T, B, A, E, H, D, C, K, rows;
};

mrssm::WeightDims weight_dims(const Dims& d) {
  const int S = d.C * d.K, X = d.A + S, G = 3 * d.D, DE = d.D + d.E, H = d.H, D = d.D;
  const int in[kNW] = {X, 1, H, 1, H, 1, D, 1, D, 1, H, 1, DE, 1, H, 1, DE, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S, H, H, S, S, H, H, S, S};
  return mrssm::weight_dims(in, out, kNW);
}

// The staged weight blocks: the chain's (the transition's first layer's
// stoch columns, whh, w2, wih, the audio and vision first layers' deter
// columns, both heads' output layers), the prologue's (the action and
// embedding columns), the epilogue's (the prior MLP), then the 10 biases.
// Phases (a)-(d) of a block of R rows read theirs at the strides of their
// splits; the rest, a lane an output, densely.
enum Staged { kW1s, kWhh, kW2, kWih, kWad, kWvd, kWa2, kWv2, kW1a, kWae, kWve, kWp1, kWp2, kB1,
              kB2, kBih, kBhh, kBp1, kBp2, kBa1, kBa2, kBv1, kBv2, kNumStaged };
using FwdWeights = chain::StagedWeights<kNumStaged>;

FwdWeights fwd_weights(const mrssm::WeightDims& w, const Dims& d) {
  const int R = d.rows, S = d.C * d.K;
  const int PA = chain::split_lanes(R, d.H + 3 * d.D, kThreads);
  const int PB = chain::split_lanes(R, d.H, kThreads);
  const int PC = chain::split_lanes(R, d.D, kThreads);
  const int PD = chain::split_lanes(R, 2 * d.H, kThreads);
  FwdWeights s;
  auto at = [&](int i, int src, int c0, int nc, int P) {
    chain::staged_weight(s, w, i, src, c0, nc, P);
  };
  at(kW1s, 0, d.A, S, PA);
  at(kWhh, 6, 0, d.D, PA);
  at(kW2, 2, 0, d.H, PB);
  at(kWih, 4, 0, d.H, PC);
  at(kWad, 12, 0, d.D, PD);
  at(kWvd, 16, 0, d.D, PD);
  at(kWa2, 14, 0, d.H, 1);
  at(kWv2, 18, 0, d.H, 1);
  at(kW1a, 0, 0, d.A, 1);
  at(kWae, 12, d.D, d.E, 1);
  at(kWve, 16, d.D, d.E, 1);
  at(kWp1, 8, 0, d.D, 1);
  at(kWp2, 10, 0, d.H, 1);
  const int bias[] = {1, 3, 5, 7, 9, 11, 13, 15, 17, 19};
  for (int i = kB1; i < kNumStaged; ++i) at(i, bias[i - kB1], 0, 1, 1);
  return s;
}

// Per-row state of the chain, each [R][width] floats (the double buffers
// [2][R][width / 2]): the stoch and deter carries, the transition's hidden
// layers h1 and x2, the GRU's hidden gates gh, the heads' hidden layers and
// logits, the mixture, and the prefetched prologue sums and posterior noise.
enum CBuf { kStoch, kDeter, kH1, kX2, kGh, kHid, kLg, kMix, kRec, kGq, kNumCBufs };

__host__ __device__ inline void chain_widths(const Dims& d, int* w) {
  const int S = d.C * d.K;
  w[kStoch] = S; w[kDeter] = d.D; w[kH1] = d.H; w[kX2] = d.H; w[kGh] = 3 * d.D;
  w[kHid] = 2 * d.H; w[kLg] = 2 * S; w[kMix] = S; w[kRec] = 6 * d.H; w[kGq] = 2 * S;
}

// Floats a prologue row-step takes (its action and both embeddings) and an
// epilogue row-step (its deter, its prior noise, the prior's hidden layer
// and logits).
__host__ __device__ inline int pro_row_floats(const Dims& d) { return d.A + 2 * d.E; }
__host__ __device__ inline int epi_row_floats(const Dims& d) {
  return d.D + 2 * d.C * d.K + d.H;
}

// The region after the staged weights holds, in turn, the weights in torch
// layout, the prologue's chunks, the chain's rows, the epilogue's chunks.
size_t region_floats(const mrssm::WeightDims& w, const Dims& d) {
  int width[kNumCBufs];
  chain_widths(d, width);
  size_t rows = 0;
  for (int i = 0; i < kNumCBufs; ++i) rows += width[i];
  const size_t chunk = (size_t)std::min(kChunkRows, d.T * d.rows) *
                       std::max(pro_row_floats(d), epi_row_floats(d));
  return std::max({(size_t)chain::raw_floats(w), d.rows * rows, chunk});
}

size_t smem_floats(const Dims& d) {
  const mrssm::WeightDims w = weight_dims(d);
  return 4 + round4(fwd_weights(w, d).total) + region_floats(w, d);
}

__global__ void __launch_bounds__(kThreads)
recurrence_fwd_stages_kernel(const __grid_constant__ FwdWeights sw,
                             const __grid_constant__ mrssm::WeightPtrs w,
                             const __grid_constant__ mrssm::WeightDims dims, FwdIn in,
                             FwdOut out, float* __restrict__ wsp, Dims d, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int A = d.A, E = d.E, H = d.H, D = d.D, S = d.C * d.K, G = 3 * D, PW = 3 * H;
  const int B = d.B, T = d.T;
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
        for (int j = lane; j < H; j += 32) {
          float a, v;
          dot2(x + A, kWae, j, E, x + A + E, kWve, j, E, a, v);
          y[j] = dot(x, kW1a, j, A) + Wp(kB1)[j];
          y[H + j] = a + Wp(kBa1)[j];
          y[2 * H + j] = v + Wp(kBv1)[j];
        }
      }
      __syncthreads();
    }
  }

  // 2. The carry chain.
  int width[kNumCBufs];
  chain_widths(d, width);
  float* buf[kNumCBufs];
  float* p = region;
  for (int i = 0; i < kNumCBufs; ++i) {
    buf[i] = p;
    p += R * width[i];
  }
  float *stoch = buf[kStoch], *deter = buf[kDeter], *h1 = buf[kH1], *x2 = buf[kX2];
  float *gh = buf[kGh], *hid = buf[kHid], *lg = buf[kLg], *mix = buf[kMix];
  if (stages & 2) {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter[i] = in.init_deter[row0 * D + i];
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) stoch[i] = in.init_stoch[row0 * S + i];
    // A step's prologue sums and posterior noise, into buffer t & 1, over
    // the threads from `first` on.
    auto prefetch = [&](int t, int first) {
      const size_t base = (size_t)t * B + row0;
      const int b = t & 1;
      chain::copy_async(buf[kRec] + b * R * PW, wsp + base * PW, rows * PW, first);
      chain::copy_async(buf[kGq] + b * R * S, in.g_post + base * S, rows * S, first);
      fconv::cp_async_commit();
    };
    // Phase (e) takes a warp a row; the warps it leaves idle bring in the
    // next step (where none is idle, every thread, at the step's start).
    const int busy = min(rows, warps);
    const bool early = busy == warps;
    __syncthreads();  // the prologue's sums are in device memory
    prefetch(0, 0);
    // Phases (a)-(d)'s splits of their outputs over the block, fixed for all
    // steps.
    const Split sA = make_split(rows, H + G), sB = make_split(rows, H);
    const Split sC = make_split(rows, D), sD = make_split(rows, 2 * H);
    fconv::cp_async_wait<0>();
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const int cur = t & 1;
      const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
      const float* rec = buf[kRec] + cur * R * PW;
      if (early && t + 1 < T) prefetch(t + 1, 0);

      // (a) h1 = elu(stoch·w1[:, A:]ᵀ + the prologue's sum) and the GRU's
      // hidden gates gh = deter·whhᵀ + bhh: both on the incoming carries.
      for_outputs(sA, rows, H + G, [&](int r, int j, bool valid) {
        const bool first = j < H;
        const float part = first ? dot_part(stoch + r * S, Wp(kW1s) + j, ws(kW1s), S, sA)
                                 : dot_part(deter + r * D, Wp(kWhh) + j - H, ws(kWhh), D, sA);
        const float sum = group_sum(part, sA);
        if (valid && sA.part == 0) {
          if (first) h1[r * H + j] = mrssm::elu(sum + rec[r * PW + j]);
          else gh[r * G + j - H] = sum + Wp(kBhh)[j - H];
        }
      });
      __syncthreads();
      // (b) x2 = h1·w2ᵀ + b2.
      for_outputs(sB, rows, H, [&](int r, int j, bool valid) {
        const float sum = group_sum(dot_part(h1 + r * H, Wp(kW2) + j, ws(kW2), H, sB), sB);
        if (valid && sB.part == 0) x2[r * H + j] = sum + Wp(kB2)[j];
      });
      __syncthreads();
      // (c) The GRU's input gates of deter unit j (r, z, n: gi = x2·wihᵀ +
      // bih) and its update, gate order r, z, n (torch nn.GRUCell; the
      // arithmetic of mrssm::gru_rows).
      for_outputs(sC, rows, D, [&](int r, int j, bool valid) {
        const float* x = x2 + r * H;
        const float* Wg = Wp(kWih) + j;
        const float ir = group_sum(dot_part(x, Wg, ws(kWih), H, sC), sC);
        const float iz = group_sum(dot_part(x, Wg + D, ws(kWih), H, sC), sC);
        const float in_ = group_sum(dot_part(x, Wg + 2 * D, ws(kWih), H, sC), sC);
        if (valid && sC.part == 0) {
          const float* g = gh + r * G;
          const float* bi = Wp(kBih);
          const float rg = mrssm::sigmoid((ir + bi[j]) + g[j]);
          const float z = mrssm::sigmoid((iz + bi[D + j]) + g[D + j]);
          const float n = tanhf((in_ + bi[2 * D + j]) + rg * g[2 * D + j]);
          const float v = (1.f - z) * n + z * deter[r * D + j];
          deter[r * D + j] = v;
          out.deter[(base + r) * D + j] = v;
        }
      });
      __syncthreads();
      // (d) The audio and vision hidden layers: deter·w[:, :D]ᵀ plus the
      // prologue's embedding sums, ELU.
      for_outputs(sD, rows, 2 * H, [&](int r, int j, bool valid) {
        const int m = j >= H;
        const float sum = group_sum(dot_part(deter + r * D, Wp(m ? kWvd : kWad) + j - m * H,
                                             ws(m ? kWvd : kWad), D, sD), sD);
        if (valid && sD.part == 0) hid[r * 2 * H + j] = mrssm::elu(sum + rec[r * PW + H + j]);
      });
      __syncthreads();
      // (e) A warp a row: both heads' logits, the fusion, the posterior
      // sample (the next step's stoch).
      if (!early && warp >= busy && t + 1 < T) prefetch(t + 1, busy * 32);
      for (int r = warp; r < rows; r += warps) {
        const size_t n = base + r;
        const float* h = hid + r * 2 * H;
        float* l = lg + r * 2 * S;
        for (int j = lane; j < S; j += 32) {
          float a, v;
          dot2(h, kWa2, j, H, h + H, kWv2, j, H, a, v);
          l[j] = a + Wp(kBa2)[j];
          l[S + j] = v + Wp(kBv2)[j];
        }
        __syncwarp();
        chain::mopoe_warp(l, l + S, S, mix + r * S, out.mixed + n * S);
        __syncwarp();
        chain::st_lanes(mix + r * S, buf[kGq] + cur * R * S + r * S, d.C, d.K, stoch + r * S,
                        out.post_stoch + n * S);
      }
      fconv::cp_async_wait<0>();
      __syncthreads();
    }
  }

  // 3. The epilogue: the prior MLP over all T steps, a warp a row-step, in
  // chunks of row-steps.
  if (stages & 4) {
    float* xq = region;        // [QC][D] the deters
    float* gp = xq + QC * D;   // [QC][S] the prior noise
    float* hp = gp + QC * S;   // [QC][H] the prior's hidden layer
    float* lp = hp + QC * H;   // [QC][S] its logits
    __syncthreads();  // the chain's deters are in device memory, its rows done
    for (int q0 = 0; q0 < N; q0 += QC) {
      const int nq = min(QC, N - q0);
      for (int i = threadIdx.x; i < nq * D; i += blockDim.x) {
        const int q = i / D;
        fconv::cp_async4(xq + i, out.deter + step_row(q0 + q) * D + i - q * D);
      }
      for (int i = threadIdx.x; i < nq * S; i += blockDim.x) {
        const int q = i / S;
        fconv::cp_async4(gp + i, in.g_prior + step_row(q0 + q) * S + i - q * S);
      }
      fconv::cp_async_commit();
      fconv::cp_async_wait<0>();
      __syncthreads();
      for (int q = warp; q < nq; q += warps) {
        const size_t n = step_row(q0 + q);
        float* h = hp + q * H;
        float* l = lp + q * S;
        for (int j = lane; j < H; j += 32) {
          h[j] = mrssm::elu(dot(xq + q * D, kWp1, j, D) + Wp(kBp1)[j]);
        }
        __syncwarp();
        for (int j = lane; j < S; j += 32) {
          l[j] = out.prior_logits[n * S + j] = dot(h, kWp2, j, H) + Wp(kBp2)[j];
        }
        __syncwarp();
        chain::st_lanes(l, gp + q * S, d.C, d.K, nullptr, out.prior_stoch + n * S);
      }
      __syncthreads();
    }
  }
}

// The largest batch rows per block ≤ R_want whose shared memory fits one
// block on the current device (0 if none does).
int fwd_rows(Dims d, int R_want) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  for (int R = R_want; R >= 1; --R) {
    d.rows = R;
    if (smem_floats(d) * sizeof(float) <= (size_t)limit) return R;
  }
  return 0;
}

}  // namespace

// The stages in `stages` (1: the prologue, 2: the chain, 4: the epilogue)
// on the 20 weights `w` (device pointers, torch layout), `workspace` holding
// the prologue's sums ([T, B, 3H] floats), R batch rows a block; launched
// on `s`. recurrence_stacked_fwd.cu calls it on its packed weights.
cudaError_t mrssm_recurrence_forward_stages(const mrssm::WeightPtrs& w, const float* actions,
                                            const float* a_emb, const float* v_emb,
                                            const float* init_deter, const float* init_stoch,
                                            const float* g_prior, const float* g_post,
                                            float* deter_out, float* prior_logits_out,
                                            float* prior_stoch_out, float* mixed_out,
                                            float* post_stoch_out, float* workspace, int T,
                                            int B, int A, int E, int H, int D, int C, int K,
                                            int R, int stages, cudaStream_t s) {
  if (R < 1) return cudaErrorInvalidValue;
  const Dims d{T, B, A, E, H, D, C, K, R};
  const mrssm::WeightDims dims = weight_dims(d);
  const FwdWeights sw = fwd_weights(dims, d);
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(recurrence_fwd_stages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const FwdIn in{actions, a_emb, v_emb, init_deter, init_stoch, g_prior, g_post};
  const FwdOut out{deter_out, prior_logits_out, prior_stoch_out, mixed_out, post_stoch_out};
  recurrence_fwd_stages_kernel<<<(B + R - 1) / R, kThreads, smem, s>>>(sw, w, dims, in, out,
                                                                      workspace, d, stages);
  return cudaGetLastError();
}

extern "C" {

// The largest batch rows per block ≤ R_want whose shared memory fits one
// block of the forward kernel on the current device (0 if none does).
int mrssm_recurrence_fwd_rows(int T, int A, int E, int H, int D, int C, int K, int R_want) {
  return fwd_rows(Dims{T, 0, A, E, H, D, C, K, 0}, R_want);
}

// Launch on `stream` the stages in `stages` (1: the prologue, 2: the chain,
// 4: the epilogue; 7 for a forward call). `weights` is a host array of the
// 20 device pointers in the order of ops/kernels/recurrence.py; `workspace`
// holds the prologue's partial sums, [T, B, 3H] floats; R is the batch rows
// a block (mrssm_recurrence_fwd_rows). All tensors f32 and contiguous.
// Returns the cudaError_t of the launch (0 on success).
int mrssm_recurrence_forward(const void* const* weights, const float* actions, const float* a_emb,
                             const float* v_emb, const float* init_deter,
                             const float* init_stoch, const float* g_prior, const float* g_post,
                             float* deter_out, float* prior_logits_out, float* prior_stoch_out,
                             float* mixed_out, float* post_stoch_out, float* workspace, int T,
                             int B, int A, int E, int H, int D, int C, int K, int R, int stages,
                             void* stream) {
  return (int)mrssm_recurrence_forward_stages(
      mrssm::weight_ptrs(weights, kNW), actions, a_emb, v_emb, init_deter, init_stoch, g_prior,
      g_post, deter_out, prior_logits_out, prior_stoch_out, mixed_out, post_stoch_out, workspace,
      T, B, A, E, H, D, C, K, R, stages, static_cast<cudaStream_t>(stream));
}

const char* mrssm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
