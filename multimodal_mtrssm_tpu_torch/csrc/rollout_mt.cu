// MoPoE-MMTRSSM hierarchical prior-only imagination rollout (the imagine path).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/rollout_mt.py::_mt_rollout_kernel:
// for t = 0..T-1, the lower MTRNN on action ⊕ ls ⊕ hs (the previous prior
// samples) → the l-prior MLP → one-hot Gumbel-argmax sample; the higher
// MTRNN on the previous hs → the h-prior MLP → one-hot sample. It writes the
// integrator trajectories too, which make a chained continuation exact.
//
// Noise: Philox4x32-10 keyed, row by row, by a 64-bit seed, counter (t,
// index, block, word) with the row's index inside its own request, as in
// rollout.cu: the lower site's blocks are 0 .. ls_class - 1, the higher site's
// ls_class + c, and a block of K categories takes ceil(K / 4) words.
// ops/kernels/rollout_mt.py::philox_mt_gumbel is the same generator in torch
// integer ops, so a seed draws the same noise on the CPU and here.
//
// What bounds it: the latency of the T dependent steps of small products at
// serving batches (a step is ~5,000 multiply-adds a row); only at B ≥ 256
// does the batch fill the SMs. Only four carries make the loop sequential:
// both deters and integrators (the samples are functions of the deters and
// the noise). mt_rollout_stages_kernel runs one block of 256 threads per
// tile of batch rows, in stages of one launch:
//
// 1. Prologue, over all T steps of the block's rows at once: the carry-free
//    work, action·wli[:, :A]ᵀ + bli and both sites' Gumbel scores
//    -log(-log(u)), into a workspace [T, B, LD + LS + HS] in device memory
//    (shared memory does not grow with T). The noise is made here, by every
//    thread at once, and not by idle warps during the chain: the chain then
//    only copies it, and a prologue-only launch shows it in device memory.
// 2. The carry chain, two barrier phases a step: (a) both MTRNN updates, a
//    thread an output (integrator, tanh); their inputs are the deters'
//    products, made in the phase before, the prologue's action sum, and the
//    sample columns of the input weights, which from t = 1 on are a gather
//    of the ls_class + hs_class columns the one-hot carries select (at t = 0
//    the given stochs, which need not be one-hot, go through the dense
//    product); (b) a warp a row and site: the prior's hidden layer (ELU) and
//    logits, a lane an output, then the first-index argmax of logits plus
//    noise by shuffles within a block's lanes, written as an exact one-hot;
//    beside them the other warps form the deters' products for the next
//    step's (a). A step's workspace row arrives by cp.async into one of two
//    buffers while the step before computes.
//
// The 16 weights come in by the bulk copy in torch layout and are
// transposed in shared memory to [in, out] blocks (forward_chain.cuh).
// Tensors are [B, T, ·], the public layout of fused_mt_rollout_transition.
#include <algorithm>

#include "chain_common.cuh"
#include "forward_chain.cuh"
#include "mrssm_common.cuh"

namespace {

using chain::dot_part;
using chain::for_outputs;
using chain::group_sum;
using chain::round4;
using chain::Split;
using mrssm::MTDims;

constexpr int kNW = 16;
constexpr int kThreads = 256;

// Input and output tensors, in ops/kernels/rollout_mt.py order.
struct MTRolloutIn {
  const float *actions, *hd0, *ld0, *hs0, *ls0, *hidh0, *hidl0;
};
struct MTRolloutOut {
  float *h_deter, *l_deter, *h_logits, *l_logits, *h_stoch, *l_stoch, *h_hidden, *l_hidden;
};

// Widths: both latents (LS, HS; XS = LS + HS, the sample columns of the
// lower cell's input), their category blocks (NB), a workspace row (PW: the
// lower cell's action sum, then both sites' Gumbel scores) and the Philox
// words a row-step draws (NWD).
struct Sizes {
  int A, HD, LD, C, lK, hK, LS, HS, XS, NB, PW, NWD;
};

__host__ __device__ inline Sizes sizes(const MTDims& d) {
  Sizes z;
  z.A = d.A; z.HD = d.HD; z.LD = d.LD; z.C = d.C; z.lK = d.ls_cat; z.hK = d.hs_cat;
  z.LS = d.ls_class * d.ls_cat; z.HS = d.hs_class * d.hs_cat; z.XS = z.LS + z.HS;
  z.NB = d.ls_class + d.hs_class; z.PW = z.LD + z.XS;
  z.NWD = d.ls_class * ((z.lK + 3) / 4) + d.hs_class * ((z.hK + 3) / 4);
  return z;
}

// The staged weight blocks: the cells' deter columns and sample columns
// (read by dots split over lanes), both priors (a lane an output), the
// lower cell's action columns (the prologue), then the 8 biases.
enum Staged { kWld, kWhd, kWlx, kWhx, kWp1, kWp2, kWh1, kWh2, kWla, kBld, kBli, kBhd, kBhi, kBp1,
              kBp2, kBh1, kBh2, kNumStaged };
using RollWeights = chain::StagedWeights<kNumStaged>;

// Threads that phase (b) leaves to the deters' products: the warps past
// its 2R prior warps.
__host__ __device__ inline int helper_first(int R) { return 2 * R * 32; }

RollWeights roll_weights(const mrssm::WeightDims& d, const Sizes& z, int R) {
  const int PD = chain::split_lanes(R, z.LD + z.HD, kThreads - helper_first(R));
  const int PX = chain::split_lanes(R, z.LD + z.HD, kThreads);
  RollWeights s;
  auto at = [&](int i, int src, int c0, int nc, int P) {
    chain::staged_weight(s, d, i, src, c0, nc, P);
  };
  at(kWld, 0, 0, z.LD, PD);
  at(kWhd, 4, 0, z.HD, PD);
  at(kWlx, 2, z.A, z.XS, PX);
  at(kWhx, 6, 0, z.HS, PX);
  at(kWp1, 8, 0, z.LD, 1);
  at(kWp2, 10, 0, z.C, 1);
  at(kWh1, 12, 0, z.HD, 1);
  at(kWh2, 14, 0, z.C, 1);
  at(kWla, 2, 0, z.A, 1);
  const int bias[] = {1, 3, 5, 7, 9, 11, 13, 15};
  for (int i = kBld; i < kNumStaged; ++i) at(i, bias[i - kBld], 0, 1, 1);
  return s;
}

// Per-row state of the chain, each [R][width] floats: both deters and
// integrators, the deters' products for the coming step (Wld·ld + bld ⊕
// Whd·hd + bhd), the sample columns' sums at t = 0, the initial stochs,
// the chosen columns (ints), the priors' hidden layers and logits, and the
// two workspace-row buffers.
enum CBuf { kLd, kHd, kHl, kHh, kDd, kCols, kXs, kSel, kHid, kLg, kRec, kNumCBufs };

__host__ __device__ inline void chain_widths(const Sizes& z, int* w) {
  w[kLd] = z.LD; w[kHd] = z.HD; w[kHl] = z.LD; w[kHh] = z.HD; w[kDd] = z.LD + z.HD;
  w[kCols] = z.LD + z.HD; w[kXs] = z.XS; w[kSel] = z.NB; w[kHid] = 2 * z.C; w[kLg] = z.XS;
  w[kRec] = 2 * z.PW;
}

size_t smem_floats(const mrssm::WeightDims& d, const MTDims& m) {
  const Sizes z = sizes(m);
  int w[kNumCBufs];
  chain_widths(z, w);
  size_t rows = 0;
  for (int i = 0; i < kNumCBufs; ++i) rows += w[i];
  const size_t region = std::max((size_t)chain::raw_floats(d), m.rows * rows);
  return 4 + round4(roll_weights(d, z, m.rows).total) + region;
}

__global__ void __launch_bounds__(kThreads, 2)
mt_rollout_stages_kernel(const __grid_constant__ RollWeights sw,
                         const __grid_constant__ mrssm::WeightPtrs w,
                         const __grid_constant__ mrssm::WeightDims dims, MTRolloutIn in,
                         MTRolloutOut out, float* __restrict__ wsp,
                         const long long* __restrict__ row_seed,
                         const long long* __restrict__ row_index, MTDims d, int stages) {
  extern __shared__ __align__(16) float smem[];
  const Sizes z = sizes(d);
  const int A = z.A, HD = z.HD, LD = z.LD, C = z.C, LS = z.LS, HS = z.HS, XS = z.XS;
  const int NB = z.NB, PW = z.PW, DN = LD + HD, B = d.B, T = d.T;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* Wt = smem + 4;
  float* region = Wt + round4(sw.total);
  auto Wp = [&](int i) -> const float* { return Wt + sw.off[i]; };
  auto ws = [&](int i) { return sw.ws[i]; };
  auto dot = [&](const float* a, int i, int o, int n) {
    return chain::dot_lane(a, Wp(i) + o, ws(i), n);
  };
  const int R = d.rows, row0 = blockIdx.x * R, rows = min(R, B - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  chain::stage_raw(region, w, dims, bar);
  chain::stage_transposed(sw, region, Wt);
  __syncthreads();

  // 1. The prologue, row-step q = t·rows + r: the action sums, a thread an
  // output, and the Gumbel scores, a thread a Philox call.
  if (stages & 1) {
    const int N = T * rows;
    for (int i = threadIdx.x; i < N * LD; i += blockDim.x) {
      const int q = i / LD, j = i - q * LD, t = q / rows, b = row0 + q - t * rows;
      const float* a = in.actions + ((size_t)b * T + t) * A;
      wsp[((size_t)t * B + b) * PW + j] = dot(a, kWla, j, A) + Wp(kBli)[j];
    }
    const int lw = (z.lK + 3) / 4, hw = (z.hK + 3) / 4;
    for (int i = threadIdx.x; i < N * z.NWD; i += blockDim.x) {
      const int q = i / z.NWD, k = i - q * z.NWD, t = q / rows, b = row0 + q - t * rows;
      const bool lower = k < d.ls_class * lw;
      const int kk = lower ? k : k - d.ls_class * lw, per = lower ? lw : hw;
      const int c = kk / per, wd = kk - c * per, K = lower ? z.lK : z.hK;
      mrssm::gumbel_word(wsp + ((size_t)t * B + b) * PW + LD + (lower ? 0 : LS) + c * K + 4 * wd,
                         t, mrssm::row_key(row_seed, row_index, b),
                         lower ? c : d.ls_class + c, wd, K);
    }
  }

  // 2. The carry chain.
  if (stages & 2) {
    int width[kNumCBufs];
    chain_widths(z, width);
    float* buf[kNumCBufs];
    float* p = region;
    for (int i = 0; i < kNumCBufs; ++i) {
      buf[i] = p;
      p += R * width[i];
    }
    float *ld = buf[kLd], *hd = buf[kHd], *hidl = buf[kHl], *hidh = buf[kHh], *dd = buf[kDd];
    float *cols = buf[kCols], *xs = buf[kXs], *hid = buf[kHid], *lg = buf[kLg];
    int* sel = reinterpret_cast<int*>(buf[kSel]);
    __syncthreads();  // the prologue's rows are in device memory, the staging area free
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
    // Step t's workspace rows into buffer t & 1, over the threads from
    // `first` on.
    auto prefetch = [&](int t, int first) {
      chain::copy_async(buf[kRec] + (t & 1) * R * PW, wsp + ((size_t)t * B + row0) * PW,
                        rows * PW, first);
      fconv::cp_async_commit();
    };
    prefetch(0, 0);
    __syncthreads();
    // The deters' products of the coming step, Wld·ld + bld ⊕ Whd·hd + bhd,
    // on the threads of split s (with them, at t = 0, the sample columns'
    // dense sums of the given stochs).
    auto deter_products = [&](const Split& s, bool first_step) {
      for_outputs(s, rows, DN, [&](int r, int j, bool valid) {
        const bool lower = j < LD;
        const int k = lower ? j : j - LD;
        const float pd = lower ? dot_part(ld + r * LD, Wp(kWld) + k, ws(kWld), LD, s)
                               : dot_part(hd + r * HD, Wp(kWhd) + k, ws(kWhd), HD, s);
        const float sd = group_sum(pd, s);
        float sx = 0.f;
        if (first_step) {
          const float* x = xs + r * XS;
          sx = group_sum(lower ? dot_part(x, Wp(kWlx) + k, ws(kWlx), XS, s)
                               : dot_part(x + LS, Wp(kWhx) + k, ws(kWhx), HS, s), s);
        }
        if (valid && s.part == 0) {
          dd[r * DN + j] = sd + Wp(lower ? kBld : kBhd)[k];
          if (first_step) cols[r * DN + j] = sx;
        }
      });
    };
    deter_products(chain::make_split(rows, DN), true);
    const Split sH = chain::make_split_from(rows, DN, helper_first(R));
    const int busy_a = min((rows * DN + 31) / 32 * 32, kThreads);
    fconv::cp_async_wait<0>();
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const float* rec = buf[kRec] + (t & 1) * R * PW;
      // (a) Both MTRNN updates, JAX mtrnn_apply's association: u = (d·Wd +
      // bd) + (x·Wi + bi), x·Wi + bi being the sample columns' sum plus the
      // prologue's action sum (the lower cell) or bhi (the higher).
      if (t + 1 < T) prefetch(t + 1, busy_a == kThreads ? 0 : busy_a);
      for (int i = threadIdx.x; i < rows * DN; i += blockDim.x) {
        const int r = i / DN, j = i - r * DN;
        const bool lower = j < LD;
        const int k = lower ? j : j - LD;
        const size_t o = ((size_t)(row0 + r) * T + t) * (lower ? LD : HD) + k;
        float x;
        if (t == 0) {
          x = cols[i];
        } else {
          const int* sr = sel + r * NB;
          x = 0.f;
          if (lower) {
            for (int c = 0; c < NB; ++c) x += Wp(kWlx)[sr[c] * ws(kWlx) + k];
          } else {
            for (int c = d.ls_class; c < NB; ++c) x += Wp(kWhx)[(sr[c] - LS) * ws(kWhx) + k];
          }
        }
        const float u = dd[i] + (x + (lower ? rec[r * PW + k] : Wp(kBhi)[k]));
        float* hp = lower ? hidl + r * LD + k : hidh + r * HD + k;
        const float h = lower ? d.l_keep * *hp + u * d.l_inv : d.h_keep * *hp + u * d.h_inv;
        const float v = tanhf(h);
        *hp = h;
        (lower ? ld + r * LD : hd + r * HD)[k] = v;
        (lower ? out.l_deter : out.h_deter)[o] = v;
        (lower ? out.l_hidden : out.h_hidden)[o] = h;
      }
      __syncthreads();
      // (b) A warp a row and site (even tasks the lower, odd the higher):
      // the prior's hidden layer and logits, and the sample, the next step's
      // ls or hs; the other warps form the next step's deter products.
      if (warp < 2 * rows) {
        const int r = warp >> 1;
        const bool lower = (warp & 1) == 0;
        const size_t n = (size_t)(row0 + r) * T + t;
        const int N = lower ? LD : HD, S = lower ? LS : HS;
        const float* dr = lower ? ld + r * LD : hd + r * HD;
        float* h = hid + r * 2 * C + (lower ? 0 : C);
        float* l = lg + r * XS + (lower ? 0 : LS);
        for (int j = lane; j < C; j += 32) {
          h[j] = mrssm::elu(dot(dr, lower ? kWp1 : kWh1, j, N) + Wp(lower ? kBp1 : kBh1)[j]);
        }
        __syncwarp();
        for (int j = lane; j < S; j += 32) {
          const float v = dot(h, lower ? kWp2 : kWh2, j, C) + Wp(lower ? kBp2 : kBh2)[j];
          l[j] = v;
          (lower ? out.l_logits : out.h_logits)[n * S + j] = v;
        }
        __syncwarp();
        chain::onehot_lanes(l, rec + r * PW + LD + (lower ? 0 : LS),
                            lower ? d.ls_class : d.hs_class, lower ? z.lK : z.hK,
                            lower ? 0 : LS, sel + r * NB + (lower ? 0 : d.ls_class),
                            (lower ? out.l_stoch : out.h_stoch) + n * S);
      } else if (t + 1 < T) {
        deter_products(sH, false);
      }
      fconv::cp_async_wait<0>();
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` the stages in `stages` (1: the prologue, 2: the chain;
// 3 for a rollout call). Host arrays of device pointers: `weights` (the 16
// MTRNN and prior weights), `ins` (actions, init6) and `outs` (the 8
// outputs), in the order of ops/kernels/rollout_mt.py; `workspace` holds
// the prologue's rows, [T, B, LD + LS + HS] floats; row_seed and row_index
// are device arrays of B int64, each row's Philox seed and its index inside
// its request (mrssm::row_key); d.rows is the batch rows
// a block (at most 3: phase (b) leaves the deters' products at least two
// warps). Tensors f32, contiguous, [B, T, ·]. Returns the cudaError_t of
// the launch (0 on success).
int mt_rollout(const void* const* weights, const void* const* ins, void* const* outs,
               void* workspace, const long long* row_seed, const long long* row_index,
               MTDims d, int stages, void* stream) {
  if (d.rows < 1 || 2 * d.rows > kThreads / 32 - 2) return (int)cudaErrorInvalidValue;
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, kNW);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  float* const* y = reinterpret_cast<float* const*>(outs);
  const MTRolloutIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6]};
  const MTRolloutOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const RollWeights sw = roll_weights(dims, sizes(d), d.rows);
  const size_t smem = smem_floats(dims, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mt_rollout_stages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.B + d.rows - 1) / d.rows;
  mt_rollout_stages_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sw, w, dims, in, out, static_cast<float*>(workspace), row_seed, row_index, d, stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
