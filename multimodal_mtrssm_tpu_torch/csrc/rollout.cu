// MoPoE-MRSSM prior-only imagination rollout (the imagine path).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/rollout.py::_rollout_kernel: for
// t = 0..T-1, transition MLP(action ⊕ stoch) → GRU → prior MLP → one-hot
// Gumbel-argmax sample per category block, which is the next step's stoch.
//
// Noise: the TPU core PRNG becomes Philox4x32-10 keyed, row by row, by a
// 64-bit seed, with counter (t, index, block, word), where index is the row's
// index inside its own request: one call gives the four uniforms of a
// 4-category block. A request's rows carry its seed, so requests coalesced
// into one launch each draw what they draw alone.
// ops/kernels/rollout.py implements the same generator in torch integer
// ops, so a seed draws the same noise on the CPU and here.
//
// What bounds it: the latency of the T dependent steps of small products at
// serving batches (a step is ~9,000 multiply-adds a row); only at B ≥ 256
// does the batch fill the SMs. Only the deter carry makes the loop
// sequential (the sample is a function of the deter and the noise), and the
// transition's second layer is linear, so rollout_stages_kernel folds it
// into the GRU's input gates (Wih·W2 and Wih·b2 + bih, formed once a block
// at staging) and runs one block of 256 threads per tile of batch rows, in
// stages of one launch:
//
// 1. Prologue, over all T steps of the block's rows at once: the carry-free
//    work, action·w1[:, :A]ᵀ + b1 and the Gumbel scores -log(-log(u)), into a
//    workspace [T, B, H + S] in device memory (shared memory does not grow
//    with T).
// 2. The carry chain, two barrier phases a step: (a) the GRU, a lane group
//    a deter unit, its three input gates on h1 by the folded weights and its
//    update with the hidden gates gh made in the phase before; (b) a warp a
//    row: the prior's hidden layer (ELU) and logits, a lane an output, the
//    first-index argmax of logits plus noise by shuffles within a block's
//    lanes, written as an exact one-hot, and then the next step's
//    h1 = elu(prologue sum + the C weight columns of w1 the one-hot selects);
//    beside it the other warps form the next step's gh = Whh·deter + bhh.
//    Before the first step the block forms h1 with the dense product on the
//    given stoch (which need not be one-hot) and gh on the given deter. The
//    workspace rows of steps t and t + 1 are in shared memory during step t,
//    and step t + 2's arrives by cp.async into a ring of three.
//
// The 12 weights come in by the bulk copy in torch layout and are
// transposed in shared memory to [in, out] blocks (forward_chain.cuh).
// Tensors are [B, T, ·], the public layout of fused_rollout_transition.
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

constexpr int kNW = 12;
constexpr int kThreads = 256;

// The kernel's sizes: action A, hidden H, deter D, C classes of K
// categories, T steps, B batch rows, `rows` batch rows a block.
struct Dims {
  int T, B, A, H, D, C, K, rows;
};

mrssm::WeightDims weight_dims(const Dims& d) {
  const int S = d.C * d.K, G = 3 * d.D, H = d.H, D = d.D;
  const int in[kNW] = {d.A + S, 1, H, 1, H, 1, D, 1, D, 1, H, 1};
  const int out[kNW] = {H, H, H, H, G, G, G, G, H, H, S, S};
  return mrssm::weight_dims(in, out, kNW);
}

// The staged weight blocks: the transition's first layer's stoch columns
// (the dense first step, and the gather), whh (the helpers' split), the
// prior MLP (a lane an output), the action columns (the prologue), then the
// four biases the kernel reads as they are. The folded input gates follow
// them (fold_stride).
enum Staged { kW1s, kWhh, kWp1, kWp2, kW1a, kB1, kBhh, kBp1, kBp2, kNumStaged };
using RollWeights = chain::StagedWeights<kNumStaged>;

// The first thread of phase (b)'s helpers: the warps past its R prior warps.
__host__ __device__ inline int helper_first(int R) { return R * 32; }

RollWeights roll_weights(const mrssm::WeightDims& w, const Dims& d) {
  const int R = d.rows, S = d.C * d.K, G = 3 * d.D;
  RollWeights s;
  auto at = [&](int i, int src, int c0, int nc, int P) {
    chain::staged_weight(s, w, i, src, c0, nc, P);
  };
  at(kW1s, 0, d.A, S, chain::split_lanes(R, d.H + G, kThreads));
  at(kWhh, 6, 0, d.D, chain::split_lanes(R, G, kThreads - helper_first(R)));
  at(kWp1, 8, 0, d.D, 1);
  at(kWp2, 10, 0, d.H, 1);
  at(kW1a, 0, 0, d.A, 1);
  const int bias[] = {1, 7, 9, 11};
  for (int i = kB1; i < kNumStaged; ++i) at(i, bias[i - kB1], 0, 1, 1);
  return s;
}

// Row stride of the folded input gates Wf = Wih·W2, staged [H, 3D] for
// phase (a)'s split.
__host__ __device__ inline int fold_stride(const Dims& d) {
  return chain::lane_stride(3 * d.D, chain::split_lanes(d.rows, d.D, kThreads));
}

// Per-row state of the chain, each [R][width] floats: the deter carry, the
// next step's h1 and gh, the prior's hidden layer and logits, the chosen
// columns (ints), the given stoch, and the ring of three workspace rows.
enum CBuf { kDeter, kH1, kGh, kP1, kLg, kSel, kXs, kRec, kNumCBufs };

__host__ __device__ inline void chain_widths(const Dims& d, int* w) {
  const int S = d.C * d.K;
  w[kDeter] = d.D; w[kH1] = d.H; w[kGh] = 3 * d.D; w[kP1] = d.H; w[kLg] = S; w[kSel] = d.C;
  w[kXs] = S; w[kRec] = 3 * (d.H + S);
}

size_t smem_floats(const mrssm::WeightDims& w, const Dims& d) {
  int width[kNumCBufs];
  chain_widths(d, width);
  size_t rows = 0;
  for (int i = 0; i < kNumCBufs; ++i) rows += width[i];
  const size_t region = std::max((size_t)chain::raw_floats(w), d.rows * rows);
  return 4 + round4(roll_weights(w, d).total) + round4(d.H * fold_stride(d) + 3 * d.D) + region;
}

__global__ void __launch_bounds__(kThreads, 2)
rollout_stages_kernel(const __grid_constant__ RollWeights sw,
                      const __grid_constant__ mrssm::WeightPtrs w,
                      const __grid_constant__ mrssm::WeightDims dims,
                      const float* __restrict__ actions, const float* __restrict__ init_deter,
                      const float* __restrict__ init_stoch, float* __restrict__ deters,
                      float* __restrict__ logits_out, float* __restrict__ stochs,
                      float* __restrict__ wsp, const long long* __restrict__ row_seed,
                      const long long* __restrict__ row_index, Dims d, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int A = d.A, H = d.H, D = d.D, K = d.K, S = d.C * d.K, G = 3 * D, PW = H + S;
  const int B = d.B, T = d.T;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* Wt = smem + 4;
  float* Wf = Wt + round4(sw.total);  // [H][wf] the folded input gates, then bf [G]
  const int wf = fold_stride(d);
  float* bf = Wf + H * wf;
  float* region = Wt + round4(sw.total) + round4(H * wf + G);
  auto Wp = [&](int i) -> const float* { return Wt + sw.off[i]; };
  auto ws = [&](int i) { return sw.ws[i]; };
  auto dot = [&](const float* a, int i, int o, int n) {
    return chain::dot_lane(a, Wp(i) + o, ws(i), n);
  };
  const int R = d.rows, row0 = blockIdx.x * R, rows = min(R, B - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The weights, and the fold of the transition's second layer into the
  // GRU's input gates from their torch layout in the staging area:
  // Wf[k, g] = Σ_h wih[g, h]·w2[h, k], bf[g] = Σ_h wih[g, h]·b2[h] + bih[g].
  chain::stage_raw(region, w, dims, bar);
  chain::stage_transposed(sw, region, Wt);
  {
    auto raw = [&](int src) {
      int off = 0;
      for (int i = 0; i < src; ++i) off += round4(dims.in[i] * dims.out[i]);
      return region + off;
    };
    const float *w2 = raw(2), *b2 = raw(3), *wih = raw(4), *bih = raw(5);
    for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
      const int g = i / H, k = i - g * H;
      const float* a = wih + g * H;
      float s0 = 0.f, s1 = 0.f;
      int h = 0;
      for (; h + 1 < H; h += 2) {
        s0 = fmaf(a[h], w2[h * H + k], s0);
        s1 = fmaf(a[h + 1], w2[(h + 1) * H + k], s1);
      }
      if (h < H) s0 = fmaf(a[h], w2[h * H + k], s0);
      Wf[k * wf + g] = s0 + s1;
    }
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float s = 0.f;
      for (int h = 0; h < H; ++h) s = fmaf(wih[g * H + h], b2[h], s);
      bf[g] = s + bih[g];
    }
  }
  __syncthreads();

  // 1. The prologue, row-step q = t·rows + r: the action sums, a thread an
  // output, and the Gumbel scores, a thread a Philox call.
  if (stages & 1) {
    const int N = T * rows, per = (K + 3) / 4, NWD = d.C * per;
    for (int i = threadIdx.x; i < N * H; i += blockDim.x) {
      const int q = i / H, j = i - q * H, t = q / rows, b = row0 + q - t * rows;
      const float* a = actions + ((size_t)b * T + t) * A;
      wsp[((size_t)t * B + b) * PW + j] = dot(a, kW1a, j, A) + Wp(kB1)[j];
    }
    for (int i = threadIdx.x; i < N * NWD; i += blockDim.x) {
      const int q = i / NWD, k = i - q * NWD, t = q / rows, b = row0 + q - t * rows;
      const int c = k / per, wd = k - c * per;
      mrssm::gumbel_word(wsp + ((size_t)t * B + b) * PW + H + c * K + 4 * wd, t,
                         mrssm::row_key(row_seed, row_index, b), c, wd, K);
    }
  }

  // 2. The carry chain.
  if (stages & 2) {
    int width[kNumCBufs];
    chain_widths(d, width);
    float* buf[kNumCBufs];
    float* p = region;
    for (int i = 0; i < kNumCBufs; ++i) {
      buf[i] = p;
      p += R * width[i];
    }
    float *deter = buf[kDeter], *h1 = buf[kH1], *gh = buf[kGh], *p1 = buf[kP1], *lg = buf[kLg];
    float* xs = buf[kXs];
    int* sel = reinterpret_cast<int*>(buf[kSel]);
    // Step t's workspace rows, into ring slot t % 3, over the threads from
    // `first` on.
    auto ring = [&](int t) { return buf[kRec] + (t % 3) * R * PW; };
    auto prefetch = [&](int t, int first) {
      chain::copy_async(ring(t), wsp + ((size_t)t * B + row0) * PW, rows * PW, first);
      fconv::cp_async_commit();
    };
    __syncthreads();  // the prologue's rows are in device memory, the staging area free
    prefetch(0, 0);
    if (T > 1) prefetch(1, 0);
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) deter[i] = init_deter[row0 * D + i];
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) xs[i] = init_stoch[row0 * S + i];
    fconv::cp_async_wait<0>();
    __syncthreads();
    // The first step's h1 (the dense product on the given stoch) and gh.
    const Split s = chain::make_split(rows, H + G);
    for_outputs(s, rows, H + G, [&](int r, int j, bool valid) {
      const bool first = j < H;
      const float part = first ? dot_part(xs + r * S, Wp(kW1s) + j, ws(kW1s), S, s)
                               : dot_part(deter + r * D, Wp(kWhh) + j - H, ws(kWhh), D, s);
      const float sum = group_sum(part, s);
      if (valid && s.part == 0) {
        if (first) h1[r * H + j] = mrssm::elu(ring(0)[r * PW + j] + sum);
        else gh[r * G + j - H] = sum + Wp(kBhh)[j - H];
      }
    });
    __syncthreads();
    const Split sA = chain::make_split(rows, D);
    const Split sG = chain::make_split_from(rows, G, helper_first(R));

    for (int t = 0; t < T; ++t) {
      // (a) The GRU's input gates of deter unit j on h1 by the folded
      // weights, gate order r, z, n (torch nn.GRUCell; mrssm::gru_rows'
      // arithmetic), and its update with the hidden gates gh.
      for_outputs(sA, rows, D, [&](int r, int j, bool valid) {
        const float* x = h1 + r * H;
        const float ir = group_sum(dot_part(x, Wf + j, wf, H, sA), sA);
        const float iz = group_sum(dot_part(x, Wf + D + j, wf, H, sA), sA);
        const float in_ = group_sum(dot_part(x, Wf + 2 * D + j, wf, H, sA), sA);
        if (valid && sA.part == 0) {
          const float* g = gh + r * G;
          const float rg = mrssm::sigmoid((ir + bf[j]) + g[j]);
          const float z = mrssm::sigmoid((iz + bf[D + j]) + g[D + j]);
          const float n = tanhf((in_ + bf[2 * D + j]) + rg * g[2 * D + j]);
          const float v = (1.f - z) * n + z * deter[r * D + j];
          deter[r * D + j] = v;
          deters[((size_t)(row0 + r) * T + t) * D + j] = v;
        }
      });
      __syncthreads();
      // (b) A warp a row: the prior, the sample (the next step's stoch) and
      // the next step's h1; the other warps: the next step's gh, and step
      // t + 2's workspace rows.
      if (t + 2 < T) prefetch(t + 2, helper_first(R));
      if (warp < rows) {
        const int r = warp;
        const size_t n = (size_t)(row0 + r) * T + t;
        float* h = p1 + r * H;
        float* l = lg + r * S;
        int* sr = sel + r * d.C;
        for (int j = lane; j < H; j += 32) {
          h[j] = mrssm::elu(dot(deter + r * D, kWp1, j, D) + Wp(kBp1)[j]);
        }
        __syncwarp();
        for (int j = lane; j < S; j += 32) {
          const float v = dot(h, kWp2, j, H) + Wp(kBp2)[j];
          l[j] = v;
          logits_out[n * S + j] = v;
        }
        __syncwarp();
        chain::onehot_lanes(l, ring(t) + r * PW + H, d.C, K, 0, sr, stochs + n * S);
        __syncwarp();
        if (t + 1 < T) {
          const float* pre = ring(t + 1) + r * PW;
          for (int j = lane; j < H; j += 32) {
            float x = 0.f;
            for (int c = 0; c < d.C; ++c) x += Wp(kW1s)[sr[c] * ws(kW1s) + j];
            h1[r * H + j] = mrssm::elu(pre[j] + x);
          }
        }
      } else if (t + 1 < T) {
        for_outputs(sG, rows, G, [&](int r, int j, bool valid) {
          const float sum =
              group_sum(dot_part(deter + r * D, Wp(kWhh) + j, ws(kWhh), D, sG), sG);
          if (valid && sG.part == 0) gh[r * G + j] = sum + Wp(kBhh)[j];
        });
      }
      fconv::cp_async_wait<0>();
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` the stages in `stages` (1: the prologue, 2: the chain;
// 3 for a rollout call). `weights` is a host array of the 12 transition
// device pointers in the order of ops/kernels/rollout.py; `workspace` holds
// the prologue's rows, [T, B, H + S] floats; row_seed and row_index are
// device arrays of B int64, each row's Philox seed and its index inside its
// request (mrssm::row_key); R is the batch rows a block (at
// most 7: phase (b) leaves gh at least one warp). Tensors f32, contiguous,
// [B, T, ·]. Returns the cudaError_t of the launch (0 on success).
int mrssm_rollout(const void* const* weights, const float* actions, const float* init_deter,
                  const float* init_stoch, float* deters, float* logits, float* stochs,
                  float* workspace, const long long* row_seed, const long long* row_index,
                  int T, int B, int A, int H, int D, int C, int K, int R, int stages,
                  void* stream) {
  if (R < 1 || R > kThreads / 32 - 1) return (int)cudaErrorInvalidValue;
  const Dims d{T, B, A, H, D, C, K, R};
  const mrssm::WeightDims dims = weight_dims(d);
  const RollWeights sw = roll_weights(dims, d);
  const size_t smem = smem_floats(dims, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rollout_stages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rollout_stages_kernel<<<(B + R - 1) / R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sw, mrssm::weight_ptrs(weights, kNW), dims, actions, init_deter, init_stoch, deters, logits,
      stochs, workspace, row_seed, row_index, d, stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
