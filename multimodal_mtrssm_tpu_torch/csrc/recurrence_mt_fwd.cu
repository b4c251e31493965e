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
// What bounds it: the latency of ~10 dependent stages a step, each a few
// hundred FMAs a batch row, not FLOPs or bytes (inputs and outputs are
// ~0.5 MB at B=8 T=30). Layout: one block per tile of R batch rows, the T
// loop inside the block. The 28 weights (16,944 floats, 67.8 KB at the
// reference widths, above the 48 KB default: opted in) are staged once into
// dynamic shared memory as [in, out]; the six carries and every per-step
// activation stay in shared memory (~2.5 KB a row). Outputs go straight to
// [T, B, ·] in device memory, so there is no time chunking: one kernel covers
// the TPU's single-block and time-chunked variants.
#include "mrssm_common.cuh"

namespace {

using mrssm::MTDims;

constexpr int kNW = 28;

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

// Per-row shared-memory floats: xl (action ⊕ ls ⊕ hs carry), embeddings,
// the deter and integrator carries of both layers, the new deters, the five
// MLPs' hidden layers, their five logits, the fusion statistics and logits.
__host__ __device__ inline int fwd_row_floats(const MTDims& d) {
  const int LS = d.ls_class * d.ls_cat, HS = d.hs_class * d.hs_cat;
  return (d.A + LS + HS) + 2 * d.E + 3 * (d.LD + d.HD) + (3 * d.C + 2 * d.R) +
         (3 * LS + 2 * HS) + 4 + LS;
}

__global__ void __launch_bounds__(mrssm::kThreads)
mt_recurrence_fwd_kernel(mrssm::WeightPtrs w, mrssm::WeightDims dims, MTFwdIn in, MTFwdOut out,
                         MTDims d) {
  using namespace mrssm;
  extern __shared__ float smem[];
  const int A = d.A, E = d.E, HD = d.HD, LD = d.LD, C = d.C, R = d.R, B = d.B;
  const int lK = d.ls_cat, hK = d.hs_cat, LS = d.ls_class * lK, HS = d.hs_class * hK;
  const int X = A + LS + HS, H5 = 3 * C + 2 * R, G5 = 3 * LS + 2 * HS, DN = LD + HD;
  // Hidden and logit offsets: l-prior, audio, vision, h-prior, h-posterior.
  const int hA = C, hV = C + R, hP = C + 2 * R, hQ = 2 * C + 2 * R;
  const int gA = LS, gV = 2 * LS, gP = 3 * LS, gQ = 3 * LS + HS;
  float* W = smem;
  auto Wp = [&](int i) -> const float* { return W + dims.off[i]; };
  const int Rt = d.rows;
  float* xl = W + dims.total;       // [R][X]  action ⊕ ls ⊕ hs carry
  float* emb = xl + Rt * X;         // [R][2E] audio ⊕ vision embedding
  float* ld = emb + Rt * 2 * E;     // [R][LD] l_deter carry
  float* hd = ld + Rt * LD;         // [R][HD] h_deter carry
  float* hidl = hd + Rt * HD;       // [R][LD] lower integrator carry
  float* hidh = hidl + Rt * LD;     // [R][HD] higher integrator carry
  float* dnew = hidh + Rt * HD;     // [R][LD + HD] the step's deters
  float* hid = dnew + Rt * DN;      // [R][H5] the five MLPs' hidden layers
  float* lg = hid + Rt * H5;        // [R][G5] their logits
  float* stat = lg + Rt * G5;       // [R][4]  fusion statistics
  float* mixed = stat + Rt * 4;     // [R][LS] fused posterior logits

  stage_weights(W, w, dims);
  const int row0 = blockIdx.x * Rt;
  const int rows = min(Rt, B - row0);
  for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
    ld[i] = in.ld0[row0 * LD + i];
    hidl[i] = in.hidl0[row0 * LD + i];
  }
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    hd[i] = in.hd0[row0 * HD + i];
    hidh[i] = in.hidh0[row0 * HD + i];
  }
  for (int i = threadIdx.x; i < rows * (LS + HS); i += blockDim.x) {
    const int r = i / (LS + HS), s = i - r * (LS + HS);
    xl[r * X + A + s] = s < LS ? in.ls0[(row0 + r) * LS + s] : in.hs0[(row0 + r) * HS + s - LS];
  }
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const size_t base = (size_t)t * B + row0;  // first [t, b] row of this tile
    for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
      const int r = i / A, a = i - r * A;
      xl[r * X + a] = in.actions[(base + r) * A + a];
    }
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i - r * E;
      emb[r * 2 * E + e] = in.a_emb[(base + r) * E + e];
      emb[r * 2 * E + E + e] = in.v_emb[(base + r) * E + e];
    }
    __syncthreads();
    // Both MTRNNs read only the carries: the lower on action ⊕ ls ⊕ hs, the
    // higher on hs.
    mtrnn_rows(ld, LD, xl, X, X, Wp(0), Wp(1), Wp(2), Wp(3), LD, hidl, LD, dnew, DN, d.l_inv,
               d.l_keep, rows);
    mtrnn_rows(hd, HD, xl + A + LS, HS, X, Wp(4), Wp(5), Wp(6), Wp(7), HD, hidh, HD, dnew + LD,
               DN, d.h_inv, d.h_keep, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * LD; i += blockDim.x) {
      const int r = i / LD, j = i - r * LD;
      ld[i] = dnew[r * DN + j];
      out.l_deter[base * LD + i] = ld[i];
      out.hid_l[base * LD + i] = hidl[i];
    }
    for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
      const int r = i / HD, j = i - r * HD;
      hd[i] = dnew[r * DN + LD + j];
      out.h_deter[base * HD + i] = hd[i];
      out.hid_h[base * HD + i] = hidh[i];
    }
    __syncthreads();
    // The five MLPs' hidden layers (ELU), then their output layers.
    dense_rows(ld, LD, LD, nullptr, 0, 0, Wp(8), Wp(9), C, hid, H5, rows, true);
    dense_rows(ld, LD, LD, emb, E, 2 * E, Wp(20), Wp(21), R, hid + hA, H5, rows, true);
    dense_rows(ld, LD, LD, emb + E, E, 2 * E, Wp(24), Wp(25), R, hid + hV, H5, rows, true);
    dense_rows(hd, HD, HD, nullptr, 0, 0, Wp(12), Wp(13), C, hid + hP, H5, rows, true);
    dense_rows(ld, LD, LD, hd, HD, HD, Wp(16), Wp(17), C, hid + hQ, H5, rows, true);
    __syncthreads();
    dense_rows(hid, C, H5, nullptr, 0, 0, Wp(10), Wp(11), LS, lg, G5, rows, false);
    dense_rows(hid + hA, R, H5, nullptr, 0, 0, Wp(22), Wp(23), LS, lg + gA, G5, rows, false);
    dense_rows(hid + hV, R, H5, nullptr, 0, 0, Wp(26), Wp(27), LS, lg + gV, G5, rows, false);
    dense_rows(hid + hP, C, H5, nullptr, 0, 0, Wp(14), Wp(15), HS, lg + gP, G5, rows, false);
    dense_rows(hid + hQ, C, H5, nullptr, 0, 0, Wp(18), Wp(19), HS, lg + gQ, G5, rows, false);
    __syncthreads();
    mopoe_stats(lg + gA, G5, LS, stat, rows);
    for (int i = threadIdx.x; i < rows * LS; i += blockDim.x) {
      const int r = i / LS, s = i - r * LS;
      out.lp_logits[base * LS + i] = lg[r * G5 + s];
    }
    for (int i = threadIdx.x; i < rows * HS; i += blockDim.x) {
      const int r = i / HS, s = i - r * HS;
      out.hp_logits[base * HS + i] = lg[r * G5 + gP + s];
      out.hq_logits[base * HS + i] = lg[r * G5 + gQ + s];
    }
    __syncthreads();
    mopoe_mix(lg + gA, G5, stat, LS, mixed, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * LS; i += blockDim.x) out.mixed[base * LS + i] = mixed[i];
    // Straight-through samples, one thread per (row, category block) of
    // either layer (lower blocks first); the posterior samples become the
    // next step's ls and hs carries.
    const int nb = d.ls_class + d.hs_class;
    for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
      const int r = i / nb, c = i - r * nb;
      if (c < d.ls_class) {
        const size_t o = (base + r) * LS + c * lK;
        const float* pl = lg + r * G5 + c * lK;
        st_block(pl, block_argmax(pl, in.g_lp + o, lK), lK, out.lp_stoch + o);
        const float* ml = mixed + r * LS + c * lK;
        float* carry = xl + r * X + A + c * lK;
        st_block(ml, block_argmax(ml, in.g_l + o, lK), lK, carry);
        for (int j = 0; j < lK; ++j) out.l_stoch[o + j] = carry[j];
      } else {
        const int ch = c - d.ls_class;
        const size_t o = (base + r) * HS + ch * hK;
        const float* pl = lg + r * G5 + gP + ch * hK;
        st_block(pl, block_argmax(pl, in.g_hp + o, hK), hK, out.hp_stoch + o);
        const float* ql = lg + r * G5 + gQ + ch * hK;
        float* carry = xl + r * X + A + LS + ch * hK;
        st_block(ql, block_argmax(ql, in.g_h + o, hK), hK, carry);
        for (int j = 0; j < hK; ++j) out.h_stoch[o + j] = carry[j];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. `weights` is a host array of the 28 device pointers,
// `ins` of the 13 inputs (actions, a_emb, v_emb, init6, the four Gumbel
// tensors) and `outs` of the 12 outputs, in the order of
// ops/kernels/recurrence_mt.py; all tensors f32 and contiguous. Returns the
// cudaError_t of the launch (0 on success).
int mt_recurrence_forward(const void* const* weights, const void* const* ins,
                          void* const* outs, MTDims d, void* stream) {
  mrssm::WeightPtrs w;
  for (int i = 0; i < kNW; ++i) w.p[i] = static_cast<const float*>(weights[i]);
  const float* const* x = reinterpret_cast<const float* const*>(ins);
  float* const* y = reinterpret_cast<float* const*>(outs);
  const MTFwdIn in{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8], x[9], x[10], x[11], x[12]};
  const MTFwdOut out{y[0], y[1], y[2], y[3], y[4], y[5], y[6], y[7], y[8], y[9], y[10], y[11]};
  const mrssm::WeightDims dims = mrssm::mt_weight_dims(d, kNW);
  const size_t smem = ((size_t)dims.total + (size_t)d.rows * fwd_row_floats(d)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mt_recurrence_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.B + d.rows - 1) / d.rows;
  mt_recurrence_fwd_kernel<<<blocks, mrssm::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, dims, in, out, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
