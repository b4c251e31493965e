// The conv encoder in bf16 (trainer.precision 16-mixed with
// conv_layout="fused_enc") on the H100's tensor cores: shared code of
// fused_encoder_bf16_fwd.cu and fused_encoder_bf16_bwd.cu.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) and ::_bwd_kernel (line 461) at dtype=bfloat16, as
// fused_encoder_apply (line 561) reaches them for bf16 frames. The
// numerics are JAX's _layer_fwd (lines 266-299) and _walk_bwd (line 331):
// frames, weights, activations and the embedding are bf16 values; each
// layer sums its products in f32, adds the bias and applies ELU in f32
// (the residual skip added before the ELU), then rounds its output to bf16
// (round to nearest even). The backward recomputes those activations,
// keeps every cotangent in f32, takes the ELU derivative from the rounded
// output (o > 0 ? 1 : o + 1, JAX's _act_deriv), and rounds dx and the
// weight gradients to bf16 at the end (JAX casts its gradients to the
// operand dtype, line 555). Unlike JAX it does not round the cotangent to
// bf16 where JAX cuts the stack into two segments (act3): here there is
// one stack.
//
// What bounds it: ~2.76 M multiply-adds a frame at the reference widths
// (89% in the six 64→64 3×3 convs at 4×4), against ~28 KB of bf16 frame
// and embedding and ~0.6 MB of weights that every block reads from L2. So
// the tensor cores, and the latency of a chain of small products per tile
// of frames, not HBM. Every layer of all three passes is an implicit GEMM
// on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (inline PTX, A
// and B fragments from ldmatrix; these pieces, the weight slices and the
// task schedule are in bf16_mma.cuh, shared with the bf16 decoder): a bf16
// product is exact and the tensor core sums in f32, so the kernels keep the
// plain version's numerics up to the order of the sums. mma.sync rather than wgmma: the 4×4 layers give
// 16 rows a frame, and wgmma's 64-row tiles would need 4 frames a block,
// leaving half the card idle at N=240. Measured on the card (clock64
// stamps, PERF.md §6), the blocks are busy in their slices' products and
// epilogues, not in the bulk copies; the hot loops therefore take 32-bit
// shared addresses with the layer's numbers in registers and the plan in
// shared memory (shared_plan), and epilogues load before they store.
//
// - Forward (encoder_bf16_tc_fwd_kernel, also the backward's recompute): a
//   block takes a tile of P.F frames (2; 1 where shared memory needs it)
//   and walks the layers with the tile's maps in shared memory, bf16, HWC
//   with channels padded to a multiple of 16 and a row stride of C16 + 8
//   (an odd count of 16-byte units: ldmatrix is free of bank conflicts).
//   Layer l reads buffer l & 1 and writes the other, so a residual block's
//   second conv writes over its skip, element by element, in place. The
//   GEMM is M = frames × output positions, N = Co, K = taps × Ci, one k-step
//   a tap and 16 channels; a padding tap's row points at 16 zero bytes. The
//   first layer reads the CoordConv input (Ci ≤ 4) from a map with a zero
//   halo and 4 channels a position, where one 16-byte row holds two taps
//   side by side: K = 3 rows of taps × 16 (the fourth tap's weights are
//   zeros), three k-steps, no branch; it stays on the tensor cores. A
//   task's even and odd k-steps sum into two sets of accumulators, each
//   step's fragments loaded while the step before multiplies. The epilogue
//   works on the accumulator fragments in registers: bias, skip and ELU in
//   f32, then one bf16 rounding, to shared memory and, in the recompute,
//   to the record.
// - Weights: packed per layer as [Co rows][k-steps × 16] bf16 (K contiguous
//   for the .col operand; the cotangent pass's as [Ci rows][tap][Co]), cut
//   into slices of ≤ kSliceCap bytes (chunks of rows × ranges of k-steps)
//   that the Hopper bulk copy streams into two shared-memory buffers on
//   mbarriers (conv_common.cuh), the next slice in flight while one
//   computes. A warp's task is one m-tile × two n-tiles (8 f32
//   accumulators); it holds up to kSlots tasks across a chunk's slices
//   (a layer with more m-tiles takes them in groups, its slices streamed
//   once a group), and where a chunk has fewer than 8 tasks, the warps
//   split its k-steps and add their sums in a fixed order through shared
//   memory.
// - Cotangent pass (encoder_bf16_tc_dx_kernel): the transposed conv as the
//   same implicit GEMM, M = frames × input positions, N = Ci, K = taps ×
//   Co. Each f32 cotangent is held as two bf16 terms, hi = bf16(d) and lo =
//   bf16(d - hi) (split once, in the epilogue that makes it), both in the
//   shared-memory maps for ldmatrix: two mma's a k-step, the lo products in
//   sums of their own. The products are exact and the sums f32, so the
//   operand keeps ~2^-17 of its relative precision (2^-9 if rounded to bf16
//   once). A residual block's output cotangent is also kept in f32 for the
//   skip its input takes. A stride-2 layer's input positions are walked by
//   parity class (each m-tile holds one class), so a tap is taken or
//   skipped by the whole warp. The epilogue takes the ELU derivative from
//   the record and writes the next map and the pre-activation cotangent
//   record, split hi/lo. A map that shared memory cannot hold (layer 0's,
//   read only for dx; at the widest widths the widest) stays in the
//   record, whose 32-bit words the lanes load as their fragments.
// - Weight-gradient pass (encoder_bf16_tc_dw_kernel): one GEMM a layer,
//   dW[(tap, ci), co] = Σ over (frame, position) of A · dpre, A the im2col
//   view of the recorded bf16 activations (exact) and dpre the split
//   record; the bias is one more m-tile whose A is ones. A block owns a
//   tile of ≤ 12 m-tiles × ≤ 64 output channels and one chunk of frames
//   (the first two layers, few tiles and long chunks: a quarter of one),
//   stages it by cp.async a few frames at a time (two buffers), and runs K
//   over (frame, position) in steps of 16 with ldmatrix.trans on both
//   operands. Chunks, and their parts, are added in a fixed order
//   (encoder_bf16_tc_reduce_kernel). No float atomics anywhere: two
//   launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bf16_mma.cuh"

namespace fbf {

typedef __nv_bfloat16 bf16;
using namespace bmma;

constexpr int kMaxLayers = 14;
constexpr int kMaxFrames = 2;      // frames a block of the forward and the cotangent pass
constexpr int kSliceCap = 16384;   // bytes of a weight-slice buffer, unless a layer needs more
constexpr int kStageCap = 57344;   // bytes of a weight-gradient staging buffer, where they fit
constexpr int kDwRows = 12;        // m-tiles of a weight-gradient block, at most
constexpr int kDwSub = 4;          // blocks a frame chunk of a layer with ≥ 64 positions
constexpr int kRedFloats = (kWarps - 1) * 32 * 8;  // the split sums of the forward passes
enum Mode { kElu = 0, kResidual = 1, kHead = 2 };

// ops/kernels/build.py::EncDims, field for field (the f32 kernels' struct):
// `frames` is not read here (the plan picks its own), `chunk` is the frames
// a chunk of the weight-gradient pass.
struct EncDims {
  int N, H, W, C0, coord, ch0, ch1, ch2, res_out, res_mid, n_res, out_dim, frames, chunk;
};

struct Layer {
  int Hi, Wi, Ci, Ho, Wo, Co, k, s, p, mode;
  int C16i, C16o;        // channels rounded up to 16
  int pair;              // layer 0: the CoordConv input, two taps a 16-byte row
  int acc_in;            // its input also feeds the next layer's residual skip
  int st_in, st_out;     // per-frame offsets (bf16) of its input and output maps in the record
  int dp_off;            // per-frame offset (bf16) of its pre-activation cotangent, hi then lo
  int cls, cpos;         // transposed walk: classes of input positions, positions a class
  int sub;               // blocks a frame chunk of the weight-gradient pass
  int aglob;             // its output's cotangent read from the record by its transposed
                         // GEMM, not kept in shared memory (layer 0's always: dx only)
  Cut c[2];              // forward [0] and transposed [1] weights
  int g_off;             // gradient elements before its weight
  // The weight-gradient pass: m-tiles (the bias's last), row tiles of rt
  // m-tiles (`pertap`: each within one tap, a window of rt·16 channels;
  // `flat`: the head, whose im2col row is the input map itself), column
  // tiles of ct n-tiles, frames a stage, bf16 elements a staged frame of
  // activations and of each cotangent half, the first tile.
  int mtw, rt, nrt, pertap, flat, ct, nct, fs, apf, dpf, tile0;
};

struct Plan {
  int n, H, W, C0, Cin, F;
  Layer L[kMaxLayers];
  int stash;       // bf16 elements a frame of the activation record (a multiple of 8)
  int dstash;      // floats a frame of the cotangent record (two bf16 halves each)
  int packed;      // bf16 elements of the packed weights, both directions
  int grads;       // gradient elements, all tensors back to back (torch layout)
  int slices[2];   // weight slices of each direction
  int dw_tiles;    // tiles of the weight-gradient pass
  int dw_small;    // gradient elements of the layers split kDwSub ways (the first ones)
  int fbuf[2];     // bf16 elements a frame of the forward's two map buffers
  int bbuf[2];     // bf16 elements a frame of the cotangent pass's two map buffers (hi and
                   // lo halves; a layer with Layer::aglob keeps none)
  int sbuf;        // floats a frame of its residual-skip buffer
  int cap;         // bytes of a weight-slice buffer
  size_t fsmem, bsmem, wsmem;

  __host__ __device__ Cut cut(int dir, int l) const { return L[l].c[dir]; }
  __host__ __device__ int count(int) const { return n; }
};

struct WeightPtrs {
  const bf16* p[2 * kMaxLayers];
};

inline WeightPtrs weight_ptrs(const void* const* weights, int n) {
  WeightPtrs w;
  for (int i = 0; i < n; ++i) w.p[i] = static_cast<const bf16*>(weights[i]);
  return w;
}

__host__ __device__ __forceinline__ int r16(int c) { return (c + 15) / 16 * 16; }

// The forward's map of layer l's input, bf16 elements a frame: the halo'd
// 4-channel CoordConv input, or positions × (C16 + 8).
__host__ __device__ __forceinline__ int in_map(const Plan& P, int l) {
  const Layer& L = P.L[l];
  return L.pair ? (L.Hi + 2) * (L.Wi + 2) * 4 : L.Hi * L.Wi * (L.C16i + 8);
}

// The weight-gradient pass's tiling of layer L (see Layer): the largest
// row tile, then column tile, whose two staging buffers fit `cap` bytes.
inline bool make_dw(Layer& L, int F, int cap) {
  const int npos = L.Ho * L.Wo, ksf = L.pair ? L.k : L.k * L.k * L.C16i / 16;
  L.mtw = ksf + 1;
  L.flat = npos == 1 && L.p == 0;
  const int rts[] = {kDwRows, 8, 4, 2, 1}, cts[] = {8, 4, 2};
  for (int rt : rts) {
    for (int ct : cts) {
      if (ct * 8 > L.C16o && ct != 2) continue;
      L.pertap = !L.pair && !L.flat && L.C16i > rt * 16;
      const int win = L.pertap ? rt * 16 : L.C16i;
      if (L.pair) {
        L.apf = (L.Hi + 2) * (L.Wi + 2) * 4;
      } else if (L.flat) {
        L.apf = rt * 16 + 8;
      } else {
        L.apf = L.Hi * L.Wi * (win + 8);
      }
      L.dpf = npos * (ct * 8 + 8);
      const int per = 2 * (L.apf + 2 * L.dpf);
      if (per > cap) continue;
      L.fs = std::max(1, std::min(cap / per, F));
      if (L.pertap) {
        L.nrt = L.k * L.k * ((L.C16i / 16 + rt - 1) / rt) + 1;  // the bias alone last
        L.rt = rt;
      } else {
        L.nrt = (L.mtw + rt - 1) / rt;
        L.rt = (L.mtw + L.nrt - 1) / L.nrt;
      }
      L.ct = std::min(ct, L.C16o / 8);
      L.nct = (L.C16o / 8 + L.ct - 1) / L.ct;
      return true;
    }
  }
  return false;
}

// The plan of an encoder; false where the widths need more layers than the
// table holds or a block's shared memory does not fit one frame.
inline bool make_plan(const EncDims& d, Plan* out) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  limit -= (int)sizeof(Plan);  // each kernel's copy of the plan (shared_plan)
  for (int F = kMaxFrames; F >= 1; --F) {
    Plan p = {};
    p.F = F;
    p.H = d.H;
    p.W = d.W;
    p.C0 = d.C0;
    p.Cin = d.C0 + (d.coord ? 2 : 0);
    if (p.Cin > 4 || d.H % 2 != 0 || d.W % 2 != 0) return false;
    int hi = d.H, wi = d.W, ci = p.Cin;
    auto add = [&](int co, int k, int s, int pad, int mode) -> bool {
      if (p.n == kMaxLayers) return false;
      Layer& L = p.L[p.n++];
      L = Layer{};
      L.Hi = hi; L.Wi = wi; L.Ci = ci;
      L.Ho = (hi + 2 * pad - k) / s + 1;
      L.Wo = (wi + 2 * pad - k) / s + 1;
      L.Co = co; L.k = k; L.s = s; L.p = pad; L.mode = mode;
      hi = L.Ho; wi = L.Wo; ci = co;
      return L.Ho >= 1 && L.Wo >= 1;
    };
    const int ch[3] = {d.ch0, d.ch1, d.ch2};
    bool ok = true;
    for (int i = 0; i < 3; ++i) ok = ok && add(ch[i], 3, 2, 1, kElu);
    if (d.n_res > 0 && ci != d.res_out) ok = ok && add(d.res_out, 1, 1, 0, kElu);
    for (int r = 0; r < d.n_res && ok; ++r) {
      const int xc = ci;
      ok = add(d.res_mid, 3, 1, 1, kElu) && add(xc, 3, 1, 1, kResidual);
    }
    ok = ok && hi == wi && add(d.out_dim, hi, 1, 0, kHead);
    if (!ok) return false;
    int stash = 0, dstash = 0, grads = 0;
    for (int l = 0; l < p.n; ++l) {
      Layer& L = p.L[l];
      L.C16i = r16(L.Ci);
      L.C16o = r16(L.Co);
      L.pair = l == 0;
      L.acc_in = l + 1 < p.n && p.L[l + 1].mode == kResidual;
      L.st_in = stash;
      stash += L.pair ? (L.Hi + 2) * (L.Wi + 2) * 4 : 0;
      L.st_out = stash;
      if (L.mode != kHead) stash += L.Ho * L.Wo * L.C16o;
      L.dp_off = 2 * dstash;
      dstash += L.Ho * L.Wo * L.C16o;
      L.g_off = grads;
      grads += L.Co * (L.Ci * L.k * L.k + 1);
      L.cls = L.s == 2 ? 4 : 1;
      L.cpos = L.Hi * L.Wi / L.cls;
      // the weight-gradient pass walks positions by shifts; stride 2 halves the map
      const int npos = L.Ho * L.Wo;
      if ((npos & (npos - 1)) != 0 ||
          (L.s == 2 && (L.Hi % 2 != 0 || L.Wi % 2 != 0 || 2 * L.Ho != L.Hi || 2 * L.Wo != L.Wi))) {
        return false;
      }
      if (l > 0) p.L[l].st_in = p.L[l - 1].st_out;
    }
    if (p.L[0].k != 3 || p.L[0].s != 2 || p.L[0].p != 1) return false;
    p.stash = (stash + 7) / 8 * 8;
    p.dstash = dstash;
    p.grads = grads;
    for (int l = 0; l < p.n; ++l) p.fbuf[l & 1] = std::max(p.fbuf[l & 1], in_map(p, l));
    p.cap = kSliceCap;
    p.packed = 0;
    for (int l = 0; l < p.n && ok; ++l) {
      Layer& L = p.L[l];
      const int ksf = L.pair ? L.k : L.k * L.k * L.C16i / 16;
      const int mtf = (F * L.Ho * L.Wo + 15) / 16;
      const int mtb = L.cls * ((F * L.cpos + 15) / 16);
      ok = make_cut(L.c[0], L.C16o, ksf, mtf, p.cap, p.packed) &&
           make_cut(L.c[1], L.C16i, L.k * L.k * L.C16o / 16, mtb, p.cap, p.packed);
    }
    if (!ok) return false;
    count_slices(p);
    p.fsmem = 32 + (size_t)F * 2 * (p.fbuf[0] + p.fbuf[1]) + 2 * (size_t)p.cap + 4 * kRedFloats;
    // The cotangent pass's maps: in shared memory while they fit, the
    // largest read from the record where they do not.
    p.L[0].aglob = 1;
    p.sbuf = 0;
    for (int l = 0; l < p.n; ++l) {
      const Layer& L = p.L[l];
      if (L.mode == kResidual) p.sbuf = std::max(p.sbuf, L.Ho * L.Wo * (L.C16o + 8));
    }
    auto bsmem = [&]() {
      p.bbuf[0] = p.bbuf[1] = 0;
      for (int l = 0; l < p.n; ++l) {
        const Layer& L = p.L[l];
        if (!L.aglob) {
          p.bbuf[(l + 1) & 1] = std::max(p.bbuf[(l + 1) & 1], 2 * L.Ho * L.Wo * (L.C16o + 8));
        }
      }
      return 32 + (size_t)F * 2 * (p.bbuf[0] + p.bbuf[1]) + (size_t)F * 4 * p.sbuf +
             2 * (size_t)p.cap + 4 * kRedFloats;
    };
    for (p.bsmem = bsmem(); p.bsmem > (size_t)limit; p.bsmem = bsmem()) {
      int big = -1;
      for (int l = 0; l < p.n - 1; ++l) {
        const Layer& L = p.L[l];
        const Layer& B = p.L[big < 0 ? 0 : big];
        if (!L.aglob && (big < 0 || L.Ho * L.Wo * L.C16o > B.Ho * B.Wo * B.C16o)) big = l;
      }
      if (big < 0) break;
      p.L[big].aglob = 1;
    }
    if (p.fsmem > (size_t)limit || p.bsmem > (size_t)limit) continue;
    // The weight-gradient pass: staging under kStageCap where it fits, else all there is.
    const int wfix = 32 + 4 * kWarps * 32 * 48;
    p.dw_tiles = p.dw_small = 0;
    size_t wsmem = 0;
    for (int l = 0; l < p.n && ok; ++l) {
      Layer& L = p.L[l];
      // the first layers, whose tiles are few and whose chunks are long, a
      // frame chunk in kDwSub blocks (partial sums of their own, past the chunks')
      L.sub = L.Ho * L.Wo >= 64 && (l == 0 || p.L[l - 1].sub > 1) ? kDwSub : 1;
      if (L.sub > 1) p.dw_small = L.g_off + L.Co * (L.Ci * L.k * L.k + 1);
      ok = make_dw(L, d.chunk, kStageCap) || make_dw(L, 1, (limit - 32) / 2);
      L.tile0 = p.dw_tiles;
      p.dw_tiles += L.nrt * L.nct;
      wsmem = std::max(wsmem, (size_t)2 * 2 * L.fs * (L.apf + 2 * L.dpf));
    }
    if (!ok) return false;
    p.wsmem = std::max(wsmem + 32, (size_t)wfix);
    if (p.wsmem > (size_t)limit) return false;
    *out = p;
    return true;
  }
  return false;
}

namespace {

// Pack one weight slice a block (blockIdx.x walks the forward slices, then
// the transposed ones): a forward row is an output channel, its k-step s a
// tap and 16 input channels (layer 0: a row of taps, [kx][ci] with 4
// channels and 4 taps, the fourth zeros); a transposed row is an input
// channel, its k-step a tap and 16 output channels. Zeros past the
// channels and in each row's 8 padding elements.
__global__ void __launch_bounds__(kThreads)
encoder_bf16_tc_pack_kernel(WeightPtrs w, Plan P, bf16* __restrict__ packed) {
  int b = blockIdx.x, dir = 0;
  if (b >= P.slices[0]) {
    b -= P.slices[0];
    dir = 1;
  }
  Slice s = make_slice(P, dir, dir == 0 ? 0 : P.n - 1, 0, 0, 0);
  for (; b > 0; --b) s = next_slice(P, dir, s, 0);
  if (s.mg > 0) return;  // the same weights as the chunk's first group
  const Layer& L = P.L[s.layer];
  const bf16* W = w.p[2 * s.layer];
  const int kk = L.k * L.k, row = (s.s1 - s.s0) * 16 + 8;
  for (int e = threadIdx.x; e < s.cw * row; e += kThreads) {
    const int r = s.r0 + e / row, q = e % row, st = s.s0 + q / 16, j = q % 16;
    int co, ci = 0, tap = 0;
    if (q >= row - 8) {
      co = L.Co;
    } else if (dir == 1) {
      const int cpo = L.C16o / 16;
      ci = r;
      tap = st / cpo;
      co = (st % cpo) * 16 + j;
    } else if (L.pair) {
      co = r;
      ci = j & 3;
      tap = st * L.k + (j >> 2);
      if ((j >> 2) >= L.k) co = L.Co;
    } else {
      const int cps = L.C16i / 16;
      co = r;
      tap = st / cps;
      ci = (st % cps) * 16 + j;
    }
    bf16 v = rn(0.f);
    if (co < L.Co && ci < L.Ci) v = W[((size_t)co * L.Ci + ci) * kk + tap];
    packed[s.off + e] = v;
  }
}

// The forward over a tile of P.F frames: x [N, H, W, C0] → out [N, out_dim]
// (not written when null); with `stash`, each frame's activation record
// (the halo'd CoordConv input, every layer's output but the head's, each
// [position][C16]) at stash[n · P.stash].
__global__ void __launch_bounds__(kThreads)
encoder_bf16_tc_fwd_kernel(const __grid_constant__ Plan Pp, const __grid_constant__ WeightPtrs w,
                           const bf16* __restrict__ x, const float* __restrict__ coords,
                           const bf16* __restrict__ packed, bf16* __restrict__ out,
                           bf16* __restrict__ stash, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Plan sP;
  const Plan& P = shared_plan(Pp, sP);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  bf16* zero = reinterpret_cast<bf16*>(smem + 16);
  const int F = P.F;
  bf16* buf[2];
  buf[0] = reinterpret_cast<bf16*>(smem + 32);
  buf[1] = buf[0] + F * P.fbuf[0];
  bf16* WB[2];
  WB[0] = buf[1] + F * P.fbuf[1];
  WB[1] = WB[0] + P.cap / 2;
  float* red = reinterpret_cast<float*>(WB[1] + P.cap / 2);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * F, nf = min(F, N - n0);

  Slice sl = make_slice(P, 0, 0, 0, 0, 0);
  if (tid == 0) {
    fconv::mbar_init(&bar[0]);
    fconv::mbar_init(&bar[1]);
    load_slice(sl, packed, WB[0], &bar[0]);
  }
  if (tid < 8) zero[tid] = rn(0.f);
  // The CoordConv input with a zero halo, 4 channels a position: one
  // 8-byte store a position.
  {
    const int Hh = P.H + 2, Wh = P.W + 2, npx = Hh * Wh;
    for (int i = tid; i < F * npx; i += kThreads) {
      const int f = i / npx, pos = i - f * npx, hy = pos / Wh, hx = pos - hy * Wh;
      __align__(8) bf16 v[4] = {rn(0.f), rn(0.f), rn(0.f), rn(0.f)};
      if (hy >= 1 && hy <= P.H && hx >= 1 && hx <= P.W) {
        const int y = hy - 1, xx = hx - 1;
        for (int c = 0; c < P.C0; ++c) {
          if (f < nf) v[c] = __ldg(x + ((size_t)(n0 + f) * P.H + y) * P.W * P.C0 + xx * P.C0 + c);
        }
        if (P.Cin > P.C0) {
          v[P.C0] = rn(coords[y]);
          v[P.C0 + 1] = rn(coords[P.H + xx]);
        }
      }
      const uint2 u = *reinterpret_cast<const uint2*>(v);
      *reinterpret_cast<uint2*>(buf[0] + f * P.fbuf[0] + 4 * pos) = u;
      if (stash != nullptr && f < nf) {
        *reinterpret_cast<uint2*>(stash + (size_t)(n0 + f) * P.stash + 4 * pos) = u;
      }
    }
  }
  __syncthreads();  // the mbarriers and the input map are in place

  float acc[kSlots][8];
  for (int i = 0; sl.layer >= 0; ++i) {
    if (tid == 0) {
      const Slice nx = next_slice(P, 0, sl, 0);
      if (nx.layer >= 0) load_slice(nx, packed, WB[(i + 1) & 1], &bar[(i + 1) & 1]);
    }
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);

    const int l = sl.layer;
    const Layer& L = P.L[l];
    // the layer's numbers in registers for the loops below
    const int Lk = L.k, Ls = L.s, Lp = L.p, Hi = L.Hi, Wi = L.Wi, Wo = L.Wo, Co = L.Co;
    const int C16o = L.C16o, mode = L.mode, pair = L.pair, mtc = sl.mtg, m0 = sl.m0;
    const int st_out = L.st_out, npos = L.Ho * Wo, tasks = mtc * (sl.cw / 16), cps = L.C16i / 16;
    const int ibsz = P.fbuf[l & 1], obsz = P.fbuf[(l + 1) & 1];
    const int istride = 2 * (L.C16i + 8), ostride = L.C16o + 8;  // bytes, elements
    const int sp = (sl.s1 - sl.s0) * 16 + 8, s0 = sl.s0, r0 = sl.r0;  // the slice's row stride
    const unsigned in_s = saddr(buf[l & 1]), zero_s = saddr(zero), w_s = saddr(WB[i & 1]);
    bf16* ob = buf[(l + 1) & 1];

    // k-steps [ka, kb) of task (m-tile, n-pair) into a[8]: a k-step is a
    // tap and 16 input channels (layer 0: a row of taps, two a 16-byte row).
    auto run = [&](int task, int ka, int kb, float* a8) {
      if (ka >= kb) return;
      const int mt = m0 + task % mtc, np = task / mtc;
      const int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, q = lane >> 4;
      const int f = m / npos, opos = m - f * npos, oy = opos / Wo, ox = opos - oy * Wo;
      const bool row_ok = f < F;
      const unsigned abase = in_s + (row_ok ? f : 0) * ibsz * 2;
      unsigned bp = w_s + 2 * ((np * 16 + (lane & 7) + (lane >> 4) * 8) * sp +
                               ((lane >> 3) & 1) * 8 + (ka - s0) * 16);
      int tap = ka / cps, cs = ka - tap * cps, ky = tap / Lk, kx = tap - ky * Lk;
      unsigned ap = zero_s, astep = 0;  // the tap's row and its step a k-step
      auto locate = [&]() {
        if (pair) {
          ap = row_ok ? abase + 8 * ((2 * oy + tap) * (P.W + 2) + 2 * ox + 2 * q) : zero_s;
          astep = 0;
          return;
        }
        const int iy = oy * Ls - Lp + ky, ix = ox * Ls - Lp + kx;
        const bool ok = row_ok && iy >= 0 && iy < Hi && ix >= 0 && ix < Wi;
        ap = ok ? abase + (iy * Wi + ix) * istride + 16 * q : zero_s;
        astep = ok ? 32 : 0;
      };
      locate();
      auto advance = [&]() {
        if (++cs == cps) {
          cs = 0;
          ++tap;
          if (++kx == Lk) {
            kx = 0;
            ++ky;
          }
          locate();
        }
        bp += 32;
      };
      // Even k-steps into a[8], odd ones into b8 (two chains of products),
      // each step's fragments loaded while the step before multiplies.
      float b8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      unsigned af[4], bfr[4], an[4], bn[4];
      ldsm4(af, ap + cs * astep);
      ldsm4(bfr, bp);
      for (int st = ka; st < kb; st += 2) {
        const bool odd = st + 1 < kb;
        if (odd) {
          advance();
          ldsm4(an, ap + cs * astep);
          ldsm4(bn, bp);
        }
        mma(a8, af, bfr[0], bfr[1]);
        mma(a8 + 4, af, bfr[2], bfr[3]);
        if (!odd) break;
        if (st + 2 < kb) {
          advance();
          ldsm4(af, ap + cs * astep);
          ldsm4(bfr, bp);
        }
        mma(b8, an, bn[0], bn[1]);
        mma(b8 + 4, an, bn[2], bn[3]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) a8[e] += b8[e];
    };
    // The epilogue of task (m-tile, n-pair) from its sums a[8]: bias, skip
    // and ELU in f32, one bf16 rounding, to the map and the record.
    auto emit = [&](int task, const float* a8) {
      const int mt = m0 + task % mtc, np = task / mtc;
      const bf16* bias = w.p[2 * l + 1];
      float bv[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int co = r0 + np * 16 + j * 8 + 2 * (lane & 3);
        bv[j][0] = co < Co ? f32(__ldg(bias + co)) : 0.f;
        bv[j][1] = co + 1 < Co ? f32(__ldg(bias + co + 1)) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + (lane >> 2) + h * 8, f = m / npos, opos = m - f * npos;
        if (f >= F) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = r0 + np * 16 + j * 8 + 2 * (lane & 3);
          float v0 = a8[4 * j + 2 * h] + bv[j][0];
          float v1 = a8[4 * j + 2 * h + 1] + bv[j][1];
          if (mode == kHead) {
            if (f < nf && out != nullptr) {
              if (co < Co) out[(size_t)(n0 + f) * Co + co] = rn(v0);
              if (co + 1 < Co) out[(size_t)(n0 + f) * Co + co + 1] = rn(v1);
            }
            continue;
          }
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(ob + f * obsz + opos * ostride + co);
          if (mode == kResidual) {
            const float2 s2 = __bfloat1622float2(*o);
            v0 = s2.x + v0;
            v1 = s2.y + v1;
          }
          const __nv_bfloat162 r = __floats2bfloat162_rn(elu(v0), elu(v1));
          *o = r;
          if (stash != nullptr && f < nf) {
            *reinterpret_cast<__nv_bfloat162*>(stash + (size_t)(n0 + f) * P.stash + st_out +
                                               opos * C16o + co) = r;
          }
        }
      }
    };

    schedule(sl, tasks, acc, red, run, emit);
    __syncthreads();  // the layer's outputs are in place; slice i's buffer is free
    sl = next_slice(P, 0, sl, 0);
  }
}

// Pack the weights, then run the forward on `stream`.
inline cudaError_t launch_forward(const WeightPtrs& w, const Plan& P, const bf16* x,
                                  const float* coords, bf16* packed, bf16* out, bf16* stash,
                                  int N, cudaStream_t stream) {
  // the transposed slices too where the backward follows (stash)
  const int slices = P.slices[0] + (stash != nullptr ? P.slices[1] : 0);
  encoder_bf16_tc_pack_kernel<<<slices, kThreads, 0, stream>>>(w, P, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encoder_bf16_tc_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.fsmem);
  if (err != cudaSuccess) return err;
  encoder_bf16_tc_fwd_kernel<<<(N + P.F - 1) / P.F, kThreads, P.fsmem, stream>>>(
      P, w, x, coords, packed, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fbf
