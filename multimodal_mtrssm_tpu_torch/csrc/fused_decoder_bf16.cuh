// The conv decoder in bf16 on the H100's tensor cores: shared code of
// fused_decoder_bf16_fwd.cu and fused_decoder_bf16_bwd.cu.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) and ::_bwd_kernel (line 461) at dtype=bfloat16, as
// fused_decoder_apply (line 766) reaches them for bf16 features (line 781:
// dtype = feats.dtype; build_decoder_operators, line 686, casts every
// operator to it). The numerics are JAX's _layer_fwd (lines 266-299) and
// _walk_bwd (line 331) at bf16: features, weights, activations and frames
// are bf16 values; each layer sums its products in f32, adds the bias and
// applies ELU (the residual skip added before it) or the last layer's Tanh
// in f32, then rounds its output to bf16 (round to nearest even). The
// backward recomputes those activations, keeps every cotangent in f32,
// takes each activation derivative from the rounded output (ELU o > 0 ? 1 :
// o + 1, Tanh 1 − o², JAX's _act_deriv), sums the weight gradients in f32
// (JAX's f32 accumulators, lines 542-547) and rounds the features'
// cotangent and the weight gradients to bf16 at the end (line 554). Unlike
// JAX it does not round the cotangent to bf16 where JAX cuts the stack into
// four segments (the linears and the residual stack, then one a transposed
// conv, line 547): here there is one stack, as in the bf16 encoder.
//
// What bounds it: operations, ~5.9 M multiply-adds a frame at 48-wide
// features, 83% in the six residual 3×3 convs at 4×4 (64↔128), ~0.0029 ms
// a forward at N=240 at the card's 989 TFLOP/s bf16; bytes are a few
// hundred KB a call. The design is the bf16 encoder's (fused_encoder_bf16.cuh,
// on the pieces of bf16_mma.cuh): every layer of all three passes an
// implicit GEMM on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, a
// bf16 product exact and the sum f32, so the kernels keep the plain
// version's numerics up to the order of the sums. mma.sync rather than
// wgmma for the encoder's reason: the 4×4 layers give 16 rows a frame, and
// a block takes a tile of P.F = 2 frames (1 where shared memory needs it),
// so that N=240 still fills the card. The layers, as GEMMs of the forward:
// - the first linear F → lin0 and the unflatten lin0 → c0·h0·w0 (JAX's
//   (c, h, w) order, one bias an output element): 1×1 GEMMs on the 1×1 map,
//   M = the tile's frames in one m-tile (14 of its 16 rows zero), N = the
//   output units (the unflatten's c·16 + position, channels padded to 16),
//   K = the input width. Weights as the A operand would save half of their
//   products, but they are 1.2% of the work: one code path for every layer
//   was worth more than ~3% of the forward's tensor-core instructions;
// - the 1×1 projection and the residual 3×3 convs: M = frames × 16
//   positions, N = Co, K = taps × Ci, a padding tap's row at 16 zero bytes;
// - each k4 s2 p1 transposed conv as four GEMMs, one an output-parity class
//   (py, px): the class's positions (2ry + py, 2rx + px) take the taps ky =
//   1 − py + 2a, kx = 1 − px + 2b (a, b ∈ {0, 1}) at input (ry + py − a,
//   rx + px − b), a dense 2×2-tap conv: M = frames × Hi·Wi class positions,
//   N = Co, K = 4 taps × Ci. The last (one output channel) takes one n8
//   tile of its n-pair.
// Maps live in shared memory as bf16, HWC, channels padded to 16 and a row
// stride of C16 + 8 (ldmatrix free of bank conflicts); the GEMMs alternate
// between two map buffers (a residual block's second conv writes over its
// skip in place); the last layer writes the frames and no map. Weights are
// packed per GEMM as [rows][k-steps × 16] bf16 and stream through two
// buffers by the bulk copy on mbarriers, the next slice in flight while one
// computes; a warp's task is an m-tile and an n-pair; narrow GEMMs split
// their k-steps over warps and add the sums in a fixed order. Measured with
// global-timer stamps (chip_smoke.py --bf16-decoder-stamps, PERF.md §6), a
// block waits little for its weights and spends a slice's time in the
// latency of its products and epilogue, whatever the slice's size: so the
// slices are as large as two blocks an SM allow (kSliceCap), and rows split
// by shifts (every map is 1, 4, 8, 16 or 32 wide).
//
// The backward (fused_decoder_bf16_bwd.cu) records the forward's bf16
// outputs, then:
// - the cotangent pass walks the layers down on a tile of frames, each
//   layer's input cotangent a GEMM M = frames × input positions, N = Ci, K =
//   taps × Co on its pre-activation cotangent held as two bf16 terms, hi =
//   bf16(d) and lo = bf16(d − hi) (split2), two products a k-step: a conv's
//   the transposed conv of its stride 1; a transposed conv's the direct
//   stride-2 conv dx[i] = Σ over t, co of dpre[2i − 1 + t][co] · W[ci][co][t]
//   (16 taps); the unflatten's a GEMM over its 16 output positions; the
//   last layer's, whose single output channel gives 16 taps × 1 channel,
//   one k-step, its A fragments gathered from an f32 map with a zero halo;
//   the largest map (the last transposed conv's input's, 16×16) read from
//   the record rather than kept in shared memory, so that two blocks share
//   an SM;
// - the weight-gradient pass is one GEMM a layer, dW[(tap, ci), co] = Σ
//   over (frame, position) of A · dpre, A the im2col view of the bf16
//   records and dpre the split record; a transposed conv's rows are taken a
//   class at a time (its pre-activation cotangent recorded class-major, so
//   that a class's positions are contiguous) and its bias over all
//   positions; the unflatten's K is the frames alone, its N every (position,
//   channel); a conv's bias is one more m-tile whose A is ones. Frame chunks
//   are staged by cp.async, each thread's 16-byte copies fixed for the block
//   (no division in the staging loops, which otherwise cost as much as the
//   products), two blocks an SM; the grid runs the longest tiles (the
//   transposed convs') first, and the chunks are added in a fixed order.
// No float atomics anywhere: two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "bf16_mma.cuh"

namespace fdbf {

using namespace bmma;

constexpr int kMaxLayers = 14;     // 2 linears, the projection, 8 residual convs, 3 transposed
constexpr int kMaxGemms = kMaxLayers + 3 * 3;  // a transposed conv is 4 GEMMs forward
constexpr int kMaxFrames = 2;      // frames a block of the forward and the cotangent pass
// Bytes of a weight-slice buffer, forward and transposed: the most that
// leaves two blocks an SM (the forward's registers allow no more; the
// cotangent pass's shared memory, with the plan's static copy, no more).
constexpr int kSliceCap[2] = {32768, 24576};
// Bytes of a weight-gradient staging buffer, where they fit: two blocks an
// SM, each with its two buffers and its plan's static copy.
constexpr int kStageCap = 55296;
constexpr int kDwRows = 12;        // m-tiles of a weight-gradient block, at most
constexpr int kClasses = 4;        // output-parity classes of a k4 s2 p1 transposed conv
constexpr int kRedFloats = (kWarps - 1) * 32 * 8;  // the split sums of the forward passes
enum Kind { kConv = 0, kDeconv = 1, kUnflatten = 2 };

// ops/kernels/build.py::DecDims, field for field: N frames of F features,
// the first linear's width, conv_in_shape (c0, h0, w0), the residual
// stack's input and intermediate widths and block count, the three
// transposed convs' output channels, frames a block (not read: the plan
// picks its own), and frames a chunk of the weight-gradient pass.
struct DecDims {
  int N, F, lin0, c0, h0, w0, res_in, res_mid, n_res, ch0, ch1, ch2, frames, chunk;
};

struct Layer {
  int kind, last, residual;   // residual: out = elu(x + conv(t)), x its output map in place
  int Hi, Wi, Ci, Ho, Wo, Co; // the torch layer's maps
  int k, p;                   // a conv's kernel and padding (the linears 1, 0; the
                              // unflatten 1, 0 as the forward's 1×1 GEMM); a transposed
                              // conv's 4, 1
  int C16i, C16o;             // channels rounded up to 16
  int ibuf;                   // the forward's map buffer of its input; its output in the other
  int acc_in;                 // its input also feeds the next layer's residual skip
  int st_in, st_out;          // per-frame offsets (bf16) in the activation record of its input
                              // and output ([position][C16]; the last layer's [position])
  int dp_off, dps;            // its pre-activation cotangent in the cotangent record: offset
                              // (bf16) a frame, hi then lo halves of Ho·Wo positions (a
                              // transposed conv's class-major) × dps (C16o, or 8 where Co ≤ 8)
  int one;                    // the cotangent pass takes its 16 taps × 1 channel as one k-step
  int aglob;                  // the cotangent pass reads its output's cotangent from the record,
                              // not from a shared-memory map
  int g_off;                  // gradient elements before its weight (torch layout, bias after)
  Cut c;                      // forward weights (a transposed conv: class 0's, class q's at
  int csize;                  // c.off + q · csize)
  Cut t;                      // transposed weights
  // The weight-gradient pass: row tiles of rt m-tiles (`pertap`: each within
  // one tap, a window of rt·16 channels), column tiles of ct n-tiles, frames
  // a stage, bf16 elements a staged frame of activations and of each
  // cotangent half, the first tile; a transposed conv's bias (its own K over
  // every position, A = ones, staged a quarter frame at a time): column
  // tiles, quarters a stage and bf16 a staged quarter of each cotangent half.
  int rt, nrt, pertap, ct, nct, fs, apf, dpf, tile0;
  int bct, bnct, bfs, bdpf;
};

struct Plan {
  int n, ng, F, Fin;
  Layer L[kMaxLayers];
  int G[kMaxGemms];  // the forward's GEMMs: layer << 2 | output-parity class
  int stash;         // bf16 elements a frame of the activation record
  int dstash;        // bf16 elements a frame of the cotangent record (both halves)
  int packed;        // bf16 elements of the packed weights, both directions
  int grads;         // gradient elements, all tensors back to back (torch layout)
  int slices[2];     // weight slices of each direction
  int dw_tiles;      // tiles of the weight-gradient pass
  int fbuf[2];       // bf16 elements a frame of the forward's two map buffers
  int bbuf[2];       // bf16 elements a frame of the cotangent pass's two map buffers (hi, lo)
  int sbuf;          // floats a frame of its residual-skip buffer
  int halo;          // floats a frame of its haloed map of the last layer's cotangent
  int cap[2];        // bytes of a weight-slice buffer, forward and transposed
  size_t fsmem, bsmem, wsmem;

  __host__ __device__ Cut cut(int dir, int i) const {
    if (dir == 1) return L[i].t;
    const Layer& Lg = L[G[i] >> 2];
    Cut c = Lg.c;
    c.off += (G[i] & 3) * Lg.csize;
    return c;
  }
  __host__ __device__ int count(int dir) const { return dir == 0 ? ng : n; }
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

// A layer's torch weight elements (its bias follows them).
__host__ __device__ __forceinline__ int weight_size(const Layer& L) {
  if (L.kind == kUnflatten) return L.Co * L.Ho * L.Wo * L.Ci;
  return L.Co * L.Ci * (L.kind == kDeconv ? 16 : L.k * L.k);
}

// The weight-gradient tiling of one GEMM of layer L (see Layer): K runs over
// kpos positions a frame, each kcols record columns wide; m-tiles are taps ×
// C16i/16 (+ the bias's, `bias`); `rows` false for a bias alone (nothing
// staged of the activations). The largest row tile, then column tile, whose
// two staging buffers fit `cap` bytes; false where one frame does not.
inline bool make_dw(const Layer& L, int taps, int bias, bool rows, int kpos, int kcols, int F,
                    int cap, int& rt_out, int& nrt, int& pertap, int& ct_out, int& nct, int& fs,
                    int& apf, int& dpf) {
  const int cps = L.C16i / 16, mtw = rows ? taps * cps + bias : 1;
  const int rts[] = {kDwRows, 8, 4, 2, 1}, cts[] = {8, 4, 2, 1};
  for (int rt : rts) {
    for (int ct : cts) {
      const int c = std::min(ct, kcols / 8);
      if (ct > 1 && c < ct && ct / 2 >= kcols / 8) continue;  // a smaller ct is the same
      pertap = rows && L.C16i > rt * 16;
      apf = rows ? L.Hi * L.Wi * ((pertap ? rt * 16 : L.C16i) + 8) : 0;
      dpf = kpos * (c * 8 + 8);
      const int per = 2 * (apf + 2 * dpf);
      if (per > cap) continue;
      fs = std::max(1, std::min(cap / per, F));
      if (pertap) {
        nrt = taps * ((cps + rt - 1) / rt) + bias;  // the bias alone last
        rt_out = rt;
      } else {
        nrt = (mtw + rt - 1) / rt;
        rt_out = (mtw + nrt - 1) / nrt;
      }
      ct_out = c;
      nct = (kcols / 8 + c - 1) / c;
      return true;
    }
  }
  return false;
}

// The plan of a decoder; false where the widths need more layers than the
// table holds, the last layer has more than one output channel, or a
// block's shared memory does not fit one frame.
inline bool make_plan(const DecDims& d, Plan* out) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return false;
  }
  limit -= (int)sizeof(Plan);  // each kernel's copy of the plan (shared_plan)
  for (int F = kMaxFrames; F >= 1; --F) {
    Plan p = {};
    p.F = F;
    p.Fin = d.F;
    int hi = 1, wi = 1, ci = d.F;
    auto add = [&](int kind, int co, int ho, int wo, int k, int pad, int residual) -> bool {
      if (p.n == kMaxLayers) return false;
      Layer& L = p.L[p.n++];
      L = Layer{};
      L.kind = kind;
      L.Hi = hi; L.Wi = wi; L.Ci = ci;
      L.Ho = ho; L.Wo = wo; L.Co = co;
      L.k = k; L.p = pad; L.residual = residual;
      hi = ho; wi = wo; ci = co;
      return true;
    };
    bool ok = d.h0 == d.w0 && add(kConv, d.lin0, 1, 1, 1, 0, 0) &&
              add(kUnflatten, d.c0, d.h0, d.w0, 1, 0, 0);
    if (ok && d.n_res > 0 && ci != d.res_in) ok = add(kConv, d.res_in, hi, wi, 1, 0, 0);
    const int xc = ci;
    for (int r = 0; r < d.n_res && ok; ++r) {
      ok = add(kConv, d.res_mid, hi, wi, 3, 1, 0) && add(kConv, xc, hi, wi, 3, 1, 1);
    }
    const int ch[3] = {d.ch0, d.ch1, d.ch2};
    for (int i = 0; i < 3 && ok; ++i) ok = add(kDeconv, ch[i], 2 * hi, 2 * wi, 4, 1, 0);
    if (!ok || p.L[p.n - 1].Co != 1) return false;

    int stash = r16(d.F), dstash = 0, grads = 0, buf = 0;
    p.fbuf[0] = r16(d.F) + 8;  // the features' map
    for (int l = 0; l < p.n; ++l) {
      Layer& L = p.L[l];
      L.C16i = r16(L.Ci);
      L.C16o = r16(L.Co);
      L.last = l == p.n - 1;
      L.one = L.last;
      L.acc_in = l + 1 < p.n && p.L[l + 1].residual;
      L.st_in = l == 0 ? 0 : p.L[l - 1].st_out;
      L.st_out = stash;
      stash += L.last ? L.Ho * L.Wo : L.Ho * L.Wo * L.C16o;
      L.dps = L.Co <= 8 ? 8 : L.C16o;
      L.dp_off = dstash;
      dstash += 2 * L.Ho * L.Wo * L.dps;
      L.g_off = grads;
      grads += weight_size(L) + (L.kind == kUnflatten ? L.Co * L.Ho * L.Wo : L.Co);
      L.ibuf = buf;
      if (!L.last) {
        buf = 1 - buf;
        p.fbuf[buf] = std::max(p.fbuf[buf], L.Ho * L.Wo * (L.C16o + 8));
      }
      for (int q = 0; q < (L.kind == kDeconv ? kClasses : 1); ++q) {
        if (p.ng == kMaxGemms) return false;
        p.G[p.ng++] = l << 2 | q;
      }
    }
    if (stash % 8 != 0) return false;
    p.stash = stash;
    p.dstash = dstash;
    p.grads = grads;
    p.cap[0] = kSliceCap[0];
    p.cap[1] = kSliceCap[1];
    // The forward's cuts (a transposed conv's four classes back to back),
    // then the transposed ones.
    p.packed = 0;
    for (int l = 0; l < p.n && ok; ++l) {
      Layer& L = p.L[l];
      const bool dc = L.kind == kDeconv;
      // rows a frame: the class positions of a transposed conv, the unflatten's one
      const int npg = dc || L.kind == kUnflatten ? L.Hi * L.Wi : L.Ho * L.Wo;
      const int R = L.kind == kUnflatten ? L.C16o * L.Ho * L.Wo : L.C16o;
      const int before = p.packed;
      ok = make_cut(L.c, R, (dc ? 4 : L.k * L.k) * (L.C16i / 16), (F * npg + 15) / 16,
                    p.cap[0], p.packed);
      L.csize = p.packed - before;
      if (dc) p.packed += (kClasses - 1) * L.csize;
    }
    for (int l = 0; l < p.n && ok; ++l) {
      Layer& L = p.L[l];
      const int taps = L.kind == kDeconv ? 16 : L.kind == kUnflatten ? L.Ho * L.Wo : L.k * L.k;
      ok = make_cut(L.t, L.C16i, L.one ? 1 : taps * (L.C16o / 16), (F * L.Hi * L.Wi + 15) / 16,
                    p.cap[1], p.packed);
    }
    if (!ok) return false;
    count_slices(p);
    p.fsmem =
        32 + (size_t)F * 2 * (p.fbuf[0] + p.fbuf[1]) + 2 * (size_t)p.cap[0] + 4 * kRedFloats;
    // The cotangent pass: layer l writes the map of layer l − 1's
    // pre-activation cotangent (hi, lo) into buffer l & 1, unless layer l − 1
    // reads it from the record (aglob): the largest map (the last transposed
    // conv's input's), so that two blocks share an SM, and more while one
    // block does not fit.
    p.sbuf = 0;
    for (int l = 1; l < p.n; ++l) {
      const Layer& B = p.L[l - 1];
      if (B.residual) p.sbuf = std::max(p.sbuf, B.Ho * B.Wo * (B.C16o + 8));
    }
    const Layer& Lt = p.L[p.n - 1];
    p.halo = (Lt.Ho + 2) * (Lt.Wo + 2);
    p.halo += p.halo & 1;
    auto map = [&](int l) { return 2 * p.L[l].Ho * p.L[l].Wo * (p.L[l].C16o + 8); };
    auto bsmem = [&]() {
      p.bbuf[0] = p.bbuf[1] = 8;
      for (int l = 1; l < p.n; ++l) {
        if (!p.L[l - 1].aglob) p.bbuf[l & 1] = std::max(p.bbuf[l & 1], map(l - 1));
      }
      return 32 + (size_t)F * 2 * (p.bbuf[0] + p.bbuf[1]) + (size_t)F * 4 * (p.sbuf + p.halo) +
             2 * (size_t)p.cap[1] + 4 * kRedFloats;
    };
    for (bool first = true;; first = false) {
      p.bsmem = bsmem();
      if (!first && p.bsmem <= (size_t)limit) break;
      int big = -1;
      for (int l = 0; l + 1 < p.n; ++l) {
        if (!p.L[l].aglob && (big < 0 || map(l) > map(big))) big = l;
      }
      if (big < 0) break;
      p.L[big].aglob = 1;
    }
    if (p.fsmem > (size_t)limit || p.bsmem > (size_t)limit) continue;
    // The weight-gradient pass: staging under kStageCap where it fits, else all there is.
    const int wfix = 32 + 4 * kWarps * 32 * 48;
    size_t wsmem = 0;
    p.dw_tiles = 0;
    for (int l = 0; l < p.n && ok; ++l) {
      Layer& L = p.L[l];
      const bool dc = L.kind == kDeconv, uf = L.kind == kUnflatten;
      const int taps = dc ? 4 : L.k * L.k, bias = dc ? 0 : 1;
      const int kpos = uf ? 1 : dc ? L.Hi * L.Wi : L.Ho * L.Wo;
      const int kcols = uf ? L.Ho * L.Wo * L.dps : L.dps;
      for (int cap : {kStageCap, (limit - 32) / 2}) {
        ok = make_dw(L, taps, bias, true, kpos, kcols, cap == kStageCap ? d.chunk : 1, cap, L.rt,
                     L.nrt, L.pertap, L.ct, L.nct, L.fs, L.apf, L.dpf);
        if (ok) break;
      }
      L.tile0 = p.dw_tiles;
      p.dw_tiles += (dc ? kClasses : 1) * L.nrt * L.nct;
      wsmem = std::max(wsmem, (size_t)2 * 2 * L.fs * (L.apf + 2 * L.dpf));
      if (dc && ok) {
        int rt, nrt, pertap, apf;
        for (int cap : {kStageCap, (limit - 32) / 2}) {
          ok = make_dw(L, 0, 1, false, L.Hi * L.Wi, L.dps,
                       cap == kStageCap ? kClasses * d.chunk : 1, cap, rt, nrt, pertap, L.bct,
                       L.bnct, L.bfs, apf, L.bdpf);
          if (ok) break;
        }
        p.dw_tiles += L.bnct;
        wsmem = std::max(wsmem, (size_t)2 * 2 * 2 * L.bfs * L.bdpf);
      }
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

// The forward GEMM i's layer and output-parity class.
__host__ __device__ __forceinline__ const Layer& gemm_layer(const Plan& P, int i, int& cls) {
  cls = P.G[i] & 3;
  return P.L[P.G[i] >> 2];
}

// Pack one weight slice a block (blockIdx.x walks the forward slices, then
// the transposed ones). A forward row is an output unit: a conv's output
// channel, the unflatten's c·16 + position (torch row c·h·w + position);
// its k-step a tap and 16 input channels, a transposed conv's taps (a, b)
// of its GEMM's class. A transposed row is an input channel, its k-step a
// tap (a conv's and a transposed conv's torch tap, the unflatten's output
// position) and 16 output channels; the last layer's one k-step its 16 taps.
// Zeros past the channels and in each row's 8 padding elements.
__global__ void __launch_bounds__(kThreads)
decoder_bf16_tc_pack_kernel(WeightPtrs w, Plan P, bf16* __restrict__ packed) {
  int b = blockIdx.x, dir = 0;
  if (b >= P.slices[0]) {
    b -= P.slices[0];
    dir = 1;
  }
  Slice s = make_slice(P, dir, dir == 0 ? 0 : P.n - 1, 0, 0, 0);
  for (; b > 0; --b) s = next_slice(P, dir, s, 0);
  if (s.mg > 0) return;  // the same weights as the chunk's first group
  int cls = 0;
  const Layer& L = dir == 0 ? gemm_layer(P, s.layer, cls) : P.L[s.layer];
  const int l = dir == 0 ? P.G[s.layer] >> 2 : s.layer;
  const bf16* W = w.p[2 * l];
  const int kk = L.k * L.k, hw = L.Ho * L.Wo, row = (s.s1 - s.s0) * 16 + 8;
  for (int e = threadIdx.x; e < s.cw * row; e += kThreads) {
    const int r = s.r0 + e / row, q = e % row, st = s.s0 + q / 16, j = q % 16;
    bool ok = q < row - 8;
    size_t idx = 0;
    if (dir == 0) {
      const int cps = L.C16i / 16, tap = st / cps, ci = (st % cps) * 16 + j;
      ok = ok && ci < L.Ci;
      if (L.kind == kDeconv) {
        const int ky = 1 - (cls >> 1) + 2 * (tap >> 1), kx = 1 - (cls & 1) + 2 * (tap & 1);
        ok = ok && r < L.Co;
        idx = ((size_t)ci * L.Co + r) * 16 + ky * 4 + kx;
      } else if (L.kind == kUnflatten) {
        const int c = r / hw, pos = r % hw;
        ok = ok && c < L.Co;
        idx = ((size_t)c * hw + pos) * L.Ci + ci;
      } else {
        ok = ok && r < L.Co;
        idx = ((size_t)r * L.Ci + ci) * kk + tap;
      }
    } else if (L.one) {
      ok = ok && st == 0 && r < L.Ci;
      idx = ((size_t)r * L.Co) * 16 + j;
    } else {
      const int cpo = L.C16o / 16, tap = st / cpo, co = (st % cpo) * 16 + j;
      ok = ok && r < L.Ci && co < L.Co;
      if (L.kind == kDeconv) {
        idx = ((size_t)r * L.Co + co) * 16 + tap;
      } else if (L.kind == kUnflatten) {
        idx = ((size_t)co * hw + tap) * L.Ci + r;
      } else {
        idx = ((size_t)co * L.Ci + r) * kk + tap;
      }
    }
    packed[s.off + e] = ok ? W[idx] : rn(0.f);
  }
}

// The forward over a tile of P.F frames: features [N, Fin] → out [N, 32, 32,
// 1] (not written when null); with `stash`, each frame's activation record
// (the features, then every layer's output: [position][C16], the last
// layer's [position]) at stash[n · P.stash].
__global__ void __launch_bounds__(kThreads)
decoder_bf16_tc_fwd_kernel(const __grid_constant__ Plan Pp, const __grid_constant__ WeightPtrs w,
                           const bf16* __restrict__ feats, const bf16* __restrict__ packed,
                           bf16* __restrict__ out, bf16* __restrict__ stash, int N) {
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
  WB[1] = WB[0] + P.cap[0] / 2;
  float* red = reinterpret_cast<float*>(WB[1] + P.cap[0] / 2);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * F, nf = min(F, N - n0);

  Slice sl = make_slice(P, 0, 0, 0, 0, 0);
  if (tid == 0) {
    fconv::mbar_init(&bar[0]);
    fconv::mbar_init(&bar[1]);
    load_slice(sl, packed, WB[0], &bar[0]);
  }
  if (tid < 8) zero[tid] = rn(0.f);
  // The features (zeros past N and past Fin), in the first map and the record.
  {
    const int C16 = P.L[0].C16i;
    for (int i = tid; i < F * C16; i += kThreads) {
      const int f = i / C16, j = i - f * C16;
      const bf16 v = f < nf && j < P.Fin ? feats[(size_t)(n0 + f) * P.Fin + j] : rn(0.f);
      buf[0][f * P.fbuf[0] + j] = v;
      if (stash != nullptr && f < nf) stash[(size_t)(n0 + f) * P.stash + j] = v;
    }
  }
  __syncthreads();  // the mbarriers and the features' map are in place

  float acc[kSlots][8];
  for (int i = 0; sl.layer >= 0; ++i) {
    if (tid == 0) {
      const Slice nx = next_slice(P, 0, sl, 0);
      if (nx.layer >= 0) load_slice(nx, packed, WB[(i + 1) & 1], &bar[(i + 1) & 1]);
    }
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);

    int cls;
    const Layer& L = gemm_layer(P, sl.layer, cls);
    const int l = P.G[sl.layer] >> 2;
    // the GEMM's numbers in registers for the loops below: its rows are a
    // grid of npg positions a frame, gw wide (a transposed conv's class
    // positions, the unflatten's 1×1 input), tap (ty, tx) of a kt × kt grid
    // reads input (ry + oy0 + sg·ty, rx + ox0 + sg·tx); every map of a
    // decoder is 1, 4, 8, 16 or 32 wide, so rows split by shifts
    const bool dc = L.kind == kDeconv, uf = L.kind == kUnflatten;
    const int Hi = L.Hi, Wi = L.Wi, Wo = L.Wo, Co = L.Co, C16o = L.C16o;
    const int py = cls >> 1, px = cls & 1, gw = dc || uf ? Wi : Wo;
    const int npg = dc || uf ? Hi * Wi : L.Ho * Wo, lnpg = __ffs(npg) - 1, lgw = __ffs(gw) - 1;
    const int kt = dc ? 2 : L.k, oy0 = dc ? py : -L.p, ox0 = dc ? px : -L.p, sg = dc ? -1 : 1;
    const int cps = L.C16i / 16, mtc = sl.mtg, m0 = sl.m0, tasks = mtc * (sl.cw / 16);
    const int residual = L.residual, last = L.last, two = uf || Co > 8, st_out = L.st_out;
    const int ibsz = P.fbuf[L.ibuf], obsz = P.fbuf[1 - L.ibuf];
    const int istride = 2 * (L.C16i + 8), ostride = C16o + 8;  // bytes, elements
    const int sp = (sl.s1 - sl.s0) * 16 + 8, s0 = sl.s0, r0 = sl.r0;  // the slice's row stride
    const unsigned in_s = saddr(buf[L.ibuf]), zero_s = saddr(zero), w_s = saddr(WB[i & 1]);
    bf16* ob = buf[1 - L.ibuf];
    const bf16* bias = w.p[2 * l + 1];

    // k-steps [ka, kb) of task (m-tile, n-pair) into a[8]: a k-step is a
    // tap and 16 input channels.
    auto run = [&](int task, int ka, int kb, float* a8) {
      if (ka >= kb) return;
      const int mt = m0 + task % mtc, np = task / mtc;
      const int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, q = lane >> 4;
      const int f = m >> lnpg, r = m & (npg - 1), ry = r >> lgw, rx = r & (gw - 1);
      const bool row_ok = f < F;
      const unsigned abase = in_s + (row_ok ? f : 0) * ibsz * 2 + 16 * q;
      unsigned bp = w_s + 2 * ((np * 16 + (lane & 7) + (lane >> 4) * 8) * sp +
                               ((lane >> 3) & 1) * 8 + (ka - s0) * 16);
      int tap = ka / cps, cs = ka - tap * cps;
      unsigned ap = zero_s, astep = 0;  // the tap's row and its step a k-step
      auto locate = [&]() {
        const int ty = tap / kt, tx = tap - ty * kt;
        const int iy = ry + oy0 + sg * ty, ix = rx + ox0 + sg * tx;
        const bool ok = row_ok && iy >= 0 && iy < Hi && ix >= 0 && ix < Wi;
        ap = ok ? abase + (iy * Wi + ix) * istride : zero_s;
        astep = ok ? 32 : 0;
      };
      locate();
      auto advance = [&]() {
        if (++cs == cps) {
          cs = 0;
          ++tap;
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
        if (two) mma(a8 + 4, af, bfr[2], bfr[3]);
        if (!odd) break;
        if (st + 2 < kb) {
          advance();
          ldsm4(af, ap + cs * astep);
          ldsm4(bfr, bp);
        }
        mma(b8, an, bn[0], bn[1]);
        if (two) mma(b8 + 4, an, bn[2], bn[3]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) a8[e] += b8[e];
    };
    // The epilogue of task (m-tile, n-pair) from its sums a[8]: bias (the
    // unflatten's an element), skip and ELU (the last layer's Tanh) in f32,
    // one bf16 rounding, to the map, the record and (the last layer) the
    // frames.
    auto emit = [&](int task, const float* a8) {
      const int mt = m0 + task % mtc, np = task / mtc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + (lane >> 2) + h * 8, f = m >> lnpg;
        if (f >= F) continue;
        const int r = m & (npg - 1), ry = r >> lgw, rx = r & (gw - 1);
        const int opos = dc ? (2 * ry + py) * Wo + 2 * rx + px : r;
        bf16* rec = stash != nullptr && f < nf ? stash + (size_t)(n0 + f) * P.stash : nullptr;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = r0 + np * 16 + j * 8 + 2 * (lane & 3);  // the GEMM's column
          float v0 = a8[4 * j + 2 * h], v1 = a8[4 * j + 2 * h + 1];
          if (last) {
            if (j == 0 && co == 0) {
              const bf16 o = rn(tanhf(v0 + f32(__ldg(bias))));
              if (f < nf && out != nullptr) out[(size_t)(n0 + f) * L.Ho * Wo + opos] = o;
              if (rec != nullptr) rec[st_out + opos] = o;
            }
            continue;
          }
          if (uf) {  // columns co, co + 1: channel co / 16, positions co % 16 and the next
            const int hw = L.Ho * Wo, c = co / hw, pos = co - c * hw;
            const bool live = c < Co;
            const bf16 o0 = rn(live ? elu(v0 + f32(__ldg(bias + co))) : 0.f);
            const bf16 o1 = rn(live ? elu(v1 + f32(__ldg(bias + co + 1))) : 0.f);
            ob[f * obsz + pos * ostride + c] = o0;
            ob[f * obsz + (pos + 1) * ostride + c] = o1;
            if (rec != nullptr) {
              rec[st_out + pos * C16o + c] = o0;
              rec[st_out + (pos + 1) * C16o + c] = o1;
            }
            continue;
          }
          v0 += co < Co ? f32(__ldg(bias + co)) : 0.f;
          v1 += co + 1 < Co ? f32(__ldg(bias + co + 1)) : 0.f;
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(ob + f * obsz + opos * ostride + co);
          if (residual) {
            const float2 s2 = __bfloat1622float2(*o);
            v0 = s2.x + v0;
            v1 = s2.y + v1;
          }
          const __nv_bfloat162 res = __floats2bfloat162_rn(elu(v0), elu(v1));
          *o = res;
          if (rec != nullptr) {
            *reinterpret_cast<__nv_bfloat162*>(rec + st_out + opos * C16o + co) = res;
          }
        }
      }
    };

    schedule(sl, tasks, acc, red, run, emit);
    __syncthreads();  // the GEMM's outputs are in place; slice i's buffer is free
    sl = next_slice(P, 0, sl, 0);
  }
}

// Pack the weights (the transposed slices too where the backward follows:
// `stash`), then run the forward on `stream`.
inline cudaError_t launch_forward(const WeightPtrs& w, const Plan& P, const bf16* feats,
                                  bf16* packed, bf16* out, bf16* stash, int N,
                                  cudaStream_t stream) {
  const int slices = P.slices[0] + (stash != nullptr ? P.slices[1] : 0);
  decoder_bf16_tc_pack_kernel<<<slices, kThreads, 0, stream>>>(w, P, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decoder_bf16_tc_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.fsmem);
  if (err != cudaSuccess) return err;
  decoder_bf16_tc_fwd_kernel<<<(N + P.F - 1) / P.F, kThreads, P.fsmem, stream>>>(
      P, w, feats, packed, out, stash, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fdbf
