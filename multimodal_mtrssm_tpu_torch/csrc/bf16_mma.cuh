// The tensor-core pieces of the bf16 fused conv kernels, shared by the
// encoder's (fused_encoder_bf16.cuh) and the decoder's
// (fused_decoder_bf16.cuh): how a GEMM direction's packed weights are cut
// into slices that the Hopper bulk copy streams into two shared-memory
// buffers, the walk of those slices, the mma.sync.m16n8k16 bf16 instruction
// and its ldmatrix fragment loads, the split of an f32 cotangent into two
// bf16 terms, and the schedule of a slice's tasks (m-tile × n-pair) on a
// block's 8 warps.
//
// A stack's Plan provides cut(dir, i), the Cut of GEMM i of direction dir
// (0: the forward's GEMMs in order, 1: the transposed ones, walked down),
// and count(dir), how many GEMMs direction dir has.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "conv_common.cuh"

namespace bmma {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;          // tasks a warp holds across a chunk's slices

// How a GEMM direction cuts a layer's packed weights: R rows (output
// channels forward, input channels transposed; a multiple of 16) of KS
// k-steps, in chunks of cw rows, each in nsl slices of ks k-steps (the last
// may be shorter), at `off` (bf16 elements) in the packed weights. A row of
// a slice of j k-steps is j·16 + 8 elements. mt m-tiles a tile of frames,
// in nmg groups of mgt, no more than the warps hold at once: a chunk's
// slices stream once for each group.
struct Cut {
  int R, KS, cw, ks, nsl, off, mt, mgt, nmg;
};

// Cut a direction's weights (see Cut) under `cap` bytes a slice.
inline bool make_cut(Cut& c, int R, int KS, int mt, int cap, int& packed) {
  c.R = R;
  c.KS = KS;
  c.mt = mt;
  c.mgt = std::min(mt, kWarps * kSlots);
  c.nmg = (mt + c.mgt - 1) / c.mgt;
  c.cw = std::min(R, 16 * (kWarps * kSlots / c.mgt));
  c.cw = std::min(c.cw, cap / 48 / 16 * 16);  // rows of one k-step (24 elements) fit
  const int ksmax = (cap / (2 * c.cw) - 8) / 16;
  if (c.cw < 16 || ksmax < 1) return false;
  c.ks = (KS + (KS + ksmax - 1) / ksmax - 1) / ((KS + ksmax - 1) / ksmax);
  c.nsl = (KS + c.ks - 1) / c.ks;
  c.off = packed;
  packed += R * (KS * 16 + 8 * c.nsl);
  return true;
}

// Slices of each direction of a plan.
template <class Plan>
inline void count_slices(Plan& p) {
  for (int dir = 0; dir < 2; ++dir) {
    p.slices[dir] = 0;
    for (int i = 0; i < p.count(dir); ++i) {
      const Cut c = p.cut(dir, i);
      p.slices[dir] += ((c.R + c.cw - 1) / c.cw) * c.nmg * c.nsl;
    }
  }
}

// ---- weight slices -------------------------------------------------------------------------

// A slice of a direction's packed weights: GEMM (layer), chunk, m-group and
// slice index, rows [r0, r0 + cw), k-steps [s0, s1), at `off`; first and
// last of its chunk's pass for the group; the group's m-tiles [m0, m0 + mtg).
struct Slice {
  int layer, chunk, mg, j, r0, cw, s0, s1, off, first, last, m0, mtg;
};

template <class Plan>
__host__ __device__ __forceinline__ Slice make_slice(const Plan& P, int dir, int l, int chunk,
                                                    int mg, int j) {
  const Cut c = P.cut(dir, l);
  Slice s;
  s.layer = l;
  s.chunk = chunk;
  s.mg = mg;
  s.j = j;
  s.m0 = mg * c.mgt;
  s.mtg = c.mt - s.m0 < c.mgt ? c.mt - s.m0 : c.mgt;
  s.r0 = chunk * c.cw;
  s.cw = c.R - s.r0 < c.cw ? c.R - s.r0 : c.cw;
  s.s0 = j * c.ks;
  s.s1 = c.KS - s.s0 < c.ks ? c.KS : s.s0 + c.ks;
  s.off = c.off + s.r0 * (c.KS * 16 + c.nsl * 8) + s.cw * j * (c.ks * 16 + 8);
  s.first = j == 0;
  s.last = s.s1 == c.KS;
  return s;
}

// The slice after s in its direction's order (the forward's GEMMs up, the
// transposed ones down to `stop`); its layer is -1 past the end.
template <class Plan>
__host__ __device__ __forceinline__ Slice next_slice(const Plan& P, int dir, const Slice& s,
                                                    int stop) {
  const Cut c = P.cut(dir, s.layer);
  if (!s.last) return make_slice(P, dir, s.layer, s.chunk, s.mg, s.j + 1);
  if (s.mg + 1 < c.nmg) return make_slice(P, dir, s.layer, s.chunk, s.mg + 1, 0);
  if (s.r0 + s.cw < c.R) return make_slice(P, dir, s.layer, s.chunk + 1, 0, 0);
  const int nl = dir == 0 ? s.layer + 1 : s.layer - 1;
  if (dir == 0 ? nl < P.count(0) : nl >= stop) return make_slice(P, dir, nl, 0, 0, 0);
  Slice end = s;
  end.layer = -1;
  return end;
}

__host__ __device__ __forceinline__ int slice_bytes(const Slice& s) {
  return s.cw * ((s.s1 - s.s0) * 16 + 8) * 2;
}

namespace {

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(x) - 1.f; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rn(float v) { return __float2bfloat16_rn(v); }

// ---- tensor-core primitives -----------------------------------------------------------------

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a · b on the tensor cores: a a 16×16 bf16 fragment, b 16×8, c 16×8 f32.
__device__ __forceinline__ void mma(float* c, const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack2(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// The two bf16 terms of a pair of f32 cotangents: hi = bf16(d), lo = bf16(d - hi).
__device__ __forceinline__ void split2(float2 d, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(d.x, d.y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack2(h);
  lo = pack2(__floats2bfloat162_rn(d.x - hf.x, d.y - hf.y));
}

// The plan, copied into shared memory by the block: the kernels read its
// layer table at the layer at hand, which from the parameter space is a
// dependent constant-cache load a field.
template <class Plan>
__device__ __forceinline__ const Plan& shared_plan(const Plan& Pp, Plan& sP) {
  const int* src = reinterpret_cast<const int*>(&Pp);
  int* dst = reinterpret_cast<int*>(&sP);
  for (int i = threadIdx.x; i < (int)(sizeof(Plan) / 4); i += kThreads) dst[i] = src[i];
  __syncthreads();
  return sP;
}

// Thread 0 starts slice s of direction `dir` into buffer `dst` on `bar`.
__device__ __forceinline__ void load_slice(const Slice& s, const bf16* packed, bf16* dst,
                                           unsigned long long* bar) {
  fconv::bulk_load(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(packed + s.off),
                   slice_bytes(s), bar);
}

// A slice's tasks on the block's warps: the tasks (m-tile, n-pair) of its
// m-group. run(task, ka, kb, a) adds k-steps [ka, kb) of a task to its 8
// sums a; emit(task, a) is its epilogue. A warp holds tasks warp + 8t
// (t < kSlots) across the group's slices; with fewer than 8 tasks the
// S = 8 / tasks warps of a task split each slice's k-steps, and at the
// group's last slice the sums of splits 1.. S-1 are added to split 0's in
// order through `red`.
template <class Run, class Emit>
__device__ __forceinline__ void schedule(const Slice& sl, int tasks, float (&acc)[kSlots][8],
                                         float* red, Run run, Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = tasks >= kWarps ? 1 : kWarps / tasks;
  const int split = S == 1 ? 0 : warp / tasks;
  if (sl.first) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[t][e] = 0.f;
    }
  }
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int task = S == 1 ? warp + kWarps * t : (t == 0 ? warp % tasks : tasks);
    if (task < tasks && split < S) {
      const int n = sl.s1 - sl.s0;
      run(task, sl.s0 + n * split / S, sl.s0 + n * (split + 1) / S, acc[t]);
    }
  }
  if (!sl.last) return;
  if (S == 1) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      if (warp + kWarps * t < tasks) emit(warp + kWarps * t, acc[t]);
    }
    return;
  }
  if (split > 0 && split < S) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(((split - 1) * tasks + warp % tasks) * 8 + e) * 32 + lane] = acc[0][e];
    }
  }
  __syncthreads();
  if (split == 0) {
    for (int q = 1; q < S; ++q) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[0][e] += red[(((q - 1) * tasks + warp) * 8 + e) * 32 + lane];
      }
    }
    emit(warp, acc[0]);
  }
}

}  // namespace
}  // namespace bmma
