// What the recurrence backwards' three passes share (recurrence_bwd.cu, the
// MRSSM backward, and recurrence_mt_bwd.cu, the MMTRSSM backward; both
// forwards' and both rollouts' stages too, through forward_chain.cuh): the
// bulk copy (TMA) on an mbarrier; the weights in torch layout by the bulk
// copy (stage_raw), and the recompute's staging, transposed from there in
// shared memory to the [in, out] layout the forward's device functions
// read; and the carry-only chain's pieces — the weight columns it
// transposes, staged row by row into rows padded off a multiple of 32
// floats, and each phase's outputs as dots split over up to 32 lanes and
// added by full-mask shuffles in a fixed order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "mrssm_common.cuh"

namespace chain {

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// One arrival on `bar` that expects `bytes` of bulk copies, and a bulk copy
// that completes on it (conv_common.cuh's bulk_load is the two for one copy).
__device__ __forceinline__ void bulk_expect(unsigned long long* bar, int bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(fconv::smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(fconv::smem_addr(dst)), "l"(src), "r"(bytes), "r"(fconv::smem_addr(bar)) : "memory");
}

// Floats of a recompute block's staging area: the weights in torch layout,
// each from a multiple of 4 floats.
__host__ __device__ inline int raw_floats(const mrssm::WeightDims& d) {
  int n = 0;
  for (int i = 0; i < d.n; ++i) n += round4(d.in[i] * d.out[i]);
  return n;
}

// Copy the weights in torch layout into `raw`, each tensor from a multiple
// of 4 floats (raw_floats in all): by the bulk copy, on one arrival on `bar`
// expecting all their bytes; a tensor not 16-byte aligned, and the last
// floats of one whose size is no multiple of 4, by the threads. Every thread
// calls it; the block synchronises inside and after.
__device__ __forceinline__ void stage_raw(float* raw, const mrssm::WeightPtrs& w,
                                          const mrssm::WeightDims& d, unsigned long long* bar) {
  if (threadIdx.x == 0) fconv::mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    int bytes = 0;
    for (int i = 0; i < d.n; ++i) {
      if ((reinterpret_cast<uintptr_t>(w.p[i]) & 15) == 0) bytes += (d.in[i] * d.out[i] & ~3) * 4;
    }
    bulk_expect(bar, bytes);
    for (int i = 0, off = 0; i < d.n; off += round4(d.in[i] * d.out[i]), ++i) {
      const int nb = (d.in[i] * d.out[i] & ~3) * 4;
      if ((reinterpret_cast<uintptr_t>(w.p[i]) & 15) == 0 && nb > 0) {
        bulk_copy(raw + off, w.p[i], nb, bar);
      }
    }
  }
  for (int i = 0, off = 0; i < d.n; off += round4(d.in[i] * d.out[i]), ++i) {
    const int n = d.in[i] * d.out[i];
    const bool bulk = (reinterpret_cast<uintptr_t>(w.p[i]) & 15) == 0;
    for (int e = (bulk ? n & ~3 : 0) + threadIdx.x; e < n; e += blockDim.x) raw[off + e] = w.p[i][e];
  }
  fconv::mbar_wait(bar, 0);
  __syncthreads();
}

// Stage the weights into W ([in, out] at dims.off, what dense_rows and
// dense_rows_t read): in torch layout into `raw` (stage_raw), then
// transposed from shared memory. Every thread calls it; the block
// synchronises inside.
__device__ __forceinline__ void stage_weights_bulk(float* W, float* raw, const mrssm::WeightPtrs& w,
                                                   const mrssm::WeightDims& d,
                                                   unsigned long long* bar) {
  stage_raw(raw, w, d, bar);
  for (int i = 0, off = 0; i < d.n; off += round4(d.in[i] * d.out[i]), ++i) {
    const int in = d.in[i], out = d.out[i];
    for (int e = threadIdx.x; e < in * out; e += blockDim.x) {
      const int o = e / in, k = e - o * in;
      W[d.off[i] + k * out + o] = raw[off + e];
    }
  }
  __syncthreads();
}

// ---- the chain ----------------------------------------------------------------------

// The weight columns a chain reads, torch layout [out, in], staged in its
// order, each a block of columns [c0, c0 + nc) of its `rows` rows at a
// padded row stride `ws`, from `off` floats into the staging area.
template <int N>
struct ChainWeights {
  const float* p[N];
  int in[N], c0[N], nc[N], rows[N], ws[N], off[N];
  int total;  // floats in shared memory
};

// A row stride ≥ nc, a multiple of 4 (16-byte rows) and not of 32, so that
// lanes reading one column of rows k, k + 1, ... fall in distinct banks.
__host__ __device__ inline int padded_stride(int nc) {
  const int s = round4(nc);
  return s % 32 == 0 ? s + 4 : s;
}

// Lay out weight i as the columns [c0, c0 + nc) of torch weight w [rows, in]
// (the caller fills them in order; `total` grows).
template <int N>
inline void chain_weight(ChainWeights<N>& c, int i, const float* w, int rows, int in, int c0,
                         int nc) {
  c.p[i] = w;
  c.in[i] = in;
  c.rows[i] = rows;
  c.c0[i] = c0;
  c.nc[i] = nc;
  c.ws[i] = padded_stride(nc);
  c.off[i] = i == 0 ? 0 : c.off[i - 1] + c.rows[i - 1] * c.ws[i - 1];
  c.total = c.off[i] + rows * c.ws[i];
}

// Whether a staged weight goes by the bulk copy, row by row: every row's
// columns start 16-byte aligned and span whole float4s.
template <int N>
__device__ __forceinline__ bool bulk_rows(const ChainWeights<N>& cw, int i) {
  return (reinterpret_cast<uintptr_t>(cw.p[i] + cw.c0[i]) & 15) == 0 && cw.in[i] % 4 == 0 &&
         cw.nc[i] % 4 == 0;
}

// Start staging the weights into Wc: rows by the bulk copy where they allow
// it (warp 0's lanes each start some), on one arrival on `bar` (initialised)
// that expects all their bytes; the rest by the threads. Every thread calls
// it; the caller waits on `bar` (phase 0) and synchronises the block.
template <int N>
__device__ __forceinline__ void stage_chain_weights(const ChainWeights<N>& cw, float* Wc,
                                                    unsigned long long* bar) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      int bytes = 0;
      for (int i = 0; i < N; ++i) {
        if (bulk_rows(cw, i)) bytes += cw.rows[i] * cw.nc[i] * 4;
      }
      bulk_expect(bar, bytes);
    }
    __syncwarp();
    for (int i = 0; i < N; ++i) {
      if (!bulk_rows(cw, i)) continue;
      for (int o = threadIdx.x; o < cw.rows[i]; o += 32) {
        bulk_copy(Wc + cw.off[i] + o * cw.ws[i], cw.p[i] + (size_t)o * cw.in[i] + cw.c0[i],
                  cw.nc[i] * 4, bar);
      }
    }
  }
  for (int i = 0; i < N; ++i) {
    if (bulk_rows(cw, i)) continue;
    for (int e = threadIdx.x; e < cw.rows[i] * cw.nc[i]; e += blockDim.x) {
      const int o = e / cw.nc[i], c = e - o * cw.nc[i];
      Wc[cw.off[i] + o * cw.ws[i] + c] = cw.p[i][(size_t)o * cw.in[i] + cw.c0[i] + c];
    }
  }
}

// How a phase's rows × items outputs spread over the block: each output a
// dot split over P adjacent lanes (a power of two ≤ 32, as large as the
// outputs leave room for); this thread's group starts at (r, j) and steps
// by (rstep, jstep), `iters` times on every thread, so that whole warps
// take each step and shuffle with a full mask; part is its lane in the
// group.
struct Split {
  int P, part, r, j, rstep, jstep, iters;
};

// The lanes P a dot of a phase of rows × items outputs takes on a block of
// `threads` threads.
__host__ __device__ inline int split_lanes(int rows, int items, int threads) {
  int P = 32;
  while (P > 1 && rows * items * P > threads) P >>= 1;
  return P;
}

// The same over the block's threads from `first` on (a multiple of 32): the
// threads before it take no output (iters 0).
__device__ __forceinline__ Split make_split_from(int rows, int items, int first) {
  Split s;
  const int threads = blockDim.x - first, id = threadIdx.x - first;
  s.P = split_lanes(rows, items, threads);
  const int slot = id / s.P, slots = threads / s.P;
  s.part = id % s.P;
  s.r = slot / items;
  s.j = slot % items;
  s.rstep = slots / items;
  s.jstep = slots % items;
  s.iters = id < 0 ? 0 : (rows * items + slots - 1) / slots;
  return s;
}

__device__ __forceinline__ Split make_split(int rows, int items) {
  return make_split_from(rows, items, 0);
}

// f(r, j, valid) for this thread's group's outputs, `iters` calls on every
// thread: where the group has run out of outputs, valid is false and r is
// 0 (a row in range, whose results the call drops).
template <class F>
__device__ __forceinline__ void for_outputs(const Split& s, int rows, int items, F f) {
  int r = s.r, j = s.j;
  for (int it = 0; it < s.iters; ++it) {
    const bool valid = r < rows;
    f(valid ? r : 0, j, valid);
    r += s.rstep;
    j += s.jstep;
    if (j >= items) {
      j -= items;
      ++r;
    }
  }
}

// This lane's share of Σ_k a[k]·w[k·ws] for k < n: the k ≡ part (mod P), in
// four partial sums added in a fixed order.
__device__ __forceinline__ float dot_part(const float* __restrict__ a,
                                          const float* __restrict__ w, int ws, int n,
                                          const Split& s) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const int P = s.P;
  int k = s.part;
  for (; k + 3 * P < n; k += 4 * P) {
    s0 = fmaf(a[k], w[k * ws], s0);
    s1 = fmaf(a[k + P], w[(k + P) * ws], s1);
    s2 = fmaf(a[k + 2 * P], w[(k + 2 * P) * ws], s2);
    s3 = fmaf(a[k + 3 * P], w[(k + 3 * P) * ws], s3);
  }
  for (; k < n; k += P) s0 = fmaf(a[k], w[k * ws], s0);
  return (s0 + s1) + (s2 + s3);
}

// The sum of v over the group's lanes, by butterfly shuffles of whole
// warps: every lane gets the same bits (each step adds the same two values).
__device__ __forceinline__ float group_sum(float v, const Split& s) {
  for (int m = 1; m < s.P; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Streaming multiprocessors of the current device (0 if it cannot be read).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace chain
