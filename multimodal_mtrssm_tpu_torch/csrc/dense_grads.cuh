// The deferred GEMMs of the recurrence backwards: what of the VJP feeds no
// carry, over all T·B row-steps at once, after the reverse-time chain has
// stored each layer's output cotangent rows dy beside its input rows x.
//
// Every task is C[i][j] = Σ_r A(r, i)·B(r, j) with strided operands:
// - a layer's weight gradient (torch W [out, in]): r a row-step, i an
//   output, j an input: dW[o, k] = Σ_n dy[n, o]·x[n, k]; its bias is the
//   column j = in with B = 1, db[o] = Σ_n dy[n, o]; K = T·B;
// - an input cotangent that feeds no carry (a row product): r a hidden
//   unit, i a row-step, j a column block of a weight: dx[n, c] =
//   Σ_h dy[n, h]·W[h, c0 + c].
// A task table lists them, so any recurrence backward can hand its layers
// to the same kernel.
//
// A block owns a tile of kDgTile i × kDgTile j of one task and one chunk of
// its r range; 256 threads each keep a 4 × 4 micro-tile, and the chunk's r
// streams through two shared-memory buffers kDgRows at a time by cp.async,
// the next round's copies in flight while this one computes. Every
// accumulator adds its r in order; where a task has several chunks, each
// block writes its partial sums, and the last block of a tile to finish (an
// integer ticket, no float atomics) adds the chunks in chunk order. So two
// launches give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "conv_common.cuh"
#include "mrssm_common.cuh"

namespace mrssm {

// The most tasks a table holds: the MMTRSSM backward has 17 (14 weights,
// 3 row products).
constexpr int kDgMaxTasks = 20;
constexpr int kDgTile = 64;      // i × j of a block's tile
constexpr int kDgRows = 32;      // r staged at once
constexpr int kDgThreads = 256;  // 16 × 16 threads of 4 × 4 accumulators
constexpr int kDgChunk = 128;    // r a chunk of a weight-gradient task

// One task: A(r, i) = a[r·a_rs + i·a_is] for i < ni; B(r, j) = b0[r·b0_rs + j]
// for j < nb0, b1[r·b1_rs + j − nb0] for nb0 ≤ j < nb0 + nb1, and 1 at
// j = nb0 + nb1 where `bias`; r < R in chunks of `chunk`. C[i][j] goes to
// c[i·c_is + j] and the bias column to cb[i]; p_off and pb_off are their
// offsets in the partial sums' layout (tasks of one chunk have none).
struct DenseGradTask {
  const float* a;
  const float* b0;
  const float* b1;
  float* c;
  float* cb;
  long long a_rs, a_is, b0_rs, b1_rs;
  int ni, nb0, nb1, bias, c_is, p_off, pb_off, R, chunk, chunks;
  int i_tiles, j_tiles, first_tile;
};

// The tasks of one backward call; `blocks` and `tiles` in all; `total`
// floats of a chunk's partial sums.
struct DenseGradTable {
  DenseGradTask task[kDgMaxTasks];
  int n, blocks, tiles, total, max_chunks;
};
// The table goes to the kernel by value, as a parameter (4 KB at most).
static_assert(sizeof(DenseGradTable) <= 4000, "the task table must fit a kernel's parameters");

inline void dense_grad_table_init(DenseGradTable& tb, int total) {
  tb.n = tb.blocks = tb.tiles = tb.max_chunks = 0;
  tb.total = total;
}

inline DenseGradTask* dense_grad_add(DenseGradTable& tb, const float* a, long long a_rs,
                                     long long a_is, int ni, int R, int chunk) {
  if (tb.n == kDgMaxTasks) return nullptr;
  DenseGradTask& t = tb.task[tb.n++];
  t = DenseGradTask{};
  t.a = a;
  t.a_rs = a_rs;
  t.a_is = a_is;
  t.ni = ni;
  t.R = R;
  t.chunk = chunk;
  t.chunks = (R + chunk - 1) / chunk;
  return &t;
}

inline void dense_grad_finish(DenseGradTable& tb, DenseGradTask& t) {
  t.i_tiles = (t.ni + kDgTile - 1) / kDgTile;
  t.j_tiles = (t.nb0 + t.nb1 + t.bias + kDgTile - 1) / kDgTile;
  t.first_tile = tb.tiles;
  tb.tiles += t.i_tiles * t.j_tiles;
  tb.blocks += t.i_tiles * t.j_tiles * t.chunks;
  if (t.chunks > tb.max_chunks) tb.max_chunks = t.chunks;
}

// A layer's weight gradient (see the header): x rows in one or two
// segments (n1 = 0: one), dy rows at stride sdy; dW [out, n0 + n1] and db
// [out] at w_off and b_off of `out_base` (the flat gradient buffer, whose
// layout the partial sums share). False when the table is full.
inline bool dense_grad_weight(DenseGradTable& tb, const float* x0, int n0, int s0,
                              const float* x1, int n1, int s1, const float* dy, int sdy, int out,
                              float* out_base, int w_off, int b_off, int N) {
  DenseGradTask* t = dense_grad_add(tb, dy, sdy, 1, out, N, kDgChunk);
  if (t == nullptr) return false;
  t->b0 = x0;
  t->b0_rs = s0;
  t->nb0 = n0;
  t->b1 = x1;
  t->b1_rs = s1;
  t->nb1 = n1;
  t->bias = 1;
  t->c = out_base + w_off;
  t->cb = out_base + b_off;
  t->c_is = n0 + t->nb1;
  t->p_off = w_off;
  t->pb_off = b_off;
  dense_grad_finish(tb, *t);
  return true;
}

// A row product: dx[n, c] = Σ_h dy[n·sdy + h]·W[h·w_in + c0 + c] for c < nc,
// h < H (torch W [H, w_in] in device memory), into dx [N, nc]. One chunk.
inline bool dense_grad_rows(DenseGradTable& tb, const float* dy, int sdy, int H, const float* w,
                            int w_in, int c0, int nc, float* dx, int N) {
  DenseGradTask* t = dense_grad_add(tb, dy, 1, sdy, N, H, H > 0 ? H : 1);
  if (t == nullptr) return false;
  t->b0 = w == nullptr ? nullptr : w + c0;
  t->b0_rs = w_in;
  t->nb0 = nc;
  t->c = dx;
  t->c_is = nc;
  dense_grad_finish(tb, *t);
  return true;
}

namespace {

// Stage round [r0, r0 + kDgRows) of a task's A (i from i0) and B (j from
// j0) tiles: cp.async for the elements in range, zeros (and the ones of the
// bias column) stored directly.
__device__ __forceinline__ void dense_grad_stage(const DenseGradTask& T, int r0, int r_end,
                                                 int i0, int j0, float (*as)[kDgTile],
                                                 float (*bs)[kDgTile]) {
  const int nb = T.nb0 + T.nb1;
  for (int e = threadIdx.x; e < kDgRows * kDgTile; e += kDgThreads) {
    const int rr = e / kDgTile, c = e % kDgTile;
    const long long r = (long long)r0 + rr;
    const int i = i0 + c, j = j0 + c;
    if (r < r_end && i < T.ni) fconv::cp_async4(&as[rr][c], T.a + r * T.a_rs + i * T.a_is);
    else as[rr][c] = 0.f;
    if (r < r_end && j < T.nb0) fconv::cp_async4(&bs[rr][c], T.b0 + r * T.b0_rs + j);
    else if (r < r_end && j < nb) fconv::cp_async4(&bs[rr][c], T.b1 + r * T.b1_rs + (j - T.nb0));
    else bs[rr][c] = r < r_end && j == nb && T.bias ? 1.f : 0.f;
  }
  fconv::cp_async_commit();
}

__global__ void __launch_bounds__(kDgThreads)
recurrence_bwd_dw_kernel(const __grid_constant__ DenseGradTable tb, float* __restrict__ partial,
                         int* __restrict__ tickets) {
  __shared__ __align__(16) float as[2][kDgRows][kDgTile];
  __shared__ __align__(16) float bs[2][kDgRows][kDgTile];
  __shared__ int last;
  int b = blockIdx.x, ti = 0;
  while (b >= tb.task[ti].i_tiles * tb.task[ti].j_tiles * tb.task[ti].chunks) {
    b -= tb.task[ti].i_tiles * tb.task[ti].j_tiles * tb.task[ti].chunks;
    ++ti;
  }
  const DenseGradTask& T = tb.task[ti];
  const int tile = b / T.chunks, chunk = b % T.chunks;
  const int i0 = (tile / T.j_tiles) * kDgTile, j0 = (tile % T.j_tiles) * kDgTile;
  const int iq = threadIdx.x / 16, jq = threadIdx.x % 16;
  const int r_begin = chunk * T.chunk, r_end = min(T.R, r_begin + T.chunk);
  const int rounds = (r_end - r_begin + kDgRows - 1) / kDgRows;
  float acc[4][4] = {};
  if (rounds > 0) dense_grad_stage(T, r_begin, r_end, i0, j0, as[0], bs[0]);
  for (int q = 0; q < rounds; ++q) {
    if (q + 1 < rounds) {
      dense_grad_stage(T, r_begin + (q + 1) * kDgRows, r_end, i0, j0, as[(q + 1) & 1],
                       bs[(q + 1) & 1]);
      fconv::cp_async_wait<1>();
    } else {
      fconv::cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kDgRows, r_end - r_begin - q * kDgRows);
    float(*A)[kDgTile] = as[q & 1];
    float(*B)[kDgTile] = bs[q & 1];
    for (int r = 0; r < n; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(&B[r][4 * jq]);
      const float4 d = *reinterpret_cast<const float4*>(&A[r][4 * iq]);
      const float xa[4] = {x.x, x.y, x.z, x.w}, da[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(da[i], xa[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  // Where each of this thread's results goes (offsets from c, cb and the
  // partial layout; -1: outside the task).
  const int nb = T.nb0 + T.nb1;
  int at[4][4], pat[4][4];
  bool isb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ii = i0 + 4 * iq + i, jj = j0 + 4 * jq + j;
      isb[i][j] = jj == nb;
      const bool in = ii < T.ni && (jj < nb || (jj == nb && T.bias));
      at[i][j] = !in ? -1 : isb[i][j] ? ii : ii * T.c_is + jj;
      pat[i][j] = !in ? -1 : isb[i][j] ? T.pb_off + ii : T.p_off + ii * T.c_is + jj;
    }
  }
  if (T.chunks == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (at[i][j] >= 0) (isb[i][j] ? T.cb : T.c)[at[i][j]] = acc[i][j];
      }
    }
    return;
  }
  float* mine = partial + (size_t)chunk * tb.total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at[i][j] >= 0) mine[pat[i][j]] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[T.first_tile + tile], 1) == T.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at[i][j] < 0) continue;
      float sum = 0.f;
      for (int c = 0; c < T.chunks; ++c) sum += __ldcg(&partial[(size_t)c * tb.total + pat[i][j]]);
      (isb[i][j] ? T.cb : T.c)[at[i][j]] = sum;
    }
  }
}

// Floats of partial sums the kernel needs as scratch (ints of tickets: tb.tiles).
inline size_t dense_grad_partial_floats(const DenseGradTable& tb) {
  return tb.max_chunks > 1 ? (size_t)tb.max_chunks * tb.total : 0;
}

// Launch on `stream`: the tickets are zeroed first (one per tile).
cudaError_t dense_grads_launch(const DenseGradTable& tb, float* partial, int* tickets,
                               cudaStream_t stream) {
  if (tb.blocks == 0) return cudaSuccess;
  if (tb.max_chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(tickets, 0, tb.tiles * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  recurrence_bwd_dw_kernel<<<tb.blocks, kDgThreads, 0, stream>>>(tb, partial, tickets);
  return cudaGetLastError();
}

}  // namespace

}  // namespace mrssm
