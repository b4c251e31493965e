// What the fused conv stacks' kernels share (fused_encoder.cuh,
// fused_encoder_bwd.cu, fused_decoder.cuh): weight slices and their
// packing plan, the Hopper bulk copy (TMA) that streams them on mbarriers,
// the parity walk of a stride-2 map, and the implicit-GEMM micro-kernel.
//
// Every layer of either stack is an implicit GEMM over a tile of F frames:
// M = F frames × positions, N = a chunk of output channels, K = input
// channels × taps. A thread owns one position of every frame of the tile
// and J output channels (J = 4, or 1 where a layer has a single output
// channel): F × J accumulators. Its task walks the taps its position takes
// (a layer's Walk maps a tap to the input position it reads, or -1) and,
// for each, the input channels as float4s of activations and of weights.
// Weights come packed tap-major, [row][tap][channel], in slices that the
// bulk copy streams into two shared-memory buffers; where a chunk has fewer
// tasks than threads, S threads split a task's channels and the S partial
// sums are added in a fixed order (no float atomics: the same bits on every
// launch).
#pragma once

#include <cuda_runtime.h>

namespace fconv {

// A slice of a layer's packed weights: rows [co0, co0 + cw) (the output
// channels of a forward slice; the input channels of a transposed one) and
// taps [t0, t1), as 4·ceil(cw/4) rows (zeros past cw) of (t1 - t0)·C floats
// ([tap][channel], C the channels a tap reduces over) at row stride sp, at
// `off` in the packed weights. A layer is cut into chunks of `fcn` rows and
// each chunk into slices of `fper` taps; a chunk has several slices only
// where it has no more tasks than threads.
struct Slice {
  int layer, co0, cw, t0, t1, sp, off;
  int first, last;              // first and last slice of its chunk
};

// The row stride of a slice of K floats a row: K rounded up to a multiple
// of 4 with stride/4 odd, so that the threads of a warp that read one float4
// each of neighbouring rows fall in distinct bank groups.
__host__ __device__ __forceinline__ int padded_k(int K) {
  const int r = (K + 3) / 4 * 4;
  return (r / 4) % 2 == 0 ? r + 4 : r;
}

__host__ __device__ __forceinline__ int slice_floats(const Slice& s) {
  return 4 * ((s.cw + 3) / 4) * s.sp;
}

// The forward slice of layer l from output channel co0 and tap t0, at `off`
// in the packed weights. `Plan` is a stack's plan: its layers have k, Ci,
// Co and the chunking fcn (rows a chunk) and fper (taps a slice).
template <class Plan>
__host__ __device__ __forceinline__ Slice make_slice(const Plan& p, int l, int co0, int t0,
                                                    int off) {
  const auto& L = p.L[l];
  const int kk = L.k * L.k;
  Slice s;
  s.layer = l;
  s.co0 = co0;
  s.cw = L.Co - co0 < L.fcn ? L.Co - co0 : L.fcn;
  s.t0 = t0;
  s.t1 = kk - t0 < L.fper ? kk : t0 + L.fper;
  s.sp = padded_k((s.t1 - s.t0) * L.Ci);
  s.off = off;
  s.first = t0 == 0;
  s.last = s.t1 == kk;
  return s;
}

// The forward slice after s, in the order of the packed weights; its layer
// is p.n past the last.
template <class Plan>
__host__ __device__ __forceinline__ Slice next_slice(const Plan& p, const Slice& s) {
  const auto& L = p.L[s.layer];
  const int off = s.off + slice_floats(s);
  if (s.t1 < L.k * L.k) return make_slice(p, s.layer, s.co0, s.t1, off);
  if (s.co0 + L.fcn < L.Co) return make_slice(p, s.layer, s.co0 + L.fcn, 0, off);
  if (s.layer + 1 < p.n) return make_slice(p, s.layer + 1, 0, 0, off);
  Slice end = s;
  end.layer = p.n;
  return end;
}

// Cut each layer of a plan's forward weights into slices of at most `cap`
// floats (Layer::fcn, Layer::fper, Layer::fpk; p.packed the floats in all):
// the whole layer where it fits; else slices of a few taps and every output
// channel, where `by_taps(layer)` allows it and the layer has no more
// (position, 4 channels) tasks than `threads`; else chunks of output
// channels with every tap. False where not even 4 output channels of one
// tap fit.
template <class Plan, class ByTaps>
inline bool make_slices(Plan& p, int cap, int threads, ByTaps by_taps) {
  p.packed = 0;
  for (int l = 0; l < p.n; ++l) {
    auto& L = p.L[l];
    const int kk = L.k * L.k, rows = 4 * ((L.Co + 3) / 4);
    int taps = kk;  // taps a slice, whole output channels
    while (taps > 0 && rows * padded_k(taps * L.Ci) > cap) --taps;
    if (taps == kk ||
        (taps > 0 && by_taps(L) && L.Ho * L.Wo * rows / 4 <= threads)) {
      const int nsl = (kk + taps - 1) / taps;
      L.fcn = L.Co;
      L.fper = (kk + nsl - 1) / nsl;
    } else {
      L.fcn = cap / padded_k(kk * L.Ci) / 4 * 4;  // chunks of output channels, all taps
      L.fper = kk;
      if (L.fcn < 4) return false;
    }
    L.fpk = p.packed;
    for (Slice s = make_slice(p, l, 0, 0, L.fpk); s.layer == l; s = next_slice(p, s)) {
      p.packed += slice_floats(s);
    }
  }
  return true;
}

// Position (y, x) of position index `pos` of an H×W map: for a stride-2
// layer's even map by parity class (even rows and even columns first, class
// (y & 1, x & 1) = (cls >> 1, cls & 1)), whose positions take a fixed subset
// of the taps, so that the threads of a warp walk the same taps; else
// row-major.
__host__ __device__ __forceinline__ void parity_position(int H, int W, int s, int pos, int& y,
                                                         int& x) {
  if (s == 2 && H % 2 == 0 && W % 2 == 0) {
    const int hh = H / 2, hw = W / 2, cls = pos / (hh * hw), r = pos - cls * hh * hw;
    y = r / hw * 2 + (cls >> 1);
    x = r % hw * 2 + (cls & 1);
  } else {
    y = pos / W;
    x = pos - y * W;
  }
}

// The slices reach shared memory by the Hopper bulk copy (TMA): one thread
// starts a slice's copy, which completes on the buffer's mbarrier.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// One tap of a task: acc[f][j] += Σ over channels [c0, c1) of a[f·abs + c] ·
// w[j·Gsp + c], channels in order. The vector form reads 4 channels at once
// (c0, c1 and both strides multiples of 4, 16-byte aligned); the scalar
// form one.
template <int F, int J>
__device__ __forceinline__ void dot_vec(const float* __restrict__ a, int abs,
                                        const float* __restrict__ w, int Gsp, int c0, int c1,
                                        float (&acc)[F][J]) {
  for (int c = c0; c < c1; c += 4) {
    float4 av[F], wv[J];
#pragma unroll
    for (int f = 0; f < F; ++f) av[f] = *reinterpret_cast<const float4*>(a + f * abs + c);
#pragma unroll
    for (int j = 0; j < J; ++j) wv[j] = *reinterpret_cast<const float4*>(w + j * Gsp + c);
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float r = fmaf(av[f].x, wv[j].x, acc[f][j]);
        r = fmaf(av[f].y, wv[j].y, r);
        r = fmaf(av[f].z, wv[j].z, r);
        acc[f][j] = fmaf(av[f].w, wv[j].w, r);
      }
    }
  }
}

template <int F, int J>
__device__ __forceinline__ void dot_scalar(const float* __restrict__ a, int abs,
                                           const float* __restrict__ w, int Gsp, int c0, int c1,
                                           float (&acc)[F][J]) {
  for (int c = c0; c < c1; ++c) {
    float av[F], wv[J];
#pragma unroll
    for (int f = 0; f < F; ++f) av[f] = a[f * abs + c];
#pragma unroll
    for (int j = 0; j < J; ++j) wv[j] = w[j * Gsp + c];
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[f][j] = fmaf(av[f], wv[j], acc[f][j]);
    }
  }
}

// One task over a slice's taps [ta, tb): for each tap, walk(tap) gives the
// input position it reads (-1: none, a tap in the padding or between
// strided positions), whose C channels sit at in + pos·C (frame f at f·ibsz
// further); `wrow` is the task's first row of the slice (taps from t0, C
// floats each), row j at j·Gsp further. Every sum runs taps in order, then
// channels in order.
template <int F, int J, bool VEC, class Walk>
__device__ __forceinline__ void conv_taps(int t0, int ta, int tb, int C,
                                          const float* __restrict__ in, int ibsz,
                                          const float* __restrict__ wrow, int Gsp, int c0, int c1,
                                          Walk walk, float (&acc)[F][J]) {
  for (int tap = ta; tap < tb; ++tap) {
    const int pos = walk(tap);
    if (pos < 0) continue;
    if (VEC) {
      dot_vec<F, J>(in + pos * C, ibsz, wrow + (tap - t0) * C, Gsp, c0, c1, acc);
    } else {
      dot_scalar<F, J>(in + pos * C, ibsz, wrow + (tap - t0) * C, Gsp, c0, c1, acc);
    }
  }
}

// One slice's tasks on a block of T threads: task = position index × G + g
// for G groups of rows, row g + G·j of the chunk its j-th channel (j < J).
// run(task, c0, c1) adds channels [c0, c1) of the task's taps to acc;
// emit(v, f, pos, c) writes the sum v of frame f, position index pos and
// chunk row c. With more tasks than threads a thread takes several, each
// whole (the chunk is then one slice); else S threads a task split its C
// channels in units of `unit`, the accumulators carry from the chunk's first
// slice to its last, and there the S partial sums (through `part`, T·J·F
// floats) are added in order. Ends with the block in step (the caller
// synchronises before the outputs are read).
template <int F, int J, int T, class Run, class Emit>
__device__ __forceinline__ void slice_tasks(const Slice& sl, int tasks, int G, int C, int unit,
                                            float* part, Run run, Emit emit, float (&acc)[F][J]) {
  const int tid = threadIdx.x;
  auto zero = [&] {
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[f][j] = 0.f;
    }
  };
  auto emit_acc = [&](int task) {
    const int pos = task / G, cg = task - pos * G;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (cg + G * j >= sl.cw) continue;
#pragma unroll
      for (int f = 0; f < F; ++f) emit(acc[f][j], f, pos, cg + G * j);
    }
  };
  if (tasks > T) {  // several tasks a thread: the chunk is one slice
    for (int task = tid; task < tasks; task += T) {
      zero();
      run(task, 0, C);
      emit_acc(task);
    }
    return;
  }
  const int S = max(1, min(T / tasks, C / unit));
  const int task = tid % tasks, s = tid / tasks, nu = C / unit;
  if (sl.first) zero();
  if (s < S) run(task, s * nu / S * unit, (s + 1) * nu / S * unit);
  if (sl.last && S == 1) {
    if (s == 0) emit_acc(task);
  } else if (sl.last) {
    if (s < S) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int j = 0; j < J; ++j) part[((s * tasks + task) * F + f) * J + j] = acc[f][j];
      }
    }
    __syncthreads();
    for (int e = tid; e < tasks * F * J; e += T) {
      const int t = e / (F * J), j = e % J, f = e / J % F;
      const int pos = t / G, c = t - pos * G + G * j;
      if (c >= sl.cw) continue;
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += part[((q * tasks + t) * F + f) * J + j];
      emit(v, f, pos, c);
    }
  }
}

}  // namespace fconv
