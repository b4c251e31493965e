// What the fused conv stacks' kernels share (fused_encoder.cuh,
// fused_encoder_bwd.cu, fused_decoder.cuh, fused_decoder_bwd.cu): weight
// slices, forward and transposed, and their packing plan, the Hopper bulk
// copy (TMA) that streams them on mbarriers, the parity walk of a stride-2
// map, the implicit-GEMM micro-kernel, and the backward's weight-gradient
// pass (a blocked GEMM a tap over records staged by cp.async).
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

#include "mrssm_common.cuh"

namespace fconv {

// Floats of each of the weight-gradient pass's two staging buffers (at
// least one frame of a layer's input and output records): 48 KB, so that
// two blocks of it fit an SM.
constexpr int kDwStage = 12288;

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

// The transposed slice of layer l from input channel r0 and tap t0, at
// `off` in the backward's packed weights. A transposed slice (the
// backward's cotangent pass) is a forward slice with the roles of the
// channels swapped: rows are input channels [co0, co0 + cw) of the
// p.t_rows(l) that take a cotangent, a row is (t1 - t0)·Co floats [tap][co],
// and the stack's pack chooses which torch tap each tap holds. The layers
// have the transposed chunking bcn (rows a chunk) and bper (taps a slice).
template <class Plan>
__host__ __device__ __forceinline__ Slice make_tslice(const Plan& p, int l, int r0, int t0,
                                                     int off) {
  const auto& L = p.L[l];
  const int kk = L.k * L.k, R = p.t_rows(l);
  Slice s;
  s.layer = l;
  s.co0 = r0;
  s.cw = R - r0 < L.bcn ? R - r0 : L.bcn;
  s.t0 = t0;
  s.t1 = kk - t0 < L.bper ? kk : t0 + L.bper;
  s.sp = padded_k((s.t1 - s.t0) * L.Co);
  s.off = off;
  s.first = t0 == 0;
  s.last = s.t1 == kk;
  return s;
}

// The transposed slice after s, in the order of the backward's packed
// weights (the last layer first); its layer is -1 past layer `stop`.
template <class Plan>
__host__ __device__ __forceinline__ Slice next_tslice(const Plan& p, const Slice& s, int stop) {
  const auto& L = p.L[s.layer];
  const int off = s.off + slice_floats(s);
  if (s.t1 < L.k * L.k) return make_tslice(p, s.layer, s.co0, s.t1, off);
  if (s.co0 + L.bcn < p.t_rows(s.layer)) return make_tslice(p, s.layer, s.co0 + L.bcn, 0, off);
  if (s.layer > stop) return make_tslice(p, s.layer - 1, 0, 0, off);
  Slice end = s;
  end.layer = -1;
  return end;
}

// make_slices for the transposed slices (Layer::bcn, bper, bpk; p.bpacked
// the floats in all), over the input positions of each layer: slices of a
// few taps where the layer has no more (input position, 4 rows) tasks than
// `threads`, else chunks of rows with every tap.
template <class Plan>
inline bool make_tslices(Plan& p, int cap, int threads) {
  p.bpacked = 0;
  for (int l = p.n - 1; l >= 0; --l) {
    auto& L = p.L[l];
    const int kk = L.k * L.k, R = p.t_rows(l), rows = 4 * ((R + 3) / 4);
    int taps = kk;
    while (taps > 0 && rows * padded_k(taps * L.Co) > cap) --taps;
    if (taps == kk || (taps > 0 && L.Hi * L.Wi * rows / 4 <= threads)) {
      const int nsl = (kk + taps - 1) / taps;
      L.bcn = R;
      L.bper = (kk + nsl - 1) / nsl;
    } else {
      L.bcn = cap / padded_k(kk * L.Co) / 4 * 4;
      L.bper = kk;
      if (L.bcn < 4) return false;
    }
    L.bpk = p.bpacked;
    for (Slice s = make_tslice(p, l, 0, 0, L.bpk); s.layer == l; s = next_tslice(p, s, 0)) {
      p.bpacked += slice_floats(s);
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

// ---- the backward's cotangent pass ---------------------------------------------------

// The cotangent pass's block on T threads over a tile of F frames: it walks
// the layers in reverse, each layer's input cotangent an implicit GEMM of
// its pre-activation cotangent with the transposed slices (M = frames ×
// input positions, N = the layer's t_rows, K = output channels × taps),
// the slices (`tpacked`, as the stack's pack wrote them) streaming through
// two buffers by the bulk copy. At `smem`: 4 floats of the slice buffers'
// mbarriers, the three cotangent buffers of F frames (bsz[i] floats a frame
// each), the split tasks' partial sums (P.fpart), two slice buffers
// (P.bslice). The epilogue adds the residual skip where the layer's input
// also feeds one (Layer::acc_in), multiplies by the activation derivative
// of the layer below, from its recorded output (`stash`), and records that
// layer's pre-activation cotangent in `dstash` (Layer::dpre_off). Below
// layer 0 it writes dx [N, layer 0's Hi·Wi, P.t_rows(0)]; where dx is
// null, the walk stops after layer 1's epilogue. `st` says what differs
// between the stacks:
// - seed(P, n, j): the last layer's pre-activation cotangent, element j of
//   frame n (from the output's cotangent);
// - in_position(L, pos, iy, ix): the input position of a task's position
//   index;
// - walk(L, iy, ix, tap): the output position index whose cotangent tap
//   reads from input position (iy, ix), or -1;
// - deriv(B, o): the derivative of layer B's activation at its output o.
template <int F, int T, class Stack, class Plan>
__device__ __forceinline__ void cotangent_pass(const Plan& P, const int (&bsz)[3],
                                               const Stack& st, const float* __restrict__ stash,
                                               float* __restrict__ dstash,
                                               const float* __restrict__ tpacked,
                                               float* __restrict__ dx, int N, float* smem) {
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // one a slice buffer
  float* buf[3];
  buf[0] = smem + 4;
  buf[1] = buf[0] + F * bsz[0];
  buf[2] = buf[1] + F * bsz[1];
  float* part = buf[2] + F * bsz[2];
  float* WB[2] = {part + P.fpart, part + P.fpart + P.bslice};
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);
  const int stop = dx == nullptr ? 1 : 0;

  auto load_slice = [&](const Slice& sl, int b) {  // thread 0 only
    bulk_load(WB[b], tpacked + sl.off, 4 * slice_floats(sl), &bar[b]);
  };
  Slice sl = make_tslice(P, P.n - 1, 0, 0, 0);
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    load_slice(sl, 0);
  }
  // The last layer's pre-activation cotangent (zeros past N), in its buffer
  // and its record.
  {
    const auto& last = P.L[P.n - 1];
    const int osz = last.Ho * last.Wo * last.Co;
    for (int i = tid; i < F * osz; i += T) {
      const int f = i / osz, j = i - f * osz;
      float v = 0.f;
      if (f < nf) {
        v = st.seed(P, n0 + f, j);
        dstash[(size_t)(n0 + f) * P.dstash + last.dpre_off + j] = v;
      }
      buf[last.out_buf][f * bsz[last.out_buf] + j] = v;
    }
  }
  __syncthreads();  // the mbarriers are initialised before any thread waits on them

  float acc[F][4];
  for (int i = 0; sl.layer >= 0; ++i) {
    const Slice next = next_tslice(P, sl, stop);
    if (tid == 0 && next.layer >= 0) load_slice(next, (i + 1) & 1);
    mbar_wait(&bar[i & 1], (i >> 1) & 1);
    __syncthreads();  // slice i and the layer's pre-activation cotangent are in place

    const int l = sl.layer;
    const auto L = P.L[l];
    const int G = (sl.cw + 3) / 4, Gsp = G * sl.sp, tasks = L.Hi * L.Wi * G;
    const bool vec = L.Co % 4 == 0;
    const float* dout = buf[L.out_buf];
    const int dbsz = bsz[L.out_buf];
    // A task of a transposed slice: input position pos of every frame of
    // the tile and the rows cg + G·j, j < 4, of the slice's chunk, summed
    // over the output channels [c0, c1) of the slice's taps that reach an
    // output position. The vector form reads 4 output channels at once (Co
    // % 4 == 0).
    auto run = [&](int task, int c0, int c1) {
      const int pos = task / G, cg = task - pos * G;
      int iy, ix;
      st.in_position(L, pos, iy, ix);
      auto walk = [&](int tap) { return st.walk(L, iy, ix, tap); };
      const float* wrow = WB[i & 1] + cg * sl.sp;
      if (vec) {
        conv_taps<F, 4, true>(sl.t0, sl.t0, sl.t1, L.Co, dout, dbsz, wrow, Gsp, c0, c1, walk, acc);
      } else {
        conv_taps<F, 4, false>(sl.t0, sl.t0, sl.t1, L.Co, dout, dbsz, wrow, Gsp, c0, c1, walk,
                               acc);
      }
    };
    // Input cotangent v of frame f, position index pos, chunk row c: dx
    // below layer 0; else, with the skip added where the input also feeds
    // one, times the activation derivative of the layer below, whose
    // pre-activation cotangent it then is.
    auto emit = [&](float v, int f, int pos, int c) {
      const int r = sl.co0 + c;
      int iy, ix;
      st.in_position(L, pos, iy, ix);
      const int pin = iy * L.Wi + ix;
      if (l == 0) {
        if (f < nf) dx[((size_t)(n0 + f) * L.Hi * L.Wi + pin) * P.t_rows(0) + r] = v;
        return;
      }
      const auto& B = P.L[l - 1];
      const int j = pin * L.Ci + r;
      float* d = buf[L.in_buf] + f * bsz[L.in_buf] + j;
      if (L.acc_in) v += *d;
      if (f < nf) {
        v *= st.deriv(B, stash[(size_t)(n0 + f) * P.stash + B.out_off + j]);
        dstash[(size_t)(n0 + f) * P.dstash + B.dpre_off + j] = v;
      }
      *d = v;
    };
    slice_tasks<F, 4, T>(sl, tasks, G, L.Co, vec ? 4 : 1, part, run, emit, acc);
    __syncthreads();  // slice i's buffer is free for slice i + 2
    sl = next;
  }
}

// ---- the backward's weight-gradient pass ---------------------------------------------

// A layer's tiles of the weight-gradient pass: ≤ 64 input × ≤ 64 output
// channels (in float4 groups) of one tap; tiles of each kind, and in all.
template <class Layer>
__host__ __device__ __forceinline__ int dw_tiles(const Layer& L, int& cit, int& cot, int& nci,
                                                 int& nco) {
  cit = (L.Ci + 3) / 4 * 4;
  cit = cit < 64 ? cit : 64;
  cot = (L.Co + 3) / 4 * 4;
  cot = cot < 64 ? cot : 64;
  nci = (L.Ci + cit - 1) / cit;
  nco = (L.Co + cot - 1) / cot;
  return L.k * L.k * nci * nco;
}

template <class Plan>
inline int dw_blocks(const Plan& P) {
  int total = 0, cit, cot, nci, nco;
  for (int l = 0; l < P.n; ++l) total += dw_tiles(P.L[l], cit, cot, nci, nco);
  return total;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Copy `count` floats of each of `frames` records (stride `stride` in
// device memory, `dstride` in shared memory) asynchronously on a block of T
// threads: float4s where count and both strides allow (every record is
// 16-byte aligned), else floats.
template <int T>
__device__ __forceinline__ void stage_records(float* dst, int dstride, const float* src,
                                              size_t stride, int count, int frames) {
  if (count % 4 == 0 && dstride % 4 == 0) {
    const int q = count / 4;
    for (int e = threadIdx.x; e < frames * q; e += T) {
      const int f = e / q, c = e - f * q;
      cp_async16(dst + f * dstride + 4 * c, src + f * stride + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < frames * count; e += T) {
      const int f = e / count, c = e - f * count;
      cp_async4(dst + f * dstride + c, src + f * stride + c);
    }
  }
}

// How a weight-gradient block forms its bias: not at all; from the
// cotangents at the positions its tap reaches (a conv's tap (p, p), which
// reaches every output position where k ≥ 2p + 1; each of the unflatten's
// taps, one output element each); or, at each input position u of a k4 s2
// p1 transposed conv's tap (1, 1), from the 2×2 block of output positions
// 2u + (0|1, 0|1), which are what the four taps (1|2, 1|2) reach from u:
// together every output position, once.
enum DwBias { kNoBias = 0, kTapBias = 1, kQuadBias = 2 };

// One thread's sums over `fs` staged frames: input channels ci + i and
// output channels co + j (i, j < 4; zeros past the tile's channels), over
// its share [q0, q1) of the positions that tap (ky, kx) relates, walked
// side rows [wy0, ..) × columns [wx0, wx0 + nc) taken row-major by pointer
// increments, the mapped side at w·s − p + tap. A conv walks its outputs
// (the cotangent record D) and maps to its inputs (the activation record
// A); SWAP, a transposed conv, walks its inputs and maps to its outputs.
// `bias` (DwBias) also sums cotangents. The running sums fa, fb fold into
// acc, bacc every `fg` frames (`since` counts them), so that no running sum
// takes more than 256 terms.
template <bool VEC, bool SWAP, class Layer>
__device__ __forceinline__ void dw_frames(const Layer& L, const float* __restrict__ A,
                                          const float* __restrict__ D, int asz, int dsz, int fs,
                                          int q0, int q1, int wy0, int wx0, int nc, int ky,
                                          int kx, int ci, int cie, int co, int coe, int bias,
                                          int fg, int& since, float (&fa)[4][4], float (&fb)[4],
                                          float (&acc)[4][4], float (&bacc)[4]) {
  const int Ww = SWAP ? L.Wi : L.Wo, Cw = SWAP ? L.Ci : L.Co, cw = SWAP ? ci : co;
  const int Wm = SWAP ? L.Wo : L.Wi, Cm = SWAP ? L.Co : L.Ci, cm = SWAP ? co : ci;
  const int r0 = q0 / nc, c0 = q0 - r0 * nc;
  auto cotangents = [&](const float* d, float (&dv)[4]) {
    if (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(d);
      dv[0] = v.x; dv[1] = v.y; dv[2] = v.z; dv[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = co + j < coe ? d[j] : 0.f;
    }
  };
  for (int f = 0; f < fs; ++f) {
    const float* a = A + f * asz;
    const float* d = D + f * dsz;
    int wy = wy0 + r0, wx = wx0 + c0;
    int wp = (wy * Ww + wx) * Cw + cw;
    int mp = ((wy * L.s - L.p + ky) * Wm + wx * L.s - L.p + kx) * Cm + cm;
    for (int q = q0; q < q1; ++q) {
      const int dp = SWAP ? mp : wp, ap = SWAP ? wp : mp;
      float dv[4], av[4];
      cotangents(d + dp, dv);
      if (VEC) {
        const float4 u = *reinterpret_cast<const float4*>(a + ap);
        av[0] = u.x; av[1] = u.y; av[2] = u.z; av[3] = u.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ci + i < cie ? a[ap + i] : 0.f;
      }
      if (bias == kTapBias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j] += dv[j];
      } else if (bias == kQuadBias) {
        float d01[4], d10[4], d11[4];
        cotangents(d + dp + L.Co, d01);
        cotangents(d + dp + L.Wo * L.Co, d10);
        cotangents(d + dp + (L.Wo + 1) * L.Co, d11);
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j] += (dv[j] + d01[j]) + (d10[j] + d11[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) fa[i][j] = fmaf(av[i], dv[j], fa[i][j]);
      }
      if (++wx == wx0 + nc) {
        wx = wx0;
        ++wy;
        wp = (wy * Ww + wx) * Cw + cw;
        mp = ((wy * L.s - L.p + ky) * Wm + wx * L.s - L.p + kx) * Cm + cm;
      } else {
        wp += Cw;
        mp += L.s * Cm;
      }
    }
    if (++since == fg) {
      since = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bacc[i] += fb[i];
        fb[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += fa[i][j];
          fa[i][j] = 0.f;
        }
      }
    }
  }
}

// The weight-gradient pass's block on T threads: weight and bias gradients
// of one tile (dw_tiles: blockIdx.x walks the layers' tiles in order) and
// one chunk of frames (blockIdx.y), into partial[chunk] in the layout of
// `gd` (the stack's grad_dims: a weight, then its bias, a layer). The
// chunk's records, the layer's input activations (stash, at Layer::in_off)
// and its pre-activation cotangents (dstash, at Layer::dpre_off), are
// staged a few frames at a time into two buffers of P.dwstage floats at
// `smem`, the next in flight while one computes. A thread owns 4 × 4
// gradient elements; with fewer such tasks than threads, S threads a task
// split the positions the tap relates and their sums are added in order.
// `Grads` says what differs between the stacks' layers: swap(L), whether
// the block walks the layer's inputs (dw_frames' SWAP); bias(L, tap), the
// DwBias of a tap; weight(L, ci, co, tap) and bias_at(L, co, tap), the
// offsets of a gradient element in its tensor's part of `gd`.
template <int T, class Grads, class Plan>
__device__ __forceinline__ void weight_grad_block(const Plan& P, const mrssm::WeightDims& gd,
                                                  const float* __restrict__ stash,
                                                  const float* __restrict__ dstash,
                                                  float* __restrict__ partial, int N, int chunk,
                                                  float* smem) {
  int b = blockIdx.x, l = 0, cit, cot, nci, nco;
  for (;; ++l) {
    const int nb = dw_tiles(P.L[l], cit, cot, nci, nco);
    if (b < nb) break;
    b -= nb;
  }
  const auto L = P.L[l];
  const int tap = b / (nci * nco), rr = b - tap * (nci * nco);
  const int ci0 = rr / nco * cit, co0 = rr % nco * cot;
  const int cie = min(L.Ci, ci0 + cit), coe = min(L.Co, co0 + cot);
  const int gi = (cie - ci0 + 3) / 4, go = (coe - co0 + 3) / 4, tasks = gi * go;
  const int ky = tap / L.k, kx = tap - ky * L.k;
  // The walked rows and columns whose mapped position (w·s − p + tap) is
  // inside the other map.
  const bool swap = Grads::swap(L);
  const int Hw = swap ? L.Hi : L.Ho, Ww = swap ? L.Wi : L.Wo;
  const int Hm = swap ? L.Ho : L.Hi, Wm = swap ? L.Wo : L.Wi;
  const int wy0 = ky >= L.p ? 0 : (L.p - ky + L.s - 1) / L.s;
  const int wx0 = kx >= L.p ? 0 : (L.p - kx + L.s - 1) / L.s;
  const int ny = Hm - 1 + L.p - ky, nx = Wm - 1 + L.p - kx;
  const int nr = max(0, min(Hw, ny < 0 ? 0 : ny / L.s + 1) - wy0);
  const int nc = max(0, min(Ww, nx < 0 ? 0 : nx / L.s + 1) - wx0);
  const int V = nr * nc, S = max(1, min(T / tasks, V));
  const int tid = threadIdx.x, task = tid % tasks, s = tid / tasks;
  const int ci = ci0 + task / go * 4, co = co0 + task % go * 4;
  const int bias = ci0 == 0 ? Grads::bias(L, tap) : kNoBias;
  const bool vec = L.Ci % 4 == 0 && L.Co % 4 == 0;
  const int q0 = s * V / S, q1 = (s + 1) * V / S;
  const int fg = max(1, 256 / max(1, (V + S - 1) / S));
  // A frame of each record, staged at a stride rounded to float4s, so that
  // the cotangents after fmax frames of activations stay 16-byte aligned
  // (a layer's input record holds Ci floats at a 1×1 map, any Ci).
  const int asz = L.Hi * L.Wi * L.Ci, dsz = L.Ho * L.Wo * L.Co;
  const int asz4 = (asz + 3) / 4 * 4, dsz4 = (dsz + 3) / 4 * 4;
  const int fmax = max(1, P.dwstage / (asz4 + dsz4));
  float* stage[2] = {smem, smem + P.dwstage};
  const int n_begin = blockIdx.y * chunk, n_end = min(N, n_begin + chunk);
  const int stages = (n_end - n_begin + fmax - 1) / fmax;

  auto load = [&](int st) {
    const int n0 = n_begin + st * fmax, fs = min(fmax, n_end - n0);
    float* dst = stage[st & 1];
    stage_records<T>(dst, asz4, stash + (size_t)n0 * P.stash + L.in_off, P.stash, asz, fs);
    stage_records<T>(dst + fmax * asz4, dsz4, dstash + (size_t)n0 * P.dstash + L.dpre_off,
                     P.dstash, dsz, fs);
    cp_async_commit();
  };
  float acc[4][4], fa[4][4], bacc[4], fb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bacc[i] = fb[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fa[i][j] = 0.f;
  }
  int since = 0;
  load(0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st is in place
    const float* A = stage[st & 1];
    const float* Dr = A + fmax * asz4;
    const int fs = min(fmax, n_end - (n_begin + st * fmax));
    if (s < S && q0 < q1) {
      if (swap && vec) {
        dw_frames<true, true>(L, A, Dr, asz4, dsz4, fs, q0, q1, wy0, wx0, nc, ky, kx, ci, cie,
                              co, coe, bias, fg, since, fa, fb, acc, bacc);
      } else if (swap) {
        dw_frames<false, true>(L, A, Dr, asz4, dsz4, fs, q0, q1, wy0, wx0, nc, ky, kx, ci, cie,
                               co, coe, bias, fg, since, fa, fb, acc, bacc);
      } else if (vec) {
        dw_frames<true, false>(L, A, Dr, asz4, dsz4, fs, q0, q1, wy0, wx0, nc, ky, kx, ci, cie,
                               co, coe, bias, fg, since, fa, fb, acc, bacc);
      } else {
        dw_frames<false, false>(L, A, Dr, asz4, dsz4, fs, q0, q1, wy0, wx0, nc, ky, kx, ci, cie,
                                co, coe, bias, fg, since, fa, fb, acc, bacc);
      }
    }
    __syncthreads();  // stage st's buffer is free for stage st + 2
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bacc[i] += fb[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += fa[i][j];
  }

  // Gradient element k of a task (16 weights, then 4 biases) into partial.
  float* out = partial + (size_t)blockIdx.y * gd.total;
  auto store = [&](int t, int k, float v) {
    const int tci = ci0 + t / go * 4, tco = co0 + t % go * 4;
    if (k < 16) {
      const int c = tci + k / 4, o = tco + k % 4;
      if (c < cie && o < coe) out[gd.off[2 * l] + Grads::weight(L, c, o, tap)] = v;
    } else if (bias != kNoBias && t / go == 0 && tco + k - 16 < coe) {
      out[gd.off[2 * l + 1] + Grads::bias_at(L, tco + k - 16, tap)] = v;
    }
  };
  if (S == 1) {
    if (s == 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) store(task, k, acc[k / 4][k % 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) store(task, 16 + j, bacc[j]);
    }
    return;
  }
  float* red = smem;  // the staging buffers are free
  if (s < S) {
#pragma unroll
    for (int k = 0; k < 16; ++k) red[(s * tasks + task) * 20 + k] = acc[k / 4][k % 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(s * tasks + task) * 20 + 16 + j] = bacc[j];
  }
  __syncthreads();
  for (int e = tid; e < tasks * 20; e += T) {
    const int t = e / 20, k = e - t * 20;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += red[(q * tasks + t) * 20 + k];
    store(t, k, v);
  }
}

}  // namespace fconv
