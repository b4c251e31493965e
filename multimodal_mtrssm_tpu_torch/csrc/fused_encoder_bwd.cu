// The conv encoder, backward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461), the custom VJP of fused_encoder_apply (lines 530-558): the
// gradients of every encoder weight and bias and, when asked, of the
// frames. Like the TPU backward it recomputes the activations from the
// input instead of keeping the forward's. Five launches:
//
// 1. the forward (fused_encoder.cuh: encoder_pack_kernel, then
//    encoder_fwd_kernel) recomputes each tile and records every layer's
//    output in device memory (13,824 floats a frame at the reference
//    widths);
// 2. encoder_bwd_pack_kernel lays out the transposed slices (Slice, in
//    fused_encoder.cuh): each layer's weights flipped in space as
//    [Ci][tap][Co], the last layer first;
// 3. encoder_bwd_dx_kernel walks the layers in reverse per tile of frames,
//    the cotangents in shared memory: each layer's input cotangent is a
//    convolution of its pre-activation cotangent with the transposed
//    slices (an implicit GEMM, M = frames × input positions, N = Ci, K =
//    Co × taps), and its epilogue adds the residual skip where the block's
//    input receives it, multiplies by the ELU derivative of the layer
//    below (from the recorded output, as fused_conv.py::_act_deriv) and
//    records that layer's pre-activation cotangent (10,816 floats a
//    frame), or writes the frames' cotangent;
// 4. encoder_bwd_dw_kernel forms the weight and bias gradients of each
//    layer as a blocked GEMM, dW[ci·k·k + tap][co] = Σ over a chunk's
//    frames and output positions of im2col(activation) × pre-activation
//    cotangent, over both records staged in shared memory;
// 5. mrssm::reduce_weight_grads adds the chunks in order and writes torch
//    layout. No float atomics anywhere, so two runs give the same bits.
//
// What bounds it: operations, ~11 MFLOP a frame besides the recompute (the
// weight gradients and the input cotangents each about the forward's
// ~5.5) in f32 FMA; the records (~99 KB a frame) stay in L2 at N=240. What
// held the first form back was the forward's first design in both passes:
// one output a thread with a dependent FMA chain and two shared loads an
// FMA (cotangents), and one thread a gradient element reading both
// operands from device memory (weights). Here:
// - the cotangent pass is the forward's design transposed: a thread owns
//   one input position of every frame of the tile and 4 input channels
//   (F × 4 accumulators) and reads 4 output channels as float4s; the
//   slices stream through two buffers by the bulk copy (TMA) on mbarriers;
//   taps that land between the strided outputs or in the padding are
//   skipped; a stride-2 layer takes its positions by parity class (even
//   and odd rows and columns), so that the threads of a warp share the
//   taps that reach them; narrow tasks are split over threads and their
//   partial sums added in a fixed order;
// - the weight-gradient pass gives a block one tap of one layer, a tile of
//   ≤ 64 input × ≤ 64 output channels, and one chunk of frames, whose two
//   records it stages a few frames at a time with cp.async into two
//   buffers; a thread accumulates 4 × 4 gradient elements (one float4 of
//   activations and one of cotangents a position), and where a tile has
//   fewer such tasks than threads, S threads split the positions and their
//   sums are added in a fixed order. A thread walks only the positions its
//   tap reaches, by pointer increments, and folds its running sums every
//   few frames, so that none takes more than 256 terms (one frame where a
//   layer has 256 positions); the chunks are added in order afterwards.
//
// Measured (chip_smoke.py's encoder_timings, NVIDIA H100 80GB HBM3, 700 W,
// PERF.md §6): at N=240 the cotangent pass takes ~0.16-0.18 ms of device
// time and the weight-gradient pass ~0.15 (the first forms 1.39 and 1.70),
// a whole call ~0.52 ms against ~3.28; at N=3840 2.8 and 1.9 ms (20.9 and
// 25.3). Both passes stay ~8-9× above their share of the bound: the
// weight-gradient pass restages a chunk's records once per tap (k·k times
// a layer) and reads two float4s of shared memory per 16 FMAs; two blocks
// an SM (128 registers) ran faster than three (80, with spills).
#include "fused_encoder.cuh"

namespace {

using fenc::Layer;
using fenc::Plan;
using fenc::Slice;
using fenc::kFwdFrames;
using fenc::kThreads;

// Pack every transposed slice of the torch-layout weights: blockIdx.y is
// the layer, whose slices the block walks in order, one thread per packed
// float, zeros past a chunk's rows and in the row padding.
__global__ void encoder_bwd_pack_kernel(mrssm::WeightPtrs w, Plan P, float* __restrict__ packed) {
  const int l = blockIdx.y;
  const Layer& L = P.L[l];
  const int kk = L.k * L.k;
  for (Slice sl = fenc::make_tslice(P, l, 0, 0, L.bpk); sl.layer == l;
       sl = fenc::next_tslice(P, sl, 0)) {
    const int cols = (sl.t1 - sl.t0) * L.Co, n = fconv::slice_floats(sl);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      const int r = e / sl.sp, col = e - r * sl.sp;
      float v = 0.f;
      if (r < sl.cw && col < cols) {
        const int t = col / L.Co, co = col - t * L.Co;
        v = w.p[2 * l][((size_t)co * L.Ci + sl.co0 + r) * kk + kk - 1 - (sl.t0 + t)];
      }
      packed[sl.off + e] = v;
    }
  }
}

// Input position (iy, ix) of a task's position index: for a stride-2 layer
// by parity class (fconv::parity_position), whose positions take a fixed
// subset of the taps; else row-major.
__device__ __forceinline__ void in_position(const Layer& L, int pos, int& iy, int& ix) {
  fconv::parity_position(L.Hi, L.Wi, L.s, pos, iy, ix);
}

// The cotangent pass over a tile of F frames (see above). g [N, out_dim] is
// the output's cotangent; dx [N, H, W, C0], or null for no input gradient
// (then the walk stops after the second layer, whose epilogue records the
// first layer's pre-activation cotangent). `tpacked` holds the transposed
// slices as encoder_bwd_pack_kernel wrote them. One block an SM, as its
// shared memory leaves it: with the thread count alone ptxas caps a thread
// at 128 registers, where the shared task loop (conv_common.cuh) spills.
__global__ void __launch_bounds__(kThreads, 1)
encoder_bwd_dx_kernel(Plan P, const float* __restrict__ g, float* __restrict__ dx,
                      const float* __restrict__ stash, float* __restrict__ dstash,
                      const float* __restrict__ tpacked, int N) {
  constexpr int F = kFwdFrames;
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);  // one a slice buffer
  float* buf[3];
  buf[0] = smem + 4;
  buf[1] = buf[0] + F * P.bbsz[0];
  buf[2] = buf[1] + F * P.bbsz[1];
  float* part = buf[2] + F * P.bbsz[2];
  float* WB[2] = {part + P.fpart, part + P.fpart + P.bslice};
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * F;
  const int nf = min(F, N - n0);
  const int stop = dx == nullptr ? 1 : 0;

  auto load_slice = [&](const Slice& sl, int b) {  // thread 0 only
    fconv::bulk_load(WB[b], tpacked + sl.off, 4 * fconv::slice_floats(sl), &bar[b]);
  };
  Slice sl = fenc::make_tslice(P, P.n - 1, 0, 0, 0);
  if (tid == 0) {
    fconv::mbar_init(&bar[0]);
    fconv::mbar_init(&bar[1]);
    load_slice(sl, 0);
  }
  // The head has no activation: its output's cotangent is its
  // pre-activation cotangent (zeros past N), in its buffer and its record.
  {
    const Layer& head = P.L[P.n - 1];
    for (int i = tid; i < F * head.Co; i += kThreads) {
      const int f = i / head.Co, o = i - f * head.Co;
      const float v = f < nf ? g[(size_t)(n0 + f) * head.Co + o] : 0.f;
      buf[head.out_buf][f * P.bbsz[head.out_buf] + o] = v;
      if (f < nf) dstash[(size_t)(n0 + f) * P.dstash + head.dpre_off + o] = v;
    }
  }
  __syncthreads();  // the mbarriers are initialised before any thread waits on them

  float acc[F][4];
  for (int i = 0; sl.layer >= 0; ++i) {
    const Slice next = fenc::next_tslice(P, sl, stop);
    if (tid == 0 && next.layer >= 0) load_slice(next, (i + 1) & 1);
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);
    __syncthreads();  // slice i and the layer's pre-activation cotangent are in place

    const int l = sl.layer;
    const Layer L = P.L[l];
    const int G = (sl.cw + 3) / 4, Gsp = G * sl.sp, tasks = L.Hi * L.Wi * G;
    const bool vec = L.Co % 4 == 0;
    const float* dout = buf[L.out_buf];
    const int dbsz = P.bbsz[L.out_buf];
    // A task of a transposed slice: input position (iy, ix) of every frame
    // of the tile and the input channels cg + G·j, j < 4, of the slice's
    // chunk, summed over the output channels [c0, c1) of the slice's
    // (flipped) taps that reach an output position: tap t of the flipped
    // kernel takes output (ty, tx) / s with ty = iy − (k − 1 − p) + t / k
    // (likewise tx), where both divide by the stride and fall inside the
    // output map. The vector form reads 4 output channels at once (Co % 4
    // == 0).
    auto run = [&](int task, int c0, int c1) {
      const int pos = task / G, cg = task - pos * G;
      int iy, ix;
      in_position(L, pos, iy, ix);
      const int pt = L.k - 1 - L.p;
      auto walk = [&](int tap) {
        const int ky = tap / L.k, kx = tap - ky * L.k;
        const int ty = iy - pt + ky, tx = ix - pt + kx;
        if (ty < 0 || tx < 0 || ty % L.s != 0 || tx % L.s != 0) return -1;
        const int oy = ty / L.s, ox = tx / L.s;
        return oy >= L.Ho || ox >= L.Wo ? -1 : oy * L.Wo + ox;
      };
      const float* wrow = WB[i & 1] + cg * sl.sp;
      if (vec) {
        fconv::conv_taps<F, 4, true>(sl.t0, sl.t0, sl.t1, L.Co, dout, dbsz, wrow, Gsp, c0, c1,
                                     walk, acc);
      } else {
        fconv::conv_taps<F, 4, false>(sl.t0, sl.t0, sl.t1, L.Co, dout, dbsz, wrow, Gsp, c0, c1,
                                      walk, acc);
      }
    };
    // Input cotangent v of frame f, position index pos, chunk row c: the
    // frames' cotangent below the first layer; else, with the skip added
    // where the input also feeds one, times the ELU derivative of the layer
    // below, whose pre-activation cotangent it then is.
    auto emit = [&](float v, int f, int pos, int c) {
      const int r = sl.co0 + c;
      int iy, ix;
      in_position(L, pos, iy, ix);
      const int pin = iy * L.Wi + ix;
      if (l == 0) {
        if (f < nf) dx[((size_t)(n0 + f) * L.Hi * L.Wi + pin) * P.C0 + r] = v;
        return;
      }
      const Layer& B = P.L[l - 1];
      const int j = pin * L.Ci + r;
      float* d = buf[L.in_buf] + f * P.bbsz[L.in_buf] + j;
      if (L.acc_in) v += *d;
      if (f < nf) {
        const float o = stash[(size_t)(n0 + f) * P.stash + B.out_off + j];
        v *= o > 0.f ? 1.f : o + 1.f;
        dstash[(size_t)(n0 + f) * P.dstash + B.dpre_off + j] = v;
      }
      *d = v;
    };
    fconv::slice_tasks<F, 4, kThreads>(sl, tasks, G, L.Co, vec ? 4 : 1, part, run, emit, acc);
    __syncthreads();  // slice i's buffer is free for slice i + 2
    sl = next;
  }
}

// ---- the weight-gradient pass --------------------------------------------------------

// A layer's tiles of the weight-gradient pass: ≤ 64 input × ≤ 64 output
// channels (in float4 groups) of one tap; tiles of each kind, and in all.
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

inline int dw_blocks(const Plan& P) {
  int total = 0, cit, cot, nci, nco;
  for (int l = 0; l < P.n; ++l) total += dw_tiles(P.L[l], cit, cot, nci, nco);
  return total;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(fconv::smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(fconv::smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Copy `count` floats of each of `frames` records (stride `stride` in
// device memory, `dstride` in shared memory) asynchronously: float4s where
// count and both strides allow (every record is 16-byte aligned), else
// floats.
__device__ __forceinline__ void stage_records(float* dst, int dstride, const float* src,
                                              size_t stride, int count, int frames) {
  if (count % 4 == 0 && dstride % 4 == 0) {
    const int q = count / 4;
    for (int e = threadIdx.x; e < frames * q; e += kThreads) {
      const int f = e / q, c = e - f * q;
      cp_async16(dst + f * dstride + 4 * c, src + f * stride + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < frames * count; e += kThreads) {
      const int f = e / count, c = e - f * count;
      cp_async4(dst + f * dstride + c, src + f * stride + c);
    }
  }
}

// One thread's sums over `fs` staged frames: input channels ci + i and
// output channels co + j (i, j < 4; zeros past the tile's channels), over
// its share [q0, q1) of the output positions that tap (ky, kx) reaches
// inside the input map, rows [oy0, ..) × columns [ox0, ox0 + nc) taken
// row-major, walked by pointer increments. With `bias` (the bias tap, which
// reaches every position) also the cotangent sums. The running sums fa, fb
// fold into acc, bacc every `fg` frames (`since` counts them), so that no
// running sum takes more than 256 terms.
template <bool VEC>
__device__ __forceinline__ void dw_frames(const Layer& L, const float* __restrict__ A,
                                          const float* __restrict__ D, int asz, int dsz, int fs,
                                          int q0, int q1, int oy0, int ox0, int nc, int ky,
                                          int kx, int ci, int cie, int co, int coe, bool bias,
                                          int fg, int& since, float (&fa)[4][4], float (&fb)[4],
                                          float (&acc)[4][4], float (&bacc)[4]) {
  const int r0 = q0 / nc, c0 = q0 - r0 * nc;
  for (int f = 0; f < fs; ++f) {
    const float* a = A + f * asz;
    const float* d = D + f * dsz;
    int oy = oy0 + r0, ox = ox0 + c0;
    int dp = (oy * L.Wo + ox) * L.Co + co;
    int ap = ((oy * L.s - L.p + ky) * L.Wi + ox * L.s - L.p + kx) * L.Ci + ci;
    for (int q = q0; q < q1; ++q) {
      float dv[4], av[4];
      if (VEC) {
        const float4 v = *reinterpret_cast<const float4*>(d + dp);
        const float4 u = *reinterpret_cast<const float4*>(a + ap);
        dv[0] = v.x; dv[1] = v.y; dv[2] = v.z; dv[3] = v.w;
        av[0] = u.x; av[1] = u.y; av[2] = u.z; av[3] = u.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = co + j < coe ? d[dp + j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ci + i < cie ? a[ap + i] : 0.f;
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j] += dv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) fa[i][j] = fmaf(av[i], dv[j], fa[i][j]);
      }
      if (++ox == ox0 + nc) {
        ox = ox0;
        ++oy;
        dp = (oy * L.Wo + ox) * L.Co + co;
        ap = ((oy * L.s - L.p + ky) * L.Wi + ox * L.s - L.p + kx) * L.Ci + ci;
      } else {
        dp += L.Co;
        ap += L.s * L.Ci;
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

// Weight and bias gradients of one tile (dw_tiles: blockIdx.x walks the
// layers' tiles in order) and one chunk of frames (blockIdx.y), into
// partial[chunk] in the layout of `gd` (a layer's weight as [Ci·k·k][Co],
// then its bias). The chunk's records, the layer's input activations and
// its pre-activation cotangents, are staged a few frames at a time into
// two buffers, the next in flight while one computes. A thread owns 4 × 4
// gradient elements; with fewer such tasks than threads, S threads a task
// split the positions the tap reaches and their sums are added in order.
// The bias falls out of the cotangents staged for the tap (p, p), which
// reaches every output position (every layer has k ≥ 2p + 1).
__global__ void __launch_bounds__(kThreads, 2)
encoder_bwd_dw_kernel(Plan P, mrssm::WeightDims gd, const float* __restrict__ stash,
                      const float* __restrict__ dstash, float* __restrict__ partial, int N,
                      int chunk) {
  extern __shared__ __align__(16) float smem[];
  int b = blockIdx.x, l = 0, cit, cot, nci, nco;
  for (;; ++l) {
    const int nb = dw_tiles(P.L[l], cit, cot, nci, nco);
    if (b < nb) break;
    b -= nb;
  }
  const Layer L = P.L[l];
  const int kk = L.k * L.k, tap = b / (nci * nco), rr = b - tap * (nci * nco);
  const int ci0 = rr / nco * cit, co0 = rr % nco * cot;
  const int cie = min(L.Ci, ci0 + cit), coe = min(L.Co, co0 + cot);
  const int gi = (cie - ci0 + 3) / 4, go = (coe - co0 + 3) / 4, tasks = gi * go;
  const int ky = tap / L.k, kx = tap - ky * L.k;
  // The output rows and columns whose input (o·s − p + tap) is inside the map.
  const int oy0 = ky >= L.p ? 0 : (L.p - ky + L.s - 1) / L.s;
  const int ox0 = kx >= L.p ? 0 : (L.p - kx + L.s - 1) / L.s;
  const int ny = L.Hi - 1 + L.p - ky, nx = L.Wi - 1 + L.p - kx;
  const int nr = max(0, min(L.Ho, ny < 0 ? 0 : ny / L.s + 1) - oy0);
  const int nc = max(0, min(L.Wo, nx < 0 ? 0 : nx / L.s + 1) - ox0);
  const int V = nr * nc, S = max(1, min(kThreads / tasks, V));
  const int tid = threadIdx.x, task = tid % tasks, s = tid / tasks;
  const int ci = ci0 + task / go * 4, co = co0 + task % go * 4;
  const int btap = L.p * L.k + L.p;
  const bool bias = tap == btap && ci0 == 0;
  const bool vec = L.Ci % 4 == 0 && L.Co % 4 == 0;
  const int q0 = s * V / S, q1 = (s + 1) * V / S;
  const int fg = max(1, 256 / max(1, (V + S - 1) / S));
  const int asz = L.Hi * L.Wi * L.Ci, dsz = L.Ho * L.Wo * L.Co, dsz4 = (dsz + 3) / 4 * 4;
  const int fmax = max(1, P.dwstage / (asz + dsz4));
  float* stage[2] = {smem, smem + P.dwstage};
  const int n_begin = blockIdx.y * chunk, n_end = min(N, n_begin + chunk);
  const int stages = (n_end - n_begin + fmax - 1) / fmax;

  auto load = [&](int st) {
    const int n0 = n_begin + st * fmax, fs = min(fmax, n_end - n0);
    float* dst = stage[st & 1];
    stage_records(dst, asz, stash + (size_t)n0 * P.stash + L.in_off, P.stash, asz, fs);
    stage_records(dst + fmax * asz, dsz4, dstash + (size_t)n0 * P.dstash + L.dpre_off, P.dstash,
                  dsz, fs);
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
    const int fs = min(fmax, n_end - (n_begin + st * fmax));
    if (s < S && q0 < q1) {
      if (vec) {
        dw_frames<true>(L, A, A + fmax * asz, asz, dsz4, fs, q0, q1, oy0, ox0, nc, ky, kx, ci,
                        cie, co, coe, bias, fg, since, fa, fb, acc, bacc);
      } else {
        dw_frames<false>(L, A, A + fmax * asz, asz, dsz4, fs, q0, q1, oy0, ox0, nc, ky, kx, ci,
                         cie, co, coe, bias, fg, since, fa, fb, acc, bacc);
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
      if (c < cie && o < coe) out[gd.off[2 * l] + (c * kk + tap) * L.Co + o] = v;
    } else if (bias && t / go == 0 && tco + k - 16 < coe) {
      out[gd.off[2 * l + 1] + tco + k - 16] = v;
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
  for (int e = tid; e < tasks * 20; e += kThreads) {
    const int t = e / 20, k = e - t * 20;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += red[(q * tasks + t) * 20 + k];
    store(t, k, v);
  }
}

// The gradient layout: per layer its weight as [in = Ci·k·k, out = Co] and
// its bias [1, Co], back to back in layer order (reduce_weight_grads writes
// each weight as torch's [Co, Ci, k, k]).
mrssm::WeightDims grad_dims(const Plan& P) {
  int in[mrssm::kMaxWeights], out[mrssm::kMaxWeights];
  for (int l = 0; l < P.n; ++l) {
    const Layer& L = P.L[l];
    in[2 * l] = L.Ci * L.k * L.k;
    in[2 * l + 1] = 1;
    out[2 * l] = out[2 * l + 1] = L.Co;
  }
  return mrssm::weight_dims(in, out, 2 * P.n);
}

}  // namespace

extern "C" {

// Launch on `stream` the five steps above. x [N, H, W, C0], coords [H + W],
// g [N, out_dim]; dx [N, H, W, C0] or null; d_weights the gradient floats
// (fused_encoder_sizes' sizes[2]) in torch layout, every tensor back to
// back; stash, dstash and partial are scratch of N·sizes[0], N·sizes[1] and
// sizes[3]·sizes[2] floats, packed of sizes[4] floats (16-byte aligned).
// All f32 and contiguous. Returns the cudaError_t of the launches (0 on
// success).
int fused_encoder_backward(const void* const* weights, int n_weights, const float* x,
                           const float* coords, const float* g, float* dx, float* d_weights,
                           float* stash, float* dstash, float* partial, float* packed,
                           fenc::EncDims d, void* stream) {
  fenc::Plan P;
  if (!fenc::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  const mrssm::WeightPtrs w = mrssm::weight_ptrs(weights, n_weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fenc::launch_forward(w, P, x, coords, packed, nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  float* tpacked = packed + P.packed;
  encoder_bwd_pack_kernel<<<dim3(8, P.n), 256, 0, s>>>(w, P, tpacked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.N + kFwdFrames - 1) / kFwdFrames;
  encoder_bwd_dx_kernel<<<blocks, kThreads, P.bsmem, s>>>(P, g, dx, stash, dstash, tpacked, d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.dwsmem);
  if (err != cudaSuccess) return (int)err;
  const mrssm::WeightDims gd = grad_dims(P);
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  encoder_bwd_dw_kernel<<<dim3(dw_blocks(P), chunks), kThreads, P.dwsmem, s>>>(
      P, gd, stash, dstash, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mrssm::reduce_weight_grads_launch(partial, chunks, gd, d_weights, s);
}

}  // extern "C"
