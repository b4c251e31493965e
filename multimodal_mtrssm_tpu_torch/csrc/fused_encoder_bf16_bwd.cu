// The conv encoder in bf16, backward (design notes in
// fused_encoder_bf16.cuh).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461) at dtype=bfloat16, the custom VJP of fused_encoder_apply
// (lines 530-558): the bf16 gradients of every encoder weight and bias and,
// when asked, of the frames. Five launches: the packing (both directions)
// and the forward recomputing and recording the activations (bf16);
// encoder_bf16_tc_dx_kernel, the cotangent pass on the tensor cores (f32
// maps, split hi/lo operands), recording each layer's pre-activation
// cotangent split hi/lo; encoder_bf16_tc_dw_kernel, the weight-gradient
// GEMMs, a tile of (tap, input channel) rows × output channels and one
// chunk of frames a block; encoder_bf16_tc_reduce_kernel, the chunks added
// in order and the gradients rounded to bf16.
#include "fused_encoder_bf16.cuh"

namespace fbf {
namespace {

// The cotangent pass over a tile of P.F frames: g [N, out_dim] (bf16) →
// every layer's pre-activation cotangent, hi then lo halves ([position][C16]
// each), in the record dpre (P.dstash floats a frame) and, when dx is not
// null, the frames' cotangent (bf16, image channels). The maps in shared
// memory hold each cotangent as its two bf16 terms too (hi, then lo, each
// [position][C16 + 8]), which ldmatrix gives the tensor cores; a layer with
// Layer::aglob reads them from the record instead (layer 0, dx only; the
// widest maps where shared memory is short). A residual block's output
// cotangent is also kept in f32 (`skip`) for its input's. Layer l reads its
// output's cotangent from map buffer (l + 1) & 1 and writes its input's to
// buffer l & 1.
__global__ void __launch_bounds__(kThreads)
encoder_bf16_tc_dx_kernel(const __grid_constant__ Plan Pp, const bf16* __restrict__ packed,
                          const bf16* __restrict__ stash, const bf16* __restrict__ g,
                          bf16* __restrict__ dpre, bf16* __restrict__ dx, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Plan sP;
  const Plan& P = shared_plan(Pp, sP);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  bf16* zero = reinterpret_cast<bf16*>(smem + 16);
  const int F = P.F;
  bf16* buf[2];
  buf[0] = reinterpret_cast<bf16*>(smem + 32);
  buf[1] = buf[0] + F * P.bbuf[0];
  float* skip = reinterpret_cast<float*>(buf[1] + F * P.bbuf[1]);
  bf16* WB[2];
  WB[0] = reinterpret_cast<bf16*>(skip + F * P.sbuf);
  WB[1] = WB[0] + P.cap / 2;
  float* red = reinterpret_cast<float*>(WB[1] + P.cap / 2);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * F, nf = min(F, N - n0);
  const int stop = dx != nullptr ? 0 : 1;

  Slice sl = make_slice(P, 1, P.n - 1, 0, 0, 0);
  if (tid == 0) {
    fconv::mbar_init(&bar[0]);
    fconv::mbar_init(&bar[1]);
    load_slice(sl, packed, WB[0], &bar[0]);
  }
  if (tid < 8) zero[tid] = rn(0.f);
  // The head's pre-activation cotangent is the output's (zeros past N): a
  // bf16 value, so its lo term is zero.
  {
    const Layer& Hd = P.L[P.n - 1];
    bf16* hb = buf[P.n & 1];
    for (int i = tid; i < F * Hd.C16o; i += kThreads) {
      const int f = i / Hd.C16o, co = i - f * Hd.C16o;
      const bf16 v = f < nf && co < Hd.Co ? g[(size_t)(n0 + f) * Hd.Co + co] : rn(0.f);
      hb[f * P.bbuf[P.n & 1] + co] = v;
      hb[f * P.bbuf[P.n & 1] + Hd.C16o + 8 + co] = rn(0.f);
      if (f < nf) {
        bf16* rec = dpre + (size_t)(n0 + f) * 2 * P.dstash + Hd.dp_off;
        rec[co] = v;
        rec[Hd.C16o + co] = rn(0.f);
      }
    }
  }
  __syncthreads();  // the mbarriers and the head's cotangent are in place

  float acc[kSlots][8];
  for (int i = 0; sl.layer >= 0; ++i) {
    if (tid == 0) {
      const Slice nx = next_slice(P, 1, sl, stop);
      if (nx.layer >= 0) load_slice(nx, packed, WB[(i + 1) & 1], &bar[(i + 1) & 1]);
    }
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);

    const int l = sl.layer;
    const Layer& L = P.L[l];
    // the layer's numbers in registers for the loops below
    const int Lk = L.k, Ls = L.s, Lp = L.p, Wi = L.Wi, Ho = L.Ho, Wo = L.Wo, cls = L.cls;
    const int cpos = L.cpos, C16i = L.C16i, C16o = L.C16o, acc_in = L.acc_in, aglob = L.aglob;
    const int istride = 2 * (C16o + 8), ostride = C16i + 8, cpo = C16o / 16;  // bytes, elements
    const int lo_in = Ho * Wo * istride;  // bytes from a hi term to its lo term
    const int mtc = (F * cpos + 15) / 16;  // m-tiles a class
    const int mtg = sl.mtg, m0 = sl.m0, tasks = mtg * (sl.cw / 16);
    const int sp = (sl.s1 - sl.s0) * 16 + 8, s0 = sl.s0, r0 = sl.r0;
    const unsigned in_s = saddr(buf[(l + 1) & 1]), zero_s = saddr(zero), w_s = saddr(WB[i & 1]);
    const int ibsz = P.bbuf[(l + 1) & 1], obsz = P.bbuf[l & 1];
    const bf16* arec = dpre + L.dp_off;  // a frame's record of this layer's output cotangent
    bf16* ob = buf[l & 1];

    // Row r of a class's rows (frame-major) → frame and input position.
    auto position = [&](int cl, int r, int& f, int& iy, int& ix) {
      f = r / cpos;
      const int rr = r - f * cpos;
      if (cls == 4) {
        const int hw = Wi / 2, ry = rr / hw;
        iy = 2 * ry + (cl >> 1);
        ix = 2 * (rr - ry * hw) + (cl & 1);
      } else {
        iy = rr / Wi;
        ix = rr - iy * Wi;
      }
    };
    // The output position whose cotangent tap (ky, kx) takes to input
    // position (iy, ix), or -1.
    auto source = [&](int f, int iy, int ix, int ky, int kx) {
      const int ty = iy + Lp - ky, tx = ix + Lp - kx, oy = ty / Ls, ox = tx / Ls;
      return f < F && ty >= 0 && tx >= 0 && oy < Ho && ox < Wo && oy * Ls == ty && ox * Ls == tx
                 ? oy * Wo + ox
                 : -1;
    };
    // k-steps [ka, kb) of task (m-tile, n-pair) into a[8]: the output
    // cotangents' hi and lo terms each tap reads, times the transposed
    // weights, the lo products in sums of their own. A stride-2 class
    // takes the taps of its parity only.
    auto run = [&](int task, int ka, int kb, float* a8) {
      if (ka >= kb) return;
      const int mt = m0 + task % mtg, np = task / mtg, cl = mt / mtc;
      const int rb = (mt - cl * mtc) * 16;
      // ldmatrix rows (shared maps), or the fragment's own rows (the record)
      int f, iy, ix, fr[2], iyr[2], ixr[2];
      position(cl, rb + (lane & 7) + ((lane >> 3) & 1) * 8, f, iy, ix);
      position(cl, rb + (lane >> 2), fr[0], iyr[0], ixr[0]);
      position(cl, rb + (lane >> 2) + 8, fr[1], iyr[1], ixr[1]);
      const unsigned abase = in_s + (f < F ? f : 0) * ibsz * 2 + 16 * (lane >> 4);
      const unsigned bb0 = w_s + 2 * ((np * 16 + (lane & 7) + (lane >> 4) * 8) * sp +
                                      ((lane >> 3) & 1) * 8 - s0 * 16);
      int tap = ka / cpo, cs = ka - tap * cpo, ky = tap / Lk, kx = tap - ky * Lk;
      float l8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int st = ka; st < kb; ++tap) {
        const int n = min(cpo - cs, kb - st);  // k-steps of this tap in range
        const bool taken = cls != 4 || ((((cl >> 1) + Lp - ky) & 1) == 0 &&
                                        (((cl & 1) + Lp - kx) & 1) == 0);
        if (taken && !aglob) {
          const int o = source(f, iy, ix, ky, kx);
          const unsigned ah = o >= 0 ? abase + o * istride + 32 * cs : zero_s;
          const unsigned al = o >= 0 ? ah + lo_in : zero_s, astep = o >= 0 ? 32 : 0;
          unsigned bp = bb0 + 32 * st;
          for (int e = 0; e < n; ++e, bp += 32) {
            unsigned hi[4], lo[4], bfr[4];
            ldsm4(hi, ah + e * astep);
            ldsm4(lo, al + e * astep);
            ldsm4(bfr, bp);
            mma(a8, hi, bfr[0], bfr[1]);
            mma(a8 + 4, hi, bfr[2], bfr[3]);
            mma(l8, lo, bfr[0], bfr[1]);
            mma(l8 + 4, lo, bfr[2], bfr[3]);
          }
        } else if (taken) {
          const unsigned* ar[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = source(fr[h], iyr[h], ixr[h], ky, kx);
            ar[h] = o < 0 || n0 + fr[h] >= N
                        ? nullptr
                        : reinterpret_cast<const unsigned*>(
                              arec + (size_t)(n0 + fr[h]) * 2 * P.dstash + o * C16o + 16 * cs +
                              2 * (lane & 3));
          }
          unsigned bp = bb0 + 32 * st;
          for (int e = 0; e < n; ++e, bp += 32) {
            unsigned hi[4], lo[4], bfr[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned* q = ar[h] + 8 * e;
              const bool ok = ar[h] != nullptr;
              hi[h] = ok ? __ldcg(q) : 0u;
              hi[h + 2] = ok ? __ldcg(q + 4) : 0u;
              lo[h] = ok ? __ldcg(q + Ho * Wo * C16o / 2) : 0u;
              lo[h + 2] = ok ? __ldcg(q + Ho * Wo * C16o / 2 + 4) : 0u;
            }
            ldsm4(bfr, bp);
            mma(a8, hi, bfr[0], bfr[1]);
            mma(a8 + 4, hi, bfr[2], bfr[3]);
            mma(l8, lo, bfr[0], bfr[1]);
            mma(l8 + 4, lo, bfr[2], bfr[3]);
          }
        }
        st += n;
        cs = 0;
        if (++kx == Lk) {
          kx = 0;
          ++ky;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) a8[e] += l8[e];
    };
    // The epilogue of task (m-tile, n-pair): below layer 0, dx; else the
    // input's cotangent (plus the residual skip's), times the derivative of
    // the layer below from its recorded output, split hi/lo into the map
    // (unless the layer below reads the record) and the record, and kept in
    // f32 where it is a residual block's output. Loads go before stores.
    auto emit = [&](int task, const float* a8) {
      const int mt = m0 + task % mtg, np = task / mtg, cl = mt / mtc;
      const Layer& B = P.L[l > 0 ? l - 1 : 0];
      const int b_out = B.st_out, b_dp = B.dp_off, b_npos = B.Ho * B.Wo;
      const bool keep_map = l > 0 && !B.aglob, keep_f32 = B.mode == kResidual;
      int fr[2], ip[2];
      float2 y[2][2], sk[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int iy, ix;
        position(cl, (mt - cl * mtc) * 16 + (lane >> 2) + h * 8, fr[h], iy, ix);
        ip[h] = iy * Wi + ix;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = r0 + np * 16 + j * 8 + 2 * (lane & 3);
          const bool live = l > 0 && fr[h] < nf;
          y[h][j] = live ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                               stash + (size_t)(n0 + fr[h]) * P.stash + b_out + ip[h] * C16i + ci))
                         : make_float2(0.f, 0.f);
          sk[h][j] = acc_in && fr[h] < F
                         ? *reinterpret_cast<const float2*>(skip + fr[h] * P.sbuf +
                                                            ip[h] * ostride + ci)
                         : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = fr[h], ipos = ip[h];
        if (f >= F) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = r0 + np * 16 + j * 8 + 2 * (lane & 3);
          float v0 = a8[4 * j + 2 * h] + sk[h][j].x, v1 = a8[4 * j + 2 * h + 1] + sk[h][j].y;
          if (l == 0) {
            if (f < nf) {
              bf16* d = dx + ((size_t)(n0 + f) * P.H * P.W + ipos) * P.C0;
              if (ci < P.C0) d[ci] = rn(v0);
              if (ci + 1 < P.C0) d[ci + 1] = rn(v1);
            }
            continue;
          }
          if (f < nf) {
            v0 *= y[h][j].x > 0.f ? 1.f : y[h][j].x + 1.f;
            v1 *= y[h][j].y > 0.f ? 1.f : y[h][j].y + 1.f;
          } else {
            v0 = v1 = 0.f;
          }
          unsigned hi, lo;
          split2(make_float2(v0, v1), hi, lo);
          if (keep_map) {
            unsigned* o = reinterpret_cast<unsigned*>(ob + f * obsz + ipos * ostride + ci);
            o[0] = hi;
            o[b_npos * ostride / 2] = lo;
          }
          if (keep_f32) {
            *reinterpret_cast<float2*>(skip + f * P.sbuf + ipos * ostride + ci) =
                make_float2(v0, v1);
          }
          if (f < nf) {
            unsigned* rec = reinterpret_cast<unsigned*>(
                dpre + (size_t)(n0 + f) * 2 * P.dstash + b_dp + ipos * C16i + ci);
            rec[0] = hi;
            rec[b_npos * C16i / 2] = lo;
          }
        }
      }
    };

    schedule(sl, tasks, acc, red, run, emit);
    __syncthreads();  // the layer's input cotangent is in place; slice i's buffer is free
    sl = next_slice(P, 1, sl, stop);
  }
}

// The weight-gradient pass: block (tile, chunk, sub). A tile is a layer's
// m-tiles [ma, mb) of (tap, input channel) rows (the bias's m-tile has A =
// ones) × n-tiles [na, nb) of output channels; the chunk's recorded inputs
// (channels [w0, w0 + window)) and split cotangents (the tile's columns)
// are staged by cp.async fs frames at a time into two buffers. A warp owns
// 3 m-tiles × 4 n-tiles; with fewer such warp tiles than warps, S warps a
// tile split each stage's k-steps and their sums are added in order. The
// first layers (Layer::sub > 1: few tiles, long chunks) cut a chunk's frames
// in L.sub parts, part z > 0 into partial sums of its own past the chunks'.
__global__ void __launch_bounds__(kThreads, 2)
encoder_bf16_tc_dw_kernel(const __grid_constant__ Plan Pp, const bf16* __restrict__ stash,
                          const bf16* __restrict__ dpre, float* __restrict__ partial, int N,
                          int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Plan sP;
  const Plan& P = shared_plan(Pp, sP);
  bf16* zero = reinterpret_cast<bf16*>(smem);
  bf16* stage0 = reinterpret_cast<bf16*>(smem + 32);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int l = 0;
  while (l + 1 < P.n && P.L[l + 1].tile0 <= (int)blockIdx.x) ++l;
  const Layer& L = P.L[l];
  const int z = blockIdx.z;
  if (z >= L.sub) return;
  const int b = blockIdx.x - L.tile0, rti = b / L.nct, cti = b - rti * L.nct;
  const int cps = L.C16i / 16, kk = L.k * L.k, npos = L.Ho * L.Wo;
  int ma, mb, w0 = 0, win = L.C16i;
  if (L.pertap) {
    const int tpt = (cps + L.rt - 1) / L.rt;
    if (rti == L.nrt - 1) {
      ma = L.mtw - 1;
      mb = L.mtw;
      win = 0;
    } else {
      const int tap = rti / tpt, part = rti - tap * tpt;
      ma = tap * cps + part * L.rt;
      mb = min(tap * cps + cps, ma + L.rt);
      w0 = part * L.rt * 16;
      win = (mb - ma) * 16;
    }
  } else {
    ma = rti * L.rt;
    mb = min(L.mtw, ma + L.rt);
  }
  const int astr = L.pertap ? L.rt * 16 + 8 : L.C16i + 8;  // a staged position's stride
  const int na = cti * L.ct, nb = min(L.C16o / 8, na + L.ct), nstr = L.ct * 8 + 8;
  const int wtm = (mb - ma + 2) / 3, npairs = (nb - na) / 2, wtn = (npairs + 1) / 2;
  const int WT = wtm * wtn, S = max(1, kWarps / WT);
  const int wt = warp % WT, split = warp / WT, wm = wt % wtm, wn = wt / wtm;
  const bool active = split < S;
  int lg = 0;
  while ((1 << lg) < npos) ++lg;

  const int fs = L.fs, per = L.apf + 2 * L.dpf;
  const int cbeg = blockIdx.y * chunk, clen = min(N, cbeg + chunk) - cbeg;
  const int nbeg = cbeg + clen * z / L.sub, nend = cbeg + clen * (z + 1) / L.sub;
  const int stages = (nend - nbeg + fs - 1) / fs;
  if (tid < 16) zero[tid] = rn(0.f);

  auto load = [&](int st) {
    const int m0 = nbeg + st * fs, fsz = min(fs, nend - m0);
    bf16* A = stage0 + (st & 1) * fs * per;
    bf16* Dh = A + fs * L.apf;
    bf16* Dl = Dh + fs * L.dpf;
    for (int f = 0; f < fsz; ++f) {
      const bf16* rec = stash + (size_t)(m0 + f) * P.stash;
      if (L.pair) {
        for (int e = tid; e < L.apf / 8; e += kThreads) {
          fconv::cp_async16(reinterpret_cast<float*>(A + f * L.apf + 8 * e),
                            reinterpret_cast<const float*>(rec + L.st_in + 8 * e));
        }
      } else if (L.flat) {
        const int cnt = (min(mb, L.mtw - 1) - ma) * 2;  // 16-byte units
        for (int e = tid; e < cnt; e += kThreads) {
          fconv::cp_async16(reinterpret_cast<float*>(A + f * L.apf + 8 * e),
                            reinterpret_cast<const float*>(rec + L.st_in + ma * 16 + 8 * e));
        }
      } else {
        const int u = win / 8, cnt = L.Hi * L.Wi * u;
        for (int e = tid; e < cnt; e += kThreads) {
          const int pos = e / u, k = e - pos * u;
          fconv::cp_async16(
              reinterpret_cast<float*>(A + f * L.apf + pos * astr + 8 * k),
              reinterpret_cast<const float*>(rec + L.st_in + pos * L.C16i + w0 + 8 * k));
        }
      }
      const bf16* d = dpre + (size_t)(m0 + f) * 2 * P.dstash + L.dp_off;
      const int u = nb - na, cnt = npos * u;
      for (int e = tid; e < 2 * cnt; e += kThreads) {
        const int half = e / cnt, r = e - half * cnt, pos = r / u, k = r - pos * u;
        fconv::cp_async16(
            reinterpret_cast<float*>((half ? Dl : Dh) + f * L.dpf + pos * nstr + 8 * k),
            reinterpret_cast<const float*>(d + half * npos * L.C16o + pos * L.C16o +
                                           8 * (na + k)));
      }
    }
    fconv::cp_async_commit();
  };

  float acc[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  // The warp's m-tiles, fixed for the block: which are present, the bias,
  // and where each reads its A rows (tap offsets and channel byte).
  const int Ls = L.s, Hi = L.Hi, Wi = L.Wi, Wo = L.Wo, npairs_w = min(2, npairs - 2 * wn);
  int lgw = 0;
  while ((1 << lgw) < Wo) ++lgw;
  const int mch = (lane >> 3) & 1;  // the A matrix's m-chunk this lane addresses
  int mdy[3], mdx[3], mcb[3], mkind[3];  // kind: 0 none, 1 weight rows, 2 bias
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m = ma + 3 * wm + i;
    mkind[i] = m >= mb ? 0 : m == L.mtw - 1 ? 2 : 1;
    mdy[i] = mdx[i] = mcb[i] = 0;
    if (mkind[i] != 1) continue;
    if (L.pair) {
      mdy[i] = m;                       // the row of taps
      mcb[i] = 16 * mch;                // two taps of 4 channels a chunk
    } else if (L.flat) {
      mcb[i] = 32 * (m - ma) + 16 * mch;
    } else {
      const int tap = m / cps, ky = tap / L.k;
      mdy[i] = ky - L.p;
      mdx[i] = tap - ky * L.k - L.p;
      mcb[i] = 2 * ((m - tap * cps) * 16 + 8 * mch - w0);
    }
  }
  const unsigned zero_s = saddr(zero), st_s = saddr(stage0);
  // A's k-half; B's k-half and n-tile
  const int qa = lane >> 4, qb = (lane >> 3) & 1, nsel = lane >> 4;
  const unsigned one2 = 0x3F803F80u;  // two bf16 ones
  load(0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load(st + 1);
      fconv::cp_async_wait<1>();
    } else {
      fconv::cp_async_wait<0>();
    }
    __syncthreads();  // stage st is in place
    const unsigned A_s = st_s + 2 * (st & 1) * fs * per;
    const unsigned Dh_s = A_s + 2 * fs * L.apf, Dl_s = Dh_s + 2 * fs * L.dpf;
    const int fsz = min(fs, nend - (nbeg + st * fs));
    const int ksteps = (fsz * npos + 15) / 16;
    if (active) {
      const int ka = ksteps * split / S, kb = ksteps * (split + 1) / S;
      for (int ks = ka; ks < kb; ++ks) {
        unsigned bh[2][4], bl[2][4];
        {
          const int kr = ks * 16 + qb * 8 + (lane & 7), f = kr >> lg, pos = kr & (npos - 1);
          const bool ok = f < fsz;
          const unsigned off = 2 * (f * L.dpf + pos * nstr + (4 * wn + nsel) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= npairs_w) continue;
            ldsm4t(bh[j], ok ? Dh_s + off + 32 * j : zero_s);
            ldsm4t(bl[j], ok ? Dl_s + off + 32 * j : zero_s);
          }
        }
        const int kr = ks * 16 + qa * 8 + (lane & 7), f = kr >> lg, pos = kr & (npos - 1);
        const int oy = pos >> lgw, ox = pos & (Wo - 1);
        const bool fok = f < fsz;
        const unsigned Af = A_s + 2 * f * L.apf;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (mkind[i] == 0) continue;
          unsigned a[4];
          if (mkind[i] == 2) {
            a[0] = a[1] = a[2] = a[3] = one2;
          } else {
            unsigned ap = zero_s;
            if (fok) {
              if (L.pair) {
                ap = Af + 8 * ((2 * oy + mdy[i]) * (Wi + 2) + 2 * ox) + mcb[i];
              } else if (L.flat) {
                ap = Af + mcb[i];
              } else {
                const int iy = oy * Ls + mdy[i], ix = ox * Ls + mdx[i];
                if (iy >= 0 && iy < Hi && ix >= 0 && ix < Wi) {
                  ap = Af + 2 * (iy * Wi + ix) * astr + mcb[i];
                }
              }
            }
            ldsm4t(a, ap);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= npairs_w) continue;
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              mma(acc[i][2 * j + t], a, bh[j][2 * t], bh[j][2 * t + 1]);
              mma(acc[i][2 * j + t], a, bl[j][2 * t], bl[j][2 * t + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st's buffer is free for stage st + 2
  }

  // Splits 1.. S-1 hand their sums to split 0 through the staging buffers.
  float* red = reinterpret_cast<float*>(stage0);
  if (S > 1) {
    if (active && split > 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[((((split - 1) * WT + wt) * 3 + i) * 16 + j * 4 + e) * 32 + lane] = acc[i][j][e];
          }
        }
      }
    }
    __syncthreads();
    if (split == 0) {
      for (int q = 1; q < S; ++q) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] += red[((((q - 1) * WT + wt) * 3 + i) * 16 + j * 4 + e) * 32 + lane];
            }
          }
        }
      }
    }
  }
  if (split != 0) return;
  // Gradient elements into partial[chunk], torch layout: weight [Co][Ci][k][k], then bias.
  float* out = partial + L.g_off +
               (z == 0 ? (size_t)blockIdx.y * P.grads
                       : (size_t)gridDim.y * P.grads +
                             ((size_t)blockIdx.y * (kDwSub - 1) + z - 1) * P.dw_small);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m = ma + 3 * wm + i;
    if (m >= mb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * wn + j / 2 >= npairs) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (lane >> 2) + 8 * (e >> 1);
        const int co = (na + (2 * wn + j / 2) * 2 + (j & 1)) * 8 + 2 * (lane & 3) + (e & 1);
        if (co >= L.Co) continue;
        if (m == L.mtw - 1) {
          if (row == 0) out[L.Co * L.Ci * kk + co] = acc[i][j][e];
          continue;
        }
        int ci, tap;
        if (L.pair) {
          const int kx = row >> 2;
          ci = row & 3;
          tap = kx < L.k ? m * L.k + kx : -1;
        } else {
          tap = m / cps;
          ci = (m - tap * cps) * 16 + row;
        }
        if (tap >= 0 && ci < L.Ci) out[((size_t)co * L.Ci + ci) * kk + tap] = acc[i][j][e];
      }
    }
  }
}

// The chunks added in order (each chunk's parts in order for the first
// layers' gradients), each gradient rounded to bf16.
__global__ void encoder_bf16_tc_reduce_kernel(int grads, int small, int chunks,
                                              const float* __restrict__ partial,
                                              bf16* __restrict__ out) {
  const float* extra = partial + (size_t)chunks * grads;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < grads; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) {
      s += partial[(size_t)c * grads + e];
      if (e < small) {
        for (int z = 0; z < kDwSub - 1; ++z) s += extra[((size_t)c * (kDwSub - 1) + z) * small + e];
      }
    }
    out[e] = rn(s);
  }
}

}  // namespace
}  // namespace fbf

extern "C" {

// Launch on `stream` the backward of fused_encoder_bf16_forward under the
// bf16 cotangent g [N, out_dim]: dx (bf16, the frames' shape; skipped when
// null), grads (bf16, sizes[2] elements, torch layout, tensor after
// tensor), and the scratch: stash (sizes[0] bf16 elements a frame), dpre
// (sizes[1] floats a frame, held as bf16 hi/lo halves), partial (sizes[3]
// × sizes[2] floats: the frame chunks' partial sums, then the first layers'
// parts), packed (sizes[4] bf16 elements). Returns the cudaError_t of the
// launches.
int fused_encoder_bf16_backward(const void* const* weights, int n_weights, const fbf::bf16* x,
                                const float* coords, const fbf::bf16* g, fbf::bf16* dx,
                                fbf::bf16* grads, fbf::bf16* stash, float* dpre, float* partial,
                                fbf::bf16* packed, fbf::EncDims d, void* stream) {
  fbf::Plan P;
  if (!fbf::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fbf::bf16* rec = reinterpret_cast<fbf::bf16*>(dpre);
  cudaError_t err = fbf::launch_forward(fbf::weight_ptrs(weights, n_weights), P, x, coords, packed,
                                        nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fbf::encoder_bf16_tc_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  fbf::encoder_bf16_tc_dx_kernel<<<(d.N + P.F - 1) / P.F, fbf::kThreads, P.bsmem, s>>>(
      P, packed, stash, g, rec, dx, d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  err = cudaFuncSetAttribute(fbf::encoder_bf16_tc_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.wsmem);
  if (err != cudaSuccess) return (int)err;
  fbf::encoder_bf16_tc_dw_kernel<<<dim3(P.dw_tiles, chunks, fbf::kDwSub), fbf::kThreads,
                                    P.wsmem, s>>>(
      P, stash, rec, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fbf::encoder_bf16_tc_reduce_kernel<<<(P.grads + fbf::kThreads - 1) / fbf::kThreads,
                                       fbf::kThreads, 0, s>>>(P.grads, P.dw_small, chunks,
                                                              partial, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
