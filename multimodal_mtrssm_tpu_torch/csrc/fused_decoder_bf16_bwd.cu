// The conv decoder on bf16 features, backward (design notes in
// fused_decoder_bf16.cuh).
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_bwd_kernel
// (line 461) at dtype=bfloat16, the custom VJP of fused_decoder_apply's
// segments (lines 530-558) for bf16 features: the bf16 gradients of every
// decoder weight and bias and, when asked, of the features. Five launches:
// the packing (both directions) and the forward recomputing and recording
// the activations (bf16); decoder_bf16_tc_dx_kernel, the cotangent pass on
// the tensor cores (split hi/lo operands), recording each layer's
// pre-activation cotangent split hi/lo; decoder_bf16_tc_dw_kernel, the
// weight-gradient GEMMs, a tile of (tap, input channel) rows × output
// columns and one chunk of frames a block; decoder_bf16_tc_reduce_kernel,
// the chunks added in order and the gradients rounded to bf16.
#include "fused_decoder_bf16.cuh"

namespace fdbf {
namespace {

// The index, in a transposed conv's class-major cotangent record, of its
// output position (oy, ox) on an output map `wo` wide with `hw` positions a
// class.
__device__ __forceinline__ int class_major(int oy, int ox, int wo, int hw) {
  return ((oy & 1) * 2 + (ox & 1)) * hw + (oy >> 1) * (wo >> 1) + (ox >> 1);
}

// The cotangent pass over a tile of P.F frames: g [N, 32, 32, 1] (bf16) →
// every layer's pre-activation cotangent, hi then lo halves, in the record
// dpre (P.dstash bf16 elements a frame) and, when dx is not null, the
// features' cotangent (bf16). The last layer's pre-activation cotangent g ·
// (1 − o²) is kept in f32 with a zero halo (`halo`), from which its
// transposed GEMM gathers its A fragments (16 taps × 1 channel, one
// k-step). Every other layer's is kept in shared memory as its two bf16
// terms (hi, then lo, each [position][C16 + 8]), which ldmatrix gives the
// tensor cores; layer l reads its output's from map buffer (l + 1) & 1 and
// writes its input's to buffer l & 1. A layer with Layer::aglob (the
// largest map, 16×16 at the reference widths: two blocks an SM instead of
// one) reads its output's from the record instead, the lanes loading their
// fragments' 32-bit words. A residual block's output cotangent is also kept
// in f32 (`skip`) for its input's. Two blocks an SM, as its shared memory
// leaves them.
__global__ void __launch_bounds__(kThreads, 2)
decoder_bf16_tc_dx_kernel(const __grid_constant__ Plan Pp, const bf16* __restrict__ packed,
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
  float* halo = skip + F * P.sbuf;
  bf16* WB[2];
  WB[0] = reinterpret_cast<bf16*>(halo + F * P.halo);
  WB[1] = WB[0] + P.cap[1] / 2;
  float* red = reinterpret_cast<float*>(WB[1] + P.cap[1] / 2);
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
  // The last layer's pre-activation cotangent (zeros past N and in the
  // halo): the haloed map and the record, one channel of dps, hi and lo.
  {
    const Layer& Lt = P.L[P.n - 1];
    const int Wh = Lt.Wo + 2, nh = (Lt.Ho + 2) * Wh, npos = Lt.Ho * Lt.Wo, hw = Lt.Hi * Lt.Wi;
    for (int i = tid; i < F * P.halo; i += kThreads) {
      const int f = i / P.halo, pos = i - f * P.halo, hy = pos / Wh, hx = pos - hy * Wh;
      float d = 0.f;
      if (f < nf && pos < nh && hy >= 1 && hy <= Lt.Ho && hx >= 1 && hx <= Lt.Wo) {
        const int oy = hy - 1, ox = hx - 1, q = oy * Lt.Wo + ox;
        const float o = f32(stash[(size_t)(n0 + f) * P.stash + Lt.st_out + q]);
        d = f32(g[(size_t)(n0 + f) * npos + q]) * (1.f - o * o);
        const bf16 h = rn(d);
        uint4 u = {0u, 0u, 0u, 0u};
        uint4* rec = reinterpret_cast<uint4*>(dpre + (size_t)(n0 + f) * P.dstash + Lt.dp_off +
                                              class_major(oy, ox, Lt.Wo, hw) * Lt.dps);
        u.x = pack2(__halves2bfloat162(h, rn(0.f)));
        rec[0] = u;
        u.x = pack2(__halves2bfloat162(rn(d - f32(h)), rn(0.f)));
        rec[npos * Lt.dps / 8] = u;
      }
      halo[i] = d;
    }
  }
  __syncthreads();  // the mbarriers and the last layer's cotangent are in place

  float acc[kSlots][8];
  for (int i = 0; sl.layer >= 0; ++i) {
    if (tid == 0) {
      const Slice nx = next_slice(P, 1, sl, stop);
      if (nx.layer >= 0) load_slice(nx, packed, WB[(i + 1) & 1], &bar[(i + 1) & 1]);
    }
    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);

    const int l = sl.layer;
    const Layer& L = P.L[l];
    // the layer's numbers in registers for the loops below: tap (ky, kx) of
    // a tk-wide grid takes input position (iy, ix) the cotangent of output
    // position (iy·ts + td + tsg·ky, ix·ts + td + tsg·kx)
    const int dc = L.kind == kDeconv, uf = L.kind == kUnflatten, one = L.one, aglob = L.aglob;
    const int Hi = L.Hi, Wi = L.Wi, Ho = L.Ho, Wo = L.Wo, C16i = L.C16i, C16o = L.C16o;
    const int tk = dc ? 4 : uf ? Wo : L.k, ts = dc ? 2 : uf ? 0 : 1;
    const int td = dc ? -1 : uf ? 0 : L.p, tsg = dc || uf ? 1 : -1;
    const int acc_in = L.acc_in, cpo = C16o / 16, npi = Hi * Wi, dps = L.dps;
    const int lnpi = __ffs(npi) - 1, lwi = __ffs(Wi) - 1;  // maps 1, 4, 8, 16 or 32 wide
    const int istride = 2 * (C16o + 8), ostride = C16i + 8;  // bytes, elements
    const int lo_in = Ho * Wo * istride;  // bytes from a hi term to its lo term
    const int mtg = sl.mtg, m0 = sl.m0, tasks = mtg * (sl.cw / 16);
    const int sp = (sl.s1 - sl.s0) * 16 + 8, s0 = sl.s0, r0 = sl.r0;
    const unsigned in_s = saddr(buf[(l + 1) & 1]), zero_s = saddr(zero), w_s = saddr(WB[i & 1]);
    const int ibsz = P.bbuf[(l + 1) & 1], obsz = P.bbuf[l & 1], Wh = Wo + 2;
    bf16* ob = buf[l & 1];

    // k-steps [ka, kb) of task (m-tile, n-pair) into a[8]: the output
    // cotangents' hi and lo terms each tap reads, times the transposed
    // weights, the lo products in sums of their own.
    auto run = [&](int task, int ka, int kb, float* a8) {
      if (ka >= kb) return;
      const int mt = m0 + task % mtg, np = task / mtg;
      const unsigned bb0 = w_s + 2 * ((np * 16 + (lane & 7) + (lane >> 4) * 8) * sp +
                                      ((lane >> 3) & 1) * 8 - s0 * 16);
      float l8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (one) {
        // A[m][t] = the cotangent at output (2iy − 1 + ky, 2ix − 1 + kx), t =
        // 4ky + kx: the lane's pairs (kx, kx + 1) from the haloed map.
        unsigned hi[4], lo[4], bfr[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + (lane >> 2) + 8 * h, f = m >> lnpi, r = m & (npi - 1);
          const int iy = r >> lwi, ix = r & (Wi - 1);
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int ky = ((lane & 3) >> 1) + 2 * kh, kx = 2 * (lane & 1);
            const float2 v = f < F ? *reinterpret_cast<const float2*>(
                                         halo + f * P.halo + (2 * iy + ky) * Wh + 2 * ix + kx)
                                   : make_float2(0.f, 0.f);
            split2(v, hi[h + 2 * kh], lo[h + 2 * kh]);
          }
        }
        ldsm4(bfr, bb0 + 32 * ka);
        mma(a8, hi, bfr[0], bfr[1]);
        mma(a8 + 4, hi, bfr[2], bfr[3]);
        mma(l8, lo, bfr[0], bfr[1]);
        mma(l8 + 4, lo, bfr[2], bfr[3]);
      } else if (aglob) {
        // A fragments from the record (L2): the lane's own rows, the words of
        // its two channels (and the 8 after them) at the output each tap reads.
        int fr[2], iyr[2], ixr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + (lane >> 2) + 8 * h, r = m & (npi - 1);
          fr[h] = m >> lnpi;
          iyr[h] = r >> lwi;
          ixr[h] = r & (Wi - 1);
        }
        const bf16* rec0 = dpre + L.dp_off + 2 * (lane & 3);
        const int half = Ho * Wo * dps / 2;  // words from a hi term to its lo term
        int tap = ka / cpo, cs = ka - tap * cpo, ky = tap / tk, kx = tap - ky * tk;
        const unsigned* ar[2];
        auto locate = [&]() {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int oy = iyr[h] * ts + td + tsg * ky, ox = ixr[h] * ts + td + tsg * kx;
            const bool ok = fr[h] < nf && oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
            const int rq = dc ? class_major(oy, ox, Wo, Ho * Wo / 4) : oy * Wo + ox;
            ar[h] = ok ? reinterpret_cast<const unsigned*>(
                             rec0 + (size_t)(n0 + fr[h]) * P.dstash + rq * dps)
                       : nullptr;
          }
        };
        locate();
        unsigned bp = bb0 + 32 * ka;
        for (int st = ka; st < kb; ++st, bp += 32) {
          unsigned hi[4], lo[4], bfr[4];
          const bool up = cs * 16 + 8 < dps;  // channels 8-15 of the k-step recorded
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned* q = ar[h] + 8 * cs;
            const bool ok = ar[h] != nullptr;
            hi[h] = ok ? __ldcg(q) : 0u;
            hi[h + 2] = ok && up ? __ldcg(q + 4) : 0u;
            lo[h] = ok ? __ldcg(q + half) : 0u;
            lo[h + 2] = ok && up ? __ldcg(q + half + 4) : 0u;
          }
          ldsm4(bfr, bp);
          mma(a8, hi, bfr[0], bfr[1]);
          mma(a8 + 4, hi, bfr[2], bfr[3]);
          mma(l8, lo, bfr[0], bfr[1]);
          mma(l8 + 4, lo, bfr[2], bfr[3]);
          if (++cs == cpo) {
            cs = 0;
            if (++kx == tk) {
              kx = 0;
              ++ky;
            }
            locate();
          }
        }
      } else {
        // the lane's ldmatrix row: frame and input position
        const int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, f = m >> lnpi;
        const int r = m & (npi - 1), iy = r >> lwi, ix = r & (Wi - 1);
        const unsigned abase = in_s + (f < F ? f : 0) * ibsz * 2 + 16 * (lane >> 4);
        int tap = ka / cpo, cs = ka - tap * cpo, ky = tap / tk, kx = tap - ky * tk;
        unsigned ah = zero_s, al = zero_s, astep = 0;
        auto locate = [&]() {
          const int oy = iy * ts + td + tsg * ky, ox = ix * ts + td + tsg * kx;
          const bool ok = f < F && oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
          ah = ok ? abase + (oy * Wo + ox) * istride : zero_s;
          al = ok ? ah + lo_in : zero_s;
          astep = ok ? 32 : 0;
        };
        locate();
        unsigned bp = bb0 + 32 * ka;
        for (int st = ka; st < kb; ++st, bp += 32) {
          unsigned hi[4], lo[4], bfr[4];
          ldsm4(hi, ah + cs * astep);
          ldsm4(lo, al + cs * astep);
          ldsm4(bfr, bp);
          mma(a8, hi, bfr[0], bfr[1]);
          mma(a8 + 4, hi, bfr[2], bfr[3]);
          mma(l8, lo, bfr[0], bfr[1]);
          mma(l8 + 4, lo, bfr[2], bfr[3]);
          if (++cs == cpo) {
            cs = 0;
            if (++kx == tk) {
              kx = 0;
              ++ky;
            }
            locate();
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) a8[e] += l8[e];
    };
    // The epilogue of task (m-tile, n-pair): below layer 0, the features'
    // cotangent; else the input's cotangent (plus the residual skip's), times
    // the ELU derivative of the layer below from its recorded output, split
    // hi/lo into the map and the record (a transposed conv's class-major),
    // and kept in f32 where it is a residual block's output. Loads go before
    // stores.
    auto emit = [&](int task, const float* a8) {
      const int mt = m0 + task % mtg, np = task / mtg;
      const Layer& B = P.L[l > 0 ? l - 1 : 0];
      const int b_out = B.st_out, b_dp = B.dp_off, b_dps = B.dps, b_npos = B.Ho * B.Wo;
      const bool keep_f32 = l > 0 && B.residual, b_dc = B.kind == kDeconv, keep_map = !B.aglob;
      int fr[2], ip[2];
      float2 y[2][2], sk[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + (lane >> 2) + h * 8;
        fr[h] = m >> lnpi;
        ip[h] = m & (npi - 1);
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
        const int rpos = b_dc ? class_major(ipos >> lwi, ipos & (Wi - 1), Wi, b_npos / 4) : ipos;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = r0 + np * 16 + j * 8 + 2 * (lane & 3);
          float v0 = a8[4 * j + 2 * h] + sk[h][j].x, v1 = a8[4 * j + 2 * h + 1] + sk[h][j].y;
          if (l == 0) {
            if (f < nf) {
              bf16* d = dx + (size_t)(n0 + f) * P.Fin;
              if (ci < P.Fin) d[ci] = rn(v0);
              if (ci + 1 < P.Fin) d[ci + 1] = rn(v1);
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
          if (f < nf && ci < b_dps) {
            unsigned* rec = reinterpret_cast<unsigned*>(
                dpre + (size_t)(n0 + f) * P.dstash + b_dp + rpos * b_dps + ci);
            rec[0] = hi;
            rec[b_npos * b_dps / 2] = lo;
          }
        }
      }
    };

    schedule(sl, tasks, acc, red, run, emit);
    __syncthreads();  // the layer's input cotangent is in place; slice i's buffer is free
    sl = next_slice(P, 1, sl, stop);
  }
}

// The weight-gradient pass: block (chunk, tile), the tiles in reverse order
// (the transposed convs' longest first). A tile is one GEMM of a
// layer (a transposed conv's output-parity class, or its bias), m-tiles
// [ma, mb) of (tap, input channel) rows (a conv's bias m-tile, and a
// transposed conv's bias tile, have A = ones) × n-tiles [na, nb) of the
// record's columns; the chunk's recorded inputs (channels [w0, w0 + win))
// and split cotangents (the GEMM's K positions, the tile's columns) are
// staged by cp.async fs frames at a time into two buffers. K runs over
// (frame, position): a conv's output positions, a transposed conv class's
// positions (ry, rx), which read input (ry + py − a, rx + px − b) at tap
// (a, b); the unflatten's frames alone. A warp owns 3 m-tiles × 4 n-tiles;
// with fewer such warp tiles than warps, S warps a tile split each stage's
// k-steps and their sums are added in order.
__global__ void __launch_bounds__(kThreads, 2)
decoder_bf16_tc_dw_kernel(const __grid_constant__ Plan Pp, const bf16* __restrict__ stash,
                          const bf16* __restrict__ dpre, float* __restrict__ partial, int N,
                          int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Plan sP;
  const Plan& P = shared_plan(Pp, sP);
  bf16* zero = reinterpret_cast<bf16*>(smem);
  bf16* stage0 = reinterpret_cast<bf16*>(smem + 32);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // The last tiles (the transposed convs', whose K a frame is longest) first.
  const int tile = (int)(gridDim.y - 1 - blockIdx.y), chunk_i = blockIdx.x;
  int l = 0;
  while (l + 1 < P.n && P.L[l + 1].tile0 <= tile) ++l;
  const Layer& L = P.L[l];
  const bool dc = L.kind == kDeconv, uf = L.kind == kUnflatten;
  int b = tile - L.tile0, cls = 0;
  int ct = L.ct, nct = L.nct, fs = L.fs, apf = L.apf, dpf = L.dpf;
  bool rows = true;  // (tap, channel) rows; false: a transposed conv's bias alone
  if (dc) {
    cls = b / (L.nrt * L.nct);
    if (cls < kClasses) {
      b -= cls * L.nrt * L.nct;
    } else {
      b -= kClasses * L.nrt * L.nct;
      rows = false;
      ct = L.bct;
      nct = L.bnct;
      fs = L.bfs;
      dpf = L.bdpf;
      apf = 0;
    }
  }
  const int py = cls >> 1, px = cls & 1;
  const int rti = rows ? b / nct : 0, cti = rows ? b - rti * nct : b;
  const int cps = L.C16i / 16, taps = dc ? 4 : L.k * L.k, bias = dc ? 0 : 1;
  const int mtw = rows ? taps * cps + bias : 1;
  int ma, mb, w0 = 0, win = L.C16i;
  if (!rows) {
    ma = 0;
    mb = 1;
    win = 0;
  } else if (L.pertap) {
    const int tpt = (cps + L.rt - 1) / L.rt;
    if (bias && rti == L.nrt - 1) {
      ma = mtw - 1;
      mb = mtw;
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
    mb = min(mtw, ma + L.rt);
  }
  // K: kpos positions a staged unit from position koff of the record, whose
  // positions are kcols columns wide; the positions a grid gw wide. A unit
  // is a frame, or for a transposed conv's bias a quarter of one (upf a
  // frame).
  const int npos = L.Ho * L.Wo, kpos = uf ? 1 : dc ? L.Hi * L.Wi : npos, upf = rows ? 1 : 4;
  const int koff = dc && rows ? cls * L.Hi * L.Wi : 0, kcols = uf ? npos * L.dps : L.dps;
  const int gw = dc || uf ? L.Wi : L.Wo, hsz = npos * L.dps;  // the record's half
  const int astr = L.pertap ? L.rt * 16 + 8 : L.C16i + 8;  // a staged position's stride
  const int na = cti * ct, nb = min(kcols / 8, na + ct), nstr = ct * 8 + 8;
  const int wtm = (mb - ma + 2) / 3, npairs = (nb - na + 1) / 2, wtn = (npairs + 1) / 2;
  const int WT = wtm * wtn, S = max(1, kWarps / WT);
  const int wt = warp % WT, split = warp / WT, wm = wt % wtm, wn = wt / wtm;
  const bool active = split < S;
  // Positions a frame of the input map, of K, of the K grid's width, and
  // units a frame, as powers of 2.
  int lga = 0, lg = 0, lgw = 0, lgu = upf == 4 ? 2 : 0;
  while ((1 << lga) < L.Hi * L.Wi) ++lga;
  while ((1 << lg) < kpos) ++lg;
  while ((1 << lgw) < gw) ++lgw;

  const int per = apf + 2 * dpf;
  const int cbeg = chunk_i * chunk, clen = min(N, cbeg + chunk) - cbeg;
  const int units = clen * upf, stages = (units + fs - 1) / fs;
  if (tid < 16) zero[tid] = rn(0.f);

  // The staging's 16-byte copies, fixed for the block: a thread copies unit
  // k of the rows (unit-frame, position) r0, r0 + rstep, ..., of the input
  // map (a) and of the cotangent's two halves (d); threads past rstep · u
  // copy nothing. No division in the loops: every count is a power of 2.
  const int au = max(1, win / 8), ak = tid % au, ar0 = tid / au, arstep = kThreads / au;
  const int du = nb - na, dk = tid % du, dr0 = tid / du, drstep = kThreads / du;
  auto load = [&](int st) {
    const int u0 = st * fs, fsz = min(fs, units - u0);
    bf16* A = stage0 + (st & 1) * fs * per;
    bf16* Dh = A + fs * apf;
    if (rows && win > 0 && ar0 < arstep) {
      for (int r = ar0; r < fsz << lga; r += arstep) {
        const int f = r >> lga, pos = r & ((1 << lga) - 1), n = cbeg + ((u0 + f) >> lgu);
        fconv::cp_async16(
            reinterpret_cast<float*>(A + f * apf + pos * astr + 8 * ak),
            reinterpret_cast<const float*>(stash + (size_t)n * P.stash + L.st_in +
                                           pos * L.C16i + w0 + 8 * ak));
      }
    }
    if (dr0 < drstep) {
      for (int r = dr0; r < fsz << lg; r += drstep) {
        const int f = r >> lg, pos = r & (kpos - 1), u = u0 + f, n = cbeg + (u >> lgu);
        const bf16* d = dpre + (size_t)n * P.dstash + L.dp_off +
                        (size_t)(koff + (u & (upf - 1)) * kpos + pos) * kcols + 8 * (na + dk);
        bf16* o = Dh + f * dpf + pos * nstr + 8 * dk;
        fconv::cp_async16(reinterpret_cast<float*>(o), reinterpret_cast<const float*>(d));
        fconv::cp_async16(reinterpret_cast<float*>(o + fs * dpf),
                          reinterpret_cast<const float*>(d + hsz));
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
  const int Hi = L.Hi, Wi = L.Wi, ntw = min(4, nb - na - 4 * wn);  // the warp's n-tiles
  const int mch = (lane >> 3) & 1;  // the A matrix's m-chunk this lane addresses
  int mdy[3], mdx[3], mcb[3], mkind[3];  // kind: 0 none, 1 weight rows, 2 ones
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m = ma + 3 * wm + i;
    mkind[i] = m >= mb ? 0 : !rows || (bias && m == mtw - 1) ? 2 : 1;
    mdy[i] = mdx[i] = mcb[i] = 0;
    if (mkind[i] != 1) continue;
    const int tap = m / cps;
    if (dc) {
      mdy[i] = py - (tap >> 1);
      mdx[i] = px - (tap & 1);
    } else {
      const int ky = tap / L.k;
      mdy[i] = ky - L.p;
      mdx[i] = tap - ky * L.k - L.p;
    }
    mcb[i] = 2 * ((m - tap * cps) * 16 + 8 * mch - w0);
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
    const unsigned Dh_s = A_s + 2 * fs * apf, Dl_s = Dh_s + 2 * fs * dpf;
    const int fsz = min(fs, units - st * fs);
    const int ksteps = (fsz * kpos + 15) / 16;
    if (active) {
      const int ka = ksteps * split / S, kb = ksteps * (split + 1) / S;
      for (int ks = ka; ks < kb; ++ks) {
        unsigned bh[2][4], bl[2][4];
        {
          const int kr = ks * 16 + qb * 8 + (lane & 7), f = kr >> lg, pos = kr & (kpos - 1);
          const bool ok = f < fsz;
          const unsigned off = 2 * (f * dpf + pos * nstr + (4 * wn + nsel) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (2 * j >= ntw) continue;
            ldsm4t(bh[j], ok ? Dh_s + off + 32 * j : zero_s);
            ldsm4t(bl[j], ok ? Dl_s + off + 32 * j : zero_s);
          }
        }
        const int kr = ks * 16 + qa * 8 + (lane & 7), f = kr >> lg, pos = kr & (kpos - 1);
        const int oy = pos >> lgw, ox = pos & (gw - 1);
        const bool fok = f < fsz;
        const unsigned Af = A_s + 2 * f * apf;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (mkind[i] == 0) continue;
          unsigned a[4];
          if (mkind[i] == 2) {
            a[0] = a[1] = a[2] = a[3] = one2;
          } else {
            unsigned ap = zero_s;
            const int iy = oy + mdy[i], ix = ox + mdx[i];
            if (fok && iy >= 0 && iy < Hi && ix >= 0 && ix < Wi) {
              ap = Af + 2 * (iy * Wi + ix) * astr + mcb[i];
            }
            ldsm4t(a, ap);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (2 * j >= ntw) continue;
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              if (2 * j + t >= ntw) continue;
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
  // Gradient elements into partial[chunk], torch layout: the weight, then
  // the bias. A column is an output channel; the unflatten's (position,
  // channel) of its record's row.
  float* out = partial + (size_t)chunk_i * P.grads + L.g_off;
  const int bo = weight_size(L), hw = L.Ho * L.Wo, kk = L.k * L.k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m = ma + 3 * wm + i;
    if (mkind[i] == 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= ntw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (lane >> 2) + 8 * (e >> 1);
        const int n = (na + 4 * wn + j) * 8 + 2 * (lane & 3) + (e & 1);
        const int pos = uf ? n / L.dps : 0, co = uf ? n - pos * L.dps : n;
        if (co >= L.Co) continue;
        if (mkind[i] == 2) {
          if (row == 0) out[bo + (uf ? co * hw + pos : co)] = acc[i][j][e];
          continue;
        }
        const int tap = m / cps, ci = (m - tap * cps) * 16 + row;
        if (ci >= L.Ci) continue;
        size_t idx;
        if (dc) {
          const int ky = 1 - py + 2 * (tap >> 1), kx = 1 - px + 2 * (tap & 1);
          idx = ((size_t)ci * L.Co + co) * 16 + ky * 4 + kx;
        } else if (uf) {
          idx = ((size_t)co * hw + pos) * L.Ci + ci;
        } else {
          idx = ((size_t)co * L.Ci + ci) * kk + tap;
        }
        out[idx] = acc[i][j][e];
      }
    }
  }
}

// The chunks added in order, each gradient rounded to bf16.
__global__ void decoder_bf16_tc_reduce_kernel(int grads, int chunks,
                                              const float* __restrict__ partial,
                                              bf16* __restrict__ out) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < grads; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * grads + e];
    out[e] = rn(s);
  }
}

}  // namespace
}  // namespace fdbf

extern "C" {

// Launch on `stream` the backward of fused_decoder_bf16_forward under the
// bf16 cotangent g [N, 32, 32, 1]: dfeats (bf16 [N, F]; skipped when null),
// d_weights (bf16, fused_decoder_bf16_sizes' sizes[2] elements, torch
// layout, tensor after tensor), and the scratch: stash (sizes[0] bf16
// elements a frame), dpre (sizes[1] floats a frame, held as bf16 hi/lo
// terms), partial
// (sizes[3] × sizes[2] floats), packed (sizes[4] bf16 elements). Returns the
// cudaError_t of the launches.
int fused_decoder_bf16_backward(const void* const* weights, int n_weights,
                                const fdbf::bf16* feats, const fdbf::bf16* g,
                                fdbf::bf16* dfeats, fdbf::bf16* d_weights, fdbf::bf16* stash,
                                float* dpre, float* partial, fdbf::bf16* packed,
                                fdbf::DecDims d, void* stream) {
  fdbf::Plan P;
  if (!fdbf::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fdbf::bf16* rec = reinterpret_cast<fdbf::bf16*>(dpre);
  cudaError_t err = fdbf::launch_forward(fdbf::weight_ptrs(weights, n_weights), P, feats, packed,
                                         nullptr, stash, d.N, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fdbf::decoder_bf16_tc_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bsmem);
  if (err != cudaSuccess) return (int)err;
  fdbf::decoder_bf16_tc_dx_kernel<<<(d.N + P.F - 1) / P.F, fdbf::kThreads, P.bsmem, s>>>(
      P, packed, stash, g, rec, dfeats, d.N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (d.N + d.chunk - 1) / d.chunk;
  err = cudaFuncSetAttribute(fdbf::decoder_bf16_tc_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.wsmem);
  if (err != cudaSuccess) return (int)err;
  fdbf::decoder_bf16_tc_dw_kernel<<<dim3(chunks, P.dw_tiles), fdbf::kThreads, P.wsmem, s>>>(
      P, stash, rec, partial, d.N, d.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fdbf::decoder_bf16_tc_reduce_kernel<<<(P.grads + fdbf::kThreads - 1) / fdbf::kThreads,
                                        fdbf::kThreads, 0, s>>>(P.grads, chunks, partial,
                                                                d_weights);
  return (int)cudaGetLastError();
}

}  // extern "C"
