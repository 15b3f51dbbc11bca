// Mamba2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/ssd_scan.py : ssd_scan (the Pallas TPU kernel
// _kernel). Same function, per (batch, head), from a zero state:
//
//   S_t = exp(a_t) S_{t-1} + dt_t x_t B_t^T           S in R^{hd x ds}
//   y_t = S_t C_t
//
// returning y (in x's dtype) and the final f32 state; D x stays outside,
// as in both JAX versions.
//
// Form. The sequence is cut into chunks of kQ = 64 tokens, with cum the
// chunk's inclusive cumulative log decay:
//   intra  y_i += sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter  y_i += exp(cum_i) S_prev C_i
//   state  S    = exp(cum_last) S_prev + sum_j dt_j exp(cum_last - cum_j) x_j B_j^T
// The intra exponent is formed only for j <= i, where it is <= 0 (above
// the diagonal it would be > 1, and masking an inf afterwards gives NaN).
// Any S is taken: rows past S in the last chunk are zero-filled with
// a = dt = 0, so they add nothing and leave cum_last unchanged. The chunk
// length does not change the result. B and C are one [S, ds] row per batch
// row, shared by all heads: the wrapper passes them with a head stride of
// 0, so they are never materialised per head.
//
// What bounds it on the H100: at the serving path's prefill (B = 1, H =
// 112, S <= 128, hd = ds = 64) a call reads x (bf16), dt, a (f32), B and C
// and writes y and a 16 KB state per head: about 5 MB, ~1.5 us at 3.35
// TB/s; its FLOPs are tens of MFLOP. So bytes bound it on paper; a call
// this small is bound by the latency of its chain of chunks, each a few
// dependent products.
//
// Design. The chunk's scores do not depend on x's channel, so each head's
// hd channels are split into slices of P (16, 32 or 64) and every CTA
// owns one (batch, head, slice): its columns of y and its rows of the
// state, recomputing the chunk's [Q, Q] scores itself (one small product;
// a second launch would cost more). The wrapper's shape-only plan
// (kernels/ssd_scan.py: ssd_plan) picks P: at zamba2's 112 heads, two
// slices of 32 give 224 CTAs on 132 SMs. Sums run in a fixed order, so
// calls are bit-equal.
//
// * tensor cores (bf16): a CTA of 8 warps walks the chunks, copied by
//   cp.async into a two-stage ring (the next chunk loads while this one
//   computes; rows past S and channels past hd / ds are zero-filled, and
//   ds is padded to 64 inside the CTA). Row warp w (0-3) owns the chunk's
//   rows 16w..16w+15 and runs on mma.sync m16n8k16 (bf16 in, f32 out):
//   G = C B^T for the key tiles at or left of its diagonal, the scores
//   G exp(cum_i - cum_j) dt_j in f32 registers, then y = exp(cum_i)
//   (C S_prev^T) + scores x, the row scale applied after the product so C
//   stays exact. Meanwhile warp 4 takes the cumsum as a warp scan, and the
//   four state warps (4-7) hold the state [P, ds] in f32 registers and
//   take S = exp(cum_last) S + x^T (w o B), w_j = dt_j exp(cum_last -
//   cum_j), with w o B built once a chunk in shared memory. With one warp
//   a scheduler the first design (one 4-warp CTA doing both in turn) was
//   bound by the latency of its dependent steps.
//   Rounding points. C, B and x enter the products exactly (bf16 data).
//   The scores and the bf16 copy of S_prev that feeds the inter term are
//   rounded to bf16 once: they reach only y, whose tolerance is bf16's.
//   The state's operand w o B is formed in f32 and split into a bf16
//   hi/lo pair (two products, about 2^-17 relative): rounded once, its
//   2^-9 per term summed into the f32 state breaks the state's 1e-3
//   tolerance (tests/test_torch_scan_plan.py emulates both). The state
//   itself stays f32 across chunks.
// * scalar f32 FMAs (f32: TF32 would break the f32 tolerances): one CTA
//   of 256 threads per (batch, head, slice), the tiles, scores and state
//   in shared memory, every product and sum in f32.
#include "common.cuh"
#include "mma.cuh"

using namespace rt;

// Timing variants for tools/scan_probe.py: each set bit of SCAN_SKIP leaves
// one step of the tensor-core kernel out (its result is then wrong); the
// build leaves it 0.
#ifndef SCAN_SKIP
#define SCAN_SKIP 0
#endif

namespace {

constexpr int kQ = 64;           // tokens per chunk
constexpr int kMaxHD = 64;
constexpr int kMaxDS = 64;

struct SsdStrides {
  long long xb, xh, xs;          // x  [B, H, S, hd]
  long long db, dh, ds;          // dt [B, H, S]
  long long ab, ah, as;          // a  [B, H, S]
  long long bb, bh, bs;          // Bm [B, H, S, ds]
  long long cb, ch, cs;          // Cm [B, H, S, ds]
  long long yb, yh, ys;          // y  [B, H, S, hd]
};

// The chunk's decays, by one warp: cum (inclusive cumsum of a, as a warp
// scan, two tokens a lane), dec = exp(cum) and w = dt exp(cum_last - cum).
__device__ __forceinline__ void chunk_decays(const float* a, const float* dt,
                                             float* cum, float* dec,
                                             float* w, int lane) {
  float x0 = a[lane], x1 = a[lane + 32];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t0 = __shfl_up_sync(0xffffffffu, x0, o);
    const float t1 = __shfl_up_sync(0xffffffffu, x1, o);
    if (lane >= o) {
      x0 += t0;
      x1 += t1;
    }
  }
  x1 += __shfl_sync(0xffffffffu, x0, 31);
  const float last = __shfl_sync(0xffffffffu, x1, 31);
  cum[lane] = x0;
  cum[lane + 32] = x1;
  dec[lane] = expf(x0);
  dec[lane + 32] = expf(x1);
  w[lane] = dt[lane] * expf(last - x0);
  w[lane + 32] = dt[lane + 32] * expf(last - x1);
}

// ---------------------------------------------------------- scalar route
constexpr int kThreads = 256;

size_t scalar_smem_bytes(int P, int ds) {
  const size_t PX = P + 1, PB = ds + 1;
  return sizeof(float) * (kQ * PX + 2 * kQ * PB + (size_t)kQ * (kQ + 1) +
                          (size_t)P * PB + 5 * kQ);
}

__global__ void __launch_bounds__(kThreads)
    ssd_scalar(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ sf, SsdStrides st, int H, int S, int hd,
               int ds, int P, int nslice) {
  extern __shared__ float smem[];
  const int PX = P + 1, PB = ds + 1;
  float* xs = smem;                  // [kQ][PX]  the slice's channels
  float* bsm = xs + kQ * PX;         // [kQ][PB]
  float* csm = bsm + kQ * PB;        // [kQ][PB]
  float* sc = csm + kQ * PB;         // [kQ][kQ + 1]  scores
  float* sts = sc + kQ * (kQ + 1);   // [P][PB]       state rows S[p][s]
  float* araw = sts + P * PB;        // [kQ]
  float* dts = araw + kQ;            // [kQ]
  float* cum = dts + kQ;             // [kQ]
  float* dec = cum + kQ;             // [kQ]  exp(cum)
  float* w = dec + kQ;               // [kQ]  dt_j exp(cum_last - cum_j)

  const int bh = blockIdx.x / nslice, p0 = (blockIdx.x % nslice) * P;
  const int b = bh / H, h = bh % H;
  const int np = min(P, hd - p0);    // channels of this slice
  const int tid = threadIdx.x;
  const float* xb = x + b * st.xb + h * st.xh + p0;
  const float* db = dt + b * st.db + h * st.dh;
  const float* ab = a + b * st.ab + h * st.ah;
  const float* bb = Bm + b * st.bb + h * st.bh;
  const float* cb = Cm + b * st.cb + h * st.ch;
  float* yb = y + b * st.yb + h * st.yh + p0;

  for (int i = tid; i < P * PB; i += kThreads) sts[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    // 1. the chunk's tiles, zero-filled (a = dt = 0) past S
    for (int i = tid; i < kQ * np; i += kThreads) {
      const int q = i / np, p = i % np;
      xs[q * PX + p] = q < nq ? xb[(long long)(c0 + q) * st.xs + p] : 0.f;
    }
    for (int i = tid; i < kQ * ds; i += kThreads) {
      const int q = i / ds, s = i % ds;
      float bv = 0.f, cv = 0.f;
      if (q < nq) {
        bv = bb[(long long)(c0 + q) * st.bs + s];
        cv = cb[(long long)(c0 + q) * st.cs + s];
      }
      bsm[q * PB + s] = bv;
      csm[q * PB + s] = cv;
    }
    for (int q = tid; q < kQ; q += kThreads) {
      dts[q] = q < nq ? db[(long long)(c0 + q) * st.ds] : 0.f;
      araw[q] = q < nq ? ab[(long long)(c0 + q) * st.as] : 0.f;
    }
    __syncthreads();
    // 2. the chunk's decays
    if (tid < 32) chunk_decays(araw, dts, cum, dec, w, tid);
    __syncthreads();
    // 3. causal score tile
    for (int p = tid; p < kQ * kQ; p += kThreads) {
      const int i = p / kQ, j = p % kQ;
      float v = 0.f;
      if (j <= i) {
        const float* ci = csm + i * PB;
        const float* bj = bsm + j * PB;
        float dot = 0.f;
        for (int s = 0; s < ds; ++s) dot += ci[s] * bj[s];
        v = dot * expf(cum[i] - cum[j]) * dts[j];
      }
      sc[i * (kQ + 1) + j] = v;
    }
    __syncthreads();
    // 4. outputs of the chunk's rows, the slice's channels
    for (int o = tid; o < nq * np; o += kThreads) {
      const int i = o / np, p = o % np;
      const float* si = sc + i * (kQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += si[j] * xs[j * PX + p];
      const float* ci = csm + i * PB;
      const float* sp = sts + p * PB;
      float inter = 0.f;
      for (int s = 0; s < ds; ++s) inter += ci[s] * sp[s];
      yb[(long long)(c0 + i) * st.ys + p] = acc + dec[i] * inter;
    }
    __syncthreads();
    // 5. carry the slice's state rows to the end of the chunk
    const float dl = dec[kQ - 1];
    for (int o = tid; o < np * ds; o += kThreads) {
      const int p = o / ds, s = o % ds;
      float v = sts[p * PB + s] * dl;
      for (int j = 0; j < nq; ++j) v += w[j] * xs[j * PX + p] * bsm[j * PB + s];
      sts[p * PB + s] = v;
    }
    __syncthreads();
  }
  float* sfb = sf + ((long long)bh * hd + p0) * ds;
  for (int o = tid; o < np * ds; o += kThreads)
    sfb[o] = sts[(o / ds) * PB + o % ds];
}

// ---------------------------------------------------- tensor-core route
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 8;       // 4 row warps, then 4 state warps
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kDSP = 64;          // ds padded inside the CTA
constexpr int kLDB = kDSP + 8;    // padded bf16 row of B, C, w o B, state

template <int P> struct SsdTc {
  static constexpr int LDX = P + 8;              // padded bf16 row of x
  static constexpr int MT = P / 16;              // state row tiles
  static constexpr int NPW = (kDSP / 8) * MT / 4;  // n-tiles a state warp
};

template <int P>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (2 * kQ * SsdTc<P>::LDX + 6 * kQ * kLDB +
                         P * kLDB) +
         sizeof(float) * 7 * kQ;
}

__device__ __forceinline__ void bar_state_warps() {
  asm volatile("bar.sync 1, 128;\n" ::);
}

// Fragment layouts: mma.cuh. A row-major from [m][k] rows and B from [n][k]
// rows take ldmatrix; A from [k][m] rows and B from [k][n] rows take
// ldmatrix.trans.
// Two CTAs an SM up to slices of 32 (registers held to 128 a thread), so
// zamba2's 224 CTAs run in one wave; slices of 64 would spill there.
template <int P>
__global__ void __launch_bounds__(kTcThreads, P <= 32 ? 2 : 1)
    ssd_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const bf16* __restrict__ Bm,
           const bf16* __restrict__ Cm, bf16* __restrict__ y,
           float* __restrict__ sf, SsdStrides st, int H, int S, int hd,
           int ds, int nslice, int vec) {
  using Cfg = SsdTc<P>;
  constexpr int LDX = Cfg::LDX, NPW = Cfg::NPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);  // [2][kQ][LDX]
  bf16* sb = sx + 2 * kQ * LDX;                  // [2][kQ][kLDB]
  bf16* sc = sb + 2 * kQ * kLDB;                 // [2][kQ][kLDB]
  bf16* swh = sc + 2 * kQ * kLDB;                // [kQ][kLDB] w o B, hi
  bf16* swl = swh + kQ * kLDB;                   // [kQ][kLDB] w o B, lo
  bf16* sS = swl + kQ * kLDB;                    // [P][kLDB] state, bf16
  float* sdt = reinterpret_cast<float*>(sS + P * kLDB);  // [2][kQ]
  float* sa = sdt + 2 * kQ;                      // [2][kQ]
  float* cum = sa + 2 * kQ;                      // [kQ]
  float* dec = cum + kQ;                         // [kQ] exp(cum)
  float* wj = dec + kQ;                          // [kQ] dt exp(cum_last - cum)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / nslice, p0 = (blockIdx.x % nslice) * P;
  const int b = bh / H, h = bh % H;
  const int np = min(P, hd - p0);                // channels of this slice
  const int nks = (ds + 15) >> 4;                // k-steps over ds with data
  const bf16* xb = x + b * st.xb + h * st.xh + p0;
  const float* db = dt + b * st.db + h * st.dh;
  const float* ab = a + b * st.ab + h * st.ah;
  const bf16* bb = Bm + b * st.bb + h * st.bh;
  const bf16* cb = Cm + b * st.cb + h * st.ch;
  bf16* yb = y + b * st.yb + h * st.yh + p0;
  const bf16 zero = __float2bfloat16(0.f);

  auto load = [&](int c0, int stg) {
    bf16* dx = sx + stg * kQ * LDX;
    bf16* dB = sb + stg * kQ * kLDB;
    bf16* dC = sc + stg * kQ * kLDB;
    if (vec) {
      for (int i = tid; i < kQ * (P / 8); i += kTcThreads) {
        const int q = i / (P / 8), c = i % (P / 8);
        const bool ok = c0 + q < S && 8 * c < np;
        cp_async16(dx + q * LDX + 8 * c,
                   ok ? xb + (long long)(c0 + q) * st.xs + 8 * c : xb, ok);
      }
      for (int i = tid; i < kQ * (kDSP / 8); i += kTcThreads) {
        const int q = i / (kDSP / 8), c = i % (kDSP / 8);
        const bool ok = c0 + q < S && 8 * c < ds;
        cp_async16(dB + q * kLDB + 8 * c,
                   ok ? bb + (long long)(c0 + q) * st.bs + 8 * c : bb, ok);
        cp_async16(dC + q * kLDB + 8 * c,
                   ok ? cb + (long long)(c0 + q) * st.cs + 8 * c : cb, ok);
      }
    } else {   // rows off the 16-byte grid: element copies
      for (int i = tid; i < kQ * P; i += kTcThreads) {
        const int q = i / P, p = i % P;
        dx[q * LDX + p] = c0 + q < S && p < np
                              ? xb[(long long)(c0 + q) * st.xs + p] : zero;
      }
      for (int i = tid; i < kQ * kDSP; i += kTcThreads) {
        const int q = i / kDSP, s = i % kDSP;
        const bool ok = c0 + q < S && s < ds;
        dB[q * kLDB + s] = ok ? bb[(long long)(c0 + q) * st.bs + s] : zero;
        dC[q * kLDB + s] = ok ? cb[(long long)(c0 + q) * st.cs + s] : zero;
      }
    }
    for (int q = tid; q < kQ; q += kTcThreads) {
      const bool ok = c0 + q < S;
      cp_async4(sdt + stg * kQ + q, ok ? db + (long long)(c0 + q) * st.ds : db,
                ok);
      cp_async4(sa + stg * kQ + q, ok ? ab + (long long)(c0 + q) * st.as : ab,
                ok);
    }
  };

  const int g = lane >> 2, cq = 2 * (lane & 3);
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_col = (lane >> 4) << 3;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;
  const bool row_warp = warp < 4;
  const int i0 = 16 * warp;                      // a row warp's chunk rows
  const int ia = i0 + g, ib = ia + 8;
  const int sw = warp - 4;                       // a state warp's tiles
  const int mt = sw % Cfg::MT, n_first = (sw / Cfg::MT) * NPW;

  float sacc[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;

  const int nchunks = (S + kQ - 1) / kQ;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    const int c0 = kc * kQ, stg = kc & 1, nq = min(kQ, S - c0);
    if (kc + 1 < nchunks) load(c0 + kQ, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* X = sx + stg * kQ * LDX;
    const bf16* Bs = sb + stg * kQ * kLDB;
    const bf16* Cs = sc + stg * kQ * kLDB;
    const float* dts = sdt + stg * kQ;

    // row warps: G = C B^T, their rows against the key tiles up to their
    // diagonal; warp 4: the chunk's decays
    const bool live = row_warp && i0 < nq;
    unsigned cf[4][4];
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      cf[ks][0] = cf[ks][1] = cf[ks][2] = cf[ks][3] = 0u;
      if (live && ks < nks)
        ldmatrix_x4(cf[ks], Cs + (i0 + a_row) * kLDB + 16 * ks + a_col);
    }
    if (live && !(SCAN_SKIP & 32)) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp > warp) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
          unsigned bfr[4];
          ldmatrix_x4(bfr, Bs + (16 * jp + b_row) * kLDB + 16 * ks + b_col);
          mma_bf16(s[2 * jp], cf[ks], bfr[0], bfr[1]);
          mma_bf16(s[2 * jp + 1], cf[ks], bfr[2], bfr[3]);
        }
      }
    } else if (warp == 4) {
      chunk_decays(sa + stg * kQ, dts, cum, dec, wj, lane);
    }
    __syncthreads();   // cum, dec, wj

    if (live && !(SCAN_SKIP & 8)) {
      // scores G exp(cum_i - cum_j) dt_j on j <= i, in f32 registers
      const float cua = cum[ia], cub = cum[ib];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= 2 * (warp + 1)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, j = 8 * n + cq + (e & 1);
          const float ci = e < 2 ? cua : cub;
          s[n][e] = j <= i ? s[n][e] * __expf(ci - cum[j]) * dts[j] : 0.f;
        }
      }
      // y: exp(cum_i) (C S_prev^T), then + scores x
      float acc[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      if (c0 > 0) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
#pragma unroll
          for (int dp = 0; dp < P / 16; ++dp) {
            unsigned bfr[4];
            ldmatrix_x4(bfr, sS + (16 * dp + b_row) * kLDB + 16 * ks + b_col);
            mma_bf16(acc[2 * dp], cf[ks], bfr[0], bfr[1]);
            mma_bf16(acc[2 * dp + 1], cf[ks], bfr[2], bfr[3]);
          }
        }
        const float da = dec[ia], dbb = dec[ib];
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          acc[n][0] *= da;
          acc[n][1] *= da;
          acc[n][2] *= dbb;
          acc[n][3] *= dbb;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) continue;
        const unsigned af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          unsigned bfr[4];
          ldmatrix_x4_trans(bfr, X + (16 * kk + a_row) * LDX + 16 * dp + a_col);
          mma_bf16(acc[2 * dp], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], af, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const int p = 8 * n + cq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? ib : ia;
          if (i >= nq) continue;
          bf16* dst = yb + (long long)(c0 + i) * st.ys + p;
          if (p < np) dst[0] = __float2bfloat16(acc[n][2 * rr]);
          if (p + 1 < np) dst[1] = __float2bfloat16(acc[n][2 * rr + 1]);
        }
      }
    } else if (!row_warp) {
      // state warps: w o B split hi/lo into shared memory, then
      // S = exp(cum_last) S + x^T (w o B)
      for (int u = (SCAN_SKIP & 2) ? kQ * 8 : tid - 128; u < kQ * (kDSP / 8);
           u += 128) {
        const int q = u >> 3, c = 8 * (u & 7);
        if (c >= 16 * nks) continue;
        const float w = wj[q];
        const uint4 b8 = *reinterpret_cast<const uint4*>(Bs + q * kLDB + c);
        const unsigned bw[4] = {b8.x, b8.y, b8.z, b8.w};
        unsigned hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bw[e]));
          const Bf16Pair pr = split_bf16(w * v.x, w * v.y);
          hi[e] = pr.hi;
          lo[e] = pr.lo;
        }
        *reinterpret_cast<uint4*>(swh + q * kLDB + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(swl + q * kLDB + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      bar_state_warps();
      const float dl = dec[kQ - 1];
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        sacc[n][0] *= dl;
        sacc[n][1] *= dl;
        sacc[n][2] *= dl;
        sacc[n][3] *= dl;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= nq || (SCAN_SKIP & 16)) continue;
        unsigned af[4];
        ldmatrix_x4_trans(af, X + (16 * kk + b_row) * LDX + 16 * mt + b_col);
#pragma unroll
        for (int n2 = 0; n2 < NPW / 2; ++n2) {
          const int n0 = 8 * (n_first + 2 * n2);
          if (n0 >= ds) continue;
          unsigned bh[4], bl[4];
          ldmatrix_x4_trans(bh, swh + (16 * kk + a_row) * kLDB + n0 + a_col);
          ldmatrix_x4_trans(bl, swl + (16 * kk + a_row) * kLDB + n0 + a_col);
          mma_bf16(sacc[2 * n2], af, bh[0], bh[1]);
          mma_bf16(sacc[2 * n2], af, bl[0], bl[1]);
          mma_bf16(sacc[2 * n2 + 1], af, bh[2], bh[3]);
          mma_bf16(sacc[2 * n2 + 1], af, bl[2], bl[3]);
        }
      }
    }
    __syncthreads();   // S_prev's copy, w o B and the stage are consumed
    if (!row_warp) {
#pragma unroll
      for (int nn = 0; nn < NPW; ++nn) {
        const int col = 8 * (n_first + nn) + cq, p = 16 * mt + g;
        *reinterpret_cast<unsigned*>(sS + p * kLDB + col) =
            pack_bf16(sacc[nn][0], sacc[nn][1]);
        *reinterpret_cast<unsigned*>(sS + (p + 8) * kLDB + col) =
            pack_bf16(sacc[nn][2], sacc[nn][3]);
      }
    }
  }
  if (row_warp) return;
  float* sfb = sf + ((long long)bh * hd + p0) * ds;
#pragma unroll
  for (int nn = 0; nn < NPW; ++nn) {
    const int col = 8 * (n_first + nn) + cq;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int p = 16 * mt + g + 8 * rr;
      if (p >= np) continue;
      if (col < ds) sfb[p * ds + col] = sacc[nn][2 * rr];
      if (col + 1 < ds) sfb[p * ds + col + 1] = sacc[nn][2 * rr + 1];
    }
  }
}

template <int P>
cudaError_t launch_tc(const void* x, const float* dt, const float* a,
                      const void* Bm, const void* Cm, void* y, float* sf,
                      const SsdStrides& st, int B, int H, int S, int hd,
                      int ds, int vec, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<P>();
  cudaError_t err = set_smem(ssd_tc<P>, smem);
  if (err != cudaSuccess) return err;
  const int nslice = (hd + P - 1) / P;
  ssd_tc<P><<<B * H * nslice, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y), sf, st, H, S, hd,
      ds, nslice, vec);
  return cudaGetLastError();
}

}  // namespace

// strides: 18 element strides in SsdStrides order. dt, a, sf are f32;
// x, Bm, Cm, y are f32 (dtype 0, the scalar route) or bf16 (dtype 1, the
// tensor-core route). sf [B, H, hd, ds] contiguous. slice: x's channels a
// CTA (the plan's; 16, 32 or 64 for bf16, 1..64 for f32). vec (bf16): x,
// Bm, Cm rows start on 16 bytes and hd, ds are multiples of 8, so the
// tiles take 16-byte copies.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* a, const void* Bm, const void* Cm,
                            void* y, void* sf, const long long* strides,
                            int B, int H, int S, int hd, int ds, int slice,
                            int vec, void* stream) {
  if (B < 1 || H < 1 || S < 1 || hd < 1 || hd > kMaxHD || ds < 1 ||
      ds > kMaxDS || slice < 1 || slice > kMaxHD)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  SsdStrides st = {s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                   s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                   s[12], s[13], s[14], s[15], s[16], s[17]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sff = static_cast<float*>(sf);
  if (dtype == kF32) {
    const size_t smem = scalar_smem_bytes(slice, ds);
    cudaError_t err = set_smem(ssd_scalar, smem);
    if (err != cudaSuccess) return err;
    const int nslice = (hd + slice - 1) / slice;
    ssd_scalar<<<B * H * nslice, kThreads, smem, cs>>>(
        static_cast<const float*>(x), dtf, af,
        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
        static_cast<float*>(y), sff, st, H, S, hd, ds, slice, nslice);
    return cudaGetLastError();
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (vec) {
    const void* ptrs[3] = {x, Bm, Cm};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
    const long long rows[9] = {st.xb, st.xh, st.xs, st.bb, st.bh,
                               st.bs, st.cb, st.ch, st.cs};
    for (long long r : rows)
      if (r % 8) return cudaErrorInvalidValue;
    if (hd % 8 || ds % 8) return cudaErrorInvalidValue;
  }
  switch (slice) {
    case 16:
      return launch_tc<16>(x, dtf, af, Bm, Cm, y, sff, st, B, H, S, hd, ds,
                           vec, cs);
    case 32:
      return launch_tc<32>(x, dtf, af, Bm, Cm, y, sff, st, B, H, S, hd, ds,
                           vec, cs);
    case 64:
      return launch_tc<64>(x, dtf, af, Bm, Cm, y, sff, st, B, H, S, hd, ds,
                           vec, cs);
  }
  return cudaErrorInvalidValue;
}
