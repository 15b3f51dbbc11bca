// RWKV6 wkv chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/rwkv6_scan.py : rwkv6_scan (the Pallas TPU
// kernel _kernel). Same function, per (batch, head), from a zero state:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T          S in R^{hd x hd}
//
// returning y (in r's dtype) and the final f32 state.
//
// Form. The sequence is cut into chunks of kQ = 64 tokens. Within a chunk,
// with c the inclusive and e the exclusive cumulative log decay per channel
// (e_i = c_{i-1}, e_0 = 0):
//   intra  y_i += sum_{j<i} (sum_t r_it k_jt exp(e_it - c_jt)) v_j
//   bonus  y_i += (sum_t r_it u_t k_it) v_i
//   inter  y_i += (r_i * exp(e_i)) . S_prev
//   state  S    = diag(exp(c_last)) S_prev + sum_j (k_j * exp(c_last - c_j)) v_j^T
// Every exponent below is a sum of log decays over a run of tokens, so it
// is <= 0 and its exp lies in [0, 1]: the form is exact for any decay (la
// down to -inf underflows to 0 as it should). The TPU kernel factors the
// intra term as exp(cs_i - la_i) * exp(-cs_j), which overflows f32 once a
// chunk's cumulative decay on a channel passes about -88 (the model clips
// w0 + lora at 8, so one token's la reaches -2981); where that form is
// finite the two agree. Any S is taken; rows past S in the last chunk are
// zero-filled with la = 0, so they add nothing and leave c_last unchanged.
// The chunk length does not change the result. The cumsum runs per
// channel in token order, as torch.cumsum does along a middle dimension.
//
// What bounds it on the H100: at the serving path's prefill (B = 1, H =
// 32, S <= 128, hd = 64) a call reads r, k, v (bf16) and la (f32) once and
// writes y and the 16 KB state per head: about 3 MB, under a microsecond
// at 3.35 TB/s; its FLOPs are tens of MFLOP. So bytes bound it on paper;
// a call this small is bound by the latency of its chain of chunks and by
// the exps of the intra term's pairs.
//
// Design. The intra scores do not depend on v's channel, so each head's
// hd value channels are split into slices of P (16, 32 or 64) and every
// CTA owns one (batch, head, slice): its columns of y and of the state,
// recomputing the chunk's [Q, Q] scores itself. The wrapper's shape-only
// plan (kernels/rwkv6_scan.py: rwkv6_plan) picks P: at rwkv6's 32 heads,
// four slices of 16 give 128 CTAs on 132 SMs. Sums run in a fixed order,
// so calls are bit-equal.
//
// * tensor cores (bf16): a CTA of 8 warps walks the chunks, copied by
//   cp.async into a two-stage ring (rows past S and channels past hd
//   zero-filled, hd padded to 64 inside the CTA). Row warp w (0-3) owns
//   the chunk's rows 16w..16w+15 (sub-block I = w) and builds their
//   scores in f32 registers from three parts, all exact for any decay:
//   - key sub-blocks J < I on mma.sync m16n8k16: with b the last row of
//     J, exp(e_i - c_j) = exp(e_i - c_b) * exp(c_b - c_j), and both
//     factors are <= 1 for every i in I and j in J, so the pair is one
//     product of r o exp(e - c_b) against k o exp(c_b - c);
//   - with the plan's diag = 8, the same factoring inside the diagonal
//     sub-block, at b = 16I + 7: its rows 8..15 against its keys 0..7;
//   - the diagonal blocks of diag rows left (two of 8, or one of 16) keep
//     a per-pair exp (56 or 120 dots of hd terms a row block), and the u
//     bonus on j = i.
//   A factor that underflows to 0 stands for a true product smaller
//   still; nothing overflows. Then y = (r o exp(e)) S_prev + scores v.
//   Meanwhile the four state warps (4-7) hold the state [hd, P] in f32
//   registers (warp 4 + w its rows 16w..16w+15) and take
//   S = diag(exp(c_last)) S + (k o exp(c_last - c))^T v. Every operand
//   that carries a decay, and every per-pair dot, is built first by all
//   256 threads into shared memory (8 channels a step), so the warps'
//   products only load and multiply: with the exps spread over four warps
//   by rows, the first design waited on its last row warp, one warp a
//   scheduler.
//   Rounding points. r, k and v enter the products exactly (bf16 data).
//   The factored operands of the scores, the scores, r o exp(e) and the
//   bf16 copy of S_prev that feeds the inter term are rounded to bf16
//   once: they reach only y, whose tolerance is bf16's. The state's
//   operand k o exp(c_last - c) is formed in f32 and split into a bf16
//   hi/lo pair (two products, about 2^-17 relative): rounded once, its
//   2^-9 per term summed into the f32 state breaks the state's 1e-3
//   tolerance (tests/test_torch_scan_plan.py emulates both). The state
//   itself stays f32 across chunks.
// * scalar f32 FMAs (f32: TF32 would break the f32 tolerances): one CTA
//   of 256 threads per (batch, head, slice), tiles, scores and state in
//   shared memory, the exponent formed per (i, j, t).
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

struct RwkvStrides {
  long long rb, rh, rs;          // r  [B, H, S, hd]
  long long kb, kh, ks;          // k  [B, H, S, hd]
  long long vb, vh, vs;          // v  [B, H, S, hd]
  long long lb, lh, ls;          // la [B, H, S, hd]
  long long ub, uh;              // u  [B, H, hd]
  long long yb, yh, ys;          // y  [B, H, S, hd]
};

// ---------------------------------------------------------- scalar route
constexpr int kThreads = 256;

size_t scalar_smem_bytes(int hd, int P) {
  const size_t PD = hd + 1, PV = P + 1;
  return sizeof(float) * (4 * kQ * PD + kQ * PV + (size_t)kQ * (kQ + 1) +
                          (size_t)hd * PV + hd);
}

__global__ void __launch_bounds__(kThreads)
    rwkv6_scalar(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ la,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ sf, RwkvStrides st, int H, int S,
                 int hd, int P, int nslice) {
  extern __shared__ float smem[];
  const int PD = hd + 1, PV = P + 1;
  float* rs = smem;                  // [kQ][PD]  r, then r * exp(e)
  float* ks = rs + kQ * PD;          // [kQ][PD]  k, then k * exp(c_last - c)
  float* cs = ks + kQ * PD;          // [kQ][PD]  la, then inclusive cumsum
  float* es = cs + kQ * PD;          // [kQ][PD]  exclusive cumsum
  float* vs = es + kQ * PD;          // [kQ][PV]  the slice's v
  float* att = vs + kQ * PV;         // [kQ][kQ + 1]
  float* sts = att + kQ * (kQ + 1);  // [hd][PV]  state S[t][c], the slice
  float* us = sts + hd * PV;         // [hd]

  const int bh = blockIdx.x / nslice, v0 = (blockIdx.x % nslice) * P;
  const int b = bh / H, h = bh % H;
  const int nv = min(P, hd - v0);    // value channels of this slice
  const int tid = threadIdx.x;
  const float* rb = r + b * st.rb + h * st.rh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh + v0;
  const float* lb = la + b * st.lb + h * st.lh;
  float* yb = y + b * st.yb + h * st.yh + v0;

  for (int i = tid; i < hd * PV; i += kThreads) sts[i] = 0.f;
  for (int t = tid; t < hd; t += kThreads) us[t] = u[b * st.ub + h * st.uh + t];

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    // 1. the chunk's tiles, zero-filled (la = 0) past S
    for (int i = tid; i < kQ * hd; i += kThreads) {
      const int q = i / hd, t = i % hd;
      float rv = 0.f, kv = 0.f, lv = 0.f;
      if (q < nq) {
        const long long s = c0 + q;
        rv = rb[s * st.rs + t];
        kv = kb[s * st.ks + t];
        lv = lb[s * st.ls + t];
      }
      rs[q * PD + t] = rv;
      ks[q * PD + t] = kv;
      cs[q * PD + t] = lv;
    }
    for (int i = tid; i < kQ * nv; i += kThreads) {
      const int q = i / nv, c = i % nv;
      vs[q * PV + c] = q < nq ? vb[(long long)(c0 + q) * st.vs + c] : 0.f;
    }
    __syncthreads();
    // 2. cumulative log decay, one thread per channel
    for (int t = tid; t < hd; t += kThreads) {
      float acc = 0.f;
      for (int q = 0; q < kQ; ++q) {
        es[q * PD + t] = acc;
        acc += cs[q * PD + t];
        cs[q * PD + t] = acc;
      }
    }
    __syncthreads();
    // 3. score tile: strictly causal pairs with their per-pair decay, the
    //    u bonus on the diagonal, 0 above it
    for (int p = tid; p < kQ * kQ; p += kThreads) {
      const int i = p / kQ, j = p % kQ;
      const float* ri = rs + i * PD;
      float a = 0.f;
      if (j < i) {
        const float* ei = es + i * PD;
        const float* kj = ks + j * PD;
        const float* cj = cs + j * PD;
        for (int t = 0; t < hd; ++t) a += ri[t] * kj[t] * expf(ei[t] - cj[t]);
      } else if (j == i) {
        const float* ki = ks + i * PD;
        for (int t = 0; t < hd; ++t) a += ri[t] * us[t] * ki[t];
      }
      att[i * (kQ + 1) + j] = a;
    }
    __syncthreads();
    // 4a. r * exp(e) for the inter term, k * exp(c_last - c) for the state
    const float* clast = cs + (kQ - 1) * PD;
    for (int i = tid; i < kQ * hd; i += kThreads) {
      const int q = i / hd, t = i % hd;
      rs[q * PD + t] *= expf(es[q * PD + t]);
      ks[q * PD + t] *= expf(clast[t] - cs[q * PD + t]);
    }
    __syncthreads();
    // 4b. outputs of the chunk's rows, the slice's channels
    for (int o = tid; o < nq * nv; o += kThreads) {
      const int i = o / nv, c = o % nv;
      const float* ai = att + i * (kQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += ai[j] * vs[j * PV + c];
      const float* ri = rs + i * PD;
      float inter = 0.f;
      for (int t = 0; t < hd; ++t) inter += ri[t] * sts[t * PV + c];
      yb[(long long)(c0 + i) * st.ys + c] = acc + inter;
    }
    __syncthreads();
    // 5. carry the slice's state columns to the end of the chunk
    for (int o = tid; o < hd * nv; o += kThreads) {
      const int t = o / nv, c = o % nv;
      float s = sts[t * PV + c] * expf(clast[t]);
      for (int j = 0; j < nq; ++j) s += ks[j * PD + t] * vs[j * PV + c];
      sts[t * PV + c] = s;
    }
    __syncthreads();
  }
  float* sfb = sf + (long long)bh * hd * hd + v0;
  for (int o = tid; o < hd * nv; o += kThreads)
    sfb[(o / nv) * hd + o % nv] = sts[(o / nv) * PV + o % nv];
}

// ---------------------------------------------------- tensor-core route
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 8;       // 4 row warps, then 4 state warps
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kHDP = 64;          // hd padded inside the CTA
constexpr int kLDB = kHDP + 8;    // padded bf16 row of r, k and the operands
constexpr int kLDL = kHDP + 4;    // padded f32 row of la / c
// rows of the chunk's operand tiles: r o exp(e) 64, the state's operand
// 64 (hi and lo), key blocks 0..2 at their last row 48, the row blocks'
// rows at those anchors 96 (pairs J < I); with diag = 8 also each block's
// keys 0..7 and rows 8..15 at its row 7, 32 + 32
constexpr int kOpRows16 = 272, kOpRows8 = 336;

template <int P> struct RwTc {
  static constexpr int LDV = P + 8;              // padded bf16 row of v, S
};

template <int P>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (4 * kQ * kLDB + 3 * kQ * RwTc<P>::LDV +
                         (3 * kQ + 17 * 16) * kLDB) +
         sizeof(float) * (2 * kQ * kLDL + kHDP + 4 * 256);
}

// Fragment layouts: mma.cuh. A row-major from [m][k] rows and B from [n][k]
// rows take ldmatrix; A from [k][m] rows and B from [k][n] rows take
// ldmatrix.trans.
template <int P>
__global__ void __launch_bounds__(kTcThreads)
    rwkv6_tc(const bf16* __restrict__ r, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ la,
             const float* __restrict__ u, bf16* __restrict__ y,
             float* __restrict__ sf, RwkvStrides st, int H, int S, int hd,
             int nslice, int diag, int vec) {
  constexpr int LDV = RwTc<P>::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sr = reinterpret_cast<bf16*>(smem_raw);  // [2][kQ][kLDB]
  bf16* sk = sr + 2 * kQ * kLDB;                 // [2][kQ][kLDB]
  bf16* sv = sk + 2 * kQ * kLDB;                 // [2][kQ][LDV] the slice
  bf16* sS = sv + 2 * kQ * LDV;                  // [kHDP][LDV] state, bf16
  bf16* tRE = sS + kHDP * LDV;                   // [kQ][kLDB] r o exp(e)
  bf16* tKh = tRE + kQ * kLDB;                   // [kQ][kLDB] k o exp(c_last - c)
  bf16* tKl = tKh + kQ * kLDB;                   //   hi and lo
  // [7][16][kLDB]: key block J (0..2) at its last row; 3 + I: block I's
  // keys 0..7 at its row 7 (rows 8..15 unused)
  bf16* tKF = tKl + kQ * kLDB;
  // [10][16][kLDB]: block I's rows at key block J's last row, tile
  // I (I - 1) / 2 + J; 6 + I: its rows 8..15 at its row 7 (rows 0..7 zero)
  bf16* tRF = tKF + 7 * 16 * kLDB;
  float* sl = reinterpret_cast<float*>(tRF + 10 * 16 * kLDB);  // [2][kQ][kLDL]
  float* su = sl + 2 * kQ * kLDL;                // [kHDP]
  float* sdg = su + kHDP;                        // [4][16][16] per-pair dots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / nslice, v0 = (blockIdx.x % nslice) * P;
  const int b = bh / H, h = bh % H;
  const int nv = min(P, hd - v0);                // value channels of the slice
  const int nks = (hd + 15) >> 4;                // k-steps over hd with data
  const int tend = 16 * nks;
  const bf16* rb = r + b * st.rb + h * st.rh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh + v0;
  const float* lb = la + b * st.lb + h * st.lh;
  bf16* yb = y + b * st.yb + h * st.yh + v0;
  const bf16 zero = __float2bfloat16(0.f);

  for (int t = tid; t < kHDP; t += kTcThreads)
    su[t] = t < hd ? u[b * st.ub + h * st.uh + t] : 0.f;
  for (int i = tid; i < 4 * 8 * kLDB; i += kTcThreads)
    tRF[(6 + i / (8 * kLDB)) * 16 * kLDB + i % (8 * kLDB)] = zero;

  auto load = [&](int c0, int stg) {
    bf16* dr = sr + stg * kQ * kLDB;
    bf16* dk = sk + stg * kQ * kLDB;
    bf16* dv = sv + stg * kQ * LDV;
    float* dl = sl + stg * kQ * kLDL;
    if (vec) {
      for (int i = tid; i < kQ * (kHDP / 8); i += kTcThreads) {
        const int q = i / (kHDP / 8), c = i % (kHDP / 8);
        const bool ok = c0 + q < S && 8 * c < hd;
        const long long s = c0 + q;
        cp_async16(dr + q * kLDB + 8 * c, ok ? rb + s * st.rs + 8 * c : rb, ok);
        cp_async16(dk + q * kLDB + 8 * c, ok ? kb + s * st.ks + 8 * c : kb, ok);
      }
      for (int i = tid; i < kQ * (P / 8); i += kTcThreads) {
        const int q = i / (P / 8), c = i % (P / 8);
        const bool ok = c0 + q < S && 8 * c < nv;
        cp_async16(dv + q * LDV + 8 * c,
                   ok ? vb + (long long)(c0 + q) * st.vs + 8 * c : vb, ok);
      }
      for (int i = tid; i < kQ * (kHDP / 4); i += kTcThreads) {
        const int q = i / (kHDP / 4), c = i % (kHDP / 4);
        const bool ok = c0 + q < S && 4 * c < hd;
        cp_async16(dl + q * kLDL + 4 * c,
                   ok ? lb + (long long)(c0 + q) * st.ls + 4 * c : lb, ok);
      }
    } else {   // rows off the 16-byte grid: element copies
      for (int i = tid; i < kQ * kHDP; i += kTcThreads) {
        const int q = i / kHDP, t = i % kHDP;
        const bool ok = c0 + q < S && t < hd;
        const long long s = c0 + q;
        dr[q * kLDB + t] = ok ? rb[s * st.rs + t] : zero;
        dk[q * kLDB + t] = ok ? kb[s * st.ks + t] : zero;
        dl[q * kLDL + t] = ok ? lb[s * st.ls + t] : 0.f;
      }
      for (int i = tid; i < kQ * P; i += kTcThreads) {
        const int q = i / P, c = i % P;
        dv[q * LDV + c] = c0 + q < S && c < nv
                              ? vb[(long long)(c0 + q) * st.vs + c] : zero;
      }
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
  const int sw = warp - 4;                       // a state warp's rows
  const int ta = 16 * sw + g, tb = ta + 8;
  // per-pair dots: the strict pairs of the diagonal blocks of diag rows,
  // per = diag (diag - 1) / 2 a block, perI a row block, nd in all
  const int per = diag * (diag - 1) / 2, perI = per * (16 / diag);
  const int nd = 4 * perI, nrows = diag == 8 ? kOpRows8 : kOpRows16;

  float sacc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;

  const int nchunks = (S + kQ - 1) / kQ;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    const int c0 = kc * kQ, stg = kc & 1, nq = min(kQ, S - c0);
    if (kc + 1 < nchunks) load(c0 + kQ, stg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* R = sr + stg * kQ * kLDB;
    const bf16* K = sk + stg * kQ * kLDB;
    const bf16* V = sv + stg * kQ * LDV;
    float* Cc = sl + stg * kQ * kLDL;
    // la -> inclusive cumsum, per channel in token order
    if (!(SCAN_SKIP & 1) && tid < kHDP) {
      float acc = 0.f;
#pragma unroll 16
      for (int q = 0; q < kQ; ++q) {
        acc += Cc[q * kLDL + tid];
        Cc[q * kLDL + tid] = acc;
      }
    }
    __syncthreads();

    // 1. every thread: the chunk's operand rows, each X_row o exp(c_p -
    //    c_m) with both c rows of one run of tokens (c_-1 = 0), 8 channels
    //    a step (a warp: 4 rows of one kind and one row block), with the
    //    u bonus of the r rows; then the per-pair dots
    for (int it = (SCAN_SKIP & 2) ? nrows * 8 : tid; it < nrows * 8;
         it += kTcThreads) {
      const int R8 = it >> 3, t = 8 * (it & 7);
      const bf16* xr;
      bf16 *out, *out_lo = nullptr;
      int pr, mr, blk;
      if (R8 < 64) {                 // r o exp(e)
        xr = R + R8 * kLDB;
        pr = R8 - 1;
        mr = -1;
        out = tRE + R8 * kLDB;
        blk = R8 >> 4;
      } else if (R8 < 128) {         // k o exp(c_last - c), hi / lo
        const int j = R8 - 64;
        xr = K + j * kLDB;
        pr = kQ - 1;
        mr = j;
        out = tKh + j * kLDB;
        out_lo = tKl + j * kLDB;
        blk = 0;
      } else if (R8 < 176) {         // key blocks at their last row
        const int j = R8 - 128;
        xr = K + j * kLDB;
        pr = (j | 15);
        mr = j;
        out = tKF + j * kLDB;
        blk = 0;
      } else if (R8 < 272) {         // row block I at key block J's row
        const int q = (R8 - 176) >> 4, ii = (R8 - 176) & 15;
        const int I = q < 1 ? 1 : (q < 3 ? 2 : 3), J = q - I * (I - 1) / 2;
        const int i = 16 * I + ii;
        xr = R + i * kLDB;
        pr = i - 1;
        mr = 16 * J + 15;
        out = tRF + (R8 - 176) * kLDB;
        blk = I;
      } else if (R8 < 304) {         // block I's keys 0..7 at its row 7
        const int I = (R8 - 272) >> 3, jj = (R8 - 272) & 7, j = 16 * I + jj;
        xr = K + j * kLDB;
        pr = 16 * I + 7;
        mr = j;
        out = tKF + ((3 + I) * 16 + jj) * kLDB;
        blk = I;
      } else {                       // block I's rows 8..15 at its row 7
        const int I = (R8 - 304) >> 3, ii = 8 + ((R8 - 304) & 7);
        const int i = 16 * I + ii;
        xr = R + i * kLDB;
        pr = i - 1;
        mr = 16 * I + 7;
        out = tRF + ((6 + I) * 16 + ii) * kLDB;
        blk = I;
      }
      if (16 * blk >= nq) continue;  // rows no live warp reads
      if (R8 < 64) {                 // r's row: sum_t r u k over 8 lanes
        const uint4 r8 = *reinterpret_cast<const uint4*>(xr + t);
        const uint4 k8 = *reinterpret_cast<const uint4*>(K + R8 * kLDB + t);
        const unsigned rw[4] = {r8.x, r8.y, r8.z, r8.w};
        const unsigned kw[4] = {k8.x, k8.y, k8.z, k8.w};
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rw[e]));
          const float2 kk = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&kw[e]));
          dot += rr.x * su[t + 2 * e] * kk.x + rr.y * su[t + 2 * e + 1] * kk.y;
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (t == 0) sdg[blk * 256 + (R8 & 15) * 17] = dot;
      }
      if (t >= tend) continue;
      const uint4 x8 = *reinterpret_cast<const uint4*>(xr + t);
      const unsigned xw[4] = {x8.x, x8.y, x8.z, x8.w};
      float cp[8], cm[8];
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 p4 = pr >= 0 ? *reinterpret_cast<const float4*>(
                                        Cc + pr * kLDL + t + e)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 m4 = mr >= 0 ? *reinterpret_cast<const float4*>(
                                        Cc + mr * kLDL + t + e)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        cp[e] = p4.x; cp[e + 1] = p4.y; cp[e + 2] = p4.z; cp[e + 3] = p4.w;
        cm[e] = m4.x; cm[e + 1] = m4.y; cm[e + 2] = m4.z; cm[e + 3] = m4.w;
      }
      float val[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
        val[2 * e] = xv.x * __expf(cp[2 * e] - cm[2 * e]);
        val[2 * e + 1] = xv.y * __expf(cp[2 * e + 1] - cm[2 * e + 1]);
      }
      unsigned hi[4], lo[4];
      if (out_lo) {                  // the state's operand: hi and lo
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Bf16Pair pr2 = split_bf16(val[2 * e], val[2 * e + 1]);
          hi[e] = pr2.hi;
          lo[e] = pr2.lo;
        }
        *reinterpret_cast<uint4*>(out_lo + t) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[e] = pack_bf16(val[2 * e], val[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(out + t) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
    for (int d = (SCAN_SKIP & 4) ? nd : tid; d < nd; d += kTcThreads) {
      const int I = d / perI;        // strict pair (il, jl) of row block I
      if (16 * I >= nq) continue;
      int p = d % perI;
      const int blk = p / per;
      p %= per;
      int il = 1;
      while (p >= il) {
        p -= il;
        ++il;
      }
      const int jl = diag * blk + p;
      il += diag * blk;
      const bf16* ri = R + (16 * I + il) * kLDB;
      const bf16* kj = K + (16 * I + jl) * kLDB;
      const float* ei = Cc + (16 * I + il - 1) * kLDL;
      const float* cj = Cc + (16 * I + jl) * kLDL;
      float dot = 0.f;
      for (int t = 0; t < tend; t += 8) {
        const uint4 r8 = *reinterpret_cast<const uint4*>(ri + t);
        const uint4 k8 = *reinterpret_cast<const uint4*>(kj + t);
        const unsigned rw[4] = {r8.x, r8.y, r8.z, r8.w};
        const unsigned kw[4] = {k8.x, k8.y, k8.z, k8.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rw[q]));
          const float2 kk = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&kw[q]));
          const float2 ee = *reinterpret_cast<const float2*>(ei + t + 2 * q);
          const float2 cc = *reinterpret_cast<const float2*>(cj + t + 2 * q);
          dot += rr.x * kk.x * __expf(ee.x - cc.x);
          dot += rr.y * kk.y * __expf(ee.y - cc.y);
        }
      }
      sdg[I * 256 + il * 16 + jl] = dot;
    }
    __syncthreads();

    // 2. row warps: scores and y; state warps: the state
    if (row_warp && i0 < nq && !(SCAN_SKIP & 8)) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int J = 0; J < 3; ++J) {  // key blocks J < I
        if (J >= warp) continue;
        const bf16* A_ = tRF + (warp * (warp - 1) / 2 + J) * 16 * kLDB;
        const bf16* B_ = tKF + J * 16 * kLDB;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
          unsigned af[4], bfr[4];
          ldmatrix_x4(af, A_ + a_row * kLDB + 16 * ks + a_col);
          ldmatrix_x4(bfr, B_ + b_row * kLDB + 16 * ks + b_col);
          mma_bf16(s[2 * J], af, bfr[0], bfr[1]);
          mma_bf16(s[2 * J + 1], af, bfr[2], bfr[3]);
        }
      }
      if (diag == 8) {               // rows 8..15 against keys 0..7
        const bf16* A_ = tRF + (6 + warp) * 16 * kLDB;
        const bf16* B_ = tKF + (3 + warp) * 16 * kLDB;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
          unsigned af[4], bfr[4];
          ldmatrix_x4(af, A_ + a_row * kLDB + 16 * ks + a_col);
          ldmatrix_x4(bfr, B_ + b_row * kLDB + 16 * ks + b_col);
#pragma unroll
          for (int n = 0; n < 8; n += 2)
            if (n == 2 * warp) mma_bf16(s[n], af, bfr[0], bfr[1]);
        }
      }
      {                              // the per-pair dots and the bonus
        const float* sd = sdg + warp * 256;
        const float d00 = cq <= g ? sd[g * 16 + cq] : 0.f;
        const float d01 = cq + 1 <= g ? sd[g * 16 + cq + 1] : 0.f;
        const float d10 = cq <= g ? sd[(g + 8) * 16 + 8 + cq] : 0.f;
        const float d11 = cq + 1 <= g ? sd[(g + 8) * 16 + 9 + cq] : 0.f;
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          if (n != 2 * warp) continue;
          s[n][0] = d00;
          s[n][1] = d01;
          if (diag == 16) {          // rows 8..15 against keys 0..7
            s[n][2] = sd[(g + 8) * 16 + cq];
            s[n][3] = sd[(g + 8) * 16 + cq + 1];
          }
          s[n + 1][2] = d10;
          s[n + 1][3] = d11;
        }
      }
      // y = (r o exp(e)) S_prev + scores v
      float acc[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      if (c0 > 0) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= nks) continue;
          unsigned af[4];
          ldmatrix_x4(af, tRE + (i0 + a_row) * kLDB + 16 * ks + a_col);
#pragma unroll
          for (int dp = 0; dp < P / 16; ++dp) {
            unsigned bfr[4];
            ldmatrix_x4_trans(bfr, sS + (16 * ks + a_row) * LDV + 16 * dp + a_col);
            mma_bf16(acc[2 * dp], af, bfr[0], bfr[1]);
            mma_bf16(acc[2 * dp + 1], af, bfr[2], bfr[3]);
          }
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
          ldmatrix_x4_trans(bfr, V + (16 * kk + a_row) * LDV + 16 * dp + a_col);
          mma_bf16(acc[2 * dp], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], af, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const int c = 8 * n + cq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? ib : ia;
          if (i >= nq) continue;
          bf16* dst = yb + (long long)(c0 + i) * st.ys + c;
          if (c < nv) dst[0] = __float2bfloat16(acc[n][2 * rr]);
          if (c + 1 < nv) dst[1] = __float2bfloat16(acc[n][2 * rr + 1]);
        }
      }
    } else if (!row_warp && 16 * sw < hd && !(SCAN_SKIP & 16)) {
      // S = diag(exp(c_last)) S + (k o exp(c_last - c))^T v, hi and lo
      const float da = __expf(Cc[(kQ - 1) * kLDL + ta]);
      const float db = __expf(Cc[(kQ - 1) * kLDL + tb]);
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        sacc[n][0] *= da;
        sacc[n][1] *= da;
        sacc[n][2] *= db;
        sacc[n][3] *= db;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= nq) continue;
        unsigned ah[4], al[4];
        ldmatrix_x4_trans(ah, tKh + (16 * kk + b_row) * kLDB + 16 * sw + b_col);
        ldmatrix_x4_trans(al, tKl + (16 * kk + b_row) * kLDB + 16 * sw + b_col);
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          unsigned bfr[4];
          ldmatrix_x4_trans(bfr, V + (16 * kk + a_row) * LDV + 16 * dp + a_col);
          mma_bf16(sacc[2 * dp], ah, bfr[0], bfr[1]);
          mma_bf16(sacc[2 * dp], al, bfr[0], bfr[1]);
          mma_bf16(sacc[2 * dp + 1], ah, bfr[2], bfr[3]);
          mma_bf16(sacc[2 * dp + 1], al, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();   // S_prev's copy, the operands and the stage are consumed
    if (!row_warp) {
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const int c = 8 * n + cq;
        *reinterpret_cast<unsigned*>(sS + ta * LDV + c) =
            pack_bf16(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<unsigned*>(sS + tb * LDV + c) =
            pack_bf16(sacc[n][2], sacc[n][3]);
      }
    }
  }
  if (row_warp) return;
  float* sfb = sf + (long long)bh * hd * hd + v0;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    const int c = 8 * n + cq;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = rr ? tb : ta;
      if (t >= hd) continue;
      if (c < nv) sfb[t * hd + c] = sacc[n][2 * rr];
      if (c + 1 < nv) sfb[t * hd + c + 1] = sacc[n][2 * rr + 1];
    }
  }
}

template <int P>
cudaError_t launch_tc(const void* r, const void* k, const void* v,
                      const float* la, const float* u, void* y, float* sf,
                      const RwkvStrides& st, int B, int H, int S, int hd,
                      int diag, int vec, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<P>();
  cudaError_t err = set_smem(rwkv6_tc<P>, smem);
  if (err != cudaSuccess) return err;
  const int nslice = (hd + P - 1) / P;
  rwkv6_tc<P><<<B * H * nslice, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), la, u, static_cast<bf16*>(y), sf, st, H,
      S, hd, nslice, diag, vec);
  return cudaGetLastError();
}

}  // namespace

// strides: 17 element strides in RwkvStrides order. la, u, sf are f32;
// r, k, v, y are f32 (dtype 0, the scalar route) or bf16 (dtype 1, the
// tensor-core route). sf [B, H, hd, hd] contiguous. slice: v's channels a
// CTA (the plan's; 16, 32 or 64 for bf16, 1..64 for f32). diag (bf16): the
// rows of the diagonal blocks that keep a per-pair exp, 8 or 16. vec: r,
// k, v and la rows start on 16 bytes and hd is a multiple of 8, so the
// tiles take 16-byte copies.
extern "C" int rwkv6_scan_fwd(int dtype, const void* r, const void* k,
                              const void* v, const void* la, const void* u,
                              void* y, void* sf, const long long* strides,
                              int B, int H, int S, int hd, int slice,
                              int diag, int vec, void* stream) {
  if (B < 1 || H < 1 || S < 1 || hd < 1 || hd > kMaxHD || slice < 1 ||
      slice > kMaxHD)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  RwkvStrides st = {s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                    s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                    s[12], s[13], s[14], s[15], s[16]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* laf = static_cast<const float*>(la);
  const float* uf = static_cast<const float*>(u);
  float* sff = static_cast<float*>(sf);
  if (dtype == kF32) {
    const size_t smem = scalar_smem_bytes(hd, slice);
    cudaError_t err = set_smem(rwkv6_scalar, smem);
    if (err != cudaSuccess) return err;
    const int nslice = (hd + slice - 1) / slice;
    rwkv6_scalar<<<B * H * nslice, kThreads, smem, cs>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), laf, uf, static_cast<float*>(y), sff,
        st, H, S, hd, slice, nslice);
    return cudaGetLastError();
  }
  if (dtype != kBF16 || (diag != 8 && diag != 16))
    return cudaErrorInvalidValue;
  if (vec) {
    const void* ptrs[4] = {r, k, v, la};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
    const long long rows[12] = {st.rb, st.rh, st.rs, st.kb, st.kh, st.ks,
                                st.vb, st.vh, st.vs, 2 * st.lb, 2 * st.lh,
                                2 * st.ls};
    for (long long x : rows)
      if (x % 8) return cudaErrorInvalidValue;
    if (hd % 8) return cudaErrorInvalidValue;
  }
  switch (slice) {
    case 16:
      return launch_tc<16>(r, k, v, laf, uf, y, sff, st, B, H, S, hd, diag,
                           vec, cs);
    case 32:
      return launch_tc<32>(r, k, v, laf, uf, y, sff, st, B, H, S, hd, diag,
                           vec, cs);
    case 64:
      return launch_tc<64>(r, k, v, laf, uf, y, sff, st, B, H, S, hd, diag,
                           vec, cs);
  }
  return cudaErrorInvalidValue;
}
