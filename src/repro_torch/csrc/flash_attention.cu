// Causal prefill attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention (the
// Pallas TPU kernel _kernel). Same function: for each (batch, kv head) the
// G query heads of the GQA group attend causally (optionally inside a
// sliding window) over the shared K/V, with an online softmax in f32, the
// TPU kernel's -1e30 mask and 1e-30 denominator clamp, and the softmax
// weights rounded to the input dtype before the P.V product, as the TPU
// kernel does (p.astype(v.dtype)).
//
// What bounds it on the H100: at the serving paths' prefill shapes (S =
// 18..128, or a padded admission group of 8 x 113; hd 112 or 128; bf16) a
// call moves well under a megabyte and does a few tens of MFLOP, so its
// floor is set by the bytes of q, k, v and out (under a microsecond); in
// practice a call this small is bound by latency: how many SMs hold work
// and how few dependent steps each walks.
//
// Two routes, chosen by the wrapper's shape-only plan
// (kernels/flash_attention.py: flash_plan):
//
// * tensor cores (bf16, hd a multiple of 16 up to 256, 16-byte aligned
//   rows): the GQA group is folded into the rows, row r = (query s = r / G,
//   head g = r % G), so a K/V tile is read once for the whole group and a
//   16-row tile spans 16 / G positions (little work past the causal
//   diagonal). A CTA of 4 warps holds RT = 1, 2 or 4 such row tiles; the
//   4 / RT warps of a row tile split every 64-key tile between them (16,
//   32 or 64 keys each), so a short prompt's few rows still keep four
//   warps busy (the first port walked 4 rows a warp, one after another)
//   while a batched prefill shares each K/V tile among more rows; the
//   plan picks RT from the grid it gives (S = 128, G 2, 8 kv heads: 128
//   one-row-tile CTAs). Q.K^T and P.V run on mma.sync m16n8k16 (bf16 in,
//   f32 out) fed by ldmatrix; Q stays in registers (in shared memory at
//   hd > 128, to save registers), scores and the online softmax stay in
//   registers with quad shuffles for the row max and sum, and p is
//   rounded to bf16 against the warp's running max as it becomes the A
//   operand of P.V. The key slices of a row tile then merge their (m, l,
//   acc) in slice order through shared memory, in f32. K/V tiles stream
//   through a two-stage cp.async ring into rows padded by 16 bytes
//   (ldmatrix without bank conflicts); rows past S and columns past hd are
//   zero-filled by the copy (src-size 0), and hd is padded to 64, 128 or
//   256 inside the CTA, the k-steps past hd skipped. Key slices wholly
//   above a row tile's diagonal or left of its window are skipped; CTAs
//   are issued latest rows first, so the longest key walks start first.
// * scalar f32 FMAs (f32, where TF32 would fall outside the 2e-5
//   tolerance, and bf16 at other head widths): the first port's kernel,
//   one CTA per (batch * kv head, 16 query positions), K/V converted to
//   f32 in shared memory, one key per lane.
#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

using namespace rt;

namespace {

struct FlashStrides {
  long long qb, qh, qg, qs;      // q   [B, H, G, S, hd]
  long long kb, kh, ks;          // k   [B, H, S, hd]
  long long vb, vh, vs;          // v   [B, H, S, hd]
  long long ob, oh, og, os;      // out [B, H, G, S, hd]
};

// ---------------------------------------------------------- scalar route
constexpr int kBK = 32;          // keys per tile: one per lane
constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxPerLane = 8;   // head_dim <= 256

size_t smem_bytes(int rows, int hd) {
  return sizeof(float) *
         (2 * (size_t)rows * hd + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
          2 * (size_t)rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_scalar(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, FlashStrides st,
              int H, int G, int S, int hd, int BQ, int causal, int window,
              float scale) {
  extern __shared__ float smem[];
  const int R = G * BQ;                   // rows: (g, query) pairs
  float* qs = smem;                       // [R][hd]
  float* acc = qs + R * hd;               // [R][hd]
  float* ks = acc + R * hd;               // [kBK][hd + 1] (odd stride)
  float* vs = ks + kBK * (hd + 1);        // [kBK][hd]
  float* m_s = vs + kBK * hd;             // [R]
  float* l_s = m_s + R;                   // [R]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  T* ob = o + b * st.ob + h * st.oh;

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int g = r / BQ, qp = q0 + r % BQ;
    qs[i] = qp < S ? to_f(qb[g * st.qg + qp * st.qs + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int q_hi = min(q0 + BQ, S) - 1;   // last query position of the tile
  const int nper = (hd + 31) / 32;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    if (causal && k0 > q_hi) break;                          // above diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // left of window
    __syncthreads();   // previous tile consumed; q/acc/m/l initialised
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int j = i / hd, d = i % hd, kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        kv = to_f(kb[kp * st.ks + d]);
        vv = to_f(vb[kp * st.vs + d]);
      }
      ks[j * (hd + 1) + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();
    const int kp = k0 + lane;
    const bool inrange = kp < S;
    const int nk = min(kBK, S - k0);
    for (int r = warp; r < R; r += kWarps) {
      const int qp = q0 + r % BQ;
      if (qp >= S) continue;              // warp-uniform
      const float* qr = qs + r * hd;
      const float* kr = ks + lane * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
      s *= scale;
      const bool ok = inrange && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      s = ok ? s : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_new);
      const float p = inrange ? expf(s - m_new) : 0.f;
      const float lsum = warp_sum(p);
      const float pt = round_to<T>(p);
      float* ar = acc + r * hd;
      float a[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        a[i] = (i < nper && d < hd) ? ar[d] * alpha : 0.f;
      }
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pt, j);
        const float* vr = vs + j * hd;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int d = lane + 32 * i;
          if (i < nper && d < hd) a[i] += pj * vr[d];
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (i < nper && d < hd) ar[d] = a[i];
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + lsum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int g = r / BQ, qp = q0 + r % BQ;
    if (qp < S)
      ob[g * st.og + qp * st.os + d] =
          from_f<T>(acc[i] / fmaxf(l_s[r], kMinDenom));
  }
}

template <typename T>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* o, const FlashStrides& st, int B, int H,
                          int G, int S, int hd, int causal, int window,
                          float scale, cudaStream_t stream) {
  int BQ = 16;
  while (BQ > 1 && smem_bytes(G * BQ, hd) > 200 * 1024) BQ /= 2;
  const size_t smem = smem_bytes(G * BQ, hd);
  cudaError_t err = set_smem(flash_scalar<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_scalar<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, G, S, hd, BQ,
      causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------- tensor-core route
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;     // warps of a CTA
constexpr int kTcBK = 64;       // keys of a K/V tile

// HDP: hd padded to 64, 128 or 256
template <int HDP> struct TcCfg {
  static constexpr int LD = HDP + 8;               // padded row, elements
  static constexpr int KSTEPS = HDP / 16;
  static constexpr bool Q_REGS = HDP <= 128;       // Q fragments in regs
};

template <int HDP, int RT>
constexpr size_t tc_smem_bytes() {
  // Q rows and the two-stage K/V ring; the warps' merge reuses the ring
  return sizeof(bf16) * (16 * RT + 4 * kTcBK) * (size_t)TcCfg<HDP>::LD;
}

// RT row tiles of 16 folded rows a CTA; warp w takes row tile w / KS and
// key slice w % KS (KS = 4 / RT) of every 64-key tile, KW = 64 / KS keys.
// Two CTAs an SM at hd <= 128 (their K/V rings fit 227 KB), so registers
// are held to 255 a thread; one-row-tile CTAs fit three, at 170.
template <int HDP, int RT>
__global__ void __launch_bounds__(32 * kTcWarps,
                                  HDP > 128 ? 1 : (RT == 1 ? 3 : 2))
    flash_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             FlashStrides st, int H, int G, int S, int hd, int causal,
             int window, float scale_log2) {
  using C = TcCfg<HDP>;
  constexpr int BK = kTcBK, KS = kTcWarps / RT, KW = BK / KS;
  constexpr int LD = C::LD, CPR = HDP / 8, ROWS = 16 * RT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [ROWS][LD]
  bf16* sk = sq + ROWS * LD;                      // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int R = G * S;                            // folded rows
  const int c0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // latest rows first
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  bf16* ob = o + b * st.ob + h * st.oh;
  const int nchunk = hd >> 3;                     // chunks holding data
  const int nks = hd >> 4;                        // k-steps holding data

  for (int i = tid; i < ROWS * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = i % CPR, r = c0 + rr;
    const bool ok = r < R && c < nchunk;
    cp_async16(sq + rr * LD + c * 8,
               ok ? qb + (r % G) * st.qg + (long long)(r / G) * st.qs + c * 8
                  : qb,
               ok);
  }
  // the CTA's key tiles
  const int kt_end = causal ? (min(c0 + ROWS, R) - 1) / G / BK + 1
                            : (S + BK - 1) / BK;
  const int kt_begin = window > 0 ? max(0, c0 / G - window + 1) / BK : 0;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CPR; i += blockDim.x) {
      const int j = i / CPR, c = i % CPR, kp = k0 + j;
      const bool ok = kp < S && c < nchunk;
      bf16* dk = sk + (stage * BK + j) * LD + c * 8;
      bf16* dv = sv + (stage * BK + j) * LD + c * 8;
      cp_async16(dk, ok ? kb + (long long)kp * st.ks + c * 8 : kb, ok);
      cp_async16(dv, ok ? vb + (long long)kp * st.vs + c * 8 : vb, ok);
    }
  };
  load_kv(kt_begin, 0);
  cp_async_commit();

  // the warp's row tile and key slice; each lane holds rows ra (c0, c1)
  // and ra + 8 (c2, c3) of the row tile
  const int rt = warp / KS, slice = warp % KS;
  const int r0 = c0 + 16 * rt;
  const bool active = r0 < R;
  const int q_lo = r0 / G, q_hi = (min(r0 + 16, R) - 1) / G;
  const int ra = r0 + (lane >> 2);
  const int qpos[2] = {ra / G, (ra + 8) / G};
  const int kc = 2 * (lane & 3);                  // column within an n-tile
  // ldmatrix row/column offsets: A (Q, P) and the transposed B (V) take
  // (row, col) = (lane & 7) + 8 ((lane >> 3) & 1), 8 (lane >> 4); the
  // non-transposed B (K) takes (lane & 7) + 8 (lane >> 4), 8 ((lane >> 3)
  // & 1)
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_col = (lane >> 4) << 3;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;

  const bf16* sq_w = sq + 16 * rt * LD;
  unsigned qf[C::Q_REGS ? C::KSTEPS : 1][4];
  float acc[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (C::Q_REGS && kt == kt_begin) {
#pragma unroll
      for (int s = 0; s < C::KSTEPS; ++s)
        if (s < nks)
          ldmatrix_x4(qf[C::Q_REGS ? s : 0],
                      sq_w + a_row * LD + s * 16 + a_col);
    }
    const int k0 = kt * BK + slice * KW;
    const bool skip = !active || (causal && k0 > q_hi) ||
                      (window > 0 && k0 + KW - 1 <= q_lo - window);
    if (!skip) {
      const bf16* skw = sk + (stage * BK + slice * KW) * LD;
      const bf16* svw = sv + (stage * BK + slice * KW) * LD;
      float s[KW / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        if (ks < nks) {
          unsigned a[4];
          if constexpr (C::Q_REGS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qf[C::Q_REGS ? ks : 0][i];
          } else {
            ldmatrix_x4(a, sq_w + a_row * LD + ks * 16 + a_col);
          }
#pragma unroll
          for (int jp = 0; jp < KW / 16; ++jp) {
            unsigned bf[4];
            ldmatrix_x4(bf, skw + (jp * 16 + b_row) * LD + ks * 16 + b_col);
            mma_bf16(s[2 * jp], a, bf[0], bf[1]);
            mma_bf16(s[2 * jp + 1], a, bf[2], bf[3]);
          }
        }
      }
      // mask, scale into the log2 domain, row max over the quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + kc + (e & 1), qp = qpos[e >> 1];
          const bool ok = kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          const float t = ok ? s[j][e] * scale_log2 : kNegInf;
          s[j][e] = t;
          mx[e >> 1] = fmaxf(mx[e >> 1], t);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // p against the warp's running max; keys past S weigh 0 (masked
      // keys that exist weigh exp(-1e30 - m), as in the TPU kernel)
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + kc + (e & 1);
          const float p = kp < S ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
          s[j][e] = p;
          l[e >> 1] += p;
        }
      // P.V: p rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < C::KSTEPS; ++dp) {
          if (dp < nks) {
            unsigned bf[4];
            ldmatrix_x4_trans(bf, svw + (kk * 16 + a_row) * LD + dp * 16 +
                                      a_col);
            mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
            mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }
  // merge each row tile's key slices in slice order, through the K/V ring
  constexpr int RLD = HDP + 8;                    // padded f32 row
  float* red = reinterpret_cast<float*>(sk);      // [4][16][RLD]
  float* red_m = red + kTcWarps * 16 * RLD;       // [4][16]
  float* red_l = red_m + kTcWarps * 16;           // [4][16]
  const int row = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if ((lane & 3) == 0) {
      red_m[warp * 16 + row + 8 * i] = m[i];
      red_l[warp * 16 + row + 8 * i] = l[i];
    }
  }
  float* rw = red + warp * 16 * RLD;
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    if (n < 2 * nks) {
      *reinterpret_cast<float2*>(rw + row * RLD + 8 * n + kc) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(rw + (row + 8) * RLD + 8 * n + kc) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < ROWS * CPR; i += blockDim.x) {
    const int rw0 = i / CPR, c = i % CPR, r = c0 + rw0;
    if (r >= R || c >= nchunk) continue;
    const int w0 = (rw0 >> 4) * KS, rr = rw0 & 15;
    float mw[KS], mmax = kNegInf, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      mw[w] = red_m[(w0 + w) * 16 + rr];
      mmax = fmaxf(mmax, mw[w]);
    }
    float out[8] = {};
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const float sc = exp2f(mw[w] - mmax);
      lsum += red_l[(w0 + w) * 16 + rr] * sc;
      const float* src = red + ((w0 + w) * 16 + rr) * RLD + c * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] += src[j] * sc;
    }
    const float den = fmaxf(lsum, kMinDenom);
    uint4 pk;
    pk.x = pack_bf16(out[0] / den, out[1] / den);
    pk.y = pack_bf16(out[2] / den, out[3] / den);
    pk.z = pack_bf16(out[4] / den, out[5] / den);
    pk.w = pack_bf16(out[6] / den, out[7] / den);
    *reinterpret_cast<uint4*>(ob + (r % G) * st.og +
                              (long long)(r / G) * st.os + c * 8) = pk;
  }
}

template <int HDP, int RT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const FlashStrides& st, int B, int H, int G, int S,
                      int hd, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HDP, RT>();
  cudaError_t err = set_smem(flash_tc<HDP, RT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G * S + 16 * RT - 1) / (16 * RT), B * H);
  flash_tc<HDP, RT><<<grid, 32 * kTcWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, H, G, S, hd,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

FlashStrides unpack(const long long* s) {
  return {s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],
          s[7], s[8], s[9], s[10], s[11], s[12], s[13]};
}

}  // namespace

// strides: 14 element strides in FlashStrides order. window <= 0: none.
// The scalar route: f32 or bf16, any hd <= 256.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int G, int S, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (hd < 1 || hd > 32 * kMaxPerLane || S < 1 || G < 1)
    return cudaErrorInvalidValue;
  const FlashStrides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_scalar<float>(q, k, v, o, st, B, H, G, S, hd, causal,
                                window, scale, s);
  if (dtype == kBF16)
    return launch_scalar<__nv_bfloat16>(q, k, v, o, st, B, H, G, S, hd,
                                        causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route: bf16, hd a multiple of 16 up to 256, every
// pointer 16-byte aligned and every row stride a multiple of 8 elements;
// `row_tiles` (1, 2 or 4) 16-row tiles a CTA, from the plan.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int H, int G, int S, int hd,
                                      int causal, int window, float scale,
                                      int row_tiles, void* stream) {
  if (hd < 16 || hd > 256 || hd % 16 || S < 1 || G < 1)
    return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < 14; ++i)
    if (strides[i] % 8) return cudaErrorInvalidValue;
  const FlashStrides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto rows = [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    switch (row_tiles) {
      case 1:
        return launch_tc<HDP, 1>(q, k, v, o, st, B, H, G, S, hd, causal,
                                 window, scale, s);
      case 2:
        return launch_tc<HDP, 2>(q, k, v, o, st, B, H, G, S, hd, causal,
                                 window, scale, s);
      case 4:
        return launch_tc<HDP, 4>(q, k, v, o, st, B, H, G, S, hd, causal,
                                 window, scale, s);
      default:
        return cudaErrorInvalidValue;
    }
  };
  if (hd <= 64) return rows(std::integral_constant<int, 64>());
  if (hd <= 128) return rows(std::integral_constant<int, 128>());
  return rows(std::integral_constant<int, 256>());
}
