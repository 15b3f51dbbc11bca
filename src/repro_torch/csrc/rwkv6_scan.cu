// RWKV6 wkv chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/rwkv6_scan.py : rwkv6_scan (the Pallas TPU
// kernel _kernel). Same function, per (batch, head), from a zero state:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T          S in R^{hd x hd}
//
// returning y (in r's dtype) and the final f32 state. Inputs are read as
// f32, every product and sum is f32, y is rounded once at the end.
//
// Form. The sequence is cut into chunks of kQ = 32 tokens. Within a chunk,
// with c the inclusive and e the exclusive cumulative log decay per channel
// (e_i = c_{i-1}, e_0 = 0):
//   intra  y_i += sum_{j<i} (sum_t r_it k_jt exp(e_it - c_jt)) v_j
//   bonus  y_i += (sum_t r_it u_t k_it) v_i
//   inter  y_i += (r_i * exp(e_i)) . S_prev
//   state  S    = diag(exp(c_last)) S_prev + sum_j (k_j * exp(c_last - c_j)) v_j^T
// The exponent is formed per (i, j, t) pair, and each one is a sum of log
// decays, so it is <= 0: the form is exact for any decay (la down to -inf
// underflows to 0 as it should). The TPU kernel factors the intra term as
// exp(cs_i - la_i) * exp(-cs_j), which overflows f32 once a chunk's
// cumulative decay on a channel passes about -88 (the model clips w0 +
// lora at 8, so one token's la reaches -2981); where that form is finite
// the two agree. The chunk length does not change the result; any S is
// taken, and rows past S in the last chunk are zero-filled with la = 0, so
// they add nothing and leave c_last unchanged.
//
// What bounds it on the H100: at the serving path's prefill (BH = 32,
// S <= 128, hd = 64) a call reads r, k, v (bf16) and la (f32) once and
// writes y and the 16 KB state per head: about 3 MB, under a microsecond
// at 3.35 TB/s; its FLOPs (about 4 * S * hd * (Q/2 + 2 hd) per head) are
// tens of MFLOP. So bytes bound it on paper; in practice a call this
// small is bound by the latency of its sequential chunk chain and by the
// exp of every intra pair.
//
// Design (right and simple first): one CTA of 256 threads per (batch,
// head) walks the chunks in order, the TPU kernel's sequential grid axis.
// The [hd, hd] f32 state lives in shared memory (16 KB at hd = 64), as do
// the chunk's r, k, v, c, e tiles and the [Q, Q] score tile, which never
// reaches device memory (VMEM held it on the TPU). Rows are padded to
// hd + 1 floats so a warp reading one column of 32 rows hits 32 banks.
// Scalar f32 FMAs; wgmma, TMA, splitting hd across CTAs and a chunked
// decode recurrence are later work.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kQ = 32;           // tokens per chunk
constexpr int kMaxHD = 64;
constexpr int kThreads = 256;

struct RwkvStrides {
  long long rb, rh, rs;          // r  [B, H, S, hd]
  long long kb, kh, ks;          // k  [B, H, S, hd]
  long long vb, vh, vs;          // v  [B, H, S, hd]
  long long lb, lh, ls;          // la [B, H, S, hd]
  long long ub, uh;              // u  [B, H, hd]
  long long yb, yh, ys;          // y  [B, H, S, hd]
};

size_t smem_bytes(int hd) {
  const size_t P = hd + 1;
  return sizeof(float) *
         (5 * kQ * P + (size_t)kQ * (kQ + 1) + (size_t)hd * P + hd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ la,
              const float* __restrict__ u, T* __restrict__ y,
              float* __restrict__ sf, RwkvStrides st, int H, int S, int hd) {
  extern __shared__ float smem[];
  const int P = hd + 1;
  float* rs = smem;                  // [kQ][P]  r, then r * exp(e)
  float* ks = rs + kQ * P;           // [kQ][P]  k, then k * exp(c_last - c)
  float* vs = ks + kQ * P;           // [kQ][P]
  float* cs = vs + kQ * P;           // [kQ][P]  la, then inclusive cumsum
  float* es = cs + kQ * P;           // [kQ][P]  exclusive cumsum
  float* att = es + kQ * P;          // [kQ][kQ + 1]
  float* sts = att + kQ * (kQ + 1);  // [hd][P]  state S[t][c]
  float* us = sts + hd * P;          // [hd]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const T* rb = r + b * st.rb + h * st.rh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* lb = la + b * st.lb + h * st.lh;
  T* yb = y + b * st.yb + h * st.yh;

  for (int i = tid; i < hd * P; i += kThreads) sts[i] = 0.f;
  for (int t = tid; t < hd; t += kThreads) us[t] = u[b * st.ub + h * st.uh + t];

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    // 1. the chunk's tiles, zero-filled (la = 0) past S
    for (int i = tid; i < kQ * hd; i += kThreads) {
      const int q = i / hd, t = i % hd;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (q < nq) {
        const long long s = c0 + q;
        rv = to_f(rb[s * st.rs + t]);
        kv = to_f(kb[s * st.ks + t]);
        vv = to_f(vb[s * st.vs + t]);
        lv = lb[s * st.ls + t];
      }
      rs[q * P + t] = rv;
      ks[q * P + t] = kv;
      vs[q * P + t] = vv;
      cs[q * P + t] = lv;
    }
    __syncthreads();
    // 2. cumulative log decay, one thread per channel
    for (int t = tid; t < hd; t += kThreads) {
      float acc = 0.f;
      for (int q = 0; q < kQ; ++q) {
        es[q * P + t] = acc;
        acc += cs[q * P + t];
        cs[q * P + t] = acc;
      }
    }
    __syncthreads();
    // 3. score tile: strictly causal pairs with their per-pair decay, the
    //    u bonus on the diagonal, 0 above it
    for (int p = tid; p < kQ * kQ; p += kThreads) {
      const int i = p / kQ, j = p % kQ;
      const float* ri = rs + i * P;
      float a = 0.f;
      if (j < i) {
        const float* ei = es + i * P;
        const float* kj = ks + j * P;
        const float* cj = cs + j * P;
        for (int t = 0; t < hd; ++t) a += ri[t] * kj[t] * expf(ei[t] - cj[t]);
      } else if (j == i) {
        const float* ki = ks + i * P;
        for (int t = 0; t < hd; ++t) a += ri[t] * us[t] * ki[t];
      }
      att[i * (kQ + 1) + j] = a;
    }
    __syncthreads();
    // 4a. r * exp(e) for the inter term, k * exp(c_last - c) for the state
    const float* clast = cs + (kQ - 1) * P;
    for (int i = tid; i < kQ * hd; i += kThreads) {
      const int q = i / hd, t = i % hd;
      rs[q * P + t] *= expf(es[q * P + t]);
      ks[q * P + t] *= expf(clast[t] - cs[q * P + t]);
    }
    __syncthreads();
    // 4b. outputs of the chunk's rows
    for (int o = tid; o < nq * hd; o += kThreads) {
      const int i = o / hd, c = o % hd;
      const float* ai = att + i * (kQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += ai[j] * vs[j * P + c];
      const float* ri = rs + i * P;
      float inter = 0.f;
      for (int t = 0; t < hd; ++t) inter += ri[t] * sts[t * P + c];
      yb[(long long)(c0 + i) * st.ys + c] = from_f<T>(acc + inter);
    }
    __syncthreads();
    // 5. carry the state to the end of the chunk
    for (int o = tid; o < hd * hd; o += kThreads) {
      const int t = o / hd, c = o % hd;
      float s = sts[t * P + c] * expf(clast[t]);
      for (int j = 0; j < nq; ++j) s += ks[j * P + t] * vs[j * P + c];
      sts[t * P + c] = s;
    }
    __syncthreads();
  }
  float* sfb = sf + (long long)blockIdx.x * hd * hd;
  for (int o = tid; o < hd * hd; o += kThreads)
    sfb[o] = sts[(o / hd) * P + o % hd];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* la, const float* u, void* y, float* sf,
                   const RwkvStrides& st, int B, int H, int S, int hd,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = set_smem(rwkv6_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  rwkv6_fwd<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), la, u, static_cast<T*>(y), sf, st, H, S, hd);
  return cudaGetLastError();
}

}  // namespace

// strides: 17 element strides in RwkvStrides order. la, u, sf are f32;
// r, k, v, y are f32 (dtype 0) or bf16 (dtype 1). sf [B, H, hd, hd]
// contiguous.
extern "C" int rwkv6_scan_fwd(int dtype, const void* r, const void* k,
                              const void* v, const void* la, const void* u,
                              void* y, void* sf, const long long* strides,
                              int B, int H, int S, int hd, void* stream) {
  if (B < 1 || H < 1 || S < 1 || hd < 1 || hd > kMaxHD)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  RwkvStrides st = {s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                    s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                    s[12], s[13], s[14], s[15], s[16]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* laf = static_cast<const float*>(la);
  const float* uf = static_cast<const float*>(u);
  float* sff = static_cast<float*>(sf);
  if (dtype == kF32)
    return launch<float>(r, k, v, laf, uf, y, sff, st, B, H, S, hd, cs);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(r, k, v, laf, uf, y, sff, st, B, H, S, hd,
                                 cs);
  return cudaErrorInvalidValue;
}
