// Mamba2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/ssd_scan.py : ssd_scan (the Pallas TPU kernel
// _kernel). Same function, per (batch, head), from a zero state:
//
//   S_t = exp(a_t) S_{t-1} + dt_t x_t B_t^T           S in R^{hd x ds}
//   y_t = S_t C_t
//
// returning y (in x's dtype) and the final f32 state; D x stays outside,
// as in both JAX versions. Inputs are read as f32 and every product, sum
// and score is f32 (the TPU kernel keeps its scores f32 too); y is rounded
// once at the end.
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
// length does not change the result.
//
// Layout. B and C are one [S, ds] row per batch row, shared by all heads:
// the wrapper passes them with a head stride of 0, so they are never
// materialised per head.
//
// What bounds it on the H100: at the serving path's prefill (BH = 112,
// S <= 128, hd = ds = 64) a call reads x (bf16), dt, a (f32), B and C and
// writes y and a 16 KB state per head: about 5 MB, ~1.5 us at 3.35 TB/s;
// its FLOPs (about 2 S (Q hd + Q ds + 2 hd ds) per head) are tens of MFLOP.
// So bytes bound it on paper; a call this small is bound by the latency
// of its sequential chunk chain.
//
// Design (right and simple first): one CTA of 256 threads per (batch,
// head) walks the chunks in order, the TPU kernel's sequential grid axis.
// The [hd, ds] f32 state lives in shared memory (16 KB at 64 x 64), as do
// the chunk's x, B, C tiles and the [Q, Q] score tile, which never reaches
// device memory (VMEM held it on the TPU). Rows are padded to an odd
// number of floats so a warp reading one column hits 32 banks. Scalar f32
// FMAs; wgmma, TMA and splitting hd across CTAs are later work.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kQ = 64;           // tokens per chunk
constexpr int kMaxHD = 64;
constexpr int kMaxDS = 64;
constexpr int kThreads = 256;

struct SsdStrides {
  long long xb, xh, xs;          // x  [B, H, S, hd]
  long long db, dh, ds;          // dt [B, H, S]
  long long ab, ah, as;          // a  [B, H, S]
  long long bb, bh, bs;          // Bm [B, H, S, ds]
  long long cb, ch, cs;          // Cm [B, H, S, ds]
  long long yb, yh, ys;          // y  [B, H, S, hd]
};

size_t smem_bytes(int hd, int ds) {
  const size_t PX = hd + 1, PB = ds + 1;
  return sizeof(float) * (kQ * PX + 2 * kQ * PB + (size_t)kQ * (kQ + 1) +
                          (size_t)hd * PB + 3 * kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ Bm,
            const T* __restrict__ Cm, T* __restrict__ y,
            float* __restrict__ sf, SsdStrides st, int H, int S, int hd,
            int ds) {
  extern __shared__ float smem[];
  const int PX = hd + 1, PB = ds + 1;
  float* xs = smem;                  // [kQ][PX]
  float* bsm = xs + kQ * PX;         // [kQ][PB]
  float* csm = bsm + kQ * PB;        // [kQ][PB]
  float* sc = csm + kQ * PB;         // [kQ][kQ + 1]  scores
  float* sts = sc + kQ * (kQ + 1);   // [hd][PB]      state S[p][s]
  float* cum = sts + hd * PB;        // [kQ]
  float* dts = cum + kQ;             // [kQ]
  float* w = dts + kQ;               // [kQ]  dt_j exp(cum_last - cum_j)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const T* xb = x + b * st.xb + h * st.xh;
  const float* db = dt + b * st.db + h * st.dh;
  const float* ab = a + b * st.ab + h * st.ah;
  const T* bb = Bm + b * st.bb + h * st.bh;
  const T* cb = Cm + b * st.cb + h * st.ch;
  T* yb = y + b * st.yb + h * st.yh;

  for (int i = tid; i < hd * PB; i += kThreads) sts[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    // 1. the chunk's tiles, zero-filled (a = dt = 0) past S
    for (int i = tid; i < kQ * hd; i += kThreads) {
      const int q = i / hd, p = i % hd;
      xs[q * PX + p] =
          q < nq ? to_f(xb[(long long)(c0 + q) * st.xs + p]) : 0.f;
    }
    for (int i = tid; i < kQ * ds; i += kThreads) {
      const int q = i / ds, s = i % ds;
      float bv = 0.f, cv = 0.f;
      if (q < nq) {
        bv = to_f(bb[(long long)(c0 + q) * st.bs + s]);
        cv = to_f(cb[(long long)(c0 + q) * st.cs + s]);
      }
      bsm[q * PB + s] = bv;
      csm[q * PB + s] = cv;
    }
    for (int q = tid; q < kQ; q += kThreads) {
      dts[q] = q < nq ? db[(long long)(c0 + q) * st.ds] : 0.f;
      cum[q] = q < nq ? ab[(long long)(c0 + q) * st.as] : 0.f;
    }
    __syncthreads();
    // 2. inclusive cumulative log decay
    if (tid == 0) {
      float acc = 0.f;
      for (int q = 0; q < kQ; ++q) {
        acc += cum[q];
        cum[q] = acc;
      }
    }
    __syncthreads();
    // 3. causal score tile, and the state weights of the chunk's rows
    const float clast = cum[kQ - 1];
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
    for (int q = tid; q < kQ; q += kThreads)
      w[q] = dts[q] * expf(clast - cum[q]);
    __syncthreads();
    // 4. outputs of the chunk's rows
    for (int o = tid; o < nq * hd; o += kThreads) {
      const int i = o / hd, p = o % hd;
      const float* si = sc + i * (kQ + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += si[j] * xs[j * PX + p];
      const float* ci = csm + i * PB;
      const float* sp = sts + p * PB;
      float inter = 0.f;
      for (int s = 0; s < ds; ++s) inter += ci[s] * sp[s];
      yb[(long long)(c0 + i) * st.ys + p] =
          from_f<T>(acc + expf(cum[i]) * inter);
    }
    __syncthreads();
    // 5. carry the state to the end of the chunk
    const float dec = expf(clast);
    for (int o = tid; o < hd * ds; o += kThreads) {
      const int p = o / ds, s = o % ds;
      float v = sts[p * PB + s] * dec;
      for (int j = 0; j < nq; ++j) v += w[j] * xs[j * PX + p] * bsm[j * PB + s];
      sts[p * PB + s] = v;
    }
    __syncthreads();
  }
  float* sfb = sf + (long long)blockIdx.x * hd * ds;
  for (int o = tid; o < hd * ds; o += kThreads)
    sfb[o] = sts[(o / ds) * PB + o % ds];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* Bm, const void* Cm, void* y, float* sf,
                   const SsdStrides& st, int B, int H, int S, int hd, int ds,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, ds);
  cudaError_t err = set_smem(ssd_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), sf, st, H, S, hd, ds);
  return cudaGetLastError();
}

}  // namespace

// strides: 18 element strides in SsdStrides order. dt, a, sf are f32;
// x, Bm, Cm, y are f32 (dtype 0) or bf16 (dtype 1). sf [B, H, hd, ds]
// contiguous.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* a, const void* Bm, const void* Cm,
                            void* y, void* sf, const long long* strides,
                            int B, int H, int S, int hd, int ds,
                            void* stream) {
  if (B < 1 || H < 1 || S < 1 || hd < 1 || hd > kMaxHD || ds < 1 ||
      ds > kMaxDS)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  SsdStrides st = {s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                   s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                   s[12], s[13], s[14], s[15], s[16], s[17]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sff = static_cast<float*>(sf);
  if (dtype == kF32)
    return launch<float>(x, dtf, af, Bm, Cm, y, sff, st, B, H, S, hd, ds, cs);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dtf, af, Bm, Cm, y, sff, st, B, H, S, hd,
                                 ds, cs);
  return cudaErrorInvalidValue;
}
