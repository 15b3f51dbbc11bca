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
// What bounds it on the H100: at the serving path's prefill shapes
// (S = 16..128, hd = 128, G = 2, bf16) a call moves well under a megabyte
// and does a few tens of MFLOP, so its floor is set by the bytes of q, k,
// v and out; in practice a call this small is bound by launch and latency.
//
// Design (right and simple first): one CTA per (batch * kv head, tile of
// BQ query positions), all G heads of the group folded into the CTA's rows
// so each K/V tile is read once for the whole group (the TPU kernel's GQA
// fold). A loop over key tiles of 32 keys -- one key per lane for the
// scores -- takes the place of the TPU's sequential KV grid axis; tiles
// wholly above the causal diagonal or outside the window are skipped. The
// kernel masks the ragged edge itself, so it takes any S (the TPU kernel
// needed S to be a multiple of its block). Products are scalar f32 FMAs
// from shared memory; wgmma, TMA and split-KV are later work.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kBK = 32;          // keys per tile: one per lane
constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxPerLane = 8;   // head_dim <= 256

struct FlashStrides {
  long long qb, qh, qg, qs;      // q   [B, H, G, S, hd]
  long long kb, kh, ks;          // k   [B, H, S, hd]
  long long vb, vh, vs;          // v   [B, H, S, hd]
  long long ob, oh, og, os;      // out [B, H, G, S, hd]
};

size_t smem_bytes(int rows, int hd) {
  return sizeof(float) *
         (2 * (size_t)rows * hd + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
          2 * (size_t)rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const FlashStrides& st, int B, int H, int G, int S, int hd,
                   int causal, int window, float scale, cudaStream_t stream) {
  int BQ = 16;
  while (BQ > 1 && smem_bytes(G * BQ, hd) > 200 * 1024) BQ /= 2;
  const size_t smem = smem_bytes(G * BQ, hd);
  cudaError_t err = set_smem(flash_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, G, S, hd, BQ,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 14 element strides in FlashStrides order. window <= 0: none.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int G, int S, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (hd < 1 || hd > 32 * kMaxPerLane || S < 1 || G < 1)
    return cudaErrorInvalidValue;
  FlashStrides st = {strides[0],  strides[1],  strides[2], strides[3],
                     strides[4],  strides[5],  strides[6], strides[7],
                     strides[8],  strides[9],  strides[10], strides[11],
                     strides[12], strides[13]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, o, st, B, H, G, S, hd, causal, window,
                         scale, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, st, B, H, G, S, hd, causal,
                                 window, scale, s);
  return cudaErrorInvalidValue;
}
