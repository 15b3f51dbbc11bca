// One-token decode attention over a dense slot cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py : decode_attention (the
// Pallas TPU slot kernel _kernel). Same function: the G query heads of a
// kv head attend over the C cache slots of their row under a bool `valid`
// mask (ragged lengths, ring windows), with an online softmax in f32, the
// TPU kernel's -1e30 mask and 1e-30 denominator clamp, and the weights
// rounded to the cache dtype before the P.V product.
//
// What bounds it on the H100: bytes. Each step must read the K and V rows
// of the valid slots once (2 * hd * sizeof(T) per slot per kv head) and
// does only 4 * G * hd FLOP per slot, far below the card's ~295 FLOP/byte
// balance point.
//
// Design (right and simple first): one CTA per (batch, kv head); its four
// warps take interleaved tiles of 32 slots, each warp keeping its own
// online-softmax state for the G heads, and the warps' states are merged
// at the end (a split of C inside the CTA). The layout adapter passes the
// cache in the model's own [B, C, nkv, hd] layout through strides, so no
// transposed copy of the cache is made. A tile whose 32 valid bits are
// all clear is skipped without reading K or V, so a step reads only the
// filled part of the cache, not all C slots as the TPU kernel streams.
// Keys are read one row per warp (coalesced) and the dot products reduced
// with shuffles. With B = 1 and nkv = 8 this launches only 8 CTAs on 132
// SMs; splitting C across CTAs is the obvious next step.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 8;   // head_dim <= 256

struct DecodeStrides {
  long long kb, kh, kc;          // k [B, H, C, hd] (hd contiguous)
  long long vb, vh, vc;          // v [B, H, C, hd]
};

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)G * hd * (1 + kWarps) +
                          (size_t)kWarps * G * (32 + 2));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               T* __restrict__ o, DecodeStrides st, int H, int G, int C,
               int hd, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [G][hd]
  float* acc = qs + G * hd;               // [kWarps][G][hd]
  float* sc = acc + kWarps * G * hd;      // [kWarps][G][32] scores, then p
  float* ml = sc + kWarps * G * 32;       // [kWarps][G][2]  (m, l)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (long long)bh * G * hd;           // q [B, H, G, hd]
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const uint8_t* vrow = valid + (long long)b * C;      // valid [B, C]

  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f(qb[i]);
  for (int i = tid; i < kWarps * G * hd; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    ml[2 * i] = kNegInf;
    ml[2 * i + 1] = 0.f;
  }
  __syncthreads();

  float* accw = acc + warp * G * hd;
  float* scw = sc + warp * G * 32;
  float* mlw = ml + warp * G * 2;
  const int nper = (hd + 31) / 32;

  for (int c0 = warp * 32; c0 < C; c0 += kWarps * 32) {
    const int c = c0 + lane;
    const bool ok = c < C && vrow[c] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (mask == 0u) continue;
    // scores of the valid slots, one coalesced K row at a time
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const T* kr = kb + (long long)(c0 + j) * st.kc;
      float kd[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        kd[i] = (i < nper && d < hd) ? to_f(kr[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * hd;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int d = lane + 32 * i;
          if (i < nper && d < hd) part += qg[d] * kd[i];
        }
        part = warp_sum(part);
        if (lane == 0) scw[g * 32 + j] = part * scale;
      }
    }
    __syncwarp();
    // online-softmax update of this warp's state, per head
    for (int g = 0; g < G; ++g) {
      const float s = ok ? scw[g * 32 + lane] : kNegInf;
      const float m_prev = mlw[2 * g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      const float lsum = warp_sum(p);
      scw[g * 32 + lane] = round_to<T>(p);
      float* ag = accw + g * hd;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (i < nper && d < hd) ag[d] *= alpha;
      }
      __syncwarp();
      if (lane == 0) {
        mlw[2 * g] = m_new;
        mlw[2 * g + 1] = alpha * mlw[2 * g + 1] + lsum;
      }
      __syncwarp();
    }
    // P.V over the valid slots
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const T* vr = vb + (long long)(c0 + j) * st.vc;
      float vd[kMaxPerLane];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        vd[i] = (i < nper && d < hd) ? to_f(vr[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float p = scw[g * 32 + j];
        float* ag = accw + g * hd;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int d = lane + 32 * i;
          if (i < nper && d < hd) ag[d] += p * vd[i];
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // merge the warps' partial softmax states
  T* ob = o + (long long)bh * G * hd;                  // out [B, H, G, hd]
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml[(w * G + g) * 2]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ml[(w * G + g) * 2] - M);
      L += ml[(w * G + g) * 2 + 1] * f;
      A += acc[(w * G + g) * hd + d] * f;
    }
    ob[i] = from_f<T>(A / fmaxf(L, kMinDenom));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, const DecodeStrides& st,
                   int B, int H, int G, int C, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  cudaError_t err = set_smem(decode_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  decode_fwd<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), st, H, G, C, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 6 element strides in DecodeStrides order; q/out contiguous
// [B, H, G, hd]; valid contiguous [B, C] bytes (torch.bool).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* o, const long long* strides, int B,
                                    int H, int G, int C, int hd, float scale,
                                    void* stream) {
  if (hd < 1 || hd > 32 * kMaxPerLane || C < 1 || G < 1 ||
      smem_bytes(G, hd) > 227 * 1024)
    return cudaErrorInvalidValue;
  DecodeStrides st = {strides[0], strides[1], strides[2],
                      strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, valid, o, st, B, H, G, C, hd, scale, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, valid, o, st, B, H, G, C, hd,
                                 scale, s);
  return cudaErrorInvalidValue;
}
