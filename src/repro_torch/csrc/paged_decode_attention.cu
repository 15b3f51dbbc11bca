// One-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py : paged_decode_attention
// (the Pallas TPU kernel _paged_kernel). Same function: the G query heads
// of a kv head attend over their slot's logical positions, which live in
// pool blocks named by the slot's row of the block table. Logical position
// c = j * bs + off is visible when c <= pos[b] and block_tables[b, j] < P
// (P, one past the pool, is the unassigned sentinel). Online softmax in
// f32, the TPU kernel's -1e30 mask and 1e-30 denominator clamp, and the
// weights rounded to the pool dtype before the P.V product.
//
// What bounds it on the H100: bytes. A step must read the K and V rows of
// the slot's visible positions once (2 * hd * sizeof(T) per position per
// kv head) and does only 4 * G * hd FLOP per position, far below the
// card's ~295 FLOP/byte balance point.
//
// Design (right and simple first): the slot kernel of decode_attention.cu
// with its `valid` bit replaced by the block-table lookup and the position
// test. One CTA per (slot, kv head) walks its slot's logical positions in
// tiles of 32 (two blocks at bs = 16), its four warps taking interleaved
// tiles, each warp keeping its own online-softmax state for the G heads;
// the warps' states are merged at the end. Each lane looks up the physical
// block of its position in the table; a position past pos[b] or behind a
// sentinel entry is masked, and the loop stops at pos[b], so blocks past
// the slot's position and sentinel blocks are never read. Only the slot's
// own blocks are read: the pool is never gathered into a dense copy. A key
// row is read once for all G query heads (the GQA fold), one coalesced row
// per warp, and the dot products reduced with shuffles.
//
// A slot whose every entry is a sentinel (a retired row riding a chunk)
// gets a zero output here, where the TPU kernel averages V over the
// clipped block; the engine discards those rows.
//
// Next step: split each slot's block list across CTAs (flash-decoding) and
// merge the partial softmax states in a second pass. At 8 slots this
// kernel launches B * nkv = 64 CTAs on the card's 132 SMs.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 8;   // head_dim <= 256

struct PagedStrides {
  long long kp, ks, kh;          // k_pool [P, bs, H, hd] (hd contiguous)
  long long vp, vs, vh;          // v_pool [P, bs, H, hd]
};

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)G * hd * (1 + kWarps) +
                          (size_t)kWarps * G * (32 + 2));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ pos, T* __restrict__ o,
                     PagedStrides st, int H, int G, int P, int bs, int n_bt,
                     int hd, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [G][hd]
  float* acc = qs + G * hd;               // [kWarps][G][hd]
  float* sc = acc + kWarps * G * hd;      // [kWarps][G][32] scores, then p
  float* ml = sc + kWarps * G * 32;       // [kWarps][G][2]  (m, l)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (long long)bh * G * hd;           // q [B, H, G, hd]
  const T* kb = k + h * st.kh;
  const T* vb = v + h * st.vh;
  const int* bt = block_tables + (long long)b * n_bt;  // [B, n_bt]
  // positions 0 .. pos[b] are visible; the loop ends there
  const int end = min(n_bt * bs, pos[b] + 1);

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

  for (int c0 = warp * 32; c0 < end; c0 += kWarps * 32) {
    const int c = c0 + lane;
    // this lane's position -> physical block; sentinels (>= P) are masked
    const int blk = c < end ? bt[c / bs] : P;
    const bool ok = c < end && (unsigned)blk < (unsigned)P;
    const int row = c % bs;                         // row inside the block
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (mask == 0u) continue;
    // scores of the visible positions, one coalesced K row at a time
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const int bj = __shfl_sync(0xffffffffu, blk, j);
      const int rj = __shfl_sync(0xffffffffu, row, j);
      const T* kr = kb + (long long)bj * st.kp + (long long)rj * st.ks;
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
    // P.V over the visible positions
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const int bj = __shfl_sync(0xffffffffu, blk, j);
      const int rj = __shfl_sync(0xffffffffu, row, j);
      const T* vr = vb + (long long)bj * st.vp + (long long)rj * st.vs;
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
                   const void* block_tables, const void* pos, void* o,
                   const PagedStrides& st, int B, int H, int G, int P,
                   int bs, int n_bt, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  cudaError_t err = set_smem(paged_decode_fwd<T>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_fwd<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(block_tables),
      static_cast<const int*>(pos), static_cast<T*>(o), st, H, G, P, bs,
      n_bt, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 6 element strides in PagedStrides order; q/out contiguous
// [B, H, G, hd]; block_tables contiguous int32 [B, n_bt]; pos int32 [B].
extern "C" int paged_decode_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* block_tables, const void* pos, void* o,
    const long long* strides, int B, int H, int G, int P, int bs, int n_bt,
    int hd, float scale, void* stream) {
  if (hd < 1 || hd > 32 * kMaxPerLane || G < 1 || P < 1 || bs < 1 ||
      n_bt < 1 || smem_bytes(G, hd) > 227 * 1024)
    return cudaErrorInvalidValue;
  PagedStrides st = {strides[0], strides[1], strides[2],
                     strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, block_tables, pos, o, st, B, H, G, P, bs,
                         n_bt, hd, scale, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, block_tables, pos, o, st, B, H, G,
                                 P, bs, n_bt, hd, scale, s);
  return cudaErrorInvalidValue;
}
