// One-token decode attention over a dense slot cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:170 decode_attention (the
// Pallas TPU slot kernel _kernel). Same function: the G query heads of a
// kv head attend over the C cache slots of their row under a bool `valid`
// mask (ragged lengths, ring windows), with an online softmax in f32, the
// TPU kernel's -1e30 mask and 1e-30 denominator clamp, and the weights
// rounded to the cache dtype before the P.V product.
//
// What bounds it on the H100: bytes. A step must read the K and V rows of
// the valid slots once (2 * hd * sizeof(T) per slot per kv head) and does
// only 4 * G * hd FLOP per slot, about G FLOP per byte, far below the
// card's ~295 FLOP/byte balance point. So the design is about bytes in
// flight and SMs in use, not tensor cores.
//
// Design (decode_split.cuh): the KV walk is split across CTAs (flash-
// decoding). Grid (B * nkv, n_split); the wrapper picks n_split (2..8,
// about one CTA per SM) and the tile (64 slots at bf16 hd <= 128) from
// shapes alone, and deals tiles to splits round-robin, so a short prefix
// of a long cache still spreads over several CTAs. Each CTA reads its
// tiles' mask bytes as 16-byte vectors, lists the tiles holding a valid
// slot, and streams their K and V rows through a cp.async ring; a split
// with no valid slot reads only the mask. The splits of a row form a
// thread block cluster and merge their softmax states through distributed
// shared memory in split order (deterministic), within the one launch.
// The cache passes in the model's own [B, C, nkv, hd] layout through
// strides: no transposed copy is made.
//
// A row with no valid slot gets 0 here, where the plain version and the
// TPU kernel average V over the masked slots. No engine path passes such
// a row, because valid = slots <= pos (models/attention.py:205-211).
#include "decode_split.cuh"

using namespace rt;
using namespace rt::split;

namespace {

struct SlotStrides {
  long long kb, kh, kc;          // k [B, H, C, hd] (hd contiguous)
  long long vb, vh, vc;          // v [B, H, C, hd]
};

// Slot c of one (batch, kv head) row: visible when c < C and valid[c].
template <typename T>
struct SlotRows {
  const T* k;
  const T* v;
  long long kc, vc;
  const uint8_t* valid;
  int C;

  __device__ __forceinline__ bool row(int c, const T*& kr,
                                      const T*& vr) const {
    if (c >= C || !valid[c]) return false;
    kr = k + c * kc;
    vr = v + c * vc;
    return true;
  }

  // any valid byte among the tile's; the loads are OR-ed with no early
  // exit, so they are all in flight at once
  __device__ __forceinline__ bool tile_live(int t, int tile) const {
    const int c0 = t * tile, n = min(tile, C - c0);
    const uint8_t* p = valid + c0;
    unsigned any = 0;
    int i = 0;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll 8
      for (; i + 16 <= n; i += 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(p + i);
        any |= u.x | u.y | u.z | u.w;
      }
    }
    for (; i < n; ++i) any |= p[i];
    return any != 0;
  }
};

template <typename T, int GM, int VPL>
__global__ void __launch_bounds__(kThreads)
    decode_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ valid,
                 SlotStrides st, int C, T* __restrict__ o, Shape s) {
  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const SlotRows<T> rows{k + b * st.kb + h * st.kh,
                         v + b * st.vb + h * st.vh, st.kc, st.vc,
                         valid + (long long)b * C, C};
  const size_t gh = (size_t)s.G * s.hd;
  split_attend<T, GM, VPL>(rows, q + bh * gh, o + bh * gh, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o,
                   const SlotStrides& st, int B, int C, Shape s,
                   cudaStream_t stream) {
  const long long el = sizeof(T);
  s.copy_vec = s.hd % Vec<T>::W == 0 && aligned16(k) && aligned16(v) &&
               (st.kb * el) % 16 == 0 && (st.kh * el) % 16 == 0 &&
               (st.kc * el) % 16 == 0 && (st.vb * el) % 16 == 0 &&
               (st.vh * el) % 16 == 0 && (st.vc * el) % 16 == 0;
  return dispatch<T>(s, [&](auto gm, auto vpl) {
    constexpr int GM = decltype(gm)::value, VPL = decltype(vpl)::value;
    return launch_split<T>(decode_split<T, GM, VPL>, s, B, o, stream,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v),
                           static_cast<const uint8_t*>(valid), st, C);
  });
}

}  // namespace

// strides: 6 element strides in SlotStrides order; q/out contiguous
// [B, H, G, hd]; valid contiguous [B, C] bytes (torch.bool); tile and
// n_split from the wrapper's split plan.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* o, const long long* strides, int B,
                                    int H,
                                    int G, int C, int hd, int tile,
                                    int n_split, float scale, void* stream) {
  const int el = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
  Shape s;
  if (el == 0 || B < 1 || !make_shape(s, el, H, G, hd, C, tile, n_split,
                                      scale))
    return cudaErrorInvalidValue;
  const SlotStrides st = {strides[0], strides[1], strides[2],
                          strides[3], strides[4], strides[5]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, valid, o, st, B, C, s, cs);
  return launch<__nv_bfloat16>(q, k, v, valid, o, st, B, C, s, cs);
}
