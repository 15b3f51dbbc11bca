// One-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:114 paged_decode_attention
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
// kv head) and does only 4 * G * hd FLOP per position, about G FLOP per
// byte, far below the card's ~295 FLOP/byte balance point.
//
// Design (decode_split.cuh): the slot kernel's split-KV walk with its
// `valid` byte replaced by the block-table lookup and the position test.
// Grid (B * nkv, n_split), n_split from shapes (2..8); a tile is the
// smallest multiple of bs that holds 64 positions (4 blocks at bs = 16,
// bf16 hd <= 128), dealt to splits round-robin. Each CTA reads pos[b] and
// its tiles' table entries itself (the TPU kernel's scalar prefetch),
// lists the tiles that hold a visible position, and streams their rows
// through a cp.async ring, each row's address computed from its own table
// entry: a tile may straddle sentinel blocks, so rows are masked one by
// one, and a masked row is zero-filled without a read. Blocks past pos[b]
// and sentinel blocks are never read, and the pool is never gathered into
// a dense copy. The splits of a slot form a thread block cluster and merge
// through distributed shared memory in split order.
//
// The slot kernel returns 0 for a row with no valid slot, where the plain
// version and the TPU kernel average V; no engine path passes such a row,
// because valid = slots <= pos (models/attention.py:205-211).
//
// A slot whose every entry is a sentinel (a retired row riding a chunk)
// gets 0 here, where the TPU kernel averages V over the clipped block; the
// engine discards those rows.
#include "decode_split.cuh"

using namespace rt;
using namespace rt::split;

namespace {

struct PagedStrides {
  long long kp, ks, kh;          // k_pool [P, bs, H, hd] (hd contiguous)
  long long vp, vs, vh;          // v_pool [P, bs, H, hd]
};

// Logical position c of one (slot, kv head) row: visible when c < end
// (= min(n_bt * bs, pos + 1)) and its table entry is not a sentinel.
template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  long long kp, ks, vp, vs;
  const int* bt;
  int P, bs, end;

  __device__ __forceinline__ bool row(int c, const T*& kr,
                                      const T*& vr) const {
    if (c >= end) return false;
    const int blk = bt[c / bs];
    if ((unsigned)blk >= (unsigned)P) return false;
    const int off = c - (c / bs) * bs;
    kr = k + blk * kp + off * ks;
    vr = v + blk * vp + off * vs;
    return true;
  }

  // any non-sentinel entry among the tile's blocks before `end`; the
  // loads are OR-ed with no early exit, so they are all in flight at once
  __device__ __forceinline__ bool tile_live(int t, int tile) const {
    const int c0 = t * tile;
    if (c0 >= end) return false;
    const int c1 = min(end, c0 + tile) - 1;
    bool any = false;
#pragma unroll 4
    for (int j = c0 / bs; j <= c1 / bs; ++j)
      any |= (unsigned)bt[j] < (unsigned)P;
    return any;
  }
};

template <typename T, int GM, int VPL>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ pos, PagedStrides st, int P,
                       int bs, int n_bt, T* __restrict__ o, Shape s) {
  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int p = pos[b], n_pos = n_bt * bs;
  const PagedRows<T> rows{k + h * st.kh, v + h * st.vh, st.kp, st.ks,
                          st.vp, st.vs, block_tables + (long long)b * n_bt,
                          P, bs, p >= n_pos ? n_pos : p + 1};
  const size_t gh = (size_t)s.G * s.hd;
  split_attend<T, GM, VPL>(rows, q + bh * gh, o + bh * gh, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* block_tables, const void* pos, void* o,
                   const PagedStrides& st, int B, int P, int bs, int n_bt,
                   Shape s, cudaStream_t stream) {
  const long long el = sizeof(T);
  s.copy_vec = s.hd % Vec<T>::W == 0 && aligned16(k) && aligned16(v) &&
               (st.kp * el) % 16 == 0 && (st.ks * el) % 16 == 0 &&
               (st.kh * el) % 16 == 0 && (st.vp * el) % 16 == 0 &&
               (st.vs * el) % 16 == 0 && (st.vh * el) % 16 == 0;
  return dispatch<T>(s, [&](auto gm, auto vpl) {
    constexpr int GM = decltype(gm)::value, VPL = decltype(vpl)::value;
    return launch_split<T>(paged_decode_split<T, GM, VPL>, s, B, o, stream,
                           static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const int*>(block_tables),
                           static_cast<const int*>(pos), st, P, bs, n_bt);
  });
}

}  // namespace

// strides: 6 element strides in PagedStrides order; q/out contiguous
// [B, H, G, hd]; block_tables contiguous int32 [B, n_bt]; pos int32 [B];
// tile and n_split from the wrapper's split plan.
extern "C" int paged_decode_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* block_tables, const void* pos, void* o,
    const long long* strides, int B, int H, int G, int P, int bs, int n_bt,
    int hd, int tile, int n_split, float scale, void* stream) {
  const int el = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
  Shape s;
  if (el == 0 || B < 1 || P < 1 || bs < 1 || n_bt < 1 ||
      (long long)n_bt * bs > (1LL << 30) ||
      !make_shape(s, el, H, G, hd, n_bt * bs, tile, n_split, scale))
    return cudaErrorInvalidValue;
  const PagedStrides st = {strides[0], strides[1], strides[2],
                           strides[3], strides[4], strides[5]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, block_tables, pos, o, st, B, P, bs, n_bt,
                         s, cs);
  return launch<__nv_bfloat16>(q, k, v, block_tables, pos, o, st, B, P, bs,
                               n_bt, s, cs);
}
