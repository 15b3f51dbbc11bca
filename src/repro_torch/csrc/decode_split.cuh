// The split-KV walk shared by the slot and the paged decode kernels.
//
// Grid (B * nkv, n_split): the CTAs of one (batch, kv head) row walk the
// tiles of `tile` positions that the split plan deals them (tile t goes to
// split t % n_split, so a short prefix lands on several CTAs) and form one
// thread block cluster. A `Rows` policy maps a logical position to its K
// and V rows and says whether it is visible; the slot kernel reads a bool
// mask, the paged kernel a block table and pos.
//
//  1. Warp 0 lists the CTA's tiles that hold a visible position (the mask
//     or the table and pos only, all loads in flight at once), in order.
//     A CTA with none reads nothing else and merges an empty state
//     (m = -1e30, l = 0).
//  2. Those tiles stream through a ring of 3 stages (2 where shared memory
//     is short) with 16-byte cp.async copies, so the next tiles load while
//     this one computes. Each row's visibility and offsets are fetched one
//     tile ahead, one thread per row, into registers. An invisible row is
//     zero-filled without a global read. A head_dim that is not a multiple
//     of the 16-byte vector, or a view that is not 16-byte aligned, takes
//     an element-wise copy of the same tile, zero-padded to the vector
//     width; the compute stays the same.
//  3. Each thread owns 16-byte slices of hd (8 bf16 or 4 f32 values; two
//     slices for f32 above hd 128), `lpr` lanes a row. Each warp keeps its
//     own online softmax over its rows in registers: kU rows per row group
//     at a time, their dot products reduced in log2(lpr) shuffles, the
//     max and sum over the warp's row groups, p rounded to T, and P.V from
//     shared memory into per-thread accumulators. No block barrier sits
//     inside a tile but the stage's own.
//  4. The warps' states merge once through shared memory (in warp order),
//     then the cluster's splits through distributed shared memory: each
//     split writes its share of the G * hd outputs, reading every split's
//     (m, l, acc) in split order, so results are deterministic:
//     out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30).
//     An empty split adds nothing; a row with no visible position gets 0.
//     The cluster merge was chosen over a second kernel on an f32 scratch:
//     it saves that launch, which measured slower than the cluster's
//     barriers and remote reads on the H100 at batch 1, and the scratch.
//     Clusters stay within the portable 8 CTAs.
//
// Why this shape: at G <= 8 query rows a kv head, decode does about G FLOP
// per byte of K and V, far below the card's balance point, so bytes in
// flight and SMs in use matter, and tensor cores do not. Measured on the
// H100 (tools/decode_split_probe.py), a tile's time is set by the
// instructions it issues, not its bytes, so the walk keeps integer
// division, runtime modulo and accurate expf out of the per-tile path
// (__expf is ex2.approx: a relative error near 1e-6 for these arguments).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace rt {
namespace split {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;   // 3 where shared memory allows, else 2
constexpr int kMaxTile = 128;
constexpr int kMaxSplit = 8;    // SPLIT_MAX of kernels/decode_attention.py
constexpr int kMaxG = 16;
constexpr int kU = 4;           // rows per row group per pass
static_assert(kThreads >= kMaxTile, "one thread per row of a tile");

struct Shape {
  int H, G, hd;
  int hdp;      // hd rounded up to the vector width (shared-memory pitch)
  int nv;       // 16-byte vectors per row
  int vpl;      // vectors per lane (1, or 2 for f32 above hd 128)
  int lpr;      // lanes per row: a power of two <= 32
  int tile, n_tiles, n_split;
  int stages;   // depth of the cp.async ring
  int copy_vec; // 1: cp.async 16-byte copies; 0: element-wise copies
  float scale;
};

// The ring [stages][K, V][tile][hdp] T, which this split's acc [G][hd]
// f32 reuses after the walk; 16-byte multiple.
__host__ __device__ inline size_t ring_bytes(const Shape& s, size_t el) {
  const size_t ring = (size_t)s.stages * 2 * s.tile * s.hdp * el;
  const size_t part = ((size_t)s.G * s.hd * 4 + 15) / 16 * 16;
  return ring > part ? ring : part;
}

// the ring, row offsets [stages + 1][K, V][tile] i64, red [kWarps][G][hdp]
// f32, ml [G][2] f32, the warps' (m, l) [kWarps][G][2] f32,
// vis [stages + 1][tile] i32, the CTA's tile list i32
inline size_t smem_bytes(const Shape& s, size_t el) {
  const size_t ring = ring_bytes(s, el);
  const size_t offs = (size_t)(s.stages + 1) * 2 * s.tile * 8;
  const size_t floats = (size_t)kWarps * s.G * s.hdp + 2 * (size_t)s.G +
                        2 * (size_t)kWarps * s.G;
  const size_t ints = (size_t)(s.stages + 1) * s.tile +
                      (s.n_tiles + s.n_split - 1) / s.n_split;
  return ring + offs + 4 * (floats + ints);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Fill `s` for one launch; false when the kernel does not take the shape.
inline bool make_shape(Shape& s, int el, int H, int G, int hd, int n_pos,
                       int tile, int n_split, float scale) {
  if (hd < 1 || hd > 256 || G < 1 || G > kMaxG || H < 1 || n_pos < 1 ||
      tile < 1 || tile > kMaxTile || n_split < 1 || n_split > kMaxSplit)
    return false;
  const int W = 16 / el;
  s.H = H;
  s.G = G;
  s.hd = hd;
  s.hdp = (hd + W - 1) / W * W;
  s.nv = s.hdp / W;
  s.vpl = s.nv > 32 ? 2 : 1;
  const int need = (s.nv + s.vpl - 1) / s.vpl;
  s.lpr = 1;
  while (s.lpr < need) s.lpr <<= 1;
  s.tile = tile;
  s.n_tiles = (n_pos + tile - 1) / tile;
  s.n_split = n_split;
  s.copy_vec = 0;
  s.scale = scale;
  for (s.stages = kMaxStages; s.stages >= 2; --s.stages)
    if (smem_bytes(s, el) <= 227 * 1024) return true;
  return false;
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int W = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int W = 8; };

// 16 bytes of shared memory as W floats
__device__ __forceinline__ void vec_to_f(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void vec_to_f(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // bf16 -> f32 is a 16-bit shift
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16-byte async copy; with ok = false it writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x % m for the ring sizes (2, 3 or 4) without a runtime division
__device__ __forceinline__ int wrap(int x, int m) {
  return m == 3 ? x % 3 : x & (m - 1);
}

// The walk of one (batch * kv head, split): blockIdx.y is the split and
// the CTA's rank in its cluster. `qb` / `ob`: this row's [G, hd].
template <typename T, int GM, int VPL, class Rows>
__device__ __forceinline__ void split_attend(
    const Rows& rows, const T* __restrict__ qb, T* __restrict__ ob,
    const Shape& s) {
  constexpr int W = Vec<T>::W;
  constexpr int E = W * VPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_mine;
  const int tile = s.tile, hdp = s.hdp, G = s.G, hd = s.hd, nv = s.nv;
  const int stages = s.stages, slots = s.stages + 1;
  const size_t st_elems = (size_t)tile * hdp;
  T* ring = reinterpret_cast<T*>(smem_raw);
  long long* offs =
      reinterpret_cast<long long*>(smem_raw + ring_bytes(s, sizeof(T)));
  float* red = reinterpret_cast<float*>(offs + slots * 2 * tile);
  float* ml = red + kWarps * G * hdp;
  float* wml = ml + 2 * G;
  int* vis = reinterpret_cast<int*>(wml + 2 * kWarps * G);
  int* list = vis + slots * tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y;
  const int lpr = s.lpr, slice = tid & (lpr - 1), rg = tid / lpr;
  const int RG = kThreads / lpr;
  // the copies: thread -> (row cr0 + k * crs, unit cu) of a tile, a unit
  // being a 16-byte vector (or one element on the element-wise path)
  const int units = s.copy_vec ? nv : hdp;
  const int crs = kThreads / units, cu = tid % units, cr0 = tid / units;

  // 1. the tiles dealt to this split that hold a visible position
  if (warp == 0) {
    int n = 0;
    for (int t0 = split; t0 < s.n_tiles; t0 += 32 * s.n_split) {
      const int t = t0 + lane * s.n_split;
      const bool live = t < s.n_tiles && rows.tile_live(t, tile);
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(m & ((1u << lane) - 1u))] = t;
      n += __popc(m);
    }
    if (lane == 0) n_mine = n;
  }
  float qr[GM][E], acc[GM][E], mw[GM], lw[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    mw[g] = kNegInf;
    lw[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int d = (slice + v * lpr) * W + e;
        qr[g][v * W + e] = (g < G && d < hd) ? to_f(qb[g * hd + d]) : 0.f;
        acc[g][v * W + e] = 0.f;
      }
  }
  __syncthreads();
  const int n = n_mine;

  // 2. per-row metadata of tile list[i] (thread r owns row r, since
  // kThreads >= kMaxTile): visibility and K / V offsets, loaded into
  // registers one iteration ahead and stored in slot i % slots
  bool m_ok = false;
  long long m_ko = 0, m_vo = 0;
  auto meta_load = [&](int i) {
    m_ok = false;
    if (i < n && tid < tile) {
      const T* kr = rows.k;
      const T* vr = rows.v;
      m_ok = rows.row(list[i] * tile + tid, kr, vr);
      m_ko = m_ok ? kr - rows.k : 0;
      m_vo = m_ok ? vr - rows.v : 0;
    }
  };
  auto meta_store = [&](int i) {
    if (i < n && tid < tile) {
      const int sl = wrap(i, slots);
      vis[sl * tile + tid] = m_ok;
      offs[sl * 2 * tile + tid] = m_ko;
      offs[sl * 2 * tile + tile + tid] = m_vo;
    }
  };
  // the copies of tile list[i] into stage i % stages (its metadata is in
  // shared memory); always commits a group, so the wait below has a
  // constant count of groups in flight
  auto issue = [&](int i) {
    if (i < n && cr0 < crs) {
      const int sl = wrap(i, slots);
      T* ks = ring + (size_t)wrap(i, stages) * 2 * st_elems;
      T* vs = ks + st_elems;
      const int* vst = vis + sl * tile;
      const long long* ko = offs + sl * 2 * tile;
      const long long* vo = ko + tile;
      if (s.copy_vec) {
        for (int r = cr0; r < tile; r += crs) {
          const bool ok = vst[r] != 0;
          cp_async16(ks + r * hdp + cu * W, rows.k + ko[r] + cu * W, ok);
          cp_async16(vs + r * hdp + cu * W, rows.v + vo[r] + cu * W, ok);
        }
      } else {
        const T zero = from_f<T>(0.f);
        for (int r = cr0; r < tile; r += crs) {
          const bool in = vst[r] != 0 && cu < hd;
          ks[r * hdp + cu] = in ? rows.k[ko[r] + cu] : zero;
          vs[r * hdp + cu] = in ? rows.v[vo[r] + cu] : zero;
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < stages; ++j) {
    meta_load(j);
    meta_store(j);
  }
  __syncthreads();
  for (int j = 0; j < stages - 1; ++j) issue(j);
  for (int i = 0; i < n; ++i) {
    issue(i + stages - 1);
    meta_load(i + stages);           // lands while this tile computes
    if (stages == 3)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();
    const T* ks = ring + (size_t)wrap(i, stages) * 2 * st_elems;
    const T* vs = ks + st_elems;
    const int* vst = vis + wrap(i, slots) * tile;

    // 3. kU rows per row group at a time (a 64-row tile in one pass at
    // bf16 hd 128): scores (dot products reduced over the row's lpr
    // lanes), the warp's online softmax over its rows (max and sum
    // reduced over the warp's row groups), then P.V with p rounded to T.
    // Masked rows have p = 0 and zero-filled K and V. The kU * G dot
    // products are independent chains, so their latencies overlap.
    for (int r0 = 0; r0 < tile; r0 += kU * RG) {
      float sco[kU][GM];
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * RG + rg;
        ok[u] = r < tile && vst[r] != 0;
        float kf[E];
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vi = slice + v * lpr;
          if (r < tile && vi < nv) {
            vec_to_f(ks + r * hdp + vi * W, kf + v * W);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e) kf[v * W + e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) a += qr[g][e] * kf[e];
          sco[u][g] = a;
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sco[u][g] += __shfl_xor_sync(0xffffffffu, sco[u][g], o);
      float mt[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        mt[g] = kNegInf;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          sco[u][g] = ok[u] ? sco[u][g] * s.scale : kNegInf;
          mt[g] = fmaxf(mt[g], sco[u][g]);
        }
      }
      for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          mt[g] = fmaxf(mt[g], __shfl_xor_sync(0xffffffffu, mt[g], o));
      float ps[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float m_new = fmaxf(mw[g], mt[g]);
        const float alpha = __expf(mw[g] - m_new);
        mw[g] = m_new;
        lw[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        ps[g] = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = ok[u] ? __expf(sco[u][g] - m_new) : 0.f;
          ps[g] += p;
          sco[u][g] = round_to<T>(p);
        }
      }
      for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          ps[g] += __shfl_xor_sync(0xffffffffu, ps[g], o);
#pragma unroll
      for (int g = 0; g < GM; ++g) lw[g] += ps[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * RG + rg;
        if (r >= tile) break;
        float vf[E];
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vi = slice + v * lpr;
          if (vi < nv) {
            vec_to_f(vs + r * hdp + vi * W, vf + v * W);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e) vf[v * W + e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += sco[u][g] * vf[e];
      }
    }
    meta_store(i + stages);          // its slot last served tile i - 1
    __syncthreads();                 // stage i % stages is refilled next
  }

  // 4. merge the warps: each warp's acc summed over its row groups by
  // shuffles, scaled to the CTA's max, and summed in warp order through
  // shared memory
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      for (int o = lpr; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        wml[(warp * G + g) * 2] = mw[g];
        wml[(warp * G + g) * 2 + 1] = lw[g];
      }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wml[(w * G + tid) * 2]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      L += wml[(w * G + tid) * 2 + 1] * __expf(wml[(w * G + tid) * 2] - M);
    ml[2 * tid] = M;
    ml[2 * tid + 1] = L;
  }
  __syncthreads();
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float f = __expf(mw[g] - ml[2 * g]);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = slice + v * lpr;
        if (vi < nv)
#pragma unroll
          for (int e = 0; e < W; ++e)
            red[(warp * G + g) * hdp + vi * W + e] = acc[g][v * W + e] * f;
      }
    }
  }
  __syncthreads();
  // this split's acc [G][hd] goes where the ring was
  float* part = reinterpret_cast<float*>(smem_raw);
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * G + g) * hdp + d];
    if (s.n_split == 1)
      ob[i] = from_f<T>(a / fmaxf(ml[2 * g + 1], kMinDenom));
    else
      part[i] = a;
  }
  if (s.n_split == 1) return;

  // 5. merge the cluster's partials through distributed shared memory:
  // each split writes its share of the G * hd outputs, reading every
  // split's (m, l, acc) in split order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_split = s.n_split;
  const int share = (G * hd + n_split - 1) / n_split;
  for (int i = split * share + tid; i < min(G * hd, (split + 1) * share);
       i += kThreads) {
    const int g = i / hd;
    float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < n_split) {
        const float* rml = cluster.map_shared_rank(ml, r);
        const float* rpart = cluster.map_shared_rank(part, r);
        mr[r] = rml[2 * g];
        lr[r] = rml[2 * g + 1];
        ar[r] = rpart[i];
        M = fmaxf(M, mr[r]);
      }
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < n_split) {
        const float f = __expf(mr[r] - M);
        L += lr[r] * f;
        A += ar[r] * f;
      }
    }
    ob[i] = from_f<T>(A / fmaxf(L, kMinDenom));
  }
  cluster.sync();     // keep this CTA's shared memory until all have read
}

// Call f(integral_constant<GM>, integral_constant<VPL>) with the
// instantiation that holds G query heads and s.vpl vectors per lane.
template <typename T, class F>
cudaError_t dispatch(const Shape& s, F&& f) {
  using std::integral_constant;
  auto by_g = [&](auto vpl) {
    if (s.G <= 1) return f(integral_constant<int, 1>{}, vpl);
    if (s.G <= 2) return f(integral_constant<int, 2>{}, vpl);
    if (s.G <= 4) return f(integral_constant<int, 4>{}, vpl);
    if (s.G <= 8) return f(integral_constant<int, 8>{}, vpl);
    return f(integral_constant<int, 16>{}, vpl);
  };
  if constexpr (std::is_same<T, float>::value) {
    if (s.vpl == 2) return by_g(integral_constant<int, 2>{});
  }
  return by_g(integral_constant<int, 1>{});
}

// Launch the split kernel `kern` on grid (B * H, n_split), the n_split
// CTAs of one (batch * kv head) row forming one thread block cluster.
template <typename T, class... KArgs, class... Args>
cudaError_t launch_split(void (*kern)(KArgs...), const Shape& s, int B,
                         void* out, cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(s, sizeof(T));
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * s.H, s.n_split, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = s.n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args..., static_cast<T*>(out), s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace split
}  // namespace rt
