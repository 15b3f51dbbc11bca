// Fused SwiGLU FFN, y = (silu(x Wg) * (x Wu)) Wd, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_ffn.py : fused_ffn (the Pallas TPU
// kernel _kernel). Same function, batched over E: gate and up products
// accumulate in f32, h = silu(g) * u is formed in f32 and rounded to the
// input dtype (as the TPU kernel's h.astype(x.dtype)), and the down
// projection accumulates in f32 before the final cast.
//
// What bounds it on the H100: the three weight matrices, 3 d d_ff
// elements, read once per call. At decode (T = 1 on the batch-1 serve, 8
// on the continuous engine) that is all the call moves, 18.9 MB at
// qwen3-0.6b's widths and 308 MB at zamba2-7b's in bf16, so bytes bound
// it; at prefill (T = S, or a padded admission group of up to 8 x 113
// rows) it does 6 T d d_ff FLOPs on the same bytes, still under the card's
// ~295 FLOP per byte up to T of about 300.
//
// Two routes, chosen by the wrapper's shape-only plan
// (kernels/fused_ffn.py: ffn_plan):
//
// * tensor cores (bf16, d and d_ff multiples of 8, 16-byte aligned): two
//   launches of one GEMM kernel, so no [T, d] accumulator has to live in
//   shared memory (it cut the first port's row tile to 4 rows at d 3584,
//   so each tile re-read all the weights):
//     1. h = round_bf16(silu(x Wg) * (x Wu)) into a [E, T, d_ff] bf16
//        scratch; the gate and up tiles share x's fragments and the SiLU
//        and product are the epilogue;
//     2. y = h Wd.
//   A CTA computes a BM x 64 output tile over its share of the reduction:
//   64-deep tiles of the activations and of the weights stream through a
//   four-stage cp.async ring (16-byte copies, rows padded by 16 bytes so
//   ldmatrix runs without bank conflicts, ragged edges zero-filled by the
//   copy) into mma.sync m16n8k16 (bf16 in, f32 out). BM is 16 while T <=
//   16 (the decode regime: a weight-streaming product whose 15 empty rows
//   cost tensor-core cycles the byte bound leaves idle) and 64 beyond it
//   (the prefill regime: every weight tile serves 64 rows, so T <= 64
//   reads each weight once). Where the output tiles alone do not give the
//   grid its CTAs (one an SM for gate/up, two for down, whose CTA streams
//   one weight tile a stage instead of two; qwen3's d_ff 3072 has only 48
//   tiles of 64 columns), the reduction is split over `ks` CTAs: each
//   writes an f32 partial, and the last CTA of a tile to arrive (a counter
//   per tile, which that CTA resets to 0 for the next call or a graph
//   replay) sums the partials in split order and applies the epilogue. No
//   atomics touch the output and the sum's order is fixed, so two calls
//   are bit-equal. For small decode calls the down GEMM launches as a
//   programmatic dependent of the gate/up GEMM: its CTAs start as the
//   gate/up CTAs run, prefetch their weight tiles, and wait for h
//   (griddepcontrol), which hides the launch gap between the two.
//
// Per-expert row counts (`rows`, an int32 [E] array on the device, or
// null): for the MoE's dispatch buffer [E, C, d], where expert e holds
// rows[e] live rows and the rest is padding. A CTA whose row tile starts
// at or past rows[e] returns before it loads anything, so an expert no
// token was sent to costs no weight bytes: the work follows the experts
// the batch hit, as jax.lax.ragged_dot's does in the JAX package. All
// CTAs of one tile share its row tile, so a skipped tile's split counter
// is never touched and stays 0. Output rows at or past rows[e] are left
// unwritten (rows of a live tile past rows[e] are computed from the
// buffer's padding), and the caller reads none of them. The count is
// read on the device: no host read, so the call can be captured in a
// CUDA graph.
// * scalar f32 FMAs (f32, where TF32 would fall outside the 1e-4
//   tolerance, and shapes off the 16-byte grid): the first port's kernel.
//   A CTA owns BT rows and a share of the 32-wide d_ff chunks, forms h in
//   shared memory and adds h . Wd into a [BT, d] f32 tile; a second kernel
//   sums the shares in a fixed order.
#include "common.cuh"
#include "mma.cuh"

using namespace rt;

namespace {

// ---------------------------------------------------------- scalar route
constexpr int kBF = 32;          // d_ff columns per chunk: one per lane
constexpr int kThreads = 256;
constexpr int kParts = kThreads / 32;   // warps splitting the d reduction

template <int BT>
size_t smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)BT * d + 2 * (size_t)kParts * BT * kBF +
                          (size_t)BT * kBF);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
    ffn_partial(const T* __restrict__ x, const T* __restrict__ wg,
                const T* __restrict__ wu, const T* __restrict__ wd,
                const int* __restrict__ rows, float* __restrict__ part,
                int n_rows, int d, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                         // [BT][d]
  float* ys = xs + BT * d;                  // [BT][d]  f32 partial of y
  float* red = ys + BT * d;                 // [2][kParts][BT][kBF]
  float* hs = red + 2 * kParts * BT * kBF;  // [BT][kBF]

  const int e = blockIdx.z, t0 = blockIdx.y * BT, split = blockIdx.x;
  if (rows != nullptr && t0 >= __ldg(rows + e)) return;   // no live row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long E = gridDim.z;
  const T* xe = x + (long long)e * n_rows * d;
  const T* wge = wg + (long long)e * d * f;
  const T* wue = wu + (long long)e * d * f;
  const T* wde = wd + (long long)e * f * d;

  for (int i = tid; i < BT * d; i += kThreads) {
    const int t = i / d, dd = i % d;
    xs[i] = (t0 + t < n_rows) ? to_f(xe[(long long)(t0 + t) * d + dd]) : 0.f;
    ys[i] = 0.f;
  }
  __syncthreads();

  const int n_chunks = (f + kBF - 1) / kBF;
  for (int fc = split; fc < n_chunks; fc += gridDim.x) {
    const int f0 = fc * kBF, fcol = f0 + lane;
    const bool colok = fcol < f;
    // gate and up products for this chunk: warp `warp` takes rows
    // dd = warp, warp + kParts, ... of the d reduction
    float g[BT], u[BT];
#pragma unroll
    for (int t = 0; t < BT; ++t) g[t] = u[t] = 0.f;
#pragma unroll 4
    for (int dd = warp; dd < d; dd += kParts) {
      const float wgv = colok ? to_f(wge[(long long)dd * f + fcol]) : 0.f;
      const float wuv = colok ? to_f(wue[(long long)dd * f + fcol]) : 0.f;
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        const float xv = xs[t * d + dd];
        g[t] += xv * wgv;
        u[t] += xv * wuv;
      }
    }
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      red[(warp * BT + t) * kBF + lane] = g[t];
      red[((kParts + warp) * BT + t) * kBF + lane] = u[t];
    }
    __syncthreads();
    for (int i = tid; i < BT * kBF; i += kThreads) {
      const int t = i / kBF, cc = i % kBF;
      float gs = 0.f, us = 0.f;
      for (int p = 0; p < kParts; ++p) {
        gs += red[(p * BT + t) * kBF + cc];
        us += red[((kParts + p) * BT + t) * kBF + cc];
      }
      hs[i] = (f0 + cc < f) ? round_to<T>(silu(gs) * us) : 0.f;
    }
    __syncthreads();
    // down projection of the chunk into the f32 tile
    const int nj = min(kBF, f - f0);
    for (int dd = tid; dd < d; dd += kThreads) {
      float a[BT];
#pragma unroll
      for (int t = 0; t < BT; ++t) a[t] = ys[t * d + dd];
      for (int j = 0; j < nj; ++j) {
        const float w = to_f(wde[(long long)(f0 + j) * d + dd]);
#pragma unroll
        for (int t = 0; t < BT; ++t) a[t] += hs[t * kBF + j] * w;
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) ys[t * d + dd] = a[t];
    }
    __syncthreads();   // red/hs are rewritten by the next chunk
  }
  // part [n_split, E, T, d]
  float* pe = part + ((long long)split * E + e) * n_rows * d;
  for (int i = tid; i < BT * d; i += kThreads) {
    const int t = i / d;
    if (t0 + t < n_rows) pe[(long long)t0 * d + i] = ys[i];
  }
}

template <typename T>
__global__ void ffn_reduce(const float* __restrict__ part, T* __restrict__ y,
                           const int* __restrict__ rows, long long n,
                           int n_rows, int d, int n_split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (rows != nullptr) {       // rows past rows[e] have no partials
      const long long r = i / d;
      if (r % n_rows >= __ldg(rows + r / n_rows)) continue;
    }
    float s = 0.f;
    for (int p = 0; p < n_split; ++p) s += part[p * n + i];
    y[i] = from_f<T>(s);
  }
}

template <typename T, int BT>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* rows, void* y, void* scratch,
                   int E, int n_rows, int d, int f, int n_split,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BT>(d);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(ffn_partial<T, BT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, (n_rows + BT - 1) / BT, E);
  ffn_partial<T, BT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), rows,
      static_cast<float*>(scratch), n_rows, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)E * n_rows * d;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  ffn_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(y), rows, n,
      n_rows, d, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bt, const void* x, const void* wg, const void* wu,
                     const void* wd, const int* rows, void* y, void* scratch,
                     int E, int n_rows, int d, int f, int n_split,
                     cudaStream_t stream) {
  switch (bt) {
    case 1:
      return launch<T, 1>(x, wg, wu, wd, rows, y, scratch, E, n_rows, d, f,
                          n_split, stream);
    case 4:
      return launch<T, 4>(x, wg, wu, wd, rows, y, scratch, E, n_rows, d, f,
                          n_split, stream);
    case 16:
      return launch<T, 16>(x, wg, wu, wd, rows, y, scratch, E, n_rows, d, f,
                           n_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------- tensor-core route
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;          // 4 warps
constexpr int kBN = 64;                  // output columns of a tile
constexpr int kBKt = 64;                 // reduction depth of a stage
constexpr int kStages = 4;
constexpr int kLD = 64 + 8;              // padded smem row (A: k, B: n)

template <int BM, bool GATED>
constexpr size_t gemm_smem_bytes() {
  return sizeof(bf16) * kStages * ((size_t)BM * kLD +
                                   (GATED ? 2 : 1) * (size_t)kBKt * kLD);
}

// out[e] = epilogue(a[e] . b0[e] (, a[e] . b1[e])), a [E, M, K], b [E, K,
// N], out [E, M, N]. GATED: out = round(silu(a b0) * (a b1)). grid: (N
// tiles, M tiles, E * ks). part: f32 partials [ks, E, M, N] (twice when
// GATED); counters: one per (e, m tile, n tile), zero between calls;
// rows: live rows of each expert (null: all M).
template <int BM, bool GATED>
__global__ void __launch_bounds__(kTcThreads)
    ffn_gemm(const bf16* __restrict__ a, const bf16* __restrict__ b0,
             const bf16* __restrict__ b1, bf16* __restrict__ out,
             float* __restrict__ part, int* __restrict__ counters,
             const int* __restrict__ rows, int E, int M, int K, int N,
             int ks) {
  constexpr int NB = GATED ? 2 : 1;
  // BM 16: the 4 warps split the 64 columns (16 each); BM 64: the rows
  constexpr int WN = BM == 16 ? 16 : 64;     // columns of a warp tile
  constexpr int NT = WN / 8;                 // n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);       // [kStages][BM][kLD]
  bf16* sb = sa + kStages * BM * kLD;         // [NB][kStages][kBKt][kLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockIdx.x, mt = blockIdx.y;
  const int e = blockIdx.z / ks, split = blockIdx.z % ks;
  const int n0 = nt * kBN, m0 = mt * BM;
  if (rows != nullptr && m0 >= __ldg(rows + e)) {
    // no live row in the tile: load nothing. A dependent down GEMM still
    // waits for the gate/up GEMM, so the grid ends after it as without
    // rows (and no later kernel can start before h is written)
    if constexpr (!GATED) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    return;
  }
  const bf16* ae = a + (long long)e * M * K;
  const bf16* be[2] = {b0 + (long long)e * K * N,
                       GATED ? b1 + (long long)e * K * N : nullptr};
  const int kt_total = (K + kBKt - 1) / kBKt;
  const int kt0 = (int)((long long)split * kt_total / ks);
  const int kt1 = (int)((long long)(split + 1) * kt_total / ks);

  auto load_a = [&](int kt, int stage) {
    const int k0 = kt * kBKt;
    for (int i = tid; i < BM * 8; i += kTcThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sa + (stage * BM + r) * kLD + c,
                 ok ? ae + (long long)(m0 + r) * K + k0 + c : ae, ok);
    }
  };
  auto load_b = [&](int kt, int stage) {
    const int k0 = kt * kBKt;
#pragma unroll
    for (int mat = 0; mat < NB; ++mat)
      for (int i = tid; i < kBKt * 8; i += kTcThreads) {
        const int r = i >> 3, c = (i & 7) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(sb + ((mat * kStages + stage) * kBKt + r) * kLD + c,
                   ok ? be[mat] + (long long)(k0 + r) * N + n0 + c : be[mat],
                   ok);
      }
  };

  float acc[NB][NT][4];
#pragma unroll
  for (int mat = 0; mat < NB; ++mat)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[mat][j][0] = acc[mat][j][1] = acc[mat][j][2] = acc[mat][j][3] = 0.f;

  if constexpr (GATED) {
    // let the down GEMM's CTAs start streaming Wd as SMs free up
    asm volatile("griddepcontrol.launch_dependents;\n" ::);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (kt0 + s < kt1) {
        load_a(kt0 + s, s);
        load_b(kt0 + s, s);
      }
      cp_async_commit();
    }
  } else {
    // the weights do not depend on the gate/up GEMM: prefetch them, then
    // wait for its h (a no-op without a programmatic dependency)
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (kt0 + s < kt1) load_b(kt0 + s, s);
      cp_async_commit();
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      if (kt0 + s < kt1) load_a(kt0 + s, s);
    cp_async_commit();
    cp_async_wait<0>();
  }
  const int wm = BM == 16 ? 0 : warp * 16, wn = BM == 16 ? warp * 16 : 0;
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_col = (lane >> 4) << 3;
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // stage ready; the one refilled below consumed
    const int pre = kt + kStages - 1;
    if (pre < kt1) {
      load_a(pre, (pre - kt0) % kStages);
      load_b(pre, (pre - kt0) % kStages);
    }
    cp_async_commit();
    const int stage = (kt - kt0) % kStages;
    const bf16* sat = sa + (stage * BM + wm) * kLD;
#pragma unroll
    for (int kk = 0; kk < kBKt / 16; ++kk) {
      unsigned af[4];
      ldmatrix_x4(af, sat + a_row * kLD + kk * 16 + a_col);
#pragma unroll
      for (int mat = 0; mat < NB; ++mat) {
        const bf16* sbt = sb + ((mat * kStages + stage) * kBKt) * kLD;
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, sbt + (kk * 16 + a_row) * kLD + wn + p * 16 +
                                    a_col);
          mma_bf16(acc[mat][2 * p], af, bf[0], bf[1]);
          mma_bf16(acc[mat][2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  auto epilogue = [&](float g0, float g1, float u0, float u1) -> unsigned {
    if constexpr (GATED)
      return pack_bf16(silu(g0) * u0, silu(g1) * u1);
    else
      return pack_bf16(g0, g1);
  };
  bf16* oe = out + (long long)e * M * N;
  const int kc = 2 * (lane & 3);
  if (ks == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm + (lane >> 2) + 8 * hf;
        const int c = n0 + wn + 8 * j + kc;
        if (r < M && c < N) {
          const float* g = acc[0][j] + 2 * hf;
          const float* u = acc[NB - 1][j] + 2 * hf;
          *reinterpret_cast<unsigned*>(oe + (long long)r * N + c) =
              epilogue(g[0], g[1], u[0], u[1]);
        }
      }
    return;
  }
  // split reduction: partials out, then the tile's last CTA sums them
  const long long plane = (long long)E * M * N;
#pragma unroll
  for (int mat = 0; mat < NB; ++mat) {
    float* pm = part + mat * ks * plane + (split * E + e) * (long long)M * N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm + (lane >> 2) + 8 * hf;
        const int c = n0 + wn + 8 * j + kc;
        if (r < M && c < N)
          *reinterpret_cast<float2*>(pm + (long long)r * N + c) =
              make_float2(acc[mat][j][2 * hf], acc[mat][j][2 * hf + 1]);
      }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = counters + ((long long)e * gridDim.y + mt) * gridDim.x + nt;
  if (tid == 0) last = atomicAdd(counter, 1) == ks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < BM * kBN / 2; i += kTcThreads) {
    const int r = m0 + i / (kBN / 2), c = n0 + 2 * (i % (kBN / 2));
    if (r >= M || c >= N) continue;
    float s[NB][2] = {};
    for (int sp = 0; sp < ks; ++sp)
#pragma unroll
      for (int mat = 0; mat < NB; ++mat) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            part + mat * ks * plane + (sp * E + e) * (long long)M * N +
            (long long)r * N + c));
        s[mat][0] += v.x;
        s[mat][1] += v.y;
      }
    *reinterpret_cast<unsigned*>(oe + (long long)r * N + c) =
        epilogue(s[0][0], s[0][1], s[NB - 1][0], s[NB - 1][1]);
  }
  if (tid == 0) *counter = 0;     // ready for the next call
}

// With `pdl`, the down GEMM (GATED false) launches as a programmatic
// dependent of the gate/up GEMM before it on the stream: its CTAs may
// start while the gate/up CTAs run, prefetch their weight tiles and wait
// for h.
template <int BM, bool GATED>
cudaError_t launch_gemm(const bf16* a, const bf16* b0, const bf16* b1,
                        bf16* out, float* part, int* counters,
                        const int* rows, int E, int M, int K, int N, int ks,
                        int pdl, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<BM, GATED>();
  cudaError_t err = set_smem(ffn_gemm<BM, GATED>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + BM - 1) / BM, E * ks);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = !GATED && pdl ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ffn_gemm<BM, GATED>, a, b0, b1, out, part,
                           counters, rows, E, M, K, N, ks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM>
cudaError_t launch_tc(const bf16* x, const bf16* wg, const bf16* wu,
                      const bf16* wd, bf16* y, bf16* h, float* part,
                      int* counters, const int* rows, int E, int T, int d,
                      int f, int ks_up, int ks_down, int pdl,
                      cudaStream_t stream) {
  const int m_tiles = (T + BM - 1) / BM;
  cudaError_t err = launch_gemm<BM, true>(x, wg, wu, h, part, counters, rows,
                                          E, T, d, f, ks_up, 0, stream);
  if (err != cudaSuccess) return err;
  int* counters_down = counters + E * m_tiles * ((f + kBN - 1) / kBN);
  return launch_gemm<BM, false>(h, wd, nullptr, y, part, counters_down, rows,
                                E, T, f, d, ks_down, pdl, stream);
}

}  // namespace

// The scalar route. x [E, T, d], wg/wu [E, d, f], wd [E, f, d], y [E, T, d],
// all contiguous; rows: int32 [E] live rows of each expert, or null (all
// T); scratch: n_split * E * T * d floats. bt: rows per CTA (1, 4 or 16).
extern "C" int fused_ffn_fwd(int dtype, const void* x, const void* wg,
                             const void* wu, const void* wd, const void* rows,
                             void* y, void* scratch, int E, int n_rows, int d,
                             int f, int bt, int n_split, void* stream) {
  if (E < 1 || n_rows < 1 || d < 1 || f < 1 || n_split < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  if (dtype == kF32)
    return dispatch<float>(bt, x, wg, wu, wd, r, y, scratch, E, n_rows, d, f,
                           n_split, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(bt, x, wg, wu, wd, r, y, scratch, E,
                                   n_rows, d, f, n_split, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route, bf16. h: [E, T, f] scratch; part: f32 partials,
// max(2 ks_up E T f, ks_down E T d) floats (unused when both ks are 1);
// counters: E * m_tiles * (ceil(f / 64) + ceil(d / 64)) ints, zero on
// entry and left zero; rows: int32 [E] live rows of each expert, or null
// (all T). bm: 16 or 64 rows a tile. pdl: launch the down GEMM as a
// programmatic dependent. d and f multiples of 8, every pointer but rows
// 16-byte aligned.
extern "C" int fused_ffn_tc_fwd(const void* x, const void* wg,
                                const void* wu, const void* wd, void* y,
                                void* h, void* part, void* counters,
                                const void* rows, int E, int n_rows, int d,
                                int f, int bm, int ks_up, int ks_down,
                                int pdl, void* stream) {
  if (E < 1 || n_rows < 1 || d < 8 || f < 8 || d % 8 || f % 8 ||
      ks_up < 1 || ks_down < 1)
    return cudaErrorInvalidValue;
  const void* ptrs[6] = {x, wg, wu, wd, y, h};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                  static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
                  static_cast<bf16*>(y), static_cast<bf16*>(h),
                  static_cast<float*>(part), static_cast<int*>(counters),
                  static_cast<const int*>(rows), E, n_rows, d, f, ks_up,
                  ks_down, pdl, s);
  };
  if (bm == 16) return args(launch_tc<16>);
  if (bm == 64) return args(launch_tc<64>);
  return cudaErrorInvalidValue;
}
