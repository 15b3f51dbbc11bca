// Fused SwiGLU FFN, y = (silu(x Wg) * (x Wu)) Wd, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_ffn.py : fused_ffn (the Pallas TPU
// kernel _kernel). Same function, batched over E: gate and up products
// accumulate in f32, h = silu(g) * u is formed in f32 and rounded to the
// input dtype (as the TPU kernel's h.astype(x.dtype)), and the down
// projection accumulates in f32 before the final cast. The [T, d_ff]
// intermediate h never reaches device memory.
//
// What bounds it on the H100: at decode (T = batch rows, 1 on the serving
// path) the three weight matrices are read once for a handful of rows, so
// bytes bound it: 3 * d * d_ff * sizeof(T) per call (18.9 MB at
// qwen3-0.6b's widths in bf16). At prefill (T = B * S <= a few hundred)
// it is still below the balance point of ~295 FLOP per byte.
//
// Design (right and simple first): the TPU kernel walks d_ff as a
// sequential reduction axis into one accumulator; on the GPU that would
// leave one CTA per row tile, so d_ff is split instead. A CTA owns a tile
// of BT rows and a share of the 32-wide d_ff chunks (enough shares that
// the grid covers the SMs): for each chunk it forms h[BT, 32] in shared
// memory (warps split the d reduction, lanes own the 32 columns so each
// weight row segment is read coalesced) and adds h . Wd[chunk] into a
// [BT, d] f32 tile in shared memory. Each CTA writes its tile once to a
// small f32 scratch, and a second kernel sums the shares in a fixed order
// and casts, so the result is deterministic. Rows past T are zero-padded
// in shared memory, so any T is taken (the TPU kernel needed T to divide
// its block). Scalar f32 FMAs; wgmma and TMA are later work.
#include "common.cuh"

using namespace rt;

namespace {

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
                float* __restrict__ part, int n_rows, int d, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                         // [BT][d]
  float* ys = xs + BT * d;                  // [BT][d]  f32 partial of y
  float* red = ys + BT * d;                 // [2][kParts][BT][kBF]
  float* hs = red + 2 * kParts * BT * kBF;  // [BT][kBF]

  const int e = blockIdx.z, t0 = blockIdx.y * BT, split = blockIdx.x;
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
                           long long n, int n_split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n_split; ++p) s += part[p * n + i];
    y[i] = from_f<T>(s);
  }
}

template <typename T, int BT>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* y, void* scratch, int E, int n_rows,
                   int d, int f, int n_split, cudaStream_t stream) {
  const size_t smem = smem_bytes<BT>(d);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(ffn_partial<T, BT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, (n_rows + BT - 1) / BT, E);
  ffn_partial<T, BT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<float*>(scratch), n_rows, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)E * n_rows * d;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  ffn_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(y), n, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bt, const void* x, const void* wg, const void* wu,
                     const void* wd, void* y, void* scratch, int E,
                     int n_rows, int d, int f, int n_split,
                     cudaStream_t stream) {
  switch (bt) {
    case 1:
      return launch<T, 1>(x, wg, wu, wd, y, scratch, E, n_rows, d, f,
                          n_split, stream);
    case 4:
      return launch<T, 4>(x, wg, wu, wd, y, scratch, E, n_rows, d, f,
                          n_split, stream);
    case 16:
      return launch<T, 16>(x, wg, wu, wd, y, scratch, E, n_rows, d, f,
                           n_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [E, T, d], wg/wu [E, d, f], wd [E, f, d], y [E, T, d], all contiguous;
// scratch: n_split * E * T * d floats. bt: rows per CTA (1, 4 or 16).
extern "C" int fused_ffn_fwd(int dtype, const void* x, const void* wg,
                             const void* wu, const void* wd, void* y,
                             void* scratch, int E, int n_rows, int d, int f,
                             int bt, int n_split, void* stream) {
  if (E < 1 || n_rows < 1 || d < 1 || f < 1 || n_split < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(bt, x, wg, wu, wd, y, scratch, E, n_rows, d, f,
                           n_split, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(bt, x, wg, wu, wd, y, scratch, E, n_rows,
                                   d, f, n_split, s);
  return cudaErrorInvalidValue;
}
