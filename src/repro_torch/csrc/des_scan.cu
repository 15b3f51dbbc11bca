// The discrete-event simulator's four sequential lanes, as CUDA kernels.
//
// Replaces the JAX package's vmapped lax.scan lanes (none of them a Pallas
// kernel): each stream is a recursion over its queries (or attempt events)
// that no closed form parallelises, so one thread (or one warp) owns one
// stream and walks it in order, while the streams (policies x rates x
// seeds) run side by side.
//
//   des_lindley      repro/queueing_sim/batched.py:85 lindley_jax
//   des_free_server  repro/queueing_sim/multiserver.py:115 free_server_jax
//   des_windowed     repro/queueing_sim/disciplines.py:376 _jax_kernel
//                    (windowed_jax, :424)
//   des_impatience   repro/queueing_sim/impatience.py:255 _jax_event_pass
//                    (impatience_jax, :299)
//
// What bounds them: a chain of n dependent steps per stream (max, add,
// compare, argmin), so each lane's time is n times one step's latency
// once every stream has its own thread or warp; bytes are a few tens of
// MB at the benchmark sizes. Every step repeats the scan body's
// operations in its order, in f64, and does only max / add / sub /
// compare (no multiply, so no FMA contraction): each kernel is bitwise
// equal to its plain version in repro_torch/kernels/des_scan.py.
//
// Entry points take plain pointers (row-major, contiguous) and return
// cudaGetLastError() right after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kTile = 32;        // streams a block and queries a smem tile
constexpr int kMaxC = 8;         // servers in the free-time panel
constexpr int kMaxWindow = 512;  // candidate window of the argmin lane
constexpr int kSlots = kMaxWindow / 32;  // ring slots a lane holds
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum / torch.maximum: NaN on either side propagates.
__device__ __forceinline__ double nan_max(double x, double y) {
  return (x != x || x > y) ? x : y;
}

// Load a [kTile streams x kTile queries] tile of a and s into shared
// memory, one coalesced row a stream.
__device__ __forceinline__ void load_tile(
    const double* __restrict__ a, const double* __restrict__ s,
    double (*ta)[kTile + 1], double (*ts)[kTile + 1], long long b0,
    int rows, long long n, long long q0, int nq, int lane) {
  for (int r = 0; r < rows; ++r) {
    if (lane < nq) {
      const long long off = (b0 + r) * n + q0 + lane;
      ta[r][lane] = a[off];
      ts[r][lane] = s[off];
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store_tile(
    double* __restrict__ start, double* __restrict__ finish,
    double (*ta)[kTile + 1], double (*ts)[kTile + 1], long long b0,
    int rows, long long n, long long q0, int nq, int lane) {
  __syncwarp();
  for (int r = 0; r < rows; ++r) {
    if (lane < nq) {
      const long long off = (b0 + r) * n + q0 + lane;
      start[off] = ta[r][lane];
      finish[off] = ts[r][lane];
    }
  }
  __syncwarp();
}

// Lindley: start = max(a_i, fin), fin = start + s_i, from fin = 0. One
// warp a block, one thread a stream; queries staged through shared memory
// in tiles so global reads and writes stay coalesced.
__global__ void __launch_bounds__(kTile) lindley_kernel(
    const double* __restrict__ a, const double* __restrict__ s,
    double* __restrict__ start, double* __restrict__ finish, long long B,
    long long n) {
  __shared__ double ta[kTile][kTile + 1];
  __shared__ double ts[kTile][kTile + 1];
  const int lane = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), B - b0));
  double fin = 0.0;
  for (long long q0 = 0; q0 < n; q0 += kTile) {
    const int nq = static_cast<int>(min(static_cast<long long>(kTile), n - q0));
    load_tile(a, s, ta, ts, b0, rows, n, q0, nq, lane);
    if (lane < rows) {
      for (int t = 0; t < nq; ++t) {
        const double st = nan_max(ta[lane][t], fin);
        fin = st + ts[lane][t];
        ta[lane][t] = st;
        ts[lane][t] = fin;
      }
    }
    store_tile(start, finish, ta, ts, b0, rows, n, q0, nq, lane);
  }
}

// First index of the smallest of f[0..kMaxC) (jnp.argmin's tie rule).
__device__ __forceinline__ int panel_argmin(const double (&f)[kMaxC],
                                            double* fmin) {
  int bj = 0;
  double bv = f[0];
#pragma unroll
  for (int j = 1; j < kMaxC; ++j) {
    if (f[j] < bv) {
      bv = f[j];
      bj = j;
    }
  }
  *fmin = bv;
  return bj;
}

__device__ __forceinline__ void panel_set(double (&f)[kMaxC], int j,
                                          double v) {
#pragma unroll
  for (int i = 0; i < kMaxC; ++i)
    if (i == j) f[i] = v;
}

// M/G/c FIFO: each query starts at max(a_i, min free) on the first
// earliest-free server. The [c_max] panel lives in registers, absent
// servers at +inf (from free0) and lanes past c_max at +inf too, which
// never win the argmin ahead of a real server.
__global__ void __launch_bounds__(kTile) free_server_kernel(
    const double* __restrict__ a, const double* __restrict__ s,
    const double* __restrict__ free0, double* __restrict__ start,
    double* __restrict__ finish, long long B, long long n, int cmax) {
  __shared__ double ta[kTile][kTile + 1];
  __shared__ double ts[kTile][kTile + 1];
  const int lane = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), B - b0));
  double f[kMaxC];
#pragma unroll
  for (int j = 0; j < kMaxC; ++j)
    f[j] = (lane < rows && j < cmax) ? free0[(b0 + lane) * cmax + j]
                                     : INFINITY;
  for (long long q0 = 0; q0 < n; q0 += kTile) {
    const int nq = static_cast<int>(min(static_cast<long long>(kTile), n - q0));
    load_tile(a, s, ta, ts, b0, rows, n, q0, nq, lane);
    if (lane < rows) {
      for (int t = 0; t < nq; ++t) {
        double fj;
        const int j = panel_argmin(f, &fj);
        const double st = nan_max(ta[lane][t], fj);
        const double fi = st + ts[lane][t];
        panel_set(f, j, fi);
        ta[lane][t] = st;
        ts[lane][t] = fi;
      }
    }
    store_tile(start, finish, ta, ts, b0, rows, n, q0, nq, lane);
  }
}

// Lexicographic (value, query) minimum: the lowest query among equal
// values, which is jnp.argmin's first index over the window's slots.
__device__ __forceinline__ void pick(double& bv, long long& bq, double& bs,
                                     double v, long long q, double sv) {
  if (v < bv || (v == bv && q < bq)) {
    bv = v;
    bq = q;
    bs = sv;
  }
}

// Sliding-window masked argmin (fifo, sjf, priority, spjf keys). One warp
// a stream. The window holds queries [lo, lo + W) of the padded stream;
// query q lives at ring position q % W, position p = j * 32 + lane in
// register slot j of that lane, with its arrival, key and service. A step
// is the scan body of disciplines.py:389-409 line by line: candidates are
// unserved slots that have arrived by free_t; with none, free_t jumps to
// the window head's arrival; the overflow flag reads ap[lo + W]; the
// argmin of the masked keys over all W slots (ties to the lowest query)
// picks the job; the window slides past the served prefix and the slots
// it frees take the next queries.
__global__ void __launch_bounds__(128) windowed_kernel(
    const double* __restrict__ ap, const double* __restrict__ sp,
    const double* __restrict__ kp, double* __restrict__ start,
    double* __restrict__ finish, uint8_t* __restrict__ ovf_out, long long B,
    long long n, int W) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // the whole warp leaves together
  const long long NW = n + W;
  const double* a = ap + warp * NW;
  const double* s = sp + warp * NW;
  const double* k = kp + warp * NW;
  double* st_out = start + warp * n;
  double* fi_out = finish + warp * n;

  double ra[kSlots], rk[kSlots], rs[kSlots];
  unsigned served = 0u;  // bit j: slot j of this lane is served
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int p = j * 32 + lane;
    if (p < W) {
      ra[j] = a[p];
      rk[j] = k[p];
      rs[j] = s[p];
    } else {
      ra[j] = INFINITY;
      rk[j] = INFINITY;
      rs[j] = 0.0;
    }
  }
  long long lo = 0;
  int lo_mod = 0;  // ring position of window slot 0
  double free_t = 0.0;
  bool ovf = false;
  for (long long step = 0; step < n; ++step) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int p = j * 32 + lane;
      any |= p < W && !((served >> j) & 1u) && ra[j] <= free_t;
    }
    // idle jump: the window head is the earliest unserved query
    if (!__any_sync(kFull, any)) free_t = a[lo];
    ovf = ovf || (a[lo + W] <= free_t);
    double bv = INFINITY, bs = 0.0;
    long long bq = LLONG_MAX;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int p = j * 32 + lane;
      if (p < W) {
        int off = p - lo_mod;
        if (off < 0) off += W;
        const bool cand = !((served >> j) & 1u) && ra[j] <= free_t;
        pick(bv, bq, bs, cand ? rk[j] : INFINITY, lo + off, rs[j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, bv, o);
      const long long oq = __shfl_xor_sync(kFull, bq, o);
      const double os = __shfl_xor_sync(kFull, bs, o);
      pick(bv, bq, bs, ov, oq, os);
    }
    const double fin = free_t + bs;
    if (lane == 0 && bq < n) {
      st_out[bq] = free_t;
      fi_out[bq] = fin;
    }
    const int pq = static_cast<int>(bq % W);
    if ((pq & 31) == lane) served |= 1u << (pq >> 5);
    // slide past the served prefix: adv = first unserved slot, or W
    int adv = W;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int p = j * 32 + lane;
      if (p < W && !((served >> j) & 1u)) {
        int off = p - lo_mod;
        if (off < 0) off += W;
        adv = min(adv, off);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      adv = min(adv, __shfl_xor_sync(kFull, adv, o));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int p = j * 32 + lane;
      if (p < W) {
        int off = p - lo_mod;
        if (off < 0) off += W;
        if (off < adv) {
          const long long q = lo + off + W;  // the query revealed here
          ra[j] = a[q];
          rk[j] = k[q];
          rs[j] = s[q];
          served &= ~(1u << j);
        }
      }
    }
    lo += adv;
    lo_mod += adv;
    if (lo_mod >= W) lo_mod -= W;
    free_t = fin;
  }
  if (lane == 0) ovf_out[warp] = ovf ? 1 : 0;
}

// Impatience event pass: one thread a stream over its stably sorted
// attempt events; the free panel in registers, per-customer state
// (served, next attempt, attempts, start, finish, wait) in global memory.
__global__ void __launch_bounds__(kTile) impatience_kernel(
    const double* __restrict__ t_ev, const long long* __restrict__ i_ev,
    const long long* __restrict__ k_ev, const double* __restrict__ svc,
    uint8_t* __restrict__ served, long long* __restrict__ nxt,
    long long* __restrict__ n_att, double* __restrict__ start,
    double* __restrict__ finish, double* __restrict__ wait, long long ns,
    long long E, long long n, double tau, long long kmax, int c,
    int orphaned) {
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= ns) return;
  const double* te = t_ev + b * E;
  const long long* ie = i_ev + b * E;
  const long long* ke = k_ev + b * E;
  const double* s = svc + b * n;
  uint8_t* sv = served + b * n;
  long long* nx = nxt + b * n;
  long long* na = n_att + b * n;
  double* st_o = start + b * n;
  double* fi_o = finish + b * n;
  double* wt_o = wait + b * n;
  double f[kMaxC];
#pragma unroll
  for (int j = 0; j < kMaxC; ++j) f[j] = j < c ? 0.0 : INFINITY;
  for (long long e = 0; e < E; ++e) {
    const double t = te[e];
    const long long i = ie[e];
    const long long k = ke[e];
    const bool live = !sv[i] && nx[i] == k;
    double fam;
    const int am = panel_argmin(f, &fam);
    const double st = nan_max(t, fam);
    const bool ok = live && (st - t <= tau);
    const bool timeout = live && !ok;
    const bool occupy = ok || (orphaned && timeout);
    if (live) na[i] = k + 1;
    const double fin = st + s[i];
    if (ok) {
      sv[i] = 1;
      st_o[i] = st;
      wt_o[i] = st - t;
      fi_o[i] = fin;
    }
    if (occupy) panel_set(f, am, fin);
    if (timeout && k < kmax) nx[i] += 1;
  }
}

// One thread, one chain of `steps` dependent Lindley steps (max, add) on
// values it makes itself: the latency of the recursion every lane has to
// walk once per query, for the lanes' sequential floor. Not a lane.
__global__ void step_probe_kernel(double* out, double a0, double s,
                                  long long steps) {
  double fin = 0.0, a = a0;
  for (long long i = 0; i < steps; ++i) {
    fin = nan_max(a, fin) + s;
    a += s;
  }
  *out = fin;
}

unsigned blocks(long long count, int per_block) {
  return static_cast<unsigned>((count + per_block - 1) / per_block);
}

}  // namespace

extern "C" int des_lindley(const void* a, const void* s, void* start,
                           void* finish, long long B, long long n,
                           void* stream) {
  lindley_kernel<<<blocks(B, kTile), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(s),
      static_cast<double*>(start), static_cast<double*>(finish), B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int des_free_server(const void* a, const void* s,
                               const void* free0, void* start, void* finish,
                               long long B, long long n, int cmax,
                               void* stream) {
  if (cmax < 1 || cmax > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  free_server_kernel<<<blocks(B, kTile), kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(s),
      static_cast<const double*>(free0), static_cast<double*>(start),
      static_cast<double*>(finish), B, n, cmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int des_windowed(const void* ap, const void* sp, const void* kp,
                            void* start, void* finish, void* ovf, long long B,
                            long long n, int W, void* stream) {
  if (W < 1 || W > kMaxWindow) return static_cast<int>(cudaErrorInvalidValue);
  windowed_kernel<<<blocks(B * 32, 128), 128, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ap), static_cast<const double*>(sp),
      static_cast<const double*>(kp), static_cast<double*>(start),
      static_cast<double*>(finish), static_cast<uint8_t*>(ovf), B, n, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int des_impatience(const void* t_ev, const void* i_ev,
                              const void* k_ev, const void* s, void* served,
                              void* nxt, void* n_att, void* start,
                              void* finish, void* wait, long long ns,
                              long long E, long long n, double tau,
                              long long kmax, int c, int orphaned,
                              void* stream) {
  if (c < 1 || c > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  impatience_kernel<<<blocks(ns, kTile), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t_ev), static_cast<const long long*>(i_ev),
      static_cast<const long long*>(k_ev), static_cast<const double*>(s),
      static_cast<uint8_t*>(served), static_cast<long long*>(nxt),
      static_cast<long long*>(n_att), static_cast<double*>(start),
      static_cast<double*>(finish), static_cast<double*>(wait), ns, E, n,
      tau, kmax, c, orphaned);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int des_step_probe(void* out, double a0, double s,
                              long long steps, void* stream) {
  step_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), a0, s, steps);
  return static_cast<int>(cudaGetLastError());
}
