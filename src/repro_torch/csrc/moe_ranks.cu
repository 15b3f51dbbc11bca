// The MoE dispatch's pair ranks, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package ranks the (token, expert) pairs
// with a stable argsort of their experts (src/repro/models/moe.py:
// _moe_capacity, _moe_ragged), which XLA lowers on its own; the port's
// first version counted a one-hot [N, E] down its N rows with torch.cumsum,
// which promotes to int64 and, scanning the outer dimension, gives one
// thread to each of the E columns: each walks the N rows through dependent
// loads (about 0.18 us a row on the H100), so the ranks of one MoE layer
// of a 2,500-token prompt took ~2.6 ms of device time.
//
// Computes, for the N = T k flat pairs t k + j of idx [T, k] (experts in
// [0, E)):
//   pos[i]   the pair's rank among its expert's pairs, in flat order (its
//            place in the stable argsort, less its expert's start), int64;
//   sizes[e] the pairs per expert, int32;
// and, when C > 0 (the capacity dispatch's [E, C, d] buffer):
//   rows_in[i]  the buffer row the pair is written to, e C + pos, or the
//               spare row E C past the buffer when pos >= C (dropped);
//   rows_out[i] the row its output is read from: e C + pos, or pair 0's
//               row idx[0] C (rank 0, always kept) when dropped.
//
// What bounds it: latency, not bytes. It reads 8 bytes a pair and writes 8
// (24 with rows); the work is a prefix count in pair order. Design: one CTA
// of 1,024 threads walks the pairs in tiles of 1,024, one pair a thread.
// Within a warp, __match_any_sync on the expert gives each pair the lanes
// that share it, so its rank in the warp is the popcount of those below
// it, and the group's lowest lane writes the group's size to a per-warp,
// per-expert count in shared memory (32 x E ints, each row padded to an
// odd stride so the scan's column reads hit 32 banks). Then each warp
// takes experts e = warp, warp + 32, ...: lane w reads warp w's count of
// e, a shuffle scan makes it exclusive, and the expert's carry from the
// earlier tiles is added; each group's lowest lane zeroes its count once
// the group has read it. A pair's rank is its warp's offset for its
// expert plus its rank in the warp. No atomics: the result is exact and
// deterministic, so a captured CUDA graph's replays give the eager call's
// bits. A tile costs a few syncs of the CTA, so the cost grows with
// N / 1,024 (2.7 us a call at 384 pairs, 30 us at 15,000 on the H100);
// the one CTA holds the carries, so no pass over the grid is needed.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 256;       // kernels/moe_ranks.py MAX_EXPERTS

__global__ void __launch_bounds__(kThreads)
moe_pair_ranks(const long long* __restrict__ idx, long long* __restrict__ pos,
               int* __restrict__ sizes, long long* __restrict__ rows_in,
               long long* __restrict__ rows_out, int n, int E, int C) {
  __shared__ int cnt[kWarps * (kMaxExperts + 1)];   // [warp][expert]
  __shared__ int carry[kMaxExperts];
  const int stride = E | 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < kWarps * stride; i += kThreads) cnt[i] = 0;
  for (int e = tid; e < E; e += kThreads) carry[e] = 0;
  const long long spare = (long long)E * C;
  const long long first = n > 0 ? idx[0] * (long long)C : 0;
  __syncthreads();

  long long v = tid < n ? idx[tid] : -1;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const int e = v >= 0 && v < E ? static_cast<int>(v) : -1;
    // the next tile's expert, loaded while this one is ranked
    v = i + kThreads < n ? idx[i + kThreads] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & below);
    const bool leader = rank == 0;
    if (e >= 0 && leader) cnt[warp * stride + e] = __popc(peers);
    __syncthreads();

    // warp w's offset for expert e: the pairs of e in warps < w of this
    // tile, plus e's pairs in the earlier tiles
    for (int x = warp; x < E; x += kWarps) {
      const int c = cnt[lane * stride + x];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int before = carry[x];
      if (c) cnt[lane * stride + x] = before + incl - c;
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      if (lane == 0) carry[x] = before + total;
    }
    __syncthreads();

    if (i < n) {
      long long p = -1, in = spare, out = 0;
      if (e >= 0) {
        p = cnt[warp * stride + e] + rank;
        const long long slot = (long long)e * C + p;
        in = p < C ? slot : spare;
        out = p < C ? slot : first;
      }
      pos[i] = p;
      if (C > 0) {
        rows_in[i] = in;
        rows_out[i] = out;
      }
    }
    __syncwarp();
    if (e >= 0 && leader) cnt[warp * stride + e] = 0;
    __syncthreads();
  }
  for (int e = tid; e < E; e += kThreads) sizes[e] = carry[e];
}

}  // namespace

// idx: contiguous int64 [n]; pos int64 [n]; sizes int32 [E]; rows_in and
// rows_out int64 [n], written only when C > 0 (else they may be null).
// Experts outside [0, E) are not counted: such a pair gets rank -1, the
// spare row and row 0 (the wrapper's callers pass top-k choices, which
// never are).
extern "C" int moe_ranks_fwd(const void* idx, void* pos, void* sizes,
                             void* rows_in, void* rows_out, int n, int E,
                             int C, void* stream) {
  if (n < 0 || n > (1 << 30) || E < 1 || E > kMaxExperts || C < 0 ||
      (C > 0 && (rows_in == nullptr || rows_out == nullptr)))
    return cudaErrorInvalidValue;
  moe_pair_ranks<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<long long*>(pos),
      static_cast<int*>(sizes), static_cast<long long*>(rows_in),
      static_cast<long long*>(rows_out), n, E, C);
  return cudaGetLastError();
}
