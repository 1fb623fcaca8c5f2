// Banded merge-rank counts for sorted index streams (Hopper, sm_90a).
//
// Replaces the TPU kernel `rank_counts(banded=True)` of
// src/repro/kernels/rank_merge.py (Pallas body `_banded_kernel`, block
// edges `_block_edges`, tile classes `_tile_classes`): the same counts as
// the dense kernel (rank_merge.cu), counts[i] = #{j : b_j < a_i} (strict)
// or <= (non-strict), in unsigned 32-bit order over b's full length,
// SENTINEL pads included.
//
// What bounds it on the card: the TPU kernel resolves every (a-block,
// b-block) tile off the merge frontier from the blocks' min/max edges --
// wholly below adds bn, wholly above adds nothing -- and compares only the
// frontier tiles.  Here a block takes a tile of bm queries of a with edges
// a_lo = a[first] and a_hi = a[last] (a is sorted).  Two binary searches
// over b give the window [w0, w1) that straddles the tile: every b before
// w0 counts for every query of the tile (the TPU's `full` tiles, one
// constant), none after w1 does (the `skip` tiles).  The block stages only
// the window in shared memory, bn entries at a time with coalesced loads,
// and each thread binary-searches its queries in the staged chunk.  Every
// entry of b inside a window is read once per tile, so the kernel moves
// about the bytes of a, the windows and the output, with O(log) compares
// per query; latency of the two global searches per (tile, run) is what
// remains.
//
// Mode 2 serves the k-way merge of one butterfly layer in one launch: the
// queries are the k sorted runs of each group, each tile is counted
// against the group's k-1 other runs in turn, with '<' against later runs
// and '<=' against earlier ones (the stable tie-break strict=(s > r) of
// repro.kernels.ops.merge_sorted_runs), plus the query's own position, so
// the output is the merge rank directly.  Sums are integers: the result is
// exact and the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PER_THREAD = 4;  // bm <= THREADS * MAX_PER_THREAD

// #{j < n : r[j] < key} (strict) or <= key, r sorted (uint32 order).
__device__ int64_t count_below(const int64_t* __restrict__ r, int64_t n,
                               uint32_t key, bool strict) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const uint32_t x = (uint32_t)__ldg(r + mid);
    if (strict ? (x < key) : (x <= key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// a: [groups, q_per_group, na]; b: [groups, s_per_group, nb]; out like a.
// mode 0: count b <= a; mode 1: count b < a; mode 2: merge rank (a == b
// layout, skip own run q, '<' for runs s > q, '<=' for s < q, plus i).
// grid: (tiles of bm queries, groups * q_per_group); dynamic shared
// memory: bn uint32.
__global__ void rank_counts_banded_kernel(const int64_t* __restrict__ a,
                                          const int64_t* __restrict__ b,
                                          int32_t* __restrict__ out,
                                          int q_per_group, int64_t na,
                                          int s_per_group, int64_t nb,
                                          int mode, int bm, int bn) {
  extern __shared__ uint32_t sb[];
  __shared__ int64_t win[2];
  const int64_t row = blockIdx.y;
  const int q = (int)(row % q_per_group);
  const int64_t g = row / q_per_group;
  const int64_t t0 = (int64_t)blockIdx.x * bm;
  const int64_t t1 = (t0 + bm < na) ? t0 + bm : na;
  const int64_t* qa = a + row * na;
  const uint32_t a_lo = (uint32_t)qa[t0];
  const uint32_t a_hi = (uint32_t)qa[t1 - 1];

  uint32_t v[MAX_PER_THREAD];
  int64_t cnt[MAX_PER_THREAD];
  for (int u = 0; u < MAX_PER_THREAD; ++u) {
    const int64_t t = t0 + threadIdx.x + (int64_t)u * THREADS;
    v[u] = t < t1 ? (uint32_t)qa[t] : 0u;
    cnt[u] = (mode == 2 && t < t1) ? t : 0;
  }

  for (int s = 0; s < s_per_group; ++s) {
    bool strict;
    if (mode == 2) {
      if (s == q) continue;
      strict = s > q;
    } else {
      strict = (mode == 1);
    }
    const int64_t* r = b + (g * s_per_group + s) * nb;
    __syncthreads();  // every thread is done with win and sb of run s-1
    if (threadIdx.x == 0) win[0] = count_below(r, nb, a_lo, strict);
    if (threadIdx.x == 32) win[1] = count_below(r, nb, a_hi, strict);
    __syncthreads();
    const int64_t w0 = win[0], w1 = win[1];
    for (int u = 0; u < MAX_PER_THREAD; ++u) cnt[u] += w0;
    for (int64_t base = w0; base < w1; base += bn) {
      const int n = (int)((w1 - base) < bn ? (w1 - base) : bn);
      __syncthreads();  // the previous chunk's searches are done with sb
      for (int j = threadIdx.x; j < n; j += THREADS) {
        sb[j] = (uint32_t)__ldg(r + base + j);
      }
      __syncthreads();
      for (int u = 0; u < MAX_PER_THREAD; ++u) {
        const int64_t t = t0 + threadIdx.x + (int64_t)u * THREADS;
        if (t >= t1) break;
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (strict ? (sb[mid] < v[u]) : (sb[mid] <= v[u])) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        cnt[u] += lo;
      }
    }
  }
  for (int u = 0; u < MAX_PER_THREAD; ++u) {
    const int64_t t = t0 + threadIdx.x + (int64_t)u * THREADS;
    if (t < t1) out[row * na + t] = (int32_t)cnt[u];
  }
}

}  // namespace

extern "C" int repro_rank_counts_banded(const void* a, const void* b,
                                        void* out, long long groups,
                                        int q_per_group, long long na,
                                        int s_per_group, long long nb,
                                        int mode, int bm, int bn,
                                        void* stream) {
  if (bm < 1 || bm > THREADS * MAX_PER_THREAD || bn < 1 ||
      bn > 12288) {  // bn * 4 bytes within the 48 KB default shared memory
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = groups * (long long)q_per_group;
  if (rows > 0 && na > 0) {
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((na + bm - 1) / bm), (unsigned)rows);
    rank_counts_banded_kernel<<<grid, THREADS, (size_t)bn * sizeof(uint32_t),
                                (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int32_t*)out, q_per_group, na,
        s_per_group, nb, mode, bm, bn);
  }
  return (int)cudaGetLastError();
}
