// Merge-rank counts for sorted index streams (Hopper, sm_90a).
//
// Replaces the TPU kernel `rank_counts(banded=False)` of
// src/repro/kernels/rank_merge.py (Pallas body `_kernel`): counts[i] =
// #{j : b_j < a_i} (strict) or <= (non-strict) over two sorted streams
// padded with SENTINEL = 0xFFFFFFFF, compared in unsigned 32-bit order.
//
// What bounds it on the card: the queries are independent and each one
// reads O(log Cb) words of b, so the work is latency of dependent loads,
// not bytes (a and the output are read and written once; b's hot top
// levels stay in L1/L2).  The TPU version is a dense Ca x Cb compare plane
// because its vector unit has no cheap data-dependent loop; here one
// thread per query runs a binary search (lower bound for '<', upper bound
// for '<='), which is O(Ca log Cb) instead of O(Ca Cb).
//
// The same kernel serves the fused k-way merge of one butterfly layer in a
// single launch (mode 2): queries are the k sorted runs of each group,
// every query is searched in the group's k-1 other runs, with '<' against
// later runs and '<=' against earlier ones (the stable tie-break of
// repro.kernels.ops.merge_sorted_runs), and its own position i is added,
// so the output is the merge rank directly.
//
// Indices arrive as int64 holding values in [0, 2^32); the low 32 bits are
// compared as uint32.  b is searched over its full length, SENTINEL pads
// included, which is exactly what the reference computes after it removes
// its own block padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a: [groups, q_per_group, na]; b: [groups, s_per_group, nb]; out like a.
// mode 0: count b <= a; mode 1: count b < a; mode 2: merge rank (a == b
// layout, skip own run q, '<' for runs s > q, '<=' for s < q, plus i).
__global__ void rank_counts_kernel(const int64_t* __restrict__ a,
                                   const int64_t* __restrict__ b,
                                   int32_t* __restrict__ out,
                                   int64_t groups, int q_per_group,
                                   int64_t na, int s_per_group, int64_t nb,
                                   int mode) {
  const int64_t total = groups * q_per_group * na;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += step) {
    const int64_t i = t % na;
    const int64_t row = t / na;
    const int q = (int)(row % q_per_group);
    const int64_t g = row / q_per_group;
    const uint32_t v = (uint32_t)a[t];
    const int64_t* runs = b + g * (int64_t)s_per_group * nb;
    int64_t count = (mode == 2) ? i : 0;
    for (int s = 0; s < s_per_group; ++s) {
      bool strict;
      if (mode == 2) {
        if (s == q) continue;
        strict = s > q;
      } else {
        strict = (mode == 1);
      }
      const int64_t* r = runs + (int64_t)s * nb;
      int64_t lo = 0, hi = nb;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        const uint32_t x = (uint32_t)__ldg(r + mid);
        if (strict ? (x < v) : (x <= v)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      count += lo;
    }
    out[t] = (int32_t)count;
  }
}

}  // namespace

extern "C" int repro_rank_counts(const void* a, const void* b, void* out,
                                 long long groups, int q_per_group,
                                 long long na, int s_per_group, long long nb,
                                 int mode, void* stream) {
  const long long total = groups * (long long)q_per_group * na;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
    rank_counts_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int32_t*)out, groups,
        q_per_group, na, s_per_group, nb, mode);
  }
  return (int)cudaGetLastError();
}
