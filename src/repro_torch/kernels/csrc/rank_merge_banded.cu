// Banded merge-rank counts for sorted index streams (Hopper, sm_90a).
//
// Replaces the TPU kernel `rank_counts(banded=True)` of
// src/repro/kernels/rank_merge.py (Pallas body `_banded_kernel`, block
// edges `_block_edges`, tile classes `_tile_classes`): the same counts as
// the dense kernel (rank_merge.cu), counts[i] = #{j : b_j < a_i} (strict)
// or <= (non-strict), in unsigned 32-bit order over b's full length,
// SENTINEL pads included.
//
// The TPU kernel's tile triage, kept as it is: a is cut into blocks of bm
// queries and b into blocks of bn entries, both from 0, and each (a-block,
// b-block) tile is classified from the blocks' (first, last) edges, a
// block padded past the stream's end having SENTINEL as its last edge:
// `full` (b_hi < a_lo strict, <= non-strict) adds the b-block's length to
// every query of the a-block, `skip` (b_lo >= a_hi strict, > non-strict)
// adds nothing, and only `frontier` tiles compare.
//
// What bounds it on the card: memory round trips, then the instructions
// of the shared-memory searches.  The kernel's first design found each
// query tile's window by two global binary searches per (tile, run),
// serialized behind barriers.  Here a first pass narrows b to uint32 and
// writes every b-block's edges (the TPU's prefetched `_block_edges`) and
// every run's count of entries before its SENTINEL tail.  Then one block
// takes one query tile and all the other runs at once:
//   1. classify: every thread reads edges of the other runs' blocks in
//      parallel -- one round trip.  Full blocks form a prefix of each run
//      and skipped ones a suffix, so the thread at each boundary writes its
//      run's count; no atomics;
//   2. stage: the frontier blocks of all runs go to shared memory in one
//      go, as uint32, by asynchronous copies (`cp.async`) with one wait;
//      where they do not fit (`stage_blocks` blocks) they are staged in
//      turns;
//   3. count: each thread searches each run's staged frontier (one
//      contiguous window per run) for its queries, branch-free, and adds
//      the full blocks' lengths.  One barrier per stage fill.
// A SENTINEL query needs no search: it follows every entry of a run it
// counts non-strictly and the valid entries of one it counts strictly.  So
// a tile of SENTINEL (most tiles of a padded layer) stages nothing, and
// frontier blocks of SENTINEL alone (a run's tail against a tile that
// ends in SENTINEL) are not staged, since no other query counts them.
// Asked for (`stats` not null), the blocks add their full, skipped and
// frontier tile counts into three int64 totals: the TPU classification,
// testable against `rank_tile_stats`.  Integer sums: exact and the same on
// every run.
//
// Mode 2 serves the k-way merge of one butterfly layer in one call: the
// queries are the k sorted runs of each group, each tile is counted
// against the group's k-1 other runs, with '<' against later runs and
// '<=' against earlier ones (the stable tie-break strict=(s > r) of
// repro.kernels.ops.merge_sorted_runs), plus the query's own position, so
// the output is the merge rank directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Few threads, many queries each: a block's time is its chain of round
// trips and dependent shared-memory probes, so small blocks (more of them
// per SM) whose threads interleave several searches do best (64 threads x
// 8 queries beat 128 x 4 and 256 x 2 on the card: tools/rank_sweep.py,
// PERF.md).
constexpr int THREADS = 64;
constexpr int MAX_PER_THREAD = 16;  // bm <= THREADS * MAX_PER_THREAD
constexpr uint32_t SENT = 0xFFFFFFFFu;

// b (int64) -> uint32 copy; edges[2 * (row * nbb + j) + {0, 1}] = the
// first and last entry of block j of each row (SENTINEL past the end); and
// valid[row] = the row's entries before its SENTINEL tail.  grid: (chunks
// of the row, rows).
__global__ void narrow_edges_kernel(const int64_t* __restrict__ b,
                                    uint32_t* __restrict__ b32,
                                    uint32_t* __restrict__ edges,
                                    int32_t* __restrict__ valid, int nb,
                                    int bn, int nbb) {
  const int64_t row = blockIdx.y;
  const int64_t* src = b + row * nb;
  uint32_t* dst = b32 + row * nb;
  uint32_t* row_edges = edges + 2 * row * nbb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += gridDim.x * blockDim.x) {
    const uint32_t v = (uint32_t)src[i];
    dst[i] = v;
    const int j = i / bn, e = i - j * bn;
    if (e == 0) row_edges[2 * j] = v;
    if (e == bn - 1) {
      row_edges[2 * j + 1] = v;
    } else if (i == nb - 1) {
      row_edges[2 * j + 1] = SENT;  // the block is padded past the end
    }
    if (v == SENT ? i == 0 : (i + 1 == nb || (uint32_t)src[i + 1] == SENT)) {
      valid[row] = v == SENT ? 0 : i + 1;
    }
  }
}

__host__ __device__ size_t stage_offset(int runs) {
  return ((size_t)4 * (4 * (size_t)runs + 3) + 15) / 16 * 16;
}

__device__ __forceinline__ bool below(uint32_t x, uint32_t key, bool strict) {
  return strict ? x < key : x <= key;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Adds to cnt[u] the entries of win[0, len) below v[u] (sorted win,
// len >= 1), branch-free, the QPT searches interleaved.
template <bool STRICT, int QPT>
__device__ __forceinline__ void count_below(const uint32_t* win, int len,
                                            const uint32_t (&v)[QPT],
                                            int (&cnt)[QPT]) {
  int base[QPT] = {};
  for (int n = len; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      base[u] = below(win[base[u] + half], v[u], STRICT) ? base[u] + half
                                                         : base[u];
    }
    n -= half;
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    cnt[u] += base[u] + below(win[base[u]], v[u], STRICT);
  }
}

// a: [groups, q_per_group, na] int64; b32: [groups, s_per_group, nb];
// edges: [groups, s_per_group, nbb, 2]; valid: [groups, s_per_group]; out
// like a.  mode 0: count b <= a; mode 1: count b < a; mode 2: merge rank
// (a == b layout, skip own run q, '<' for runs s > q, '<=' for s < q, plus
// i).  QPT queries per thread (bm <= THREADS * QPT).  grid: (tiles of bm
// queries, groups * q_per_group).  Dynamic shared memory: stage_offset(S)
// bytes of per-run counts, then stage_blocks * bn uint32.
template <int QPT>
__global__ void __launch_bounds__(THREADS) rank_counts_banded_kernel(
    const int64_t* __restrict__ a, const uint32_t* __restrict__ b32,
    const uint32_t* __restrict__ edges, const int32_t* __restrict__ valid,
    int32_t* __restrict__ out, unsigned long long* __restrict__ stats,
    int q_per_group, int na, int s_per_group, int nb, int mode, int bm,
    int bn, int nbb, int stage_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = mode == 2 ? s_per_group - 1 : s_per_group;  // other runs
  int* nfull = reinterpret_cast<int*>(smem);  // full blocks per run
  int* nskip = nfull + S;                     // skipped blocks per run
  int* jsent = nskip + S;   // first all-SENTINEL block per run
  int* fpre = jsent + S;    // first staged frontier block of each run
  int* totals = fpre + S + 1;  // full entries; a SENTINEL query's count
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + stage_offset(S));

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.y;
  const int q = (int)(row % q_per_group);
  const int64_t g = row / q_per_group;
  const int t0 = blockIdx.x * bm;
  const int t1 = t0 + bm < na ? t0 + bm : na;
  const int64_t* qa = a + row * na;
  const uint32_t a_lo = (uint32_t)qa[t0];
  const uint32_t a_hi = t0 + bm <= na ? (uint32_t)qa[t0 + bm - 1] : SENT;
  const uint32_t* runs32 = b32 + g * s_per_group * nb;
  const uint32_t* run_edges = edges + 2 * g * s_per_group * nbb;
  const int32_t* run_valid = valid + g * s_per_group;
  auto run_of = [&](int sp) { return mode == 2 && sp >= q ? sp + 1 : sp; };
  auto strict_of = [&](int sp) {
    return mode == 2 ? run_of(sp) > q : mode == 1;
  };
  auto sent_count = [&](int sp) {
    return strict_of(sp) ? run_valid[run_of(sp)] : nb;
  };

  uint32_t v[QPT];
  int cnt[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int t = t0 + tid + u * THREADS;
    v[u] = t < t1 ? (uint32_t)qa[t] : SENT;
    cnt[u] = 0;
  }
  auto write_out = [&](int full_len, int sent) {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int t = t0 + tid + u * THREADS;
      if (t < t1) {
        out[row * na + t] = (mode == 2 ? t : 0) +
                            (v[u] == SENT ? sent : full_len + cnt[u]);
      }
    }
  };
  // A SENTINEL query needs no search: it follows every entry of a run it
  // counts non-strictly and the valid entries of one it counts strictly.
  // A tile of SENTINEL alone (most tiles of a padded layer) is done here,
  // unless its tile classes are asked for.
  if (a_lo == SENT && stats == nullptr) {
    int sent = 0;
    for (int sp = 0; sp < S; ++sp) sent += sent_count(sp);
    write_out(0, sent);
    return;
  }

  // 1. classify every (run, block) tile from the edges.  Full blocks are a
  // prefix of each run, skipped ones a suffix, all-SENTINEL ones too: the
  // thread at each boundary writes its run's count, so nothing needs
  // setting first.  The edges of up to CLS blocks per thread are loaded
  // before any is used.
  constexpr int CLS = 4;
  for (int x0 = 0; x0 < S * nbb; x0 += CLS * THREADS) {
    uint32_t lo[CLS], hi[CLS], prev_lo[CLS], prev_hi[CLS];
#pragma unroll
    for (int w = 0; w < CLS; ++w) {
      const int x = x0 + tid + w * THREADS;
      if (x < S * nbb) {
        const int sp = x / nbb, j = x - sp * nbb;
        const uint32_t* e = run_edges + 2 * (run_of(sp) * nbb + j);
        lo[w] = e[0];
        hi[w] = e[1];
        prev_lo[w] = j > 0 ? e[-2] : 0;
        prev_hi[w] = j > 0 ? e[-1] : 0;
      }
    }
#pragma unroll
    for (int w = 0; w < CLS; ++w) {
      const int x = x0 + tid + w * THREADS;
      if (x < S * nbb) {
        const int sp = x / nbb, j = x - sp * nbb;
        const bool strict = strict_of(sp), last = j + 1 == nbb;
        const bool full = below(hi[w], a_lo, strict);
        const bool full_prev = j > 0 && below(prev_hi[w], a_lo, strict);
        if ((!full && (j == 0 || full_prev)) || (full && last)) {
          nfull[sp] = full ? nbb : j;
        }
        // skipped: b_lo >= a_hi (strict) or > a_hi: not below(b_lo, a_hi)
        const bool skip = !below(lo[w], a_hi, strict);
        const bool skip_prev = j > 0 && !below(prev_lo[w], a_hi, strict);
        if ((skip && !skip_prev) || (!skip && last)) {
          nskip[sp] = skip ? nbb - j : 0;
        }
        const bool sent = lo[w] == SENT;
        const bool sent_prev = j > 0 && prev_lo[w] == SENT;
        if ((sent && !sent_prev) || (!sent && last)) jsent[sp] = sent ? j : nbb;
      }
    }
  }
  __syncthreads();
  // per run (warp 0, 32 runs at a time): the staged frontier -- its
  // blocks from the first not full to the first skipped, without the
  // all-SENTINEL ones, which count for no query but SENTINEL -- and its
  // place in the stage (a scan), the full entries, the SENTINEL count
  if (tid < 32) {
    int f = 0, full_len = 0, sent = 0;
    long long n_full = 0, n_skip = 0;
    for (int sp0 = 0; sp0 < S; sp0 += 32) {
      const int sp = sp0 + tid;
      int staged = 0;
      if (sp < S && nbb > 0) {
        const int end = nbb - nskip[sp];
        const int mid = jsent[sp] < end ? jsent[sp] : end;
        staged = mid > nfull[sp] ? mid - nfull[sp] : 0;
        const int full_end = nfull[sp] * bn;
        full_len += full_end < nb ? full_end : nb;
        n_full += nfull[sp];
        n_skip += nskip[sp];
      }
      if (sp < S) sent += sent_count(sp);
      int scan = staged;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, scan, d);
        if (tid >= d) scan += y;
      }
      if (sp < S) fpre[sp] = f + scan - staged;
      f += __shfl_sync(0xffffffffu, scan, 31);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      full_len += __shfl_xor_sync(0xffffffffu, full_len, d);
      sent += __shfl_xor_sync(0xffffffffu, sent, d);
      n_full += __shfl_xor_sync(0xffffffffu, n_full, d);
      n_skip += __shfl_xor_sync(0xffffffffu, n_skip, d);
    }
    if (tid == 0) {
      fpre[S] = a_lo == SENT ? 0 : f;  // a tile of SENTINEL stages nothing
      totals[0] = full_len;
      totals[1] = sent;
      if (stats != nullptr) {
        atomicAdd(stats, (unsigned long long)n_full);
        atomicAdd(stats + 1, (unsigned long long)n_skip);
        atomicAdd(stats + 2,
                  (unsigned long long)((long long)S * nbb - n_full - n_skip));
      }
    }
  }
  __syncthreads();

  // 2-3. stage the frontier blocks (stage_blocks at a time) with
  // asynchronous copies, one wait, one barrier; then count
  const int F = fpre[S];
  const bool vec = (bn & 3) == 0 && (nb & 3) == 0;
  for (int c0 = 0; c0 < F; c0 += stage_blocks) {
    const int c1 = F - c0 < stage_blocks ? F : c0 + stage_blocks;
    if (c0 > 0) __syncthreads();  // the previous turn's searches are done
    // run sp's staged blocks in this turn: entries [begin, begin + len) of
    // the run at stage[at]
    auto part = [&](int sp, int& begin, int& len, int& at) {
      const int q0 = fpre[sp] > c0 ? fpre[sp] : c0;
      const int q1 = fpre[sp + 1] < c1 ? fpre[sp + 1] : c1;
      if (q0 >= q1) return false;
      begin = (nfull[sp] + q0 - fpre[sp]) * bn;
      const int end = (nfull[sp] + q1 - fpre[sp]) * bn;
      len = (end < nb ? end : nb) - begin;
      at = (q0 - c0) * bn;
      return true;
    };
    for (int sp = 0; sp < S; ++sp) {
      int begin, len, at;
      if (!part(sp, begin, len, at)) continue;
      const uint32_t* src = runs32 + (int64_t)run_of(sp) * nb + begin;
      if (vec) {
        for (int e = 4 * tid; e < len; e += 4 * THREADS) {
          cp_async16(stage + at + e, src + e);
        }
      } else {
        for (int e = tid; e < len; e += THREADS) cp_async4(stage + at + e, src + e);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (int sp = 0; sp < S; ++sp) {
      int begin, len, at;
      if (!part(sp, begin, len, at)) continue;
      if (strict_of(sp)) {
        count_below<true>(stage + at, len, v, cnt);
      } else {
        count_below<false>(stage + at, len, v, cnt);
      }
    }
  }
  write_out(totals[0], totals[1]);
}

template <int QPT>
cudaError_t launch_banded(dim3 grid, size_t smem, cudaStream_t s,
                          const int64_t* a, const uint32_t* b32,
                          const uint32_t* edges, const int32_t* valid,
                          int32_t* out, unsigned long long* stats, int q,
                          int na, int sg, int nb, int mode, int bm, int bn,
                          int nbb, int stage_blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_counts_banded_kernel<QPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rank_counts_banded_kernel<QPT><<<grid, THREADS, smem, s>>>(
      a, b32, edges, valid, out, stats, q, na, sg, nb, mode, bm, bn, nbb,
      stage_blocks);
  return cudaGetLastError();
}

int64_t blocks_of(int64_t n, int bn) { return (n + bn - 1) / bn; }

}  // namespace

// Bytes of scratch `repro_rank_counts_banded` needs: b narrowed to uint32,
// its block edges and valid counts, for `rows` rows of nb entries.
extern "C" long long repro_rank_counts_banded_scratch(long long rows,
                                                      long long nb, int bn) {
  return rows * nb * 4 + rows * blocks_of(nb, bn) * 8 + rows * 4;
}

// Shapes and modes as repro_rank_counts (rank_merge.cu); bm queries per
// tile (<= 1024), b-blocks of bn entries, at most stage_bytes of frontier
// staged at a time (at least one block).  stats: null, or three int64
// totals (full, skipped, frontier tiles) that the launch adds to.
extern "C" int repro_rank_counts_banded(const void* a, const void* b,
                                        void* out, void* scratch, void* stats,
                                        long long groups, int q_per_group,
                                        long long na, int s_per_group,
                                        long long nb, int mode, int bm,
                                        int bn, int stage_bytes,
                                        void* stream) {
  const long long rows = groups * (long long)q_per_group;
  const long long b_rows = groups * (long long)s_per_group;
  const int S = mode == 2 ? s_per_group - 1 : s_per_group;
  if (bm < 1 || bm > THREADS * MAX_PER_THREAD || bn < 1 || rows > 65535 ||
      b_rows > 65535 || S < 0 || na >= (1LL << 31) ||
      nb + bn >= (1LL << 31) ||
      (mode == 2 && (q_per_group != s_per_group || na != nb)) ||
      (mode != 2 && (q_per_group != 1 || s_per_group != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0 || na <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int nbb = (int)blocks_of(nb, bn);
  uint32_t* b32 = (uint32_t*)scratch;
  uint32_t* edges = b32 + b_rows * nb;
  int32_t* valid = (int32_t*)(edges + 2 * b_rows * nbb);
  // room for the frontier a tile meets between runs of like density (about
  // two b-blocks per run when bm == bn), within stage_bytes
  int stage_blocks = stage_bytes / (bn * 4);
  if (stage_blocks > 2 * S + 2) stage_blocks = 2 * S + 2;
  if (stage_blocks < 1) stage_blocks = 1;
  const size_t smem = stage_offset(S) + (size_t)stage_blocks * bn * 4;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (nb == 0) cudaMemsetAsync(valid, 0, b_rows * sizeof(int32_t), s);
  if (nb > 0) {
    const long long chunks = (nb + 4 * THREADS - 1) / (4 * THREADS);
    narrow_edges_kernel<<<dim3((unsigned)chunks, (unsigned)b_rows), THREADS,
                          0, s>>>((const int64_t*)b, b32, edges, valid,
                                  (int)nb, bn, nbb);
  }
  const dim3 grid((unsigned)((na + bm - 1) / bm), (unsigned)rows);
  const int qpt = (bm + THREADS - 1) / THREADS;
  cudaError_t err;
  auto go = [&](auto qpt_const) {
    return launch_banded<decltype(qpt_const)::value>(
        grid, smem, s, (const int64_t*)a, b32, edges, valid, (int32_t*)out,
        (unsigned long long*)stats, q_per_group, (int)na, s_per_group,
        (int)nb, mode, bm, bn, nbb, stage_blocks);
  };
  if (qpt == 1) {
    err = go(std::integral_constant<int, 1>());
  } else if (qpt == 2) {
    err = go(std::integral_constant<int, 2>());
  } else if (qpt <= 4) {
    err = go(std::integral_constant<int, 4>());
  } else if (qpt <= 8) {
    err = go(std::integral_constant<int, 8>());
  } else {  // bm <= THREADS * MAX_PER_THREAD
    err = go(std::integral_constant<int, MAX_PER_THREAD>());
  }
  return (int)err;
}
