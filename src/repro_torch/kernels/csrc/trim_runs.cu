// Run compaction of the union path's gathered chunk (Hopper, sm_90a).
//
// Replaces no TPU kernel.  The JAX package trims the gathered union with
// plain array operations (a cumulative sum of the valid flags, then a
// scatter of every slot), and the port did the same with torch ops; on an
// NVIDIA H100 80GB HBM3 that trim was the largest block of a mini-batch
// reduce (25 of 41 ms at 64 nodes, 16 x 4).  This kernel computes the same
// function from what the butterfly guarantees about its input: after the
// up-gathers each chunk (one batch row b) of C slots is S = C / L equal
// runs of L slots, each sorted with its valid rows first and SENTINEL
// (2^32 - 1, the largest key) after them.  Output row b holds the runs'
// valid prefixes laid end to end, the first `cap` of them: int64 indices
// and rows of `row_bytes` bytes of values (copied, never summed), SENTINEL
// and zero bytes after.
//
// What bounds it on the card: bytes -- each kept row read once (8 B of
// index and row_bytes of values) and every output slot written once.  At
// the mini-batch shape (64 chunks of 64 runs x 65,536 slots, about 1.44 M
// kept rows each, cap 2^21, float32 values) that is 2.72 GB, 0.81 ms at
// 3.35 TB/s.  The scan-and-scatter read and wrote all S * L slots several
// times over, with int64 temporaries of that size.
//
// Design.  Two launches on the caller's stream; no host synchronisation.
//   1. `trim_runs_count_kernel`, one block a chunk: a run's count is the
//      position of its first SENTINEL, found by a binary search (log2 L + 1
//      loads, no other slot read); the block then scans the S counts into
//      exclusive offsets off[b, 0..S] (scratch the wrapper allocates).
//   2. `trim_runs_copy_kernel`, output-driven: one block a tile of T
//      consecutive output slots of one chunk (T a launch argument, so that
//      a tile is about TILE_BYTES whatever the row width).  The block
//      stages its chunk's offsets in shared memory (searched in global
//      memory when S is too large), finds the runs of its first and last
//      kept slot once, and maps slot o < min(off[S], cap) to row o - off[s]
//      of the run s with off[s] <= o < off[s + 1] (a search only when the
//      tile spans two runs or more).  Slots past the union get SENTINEL and
//      zeros in the same pass, so every output slot is written exactly
//      once and the wrapper allocates its outputs with torch.empty.  The
//      indices move as 8-byte words, one slot a thread; the values as
//      units of u bytes, u the largest of 16, 8, 4, 2, 1 that divides the
//      row and both value pointers, so both sides stay aligned whatever
//      the destination offset of a run (a row is a whole number of units,
//      so no copy has a ragged head or tail), and a wide row (W values) is
//      one contiguous run of units.  Stores are consecutive across a warp;
//      so are the loads within a run.  Each thread keeps K loads in flight
//      before its stores.
// Chunk-local slots are 32-bit (C < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long SENTINEL = 0xFFFFFFFFLL;
constexpr int THREADS = 256;
constexpr int K = 4;                  // loads in flight a thread
constexpr int TILE_MAX = 4096;        // output slots a block
constexpr long long TILE_BYTES = 64 * 1024;
constexpr int OFF_SMEM = 1025;        // offsets staged in shared memory

// Block-wide inclusive scan of one value a thread (all threads call).
__device__ long long block_scan(long long v, long long* warp_sums,
                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();  // warp_sums is free for the next call
  *total = all;
  return v + before;
}

// idx: [B, C]; off: [B, S + 1] (out).
__global__ void trim_runs_count_kernel(const long long* __restrict__ idx,
                                       long long c, long long l, int s_runs,
                                       long long* __restrict__ off) {
  __shared__ long long warp_sums[THREADS / 32];
  const long long* chunk = idx + blockIdx.x * c;
  long long* o = off + blockIdx.x * (long long)(s_runs + 1);
  long long carry = 0;
  for (int base = 0; base < s_runs; base += THREADS) {
    const int s = base + threadIdx.x;
    long long n = 0;
    if (s < s_runs) {
      const long long* run = chunk + (long long)s * l;
      long long lo = 0, hi = l;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (run[mid] >= SENTINEL) hi = mid; else lo = mid + 1;
      }
      n = lo;
    }
    long long chunk_total;
    const long long incl = block_scan(n, warp_sums, &chunk_total);
    if (s < s_runs) o[s + 1] = carry + incl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) o[0] = 0;
}

// The largest s in [lo, hi] with offs[s] <= o (offs non-decreasing and
// offs[lo] <= o).
__device__ __forceinline__ int run_of(const long long* offs, int lo, int hi,
                                      long long o) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= o) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// idx: [B, C]; val: [B, C, nu] units; off: [B, S + 1]; out_idx: [B, cap];
// out_val: [B, cap, nu].  Block x covers tile x % tiles of chunk x / tiles.
template <typename U>
__global__ void trim_runs_copy_kernel(const long long* __restrict__ idx,
                                      const U* __restrict__ val,
                                      const long long* __restrict__ off,
                                      long long* __restrict__ out_idx,
                                      U* __restrict__ out_val, long long c,
                                      long long l, int s_runs, long long cap,
                                      int tile, long long tiles, int nu) {
  __shared__ long long soff[OFF_SMEM];
  __shared__ int src[TILE_MAX];  // chunk slot of each tile slot, -1 past it
  __shared__ int bounds[2];
  const long long b = blockIdx.x / tiles;
  const long long o0 = (blockIdx.x % tiles) * tile;
  const int rows = (int)min((long long)tile, cap - o0);
  const long long* offs = off + b * (long long)(s_runs + 1);
  if (s_runs < OFF_SMEM) {
    for (int i = threadIdx.x; i <= s_runs; i += THREADS) soff[i] = offs[i];
    __syncthreads();
    offs = soff;
  }
  const long long kept = min(offs[s_runs], cap) - o0;
  const int nvalid = (int)max(0LL, min((long long)rows, kept));
  if (threadIdx.x == 0 && nvalid > 0) {
    bounds[0] = run_of(offs, 0, s_runs - 1, o0);
    bounds[1] = run_of(offs, bounds[0], s_runs - 1, o0 + nvalid - 1);
  }
  __syncthreads();
  const int s_lo = bounds[0], s_hi = bounds[1];

  const long long* cidx = idx + b * c;
  long long* oidx = out_idx + b * cap + o0;
  for (int t0 = threadIdx.x; t0 < rows; t0 += K * THREADS) {
    long long v[K];
    int sr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k * THREADS;
      sr[k] = -1;
      if (t < nvalid) {
        const long long o = o0 + t;
        const int r = s_lo == s_hi ? s_lo : run_of(offs, s_lo, s_hi, o);
        sr[k] = (int)(r * l + (o - offs[r]));
      }
      v[k] = sr[k] >= 0 ? cidx[sr[k]] : SENTINEL;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k * THREADS;
      if (t < rows) {
        oidx[t] = v[k];
        src[t] = sr[k];
      }
    }
  }
  if (nu == 0) return;
  __syncthreads();

  const U* cval = val + b * c * nu;
  U* oval = out_val + (b * cap + o0) * nu;
  const int units = rows * nu;
  for (int q0 = threadIdx.x; q0 < units; q0 += K * THREADS) {
    U v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = q0 + k * THREADS;
      v[k] = U{};
      if (q < units) {
        const int t = nu == 1 ? q : q / nu;
        const int s = src[t];
        if (s >= 0) v[k] = cval[(long long)s * nu + (q - t * nu)];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = q0 + k * THREADS;
      if (q < units) oval[q] = v[k];
    }
  }
}

template <typename U>
void copy(const void* idx, const void* val, const void* off, void* out_idx,
          void* out_val, long long batch, long long c, long long l,
          int s_runs, long long cap, int tile, long long tiles, int nu,
          cudaStream_t s) {
  trim_runs_copy_kernel<U><<<(unsigned)(batch * tiles), THREADS, 0, s>>>(
      (const long long*)idx, (const U*)val, (const long long*)off,
      (long long*)out_idx, (U*)out_val, c, l, s_runs, cap, tile, tiles, nu);
}

}  // namespace

// idx: int64 [batch, c], c = S * l; val: [batch, c] rows of row_bytes
// bytes; off: scratch int64 [batch, S + 1]; out_idx: int64 [batch, cap];
// out_val: [batch, cap] rows of row_bytes bytes.
extern "C" int repro_trim_runs(const void* idx, const void* val, void* off,
                               void* out_idx, void* out_val, long long batch,
                               long long c, long long l, long long cap,
                               long long row_bytes, void* stream) {
  if (batch <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (l <= 0 || c < 0 || c % l || c >= (1LL << 31) || row_bytes < 0 ||
      cap >= (1LL << 62)) {
    return (int)cudaErrorInvalidValue;
  }
  int u = 16;
  while (row_bytes % u || (uintptr_t)val % u || (uintptr_t)out_val % u) {
    u >>= 1;
  }
  const long long nu = row_bytes / u;
  long long tile = 1;
  while (tile * 2 <= TILE_MAX && tile * 2 * (8 + row_bytes) <= TILE_BYTES) {
    tile *= 2;
  }
  const long long tiles = (cap + tile - 1) / tile;
  if (tile * nu >= (1LL << 31) || batch * tiles >= (1LL << 31) ||
      batch >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int s_runs = (int)(c / l);
  cudaStream_t s = (cudaStream_t)stream;
  trim_runs_count_kernel<<<(unsigned)batch, THREADS, 0, s>>>(
      (const long long*)idx, c, l, s_runs, (long long*)off);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int t = (int)tile, n = (int)nu;
  switch (u) {
    case 16:
      copy<uint4>(idx, val, off, out_idx, out_val, batch, c, l, s_runs, cap,
                  t, tiles, n, s);
      break;
    case 8:
      copy<uint2>(idx, val, off, out_idx, out_val, batch, c, l, s_runs, cap,
                  t, tiles, n, s);
      break;
    case 4:
      copy<uint32_t>(idx, val, off, out_idx, out_val, batch, c, l, s_runs,
                     cap, t, tiles, n, s);
      break;
    case 2:
      copy<uint16_t>(idx, val, off, out_idx, out_val, batch, c, l, s_runs,
                     cap, t, tiles, n, s);
      break;
    default:
      copy<uint8_t>(idx, val, off, out_idx, out_val, batch, c, l, s_runs,
                    cap, t, tiles, n, s);
  }
  return (int)cudaGetLastError();
}
