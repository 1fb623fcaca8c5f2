// Band-limited deterministic row scatter-add for monotone positions
// (Hopper, sm_90a).
//
// Replaces the TPU kernels `banded_onehot_scatter_add(scale=None)` (Pallas
// body `_banded_kernel`) and `banded_onehot_scatter_add(scale=...)`
// (`_banded_scaled_kernel`) of src/repro/kernels/onehot_scatter.py:
// out[p, :] = sum_{i : pos_i = p} val[i, :] (* scale[i]) for a
// non-decreasing pos with at most `band` sources per row in [0, rows);
// rows parked at >= rows (drop bin, padding) sit at the tail and are
// dropped, as are leading entries below 0.  Values arrive in their wire
// type (f32, bf16, or int8 with a scale) and are widened and scaled in
// registers only; sums are f32.
//
// What bounds it on the card: bytes -- the kept sources' positions, values
// and scales read once and every output row written once.  The parked tail
// of pos (about 85 % of it on the union path's second butterfly layer) is
// never read.
//
// Design.  Output rows are cut into tiles of `bm` rows (a launch argument,
// `onehot_scatter.BANDED_ROWS`); tile t's sources are the window
// [first[t], first[t + 1]) with first[t] = the first i with pos[i] >=
// min(t * bm, rows).  Neighbouring windows are disjoint and adjacent, so
// every kept source is read by one block, and no block searches.
//   1. `banded_window_table` builds first[] as the TPU does (there one
//      searchsorted per output tile on the host, scalar-prefetched): every
//      boundary is searched at once by its own warp, 32 probes a round, so
//      4 round trips at 262,144 entries where each block of the previous
//      design ran two serial binary searches (18 dependent loads) before it
//      could start.
//   2. `banded_scatter_kernel` is a persistent grid (as many blocks as the
//      card holds) walking the tiles in t-major order, each tile's two
//      table entries read one tile ahead.  Most tiles lie past a node's
//      union and have an empty window: they cost 16-byte zero stores and no
//      launch or search.  A tile with sources reads its window in passes of
//      THREADS x ITEMS entries, ITEMS consecutive ones a thread (one round
//      trip a pass, the rows of the window's first and last source loaded
//      beside the first).  A source whose predecessor differs starts a run;
//      its thread sums the run in increasing source order from 0.f with
//      __fadd_rn (scales applied with __fmul_rn), in registers while the
//      run stays in its segment and from memory (lines its warp just read)
//      past it, over any length (band), and writes the row once, then the
//      zero rows up to the next source's row.  Rows of the tile before the
//      first source and after the last are zeroed by the whole block.
// Every output row is written exactly once and no float atomics are used,
// so the bits are those of the plain version and the same on every run.
// The kernel does not need `band`; a pos that breaks the precondition gives
// a wrong sum but is never written outside its tile.  Indices within a
// batch row are 32-bit (c <= 2^31 - 2^16, rows < 2^31 - 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TABLE_THREADS = 128;  // four boundaries per block
constexpr int THREADS = 256;        // scatter block
constexpr int ITEMS = 4;            // window entries per thread and pass
constexpr int MIN_BLOCKS = 4;       // scatter blocks an SM must hold

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

template <typename T, bool SCALED>
__device__ __forceinline__ float source(const T* __restrict__ v,
                                        const float* __restrict__ s, int i,
                                        int w, int col) {
  const float x = widen(v[(int64_t)i * w + col]);
  return SCALED ? __fmul_rn(x, s[i]) : x;
}

// o[lo, hi) = 0 by the whole block: 16-byte stores between scalar edges.
__device__ void zero_rows(float* __restrict__ o, int64_t lo, int64_t hi) {
  if (hi <= lo) return;
  const int64_t mis = (int64_t)(((uintptr_t)(o + lo) >> 2) & 3);
  const int64_t head = min(hi - lo, (4 - mis) & 3);
  if (threadIdx.x < head) o[lo + threadIdx.x] = 0.f;
  float4* body = reinterpret_cast<float4*>(o + lo + head);
  const int64_t n4 = (hi - lo - head) >> 2;
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
    body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int64_t i = lo + head + 4 * n4 + threadIdx.x; i < hi; i += blockDim.x) {
    o[i] = 0.f;
  }
}

// first[b * nb + t] = first i with pos[b, i] >= min(t * bm, rows), one warp
// per boundary.  Invariant: the answer lies in [lo, hi]; each round's 32
// probes cut (lo, hi) into 33 pieces, and since pos is non-decreasing the
// lanes whose probe is below the key form a prefix.
__global__ void __launch_bounds__(TABLE_THREADS)
    banded_window_table(const int32_t* __restrict__ pos,
                        int64_t* __restrict__ first, int64_t batch, int64_t c,
                        int64_t rows, int64_t bm, int64_t nb) {
  const int64_t warp =
      ((int64_t)blockIdx.x * TABLE_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= batch * nb) return;  // uniform over the warp
  const int64_t b = warp / nb, t = warp - b * nb;
  const int64_t key = min(t * bm, rows);
  const int32_t* p = pos + b * c;
  int64_t lo = 0, hi = c;
  while (hi - lo > 32) {
    const int64_t n = hi - lo;
    const int64_t q = lo + (lane + 1) * n / 33;
    const int m = __popc(__ballot_sync(0xffffffffu, (int64_t)p[q] < key));
    const int64_t nlo = m ? lo + m * n / 33 + 1 : lo;  // past probe m - 1
    hi = m < 32 ? lo + (m + 1) * n / 33 : hi;          // at probe m
    lo = nlo;
  }
  const bool below = lo + lane < hi && (int64_t)p[lo + lane] < key;
  const int m = __popc(__ballot_sync(0xffffffffu, below));
  if (lane == 0) first[warp] = lo + m;
}

// Tile `tile`'s window [w0, w1) from the table (t-major tile order).
__device__ __forceinline__ void window(const int64_t* __restrict__ first,
                                       int64_t tile, int64_t batch,
                                       int64_t nb, int& w0, int& w1) {
  const int64_t t = tile / batch, g = tile - t * batch;
  w0 = (int)first[g * nb + t];
  w1 = (int)first[g * nb + t + 1];
}

// The end of a run: tile row r gets `acc` in column 0 and its other columns
// summed over the run's sources [j, e) in order; then, when the window goes
// on, the rows up to `next` (the next source's row) are zeroed.  Rows
// outside [0, nrow) are never written.
template <typename T, bool SCALED>
__device__ __forceinline__ void finish_run(float* __restrict__ o,
                                           const T* __restrict__ gv,
                                           const float* __restrict__ gs,
                                           int r, float acc, int j, int e,
                                           int next, bool more, int nrow,
                                           int w) {
  const bool mine = r >= 0 && r < nrow;
  if (mine) o[(int64_t)r * w] = acc;
  for (int col = 1; col < w; ++col) {
    float a = 0.f;
    for (int i = j; i < e; ++i) {
      a = __fadd_rn(a, source<T, SCALED>(gv, gs, i, w, col));
    }
    if (mine) o[(int64_t)r * w + col] = a;
  }
  if (more) {
    for (int64_t x = (int64_t)max(r + 1, 0) * w; x < (int64_t)next * w; ++x) {
      o[x] = 0.f;
    }
  }
}

// pos: [batch, c] int32; val: [batch, c, w] T; scale: [batch, c] f32 or
// null; first: [batch, nb] window table; out: [batch, rows, w] f32.  Block
// b takes tiles b, b + gridDim.x, ... in t-major order (the same tile of
// every batch row, then the next), so every block gets a like share of full
// and empty tiles.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    banded_scatter_kernel(const int32_t* __restrict__ pos,
                          const T* __restrict__ val,
                          const float* __restrict__ scale,
                          const int64_t* __restrict__ first,
                          float* __restrict__ out, int64_t batch, int64_t c,
                          int64_t rows, int w, int bm, int64_t nb) {
  const int lane = threadIdx.x & 31;
  const int64_t total = batch * (nb - 1);
  int w0 = 0, w1 = 0;  // the window of the block's next tile
  if (blockIdx.x < total) window(first, blockIdx.x, batch, nb, w0, w1);
  for (int64_t tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int64_t t = tile / batch, g = tile - t * batch;
    const int p0 = (int)(t * bm), nrow = (int)min((int64_t)bm, rows - p0);
    const int u0 = w0, u1 = w1;
    if (tile + gridDim.x < total) {
      window(first, tile + gridDim.x, batch, nb, w0, w1);
    }
    float* o = out + (g * rows + p0) * w;
    if (u1 <= u0) {
      zero_rows(o, 0, (int64_t)nrow * w);
      continue;
    }
    const int32_t* gp = pos + g * c;
    const T* gv = val + g * c * w;
    const float* gs = SCALED ? scale + g * c : nullptr;
    const int32_t p_first = gp[u0], p_last = gp[u1 - 1];
    for (int base = u0; base < u1; base += THREADS * ITEMS) {
      const int j0 = base + threadIdx.x * ITEMS;
      int32_t p[ITEMS];
      float v[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        p[k] = j0 + k < u1 ? gp[j0 + k] : 0;
        v[k] = j0 + k < u1 ? source<T, SCALED>(gv, gs, j0 + k, w, 0) : 0.f;
      }
      // the entry before the segment: the left neighbour's last, or memory
      int32_t prev = __shfl_up_sync(0xffffffffu, p[ITEMS - 1], 1);
      if (lane == 0 && j0 > u0 && j0 < u1) prev = gp[j0 - 1];
      if (j0 >= u1) continue;
      // sources at the segment's start that continue a run begun before it
      // belong to that run's head; every run that starts here is summed here
      bool skip = j0 > u0, open = false;
      int32_t row = 0;
      int head = 0;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int j = j0 + k;
        if (j >= u1) break;
        if (skip) {
          if (p[k] == prev) continue;
          skip = false;
        }
        if (open && p[k] == row) {
          acc = __fadd_rn(acc, v[k]);
          continue;
        }
        if (open) {
          finish_run<T, SCALED>(o, gv, gs, row - p0, acc, head, j,
                                min(max(p[k] - p0, 0), nrow), true, nrow, w);
        }
        open = true;
        row = p[k];
        head = j;
        acc = __fadd_rn(0.f, v[k]);
      }
      if (open) {  // the last run may go on past the segment
        int e = j0 + ITEMS, next = nrow;
        for (; e < u1; ++e) {
          const int32_t pe = gp[e];
          if (pe != row) {
            next = min(max(pe - p0, 0), nrow);
            break;
          }
          acc = __fadd_rn(acc, source<T, SCALED>(gv, gs, e, w, 0));
        }
        finish_run<T, SCALED>(o, gv, gs, row - p0, acc, head, min(e, u1),
                              next, e < u1, nrow, w);
      }
    }
    // rows of the tile before the window's first source and after its last
    const int lead = min(max(p_first - p0, 0), nrow);
    const int tail = (int)min(max((int64_t)p_last + 1 - p0, (int64_t)lead),
                              (int64_t)nrow);
    zero_rows(o, 0, (int64_t)lead * w);
    zero_rows(o, (int64_t)tail * w, (int64_t)nrow * w);
  }
}

int64_t tiles(int64_t rows, int64_t bm) { return (rows + bm - 1) / bm; }

cudaError_t table(const void* pos, void* first, long long batch, long long c,
                  long long rows, long long bm, cudaStream_t stream) {
  const int64_t nb = tiles(rows, bm) + 1;
  const int64_t blocks = (batch * nb * 32 + TABLE_THREADS - 1) / TABLE_THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  banded_window_table<<<(unsigned)blocks, TABLE_THREADS, 0, stream>>>(
      (const int32_t*)pos, (int64_t*)first, batch, c, rows, bm, nb);
  return cudaGetLastError();
}

// Blocks of the persistent grid: as many as the card holds at once
// (asked once per device, then kept: a host-bound call pays for each query).
template <typename T, bool SCALED>
int64_t resident_blocks() {
  static int64_t known[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && known[dev] > 0) return known[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, banded_scatter_kernel<T, SCALED>, THREADS, 0);
  const int64_t n = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) known[dev] = n;
  return n;
}

template <typename T, bool SCALED>
void launch(const void* pos, const void* val, const void* scale, void* out,
            const void* first, long long batch, long long c, long long rows,
            int w, long long bm, cudaStream_t stream) {
  const int64_t t = tiles(rows, bm);
  const int64_t most = resident_blocks<T, SCALED>();
  const int64_t grid = batch * t < most ? batch * t : most;
  banded_scatter_kernel<T, SCALED><<<(unsigned)grid, THREADS, 0, stream>>>(
      (const int32_t*)pos, (const T*)val, (const float*)scale,
      (const int64_t*)first, (float*)out, batch, c, rows, w, (int)bm, t + 1);
}

// 32-bit indices within a batch row (a pass may look up to THREADS x ITEMS
// entries past c); the tile grid in 64 bits.
bool shape_ok(long long c, long long rows, long long bm) {
  return bm > 0 && bm < (1LL << 31) && c <= (1LL << 31) - (1 << 16) &&
         rows < (1LL << 31) - 1;
}

}  // namespace

// The window table alone: first: [batch, ceil(rows / bm) + 1] int64.
extern "C" int repro_banded_windows(const void* pos, void* first,
                                    long long batch, long long c,
                                    long long rows, long long bm,
                                    void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (rows < 0 || !shape_ok(c, rows, bm)) return (int)cudaErrorInvalidValue;
  return (int)table(pos, first, batch, c, rows, bm, (cudaStream_t)stream);
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (int8 needs a scale).  scale: [batch,
// c] f32 per-source factor, or null.  first: scratch for the window table,
// [batch, ceil(rows / bm) + 1] int64.
extern "C" int repro_banded_onehot_scatter_add(
    const void* pos, const void* val, const void* scale, void* out,
    long long batch, long long c, long long rows, int w, int dtype,
    void* first, long long bm, void* stream) {
  if (batch <= 0 || rows <= 0 || w <= 0) return (int)cudaGetLastError();
  if (!shape_ok(c, rows, bm)) return (int)cudaErrorInvalidValue;
  const bool scaled = scale != nullptr;
  if ((dtype == 2 && !scaled) || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = table(pos, first, batch, c, rows, bm, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0 && !scaled) {
    launch<float, false>(pos, val, scale, out, first, batch, c, rows, w, bm, s);
  } else if (dtype == 0) {
    launch<float, true>(pos, val, scale, out, first, batch, c, rows, w, bm, s);
  } else if (dtype == 1 && !scaled) {
    launch<__nv_bfloat16, false>(pos, val, scale, out, first, batch, c, rows,
                                 w, bm, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, true>(pos, val, scale, out, first, batch, c, rows,
                                w, bm, s);
  } else {
    launch<int8_t, true>(pos, val, scale, out, first, batch, c, rows, w, bm,
                         s);
  }
  return (int)cudaGetLastError();
}
