// Deterministic row scatter-add through a stable counting layout (Hopper,
// sm_90a).
//
// Replaces the TPU kernels `onehot_scatter_add(scale=None)` (Pallas body
// `_kernel`, src/repro/kernels/onehot_scatter.py:41) and
// `onehot_scatter_add(scale=...)` (`_scaled_kernel`, :58), both launched by
// the `pallas_call` at :115:
// out[p, :] = sum_{i : pos_i = p} val[i, :] (* scale[i]), with every pos
// outside [0, rows) dropped (-1 pads and the `rows` drop bin).  `pos` comes
// in any order with any multiplicity per row.  Values arrive in their wire
// type -- f32, bf16 or int8 (int8 only with a scale) -- and are widened
// and scaled in registers only; sums are f32.
//
// Contract on the bits: each row is summed over its sources in increasing
// source index, from 0.f with __fadd_rn, and each scaled product is rounded
// once with __fmul_rn -- the order of the plain version on the CPU
// (`index_add_` in source order) -- so two launches give the same bits and
// no float atomics are used.
//
// What bounds it on the card: bytes, once the layout is linear.  The TPU
// multiplies a one-hot tile by the values, O(rows * C) work; the earlier
// port walked all C sources from every block of rows, also quadratic.
// Here a stable counting layout puts each row's sources next to each
// other, in increasing source order, in O(C) work per digit pass:
//   (a) per tile of TILE sources, a shared-memory histogram of one 8-bit
//       digit of the destination (`tile_hist`);
//   (b) an exclusive scan of those counts in (digit, tile) order, per node
//       (`scan_counts`);
//   (c) a stable placement of each source index (`tile_place`): its rank
//       within the tile comes from __match_any_sync inside a warp, the
//       warps taken in order, so equal digits keep their source order.
// (a)-(c) run once per digit, least significant first, over the
// destination key (dropped sources get key `rows` and sort last), i.e. a
// least-significant-digit radix sort of source indices by destination:
// ceil(bits(rows) / 8) passes, 3 at 262,144 rows.  Digit passes were
// chosen over bucketing by output block and sorting each bucket in shared
// memory because a bucket has no size bound (every source may go to one
// row); the passes take any distribution in the same memory.  Each pass
// places its tile in shared memory first and writes it out in sorted
// order, so consecutive threads store consecutive positions of a digit's
// run; the scan reads 32 consecutive counts per warp step.  Then
//   (d) `run_sum`: the thread at the first sorted position of each row's
//       run sums the run in order -- the banded kernel's summation (one
//       thread per row, sources in increasing index, each read once),
//       reading val and scale through the permutation in their wire
//       types -- into an output zeroed first, so no search finds the runs.
//       `repro_row_order` runs (a)-(c) alone, the layout as a test hook;
//       its wrapper derives the row offsets from the sorted keys.
// The wrapper allocates the scratch (`repro_row_order_scratch` ints: two
// key buffers, one permutation buffer, the tile counts -- about 12.5 bytes
// per source) and the permutation (4 bytes per source); the kernels
// allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // == RADIX: one thread per digit in the scan
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;  // sources per thread per tile
constexpr int TILE = THREADS * ITEMS;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// Destination key of source e in the first pass (pos) or a later one
// (the previous pass's keys): dropped sources get `rows`.
__device__ __forceinline__ int32_t key_of(const int32_t* __restrict__ src,
                                          int64_t e, int32_t rows,
                                          bool first) {
  const int32_t q = src[e];
  return first && (q < 0 || q >= rows) ? rows : q;
}

// (a) hist[b][d][tile] = #{sources of the tile whose key digit is d}.
__global__ void tile_hist(const int32_t* __restrict__ src, int64_t c,
                          int32_t rows, bool first, int shift,
                          int32_t* __restrict__ hist, int64_t tiles) {
  __shared__ int32_t h[RADIX];
  const int64_t b = blockIdx.y, tile = blockIdx.x;
  h[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* gs = src + b * c;
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t e = tile * TILE + i * THREADS + threadIdx.x;
    if (e < c) {
      atomicAdd(&h[(key_of(gs, e, rows, first) >> shift) & (RADIX - 1)], 1);
    }
  }
  __syncthreads();
  hist[(b * RADIX + threadIdx.x) * tiles + tile] = h[threadIdx.x];
}

// Inclusive sum of v over the warp's lanes.
__device__ __forceinline__ int32_t warp_inclusive(int32_t v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// (b) Exclusive scan of data[b][0..n) in place, one block per node.  Warp
// w scans the w-th contiguous segment 32 entries at a time (coalesced),
// after a first sweep that sums each segment.
__global__ void scan_counts(int32_t* __restrict__ data, int64_t n) {
  constexpr int SW = SCAN_THREADS / 32;
  __shared__ int32_t seg_base[SW];
  int32_t* g = data + (int64_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t seg = ((n + SW - 1) / SW + 31) / 32 * 32;
  const int64_t lo = warp * seg;
  const int64_t hi = lo + seg < n ? lo + seg : n;
  int32_t sum = 0;
  for (int64_t i = lo + lane; i < hi; i += 32) sum += g[i];
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) seg_base[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int32_t v = seg_base[lane];  // SW == 32
    const int32_t inc = warp_inclusive(v, lane);
    __syncwarp();
    seg_base[lane] = inc - v;
  }
  __syncthreads();
  int32_t run = seg_base[warp];
  for (int64_t i0 = lo; i0 < hi; i0 += 32) {
    const int64_t i = i0 + lane;
    const int32_t v = i < hi ? g[i] : 0;
    const int32_t inc = warp_inclusive(v, lane);
    if (i < hi) g[i] = run + inc - v;
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
}

// (c) Stable placement of the tile's sources by one key digit.  Warp w
// owns sources [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile and takes
// them 32 at a time in order, so (warp, round, lane) is source order.
// The tile is first placed in shared memory in its sorted order, then
// written out with consecutive threads on consecutive positions of each
// digit's run, so the stores coalesce as far as the runs are long.
__global__ void tile_place(const int32_t* __restrict__ src,
                           const int32_t* __restrict__ perm_in, int64_t c,
                           int32_t rows, bool first, int shift,
                           const int32_t* __restrict__ hist, int64_t tiles,
                           int32_t* __restrict__ keys_out,
                           int32_t* __restrict__ perm_out) {
  __shared__ int32_t wh[WARPS][RADIX];  // warp counts, then warp offsets
  __shared__ int32_t start[RADIX];      // digit's first tile position
  __shared__ int32_t shift_out[RADIX];  // global position - tile position
  __shared__ int32_t wsum[WARPS];
  __shared__ int32_t skey[TILE], sfrom[TILE];
  const int64_t b = blockIdx.y, tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int w = 0; w < WARPS; ++w) wh[w][threadIdx.x] = 0;
  __syncthreads();
  const int32_t* gs = src + b * c;
  int32_t key[ITEMS], from[ITEMS], rank[ITEMS], dig[ITEMS];
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t e = tile * TILE + (warp * ITEMS + i) * 32 + lane;
    const bool valid = e < c;
    key[i] = valid ? key_of(gs, e, rows, first) : 0;
    from[i] = valid ? (first ? (int32_t)e : perm_in[b * c + e]) : 0;
    // a lane past C gets a digit of its own, so it matches nobody
    dig[i] = valid ? (key[i] >> shift) & (RADIX - 1) : RADIX + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, dig[i]);
    const int32_t before = valid ? wh[warp][dig[i]] : 0;
    rank[i] = before + __popc(peers & lt);
    __syncwarp();
    if (valid && (peers & lt) == 0u) wh[warp][dig[i]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: warp offsets inside digit d, then the digit's tile start
  const int d = threadIdx.x;
  int32_t total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int32_t n = wh[w][d];
    wh[w][d] = total;
    total += n;
  }
  const int32_t inc = warp_inclusive(total, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int32_t before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  start[d] = before + inc - total;
  shift_out[d] = hist[(b * RADIX + d) * tiles + tile] - start[d];
  __syncthreads();
  for (int i = 0; i < ITEMS; ++i) {
    if (dig[i] < RADIX) {
      const int l = start[dig[i]] + wh[warp][dig[i]] + rank[i];
      skey[l] = key[i];
      sfrom[l] = from[i];
    }
  }
  __syncthreads();
  const int64_t left = c - tile * TILE;
  const int n = left < TILE ? (int)left : TILE;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const int32_t k = skey[j];
    const int64_t dst = b * c + shift_out[(k >> shift) & (RADIX - 1)] + j;
    keys_out[dst] = k;
    perm_out[dst] = sfrom[j];
  }
}

// (d) For each run of equal kept keys in the sorted order, the thread at
// its first position sums it in order: out[b][key] = sum over the run
// (out is zeroed first, so rows without a source stay 0).
template <typename T, bool SCALED>
__global__ void run_sum(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ perm,
                        const T* __restrict__ val,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int64_t c, int32_t rows,
                        int w) {
  const int64_t b = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= c) return;
  const int32_t* gk = keys + b * c;
  const int32_t k = gk[j];
  if (k >= rows || (j > 0 && gk[j - 1] == k)) return;
  const int32_t* gp = perm + b * c;
  const T* gv = val + b * c * w;
  const float* gs = SCALED ? scale + b * c : nullptr;
  for (int col = 0; col < w; ++col) {
    float acc = 0.f;
    for (int64_t i = j; i < c && gk[i] == k; ++i) {
      const int64_t e = gp[i];
      float v = widen(gv[e * w + col]);
      if (SCALED) v = __fmul_rn(v, gs[e]);
      acc = __fadd_rn(acc, v);
    }
    out[(b * rows + k) * w + col] = acc;
  }
}

int64_t tiles_of(int64_t c) { return (c + TILE - 1) / TILE; }

// Stages (a)-(c): scratch holds 3 * batch * c + batch * RADIX * tiles
// ints; writes the sorted permutation to `perm` and returns the sorted
// keys (inside scratch).
const int32_t* sort_by_row(const int32_t* pos, int64_t batch, int64_t c,
                           int32_t rows, int32_t* scratch, int32_t* perm,
                           cudaStream_t s) {
  const int64_t tiles = tiles_of(c);
  int32_t* keys[2] = {scratch, scratch + batch * c};
  int32_t* perm_tmp = scratch + 2 * batch * c;
  int32_t* hist = scratch + 3 * batch * c;
  int bits = 0;
  while (bits < 31 && ((int64_t)1 << bits) <= (int64_t)rows) ++bits;
  const int passes = bits > 0 ? (bits + RADIX_BITS - 1) / RADIX_BITS : 1;
  if (c > 0) {
    const dim3 grid((unsigned)tiles, (unsigned)batch);
    for (int k = 0; k < passes; ++k) {
      const bool first = k == 0;
      const int32_t* src = first ? pos : keys[(k - 1) & 1];
      // the last pass writes `perm`, the one before it `perm_tmp`, ...
      int32_t* p_out = ((passes - 1 - k) & 1) == 0 ? perm : perm_tmp;
      const int32_t* p_in = first ? nullptr
                                  : (((passes - k) & 1) == 0 ? perm : perm_tmp);
      tile_hist<<<grid, THREADS, 0, s>>>(src, c, rows, first,
                                         k * RADIX_BITS, hist, tiles);
      scan_counts<<<(unsigned)batch, SCAN_THREADS, 0, s>>>(hist,
                                                           RADIX * tiles);
      tile_place<<<grid, THREADS, 0, s>>>(src, p_in, c, rows, first,
                                          k * RADIX_BITS, hist, tiles,
                                          keys[k & 1], p_out);
    }
  }
  return keys[(passes - 1) & 1];
}

template <typename T, bool SCALED>
void launch_sum(const int32_t* keys, const int32_t* perm, const void* val,
                const void* scale, void* out, int64_t batch, int64_t c,
                int32_t rows, int w, cudaStream_t s) {
  if (c == 0) return;
  const dim3 grid((unsigned)((c + THREADS - 1) / THREADS), (unsigned)batch);
  run_sum<T, SCALED><<<grid, THREADS, 0, s>>>(
      keys, perm, (const T*)val, (const float*)scale, (float*)out, c, rows, w);
}

bool bad_shape(long long batch, long long c, long long rows) {
  return batch > 65535 || c >= 0x7fffffffLL || rows >= 0x7fffffffLL ||
         tiles_of(c) > 0x7fffffffLL;
}

}  // namespace

// Ints of scratch `repro_row_order` and `repro_onehot_scatter_add` need.
extern "C" long long repro_row_order_scratch(long long batch, long long c) {
  return 3 * batch * c + batch * RADIX * tiles_of(c);
}

// The stable layout alone: perm [batch, c], the sources sorted by
// destination, dropped ones last, each row's in increasing index.
extern "C" int repro_row_order(const void* pos, long long batch, long long c,
                               long long rows, void* scratch, void* perm,
                               void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (bad_shape(batch, c, rows) || rows < 0) return (int)cudaErrorInvalidValue;
  sort_by_row((const int32_t*)pos, batch, c, (int32_t)rows,
              (int32_t*)scratch, (int32_t*)perm, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 (int8 needs a scale).  scale: [batch,
// c] f32 per-source factor, or null.  scratch and perm: as for
// repro_row_order (scratch here).
extern "C" int repro_onehot_scatter_add(const void* pos, const void* val,
                                        const void* scale, void* out,
                                        long long batch, long long c,
                                        long long rows, int w, int dtype,
                                        void* scratch, void* perm,
                                        void* stream) {
  if (batch <= 0 || rows <= 0 || w <= 0) return (int)cudaGetLastError();
  if (bad_shape(batch, c, rows)) return (int)cudaErrorInvalidValue;
  // an empty scale tensor may come as a null pointer: nothing reads it
  const bool scaled = scale != nullptr || dtype == 2;
  if (dtype < 0 || dtype > 2 || (dtype == 2 && scale == nullptr && c > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(batch * rows * w) * 4, s);
  if (err != cudaSuccess) return (int)err;
  const int32_t* k = sort_by_row((const int32_t*)pos, batch, c, (int32_t)rows,
                                 (int32_t*)scratch, (int32_t*)perm, s);
  const int32_t* p = (const int32_t*)perm;
  const int32_t r = (int32_t)rows;
  if (dtype == 0 && !scaled) {
    launch_sum<float, false>(k, p, val, scale, out, batch, c, r, w, s);
  } else if (dtype == 0) {
    launch_sum<float, true>(k, p, val, scale, out, batch, c, r, w, s);
  } else if (dtype == 1 && !scaled) {
    launch_sum<__nv_bfloat16, false>(k, p, val, scale, out, batch, c, r, w, s);
  } else if (dtype == 1) {
    launch_sum<__nv_bfloat16, true>(k, p, val, scale, out, batch, c, r, w, s);
  } else {
    launch_sum<int8_t, true>(k, p, val, scale, out, batch, c, r, w, s);
  }
  return (int)cudaGetLastError();
}
