// Band-limited deterministic row scatter-add for monotone positions
// (Hopper, sm_90a).
//
// Replaces the TPU kernels `banded_onehot_scatter_add(scale=None)` (Pallas
// body `_banded_kernel`) and `banded_onehot_scatter_add(scale=...)`
// (`_banded_scaled_kernel`) of src/repro/kernels/onehot_scatter.py:
// out[p, :] = sum_{i : pos_i = p} val[i, :] (* scale[i]) for a
// non-decreasing pos with at most `band` sources per row in [0, rows);
// rows parked at >= rows (drop bin, padding) sit at the tail and are
// dropped.  Values arrive in their wire type (f32, bf16, or int8 with a
// scale) and are widened and scaled in registers only; sums are f32.
//
// What bounds it on the card: bytes.  The TPU builds a start-block table on
// the host (searchsorted per output tile, scalar-prefetched) so each output
// tile multiplies only ceil(band*bm/bk)+1 one-hot input tiles.  Here each
// block owns BM output rows [p0, p0 + BM) and finds its own sources with
// two binary searches over pos -- the window [first_at_least(p0),
// first_at_least(min(p0 + BM, rows))), which holds at most band * BM entries
// and never reaches past C.  Neighbouring blocks' windows are disjoint and
// adjacent, so every source is read once: the block stages its window in
// shared memory with coalesced loads, CHUNK entries at a time, and each
// thread (one output row) binary-searches the chunk for its own contiguous
// run and sums it in source order.  No atomics: the sums are the same on
// every run, in the order of the dense kernel and the plain version.  The
// kernel does not need `band` (the window is found, not bounded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;      // output rows per block == threads
constexpr int CHUNK = 2048;  // staged window entries per pass

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// First index of p[0..n) whose value is >= key (p non-decreasing).
__device__ int64_t first_at_least(const int32_t* __restrict__ p, int64_t n,
                                  int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)p[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// pos: [batch, c] int32; val: [batch, c, w] T; scale: [batch, c] f32 or
// null; out: [batch, rows, w] f32.
template <typename T, bool SCALED>
__global__ void banded_scatter_kernel(const int32_t* __restrict__ pos,
                                      const T* __restrict__ val,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int64_t c,
                                      int64_t rows, int w) {
  __shared__ int32_t spos[CHUNK];
  __shared__ float sval[CHUNK];
  __shared__ int64_t win[2];
  const int64_t g = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * BM;
  const int64_t p = p0 + threadIdx.x;
  const int32_t* gp = pos + g * c;
  const T* gv = val + g * c * w;
  const float* gs = SCALED ? scale + g * c : nullptr;
  if (threadIdx.x == 0) win[0] = first_at_least(gp, c, p0);
  if (threadIdx.x == 32) {
    win[1] = first_at_least(gp, c, (p0 + BM < rows) ? p0 + BM : rows);
  }
  __syncthreads();
  const int64_t w0 = win[0], w1 = win[1];
  for (int col = 0; col < w; ++col) {
    float acc = 0.f;
    for (int64_t base = w0; base < w1; base += CHUNK) {
      const int n = (int)((w1 - base) < CHUNK ? (w1 - base) : CHUNK);
      __syncthreads();  // the previous chunk's sums are done with the stage
      for (int j = threadIdx.x; j < n; j += BM) {
        const int64_t e = base + j;
        spos[j] = gp[e];
        float v = widen(gv[e * w + col]);
        if (SCALED) v = __fmul_rn(v, gs[e]);
        sval[j] = v;
      }
      __syncthreads();
      if (p < rows) {
        int lo = 0, hi = n;  // first staged source of row p
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((int64_t)spos[mid] < p) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        for (int j = lo; j < n && (int64_t)spos[j] == p; ++j) {
          acc = __fadd_rn(acc, sval[j]);
        }
      }
    }
    if (p < rows) out[(g * rows + p) * w + col] = acc;
  }
}

template <typename T, bool SCALED>
void launch(const void* pos, const void* val, const void* scale, void* out,
            long long batch, long long c, long long rows, int w,
            cudaStream_t stream) {
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)batch);
  banded_scatter_kernel<T, SCALED><<<grid, BM, 0, stream>>>(
      (const int32_t*)pos, (const T*)val, (const float*)scale, (float*)out, c,
      rows, w);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (int8 needs a scale).  scale: [batch,
// c] f32 per-source factor, or null.
extern "C" int repro_banded_onehot_scatter_add(const void* pos,
                                               const void* val,
                                               const void* scale, void* out,
                                               long long batch, long long c,
                                               long long rows, int w,
                                               int dtype, void* stream) {
  if (batch > 0 && rows > 0 && w > 0) {
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool scaled = scale != nullptr;
    if (dtype == 0 && !scaled) {
      launch<float, false>(pos, val, scale, out, batch, c, rows, w, s);
    } else if (dtype == 0) {
      launch<float, true>(pos, val, scale, out, batch, c, rows, w, s);
    } else if (dtype == 1 && !scaled) {
      launch<__nv_bfloat16, false>(pos, val, scale, out, batch, c, rows, w, s);
    } else if (dtype == 1) {
      launch<__nv_bfloat16, true>(pos, val, scale, out, batch, c, rows, w, s);
    } else if (dtype == 2 && scaled) {
      launch<int8_t, true>(pos, val, scale, out, batch, c, rows, w, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
