// Deterministic row scatter-add (Hopper, sm_90a).
//
// Replaces the TPU kernels `onehot_scatter_add(scale=None)` (Pallas body
// `_kernel`) and `onehot_scatter_add(scale=...)` (`_scaled_kernel`) of
// src/repro/kernels/onehot_scatter.py:
// out[p, :] = sum_{i : pos_i = p} val[i, :] (* scale[i]), with every pos
// outside [0, num_rows) dropped (-1 pads and the num_rows drop bin).  The
// values arrive in their wire type -- f32, bf16 or int8 (int8 only with a
// scale) -- and are widened and scaled in registers only, so the narrow
// payload is never rebuilt as 4-byte values in memory; sums are f32.
//
// What bounds it on the card: the TPU version multiplies a one-hot tile by
// the values on the matrix unit, O(rows * C) work.  A float atomicAdd
// scatter would read each input once, but its sums would depend on the
// order the atomics land in, and the fused merge needs the same bits on
// every run.  So each block owns BM output rows (one thread per row) and
// walks the sources in index order, which fixes the summation order: for
// every row the sum is taken over its sources in increasing i.  The walk
// stages BM positions at a time in shared memory, and a block-wide vote
// (__syncthreads_or) skips every chunk that holds no source of the block's
// rows, without loading its values.  In the fused merge each run's
// destinations ascend, so a block's sources sit in about one window per
// run and most chunks are skipped; the compare work stays O(rows * C) only
// for adversarial orders.  It is bounded by those compares, not by bytes.
// The scaled product is rounded once (__fmul_rn, never fused into the
// add), as the plain version computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;  // output rows per block == threads == chunk length

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// pos: [batch, c] int32; val: [batch, c, w] T; scale: [batch, c] f32 or
// null; out: [batch, rows, w] f32.
template <typename T, bool SCALED>
__global__ void onehot_scatter_kernel(const int32_t* __restrict__ pos,
                                      const T* __restrict__ val,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int64_t c,
                                      int64_t rows, int w) {
  __shared__ int32_t spos[BM];
  __shared__ float sval[BM];
  const int64_t g = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * BM;
  const int64_t p = p0 + threadIdx.x;
  const int32_t* gp = pos + g * c;
  const T* gv = val + g * c * w;
  const float* gs = SCALED ? scale + g * c : nullptr;
  for (int col = 0; col < w; ++col) {
    float acc = 0.f;
    for (int64_t c0 = 0; c0 < c; c0 += BM) {
      const int64_t e = c0 + threadIdx.x;
      const int32_t q = e < c ? gp[e] : -1;
      const bool mine = q >= p0 && q < p0 + BM && q < rows;
      __syncthreads();  // the previous chunk's scan is done with spos/sval
      spos[threadIdx.x] = q;
      if (__syncthreads_or(mine)) {
        float v = 0.f;
        if (e < c) {
          v = widen(gv[e * w + col]);
          if (SCALED) v = __fmul_rn(v, gs[e]);
        }
        sval[threadIdx.x] = v;
        __syncthreads();
        const int n = (int)((c - c0) < BM ? (c - c0) : BM);
        for (int j = 0; j < n; ++j) {
          if (spos[j] == p) acc = __fadd_rn(acc, sval[j]);
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
  onehot_scatter_kernel<T, SCALED><<<grid, BM, 0, stream>>>(
      (const int32_t*)pos, (const T*)val, (const float*)scale, (float*)out, c,
      rows, w);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (int8 needs a scale).  scale: [batch,
// c] f32 per-source factor, or null.
extern "C" int repro_onehot_scatter_add(const void* pos, const void* val,
                                        const void* scale, void* out,
                                        long long batch, long long c,
                                        long long rows, int w, int dtype,
                                        void* stream) {
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
