// Deterministic row scatter-add (Hopper, sm_90a).
//
// Replaces the TPU kernel `onehot_scatter_add(scale=None)` of
// src/repro/kernels/onehot_scatter.py (Pallas body `_kernel`):
// out[p, :] = sum_{i : pos_i = p} val[i, :], with every pos outside
// [0, num_rows) dropped (-1 pads and the num_rows drop bin).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;  // output rows per block == threads == chunk length

// pos: [batch, c] int32; val: [batch, c, w] f32; out: [batch, rows, w] f32.
__global__ void onehot_scatter_kernel(const int32_t* __restrict__ pos,
                                      const float* __restrict__ val,
                                      float* __restrict__ out, int64_t c,
                                      int64_t rows, int w) {
  __shared__ int32_t spos[BM];
  __shared__ float sval[BM];
  const int64_t g = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * BM;
  const int64_t p = p0 + threadIdx.x;
  const int32_t* gp = pos + g * c;
  const float* gv = val + g * c * w;
  for (int col = 0; col < w; ++col) {
    float acc = 0.f;
    for (int64_t c0 = 0; c0 < c; c0 += BM) {
      const int64_t e = c0 + threadIdx.x;
      const int32_t q = e < c ? gp[e] : -1;
      const bool mine = q >= p0 && q < p0 + BM && q < rows;
      __syncthreads();  // the previous chunk's scan is done with spos/sval
      spos[threadIdx.x] = q;
      if (__syncthreads_or(mine)) {
        sval[threadIdx.x] = e < c ? gv[e * w + col] : 0.f;
        __syncthreads();
        const int n = (int)((c - c0) < BM ? (c - c0) : BM);
        for (int j = 0; j < n; ++j) {
          if (spos[j] == p) acc += sval[j];
        }
      }
    }
    if (p < rows) out[(g * rows + p) * w + col] = acc;
  }
}

}  // namespace

extern "C" int repro_onehot_scatter_add(const void* pos, const void* val,
                                        void* out, long long batch,
                                        long long c, long long rows, int w,
                                        void* stream) {
  if (batch > 0 && rows > 0 && w > 0) {
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)batch);
    onehot_scatter_kernel<<<grid, BM, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pos, (const float*)val, (float*)out, c, rows, w);
  }
  return (int)cudaGetLastError();
}
