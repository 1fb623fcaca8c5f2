// ELL sparse matrix-vector product (Hopper, sm_90a).
//
// Replaces the TPU kernel `spmv_ell` of src/repro/kernels/spmv_ell.py
// (Pallas body `_kernel`): y[r] = sum_k w[r, k] * x[cols[r, k]], with
// cols < 0 marking padding, batched over the stacked nodes of the port's
// one-card mesh (one x per batch row).  Columns must be < n: the kernel
// reads x at every non-negative column unchecked, as the plain version
// gathers it (`stack_ell(..., n_cols=)` checks the tables once on build).
//
// What bounds it on the card: bytes.  Every (col, weight) slot of the
// padded [R, K] tables is read once (8 bytes) for one multiply-add, so the
// kernel runs at the memory rate over the *padded* tables; power-law hub
// rows set K, and padding, not the real nonzeros, sets the time.  The
// design streams the tables with coalesced loads -- one warp per row, its
// 32 lanes reading consecutive slots -- and gathers x through the read-only
// cache (one node's x is tens of KB and stays resident in L1/L2), then sums
// the lanes with a fixed shuffle tree, so the result is the same on every
// run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cols, w: [batch, rows, k]; x: [batch, n]; y: [batch, rows].
__global__ void spmv_ell_kernel(const int32_t* __restrict__ cols,
                                const float* __restrict__ w,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t batch,
                                int64_t rows, int64_t k, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t total = batch * rows;
  for (int64_t row = warp; row < total; row += nwarps) {
    const int32_t* c = cols + row * k;
    const float* wr = w + row * k;
    const float* xg = x + (row / rows) * n;
    float acc = 0.f;
    for (int64_t j = lane; j < k; j += 32) {
      const int32_t col = c[j];
      if (col >= 0) acc += wr[j] * __ldg(xg + col);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) y[row] = acc;
  }
}

}  // namespace

extern "C" int repro_spmv_ell(const void* cols, const void* w, const void* x,
                              void* y, long long batch, long long rows,
                              long long k, long long n, void* stream) {
  const long long total = batch * rows;
  if (total > 0) {
    const int threads = 256;  // 8 rows (warps) per block
    long long blocks = (total + 7) / 8;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
    spmv_ell_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cols, (const float*)w, (const float*)x, (float*)y,
        batch, rows, k, n);
  }
  return (int)cudaGetLastError();
}
