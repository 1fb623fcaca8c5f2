// Stacked-CSR sparse matrix-vector product (Hopper, sm_90a).
//
// Replaces the TPU kernel `spmv_ell` of src/repro/kernels/spmv_ell.py:34
// (Pallas body `_kernel`, `pallas_call` at :42) on PageRank's main path:
// y[r] = sum_j wts[j] * x[node(r) * n + cols[j]] over j in
// [row_ptr[r], row_ptr[r + 1]), for the block-diagonal CSR of all stacked
// nodes (`graph.engine.stack_csr`): row r belongs to node r / n_rows and
// its columns are node-local, so x is read at node * n + col.  Columns
// must be < n: the kernel reads x unchecked (`stack_csr(n_cols=)` checks
// the tables once on build).
//
// What bounds it on the card: bytes -- each nonzero's (col, w) pair (8
// bytes) is read once for one multiply-add, plus the row offsets, x and y.
// The ELL layout padded every row to the global max row length (hub rows
// of thousands against a mean of about 2.5), so the ELL kernel streamed
// the padding; here nothing is padded.  What is left is balance: row
// lengths follow a power law, so a warp per row idles most lanes on short
// rows and runs long on hubs.  The host (`kernels.spmv_csr.csr_bins`, run
// once per graph by `stack_csr`) cuts the rows into bins, and each block
// takes one bin, so the kernel searches nothing.  The bin limits (long_row,
// bin_nnz, bin_rows) are launch arguments, set where `csr_bins` is, so the
// two cannot drift apart; they also size the dynamic shared memory:
//   * a short bin holds consecutive rows, at most bin_rows of them with at
//     most bin_nnz nonzeros in all, none longer than long_row, and never
//     straddles two nodes.  The block stages the bin's products w * x[col]
//     in shared memory with coalesced loads of (col, w) -- all threads
//     busy, whatever the row lengths -- then each thread sums its rows'
//     runs in order;
//   * a long bin is one row with more than long_row nonzeros.  The whole
//     block strides over it and sums its 256 partial sums with a fixed
//     tree.
// No atomics: each row is summed in one fixed order, so two launches give
// the same bits.  Any other bin (one the host would not make) takes the
// long path row by row, which is right for any bin, only slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 48 * 1024;  // without an opt-in attribute

// Sum of v over the block's threads in a fixed order (all threads call).
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free (an earlier call has read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  }
  return s;  // valid on thread 0
}

// row_ptr: [R + 1] (IdxT); cols, w: [nnz]; x: [R / n_rows, n]; y: [R];
// bins: [nbins + 1] row starts of the bins.  Dynamic shared memory:
// srp (IdxT [bin_rows + 1]) then prod (float [bin_nnz]).
template <typename IdxT>
__global__ void spmv_csr_kernel(const IdxT* __restrict__ row_ptr,
                                const int32_t* __restrict__ cols,
                                const float* __restrict__ w,
                                const float* __restrict__ x,
                                float* __restrict__ y,
                                const int32_t* __restrict__ bins,
                                int64_t n_rows, int64_t n, int long_row,
                                int bin_nnz, int bin_rows) {
  extern __shared__ __align__(8) unsigned char smem[];
  IdxT* srp = reinterpret_cast<IdxT*>(smem);
  float* prod = reinterpret_cast<float*>(srp + bin_rows + 1);
  __shared__ float red[THREADS / 32];
  const int64_t r0 = bins[blockIdx.x], r1 = bins[blockIdx.x + 1];
  const int64_t rows = r1 - r0;
  const int64_t n0 = (int64_t)row_ptr[r0], n1 = (int64_t)row_ptr[r1];
  const int64_t nnz = n1 - n0;
  const bool short_bin = rows <= bin_rows && nnz <= bin_nnz &&
                         !(rows == 1 && nnz > long_row) &&
                         r0 / n_rows == (r1 - 1) / n_rows;
  if (short_bin) {
    const float* xg = x + (r0 / n_rows) * n;
    for (int64_t j = threadIdx.x; j < nnz; j += THREADS) {
      prod[j] = __fmul_rn(w[n0 + j], __ldg(xg + cols[n0 + j]));
    }
    for (int64_t r = threadIdx.x; r <= rows; r += THREADS) {
      srp[r] = row_ptr[r0 + r];
    }
    __syncthreads();
    for (int64_t r = threadIdx.x; r < rows; r += THREADS) {
      float acc = 0.f;
      const int64_t e = (int64_t)srp[r + 1] - n0;
      for (int64_t j = (int64_t)srp[r] - n0; j < e; ++j) {
        acc = __fadd_rn(acc, prod[j]);
      }
      y[r0 + r] = acc;
    }
    return;
  }
  for (int64_t r = r0; r < r1; ++r) {
    const float* xg = x + (r / n_rows) * n;
    const int64_t e = (int64_t)row_ptr[r + 1];
    float acc = 0.f;
    for (int64_t j = (int64_t)row_ptr[r] + threadIdx.x; j < e; j += THREADS) {
      acc = __fadd_rn(acc, __fmul_rn(w[j], __ldg(xg + cols[j])));
    }
    const float s = block_sum(acc, red);
    if (threadIdx.x == 0) y[r] = s;
  }
}

}  // namespace

// row_ptr is int64 when rowptr64 != 0, else int32.  n_rows: rows per node;
// n: length of each node's x; long_row, bin_nnz, bin_rows: the limits
// `csr_bins` cut the bins with.
extern "C" int repro_spmv_csr(const void* row_ptr, const void* cols,
                              const void* w, const void* x, void* y,
                              const void* bins, long long nbins,
                              long long n_rows, long long n, int rowptr64,
                              int long_row, int bin_nnz, int bin_rows,
                              void* stream) {
  if (nbins > 0) {
    const long long smem =
        (long long)(bin_rows + 1) * (rowptr64 ? 8 : 4) + 4LL * bin_nnz;
    if (nbins > 0x7fffffffLL || n_rows <= 0 || long_row < 0 ||
        bin_nnz < 0 || bin_rows < 1 || smem > SMEM_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (rowptr64) {
      spmv_csr_kernel<int64_t><<<(unsigned)nbins, THREADS, (size_t)smem, s>>>(
          (const int64_t*)row_ptr, (const int32_t*)cols, (const float*)w,
          (const float*)x, (float*)y, (const int32_t*)bins, n_rows, n,
          long_row, bin_nnz, bin_rows);
    } else {
      spmv_csr_kernel<int32_t><<<(unsigned)nbins, THREADS, (size_t)smem, s>>>(
          (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)w,
          (const float*)x, (float*)y, (const int32_t*)bins, n_rows, n,
          long_row, bin_nnz, bin_rows);
    }
  }
  return (int)cudaGetLastError();
}
