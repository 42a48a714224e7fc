// LUT time encode: out[r, :] = table[bucket(dt[r]), :].
//
// Replaces repro/kernels/lut_time_encode.py::lut_encode_pallas (body
// _lut_kernel, row fetch lut_rows). On the TPU the row fetch is a one-hot
// matmul on the MXU; here it is an indexed load of one table row.
//
// Bound on the H100: bytes. At the main path's shapes (400 rows, E = 128,
// D = 300) it moves ~0.64 MB (the table once, the rows out) and does no
// arithmetic beyond 128 compares per row, so one launch costs about what
// launching costs. Design: one warp per row; the warp buckets dt together
// (rt::lut_bucket) and then copies the row with coalesced 32-lane loads
// and stores.
#include "common.cuh"

namespace {

__global__ void lut_encode_kernel(const float* __restrict__ dt,
                                  const float* __restrict__ bounds,
                                  const float* __restrict__ table,
                                  float* __restrict__ out, int n, int E,
                                  int D) {
  const int r = blockIdx.x * rt::kRows + threadIdx.y;
  const int b = rt::lut_bucket(r < n ? dt[r] : 0.f, bounds, E);
  if (r >= n) return;
  const float* src = table + (size_t)b * D;
  float* dst = out + (size_t)r * D;
  for (int c = threadIdx.x; c < D; c += rt::kCols) dst[c] = src[c];
}

}  // namespace

extern "C" int rt_lut_encode(const float* dt, const float* bounds,
                             const float* table, float* out, int n, int E,
                             int D, cudaStream_t stream) {
  if (n > 0) {
    const dim3 block(rt::kCols, rt::kRows);
    const dim3 grid((n + rt::kRows - 1) / rt::kRows);
    lut_encode_kernel<<<grid, block, 0, stream>>>(dt, bounds, table, out, n,
                                                  E, D);
  }
  return (int)cudaGetLastError();
}
