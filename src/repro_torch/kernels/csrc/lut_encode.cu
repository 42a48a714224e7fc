// LUT time encode: out[r, :] = table[bucket(dt[r]), :].
//
// Replaces repro/kernels/lut_time_encode.py::lut_encode_pallas (body
// _lut_kernel, row fetch lut_rows). On the TPU the row fetch is a one-hot
// matmul on the MXU; here it is an indexed copy of one table row.
//
// Bound on the H100: bytes. At the main path's shapes (400 rows, E = 128,
// D = 300) it moves ~0.6 MB (the rows read, the rows out) and does no
// arithmetic beyond 128 compares a row: 0.18 us, well under what a launch
// costs (rt_noop below launches an empty kernel of the same grid, so the
// launch floor can be timed beside the kernel). So the design is a short
// dependency chain in every warp and enough blocks to spread the rows:
//
//   - a warp a row, kLutWarps rows a block: 100 blocks of 128 threads at
//     400 rows (the first design had 25 blocks of 512 threads);
//   - the bucket costs one round trip: dt[r] and each lane's float4 of
//     bounds (rt::lut_buckets; 128 bounds are one float4 a lane) load
//     together, then 4 compares and a 5-step butterfly;
//   - the row copy issues all of a lane's loads of a pass (kLutPass
//     copies, 16 bytes each where the table, the output and D allow it,
//     4 bytes otherwise, chosen per launch) before its first store: at
//     D = 300, 75 float4s, one pass of at most 3 loads a lane.
#include "common.cuh"

namespace {

// T: float4 (16-byte copies) or float (4-byte copies).
template <class T>
__global__ void __launch_bounds__(32 * rt::kLutWarps) lut_encode_kernel(
    const float* __restrict__ dt, const float* __restrict__ bounds,
    const float* __restrict__ table, float* __restrict__ out, int n, int E,
    int D) {
  const int r = blockIdx.x * rt::kLutWarps + threadIdx.y;
  if (r >= n) return;                   // the whole warp: one row
  const float d[1] = {dt[r]};
  int b[1];
  rt::lut_buckets<1>(d, bounds, E, b);
  constexpr int kW = sizeof(T) / sizeof(float);
  const T* src = reinterpret_cast<const T*>(table + (size_t)b[0] * D);
  T* dst = reinterpret_cast<T*>(out + (size_t)r * D);
  const int nc = D / kW;
  for (int c0 = threadIdx.x; c0 < nc; c0 += 32 * rt::kLutPass) {
    T v[rt::kLutPass];
#pragma unroll
    for (int p = 0; p < rt::kLutPass; ++p)
      if (c0 + 32 * p < nc) v[p] = __ldg(src + c0 + 32 * p);
#pragma unroll
    for (int p = 0; p < rt::kLutPass; ++p)
      if (c0 + 32 * p < nc) dst[c0 + 32 * p] = v[p];
  }
}

// The same grid, block and arguments, and no work: the launch floor.
__global__ void __launch_bounds__(32 * rt::kLutWarps) noop_kernel(
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, float* __restrict__, int, int, int) {}

dim3 lut_grid(int n) {
  return dim3((n + rt::kLutWarps - 1) / rt::kLutWarps);
}

}  // namespace

// bounds: ops.sentinel_bounds's layout, 16-byte aligned.
extern "C" int rt_lut_encode(const float* dt, const float* bounds,
                             const float* table, float* out, int n, int E,
                             int D, cudaStream_t stream) {
  if (n > 0) {
    const auto kernel =
        rt::rows_aligned16(table, D) && rt::rows_aligned16(out, D)
            ? lut_encode_kernel<float4>
            : lut_encode_kernel<float>;
    kernel<<<lut_grid(n), dim3(32, rt::kLutWarps), 0, stream>>>(
        dt, bounds, table, out, n, E, D);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_noop(const float* dt, const float* bounds,
                       const float* table, float* out, int n, int E, int D,
                       cudaStream_t stream) {
  if (n > 0)
    noop_kernel<<<lut_grid(n), dim3(32, rt::kLutWarps), 0, stream>>>(
        dt, bounds, table, out, n, E, D);
  return (int)cudaGetLastError();
}
