// Fused GRU cell: gi = mail @ W_i + b_i + extra, gh = s @ W_h + b_h, gates
// [r | z | n] at f_mem strides, out = (1 - z) * n + z * s.
//
// Replaces repro/kernels/gru_cell.py::gru_cell_pallas (body _gru_kernel).
//
// Bound on the H100: operations. At the main path's shapes (400 rows,
// f_mail = 372, f_mem = 100) it does 2 * 400 * 472 * 300 = 113 MFLOP in
// fp32 against ~2 MB of traffic. The TPU pins all of W_i in VMEM; in fp32
// W_i is 372 x 300 x 4 = 446 KB, more than the 227 KB a block may use, so
// here the weights stay in global memory (where they live in L2) and each
// block streams them through shared memory in 32-deep tiles
// (rt::project), reusing each tile for its 16 rows. One block computes a
// 16-row x 32-column tile of all three gates, so the gate tail
// (rt::gru_gate) runs in registers with no round trip.
#include "common.cuh"

namespace {

__global__ void gru_cell_kernel(const float* __restrict__ mail,
                                const float* __restrict__ s,
                                const float* __restrict__ extra,
                                const float* __restrict__ w_i,
                                const float* __restrict__ w_h,
                                const float* __restrict__ b_i,
                                const float* __restrict__ b_h,
                                float* __restrict__ out, int n, int F, int M) {
  const int r = blockIdx.y * rt::kRows + threadIdx.y;
  const int col0 = blockIdx.x * rt::kCols;
  const int c = col0 + threadIdx.x;
  const bool row_ok = r < n;
  const rt::Row mail_row{row_ok ? mail + (size_t)r * F : nullptr};
  const rt::Row mem_row{row_ok ? s + (size_t)r * M : nullptr};
  const float* extra_row =
      (row_ok && extra) ? extra + (size_t)r * 3 * M : nullptr;
  const float s_prev = (row_ok && c < M) ? s[(size_t)r * M + c] : 0.f;
  const float s_new = rt::gru_update(mail_row, F, mem_row, M, w_i, w_h, b_i,
                                     b_h, extra_row, col0, s_prev);
  if (row_ok && c < M) out[(size_t)r * M + c] = s_new;
}

}  // namespace

// extra may be null (no additive input-gate term).
extern "C" int rt_gru_cell(const float* mail, const float* s,
                           const float* extra, const float* w_i,
                           const float* w_h, const float* b_i,
                           const float* b_h, float* out, int n, int F, int M,
                           cudaStream_t stream) {
  if (n > 0) {
    const dim3 block(rt::kCols, rt::kRows);
    const dim3 grid((M + rt::kCols - 1) / rt::kCols,
                    (n + rt::kRows - 1) / rt::kRows);
    gru_cell_kernel<<<grid, block, 0, stream>>>(mail, s, extra, w_i, w_h, b_i,
                                                b_h, out, n, F, M);
  }
  return (int)cudaGetLastError();
}
