// Fused GRU cell: gi = mail @ W_i + b_i + extra, gh = s @ W_h + b_h, gates
// [r | z | n] at f_mem strides, out = (1 - z) * n + z * s.
//
// Replaces repro/kernels/gru_cell.py::gru_cell_pallas (body _gru_kernel).
//
// Bound on the H100: operations. At the main path's shapes (400 rows,
// f_mail = 372, f_mem = 100) it does 113.8 MFLOP in fp32, 1.698 us at
// 67 TFLOP/s, against ~2 MB of traffic. The TPU pins all of W_i in VMEM;
// here the packed weights stay in global memory (where they live in L2)
// and stream through a cp.async ring in shared memory. The whole update,
// products and gate tail, is rt::gru_update (common.cuh), which also
// serves fused_step's phase 0 and says what its design does about each
// cost of the first design: one block computes a 16-row x 8-column tile
// of the output, with 3xTF32 tensor-core products, for 13 x 25 = 325
// blocks at the main path's shapes.
#include "common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(rt::kGruThreads)
    gru_cell_kernel(const float* __restrict__ mail,
                    const float* __restrict__ s,
                    const float* __restrict__ extra,
                    const float* __restrict__ w_tc,
                    const float* __restrict__ b_i,
                    const float* __restrict__ b_h, float* __restrict__ out,
                    int n, int F, int M) {
  const int r0 = blockIdx.y * rt::kGruRows;
  const auto row_of = [&](int i) {
    const int r = r0 + i;
    if (r >= n) return rt::GruRow{nullptr, nullptr, nullptr};
    return rt::GruRow{mail + (size_t)r * F, s + (size_t)r * M,
                      extra ? extra + (size_t)r * 3 * M : nullptr};
  };
  const auto store = [&](int i, int c, float s_new, float) {
    out[(size_t)(r0 + i) * M + c] = s_new;
  };
  rt::gru_update<kVec>(row_of, F, M, w_tc, b_i, b_h, blockIdx.x, store);
}

}  // namespace

// extra may be null (no additive input-gate term). w_tc is the packed
// weight layout of ops.pack_gru_params.
extern "C" int rt_gru_cell(const float* mail, const float* s,
                           const float* extra, const float* w_tc,
                           const float* b_i, const float* b_h, float* out,
                           int n, int F, int M, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = rt::rows_aligned16(mail, F) && rt::rows_aligned16(s, M);
  const auto kernel = vec ? gru_cell_kernel<true> : gru_cell_kernel<false>;
  const int err = rt::gru_allow_smem(kernel);
  if (err) return err;
  const dim3 block(32, rt::kGruWarps);
  const dim3 grid((M + rt::kGruCols - 1) / rt::kGruCols,
                  (n + rt::kGruRows - 1) / rt::kGruRows);
  kernel<<<grid, block, rt::kGruSmemBytes, stream>>>(mail, s, extra, w_tc,
                                                      b_i, b_h, out, n, F, M);
  return (int)cudaGetLastError();
}
