// Fused post-prune step of one batch of R vertex rows: returns
// h (R, f_emb) and s_upd (R, f_mem).
//
// Replaces repro/kernels/fused_step.py::fused_step_pallas (body
// _fused_kernel), the paper's single-pass datapath (Fig. 4).
//
//   phase 0 (MUU)  gather the mail and memory rows of vids, add the
//                  GRU-folded LUT row of dt_mail, GRU update; rows with
//                  mail_ok == 0 keep s_prev. Writes s_upd.
//   phase 1 (EU)   per row, the k winners' memory rows (read from s_upd
//                  when hit >= 0: the vertex was updated by this batch, and
//                  s_upd[hit] is its committed memory) and edge rows;
//                  v = [s || e] @ W_v + LUT_folded[bucket(sel_dt)] + b_v;
//                  masked softmax; FAM; h = [s_upd || agg] @ W_out + b_out.
//
// Phase order. The TPU gets MUU -> EU from its sequential (2, T) grid and a
// batch-wide VMEM scratch. CUDA blocks run in no order, so the phases are
// two kernels launched back to back on one stream: phase 0 writes s_upd to
// global memory (it is an output anyway) and phase 1 reads it through hit.
//
// Row gathers. The TPU fetches one row per DMA with an immediate wait.
// Phase 0 runs rt::gru_update (common.cuh), as gru_cell does: its 16 rows
// are gathered through vids by per-row cp.async copies into a ring of
// shared-memory stages (TMA cannot gather rows), so the next stage loads
// while the tensor cores multiply this one; the GRU-folded LUT row of each
// row's bucket (rt::lut_bucket, one warp per row) is its extra row, and
// the mail_ok select is the store. Phase 1 keeps the first design: every
// warp owns one row, reads its own indices once, and the block streams
// the rows through shared memory in 32-wide coalesced pieces (rt::project
// with a gathering loader), so no neighbour tensor, kv concat or LUT-row
// tensor is ever written to device memory.
//
// Bound on the H100: operations at the main path's shapes (R = 400, k = 4,
// f_mem = d = f_emb = 100, f_edge = 172, f_mail = 372): 113.8 MFLOP in
// phase 0 and ~95 MFLOP in phase 1, in fp32 (3.249 us at 67 TFLOP/s for
// the step), against ~1.5 MB of gathered rows and weights. Phase 0 runs
// 13 x 25 = 325 blocks of 128 threads (see rt::gru_update for what that
// design does about the first one's costs). Phase 1 runs one block per
// 16 / k batch rows, which holds the whole aggregate row of its batch rows
// in shared memory for the output transform.
#include "common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(rt::kGruThreads) fused_muu_kernel(
    const int32_t* __restrict__ vids, const float* __restrict__ dt_mail,
    const uint8_t* __restrict__ mail_ok, const float* __restrict__ memory,
    const float* __restrict__ mail, const float* __restrict__ w_tc,
    const float* __restrict__ b_i, const float* __restrict__ b_h,
    const float* __restrict__ g_bounds, const float* __restrict__ g_table,
    float* __restrict__ s_upd, int R, int M, int F, int E) {
  __shared__ int sbucket[rt::kGruRows];
  const int r0 = blockIdx.y * rt::kGruRows;
  for (int i = threadIdx.y; i < rt::kGruRows; i += rt::kGruWarps) {
    const int r = r0 + i;
    const int b = rt::lut_bucket(r < R ? dt_mail[r] : 0.f, g_bounds, E);
    if (threadIdx.x == 0) sbucket[i] = b;
  }
  __syncthreads();
  const auto row_of = [&](int i) {
    const int r = r0 + i;
    if (r >= R) return rt::GruRow{nullptr, nullptr, nullptr};
    const size_t v = (size_t)vids[r];
    return rt::GruRow{mail + v * F, memory + v * M,
                      g_table + (size_t)sbucket[i] * 3 * M};
  };
  const auto store = [&](int i, int c, float s_new, float s_prev) {
    const int r = r0 + i;
    s_upd[(size_t)r * M + c] = mail_ok[r] ? s_new : s_prev;
  };
  rt::gru_update<kVec>(row_of, F, M, w_tc, b_i, b_h, blockIdx.x, store);
}

__global__ void fused_eu_kernel(
    const int32_t* __restrict__ sel_ids, const int32_t* __restrict__ sel_eid,
    const int32_t* __restrict__ hit, const float* __restrict__ sel_dt,
    const float* __restrict__ sel_logits, const uint8_t* __restrict__ sel_valid,
    const float* __restrict__ memory, const float* __restrict__ edge_feats,
    const float* __restrict__ s_upd, const float* __restrict__ w_v,
    const float* __restrict__ b_v, const float* __restrict__ s_bounds,
    const float* __restrict__ s_table, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ h, int R, int k,
    int M, int Fe, int D, int Femb, int E, int bpb) {
  extern __shared__ float sagg[];                  // (bpb, D) aggregates
  __shared__ float sv[rt::kRows][rt::kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.x * bpb;

  // this warp's winner row: memory row (redirected through hit) || edge row
  const int f = b0 * k + ty;
  const bool nbr_ok = ty < bpb * k && f < R * k;
  const float* mem_row = nullptr;
  const float* edge_row = nullptr;
  if (nbr_ok) {
    const int hr = hit[f];
    mem_row = hr >= 0 ? s_upd + (size_t)hr * M
                      : memory + (size_t)sel_ids[f] * M;
    edge_row = edge_feats + (size_t)sel_eid[f] * Fe;
  }
  const rt::Concat2 nbr{mem_row, M, edge_row};
  const int bucket = rt::lut_bucket(nbr_ok ? sel_dt[f] : 0.f, s_bounds, E);

  const int b = b0 + ty;                           // batch row of warps < bpb
  const bool out_ok = ty < bpb && b < R;
  for (int col0 = 0; col0 < D; col0 += rt::kCols) {
    const int c = col0 + tx;
    float acc[1];
    rt::project<1>(nbr, M + Fe, w_v, D, 0, col0, D, acc);
    sv[ty][tx] = (nbr_ok && c < D)
                     ? acc[0] + s_table[(size_t)bucket * D + c] + b_v[c]
                     : 0.f;
    __syncthreads();
    if (out_ok && c < D)
      sagg[ty * D + c] = rt::softmax_fam(
          sel_logits + (size_t)b * k, sel_valid + (size_t)b * k, k,
          &sv[ty * k][tx], rt::kCols);
    __syncthreads();
  }

  // output transform over [s_upd row || aggregate row]
  const rt::Concat2 self{out_ok ? s_upd + (size_t)b * M : nullptr, M,
                         out_ok ? sagg + ty * D : nullptr};
  for (int col0 = 0; col0 < Femb; col0 += rt::kCols) {
    const int c = col0 + tx;
    float acc[1];
    rt::project<1>(self, M + D, w_out, Femb, 0, col0, Femb, acc);
    if (out_ok && c < Femb) h[(size_t)b * Femb + c] = acc[0] + b_out[c];
  }
}

}  // namespace

// Both phases on one stream; k must be in [1, 16]. s_upd is written by
// phase 0 and read by phase 1. w_tc is the packed GRU weight layout of
// ops.pack_gru_params.
extern "C" int rt_fused_step(
    const int32_t* vids, const int32_t* sel_ids, const int32_t* sel_eid,
    const int32_t* hit, const float* dt_mail, const uint8_t* mail_ok,
    const float* sel_dt, const float* sel_logits, const uint8_t* sel_valid,
    const float* memory, const float* mail, const float* edge_feats,
    const float* w_tc, const float* b_i, const float* b_h,
    const float* g_bounds, const float* g_table, const float* w_v,
    const float* b_v, const float* s_bounds, const float* s_table,
    const float* w_out, const float* b_out, float* h, float* s_upd, int R,
    int k, int M, int F, int Fe, int D, int Femb, int E,
    cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const bool vec =
      rt::rows_aligned16(mail, F) && rt::rows_aligned16(memory, M);
  const auto muu = vec ? fused_muu_kernel<true> : fused_muu_kernel<false>;
  int err = rt::gru_allow_smem(muu);
  if (err) return err;
  const dim3 block0(32, rt::kGruWarps);
  const dim3 grid0((M + rt::kGruCols - 1) / rt::kGruCols,
                   (R + rt::kGruRows - 1) / rt::kGruRows);
  muu<<<grid0, block0, rt::kGruSmemBytes, stream>>>(
      vids, dt_mail, mail_ok, memory, mail, w_tc, b_i, b_h, g_bounds, g_table,
      s_upd, R, M, F, E);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int bpb = rt::kRows / k;
  const size_t smem = (size_t)bpb * D * sizeof(float);
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(fused_eu_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
  }
  const dim3 block1(rt::kCols, rt::kRows);
  const dim3 grid1((R + bpb - 1) / bpb);
  fused_eu_kernel<<<grid1, block1, smem, stream>>>(
      sel_ids, sel_eid, hit, sel_dt, sel_logits, sel_valid, memory,
      edge_feats, s_upd, w_v, b_v, s_bounds, s_table, w_out, b_out, h, R, k,
      M, Fe, D, Femb, E, bpb);
  return (int)cudaGetLastError();
}
