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
// batch-wide VMEM scratch. CUDA blocks run in no order, so the step is
// three kernels launched back to back on one stream: phase 0 writes s_upd
// to global memory (it is an output anyway); phase 1's EU kernel reads it
// through hit and writes the aggregates to agg, an (R, D) scratch the
// wrapper allocates (160 KB at the main path's shapes, resident in L2);
// the output transform reads s_upd and agg.
//
// Row gathers. The TPU fetches one row per DMA with an immediate wait.
// Here every phase gathers its rows with per-row cp.async copies into a
// ring of shared-memory stages (TMA cannot gather rows), so the next
// stages load while the tensor cores multiply this one. Phase 0 runs
// rt::gru_update (common.cuh), as gru_cell does: its 16 rows are gathered
// through vids; the GRU-folded LUT row of each row's bucket is its extra
// row, and the mail_ok select is the store. The EU runs rt::sat_eu, as
// sat_aggregate does, on two sources: the winner's memory row (through
// hit and sel_ids) and its edge row (through sel_eid), so no neighbour
// tensor, kv concat or LUT-row tensor is ever written to device memory.
// The output transform runs rt::tc_tile over the rows [s_upd || agg].
//
// Bound on the H100: operations at the main path's shapes (R = 400, k = 4,
// f_mem = d = f_emb = 100, f_edge = 172, f_mail = 372): 113.8 MFLOP in
// phase 0 and ~104 MFLOP in phase 1, in fp32 (3.249 us at 67 TFLOP/s for
// the step), against ~1.5 MB of gathered rows and weights.
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
  {  // each warp buckets its rows warp + j * kGruWarps together
    constexpr int kPerWarp = rt::kGruRows / rt::kGruWarps;
    static_assert(rt::kGruRows % rt::kGruWarps == 0, "whole rows a warp");
    float d[kPerWarp];
    int b[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int r = r0 + threadIdx.y + j * rt::kGruWarps;
      d[j] = r < R ? dt_mail[r] : 0.f;
    }
    rt::lut_buckets<kPerWarp>(d, g_bounds, E, b);
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j)
      if (threadIdx.x == 0) sbucket[threadIdx.y + j * rt::kGruWarps] = b[j];
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

template <bool kVec>
__global__ void __launch_bounds__(rt::EuShape::kThreads) fused_eu_kernel(
    const int32_t* __restrict__ sel_ids, const int32_t* __restrict__ sel_eid,
    const int32_t* __restrict__ hit, const float* __restrict__ sel_dt,
    const float* __restrict__ sel_logits, const uint8_t* __restrict__ sel_valid,
    const float* __restrict__ memory, const float* __restrict__ edge_feats,
    const float* __restrict__ s_upd, const float* __restrict__ wv_tc,
    const float* __restrict__ b_v, const float* __restrict__ s_bounds,
    const float* __restrict__ s_table, float* __restrict__ agg, int R, int k,
    int M, int Fe, int D, int E) {
  // winner f: its memory row (redirected through hit) || its edge row
  const auto nbr_of = [&](int f) {
    const int hr = hit[f];
    return rt::TcRow{hr >= 0 ? s_upd + (size_t)hr * M
                             : memory + (size_t)sel_ids[f] * M,
                     edge_feats + (size_t)sel_eid[f] * Fe};
  };
  const auto store = [&](int b, int c, float x) {
    agg[(size_t)b * D + c] = x;
  };
  rt::sat_eu<rt::EuShape, kVec>(nbr_of, R, k, M, Fe, sel_dt, sel_logits,
                                sel_valid, wv_tc, b_v, s_bounds, s_table, D,
                                E, store);
}

// h = [s_upd || agg] @ W_out + b_out
template <bool kVec>
__global__ void __launch_bounds__(rt::OutShape::kThreads) fused_out_kernel(
    const float* __restrict__ s_upd, const float* __restrict__ agg,
    const float* __restrict__ wout_tc, const float* __restrict__ b_out,
    float* __restrict__ h, int R, int M, int D, int Femb) {
  using S = rt::OutShape;
  const int r0 = blockIdx.y * S::kRows;
  const auto row_of = [&](int i) {
    const int r = r0 + i;
    return r < R ? rt::TcRow{s_upd + (size_t)r * M, agg + (size_t)r * D}
                 : rt::TcRow{nullptr, nullptr};
  };
  const float* red =
      rt::tc_tile<S, kVec>(row_of, M, D, wout_tc, blockIdx.x, [] {});
  for (int o = threadIdx.y * 32 + threadIdx.x; o < S::kRows * S::kCols;
       o += S::kThreads) {
    const int i = o / S::kCols, j = o % S::kCols;
    const int r = r0 + i, c = blockIdx.x * S::kCols + j;
    if (r < R && c < Femb)
      h[(size_t)r * Femb + c] = rt::tc_sum<S>(red, i, j) + b_out[c];
  }
}

}  // namespace

// The three kernels on one stream; k must be in [1, 16]. s_upd is written
// by phase 0 and read by phase 1; agg (R, D) is scratch. w_tc, wv_tc and
// wout_tc are the packed layouts of ops.pack_fused_params.
extern "C" int rt_fused_step(
    const int32_t* vids, const int32_t* sel_ids, const int32_t* sel_eid,
    const int32_t* hit, const float* dt_mail, const uint8_t* mail_ok,
    const float* sel_dt, const float* sel_logits, const uint8_t* sel_valid,
    const float* memory, const float* mail, const float* edge_feats,
    const float* w_tc, const float* b_i, const float* b_h,
    const float* g_bounds, const float* g_table, const float* wv_tc,
    const float* b_v, const float* s_bounds, const float* s_table,
    const float* wout_tc, const float* b_out, float* h, float* s_upd,
    float* agg, int R, int k, int M, int F, int Fe, int D, int Femb, int E,
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

  using SE = rt::EuShape;
  const auto eu = rt::rows_aligned16(memory, M) &&
                          rt::rows_aligned16(s_upd, M) &&
                          rt::rows_aligned16(edge_feats, Fe)
                      ? fused_eu_kernel<true>
                      : fused_eu_kernel<false>;
  err = rt::tc_allow_smem<SE>(eu);
  if (err) return err;
  const int bpb = SE::kMTiles * (16 / k);         // batch rows a block
  const dim3 grid1((D + SE::kCols - 1) / SE::kCols, (R + bpb - 1) / bpb);
  eu<<<grid1, dim3(32, SE::kWarps), SE::kSmemBytes, stream>>>(
      sel_ids, sel_eid, hit, sel_dt, sel_logits, sel_valid, memory,
      edge_feats, s_upd, wv_tc, b_v, s_bounds, s_table, agg, R, k, M, Fe, D,
      E);
  err = (int)cudaGetLastError();
  if (err) return err;

  using SO = rt::OutShape;
  const auto out = rt::rows_aligned16(s_upd, M) && rt::rows_aligned16(agg, D)
                       ? fused_out_kernel<true>
                       : fused_out_kernel<false>;
  err = rt::tc_allow_smem<SO>(out);
  if (err) return err;
  const dim3 grid2((Femb + SO::kCols - 1) / SO::kCols,
                   (R + SO::kRows - 1) / SO::kRows);
  out<<<grid2, dim3(32, SO::kWarps), SO::kSmemBytes, stream>>>(
      s_upd, agg, wout_tc, b_out, h, R, M, D, Femb);
  return (int)cudaGetLastError();
}
