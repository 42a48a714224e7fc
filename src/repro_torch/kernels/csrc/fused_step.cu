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
// Here every warp owns one row: it reads its own indices once and the
// block streams the rows through shared memory in 32-wide coalesced pieces
// (rt::project with a gathering loader), so no neighbour tensor, kv concat
// or LUT-row tensor is ever written to device memory.
//
// Bound on the H100: operations at the main path's shapes (R = 400, k = 4,
// f_mem = d = f_emb = 100, f_edge = 172, f_mail = 372): ~113 MFLOP in
// phase 0 and ~95 MFLOP in phase 1, in fp32, against ~1.5 MB of gathered
// rows and weights. Phase 1 runs one block per 16 / k batch rows, which
// holds the whole aggregate row of its batch rows in shared memory for the
// output transform.
#include "common.cuh"

namespace {

__global__ void fused_muu_kernel(
    const int32_t* __restrict__ vids, const float* __restrict__ dt_mail,
    const uint8_t* __restrict__ mail_ok, const float* __restrict__ memory,
    const float* __restrict__ mail, const float* __restrict__ w_i,
    const float* __restrict__ w_h, const float* __restrict__ b_i,
    const float* __restrict__ b_h, const float* __restrict__ g_bounds,
    const float* __restrict__ g_table, float* __restrict__ s_upd, int R,
    int M, int F, int E) {
  const int r = blockIdx.y * rt::kRows + threadIdx.y;
  const int col0 = blockIdx.x * rt::kCols;
  const int c = col0 + threadIdx.x;
  const bool row_ok = r < R;
  const size_t v = row_ok ? (size_t)vids[r] : 0;
  const rt::Row mail_row{row_ok ? mail + v * F : nullptr};
  const rt::Row mem_row{row_ok ? memory + v * M : nullptr};
  const int bucket = rt::lut_bucket(row_ok ? dt_mail[r] : 0.f, g_bounds, E);
  const float s_prev = (row_ok && c < M) ? memory[v * M + c] : 0.f;
  const float s_new =
      rt::gru_update(mail_row, F, mem_row, M, w_i, w_h, b_i, b_h,
                     g_table + (size_t)bucket * 3 * M, col0, s_prev);
  if (row_ok && c < M) s_upd[(size_t)r * M + c] = mail_ok[r] ? s_new : s_prev;
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
// phase 0 and read by phase 1.
extern "C" int rt_fused_step(
    const int32_t* vids, const int32_t* sel_ids, const int32_t* sel_eid,
    const int32_t* hit, const float* dt_mail, const uint8_t* mail_ok,
    const float* sel_dt, const float* sel_logits, const uint8_t* sel_valid,
    const float* memory, const float* mail, const float* edge_feats,
    const float* w_i, const float* w_h, const float* b_i, const float* b_h,
    const float* g_bounds, const float* g_table, const float* w_v,
    const float* b_v, const float* s_bounds, const float* s_table,
    const float* w_out, const float* b_out, float* h, float* s_upd, int R,
    int k, int M, int F, int Fe, int D, int Femb, int E,
    cudaStream_t stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 block(rt::kCols, rt::kRows);
  const dim3 grid0((M + rt::kCols - 1) / rt::kCols,
                   (R + rt::kRows - 1) / rt::kRows);
  fused_muu_kernel<<<grid0, block, 0, stream>>>(
      vids, dt_mail, mail_ok, memory, mail, w_i, w_h, b_i, b_h, g_bounds,
      g_table, s_upd, R, M, F, E);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int bpb = rt::kRows / k;
  const size_t smem = (size_t)bpb * D * sizeof(float);
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(fused_eu_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
  }
  const dim3 grid1((R + bpb - 1) / bpb);
  fused_eu_kernel<<<grid1, block, smem, stream>>>(
      sel_ids, sel_eid, hit, sel_dt, sel_logits, sel_valid, memory,
      edge_feats, s_upd, w_v, b_v, s_bounds, s_table, w_out, b_out, h, R, k,
      M, Fe, D, Femb, E, bpb);
  return (int)cudaGetLastError();
}
