// SAT aggregation, the Embedding-Unit tail over pre-gathered neighbours:
// v = kv @ W_v + LUT_folded[bucket(dt)] + b_v over the B*k neighbour rows,
// masked softmax of the k logits per row (a row with no valid slot gives
// 0), out = sum_k attn * v.
//
// Replaces repro/kernels/sat_aggregate.py::sat_aggregate_pallas (body
// _sat_kernel).
//
// Bound on the H100: operations at the main path's shapes (B = 400, k = 4,
// Dkv = 272, D = 100): 2 * 1600 * 272 * 100 = 87 MFLOP in fp32 against
// ~1.9 MB of traffic. Design: a block owns whole batch rows, bpb = 16 / k
// of them (bpb * k neighbour rows, one warp each), and one 32-column tile
// of D. The projection streams W_v through shared memory (rt::project);
// each warp adds its row's folded LUT row (rt::lut_bucket, an indexed load)
// and parks v in shared memory, where one warp per batch row reduces over
// its k neighbours (rt::softmax_fam). The (B, k, D) tensor v never leaves
// the SM.
#include "common.cuh"

namespace {

__global__ void sat_aggregate_kernel(
    const float* __restrict__ kv, const float* __restrict__ dt,
    const float* __restrict__ logits, const uint8_t* __restrict__ valid,
    const float* __restrict__ w_v, const float* __restrict__ b_v,
    const float* __restrict__ bounds, const float* __restrict__ table,
    float* __restrict__ out, int B, int k, int Dkv, int D, int E, int bpb) {
  __shared__ float sv[rt::kRows][rt::kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col0 = blockIdx.x * rt::kCols;
  const int c = col0 + tx;
  const int b0 = blockIdx.y * bpb;
  const int f = b0 * k + ty;                       // neighbour row
  const bool row_ok = ty < bpb * k && f < B * k;
  const rt::Row x{row_ok ? kv + (size_t)f * Dkv : nullptr};
  float acc[1];
  rt::project<1>(x, Dkv, w_v, D, 0, col0, D, acc);
  const int bucket = rt::lut_bucket(row_ok ? dt[f] : 0.f, bounds, E);
  float v = 0.f;
  if (row_ok && c < D) v = acc[0] + table[(size_t)bucket * D + c] + b_v[c];
  sv[ty][tx] = v;
  __syncthreads();
  const int b = b0 + ty;
  if (ty < bpb && b < B && c < D)
    out[(size_t)b * D + c] = rt::softmax_fam(
        logits + (size_t)b * k, valid + (size_t)b * k, k, &sv[ty * k][tx],
        rt::kCols);
}

}  // namespace

// k must be in [1, 16].
extern "C" int rt_sat_aggregate(const float* kv, const float* dt,
                                const float* logits, const uint8_t* valid,
                                const float* w_v, const float* b_v,
                                const float* bounds, const float* table,
                                float* out, int B, int k, int Dkv, int D,
                                int E, cudaStream_t stream) {
  if (B > 0) {
    const int bpb = rt::kRows / k;
    const dim3 block(rt::kCols, rt::kRows);
    const dim3 grid((D + rt::kCols - 1) / rt::kCols, (B + bpb - 1) / bpb);
    sat_aggregate_kernel<<<grid, block, 0, stream>>>(
        kv, dt, logits, valid, w_v, b_v, bounds, table, out, B, k, Dkv, D, E,
        bpb);
  }
  return (int)cudaGetLastError();
}
