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
// ~1.9 MB of traffic. The whole function is rt::sat_eu (common.cuh), which
// also serves fused_step's phase 1 and says what its design does about
// each cost of the first design: a block computes whole batch rows (two
// m16 tiles of contiguous kv rows, 2 * floor(16 / k) batch rows) for one
// 56-column tile of D, 100 blocks at the main path's shapes, with 3xTF32
// tensor-core products fed by a cp.async ring, and v never leaves the SM.
#include "common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(rt::EuShape::kThreads) sat_aggregate_kernel(
    const float* __restrict__ kv, const float* __restrict__ dt,
    const float* __restrict__ logits, const uint8_t* __restrict__ valid,
    const float* __restrict__ w_tc, const float* __restrict__ b_v,
    const float* __restrict__ bounds, const float* __restrict__ table,
    float* __restrict__ out, int B, int k, int Dkv, int D, int E) {
  const auto nbr_of = [&](int f) {
    return rt::TcRow{kv + (size_t)f * Dkv, nullptr};
  };
  const auto store = [&](int b, int c, float x) {
    out[(size_t)b * D + c] = x;
  };
  rt::sat_eu<rt::EuShape, kVec>(nbr_of, B, k, Dkv, 0, dt, logits, valid,
                                w_tc, b_v, bounds, table, D, E, store);
}

}  // namespace

// k must be in [1, 16]. w_tc is the packed W_v layout of
// ops.pack_sat_params.
extern "C" int rt_sat_aggregate(const float* kv, const float* dt,
                                const float* logits, const uint8_t* valid,
                                const float* w_tc, const float* b_v,
                                const float* bounds, const float* table,
                                float* out, int B, int k, int Dkv, int D,
                                int E, cudaStream_t stream) {
  using S = rt::EuShape;
  if (B <= 0) return (int)cudaGetLastError();
  const auto kernel = rt::rows_aligned16(kv, Dkv)
                          ? sat_aggregate_kernel<true>
                          : sat_aggregate_kernel<false>;
  const int err = rt::tc_allow_smem<S>(kernel);
  if (err) return err;
  const int bpb = S::kMTiles * (16 / k);          // batch rows a block
  const dim3 block(32, S::kWarps);
  const dim3 grid((D + S::kCols - 1) / S::kCols, (B + bpb - 1) / bpb);
  kernel<<<grid, block, S::kSmemBytes, stream>>>(
      kv, dt, logits, valid, w_tc, b_v, bounds, table, out, B, k, Dkv, D, E);
  return (int)cudaGetLastError();
}
