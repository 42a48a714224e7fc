// Device functions shared by every kernel of the port, so that the staged
// and fused tiers run the same arithmetic and cannot drift apart:
//
//   lut_bucket   LUT bucketing (lut_encode, sat_aggregate, fused_step), the
//                counterpart of repro/kernels/lut_time_encode.py::lut_rows
//   project      a shared-memory tiled fp32 row-block x weight product,
//                used for every matmul inside a kernel body
//   gru_gate     the GRU gate tail (gru_cell, fused_step phase 0)
//   softmax_fam  masked softmax over the k winners and the weighted sum
//                (sat_aggregate, fused_step phase 1)
//
// Thread layout of every kernel: blockDim = (kCols, kRows) = (32, 16). A
// warp is one row (threadIdx.y); its lanes are 32 consecutive output
// columns (threadIdx.x), so row-wise loads and stores are coalesced.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kCols = 32;   // output columns per tile (= warp lanes)
constexpr int kRows = 16;   // rows per block (= warps per block)
constexpr int kDepth = 32;  // depth (K) of one shared-memory tile
constexpr float kNegInf = -1e30f;  // repro_torch.utils.NEG_INF

// bucket(dt) = #(bounds <= dt) over the E bounds (the last is the +inf
// sentinel), clamped to E-1 so a row index never leaves the table. The
// whole warp calls it with the same dt; each lane counts E/32 bounds and a
// butterfly sum gives every lane the total. The row fetch that follows is
// an indexed load of one table row (the TPU did it as a one-hot matmul).
__device__ __forceinline__ int lut_bucket(float dt,
                                          const float* __restrict__ bounds,
                                          int E) {
  int c = 0;
  for (int e = threadIdx.x; e < E; e += kCols) c += (dt >= bounds[e]) ? 1 : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  return min(c, E - 1);
}

// Loaders give element k of the calling thread's own row (threadIdx.y).
// A null row pointer reads zeros (rows past the end of the batch).
struct Row {
  const float* p;
  __device__ __forceinline__ float operator()(int k) const {
    return p ? p[k] : 0.f;
  }
};

// The row [a || b] with |a| = na, without materializing the concat.
struct Concat2 {
  const float* a;
  int na;
  const float* b;
  __device__ __forceinline__ float operator()(int k) const {
    if (!a) return 0.f;
    return k < na ? a[k] : b[k - na];
  }
};

// acc[g] = sum_k x(k) * W[k * ldw + g * gstride + col0 + threadIdx.x] for
// g < G, over depth K: the G gate blocks of one 32-column tile for the 16
// rows of the block. Both operands pass through shared memory in
// kDepth-deep tiles; the weight tile is read once per block and reused by
// all 16 rows. Columns at or past ncols read zero weights. Every thread of
// the block must call it (it synchronizes).
template <int G, class Load>
__device__ __forceinline__ void project(const Load& x, int K,
                                        const float* __restrict__ W, int ldw,
                                        int gstride, int col0, int ncols,
                                        float (&acc)[G]) {
  __shared__ float sx[kRows][kDepth + 1];
  __shared__ float sw[kDepth][G * kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = col0 + tx;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    sx[ty][tx] = (k0 + tx < K) ? x(k0 + tx) : 0.f;
    for (int kk = ty; kk < kDepth; kk += kRows) {
      const int k = k0 + kk;
      const bool in = (k < K) && (col < ncols);
#pragma unroll
      for (int g = 0; g < G; ++g)
        sw[kk][g * kCols + tx] =
            in ? W[(size_t)k * ldw + g * gstride + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float xv = sx[ty][kk];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += xv * sw[kk][g * kCols + tx];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// GRU tail for one (row, column): gi/gh hold the [r | z | n] projections
// with biases (and, for gi, the folded LUT row) already added.
__device__ __forceinline__ float gru_gate(const float (&gi)[3],
                                          const float (&gh)[3], float s) {
  const float r = sigmoid(gi[0] + gh[0]);
  const float z = sigmoid(gi[1] + gh[1]);
  const float n = tanhf(gi[2] + r * gh[2]);
  return (1.f - z) * n + z * s;
}

// The GRU update of one (row, column) of a 16-row block: projections of
// the block's mail rows through W_i and memory rows through W_h, plus
// biases and the per-row additive input term extra_row (3M floats, may be
// null), then the gate tail. M is f_mem; columns >= M return garbage the
// caller does not store.
template <class MailLoad, class MemLoad>
__device__ __forceinline__ float gru_update(
    const MailLoad& mail, int F, const MemLoad& mem, int M,
    const float* __restrict__ w_i, const float* __restrict__ w_h,
    const float* __restrict__ b_i, const float* __restrict__ b_h,
    const float* __restrict__ extra_row, int col0, float s_prev) {
  float gi[3], gh[3];
  project<3>(mail, F, w_i, 3 * M, M, col0, M, gi);
  project<3>(mem, M, w_h, 3 * M, M, col0, M, gh);
  const int c = col0 + threadIdx.x;
  if (c < M) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      gi[g] += b_i[g * M + c] + (extra_row ? extra_row[g * M + c] : 0.f);
      gh[g] += b_h[g * M + c];
    }
  }
  return gru_gate(gi, gh, s_prev);
}

// Masked softmax over the k winners of one row, then sum_j attn_j * v_j.
// valid_j == 0 masks slot j to kNegInf; a row with no valid slot gives 0.
// v points at v_0 of this thread's column; v_j is at v[j * vstride].
__device__ __forceinline__ float softmax_fam(const float* __restrict__ logits,
                                             const uint8_t* __restrict__ valid,
                                             int k, const float* v,
                                             int vstride) {
  float mx = kNegInf;
  for (int j = 0; j < k; ++j)
    mx = fmaxf(mx, valid[j] ? logits[j] : kNegInf);
  float z = 0.f;
  for (int j = 0; j < k; ++j) z += valid[j] ? expf(logits[j] - mx) : 0.f;
  if (!(z > 0.f)) return 0.f;
  const float zc = fmaxf(z, 1e-30f);
  float out = 0.f;
  for (int j = 0; j < k; ++j) {
    const float e = valid[j] ? expf(logits[j] - mx) : 0.f;
    out += (e / zc) * v[j * vstride];
  }
  return out;
}

}  // namespace rt
