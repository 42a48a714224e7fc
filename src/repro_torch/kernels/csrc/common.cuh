// Device functions shared by every kernel of the port, so that the staged
// and fused tiers run the same arithmetic and cannot drift apart:
//
//   lut_bucket   LUT bucketing (lut_encode, sat_aggregate, fused_step), the
//                counterpart of repro/kernels/lut_time_encode.py::lut_rows
//   project      a shared-memory tiled fp32 row-block x weight product
//                (sat_aggregate, fused_step phase 1)
//   gru_gate     the GRU gate tail
//   gru_update   the GRU update of a 16-row x 8-column output tile on the
//                tensor cores (gru_cell, fused_step phase 0); it replaces
//                the GRU body of repro/kernels/gru_cell.py::gru_cell_pallas
//                and of phase 0 of fused_step.py::fused_step_pallas
//   softmax_fam  masked softmax over the k winners and the weighted sum
//                (sat_aggregate, fused_step phase 1)
//
// Thread layout of the project-based kernels: blockDim = (kCols, kRows) =
// (32, 16). A warp is one row (threadIdx.y); its lanes are 32 consecutive
// output columns (threadIdx.x), so row-wise loads and stores are coalesced.
// gru_update runs on blockDim = (32, kGruWarps) and is described with it.
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

// ---------------------------------------------------------------------------
// The GRU update on the tensor cores
// ---------------------------------------------------------------------------
//
// Bound on the H100: operations. At the main path's shapes (R = 400 rows,
// F = f_mail = 372, M = f_mem = 100) the update is 2 * 400 * 472 * 300 +
// 12 * 400 * 100 = 113.8 MFLOP, 1.698 us at fp32's 67 TFLOP/s (the yardstick
// chip_smoke.bound uses, whatever unit does the work), against ~2 MB of
// traffic.
//
// Layout. One block computes a kGruRows x kGruCols tile of the output (16
// rows x 8 columns of M) with four accumulators per output: the r and z
// gates folded over the concatenated depth [mail || s] . [W_i; W_h]
// (K = F + M), and gi_n (K = F) and gh_n (K = M) kept apart, because
// n = tanh(gi_n + r * gh_n). The packer (ops.pack_gru_params) lays the
// weights out as w_tc (NT, S, 2, kGruDepth, 3 * kGruCols): for column tile
// j and depth stage s, the TF32 high part then the low part of the rows
// k of that stage, each row the [r | z | n] columns of the tile. Mail rows
// are padded to a whole stage (Sf = ceil(F / kGruDepth) stages), memory
// rows likewise (Sm stages), so a stage is all mail or all memory and its
// n slot goes to gi_n or gh_n as a whole; padded rows and columns are 0.
//
// What this does about the first design's costs (rt::project, 80
// registers, one 512-thread block per SM):
//  - Too few blocks: a 16 x 8 tile and 128 threads give ceil(M / 8) x
//    ceil(R / 16) = 13 x 25 = 325 blocks at R = 400, about 50 registers a
//    thread and 49,920 bytes of shared memory a block, so four fit on an
//    SM and all run in one wave.
//  - The wasted column tile: M pads to 104, not 128.
//  - One FMA per shared-memory load: each warp's m16n8k8 fragments feed 9
//    tensor-core products per 8-deep step (3 gates x 3 passes); the
//    activations are split once per step in registers, and the three
//    passes each run over every gate, so consecutive products are
//    independent.
//  - Loads never overlapping the math: a kGruStages-deep ring of cp.async
//    stages, the next stages loading while this one multiplies; one
//    __syncthreads per stage. Rows are copied with per-row cp.async (the
//    fused phase gathers them through vids, which TMA cannot do), 16 bytes
//    a copy where rows are 16-byte aligned, 4 bytes otherwise; the ragged
//    tail reads zeros through the copy's src-size.
//  - Two products in turn, six accumulators: one pass over K, four.
//  - No tensor cores: mma.sync m16n8k8 TF32 in the 3xTF32 scheme,
//    a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in fp32, which keeps
//    fp32's accuracy (a single TF32 pass keeps ~3 digits and is not used).
//    The weights are split once, in the packer; the activations in
//    registers with cvt.rna.tf32.f32.
// The four warps of a block split each 64-deep stage (16 of its K rows,
// two k8 steps, each) and reduce in shared memory before the gate
// epilogue, which stays fused: biases, the extra row, rt::gru_gate, then
// the caller's store.
//
// Tile sizes come from a sweep on the H100 (launch/gru_tiles.py, whose
// times PERF.md keeps): 32-row tiles (169 blocks) and 32-deep stages were
// slower, and rings of 6 stages, whose shared memory leaves fewer blocks
// resident, slower still. In the main loop the copies and the products
// cost about the same and do not overlap; a 2-block cluster splitting K,
// a bulk (TMA) copy of each weight stage, and issuing the copies behind
// the products each gained little in trials, and are not used.
//
// Why mma.sync and not wgmma: wgmma takes 64-row tiles, which leaves 7 row
// tiles at R = 400, too few blocks for 132 SMs.

constexpr int kGruMTiles = 1;                  // m16 row tiles per block
constexpr int kGruRows = 16 * kGruMTiles;      // rows per block
constexpr int kGruCols = 8;                    // output columns: 1 n8 tile
constexpr int kGruWarps = 4;                   // split each stage's K
constexpr int kGruKSteps = 2;                  // k8 steps per warp a stage
constexpr int kGruDepth = 8 * kGruWarps * kGruKSteps;  // K per stage
constexpr int kGruStages = 3;                  // cp.async ring depth
constexpr int kGruThreads = 32 * kGruWarps;
constexpr int kGruLda = kGruDepth + 4;         // A row in shared memory:
                                               // 16 B aligned, no conflicts
constexpr int kGruLdb = 3 * kGruCols;          // [r | z | n] x 8 columns
constexpr int kGruStageW = 2 * kGruDepth * kGruLdb;  // hi + lo, floats
constexpr int kGruStageF = kGruRows * kGruLda + kGruStageW;
constexpr int kGruRed = kGruWarps * 4 * kGruRows * kGruCols;  // split-K sums
static_assert(kGruRed <= kGruStages * kGruStageF, "reduction fits the ring");
constexpr int kGruSmemBytes = kGruStages * kGruStageF * 4;  // dynamic

// Rows of w floats from p all start on a 16-byte boundary (the kVec path
// of gru_update may copy them 16 bytes at a time).
inline bool rows_aligned16(const float* p, int w) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One row of a GRU tile. mail is null for rows past the end of the batch.
struct GruRow {
  const float* mail;   // F floats
  const float* mem;    // M floats: the hidden state s_prev
  const float* extra;  // 3M additive input-gate terms [r | z | n], or null
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of the four accumulators in 3xTF32, d += a b with
// b = [r | z | n] of the stage: a_lo b_hi, then a_hi b_lo, then a_hi b_hi,
// each pass over every (row tile, gate) so that consecutive products are
// independent. The n gate goes to gi_n (kMail) or gh_n.
template <bool kMail>
__device__ __forceinline__ void gru_mma(
    float (&acc)[kGruMTiles][4][4], const uint32_t (&ah)[kGruMTiles][4],
    const uint32_t (&al)[kGruMTiles][4], const uint32_t (&bh)[3][2],
    const uint32_t (&bl)[3][2]) {
  constexpr int n = kMail ? 2 : 3;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int m = 0; m < kGruMTiles; ++m) {
      const uint32_t(&a)[4] = pass == 0 ? al[m] : ah[m];
      const uint32_t(&b)[3][2] = pass == 1 ? bl : bh;
      mma_tf32(acc[m][0], a, b[0]);
      mma_tf32(acc[m][1], a, b[1]);
      mma_tf32(acc[m][n], a, b[2]);
    }
}

// cp.async of 16 or 4 bytes; bytes past src_bytes are written as zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The GRU update of one kGruRows x 8-column output tile, column tile ct
// (columns 8 ct .. 8 ct + 7 of M). Every thread of a (32, kGruWarps)
// block calls it; the launch gives it kGruSmemBytes of dynamic shared
// memory (gru_allow_smem). row_of(i) gives block row i (called by thread
// i < kGruRows). For each row with mail and column c < M it calls
// store(i, c, s_new, s_prev). kVec: every row pointer is 16-byte aligned
// (F and M multiples of 4, aligned bases), so rows load 16 bytes a copy.
template <bool kVec, class RowOf, class Store>
__device__ __forceinline__ void gru_update(const RowOf& row_of, int F, int M,
                                           const float* __restrict__ w_tc,
                                           const float* __restrict__ b_i,
                                           const float* __restrict__ b_h,
                                           int ct, const Store& store) {
  extern __shared__ __align__(16) float smem[];
  __shared__ GruRow srow[kGruRows];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  if (tid < kGruRows) srow[tid] = row_of(tid);
  __syncthreads();

  const int nf = (F + kGruDepth - 1) / kGruDepth;       // mail stages
  const int S = nf + (M + kGruDepth - 1) / kGruDepth;   // all stages
  const float* w_tile = w_tc + (size_t)ct * S * kGruStageW;

  auto load = [&](int s) {
    float* sa = smem + (s % kGruStages) * kGruStageF;
    float* sb = sa + kGruRows * kGruLda;
    const float* ws = w_tile + (size_t)s * kGruStageW;
    for (int c = tid; c < kGruStageW / 4; c += kGruThreads)
      cp_async16(sb + 4 * c, ws + 4 * c, 16);
    const bool mail = s < nf;
    const int k0 = (mail ? s : s - nf) * kGruDepth;
    const int lim = (mail ? F : M) - k0;                // valid K here
    for (int c = tid; c < kGruRows * kGruDepth / 4; c += kGruThreads) {
      const int i = c / (kGruDepth / 4), kc = 4 * (c % (kGruDepth / 4));
      const GruRow& rw = srow[i];
      const float* src = rw.mail ? (mail ? rw.mail : rw.mem) + k0 + kc
                                 : w_tc;
      const int n = rw.mail ? min(max(lim - kc, 0), 4) : 0;
      float* dst = sa + i * kGruLda + kc;
      if (kVec) {
        cp_async16(dst, n ? src : w_tc, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + e, e < n ? src + e : w_tc, e < n ? 4 : 0);
      }
    }
  };

  // acc[m16 tile][r, z, gi_n, gh_n][fragment]
  float acc[kGruMTiles][4][4];
#pragma unroll
  for (int m = 0; m < kGruMTiles; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kGruStages - 1; ++s) {
    if (s < S) load(s);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < S; ++s) {
    cp_async_wait<kGruStages - 2>();
    __syncthreads();   // stage s landed; stage s - 1's buffer is free
    if (s + kGruStages - 1 < S) load(s + kGruStages - 1);
    cp_async_commit();

    const float* sa = smem + (s % kGruStages) * kGruStageF;
    const float* sb = sa + kGruRows * kGruLda;
    const bool mail = s < nf;
#pragma unroll
    for (int j = 0; j < kGruKSteps; ++j) {
      const int kk = 8 * (warp * kGruKSteps + j);     // this warp's k8 slice
      uint32_t bh[3][2], bl[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* p = sb + (kk + t) * kGruLdb + q * kGruCols + g;
        bh[q][0] = __float_as_uint(p[0]);
        bh[q][1] = __float_as_uint(p[4 * kGruLdb]);
        bl[q][0] = __float_as_uint(p[kGruDepth * kGruLdb]);
        bl[q][1] = __float_as_uint(p[(kGruDepth + 4) * kGruLdb]);
      }
      uint32_t ah[kGruMTiles][4], al[kGruMTiles][4];
#pragma unroll
      for (int m = 0; m < kGruMTiles; ++m) {
        const float* p = sa + (16 * m + g) * kGruLda + kk + t;
        const float a[4] = {p[0], p[8 * kGruLda], p[4], p[8 * kGruLda + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[m][e] = tf32_rna(a[e]);
          al[m][e] = tf32_rna(a[e] - __uint_as_float(ah[m][e]));
        }
      }
      if (mail)
        gru_mma<true>(acc, ah, al, bh, bl);
      else
        gru_mma<false>(acc, ah, al, bh, bl);
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // every warp is done with the ring: reuse it

  // split-K reduction over the warps: red[warp][gate][row][col]
  float* red = smem;
#pragma unroll
  for (int m = 0; m < kGruMTiles; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + g + 8 * (e >> 1), col = 2 * t + (e & 1);
        red[((warp * 4 + q) * kGruRows + row) * kGruCols + col] =
            acc[m][q][e];
      }
  __syncthreads();
  for (int o = tid; o < kGruRows * kGruCols; o += kGruThreads) {
    const int i = o / kGruCols, j = o % kGruCols;
    const int c = ct * kGruCols + j;
    const GruRow rw = srow[i];
    if (!rw.mail || c >= M) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kGruWarps; ++w)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sum[q] += red[((w * 4 + q) * kGruRows + i) * kGruCols + j];
    float gi[3], gh[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi[q] = sum[q] + b_i[q * M + c] + (rw.extra ? rw.extra[q * M + c] : 0.f);
      gh[q] = b_h[q * M + c];
    }
    gh[2] += sum[3];
    const float s_prev = rw.mem[c];
    store(i, c, gru_gate(gi, gh, s_prev), s_prev);
  }
}

// Lets a gru_update kernel take kGruSmemBytes of dynamic shared memory.
template <class Kernel>
inline int gru_allow_smem(Kernel* kernel) {
  if (kGruSmemBytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGruSmemBytes);
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
