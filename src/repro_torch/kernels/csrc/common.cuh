// Device functions shared by every kernel of the port, so that the staged
// and fused tiers run the same arithmetic and cannot drift apart:
//
//   lut_buckets  LUT bucketing (lut_encode, sat_aggregate, fused_step), the
//                counterpart of repro/kernels/lut_time_encode.py::lut_rows;
//                it buckets several rows at once
//   gru_gate     the GRU gate tail
//   gru_update   the GRU update of a 16-row x 8-column output tile on the
//                tensor cores (gru_cell, fused_step phase 0); it replaces
//                the GRU body of repro/kernels/gru_cell.py::gru_cell_pallas
//                and of phase 0 of fused_step.py::fused_step_pallas
//   tc_tile      a row tile of [a || b] @ W on the tensor cores, the rows
//                gathered from two sources (fused_step's output transform,
//                and sat_eu below)
//   sat_eu       the SAT Embedding Unit of a tile of whole batch rows:
//                v = kv @ W_v + folded LUT row + b_v, masked softmax, FAM
//                (sat_aggregate, fused_step phase 1); it replaces the body
//                of repro/kernels/sat_aggregate.py::sat_aggregate_pallas
//                and phase 1 (_eu) of fused_step.py::fused_step_pallas
//
// Every kernel runs on blockDim = (32, warps): threadIdx.x is the lane.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr float kNegInf = -1e30f;  // repro_torch.utils.NEG_INF

// lut_encode's block (lut_encode.cu): a warp a row, kLutWarps rows a
// block; each lane issues kLutPass row copies before its stores.
constexpr int kLutWarps = 4;
constexpr int kLutPass = 4;

// bucket(dt) = #(bounds <= dt) over the bounds of a table of E rows,
// clamped to E-1 so a row index never leaves the table. The bounds are
// ops.sentinel_bounds's layout: the E-1 boundaries, then +inf up to a
// multiple of 4 (at least one), 16-byte aligned; the +inf entries count
// nothing for a finite dt, and a NaN dt counts nothing. The whole warp
// calls it with the same R values of dt; each lane counts one float4 of
// bounds a 128 (at E = 128 one load a lane, issued with the loads of dt)
// and a butterfly sum gives every lane the totals. Each bound is loaded
// once for all R rows, and their R sums interleave. The row fetch that
// follows is an indexed copy of one table row (the TPU did it as a
// one-hot matmul).
template <int R>
__device__ __forceinline__ void lut_buckets(const float (&dt)[R],
                                            const float* __restrict__ bounds,
                                            int E, int (&bucket)[R]) {
  const int nb = (E + 3) & ~3;          // bounds, padded to whole float4s
  int c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0;
  for (int e = 4 * threadIdx.x; e < nb; e += 4 * 32) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bounds + e));
#pragma unroll
    for (int r = 0; r < R; ++r)
      c[r] += (dt[r] >= b.x) + (dt[r] >= b.y) + (dt[r] >= b.z) +
              (dt[r] >= b.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] += __shfl_xor_sync(0xffffffffu, c[r], o);
#pragma unroll
  for (int r = 0; r < R; ++r) bucket[r] = min(c[r], E - 1);
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

// ---------------------------------------------------------------------------
// Row-tile products on the tensor cores, and the SAT Embedding Unit
// ---------------------------------------------------------------------------
//
// tc_tile computes one kRows x kCols tile of [a || b] @ W: kRows rows,
// each the concatenation of an na-float row a and an nb-float row b, both
// gathered through a row_of callback, so that no concatenated or gathered
// tensor is ever written to device memory. It is the machinery of
// rt::gru_update with one accumulator a column: mma.sync m16n8k8 TF32 in
// the 3xTF32 scheme (a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32 accumulation,
// which keeps fp32's accuracy), a kStages-deep cp.async ring of depth
// stages with one __syncthreads a stage, per-row copies of 16 bytes where
// every row is 16-byte aligned (kVec) and 4 bytes otherwise, ragged tails
// read as zeros through the copy's src-size. The a rows are padded to
// whole stages, then the b rows, so that each stage reads one source. The
// packer (ops.pack_rows_tc) lays W out as (NT, S, 2, kDepth, kCols): for
// column tile j and stage s, the TF32 high part then the low part of that
// stage's rows; padded rows and columns are 0. The kWarps warps of a block
// split each stage's K (kKSteps k8 steps each); each warp holds kMTiles x
// kNTiles m16n8 accumulators and parks them in shared memory, where the
// caller sums the warps' parts as it reads them.
//
// sat_eu runs tc_tile over the neighbour rows of whole batch rows: an m16
// tile holds floor(16 / k) batch rows of k winners each (4 at k = 4; 2 and
// 4 zero rows at k = 6), so the softmax over a batch row's winners never
// leaves the block. Its epilogue adds each row's folded-LUT row
// (rt::lut_buckets, while the first stages load) and b_v to the tile and
// sums it over each batch row's winners with their softmax weights: the
// (rows, k, D) tensor v never leaves the SM.
//
// Bound on the H100: operations. At the main path's shapes (1,600
// neighbour rows, K = 272, D = 100; R = 400, K = 200, f_emb = 100 for the
// output transform) the EU does 2 * 1600 * 272 * 100 + 2 * 400 * 200 *
// 100 = 103 MFLOP, 1.55 us at fp32's 67 TFLOP/s, against ~2 MB of rows and
// weights. What the design does about the first design's costs
// (rt::project: one FMA per shared-memory load, the rows gathered again
// for every 32-column tile, one load round between two barriers with
// nothing in flight, 100 blocks of 512 threads): the products run on the
// tensor cores, the rows are gathered once per column tile, and the
// copies run kStages - 1 stages ahead of the products. The tile shapes
// come from a sweep on the H100 (launch/gru_tiles.py; times in PERF.md):
// an EU block of 32 rows (8 batch rows at k = 4) x 56 columns with 8
// warps, 100 blocks at the main path's shapes; tiles of all 104 columns
// stream more of W_v into each block and were slower, smaller ones
// stream W_v into more blocks and were slower too. Per-block timestamps
// showed each block's time spread over latency-bound phases (the first
// stages, the setup of the epilogue's inputs, the main loop, the
// epilogue), so the design keeps every global load of the epilogue off
// its path: a thread's copy addresses are found once, the softmax
// weights, buckets and LUT rows are made while the first stages load,
// and the epilogue is one pass over shared memory.
//
// Why mma.sync and not wgmma: wgmma takes 64-row tiles, which leaves 25
// tiles over the 1,600 neighbour rows and 7 over R = 400, too few blocks
// for 132 SMs.

template <int MT, int NT, int W, int KS, int ST>
struct TcShape {
  static constexpr int kMTiles = MT;           // m16 row tiles a block
  static constexpr int kNTiles = NT;           // n8 column tiles a block
  static constexpr int kWarps = W;             // split each stage's K
  static constexpr int kKSteps = KS;           // k8 steps a warp a stage
  static constexpr int kStages = ST;           // cp.async ring depth
  static constexpr int kRows = 16 * MT;
  static constexpr int kCols = 8 * NT;
  static constexpr int kDepth = 8 * W * KS;    // K per stage
  static constexpr int kThreads = 32 * W;
  // A and B rows in shared memory: 16-byte aligned, and the fragment loads
  // of a warp hit 32 distinct banks
  static constexpr int kLda = kDepth + 4;
  static constexpr int kLdb = kCols + (NT % 2 ? 0 : 8);
  static constexpr int kStageW = 2 * kDepth * kCols;  // packed hi + lo
  static constexpr int kStageF = kRows * kLda + 2 * kDepth * kLdb;
  static constexpr int kRed = W * kRows * kCols;      // split-K sums
  static constexpr int kSmemBytes =
      4 * (ST * kStageF > kRed ? ST * kStageF : kRed);  // dynamic
  static_assert(ST >= 2, "the ring needs two stages");
  // a block has 227 KB; leave 16 KB for the caller's static arrays
  static_assert(kSmemBytes <= 211 * 1024, "shared memory of one block");
};

// The EU's tile (sat_aggregate, fused_step phase 1) and the output
// transform's (fused_step); ops.EU_* and ops.OUT_* give the packer the
// same depth and columns.
constexpr int kEuMTiles = 2;
constexpr int kEuNTiles = 7;
constexpr int kEuWarps = 8;
constexpr int kEuKSteps = 1;
constexpr int kEuStages = 4;
using EuShape =
    TcShape<kEuMTiles, kEuNTiles, kEuWarps, kEuKSteps, kEuStages>;
constexpr int kOutMTiles = 1;
constexpr int kOutNTiles = 1;
constexpr int kOutWarps = 8;
constexpr int kOutKSteps = 1;
constexpr int kOutStages = 3;
using OutShape =
    TcShape<kOutMTiles, kOutNTiles, kOutWarps, kOutKSteps, kOutStages>;

// One row of a tc_tile: a (na floats) || b (nb floats). a null: zeros.
struct TcRow {
  const float* a;
  const float* b;
};

// Lets a tc_tile kernel of shape S take S::kSmemBytes of dynamic shared
// memory. Always asked: the kernel's static arrays count against the
// 48 KB a block gets without it.
template <class S, class Kernel>
inline int tc_allow_smem(Kernel* kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
}

// Tile (row block, column tile ct) of [a || b] @ W. Every thread of a
// (32, S::kWarps) block calls it; the launch gives it S::kSmemBytes of
// dynamic shared memory (tc_allow_smem). row_of(i) gives block row i.
// pre() is called by every thread once the first stages are in flight.
// Returns the warps' split-K partial sums in shared memory, visible to
// the whole block, which the caller reduces where it reads them
// (tc_sum): one pass over the tile and one barrier fewer. They stay valid
// until the caller's kernel ends. kVec: every row pointer is 16-byte
// aligned and na, nb are multiples of 4.
template <class S, bool kVec, class RowOf, class Pre>
__device__ __forceinline__ const float* tc_tile(
    const RowOf& row_of, int na, int nb, const float* __restrict__ w_tc,
    int ct, const Pre& pre) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TcRow srow[S::kRows];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  for (int i = tid; i < S::kRows; i += S::kThreads) srow[i] = row_of(i);
  __syncthreads();

  const int sa = (na + S::kDepth - 1) / S::kDepth;        // a stages
  const int nst = sa + (nb + S::kDepth - 1) / S::kDepth;  // all stages
  const float* w_tile = w_tc + (size_t)ct * nst * S::kStageW;

  // A thread's 16-byte chunks of a stage are the same every stage: its
  // weight chunks (u-th at tid + u * kThreads) and row chunks, with their
  // shared-memory offsets and rows, are found once.
  constexpr int kWChunks = S::kStageW / 4;
  constexpr int kAChunks = S::kRows * S::kDepth / 4;
  constexpr int kWPer = (kWChunks + S::kThreads - 1) / S::kThreads;
  constexpr int kAPer = (kAChunks + S::kThreads - 1) / S::kThreads;
  int wdst[kWPer], adst[kAPer], akc[kAPer];
  TcRow arow[kAPer];
#pragma unroll
  for (int u = 0; u < kWPer; ++u) {
    const int c = tid + u * S::kThreads;
    wdst[u] = c < kWChunks
                  ? (c / (S::kCols / 4)) * S::kLdb + 4 * (c % (S::kCols / 4))
                  : -1;
  }
#pragma unroll
  for (int u = 0; u < kAPer; ++u) {
    const int c = tid + u * S::kThreads;
    const int i = c / (S::kDepth / 4);
    akc[u] = 4 * (c % (S::kDepth / 4));
    adst[u] = c < kAChunks ? i * S::kLda + akc[u] : -1;
    arow[u] = c < kAChunks ? srow[i] : TcRow{nullptr, nullptr};
  }

  auto load = [&](int s) {
    float* xa = smem + (s % S::kStages) * S::kStageF;
    float* xb = xa + S::kRows * S::kLda;
    const float* ws = w_tile + (size_t)s * S::kStageW;
#pragma unroll
    for (int u = 0; u < kWPer; ++u)
      if (wdst[u] >= 0)
        cp_async16(xb + wdst[u], ws + 4 * (tid + u * S::kThreads), 16);
    const bool first = s < sa;
    const int k0 = (first ? s : s - sa) * S::kDepth;
    const int lim = (first ? na : nb) - k0;             // valid K here
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      if (adst[u] < 0) continue;
      const int n = arow[u].a ? min(max(lim - akc[u], 0), 4) : 0;
      const float* src =
          n ? (first ? arow[u].a : arow[u].b) + k0 + akc[u] : w_tc;
      float* dst = xa + adst[u];
      if (kVec) {
        cp_async16(dst, src, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + e, e < n ? src + e : w_tc, e < n ? 4 : 0);
      }
    }
  };

  float acc[S::kMTiles][S::kNTiles][4];
#pragma unroll
  for (int m = 0; m < S::kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < S::kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  pre();
  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();   // stage s landed; stage s - 1's buffer is free
    if (s + S::kStages - 1 < nst) load(s + S::kStages - 1);
    cp_async_commit();

    const float* xa = smem + (s % S::kStages) * S::kStageF;
    const float* xb = xa + S::kRows * S::kLda;
#pragma unroll
    for (int j = 0; j < S::kKSteps; ++j) {
      const int kk = 8 * (warp * S::kKSteps + j);     // this warp's k8 slice
      uint32_t ah[S::kMTiles][4], al[S::kMTiles][4];
#pragma unroll
      for (int m = 0; m < S::kMTiles; ++m) {
        const float* p = xa + (16 * m + g) * S::kLda + kk + t;
        const float a[4] = {p[0], p[8 * S::kLda], p[4], p[8 * S::kLda + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[m][e] = tf32_rna(a[e]);
          al[m][e] = tf32_rna(a[e] - __uint_as_float(ah[m][e]));
        }
      }
      uint32_t bh[S::kNTiles][2], bl[S::kNTiles][2];
#pragma unroll
      for (int n = 0; n < S::kNTiles; ++n) {
        const float* p = xb + (kk + t) * S::kLdb + 8 * n + g;
        bh[n][0] = __float_as_uint(p[0]);
        bh[n][1] = __float_as_uint(p[4 * S::kLdb]);
        bl[n][0] = __float_as_uint(p[S::kDepth * S::kLdb]);
        bl[n][1] = __float_as_uint(p[(S::kDepth + 4) * S::kLdb]);
      }
      // each pass over every (row tile, column tile): consecutive
      // products are independent
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int m = 0; m < S::kMTiles; ++m)
#pragma unroll
          for (int n = 0; n < S::kNTiles; ++n)
            mma_tf32(acc[m][n], pass == 0 ? al[m] : ah[m],
                     pass == 1 ? bl[n] : bh[n]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // every warp is done with the ring: reuse it

  // the warps' split-K partial sums: red[warp][row][col]
  float* red = smem;
#pragma unroll
  for (int m = 0; m < S::kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < S::kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + g + 8 * (e >> 1);
        const int col = 8 * n + 2 * t + (e & 1);
        red[(warp * S::kRows + row) * S::kCols + col] = acc[m][n][e];
      }
  __syncthreads();
  return red;
}

// Element (i, j) of a tc_tile result: the sum of the warps' partial sums.
template <class S>
__device__ __forceinline__ float tc_sum(const float* red, int i, int j) {
  float sum = red[i * S::kCols + j];
#pragma unroll
  for (int w = 1; w < S::kWarps; ++w)
    sum += red[(w * S::kRows + i) * S::kCols + j];
  return sum;
}

// The SAT Embedding Unit of one block: batch rows b0 .. b0 + kMTiles *
// floor(16 / k) - 1 (b0 from blockIdx.y), output columns of column tile
// blockIdx.x. nbr_of(f) gives the TcRow of neighbour row f = b * k + j
// (winner j of batch row b < B): na floats of its first source || nb of
// its second. dt, logits and valid are (B, k); table is the folded LUT
// (E, D). For each batch row b < B and column c < D it calls
// store(b, c, sum_j attn_j v_j). k must be in [1, 16].
//
// Nothing of the epilogue waits on a global load, and nothing in it runs
// once a batch row: each block row's dt, logit and mask are loaded by its
// thread together with its row pointers; once the first stages are in
// flight, the softmax weights of each batch row are computed, and each
// warp buckets its rows and copies their folded-LUT row slices (and b_v)
// into shared memory with cp.async, landing with the stages. The epilogue
// is then one pass: sum_j attn_j ((v_j + lut_j) + b_v) per (batch row,
// column), with v_j summed over the warps' partial sums.
template <class S, bool kVec, class NbrOf, class Store>
__device__ __forceinline__ void sat_eu(
    const NbrOf& nbr_of, int B, int k, int na, int nb,
    const float* __restrict__ dt, const float* __restrict__ logits,
    const uint8_t* __restrict__ valid, const float* __restrict__ w_tc,
    const float* __restrict__ b_v, const float* __restrict__ bounds,
    const float* __restrict__ table, int D, int E, const Store& store) {
  __shared__ float sdt[S::kRows], slogit[S::kRows], sattn[S::kRows];
  __shared__ uint8_t sval[S::kRows];
  __shared__ __align__(16) float slut[S::kRows * S::kCols];  // LUT slices
  __shared__ float sbv[S::kCols];
  constexpr int kPerWarp = S::kRows / S::kWarps;  // rows each warp buckets
  static_assert(S::kRows % S::kWarps == 0, "whole rows a warp");
  const int bpt = 16 / k;                        // batch rows an m16 tile
  const int b0 = blockIdx.y * S::kMTiles * bpt;
  const int c0 = blockIdx.x * S::kCols;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const auto nbr = [&](int i) {                  // block row -> f, or -1
    const int q = i % 16, b = b0 + (i / 16) * bpt + q / k;
    return (q < bpt * k && b < B) ? b * k + q % k : -1;
  };
  const auto first_row = [&](int lb) {           // batch row -> block row
    return (lb / bpt) * 16 + (lb % bpt) * k;
  };
  const auto row_of = [&](int i) {
    const int f = nbr(i);
    sdt[i] = f < 0 ? 0.f : dt[f];
    slogit[i] = f < 0 ? 0.f : logits[f];
    sval[i] = f < 0 ? 0 : valid[f];
    return f < 0 ? TcRow{nullptr, nullptr} : nbr_of(f);
  };
  const auto pre = [&] {
    // softmax weights, a lane per block row: the k winners of its batch
    // row are the lanes first .. first + k - 1 of the same warp. Invalid
    // winners are masked to kNegInf; a batch row with no valid winner gets
    // all-zero weights.
    for (int w0 = threadIdx.y * 32; w0 < S::kRows; w0 += S::kWarps * 32) {
      const int i = w0 + threadIdx.x;
      const int first = threadIdx.x - (i % 16) % k;
      const bool v = i < S::kRows && nbr(i) >= 0 && sval[i];
      const float l = v ? slogit[i] : kNegInf;
      float mx = kNegInf;
      for (int j = 0; j < k; ++j)
        mx = fmaxf(mx, __shfl_sync(0xffffffffu, l, first + j));
      const float e = v ? expf(l - mx) : 0.f;
      float z = 0.f;
      for (int j = 0; j < k; ++j) z += __shfl_sync(0xffffffffu, e, first + j);
      if (i < S::kRows) sattn[i] = z > 0.f ? e / fmaxf(z, 1e-30f) : 0.f;
    }
    float d[kPerWarp];                           // rows warp + r * kWarps
    int bk[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) d[r] = sdt[threadIdx.y + r * S::kWarps];
    lut_buckets<kPerWarp>(d, bounds, E, bk);
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int i = threadIdx.y + r * S::kWarps;
      const float* row = table + (size_t)bk[r] * D + c0;
      const bool ok = nbr(i) >= 0;
      for (int j = threadIdx.x; j < S::kCols; j += 32) {
        const int n = ok && c0 + j < D ? 4 : 0;
        cp_async4(slut + i * S::kCols + j, n ? row + j : table, n);
      }
    }
    for (int j = tid; j < S::kCols; j += S::kThreads) {
      const int n = c0 + j < D ? 4 : 0;
      cp_async4(sbv + j, n ? b_v + c0 + j : b_v, n);
    }
  };
  const float* red = tc_tile<S, kVec>(row_of, na, nb, w_tc, blockIdx.x, pre);
  for (int o = tid; o < S::kMTiles * bpt * S::kCols; o += S::kThreads) {
    const int lb = o / S::kCols, j = o % S::kCols;
    const int b = b0 + lb, c = c0 + j;
    if (b >= B || c >= D) continue;
    float out = 0.f;
    for (int i = first_row(lb); i < first_row(lb) + k; ++i)
      out += sattn[i] * ((tc_sum<S>(red, i, j) + slut[i * S::kCols + j]) +
                         sbv[j]);
    store(b, c, out);
  }
}

}  // namespace rt
