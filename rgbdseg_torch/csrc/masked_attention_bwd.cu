// Backward of the Mask2Former masked cross-attention (kernel K3).
//
// Forward (csrc/masked_attention.cu): S = q k^T + bias, P = softmax(S), O = P v,
// bias = -1e9 where mask_logits < 0 && !all_blocked, else 0; q (B, H, Q, hd)
// already scaled. Given dO (B, H, Q, hd), the forward's O and each row's
// log-sum-exp lse of S, this computes, flash-attention style,
//   delta = rowsum(dO * O)
//   P     = exp(S - lse), recomputed per 64-key tile under the same mask test
//   dV    = P^T dO
//   dS    = P * (dO v^T - delta)
//   dQ    = dS k,   dK = dS^T q
// in float32; mask_logits and all_blocked get no gradient. A blocked key's
// probability underflows to exactly 0 in the forward, so it is 0 here too and
// its dS is 0.
//
// Replaces the backward of rgbdseg_tpu/ops/kernels/masked_attention.py::
// masked_cross_attention (_bwd), which is the VJP of the jnp twin
// masked_cross_attention_xla. The TPU package has no Pallas kernel for it.
//
// Bound on the H100: at Q=100, K=4800, hd=32, H=8, B=2 it reads q, k, v, O, dO,
// the mask and lse (~24 MB) and writes dQ, dK, dV (~20 MB): ~13 us at 3.35 TB/s.
// The five products take 10 * hd flops per unblocked (query, key, head), up to
// 2.5 GFLOP there, ~15 us as float32-accurate products on the tensor cores
// (three TF32 products each at 495 TFLOP/s): bytes and tensor-core work are
// about even. The first version ran the products as scalar FMAs from shared
// memory, two shared loads per FMA, at 30x that bound.
//
// Design. Three launches: the mask as bits, the main kernel, the sum of dQ over
// the key splits.
//  - Mask bits: one warp per (b, query) row ballots the forward's test
//    (mask < 0 && !all_blocked blocks a key) into 32-key words, 2 per 64-key
//    tile. So the mask (the largest input) is read once, not once per head, and
//    the main kernel stages a tile's bits (8 bytes per query) instead of its
//    logits (256 bytes per query).
//  - Main kernel, grid (key splits, H, B), the forward's split of the keys: a
//    block owns a contiguous chunk of 64-key tiles and every query of its
//    (b, h), taken in chunks of up to 128 rows (padded to 16). Four warps. Per
//    chunk it stages q and dO in shared memory (16-byte cp.async), per tile k,
//    v and the mask bits (cp.async, double-buffered). All five products run on
//    the tensor cores as mma.sync m16n8k8 TF32 with the error-compensated split
//    x = hi + lo and three products per step (mma_tf32.cuh), float32 within
//    1e-5. The splits are integer and float ALU operations (conversions run at
//    a quarter rate), and the three products of a step are issued pass by pass
//    over independent accumulators, so consecutive mma.sync do not wait for
//    each other.
//  - Key-major phase: each warp owns 16 keys of the tile and walks the queries
//    in groups of 16. It computes S^T = k q^T and dP^T = v dO^T into
//    accumulators, turns them into P^T and dS^T = P^T * (dP^T - delta) in
//    place, and feeds both straight from the accumulators as the A operand of
//    dV += P^T dO and dK += dS^T q (the queries, the contraction index, read in
//    the permuted order of the accumulator layout). So dK and dV of the warp's
//    keys need no reduction across warps; they are written once per tile
//    (added over query chunks, in order). dS^T goes to shared memory.
//  - Query-major phase: each warp owns 16-row groups of queries and adds dS k
//    for the tile to its dQ accumulators, kept in registers over the block's
//    tiles and written once per split to a scratch row; the third launch sums
//    the splits in order.
//  - delta = rowsum(dO * O) is the diagonal of O dO^T, taken with the same
//    products as dP (see below), so a row that attends to one key gets dS = 0
//    exactly, as in the plain backward.
// Three barriers per tile. No atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace rgbd;

constexpr int kTileK = 64;
constexpr int kMaxRows = 128;  // query rows per chunk
constexpr int kWarps = 4;      // 16 keys of the tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kSubNT = 2;             // n-tiles per step of the key-major phase
constexpr int kGroups = kMaxRows / 16 / kWarps;  // 16-row query groups per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
struct Smem {
  static constexpr int kRS = HD + 16 / (int)sizeof(T);  // q / dO / k / v row stride (elements)
  static constexpr int kKVTile = kTileK * kRS;
  // dS^T row stride (floats), 8 mod 32 so the float2 stores and the A-operand
  // loads of the query-major phase touch 32 different banks.
  static __host__ __device__ int ds_stride(int qp) { return (qp + 31) / 32 * 32 + 8; }
  static __host__ __device__ size_t bytes(int qp) {
    return (size_t)(2 * qp * kRS + 4 * kKVTile) * sizeof(T) +
           (size_t)4 * (kTileK * ds_stride(qp) + 2 * kMaxRows + 2 * 2 * kMaxRows);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 32 ? 2 : 1) mca_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint32_t* __restrict__ allowed, const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part,
    int nh, int nq, int nk, int tiles_per_split, int splits) {
  using S = Smem<T, HD>;
  constexpr int kSteps = HD / 8;  // m16n8k8 steps over hd, and n-tiles over hd
  constexpr int kE = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = HD / kE;         // 16-byte chunks per row

  const int qp_max = (min(nq, kMaxRows) + 15) / 16 * 16;
  const int dss = S::ds_stride(qp_max);
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);           // [qp][kRS]
  T* dos = qs + qp_max * S::kRS;                // [qp][kRS]
  T* kvs = dos + qp_max * S::kRS;               // [2 buffers][k, v][kTileK][kRS]
  float* dst = reinterpret_cast<float*>(kvs + 4 * S::kKVTile);  // dS^T [kTileK][dss]
  float* lse_s = dst + kTileK * dss;            // [kMaxRows]
  float* delta_s = lse_s + kMaxRows;            // [kMaxRows]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(delta_s + kMaxRows);  // [2 buffers][kMaxRows][2]: the tile's mask bits

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group
  const int t = lane & 3;   // thread in group
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + h;
  const int kbeg = split * tiles_per_split * kTileK;
  const int kend = min(nk, kbeg + tiles_per_split * kTileK);
  const int ntile = (kend - kbeg + kTileK - 1) / kTileK;
  const T* kb = k + bh * nk * HD;
  const T* vb = v + bh * nk * HD;
  const int words = 2 * ((nk + kTileK - 1) / kTileK);  // mask words per query row
  const uint32_t* ab_rows = allowed + (long long)b * nq * words;

  auto issue_tile = [&](int tile, int q0, int rows, int qp) {
    const int k0 = kbeg + tile * kTileK;
    T* kt = kvs + (size_t)(2 * (tile & 1)) * S::kKVTile;
    uint32_t* bt = bits_s + (tile & 1) * 2 * kMaxRows;
    for (int idx = tid; idx < 2 * qp; idx += kThreads) {  // zero past `rows`
      const bool ok = idx / 2 < rows;
      cp_async4(bt + idx, ab_rows + (long long)(q0 + (ok ? idx / 2 : 0)) * words + k0 / 32 + (idx & 1), ok);
    }
    for (int idx = tid; idx < 2 * kTileK * kChunks; idx += kThreads) {
      const int which = idx / (kTileK * kChunks);
      const int rem = idx - which * kTileK * kChunks;
      const int j = rem / kChunks;
      const int c = rem - j * kChunks;
      const int key = k0 + j;
      const bool ok = key < nk;
      cp_async16(kt + (size_t)which * S::kKVTile + j * S::kRS + c * kE,
                 (which ? vb : kb) + (long long)(ok ? key : 0) * HD + c * kE, ok);
    }
  };

  for (int q0 = 0; q0 < nq; q0 += kMaxRows) {
    const int rows = min(kMaxRows, nq - q0);
    const int qp = (rows + 15) / 16 * 16;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int idx = tid; idx < 2 * qp * kChunks; idx += kThreads) {
      const int which = idx / (qp * kChunks);
      const int rem = idx - which * qp * kChunks;
      const int r = rem / kChunks;
      const int c = rem - r * kChunks;
      const bool ok = r < rows;
      cp_async16((which ? dos : qs) + r * S::kRS + c * kE,
                 (which ? dout : q) + (bh * nq + q0 + (ok ? r : 0)) * HD + c * kE, ok);
    }
    cp_async_commit();
    issue_tile(0, q0, rows, qp);
    cp_async_commit();
    for (int r = tid; r < qp; r += kThreads) lse_s[r] = r < rows ? lse[bh * nq + q0 + r] : 0.f;
    cp_async_wait1();  // q and dO are here
    __syncthreads();
    // delta = rowsum(dO * O), as the diagonal of O dO^T, with the same 3xTF32
    // products as dP^T = v dO^T below (O in the A operand as v, dO in B). A row
    // that attends to one key has O = hi(v) + lo(v) of that key (the forward's
    // products), so its delta has the bits of that key's dP and its dS is
    // exactly 0, as in the plain backward; f32 FMAs here would leave a
    // rounding-sized dS there, times k. Padding rows get 0.
    for (int r0 = 16 * warp; r0 < qp; r0 += 16 * kWarps) {
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};  // queries r0.. and r0 + 8..
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        float oa[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e & 1);
          oa[e] = r < rows ? to_f32(out[(bh * nq + q0 + r) * HD + 8 * st + t + 4 * (e >> 1)]) : 0.f;
        }
        uint32_t ohi[4], olo[4];
        split_tf32_alu(oa, ohi, olo);
        const int off = (r0 + g) * S::kRS + 8 * st + t;
        const BFrag b0 = split_b(to_f32(dos[off]), to_f32(dos[off + 4]));
        const BFrag b1 = split_b(to_f32(dos[off + 8 * S::kRS]), to_f32(dos[off + 8 * S::kRS + 4]));
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          mma_pass(pass, d0, ohi, olo, b0);
          mma_pass(pass, d1, ohi, olo, b1);
        }
      }
      // Diagonal: (g, 2t) or (g, 2t + 1) of each 16 x 8 block.
      if (g == 2 * t) {
        delta_s[r0 + g] = d0[0];
        delta_s[r0 + 8 + g] = d1[2];
      } else if (g == 2 * t + 1) {
        delta_s[r0 + g] = d0[1];
        delta_s[r0 + 8 + g] = d1[3];
      }
    }
    __syncthreads();

    float dq[kGroups][kSteps][4];
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[i][n][e] = 0.f;

    for (int tile = 0; tile < ntile; ++tile) {
      if (tile + 1 < ntile) issue_tile(tile + 1, q0, rows, qp);
      cp_async_commit();  // possibly empty: keeps wait_group 1 meaning "this tile is here"
      cp_async_wait1();
      __syncthreads();

      const int k0 = kbeg + tile * kTileK;
      const T* kt = kvs + (size_t)(2 * (tile & 1)) * S::kKVTile;
      const T* vt = kt + S::kKVTile;
      const T* kw = kt + 16 * warp * S::kRS;  // this warp's 16 keys
      const T* vw = vt + 16 * warp * S::kRS;
      // This warp's keys in the tile's mask words: word warp / 2, bits from 16 (warp % 2).
      const uint32_t* bw = bits_s + (tile & 1) * 2 * kMaxRows + (warp >> 1);
      const int bit0 = 16 * (warp & 1) + g;

      // Key-major phase.
      float dvacc[kSteps][4], dkacc[kSteps][4];  // keys g, g + 8 x channels 8n + 2t (+1)
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dvacc[n][e] = dkacc[n][e] = 0.f;
      for (int qc = 0; qc < qp; qc += 8 * kSubNT) {
        // S^T and dP^T: s[j] holds keys g, g + 8 x queries qc + 8j + 2t (+1).
        float s[kSubNT][4], dp[kSubNT][4];
#pragma unroll
        for (int j = 0; j < kSubNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          float ka[4], va[4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = (g + 8 * (e & 1)) * S::kRS + 8 * st + t + 4 * (e >> 1);
            ka[e] = to_f32(kw[off]);
            va[e] = to_f32(vw[off]);
          }
          uint32_t khi[4], klo[4], vhi[4], vlo[4];
          split_tf32_alu(ka, khi, klo);
          split_tf32_alu(va, vhi, vlo);
          BFrag qb[kSubNT], ob[kSubNT];
#pragma unroll
          for (int j = 0; j < kSubNT; ++j) {
            const int off = (qc + 8 * j + g) * S::kRS + 8 * st + t;  // b0 (k = t, query g), b1 (k = t + 4)
            if (qc + 8 * j >= qp) continue;
            qb[j] = split_b(to_f32(qs[off]), to_f32(qs[off + 4]));
            ob[j] = split_b(to_f32(dos[off]), to_f32(dos[off + 4]));
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < kSubNT; ++j) {
              if (qc + 8 * j >= qp) continue;
              mma_pass(pass, s[j], khi, klo, qb[j]);
              mma_pass(pass, dp[j], vhi, vlo, ob[j]);
            }
        }
        // P^T and dS^T in place; dS^T to shared memory for the query-major phase.
#pragma unroll
        for (int j = 0; j < kSubNT; ++j) {
          if (qc + 8 * j >= qp) continue;
          const uint32_t w0 = bw[2 * (qc + 8 * j + 2 * t)], w1 = bw[2 * (qc + 8 * j + 2 * t + 1)];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qc + 8 * j + 2 * t + (e & 1);
            const bool on = (((e & 1) ? w1 : w0) >> (bit0 + 8 * (e >> 1))) & 1;
            const float p = on ? expf(s[j][e] - lse_s[qi]) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_s[qi]);
          }
          float* row = dst + (16 * warp + g) * dss + qc + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(row) = make_float2(dp[j][0], dp[j][1]);
          *reinterpret_cast<float2*>(row + 8 * dss) = make_float2(dp[j][2], dp[j][3]);
        }
        // dV += P^T dO and dK += dS^T q over these queries. The A operand is the
        // accumulator of n-tile j as it stands (a0 = (g, query 2t), a1 = (g + 8,
        // query 2t), a2 = (g, query 2t + 1), a3 = (g + 8, query 2t + 1)), so
        // dO's and q's rows are read as queries 2t and 2t + 1.
#pragma unroll
        for (int j = 0; j < kSubNT; ++j) {
          if (qc + 8 * j >= qp) continue;
          uint32_t phi[4], plo[4], dhi[4], dlo[4];
          const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          const float da[4] = {dp[j][0], dp[j][2], dp[j][1], dp[j][3]};
          split_tf32_alu(pa, phi, plo);
          split_tf32_alu(da, dhi, dlo);
          BFrag ob[kSteps], qb[kSteps];
#pragma unroll
          for (int n = 0; n < kSteps; ++n) {
            const int off = (qc + 8 * j + 2 * t) * S::kRS + 8 * n + g;
            ob[n] = split_b(to_f32(dos[off]), to_f32(dos[off + S::kRS]));
            qb[n] = split_b(to_f32(qs[off]), to_f32(qs[off + S::kRS]));
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int n = 0; n < kSteps; ++n) {
              mma_pass(pass, dvacc[n], phi, plo, ob[n]);
              mma_pass(pass, dkacc[n], dhi, dlo, qb[n]);
            }
        }
      }
      // dK and dV of this warp's keys, complete over the chunk's queries.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = k0 + 16 * warp + g + 8 * half;
        if (key >= nk) continue;
        const long long base = (bh * nk + key) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          float2* pv = reinterpret_cast<float2*>(dv + base + 8 * n);
          float2* pk = reinterpret_cast<float2*>(dk + base + 8 * n);
          float2 nv = make_float2(dvacc[n][2 * half], dvacc[n][2 * half + 1]);
          float2 nk2 = make_float2(dkacc[n][2 * half], dkacc[n][2 * half + 1]);
          if (q0 > 0) {
            const float2 ov = *pv, ok = *pk;
            nv.x += ov.x; nv.y += ov.y; nk2.x += ok.x; nk2.y += ok.y;
          }
          *pv = nv;
          *pk = nk2;
        }
      }
      __syncthreads();  // dS^T of the tile is complete

      // Query-major phase: dQ += dS k for this warp's 16-row groups.
#pragma unroll
      for (int st = 0; st < kTileK / 8; ++st) {
        BFrag kb8[kSteps];
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          const T* kr = kt + (8 * st + t) * S::kRS + 8 * n + g;  // b0 (key t, channel g), b1 (key t + 4)
          kb8[n] = split_b(to_f32(kr[0]), to_f32(kr[4 * S::kRS]));
        }
        uint32_t ahi[kGroups][4], alo[kGroups][4];
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          const int r0 = 16 * (warp + kWarps * i);
          if (r0 >= qp) continue;
          const float* a = dst + (8 * st + t) * dss + r0 + g;
          const float aa[4] = {a[0], a[8], a[4 * dss], a[4 * dss + 8]};
          split_tf32_alu(aa, ahi[i], alo[i]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int i = 0; i < kGroups; ++i) {
            if (16 * (warp + kWarps * i) >= qp) continue;
#pragma unroll
            for (int n = 0; n < kSteps; ++n) mma_pass(pass, dq[i][n], ahi[i], alo[i], kb8[n]);
          }
      }
      __syncthreads();  // done with dS^T and this k / v buffer
    }
    // This split's dQ partial of the chunk's rows.
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int r0 = 16 * (warp + kWarps * i);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        if (r0 >= qp || r >= rows) continue;
        float* p = dq_part + ((bh * nq + q0 + r) * splits + split) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
          *reinterpret_cast<float2*>(p + 8 * n) = make_float2(dq[i][n][2 * half], dq[i][n][2 * half + 1]);
      }
    }
  }
}

// allowed[b, q, w], bit i: key 32 w + i of row (b, q) takes part (key < nk and
// not (mask_logits < 0 and not all_blocked), the forward's test); 2 ceil(nk / 64)
// words per row, so a 64-key tile's bits are two whole words. One warp per row.
constexpr int kMaskWarps = 8;

__global__ void __launch_bounds__(32 * kMaskWarps) mca_bwd_mask_kernel(
    const float* __restrict__ mask, const uint8_t* __restrict__ all_blocked, uint32_t* __restrict__ allowed,
    long long rows, int nk, int words) {
  const long long row = (long long)blockIdx.x * kMaskWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const bool exempt = all_blocked[row] != 0;
  const float* m = mask + row * nk;
#pragma unroll 4
  for (int w = 0; w < words; ++w) {
    const int key = 32 * w + lane;
    const bool on = key < nk && (exempt || !(__ldg(m + key) < 0.f));
    const uint32_t bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) allowed[row * words + w] = bits;
  }
}

// dq[row, c] = sum over the splits, in order, of dq_part[row, split, c].
__global__ void mca_bwd_dq_kernel(const float* __restrict__ dq_part, float* __restrict__ dq, long long rows,
                                  int hd, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * hd) return;
  const long long row = i / hd;
  const int c = (int)(i - row * hd);
  const float* p = dq_part + row * splits * hd + c;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += p[(long long)s * hd];
  dq[i] = acc;
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, const void* mask, const void* all_blocked,
                 const void* out, const void* dout, const void* lse, void* dq, void* dk, void* dv, void* dq_part,
                 int b, int nh, int nq, int nk, int tiles_per_split, int splits, cudaStream_t s) {
  const int qp = (min(nq, kMaxRows) + 15) / 16 * 16;
  const size_t smem = Smem<T, HD>::bytes(qp);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mca_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Smem<T, HD>::bytes(kMaxRows));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int words = 2 * ((nk + kTileK - 1) / kTileK);
  uint32_t* allowed = reinterpret_cast<uint32_t*>((float*)dq_part + (size_t)b * nh * nq * splits * HD);
  const long long mask_rows = (long long)b * nq;
  mca_bwd_mask_kernel<<<(unsigned)((mask_rows + kMaskWarps - 1) / kMaskWarps), 32 * kMaskWarps, 0, s>>>(
      (const float*)mask, (const uint8_t*)all_blocked, allowed, mask_rows, nk, words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)splits, (unsigned)nh, (unsigned)b);
  mca_bwd_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, allowed, (const T*)out, (const T*)dout, (const float*)lse,
      (float*)dk, (float*)dv, (float*)dq_part, nh, nq, nk, tiles_per_split, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)b * nh * nq;
  const int threads = 256;
  mca_bwd_dq_kernel<<<(unsigned)((rows * HD + threads - 1) / threads), threads, 0, s>>>(
      (const float*)dq_part, (float*)dq, rows, HD, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* mask, const void* all_blocked,
                const void* out, const void* dout, const void* lse, void* dq, void* dk, void* dv, void* dq_part,
                int b, int nh, int nq, int nk, int tps, int splits, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_typed<T, 16>(q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh, nq, nk,
                                 tps, splits, s);
    case 32:
      return launch_typed<T, 32>(q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh, nq, nk,
                                 tps, splits, s);
    case 64:
      return launch_typed<T, 64>(q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh, nq, nk,
                                 tps, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out and dout in one dtype (float32, or bfloat16 with bf16 = 1); lse
// float32 (b, nh, nq) from the forward; dq, dk, dv float32 outputs; dq_part
// 4-byte scratch of b*nh*nq*splits*hd (the dQ partials) + b*nq*2*ceil(nk/64)
// (the mask bits). Three launches: mask bits, the main kernel, the dQ sum.
// The keys are cut as in the forward:
// splits == ceil(ceil(nk / 64) / tiles_per_split). q, k, v and dout must be
// 16-byte aligned.
extern "C" int rgbd_masked_cross_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask, const void* all_blocked, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* dq_part, int b, int nh, int nq,
    int nk, int hd, int tiles_per_split, int splits, int bf16, void* stream) {
  if (b == 0 || nh == 0 || nq == 0) return (int)cudaSuccess;
  const int ntiles = (nk + kTileK - 1) / kTileK;
  if (nk <= 0 || tiles_per_split <= 0 || splits != (ntiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh,
                                      nq, nk, tiles_per_split, splits, s);
  return dispatch_hd<float>(hd, q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh, nq, nk,
                            tiles_per_split, splits, s);
}
