// Mask2Former masked cross-attention (kernel K3), split over the keys.
//
//   out[b, h, q, :] = softmax_k(q . k + bias[b, q, k]) @ v
//   bias = -1e9 where mask_logits[b, q, k] < 0 && !all_blocked[b, q], else 0
//
// q is (B, H, Q, hd) and already scaled by hd**-0.5; k, v are (B, H, K, hd);
// mask_logits (B, Q, K) float32 raw (pre-sigmoid) logits, sigmoid(m) < 0.5 <=> m < 0;
// all_blocked (B, Q) bool. Output (B, H, Q, hd) in q's dtype (float32 or bfloat16).
//
// Replaces the TPU kernel rgbdseg_tpu/ops/kernels/masked_attention.py::
// masked_cross_attention (_mca_pallas / _mca_kernel). As there, the softmax is an
// online (flash-style) recurrence over key tiles, the mask test is evaluated on
// the raw logits inside the kernel, and all_blocked is folded into that test.
// Blocked keys take the same additive -1e9 as the JAX twin (not -inf), and so do
// the padding keys of the last tile.
//
// Invariant: every row has at least one key with bias 0, either because
// all_blocked exempts the row or because some logit is >= 0. So the final
// running max is a real score, every -1e9 entry's weight underflows to exactly 0,
// and rows never divide by zero. A split whose keys are all blocked for a row has
// a partial max near -1e9; its weight exp(m_split - m_final) in the combine
// underflows to exactly 0, so it adds exactly nothing.
//
// Bound on the H100: at Q=100, K=4800, hd=32, H=8 it reads ~12 MB (k, v and the
// mask) and does ~0.25 GFLOP of multiply-adds for the unblocked pairs, so bytes
// bound it (~4 us).
//
// Design. A call is TWO launches: the split kernel and the combine kernel.
//  - Split kernel, grid (key splits, H, B * query tiles). A block owns every
//    query of its (b, h) (up to 128, padded to 16 inside the kernel; more
//    queries take more query tiles) and one contiguous chunk of whole 64-key
//    tiles, so k and v are read once. The wrapper sizes the chunk so that the
//    grid fills the card in one wave of two blocks per SM: at K=4800, 25 splits
//    of 3 tiles, 200 blocks (38 splits of 2 tiles would need 1.15 waves).
//  - k, v and mask tiles are staged with 16-byte cp.async (4-byte where K is
//    not a multiple of 4), double-buffered.
//  - float32: the products run on the tensor cores as mma.sync m16n8k8 TF32
//    with the error-compensated split x = hi + lo (hi = tf32(x), lo = tf32(x -
//    hi)) and three products hi*hi + hi*lo + lo*hi per step, which keeps the
//    f32 comparison with the plain version within 1e-5 (one TF32 product would
//    not). A warp owns 16 query rows: its q fragments (already split) stay in
//    registers for the whole kernel; per 64-key tile it computes the 16 x 64
//    scores into accumulators, applies the mask there, takes the row max over
//    the four lanes of a row with two shuffles, and feeds the probabilities
//    straight from the score accumulators into p @ v as the A operand: the
//    contraction over keys does not care about their order, so the B operand
//    (v) is read with the keys permuted to match the accumulator layout
//    (k-index t <-> key 2t, t + 4 <-> key 2t + 1 within each block of 8).
//    Scores are kept in log2 units (q times log2(e)), so exp2 replaces exp.
//  - bfloat16: what the JAX kernel computes at Precision.DEFAULT, bf16
//    products with float32 sums (mma.sync m16n8k16, csrc/mma_bf16.cuh), half
//    the depth steps of m16n8k8 and one product each where 3xTF32 took three
//    (a bf16 value is exact in TF32, so two of them added zeros). q's
//    fragments are loaded as they are; log2(e) multiplies the float32 scores
//    after the product (multiplying q first would round it into bf16). The
//    mask, the running max and sum and the partials are the float32 route's;
//    p = exp2(s - m) enters the sum unrounded and is rounded to bf16 for
//    p @ v, as the JAX kernel rounds it: the score accumulators of two
//    neighbouring 8-key blocks, packed pairwise (cvt.rn.bf16x2.f32), are the
//    A fragment of 16 keys, and v's B fragments come from ldmatrix .trans of
//    the staged bf16 tile, the keys in order.
//  - Each block writes (running max, running sum, unnormalised accumulator) per
//    row to a scratch tensor; the combine kernel (one warp per row) rescales by
//    exp2(m_s - max_s m_s), sums over the splits and normalises. Where the caller
//    asks for it, the combine kernel also writes each row's log-sum-exp of the
//    masked scores (natural log), which the backward (masked_attention_bwd.cu)
//    uses to recompute the probabilities.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace rgbd;

constexpr float kNegInf = -1e9f;  // the JAX twin's additive mask value
constexpr float kInit = -1e30f;   // running max before the first tile
constexpr float kLog2e = 1.4426950408889634f;  // scores are kept in log2 units: exp2 is cheaper
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTileK = 64;
constexpr int kRowsPerWarp = 16;
constexpr int kMaxRows = 128;  // query rows of one block
constexpr int kMS = kTileK + 4;  // mask row stride (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
struct Layout {
  static constexpr int kKS = HD + 16 / (int)sizeof(T);  // k/v row stride (elements)
  static constexpr int kKVTile = kTileK * kKS;          // one k or v tile (elements)
  static size_t bytes(int rows) { return (size_t)4 * kKVTile * sizeof(T) + (size_t)2 * rows * kMS * 4; }
};

// Two blocks per SM where the registers allow it (hd <= 32).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMaxRows / kRowsPerWarp, HD <= 32 ? 2 : 1) mca_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const uint8_t* __restrict__ all_blocked,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int nh, int nq, int nk, int q_rows, int qtiles, int tiles_per_split, int splits, int mask_vec) {
  using L = Layout<T, HD>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kSteps = HD / 8;  // m16n8k8 steps over hd (q.k) and n-tiles over hd (p.v)
  constexpr int kBf16Steps = HD / 16;  // m16n8k16 steps over hd (q.k, bf16)
  constexpr int kChunks = HD * (int)sizeof(T) / 16;  // 16-byte chunks per k/v row

  extern __shared__ __align__(16) unsigned char smem[];
  T* kvs = reinterpret_cast<T*>(smem);
  float* ms = reinterpret_cast<float*>(smem + (size_t)4 * L::kKVTile * sizeof(T));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: rows g and g + 8, b-operand column g
  const int t = lane & 3;   // thread in group
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / qtiles;
  const int q0 = (blockIdx.z - b * qtiles) * q_rows;
  const long long bh = (long long)b * nh + h;
  const int kbeg = split * tiles_per_split * kTileK;
  const int kend = min(nk, kbeg + tiles_per_split * kTileK);
  const int ntile = (kend - kbeg + kTileK - 1) / kTileK;
  const T* kb = k + bh * nk * HD;
  const T* vb = v + bh * nk * HD;
  const float* mb = mask + (long long)b * nq * nk;

  auto issue_tile = [&](int tile) {
    const int k0 = kbeg + tile * kTileK;
    const int buf = tile & 1;
    T* kt = kvs + (size_t)(2 * buf) * L::kKVTile;
    for (int idx = tid; idx < 2 * kTileK * kChunks; idx += blockDim.x) {
      const int which = idx / (kTileK * kChunks);
      const int rem = idx - which * kTileK * kChunks;
      const int j = rem / kChunks;
      const int c = rem - j * kChunks;
      const int key = k0 + j;
      const bool ok = key < nk;
      const T* src = (which ? vb : kb) + (long long)(ok ? key : 0) * HD + c * (16 / (int)sizeof(T));
      cp_async16(kt + (size_t)which * L::kKVTile + j * L::kKS + c * (16 / (int)sizeof(T)), src, ok);
    }
    float* mt = ms + (size_t)buf * q_rows * kMS;
    if (mask_vec) {
      for (int idx = tid; idx < q_rows * (kTileK / 4); idx += blockDim.x) {
        const int r = idx / (kTileK / 4);
        const int c = idx - r * (kTileK / 4);
        const int qi = q0 + r;
        const int key = k0 + 4 * c;
        const bool ok = qi < nq && key < nk;
        cp_async16(mt + r * kMS + 4 * c, mb + (ok ? (long long)qi * nk + key : 0), ok);
      }
    } else {
      for (int idx = tid; idx < q_rows * kTileK; idx += blockDim.x) {
        const int r = idx / kTileK;
        const int c = idx - r * kTileK;
        const int qi = q0 + r;
        const int key = k0 + c;
        const bool ok = qi < nq && key < nk;
        cp_async4(mt + r * kMS + c, mb + (ok ? (long long)qi * nk + key : 0), ok);
      }
    }
  };

  issue_tile(0);
  cp_async_commit();

  // This warp's rows are r0 = warp * 16 + g and r0 + 8. Their q fragments, zero
  // for padding rows: float32 q times log2(e), split into hi and lo; bf16 q as
  // it is (m16n8k16 A fragments, two bf16 per register).
  const int r0 = warp * kRowsPerWarp + g;
  uint32_t qhi[kSteps][4], qlo[kSteps][4];
  uint32_t qa[kBf16Steps][4];
  bool exempt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    exempt[half] = qi >= nq || all_blocked[(long long)b * nq + qi] != 0;
  }
  if constexpr (kBf16) {
#pragma unroll
    for (int s = 0; s < kBf16Steps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
        const int qi = q0 + r0 + 8 * (e & 1);
        qa[s][e] = qi < nq ? *reinterpret_cast<const uint32_t*>(q + (bh * nq + qi) * HD + 16 * s + 2 * t + 8 * (e >> 1))
                           : 0u;
      }
  } else {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const int qi = q0 + r0 + 8 * (e & 1);
        const float x = qi < nq ? to_f32(q[(bh * nq + qi) * HD + 8 * s + t + 4 * (e >> 1)]) * kLog2e : 0.f;
        split_tf32(x, qhi[s][e], qlo[s][e]);
      }
  }

  float m_run[2] = {kInit, kInit};
  float l_run[2] = {0.f, 0.f};
  float o[kSteps][4];  // rows g (0, 1) and g + 8 (2, 3); channels 8n + 2t (+1)
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) issue_tile(tile + 1);
    cp_async_commit();  // possibly empty: keeps wait_group 1 meaning "this tile is here"
    cp_async_wait1();
    __syncthreads();

    const int buf = tile & 1;
    const int k0 = kbeg + tile * kTileK;
    const T* kt = kvs + (size_t)(2 * buf) * L::kKVTile;
    const T* vt = kt + L::kKVTile;
    const float* mw = ms + ((size_t)buf * q_rows + warp * kRowsPerWarp) * kMS;  // this warp's mask rows

    // Scores: s[n] holds rows g, g + 8 x keys 8n + 2t, 8n + 2t + 1.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kBf16) {
      // bf16 products, float32 sums: the JAX kernel's q . k at Precision.DEFAULT.
      // b0 = (k = 2t..2t+1, key g), b1 = (k = 2t+8.., key g): two bf16 of k's row.
#pragma unroll
      for (int st = 0; st < kBf16Steps; ++st)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const T* kr = kt + (8 * n + g) * L::kKS + 16 * st + 2 * t;
          mma_bf16(s[n], qa[st], *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      // Scores in log2 units, scaled after the product so that q is not rounded with log2(e).
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= kLog2e;
    } else {
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const T* kr = kt + (8 * n + g) * L::kKS + 8 * st + t;  // b0 (k = t, key g), b1 (k = t + 4)
          mma_3xtf32(s[n], qhi[st], qlo[st], to_f32(kr[0]), to_f32(kr[4]));
        }
    }

    // Mask, then the online softmax per row (max over the 4 lanes of a row).
    float mt[2] = {kInit, kInit};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 mv = *reinterpret_cast<const float2*>(mw + (g + 8 * half) * kMS + 8 * n + 2 * t);
        const int key = k0 + 8 * n + 2 * t;
        const bool b0 = key >= nk || (!exempt[half] && mv.x < 0.f);
        const bool b1 = key + 1 >= nk || (!exempt[half] && mv.y < 0.f);
        s[n][2 * half] += b0 ? kNegInf : 0.f;
        s[n][2 * half + 1] += b1 ? kNegInf : 0.f;
        mt[half] = fmaxf(mt[half], fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mt[half] = fmaxf(mt[half], __shfl_xor_sync(0xffffffffu, mt[half], 1));
      mt[half] = fmaxf(mt[half], __shfl_xor_sync(0xffffffffu, mt[half], 2));
      const float m_new = fmaxf(m_run[half], mt[half]);
      alpha[half] = exp2f(m_run[half] - m_new);
      m_run[half] = m_new;
      l_run[half] *= alpha[half];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    if constexpr (kBf16) {
      // p @ v, 16 keys per step, p rounded to bf16 as the JAX kernel rounds it
      // (the running sum above took it unrounded). The A fragment is the score
      // accumulators of key blocks 2j and 2j + 1 packed pairwise; v's B
      // fragments come from ldmatrix .trans of 8 x 8 blocks (keys x channels):
      // matrix i of an x4 is keys 16j + 8 (i & 1) .., channels 8 (n + (i >> 1)) ..
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < kSteps; n += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + (16 * j + 8 * ((lane >> 3) & 1) + (lane & 7)) * L::kKS + 8 * (n + (lane >> 4)));
          mma_bf16(o[n], pa, vb[0], vb[1]);
          mma_bf16(o[n + 1], pa, vb[2], vb[3]);
        }
      }
    } else {
      // p @ v, 8 keys per step. The A operand is the score accumulator of block j
      // as it stands (a0 = (g, key 2t), a1 = (g + 8, key 2t), a2 = (g, key 2t + 1),
      // a3 = (g + 8, key 2t + 1)), so v's rows are read as keys 2t and 2t + 1.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t phi[4], plo[4];
        split_tf32(s[j][0], phi[0], plo[0]);
        split_tf32(s[j][2], phi[1], plo[1]);
        split_tf32(s[j][1], phi[2], plo[2]);
        split_tf32(s[j][3], phi[3], plo[3]);
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          const T* vr = vt + (8 * j + 2 * t) * L::kKS + 8 * n + g;
          mma_3xtf32(o[n], phi, plo, to_f32(vr[0]), to_f32(vr[L::kKS]));
        }
      }
    }
    __syncthreads();
  }

  // Partials: per (bh, query, split) the running max and sum and the accumulator.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + r0 + 8 * half;
    if (qi >= nq) continue;
    const long long slot = (bh * nq + qi) * splits + split;
    float* po = part_o + slot * HD;
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
      *reinterpret_cast<float2*>(po + 8 * n + 2 * t) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
    if (t == 0) {
      part_ml[2 * slot] = m_run[half];
      part_ml[2 * slot + 1] = l;
    }
  }
}

// One warp per (bh, query) row: lanes over the splits find the max and the
// rescaled sum, then lanes over the channels accumulate the rescaled partials
// (eight splits' loads in flight), and normalise.
constexpr int kCombineWarps = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kCombineWarps) mca_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml, T* __restrict__ out,
    float* __restrict__ lse, long long rows, int splits) {
  constexpr int kPerLane = (HD + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ml = part_ml + row * splits * 2;
  const float* po = part_o + row * splits * HD;
  float m = kInit;
  for (int s = lane; s < splits; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    const float w = s < splits ? exp2f(ml[2 * s] - m) : 0.f;
    if (s < splits) l = fmaf(w, ml[2 * s + 1], l);
    const int n = min(32, splits - s0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* p = po + (long long)(s0 + j) * HD;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        if (lane + 32 * c < HD) acc[c] = fmaf(wj, p[lane + 32 * c], acc[c]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int c = 0; c < kPerLane; ++c)
    if (lane + 32 * c < HD) store(out + row * HD + lane + 32 * c, acc[c] / l);
  if (lane == 0) lse[row] = (m + log2f(l)) * kLn2;
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, const void* mask, const void* all_blocked,
                 void* out, void* part_o, void* part_ml, void* lse, int b, int nh, int nq, int nk,
                 int tiles_per_split, int splits, cudaStream_t s) {
  const int qtiles = (nq + kMaxRows - 1) / kMaxRows;
  const int per_tile = (nq + qtiles - 1) / qtiles;
  const int q_rows = (per_tile + kRowsPerWarp - 1) / kRowsPerWarp * kRowsPerWarp;
  const size_t smem = Layout<T, HD>::bytes(q_rows);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mca_split_kernel<T, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Layout<T, HD>::bytes(kMaxRows));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int mask_vec = (nk % 4 == 0) && ((uintptr_t)mask % 16 == 0);
  const dim3 grid((unsigned)splits, (unsigned)nh, (unsigned)(b * qtiles));
  mca_split_kernel<T, HD><<<grid, 32 * (q_rows / kRowsPerWarp), smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (const uint8_t*)all_blocked,
      (float*)part_o, (float*)part_ml, nh, nq, nk, q_rows, qtiles, tiles_per_split, splits, mask_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)b * nh * nq;
  mca_combine_kernel<T, HD><<<(unsigned)((rows + kCombineWarps - 1) / kCombineWarps), 32 * kCombineWarps, 0, s>>>(
      (const float*)part_o, (const float*)part_ml, (T*)out, (float*)lse, rows, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* mask,
                const void* all_blocked, void* out, void* part_o, void* part_ml, void* lse, int b, int nh,
                int nq, int nk, int tps, int splits, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_typed<T, 16>(q, k, v, mask, all_blocked, out, part_o, part_ml, lse, b, nh, nq, nk, tps, splits, s);
    case 32: return launch_typed<T, 32>(q, k, v, mask, all_blocked, out, part_o, part_ml, lse, b, nh, nq, nk, tps, splits, s);
    case 64: return launch_typed<T, 64>(q, k, v, mask, all_blocked, out, part_o, part_ml, lse, b, nh, nq, nk, tps, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_o: float32 scratch of b*nh*nq*splits*hd; part_ml: of b*nh*nq*splits*2;
// lse: float32 (b, nh, nq) for the rows' log-sum-exp. The keys are
// cut into `splits` chunks of `tiles_per_split` 64-key tiles
// (splits == ceil(ceil(nk / 64) / tiles_per_split)). k and v must be 16-byte
// aligned, q 4-byte aligned.
extern "C" int rgbd_masked_cross_attention(
    const void* q, const void* k, const void* v, const void* mask, const void* all_blocked,
    void* out, void* part_o, void* part_ml, void* lse, int b, int nh, int nq, int nk, int hd,
    int tiles_per_split, int splits, int bf16, void* stream) {
  if (b == 0 || nh == 0 || nq == 0) return (int)cudaSuccess;
  const int ntiles = (nk + kTileK - 1) / kTileK;
  if (nk <= 0 || tiles_per_split <= 0 || splits != (ntiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v) % 16 != 0 || (uintptr_t)q % 4 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, all_blocked, out, part_o, part_ml, lse, b, nh, nq, nk,
                                      tiles_per_split, splits, s);
  return dispatch_hd<float>(hd, q, k, v, mask, all_blocked, out, part_o, part_ml, lse, b, nh, nq, nk,
                            tiles_per_split, splits, s);
}
