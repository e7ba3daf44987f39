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
// masked_cross_attention_xla.
//
// Bound on the H100: at Q=100, K=4800, hd=32, H=8, B=2 it reads q, k, v, O, dO,
// the mask and lse (~24 MB) and writes dQ, dK, dV (~20 MB): ~13 us at 3.35 TB/s.
// The five products take 10 * hd flops per unblocked (query, key, head), up to
// 2.5 GFLOP there (~37 us at 67 TFLOP/s in f32 FMA): operations bound it unless
// most pairs are blocked.
//
// Design (simple, correct first; the forward's split reused). Grid (key splits,
// H, B): a block owns a contiguous chunk of 64-key tiles (the forward's split
// plan) and every query of its (b, h), taken in chunks of up to 128 rows. So it
// writes dK and dV of its keys directly (adding over query chunks, in order) and
// keeps its partial dQ of each query chunk in registers over its tiles, to write
// it once to a per-split scratch row; a second kernel sums the splits in order.
// No atomics: the result is deterministic. Per tile the block stages k and v in
// shared memory (rows padded by one float against bank conflicts), computes P
// into a (rows x 64) shared tile, dV from it, overwrites it in place with dS,
// then dK and the dQ partial. All products are scalar f32 FMAs from shared
// memory (no tensor cores): a first version that is right, not fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;
constexpr int kMaxRows = 128;  // query rows per chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
struct Smem {
  static constexpr int kRS = HD + 1;      // q / dO / k / v row stride (floats)
  static constexpr int kPS = kTileK + 1;  // P / dS row stride
  static constexpr size_t bytes() {
    return (size_t)4 * (2 * kMaxRows * kRS + 2 * kTileK * kRS + kMaxRows * kPS + 3 * kMaxRows);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) mca_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const uint8_t* __restrict__ all_blocked, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dq_part, int nh, int nq, int nk, int tiles_per_split,
    int splits) {
  using S = Smem<HD>;
  constexpr int kQPer = kMaxRows * HD / kThreads;  // dQ elements per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kMaxRows][kRS]
  float* dos = qs + kMaxRows * S::kRS;       // [kMaxRows][kRS]
  float* ks = dos + kMaxRows * S::kRS;       // [kTileK][kRS]
  float* vs = ks + kTileK * S::kRS;          // [kTileK][kRS]
  float* ps = vs + kTileK * S::kRS;          // [kMaxRows][kPS]: P, then dS
  float* lse_s = ps + kMaxRows * S::kPS;     // [kMaxRows]
  float* delta_s = lse_s + kMaxRows;         // [kMaxRows]
  float* exempt_s = delta_s + kMaxRows;      // [kMaxRows], 1 where all_blocked

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + h;
  const int kbeg = split * tiles_per_split * kTileK;
  const int kend = min(nk, kbeg + tiles_per_split * kTileK);
  const int ntile = (kend - kbeg + kTileK - 1) / kTileK;

  for (int q0 = 0; q0 < nq; q0 += kMaxRows) {
    const int rows = min(kMaxRows, nq - q0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD;
      const int c = i - r * HD;
      const long long gi = (bh * nq + q0 + r) * HD + c;
      qs[r * S::kRS + c] = to_f32(q[gi]);
      dos[r * S::kRS + c] = to_f32(dout[gi]);
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      const long long row = bh * nq + q0 + r;
      float d = 0.f;
      for (int c = 0; c < HD; ++c) d = fmaf(dos[r * S::kRS + c], to_f32(out[row * HD + c]), d);
      delta_s[r] = d;
      lse_s[r] = lse[row];
      exempt_s[r] = all_blocked[(long long)b * nq + q0 + r] ? 1.f : 0.f;
    }
    float dq[kQPer];
#pragma unroll
    for (int m = 0; m < kQPer; ++m) dq[m] = 0.f;

    for (int tile = 0; tile < ntile; ++tile) {
      const int k0 = kbeg + tile * kTileK;
      __syncthreads();  // the previous tile is done with k, v and P
      for (int i = tid; i < kTileK * HD; i += kThreads) {
        const int j = i / HD;
        const int c = i - j * HD;
        const int key = k0 + j;
        const bool ok = key < nk;
        ks[j * S::kRS + c] = ok ? to_f32(k[(bh * nk + key) * HD + c]) : 0.f;
        vs[j * S::kRS + c] = ok ? to_f32(v[(bh * nk + key) * HD + c]) : 0.f;
      }
      __syncthreads();
      // P = exp(S - lse) where the key is not blocked, else 0.
      for (int i = tid; i < rows * kTileK; i += kThreads) {
        const int r = i / kTileK;
        const int j = i - r * kTileK;
        const int key = k0 + j;
        float p = 0.f;
        if (key < nk && (exempt_s[r] != 0.f || mask[((long long)b * nq + q0 + r) * nk + key] >= 0.f)) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) s = fmaf(qs[r * S::kRS + c], ks[j * S::kRS + c], s);
          p = expf(s - lse_s[r]);
        }
        ps[r * S::kPS + j] = p;
      }
      __syncthreads();
      // dV = P^T dO for this tile's keys, complete over the chunk's rows.
      for (int i = tid; i < kTileK * HD; i += kThreads) {
        const int j = i / HD;
        const int c = i - j * HD;
        const int key = k0 + j;
        if (key >= nk) continue;
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc = fmaf(ps[r * S::kPS + j], dos[r * S::kRS + c], acc);
        float* dst = dv + (bh * nk + key) * HD + c;
        *dst = q0 == 0 ? acc : *dst + acc;
      }
      __syncthreads();
      // dS = P * (dO v^T - delta), in place.
      for (int i = tid; i < rows * kTileK; i += kThreads) {
        const int r = i / kTileK;
        const int j = i - r * kTileK;
        const float p = ps[r * S::kPS + j];
        if (p == 0.f) continue;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) dp = fmaf(dos[r * S::kRS + c], vs[j * S::kRS + c], dp);
        ps[r * S::kPS + j] = p * (dp - delta_s[r]);
      }
      __syncthreads();
      // dK = dS^T q for this tile's keys.
      for (int i = tid; i < kTileK * HD; i += kThreads) {
        const int j = i / HD;
        const int c = i - j * HD;
        const int key = k0 + j;
        if (key >= nk) continue;
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc = fmaf(ps[r * S::kPS + j], qs[r * S::kRS + c], acc);
        float* dst = dk + (bh * nk + key) * HD + c;
        *dst = q0 == 0 ? acc : *dst + acc;
      }
      // dQ += dS k (padding keys have k = 0 and dS = 0).
#pragma unroll
      for (int m = 0; m < kQPer; ++m) {
        const int e = tid + m * kThreads;
        const int r = e / HD;
        const int c = e - r * HD;
        if (r >= rows) continue;
        float acc = dq[m];
#pragma unroll 8
        for (int j = 0; j < kTileK; ++j) acc = fmaf(ps[r * S::kPS + j], ks[j * S::kRS + c], acc);
        dq[m] = acc;
      }
    }
#pragma unroll
    for (int m = 0; m < kQPer; ++m) {
      const int e = tid + m * kThreads;
      const int r = e / HD;
      const int c = e - r * HD;
      if (r < rows) dq_part[((bh * nq + q0 + r) * splits + split) * HD + c] = dq[m];
    }
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
  const size_t smem = Smem<HD>::bytes();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(mca_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)splits, (unsigned)nh, (unsigned)b);
  mca_bwd_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (const uint8_t*)all_blocked, (const T*)out,
      (const T*)dout, (const float*)lse, (float*)dk, (float*)dv, (float*)dq_part, nh, nq, nk, tiles_per_split,
      splits);
  cudaError_t e = cudaGetLastError();
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
// float32 scratch of b*nh*nq*splits*hd. The keys are cut as in the forward:
// splits == ceil(ceil(nk / 64) / tiles_per_split).
extern "C" int rgbd_masked_cross_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask, const void* all_blocked, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* dq_part, int b, int nh, int nq,
    int nk, int hd, int tiles_per_split, int splits, int bf16, void* stream) {
  if (b == 0 || nh == 0 || nq == 0) return (int)cudaSuccess;
  const int ntiles = (nk + kTileK - 1) / kTileK;
  if (nk <= 0 || tiles_per_split <= 0 || splits != (ntiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh,
                                      nq, nk, tiles_per_split, splits, s);
  return dispatch_hd<float>(hd, q, k, v, mask, all_blocked, out, dout, lse, dq, dk, dv, dq_part, b, nh, nq, nk,
                            tiles_per_split, splits, s);
}
