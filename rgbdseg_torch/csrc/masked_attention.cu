// Mask2Former masked cross-attention (kernel K3).
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
// and rows never divide by zero.
//
// Bound on the H100: at Q=100, K=4800, hd=32, H=8 it reads ~12 MB (k, v and the
// mask) and does ~0.5 GFLOP of f32 multiply-adds: ~7 us at the 67 TFLOP/s f32
// (non-tensor) rate against ~3.6 us of memory, so operations bound it.
// Design (right and simple first): one block per (b, h, tile of 8 queries), one
// warp per query. Each key/value tile of 64 rows is staged in shared memory as
// float32 (k padded to hd+1 columns so the lanes' dot products hit distinct
// banks); each lane scores two keys, the warp reduces max and sum with shuffles,
// and the lanes then accumulate p @ v over the head channels. The k/v tiles are
// re-read from L2 once per query tile (13 times at Q=100). Accumulation is f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;  // the JAX twin's additive mask value
constexpr int kTileK = 64;
constexpr int kWarps = 8;  // queries per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kWarps) masked_cross_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const uint8_t* __restrict__ all_blocked,
    T* __restrict__ out, int nh, int nq, int nk) {
  constexpr int kChunks = (HD + 31) / 32;
  constexpr int kPerLane = kTileK / 32;
  __shared__ float ks[kTileK][HD + 1];
  __shared__ float vs[kTileK][HD];
  __shared__ float ps[kWarps][kTileK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const long long bh = (long long)b * nh + blockIdx.y;
  const int qi = blockIdx.x * kWarps + warp;
  const bool active = qi < nq;
  const T* kb = k + bh * nk * HD;
  const T* vb = v + bh * nk * HD;

  float qreg[HD];
  bool exempt = false;
  const float* mrow = mask;
  if (active) {
    const T* qrow = q + (bh * nq + qi) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qreg[d] = to_f32(qrow[d]);
    exempt = all_blocked[(long long)b * nq + qi] != 0;
    mrow = mask + ((long long)b * nq + qi) * nk;
  }

  float m_run = -1e30f;
  float l_run = 0.f;
  float acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTileK) {
    for (int idx = threadIdx.x; idx < kTileK * HD; idx += blockDim.x) {
      const int j = idx / HD;
      const int d = idx - j * HD;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < nk) {
        kv = to_f32(kb[(long long)kj * HD + d]);
        vv = to_f32(vb[(long long)kj * HD + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    if (active) {
      float s[kPerLane];
      float tile_max = -1e30f;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int j = lane + 32 * r;
        const int kj = k0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot += qreg[d] * ks[j][d];
        const bool blocked = kj >= nk || (!exempt && mrow[kj] < 0.f);
        s[r] = dot + (blocked ? kNegInf : 0.f);
        tile_max = fmaxf(tile_max, s[r]);
      }
      const float m_new = fmaxf(m_run, warp_max(tile_max));
      const float alpha = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float p = expf(s[r] - m_new);
        ps[warp][lane + 32 * r] = p;
        psum += p;
      }
      l_run = l_run * alpha + warp_sum(psum);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) {
          float a = acc[c] * alpha;
#pragma unroll 8
          for (int j = 0; j < kTileK; ++j) a += ps[warp][j] * vs[j][d];
          acc[c] = a;
        }
      }
      __syncwarp();
      m_run = m_new;
    }
    __syncthreads();
  }

  if (active) {
    T* orow = out + (bh * nq + qi) * HD;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) store(orow + d, acc[c] * inv);
    }
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* mask,
                 const void* all_blocked, void* out, int b, int nh, int nq, int nk, int hd,
                 cudaStream_t s) {
  const dim3 block(32 * kWarps);
  const dim3 grid((unsigned)((nq + kWarps - 1) / kWarps), (unsigned)nh, (unsigned)b);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  const float* mm = (const float*)mask;
  const uint8_t* ab = (const uint8_t*)all_blocked;
  T* oo = (T*)out;
  switch (hd) {
    case 16:
      masked_cross_attention_kernel<T, 16><<<grid, block, 0, s>>>(qq, kk, vv, mm, ab, oo, nh, nq, nk);
      break;
    case 32:
      masked_cross_attention_kernel<T, 32><<<grid, block, 0, s>>>(qq, kk, vv, mm, ab, oo, nh, nq, nk);
      break;
    case 64:
      masked_cross_attention_kernel<T, 64><<<grid, block, 0, s>>>(qq, kk, vv, mm, ab, oo, nh, nq, nk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rgbd_masked_cross_attention(
    const void* q, const void* k, const void* v, const void* mask, const void* all_blocked,
    void* out, int b, int nh, int nq, int nk, int hd, int bf16, void* stream) {
  if (b == 0 || nh == 0 || nq == 0) return (int)cudaSuccess;
  if (nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch_typed<__nv_bfloat16>(q, k, v, mask, all_blocked, out, b, nh, nq, nk, hd, s);
  return launch_typed<float>(q, k, v, mask, all_blocked, out, b, nh, nq, nk, hd, s);
}
