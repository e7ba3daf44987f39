// Multi-scale deformable-attention sampling for one level (kernel K1).
//
//   out[bh, l, :] = sum_p aw[bh, l, p] * bilinear_zeros(V[bh], gy[bh, l, p], gx[bh, l, p])
//
// gx, gy are pixel coordinates (x * w - 0.5, y * h - 0.5); V is (BH, h*w, hd)
// row-major over (y, x); out is (BH, L, hd) float32.
//
// Replaces the TPU kernels rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level
// (_tent_kernel) and ::tent_sample_level_band (_tent_band_kernel). Those build
// the dense "tent" matrix P[l, y*w+x] and contract it with V on the MXU, because
// the TPU gathers slowly. On Hopper a gather is cheap, so this kernel reads the
// <= 4 in-bounds bilinear corners of each point directly. Bilinear weights with
// zeros padding are exactly the tent relu(1 - |g - x|) at the two cells around
// g, including coordinates that are exact integers (the far corner gets weight 0).
//
// Bound on the H100: memory. Per call it must read gx, gy, aw (3 * BH*L*P f32)
// and V once and write out (BH*L*hd f32): about 14 MB at the 60x80 level of a
// 480x640 frame, ~4 us at 3.35 TB/s, against ~0.05 GFLOP of f32 FMAs (<1 us).
// Design: one warp per query (bh, l); the lanes run over the head channels, so
// every corner read is one coalesced 128-byte row of V (hd = 32, f32). The
// per-point coordinates and weights are warp-uniform loads. V's rows are read
// again by neighbouring queries and are served from L2. Accumulation is f32;
// V may be float32 or bfloat16.
//
// Points whose footprint lies wholly outside the map contribute zero and are
// skipped before any float->int conversion (this also skips NaN coordinates).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 4;  // hd <= 128

template <typename T>
__global__ void deform_sample_level_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ aw, const T* __restrict__ v,
    float* __restrict__ out, int bh, int l, int npts, int h, int w, int hd) {
  const int lane = threadIdx.x & 31;
  const long long query = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (query >= (long long)bh * l) return;
  const long long b = query / l;
  const T* vb = v + b * (long long)h * w * hd;
  const long long pbase = query * npts;

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;

  for (int p = 0; p < npts; ++p) {
    const float x = gx[pbase + p];
    const float y = gy[pbase + p];
    const float a = aw[pbase + p];
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    if (!(x0f >= -1.f && x0f <= (float)(w - 1) && y0f >= -1.f && y0f <= (float)(h - 1))) continue;
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1;
      const int dx = corner & 1;
      const int yy = y0 + dy;
      const int xx = x0 + dx;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const float wgt = a * (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
      const T* row = vb + ((long long)yy * w + xx) * hd;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) acc[c] += wgt * to_f32(row[d]);
      }
    }
  }
  float* o = out + query * hd;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < hd) o[d] = acc[c];
  }
}

}  // namespace

extern "C" int rgbd_deform_sample_level(
    const void* gx, const void* gy, const void* aw, const void* v, void* out,
    int bh, int l, int npts, int h, int w, int hd, int v_bf16, void* stream) {
  if (hd <= 0 || hd > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  const long long queries = (long long)bh * l;
  if (queries == 0) return (int)cudaSuccess;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (v_bf16) {
    deform_sample_level_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)gx, (const float*)gy, (const float*)aw, (const __nv_bfloat16*)v,
        (float*)out, bh, l, npts, h, w, hd);
  } else {
    deform_sample_level_kernel<float><<<grid, block, 0, s>>>(
        (const float*)gx, (const float*)gy, (const float*)aw, (const float*)v,
        (float*)out, bh, l, npts, h, w, hd);
  }
  return (int)cudaGetLastError();
}
