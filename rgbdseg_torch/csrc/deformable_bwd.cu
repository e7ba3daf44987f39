// Backward of the multi-scale deformable-attention sampling (kernel K1).
//
// Forward (csrc/deformable.cu):
//   out[b, l, h, :] = sum_lvl sum_p aw[b, l, h, lvl, p]
//                       * sum_{y, x} ty(y) tx(x) V_lvl[b, y, x, h, :]
// with the tents tx(x) = max(0, 1 - |gx - x|), ty(y) = max(0, 1 - |gy - y|) over
// the level's cells, gx = loc_x * w - 0.5 and gy = loc_y * h - 0.5 (or loc in
// pixels, the per-level entry). Given grad_out (B, L, nh * hd) this kernel writes
//   d_value (B, L_total, nh, hd) += aw * ty(y) tx(x) * grad_out   (scatter, atomics)
//   d_aw    (B, L, nh, nl, P)     = <bilinear sample, grad_out>
//   d_loc   (B, L, nh, nl, P, 2)  = aw * (sum_{y,x} ty(y) tx'(x) <V[y, x], grad_out> * w,
//                                        sum_{y,x} ty'(y) tx(x) <V[y, x], grad_out> * h)
//
// Replaces the backward of rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level
// (and ::tent_sample_level_band), which is the VJP of the jnp tent twin
// tent_sample_level_xla. So the kernel differentiates the tent itself, cell by cell,
// in float32 as that VJP does: with u = gx - x and t = 1 - |u|, the value is
// max(0, t) and the slope tx'(x) is -sign(u) where t > 0 (-1 at u = 0, since
// jax.grad(abs)(0) = 1), half of it where t == 0 exactly (JAX's max splits a tie),
// and 0 where t < 0. Away from integers that is the bilinear gradient (-1 at
// floor(gx), +1 above); at an exactly integer gx it is -1/2, -1, +1/2 at gx - 1,
// gx, gx + 1, and f32 rounding gives the same half slopes within an ulp of an
// integer. The cells floor(gx) - 1 .. floor(gx) + 2 cover every t >= 0. Columns
// or rows outside the map add nothing, as in the tent. The seeded geometry puts
// most level-0 samples on exact integers, so this rule decides whether the
// sampling offsets' gradient matches the JAX package.
//
// Bound on the H100: memory, like the forward. One encoder layer at 480x640, B=2
// (nh = 8, hd = 32, P = 4), reads V, loc, aw and grad_out (~40 MB) and writes
// d_value, d_loc and d_aw (~27 MB): ~20 us at 3.35 TB/s.
//
// Design (simple, correct first): the forward's thread layout, hd / 4 lanes per
// (query, head) pair, each lane a float4 of channels, a block 32 neighbouring
// queries of one head. Each lane loads its float4 of grad_out once, then per
// point visits the cells of non-zero value or slope among the 4 x 4 from
// floor - 1 (the 2 x 2 bilinear cells, plus a neighbour column or row where a
// coordinate is, or rounds like, an integer), loads V there, takes its partial
// dot with grad_out and accumulates the three scalar gradients; the pair's lanes
// reduce them with width-(hd / 4) shuffles and one lane writes them. d_value
// is scattered into a zeroed float32 buffer with one float4 atomicAdd (sm_90)
// per lane and cell of non-zero weight, a quarter of the atomics of four
// scalar ones. The order of the additions, and so the last bits of d_value,
// vary from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The tent max(0, 1 - |g - i|) at cell i and its slope in g, as JAX differentiates it.
__device__ __forceinline__ void tent(float g, float i, float& value, float& slope) {
  const float u = __fsub_rn(g, i);
  const float t = __fsub_rn(1.f, fabsf(u));
  const float sign = u >= 0.f ? -1.f : 1.f;
  value = fmaxf(t, 0.f);
  slope = t > 0.f ? sign : (t == 0.f ? 0.5f * sign : 0.f);
}

template <typename T, int HD, int NL, int P>
__global__ void __launch_bounds__(kThreads) deform_sample_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    const float* __restrict__ grad_out, float* __restrict__ d_value, float* __restrict__ d_loc,
    float* __restrict__ d_aw, Levels lv, long long pairs, int nh, int nq, int ltot, int normalized) {
  constexpr int kLanes = HD / 4;  // lanes per (query, head) pair
  constexpr int kPairsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  long long slot =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kPairsPerWarp + lane / kLanes;
  // Lanes past the last pair compute on it (the shuffles need the whole warp)
  // and write nothing.
  const bool live = slot < pairs;
  slot = live ? slot : pairs - 1;
  const long long bh = slot / nq;
  const long long l = slot - bh * nq;
  const int h = (int)(bh % nh);
  const long long b = bh / nh;
  const long long pr = (b * nq + l) * nh + h;  // the pair's index in loc, aw and grad_out
  const int c = sub * 4;
  const long long pix = (long long)nh * HD;
  const long long vbase = (b * ltot * nh + h) * HD + c;
  const float4 g = *reinterpret_cast<const float4*>(grad_out + pr * HD + c);

#pragma unroll
  for (int lvl = 0; lvl < NL; ++lvl) {
    const int hh = lv.h[lvl];
    const int ww = lv.w[lvl];
    const T* vl = value + vbase + (long long)lv.start[lvl] * pix;
    float* dvl = d_value + vbase + (long long)lv.start[lvl] * pix;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long pt = (pr * NL + lvl) * P + p;
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + pt);
      const float a = __ldg(aw + pt);
      float x = xy.x, y = xy.y;
      if (normalized) {
        x = __fsub_rn(__fmul_rn(x, (float)ww), 0.5f);
        y = __fsub_rn(__fmul_rn(y, (float)hh), 0.5f);
      }
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      float s_aw = 0.f, s_gx = 0.f, s_gy = 0.f;  // partial sums over this lane's channels
      // Cells floor - 1 .. floor + 2 can matter, so x0 from -2 to w; false for NaN.
      if (x0f >= -2.f && x0f <= (float)ww && y0f >= -2.f && y0f <= (float)hh) {
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        float wx[4], dx[4], wy[4], dy[4];  // tent values and slopes at offsets -1 .. 2
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tent(x, x0f + (float)(j - 1), wx[j], dx[j]);
          tent(y, y0f + (float)(j - 1), wy[j], dy[j]);
        }
#pragma unroll
        for (int jy = 0; jy < 4; ++jy) {
          const int yy = y0 + jy - 1;
          if (yy < 0 || yy >= hh) continue;
#pragma unroll
          for (int jx = 0; jx < 4; ++jx) {
            const int xx = x0 + jx - 1;
            if (xx < 0 || xx >= ww) continue;
            const float cw = wy[jy] * wx[jx];
            const float cgx = wy[jy] * dx[jx];
            const float cgy = dy[jy] * wx[jx];
            if (cw == 0.f && cgx == 0.f && cgy == 0.f) continue;
            const long long off = (long long)(yy * ww + xx) * pix;
            const float4 v = ldg4(vl + off);
            const float dot = g.x * v.x + g.y * v.y + g.z * v.z + g.w * v.w;
            s_aw = fmaf(cw, dot, s_aw);
            s_gx = fmaf(cgx, dot, s_gx);
            s_gy = fmaf(cgy, dot, s_gy);
            const float cv = a * cw;
            if (live && cv != 0.f)
              atomicAdd(reinterpret_cast<float4*>(dvl + off), make_float4(cv * g.x, cv * g.y, cv * g.z, cv * g.w));
          }
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        s_aw += __shfl_xor_sync(0xffffffffu, s_aw, o, kLanes);
        s_gx += __shfl_xor_sync(0xffffffffu, s_gx, o, kLanes);
        s_gy += __shfl_xor_sync(0xffffffffu, s_gy, o, kLanes);
      }
      if (live && sub == 0) {
        d_aw[pt] = s_aw;
        const float sx = normalized ? (float)ww : 1.f;
        const float sy = normalized ? (float)hh : 1.f;
        reinterpret_cast<float2*>(d_loc)[pt] = make_float2(a * s_gx * sx, a * s_gy * sy);
      }
    }
  }
}

template <typename T, int HD, int NL>
int launch_levels(const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value,
                  void* d_loc, void* d_aw, const Levels& lv, long long pairs, int nh, int nq, int ltot,
                  int normalized, cudaStream_t s) {
  constexpr int kPairsPerBlock = kThreads / 32 * (32 / (HD / 4));
  const unsigned grid = (unsigned)((pairs + kPairsPerBlock - 1) / kPairsPerBlock);
  deform_sample_bwd_kernel<T, HD, NL, 4><<<grid, kThreads, 0, s>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (const float*)grad_out, (float*)d_value,
      (float*)d_loc, (float*)d_aw, lv, pairs, nh, nq, ltot, normalized);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_nl(int nl, const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value,
                void* d_loc, void* d_aw, const Levels& lv, long long pairs, int nh, int nq, int ltot,
                int normalized, cudaStream_t s) {
  switch (nl) {  // the per-level entry and the model's three levels
    case 1:
      return launch_levels<T, HD, 1>(value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq, ltot,
                                     normalized, s);
    case 3:
      return launch_levels<T, HD, 3>(value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq, ltot,
                                     normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(int hd, int nl, const void* value, const void* loc, const void* aw, const void* grad_out,
                void* d_value, void* d_loc, void* d_aw, const Levels& lv, long long pairs, int nh, int nq,
                int ltot, int normalized, cudaStream_t s) {
  switch (hd) {
    case 16:
      return dispatch_nl<T, 16>(nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq, ltot,
                                normalized, s);
    case 32:
      return dispatch_nl<T, 32>(nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq, ltot,
                                normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// levels: nl triples (h, w, start) on the host; nl 1 or 3, P 4, hd 16 or 32.
// grad_out, d_value, d_loc and d_aw are float32; d_value must be zeroed by the
// caller. All pointers must be 16-byte aligned.
extern "C" int rgbd_deform_sample_bwd(
    const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value, void* d_loc,
    void* d_aw, const int* levels, int b, int nq, int nh, int nl, int npts, int hd, int ltot, int normalized,
    int v_bf16, void* stream) {
  if (nl < 1 || nl > kMaxLevels || npts != 4) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)loc | (uintptr_t)aw | (uintptr_t)grad_out | (uintptr_t)d_value |
       (uintptr_t)d_loc | (uintptr_t)d_aw) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Levels lv = {};
  for (int i = 0; i < nl; ++i) {
    lv.h[i] = levels[3 * i];
    lv.w[i] = levels[3 * i + 1];
    lv.start[i] = levels[3 * i + 2];
  }
  const long long pairs = (long long)b * nq * nh;
  if (pairs == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (v_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq,
                                      ltot, normalized, s);
  return dispatch_hd<float>(hd, nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, lv, pairs, nh, nq, ltot,
                            normalized, s);
}
