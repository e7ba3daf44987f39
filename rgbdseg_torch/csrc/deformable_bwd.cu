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
// tent_sample_level_xla; the TPU package has no Pallas kernel for it. So the
// kernel differentiates the tent itself, cell by cell, in float32 as that VJP
// does: with u = gx - x and t = 1 - |u|, the value is max(0, t) and the slope
// tx'(x) is -sign(u) where t > 0 (-1 at u = 0, since jax.grad(abs)(0) = 1), half
// of it where t == 0 exactly (JAX's max splits a tie), and 0 where t < 0. Away
// from integers that is the bilinear gradient (-1 at floor(gx), +1 above); at an
// exactly integer gx it is -1/2, -1, +1/2 at gx - 1, gx, gx + 1, and f32 rounding
// gives the same half slopes within an ulp of an integer. The cells
// floor(gx) - 1 .. floor(gx) + 2 cover every t >= 0; at most three of them per
// axis have t >= 0, so a point has at most 3 x 3 cells of non-zero value or
// slope. Columns or rows outside the map add nothing, as in the tent. The seeded
// geometry puts most level-0 samples on exact integers, so this rule decides
// whether the sampling offsets' gradient matches the JAX package.
//
// Bound on the H100: memory, like the forward. One encoder layer at 480x640, B=2
// (nh = 8, hd = 32, P = 4), reads V, loc, aw and grad_out (~40 MB) and writes
// d_value, d_loc and d_aw (~27 MB): ~20 us at 3.35 TB/s. What held the first
// version at 15x that bound was not the d value atomics but the gather's
// latency: each lane walked the 4 x 4 cells of one point after another, and
// each cell's V load waited for the previous cell's tent tests, some 48
// dependent L1/L2 round trips per (query, head) and layer.
//
// Design: the forward's thread layout, hd / 4 lanes per (query, head) pair, each
// lane a float4 of channels, a block 32 neighbouring queries of one head. Per
// level, (a) the pair's lanes split the 4 points x 4 x 4 candidate cells (two
// lanes per point at hd = 32) and compute their tent values and slopes; (b) the
// cells of non-zero value or slope go to a list in shared memory, in a fixed
// order (ballots within the pair give each its slot); (c) all lanes walk the
// list, issuing the V loads of 8 cells before using any, and add the dot with
// grad_out into the partial d weight and d location of the cell's point;
// (d) shuffles reduce those over the pair's lanes, and lane p writes point p's.
// d value is added to a zeroed float32 buffer with one float4 atomicAdd (sm_90)
// per lane and cell of non-zero value. The order of those additions, and so the
// last bits of d_value, vary from run to run. Merging d value in a
// shared-memory window per level first was slower: the window's int32 atomics
// (float ones in shared memory are compare-and-swap loops) and its flush cost
// more than the device-memory atomics they save.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kThreads = 256;
constexpr int kMaxEntries = 36;  // cells of non-zero tent value or slope: at most 3 x 3 per point, 4 points
constexpr int kBatch = 8;        // V loads in flight per lane

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

template <int HD>
__host__ __device__ constexpr int pairs_per_block() { return kThreads / (HD / 4); }

template <typename T, int HD, int NL, int P>
__global__ void __launch_bounds__(kThreads, 2) deform_sample_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    const float* __restrict__ grad_out, float* __restrict__ d_value, float* __restrict__ d_loc,
    float* __restrict__ d_aw, Levels lv, long long pairs, int nh, int nq, int ltot, int normalized) {
  constexpr int kLanes = HD / 4;              // lanes per (query, head) pair
  constexpr int kLanesPerPoint = kLanes / P;  // lanes that list one point's candidate cells
  constexpr int kRows = 4 / kLanesPerPoint;   // candidate rows per lane
  constexpr unsigned kSegMask = (1u << kLanes) - 1u;
  static_assert(P == 4 && kLanes % P == 0, "a point's candidates are split over whole lanes");
  __shared__ int4 lists[pairs_per_block<HD>()][kMaxEntries];

  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int pair = threadIdx.x / kLanes;
  long long slot = (long long)blockIdx.x * pairs_per_block<HD>() + pair;
  // Lanes past the last pair compute on it (the shuffles need the whole warp)
  // and write nothing.
  const bool live = slot < pairs;
  slot = live ? slot : pairs - 1;
  // Slots run over the queries of one (b, head) fastest: a block's pairs are
  // neighbouring queries of one head, which sample overlapping V rows.
  const long long bh = slot / nq;
  const long long l = slot - bh * nq;
  const int h = (int)(bh % nh);
  const long long b = bh / nh;
  const long long pr = (b * nq + l) * nh + h;  // the pair's index in loc, aw and grad_out
  const int c = sub * 4;
  const long long pix = (long long)nh * HD;
  const long long vbase = (b * ltot * nh + h) * HD + c;
  const float4 g = *reinterpret_cast<const float4*>(grad_out + pr * HD + c);
  int4* list = lists[pair];
  const int seg = lane / kLanes * kLanes;  // the pair's first lane in the warp
  const unsigned below = (1u << sub) - 1u;
  const int p_own = sub / kLanesPerPoint;
  const int jy0 = (sub % kLanesPerPoint) * kRows;

#pragma unroll
  for (int lvl = 0; lvl < NL; ++lvl) {
    const int hh = lv.h[lvl];
    const int ww = lv.w[lvl];
    const T* vl = value + vbase + (long long)lv.start[lvl] * pix;
    float* dvl = d_value + vbase + (long long)lv.start[lvl] * pix;
    const long long pt0 = (pr * NL + lvl) * P;  // the pair's first point at this level

    // (a) This lane's candidate cells: rows jy0 .. jy0 + kRows - 1 of the 4 x 4
    // cells from floor - 1 of point p_own, with their tent weights.
    const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + pt0 + p_own);
    const float a_own = __ldg(aw + pt0 + p_own);
    float x = xy.x, y = xy.y;
    if (normalized) {
      x = __fsub_rn(__fmul_rn(x, (float)ww), 0.5f);
      y = __fsub_rn(__fmul_rn(y, (float)hh), 0.5f);
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    // Cells floor - 1 .. floor + 2 can matter, so x0 from -2 to w; false for NaN.
    const bool inside = x0f >= -2.f && x0f <= (float)ww && y0f >= -2.f && y0f <= (float)hh;
    const int x0 = inside ? (int)x0f : 0;
    const int y0 = inside ? (int)y0f : 0;
    float wx[4], dx[4], wy[kRows], dy[kRows];  // tent values and slopes
#pragma unroll
    for (int j = 0; j < 4; ++j) tent(x, x0f + (float)(j - 1), wx[j], dx[j]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) tent(y, y0f + (float)(jy0 + r - 1), wy[r], dy[r]);

    // (b) The pair's cells of non-zero tent value or slope, listed in the order
    // (candidate, lane): (row << 16 | column << 2 | point, value, x slope, y slope).
    int n = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int jx = 0; jx < 4; ++jx) {
        const int yy = y0 + jy0 + r - 1;
        const int xx = x0 + jx - 1;
        const float cw = wy[r] * wx[jx];
        const float cgx = wy[r] * dx[jx];
        const float cgy = dy[r] * wx[jx];
        const bool on = inside && yy >= 0 && yy < hh && xx >= 0 && xx < ww && (cw != 0.f || cgx != 0.f || cgy != 0.f);
        const unsigned m = (__ballot_sync(0xffffffffu, on) >> seg) & kSegMask;
        if (on)
          list[n + __popc(m & below)] = make_int4((yy << 16) | (xx << 2) | p_own, __float_as_int(cw),
                                                  __float_as_int(cgx), __float_as_int(cgy));
        n += __popc(m);
      }
    __syncwarp();
    float a[P];  // the pair's point weights
#pragma unroll
    for (int q = 0; q < P; ++q) a[q] = __shfl_sync(0xffffffffu, a_own, q * kLanesPerPoint, kLanes);

    // (c) Every listed cell: V loads kBatch at a time, then the dot with
    // grad_out, the partial d weight and d location of its point, and d value.
    float s_aw[P], s_gx[P], s_gy[P];  // partial sums over this lane's channels
#pragma unroll
    for (int q = 0; q < P; ++q) s_aw[q] = s_gx[q] = s_gy[q] = 0.f;
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    for (int e0 = 0; e0 < nmax; e0 += kBatch) {
      int4 ent[kBatch];
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = e0 + k < n;
        ent[k] = ok ? list[e0 + k] : make_int4(0, 0, 0, 0);  // weights 0
        const long long off = (long long)((ent[k].x >> 16) * ww + ((ent[k].x >> 2) & 0x3fff)) * pix;
        v[k] = ok ? ldg4(vl + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int p = ent[k].x & 3;
        const float cw = __int_as_float(ent[k].y);
        const float dot = g.x * v[k].x + g.y * v[k].y + g.z * v[k].z + g.w * v[k].w;
        float ap = 0.f;
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (p == q) {
            s_aw[q] = fmaf(cw, dot, s_aw[q]);
            s_gx[q] = fmaf(__int_as_float(ent[k].z), dot, s_gx[q]);
            s_gy[q] = fmaf(__int_as_float(ent[k].w), dot, s_gy[q]);
            ap = a[q];
          }
        const float cv = ap * cw;
        if (live && cv != 0.f) {
          const long long off = (long long)((ent[k].x >> 16) * ww + ((ent[k].x >> 2) & 0x3fff)) * pix;
          atomicAdd(reinterpret_cast<float4*>(dvl + off), make_float4(cv * g.x, cv * g.y, cv * g.z, cv * g.w));
        }
      }
    }

    // (d) Reduce over the pair's lanes; lane p writes point p's d weight and d location.
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        s_aw[q] += __shfl_xor_sync(0xffffffffu, s_aw[q], o, kLanes);
        s_gx[q] += __shfl_xor_sync(0xffffffffu, s_gx[q], o, kLanes);
        s_gy[q] += __shfl_xor_sync(0xffffffffu, s_gy[q], o, kLanes);
      }
    const float sx = normalized ? (float)ww : 1.f;
    const float sy = normalized ? (float)hh : 1.f;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (live && sub == q) {
        d_aw[pt0 + q] = s_aw[q];
        reinterpret_cast<float2*>(d_loc)[pt0 + q] = make_float2(a[q] * s_gx[q] * sx, a[q] * s_gy[q] * sy);
      }
    __syncwarp();  // the list is read before the next level rewrites it
  }
}

template <typename T, int HD, int NL>
int launch_levels(const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value,
                  void* d_loc, void* d_aw, const Levels& lv, long long pairs, int nh, int nq, int ltot,
                  int normalized, cudaStream_t s) {
  const unsigned grid = (unsigned)((pairs + pairs_per_block<HD>() - 1) / pairs_per_block<HD>());
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
    if (lv.h[i] >= (1 << 15) || lv.w[i] >= (1 << 14)) return (int)cudaErrorInvalidValue;  // the list's packing
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
