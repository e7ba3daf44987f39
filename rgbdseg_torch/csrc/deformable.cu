// Multi-scale deformable-attention sampling over all levels (kernel K1).
//
//   out[b, l, h, :] = sum_lvl sum_p aw[b, l, h, lvl, p]
//                       * bilinear_zeros(V_lvl[b, :, :, h, :], loc[b, l, h, lvl, p])
//
// value (B, L_total, nh, hd) as value_proj emits it, level lvl occupying rows
// [start_lvl, start_lvl + h_lvl * w_lvl) in (y, x) raster order; loc (B, L, nh,
// nl, P, 2) float32 (x, y); aw (B, L, nh, nl, P) float32; out (B, L, nh * hd)
// float32, the input of output_proj. With `normalized`, loc is in [0, 1] and the
// kernel converts it to pixels as x * w - 0.5 (rounded as two separate float32
// operations, as the plain version computes it); otherwise loc is already in
// pixels (the per-level entry, which passes the JAX per-level gx, gy).
//
// Replaces the TPU kernels rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level
// (_tent_kernel) and ::tent_sample_level_band (_tent_band_kernel), and the level
// loop around them (rgbdseg_tpu/models/pixel_decoder.py, DeformableAttention).
// Those build the dense "tent" matrix P[l, y*w+x] and contract it with V on the
// MXU, because the TPU gathers slowly. On Hopper a gather is cheap, so this kernel
// reads the <= 4 in-bounds bilinear corners of each point directly. Bilinear
// weights with zeros padding are exactly the tent relu(1 - |g - x|) at the two
// cells around g, including coordinates that are exact integers (the far corner
// gets weight 0). A corner whose weight is exactly 0 adds exactly 0, so it is not
// loaded.
//
// Bound on the H100: memory. One encoder layer at 480x640 (levels 15x20, 30x40,
// 60x80; nh = 8, hd = 32, P = 4) must read V (6.45 MB), loc (4.84 MB) and aw
// (2.42 MB) and write out (6.45 MB): ~20 MB, ~6 us at 3.35 TB/s. The per-layer
// FMAs (< 0.1 GFLOP) are far below that.
//
// Design: one launch per encoder layer for all levels, on the layouts the layer
// produces (no per-level permutes or copies around it). Lanes own 16 bytes of
// channels each: hd / 4 lanes per (query, head) pair with a float4 each (8
// lanes, 4 pairs per warp at hd = 32) for f32 V, hd / 8 with 8 bf16 each (4
// lanes, 8 pairs per warp) for bf16 V (hd 16: 4 bf16, 8 bytes), so every
// corner read is one coalesced row of V (128 bytes f32, 64 bf16). A block
// takes 32 neighbouring queries of one head, which sample overlapping V rows
// (queries arrive in raster order and sample a few pixels from their reference
// point), so repeated rows come from L1 and L2. The per-point arithmetic is not
// repeated on every lane of a pair: per level, each lane computes 4 * P / (hd / 4)
// of the pair's corners (pixel index and weight, from its point's coordinates
// and weight), the pair's lanes exchange them with shuffles within the pair, and
// each lane then issues all 4 * P corner loads of the level before any FMA. nl
// and P are template constants. Accumulation is f32; V may be float32 or
// bfloat16. At the in-model geometry it still moves about 10x the bytes of its
// bound through L1 (each corner row is requested once per query that needs it).
//
// bf16 V: widening each corner as it is loaded (a bf16 pair read through a
// register's address) leads ptxas to 169 registers at hd 32 and 3 levels, one
// block of 256 threads per SM against the f32 kernel's 44 registers and five
// blocks, and the latency-bound gather then takes 3.6x the f32 time. Raw
// words widened at the FMAs, loaded 16 bytes at a time, take 58 registers
// (four blocks per SM) and half the f32 route's lanes per pair, and run below
// the f32 time with the f32 route's bits on V.float().
//
// Points whose footprint lies wholly outside the map contribute zero and are
// skipped before any float->int conversion (this also skips NaN coordinates).

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

// A lane's channels of one V row as the raw words one 16-byte (or, for bf16 at
// hd 16, 8-byte) load returns: a float4, or a uint4 (uint2) of 8 (4) bf16.
// The words stay in registers until every load of the level is issued, and
// are widened at the FMAs: bf16 -> float32 is exact as a shift or a mask of
// the word, so bf16 V gives the bits of V.float().
template <typename T, int V>
struct RawT;
template <>
struct RawT<float, 4> { using type = float4; };
template <>
struct RawT<__nv_bfloat16, 4> { using type = uint2; };
template <>
struct RawT<__nv_bfloat16, 8> { using type = uint4; };

template <typename T, int HD>
constexpr int kVec = (sizeof(T) == 2 && HD >= 32) ? 8 : 4;  // channels per lane

template <typename T, int V>
__device__ __forceinline__ typename RawT<T, V>::type ldg_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename RawT<T, V>::type*>(p));
}
__device__ __forceinline__ void widen(float4 x, float* o) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void widen(uint32_t u, float* o) {
  o[0] = __uint_as_float(u << 16);
  o[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 u, float* o) {
  widen(u.x, o);
  widen(u.y, o + 2);
}
__device__ __forceinline__ void widen(uint4 u, float* o) {
  widen(u.x, o);
  widen(u.y, o + 2);
  widen(u.z, o + 4);
  widen(u.w, o + 6);
}

template <typename T, int HD, int NL, int P>
__global__ void __launch_bounds__(kThreads) deform_sample_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    float* __restrict__ out, Levels lv, long long pairs, int nh, int nq, int ltot, int normalized) {
  constexpr int kV = kVec<T, HD>;
  using Raw = typename RawT<T, kV>::type;
  constexpr int kLanes = HD / kV;          // lanes per (query, head) pair
  constexpr int kPairsPerWarp = 32 / kLanes;
  constexpr int kCorners = 4 * P;          // bilinear corners per level
  constexpr int kOwn = kCorners / kLanes;  // corners each lane computes
  static_assert(kCorners % kLanes == 0 && kOwn <= 4, "a lane's corners must lie in one point");
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  long long slot =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kPairsPerWarp + lane / kLanes;
  // Lanes past the last pair keep computing on it (the shuffles need the whole
  // warp) and store nothing.
  const bool live = slot < pairs;
  slot = live ? slot : pairs - 1;
  // Slots run over the queries of one (b, head) fastest: a block's pairs are
  // neighbouring queries of one head, which sample overlapping V rows.
  const long long bh = slot / nq;
  const long long l = slot - bh * nq;
  const int h = (int)(bh % nh);
  const long long b = bh / nh;
  const long long pr = (b * nq + l) * nh + h;  // the pair's index in loc, aw and out
  const int c = sub * kV;  // this lane's channels
  const long long pix = (long long)nh * HD;  // stride of one pixel in value
  const T* vb = value + (b * ltot * nh + h) * HD + c;
  const int p = sub * kOwn / 4;  // the point whose corners this lane computes

  float acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) acc[i] = 0.f;
#pragma unroll
  for (int lvl = 0; lvl < NL; ++lvl) {
    const int hh = lv.h[lvl];
    const int ww = lv.w[lvl];
    // This lane's corners: weight and pixel index, 0 where the corner is out of
    // bounds or has weight exactly 0.
    const float2 g = __ldg(reinterpret_cast<const float2*>(loc) + (pr * NL + lvl) * P + p);
    const float a = __ldg(aw + (pr * NL + lvl) * P + p);
    float x = g.x, y = g.y;
    if (normalized) {
      x = __fsub_rn(__fmul_rn(x, (float)ww), 0.5f);
      y = __fsub_rn(__fmul_rn(y, (float)hh), 0.5f);
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const bool any = x0f >= -1.f && x0f <= (float)(ww - 1) && y0f >= -1.f && y0f <= (float)(hh - 1);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = any ? (int)x0f : 0;
    const int y0 = any ? (int)y0f : 0;
    float own_w[kOwn];
    int own_i[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int corner = (sub * kOwn + j) & 3;
      const int dy = corner >> 1;
      const int dx = corner & 1;
      const int yy = y0 + dy;
      const int xx = x0 + dx;
      const float wgt = a * (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
      const bool ok = any && yy >= 0 && yy < hh && xx >= 0 && xx < ww && wgt != 0.f;
      own_w[j] = ok ? wgt : 0.f;
      own_i[j] = ok ? yy * ww + xx : 0;
    }
    // Every corner of the pair, from its owner lane; all loads before the FMAs.
    const T* vl = vb + (long long)lv.start[lvl] * pix;
    float wt[kCorners];
    Raw raw[kCorners];
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      wt[k] = __shfl_sync(0xffffffffu, own_w[k % kOwn], k / kOwn, kLanes);
      const int idx = __shfl_sync(0xffffffffu, own_i[k % kOwn], k / kOwn, kLanes);
      raw[k] = wt[k] != 0.f ? ldg_raw<T, kV>(vl + idx * pix) : Raw{};
    }
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      float val[kV];
      widen(raw[k], val);
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[k], val[i], acc[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kV; i += 4)
      *reinterpret_cast<float4*>(out + pr * HD + c + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

template <typename T, int HD, int NL>
int launch_levels(const void* value, const void* loc, const void* aw, void* out, const Levels& lv,
                  long long pairs, int nh, int nq, int ltot, int normalized, cudaStream_t s) {
  constexpr int kPairsPerBlock = kThreads / 32 * (32 / (HD / kVec<T, HD>));
  const unsigned grid = (unsigned)((pairs + kPairsPerBlock - 1) / kPairsPerBlock);
  deform_sample_kernel<T, HD, NL, 4><<<grid, kThreads, 0, s>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (float*)out, lv, pairs, nh, nq, ltot, normalized);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_nl(int nl, const void* value, const void* loc, const void* aw, void* out, const Levels& lv,
                long long pairs, int nh, int nq, int ltot, int normalized, cudaStream_t s) {
  switch (nl) {  // the per-level entry and the model's three levels
    case 1: return launch_levels<T, HD, 1>(value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
    case 3: return launch_levels<T, HD, 3>(value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(int hd, int nl, const void* value, const void* loc, const void* aw, void* out,
                const Levels& lv, long long pairs, int nh, int nq, int ltot, int normalized, cudaStream_t s) {
  switch (hd) {
    case 16: return dispatch_nl<T, 16>(nl, value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
    case 32: return dispatch_nl<T, 32>(nl, value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// levels: nl triples (h, w, start) on the host; nl 1 or 3, P 4, hd 16 or 32.
// All pointers must be 16-byte aligned.
extern "C" int rgbd_deform_sample(
    const void* value, const void* loc, const void* aw, void* out, const int* levels,
    int b, int nq, int nh, int nl, int npts, int hd, int ltot, int normalized, int v_bf16, void* stream) {
  if (nl < 1 || nl > kMaxLevels || npts != 4) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)loc | (uintptr_t)aw | (uintptr_t)out) % 16 != 0)
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
  if (v_bf16) return dispatch_hd<__nv_bfloat16>(hd, nl, value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
  return dispatch_hd<float>(hd, nl, value, loc, aw, out, lv, pairs, nh, nq, ltot, normalized, s);
}
