// Backward of the multi-scale deformable-attention sampling (kernel K1).
//
// Forward (csrc/deformable.cu):
//   out[b, l, h, :] = sum_lvl sum_p aw[b, l, h, lvl, p]
//                       * sum_{y, x} ty(y) tx(x) V_lvl[b, y, x, h, :]
// with the tents tx(x) = max(0, 1 - |gx - x|), ty(y) = max(0, 1 - |gy - y|) over
// the level's cells, gx = loc_x * w - 0.5 and gy = loc_y * h - 0.5 (or loc in
// pixels, the per-level entry). Given grad_out (B, L, nh * hd) this file writes
//   d_value (B, L_total, nh, hd)  = sum over points of aw * ty(y) tx(x) * grad_out
//   d_aw    (B, L, nh, nl, P)     = <bilinear sample, grad_out>
//   d_loc   (B, L, nh, nl, P, 2)  = aw * (sum_{y,x} ty(y) tx'(x) <V[y, x], grad_out> * w,
//                                        sum_{y,x} ty'(y) tx(x) <V[y, x], grad_out> * h)
//
// Replaces the backward of rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level
// (and ::tent_sample_level_band), which is the VJP of the jnp tent twin
// tent_sample_level_xla; the TPU package has no Pallas kernel for it. So the
// kernels differentiate the tent itself, cell by cell, in float32 as that VJP
// does: with u = gx - x and t = 1 - |u|, the value is max(0, t) and the slope
// tx'(x) is -sign(u) where t > 0 (-1 at u = 0, since jax.grad(abs)(0) = 1), half
// of it where t == 0 exactly (JAX's max splits a tie), and 0 where t < 0. Away
// from integers that is the bilinear gradient (-1 at floor(gx), +1 above); at an
// exactly integer gx it is -1/2, -1, +1/2 at gx - 1, gx, gx + 1, and f32 rounding
// gives the same half slopes within an ulp of an integer. The cells
// floor(gx) - 1 .. floor(gx) + 2 cover every t >= 0; at most three of them per
// axis have t >= 0, so a point has at most 3 x 3 cells of non-zero value or
// slope. A non-zero value only at floor(gx) and floor(gx) + 1: |u| >= 1 exactly
// at the other two, and f32 rounding keeps it there. Columns or rows outside the
// map add nothing, as in the tent. The seeded geometry puts most level-0 samples
// on exact integers, so this rule decides whether the sampling offsets' gradient
// matches the JAX package.
//
// Bound on the H100: memory, like the forward. One encoder layer at 480x640, B=2
// (nh = 8, hd = 32, P = 4), reads V, loc, aw and grad_out (~40 MB) and writes
// d_value, d_loc and d_aw (~27 MB): ~20 us at 3.35 TB/s.
//
// Design: three kernels and a memset in one call, no float atomics, and d
// value written once, in V's dtype, with the same bits on every run.
//  (a) The pair kernel: d loc and d weights. The forward's thread layout, hd / 4
//      lanes per (query, head) pair, each lane a float4 of channels, a block 32
//      neighbouring queries of one head. Per level, the pair's lanes split the 4
//      points x 4 x 4 candidate cells (two lanes per point at hd = 32) and
//      compute their tent values and slopes; the cells of non-zero value or
//      slope go to a list in shared memory in a fixed order (ballots within the
//      pair give each its slot); all lanes walk the list, issuing the V loads of
//      8 cells before using any, and add the dot with grad_out into the partial
//      d weight and d location of the cell's point; shuffles reduce those over
//      the pair's lanes, and lane p writes point p's. It also writes, per (b,
//      head, level, query), a record of the 4 points' pixel coordinates (32
//      contiguous bytes) and weights (16 bytes in a second array), where loc
//      and aw keep a query's bytes 768 apart.
//  (b) The bucketing: each level's map is cut into tiles of th x tw cells (the
//      wrapper's plan; powers of two), and each tile has a bitmap over its (b,
//      head)'s queries: bit q is set where one of query q's points has a value
//      corner (one of its <= 2 x 2 cells of non-zero tent value on the map) in
//      the tile. One warp per bitmap word, 32 consecutive queries: a point's
//      value corners lie in at most 2 x 2 neighbouring tiles, whose row and
//      column parities all differ, so per parity slot the warp takes the tiles
//      its lanes list one at a time, and a ballot is that tile's word, stored
//      by one lane. No atomics; the memset before clears the rest.
//  (c) The gather: d value in destination order. A block of 8 warps takes 8 / k
//      neighbouring tiles of one level, k warps per tile (the wrapper's plan:
//      the coarse levels' tiles list many more queries, and get more warps).
//      The warps of a tile list its marked queries in shared memory in
//      ascending order (a block scan over the bitmap's words) and split the
//      list in k equal parts. A warp takes its part 32 queries at a time: their
//      grad_out rows G (32 x hd; B=2's 12.9 MB stay in the 50 MB L2) are
//      copied to shared memory by cp.async while lane j sums query j's corner
//      weights aw * ty * tx (the pair kernel's tents, from the records) into
//      column j of W (the tile's cells x 32 queries); then the warp adds W G to
//      its copy of the tile in registers, on the tensor cores: mma.sync
//      m16n8k8 on 3xTF32 splits, float32-accurate (a half of W that is zero
//      over 8 queries is skipped). The tile's k copies are summed in warp order
//      and every cell is written once: float32, or bfloat16 rounded once from
//      the float32 sum, as the plain backward rounds. Every sum has an order
//      fixed by the bitmaps and the products' shapes, so d value has the same
//      bits on every run.
// (b) and (c) take the (b, head)s in the reverse of (a)'s order, so that the
// records and grad_out rows they read first are the ones (a) left in L2 last.
// The float atomics this replaces took 0.069 of PR 13's 0.2031 ms at the
// in-model geometry, B=2, on the H100; a gather that added each point's
// corners into shared memory one by one was a chain of dependent
// shared-memory accesses and took 0.16 ms. One grad_out row per (query, tile),
// not per (point, tile), and products of 32 queries at a time, keep it short.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tf32.cuh"


namespace {

using namespace rgbd;

constexpr int kMaxLevels = 3;
constexpr int kThreads = 256;
constexpr int kMaxEntries = 36;  // cells of non-zero tent value or slope: at most 3 x 3 per point, 4 points
constexpr int kBatch = 8;        // V loads in flight per lane
constexpr int kPoints = 4;       // P
constexpr int kWarps = kThreads / 32;
constexpr int kListCap = 2048;   // queries a gather block lists in shared memory at a time
constexpr int kCells = 32;       // cells per tile at most: the gather's products are 32 cells tall
constexpr int kRec = 3 * 4;      // floats per (b, head, level, query) record: 4 points' (x, y), then their weights
constexpr int kScanRounds = 8;   // bitmap words per thread that a gather block's list scan loads at once

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  int th[kMaxLevels];               // tile rows and columns
  int tw[kMaxLevels];
  int wpt[kMaxLevels];              // gather warps per tile: 1, 2, 4 or 8
  int tile0[kMaxLevels + 1];        // the level's first tile over all levels
  int blk0[kMaxLevels + 1];         // the level's first gather block
};

// One level's fields. The kernels whose level is known only at run time read
// the table through level(), which selects among the parameter's entries: an
// array index into a kernel parameter would make every thread copy the table
// to local memory first.
struct Level {
  int h, w, start, th, tw, wpt, tile0, blk0;
  // Tile rows and columns are powers of two: the tile of a cell is a shift.
  __device__ __forceinline__ int tile_y(int y) const { return y >> (__ffs(th) - 1); }
  __device__ __forceinline__ int tile_x(int x) const { return x >> (__ffs(tw) - 1); }
  __device__ __forceinline__ int tiles_x() const { return tile_x(w + tw - 1); }
  __device__ __forceinline__ int tiles_y() const { return tile_y(h + th - 1); }
};

__device__ __forceinline__ Level level(const Levels& lv, int lvl) {
  Level l = {lv.h[0], lv.w[0], lv.start[0], lv.th[0], lv.tw[0], lv.wpt[0], lv.tile0[0], lv.blk0[0]};
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (lvl == i) l = {lv.h[i], lv.w[i], lv.start[i], lv.th[i], lv.tw[i], lv.wpt[i], lv.tile0[i], lv.blk0[i]};
  return l;
}

// A lane's 4 channels of one V row as one load returns them: a float4, or a
// uint2 of 4 bf16. The words stay in registers until the FMAs, where bf16 is
// widened exactly (a shift or a mask of the word), so bf16 V gives the f32
// route's bits on V.float(); widened at the load, the bf16 route ran 43%
// slower than the f32 one on the H100 once the d value atomics were gone.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 ld_raw(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ uint2 ld_raw(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}


// The tent max(0, 1 - |g - i|) at cell i and its slope in g, as JAX differentiates it.
__device__ __forceinline__ void tent(float g, float i, float& value, float& slope) {
  const float u = __fsub_rn(g, i);
  const float t = __fsub_rn(1.f, fabsf(u));
  const float sign = u >= 0.f ? -1.f : 1.f;
  value = fmaxf(t, 0.f);
  slope = t > 0.f ? sign : (t == 0.f ? 0.5f * sign : 0.f);
}

// A point's pixel coordinates, as the pair kernel computes them.
__device__ __forceinline__ float2 pixel_xy(float2 xy, int hh, int ww, int normalized) {
  if (normalized) {
    xy.x = __fsub_rn(__fmul_rn(xy.x, (float)ww), 0.5f);
    xy.y = __fsub_rn(__fmul_rn(xy.y, (float)hh), 0.5f);
  }
  return xy;
}

// A point's value corners: cells (y0 + dy, x0 + dx), dy, dx in {0, 1}, with the
// tent values wy[dy], wx[dx]; `inside` false where no corner can be on the map
// (NaN included), as in the pair kernel.
struct Corners {
  int x0, y0;
  float wx[2], wy[2];
  bool inside;
};

__device__ __forceinline__ Corners value_corners(float2 g, int hh, int ww) {
  Corners c;
  const float x0f = floorf(g.x);
  const float y0f = floorf(g.y);
  c.inside = x0f >= -2.f && x0f <= (float)ww && y0f >= -2.f && y0f <= (float)hh;
  c.x0 = c.inside ? (int)x0f : 0;
  c.y0 = c.inside ? (int)y0f : 0;
  float slope;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    tent(g.x, x0f + (float)j, c.wx[j], slope);
    tent(g.y, y0f + (float)j, c.wy[j], slope);
  }
  return c;
}

// Corner k (dy = k >> 1, dx = k & 1) is listed: on the map with a non-zero tent value.
__device__ __forceinline__ bool corner_on(const Corners& c, int k, int hh, int ww) {
  const int yy = c.y0 + (k >> 1);
  const int xx = c.x0 + (k & 1);
  return c.inside && yy >= 0 && yy < hh && xx >= 0 && xx < ww && c.wy[k >> 1] * c.wx[k & 1] != 0.f;
}

// A point's tiles by parity class. A point's value corners lie in at most 2 x 2
// neighbouring tiles, whose (row, column) parities all differ, so slot
// (ty & 1) * 2 + (tx & 1) holds the tile it lists there (-1 for none): a tile
// takes the same slot for every point that lists it.
__device__ __forceinline__ void point_tiles(float2 g, const Level& L, int (&t)[4]) {
  const Corners c = value_corners(g, L.h, L.w);
  const int ntx = L.tiles_x();
#pragma unroll
  for (int s = 0; s < 4; ++s) t[s] = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ty = L.tile_y(c.y0 + (k >> 1));
    const int tx = L.tile_x(c.x0 + (k & 1));
    const bool on = corner_on(c, k, L.h, L.w);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (on && ((ty & 1) * 2 + (tx & 1)) == s) t[s] = ty * ntx + tx;
  }
}

template <typename T, int HD, int NL, int P>
__global__ void __launch_bounds__(kThreads, HD == 32 ? 3 : 2) deform_sample_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    const float* __restrict__ grad_out, float* __restrict__ d_loc, float* __restrict__ d_aw,
    float* __restrict__ rec, Levels lv, long long pairs, int nh, int nq, int ltot, int normalized) {
  constexpr int kLanes = HD / 4;              // lanes per (query, head) pair
  constexpr int kPairs = kThreads / kLanes;   // pairs per block
  constexpr int kLanesPerPoint = kLanes / P;  // lanes that list one point's candidate cells
  constexpr int kRows = 4 / kLanesPerPoint;   // candidate rows per lane
  constexpr unsigned kSegMask = (1u << kLanes) - 1u;
  static_assert(P == 4 && kLanes % P == 0, "a point's candidates are split over whole lanes");
  __shared__ int4 lists[kPairs][kMaxEntries];

  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int pair = threadIdx.x / kLanes;
  long long slot = (long long)blockIdx.x * kPairs + pair;
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
    const long long pt0 = (pr * NL + lvl) * P;  // the pair's first point at this level

    // This lane's candidate cells: rows jy0 .. jy0 + kRows - 1 of the 4 x 4
    // cells from floor - 1 of point p_own, with their tent weights.
    const float2 xy = pixel_xy(__ldg(reinterpret_cast<const float2*>(loc) + pt0 + p_own), hh, ww, normalized);
    const float a_own = __ldg(aw + pt0 + p_own);
    const float x = xy.x, y = xy.y;
    if (live && sub % kLanesPerPoint == 0) {  // the point's record for the bucketing and the gather
      const long long r = (bh * NL + lvl) * nq + l;
      reinterpret_cast<float2*>(rec)[r * kPoints + p_own] = xy;
      rec[r * kPoints + p_own + (long long)pairs * NL * kPoints * 2] = a_own;
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

    // The pair's cells of non-zero tent value or slope, listed in the order
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

    // Every listed cell: V loads kBatch at a time, then the dot with grad_out
    // and the partial d weight and d location of its point.
    float s_aw[P], s_gx[P], s_gy[P];  // partial sums over this lane's channels
#pragma unroll
    for (int q = 0; q < P; ++q) s_aw[q] = s_gx[q] = s_gy[q] = 0.f;
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    for (int e0 = 0; e0 < nmax; e0 += kBatch) {
      int4 ent[kBatch];
      typename Raw<T>::type raw[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = e0 + k < n;
        ent[k] = ok ? list[e0 + k] : make_int4(0, 0, 0, 0);  // weights 0
        const long long off = (long long)((ent[k].x >> 16) * ww + ((ent[k].x >> 2) & 0x3fff)) * pix;
        raw[k] = ok ? ld_raw(vl + off) : typename Raw<T>::type{};
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int p = ent[k].x & 3;
        const float cw = __int_as_float(ent[k].y);
        const float4 v = widen(raw[k]);
        const float dot = g.x * v.x + g.y * v.y + g.z * v.z + g.w * v.w;
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (p == q) {
            s_aw[q] = fmaf(cw, dot, s_aw[q]);
            s_gx[q] = fmaf(__int_as_float(ent[k].z), dot, s_gx[q]);
            s_gy[q] = fmaf(__int_as_float(ent[k].w), dot, s_gy[q]);
          }
      }
    }

    // Reduce over the pair's lanes; lane p writes point p's d weight and d location.
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


// The (b, head, level, query) records: its 4 points' pixel coordinates (32
// bytes in one array) and weights (16 bytes in a second one, `n` records on).
__device__ __forceinline__ void load_xy(const float* rec, long long r, float2 (&xy)[kPoints]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(rec) + 2 * r);
  const float4 v = __ldg(reinterpret_cast<const float4*>(rec) + 2 * r + 1);
  xy[0] = make_float2(u.x, u.y);
  xy[1] = make_float2(u.z, u.w);
  xy[2] = make_float2(v.x, v.y);
  xy[3] = make_float2(v.z, v.w);
}
__device__ __forceinline__ void load_aw(const float* rec, long long r, long long n, float (&a)[kPoints]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(rec + n * kPoints * 2) + r);
  a[0] = u.x;
  a[1] = u.y;
  a[2] = u.z;
  a[3] = u.w;
}

// (b) The bucketing: one warp per bitmap word, 32 consecutive queries of one
// (b, head, level); lane j lists query j's points' tiles by parity slot. Per
// slot, while a lane has a tile left, the warp takes the first lane's, a
// ballot over the lanes that list it is that tile's word, and lane 0 stores
// it. Every word is written by one warp at most (the memset before clears the
// rest): no atomics, the same bits on every run. Grid (word groups, levels,
// b * nh).
__global__ void __launch_bounds__(kThreads) mark_kernel(const float* __restrict__ rec, Levels lv, int nl, int nq,
                                                        int words, unsigned* __restrict__ bitmap) {
  const int word = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (word >= words) return;
  const int lvl = blockIdx.y;
  const Level L = level(lv, lvl);
  const long long bh = gridDim.z - 1 - blockIdx.z;  // the last-written records first: they are in L2
  const int lane = threadIdx.x & 31;
  const int q = word * 32 + lane;
  int t[kPoints][4];
#pragma unroll
  for (int p = 0; p < kPoints; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s) t[p][s] = -1;
  if (q < nq) {
    float2 xy[kPoints];
    load_xy(rec, (bh * nl + lvl) * nq + q, xy);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) point_tiles(xy[p], L, t[p]);
  }
  unsigned* bm = bitmap + (bh * lv.tile0[kMaxLevels] + L.tile0) * words + word;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int c0 = t[0][s], c1 = t[1][s], c2 = t[2][s], c3 = t[3][s];
    for (;;) {
      const int first = c0 >= 0 ? c0 : c1 >= 0 ? c1 : c2 >= 0 ? c2 : c3;
      const unsigned any = __ballot_sync(0xffffffffu, first >= 0);
      if (any == 0u) break;
      const int tile = __shfl_sync(0xffffffffu, first, __ffs(any) - 1);
      const unsigned bits = __ballot_sync(0xffffffffu, c0 == tile || c1 == tile || c2 == tile || c3 == tile);
      c0 = c0 == tile ? -1 : c0;
      c1 = c1 == tile ? -1 : c1;
      c2 = c2 == tile ? -1 : c2;
      c3 = c3 == tile ? -1 : c3;
      if (lane == 0) bm[(long long)tile * words] = bits;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) { *reinterpret_cast<float2*>(p) = make_float2(x, y); }
__device__ __forceinline__ void store4(float* p, float4 s) { *reinterpret_cast<float4*>(p) = s; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 s) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// The gather's shared memory per warp: 32 staged grad_out rows (hd + 8 floats
// apart, so that a B fragment's loads hit 32 banks) and the weights (kCells x
// 32 queries, 36 floats apart); the warp's copy of its tile (cells x hd) takes
// the rows' place at the end. Per block: the tiles' lists and the scan's sums.
template <int HD>
struct GatherSmem {
  static constexpr int kGS = HD + 8;
  static constexpr int kWS = 36;
  static constexpr int kWarpFloats = 32 * kGS + kCells * kWS;
  static constexpr size_t bytes() { return (size_t)kWarps * kWarpFloats * 4 + (size_t)(kListCap + kScanRounds * kWarps) * 4; }
};

// (c) The gather: one block per 8 / k tiles of one level, k = the level's warps
// per tile (blockIdx.x over all levels' blocks, blockIdx.y = b * nh + h). Per
// 32 listed queries a warp stages their grad_out rows G (32 x hd) by cp.async,
// lane j sums query j's corner weights aw * ty * tx into column j of W (cells
// x 32), and the warp adds W G to its tile in registers: mma.sync m16n8k8 on
// 3xTF32 splits, float32-accurate, in a fixed order.
template <typename T, int HD, int NL>
__global__ void __launch_bounds__(kThreads, 2) gather_dv_kernel(
    const float* __restrict__ rec, const float* __restrict__ grad_out, T* __restrict__ d_value,
    const unsigned* __restrict__ bitmap, Levels lv, int nq, int nh, int ltot, int words) {
  using S = GatherSmem<HD>;
  constexpr int kChunks = HD / 4;  // 16-byte chunks per grad_out row
  constexpr int kN = HD / 8;       // n8 tiles over hd
  extern __shared__ __align__(16) float smem[];
  int lvl = 0;
#pragma unroll
  for (int j = 1; j < NL; ++j) lvl += (int)blockIdx.x >= lv.blk0[j];
  const Level L = level(lv, lvl);
  const int wpt = L.wpt;
  const int tpb = kWarps / wpt;  // tiles per block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment coordinates
  const int slot = warp / wpt;   // this warp's tile among the block's
  const int part = warp % wpt;   // and its part of that tile's list
  const int ntx = L.tiles_x();
  const int ntiles = ntx * L.tiles_y();
  const int tile = ((int)blockIdx.x - L.blk0) * tpb + slot;
  const bool has_tile = tile < ntiles;
  const int ty0 = tile / ntx * L.th, tx0 = tile % ntx * L.tw;
  const int cells = L.th * L.tw;
  const long long bh = gridDim.y - 1 - blockIdx.y;  // as the bucketing: the last-written records first
  const int h = (int)(bh % nh);
  const long long b = bh / nh;

  float* G = smem + (size_t)warp * S::kWarpFloats;
  float* W = G + 32 * S::kGS;
  int* lists = reinterpret_cast<int*>(smem + (size_t)kWarps * S::kWarpFloats);
  int* warp_sums = lists + kListCap;
  const int cap = kListCap / tpb;
  int* list = lists + slot * cap;
  const unsigned* bm = bitmap + (bh * lv.tile0[NL] + L.tile0 + (has_tile ? tile : 0)) * words;
  const float* grow = grad_out + (b * nq * nh + h) * HD;  // query 0's row
  const long long rec0 = (bh * NL + lvl) * nq;  // the records of query 0
  const long long nrec = (long long)gridDim.y * NL * nq;
  const int gt = part * 32 + lane;  // the thread's place among its tile's
  const int rounds = (words + wpt * 32 - 1) / (wpt * 32);
  float acc[2][kN][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int c0 = 0;; c0 += cap) {
    // The tile's list: queries of rank c0 .. c0 + cap - 1 in ascending order.
    // The tile's threads take its bitmap's words in turn, kScanRounds each at
    // a time: every word's count, its place by a scan, then its queries.
    int total = 0;
    for (int r0 = 0; r0 < rounds; r0 += kScanRounds) {
      unsigned wd[kScanRounds];
      int x[kScanRounds];
#pragma unroll
      for (int r = 0; r < kScanRounds; ++r) {
        const int wi = (r0 + r) * wpt * 32 + gt;
        wd[r] = has_tile && r0 + r < rounds && wi < words ? __ldg(bm + wi) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kScanRounds; ++r) {
        if (r0 + r >= rounds) break;
        x[r] = __popc(wd[r]);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x[r], o);
          if (lane >= o) x[r] += y;
        }
        if (lane == 31) warp_sums[r * kWarps + warp] = x[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kScanRounds; ++r) {
        if (r0 + r >= rounds) break;
        int before = 0, tot = 0;
        for (int w = slot * wpt; w < (slot + 1) * wpt; ++w) {
          const int s = warp_sums[r * kWarps + w];
          before += w < warp ? s : 0;
          tot += s;
        }
        unsigned m = wd[r];
        int k = total + before + x[r] - __popc(m);
        const int base = ((r0 + r) * wpt * 32 + gt) * 32;
        while (m != 0u) {
          const int bit = __ffs(m) - 1;
          m &= m - 1u;
          if (k >= c0 && k < c0 + cap) list[k - c0] = base + bit;
          ++k;
        }
        total += tot;
      }
      __syncthreads();  // warp_sums are read before the next words' are written, the list before it is used
    }

    // This warp's part of the list, 32 queries at a time.
    const int n = min(cap, total - c0);
    const int e1 = n > 0 ? n * (part + 1) / wpt : 0;
    for (int e0 = n > 0 ? n * part / wpt : 0; e0 < e1; e0 += 32) {
      const int cnt = min(32, e1 - e0);
      const int q = lane < cnt ? list[e0 + lane] : 0;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {  // row r = (32k + lane) / kChunks, zero past the last query
        const int i = k * 32 + lane;
        const int r = i / kChunks;
        const int qr = __shfl_sync(0xffffffffu, q, r);
        cp_async16(G + r * S::kGS + (i % kChunks) * 4, grow + (long long)qr * nh * HD + (i % kChunks) * 4, r < cnt);
      }
      cp_async_commit();
      float2 xy[kPoints];
      float a[kPoints];
      if (lane < cnt) {
        load_xy(rec, rec0 + q, xy);
        load_aw(rec, rec0 + q, nrec, a);
      }
      for (int i = lane; i < kCells * S::kWS / 4; i += 32)
        reinterpret_cast<float4*>(W)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      int halves = 0;  // which 16-cell halves of W's column are not zero
      if (lane < cnt) {  // column lane of W: the query's corner weights on the tile's cells, point by point
#pragma unroll
        for (int p = 0; p < kPoints; ++p) {  // a point's 4 corners are 4 cells: their loads go first
          const Corners cr = value_corners(xy[p], L.h, L.w);
          int off[4];
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int yy = cr.y0 + (c >> 1) - ty0;
            const int xx = cr.x0 + (c & 1) - tx0;
            const bool on = corner_on(cr, c, L.h, L.w) && yy >= 0 && yy < L.th && xx >= 0 && xx < L.tw;
            off[c] = on ? (yy * L.tw + xx) * S::kWS + lane : -1;
            v[c] = on ? W[off[c]] : 0.f;
            halves |= on ? 1 << ((yy * L.tw + xx) >> 4) : 0;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (off[c] >= 0) W[off[c]] = v[c] + a[p] * (cr.wy[c >> 1] * cr.wx[c & 1]);
        }
      }
      const unsigned used[2] = {__ballot_sync(0xffffffffu, halves & 1), __ballot_sync(0xffffffffu, halves & 2)};
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      // acc += W G, 8 queries per step; a half of W that is zero over the 8 adds nothing.
      for (int k0 = 0; k0 < cnt; k0 += 8) {
        BFrag bf[kN];
#pragma unroll
        for (int ni = 0; ni < kN; ++ni) {
          const float* gp = G + (k0 + t4) * S::kGS + ni * 8 + g8;
          bf[ni] = split_b(gp[0], gp[4 * S::kGS]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (((used[mi] >> k0) & 0xffu) == 0u) continue;
          uint32_t ahi[4], alo[4];
          const float* w = W + (mi * 16 + g8) * S::kWS + k0 + t4;
          const float av[4] = {w[0], w[8 * S::kWS], w[4], w[8 * S::kWS + 4]};
          split_tf32_alu(av, ahi, alo);
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int ni = 0; ni < kN; ++ni) mma_pass(pass, acc[mi][ni], ahi, alo, bf[ni]);
        }
      }
      __syncwarp();  // G and W are read before the next 32 queries' are written
    }
    if (!__syncthreads_or(has_tile && part == 0 && total > c0 + cap)) break;
  }

  // The warp's copy of its tile (cells x hd) in G's place; the tile's copies
  // summed in warp order, each of its cells on the map written once.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kN; ++ni) {
      const int cell = mi * 16 + g8, ch = ni * 8 + 2 * t4;
      if (cell < cells) store2(G + cell * HD + ch, acc[mi][ni][0], acc[mi][ni][1]);
      if (cell + 8 < cells) store2(G + (cell + 8) * HD + ch, acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  const long long pix = (long long)nh * HD;
  T* dv = d_value + (b * ltot + L.start) * pix + (long long)h * HD;
  for (int t = 0; t < tpb; ++t) {
    const int tl = ((int)blockIdx.x - L.blk0) * tpb + t;
    if (tl >= ntiles) break;
    const int y0 = tl / ntx * L.th, x0 = tl % ntx * L.tw;
    const float4* c4 = reinterpret_cast<const float4*>(smem + (size_t)t * wpt * S::kWarpFloats);
    for (int r = threadIdx.x; r < cells * HD / 4; r += kThreads) {
      const int cell = r / (HD / 4);
      const int yy = y0 + (cell >> (__ffs(L.tw) - 1)), xx = x0 + (cell & (L.tw - 1));
      if (yy >= L.h || xx >= L.w) continue;
      float4 s = c4[r];
      for (int j = 1; j < wpt; ++j) {
        const float4 u = c4[(size_t)j * S::kWarpFloats / 4 + r];
        s.x += u.x;
        s.y += u.y;
        s.z += u.z;
        s.w += u.w;
      }
      store4(dv + (long long)(yy * L.w + xx) * pix + (r % (HD / 4)) * 4, s);
    }
  }
}

template <typename T, int HD, int NL>
int launch_levels(const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value,
                  void* d_loc, void* d_aw, unsigned* bitmap, long long bitmap_words, float* rec, const Levels& lv,
                  int words, int b, int nq, int nh, int ltot, int normalized, cudaStream_t s) {
  constexpr int kPairs = kThreads / (HD / 4);
  const long long pairs = (long long)b * nq * nh;
  const size_t smem = GatherSmem<HD>::bytes();
  // Set on every call: the attributes belong to the current device. All of
  // the SM's shared memory for the gather, so that two blocks fit.
  cudaError_t e = cudaFuncSetAttribute(gather_dv_kernel<T, HD, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_dv_kernel<T, HD, NL>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  deform_sample_bwd_kernel<T, HD, NL, kPoints><<<(unsigned)((pairs + kPairs - 1) / kPairs), kThreads, 0, s>>>(
      (const T*)value, (const float*)loc, (const float*)aw, (const float*)grad_out, (float*)d_loc, (float*)d_aw, rec, lv,
      pairs, nh, nq, ltot, normalized);
  e = cudaMemsetAsync(bitmap, 0, (size_t)bitmap_words * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  mark_kernel<<<dim3((unsigned)((words + kWarps - 1) / kWarps), (unsigned)NL, (unsigned)(b * nh)), kThreads, 0, s>>>(
      rec, lv, NL, nq, words, bitmap);
  gather_dv_kernel<T, HD, NL><<<dim3((unsigned)lv.blk0[NL], (unsigned)(b * nh)), kThreads, smem, s>>>(
      rec, (const float*)grad_out, (T*)d_value, bitmap, lv, nq, nh, ltot, words);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_nl(int nl, const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value,
                void* d_loc, void* d_aw, unsigned* bitmap, long long bitmap_words, float* rec, const Levels& lv, int words,
                int b, int nq, int nh, int ltot, int normalized, cudaStream_t s) {
  switch (nl) {  // the per-level entry and the model's three levels
    case 1:
      return launch_levels<T, HD, 1>(value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words, rec, lv,
                                     words, b, nq, nh, ltot, normalized, s);
    case 3:
      return launch_levels<T, HD, 3>(value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words, rec, lv,
                                     words, b, nq, nh, ltot, normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_hd(int hd, int nl, const void* value, const void* loc, const void* aw, const void* grad_out,
                void* d_value, void* d_loc, void* d_aw, unsigned* bitmap, long long bitmap_words, float* rec,
                const Levels& lv, int words, int b, int nq, int nh, int ltot, int normalized, cudaStream_t s) {
  switch (hd) {
    case 16:
      return dispatch_nl<T, 16>(nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words, rec, lv, words,
                                b, nq, nh, ltot, normalized, s);
    case 32:
      return dispatch_nl<T, 32>(nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words, rec, lv, words,
                                b, nq, nh, ltot, normalized, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// levels: nl sextuples (h, w, start, tile rows, tile columns, gather warps per
// tile) on the host, the tiles and warps as the wrapper plans them (at most
// kCells cells per tile); nl 1 or 3, P 4, hd 16 or 32. The levels must lie in
// consecutive rows of value from `start`; rows past the last level are not
// written. grad_out, d_loc and d_aw are float32; d_value has value's dtype
// (float32 or bfloat16, v_bf16) and is written whole over the levels' rows.
// scratch: scratch_ints 32-bit words, the bitmaps (b * nh * (all levels'
// tiles) * ceil(nq / 32) words, rounded up to a multiple of 4) and then the
// records (b * nh * nl * nq * 12 floats), which the wrapper computes the same
// way. All pointers must be 16-byte aligned.
extern "C" int rgbd_deform_sample_bwd(
    const void* value, const void* loc, const void* aw, const void* grad_out, void* d_value, void* d_loc,
    void* d_aw, void* scratch, long long scratch_ints, const int* levels, int b, int nq, int nh, int nl, int npts,
    int hd, int ltot, int normalized, int v_bf16, void* stream) {
  if (nl < 1 || nl > kMaxLevels || npts != kPoints) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)value | (uintptr_t)loc | (uintptr_t)aw | (uintptr_t)grad_out | (uintptr_t)d_value |
       (uintptr_t)d_loc | (uintptr_t)d_aw | (uintptr_t)scratch) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Levels lv = {};
  for (int i = 0; i < nl; ++i) {
    lv.h[i] = levels[6 * i];
    lv.w[i] = levels[6 * i + 1];
    lv.start[i] = levels[6 * i + 2];
    lv.th[i] = levels[6 * i + 3];
    lv.tw[i] = levels[6 * i + 4];
    lv.wpt[i] = levels[6 * i + 5];
    if (lv.h[i] < 1 || lv.w[i] < 1 || lv.h[i] >= (1 << 15) || lv.w[i] >= (1 << 14)) return (int)cudaErrorInvalidValue;
    const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
    if (!pow2(lv.th[i]) || !pow2(lv.tw[i]) || lv.th[i] * lv.tw[i] > kCells || !pow2(lv.wpt[i]) || lv.wpt[i] > kWarps)
      return (int)cudaErrorInvalidValue;
    const int tiles = ((lv.w[i] + lv.tw[i] - 1) / lv.tw[i]) * ((lv.h[i] + lv.th[i] - 1) / lv.th[i]);
    const int tpb = kWarps / lv.wpt[i];
    lv.tile0[i + 1] = lv.tile0[i] + tiles;
    lv.blk0[i + 1] = lv.blk0[i] + (tiles + tpb - 1) / tpb;
  }
  for (int i = nl + 1; i <= kMaxLevels; ++i) {  // every level's tiles and blocks: tile0[nl], blk0[nl]
    lv.tile0[i] = lv.tile0[nl];
    lv.blk0[i] = lv.blk0[nl];
  }
  if ((long long)b * nq * nh == 0) return (int)cudaSuccess;
  const int words = (int)(((long long)nq + 31) / 32);
  const long long bitmap_words = ((long long)b * nh * lv.tile0[nl] * words + 3) / 4 * 4;
  if (bitmap_words + (long long)b * nh * nl * nq * kRec != scratch_ints) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* bitmap = (unsigned*)scratch;
  float* rec = (float*)scratch + bitmap_words;
  if (v_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words,
                                      rec, lv, words, b, nq, nh, ltot, normalized, s);
  return dispatch_hd<float>(hd, nl, value, loc, aw, grad_out, d_value, d_loc, d_aw, bitmap, bitmap_words, rec, lv,
                            words, b, nq, nh, ltot, normalized, s);
}
