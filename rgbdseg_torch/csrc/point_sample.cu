// Bilinear sampling of each mask at its own points, and its gradient to the
// masks (the criterion's point sampling).
//
//   out[m, p] = bilinear_zeros(masks[m], coords[m, p]),   m over B * N masks
//
// masks (B*N, H, W) float32; coords (B*N, P, 2) float32 (x, y) in [0, 1]; out
// (B*N, P) float32. The sampling is `F.grid_sample(mode="bilinear",
// padding_mode="zeros", align_corners=False)` of the grid 2c - 1, computed as
// aten's CUDA kernel computes it: the source index ((g + 1) * W - 1) / 2 of
// grid_sampler_compute_source_index (nvcc contracts its multiply and subtract
// into one fma, written out here), the corner weights (ix_se - ix) * (iy_se -
// iy) etc., and the in-bounds corners added in aten's order (nw, ne, sw, se).
//
// Replaces no TPU kernel. The JAX package computes this function in XLA,
// outside any Pallas call: rgbdseg_tpu/ops/losses.py:72 `_sample_each_mask`, a
// custom VJP whose backward is one matmul per layer, (Ty * g)^T @ Tx over tent
// tables, with no scatter, so its training repeats bit for bit. aten's
// `grid_sampler_2d_backward` on CUDA adds each point's four corner terms into
// the gradient with float atomics, in an order that changes from run to run,
// and no library call offers a deterministic backward for it.
//
// Bound on the H100: memory. At B*N = 32 masks of 120x160 and P = 12544, the
// backward must read the coordinates (3.2 MB) and grad_out (1.6 MB) and write
// the gradient (2.5 MB): ~7.3 MB, ~2.2 us at 3.35 TB/s; the forward reads the
// mask cells its points touch and the coordinates and writes out (~7 MB; ~17
// MB at P = 37632).
//
// Forward: a block samples `runs` consecutive runs of 1024 points of one
// mask (the mask from the block index, 32-bit index arithmetic within it;
// runs chosen for about two blocks per SM), so that the cells its points
// share come from its SM's L1; each thread takes 4 points of a run, read as
// two float4 of coordinate pairs where P is even and the coordinates are
// 16-byte aligned (else one float2 each), the next run's in flight, and issues
// the loads of its 16 corners before the first multiply-add.
//
// Backward, deterministic by construction: no float atomics and no zeroing of
// the gradient followed by scattered adds. Each point is keyed by the top-left
// cell (floor(iy), floor(ix)) of its 2x2 footprint on the (H+1) x (W+1)
// lattice of such cells (row and column shifted by one, so -1 is cell 0); a
// point whose footprint misses the mask has no key and adds nothing. Each mask
// cell sums, from 0, the lists of the <= 4 lattice cells that touch it (the
// points of which it is the se, sw, ne and nw corner, in that order), each
// list in ascending point order, each term the product weight x grad_out
// rounded on its own as aten rounds it, with round-to-nearest adds, and is
// written once. That order is fixed by the data alone, so two launches give
// the same bits.
//
// One launch: a block of 1024 threads owns one mask's band of kBandRows rows
// (4 bands, 128 blocks, one per SM, at 120x160) and works in shared memory:
//   compact: stream the mask's P coordinates and grad_out in rounds of 4096
//            points (float4 loads, the next round's in flight while this one
//            is scanned), locate each point once, and keep, in ascending point
//            order (a block scan per round), those whose footprint touches the
//            band: their band-local lattice key and their four corner terms;
//   lists:   int32 counts per band lattice cell (shared atomics: counts are
//            exact in any order), a block scan to list starts, a placement,
//            and each entry's rank in its list by counting the smaller point
//            indices in it; the terms are copied into list order, so every
//            list is in ascending order whatever order the atomics took;
//   gather:  one thread per band cell adds its <= 4 lists' terms in one loop
//            (a warp diverges on the cells' total lengths only) and writes its
//            cell once, coalesced.
// No global scratch, no second launch. At the main path's geometry a band
// keeps ~3.2k of the 12544 points (~120 KB of its 220 KB of shared memory).
// Every band reads all of its mask's coordinates (4x the compulsory bytes,
// from L2); a cluster of a mask's bands that located each point once and
// handed it to its bands through distributed shared memory, and cp.async
// stages for the rounds, were both slower on the H100.
// A band whose points do not fit (bunched points: the uncertainty draw of a
// trained model bunches them along boundaries) takes the same order in more
// passes: for each of the four list kinds in turn, for each run of `cap`
// points in ascending order, compact, list and add that kind's terms onto the
// cell's partial sum, kept in the gradient itself (each cell belongs to one
// thread). Slower, the same bits. Lists stay short on the main path (about
// 0.65 points per lattice cell); the ranking costs the square of a list's
// length, so a list of thousands (all points in one cell) is slow but exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // forward block
constexpr int kFwdItems = 4;      // forward points per thread
constexpr int kFwdPoints = kThreads * kFwdItems;
constexpr int kBwdThreads = 1024;  // backward block: one mask band, one block per SM
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdItems = 4;      // consecutive points per thread per compaction round
constexpr int kBandRows = 32;
constexpr int kSmemBudget = 220 * 1024;  // per backward block

struct Point {
  float ix, iy;       // source indices, as aten computes them
  int x0, y0;         // the footprint's top-left cell
  bool touches;       // some corner lies in the mask
};

// grid_sampler_compute_source_index (align_corners=False, zeros padding) of the
// grid value g = 2c - 1 that the plain version builds (2c is exact, so one fma
// rounds g as the plain version's two operations do).
__device__ __forceinline__ float source_index(float c, int size) {
  const float g = __fmaf_rn(2.f, c, -1.f);
  return __fmaf_rn(g + 1.f, (float)size, -1.f) / 2;
}

__device__ __forceinline__ Point locate(float2 c, int h, int w) {
  Point p;
  p.ix = source_index(c.x, w);
  p.iy = source_index(c.y, h);
  const float fx = floorf(p.ix), fy = floorf(p.iy);
  // Compared as floats before any conversion: far and NaN coordinates touch nothing.
  p.touches = fx >= -1.f && fx <= (float)(w - 1) && fy >= -1.f && fy <= (float)(h - 1);
  p.x0 = p.touches ? (int)fx : 0;
  p.y0 = p.touches ? (int)fy : 0;
  return p;
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// Thread t takes points p0 + 2t, p0 + 2t + 1, p0 + 2 * kThreads + 2t and
// p0 + 2 * kThreads + 2t + 1 of a run of kFwdPoints: two coordinate pairs,
// each one float4 with kVec (points past npts read as far outside).
template <bool kVec>
__device__ __forceinline__ void load_fwd(const float2* c2, int p0, int npts, float2 (&c)[kFwdItems]) {
#pragma unroll
  for (int j = 0; j < kFwdItems; j += 2) {
    const int p = p0 + (j >> 1) * 2 * kThreads;
    if (kVec && p < npts) {
      const float4 v = *reinterpret_cast<const float4*>(c2 + p);
      c[j] = make_float2(v.x, v.y);
      c[j + 1] = make_float2(v.z, v.w);
    } else {
      c[j] = p < npts ? c2[p] : make_float2(-2.f, -2.f);
      c[j + 1] = p + 1 < npts ? c2[p + 1] : make_float2(-2.f, -2.f);
    }
  }
}

// A block samples `runs` consecutive runs of kFwdPoints points of one mask
// (the next run's coordinates in flight while this one's corners load), so
// that the mask's cells, read by many of its points, come from this SM's L1.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) sample_kernel(
    const float* __restrict__ masks, const float* __restrict__ coords, float* __restrict__ out, int npts, int h,
    int w, int blocks_per_mask, int runs) {
  const int m = blockIdx.x / blocks_per_mask;
  const int first = (blockIdx.x - m * blocks_per_mask) * runs * kFwdPoints;
  const int last = min(npts, first + runs * kFwdPoints);
  const float* mk = masks + (size_t)m * h * w;
  const float2* c2 = reinterpret_cast<const float2*>(coords) + (size_t)m * npts;
  float* o = out + (size_t)m * npts;
  float2 c[kFwdItems], cn[kFwdItems];
  load_fwd<kVec>(c2, first + 2 * threadIdx.x, last, c);
  for (int base = first; base < last; base += kFwdPoints) {
    const int p0 = base + 2 * threadIdx.x;
    load_fwd<kVec>(c2, p0 + kFwdPoints, last, cn);
    Point pt[kFwdItems];
    float v[kFwdItems][4];
#pragma unroll
    for (int j = 0; j < kFwdItems; ++j) {
      pt[j] = locate(c[j], h, w);
      const int x0 = pt[j].x0, y0 = pt[j].y0, t = pt[j].touches;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // nw, ne, sw, se
        const int y = y0 + (k >> 1), x = x0 + (k & 1);
        v[j][k] = t && inside(y, x, h, w) ? __ldg(mk + y * w + x) : 0.f;
      }
    }
    float acc[kFwdItems];
#pragma unroll
    for (int j = 0; j < kFwdItems; ++j) {
      const Point& q = pt[j];
      acc[j] = 0.f;
      if (q.touches) {
        const int xe = q.x0 + 1, ys = q.y0 + 1;
        const float nw = (xe - q.ix) * (ys - q.iy);
        const float ne = (q.ix - q.x0) * (ys - q.iy);
        const float sw = (xe - q.ix) * (q.iy - q.y0);
        const float se = (q.ix - q.x0) * (q.iy - q.y0);
        if (inside(q.y0, q.x0, h, w)) acc[j] = __fmaf_rn(v[j][0], nw, acc[j]);
        if (inside(q.y0, xe, h, w)) acc[j] = __fmaf_rn(v[j][1], ne, acc[j]);
        if (inside(ys, q.x0, h, w)) acc[j] = __fmaf_rn(v[j][2], sw, acc[j]);
        if (inside(ys, xe, h, w)) acc[j] = __fmaf_rn(v[j][3], se, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kFwdItems; j += 2) {
      const int p = p0 + (j >> 1) * 2 * kThreads;
      if (kVec && p < last) {
        *reinterpret_cast<float2*>(o + p) = make_float2(acc[j], acc[j + 1]);
      } else {
        if (p < last) o[p] = acc[j];
        if (p + 1 < last) o[p + 1] = acc[j + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kFwdItems; ++j) c[j] = cn[j];
  }
}

// Exclusive prefix sum of v over the block; `total` gets the block's sum.
// `wsum` holds kBwdWarps ints; callers alternate two such buffers, so that one
// call's readers never race the next call's writers.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kBwdWarps ? wsum[lane] : 0;
    int s = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kBwdWarps) wsum[lane] = s;
  }
  __syncthreads();
  total = wsum[kBwdWarps - 1];
  return (warp ? wsum[warp - 1] : 0) + incl - v;
}

// One backward block's shared memory: `cap` compacted points and the band's
// `cells` lattice cells.
struct Band {
  float4* terms;       // [cap] each kept point's nw, ne, sw, se terms, in point order
  float4* listed;      // [cap] the same, in list order
  int* starts;         // [cells + 1] counts, then each list's start; the last is the end
  int* wsum;           // [2 * 32] block-scan buffers
  uint16_t* key;       // [cap] band-local lattice key
  uint16_t* slot;      // [cap] each point's slot in its list from the atomics
  uint16_t* unsorted;  // [cap] the lists, entries in the atomics' order

  __device__ Band(void* smem, int cap, int cells) {
    terms = reinterpret_cast<float4*>(smem);
    listed = terms + cap;
    starts = reinterpret_cast<int*>(listed + cap);
    wsum = starts + cells + 1;
    key = reinterpret_cast<uint16_t*>(wsum + 64);
    slot = key + cap;
    unsorted = slot + cap;
  }
};

constexpr int kBytesPerPoint = 2 * 16 + 3 * 2;

size_t band_bytes(int cap, int cells) { return (size_t)cap * kBytesPerPoint + 4 * (size_t)(cells + 1) + 4 * 64; }

__device__ __forceinline__ void load_round(const float2* c2, const float* g, int p0, int hi, bool vec,
                                           float2 (&c)[kBwdItems], float (&gv)[kBwdItems]) {
  static_assert(kBwdItems % 4 == 0, "vector loads take 4 points at a time");
  if (vec && p0 < hi) {  // hi - p0 is then a multiple of kBwdItems
#pragma unroll
    for (int j = 0; j < kBwdItems; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(c2 + p0 + j);
      const float4 b = *reinterpret_cast<const float4*>(c2 + p0 + j + 2);
      const float4 gg = *reinterpret_cast<const float4*>(g + p0 + j);
      c[j] = make_float2(a.x, a.y);
      c[j + 1] = make_float2(a.z, a.w);
      c[j + 2] = make_float2(b.x, b.y);
      c[j + 3] = make_float2(b.z, b.w);
      gv[j] = gg.x, gv[j + 1] = gg.y, gv[j + 2] = gg.z, gv[j + 3] = gg.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kBwdItems; ++j) {
    c[j] = p0 + j < hi ? c2[p0 + j] : make_float2(-2.f, -2.f);
    gv[j] = p0 + j < hi ? g[p0 + j] : 0.f;
  }
}

// The points [lo, hi) of one mask (coordinates c2, grad_out g) whose footprint
// touches lattice rows [r0, r0 + rows]: their band-local keys and corner terms
// at [0, n) of the band, in ascending point order. Returns n, or -1 (in every
// thread) once more than `cap` would be kept.
__device__ int compact(const Band& s, const float2* c2, const float* g, int lo, int hi, int r0, int rows, int h,
                       int w, bool vec, int cap, int& parity) {
  constexpr int kRound = kBwdThreads * kBwdItems;
  float2 c[kBwdItems], cn[kBwdItems];
  float gv[kBwdItems], gn[kBwdItems];
  load_round(c2, g, lo + threadIdx.x * kBwdItems, hi, vec, c, gv);
  int n = 0;
  for (int base = lo; base < hi; base += kRound) {
    load_round(c2, g, base + kRound + threadIdx.x * kBwdItems, hi, vec, cn, gn);  // the next round, in flight
    Point pt[kBwdItems];
    int kept = 0;
#pragma unroll
    for (int j = 0; j < kBwdItems; ++j) {
      pt[j] = locate(c[j], h, w);
      pt[j].touches = pt[j].touches && pt[j].y0 + 1 >= r0 && pt[j].y0 + 1 <= r0 + rows;
      kept += pt[j].touches;
    }
    int total;
    int at = n + block_scan(kept, s.wsum + 32 * parity, total);
    parity ^= 1;
    if (n + total > cap) return -1;
#pragma unroll
    for (int j = 0; j < kBwdItems; ++j) {
      const Point& q = pt[j];
      if (!q.touches) continue;
      const float wx0 = (q.x0 + 1) - q.ix, wx1 = q.ix - q.x0;  // the west and east columns' weights
      const float wy0 = (q.y0 + 1) - q.iy, wy1 = q.iy - q.y0;  // the north and south rows'
      s.key[at] = (uint16_t)((q.y0 + 1 - r0) * (w + 1) + q.x0 + 1);
      s.terms[at] = make_float4(__fmul_rn(__fmul_rn(wx0, wy0), gv[j]), __fmul_rn(__fmul_rn(wx1, wy0), gv[j]),
                                __fmul_rn(__fmul_rn(wx0, wy1), gv[j]), __fmul_rn(__fmul_rn(wx1, wy1), gv[j]));
      ++at;
    }
    n += total;
#pragma unroll
    for (int j = 0; j < kBwdItems; ++j) c[j] = cn[j], gv[j] = gn[j];
  }
  return n;
}

__device__ __forceinline__ void zero_counts(const Band& s, int cells) {
  for (int c = threadIdx.x; c <= cells; c += kBwdThreads) s.starts[c] = 0;
}

// From the band's n compacted points and zeroed counts: each lattice cell's
// list, in ascending point order, of its points' terms at
// listed[starts[c], starts[c + 1]).
__device__ void build_lists(const Band& s, int n, int cells, int& parity) {
  for (int i = threadIdx.x; i < n; i += kBwdThreads) s.slot[i] = (uint16_t)atomicAdd(&s.starts[s.key[i]], 1);
  __syncthreads();
  const int per = (cells + kBwdThreads) / kBwdThreads;  // cells + 1 counts, a contiguous run each
  const int lo = min(cells + 1, (int)threadIdx.x * per), hi = min(cells + 1, lo + per);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += s.starts[c];
  int total;
  int run = block_scan(sum, s.wsum + 32 * parity, total);
  parity ^= 1;
  for (int c = lo; c < hi; ++c) {
    const int k = s.starts[c];
    s.starts[c] = run;
    run += k;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kBwdThreads) s.unsorted[s.starts[s.key[i]] + s.slot[i]] = (uint16_t)i;
  __syncthreads();
  // An entry's rank in its list: the entries of smaller point index in it.
  for (int i = threadIdx.x; i < n; i += kBwdThreads) {
    const int k = s.key[i], first = s.starts[k], end = s.starts[k + 1];
    int rank = 0;
    for (int e = first; e < end; ++e) rank += s.unsorted[e] < i;
    s.listed[first + rank] = s.terms[i];
  }
  __syncthreads();
}

// Each of the band's rows x w cells adds the terms of its lists of kinds
// [k0, k1) (0..3: the lattice cell of which it is the se, sw, ne, nw corner;
// the point's corner 3 - k), each in ascending point order, onto 0 (`first`)
// or its partial sum in the gradient, and writes the gradient. Kinds 0 and 1
// are neighbouring lattice cells, whose lists are contiguous, as are 2 and 3:
// one loop over all of a cell's entries, so that a warp diverges only on the
// cells' total lengths.
__device__ void gather(const Band& s, float* grad, int rows, int w, int k0, int k1, bool first) {
  const float* listed = reinterpret_cast<const float*>(s.listed);
  const int step_y = kBwdThreads / w, step_x = kBwdThreads - step_y * w;
  int y = threadIdx.x / w, x = threadIdx.x - y * w;
  for (int q = threadIdx.x; q < rows * w; q += kBwdThreads) {
    const int c = y * (w + 1) + x;
    float acc = first ? 0.f : grad[q];
    const int ka = max(k0, 0), kb = min(k1, 2), kc = max(k0, 2), kd = min(k1, 4);
    // kinds [ka, kb) run over starts[c + ka, c + kb], kinds [kc, kd) over
    // starts[c + w + 1 + kc - 2, c + w + 1 + kd - 2]
    const int a0 = ka < kb ? s.starts[c + ka] : 0, a1 = s.starts[c + 1], a2 = ka < kb ? s.starts[c + kb] : 0;
    const int b0 = kc < kd ? s.starts[c + w + 1 + kc - 2] : 0, b1 = s.starts[c + w + 2];
    const int b2 = kc < kd ? s.starts[c + w + 1 + kd - 2] : 0;
    const int na = a2 - a0, total = na + b2 - b0;
    for (int i = 0; i < total; ++i) {
      const int e = i < na ? a0 + i : b0 + i - na;
      const int corner = i < na ? (e < a1 ? 3 : 2) : (e < b1 ? 1 : 0);
      acc = __fadd_rn(acc, listed[4 * e + corner]);
    }
    grad[q] = acc;
    x += step_x;
    y += step_y;
    if (x >= w) x -= w, ++y;
  }
}

__global__ void __launch_bounds__(kBwdThreads, 1) band_bwd_kernel(
    const float* __restrict__ coords, const float* __restrict__ grad_out, float* __restrict__ grad, int npts, int h,
    int w, int band_rows, int bands, int cap, int vec) {
  extern __shared__ float4 smem[];
  const int m = blockIdx.x / bands, r0 = (blockIdx.x - m * bands) * band_rows;
  const int rows = min(band_rows, h - r0), cells = (rows + 1) * (w + 1);
  const Band s(smem, cap, cells);
  const float2* c2 = reinterpret_cast<const float2*>(coords) + (size_t)m * npts;
  const float* g = grad_out + (size_t)m * npts;
  float* out = grad + ((size_t)m * h + r0) * w;
  int parity = 0;
  zero_counts(s, cells);  // ordered before build_lists by compact's barriers
  const int n = compact(s, c2, g, 0, npts, r0, rows, h, w, vec, cap, parity);
  __syncthreads();
  if (n >= 0) {
    build_lists(s, n, cells, parity);
    gather(s, out, rows, w, 0, 4, true);
    return;
  }
  // The band holds more than `cap` points: the same sums, one list kind and
  // `cap` points at a time.
  for (int k = 0; k < 4; ++k) {
    for (int lo = 0; lo < npts; lo += cap) {
      zero_counts(s, cells);
      const int got = compact(s, c2, g, lo, min(npts, lo + cap), r0, rows, h, w, vec, cap, parity);
      __syncthreads();
      build_lists(s, got, cells, parity);
      gather(s, out, rows, w, k, k + 1, k == 0 && lo == 0);
      __syncthreads();
    }
  }
}

// Runs of kFwdPoints per forward block: about two blocks per SM, so that a
// block reads many points of its mask and the mask's cells they share come
// from its SM's L1.
int fwd_runs(int bn, int per_mask) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    sms = 132;
  const long long runs = ((long long)bn * per_mask + sms) / (2LL * sms);  // rounded to nearest
  return (int)(runs < 1 ? 1 : runs > per_mask ? per_mask : runs);
}

}  // namespace

extern "C" int rgbd_point_sample(const void* masks, const void* coords, void* out, int bn, int npts, int h, int w,
                                 void* stream) {
  if (((uintptr_t)coords) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (bn == 0 || npts == 0) return (int)cudaSuccess;
  const int per_mask = (npts + kFwdPoints - 1) / kFwdPoints;  // runs of kFwdPoints
  const int runs = fwd_runs(bn, per_mask);
  const int blocks_per_mask = (per_mask + runs - 1) / runs;
  const bool vec = npts % 2 == 0 && (uintptr_t)coords % 16 == 0 && (uintptr_t)out % 8 == 0;
  const unsigned blocks = (unsigned)((long long)bn * blocks_per_mask);
  if (vec) {
    sample_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)masks, (const float*)coords, (float*)out, npts, h, w, blocks_per_mask, runs);
  } else {
    sample_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)masks, (const float*)coords, (float*)out, npts, h, w, blocks_per_mask, runs);
  }
  return (int)cudaGetLastError();
}

extern "C" int rgbd_point_sample_bwd(const void* coords, const void* grad_out, void* grad, int bn, int npts, int h,
                                     int w, void* stream) {
  if (((uintptr_t)coords) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (bn == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  // Bands of kBandRows rows, fewer where a wide mask's lattice would take more
  // than a quarter of the budget; the rest holds `cap` points.
  int band_rows = kBandRows;
  while (band_rows > 1 && 4 * (band_rows + 1) * (w + 1) > kSmemBudget / 4) band_rows >>= 1;
  band_rows = band_rows < h ? band_rows : h;
  const int cells = (band_rows + 1) * (w + 1);
  const int cap = (int)((kSmemBudget - band_bytes(0, cells)) / kBytesPerPoint) & ~15;
  if (cells > 65535 || cap < 16) return (int)cudaErrorInvalidValue;
  const size_t smem = band_bytes(cap, cells);
  const int bands = (h + band_rows - 1) / band_rows;
  const int vec = npts % kBwdItems == 0 && (uintptr_t)coords % 16 == 0 && (uintptr_t)grad_out % 16 == 0;
  // Set on every call: the attributes belong to the current device.
  cudaError_t e = cudaFuncSetAttribute(band_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(band_bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  band_bwd_kernel<<<(unsigned)((long long)bn * bands), kBwdThreads, smem, (cudaStream_t)stream>>>(
      (const float*)coords, (const float*)grad_out, (float*)grad, npts, h, w, band_rows, bands, cap, vec);
  return (int)cudaGetLastError();
}
