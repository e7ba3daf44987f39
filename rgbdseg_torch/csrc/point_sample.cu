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
// and no library call offers a deterministic backward for it. The tent-matmul
// form is deterministic too, but at the main path's geometry (B*N = 32 masks of
// 120x160, P = 12544) it is ~16 GFLOP and ~0.45 GB of tent tables per layer.
//
// Backward, deterministic by construction: no float atomics and no zeroing of
// the gradient followed by scattered adds. Each point is keyed by the top-left
// cell (floor(iy), floor(ix)) of its 2x2 footprint on the (H+1) x (W+1)
// lattice of such cells (row and column shifted by one, so -1 is cell 0); a
// point whose footprint misses the mask has no key and adds nothing. A
// counting sort builds each lattice cell's list of points, in ascending point
// order, in each mask's own P-entry stretch of `list`:
//   key:    per point, its key; its slot in the cell's list by an int32 atomic
//           (counts are exact whatever the order; the slots are not, so
//           `order` sorts each list afterwards);
//   scan:   per mask, one block turns the counts into each list's start;
//   place:  per point, list[start + slot] = p;
//   order:  per lattice cell, an insertion sort of its list by point index;
//   gather: per mask cell, the terms of the <= 4 lists that touch it (the
//           points of which it is the se, sw, ne and nw corner, in that order,
//           each list in ascending point order), each term the product weight
//           x grad_out rounded on its own as aten rounds it, summed in that
//           order and written once.
// Int32 atomics only count; every float sum runs in one fixed order, so two
// launches give the same bits. The lists stay short on the main path (about
// 0.65 points per cell, at most a few tens where the uncertainty draw bunches
// points), so the insertion sort is cheap there; it stays correct, and only
// slower, however the points bunch.
//
// Bound on the H100: memory. At B*N = 32 masks of 120x160 and P = 12544, the
// backward must read the coordinates (3.2 MB) and grad_out (1.6 MB) and write
// the gradient (2.5 MB): ~7.3 MB, ~2.2 us at 3.35 TB/s; the forward reads the
// masks and coordinates and writes out (7.3 MB; 16.9 MB at P = 37632). Every
// launch here is a gather or a pass over small int32 arrays; the scratch
// (keys, slots, lists: 12 bytes per point, 4 per lattice cell) stays in L2.
//
// One block per mask for the scan: 1024 threads, each warp over a contiguous
// run of the mask's (H+1)(W+1) + 1 counts, read 32 at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

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

__device__ __forceinline__ Point locate(const float* coords, long long i, int h, int w) {
  const float2 c = reinterpret_cast<const float2*>(coords)[i];
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

__global__ void __launch_bounds__(kThreads) sample_kernel(
    const float* __restrict__ masks, const float* __restrict__ coords, float* __restrict__ out,
    long long total, int npts, int h, int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const Point p = locate(coords, i, h, w);
  float acc = 0.f;
  if (p.touches) {
    const float* m = masks + (i / npts) * (long long)h * w;
    const int xe = p.x0 + 1, ys = p.y0 + 1;
    const float nw = (xe - p.ix) * (ys - p.iy);
    const float ne = (p.ix - p.x0) * (ys - p.iy);
    const float sw = (xe - p.ix) * (p.iy - p.y0);
    const float se = (p.ix - p.x0) * (p.iy - p.y0);
    if (inside(p.y0, p.x0, h, w)) acc = __fmaf_rn(m[p.y0 * w + p.x0], nw, acc);
    if (inside(p.y0, xe, h, w)) acc = __fmaf_rn(m[p.y0 * w + xe], ne, acc);
    if (inside(ys, p.x0, h, w)) acc = __fmaf_rn(m[ys * w + p.x0], sw, acc);
    if (inside(ys, xe, h, w)) acc = __fmaf_rn(m[ys * w + xe], se, acc);
  }
  out[i] = acc;
}

// Per point: its lattice key (-1: touches nothing) and its slot in the key's list.
__global__ void __launch_bounds__(kThreads) key_kernel(
    const float* __restrict__ coords, int* __restrict__ keys, int* __restrict__ slots, int* __restrict__ counts,
    long long total, int npts, int h, int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const Point p = locate(coords, i, h, w);
  int key = -1;
  if (p.touches) {
    key = (p.y0 + 1) * (w + 1) + p.x0 + 1;
    const long long cells = (long long)(h + 1) * (w + 1) + 1;
    slots[i] = atomicAdd(&counts[(i / npts) * cells + key], 1);
  }
  keys[i] = key;
}

// Per mask (one block): counts -> each list's start in `list` (the mask's
// stretch begins at mask * npts); the extra last entry becomes the end. Each
// warp owns a contiguous run of whole 32-count chunks, read coalesced: a first
// pass sums the run, the block scans the 32 runs' sums, a second pass scans
// chunk by chunk with shuffles and writes the starts.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int* __restrict__ counts, int cells, int npts) {
  __shared__ int warp_sums[kScanThreads / 32];
  int* c = counts + (long long)blockIdx.x * cells;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = (cells + kScanThreads - 1) / kScanThreads * 32;
  const int lo = min(cells, warp * run), hi = min(cells, lo + run);
  int sum = 0;
  for (int k = lo + lane; k < hi; k += 32) sum += c[k];
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int own = warp_sums[lane];
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    warp_sums[lane] = incl - own;
  }
  __syncthreads();
  int base = blockIdx.x * npts + warp_sums[warp];
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int k = k0 + lane;
    const int n = k < hi ? c[k] : 0;
    int incl = n;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (k < hi) c[k] = base + incl - n;
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}

__global__ void __launch_bounds__(kThreads) place_kernel(
    const int* __restrict__ keys, const int* __restrict__ slots, const int* __restrict__ starts,
    int* __restrict__ list, long long total, int npts, int cells) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int key = keys[i];
  if (key < 0) return;
  const long long m = i / npts;
  list[starts[m * cells + key] + slots[i]] = (int)(i - m * npts);
}

__global__ void __launch_bounds__(kThreads) order_kernel(
    const int* __restrict__ starts, int* __restrict__ list, long long lattice, int cells) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lattice) return;
  const long long c = i / (cells - 1) * cells + i % (cells - 1);
  const int lo = starts[c], hi = starts[c + 1];
  for (int k = lo + 1; k < hi; ++k) {
    const int v = list[k];
    int j = k - 1;
    for (; j >= lo && list[j] > v; --j) list[j + 1] = list[j];
    list[j + 1] = v;
  }
}

// The weight with which point `p` samples the mask cell (y, x), as aten forms it.
__device__ __forceinline__ float corner_weight(const Point& p, int y, int x) {
  const float wx = x == p.x0 ? (p.x0 + 1) - p.ix : p.ix - p.x0;
  const float wy = y == p.y0 ? (p.y0 + 1) - p.iy : p.iy - p.y0;
  return wx * wy;
}

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ coords, const float* __restrict__ grad_out, const int* __restrict__ starts,
    const int* __restrict__ list, float* __restrict__ grad, long long total, int npts, int h, int w) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long hw = (long long)h * w, m = i / hw;
  const int y = (int)(i % hw / w), x = (int)(i % w);
  const int* st = starts + m * ((long long)(h + 1) * (w + 1) + 1);
  const long long base = m * npts;
  float acc = 0.f;
  // This cell is the se corner of lattice cell (y, x), sw of (y, x + 1), ne of
  // (y + 1, x) and nw of (y + 1, x + 1).
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = (y + (k >> 1)) * (w + 1) + x + (k & 1);
    for (int j = st[c]; j < st[c + 1]; ++j) {
      const long long q = base + list[j];
      const Point p = locate(coords, q, h, w);
      acc = __fadd_rn(acc, __fmul_rn(corner_weight(p, y, x), grad_out[q]));
    }
  }
  grad[i] = acc;
}

int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int rgbd_point_sample(const void* masks, const void* coords, void* out, int bn, int npts, int h, int w,
                                 void* stream) {
  if (((uintptr_t)coords) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const long long total = (long long)bn * npts;
  if (total == 0) return (int)cudaSuccess;
  sample_kernel<<<blocks(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)masks, (const float*)coords, (float*)out, total, npts, h, w);
  return (int)cudaGetLastError();
}

// scratch: int32, (bn * (H+1)(W+1) + bn) counts / starts, then keys, slots and
// the lists, bn * npts each.
extern "C" int rgbd_point_sample_bwd(const void* coords, const void* grad_out, void* grad, void* scratch, int bn,
                                     int npts, int h, int w, void* stream) {
  if (((uintptr_t)coords) % 8 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const int cells = (h + 1) * (w + 1) + 1;
  const long long points = (long long)bn * npts, pixels = (long long)bn * h * w;
  int* counts = (int*)scratch;
  int* keys = counts + (long long)bn * cells;
  int* slots = keys + points;
  int* list = slots + points;
  if (pixels == 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)bn * cells, s);
  if (err != cudaSuccess) return (int)err;
  if (points > 0) {
    key_kernel<<<blocks(points, kThreads), kThreads, 0, s>>>(
        (const float*)coords, keys, slots, counts, points, npts, h, w);
  }
  scan_kernel<<<bn, kScanThreads, 0, s>>>(counts, cells, npts);
  if (points > 0) {
    place_kernel<<<blocks(points, kThreads), kThreads, 0, s>>>(keys, slots, counts, list, points, npts, cells);
  }
  const long long lattice = (long long)bn * (cells - 1);
  order_kernel<<<blocks(lattice, kThreads), kThreads, 0, s>>>(counts, list, lattice, cells);
  gather_kernel<<<blocks(pixels, kThreads), kThreads, 0, s>>>(
      (const float*)coords, (const float*)grad_out, counts, list, (float*)grad, pixels, npts, h, w);
  return (int)cudaGetLastError();
}
