// E-DSAM's full-resolution extract stage (models/fusion.py,
// EnhancedDepthImageRatioPredictor): a 3x3 convolution from 128 to 256
// channels, BatchNorm, ReLU and the adaptive average pool to 4 x 4, as
//
//   out[n, c, i, j] = mean over bin (i, j) of relu(bn(conv3x3(x)[n, c]))
//
// x (B, 128, H, W) float32 NCHW; the weights (256, 128, 3, 3) float32; out
// (B, 256, 4, 4) float32.
// The bins follow torch's adaptive pooling: rows [floor(iH/4), ceil((i+1)H/4)),
// columns likewise, so uneven sizes give overlapping bins.
//
// Replaces no TPU kernel. The JAX package computes this stage in XLA (its conv
// with the eval-mode BatchNorm folded in, `rgbdseg_tpu/models/fusion.py`); on
// the H100 it is the largest single operation of every 0.4.0 step: 2.90 TFLOP
// of products at batch 16, 480 x 640, and a 5.0 GB float32 output that three
// more kernels (BatchNorm, ReLU, pool) read again before the pool throws all
// but 16 x 256 x 16 numbers away. cuDNN's float32 route runs on the CUDA cores.
//
// Bound on the H100: the tensor cores. Products in 3xTF32, x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi), each product lo*hi + hi*lo + hi*hi with
// float32 sums (as mma_tf32.cuh), keep float32's accuracy at three TF32
// products: 3 x 2.90 TFLOP / 494.7 TFLOP/s = 17.6 ms a train step of 16.
//
// Design: an implicit GEMM, M = B*H*W pixels, N = 256, K = 9 taps x 128.
//  - A tile is 2 image rows x 128 columns (M = 256) by one half of the output
//    channels (N = 128); K runs as 16 chunks of 8 input channels, each chunk
//    one k8 step per tap (144 steps).
//  - Persistent blocks, one per SM, walk the tiles (the two halves of one
//    pixel tile next to each other, so their input meets in L2). Two
//    consumer warpgroups (one image row each, two m64 subtiles) and a
//    producer warpgroup; setmaxnreg gives the consumers 232 registers and
//    the producer 40.
//  - The producer keeps two rings full. A: the chunk's input halo, 8 channels
//    x 4 rows x 130 columns, by cp.async with zero fill at the image's edges
//    (the conv's padding), completion on an mbarrier; it serves all 9 taps.
//    B: each k8 step's weights, split into hi and lo by `prep_kernel` once a
//    call and laid out in wgmma's K-major no-swizzle layout (8 x 16-byte core
//    matrices), one 8 KB bulk copy (TMA) a step. The tile's 256 pixels share
//    each B tile: L2 sends 8 KB per 256 x 128 x 8 products.
//  - The consumers load their A fragments from the halo (the plane stride is
//    8 mod 32 words: conflict-free), split them in registers, and issue
//    wgmma m64n128k8 with A from registers and B from shared memory: lo*hi,
//    hi*lo, hi*hi. The tensor cores' additions truncate: chained over the 432
//    products of a tile they shrink every output by ~1e-5 (measured on an H100: the
//    batch mean 1e-5 off float64, cuDNN's 1e-7). So a subtile's sum over two
//    k8 steps starts from 0 (the four small products first, the two hi*hi
//    last) and goes into a float32 register sum with a round-to-nearest add
//    (measured on an H100: within 0.36 of twice cuDNN's error). The two consumer
//    warpgroups take turns issuing (named barriers), so one adds while the
//    other's products run. The producer runs ahead into the next tile while
//    the consumers finish an epilogue.
//  - Train mode (batch statistics need the whole output first): the epilogue
//    adds the bias, stores y, and writes the tile's per-channel mean and M2
//    (Chan's form: y has a large mean). `stats_kernel` combines the tiles'
//    partials into the batch's (count, mean, M2) in float64 in a fixed order
//    (the same bits on every run; under data parallelism the caller sums
//    them over the data group), and `apply_kernel` finalizes them (the
//    running statistics as BatchNorm2d moves them), normalises y, applies the
//    affine and the ReLU and sums the bins in a fixed order. Three launches
//    (and the weights' split); one stored round trip of y.
//  - Eval mode (a per-channel affine from the running statistics): the
//    epilogue applies bias, BatchNorm and ReLU in registers and sums each
//    tile row's part of each bin column; the last tile of a tile row adds
//    the row's tiles, the last tile row of a bin row adds its rows and writes
//    the bins (integer counters pick the last; fixed orders). One call (the
//    split, then the products); y is never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kCin = 128;
constexpr int kCout = 256;
constexpr int kBN = 128;    // output channels of a tile: one half
constexpr int kTileW = 128;  // a tile's columns; its rows: 2
constexpr int kCk = 8;       // input channels of a chunk
constexpr int kChunks = kCin / kCk;
constexpr int kSteps = kChunks * 9;  // k8 steps of a tile
constexpr int kRS = 136;              // halo row stride (floats); input column w0 - 1 at index 3
constexpr int kPS = 552;              // halo plane stride (floats, 4 rows): 8 mod 32
constexpr int kHalo = kCk * kPS;      // floats of one A stage
constexpr int kNA = 3;                // A stages
constexpr int kNB = 12;               // B stages
constexpr int kBTile = kBN * 8;       // floats of one k8 B tile (hi or lo)
constexpr int kThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int kPool = 4;  // the pool's output size

// Shared memory, in floats from the (1024-aligned) base.
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kNA * kHalo;
constexpr int kOffRed = kOffB + kNB * 2 * kBTile;
constexpr int kOffCoef = kOffRed + 8 * 4 * kBN;
constexpr int kOffMean = kOffCoef + 4 * kCout;
constexpr int kOffFlag = kOffMean + kBN;
constexpr int kOffBar = kOffFlag + 8;  // 8-byte aligned: kOffFlag is a multiple of 8
constexpr size_t kSmemBytes = (size_t)kOffBar * 4 + (2 * kNA + 2 * kNB) * 8;
static_assert(kHalo % 4 == 0 && kOffB % 32 == 0 && kOffBar % 2 == 0, "alignment");
static_assert(kSmemBytes <= 232448, "shared memory");

// wgmma's K-major no-swizzle layout for a 128 x 8 tf32 tile: core matrices of 8
// rows x 16 bytes (4 values), the two along K 128 bytes apart (leading byte
// offset), consecutive groups of 8 rows 256 bytes apart (stride byte offset).
constexpr uint32_t kLBO = 128, kSBO = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrives and expects `bytes` more from the async proxy (a bulk copy) before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// A bulk copy of `bytes` contiguous bytes into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
// Arrives once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits for the phase of `parity` to complete. A wait of more than ~10 s (a
// broken protocol) traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) asm volatile("trap;");
  }
}
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) | ((uint64_t)(kSBO >> 4) << 32);
}

// d (64 x 128, f32) = a (64 x 8, tf32 registers) * b (8 x 128, tf32 in shared
// memory) + (kAdd ? d : 0).
template <int kAdd>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(kAdd));
}

// torch's adaptive pooling bounds: [floor(i * n / 4), ceil((i + 1) * n / 4)).
__host__ __device__ __forceinline__ int bin_lo(int i, int n) { return i * n / kPool; }
__host__ __device__ __forceinline__ int bin_hi(int i, int n) { return ((i + 1) * n + kPool - 1) / kPool; }

struct Geo {
  int b, h, w, th, tw;  // batch, image size, tiles down and across
  int tiles;            // pixel tiles (b * th * tw); work items: 2 * tiles (the channel halves)
  int vec;              // rows load as float4: w % 4 == 0 and x 16-byte aligned
};

struct Tile {
  int m, half, n, h0, w0;  // pixel tile m = (n * th + h0 / 2) * tw + w0 / 128: rows h0, h0 + 1
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int item) {
  Tile t;
  t.half = item & 1;
  t.m = item >> 1;
  t.n = t.m / (g.th * g.tw);
  t.h0 = 2 * ((t.m / g.tw) % g.th);
  t.w0 = kTileW * (t.m % g.tw);
  return t;
}

struct ExtractArgs {
  const float* x;     // (B, 128, H, W)
  const float* wt;    // (2, 144, 2, 128 x 8): each step's weights split into hi and lo, in wgmma's layout
  const float* bias;  // (256,)
  const float* gamma;
  const float* beta;
  const float* running_mean;
  const float* running_var;
  float eps;
  float* y;        // train: (B, 256, H, W)
  float2* stats;   // train: (256, tiles) per-tile (mean, M2)
  float* rows;     // eval: (tiles, 2, 256, 4) each tile row's part of each bin column
  float* rowsums;  // eval: (B * ceil(H / 2), 2, 256, 4) the parts summed over a row's tiles
  int* counters;   // eval: B * ceil(H / 2) tile rows' tiles done, then (B, 4) bin rows' tile rows done; zeroed
  float* out;      // eval: (B, 256, 4, 4)
};

// ---------------------------------------------------------------- producer

__device__ __forceinline__ void load_halo(const ExtractArgs& args, const Geo& g, const Tile& t, int cc, float* dst,
                                          int p) {
  const size_t plane = (size_t)g.h * g.w;
  const float* src = args.x + ((size_t)t.n * kCin + cc * kCk) * plane;
  if (g.vec) {
    // Interior: 8 channels x 4 rows x 32 float4, a warp on one row, 8 a thread.
    const int q = p & 31, hr = p >> 5;
    const int hh = t.h0 - 1 + hr, col = t.w0 + 4 * q;
    const bool ok = hh >= 0 && hh < g.h && col < g.w;
#pragma unroll
    for (int ci = 0; ci < kCk; ++ci) {
      const float* s = ok ? src + ci * plane + (size_t)hh * g.w + col : args.x;
      rgbd::cp_async16(dst + ci * kPS + hr * kRS + 4 + 4 * q, s, ok);
    }
    if (p < 64) {  // the halo columns w0 - 1 and w0 + 128
      const int ci = p >> 3, hr2 = (p >> 1) & 3, side = p & 1;
      const int hh2 = t.h0 - 1 + hr2, col2 = side ? t.w0 + kTileW : t.w0 - 1;
      const bool ok2 = hh2 >= 0 && hh2 < g.h && col2 >= 0 && col2 < g.w;
      const float* s = ok2 ? src + ci * plane + (size_t)hh2 * g.w + col2 : args.x;
      rgbd::cp_async4(dst + ci * kPS + hr2 * kRS + (side ? 4 + kTileW : 3), s, ok2);
    }
  } else {
    for (int e = p; e < kCk * 4 * (kTileW + 2); e += 128) {
      const int ci = e / (4 * (kTileW + 2)), rem = e % (4 * (kTileW + 2));
      const int hr = rem / (kTileW + 2), k = rem % (kTileW + 2);
      const int hh = t.h0 - 1 + hr, col = t.w0 - 1 + k;
      const bool ok = hh >= 0 && hh < g.h && col >= 0 && col < g.w;
      const float* s = ok ? src + ci * plane + (size_t)hh * g.w + col : args.x;
      rgbd::cp_async4(dst + ci * kPS + hr * kRS + 3 + k, s, ok);
    }
  }
}

__device__ void producer(const ExtractArgs& args, const Geo& g, float* smem, uint64_t* a_full, uint64_t* a_empty,
                         uint64_t* b_full, uint64_t* b_empty) {
  const int p = threadIdx.x - 256;
  const int items = 2 * g.tiles;
  const int mine = blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * kSteps;
  for (int s = 0; s < total; ++s) {
    const int k = s % kSteps;
    if (k % 9 != 0 && p != 0) continue;
    const Tile t = tile_of(g, blockIdx.x + s / kSteps * gridDim.x);
    if (k % 9 == 0) {  // a chunk's halo, by every producer thread
      const int a = s / 9, slot = a % kNA;
      mbar_wait(&a_empty[slot], ((a / kNA) & 1) ^ 1);
      load_halo(args, g, t, k / 9, smem + kOffA + slot * kHalo, p);
      mbar_arrive_cp_async(&a_full[slot]);
    }
    if (p == 0) {  // the step's hi and lo weight tiles, one bulk copy
      const int slot = s % kNB;
      mbar_wait(&b_empty[slot], ((s / kNB) & 1) ^ 1);
      mbar_expect_tx(&b_full[slot], 2 * kBTile * 4);
      bulk_copy(smem + kOffB + slot * 2 * kBTile, args.wt + (size_t)(t.half * kSteps + k) * 2 * kBTile,
                2 * kBTile * 4, &b_full[slot]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The weights for the producer's bulk copies: for each channel half and k8
// step (chunk cc, tap rs), the 128 x 8 tile w[n, 8 cc + ci, rs] split into hi
// and lo, each in wgmma's K-major no-swizzle layout (row n at core matrix
// (n / 8, k half), row n % 8). One thread per (half, step, n).
__global__ void __launch_bounds__(256) prep_kernel(const float* w, float* wt) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= 2 * kSteps * kBN) return;
  const int row = idx % kBN, step = idx / kBN % kSteps, half = idx / (kBN * kSteps);
  const int cc = step / 9, rs = step % 9;
  const float* src = w + ((size_t)(half * kBN + row) * kCin + cc * kCk) * 9 + rs;
  uint32_t hi[8], lo[8];
#pragma unroll
  for (int ci = 0; ci < kCk; ++ci) rgbd::split_tf32_alu(src[9 * ci], hi[ci], lo[ci]);
  float* dst = wt + (size_t)(half * kSteps + step) * 2 * kBTile + (row >> 3) * 64 + (row & 7) * 4;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + 32) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  *reinterpret_cast<uint4*>(dst + kBTile) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dst + kBTile + 32) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
}

// ---------------------------------------------------------------- consumers

// Sum over the 8 lanes of a warp that share lane % 4 (the fragment rows).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Pins registers that an asynchronous wgmma writes: no access moves across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(r[e])::"memory");
}

// One subtile's fragment of a k8 step, split: a0 (gr, tq), a1 (gr + 8, tq),
// a2 (gr, tq + 4), a3 (gr + 8, tq + 4), channels 4 planes apart.
__device__ __forceinline__ void load_split(const float* f, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {f[0], f[8], f[4 * kPS], f[4 * kPS + 8]};
  rgbd::split_tf32_alu(v, hi, lo);
}

// The two consumer warpgroups take turns on the tensor cores: each issues a
// subtile's products after the other has issued its own (named barriers 2 and
// 3), then adds them into acc while the other's run.
__device__ __forceinline__ void turn_wait(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory"); }
__device__ __forceinline__ void turn_pass(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory"); }

// Fragment e of n8 block jb of subtile i holds channel 8 jb + 2 tq + (e & 1)
// of pixel 64 i + 16 warp + gr + 8 (e >> 1) of the tile's row wg.
template <bool kEval>
__device__ void consumer(const ExtractArgs& args, const Geo& g, float* smem, uint64_t* a_full, uint64_t* a_empty,
                         uint64_t* b_full, uint64_t* b_empty) {
  const int wg = threadIdx.x >> 7;  // the tile's row
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int ctid = threadIdx.x;  // 0..255
  float* red = smem + kOffRed;
  const float* coef = smem + kOffCoef;  // per channel: bias, mean, scale, shift
  float* smean = smem + kOffMean;
  int* flag = reinterpret_cast<int*>(smem + kOffFlag);
  const int items = 2 * g.tiles;
  // This thread's A fragment in an A stage, and the B ring's descriptors.
  const float* a_frag = smem + kOffA + tq * kPS + wg * kRS + 16 * warp + gr + 3;
  const uint64_t b_desc0 = b_desc(smem + kOffB);
  constexpr uint64_t kLo = kBTile * 4 / 16, kSlot = 2 * kBTile * 4 / 16;  // descriptor steps, 16-byte units
  int chunks = 0, bslot = 0, bphase = 0;  // A chunks taken; B ring position (pairs of slots)
  if (wg == 1) turn_pass(1);              // warpgroup 0 goes first
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Tile t = tile_of(g, item);
    float acc[2][64], part[64];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
    // Two k8 steps (s, s + 1) at a time. Each subtile's sum of the pair
    // starts from 0 with the four small products (lo*hi, hi*lo), then the
    // two hi*hi, and goes into acc with a round-to-nearest add. The tensor
    // cores' additions truncate: chained over a tile's 432 products they
    // would shrink every output by ~1e-5; so ordered, a pair truncates about
    // 1.5x as much as one step alone, at the pair's own magnitude.
    for (int s = 0; s < kSteps; s += 2) {
      const int rs0 = s % 9, rs1 = (s + 1) % 9;
      const int a0 = chunks + s / 9, a1 = chunks + (s + 1) / 9;
      if (rs0 == 0) mbar_wait(&a_full[a0 % kNA], (a0 / kNA) & 1);
      if (rs1 == 0) mbar_wait(&a_full[a1 % kNA], (a1 / kNA) & 1);
      mbar_wait(&b_full[bslot], bphase);
      mbar_wait(&b_full[bslot + 1], bphase);
      const float* f0 = a_frag + a0 % kNA * kHalo + (rs0 / 3) * kRS + rs0 % 3;
      const float* f1 = a_frag + a1 % kNA * kHalo + (rs1 / 3) * kRS + rs1 % 3;
      const uint64_t dh0 = b_desc0 + (uint64_t)bslot * kSlot, dh1 = dh0 + kSlot;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t hi0[4], lo0[4], hi1[4], lo1[4];
        load_split(f0 + 64 * i, hi0, lo0);
        load_split(f1 + 64 * i, hi1, lo1);
        if (i == 1 && (rs0 == 8 || rs1 == 8)) {  // a chunk's last fragments are in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(&a_empty[(rs0 == 8 ? a0 : a1) % kNA]);
        }
        fence_regs(part);
        turn_wait(wg);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32<0>(part, lo0, dh0);
        wgmma_tf32<1>(part, hi0, dh0 + kLo);
        wgmma_tf32<1>(part, lo1, dh1);
        wgmma_tf32<1>(part, hi1, dh1 + kLo);
        wgmma_tf32<1>(part, hi0, dh0);
        wgmma_tf32<1>(part, hi1, dh1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        turn_pass(wg);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(part);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[i][e] += part[e];
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&b_empty[bslot]);
        mbar_arrive(&b_empty[bslot + 1]);
      }
      if ((bslot += 2) == kNB) {
        bslot = 0;
        bphase ^= 1;
      }
    }
    chunks += kChunks;

    // Epilogue.
    const int hrow = t.h0 + wg;
    const bool row_ok = hrow < g.h;
    const int cols = min(kTileW, g.w - t.w0);
    const int cbase = t.half * kBN;
    if (!kEval) {
      const int count = min(2, g.h - t.h0) * cols;
      const size_t plane = (size_t)g.h * g.w;
      float* yrow = args.y + ((size_t)t.n * kCout + cbase) * plane + (size_t)hrow * g.w + t.w0;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = 8 * jb + 2 * tq + par;
          const float bias = coef[4 * (cbase + c)];
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int px = 64 * i + 16 * warp + gr + 8 * hf;
              const float v = acc[i][4 * jb + 2 * hf + par] + bias;
              acc[i][4 * jb + 2 * hf + par] = v;
              if (row_ok && px < cols) {
                yrow[(size_t)c * plane + px] = v;
                sum += v;
              }
            }
          sum = row_sum(sum);
          if (gr == 0) red[(wg * 4 + warp) * kBN + c] = sum;
        }
      consumer_sync();
      if (ctid < kBN) {
        float tot = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) tot += red[k * kBN + ctid];
        smean[ctid] = tot / (float)count;
      }
      consumer_sync();
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = 8 * jb + 2 * tq + par;
          const float mu = smean[c];
          float m2 = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float dv = acc[i][4 * jb + 2 * hf + par] - mu;
              if (row_ok && 64 * i + 16 * warp + gr + 8 * hf < cols) m2 += dv * dv;
            }
          m2 = row_sum(m2);
          if (gr == 0) red[(wg * 4 + warp) * kBN + c] = m2;
        }
      consumer_sync();
      if (ctid < kBN) {
        float tot = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) tot += red[k * kBN + ctid];
        args.stats[(size_t)(cbase + ctid) * g.tiles + t.m] = make_float2(smean[ctid], tot);
      }
      consumer_sync();
    } else {
      // z = relu((y - mean) * scale + shift), 0 outside the image.
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const float* k4 = coef + 4 * (cbase + 8 * jb + 2 * tq + par);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int px = 64 * i + 16 * warp + gr + 8 * hf;
              const float v = acc[i][4 * jb + 2 * hf + par] + k4[0];
              acc[i][4 * jb + 2 * hf + par] = row_ok && px < cols ? fmaxf((v - k4[1]) * k4[2] + k4[3], 0.f) : 0.f;
            }
        }
      // Each bin column's part of each of the tile's rows, per channel.
      for (int j = 0; j < kPool; ++j) {
        const int lo = max(bin_lo(j, g.w) - t.w0, 0), hi = min(bin_hi(j, g.w) - t.w0, cols);
        if (lo >= hi) continue;
#pragma unroll
        for (int jb = 0; jb < 16; ++jb)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int px = 64 * i + 16 * warp + gr + 8 * hf;
                if (px >= lo && px < hi) sum += acc[i][4 * jb + 2 * hf + par];
              }
            sum = row_sum(sum);
            if (gr == 0) red[((wg * 4 + warp) * 4 + j) * kBN + 8 * jb + 2 * tq + par] = sum;
          }
      }
      consumer_sync();
      {
        const int row = ctid >> 7, c = ctid & (kBN - 1);
        float part4[4];
#pragma unroll
        for (int j = 0; j < kPool; ++j) {
          const int lo = max(bin_lo(j, g.w) - t.w0, 0), hi = min(bin_hi(j, g.w) - t.w0, cols);
          float tot = 0.f;
          if (lo < hi) {
#pragma unroll
            for (int k = 0; k < 4; ++k) tot += red[((row * 4 + k) * 4 + j) * kBN + c];
          }
          part4[j] = tot;
        }
        reinterpret_cast<float4*>(args.rows)[((size_t)t.m * 2 + row) * kCout + cbase + c] =
            make_float4(part4[0], part4[1], part4[2], part4[3]);
      }
      // The last tile of a tile row (two image rows) sums the row's tiles'
      // parts; the last tile row of an (image, bin row) sums its rows' and
      // writes those bins. Integer counters pick the last; the sums run in
      // a fixed order.
      __threadfence();
      consumer_sync();
      const int trow = t.m / g.tw;  // n * th + h0 / 2
      if (ctid == 0) flag[0] = atomicAdd(&args.counters[trow], 1) == 2 * g.tw - 1;
      consumer_sync();
      if (flag[0]) {
        __threadfence();
        const float4* rows = reinterpret_cast<const float4*>(args.rows) + ctid;
        float4* rowsum = reinterpret_cast<float4*>(args.rowsums) + ctid;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int tc = 0; tc < g.tw; ++tc) {
            const float4 v = __ldcg(rows + ((size_t)(trow * g.tw + tc) * 2 + r) * kCout);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          rowsum[((size_t)trow * 2 + r) * kCout] = sum;
        }
        __threadfence();
        consumer_sync();
        if (ctid == 0) {
          const int rlast = min(t.h0 + 1, g.h - 1);
          for (int i = 0; i < kPool; ++i) {
            const int r0 = bin_lo(i, g.h), r1 = bin_hi(i, g.h);
            int last = 0;
            if (t.h0 < r1 && rlast >= r0)
              last = atomicAdd(&args.counters[g.b * g.th + t.n * kPool + i], 1) == (r1 - 1) / 2 - r0 / 2;
            flag[1 + i] = last;
          }
        }
        consumer_sync();
        for (int i = 0; i < kPool; ++i) {
          if (!flag[1 + i]) continue;
          __threadfence();
          const int r0 = bin_lo(i, g.h), r1 = bin_hi(i, g.h), c = ctid;
          const float4* rs = reinterpret_cast<const float4*>(args.rowsums) + c;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int hh = r0; hh < r1; ++hh) {
            const float4 v = __ldcg(rs + ((size_t)(t.n * g.th + hh / 2) * 2 + (hh & 1)) * kCout);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          const float part4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int j = 0; j < kPool; ++j)
            args.out[(((size_t)t.n * kCout + c) * kPool + i) * kPool + j] =
                part4[j] / (float)((r1 - r0) * (bin_hi(j, g.w) - bin_lo(j, g.w)));
        }
      }
      consumer_sync();
    }
  }
}

template <bool kEval>
__global__ void __launch_bounds__(kThreads, 1) extract_kernel(const ExtractArgs args, const Geo g) {
  extern __shared__ __align__(1024) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t *a_full = bars, *a_empty = bars + kNA, *b_full = bars + 2 * kNA, *b_empty = bars + 2 * kNA + kNB;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kNA; ++i) {
      mbar_init(&a_full[i], 128);
      mbar_init(&a_empty[i], 8);
    }
    for (int i = 0; i < kNB; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Per channel: bias, and the eval-mode normalisation (running mean, scale, shift).
  for (int c = threadIdx.x; c < kCout; c += kThreads) {
    float* k4 = smem + kOffCoef + 4 * c;
    k4[0] = args.bias[c];
    if (kEval) {
      k4[1] = args.running_mean[c];
      k4[2] = (float)((double)args.gamma[c] / sqrt((double)args.running_var[c] + (double)args.eps));
      k4[3] = args.beta[c];
    }
  }
  __syncthreads();
  // Each SM quarter holds one warp of each warpgroup: 3 x 32 x 168 registers
  // at launch, 2 x 32 x 232 + 32 x 40 after the moves.
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    producer(args, g, smem, a_full, a_empty, b_full, b_empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consumer<kEval>(args, g, smem, a_full, a_empty, b_full, b_empty);
  }
}

// ---------------------------------------------------------------- train: statistics and apply

// (n, mean, M2) += (nb, mb, m2b), Chan et al.'s pairwise update.
__device__ __forceinline__ void chan(double& n, double& mean, double& m2, double nb, double mb, double m2b) {
  if (nb == 0.0) return;
  const double tot = n + nb, d = mb - mean;
  mean += d * (nb / tot);
  m2 += m2b + d * d * (n * nb / tot);
  n = tot;
}

// One block per channel: the tiles' partials in a fixed order (a strided run
// per thread, then a tree), in float64.
__global__ void __launch_bounds__(256) stats_kernel(const float2* stats, Geo g, double* moments) {
  __shared__ double sn[256], sm[256], s2[256];
  const int c = blockIdx.x, k = threadIdx.x;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int m = k; m < g.tiles; m += 256) {
    const int h0 = 2 * ((m / g.tw) % g.th), w0 = kTileW * (m % g.tw);
    const double cnt = (double)(min(2, g.h - h0) * min(kTileW, g.w - w0));
    const float2 v = stats[(size_t)c * g.tiles + m];
    chan(n, mean, m2, cnt, (double)v.x, (double)v.y);
  }
  sn[k] = n;
  sm[k] = mean;
  s2[k] = m2;
  __syncthreads();
  for (int stride = 128; stride > 0; stride >>= 1) {
    if (k < stride) {
      double a = sn[k], b = sm[k], d = s2[k];
      chan(a, b, d, sn[k + stride], sm[k + stride], s2[k + stride]);
      sn[k] = a;
      sm[k] = b;
      s2[k] = d;
    }
    __syncthreads();
  }
  if (k != 0) return;
  n = sn[0];
  mean = sm[0];
  m2 = s2[0];
  moments[3 * c] = n;
  moments[3 * c + 1] = mean;
  moments[3 * c + 2] = m2;
}

// The BatchNorm's finalize and the bins, one block per (bin row, channel,
// image): from the batch's (count, mean, M2) the biased variance, then
// relu((y - mean) * scale + shift) over the bin row's rows, summed into its 4
// bins in a fixed order. The first bin row's block of the first image moves
// the channel's running statistics (momentum, the unbiased variance), channel
// 0's adds 1 to num_batches_tracked.
__global__ void __launch_bounds__(256) apply_kernel(const float* y, const double* moments, const float* gamma,
                                                    const float* beta, float* running_mean, float* running_var,
                                                    long long* tracked, float momentum, float eps, float* out, int h,
                                                    int w, int vec) {
  __shared__ float part[8][kPool];
  __shared__ float coef[3];
  const int i = blockIdx.x, c = blockIdx.y, n = blockIdx.z;
  const int r0 = bin_lo(i, h), r1 = bin_hi(i, h);
  const float* slab = y + ((size_t)n * kCout + c) * h * w + (size_t)r0 * w;
  const int len = (r1 - r0) * w;
  if (threadIdx.x == 0) {
    const double cnt = moments[3 * c], mu = moments[3 * c + 1], m2 = moments[3 * c + 2];
    coef[0] = (float)mu;
    coef[1] = (float)((double)gamma[c] / sqrt(m2 / cnt + (double)eps));
    coef[2] = beta[c];
    if (i == 0 && n == 0) {
      running_mean[c] = momentum * (float)mu + (1.f - momentum) * running_mean[c];
      running_var[c] = momentum * (float)(m2 / (cnt - 1.0)) + (1.f - momentum) * running_var[c];
      if (c == 0) *tracked += 1;
    }
  }
  __syncthreads();
  const float mean = coef[0], scale = coef[1], shift = coef[2];
  int lo[kPool], hi[kPool];
#pragma unroll
  for (int j = 0; j < kPool; ++j) {
    lo[j] = bin_lo(j, w);
    hi[j] = bin_hi(j, w);
  }
  float sum[kPool] = {0.f, 0.f, 0.f, 0.f};
  auto add = [&](float v, int col) {
    const float z = fmaxf((v - mean) * scale + shift, 0.f);
#pragma unroll
    for (int j = 0; j < kPool; ++j)
      if (col >= lo[j] && col < hi[j]) sum[j] += z;
  };
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(slab);
    for (int q = threadIdx.x; q < len / 4; q += 256) {
      const float4 v = s4[q];
      const int col = (4 * q) % w;
      add(v.x, col);
      add(v.y, col + 1);
      add(v.z, col + 2);
      add(v.w, col + 3);
    }
  } else {
    for (int q = threadIdx.x; q < len; q += 256) add(slab[q], q % w);
  }
#pragma unroll
  for (int j = 0; j < kPool; ++j) {
    float v = sum[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kPool) {
    const int j = threadIdx.x;
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) tot += part[k][j];
    out[(((size_t)n * kCout + c) * kPool + i) * kPool + j] = tot / (float)((r1 - r0) * (hi[j] - lo[j]));
  }
}

Geo geometry(int b, int h, int w) {
  Geo g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.th = (h + 1) / 2;
  g.tw = (w + kTileW - 1) / kTileW;
  g.tiles = b * g.th * g.tw;
  g.vec = 0;
  return g;
}

}  // namespace

// The products kernel, after the weights' split (two kernels, one call): x
// (B, 128, H, W), weight (256, 128, 3, 3), wt (2, 144, 2, 1024) its split copy.
// Train (eval = 0): y (B, 256, H, W) and the per-tile
// statistics stats (256, tiles) as (mean, M2). Eval: out (B, 256, 4, 4) from
// the running statistics, through rows (tiles, 2, 256, 4), rowsums (B *
// ceil(H / 2), 2, 256, 4) and counters (B * ceil(H / 2) + 4 B), zeroed.
// tiles = B * ceil(H / 2) * ceil(W / 128).
extern "C" int rgbd_edsam_extract(const void* x, const void* weight, void* wt, const void* bias, const void* gamma,
                                  const void* beta, const void* running_mean, const void* running_var, float eps,
                                  void* y, void* stats, void* rows, void* rowsums, void* counters, void* out, int b,
                                  int h, int w,
                                  int eval, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  Geo g = geometry(b, h, w);
  g.vec = w % 4 == 0 && (uintptr_t)x % 16 == 0;
  if ((long long)g.tiles * 2 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  ExtractArgs a{(const float*)x,           (const float*)wt,           (const float*)bias, (const float*)gamma,
                (const float*)beta,        (const float*)running_mean, (const float*)running_var,
                eps,                       (float*)y,                  (float2*)stats,     (float*)rows,
                (float*)rowsums,           (int*)counters,             (float*)out};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = 2 * g.tiles < sms ? 2 * g.tiles : sms;
  prep_kernel<<<(2 * kSteps * kBN + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)weight, (float*)wt);
  // Set on every call: the attributes belong to the current device.
  if (eval) {
    e = cudaFuncSetAttribute(extract_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    extract_kernel<true><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a, g);
  } else {
    e = cudaFuncSetAttribute(extract_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    extract_kernel<false><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a, g);
  }
  return (int)cudaGetLastError();
}

// Train: the batch statistics from the per-tile partials, moments (256, 3) as
// (count, mean, M2) in float64. A data-parallel step sums them over the data
// group before the apply kernel reads them.
extern "C" int rgbd_edsam_extract_stats(const void* stats, void* moments, int b, int h, int w, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const Geo g = geometry(b, h, w);
  stats_kernel<<<kCout, 256, 0, (cudaStream_t)stream>>>((const float2*)stats, g, (double*)moments);
  return (int)cudaGetLastError();
}

// Train: out (B, 256, 4, 4) = the bins of relu((y - mean) * scale + shift)
// from the moments, gamma and beta; the running statistics (float32) and
// num_batches_tracked (int64) updated in place as BatchNorm2d updates them.
extern "C" int rgbd_edsam_extract_apply(const void* y, const void* moments, const void* gamma, const void* beta,
                                        void* running_mean, void* running_var, void* tracked, void* out, int b,
                                        int h, int w, float momentum, float eps, void* stream) {
  if (b == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const int vec = w % 4 == 0 && (uintptr_t)y % 16 == 0;
  apply_kernel<<<dim3(kPool, kCout, b), 256, 0, (cudaStream_t)stream>>>(
      (const float*)y, (const double*)moments, (const float*)gamma, (const float*)beta, (float*)running_mean,
      (float*)running_var, (long long*)tracked, momentum, eps, (float*)out, h, w, vec);
  return (int)cudaGetLastError();
}
