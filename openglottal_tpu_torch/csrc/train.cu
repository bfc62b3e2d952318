// Training kernels of the port (ops/train_cuda.py binds them with ctypes).
//
// None replaces a Pallas kernel: the JAX package's training path has none
// (XLA fuses all of it), so these are the port's own additions, each with a
// plain PyTorch version beside its wrapper.
//
//   og_unet_augment  <- openglottal_tpu/data/augment.py:112 (augment_batch):
//       per sample, the inverse-affine bilinear image gather and nearest
//       mask gather (zero fill), noise and clip, the 5-tap reflect-101
//       separable blur, brightness, then contrast against the image's mean.
//       Bound by bytes: u8 frame and mask, f32 noise read once, f32 image
//       and mask written once (14.7 MB at batch 16 of 256²: 4.4 us at 3.35
//       TB/s).  One launch; a sample is a cluster of 8 blocks of 512
//       threads, a block 32 output rows, two blocks an SM (108,736 bytes of
//       shared memory each), so that the card holds 16 clusters at once:
//       - the sample's u8 frame is staged whole in every block's shared
//         memory, in rows of 272 bytes with a zero border (2 rows above and
//         below, 16 bytes left of each row).  Each block issues the TMA
//         bulk copies of its own 32 rows and multicasts them to the
//         cluster, so the cluster reads the frame once.  The four bilinear
//         gathers read shared memory with no bounds test: a source
//         coordinate is clamped into the border, whose zeros are the zero
//         fill.  The nearest mask sample (one a pixel) is read from global
//         memory;
//       - (k - c) / scale for k = 0..255 is one table a block that serves
//         both axes (no division a pixel);
//       - the block computes its 36 rows (2 halo rows each side feed the
//         blur) of gather and noise into shared memory, the blur's two
//         passes in place over them, and keeps its own pixels in
//         registers;
//       - the image's mean: each 16-row tile sums each column over its 16
//         rows in order, the warps' __shfl_down trees (16, 8, 4, 2, 1) add
//         32 columns, the 8 warps of a tile are added in order; the 16 tile
//         partials cross the cluster through distributed shared memory and
//         are added in tile order, then divided by 65,536.  This is the
//         association of the earlier two-launch form (a tile pass, then a
//         contrast pass), so the bits are the same;
//       - each block applies the contrast and stores each pixel once.
//   og_bce_dice      <- openglottal_tpu/train/unet_trainer.py:49 (_loss_fn)
//       and :89 (unet_eval_loss_masked): sum BCE, sum sigma*t, sum sigma,
//       sum t over the valid rows, then the loss.  Bound by bytes (8.4 MB
//       forward at batch 16: 2.5 us).  One launch of `blocks` blocks of
//       256 threads: element i goes to thread i mod (blocks*256), which
//       adds its elements in order of i; each block adds its threads by the
//       warps' __shfl_down trees and its 8 warps in order.  Each of those
//       (logical) threads is two threads of a 512-thread block: of each 16
//       of its elements, the second computes the terms of the last 8 and
//       passes them through shared memory, the first computes the first 8
//       and adds all 16 in order.  A thread loads its 8 elements before
//       their arithmetic; a masked call steps the element's row with the
//       stride (one division a thread per 16 elements, not one an
//       element); log1p(exp(-|x|)) serves both log-sigmoids.  The last
//       block to finish (an atomic ticket taken after a release fence) adds
//       the blocks' partials in double in a fixed order and forms the
//       loss.  The ticket is the word after the blocks' partials in
//       `partial`, zero at every launch (the last block resets it).  So a
//       launch owns its `partial` until it ends: launches that may overlap
//       (on different streams) each take their own; launches on one stream
//       run one after another and may share one.  The wrapper keeps one
//       zeroed buffer for each device and stream.
//   og_bce_dice_bwd  the loss's gradient, one elementwise pass from the
//       saved sums.  Bound by bytes (12.6 MB at batch 16: 3.8 us).  A
//       thread loads two 16-byte groups of x and two of t before any
//       arithmetic and stores its gradient 16 bytes at a time; the grid is
//       one pass where the card holds it (SMs x resident blocks at most).
//       A masked call steps the row with the stride (no division an
//       element).  The last n mod 4 elements, and every element where x, t
//       and the gradient are not all 16-byte aligned, go one at a time.
//       Each element's rounded operations and their order are fixed (the
//       trainers' bits depend on them); three divisions are made cheaper
//       with the same bits: 1 / y as
//       __frcp_rn, the division by a count that is a power of two as a
//       product by its exact reciprocal, and 2t / D for t = 0 and t = 1
//       (the mask's values) from none or one division a thread.
//   og_tal_assign    <- openglottal_tpu/train/yolo_loss.py:98-133: the
//       task-aligned assignment, one block of 16 warps an image.
//       Latency-bound (its bytes take 0.2 us, an empty launch of its grid
//       ~1.9 us): two block barriers in all, none a round.
//       (1) each warp copies the M <= 8 gts for itself; every thread loads
//       3 anchors' logit, centre and box before any arithmetic and, for
//       each gt, tests them inside it; where no lane of the warp has an
//       anchor inside, or none intersecting the gt, the warp skips the
//       rest.  Otherwise it forms the align metric (sigma's square root
//       once an anchor, shared by the gts) and appends the positive (align
//       bits, anchor) pairs to its own region of the gt's candidate list
//       in shared memory by a ballot, its count in a register (no
//       atomics; 38,208 bytes with the claim bytes at M = 4, A = 1,344).
//       No intersection, no division by it: an IEEE division of 0 takes
//       its slow path.  (2) warp m alone selects gt m's top 10, from the
//       16 regions read as one list: each lane keeps its candidates' top
//       10 by (value, lower anchor) in registers and each round takes the
//       warp's best by __reduce_max_sync on the value bits (they order as
//       the values, all > 0) and __reduce_min_sync on the anchor, so the M
//       selections run at once; each taken anchor's claim byte gets bit m.
//       (3) the lane of each taken anchor's lowest gt resolves it among
//       the gts in its claim byte (first largest; one gt needs no lookup)
//       and writes its soft target; the other anchors were written as
//       unassigned in (1).  The bits are fixed (the trainers' depend on
//       them): the plain version's rounded operations on the same inputs
//       (1 / y as __frcp_rn, correctly rounded as __fdiv_rn(1, y) is) and
//       its selection's order (value descending, ties to the lower anchor,
//       only values > 0; the first gt with the largest value).
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn /
// __fmaf_rn, so nvcc contracts nothing; the forms are the plain versions'
// (ops/train_cuda.py), which are the JAX package's compiled forms.
//
// tools/train_cycles.py measures a copy of this file with clock64() marks
// at the kernels' barriers; nothing of it is kept here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 256;          // the augment's frame side
constexpr int TILE = 16;        // rows of a tile of the image's mean
constexpr int NP = 16;          // per-sample parameter row
constexpr int THREADS = 256;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ int reflect101(int i) {
  return i < 0 ? -i : (i >= S ? 2 * S - 2 - i : i);
}

__device__ __forceinline__ float warp_tree(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;   // valid in lane 0
}

// ── cluster, mbarrier and TMA helpers ───────────────────────────────────

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// All threads of every block of the cluster arrive (and wait); shared-memory
// writes before the arrival are visible to every block after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The float at `p` (this block's shared memory) in block `rank`'s shared
// memory.
__device__ __forceinline__ float ld_rank(const float* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(r)
               : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed; traps (the launch
// fails) rather than spin for ever should the copies never land.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 24)) __trap();
  }
}

// `bytes` (a multiple of 16) from 16-B aligned global memory to the same
// 16-B aligned offset of the shared memory of every block in `ranks` (a mask
// of cluster ranks), each completing the bytes on its mbarrier at `bar`.
__device__ __forceinline__ void bulk_multicast(unsigned dst, const void* src,
                                               unsigned bytes, unsigned bar,
                                               unsigned short ranks) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(ranks)
      : "memory");
}

// ── og_unet_augment ─────────────────────────────────────────────────────

constexpr int AUG_RANKS = 8;                  // blocks of a sample's cluster
constexpr int AUG_ROWS = S / AUG_RANKS;       // output rows a block
constexpr int AUG_TILES = AUG_ROWS / TILE;    // mean tiles a block
constexpr int AUG_THREADS = 512;
constexpr int AUG_LANES = AUG_THREADS / S;    // threads a column
constexpr int AUG_HALO = 2;
constexpr int AUG_GROWS = AUG_ROWS + 2 * AUG_HALO;   // rows of gather
constexpr int AUG_PER_LANE = AUG_ROWS / AUG_LANES;   // output pixels kept
constexpr int AUG_HALO_PER_LANE = 2 * AUG_HALO / AUG_LANES;
// the staged frame: 2 zero rows above and below, each row 16 zero bytes then
// the 256 pixels (x = 256, 257 read the next row's zeros), 16 bytes of
// zeros after the last row
constexpr int FR_PAD = 16;
constexpr int FR_STRIDE = FR_PAD + S;                     // 272
constexpr int FR_BYTES = (S + 4) * FR_STRIDE + 16;        // 70,736
constexpr int FR_ROW_WORDS = FR_STRIDE / 4;
constexpr int FR_TOP_WORDS = 2 * FR_ROW_WORDS;            // rows 0, 1
constexpr int FR_BOTTOM_WORD = (S + 2) * FR_ROW_WORDS;    // rows 258, 259
constexpr int FR_BOTTOM_WORDS = FR_BYTES / 4 - FR_BOTTOM_WORD;
constexpr int FR_PAD_WORDS = FR_PAD / 4;
constexpr int FR_ZERO_WORDS =
    FR_TOP_WORDS + FR_BOTTOM_WORDS + S * FR_PAD_WORDS;
constexpr int AUG_G_OFF = FR_BYTES;                       // gather rows
constexpr int AUG_TAB_OFF = AUG_G_OFF + AUG_GROWS * S * 4;
constexpr int AUG_RED_OFF = AUG_TAB_OFF + S * 4;          // [tiles][8]
constexpr int AUG_PART_OFF = AUG_RED_OFF + AUG_TILES * 8 * 4;
constexpr int AUG_MEAN_OFF = AUG_PART_OFF + 16;
constexpr int AUG_BAR_OFF = AUG_MEAN_OFF + 16;
constexpr int AUG_SMEM = AUG_BAR_OFF + 16;                // 108,736 bytes
// two blocks an SM (1 KB of each SM's shared memory is the system's a
// block): the card holds 16 clusters at once only so
static_assert(2 * (AUG_SMEM + 1024) <= 233472, "the augment's shared memory");
static_assert(FR_BYTES % 16 == 0 && AUG_G_OFF % 16 == 0, "16-B alignment");

__global__ void __cluster_dims__(AUG_RANKS, 1, 1)
    __launch_bounds__(AUG_THREADS, 2)
augment_kernel(const uint8_t* __restrict__ imgs,
               const uint8_t* __restrict__ msks,
               const float* __restrict__ params,
               const float* __restrict__ noise, float* __restrict__ out_img,
               float* __restrict__ out_msk) {
  extern __shared__ __align__(16) unsigned char aug_smem[];
  uint8_t* const fimg = aug_smem;
  float* const g = reinterpret_cast<float*>(aug_smem + AUG_G_OFF);
  float* const tab = reinterpret_cast<float*>(aug_smem + AUG_TAB_OFF);
  float* const red = reinterpret_cast<float*>(aug_smem + AUG_RED_OFF);
  float* const part = reinterpret_cast<float*>(aug_smem + AUG_PART_OFF);
  float* const shmean = reinterpret_cast<float*>(aug_smem + AUG_MEAN_OFF);
  const unsigned bar = smem_addr(aug_smem + AUG_BAR_OFF);

  const int tid = threadIdx.x;
  const int x = tid % S, lane_row = tid / S;
  const int rank = blockIdx.x;          // the cluster spans the grid's x
  const int b = blockIdx.y, r0 = rank * AUG_ROWS;
  const float* p = params + (size_t)b * NP;
  const bool hf = p[0] != 0.f, vf = p[1] != 0.f;
  const float ct = p[2], st = p[3], sc = p[4];
  const bool dn = p[5] != 0.f, db = p[7] != 0.f;
  const float sig = p[6], br = p[13], cc = p[14];
  float k[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) k[d] = p[8 + d];
  const uint8_t* img = imgs + (size_t)b * S * S;
  const uint8_t* msk = msks + (size_t)b * S * S;
  const float* nz = noise + (size_t)b * S * S;
  const float inv255 = 1.f / 255.f;   // f32(1/255): XLA's form of / 255
  const float c = (S - 1) / 2.f;
  // (the same for every block of the grid: the samples are 65,536 bytes
  // apart)
  const bool tma = (reinterpret_cast<uintptr_t>(imgs) & 15) == 0;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // the frame's zero border, word by word
  unsigned* const fw = reinterpret_cast<unsigned*>(fimg);
  for (int i = tid; i < FR_ZERO_WORDS; i += AUG_THREADS) {
    int w = i;
    if (i >= FR_TOP_WORDS + FR_BOTTOM_WORDS) {
      const int q = i - FR_TOP_WORDS - FR_BOTTOM_WORDS;
      w = (q / FR_PAD_WORDS + 2) * FR_ROW_WORDS + q % FR_PAD_WORDS;
    } else if (i >= FR_TOP_WORDS) {
      w = FR_BOTTOM_WORD + i - FR_TOP_WORDS;
    }
    fw[w] = 0u;
  }
  if (tid < S) tab[tid] = __fdiv_rn(__fsub_rn((float)tid, c), sc);
  // the noise of this thread's rows, loaded ahead of the frame: its output
  // rows (g rows 2 ..), and with the blur its halo rows (g rows 0, 1 and
  // AUG_ROWS + 2, AUG_ROWS + 3)
  auto halo_row = [&](int h) {
    const int q = lane_row + h * AUG_LANES;
    return q < AUG_HALO ? q : AUG_ROWS + q;
  };
  float nv[AUG_PER_LANE], nh[AUG_HALO_PER_LANE];
#pragma unroll
  for (int j = 0; j < AUG_PER_LANE; ++j)
    nv[j] = dn ? nz[(r0 + lane_row + j * AUG_LANES) * S + x] : 0.f;
#pragma unroll
  for (int h = 0; h < AUG_HALO_PER_LANE; ++h)
    nh[h] = (dn && db) ? nz[reflect101(r0 - AUG_HALO + halo_row(h)) * S + x]
                       : 0.f;
  __syncthreads();
  // every block's mbarrier is initialised before any block's copies land
  // (its fence releases the initialisation; nothing else to release)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cluster_wait();
  if (tma) {
    if (tid == 0) mbar_expect(bar, (unsigned)(S * S));
    // lane 0 of each warp issues its rows' copies (a warp's lanes would
    // issue theirs one after another)
    if ((tid & 31) == 0)
      for (int row = r0 + (tid >> 5); row < r0 + AUG_ROWS;
           row += AUG_THREADS / 32)
        bulk_multicast(smem_addr(fimg + (row + 2) * FR_STRIDE + FR_PAD),
                       img + (size_t)row * S, S, bar,
                       (unsigned short)((1u << AUG_RANKS) - 1));
  } else {
    // an unaligned batch: every block reads the whole frame itself
    for (int i = tid; i < S * S; i += AUG_THREADS)
      fimg[(i / S + 2) * FR_STRIDE + FR_PAD + i % S] = img[i];
  }

  // ── the mask: the nearest samples of this thread's output rows from
  // global memory, their loads in flight while the frame lands
  const float xf = tab[x];
  {
    float mv[AUG_PER_LANE];
#pragma unroll
    for (int j = 0; j < AUG_PER_LANE; ++j) {
      const float yf = tab[r0 + lane_row + j * AUG_LANES];
      float sx = __fadd_rn(__fmaf_rn(ct, xf, -__fmul_rn(st, yf)), c);
      float sy = __fadd_rn(__fmaf_rn(st, xf, __fmul_rn(ct, yf)), c);
      if (hf) sx = __fsub_rn((float)(S - 1), sx);
      if (vf) sy = __fsub_rn((float)(S - 1), sy);
      // round half to even, zero outside
      const float yi = rintf(sy), xi = rintf(sx);
      const bool inb =
          yi >= 0.f && yi < (float)S && xi >= 0.f && xi < (float)S;
      const int ym = (int)fminf(fmaxf(yi, 0.f), (float)(S - 1));
      const int xm = (int)fminf(fmaxf(xi, 0.f), (float)(S - 1));
      mv[j] = inb ? (float)msk[ym * S + xm] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < AUG_PER_LANE; ++j)
      out_msk[((size_t)b * S + r0 + lane_row + j * AUG_LANES) * S + x] =
          mv[j];
  }
  __syncthreads();
  if (tma) mbar_wait(bar, 0);

  // ── gather and noise of g row `lr` (image row reflect101(r0 - 2 + lr))
  auto gather = [&](int lr, float nzv) {
    const float yf = tab[reflect101(r0 - AUG_HALO + lr)];
    float sx = __fadd_rn(__fmaf_rn(ct, xf, -__fmul_rn(st, yf)), c);
    float sy = __fadd_rn(__fmaf_rn(st, xf, __fmul_rn(ct, yf)), c);
    if (hf) sx = __fsub_rn((float)(S - 1), sx);
    if (vf) sy = __fsub_rn((float)(S - 1), sy);
    const float y0 = floorf(sy), x0 = floorf(sx);
    const float wy = __fsub_rn(sy, y0), wx = __fsub_rn(sx, x0);
    const float owy = __fsub_rn(1.f, wy), owx = __fsub_rn(1.f, wx);
    // a source pixel outside the frame reads the zero border
    const int yc = (int)fminf(fmaxf(y0, -2.f), (float)S);
    const int xc = (int)fminf(fmaxf(x0, -2.f), (float)S);
    const uint8_t* q = fimg + (yc + 2) * FR_STRIDE + FR_PAD + xc;
    const float v00 = __fmul_rn((float)q[0], inv255);
    const float v01 = __fmul_rn((float)q[1], inv255);
    const float v10 = __fmul_rn((float)q[FR_STRIDE], inv255);
    const float v11 = __fmul_rn((float)q[FR_STRIDE + 1], inv255);
    float v = __fmaf_rn(__fmul_rn(owy, owx), v00,
                        __fmul_rn(__fmul_rn(owy, wx), v01));
    v = __fmaf_rn(__fmul_rn(wy, owx), v10, v);
    v = __fmaf_rn(__fmul_rn(wy, wx), v11, v);
    if (dn) v = clamp01(__fmaf_rn(nzv, sig, v));
    g[lr * S + x] = v;
  };
#pragma unroll
  for (int j = 0; j < AUG_PER_LANE; ++j)
    gather(AUG_HALO + lane_row + j * AUG_LANES, nv[j]);
  if (db) {
#pragma unroll
    for (int h = 0; h < AUG_HALO_PER_LANE; ++h) gather(halo_row(h), nh[h]);
  }
  __syncthreads();

  // ── the blur's row pass (across rows), in place over the gather rows
  if (db) {
    float rr[AUG_PER_LANE];
#pragma unroll
    for (int j = 0; j < AUG_PER_LANE; ++j) {
      const int lr = lane_row + j * AUG_LANES;
      float acc = __fmaf_rn(k[0], g[lr * S + x],
                            __fmul_rn(k[1], g[(lr + 1) * S + x]));
#pragma unroll
      for (int d = 2; d < 5; ++d)
        acc = __fmaf_rn(k[d], g[(lr + d) * S + x], acc);
      rr[j] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < AUG_PER_LANE; ++j)
      g[(lane_row + j * AUG_LANES) * S + x] = rr[j];
    __syncthreads();
  }
  // ── its column pass and the brightness, kept in registers and, for the
  // mean, in place over rows 0 .. 31
  float vv[AUG_PER_LANE];
#pragma unroll
  for (int j = 0; j < AUG_PER_LANE; ++j) {
    const int lr = lane_row + j * AUG_LANES;
    float v;
    if (db) {
      const float* row = g + lr * S;
      v = __fmaf_rn(k[0], row[reflect101(x - 2)],
                    __fmul_rn(k[1], row[reflect101(x - 1)]));
#pragma unroll
      for (int d = 2; d < 5; ++d)
        v = __fmaf_rn(k[d], row[reflect101(x + d - 2)], v);
    } else {
      v = g[(lr + AUG_HALO) * S + x];
    }
    vv[j] = clamp01(__fmul_rn(v, br));
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < AUG_PER_LANE; ++j)
    g[(lane_row + j * AUG_LANES) * S + x] = vv[j];
  __syncthreads();

  // ── the image's mean, in the tiles' order
  {
    const int t = tid / S;
    float s = 0.f;
    for (int i = 0; i < TILE; ++i) s += g[(t * TILE + i) * S + x];
    s = warp_tree(s);
    if ((tid & 31) == 0) red[t * 8 + ((tid >> 5) & 7)] = s;
  }
  __syncthreads();
  if (tid < AUG_TILES) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[tid * 8 + w];
    part[tid] = s;
  }
  cluster_arrive();
  cluster_wait();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < AUG_RANKS; ++q)
      for (int t = 0; t < AUG_TILES; ++t) s += ld_rank(part + t, q);
    shmean[0] = __fdiv_rn(s, (float)(S * S));
  }
  __syncthreads();
  // no block leaves while another may still read its partials
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // ── contrast, one store a pixel
  const float off = __fmul_rn(__fsub_rn(1.f, cc), shmean[0]);
#pragma unroll
  for (int j = 0; j < AUG_PER_LANE; ++j) {
    const int lr = lane_row + j * AUG_LANES;
    out_img[((size_t)b * S + r0 + lr) * S + x] =
        clamp01(__fmaf_rn(cc, vv[j], off));
  }
  cluster_wait();
}

// ── og_bce_dice ─────────────────────────────────────────────────────────

constexpr int BCE_AHEAD = 16;    // elements of a logical thread a step
constexpr int BCE_HALF = BCE_AHEAD / 2;   // of them, computed by each of
constexpr int BCE_THREADS = 2 * THREADS;  // its two threads
constexpr int BCE_MAX_LAPS = 4;  // the finish's partials a thread, loaded
                                 // together (more are added as they come)

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// log_sigmoid(x) = -softplus(-x) = -(max(-x, 0) + log1p(exp(-|x|))), and
// log_sigmoid(-x) from the same log1p term (|-x| = |x|)
__device__ __forceinline__ float bce_of(float xi, float ti) {
  const float l = log1pf(expf(-fabsf(xi)));
  const float ls_pos = -__fadd_rn(fmaxf(-xi, 0.f), l);
  const float ls_neg = -__fadd_rn(fmaxf(xi, 0.f), l);
  return __fsub_rn(-__fmul_rn(ti, ls_pos),
                   __fmul_rn(__fsub_rn(1.f, ti), ls_neg));
}

__global__ void __launch_bounds__(BCE_THREADS, 2)
bce_dice_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const uint8_t* __restrict__ valid, float* __restrict__ partial,
                int rows, int per_row, float* __restrict__ out) {
  __shared__ float red[4][THREADS / 32];
  __shared__ double dred[4][THREADS];
  __shared__ float terms[BCE_HALF][4][THREADS];   // the second half's
  __shared__ unsigned char used[THREADS];         // its elements that count
  __shared__ int nvalid;
  __shared__ bool last;
  if (threadIdx.x == 0) nvalid = 0;
  // logical thread `lt` of the block (element i to logical thread i mod
  // (blocks * 256)); `half` 0 computes elements 0-7 of each 16 of it and
  // adds all 16, `half` 1 computes elements 8-15
  const int lt = threadIdx.x % THREADS, half = threadIdx.x / THREADS;
  const long long n = (long long)rows * per_row;
  const long long stride = (long long)gridDim.x * THREADS;
  long long step_row = 0, step_col = 0;
  if (valid != nullptr) {
    step_row = stride / per_row;
    step_col = stride % per_row;
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  // (the same trip count in every thread of the block)
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += BCE_AHEAD * stride) {
    const long long i = base + lt + half * BCE_HALF * stride;
    // the row and column of the next element, stepped by the stride's
    long long row = 0, col = 0;
    if (valid != nullptr && i < n) {
      row = i / per_row;
      col = i % per_row;
    }
    float xs[BCE_HALF], ts[BCE_HALF];
    bool on[BCE_HALF];
#pragma unroll
    for (int j = 0; j < BCE_HALF; ++j) {
      const long long e = i + j * stride;
      bool use = e < n;
      if (valid != nullptr) {
        use = use && valid[row] != 0;
        row += step_row;
        col += step_col;
        if (col >= per_row) {
          col -= per_row;
          ++row;
        }
      }
      on[j] = use;
      xs[j] = use ? x[e] : 0.f;
      ts[j] = use ? t[e] : 0.f;
    }
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < BCE_HALF; ++j) {
      const float xi = xs[j], ti = ts[j];
      const float bce = bce_of(xi, ti);
      const float pr = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-xi)));
      const float pt = __fmul_rn(pr, ti);
      if (half == 0) {
        if (on[j]) {
          s0 += bce;
          s1 += pt;
          s2 += pr;
          s3 += ti;
        }
      } else {
        m |= (unsigned)on[j] << j;
        terms[j][0][lt] = bce;
        terms[j][1][lt] = pt;
        terms[j][2][lt] = pr;
        terms[j][3][lt] = ti;
      }
    }
    if (half == 1) used[lt] = (unsigned char)m;
    __syncthreads();
    if (half == 0) {
      m = used[lt];
#pragma unroll
      for (int j = 0; j < BCE_HALF; ++j)
        if ((m >> j) & 1u) {
          s0 += terms[j][0][lt];
          s1 += terms[j][1][lt];
          s2 += terms[j][2][lt];
          s3 += terms[j][3][lt];
        }
    }
    __syncthreads();
  }
  const int w = threadIdx.x >> 5;
  // the blocks of this launch that have written their partials (the word
  // after them; zero between launches)
  unsigned* const ticket = reinterpret_cast<unsigned*>(partial) +
                           (size_t)gridDim.x * 4;
  if (half == 0) {
    s0 = warp_tree(s0);
    s1 = warp_tree(s1);
    s2 = warp_tree(s2);
    s3 = warp_tree(s3);
    if ((threadIdx.x & 31) == 0) {
      red[0][w] = s0;
      red[1][w] = s1;
      red[2][w] = s2;
      red[3][w] = s3;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int v = 0; v < THREADS / 32; ++v) s += red[j][v];
      partial[blockIdx.x * 4 + j] = s;
    }
    fence_acq_rel_gpu();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // ── the last block: the partials in double, in a fixed order (thread k
  // adds partials k, k + 256, ... from 0; then halves added onto the first)
  fence_acq_rel_gpu();
  if (threadIdx.x == 0) *ticket = 0u;
  if (threadIdx.x < THREADS) {
    float pl[4][BCE_MAX_LAPS];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int l = 0; l < BCE_MAX_LAPS; ++l) {
        const int q = threadIdx.x + l * THREADS;
        pl[j][l] = q < (int)gridDim.x ? __ldcg(partial + q * 4 + j) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      double a = 0.0;
#pragma unroll
      for (int l = 0; l < BCE_MAX_LAPS; ++l)
        if (threadIdx.x + l * THREADS < (int)gridDim.x) a += (double)pl[j][l];
      for (int q = threadIdx.x + BCE_MAX_LAPS * THREADS; q < (int)gridDim.x;
           q += THREADS)
        a += (double)__ldcg(partial + q * 4 + j);
      dred[j][threadIdx.x] = a;
    }
  }
  int nv = 0;
  for (int v = threadIdx.x; v < rows; v += BCE_THREADS)
    nv += valid ? (valid[v] != 0) : 1;
  if (nv) atomicAdd(&nvalid, nv);
  __syncthreads();
  for (int h = THREADS / 2; h > 16; h >>= 1) {
    if ((int)threadIdx.x < h)
      for (int j = 0; j < 4; ++j)
        dred[j][threadIdx.x] += dred[j][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    // the last five halvings within one warp: lane k adds lane k + h
    double a[4];
    for (int j = 0; j < 4; ++j) a[j] = dred[j][threadIdx.x];
    for (int h = 16; h > 0; h >>= 1)
      for (int j = 0; j < 4; ++j)
        a[j] += __shfl_down_sync(0xffffffffu, a[j], h);
    if (threadIdx.x == 0) {
      float s[4];
      for (int j = 0; j < 4; ++j) s[j] = (float)a[j];
      const float cnt = fmaxf((float)nvalid * (float)per_row, 1.f);
      const float eps = 1e-6f;
      const float bce = __fdiv_rn(s[0], cnt);
      const float num = __fadd_rn(__fmul_rn(2.f, s[1]), eps);
      const float den = __fadd_rn(__fadd_rn(s[2], s[3]), eps);
      const float dl = __fsub_rn(1.f, __fdiv_rn(num, den));
      for (int j = 0; j < 4; ++j) out[j] = s[j];
      out[4] = cnt;
      out[5] = __fadd_rn(__fmul_rn(0.5f, bce), __fmul_rn(0.5f, dl));
    }
  }
}

// ── og_bce_dice_bwd ─────────────────────────────────────────────────────

constexpr int BWD_THREADS = 256;
constexpr int BWD_AHEAD = 2;   // 16-byte groups of x and of t a thread loads
                               // before their arithmetic

// The launch's constants of the gradient: a = I / D², the count and, where
// they allow it, the divisions that need none: by a count that is a power
// of two (a product by its exact reciprocal rounds the same real number),
// and 2t / D at t = 0 (±0, D > 0) and t = 1 (2 / D, once a thread).
struct BwdConst {
  float a, D, cnt, g, inv_cnt, two_d;
  bool pow2, dpos;
};

// One element of the gradient, its rounded operations in their fixed order:
// g * (0.5 (p - t) / n + 0.5 (a - 2t / D) p (1 - p)), p = 1 / (1 + e^-x).
// 1 / y is __frcp_rn (correctly rounded as __fdiv_rn(1, y) is: the same
// bits); a division whose numerator is 0 would take the IEEE division's
// slow path.
__device__ __forceinline__ float bwd_elem(float xi, float ti,
                                          const BwdConst& k) {
  const float p = __frcp_rn(__fadd_rn(1.f, expf(-xi)));
  const float num = __fmul_rn(0.5f, __fsub_rn(p, ti));
  const float gb = k.pow2 ? __fmul_rn(num, k.inv_cnt) : __fdiv_rn(num, k.cnt);
  const float t2 = __fmul_rn(2.f, ti);
  float q;
  if (k.dpos && ti == 0.f) {
    q = t2;
  } else if (k.dpos && ti == 1.f) {
    q = k.two_d;
  } else {
    q = __fdiv_rn(t2, k.D);
  }
  const float gd = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, __fsub_rn(k.a, q)), p),
                             __fsub_rn(1.f, p));
  return __fmul_rn(__fadd_rn(gb, gd), k.g);
}

// Element i of x, t and grad: groups q < n4 as 16-byte vectors (thread j
// takes groups j, j + G, ... of the G = blocks * 256 threads, BWD_AHEAD of
// them loaded together), then elements 4 n4 .. n - 1 one at a time
// (n4 = 0 where the three pointers are not all 16-byte aligned).  A masked
// call steps each thread's row and column by the stride: one division a
// thread, none an element.
__global__ void __launch_bounds__(BWD_THREADS)
bce_dice_bwd(const float* __restrict__ x, const float* __restrict__ t,
             const uint8_t* __restrict__ valid, const float* __restrict__ sn,
             const float* __restrict__ gout, float* __restrict__ grad,
             long long n, int per_row, long long n4) {
  const float eps = 1e-6f;
  const float I = __fadd_rn(__fmul_rn(2.f, sn[1]), eps);
  BwdConst k;
  k.D = __fadd_rn(__fadd_rn(sn[2], sn[3]), eps);
  k.a = __fdiv_rn(I, __fmul_rn(k.D, k.D));
  k.cnt = sn[4];
  k.g = gout[0];
  const unsigned cb = __float_as_uint(k.cnt);
  k.pow2 = (cb & 0x807fffffu) == 0u && (cb >> 23) != 0u && (cb >> 23) != 255u;
  k.inv_cnt = __frcp_rn(k.cnt);
  k.dpos = k.D > 0.f && k.D < __uint_as_float(0x7f800000u);
  k.two_d = __fdiv_rn(2.f, k.D);
  const long long G = (long long)gridDim.x * BWD_THREADS;
  const long long q0 = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  float4* g4 = reinterpret_cast<float4*>(grad);
  // the row and column of this thread's next group's first element, and
  // the stride's (4 G elements)
  long long row = 0, srow = 0;
  int col = 0, scol = 0;
  if (valid != nullptr && q0 < n4) {
    row = 4 * q0 / per_row;
    col = (int)(4 * q0 % per_row);
    srow = 4 * G / per_row;
    scol = (int)(4 * G % per_row);
  }
  for (long long q = q0; q < n4; q += BWD_AHEAD * G) {
    float4 xv[BWD_AHEAD], tv[BWD_AHEAD];
    bool on[BWD_AHEAD][4];
#pragma unroll
    for (int j = 0; j < BWD_AHEAD; ++j) {
      const long long qj = q + j * G;
      const bool in = qj < n4;
      xv[j] = in ? x4[qj] : make_float4(0.f, 0.f, 0.f, 0.f);
      tv[j] = in ? t4[qj] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid == nullptr) {
        on[j][0] = on[j][1] = on[j][2] = on[j][3] = true;
      } else {
        if (col + 3 < per_row) {          // the group lies in one row
          const bool v = in && valid[row] != 0;
          on[j][0] = on[j][1] = on[j][2] = on[j][3] = v;
        } else {
          long long r = row;
          int c = col;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            on[j][k] = in && valid[r] != 0;
            if (++c == per_row) { c = 0; ++r; }
          }
        }
        row += srow;
        col += scol;
        if (col >= per_row) { col -= per_row; ++row; }
      }
    }
#pragma unroll
    for (int j = 0; j < BWD_AHEAD; ++j) {
      const long long qj = q + j * G;
      if (qj < n4) {
        float4 o;
        o.x = on[j][0] ? bwd_elem(xv[j].x, tv[j].x, k) : 0.f;
        o.y = on[j][1] ? bwd_elem(xv[j].y, tv[j].y, k) : 0.f;
        o.z = on[j][2] ? bwd_elem(xv[j].z, tv[j].z, k) : 0.f;
        o.w = on[j][3] ? bwd_elem(xv[j].w, tv[j].w, k) : 0.f;
        g4[qj] = o;
      }
    }
  }
  // the elements after the groups, one a thread a step
  const long long e0 = 4 * n4 + q0;
  if (e0 >= n) return;
  if (valid != nullptr) {
    row = e0 / per_row;
    col = (int)(e0 % per_row);
    srow = G / per_row;
    scol = (int)(G % per_row);
  }
  for (long long e = e0; e < n; e += G) {
    bool on = true;
    if (valid != nullptr) {
      on = valid[row] != 0;
      row += srow;
      col += scol;
      if (col >= per_row) { col -= per_row; ++row; }
    }
    grad[e] = on ? bwd_elem(x[e], t[e], k) : 0.f;
  }
}

// ── og_tal_assign ───────────────────────────────────────────────────────

constexpr int TOPK = 10;
constexpr int MAXM = 8;
constexpr int TAL_WARPS = 2 * MAXM;      // (the selection: a warp a gt)
constexpr int TAL_THREADS = 32 * TAL_WARPS;
constexpr int TAL_AHEAD = 3;   // anchors a thread loads before their
                               // arithmetic (3 x 512 >= 1,344, 256²'s A)
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ANCHOR = 0x7fffffff;

// The gt's intersection with a predicted box, and the IoU from it (union +
// 1e-7): the plain version's operations (box_iou), rounded one at a time.
__device__ __forceinline__ float tal_inter(float gx1, float gy1, float gx2,
                                           float gy2, float4 p) {
  const float iw = fmaxf(__fsub_rn(fminf(gx2, p.z), fmaxf(gx1, p.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(gy2, p.w), fmaxf(gy1, p.y)), 0.f);
  return __fmul_rn(iw, ih);
}

// (num: inter itself, or a stand-in where the quotient is not used)
__device__ __forceinline__ float tal_iou(float inter, float ag, float4 p,
                                         float num) {
  const float ap = __fmul_rn(fmaxf(__fsub_rn(p.z, p.x), 0.f),
                             fmaxf(__fsub_rn(p.w, p.y), 0.f));
  const float u = __fadd_rn(__fsub_rn(__fadd_rn(ag, ap), inter), 1e-7f);
  return __fdiv_rn(num, u);
}

__device__ __forceinline__ float tal_area(float gx1, float gy1, float gx2,
                                          float gy2) {
  return __fmul_rn(fmaxf(__fsub_rn(gx2, gx1), 0.f),
                   fmaxf(__fsub_rn(gy2, gy1), 0.f));
}

// (k1, a1) before (k2, a2): the larger value, then the lower anchor
__device__ __forceinline__ bool tal_before(unsigned k1, int a1, unsigned k2,
                                           int a2) {
  return k1 > k2 || (k1 == k2 && a1 < a2);
}

// dynamic shared memory: for each (gt, warp) a region of the candidates'
// align bits and their anchors (16 bits: A <= 65,535) the warp found, as
// many as the anchors it visits; then a claim byte an anchor (bit m: gt m
// took it) in 32-bit words
__host__ __device__ constexpr size_t tal_region(int a) {
  return 32 * (((size_t)a + TAL_THREADS - 1) / TAL_THREADS);
}
__host__ __device__ constexpr size_t tal_claim_off(int a, int m) {
  return ((size_t)m * TAL_WARPS * tal_region(a) *
              (sizeof(unsigned) + sizeof(uint16_t)) + 3) & ~3ull;
}
__host__ __device__ constexpr size_t tal_smem(int a, int m) {
  return tal_claim_off(a, m) + 4 * (((size_t)a + 3) / 4);
}

__global__ void __launch_bounds__(TAL_THREADS)
tal_assign_kernel(const float* __restrict__ cls, const float* __restrict__ pred,
                  const float* __restrict__ gt, const uint8_t* __restrict__ gtv,
                  const float* __restrict__ pts, int32_t* __restrict__ best_gt,
                  uint8_t* __restrict__ assigned, float* __restrict__ t_score,
                  int A, int M) {
  extern __shared__ __align__(16) unsigned char tal_smem_raw[];
  const int R = (int)tal_region(A);
  unsigned* const ck = reinterpret_cast<unsigned*>(tal_smem_raw);
  uint16_t* const ca =
      reinterpret_cast<uint16_t*>(ck + (size_t)M * TAL_WARPS * R);
  unsigned* const claim =
      reinterpret_cast<unsigned*>(tal_smem_raw + tal_claim_off(A, M));
  __shared__ float gbox[TAL_WARPS][MAXM][4];   // a copy a warp
  __shared__ int gok[TAL_WARPS][MAXM];
  __shared__ int take_n[MAXM];
  __shared__ int wcnt[MAXM][TAL_WARPS];   // the regions' counts
  __shared__ unsigned take_v[MAXM][TOPK];
  __shared__ int take_a[MAXM][TOPK];
  __shared__ float max_align[MAXM], max_iou[MAXM];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const float* const cb = cls + (size_t)b * A;
  const float* const pb = pred + (size_t)b * A * 4;
  const bool vec = (reinterpret_cast<uintptr_t>(pb) & 15) == 0;

  // ── (1) a thread's anchors a0 + k * TAL_THREADS + tid: logit, centre, box
  float xs[TAL_AHEAD], px[TAL_AHEAD], py[TAL_AHEAD];
  float4 box[TAL_AHEAD];
  auto load = [&](int a0) {
#pragma unroll
    for (int k = 0; k < TAL_AHEAD; ++k) {
      const int a = a0 + k * TAL_THREADS + tid;
      // (past the last anchor: zeros, on which the arithmetic is plain)
      xs[k] = px[k] = py[k] = 0.f;
      box[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a < A) {
        xs[k] = cb[a];
        px[k] = pts[2 * a];
        py[k] = pts[2 * a + 1];
        box[k] = vec ? reinterpret_cast<const float4*>(pb)[a]
                     : make_float4(pb[4 * a], pb[4 * a + 1], pb[4 * a + 2],
                                   pb[4 * a + 3]);
        // unassigned unless step (3) rewrites it
        const size_t o = (size_t)b * A + a;
        best_gt[o] = 0;
        assigned[o] = 0;
        t_score[o] = 0.f;
      }
    }
  };
  load(0);
  // the gts in the warp's own copy: no block barrier before the anchors
  if (lane < 4 * M)
    gbox[w][lane >> 2][lane & 3] = gt[(size_t)b * M * 4 + lane];
  if (lane < M) gok[w][lane] = gtv[b * M + lane] != 0;
  for (int i = tid; i < (A + 3) / 4; i += TAL_THREADS) claim[i] = 0u;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  for (int a0 = 0;;) {
    float sp[TAL_AHEAD];        // sqrt(sigmoid(logit)), once a warp needs it
    unsigned have = 0u;
    for (int m = 0; m < M; ++m) {
      const float gx1 = gbox[w][m][0], gy1 = gbox[w][m][1],
                  gx2 = gbox[w][m][2], gy2 = gbox[w][m][3];
      const bool ok = gok[w][m] != 0;
      const float ag = tal_area(gx1, gy1, gx2, gy2);
      unsigned* const rk = ck + (size_t)(m * TAL_WARPS + w) * R;
      uint16_t* const ra = ca + (size_t)(m * TAL_WARPS + w) * R;
      int n = a0 == 0 ? 0 : wcnt[m][w];
#pragma unroll
      for (int k = 0; k < TAL_AHEAD; ++k) {
        const int a = a0 + k * TAL_THREADS + tid;
        const bool inside = ok && a < A && px[k] > gx1 && px[k] < gx2 &&
                            py[k] > gy1 && py[k] < gy2;
        if (!__any_sync(FULL, inside)) continue;
        // inside the gt and intersecting it; elsewhere the IoU is 0 and so
        // is the align metric (a NaN is never taken either, as a value
        // that is not > 0)
        const float inter = tal_inter(gx1, gy1, gx2, gy2, box[k]);
        const bool on = inside && inter > 0.f;
        if (!__any_sync(FULL, on)) continue;
        if (!((have >> k) & 1u)) {
          sp[k] = sqrtf(__frcp_rn(__fadd_rn(1.f, expf(-xs[k]))));
          have |= 1u << k;
        }
        // a numerator of 1 where there is no intersection (a division of
        // 0 would take the slow path)
        const float c =
            fmaxf(tal_iou(inter, ag, box[k], on ? inter : 1.f), 0.f);
        const float c2 = __fmul_rn(c, c);
        const float c6 = __fmul_rn(__fmul_rn(c2, c2), c2);
        const float align = __fmul_rn(sp[k], c6);
        const unsigned key =
            on && align > 0.f ? __float_as_uint(align) : 0u;
        // appended to the warp's region of gt m's list
        const unsigned bal = __ballot_sync(FULL, key != 0u);
        if (key != 0u) {
          const int pos = n + __popc(bal & lt);
          rk[pos] = key;
          ra[pos] = (uint16_t)a;
        }
        n += __popc(bal);
      }
      wcnt[m][w] = n;     // (every lane writes the same count)
    }
    a0 += TAL_THREADS * TAL_AHEAD;
    if (a0 >= A) break;
    load(a0);
  }
  __syncthreads();

  // ── (2) warp w: gt w's top 10 by value, ties to the lower anchor, > 0
  unsigned my_v = 0u;       // lane r: round r's value and anchor
  int my_a = 0, r = 0;
  if (w < M) {
    unsigned kv[TOPK];
    int ka[TOPK];
#pragma unroll
    for (int s = 0; s < TOPK; ++s) {
      kv[s] = 0u;
      ka[s] = NO_ANCHOR;
    }
    // the warps' regions of gt w as one list: region j starts at off[j]
    int off[TAL_WARPS + 1];
    off[0] = 0;
#pragma unroll
    for (int j = 0; j < TAL_WARPS; ++j) off[j + 1] = off[j] + wcnt[w][j];
    for (int p = lane; p < off[TAL_WARPS]; p += 32) {
      int j = 0;
#pragma unroll
      for (int q = 1; q < TAL_WARPS; ++q) j += p >= off[q];
      int at = p - off[0];
#pragma unroll
      for (int q = 1; q < TAL_WARPS; ++q)
        if (j == q) at = p - off[q];
      const size_t e = (size_t)(w * TAL_WARPS + j) * R + at;
      const unsigned key = ck[e];
      const int a = ca[e];
      // insertion into the lane's ordered ten
#pragma unroll
      for (int s = TOPK - 1; s >= 0; --s) {
        if (s > 0 && tal_before(key, a, kv[s - 1], ka[s - 1])) {
          kv[s] = kv[s - 1];
          ka[s] = ka[s - 1];
        } else if (tal_before(key, a, kv[s], ka[s])) {
          kv[s] = key;
          ka[s] = a;
        }
      }
    }
    for (; r < TOPK; ++r) {
      const unsigned v = __reduce_max_sync(FULL, kv[0]);
      if (v == 0u) break;
      const int a = (int)__reduce_min_sync(
          FULL, kv[0] == v ? (unsigned)ka[0] : (unsigned)NO_ANCHOR);
      if (lane == r) {
        my_v = v;
        my_a = a;
      }
      if (kv[0] == v && ka[0] == a) {     // the lane that held it
#pragma unroll
        for (int s = 0; s < TOPK - 1; ++s) {
          kv[s] = kv[s + 1];
          ka[s] = ka[s + 1];
        }
        kv[TOPK - 1] = 0u;
        ka[TOPK - 1] = NO_ANCHOR;
      }
    }
    // the largest value is the first taken; the taken IoUs are > 0 (their
    // align is), so their largest is the largest of their bits
    unsigned ci = 0u;
    if (lane < r) {
      const float4 p = vec ? reinterpret_cast<const float4*>(pb)[my_a]
                           : make_float4(pb[4 * my_a], pb[4 * my_a + 1],
                                         pb[4 * my_a + 2], pb[4 * my_a + 3]);
      const float gx1 = gbox[w][w][0], gy1 = gbox[w][w][1],
                  gx2 = gbox[w][w][2], gy2 = gbox[w][w][3];
      const float inter = tal_inter(gx1, gy1, gx2, gy2, p);
      ci = __float_as_uint(fmaxf(
          tal_iou(inter, tal_area(gx1, gy1, gx2, gy2), p, inter), 0.f));
      take_v[w][lane] = my_v;
      take_a[w][lane] = my_a;
      atomicOr(&claim[my_a >> 2], (1u << w) << (8 * (my_a & 3)));
    }
    ci = __reduce_max_sync(FULL, ci);
    const unsigned v0 = __shfl_sync(FULL, my_v, 0);
    if (lane == 0) {
      take_n[w] = r;
      max_align[w] = __uint_as_float(v0);
      max_iou[w] = __uint_as_float(ci);
    }
  }
  __syncthreads();

  // ── (3) each taken anchor, by the lane of the lowest gt that took it:
  // the first gt with the largest value among those, and its soft target
  if (w < M && lane < r) {
    const unsigned c = (claim[my_a >> 2] >> (8 * (my_a & 3))) & 0xffu;
    if ((c & ((1u << w) - 1u)) == 0u) {
      int bm = w;
      float mx = __uint_as_float(my_v);
      for (int m = w + 1; m < M; ++m)       // (rare: other gts took it too)
        if ((c >> m) & 1u)
          for (int k = 0; k < take_n[m]; ++k)
            if (take_a[m][k] == my_a) {
              const float v = __uint_as_float(take_v[m][k]);
              if (v > mx) {
                mx = v;
                bm = m;
              }
              break;
            }
      const size_t o = (size_t)b * A + my_a;
      best_gt[o] = bm;
      assigned[o] = 1;
      t_score[o] = __fdiv_rn(__fmul_rn(mx, max_iou[bm]),
                             __fadd_rn(max_align[bm], 1e-9f));
    }
  }
}

int launch_augment(const uint8_t* imgs, const uint8_t* msks,
                   const float* params, const float* noise, float* out_img,
                   float* out_msk, int b, cudaStream_t stream) {
  if (b <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AUG_SMEM);
  if (e != cudaSuccess) return (int)e;
  augment_kernel<<<dim3(AUG_RANKS, b), AUG_THREADS, AUG_SMEM, stream>>>(
      imgs, msks, params, noise, out_img, out_msk);
  return (int)cudaGetLastError();
}

int launch_bce(const float* x, const float* t, const uint8_t* valid,
               float* partial, float* out, int rows, int per_row, int blocks,
               cudaStream_t stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  bce_dice_kernel<<<blocks, BCE_THREADS, 0, stream>>>(
      x, t, valid, partial, rows, per_row, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `partial` is not used: the sample's tile partials stay in its cluster.
int og_unet_augment(const uint8_t* imgs, const uint8_t* msks,
                    const float* params, const float* noise, float* out_img,
                    float* out_msk, float* partial, int b,
                    cudaStream_t stream) {
  (void)partial;
  return launch_augment(imgs, msks, params, noise, out_img, out_msk, b,
                        stream);
}

// `partial`: blocks * 4 + 1 words, the blocks' four sums for the last
// block's finish, then the ticket, which must be zero at the launch (the
// launch leaves it zero).
int og_bce_dice(const float* x, const float* t, const uint8_t* valid,
                float* partial, float* out, int rows, int per_row, int blocks,
                cudaStream_t stream) {
  return launch_bce(x, t, valid, partial, out, rows, per_row, blocks,
                    stream);
}

// One pass where the card holds it: blocks for two groups a thread, at
// most the SMs times the blocks an SM holds (queried once a device).
int og_bce_dice_bwd(const float* x, const float* t, const uint8_t* valid,
                    const float* sn, const float* gout, float* grad, int rows,
                    int per_row, cudaStream_t stream) {
  const long long n = (long long)rows * per_row;
  if (n <= 0) return 0;
  static int resident[64];      // SMs x blocks an SM, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bce_dice_bwd,
                                                        BWD_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(t) |
                         reinterpret_cast<uintptr_t>(grad)) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long units = n4 > 0 ? (n4 + BWD_AHEAD - 1) / BWD_AHEAD : n;
  long long blocks = (units + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks > resident[dev]) blocks = resident[dev];
  bce_dice_bwd<<<(int)blocks, BWD_THREADS, 0, stream>>>(x, t, valid, sn, gout,
                                                        grad, n, per_row, n4);
  return (int)cudaGetLastError();
}

// Shared memory above 48 KB (M A > 8,192) is allowed once a device for the
// largest size seen.
int og_tal_assign(const float* cls, const float* pred, const float* gt,
                  const uint8_t* gtv, const float* pts, int32_t* best_gt,
                  uint8_t* assigned, float* t_score, int b, int a, int m,
                  cudaStream_t stream) {
  if (b <= 0 || a <= 0) return 0;
  if (m < 1 || m > MAXM || a > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = tal_smem(a, m);
  if (smem > 48 * 1024) {
    static size_t allowed[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > allowed[dev]) {
      e = cudaFuncSetAttribute(tal_assign_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed[dev] = smem;
    }
  }
  tal_assign_kernel<<<b, TAL_THREADS, smem, stream>>>(
      cls, pred, gt, gtv, pts, best_gt, assigned, t_score, a, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
