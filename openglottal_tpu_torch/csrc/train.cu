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
//       TB/s).  A 256² f32 image (256 KB) does not fit one block's shared
//       memory, so the pass is cut in row tiles of 16 (+2 halo rows each
//       side, recomputed) held in shared memory for the blur; each tile
//       writes its partial sum, and a second small launch (augment_contrast)
//       takes each image's mean from its tiles' partials in a fixed order
//       and applies the contrast in place.
//   og_bce_dice      <- openglottal_tpu/train/unet_trainer.py:49 (_loss_fn)
//       and :89 (unet_eval_loss_masked): one pass over logits and targets
//       giving sum BCE, sum sigma*t, sum sigma, sum t per block, then one
//       block that adds the partials in a fixed order (double) and forms the
//       loss.  Bound by bytes (8.4 MB forward at batch 16: 2.5 us).
//   og_bce_dice_bwd  the loss's gradient, one elementwise pass from the
//       saved sums (12.6 MB: 3.8 us).
//   og_tal_assign    <- openglottal_tpu/train/yolo_loss.py:98-133: the
//       task-aligned assignment, one block an image over M <= 8 gts x A
//       anchors (align and IoU in shared memory), top-10 per gt by ten
//       block arg-max rounds.  Latency-bound: its bytes are negligible, its
//       floor is the serial chain of M x 10 block reductions.
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn /
// __fmaf_rn, so nvcc contracts nothing; the forms are the plain versions'
// (ops/train_cuda.py), which are the JAX package's compiled forms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 256;          // the augment's frame side
constexpr int TILE = 16;        // rows of a sample a block takes
constexpr int NTILE = S / TILE;
constexpr int NP = 16;          // per-sample parameter row
constexpr int THREADS = 256;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ int reflect101(int i) {
  return i < 0 ? -i : (i >= S ? 2 * S - 2 - i : i);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  __syncthreads();
  return s;   // valid in thread 0
}

// pixel value of the u8 frame at float indices, zero outside
__device__ __forceinline__ float at_u8(const uint8_t* img, float yi, float xi,
                                       float inv255) {
  bool inb = yi >= 0.f && yi < (float)S && xi >= 0.f && xi < (float)S;
  int yc = (int)fminf(fmaxf(yi, 0.f), (float)(S - 1));
  int xc = (int)fminf(fmaxf(xi, 0.f), (float)(S - 1));
  return inb ? __fmul_rn((float)img[yc * S + xc], inv255) : 0.f;
}

__global__ void __launch_bounds__(THREADS)
augment_tiles(const uint8_t* __restrict__ imgs,
              const uint8_t* __restrict__ msks,
              const float* __restrict__ params, const float* __restrict__ noise,
              float* __restrict__ out_img, float* __restrict__ out_msk,
              float* __restrict__ partial) {
  __shared__ float g[TILE + 4][S];   // geometry + noise, rows r0-2 .. r0+TILE+1
  __shared__ float r[TILE][S];       // the blur's row pass
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.y, r0 = blockIdx.x * TILE;
  const float* p = params + (size_t)b * NP;
  const bool hf = p[0] != 0.f, vf = p[1] != 0.f;
  const float ct = p[2], st = p[3], sc = p[4];
  const bool dn = p[5] != 0.f, db = p[7] != 0.f;
  const float sig = p[6], br = p[13];
  float k[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) k[d] = p[8 + d];
  const uint8_t* img = imgs + (size_t)b * S * S;
  const uint8_t* msk = msks + (size_t)b * S * S;
  const float* nz = noise + (size_t)b * S * S;
  const float inv255 = 1.f / 255.f;   // f32(1/255): XLA's form of / 255
  const float c = (S - 1) / 2.f;

  for (int i = threadIdx.x; i < (TILE + 4) * S; i += blockDim.x) {
    const int lr = i / S, x = i % S;
    const bool in_tile = lr >= 2 && lr < TILE + 2;
    if (!db && !in_tile) continue;    // the halo only feeds the blur
    const int yrow = reflect101(r0 - 2 + lr);
    const float xf = __fdiv_rn(__fsub_rn((float)x, c), sc);
    const float yf = __fdiv_rn(__fsub_rn((float)yrow, c), sc);
    float sx = __fadd_rn(__fmaf_rn(ct, xf, -__fmul_rn(st, yf)), c);
    float sy = __fadd_rn(__fmaf_rn(st, xf, __fmul_rn(ct, yf)), c);
    if (hf) sx = __fsub_rn((float)(S - 1), sx);
    if (vf) sy = __fsub_rn((float)(S - 1), sy);
    const float y0 = floorf(sy), x0 = floorf(sx);
    const float wy = __fsub_rn(sy, y0), wx = __fsub_rn(sx, x0);
    const float owy = __fsub_rn(1.f, wy), owx = __fsub_rn(1.f, wx);
    const float v00 = at_u8(img, y0, x0, inv255);
    const float v01 = at_u8(img, y0, __fadd_rn(x0, 1.f), inv255);
    const float v10 = at_u8(img, __fadd_rn(y0, 1.f), x0, inv255);
    const float v11 = at_u8(img, __fadd_rn(y0, 1.f), __fadd_rn(x0, 1.f),
                            inv255);
    float v = __fmaf_rn(__fmul_rn(owy, owx), v00,
                        __fmul_rn(__fmul_rn(owy, wx), v01));
    v = __fmaf_rn(__fmul_rn(wy, owx), v10, v);
    v = __fmaf_rn(__fmul_rn(wy, wx), v11, v);
    if (dn) v = clamp01(__fmaf_rn(nz[yrow * S + x], sig, v));
    g[lr][x] = v;
    if (in_tile) {
      // nearest mask sample: round half to even, zero outside
      const float yi = rintf(sy), xi = rintf(sx);
      const bool inb = yi >= 0.f && yi < (float)S && xi >= 0.f && xi < (float)S;
      const int yc = (int)fminf(fmaxf(yi, 0.f), (float)(S - 1));
      const int xc = (int)fminf(fmaxf(xi, 0.f), (float)(S - 1));
      out_msk[((size_t)b * S + r0 + lr - 2) * S + x] =
          inb ? (float)msk[yc * S + xc] : 0.f;
    }
  }
  __syncthreads();
  if (db) {
    for (int i = threadIdx.x; i < TILE * S; i += blockDim.x) {
      const int lr = i / S, x = i % S;
      float acc = __fmaf_rn(k[0], g[lr][x], __fmul_rn(k[1], g[lr + 1][x]));
#pragma unroll
      for (int d = 2; d < 5; ++d) acc = __fmaf_rn(k[d], g[lr + d][x], acc);
      r[lr][x] = acc;
    }
    __syncthreads();
  }
  float sum = 0.f;
  for (int i = threadIdx.x; i < TILE * S; i += blockDim.x) {
    const int lr = i / S, x = i % S;
    float v;
    if (db) {
      v = __fmaf_rn(k[0], r[lr][reflect101(x - 2)],
                    __fmul_rn(k[1], r[lr][reflect101(x - 1)]));
#pragma unroll
      for (int d = 2; d < 5; ++d)
        v = __fmaf_rn(k[d], r[lr][reflect101(x + d - 2)], v);
    } else {
      v = g[lr + 2][x];
    }
    v = clamp01(__fmul_rn(v, br));
    out_img[((size_t)b * S + r0 + lr) * S + x] = v;
    sum += v;
  }
  sum = block_sum(sum, red);
  if (threadIdx.x == 0) partial[b * NTILE + blockIdx.x] = sum;
}

__global__ void __launch_bounds__(THREADS)
augment_contrast(const float* __restrict__ params,
                 const float* __restrict__ partial,
                 float* __restrict__ out_img) {
  const int b = blockIdx.y, r0 = blockIdx.x * TILE;
  const float cc = params[(size_t)b * NP + 14];
  float s = 0.f;
  for (int t = 0; t < NTILE; ++t) s += partial[b * NTILE + t];
  const float mean = __fdiv_rn(s, (float)(S * S));
  const float off = __fmul_rn(__fsub_rn(1.f, cc), mean);
  float* o = out_img + ((size_t)b * S + r0) * S;
  for (int i = threadIdx.x; i < TILE * S; i += blockDim.x)
    o[i] = clamp01(__fmaf_rn(cc, o[i], off));
}

// ── the loss ────────────────────────────────────────────────────────────

__device__ __forceinline__ float log_sigmoid(float x) {
  // -softplus(-x), stable for any x
  return -__fadd_rn(fmaxf(-x, 0.f), log1pf(expf(-fabsf(x))));
}

__global__ void __launch_bounds__(THREADS)
bce_dice_partial(const float* __restrict__ x, const float* __restrict__ t,
                 const uint8_t* __restrict__ valid, float* __restrict__ partial,
                 int rows, int per_row) {
  __shared__ float red[THREADS / 32];
  const long long n = (long long)rows * per_row;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (valid && !valid[i / per_row]) continue;
    const float xi = x[i], ti = t[i];
    const float bce = __fsub_rn(
        -__fmul_rn(ti, log_sigmoid(xi)),
        __fmul_rn(__fsub_rn(1.f, ti), log_sigmoid(-xi)));
    const float p = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-xi)));
    s[0] += bce;
    s[1] += __fmul_rn(p, ti);
    s[2] += p;
    s[3] += ti;
  }
  for (int j = 0; j < 4; ++j) {
    const float v = block_sum(s[j], red);
    if (threadIdx.x == 0) partial[blockIdx.x * 4 + j] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
bce_dice_finish(const float* __restrict__ partial, int blocks,
                const uint8_t* __restrict__ valid, int rows, int per_row,
                float* __restrict__ out) {
  __shared__ double red[4][THREADS];
  __shared__ int nvalid;
  for (int j = 0; j < 4; ++j) {
    double a = 0.0;
    for (int i = threadIdx.x; i < blocks; i += blockDim.x)
      a += (double)partial[i * 4 + j];
    red[j][threadIdx.x] = a;
  }
  if (threadIdx.x == 0) {
    int nv = 0;
    for (int i = 0; i < rows; ++i) nv += valid ? (valid[i] != 0) : 1;
    nvalid = nv;
  }
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w)
      for (int j = 0; j < 4; ++j)
        red[j][threadIdx.x] += red[j][threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float s[4];
    for (int j = 0; j < 4; ++j) s[j] = (float)red[j][0];
    const float n = fmaxf((float)nvalid * (float)per_row, 1.f);
    const float eps = 1e-6f;
    const float bce = __fdiv_rn(s[0], n);
    const float num = __fadd_rn(__fmul_rn(2.f, s[1]), eps);
    const float den = __fadd_rn(__fadd_rn(s[2], s[3]), eps);
    const float dl = __fsub_rn(1.f, __fdiv_rn(num, den));
    for (int j = 0; j < 4; ++j) out[j] = s[j];
    out[4] = n;
    out[5] = __fadd_rn(__fmul_rn(0.5f, bce), __fmul_rn(0.5f, dl));
  }
}

__global__ void __launch_bounds__(THREADS)
bce_dice_bwd(const float* __restrict__ x, const float* __restrict__ t,
             const uint8_t* __restrict__ valid, const float* __restrict__ sn,
             const float* __restrict__ gout, float* __restrict__ grad, int rows,
             int per_row) {
  const long long n = (long long)rows * per_row;
  const float eps = 1e-6f;
  const float I = __fadd_rn(__fmul_rn(2.f, sn[1]), eps);
  const float D = __fadd_rn(__fadd_rn(sn[2], sn[3]), eps);
  const float a = __fdiv_rn(I, __fmul_rn(D, D));
  const float cnt = sn[4], g = gout[0];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (valid && !valid[i / per_row]) { grad[i] = 0.f; continue; }
    const float xi = x[i], ti = t[i];
    const float p = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-xi)));
    const float gb = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(p, ti)), cnt);
    const float gd = __fmul_rn(__fmul_rn(__fmul_rn(0.5f,
        __fsub_rn(a, __fdiv_rn(__fmul_rn(2.f, ti), D))), p), __fsub_rn(1.f, p));
    grad[i] = __fmul_rn(__fadd_rn(gb, gd), g);
  }
}

// ── task-aligned assignment ─────────────────────────────────────────────

constexpr int TOPK = 10;
constexpr int MAXM = 8;

__global__ void __launch_bounds__(THREADS)
tal_assign_kernel(const float* __restrict__ cls, const float* __restrict__ pred,
                  const float* __restrict__ gt, const uint8_t* __restrict__ gtv,
                  const float* __restrict__ pts, int32_t* __restrict__ best_gt,
                  uint8_t* __restrict__ assigned, float* __restrict__ t_score,
                  int A, int M) {
  extern __shared__ float sm[];
  float* align = sm;                       // [M][A]
  float* iou = sm + (size_t)M * A;         // [M][A]
  uint8_t* mask = (uint8_t*)(iou + (size_t)M * A);   // [M][A]
  __shared__ float wv[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  __shared__ float max_align[MAXM], max_iou[MAXM];
  __shared__ int stop;
  const int b = blockIdx.x;
  const float* g = gt + (size_t)b * M * 4;
  for (int i = threadIdx.x; i < M * A; i += blockDim.x) {
    const int m = i / A, a = i % A;
    const float* pb = pred + ((size_t)b * A + a) * 4;
    const float gx1 = g[m * 4], gy1 = g[m * 4 + 1], gx2 = g[m * 4 + 2],
                gy2 = g[m * 4 + 3];
    const float px = pts[a * 2], py = pts[a * 2 + 1];
    const bool inside = gtv[b * M + m] && px > gx1 && px < gx2 && py > gy1 &&
                        py < gy2;
    const float iw =
        fmaxf(__fsub_rn(fminf(gx2, pb[2]), fmaxf(gx1, pb[0])), 0.f);
    const float ih =
        fmaxf(__fsub_rn(fminf(gy2, pb[3]), fmaxf(gy1, pb[1])), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float ag = __fmul_rn(fmaxf(__fsub_rn(gx2, gx1), 0.f),
                               fmaxf(__fsub_rn(gy2, gy1), 0.f));
    const float ap = __fmul_rn(fmaxf(__fsub_rn(pb[2], pb[0]), 0.f),
                               fmaxf(__fsub_rn(pb[3], pb[1]), 0.f));
    const float u = __fadd_rn(__fsub_rn(__fadd_rn(ag, ap), inter), 1e-7f);
    const float io = __fdiv_rn(inter, u);
    const float c = fmaxf(io, 0.f);
    const float c2 = __fmul_rn(c, c);
    const float c6 = __fmul_rn(__fmul_rn(c2, c2), c2);
    const float x = cls[(size_t)b * A + a];
    const float prob = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
    align[i] = inside ? __fmul_rn(sqrtf(prob), c6) : 0.f;
    iou[i] = io;
    mask[i] = 0;
  }
  __syncthreads();
  // per gt: the top-10 by value, ties to the lower index, kept where > 0
  for (int m = 0; m < M; ++m) {
    if (threadIdx.x == 0) { max_align[m] = 0.f; max_iou[m] = 0.f; }
    for (int r = 0; r < TOPK && r < A; ++r) {
      float bv = -1.f;
      int bi = A;
      for (int a = threadIdx.x; a < A; a += blockDim.x) {
        const float v = align[m * A + a];
        if (!mask[m * A + a] && (v > bv || (v == bv && a < bi))) {
          bv = v;
          bi = a;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, o);
        const int oi = __shfl_down_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if ((threadIdx.x & 31) == 0) {
        wv[threadIdx.x >> 5] = bv;
        wi[threadIdx.x >> 5] = bi;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
          if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) {
            bv = wv[w];
            bi = wi[w];
          }
        // the values are >= 0; once the best left is not > 0, no later one is
        stop = !(bv > 0.f) || bi >= A;
        if (!stop) {
          mask[m * A + bi] = 1;
          max_align[m] = fmaxf(max_align[m], bv);
          max_iou[m] = fmaxf(max_iou[m], fmaxf(iou[m * A + bi], 0.f));
        }
      }
      __syncthreads();
      if (stop) break;
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    int bm = 0;
    float mx = mask[a] ? align[a] : -1.f;
    for (int m = 1; m < M; ++m) {
      const float v = mask[m * A + a] ? align[m * A + a] : -1.f;
      if (v > mx) { mx = v; bm = m; }
    }
    const bool as = mask[bm * A + a] && mx > 0.f;
    const size_t o = (size_t)b * A + a;
    best_gt[o] = bm;
    assigned[o] = as;
    t_score[o] = as ? __fdiv_rn(__fmul_rn(align[bm * A + a], max_iou[bm]),
                                __fadd_rn(max_align[bm], 1e-9f))
                    : 0.f;
  }
}

}  // namespace

extern "C" {

int og_unet_augment(const uint8_t* imgs, const uint8_t* msks,
                    const float* params, const float* noise, float* out_img,
                    float* out_msk, float* partial, int b,
                    cudaStream_t stream) {
  if (b <= 0) return 0;
  dim3 grid(NTILE, b);
  augment_tiles<<<grid, THREADS, 0, stream>>>(imgs, msks, params, noise,
                                              out_img, out_msk, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  augment_contrast<<<grid, THREADS, 0, stream>>>(params, partial, out_img);
  return (int)cudaGetLastError();
}

int og_bce_dice(const float* x, const float* t, const uint8_t* valid,
                float* partial, float* out, int rows, int per_row, int blocks,
                cudaStream_t stream) {
  bce_dice_partial<<<blocks, THREADS, 0, stream>>>(x, t, valid, partial, rows,
                                                   per_row);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bce_dice_finish<<<1, THREADS, 0, stream>>>(partial, blocks, valid, rows,
                                             per_row, out);
  return (int)cudaGetLastError();
}

int og_bce_dice_bwd(const float* x, const float* t, const uint8_t* valid,
                    const float* sn, const float* gout, float* grad, int rows,
                    int per_row, cudaStream_t stream) {
  const long long n = (long long)rows * per_row;
  long long blocks = (n + THREADS * 4 - 1) / (THREADS * 4);
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  bce_dice_bwd<<<(int)blocks, THREADS, 0, stream>>>(x, t, valid, sn, gout, grad,
                                                    rows, per_row);
  return (int)cudaGetLastError();
}

int og_tal_assign(const float* cls, const float* pred, const float* gt,
                  const uint8_t* gtv, const float* pts, int32_t* best_gt,
                  uint8_t* assigned, float* t_score, int b, int a, int m,
                  cudaStream_t stream) {
  if (b <= 0 || a <= 0) return 0;
  if (m < 1 || m > MAXM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * a * (4 + 4 + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tal_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tal_assign_kernel<<<b, THREADS, smem, stream>>>(cls, pred, gt, gtv, pts,
                                                  best_gt, assigned, t_score,
                                                  a, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
