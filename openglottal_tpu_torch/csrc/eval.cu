// Per-frame evaluation counts (TP / FP / FN of a mask against the ground
// truth), and the in-box Otsu baseline with its counts, one launch each.
//
//   og_frame_counts  <- openglottal_tpu/eval.py frame_metrics_batch (:29-41),
//                       with box_masked (:61-73) fused in: the box-masked
//                       mask is never written
//   og_otsu_counts   <- openglottal_tpu/eval.py otsu_in_box_masks (:44-58)
//                       (ops/histogram.py otsu_threshold, :121-140) and
//                       frame_metrics_batch of its masks, in one launch
//
// Replace no Pallas kernel: the reference lets XLA fuse these.  Eager PyTorch
// would write each boolean intermediate (the binarised masks, their AND, the
// in-box mask, the Otsu mask) to device memory and reduce each separately.
//
// For frame n of (T, H, W) one-byte masks (bool or uint8; a byte is "in"
// when non-zero, which is `> 0` for both), valid (T,) bytes and boxes (T, 4)
// int32 (x0, y0, x1, y1), the box clipped to the frame:
//
//   og_frame_counts: p = pred[n] != 0, or p & inbox & valid[n] when boxes
//   are given; g = gt[n] != 0; out (tp, fp, fn) = (#(p & g), #(p & ~g),
//   #(~p & g)) as int32.  Mode 2 writes the box-masked counts and then the
//   unmasked ones of the same pred, from one pass (T, 6).
//
//   og_otsu_counts: the 256-bin histogram of gray[n] inside the box (valid
//   or not, as the reference computes it), its Otsu threshold t (float32,
//   written out), and the counts of m = (gray[n] <= t) & inbox & valid[n]
//   against g.  Without gt the counts are (0, #m, 0).
//
// The threshold is the reference's float32 sequence, step by step:
//   p = hist / max(n, 1); w0 and mu the SEQUENTIAL float32 cumulative sums of
//   p and p*v; w1 = 1 - w0; denom = w0*w1; num = mu_total*w0 - mu (two
//   roundings, not one fma); sigma = (num*num) / max(denom, 1e-12) where
//   denom > 1e-12, else -1; t = the first argmax.  nvcc contracts a*b - c
//   into an fma unless told otherwise, so each step is spelled out with the
//   round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
//   which are never contracted.  The counts are exact integers.
//
// Bound: the bytes (pred and gt read once, 2 * T * H * W) over the card's
// memory rate: ~0.02 ms for 502 frames of 256².  Design (a simple form): one
// block of 256 threads per frame; the frame read flat in 16-byte vectors (a
// one-byte-per-element scalar head and tail where the frame does not start
// on a 16-byte boundary), each 4-byte word binarised with a carry-free byte
// test and counted with __popc; the in-box byte mask of a vector built from
// its row and column range (a vector that crosses a row end bytewise); the
// counts summed by warp shuffles and once through shared memory.  The Otsu
// launch walks its 256 bins on one thread (the cumulative sums must be taken
// in order to round as the reference rounds) between a histogram pass over
// the box (shared-memory atomics) and a count pass.
//
// Plain C interface; nothing allocates or synchronises; each function
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 0x80 in every non-zero byte of x, 0 elsewhere (no carry crosses a byte:
// the low seven bits plus 0x7f stay below 0x100).
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// 0x80 in byte k of word j for bit 4j + k of a 16-bit mask.
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return ((b & 1u) << 7) | ((b & 2u) << 14) | ((b & 4u) << 21) |
         ((b & 8u) << 28);
}

struct Box {
  int x0, y0, x1, y1;
  bool on;   // valid, and the clipped box is not empty
};

__device__ __forceinline__ Box load_box(const uint8_t* valid,
                                        const int32_t* boxes, int n, int h,
                                        int w) {
  Box b;
  const int32_t* bp = boxes + 4 * (size_t)n;
  b.x0 = max(bp[0], 0);
  b.y0 = max(bp[1], 0);
  b.x1 = min(bp[2], w);
  b.y1 = min(bp[3], h);
  b.on = valid[n] != 0 && b.x1 > b.x0 && b.y1 > b.y0;
  return b;
}

__device__ __forceinline__ bool in_box(const Box& b, long long r,
                                       long long c) {
  return r >= b.y0 && r < b.y1 && c >= b.x0 && c < b.x1;
}

// The in-box byte masks (0x80 a byte) of the 16 bytes at flat index i of a
// frame of width w.
__device__ __forceinline__ uint4 box_mask16(const Box& b, long long i,
                                            int w) {
  const long long r = i / w;
  const long long c = i - r * w;
  unsigned m16 = 0;
  if (c + 16 <= w) {                       // one row
    if (r >= b.y0 && r < b.y1) {
      const long long lo = max((long long)b.x0 - c, 0LL);
      const long long hi = min((long long)b.x1 - c, 16LL);
      if (hi > lo) m16 = (unsigned)((1u << hi) - (1u << lo));
    }
  } else {                                 // crosses a row end
    long long rr = r, cc = c;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      m16 |= (unsigned)in_box(b, rr, cc) << k;
      if (++cc == w) {
        cc = 0;
        ++rr;
      }
    }
  }
  return make_uint4(spread4(m16), spread4(m16 >> 4), spread4(m16 >> 8),
                    spread4(m16 >> 12));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums kN per-thread counts over the block; the totals are valid on
// thread 0.  `part` holds kN * kWarps ints.
template <int kN>
__device__ __forceinline__ void block_sum(int (&v)[kN], int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    v[j] = warp_sum(v[j]);
    if (lane == 0) part[j * kWarps + warp] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      v[j] = warp_sum(lane < kWarps ? part[j * kWarps + lane] : 0);
    }
  }
}

// The five counts of one frame: #p, #g, #(p & g) over the frame and, when
// kBoxed, #(p & inbox), #(p & g & inbox) (zero unless box.on).
template <bool kBoxed>
__device__ __forceinline__ void count_frame(const uint8_t* p,
                                            const uint8_t* g, long long hw,
                                            int w, const Box& box,
                                            int (&c)[5]) {
  // a scalar head up to p's 16-byte boundary; vectors only where g shares
  // p's alignment, else every byte scalar
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(g)) &
       15) != 0) {
    head = hw;
  }
  head = min(head, hw);
  const long long nvec = (hw - head) / 16;
  const long long tail0 = head + nvec * 16;
  for (long long i = threadIdx.x; i < head + (hw - tail0);
       i += kThreads) {
    const long long k = i < head ? i : tail0 + (i - head);
    const int pm = p[k] != 0, gm = g[k] != 0;
    c[0] += pm;
    c[1] += gm;
    c[2] += pm & gm;
    if (kBoxed && box.on) {
      const long long r = k / w;
      const int ib = in_box(box, r, k - r * w);
      c[3] += pm & ib;
      c[4] += pm & gm & ib;
    }
  }
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  for (long long v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 a = __ldg(pv + v), b = __ldg(gv + v);
    const unsigned pw[4] = {nonzero_bytes(a.x), nonzero_bytes(a.y),
                            nonzero_bytes(a.z), nonzero_bytes(a.w)};
    const unsigned gw[4] = {nonzero_bytes(b.x), nonzero_bytes(b.y),
                            nonzero_bytes(b.z), nonzero_bytes(b.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[0] += __popc(pw[j]);
      c[1] += __popc(gw[j]);
      c[2] += __popc(pw[j] & gw[j]);
    }
    if (kBoxed && box.on) {
      const long long i = head + 16 * v;
      const long long r0 = i / w, r1 = (i + 15) / w;
      if (r1 >= box.y0 && r0 < box.y1) {
        const uint4 m = box_mask16(box, i, w);
        const unsigned mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[3] += __popc(pw[j] & mw[j]);
          c[4] += __popc(pw[j] & gw[j] & mw[j]);
        }
      }
    }
  }
}

// mode 0: unmasked counts (T, 3); 1: box-masked (T, 3); 2: both (T, 6).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
frame_counts_kernel(const uint8_t* __restrict__ pred,
                    const uint8_t* __restrict__ gt,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ boxes, int32_t* out, int h,
                    int w) {
  __shared__ int part[5 * kWarps];
  const int n = blockIdx.x;
  const long long hw = (long long)h * w;
  Box box{0, 0, 0, 0, false};
  if (kMode != 0) box = load_box(valid, boxes, n, h, w);
  int c[5] = {0, 0, 0, 0, 0};
  count_frame<kMode != 0>(pred + n * hw, gt + n * hw, hw, w, box, c);
  block_sum<5>(c, part);
  if (threadIdx.x == 0) {
    // (tp, fp, fn) of p & inbox & valid, then of p
    const int tb = c[4], fb = c[3] - c[4], nb = c[1] - c[4];
    const int tp = c[2], fp = c[0] - c[2], fn = c[1] - c[2];
    int32_t* o = out + (size_t)n * (kMode == 2 ? 6 : 3);
    if (kMode == 0) {
      o[0] = tp; o[1] = fp; o[2] = fn;
    } else {
      o[0] = tb; o[1] = fb; o[2] = nb;
      if (kMode == 2) {
        o[3] = tp; o[4] = fp; o[5] = fn;
      }
    }
  }
}

// The count of non-zero bytes of a frame, as count_frame reads g.
__device__ __forceinline__ int count_nonzero(const uint8_t* g, long long hw) {
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(g) & 15)) & 15;
  head = min(head, hw);
  const long long nvec = (hw - head) / 16;
  const long long tail0 = head + nvec * 16;
  int c = 0;
  for (long long i = threadIdx.x; i < head + (hw - tail0); i += kThreads) {
    c += g[i < head ? i : tail0 + (i - head)] != 0;
  }
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  for (long long v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 b = __ldg(gv + v);
    c += __popc(nonzero_bytes(b.x)) + __popc(nonzero_bytes(b.y)) +
         __popc(nonzero_bytes(b.z)) + __popc(nonzero_bytes(b.w));
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
otsu_counts_kernel(const uint8_t* __restrict__ gray,
                   const uint8_t* __restrict__ gt,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ boxes, float* thr_out,
                   int32_t* out, int h, int w) {
  __shared__ int hist[256];
  __shared__ float w0s[256];
  __shared__ float mus[256];
  __shared__ float best_sigma[kWarps];
  __shared__ int best_bin[kWarps];
  __shared__ int part[3 * kWarps];
  __shared__ int thr_bin;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long hw = (long long)h * w;
  const uint8_t* gn = gray + n * hw;
  // the box (clipped), whether or not the frame is valid: the reference
  // takes the threshold of the in-box pixels regardless
  const int32_t* bp = boxes + 4 * (size_t)n;
  const int x0 = max(bp[0], 0), y0 = max(bp[1], 0);
  const int x1 = min(bp[2], w), y1 = min(bp[3], h);
  const bool on = valid[n] != 0;
  hist[tid] = 0;
  __syncthreads();
  // 1. the in-box histogram: warps over rows, lanes over columns
  for (int r = y0 + warp; r < y1; r += kWarps) {
    const uint8_t* row = gn + (long long)r * w;
    for (int col = x0 + lane; col < x1; col += 32) atomicAdd(&hist[row[col]], 1);
  }
  __syncthreads();
  // 2. the threshold: n = the in-box count; p = hist / max(n, 1)
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i < 256; ++i) total += hist[i];
    const float nf = fmaxf((float)total, 1.0f);
    float w0 = 0.0f, mu = 0.0f;
    for (int i = 0; i < 256; ++i) {
      const float p = __fdiv_rn((float)hist[i], nf);
      w0 = __fadd_rn(w0, p);
      mu = __fadd_rn(mu, __fmul_rn(p, (float)i));
      w0s[i] = w0;
      mus[i] = mu;
    }
  }
  __syncthreads();
  {
    const float w0 = w0s[tid], mu = mus[tid], mu_total = mus[255];
    const float w1 = __fsub_rn(1.0f, w0);
    const float denom = __fmul_rn(w0, w1);
    const float num = __fsub_rn(__fmul_rn(mu_total, w0), mu);
    float sigma = -1.0f;
    if (denom > 1e-12f) {
      sigma = __fdiv_rn(__fmul_rn(num, num), fmaxf(denom, 1e-12f));
    }
    // the first argmax: the larger sigma, the lower bin on ties
    int bin = tid;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, sigma, o);
      const int b2 = __shfl_down_sync(0xffffffffu, bin, o);
      if (s2 > sigma || (s2 == sigma && b2 < bin)) {
        sigma = s2;
        bin = b2;
      }
    }
    if (lane == 0) {
      best_sigma[warp] = sigma;
      best_bin[warp] = bin;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = best_sigma[0];
    int b = best_bin[0];
    for (int k = 1; k < kWarps; ++k) {
      if (best_sigma[k] > s) {   // warps hold ascending bins: ties keep b
        s = best_sigma[k];
        b = best_bin[k];
      }
    }
    thr_bin = b;
    thr_out[n] = (float)b;
  }
  __syncthreads();
  // 3. the counts of m = (gray <= t) & inbox & valid against g
  const int t = thr_bin;
  int c[3] = {0, 0, 0};   // #m, #(m & g), #g
  const uint8_t* gtn = gt ? gt + n * hw : nullptr;
  if (on) {
    for (int r = y0 + warp; r < y1; r += kWarps) {
      const long long off = (long long)r * w;
      for (int col = x0 + lane; col < x1; col += 32) {
        const int m = gn[off + col] <= t;
        c[0] += m;
        if (gtn) c[1] += m & (gtn[off + col] != 0);
      }
    }
  }
  if (gtn) c[2] = count_nonzero(gtn, hw);
  block_sum<3>(c, part);
  if (tid == 0) {
    int32_t* o = out + 3 * (size_t)n;
    o[0] = c[1];
    o[1] = c[0] - c[1];
    o[2] = c[2] - c[1];
  }
}

}  // namespace

extern "C" {

// pred, gt: (t, h, w) one-byte masks; valid (t,) bytes and boxes (t, 4)
// int32, both null for mode 0; out: (t, 3) int32 for modes 0 and 1, (t, 6)
// for mode 2.
int og_frame_counts(const void* pred, const void* gt, const void* valid,
                    const void* boxes, void* out, int t, int h, int w,
                    int mode, void* stream) {
  if (t < 0 || h <= 0 || w <= 0 || mode < 0 || mode > 2 ||
      (mode != 0 && (valid == nullptr || boxes == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(pred);
  const uint8_t* g = static_cast<const uint8_t*>(gt);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* b = static_cast<const int32_t*>(boxes);
  int32_t* o = static_cast<int32_t*>(out);
  if (mode == 0) {
    frame_counts_kernel<0><<<t, kThreads, 0, s>>>(p, g, v, b, o, h, w);
  } else if (mode == 1) {
    frame_counts_kernel<1><<<t, kThreads, 0, s>>>(p, g, v, b, o, h, w);
  } else {
    frame_counts_kernel<2><<<t, kThreads, 0, s>>>(p, g, v, b, o, h, w);
  }
  return (int)cudaGetLastError();
}

// gray: (t, h, w) uint8; gt: (t, h, w) one-byte masks or null; valid (t,)
// bytes; boxes (t, 4) int32; thr: (t,) float32; out: (t, 3) int32.
int og_otsu_counts(const void* gray, const void* gt, const void* valid,
                   const void* boxes, void* thr, void* out, int t, int h,
                   int w, void* stream) {
  if (t < 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  otsu_counts_kernel<<<t, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<const uint8_t*>(gt),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(boxes),
      static_cast<float*>(thr), static_cast<int32_t*>(out), h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
