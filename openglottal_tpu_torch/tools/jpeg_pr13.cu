// The first form of csrc/jpeg.cu's two kernels, kept as a yardstick only: no
// served path loads it.  chip_smoke.py builds it beside csrc/jpeg.cu
// (ops/_build.build_others) and times both forms in turns on the same packed
// chunks.  Its C interface is the first form's: og_jpeg_entropy without the
// frame count, the subsequence length and the scratch of the redesigned
// decode.  What follows is that file as it was.
//
// Baseline JPEG (MJPG video frames) on the card, two launches a chunk:
//
//   og_jpeg_entropy   Huffman decode, DC prediction and de-zigzag into int16
//                     coefficient blocks, one warp per entropy-coded segment
//                     (a frame, or one restart interval of it)
//   og_jpeg_idct_bgr  dequantisation, FFmpeg's simple IDCT, the clamp, the
//                     chroma upsampling and YCbCr -> BGR as swscale does it,
//                     the crop; writes (T, H, W, 3) uint8 BGR, or (T, H, W)
//                     gray for one component
//
// Replace no Pallas kernel: they replace the host decode of the JAX package
// (openglottal_tpu/data/video.py:32-74, cv2.VideoCapture: FFmpeg's MJPEG
// decoder and swscale's yuvj -> bgr24), so that a clip crosses to the card
// as its compressed bytes.  The host side (data/jpeg.py) parses the markers,
// unstuffs the entropy-coded data, cuts it at its restart markers and packs
// a chunk: the segments' bytes (each at a 4-byte boundary, zero-padded),
// rows of (byte offset, byte count, frame, first MCU, MCU count), the
// chunk's distinct Huffman tables, per frame its table slots and per
// component its quantisation table.  The plain versions of both kernels are
// data/jpeg.py's entropy_decode_plain and idct_bgr_plain, which chip_smoke.py
// holds these equal to byte for byte.
//
// og_jpeg_entropy.  Bound: the compressed bytes in and the coefficients out
// (64 int16 a block) over the memory rate, ~0.03 ms for 502 frames of 256²;
// its real floor is the serial chain of one segment (a symbol's length is
// known only after its lookup).  Design (a simple form): a warp loads its
// frame's tables into shared memory (all 32 lanes), then lane 0 decodes the
// segment: a 64-bit bit buffer refilled a big-endian word at a time, a 9-bit
// fast lookup and the canonical max-code walk for longer codes, the block
// built in shared memory and written as eight 16-byte stores.  Every loop is
// bounded (each AC symbol advances the zigzag position); an invalid code, a
// DC size above 16, a coefficient past position 63 or reading past the
// segment's bytes sets the frame's error flag and stops the segment.  Reads
// past the segment return zeros and never leave the buffer.
//
// og_jpeg_idct_bgr.  Bound: the coefficients in and the pixels out over the
// memory rate, ~0.06 ms for 502 frames of 256² 4:2:0.  Design: a block of
// 256 threads takes up to 8 MCUs of one MCU row (48 IDCT blocks): row pass
// (one thread a row, 16-byte loads), column pass, both through shared
// memory, then each thread converts pixels of the strip, neighbouring
// threads on neighbouring pixels.
//
// The arithmetic, FFmpeg's (libavcodec 62 / libswscale 9, as cv2 calls them):
//   DC: last = diff * q[0] + last (32-bit wrapping, from 1024 at each
//       segment's start), stored clipped to int16;  AC: level * q stored as
//       int16.
//   IDCT (simple_idct_template.c, 8-bit, in the form of its x86 build,
//       ff_simple_idct8_sse2 / _avx, which cv2's FFmpeg runs): rows, a row
//       of only a DC term -> DC << 3 wrapped to int16, else 32-bit sums of
//       W1..W7 + (1 << 10), >> 11, saturated to int16; columns with the DC
//       term biased by 32 in 16 bits (wrapping), >> 20, clamped to 0..255.
//   Colour (full-range BT.601, coefficients C_* below), by form:
//     0 gray:    the value in every channel (gray8 -> bgr24's palette)
//     1 paired:  4:2:0 / 4:2:2 of even height (swscale's unscaled x86
//                converter): chroma shared by each 2x2 (2x1) block,
//                c = y + ((((u - 128) << 3) * C) >> 16) per term
//     2 full:    4:4:4 (the scaler with identity filters, full-chroma
//                output): ((y << 22) + (1 << 21) + ((u - 128) << 9) * C)
//                >> 22
//   (4:2:x of odd height, which swscale runs through its bicubic chroma
//   filters, is refused on the host before it reaches this file.)
//
// Plain C interface; nothing allocates or synchronises; each function
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a Huffman table row (data/jpeg.py table_words), int32 words
constexpr int kTableWords = 360;
constexpr int kMaxcode = 256;
constexpr int kDelta = 273;
constexpr int kVals = 290;
constexpr int kMaxSlots = 6;
constexpr int kSegWarps = 2;          // segments a block, a warp each
constexpr int kSegWords = 5;

constexpr int kIdctThreads = 256;
constexpr int kMaxJobs = 48;          // IDCT blocks a block (8 MCUs of 4:2:0)

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int C_UB = 14516, C_UG = -2819, C_VG = -5850, C_VR = 11485;

__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Layout {
  int ncomp;   // 1 (gray, a block an MCU) or 3
  int mcux;    // MCUs a row
  int mcus;    // MCUs a frame
  int hs0;     // luma blocks across an MCU (chroma 1)
  int vs0;     // luma blocks down an MCU
  int nblk;    // blocks a frame
};

__device__ __forceinline__ int blocks_per_mcu(const Layout& g) {
  return g.ncomp == 1 ? 1 : g.hs0 * g.vs0 + 2;
}

__device__ __forceinline__ int component_of(const Layout& g, int b) {
  const int ny = g.hs0 * g.vs0;
  return (g.ncomp == 1 || b < ny) ? 0 : b - ny + 1;
}

// Index in the frame's coefficient blocks of block b of MCU m: luma in
// (mcuy * vs0) rows of (mcux * hs0) blocks, then Cb and Cr a block an MCU.
__device__ __forceinline__ int block_index(const Layout& g, int m, int b) {
  if (g.ncomp == 1) return m;
  const int ny = g.hs0 * g.vs0;
  if (b >= ny) return b * g.mcus + m;
  const int my = m / g.mcux, mx = m - my * g.mcux;
  const int v = b / g.hs0, u = b - v * g.hs0;
  return (my * g.vs0 + v) * (g.mcux * g.hs0) + mx * g.hs0 + u;
}

// ── og_jpeg_entropy ────────────────────────────────────────────────────────

struct BitReader {
  const uint32_t* w;
  int next;        // next word to load
  int words;       // words of the segment (zero-padded to a word)
  uint64_t buf;    // n valid bits at the top, zeros below
  int n;

  // At least 32 valid bits after the call.
  __device__ __forceinline__ void refill() {
    if (n <= 32) {
      const uint32_t x = next < words ? __byte_perm(w[next], 0, 0x0123) : 0u;
      buf |= (uint64_t)x << (32 - n);
      n += 32;
      ++next;
    }
  }
  __device__ __forceinline__ uint32_t peek16() const {
    return (uint32_t)(buf >> 48);
  }
  __device__ __forceinline__ void skip(int k) {
    buf <<= k;
    n -= k;
  }
  // s in 1..16
  __device__ __forceinline__ uint32_t get(int s) {
    const uint32_t v = (uint32_t)(buf >> (64 - s));
    skip(s);
    return v;
  }
  __device__ __forceinline__ long long consumed() const {
    return 32LL * next - n;
  }
};

__device__ __forceinline__ int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

// One symbol of a table in shared memory, or -1 for an invalid code.
__device__ __forceinline__ int huff_decode(BitReader& br, const int32_t* tab) {
  const uint32_t top = br.peek16();
  const uint32_t e = reinterpret_cast<const uint16_t*>(tab)[top >> 7];
  if (e != 0) {
    br.skip((int)(e >> 8));
    return (int)(e & 0xFF);
  }
  for (int l = 10; l <= 16; ++l) {
    const int code = (int)(top >> (16 - l));
    if (code <= tab[kMaxcode + l]) {
      br.skip(l);
      return reinterpret_cast<const uint8_t*>(tab + kVals)[code +
                                                           tab[kDelta + l]];
    }
  }
  return -1;
}

__global__ void __launch_bounds__(32 * kSegWarps)
    entropy_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ segs, int nseg,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ comp,
                   const int32_t* __restrict__ quant,
                   int16_t* __restrict__ coef, int32_t* __restrict__ err,
                   Layout g, int nslots) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kSegWarps + warp;
  // per warp: its frame's tables, then one block of coefficients
  int32_t* tabs = reinterpret_cast<int32_t*>(smem) +
                  warp * (nslots * kTableWords + 32);
  int16_t* blk = reinterpret_cast<int16_t*>(tabs + nslots * kTableWords);
  if (seg >= nseg) return;
  const int32_t* sg = segs + (size_t)kSegWords * seg;
  const int off = sg[0], nbytes = sg[1], f = sg[2], m0 = sg[3], nm = sg[4];
  for (int s = 0; s < nslots; ++s) {
    const int id = slots[(size_t)f * nslots + s];
    if (id < 0) break;
    const int32_t* src = tables + (size_t)id * kTableWords;
    for (int i = lane; i < kTableWords; i += 32)
      tabs[s * kTableWords + i] = src[i];
  }
  __syncwarp();
  if (lane != 0) return;

  // per component (unrolled below, so these stay in registers): table
  // slots, the DC quantiser, the DC predictor
  int dc_slot[3], ac_slot[3], last[3];
  uint32_t q0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int cc = c < g.ncomp ? c : 0;
    dc_slot[c] = comp[((size_t)f * 3 + cc) * 2 + 0];
    ac_slot[c] = comp[((size_t)f * 3 + cc) * 2 + 1];
    q0[c] = (uint32_t)quant[((size_t)f * 3 + cc) * 64];
    last[c] = 1024;
  }
  BitReader br{reinterpret_cast<const uint32_t*>(data + off), 0,
               (nbytes + 3) >> 2, 0ull, 0};
  const int ny = g.ncomp == 1 ? 1 : g.hs0 * g.vs0;
  int4* blk4 = reinterpret_cast<int4*>(blk);
  bool bad = false;
  for (int m = m0; m < m0 + nm && !bad; ++m) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c >= g.ncomp || bad) break;
      const int32_t* dc = tabs + dc_slot[c] * kTableWords;
      const int32_t* ac = tabs + ac_slot[c] * kTableWords;
      const int nb = c == 0 ? ny : 1;
      for (int k = 0; k < nb; ++k) {
#pragma unroll
        for (int z = 0; z < 8; ++z) blk4[z] = make_int4(0, 0, 0, 0);
        // DC: the size, its extra bits, the prediction in dequantised units
        br.refill();
        const int s = huff_decode(br, dc);
        if (s < 0 || s > 16) {
          bad = true;
          break;
        }
        const int diff = s ? extend(br.get(s), s) : 0;
        last[c] = (int)((uint32_t)diff * q0[c] + (uint32_t)last[c]);
        blk[0] = (int16_t)max(-32768, min(32767, last[c]));
        // AC: (run, size) symbols; EOB or position 63 ends the block
        int i = 0;
        while (i < 63) {
          br.refill();
          const int sym = huff_decode(br, ac);
          if (sym < 0) {
            bad = true;
            break;
          }
          if (sym == 0) break;
          i += (sym >> 4) + 1;
          const int sz = sym & 15;
          if (sz) {
            const int v = extend(br.get(sz), sz);
            if (i > 63) {
              bad = true;
              break;
            }
            blk[kZigzag[i]] = (int16_t)v;
          }
        }
        if (bad || br.consumed() > 8LL * nbytes) {
          bad = true;
          break;
        }
        const int b = c == 0 ? k : ny + c - 1;
        int4* dst = reinterpret_cast<int4*>(
            coef + ((size_t)f * g.nblk + block_index(g, m, b)) * 64);
#pragma unroll
        for (int z = 0; z < 8; ++z) dst[z] = blk4[z];
      }
    }
  }
  if (bad) err[f] = 1;
}

// ── og_jpeg_idct_bgr ───────────────────────────────────────────────────────

__device__ __forceinline__ void butterfly(const int* x, unsigned a0,
                                          unsigned* o) {
  unsigned a1 = a0, a2 = a0, a3 = a0;
  const unsigned x1 = x[1], x2 = x[2], x3 = x[3], x4 = x[4], x5 = x[5],
                 x6 = x[6], x7 = x[7];
  a0 += W2 * x2 + W4 * x4 + W6 * x6;
  a1 += W6 * x2 - W4 * x4 - W2 * x6;
  a2 += -W6 * x2 - W4 * x4 + W2 * x6;
  a3 += -W2 * x2 + W4 * x4 - W6 * x6;
  const unsigned b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7;
  const unsigned b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7;
  const unsigned b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7;
  const unsigned b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7;
  o[0] = a0 + b0;
  o[1] = a1 + b1;
  o[2] = a2 + b2;
  o[3] = a3 + b3;
  o[4] = a3 - b3;
  o[5] = a2 - b2;
  o[6] = a1 - b1;
  o[7] = a0 - b0;
}

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return (uint8_t)min(255, max(0, v));
}

__global__ void __launch_bounds__(kIdctThreads)
    idct_bgr_kernel(const int16_t* __restrict__ coef,
                    const int32_t* __restrict__ quant,
                    uint8_t* __restrict__ out, Layout g, int h, int w,
                    int mpb, int form) {
  __shared__ __align__(16) int16_t rows[kMaxJobs * 64];
  __shared__ uint8_t pix[kMaxJobs * 64];
  __shared__ int32_t q[3 * 64];
  const int f = blockIdx.z, my = blockIdx.y, mx0 = blockIdx.x * mpb;
  const int nm = min(mpb, g.mcux - mx0);
  const int bpm = blocks_per_mcu(g);
  const int jobs = nm * bpm;
  for (int i = threadIdx.x; i < g.ncomp * 64; i += blockDim.x)
    q[i] = quant[(size_t)f * 3 * 64 + i];
  __syncthreads();
  // rows: dequantise the AC levels, one row of 8 a thread
  for (int r = threadIdx.x; r < jobs * 8; r += blockDim.x) {
    const int j = r >> 3, row = r & 7;
    const int mi = j / bpm, b = j - mi * bpm;
    const int m = my * g.mcux + mx0 + mi;
    const int* qc = q + component_of(g, b) * 64 + row * 8;
    const int4 v = *reinterpret_cast<const int4*>(
        coef + ((size_t)f * g.nblk + block_index(g, m, b)) * 64 + row * 8);
    const int32_t words[4] = {v.x, v.y, v.z, v.w};
    int x[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = (int16_t)(words[k] & 0xFFFF);
      x[2 * k + 1] = (int16_t)((uint32_t)words[k] >> 16);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (row | k) x[k] = (int16_t)(x[k] * qc[k]);
    int16_t* dst = rows + j * 64 + row * 8;
    if ((x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0) {
      const int16_t d = (int16_t)(x[0] * 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k] = d;
    } else {
      unsigned o[8];
      butterfly(x, (unsigned)W4 * (unsigned)x[0] + (1u << 10), o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dst[k] = (int16_t)max(-32768, min(32767, (int)o[k] >> 11));
    }
  }
  __syncthreads();
  // columns: >> 20 and the clamp
  for (int r = threadIdx.x; r < jobs * 8; r += blockDim.x) {
    const int j = r >> 3, col = r & 7;
    int x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = rows[j * 64 + k * 8 + col];
    unsigned o[8];
    butterfly(x, (unsigned)W4 * (unsigned)(int16_t)(x[0] + 32), o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      pix[j * 64 + k * 8 + col] = clamp_u8((int)o[k] >> 20);
  }
  __syncthreads();
  // pixels of the strip: rows of nm MCUs, neighbouring threads neighbouring
  // pixels; the MCU padding cropped
  const int uw = 8 * g.hs0, uh = 8 * g.vs0;
  const int sw = nm * uw;
  const int ny = g.hs0 * g.vs0;
  for (int i = threadIdx.x; i < sw * uh; i += blockDim.x) {
    const int py = i / sw, sx = i - py * sw;
    const int mi = sx / uw, px = sx - mi * uw;
    const int gy = my * uh + py, gx = (mx0 + mi) * uw + px;
    if (gy >= h || gx >= w) continue;
    const int jb = mi * bpm;
    const int y = pix[(jb + (py >> 3) * g.hs0 + (px >> 3)) * 64 +
                      (py & 7) * 8 + (px & 7)];
    if (form == 0) {
      out[((size_t)f * h + gy) * w + gx] = (uint8_t)y;
      continue;
    }
    const int ci = (py / g.vs0) * 8 + px / g.hs0;
    const int u = pix[(jb + ny) * 64 + ci] - 128;
    const int v = pix[(jb + ny + 1) * 64 + ci] - 128;
    int cb, cg, cr;
    if (form == 2) {
      const int yy = (y << 22) + (1 << 21);
      cb = (yy + (u << 9) * C_UB) >> 22;
      cg = (yy + (v << 9) * C_VG + (u << 9) * C_UG) >> 22;
      cr = (yy + (v << 9) * C_VR) >> 22;
    } else {
      const int u8 = u << 3, v8 = v << 3;
      cb = y + ((u8 * C_UB) >> 16);
      cg = y + ((u8 * C_UG) >> 16) + ((v8 * C_VG) >> 16);
      cr = y + ((v8 * C_VR) >> 16);
    }
    uint8_t* o = out + (((size_t)f * h + gy) * w + gx) * 3;
    o[0] = clamp_u8(cb);
    o[1] = clamp_u8(cg);
    o[2] = clamp_u8(cr);
  }
}

bool valid_layout(const Layout& g) {
  if (g.ncomp == 1) return g.hs0 == 1 && g.vs0 == 1 && g.mcus == g.nblk;
  return g.ncomp == 3 && g.hs0 >= 1 && g.hs0 <= 2 && g.vs0 >= 1 &&
         g.vs0 <= g.hs0 && g.nblk == (g.hs0 * g.vs0 + 2) * g.mcus;
}

}  // namespace

extern "C" {

// Shared memory of og_jpeg_entropy a block, for nslots table slots a frame.
int og_jpeg_entropy_smem(int nslots) {
  return kSegWarps * (nslots * kTableWords + 32) * 4;
}

// data: packed segment bytes (4-byte aligned); segs: (nseg, 5) int32;
// tables: (nt, 360) int32; slots: (t, nslots) int32; comp: (t, 3, 2) int32;
// quant: (t, 3, 64) int32; coef: (t, nblk, 64) int16; err: (t,) int32,
// zeroed by the caller.
int og_jpeg_entropy(const void* data, const void* segs, int nseg,
                    const void* tables, const void* slots, const void* comp,
                    const void* quant, void* coef, void* err, int ncomp,
                    int mcux, int mcus, int hs0, int vs0, int nblk,
                    int nslots, void* stream) {
  const Layout g{ncomp, mcux, mcus, hs0, vs0, nblk};
  if (nseg < 0 || nslots < 1 || nslots > kMaxSlots || mcux < 1 ||
      !valid_layout(g))
    return (int)cudaErrorInvalidValue;
  if (nseg == 0) return (int)cudaSuccess;
  const int smem = og_jpeg_entropy_smem(nslots);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        entropy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        og_jpeg_entropy_smem(kMaxSlots));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int blocks = (nseg + kSegWarps - 1) / kSegWarps;
  entropy_kernel<<<blocks, 32 * kSegWarps, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(segs),
      nseg, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(comp),
      static_cast<const int32_t*>(quant), static_cast<int16_t*>(coef),
      static_cast<int32_t*>(err), g, nslots);
  return (int)cudaGetLastError();
}

// MCUs a block of og_jpeg_idct_bgr takes along a row.
int og_jpeg_idct_mcus(int ncomp, int hs0, int vs0, int mcux) {
  const int bpm = ncomp == 1 ? 1 : hs0 * vs0 + 2;
  const int m = kMaxJobs / bpm;
  return mcux < m ? mcux : m;
}

// coef: (t, nblk, 64) int16; quant: (t, 3, 64) int32; out: (t, h, w, 3)
// uint8 (form 1, 2) or (t, h, w) uint8 (form 0).
int og_jpeg_idct_bgr(const void* coef, const void* quant, void* out, int t,
                     int h, int w, int ncomp, int mcux, int mcuy, int hs0,
                     int vs0, int nblk, int form, void* stream) {
  const Layout g{ncomp, mcux, mcux * mcuy, hs0, vs0, nblk};
  if (t < 0 || h <= 0 || w <= 0 || mcux < 1 || mcuy < 1 || form < 0 ||
      form > 2 || (form == 0) != (ncomp == 1) || (form == 1 && (h & 1)) ||
      !valid_layout(g) || t > 65535 || mcuy > 65535 || h > 8 * vs0 * mcuy ||
      w > 8 * hs0 * mcux)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const int mpb = og_jpeg_idct_mcus(ncomp, hs0, vs0, mcux);
  const dim3 grid((mcux + mpb - 1) / mpb, mcuy, t);
  idct_bgr_kernel<<<grid, kIdctThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coef), static_cast<const int32_t*>(quant),
      static_cast<uint8_t*>(out), g, h, w, mpb, form);
  return (int)cudaGetLastError();
}

}  // extern "C"
