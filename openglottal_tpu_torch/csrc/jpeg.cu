// Baseline JPEG (MJPG video frames) on the card, two kernels a chunk:
//
//   og_jpeg_entropy   Huffman decode, DC prediction and de-zigzag into int16
//                     coefficient blocks: a split-and-synchronise parallel
//                     decode, one thread block a frame, one thread a
//                     subsequence of S bits of an entropy-coded segment
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
// rows of (byte offset, byte count, frame, first MCU, MCU count) in frame
// order, the chunk's distinct Huffman tables, per frame its table slots and
// per component its quantisation table.  The plain versions of both kernels
// are data/jpeg.py's entropy_decode_plain and idct_bgr_plain, which
// chip_smoke.py holds these equal to byte for byte.
//
// og_jpeg_entropy.  Bound: the compressed bytes in and the coefficients out
// (64 int16 a block) over the memory rate, ~0.03 ms for 502 frames of 256²
// 4:2:0.  What holds a decode back is that a symbol's length is known only
// after its lookup: one segment (a cv2-written frame has one) is one chain
// of ~30,000 dependent lookups, ~5 ms on one lane.  Design, after
// Weissenberger and Schmidt (ICPP 2018; the JPEG form HiPC 2021): each
// segment is cut into subsequences of S bits (S a launch argument; the
// wrapper passes 1536, and chip_smoke.py's mjpg line times 1024, 1536 and
// 2048; a segment shorter than S is one), one thread each, and a block of 128
// threads takes the segments of one frame, in groups of up to 128 segments,
// with the frame's Huffman tables and a copy of the group's stream (up to
// 28 KB, the rest read from device memory) in shared memory.  A decoder's
// state is its bit position, its slot in the MCU (which component's tables)
// and its zigzag position (DC or the AC position); a subsequence owns the
// blocks whose DC begins in it and decodes past its end to finish them.
//   A (synchronise)  each thread decodes from a guessed start (its first
//     bit, luma AC) up to the first symbol boundary at or past its end and
//     records that exit state, the DCs it began and, per component, the sum
//     of diff * q0 (mod 2**32).  Then, in rounds, each thread whose left
//     neighbour's exit differs from the start it last used decodes again
//     from that exit, until no exit changes.  The first subsequence of a
//     segment starts exact (bit 0, slot 0, DC), so round r makes the first
//     r + 1 exact and the rounds end; a stream that never synchronises (codes
//     of equal lengths) costs the serial chain, never a wrong answer.  An
//     invalid code (or a DC size above 16, a coefficient past 63) met by
//     such a decode consumes nothing and re-guesses one bit on with the next
//     slot: from an exact start it is an error of the stream, flagged below.
//     On cv2-written 256² frames a guess synchronises within a subsequence
//     about half the time (a wrong slot among the four luma blocks keeps a
//     decoder on the right bits for a while), so a frame takes several
//     rounds, and they are most of the time.
//   B (scan)  an exclusive scan of (DCs begun, the three sums) over each
//     segment's subsequences gives each its first block and its DC
//     predictors; the wrapping sums are associative, so the DC values are
//     bit-equal to the serial last = diff * q0 + last.
//   C (write)  each thread decodes again from its synchronised start: the
//     tail of a block begun before it is skipped, then every block whose DC
//     begins before its end is decoded, up to the segment's last needed
//     block (MCU count x blocks an MCU), into the frame's coefficients,
//     which the block zeroes first (the wrapper allocates with torch.empty).
// Errors exactly as the serial decode's: only a needed block decoded in C
// flags its frame (an invalid code, a DC size above 16, a coefficient past
// position 63, or a block that ends past the segment's bits); fill bits and
// junk after the last needed block are never decoded into an error.  One
// lookup a symbol in the common case: a 16-bit entry on the top 10 bits
// gives the bits of code and extra bits together, their size, the run and
// EOB (the extended value is read from the bits, off the chain of lookups);
// longer codes compare the canonical max codes of lengths 11-16 at once.
// One step a symbol, the same for DC and AC.  Scratch: 32 bytes a
// subsequence (og_jpeg_entropy_scratch_bytes).
//
// og_jpeg_idct_bgr.  Bound: the coefficients in and the pixels out over the
// memory rate, ~0.06 ms for 502 frames of 256² 4:2:0.  Design: one
// instantiation per layout (gray; 4:4:4 in the full colour form, 4:2:2 and
// 4:2:0 in the paired form), so every index is a shift or a constant; a
// block takes a strip of one MCU row (32 MCUs gray, 8 of the others), a
// thread an IDCT row: 16-byte coefficient loads, the row pass in registers,
// a transpose through shared memory padded to 72 halfwords a block (no bank
// conflicts), the column pass, the colour conversion (two neighbouring
// pixels a thread) into a shared copy of the strip's output rows aligned as
// their destination, then 16-byte stores.
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
constexpr int kSegWords = 5;

constexpr int kEntThreads = 128;      // subsequences a round of a block
constexpr int kEntWarps = kEntThreads / 32;
constexpr int kFastBits = 10;         // lookahead of the one-lookup table
constexpr int kBadSize = 31;          // entry size of a DC size above 16
constexpr int kStageWords = 7168;     // words of a group's stream in shared
constexpr int kBlkStride = 72;        // halfwords of an IDCT block's rows
constexpr int kMinSubBits = 32;
constexpr int kMaxSubBits = 1 << 20;

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

bool valid_layout(const Layout& g) {
  if (g.ncomp == 1) return g.hs0 == 1 && g.vs0 == 1 && g.mcus == g.nblk;
  return g.ncomp == 3 && g.hs0 >= 1 && g.hs0 <= 2 && g.vs0 >= 1 &&
         g.vs0 <= g.hs0 && g.nblk == (g.hs0 * g.vs0 + 2) * g.mcus;
}

// ── og_jpeg_entropy ────────────────────────────────────────────────────────

// A subsequence's record in the scratch: the state it last started from
// (bit 63: to be decoded again) and its exit state, then the DCs it began
// and per component the sum of diff * q0; after the scan, their exclusive
// prefixes over the block's group.
struct Sub {
  unsigned long long start;
  unsigned long long exit;
  uint32_t v[4];
};
constexpr unsigned long long kDirty = 1ull << 63;

__device__ __forceinline__ unsigned long long pack_state(int pos, int slot,
                                                         int z) {
  return (unsigned long long)(uint32_t)pos |
         ((unsigned long long)slot << 32) |
         ((unsigned long long)(z + 1) << 36);
}

// The bits of one segment: its words from the block's staged copy in shared
// memory (byte-swapped to host order) where staged, else from device memory;
// zeros past its end.
struct BitReader {
  const uint32_t* gw;   // the segment's words in device memory
  const uint32_t* sw;   // its staged words (the first ns of them)
  int ns;
  int words;            // words of the segment (zero-padded to a word)
  int next;             // the next word to take, loaded ahead into nw
  uint32_t nw;
  uint64_t buf;         // n valid bits at the top, zeros below
  int n;
  int pos;              // bits of the segment consumed

  __device__ __forceinline__ uint32_t word(int w) const {
    return w < ns ? sw[w]
                  : (w < words ? __byte_perm(__ldg(gw + w), 0, 0x0123) : 0u);
  }
  // At least 32 valid bits after the call; the word after loaded ahead.
  __device__ __forceinline__ void refill() {
    if (n <= 32) {
      buf |= (uint64_t)nw << (32 - n);
      n += 32;
      nw = word(++next);
    }
  }
  __device__ __forceinline__ void skip(int k) {
    buf <<= k;
    n -= k;
    pos += k;
  }
  __device__ __forceinline__ void seek(int bit) {
    next = bit >> 5;
    nw = word(next);
    buf = 0;
    n = 0;
    refill();
    refill();
    pos = bit & ~31;
    skip(bit & 31);
  }
};

__device__ __forceinline__ int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

// A symbol's entry: the bits of its code and extra bits together (0-5),
// the size of the extra bits (6-10; kBadSize for a DC size above 16, an
// error), the AC run (11-14) and EOB (bit 15); 0 for an invalid code.  The
// extended value is read from the bits after the code, off the chain of
// lookups.
__device__ __forceinline__ int make_entry(int len, int sym, bool dc) {
  const int s = dc ? (sym > 16 ? kBadSize : sym) : (sym & 15);
  return (len + (s > 16 ? 0 : s)) | (s << 6) |
         ((dc ? 0 : sym >> 4) << 11) | (!dc && sym == 0 ? 1 << 15 : 0);
}

// The one-lookup table's entry of 10-bit prefix x of a table row (in shared
// memory): 0 where the code is longer than 10 bits or none begins there.
__device__ uint16_t fast_entry(const int32_t* row, bool dc, int x) {
  const uint32_t e9 = reinterpret_cast<const uint16_t*>(row)[x >> 1];
  if (e9 != 0)
    return (uint16_t)make_entry((int)(e9 >> 8), (int)(e9 & 0xFF), dc);
  if (x > row[kMaxcode + kFastBits]) return 0;
  const uint8_t* vals = reinterpret_cast<const uint8_t*>(row + kVals);
  return (uint16_t)make_entry(kFastBits,
                              vals[x + row[kDelta + kFastBits]], dc);
}

struct Tables {
  const uint16_t* fast;  // shared: table t = 2c + k (k 0 DC, 1 AC)
  const int32_t* rows;   // shared: the rows, kTableWords apart
  int ny, bpm;
  uint32_t q0a, q0b, q0c;  // DC quantisers of the components

  __device__ __forceinline__ int comp(int slot) const {
    return slot < ny ? 0 : slot - ny + 1;
  }
  __device__ __forceinline__ uint32_t q0(int c) const {
    return c == 0 ? q0a : c == 1 ? q0b : q0c;
  }
  // The entry of the symbol at the reader's position in table t: one
  // lookup; past 10 bits the canonical max codes of lengths 11-16 compared
  // all at once.
  __device__ __forceinline__ int lookup(const BitReader& br, int t) const {
    const int e = fast[(t << kFastBits) | (int)(br.buf >> (64 - kFastBits))];
    if (e != 0) return e;
    const int32_t* row = rows + t * kTableWords;
    const uint32_t top = (uint32_t)(br.buf >> 48);
    int len = 0;
#pragma unroll
    for (int l = 16; l > kFastBits; --l)
      len = (int)(top >> (16 - l)) <= row[kMaxcode + l] ? l : len;
    if (len == 0) return 0;
    return make_entry(
        len,
        reinterpret_cast<const uint8_t*>(row + kVals)[(int)(top >> (16 - len)) +
                                                      row[kDelta + len]],
        (t & 1) == 0);
  }
};

// The extended value of entry e at the reader's position (before its skip).
__device__ __forceinline__ int value_of(const BitReader& br, int e) {
  const int s = (e >> 6) & 31;
  return s ? extend((uint32_t)((br.buf << ((e & 63) - s)) >> (64 - s)), s)
           : 0;
}

__device__ __forceinline__ void add3(uint32_t& a, uint32_t& b, uint32_t& c,
                                     int k, uint32_t v) {
  a += k == 0 ? v : 0u;
  b += k == 1 ? v : 0u;
  c += k == 2 ? v : 0u;
}

// Phase A: decode from (br.pos, slot, z) while br.pos < end; the DCs begun
// and the sums into v.  An invalid code, a DC size above 16 or a
// coefficient past 63 consumes nothing and re-guesses one bit on, luma AC
// at the next slot.  One step a symbol, the same for DC and AC.
__device__ __forceinline__ void sync_decode(BitReader& br, const Tables& tb,
                                            int& slot, int& z, int end,
                                            uint32_t* v) {
  int rg = 0;
  while (br.pos < end) {
    br.refill();
    const bool dc = z < 0;
    const int c = tb.comp(slot);
    const int e = tb.lookup(br, 2 * c + !dc);
    const int s = (e >> 6) & 31, run = (e >> 11) & 15;
    const int zn = dc ? 0 : z + run + 1;
    v[0] += dc;
    if (e == 0 || s > 16 || (!dc && s != 0 && zn > 63)) {
      rg = rg + 1 == tb.bpm ? 0 : rg + 1;
      slot = rg;
      z = 0;
      br.skip(1);
      continue;
    }
    if (dc) add3(v[1], v[2], v[3], c, (uint32_t)value_of(br, e) * tb.q0(c));
    br.skip(e & 63);
    const bool endb = !dc && (zn >= 63 || (e & (1 << 15)));
    z = endb ? -1 : zn;
    slot = endb ? (slot + 1 == tb.bpm ? 0 : slot + 1) : slot;
  }
}

// Index in the frame's coefficient blocks of slot b of the MCU at (my, mx):
// luma in (mcuy * vs0) rows of (mcux * hs0) blocks, then Cb and Cr a block
// an MCU.
__device__ __forceinline__ int block_index(const Layout& g, int ny, int my,
                                           int mx, int b) {
  if (g.ncomp == 1) return my * g.mcux + mx;
  if (b >= ny) return b * g.mcus + my * g.mcux + mx;
  const int v = g.hs0 == 2 ? b >> 1 : b, u = g.hs0 == 2 ? b & 1 : 0;
  return (my * g.vs0 + v) * (g.mcux * g.hs0) + mx * g.hs0 + u;
}

// Phase C: from the synchronised start, skip the tail of a block begun
// before this subsequence, then decode and write block b (segment-relative)
// and on while its DC begins before end, up to block `needed`, one symbol a
// step, into the frame's coefficients (zeroed by the block beforehand).
// True when a needed block is corrupt or ends past the segment's bits.
__device__ __forceinline__ bool write_decode(
    BitReader& br, const Tables& tb, const Layout& g, int slot, int z,
    int end, int b, int needed, int m0, int nbits, uint32_t* last,
    const uint8_t* zz, int16_t* __restrict__ coef) {
  while (z >= 0 && br.pos < end) {      // its owner writes that block
    br.refill();
    const int e = tb.lookup(br, 2 * tb.comp(slot) + 1);
    const int s = (e >> 6) & 31, zn = z + ((e >> 11) & 15) + 1;
    if (e == 0 || (s != 0 && zn > 63)) return false;
    br.skip(e & 63);
    z = (zn >= 63 || (e & (1 << 15))) ? -1 : zn;
  }
  if (z >= 0 || br.pos >= end || b >= needed) return false;
  const int mi = b / tb.bpm;
  slot = b - mi * tb.bpm;
  const int m = m0 + mi;
  int my = m / g.mcux, mx = m - my * g.mcux;
  int16_t* out = coef;
  for (;;) {
    const bool dc = z < 0;
    if (dc) {
      if (br.pos >= end || b >= needed) return false;
      out = coef + (size_t)block_index(g, tb.ny, my, mx, slot) * 64;
    }
    br.refill();
    const int c = tb.comp(slot);
    const int e = tb.lookup(br, 2 * c + !dc);
    const int s = (e >> 6) & 31, run = (e >> 11) & 15;
    const int zn = dc ? 0 : z + run + 1;
    if (e == 0 || s > 16 || (!dc && s != 0 && zn > 63)) return true;
    const int value = value_of(br, e);
    br.skip(e & 63);
    if (dc) {
      const uint32_t d = (uint32_t)value * tb.q0(c) +
                         (c == 0 ? last[0] : c == 1 ? last[1] : last[2]);
      last[0] = c == 0 ? d : last[0];
      last[1] = c == 1 ? d : last[1];
      last[2] = c == 2 ? d : last[2];
      out[0] = (int16_t)max(-32768, min(32767, (int)d));
    } else if (s != 0) {
      out[zz[zn]] = (int16_t)value;
    }
    const bool endb = !dc && (zn >= 63 || (e & (1 << 15)));
    z = endb ? -1 : zn;
    if (endb) {
      if (br.pos > nbits) return true;
      ++b;
      if (++slot == tb.bpm) {
        slot = 0;
        if (++mx == g.mcux) {
          mx = 0;
          ++my;
        }
      }
    }
  }
}

// First segment row whose frame is >= f (the rows are in frame order).
__device__ int lower_bound_frame(const int32_t* segs, int nseg, int f) {
  int lo = 0, hi = nseg;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (segs[(size_t)kSegWords * mid + 2] < f) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Exclusive scan of four uint32 over the block (wrapping); the totals too.
// Every thread calls it.
__device__ void block_scan4(uint32_t* v, uint32_t* total,
                            uint32_t (*warp_tot)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) inc[k] = v[k];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, inc[k], o);
      if (lane >= o) inc[k] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 4; ++k) warp_tot[warp][k] = inc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t pre = 0, tot = 0;
    for (int w = 0; w < kEntWarps; ++w) {
      pre += w < warp ? warp_tot[w][k] : 0u;
      tot += warp_tot[w][k];
    }
    v[k] = pre + inc[k] - v[k];
    total[k] = tot;
  }
  __syncthreads();
}

__device__ __forceinline__ int find_segment(const int* pre, int ng, int l) {
  int lo = 0, hi = ng - 1;      // last j with pre[j] <= l
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= l) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kEntThreads)
    entropy_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ segs, int nseg,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ comp,
                   const int32_t* __restrict__ quant,
                   int16_t* __restrict__ coef, int32_t* __restrict__ err,
                   Sub* subs, Layout g, int nslots, int sub_bits,
                   int data_words) {
  extern __shared__ int4 smem[];
  // the frame's table rows, the staged words of a group's segments, the
  // one-lookup tables
  const int ntab = 2 * g.ncomp;
  int32_t* rows = reinterpret_cast<int32_t*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(rows + ntab * kTableWords);
  uint16_t* fast = reinterpret_cast<uint16_t*>(stage + kStageWords);
  __shared__ const int32_t* s_src[6];
  __shared__ uint8_t s_zz[64];
  __shared__ int s_lo, s_hi;
  __shared__ int s_off[kEntThreads], s_nb[kEntThreads], s_m0[kEntThreads],
      s_nm[kEntThreads], s_pre[kEntThreads + 1];
  __shared__ long long s_gid[kEntThreads];
  __shared__ uint32_t s_warp[kEntWarps][4];
  const int f = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    s_lo = lower_bound_frame(segs, nseg, f);
    s_hi = lower_bound_frame(segs, nseg, f + 1);
  }
  if (tid < 64) s_zz[tid] = kZigzag[tid];
  // the frame's coefficients zeroed: the decode writes only the non-zero
  int16_t* fcoef = coef + (size_t)f * g.nblk * 64;
  for (int i = tid; i < g.nblk * 8; i += kEntThreads)
    reinterpret_cast<int4*>(fcoef)[i] = make_int4(0, 0, 0, 0);
  if (tid < ntab) {
    const int s = comp[((size_t)f * 3 + (tid >> 1)) * 2 + (tid & 1)];
    s_src[tid] = tables + (size_t)slots[(size_t)f * nslots + s] * kTableWords;
  }
  __syncthreads();
  for (int i = tid; i < ntab * kTableWords; i += kEntThreads)
    rows[i] = s_src[i / kTableWords][i % kTableWords];
  __syncthreads();
  for (int i = tid; i < ntab << kFastBits; i += kEntThreads)
    fast[i] = fast_entry(rows + (i >> kFastBits) * kTableWords,
                         ((i >> kFastBits) & 1) == 0,
                         i & ((1 << kFastBits) - 1));
  Tables tb;
  tb.fast = fast;
  tb.rows = rows;
  tb.ny = g.ncomp == 1 ? 1 : g.hs0 * g.vs0;
  tb.bpm = g.ncomp == 1 ? 1 : tb.ny + 2;
  tb.q0a = (uint32_t)quant[(size_t)f * 3 * 64];
  tb.q0b = g.ncomp == 3 ? (uint32_t)quant[((size_t)f * 3 + 1) * 64] : 0u;
  tb.q0c = g.ncomp == 3 ? (uint32_t)quant[((size_t)f * 3 + 2) * 64] : 0u;
  const int lo = s_lo, hi = s_hi;
  bool bad = false;

  for (int g0 = lo; g0 < hi; g0 += kEntThreads) {
    const int ng = min(kEntThreads, hi - g0);
    // the group's segments, their subsequence counts and offsets
    uint32_t cnt[4] = {0, 0, 0, 0}, tot[4];
    if (tid < ng) {
      const int32_t* sg = segs + (size_t)kSegWords * (g0 + tid);
      s_off[tid] = sg[0];
      s_nb[tid] = sg[1];
      s_m0[tid] = sg[3];
      s_nm[tid] = sg[4];
      const long long bits = 8LL * sg[1];
      cnt[0] = (uint32_t)max(1LL, (bits + sub_bits - 1) / sub_bits);
      s_gid[tid] = (long long)(g0 + tid) + 8LL * sg[0] / sub_bits;
    }
    block_scan4(cnt, tot, s_warp);
    if (tid < ng) s_pre[tid] = (int)cnt[0];
    if (tid == 0) s_pre[ng] = (int)tot[0];
    __syncthreads();
    const int tg = s_pre[ng];
    // the words from the group's first segment on, as many as the stage
    // holds, byte-swapped; a reader takes the rest from device memory
    const int w0 = s_off[0] >> 2;
    const int nstage = min(kStageWords, data_words - w0);
    for (int i = tid; i < nstage; i += kEntThreads)
      stage[i] = __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(data) +
                                   w0 + i), 0, 0x0123);
    __syncthreads();
    // a reader of segment j of the group
    auto reader = [&](int j) {
      const int sw = (s_off[j] >> 2) - w0;
      const int words = (s_nb[j] + 3) >> 2;
      return BitReader{
          reinterpret_cast<const uint32_t*>(data) + (s_off[j] >> 2),
          stage + max(0, sw), sw < 0 ? 0 : max(0, min(words, nstage - sw)),
          words};
    };

    // A: round 0 from the guesses (the exact start for each first one)
    for (int l = tid; l < tg; l += kEntThreads) {
      const int j = find_segment(s_pre, ng, l), k = l - s_pre[j];
      const int nsub = s_pre[j + 1] - s_pre[j];
      Sub* r = subs + s_gid[j] + k;
      int slot = 0, z = k == 0 ? -1 : 0;
      r->start = pack_state(k * sub_bits, slot, z);
      uint32_t v[4] = {0, 0, 0, 0};
      if (k < nsub - 1) {
        BitReader br = reader(j);
        br.seek(k * sub_bits);
        sync_decode(br, tb, slot, z, (k + 1) * sub_bits, v);
        r->exit = pack_state(br.pos, slot, z);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) r->v[q] = v[q];
    }
    // A: rounds from the neighbours' exits until none changes
    for (int round = 0; round <= tg; ++round) {
      __syncthreads();
      for (int l = tid; l < tg; l += kEntThreads) {
        const int j = find_segment(s_pre, ng, l), k = l - s_pre[j];
        if (k == 0) continue;
        Sub* r = subs + s_gid[j] + k;
        const unsigned long long e = (r - 1)->exit;
        if (e != r->start) r->start = e | kDirty;
      }
      __syncthreads();
      int changed = 0;
      for (int l = tid; l < tg; l += kEntThreads) {
        const int j = find_segment(s_pre, ng, l), k = l - s_pre[j];
        Sub* r = subs + s_gid[j] + k;
        const unsigned long long st = r->start;
        if (!(st & kDirty)) continue;
        r->start = st & ~kDirty;
        if (k == s_pre[j + 1] - s_pre[j] - 1) continue;
        int slot = (int)((st >> 32) & 7), z = (int)((st >> 36) & 127) - 1;
        BitReader br = reader(j);
        br.seek((int)(uint32_t)st);
        uint32_t v[4] = {0, 0, 0, 0};
        sync_decode(br, tb, slot, z, (k + 1) * sub_bits, v);
        const unsigned long long e = pack_state(br.pos, slot, z);
        if (e != r->exit) {
          r->exit = e;
          changed = 1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) r->v[q] = v[q];
      }
      if (!__syncthreads_or(changed)) break;
    }

    // B: exclusive prefixes over the group, a tile of kEntThreads at a time
    uint32_t carry[4] = {0, 0, 0, 0};
    for (int t0 = 0; t0 < tg; t0 += kEntThreads) {
      const int l = t0 + tid;
      uint32_t v[4] = {0, 0, 0, 0};
      Sub* r = nullptr;
      if (l < tg) {
        const int j = find_segment(s_pre, ng, l);
        r = subs + s_gid[j] + (l - s_pre[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = r->v[q];
      }
      block_scan4(v, tot, s_warp);
      if (r != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) r->v[q] = carry[q] + v[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) carry[q] += tot[q];
    }
    __syncthreads();

    // C: decode from the synchronised starts and write
    for (int l = tid; l < tg; l += kEntThreads) {
      const int j = find_segment(s_pre, ng, l), k = l - s_pre[j];
      const int nsub = s_pre[j + 1] - s_pre[j];
      const Sub* first = subs + s_gid[j];
      const Sub* r = first + k;
      uint32_t last[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        last[q] = 1024u + r->v[q + 1] - first->v[q + 1];
      const int b = (int)(r->v[0] - first->v[0]);
      const unsigned long long st = r->start;
      BitReader br = reader(j);
      br.seek((int)(uint32_t)st);
      const int end = k == nsub - 1 ? 0x7fffffff : (k + 1) * sub_bits;
      if (write_decode(br, tb, g, (int)((st >> 32) & 7),
                       (int)((st >> 36) & 127) - 1, end, b,
                       s_nm[j] * tb.bpm, s_m0[j], 8 * s_nb[j], last, s_zz,
                       fcoef))
        bad = true;
    }
    __syncthreads();
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

// A layout's constants: FORM 0 gray (HS = VS = 1), 1 paired, 2 full.
template <int FORM, int HS, int VS>
struct Idct {
  static constexpr int kNc = FORM == 0 ? 1 : 3;
  static constexpr int kNy = HS * VS;
  static constexpr int kBpm = FORM == 0 ? 1 : kNy + 2;
  static constexpr int kMcus = kBpm == 1 ? 32 : 8;  // MCUs a block
  static constexpr int kJobs = kMcus * kBpm;       // IDCT blocks a block
  static constexpr int kThreads = kJobs * 8;       // a row (a column) each
  static constexpr int kUw = 8 * HS, kUh = 8 * VS; // an MCU's pixels
  static constexpr int kSw = kMcus * kUw;          // the strip's width
  static constexpr int kCh = FORM == 0 ? 1 : 3;
  static constexpr int kRowBytes = kSw * kCh;
  static constexpr int kStage = kRowBytes + 16;    // + the alignment shift
  static constexpr int kPix = 72;                  // bytes a block's pixels
};

template <int FORM, int HS, int VS>
__global__ void __launch_bounds__(Idct<FORM, HS, VS>::kThreads)
    idct_bgr_kernel(const int16_t* __restrict__ coef,
                    const int32_t* __restrict__ quant,
                    uint8_t* __restrict__ out, int mcux, int mcuy, int h,
                    int w, int nblk) {
  using L = Idct<FORM, HS, VS>;
  __shared__ __align__(16) int16_t rows[L::kJobs * kBlkStride];
  __shared__ __align__(16) uint8_t pix[L::kJobs * L::kPix];
  __shared__ __align__(16) uint8_t stage[L::kUh * L::kStage];
  __shared__ int32_t q[L::kNc * 64];
  __shared__ int shift[L::kUh];       // each output row's address mod 16
  const int tid = threadIdx.x;
  const int f = blockIdx.z, my = blockIdx.y, mx0 = blockIdx.x * L::kMcus;
  const int nm = min(L::kMcus, mcux - mx0);
  const int mcus = mcux * mcuy;
  const int gx0 = mx0 * L::kUw;
  const int sw = min(nm * L::kUw, w - gx0);
  for (int i = tid; i < L::kNc * 64; i += L::kThreads)
    q[i] = quant[(size_t)f * 3 * 64 + i];
  if (tid < L::kUh)
    shift[tid] = (int)(((((size_t)f * h + my * L::kUh + tid) * w + gx0) *
                        L::kCh) & 15);
  __syncthreads();
  const int job = tid >> 3, lane8 = tid & 7;
  const int mi = job / L::kBpm, b = job - mi * L::kBpm;
  const bool active = mi < nm;
  // rows: dequantise the AC levels, one row of 8 a thread
  if (active) {
    const int mx = mx0 + mi;
    int idx;
    if (FORM == 0) idx = my * mcux + mx;
    else if (b >= L::kNy) idx = b * mcus + my * mcux + mx;
    else
      idx = (my * VS + b / HS) * (mcux * HS) + mx * HS + (b % HS);
    const int row = lane8;
    const int* qc = q + (b < L::kNy ? 0 : b - L::kNy + 1) * 64 + row * 8;
    const int4 v = *reinterpret_cast<const int4*>(
        coef + ((size_t)f * nblk + idx) * 64 + row * 8);
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
    int16_t o16[8];
    if ((x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0) {
      const int16_t d = (int16_t)(x[0] * 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) o16[k] = d;
    } else {
      unsigned o[8];
      butterfly(x, (unsigned)W4 * (unsigned)x[0] + (1u << 10), o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o16[k] = (int16_t)max(-32768, min(32767, (int)o[k] >> 11));
    }
    *reinterpret_cast<int4*>(rows + job * kBlkStride + row * 8) =
        *reinterpret_cast<const int4*>(o16);
  }
  __syncthreads();
  // columns: >> 20 and the clamp
  if (active) {
    const int col = lane8;
    int x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = rows[job * kBlkStride + k * 8 + col];
    unsigned o[8];
    butterfly(x, (unsigned)W4 * (unsigned)(int16_t)(x[0] + 32), o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      pix[job * L::kPix + k * 8 + col] = clamp_u8((int)o[k] >> 20);
  }
  __syncthreads();
  // colour: the strip's pixels into its output rows, each staged at its
  // destination's alignment; two neighbouring pixels a thread (one chroma
  // sample in the paired forms)
  for (int i = tid; i < L::kUh * L::kSw / 2; i += L::kThreads) {
    const int py = i / (L::kSw / 2), sx = 2 * (i % (L::kSw / 2));
    if (my * L::kUh + py >= h || sx >= sw) continue;
    const int m = sx / L::kUw, px = sx % L::kUw;
    const int jb = m * L::kBpm;
    const uint8_t* yp = pix + (jb + (py >> 3) * HS + (px >> 3)) * L::kPix +
                        (py & 7) * 8 + (px & 7);
    uint8_t* s = stage + py * L::kStage + shift[py] + sx * L::kCh;
    const bool two = sx + 1 < sw;
    if (FORM == 0) {
      s[0] = yp[0];
      if (two) s[1] = yp[1];
      continue;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
      const int y = yp[k];
      const int ci = (py / VS) * 8 + (px + k) / HS;
      const int u = pix[(jb + L::kNy) * L::kPix + ci] - 128;
      const int v = pix[(jb + L::kNy + 1) * L::kPix + ci] - 128;
      int cb, cg, cr;
      if (FORM == 2) {
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
      s[3 * k] = clamp_u8(cb);
      s[3 * k + 1] = clamp_u8(cg);
      s[3 * k + 2] = clamp_u8(cr);
    }
  }
  __syncthreads();
  // out: each row's aligned middle as 16-byte stores, its ends byte by byte
  constexpr int kUnits = L::kRowBytes / 16 + 2;
  for (int i = tid; i < L::kUh * kUnits; i += L::kThreads) {
    const int py = i / kUnits, u = i % kUnits;
    const int gy = my * L::kUh + py;
    if (gy >= h) continue;
    const size_t dst = (((size_t)f * h + gy) * w + gx0) * L::kCh;
    const size_t len = (size_t)sw * L::kCh;
    const size_t a0 = (dst + 15) & ~(size_t)15, a1 = (dst + len) & ~(size_t)15;
    const uint8_t* src = stage + py * L::kStage;   // byte a at a - base
    const size_t base = dst & ~(size_t)15;
    if (u < kUnits - 2) {
      const size_t a = a0 + 16 * (size_t)u;
      if (a + 16 <= a1)
        *reinterpret_cast<int4*>(out + a) =
            *reinterpret_cast<const int4*>(src + (a - base));
    } else {
      // the head (u == kUnits - 2) or the tail: the bytes outside [a0, a1)
      const size_t from = u == kUnits - 2 ? dst : max(a1, a0);
      const size_t to = u == kUnits - 2 ? min(a0, dst + len) : dst + len;
      for (size_t a = from; a < to; ++a) out[a] = src[a - base];
    }
  }
}

template <int FORM, int HS, int VS>
int launch_idct(const int16_t* coef, const int32_t* quant, uint8_t* out,
                int t, int h, int w, int mcux, int mcuy, int nblk,
                cudaStream_t stream) {
  using L = Idct<FORM, HS, VS>;
  const dim3 grid((mcux + L::kMcus - 1) / L::kMcus, mcuy, t);
  idct_bgr_kernel<FORM, HS, VS><<<grid, L::kThreads, 0, stream>>>(
      coef, quant, out, mcux, mcuy, h, w, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch og_jpeg_entropy needs: a 32-byte record for every
// subsequence a chunk of nseg segments in data_bytes bytes can hold.
long long og_jpeg_entropy_scratch_bytes(int nseg, long long data_bytes,
                                        int sub_bits) {
  if (nseg < 0 || data_bytes < 0 || sub_bits < kMinSubBits ||
      sub_bits > kMaxSubBits)
    return -1;
  return ((long long)nseg + 8 * data_bytes / sub_bits + 1) *
         (long long)sizeof(Sub);
}

// Dynamic shared memory of og_jpeg_entropy a block: the one-lookup tables
// and rows of a frame's 2 * ncomp tables, a block buffer a thread.
int og_jpeg_entropy_smem(int ncomp) {
  return 2 * ncomp * kTableWords * 4 + kStageWords * 4 +
         ((2 * ncomp) << kFastBits) * 2;
}

// The subsequence length of og_jpeg_entropy's smallest supported form.
int og_jpeg_entropy_min_sub_bits() { return kMinSubBits; }

// data: packed segment bytes (4-byte aligned); segs: (nseg, 5) int32 in
// frame order; tables: (nt, 360) int32; slots: (t, nslots) int32; comp: (t,
// 3, 2) int32; quant: (t, 3, 64) int32; coef: (t, nblk, 64) int16; err: (t,)
// int32, zeroed by the caller; sub_bits: the subsequence length S in bits;
// scratch: og_jpeg_entropy_scratch_bytes(nseg, data bytes, sub_bits) bytes,
// 8-byte aligned, any content.
int og_jpeg_entropy(const void* data, const void* segs, int nseg,
                    const void* tables, const void* slots, const void* comp,
                    const void* quant, void* coef, void* err, int t,
                    int ncomp, int mcux, int mcus, int hs0, int vs0, int nblk,
                    int nslots, int sub_bits, void* scratch,
                    long long scratch_bytes, long long data_bytes,
                    void* stream) {
  const Layout g{ncomp, mcux, mcus, hs0, vs0, nblk};
  const long long need = og_jpeg_entropy_scratch_bytes(nseg, data_bytes,
                                                       sub_bits);
  if (nseg < 0 || t < 0 || nslots < 1 || nslots > kMaxSlots || mcux < 1 ||
      !valid_layout(g) || need < 0 || scratch_bytes < need ||
      ((uintptr_t)scratch & 7) ||
      8 * data_bytes + 2LL * sub_bits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (nseg == 0 || t == 0) return (int)cudaSuccess;
  const int smem = og_jpeg_entropy_smem(ncomp);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        entropy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        og_jpeg_entropy_smem(3));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  entropy_kernel<<<t, kEntThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(segs),
      nseg, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(comp),
      static_cast<const int32_t*>(quant), static_cast<int16_t*>(coef),
      static_cast<int32_t*>(err), static_cast<Sub*>(scratch), g, nslots,
      sub_bits, (int)(data_bytes / 4));
  return (int)cudaGetLastError();
}

// coef: (t, nblk, 64) int16, 16-byte aligned; quant: (t, 3, 64) int32; out:
// (t, h, w, 3) uint8 (form 1, 2) or (t, h, w) uint8 (form 0); form 0 for
// gray, 2 for 4:4:4, 1 for 4:2:2 and 4:2:0.
int og_jpeg_idct_bgr(const void* coef, const void* quant, void* out, int t,
                     int h, int w, int ncomp, int mcux, int mcuy, int hs0,
                     int vs0, int nblk, int form, void* stream) {
  const Layout g{ncomp, mcux, mcux * mcuy, hs0, vs0, nblk};
  if (t < 0 || h <= 0 || w <= 0 || mcux < 1 || mcuy < 1 || form < 0 ||
      form > 2 || (form == 0) != (ncomp == 1) || (form == 1 && (h & 1)) ||
      !valid_layout(g) || t > 65535 || mcuy > 65535 || h > 8 * vs0 * mcuy ||
      w > 8 * hs0 * mcux || ((uintptr_t)coef & 15))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const int16_t* c = static_cast<const int16_t*>(coef);
  const int32_t* q = static_cast<const int32_t*>(quant);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = form * 100 + hs0 * 10 + vs0;
  switch (key) {   // the forms data/jpeg.colour_form gives each layout
    case 11: return launch_idct<0, 1, 1>(c, q, o, t, h, w, mcux, mcuy, nblk, s);
    case 211: return launch_idct<2, 1, 1>(c, q, o, t, h, w, mcux, mcuy, nblk,
                                          s);
    case 121: return launch_idct<1, 2, 1>(c, q, o, t, h, w, mcux, mcuy, nblk,
                                          s);
    case 122: return launch_idct<1, 2, 2>(c, q, o, t, h, w, mcux, mcuy, nblk,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
