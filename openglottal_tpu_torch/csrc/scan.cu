// Sequential recurrences over the frame axis of the serving path.
//
//   og_gate_scan     <- openglottal_tpu/models/gate.py gate_scan_carry
//                       (a lax.scan over per-frame detection summaries)
//   og_thresh_chain  <- openglottal_tpu/models/tracker.py _thresh_chain
//                       (a lax.scan over T scalars)
//   og_lmap_ema      <- openglottal_tpu/models/tracker.py _linear_prefix as
//                       vft_parallel uses it (an associative scan over
//                       (T,H,W)), i.e. the motion-map update of vft_step
//
// None replaces a Pallas kernel; each replaces an XLA scan.  The first two are
// a few scalar operations per frame that must run in frame order and stay
// bit-identical to the reference, so eager PyTorch would make thousands of
// tiny launches per video (or force a device-to-host copy in the middle of
// the pipeline).  Each runs a whole segment in one launch of one block; the
// notes above the kernels say what bounds them and how the block keeps
// everything but the carried recurrence off its one serial thread.
//
// og_lmap_ema is the motion map lmap_t = alpha*d_t + (1-alpha)*lmap_{t-1} per
// pixel.  The reference computes it by parallel prefix because its compiler
// wants one, and pays log T passes over (T,H,W) plus a reassociated result.
// Here a thread owns a pixel and walks T in order with the state in a
// register: neighbouring threads read neighbouring addresses of every frame,
// d is read once and the maps are written once (8 B per pixel-step, the
// bound), and the result is the sequential tracker's, bit for bit.  Its
// parallelism is H*W threads (a size-locked crop: a few thousand), so on a
// small crop the T dependent fused multiply-adds per thread, not bytes, set
// the time.
//
// Float arithmetic uses the round-to-nearest intrinsics throughout, so that
// where a multiply and an add are fused is written down here and not left to
// nvcc: a 1-ulp drift in the threshold flips `pixel < thresh` for a whole
// pixel population.  The threshold step is fma(beta, th, round((1-beta)*c)),
// the form the reference's scan takes (see models/tracker.py _thresh_chain);
// the motion-map step is fma(1-alpha, lmap, round(alpha*d)), the form the
// reference's sequential scan takes (models/tracker.py lmap_ema); the gate
// uses no fused operation.
//
// Plain C interface; nothing allocates or synchronises; each function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ── staging of the two one-block scans ──────────────────────────────────
//
// A segment is walked in tiles of up to kTile frames.  Every thread of the
// block copies a tile's inputs into shared memory by cp.async (see stage()),
// then the block computes in parallel what does not read the carry, thread 0
// walks the tile, and the block writes the outputs with coalesced stores.
// With more than one tile, the warps other than thread 0's stage tile k+1
// into the second buffer while thread 0 walks tile k.  The block has a
// thread per frame of the tile, rounded up to whole warps, from kMinThreads
// to kMaxThreads.

constexpr int kTile = 4096;
constexpr int kMinThreads = 256;
constexpr int kMaxThreads = 1024;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared bytes that hold n elements of `size` bytes staged from any address:
// the copy keeps the source's offset within 16 B, so 16 B of slack.
__host__ __device__ constexpr size_t staged_bytes(int n, int size) {
  return round16(static_cast<size_t>(n) * size + 16);
}

inline int block_threads(int tile) {
  const int r = (tile + 31) & ~31;
  return r < kMinThreads ? kMinThreads : (r > kMaxThreads ? kMaxThreads : r);
}

// Where stage() puts the first byte of src inside the region dst.
__device__ __forceinline__ unsigned char* staged_ptr(unsigned char* dst,
                                                     const void* src) {
  return dst + (reinterpret_cast<uintptr_t>(src) & 15);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Threads lane = 0..lanes-1 copy nbytes at src, elements of kSize (1 or 4)
// bytes at an address aligned to one, into dst at staged_ptr(dst, src).  The
// 16-B aligned body goes by 16-B cp.async, the head and the tail (under 16 B
// each) by 4-B cp.async for 4-B elements and by plain loads for bytes, one
// element per lane counted from the last lane, so that lane 0 (the walker)
// takes none.  Copies are in flight until the next cp_async_wait_all of each
// thread; plain stores are done on return.
template <int kSize>
__device__ void stage(unsigned char* dst, const void* src, int nbytes,
                      int lane, int lanes) {
  const unsigned char* g = static_cast<const unsigned char*>(src);
  unsigned char* d = staged_ptr(dst, src);
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(nbytes, (16 - off) & 15);
  const int chunks = (nbytes - head) >> 4;
  const int tail = head + (chunks << 4);
  for (int c = lane; c < chunks; c += lanes)
    cp_async16(d + head + (c << 4), g + head + (c << 4));
  // element e of the odd bytes: byte e * kSize of the head (< 16) or of the
  // tail (16 on)
  for (int e = lanes - 1 - lane; e < 32 / kSize; e += lanes) {
    const int x = e * kSize;
    const int b = x < 16 ? x : tail + x - 16;
    if (x < 16 ? x >= head : b >= nbytes) continue;
    if (kSize == 4) {
      cp_async4(d + b, g + b);
    } else {
      d[b] = g[b];
    }
  }
}

// jnp.hypot as the reference lowers it: max * sqrt(1 + (min / max)^2).
__device__ __forceinline__ float ref_hypot(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  const bool inf = isinf(a) || isinf(b);
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  float r = hi;
  if (hi != 0.0f) {
    const float q = __fdiv_rn(lo, hi);
    r = __fmul_rn(hi, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(q, q))));
  }
  return inf ? INFINITY : r;
}

// C cast toward zero, saturating like the hardware conversion.
__device__ __forceinline__ int trunc_i32(float x) { return __float2int_rz(x); }

// Centre of a raw detection (x1, y1, x2, y2).
__device__ __forceinline__ void centre(const float* r, float& cx, float& cy) {
  cx = __fmul_rn(__fadd_rn(r[0], r[2]), 0.5f);
  cy = __fmul_rn(__fadd_rn(r[1], r[3]), 0.5f);
}

// Box size of a raw detection, padded (int truncation toward zero).
__device__ __forceinline__ void box_size(const float* r, int padding, int& w,
                                         int& h) {
  w = trunc_i32(__fsub_rn(r[2], r[0])) + 2 * padding;
  h = trunc_i32(__fsub_rn(r[3], r[1])) + 2 * padding;
}

// ── the gate ────────────────────────────────────────────────────────────
//
// Replaces gate_scan_carry's lax.scan (openglottal_tpu/models/gate.py).
// Bytes bound: 34 B per frame (has 1, raw 16, out_valid 1, out_box 16) and
// the 24-B carry; 17 KB for a 502-frame video, 5 ns at 3.35 TB/s.  What
// bounds it is the serial floor: thread 0's walk, a step of the dependent
// chain valid/miss -> fresh -> (miss, expired) -> valid for each frame whose
// outcome depends on the carry, one step per 128 frames elsewhere.  Read by
// clock64() around the walk (og_gate_scan_walk_cycles, chip_smoke.py) on an
// NVIDIA H100 80GB HBM3 at 700 W, SM clock 1980 MHz: 2543 cycles (1.3 us) at
// a served video's 502 frames, 1.26 cycles per frame on 20,000 frames that
// are fresh throughout.
// The rest of a launch is a fixed cost of about 3 us (one global round trip,
// three block barriers), which the T = 1 launch shows.
//
// What the design takes off the serial thread:
//   * memory: the tile is in shared memory before the walk;
//   * the detection's centre and size: computed in parallel, and again only
//     where the walk or the epilogue needs a frame's box;
//   * the jump test's divide and square root, by speculation: while the gate
//     holds a fresh detection, the carried centre is the centre of the last
//     fresh frame.  So before the walk every thread computes, for its frame
//     i >= 1 of the tile, P_i = ref_hypot(ncx_i - ncx_{i-1}, ncy_i -
//     ncy_{i-1}) <= max_shift with the same operations on the same float32
//     values as the exact test; where frame i-1 was fresh the walk takes P_i,
//     elsewhere (a hold, a rejection, a carried-in state, a tile's first
//     frame) it computes the test exactly.  Equal inputs to the same function
//     give equal bits, so this changes no result;
//   * the frames that need no step at all: after a fresh frame, a frame with
//     a detection that passes P_i is fresh, and so is the next such frame.
//     The parallel pass marks these frames (a ballot per 32 frames) and
//     writes their output records ahead; the walk jumps over a run of them
//     in one step per 128 frames.  On served videos (fresh on every frame)
//     that is the whole walk;
//   * the output box clamp: the walk records per frame only whether the
//     output is valid and which box it shows (a fresh frame of this tile, the
//     carry the tile started from, or the zero box after an expiry); the
//     block then clamps every box in parallel and stores them coalesced.
//
// state_f: {cx, cy}; state_i: {valid, w, h, miss}.  Both are read at entry and
// hold the carry for the next segment at exit.

// Shared layout: rec (int per frame) | runs (a 32-bit mask per 32 frames) |
// flags (byte per frame) | per buffer: raw staging, has staging.
__host__ __device__ constexpr size_t gate_buffer_bytes(int tile) {
  return staged_bytes(tile, 16) + staged_bytes(tile, 1);
}

__host__ __device__ constexpr size_t gate_work_bytes(int tile) {
  return round16(static_cast<size_t>(tile) * 4) +
         round16(static_cast<size_t>((tile + 31) / 32) * 4) + round16(tile);
}

__host__ __device__ constexpr size_t gate_smem_bytes(int tile, int nbuf) {
  return gate_work_bytes(tile) + nbuf * gate_buffer_bytes(tile);
}

__global__ void __launch_bounds__(kMaxThreads)
gate_scan_kernel(const uint8_t* __restrict__ has, const float* __restrict__ raw,
                 uint8_t* __restrict__ out_valid, int* __restrict__ out_box,
                 float* state_f, int* state_i, int t, int tile, float frame_h,
                 float frame_w, float max_shift, int padding, int max_hold,
                 long long* walk_cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float entry_f[2];   // the carry a tile starts from: cx, cy
  __shared__ int entry_i[2];     //                              w, h
  int* rec = reinterpret_cast<int*>(smem);
  unsigned* runs = reinterpret_cast<unsigned*>(
      smem + round16(static_cast<size_t>(tile) * 4));
  unsigned char* flags = reinterpret_cast<unsigned char*>(runs) +
                         round16(static_cast<size_t>((tile + 31) / 32) * 4);
  unsigned char* const buf0 = smem + gate_work_bytes(tile);
  const size_t raw_bytes = staged_bytes(tile, 16);
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int ntiles = (t + tile - 1) / tile;

  // thread 0's carry, loaded while the first tile is staged
  float cx = 0.0f, cy = 0.0f;
  int valid = 0, bw = 0, bh = 0, miss = 0;
  long long cycles = 0;     // the walks' clock, where walk_cycles asks for it
  if (tid == 0) {
    cx = state_f[0];
    cy = state_f[1];
    valid = state_i[0] != 0;
    bw = state_i[1];
    bh = state_i[2];
    miss = state_i[3];
  }
  {
    const int n = min(tile, t);
    stage<4>(buf0, raw, 16 * n, tid, nthreads);
    stage<1>(buf0 + raw_bytes, has, n, tid, nthreads);
    cp_async_commit();
  }

  for (int k = 0; k < ntiles; ++k) {
    const int i0 = k * tile;
    const int n = min(tile, t - i0);
    unsigned char* const buf = buf0 + (k & 1) * gate_buffer_bytes(tile);
    const float* rs = reinterpret_cast<const float*>(
        staged_ptr(buf, raw + 4 * static_cast<size_t>(i0)));
    const unsigned char* hs = staged_ptr(buf + raw_bytes, has + i0);
    cp_async_wait_all();
    __syncthreads();

    // in parallel: has | P_i << 1 per frame; where both hold, the record the
    // frame has if it follows a fresh frame, and its bit in the run mask
    for (int j0 = tid - lane; j0 < n; j0 += nthreads) {
      const int j = j0 + lane;
      int f = 0;
      if (j < n) {
        f = hs[j] != 0;
        if (j > 0) {
          float ncx, ncy, pcx, pcy;
          centre(rs + 4 * j, ncx, ncy);
          centre(rs + 4 * (j - 1), pcx, pcy);
          f |= (ref_hypot(__fsub_rn(ncx, pcx), __fsub_rn(ncy, pcy)) <=
                max_shift) << 1;
        }
        flags[j] = f;
        if (f == 3) rec[j] = ((j + 2) << 1) | 1;
      }
      const unsigned m = __ballot_sync(0xffffffffu, f == 3);
      if (lane == 0) runs[j0 >> 5] = m;
    }
    __syncthreads();

    if (tid == 0) {
      // the walk: rec[i] = (source + 2) << 1 | valid, where source is the
      // frame of this tile whose box the output shows, -1 for the carry the
      // tile started from, -2 for the zero box
      const long long c0 = walk_cycles ? clock64() : 0;
      entry_f[0] = cx;
      entry_f[1] = cy;
      entry_i[0] = bw;
      entry_i[1] = bh;
      int src = -1;
      int prev_fresh = 0;     // frame i-1 was fresh, so P_i is the jump test
      int i = 0;
      while (i < n) {
        const int f = flags[i];
        const unsigned mask = runs[i >> 5];
        if (prev_fresh && ((mask >> (i & 31)) & 1)) {
          // the run of frames from i on that are fresh after a fresh frame:
          // the rest of its 32 (the zero bits of m; bits shifted in from
          // above end the run), then whole blocks of 128 (one 16-B load
          // tests four masks)
          const unsigned m = ~(mask >> (i & 31));
          i += min(m ? __ffs(m) - 1 : 32, n - i);
          if ((i & 127) == 0) {
            while (i + 128 <= n) {
              const uint4 m4 = *reinterpret_cast<const uint4*>(runs + (i >> 5));
              if ((m4.x & m4.y & m4.z & m4.w) != ~0u) break;
              i += 128;
            }
          }
          src = i - 1;
          continue;
        }
        const int h = f & 1;
        int jok = f >> 1;
        if (h && valid && !prev_fresh) {
          float ccx = 0.0f, ccy = 0.0f, ncx, ncy;
          if (src >= 0) {
            centre(rs + 4 * src, ccx, ccy);
          } else if (src == -1) {
            ccx = cx;
            ccy = cy;
          }
          centre(rs + 4 * i, ncx, ncy);
          jok = ref_hypot(__fsub_rn(ncx, ccx), __fsub_rn(ncy, ccy)) <= max_shift;
        }
        const int fresh = h && (!valid || jok);
        const int old = miss + 1 > max_hold;
        const int expired = !fresh && valid && old;
        const int v2 = fresh || (valid && !old);
        const int shown = fresh ? i : src;
        miss = (fresh || expired) ? 0 : miss + valid;
        src = expired ? -2 : shown;
        valid = v2;
        prev_fresh = fresh;
        rec[i] = ((shown + 2) << 1) | v2;
        ++i;
      }
      if (walk_cycles) cycles += clock64() - c0;
      // the carry at the tile's end
      if (src >= 0) {
        centre(rs + 4 * src, cx, cy);
        box_size(rs + 4 * src, padding, bw, bh);
      } else if (src == -2) {
        cx = cy = 0.0f;
        bw = bh = 0;
      }
    } else if (tid >= 32 && k + 1 < ntiles) {
      // the other warps stage the next tile meanwhile
      const int j0 = i0 + tile;
      const int m = min(tile, t - j0);
      unsigned char* const nb = buf0 + ((k + 1) & 1) * gate_buffer_bytes(tile);
      stage<4>(nb, raw + 4 * static_cast<size_t>(j0), 16 * m, tid - 32,
               nthreads - 32);
      stage<1>(nb + raw_bytes, has + j0, m, tid - 32, nthreads - 32);
      cp_async_commit();
    }
    __syncthreads();

    // epilogue: clamp each output box so it stays in the frame (with lo > hi
    // the result is hi: min(max(c, lo), hi)), coalesced stores
    const bool box4 = (reinterpret_cast<uintptr_t>(out_box) & 15) == 0;
    for (int j = tid; j < n; j += nthreads) {
      const int r = rec[j];
      const int s = (r >> 1) - 2;
      float c2x = 0.0f, c2y = 0.0f;
      int w2 = 0, h2 = 0;
      if (s >= 0) {
        centre(rs + 4 * s, c2x, c2y);
        box_size(rs + 4 * s, padding, w2, h2);
      } else if (s == -1) {
        c2x = entry_f[0];
        c2y = entry_f[1];
        w2 = entry_i[0];
        h2 = entry_i[1];
      }
      // floor division by 2 (Python // on a possibly negative int)
      const int half_w = w2 >> 1;
      const int half_h = h2 >> 1;
      const float lo_x = static_cast<float>(half_w);
      const float lo_y = static_cast<float>(half_h);
      const float hi_x = __fsub_rn(frame_w, static_cast<float>(half_w));
      const float hi_y = __fsub_rn(frame_h, static_cast<float>(half_h));
      const int ocx = trunc_i32(fminf(fmaxf(c2x, lo_x), hi_x));
      const int ocy = trunc_i32(fminf(fmaxf(c2y, lo_y), hi_y));
      const int4 b = make_int4(ocx - half_w, ocy - half_h, ocx + half_w,
                               ocy + half_h);
      const size_t i = static_cast<size_t>(i0) + j;
      out_valid[i] = r & 1;
      if (box4) {
        reinterpret_cast<int4*>(out_box)[i] = b;
      } else {
        out_box[4 * i] = b.x;
        out_box[4 * i + 1] = b.y;
        out_box[4 * i + 2] = b.z;
        out_box[4 * i + 3] = b.w;
      }
    }
  }
  if (tid == 0) {
    state_f[0] = cx;
    state_f[1] = cy;
    state_i[0] = valid;
    state_i[1] = bw;
    state_i[2] = bh;
    state_i[3] = miss;
    if (walk_cycles) *walk_cycles = cycles;
  }
}

// ── the threshold chain ─────────────────────────────────────────────────
//
// Replaces _thresh_chain's lax.scan (openglottal_tpu/models/tracker.py).
// Bytes bound: 13 B per frame (cur 4, n_px 4, active 1, out 4) and the 4-B
// seed; 6.5 KB for 502 frames, 2 ns at 3.35 TB/s.  What bounds it is the
// serial floor: T steps of th -> fma(beta, th, c) -> select, where c is the
// precomputed round32((1-beta)*cur_i) or, on a fallback step (n_px_i <= 10),
// round32((1-beta)*th).  Where four steps in a row are active and take their
// percentile the step is one fma (the SASS of the walk is 16 dependent FFMAs
// per batch).  Read by clock64() around the walk
// (og_thresh_chain_walk_cycles, chip_smoke.py) on an NVIDIA H100 80GB HBM3
// at 700 W, SM clock 1980 MHz: 5366 cycles (2.7 us) at a served video's 500
// steps, 9.6 cycles per step on 20,000 active steps.
//
// What the design takes off the serial thread: memory (the tile is staged in
// shared memory; the walk holds two batches of 16 frames' operands in
// registers, loading one while it walks the other, and writes th back in
// place); the product round32((1-beta)*cur_i) and the two flags, computed by
// the block in parallel before the walk (the same __fmul_rn on the same
// values, so the same bits); the selects where four steps in a row are
// active and take their percentile (four chained fmas, the served case); the
// output stores, coalesced after the walk.

// Shared layout: work values (float per frame) | flags (byte per frame) |
// per buffer: cur, n_px and active staging.

// Sixteen frames of the walk's operands: round32((1-beta)*cur_i) and
// (n_px_i > 10) | active_i << 1, one byte each.
struct ThreshBatch {
  float4 p0, p1, p2, p3;
  uint4 f;
};

// A chain of at most 32 steps (the sequential trackers launch T = 1): one
// warp, no staging and no block barrier, so the launch pays one global round
// trip.  Lane j loads step j's operands and forms its product and flags;
// every lane then walks the chain on values broadcast by shuffles (the same
// operations as the block's walk) and lane j keeps step j's threshold.
constexpr int kWarpChain = 32;

__global__ void __launch_bounds__(32)
thresh_chain_warp_kernel(const float* __restrict__ thresh0,
                         const float* __restrict__ cur,
                         const float* __restrict__ n_px,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ out, int t, float beta,
                         float one_minus_beta, long long* walk_cycles) {
  const int j = threadIdx.x;
  float p = 0.0f;
  unsigned f = 0;
  if (j < t) {
    p = __fmul_rn(one_minus_beta, cur[j]);
    f = (n_px[j] > 10.0f) | ((active[j] != 0) << 1);
  }
  float th = thresh0[0];
  const long long c0 = walk_cycles ? clock64() : 0;
  float mine = 0.0f;
  for (int i = 0; i < t; ++i) {
    const float pi = __shfl_sync(0xffffffffu, p, i);
    const unsigned fi = __shfl_sync(0xffffffffu, f, i);
    const float c = (fi & 1) ? pi : __fmul_rn(one_minus_beta, th);
    const float th2 = __fmaf_rn(beta, th, c);
    th = (fi & 2) ? th2 : th;
    if (j == i) mine = th;
  }
  if (j == 0 && walk_cycles) *walk_cycles = clock64() - c0;
  if (j < t) out[j] = mine;
}

__device__ __forceinline__ void load_batch(ThreshBatch& b, const float* work,
                                           const unsigned char* flags, int i) {
  const float4* p = reinterpret_cast<const float4*>(work + i);
  b.p0 = p[0];
  b.p1 = p[1];
  b.p2 = p[2];
  b.p3 = p[3];
  b.f = *reinterpret_cast<const uint4*>(flags + i);
}
__host__ __device__ constexpr size_t thresh_buffer_bytes(int tile) {
  return 2 * staged_bytes(tile, 4) + staged_bytes(tile, 1);
}

__host__ __device__ constexpr size_t thresh_smem_bytes(int tile, int nbuf) {
  return round16(static_cast<size_t>(tile) * 4) + round16(tile) +
         nbuf * thresh_buffer_bytes(tile);
}

__global__ void __launch_bounds__(kMaxThreads)
thresh_chain_kernel(const float* __restrict__ thresh0,
                    const float* __restrict__ cur,
                    const float* __restrict__ n_px,
                    const uint8_t* __restrict__ active,
                    float* __restrict__ out, int t, int tile, float beta,
                    float one_minus_beta, long long* walk_cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* work = reinterpret_cast<float*>(smem);
  unsigned char* flags = smem + round16(static_cast<size_t>(tile) * 4);
  unsigned char* const buf0 = flags + round16(tile);
  const size_t f_bytes = staged_bytes(tile, 4);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ntiles = (t + tile - 1) / tile;

  float th = 0.0f;
  long long cycles = 0;     // the walks' clock, where walk_cycles asks for it
  if (tid == 0) th = thresh0[0];
  {
    const int n = min(tile, t);
    stage<4>(buf0, cur, 4 * n, tid, nthreads);
    stage<4>(buf0 + f_bytes, n_px, 4 * n, tid, nthreads);
    stage<1>(buf0 + 2 * f_bytes, active, n, tid, nthreads);
    cp_async_commit();
  }

  for (int k = 0; k < ntiles; ++k) {
    const int i0 = k * tile;
    const int n = min(tile, t - i0);
    unsigned char* const buf = buf0 + (k & 1) * thresh_buffer_bytes(tile);
    const float* cs = reinterpret_cast<const float*>(staged_ptr(buf, cur + i0));
    const float* ns = reinterpret_cast<const float*>(
        staged_ptr(buf + f_bytes, n_px + i0));
    const unsigned char* as = staged_ptr(buf + 2 * f_bytes, active + i0);
    cp_async_wait_all();
    __syncthreads();

    // in parallel: round32((1-beta)*cur_i), n_px_i > 10, active_i
    for (int j = tid; j < n; j += nthreads) {
      work[j] = __fmul_rn(one_minus_beta, cs[j]);
      flags[j] = (ns[j] > 10.0f) | ((as[j] != 0) << 1);
    }
    __syncthreads();

    if (tid == 0) {
      const long long c0 = walk_cycles ? clock64() : 0;
      // pinned rounding: round32((1-beta)*c), then one fused multiply-add
      auto step = [&](float p, unsigned f) {
        const float c = (f & 1) ? p : __fmul_rn(one_minus_beta, th);
        const float th2 = __fmaf_rn(beta, th, c);
        th = (f & 2) ? th2 : th;
        return th;
      };
      // four steps: where all four are active and none falls back (the
      // served case), four chained fmas
      auto group = [&](float4 p, unsigned f) {
        float4 o;
        if (f == 0x03030303u) {
          o.x = th = __fmaf_rn(beta, th, p.x);
          o.y = th = __fmaf_rn(beta, th, p.y);
          o.z = th = __fmaf_rn(beta, th, p.z);
          o.w = th = __fmaf_rn(beta, th, p.w);
        } else {
          o.x = step(p.x, f & 0xff);
          o.y = step(p.y, (f >> 8) & 0xff);
          o.z = step(p.z, (f >> 16) & 0xff);
          o.w = step(p.w, f >> 24);
        }
        return o;
      };
      auto walk16 = [&](int i, const ThreshBatch& b) {
        float4* o = reinterpret_cast<float4*>(work + i);
        if ((b.f.x & b.f.y & b.f.z & b.f.w) == 0x03030303u) {
          // sixteen such steps: one test for four groups
          o[0] = group(b.p0, 0x03030303u);
          o[1] = group(b.p1, 0x03030303u);
          o[2] = group(b.p2, 0x03030303u);
          o[3] = group(b.p3, 0x03030303u);
        } else {
          o[0] = group(b.p0, b.f.x);
          o[1] = group(b.p1, b.f.y);
          o[2] = group(b.p2, b.f.z);
          o[3] = group(b.p3, b.f.w);
        }
      };
      // 16 frames a batch, two batches in registers: one batch's loads are
      // in flight while the other is walked
      int i = 0;
      if (n >= 16) {
        ThreshBatch a, b;
        load_batch(a, work, flags, 0);
        for (;;) {
          const bool more = i + 32 <= n;
          if (more) load_batch(b, work, flags, i + 16);
          walk16(i, a);
          i += 16;
          if (!more) break;
          const bool more2 = i + 32 <= n;
          if (more2) load_batch(a, work, flags, i + 16);
          walk16(i, b);
          i += 16;
          if (!more2) break;
        }
      }
      for (; i < n; ++i) work[i] = step(work[i], flags[i]);
      if (walk_cycles) cycles += clock64() - c0;
    } else if (tid >= 32 && k + 1 < ntiles) {
      // the other warps stage the next tile meanwhile
      const int j0 = i0 + tile;
      const int m = min(tile, t - j0);
      unsigned char* const nb = buf0 + ((k + 1) & 1) * thresh_buffer_bytes(tile);
      stage<4>(nb, cur + j0, 4 * m, tid - 32, nthreads - 32);
      stage<4>(nb + f_bytes, n_px + j0, 4 * m, tid - 32, nthreads - 32);
      stage<1>(nb + 2 * f_bytes, active + j0, m, tid - 32, nthreads - 32);
      cp_async_commit();
    }
    __syncthreads();

    for (int j = tid; j < n; j += nthreads) out[i0 + j] = work[j];
  }
  if (tid == 0 && walk_cycles) *walk_cycles = cycles;
}

// lmap0: (n,) state before the first step; d, out: (t, n); active: (t,).
// Inactive steps keep the state and still write it out.
__global__ void lmap_ema_kernel(const float* __restrict__ lmap0,
                                const float* __restrict__ d,
                                const uint8_t* __restrict__ active,
                                float* __restrict__ out, int t, int n,
                                float alpha, float one_minus_alpha) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float lm = lmap0[p];
  const float* src = d + p;
  float* dst = out + p;
#pragma unroll 8
  for (int i = 0; i < t; ++i) {
    const float di = src[static_cast<size_t>(i) * n];
    // pinned rounding: round32(alpha*d), then one fused multiply-add
    const float nxt = __fmaf_rn(one_minus_alpha, lm, __fmul_rn(alpha, di));
    lm = active[i] ? nxt : lm;
    dst[static_cast<size_t>(i) * n] = lm;
  }
}

int launch_gate_scan(const void* has, const void* raw, void* out_valid,
                     void* out_box, void* state_f, void* state_i, int t,
                     float frame_h, float frame_w, float max_shift, int padding,
                     int max_hold, void* walk_cycles, void* stream) {
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaSuccess);
  const int tile = t < kTile ? t : kTile;
  const size_t smem = gate_smem_bytes(tile, t > tile ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gate_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gate_scan_kernel<<<1, block_threads(tile), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(has), static_cast<const float*>(raw),
      static_cast<uint8_t*>(out_valid), static_cast<int*>(out_box),
      static_cast<float*>(state_f), static_cast<int*>(state_i), t, tile,
      frame_h, frame_w, max_shift, padding, max_hold,
      static_cast<long long*>(walk_cycles));
  return static_cast<int>(cudaGetLastError());
}

int launch_thresh_chain(const void* thresh0, const void* cur, const void* n_px,
                        const void* active, void* out, int t, float beta,
                        float one_minus_beta, void* walk_cycles, void* stream) {
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaSuccess);
  if (t <= kWarpChain) {
    thresh_chain_warp_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(thresh0), static_cast<const float*>(cur),
        static_cast<const float*>(n_px), static_cast<const uint8_t*>(active),
        static_cast<float*>(out), t, beta, one_minus_beta,
        static_cast<long long*>(walk_cycles));
    return static_cast<int>(cudaGetLastError());
  }
  const int tile = t < kTile ? t : kTile;
  const size_t smem = thresh_smem_bytes(tile, t > tile ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        thresh_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  thresh_chain_kernel<<<1, block_threads(tile), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thresh0), static_cast<const float*>(cur),
      static_cast<const float*>(n_px), static_cast<const uint8_t*>(active),
      static_cast<float*>(out), t, tile, beta, one_minus_beta,
      static_cast<long long*>(walk_cycles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int og_gate_scan(const void* has, const void* raw, void* out_valid,
                 void* out_box, void* state_f, void* state_i, int t,
                 float frame_h, float frame_w, float max_shift, int padding,
                 int max_hold, void* stream) {
  return launch_gate_scan(has, raw, out_valid, out_box, state_f, state_i, t,
                          frame_h, frame_w, max_shift, padding, max_hold,
                          nullptr, stream);
}

int og_thresh_chain(const void* thresh0, const void* cur, const void* n_px,
                    const void* active, void* out, int t, float beta,
                    float one_minus_beta, void* stream) {
  return launch_thresh_chain(thresh0, cur, n_px, active, out, t, beta,
                             one_minus_beta, nullptr, stream);
}

// The same launches, with the clock of the serial walk: thread 0 adds up
// clock64() around its walks and stores the sum (SM cycles) to walk_cycles,
// one long long on the device.  For measurement only (chip_smoke.py).
int og_gate_scan_walk_cycles(const void* has, const void* raw,
                             void* out_valid, void* out_box, void* state_f,
                             void* state_i, int t, float frame_h,
                             float frame_w, float max_shift, int padding,
                             int max_hold, void* walk_cycles, void* stream) {
  return launch_gate_scan(has, raw, out_valid, out_box, state_f, state_i, t,
                          frame_h, frame_w, max_shift, padding, max_hold,
                          walk_cycles, stream);
}

int og_thresh_chain_walk_cycles(const void* thresh0, const void* cur,
                                const void* n_px, const void* active,
                                void* out, int t, float beta,
                                float one_minus_beta, void* walk_cycles,
                                void* stream) {
  return launch_thresh_chain(thresh0, cur, n_px, active, out, t, beta,
                             one_minus_beta, walk_cycles, stream);
}

int og_lmap_ema(const void* lmap0, const void* d, const void* active,
                void* out, int t, int n, float alpha, float one_minus_alpha,
                void* stream) {
  if (t <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  lmap_ema_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lmap0), static_cast<const float*>(d),
      static_cast<const uint8_t*>(active), static_cast<float*>(out), t, n,
      alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
