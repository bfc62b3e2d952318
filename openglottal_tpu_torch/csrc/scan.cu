// Sequential recurrences over the frame axis of the serving path.
//
//   og_gate_scan     <- openglottal_tpu/models/gate.py gate_scan_carry
//                       (a lax.scan over per-frame detection summaries)
//   og_thresh_chain  <- openglottal_tpu/models/tracker.py _thresh_chain
//                       (a lax.scan over T scalars)
//   og_motion_map    <- openglottal_tpu/models/tracker.py _linear_prefix as
//                       vft_parallel uses it (an associative scan over
//                       (T,H,W)), with the blurred absdiff that feeds it
//                       (gaussian_blur(|frame - prev|), tracker.py:325), i.e.
//                       the motion-map update of vft_step
//
// None replaces a Pallas kernel; each replaces an XLA scan.  The first two are
// a few scalar operations per frame that must run in frame order and stay
// bit-identical to the reference, so eager PyTorch would make thousands of
// tiny launches per video (or force a device-to-host copy in the middle of
// the pipeline).  Each runs a whole segment in one launch of one block; the
// notes above the kernels say what bounds them and how the block keeps
// everything but the carried recurrence off its one serial thread.
//
// og_motion_map computes, per pixel, d_t = blur(|frame_t - frame_{t-1}|) and
// lmap_t = alpha*d_t + (1-alpha)*lmap_{t-1}, all in one launch: d never
// reaches device memory.  The reference computes the recurrence by parallel
// prefix because its compiler wants one, and pays log T passes over (T,H,W)
// plus a reassociated result; here each pixel walks T in order, so the result
// is the sequential tracker's, bit for bit.  The note above the kernel says
// how the blur, which is most of the work, is spread over the card.
//
// Float arithmetic uses the round-to-nearest intrinsics throughout, so that
// where a multiply and an add are fused is written down here and not left to
// nvcc: a 1-ulp drift in the threshold flips `pixel < thresh` for a whole
// pixel population.  The threshold step is fma(beta, th, round((1-beta)*c)),
// the form the reference's scan takes (see models/tracker.py _thresh_chain);
// the motion-map step is fma(1-alpha, lmap, round(alpha*d)), the form the
// reference's sequential scan takes (models/tracker.py lmap_ema_plain); the
// blur is fma(k0, x0, round(k1*x1)) and then one fma per tap, the form the
// reference's compiled blur takes (ops/blur.py); the gate uses no fused
// operation.
//
// Plain C interface; nothing allocates or synchronises; each function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

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

// The sequences of a launch: block b walks frames [start[b], start[b + 1])
// of the flat inputs and outputs, and its carry is the b-th of the launch's
// carries.  Passed by value (the launch's parameter space, read in place as
// a __grid_constant__), so a batch of sequences needs no host-to-device
// copy of its offsets.  kSegs is the most sequences one launch takes: 1 for
// the per-video launches, kBatchSegs for the batched ones, which the host
// splits into launches of at most kBatchSegs sequences.
template <int kSegs>
struct Segments {
  long long start[kSegs + 1];
};

constexpr int kBatchSegs = 256;

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
//
// A batch of sequences (og_gate_scan_batch, one video each) is one launch of
// the same body with one block per sequence: each block stages and walks its
// own frames with its own carry, so a sequence's outputs and carry are those
// of its own launch, bit for bit.  The serial walks of the K sequences run
// side by side on K SMs.

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

// state: the carries, six int32 per sequence: {valid, w, h, miss} and then
// {cx, cy} as float32 bits.
template <int kSegs>
__global__ void __launch_bounds__(kMaxThreads)
gate_scan_kernel(const uint8_t* __restrict__ has, const float* __restrict__ raw,
                 uint8_t* __restrict__ out_valid, int* __restrict__ out_box,
                 int* state, const __grid_constant__ Segments<kSegs> seg,
                 int tile, float frame_h, float frame_w, float max_shift,
                 int padding, int max_hold, long long* walk_cycles) {
  // this block's sequence
  const long long s0 = seg.start[blockIdx.x];
  const int t = static_cast<int>(seg.start[blockIdx.x + 1] - s0);
  has += s0;
  raw += 4 * s0;
  out_valid += s0;
  out_box += 4 * s0;
  int* const state_i = state + 6 * blockIdx.x;
  float* const state_f = reinterpret_cast<float*>(state_i + 4);
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
//
// A batch of chains (og_thresh_chain_batch, one per video, each from its own
// seed) is one launch of the same bodies with one block per chain: the warp
// form when every chain has at most 32 steps, else the staged block form.

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

template <int kSegs>
__global__ void __launch_bounds__(32)
thresh_chain_warp_kernel(const float* __restrict__ thresh0,
                         const float* __restrict__ cur,
                         const float* __restrict__ n_px,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ out,
                         const __grid_constant__ Segments<kSegs> seg,
                         float beta, float one_minus_beta,
                         long long* walk_cycles) {
  const long long s0 = seg.start[blockIdx.x];
  const int t = static_cast<int>(seg.start[blockIdx.x + 1] - s0);
  thresh0 += blockIdx.x;
  cur += s0;
  n_px += s0;
  active += s0;
  out += s0;
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

template <int kSegs>
__global__ void __launch_bounds__(kMaxThreads)
thresh_chain_kernel(const float* __restrict__ thresh0,
                    const float* __restrict__ cur,
                    const float* __restrict__ n_px,
                    const uint8_t* __restrict__ active,
                    float* __restrict__ out,
                    const __grid_constant__ Segments<kSegs> seg, int tile,
                    float beta, float one_minus_beta, long long* walk_cycles) {
  const long long s0 = seg.start[blockIdx.x];
  const int t = static_cast<int>(seg.start[blockIdx.x + 1] - s0);
  thresh0 += blockIdx.x;
  cur += s0;
  n_px += s0;
  active += s0;
  out += s0;
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

// ── the motion map ──────────────────────────────────────────────────────
//
// Replaces the motion-map update of vft_parallel / vft_step
// (openglottal_tpu/models/tracker.py: _linear_prefix over gaussian_blur of
// the absdiff).  For frames (t, h, w), the frame before the first prev0 (h,
// w), the map before the first lmap0 (h, w) and active (t,):
//
//   d_i    = blur(|frames[i] - frames[i-1]|)   (frames[-1] = prev0)
//   lmap_i = active_i ? fma(1-alpha, lmap_{i-1}, round32(alpha*d_i))
//                     : lmap_{i-1}
//
// and every lmap_i is stored.  The blur is ops/blur.py's: reflect-101
// borders (by index math here: no padded copy), the h axis first, then the w
// axis, each rounded as the reference rounds it: fma(k0, x0, round32(k1 *
// x1)), then one __fmaf_rn per tap (blur_step).  Inactive steps keep the map
// and still store it.
//
// Bytes bound: 4 B read + 4 B written per pixel-step (the frames, the maps);
// at a served (502, 48, 40) that is 7.7 MB, 2.3 us at 3.35 TB/s.  The
// operations (a subtract, a product and K-1 fmas per axis of the blur, a
// multiply and an fma per pixel-step; ~54 at K = 13, an fma counting two) are
// 0.8 us at the card's float32 rate; the serial floor is t dependent fmas per
// pixel (502 x 4 cycles, ~1 us).  The blur is most of the work, and it does not read the
// carry.
//
// The design.  A block owns a band of `rows` output rows by the full width.
// The blur of a band needs its rows and r = K/2 more on either side, so the
// smaller the band the more often each input row is read (7x at two rows and
// K = 13).  Bands of one block each, walking all t frames, put every band's
// t frames through one SM: measured 0.110-0.177 ms at (502, 48, 40) for
// bands of 1, 2 and 4 rows (chip_smoke.py's motion_map line).  So the frames
// of a band are split too, over a cluster of `ranks` blocks.  Each round,
// rank j blurs its slice of the round's frames and pushes each d into the
// shared memory of the rank that walks that pixel (distributed shared
// memory: rank j walks pixels [j*npx, (j+1)*npx) of the band); after one
// cluster barrier every rank walks its pixels through all the round's frames
// from its own shared memory.  d never reaches device memory, and no carry
// passes between blocks.
//
// A rank blurs its slice in chunks of up to 32 frames.  A chunk's staged
// input (the band's input rows of each frame of the chunk and of the frame
// before it) is copied into shared memory by the tensor memory accelerator,
// one bulk copy per frame issued by lane 0 of each warp in turn, the next
// chunk's copies in flight while this one is computed (cp.async issued by
// every thread moved ~9 B per SM cycle here).  Then:
//   1. all threads: the absdiff and the h-axis blur; a thread takes a column
//      and a run of frames, keeps the previous frame's input rows in
//      registers and computes the band's rows from one pass over the
//      column's rows; results go to a tile whose rows carry r reflected
//      columns on either side;
//   2. all threads: the w-axis blur, four columns a thread, pushed to the
//      walkers' tiles (a row of the round's frames per pixel).
// The walk keeps the map in a register and writes each map over its d (four
// frames a float4, the next 16 frames' loads ahead of the chain, one fma a
// step where 16 active flags in a row are set: the flags are one ballot word
// per 32 frames); then the block stores the round's maps coalesced.  The
// sequential trackers' t = 1 is the same kernel with a cluster of one block.
//
// What limits it (clock64() per phase of block 0, chip_smoke.py, NVIDIA H100
// 80GB HBM3 at 700 W): at (502, 48, 40) with 2-row bands over clusters of 4
// (96 blocks) the launch takes ~29 us, ~50k SM cycles, of which the two
// blur phases are ~60 % at about one instruction per SM cycle.  Phase 1's
// time does not fall with K (a 1-tap blur takes as long as 13 taps), so it
// is the 7x re-read of the staged rows through L2 (~29 MB for the launch)
// that holds it; the walk is ~16 cycles a step.

constexpr int kMaxTaps = 31;
constexpr int kMaxChunk = 32;      // frames a rank stages at once
constexpr int kMaxRanks = 8;       // blocks of a cluster (portable size)
constexpr int kMapThreads = 512;
constexpr int kTargetBlocks = 132; // the H100's SMs
constexpr size_t kMaxSmem = 227 * 1024;

struct MapTaps {
  float k[kMaxTaps];
};

// One tap of the blur, rounded as the reference's compiled CPU code rounds
// it (ops/blur.py): tap 0's input is held until tap 1, which fuses it over
// the rounded product of tap 1; every later tap is one fused step; a 1-tap
// blur is the one product.  acc is the running sum, x tap d's input.
template <typename Tap>
__device__ __forceinline__ float blur_step(float acc, int d, int nt, float x,
                                           const Tap& tap) {
  if (d == 0) return nt == 1 ? __fmul_rn(tap(0), x) : x;
  if (d == 1) return __fmaf_rn(tap(0), acc, __fmul_rn(tap(1), x));
  return __fmaf_rn(tap(d), x, acc);
}

// Reflect-101 of a row or column index that lies less than n outside [0, n).
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

// Shared layout: taps | an mbarrier per staging buffer | active words of a
// round | the h-blur tile (chunk * rows * (w + 2r) floats) | the walker's
// tile (a row of the round's d per pixel this rank walks, then its maps) |
// nbuf staging buffers of chunk + 1 frames, up to `rows + 2r` rows of w
// floats each, copied in whole 16-B granules.
struct MapLayout {
  int rows, ranks, chunk, slice, nbuf, radius;
  size_t frame_bytes, buffer_bytes, bar_off, act_off, hb_off, walk_off,
      buf_off, smem;
  // where block 0's thread 0 adds up the SM cycles of its phases: the
  // prologue, waiting for a chunk's copies, phase 1, phase 2, the cluster
  // barriers, the maps' stores, the walk (nullptr: not measured;
  // chip_smoke.py only)
  long long* phase_cycles;
};

// A walker-tile row: the round's frames, rounded up to 4 mod 8 floats, so
// that a walker's float4 loads and stores (8 threads a phase, rows apart) fall
// on distinct banks.
__host__ __device__ inline int walk_pitch(int frames) {
  return ((frames + 3) & ~7) + 4;
}

inline MapLayout map_layout(int h, int w, int ksize, int rows, int ranks,
                            int chunk, int slice, int nbuf) {
  MapLayout L;
  L.phase_cycles = nullptr;
  L.rows = rows;
  L.ranks = ranks;
  L.chunk = chunk;
  L.slice = slice;
  L.nbuf = nbuf;
  L.radius = ksize / 2;
  const int srows = h < rows + 2 * L.radius ? h : rows + 2 * L.radius;
  L.frame_bytes = staged_bytes(srows * w, 4);
  L.buffer_bytes = static_cast<size_t>(chunk + 1) * L.frame_bytes;
  L.bar_off = round16(kMaxTaps * 4);
  L.act_off = L.bar_off + 16;
  // + 1 word: a batch of the walk reads the word after its first frame's
  L.hb_off = L.act_off +
             round16(static_cast<size_t>((ranks * slice + 31) / 32 + 1) * 4);
  // + 3 floats: the w blur's last group of four reads past its row
  L.walk_off = L.hb_off + round16((static_cast<size_t>(chunk) * rows *
                                    (w + 2 * L.radius) + 3) * 4);
  // the walker's tile: the round's d of this rank's pixels of the walk, a
  // row of walk_pitch(ranks * slice) floats per pixel
  const size_t walk_px = (static_cast<size_t>(rows) * w + ranks - 1) / ranks;
  L.buf_off = L.walk_off + round16(walk_px * walk_pitch(ranks * slice) * 4);
  L.smem = L.buf_off + nbuf * L.buffer_bytes;
  return L;
}

// Rows of a band where the caller names none: 2 (the fastest of 1, 2, 4 and
// 8 at (502, 48, 40): chip_smoke.py's motion_map line), more where the bands
// alone would exceed one block per SM.
inline int default_map_rows(int h) {
  int rows = h < 2 ? 1 : 2;
  while (rows < 16 && (h + rows - 1) / rows > kTargetBlocks) rows *= 2;
  return rows;
}

// For bands of `rows` rows split over `ranks` blocks: the largest staging
// chunk, and the longest slice a round gives each rank, that fit shared
// memory; chunk 0 where nothing fits.
inline MapLayout choose_map_layout(int t, int h, int w, int ksize, int rows,
                                   int ranks) {
  const int per_rank = (t + ranks - 1) / ranks;
  for (int c = per_rank < kMaxChunk ? per_rank : kMaxChunk; c >= 1; c /= 2) {
    const MapLayout base = map_layout(h, w, ksize, rows, ranks, c, c, 2);
    if (base.smem > kMaxSmem) continue;
    const size_t per_frame =
        static_cast<size_t>(ranks) *
        ((static_cast<size_t>(rows) * w + ranks - 1) / ranks) * 4;
    const size_t room = (kMaxSmem - base.smem) / per_frame + c;
    for (int slice = room >= static_cast<size_t>(per_rank)
                         ? per_rank
                         : static_cast<int>(room);
         slice >= c; --slice) {
      // one staging buffer where the launch has one chunk, else two
      const int chunks = ((t + ranks * slice - 1) / (ranks * slice)) *
                         ((slice + c - 1) / c);
      const MapLayout L = map_layout(h, w, ksize, rows, ranks, c, slice,
                                     chunks > 1 ? 2 : 1);
      if (L.smem <= kMaxSmem) return L;
    }
  }
  MapLayout none = map_layout(h, w, ksize, rows, ranks, 1, 1, 1);
  none.chunk = 0;
  return none;
}

__device__ __forceinline__ const float* map_source(const float* frames,
                                                   const float* prev0, int g,
                                                   int h, int w, int rlo) {
  return g < 0 ? prev0 + static_cast<size_t>(rlo) * w
               : frames + (static_cast<size_t>(g) * h + rlo) * w;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// All threads of every block of the cluster arrive and wait; shared-memory
// writes before it are visible to every block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank`'s shared
// memory, as a shared::cluster address.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(s),
               "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// The staging by the tensor memory accelerator: whole 16-B granules, one bulk
// copy per frame; the copies complete a transaction count on the buffer's
// mbarrier, on which the block waits.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int kRows, int kRadius>
__global__ void __launch_bounds__(kMapThreads)
motion_map_kernel(const float* __restrict__ frames,
                  const float* __restrict__ prev0,
                  const float* __restrict__ lmap0,
                  const uint8_t* __restrict__ active, float* __restrict__ out,
                  int t, int h, int w, MapTaps taps, int ksize, float alpha,
                  float one_minus_alpha, MapLayout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps_s = reinterpret_cast<float*>(smem);
  unsigned* act_s = reinterpret_cast<unsigned*>(smem + L.act_off);
  float* hb = reinterpret_cast<float*>(smem + L.hb_off);
  float* wt = reinterpret_cast<float*>(smem + L.walk_off);
  unsigned char* const buf0 = smem + L.buf_off;
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int r = kRadius >= 0 ? kRadius : ksize / 2;
  const int nt = 2 * r + 1;
  const int ranks = L.ranks;
  const int rank = ranks > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int b0 = (blockIdx.x / ranks) * kRows;
  const int rb = min(kRows, h - b0);           // rows of this band
  const int rlo = max(0, b0 - r);
  const int srows = min(h, b0 + rb + r) - rlo;
  const int band_px = rb * w;
  const int wp = w + 2 * r;                    // h-blur tile row, padded
  const int chunk = L.chunk, slice = L.slice;
  const int round_frames = ranks * slice;
  const int nrounds = (t + round_frames - 1) / round_frames;
  const int chunks_per_slice = (slice + chunk - 1) / chunk;
  // rank j walks pixels [j * npx, (j + 1) * npx) of the band
  const int npx = (band_px + ranks - 1) / ranks;
  const float inv_npx = 1.0f / static_cast<float>(npx);
  const int walk_lo = min(band_px, rank * npx);
  const int walk_hi = min(band_px, walk_lo + npx);
  const int walk_n = walk_hi - walk_lo;
  const int pitch = walk_pitch(round_frames);
  // the taps: from the kernel's parameters where the unrolled loops index
  // them by constants, from shared memory where the loops are not unrolled
  auto tap = [&](int d) { return kRadius >= 0 ? taps.k[d] : taps_s[d]; };
  const bool timed = L.phase_cycles && blockIdx.x == 0 && tid == 0;
  long long phase[7] = {0, 0, 0, 0, 0, 0, 0};
  long long clock_at = timed ? clock64() : 0;
  auto mark = [&](int i) {
    if (timed) {
      const long long c = clock64();
      phase[i] += c - clock_at;
      clock_at = c;
    }
  };

  // this rank's chunks, in order over all rounds: chunk q is chunk q %
  // chunks_per_slice of round q / chunks_per_slice; returns its first frame
  // and its frame count (0: past the end)
  auto chunk_at = [&](int q, int& t0, int& f0) {
    const int u = q / chunks_per_slice;
    const int c = q - u * chunks_per_slice;
    f0 = c * chunk;                              // first frame in the slice
    t0 = u * round_frames + rank * slice + f0;
    return max(0, min(min(chunk, slice - f0), t - t0));
  };
  // chunk q: lane 0 of every warp copies its share of the frames (frame f
  // by warp f % warps: one warp issues its copies one after another) into
  // buffer q % nbuf, the 16-B granules that hold each frame's rows (the bytes
  // outside the rows share a granule with them, so they lie in the same
  // allocation), so that the first row starts at staged_ptr(buffer, source).
  // The buffer's mbarrier expects one arrival per warp, each with its bytes;
  // its phase flips once per use
  const unsigned bar0 = smem_addr(smem + L.bar_off);
  const int warps = nthreads >> 5;
  auto stage_chunk = [&](int q) {
    if (lane != 0) return;
    int t0, f0;
    const int n = chunk_at(q, t0, f0);
    const int b = q & (L.nbuf - 1);
    unsigned char* const buf = buf0 + b * L.buffer_bytes;
    const int last = n > 0 ? n : -1;
    auto span = [&](int f, uintptr_t& lo) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          map_source(frames, prev0, t0 - 1 + f, h, w, rlo));
      lo = a & ~uintptr_t{15};
      return static_cast<unsigned>(
          ((a + srows * w * 4 + 15) & ~uintptr_t{15}) - lo);
    };
    unsigned total = 0;
    uintptr_t lo;
    for (int f = tid >> 5; f <= last; f += warps) total += span(f, lo);
    // the block's reads of this buffer (two chunks ago) come before the
    // copies that overwrite it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar0 + 8 * b, total);
    for (int f = tid >> 5; f <= last; f += warps) {
      const unsigned bytes = span(f, lo);
      bulk_copy(smem_addr(buf + f * L.frame_bytes),
                reinterpret_cast<const void*>(lo), bytes, bar0 + 8 * b);
    }
  };

  if (kRadius < 0)
    for (int d = tid; d < nt; d += nthreads) taps_s[d] = taps.k[d];
  if (tid == 0) {
    mbar_init(bar0, warps);
    mbar_init(bar0 + 8, warps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  stage_chunk(0);
  // the walker's map: one pixel per thread where this rank has no more pixels
  // than threads (every served shape), else in the output between rounds
  float lm = 0.0f;
  const bool one_px = walk_hi - walk_lo <= nthreads;
  if (one_px && walk_lo + tid < walk_hi)
    lm = lmap0[static_cast<size_t>(b0) * w + walk_lo + tid];
  mark(0);

  const int nq = nrounds * chunks_per_slice;
  for (int q = 0; q < nq; ++q) {
    int t0, f0;
    const int n = chunk_at(q, t0, f0);
    unsigned char* const buf = buf0 + (q & (L.nbuf - 1)) * L.buffer_bytes;
    if (L.nbuf == 2 && q + 1 < nq) stage_chunk(q + 1);
    mbar_wait(bar0 + 8 * (q & (L.nbuf - 1)), (q / L.nbuf) & 1);
    __syncthreads();
    mark(1);

    if (n > 0) {
      // 1. absdiff and h-axis blur: item (column x, run of frames)
      const int runs = max(1, nthreads / w);
      const int run_len = (n + runs - 1) / runs;
      for (int i = tid; i < w * runs; i += nthreads) {
        const int x = i % w;
        const int fa = (i / w) * run_len;
        const int fb = min(n, fa + run_len);
        if (fa >= fb) continue;
        // input row b0 - r + q' of the band, as an offset into a staged
        // frame (rows past the band's last are clamped: never stored)
        auto row_at = [&](int qq) {
          const int y = min(b0 - r + qq, b0 + rb - 1 + r);
          return (reflect101(y, h) - rlo) * w + x;
        };
        auto staged = [&](int f) {   // staged frame f: frame t0 - 1 + f
          return reinterpret_cast<const float*>(staged_ptr(
              buf + f * L.frame_bytes,
              map_source(frames, prev0, t0 - 1 + f, h, w, rlo)));
        };
        if (kRadius >= 0) {
          constexpr int kIn = kRows + 2 * (kRadius >= 0 ? kRadius : 0);
          int off[kIn];
          float prv[kIn];
#pragma unroll
          for (int qq = 0; qq < kIn; ++qq) off[qq] = row_at(qq);
          {
            const float* s = staged(fa);
#pragma unroll
            for (int qq = 0; qq < kIn; ++qq) prv[qq] = s[off[qq]];
          }
          for (int f = fa; f < fb; ++f) {
            const float* s = staged(f + 1);
            float acc[kRows] = {};
#pragma unroll
            for (int qq = 0; qq < kIn; ++qq) {
              const float c = s[off[qq]];
              const float a = fabsf(__fsub_rn(c, prv[qq]));
              prv[qq] = c;
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                const int d = qq - j;
                if (d < 0 || d > 2 * (kRadius >= 0 ? kRadius : 0)) continue;
                acc[j] = blur_step(acc[j], d, nt, a, tap);
              }
            }
            float* row = hb + static_cast<size_t>(f) * kRows * wp + r + x;
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              if (j < rb) {
                row[j * wp] = acc[j];
                if (x >= 1 && x <= r) row[j * wp - 2 * x] = acc[j];
                if (x >= w - 1 - r && x <= w - 2)
                  row[j * wp + 2 * (w - 1 - x)] = acc[j];
              }
            }
          }
        } else {
          for (int f = fa; f < fb; ++f) {
            const float* s = staged(f + 1);
            const float* p0 = staged(f);
            float acc[kRows] = {};
            for (int qq = 0; qq < rb + 2 * r; ++qq) {
              const int o = row_at(qq);
              const float a = fabsf(__fsub_rn(s[o], p0[o]));
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                const int d = qq - j;
                if (d < 0 || d >= nt) continue;
                acc[j] = blur_step(acc[j], d, nt, a, tap);
              }
            }
            float* row = hb + static_cast<size_t>(f) * kRows * wp + r + x;
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              if (j < rb) {
                row[j * wp] = acc[j];
                if (x >= 1 && x <= r) row[j * wp - 2 * x] = acc[j];
                if (x >= w - 1 - r && x <= w - 2)
                  row[j * wp + 2 * (w - 1 - x)] = acc[j];
              }
            }
          }
        }
      }
    }
    __syncthreads();
    mark(2);

    if (n > 0) {
      // 2. w-axis blur: item (frame f, band row j, four columns from x)
      // (the item's row fj = f * rb + j and group g advance by the thread
      // count without a division per item)
      const int groups = (w + 3) / 4;
      const int step_rows = nthreads / groups;
      const int step_g = nthreads - step_rows * groups;
      int fj = tid / groups;
      int g = tid - fj * groups;
      for (int i = tid; i < n * rb * groups;
           i += nthreads, fj += step_rows, g += step_g) {
        if (g >= groups) {
          g -= groups;
          ++fj;
        }
        const int x = g * 4;
        const int f = rb == kRows ? fj / kRows : fj / rb;
        const int j = fj - f * rb;
        const float* src = hb + (static_cast<size_t>(f) * kRows + j) * wp + x;
        float acc[4] = {};
        if (kRadius >= 0) {
          constexpr int kWin = 4 + 2 * (kRadius >= 0 ? kRadius : 0);
          float v[kWin];
#pragma unroll
          for (int e = 0; e < kWin; ++e) v[e] = src[e];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
#pragma unroll
            for (int d = 0; d < kWin - 3; ++d)
              acc[o] = blur_step(acc[o], d, nt, v[o + d], tap);
          }
        } else {
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            for (int d = 0; d < nt; ++d)
              acc[o] = blur_step(acc[o], d, nt, src[o + d], tap);
          }
        }
        // to the walker of each pixel: column k of its row of the walker's
        // tile
        const int k = rank * slice + f0 + f;
        const int p0 = j * w + x;
        // p0 / npx by a float reciprocal, corrected to the exact quotient
        int dest = __float2int_rz(__int2float_rn(p0) * inv_npx);
        dest -= dest * npx > p0;
        dest += (dest + 1) * npx <= p0;
        int bound = (dest + 1) * npx;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (x + o >= w) break;
          while (p0 + o >= bound) {
            ++dest;
            bound += npx;
          }
          const int at = (p0 + o - (bound - npx)) * pitch + k;
          if (dest == rank) {
            wt[at] = acc[o];
          } else {
            st_cluster(map_rank(wt + at, dest), acc[o]);
          }
        }
      }
    }
    mark(3);

    const int u = q / chunks_per_slice;
    if (q - u * chunks_per_slice != chunks_per_slice - 1) continue;

    // the round is blurred: its active words (frame u * round_frames + 32 v
    // + lane is bit lane of word v), then every push into every walker's
    // tile is complete
    const int rt0 = u * round_frames;
    const int rn = min(round_frames, t - rt0);
    for (int v0 = tid - lane; v0 < rn; v0 += nthreads) {
      const int i = v0 + lane;
      const unsigned word = __ballot_sync(
          0xffffffffu, i < rn && active[rt0 + i] != 0);
      if (lane == 0) act_s[v0 >> 5] = word;
    }
    if (ranks > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    mark(4);

    // 3. the walk: frame rt0 + k of pixel p is column k of row p - walk_lo
    // of this rank's tile, and its map replaces it there.  Four frames a
    // float4; the next 16 frames' loads are in flight while the chain walks
    // these; where all 16 are active the step is one fma
    for (int p = walk_lo + tid; p < walk_hi; p += nthreads) {
      if (!one_px)
        lm = u == 0 ? lmap0[static_cast<size_t>(b0) * w + p]
                    : out[(static_cast<size_t>(rt0 - 1) * h + b0) * w + p];
      float* row = wt + static_cast<size_t>(p - walk_lo) * pitch;
      auto step = [&](float& d, bool on) {
        // pinned rounding: round32(alpha*d), then one fused multiply-add
        const float nxt = __fmaf_rn(one_minus_alpha, lm, __fmul_rn(alpha, d));
        lm = on ? nxt : lm;
        d = lm;
      };
      auto walk4 = [&](float4& v, unsigned bits) {
        step(v.x, bits & 1);
        step(v.y, (bits >> 1) & 1);
        step(v.z, (bits >> 2) & 1);
        step(v.w, (bits >> 3) & 1);
      };
      float4* r4 = reinterpret_cast<float4*>(row);
      int k = 0;
      float4 cur[4], nxt[4];
      if (rn >= 16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[e] = r4[e];
      }
      for (; k + 16 <= rn; k += 16) {
        const bool more = k + 32 <= rn;
        if (more) {
#pragma unroll
          for (int e = 0; e < 4; ++e) nxt[e] = r4[(k >> 2) + 4 + e];
        }
        const unsigned long long two =
            act_s[k >> 5] |
            static_cast<unsigned long long>(act_s[(k >> 5) + 1]) << 32;
        const unsigned bits = static_cast<unsigned>(two >> (k & 31)) & 0xffffu;
        if (bits == 0xffffu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) walk4(cur[e], 0xfu);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) walk4(cur[e], (bits >> (4 * e)) & 0xfu);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) r4[(k >> 2) + e] = cur[e];
        if (more) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
        }
      }
      for (; k < rn; ++k) step(row[k], (act_s[k >> 5] >> (k & 31)) & 1);
    }
    mark(6);
    __syncthreads();
    // the maps out, coalesced: frame rt0 + k, this rank's pixels
    {
      const size_t frame = static_cast<size_t>(h) * w;
      float* o = out + (static_cast<size_t>(rt0) * h + b0) * w + walk_lo;
      if (walk_n > 0 && walk_n <= nthreads) {
        const int per = nthreads / walk_n;
        const int q = tid % walk_n;
        if (tid < per * walk_n)
          for (int k = tid / walk_n; k < rn; k += per)
            o[k * frame + q] = wt[static_cast<size_t>(q) * pitch + k];
      } else {
        for (int i = tid; i < rn * walk_n; i += nthreads) {
          const int k = i / walk_n;
          const int q = i - k * walk_n;
          o[k * frame + q] = wt[static_cast<size_t>(q) * pitch + k];
        }
      }
    }
    mark(5);
    // the next round's pushes wait until every walker is done with its tile
    // (the last round needs no barrier: every push came before the first)
    if (u + 1 < nrounds) {
      if (ranks > 1) {
        cluster_sync();
      } else {
        __syncthreads();
      }
    }
    mark(4);
  }
  if (timed)
    for (int i = 0; i < 7; ++i) L.phase_cycles[i] = phase[i];
}

using MapKernel = void (*)(const float*, const float*, const float*,
                          const uint8_t*, float*, int, int, int, MapTaps, int,
                          float, float, MapLayout);

inline MapKernel map_kernel(int rows, int ksize) {
#define OG_MAP_PICK(R)                                                        \
  if (rows == R)                                                              \
    return ksize == 13 ? motion_map_kernel<R, 6> : motion_map_kernel<R, -1>;
  OG_MAP_PICK(1)
  OG_MAP_PICK(2)
  OG_MAP_PICK(4)
  OG_MAP_PICK(8)
  OG_MAP_PICK(16)
#undef OG_MAP_PICK
  return nullptr;
}

inline cudaLaunchConfig_t map_config(const MapLayout& L, int h,
                                     cudaLaunchAttribute* attr,
                                     cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((h + L.rows - 1) / L.rows) * L.ranks);
  cfg.blockDim = dim3(kMapThreads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks of L's kernel an SM holds, and clusters the card holds at once.
inline cudaError_t map_occupancy(const MapLayout& L, int h, int ksize,
                                 int* per_sm, int* clusters) {
  const MapKernel kernel = map_kernel(L.rows, ksize);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem));
  if (e == cudaSuccess && per_sm)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kMapThreads, L.smem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = map_config(L, h, attr, nullptr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return e;
}

// The layout of a launch; rows, ranks 0: the defaults.  Default ranks: the
// most (up to kMaxRanks and the frame count) whose clusters the card holds
// all at once, every band in one wave (measured at (502, 48, 40): 4 ranks of
// 2-row bands, 96 blocks, 0.029 ms; 5 ranks, 120 blocks of which 22 clusters
// fit at once, 0.049 ms).  Picks are kept per shape.
inline cudaError_t pick_map_layout(int t, int h, int w, int ksize, int rows,
                                   int ranks, MapLayout* out) {
  if (rows <= 0) rows = default_map_rows(h);
  if (ranks > 0) {
    *out = choose_map_layout(t, h, w, ksize, rows, ranks);
    return cudaSuccess;
  }
  struct Pick {
    int t, h, w, ksize, rows;
    MapLayout L;
  };
  static Pick picks[32];
  static int npicks = 0;
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < npicks && i < 32; ++i) {
      const Pick& q = picks[i];
      if (q.t == t && q.h == h && q.w == w && q.ksize == ksize &&
          q.rows == rows) {
        *out = q.L;
        return cudaSuccess;
      }
    }
  }
  const int bands = (h + rows - 1) / rows;
  int most = kTargetBlocks / bands;
  most = most < 1 ? 1 : (most > kMaxRanks ? kMaxRanks : most);
  most = most > t ? t : most;
  MapLayout L = choose_map_layout(t, h, w, ksize, rows, 1);
  for (int k = most; k > 1; --k) {
    const MapLayout c = choose_map_layout(t, h, w, ksize, rows, k);
    if (c.chunk == 0) continue;
    int clusters = 0;
    const cudaError_t e = map_occupancy(c, h, ksize, nullptr, &clusters);
    if (e != cudaSuccess) return e;
    if (clusters >= bands) {
      L = c;
      break;
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  picks[npicks++ % 32] = Pick{t, h, w, ksize, rows, L};
  *out = L;
  return cudaSuccess;
}

inline bool map_args_ok(int t, int h, int w, int ksize, int rows, int ranks) {
  return t > 0 && ksize >= 1 && ksize <= kMaxTaps && ksize % 2 == 1 &&
         h > ksize / 2 && w > ksize / 2 &&
         (rows == 0 || rows == 1 || rows == 2 || rows == 4 || rows == 8 ||
          rows == 16) &&
         ranks >= 0 && ranks <= kMaxRanks && ranks <= t;
}

// rows, ranks <= 0: pick_map_layout picks them.  Refuses
// (cudaErrorInvalidValue) what the wrapper refuses too: an even or too large
// ksize, frames no larger than the blur's radius; and frames so wide that
// one frame's rows of a band do not fit shared memory.
int launch_motion_map(const void* frames, const void* prev0, const void* lmap0,
                      const void* active, void* out, int t, int h, int w,
                      const float* taps, int ksize, float alpha,
                      float one_minus_alpha, int rows, int ranks,
                      void* phase_cycles, void* stream) {
  if (rows < 0) rows = 0;
  if (ranks < 0) ranks = 0;
  if (!map_args_ok(t, h, w, ksize, rows, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  MapLayout L;
  cudaError_t e = pick_map_layout(t, h, w, ksize, rows, ranks, &L);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L.chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  L.phase_cycles = static_cast<long long*>(phase_cycles);
  MapTaps tp{};
  for (int d = 0; d < ksize; ++d) tp.k[d] = taps[d];
  const MapKernel kernel = map_kernel(L.rows, ksize);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      map_config(L, h, attr, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(frames),
                         static_cast<const float*>(prev0),
                         static_cast<const float*>(lmap0),
                         static_cast<const uint8_t*>(active),
                         static_cast<float*>(out), t, h, w, tp, ksize, alpha,
                         one_minus_alpha, L);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The gate over the sequences of `seg` (n of them, at most kSegs), the
// longest max_t frames; state holds n carries.
template <int kSegs>
int launch_gate_scan(const void* has, const void* raw, void* out_valid,
                     void* out_box, void* state, const Segments<kSegs>& seg,
                     int n, int max_t, float frame_h, float frame_w,
                     float max_shift, int padding, int max_hold,
                     void* walk_cycles, void* stream) {
  if (n == 0 || max_t == 0) return static_cast<int>(cudaSuccess);
  const int tile = max_t < kTile ? max_t : kTile;
  const size_t smem = gate_smem_bytes(tile, max_t > tile ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gate_scan_kernel<kSegs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gate_scan_kernel<kSegs><<<n, block_threads(tile), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(has), static_cast<const float*>(raw),
      static_cast<uint8_t*>(out_valid), static_cast<int*>(out_box),
      static_cast<int*>(state), seg, tile, frame_h, frame_w, max_shift,
      padding, max_hold, static_cast<long long*>(walk_cycles));
  return static_cast<int>(cudaGetLastError());
}

// The threshold chains of `seg` (n of them, at most kSegs), the longest
// max_t steps; thresh0 holds n seeds.
template <int kSegs>
int launch_thresh_chain(const void* thresh0, const void* cur, const void* n_px,
                        const void* active, void* out,
                        const Segments<kSegs>& seg, int n, int max_t,
                        float beta, float one_minus_beta, void* walk_cycles,
                        void* stream) {
  if (n == 0 || max_t == 0) return static_cast<int>(cudaSuccess);
  const auto* th0 = static_cast<const float*>(thresh0);
  const auto* c = static_cast<const float*>(cur);
  const auto* np = static_cast<const float*>(n_px);
  const auto* act = static_cast<const uint8_t*>(active);
  auto* o = static_cast<float*>(out);
  auto* cyc = static_cast<long long*>(walk_cycles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_t <= kWarpChain) {
    thresh_chain_warp_kernel<kSegs><<<n, 32, 0, s>>>(
        th0, c, np, act, o, seg, beta, one_minus_beta, cyc);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile = max_t < kTile ? max_t : kTile;
  const size_t smem = thresh_smem_bytes(tile, max_t > tile ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        thresh_chain_kernel<kSegs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  thresh_chain_kernel<kSegs><<<n, block_threads(tile), smem, s>>>(
      th0, c, np, act, o, seg, tile, beta, one_minus_beta, cyc);
  return static_cast<int>(cudaGetLastError());
}

// One sequence of t frames.
inline Segments<1> one_segment(int t) { return Segments<1>{{0, t}}; }

// Checks offsets (k + 1 non-decreasing values from 0) and returns the
// longest sequence, or -1.
int longest(const long long* offsets, int k) {
  if (k < 0 || offsets == nullptr || offsets[0] != 0) return -1;
  long long m = 0;
  for (int i = 0; i < k; ++i) {
    const long long n = offsets[i + 1] - offsets[i];
    if (n < 0 || n > INT32_MAX) return -1;
    m = n > m ? n : m;
  }
  return static_cast<int>(m);
}

// The longest of the sequences [first, first + n) of checked offsets.
int max_len(const long long* offsets, int first, int n) {
  long long m = 0;
  for (int i = first; i < first + n; ++i) {
    const long long len = offsets[i + 1] - offsets[i];
    m = len > m ? len : m;
  }
  return static_cast<int>(m);
}

// The sequences [first, first + n) of `offsets`, as one launch's segments
// counted from the flat inputs' start.
Segments<kBatchSegs> batch_segments(const long long* offsets, int first,
                                    int n) {
  Segments<kBatchSegs> seg{};
  for (int i = 0; i <= n; ++i) seg.start[i] = offsets[first + i];
  return seg;
}

}  // namespace

extern "C" {

int og_gate_scan(const void* has, const void* raw, void* out_valid,
                 void* out_box, void* state_f, void* state_i, int t,
                 float frame_h, float frame_w, float max_shift, int padding,
                 int max_hold, void* stream) {
  if (t < 0 || static_cast<int*>(state_i) + 4 != state_f)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gate_scan(has, raw, out_valid, out_box, state_i,
                          one_segment(t), 1, t, frame_h, frame_w, max_shift,
                          padding, max_hold, nullptr, stream);
}

// K sequences in one launch, one block each: sequence i is frames
// [offsets[i], offsets[i + 1]) of has (uint8), raw (float32 x4), out_valid
// and out_box (int32 x4); state holds K carries of six int32 (valid, w, h,
// miss, cx bits, cy bits), read at entry and holding each sequence's carry
// at exit.  offsets: K + 1 host values, non-decreasing from 0; lengths of 0
// are allowed.  More than 256 sequences take one launch per 256.
int og_gate_scan_batch(const void* has, const void* raw, void* out_valid,
                       void* out_box, void* state, const long long* offsets,
                       int k, float frame_h, float frame_w, float max_shift,
                       int padding, int max_hold, void* stream) {
  if (longest(offsets, k) < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < k; first += kBatchSegs) {
    const int n = k - first < kBatchSegs ? k - first : kBatchSegs;
    const int err = launch_gate_scan(
        has, raw, out_valid, out_box, static_cast<int*>(state) + 6 * first,
        batch_segments(offsets, first, n), n,
        max_len(offsets, first, n),
        frame_h, frame_w, max_shift, padding, max_hold, nullptr, stream);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaSuccess);
}

int og_thresh_chain(const void* thresh0, const void* cur, const void* n_px,
                    const void* active, void* out, int t, float beta,
                    float one_minus_beta, void* stream) {
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_thresh_chain(thresh0, cur, n_px, active, out, one_segment(t),
                             1, t, beta, one_minus_beta, nullptr, stream);
}

// K chains in one launch, one block (a warp where every chain has at most 32
// steps) each: chain i is steps [offsets[i], offsets[i + 1]) of cur, n_px,
// active (uint8) and out, from the seed thresh0[i].  offsets as in
// og_gate_scan_batch.
int og_thresh_chain_batch(const void* thresh0, const void* cur,
                          const void* n_px, const void* active, void* out,
                          const long long* offsets, int k, float beta,
                          float one_minus_beta, void* stream) {
  if (longest(offsets, k) < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < k; first += kBatchSegs) {
    const int n = k - first < kBatchSegs ? k - first : kBatchSegs;
    const int err = launch_thresh_chain(
        static_cast<const float*>(thresh0) + first, cur, n_px, active, out,
        batch_segments(offsets, first, n), n, max_len(offsets, first, n),
        beta, one_minus_beta, nullptr, stream);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaSuccess);
}

// The same launches, with the clock of the serial walk: thread 0 adds up
// clock64() around its walks and stores the sum (SM cycles) to walk_cycles,
// one long long on the device.  For measurement only (chip_smoke.py).
int og_gate_scan_walk_cycles(const void* has, const void* raw,
                             void* out_valid, void* out_box, void* state_f,
                             void* state_i, int t, float frame_h,
                             float frame_w, float max_shift, int padding,
                             int max_hold, void* walk_cycles, void* stream) {
  if (t < 0 || static_cast<int*>(state_i) + 4 != state_f)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gate_scan(has, raw, out_valid, out_box, state_i,
                          one_segment(t), 1, t, frame_h, frame_w, max_shift,
                          padding, max_hold, walk_cycles, stream);
}

int og_thresh_chain_walk_cycles(const void* thresh0, const void* cur,
                                const void* n_px, const void* active,
                                void* out, int t, float beta,
                                float one_minus_beta, void* walk_cycles,
                                void* stream) {
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_thresh_chain(thresh0, cur, n_px, active, out, one_segment(t),
                             1, t, beta, one_minus_beta, walk_cycles, stream);
}

int og_motion_map(const void* frames, const void* prev0, const void* lmap0,
                  const void* active, void* out, int t, int h, int w,
                  const float* taps, int ksize, float alpha,
                  float one_minus_alpha, void* stream) {
  return launch_motion_map(frames, prev0, lmap0, active, out, t, h, w, taps,
                           ksize, alpha, one_minus_alpha, 0, 0, nullptr,
                           stream);
}

// The same launch with bands of `rows` (1, 2, 4, 8 or 16) output rows split
// over clusters of `ranks` (1 to 8) blocks (0: the launch's own choice), and
// with phase_cycles (7 long longs on the device, or null) the SM cycles of
// block 0's phases.  For measurement only (chip_smoke.py).
int og_motion_map_as(const void* frames, const void* prev0, const void* lmap0,
                     const void* active, void* out, int t, int h, int w,
                     const float* taps, int ksize, float alpha,
                     float one_minus_alpha, int rows, int ranks,
                     void* phase_cycles, void* stream) {
  return launch_motion_map(frames, prev0, lmap0, active, out, t, h, w, taps,
                           ksize, alpha, one_minus_alpha, rows, ranks,
                           phase_cycles, stream);
}

// The layout such a launch takes: {rows, ranks, frames a rank stages at once,
// frames a rank blurs per round, staging buffers, shared bytes, blocks,
// blocks per SM, clusters the card holds at once}.  For measurement only.
int og_motion_map_layout(int t, int h, int w, int ksize, int rows, int ranks,
                         long long* info) {
  if (rows < 0) rows = 0;
  if (ranks < 0) ranks = 0;
  if (!map_args_ok(t, h, w, ksize, rows, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  MapLayout L;
  cudaError_t e = pick_map_layout(t, h, w, ksize, rows, ranks, &L);
  int per_sm = 0, clusters = 0;
  if (e == cudaSuccess && L.chunk > 0)
    e = map_occupancy(L, h, ksize, &per_sm, &clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long v[9] = {L.rows, L.ranks, L.chunk, L.slice, L.nbuf,
                          static_cast<long long>(L.smem),
                          ((h + L.rows - 1) / L.rows) * L.ranks, per_sm,
                          clusters};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
