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
// a few dozen scalar operations per frame that must run in frame order and
// stay bit-identical to the reference, so eager PyTorch would make thousands
// of tiny launches per video (or force a device-to-host copy in the middle of
// the pipeline).  One thread with the state in registers does the whole video
// in one launch; the bound is launch latency plus T dependent steps, not
// bytes (a 502-frame video moves ~20 KB).
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

// state_f: {cx, cy}; state_i: {valid, w, h, miss}.  Both are read at entry and
// hold the carry for the next segment at exit.
__global__ void gate_scan_kernel(const uint8_t* __restrict__ has,
                                 const float* __restrict__ raw,
                                 uint8_t* __restrict__ out_valid,
                                 int* __restrict__ out_box,
                                 float* state_f, int* state_i, int t,
                                 float frame_h, float frame_w,
                                 float max_shift, int padding, int max_hold) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float cx = state_f[0], cy = state_f[1];
  bool valid = state_i[0] != 0;
  int bw = state_i[1], bh = state_i[2], miss = state_i[3];
  for (int i = 0; i < t; ++i) {
    const float x1 = raw[4 * i], y1 = raw[4 * i + 1];
    const float x2 = raw[4 * i + 2], y2 = raw[4 * i + 3];
    const float ncx = __fmul_rn(__fadd_rn(x1, x2), 0.5f);
    const float ncy = __fmul_rn(__fadd_rn(y1, y2), 0.5f);
    const int nw = trunc_i32(__fsub_rn(x2, x1)) + 2 * padding;
    const int nh = trunc_i32(__fsub_rn(y2, y1)) + 2 * padding;
    const float jump = ref_hypot(__fsub_rn(ncx, cx), __fsub_rn(ncy, cy));
    const bool fresh = has[i] && (!valid || jump <= max_shift);
    const int miss2 = fresh ? 0 : (valid ? miss + 1 : miss);
    const bool expired = valid && !fresh && miss2 > max_hold;
    const bool v2 = (fresh || valid) && !expired;
    const float cx2 = fresh ? ncx : cx, cy2 = fresh ? ncy : cy;
    const int w2 = fresh ? nw : bw, h2 = fresh ? nh : bh;
    // output box: clamp the centre so the box stays in the frame; with
    // lo > hi the result is hi (min(max(c, lo), hi))
    // floor division by 2 (Python // on a possibly negative int)
    const int half_w = w2 >> 1;
    const int half_h = h2 >> 1;
    const float lo_x = static_cast<float>(half_w);
    const float lo_y = static_cast<float>(half_h);
    const float hi_x = __fsub_rn(frame_w, static_cast<float>(half_w));
    const float hi_y = __fsub_rn(frame_h, static_cast<float>(half_h));
    const int ocx = trunc_i32(fminf(fmaxf(cx2, lo_x), hi_x));
    const int ocy = trunc_i32(fminf(fmaxf(cy2, lo_y), hi_y));
    out_valid[i] = v2 ? 1 : 0;
    out_box[4 * i] = ocx - half_w;
    out_box[4 * i + 1] = ocy - half_h;
    out_box[4 * i + 2] = ocx + half_w;
    out_box[4 * i + 3] = ocy + half_h;
    // carry (an expiry resets everything so re-acquisition starts fresh)
    valid = v2;
    cx = expired ? 0.0f : cx2;
    cy = expired ? 0.0f : cy2;
    bw = expired ? 0 : w2;
    bh = expired ? 0 : h2;
    miss = expired ? 0 : miss2;
  }
  state_f[0] = cx;
  state_f[1] = cy;
  state_i[0] = valid ? 1 : 0;
  state_i[1] = bw;
  state_i[2] = bh;
  state_i[3] = miss;
}

__global__ void thresh_chain_kernel(const float* __restrict__ thresh0,
                                    const float* __restrict__ cur,
                                    const float* __restrict__ n_px,
                                    const uint8_t* __restrict__ active,
                                    float* __restrict__ out, int t,
                                    float beta, float one_minus_beta) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float th = thresh0[0];
  for (int i = 0; i < t; ++i) {
    const float c = n_px[i] > 10.0f ? cur[i] : th;
    // pinned rounding: round32((1-beta)*c), then one fused multiply-add
    const float th2 = __fmaf_rn(beta, th, __fmul_rn(one_minus_beta, c));
    th = active[i] ? th2 : th;
    out[i] = th;
  }
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

}  // namespace

extern "C" {

int og_gate_scan(const void* has, const void* raw, void* out_valid,
                 void* out_box, void* state_f, void* state_i, int t,
                 float frame_h, float frame_w, float max_shift, int padding,
                 int max_hold, void* stream) {
  gate_scan_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(has), static_cast<const float*>(raw),
      static_cast<uint8_t*>(out_valid), static_cast<int*>(out_box),
      static_cast<float*>(state_f), static_cast<int*>(state_i), t, frame_h,
      frame_w, max_shift, padding, max_hold);
  return static_cast<int>(cudaGetLastError());
}

int og_thresh_chain(const void* thresh0, const void* cur, const void* n_px,
                    const void* active, void* out, int t, float beta,
                    float one_minus_beta, void* stream) {
  thresh_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thresh0), static_cast<const float*>(cur),
      static_cast<const float*>(n_px), static_cast<const uint8_t*>(active),
      static_cast<float*>(out), t, beta, one_minus_beta);
  return static_cast<int>(cudaGetLastError());
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
