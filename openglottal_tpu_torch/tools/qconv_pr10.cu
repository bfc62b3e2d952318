// og_qconv's first form, kept as a yardstick only: no served path loads it.
// chip_smoke.py builds it beside csrc/qconv.cu (ops/_build.build_others) and
// times the two in turns on every U-Net layer shape; its C interface and its
// Args are csrc/qconv.cu's.  The s8 x s8 -> s32 convolution with the int8
// serving mode's epilogue, on mma.sync, one launch per layer (its SiLU still
// calls expf; csrc/qconv.cu takes XLA's exp).

// What it computes, for NHWC int8 activations x (one tensor, or two whose
// channels are concatenated along K without the concatenation being
// written), weights w [C_out][kh][kw][C_in] (K contiguous), per-channel
// weight scales sw and biases b (float32), the input scale sx and, for the
// requantising epilogues, rcp = f32(1 / s_next):
//
//   acc[m, o] = sum_{dy, dx, c} x[n, ho*s - p + dy, wo*s - p + dx, c] *
//                               w[o, dy, dx, c]        (zero outside the frame)
//   y         = fma(f32(acc), f32(sx) * sw[o], b[o])
//   relu_q:  out = q(max(y, 0))
//   silu_q:  out = q(fma(f32(r8), s_r, y * (1 / (1 + exp(-y)))))   (r8: the
//            residual, when given; else q(y * (1 / (1 + exp(-y)))))
//   f32:     out = y
//   q(v)     = clip(rint(v * rcp), -127, 127)
//
// That is the rounding the JAX package's compiled CPU code takes (found by
// comparing bits, tests/test_torch_port_quant.py): XLA contracts acc*m + b
// into one fma and turns the division by the constant scale into a
// multiplication by its float32 reciprocal.  Every float operation here is
// an explicitly rounded intrinsic, so nvcc cannot contract or reorder them,
// and ops/qconv_cuda.py's plain version repeats them one by one.
//
// Design.  An implicit GEMM: M = N*Ho*Wo output pixels, N = C_out, K =
// kh*kw*C_in.  A block of 256 threads (8 warps, 4 along M by 2 along N)
// computes a 128 x BN tile (BN = 16, 32 or 64 after C_out) with
// mma.sync.m16n8k32 s8*s8->s32, each warp 32 x BN/2.  The K loop takes 32
// bytes of K a step through a 3-stage cp.async ring in shared memory; each
// 16-byte half of a step's row is one tap's 16 consecutive channels (C_in is
// a multiple of 16), read from the frame or zero-filled by cp.async's
// src-size 0 at the frame's border and past K.  Shared rows are 48 bytes, so
// the fragments' 32-bit loads hit 32 distinct banks.  The epilogue runs on the
// accumulator registers and stores the output bytes directly.  What bounds a
// layer on this card: the 256x256 levels move more bytes than they take
// tensor-core time (a 32->32 3x3 layer does 288 int8 MACs per output byte),
// the deeper levels are operation-bound; this first form uses neither TMA nor
// wgmma, which are what a later PR would add.
//
// Plain C interface; nothing allocates or synchronises; the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;      // output pixels per block
constexpr int kBK = 32;       // K bytes per step (one m16n8k32)
constexpr int kRow = 48;      // shared bytes per tile row (32 + 16 padding)
constexpr int kStages = 3;

enum Epilogue { kReluQ = 0, kSiluQ = 1, kF32 = 2 };

// One launch's arguments (the C layout of ops/qconv_cuda.py's _Args): the
// 8-byte fields first, then the 4-byte ones.  Strides are in elements
// (bytes: int8); channels are contiguous.
struct Args {
  const int8_t* x0;         // first K source (channels [0, c0))
  const int8_t* x1;         // second K source (channels [c0, c0 + c1)) or null
  const int8_t* w;          // [cout][kh][kw][c0 + c1]
  const float* sw;          // [cout]
  const float* b;           // [cout]
  const int8_t* res;        // (n, ho, wo, cout) residual or null
  void* out;                // (n, ho, wo, cout) contiguous, int8 or float32
  long long x0_img, x0_row, x0_pix;
  long long x1_img, x1_row, x1_pix;
  long long res_img, res_row, res_pix;
  int c0, c1, n, h, w_in, ho, wo, cout, kh, kw, stride, pad, epi;
  float sx, rcp, sres;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q(v) = clip(rint(v * rcp), -127, 127) as int8
__device__ __forceinline__ int8_t requant(float v, float rcp) {
  float q = rintf(__fmul_rn(v, rcp));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const __grid_constant__ Args a) {
  constexpr int WN = BN / 2;    // columns per warp (2 warps along N)
  constexpr int NT = WN / 8;    // n8 tiles per warp
  constexpr int MT = 2;         // m16 tiles per warp (4 warps along M)
  __shared__ __align__(16) int8_t sA[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sB[kStages][BN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long M = static_cast<long long>(a.n) * a.ho * a.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int cin = a.c0 + a.c1;
  const int K = a.kh * a.kw * cin;
  const int KT = (K + kBK - 1) / kBK;

  // the A row this thread loads (one 16-byte half of it every step)
  const int ar = tid >> 1, ah = tid & 1;
  const long long am = m0 + ar;
  const bool arow_ok = am < M;
  int an = 0, aho = 0, awo = 0;
  if (arow_ok) {
    const long long q = am / a.wo;
    awo = static_cast<int>(am - q * a.wo);
    an = static_cast<int>(q / a.ho);
    aho = static_cast<int>(q - static_cast<long long>(an) * a.ho);
  }
  const int hi0 = aho * a.stride - a.pad, wi0 = awo * a.stride - a.pad;
  // the B row (output channel) this thread loads, if any
  const int br = tid >> 1, bh = tid & 1;
  const bool b_loader = br < BN;
  const int bo = n0 + br;

  auto load_step = [&](int stage, int kt) {
    const int k = kt * kBK + ah * 16;
    const int8_t* src = a.w;          // a valid address when nothing is read
    bool ok = false;
    if (arow_ok && k < K) {
      const int tap = k / cin, c = k - tap * cin;
      const int dy = tap / a.kw, dx = tap - dy * a.kw;
      const int hi = hi0 + dy, wi = wi0 + dx;
      if (hi >= 0 && hi < a.h && wi >= 0 && wi < a.w_in) {
        ok = true;
        src = c < a.c0
            ? a.x0 + an * a.x0_img + hi * a.x0_row + wi * a.x0_pix + c
            : a.x1 + an * a.x1_img + hi * a.x1_row + wi * a.x1_pix
                  + (c - a.c0);
      }
    }
    cp_async16(&sA[stage][ar * kRow + ah * 16], src, ok);
    if (b_loader) {
      const int kb = kt * kBK + bh * 16;
      const bool okb = bo < a.cout && kb < K;
      const int8_t* wsrc = okb ? a.w + static_cast<long long>(bo) * K + kb
                               : a.w;
      cp_async16(&sB[stage][br * kRow + bh * 16], wsrc, okb);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_step(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < KT) load_step(nk % kStages, nk);
    cp_async_commit();
    const int8_t* A = sA[kt % kStages];
    const int8_t* B = sB[kt % kStages];
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* r = A + (wm * 32 + i * 16 + g) * kRow + 4 * t;
      af[i][0] = lds32(r);
      af[i][1] = lds32(r + 8 * kRow);
      af[i][2] = lds32(r + 16);
      af[i][3] = lds32(r + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* r = B + (wn * WN + j * 8 + g) * kRow + 4 * t;
      bf[j][0] = lds32(r);
      bf[j][1] = lds32(r + 16);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // ── epilogue on the accumulators ────────────────────────────────────
  float mul[NT][2], bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * WN + j * 8 + 2 * t + e;
      const bool ok = col < a.cout;
      mul[j][e] = ok ? __fmul_rn(a.sx, a.sw[col]) : 0.f;
      bias[j][e] = ok ? a.b[col] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (row >= M) continue;
      const int8_t* rrow = nullptr;
      if (a.res != nullptr) {
        const long long q = row / a.wo;
        const int wo = static_cast<int>(row - q * a.wo);
        const int n = static_cast<int>(q / a.ho);
        const int ho = static_cast<int>(q - static_cast<long long>(n) * a.ho);
        rrow = a.res + n * a.res_img + ho * a.res_row + wo * a.res_pix;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * WN + j * 8 + 2 * t + e;
          if (col >= a.cout) continue;
          const float y = __fmaf_rn(__int2float_rn(acc[i][j][2 * half + e]),
                                    mul[j][e], bias[j][e]);
          const long long o = row * a.cout + col;
          if (a.epi == kF32) {
            static_cast<float*>(a.out)[o] = y;
          } else if (a.epi == kReluQ) {
            static_cast<int8_t*>(a.out)[o] = requant(fmaxf(y, 0.f), a.rcp);
          } else {
            const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y)));
            float v = __fmul_rn(y, sig);
            if (rrow != nullptr)
              v = __fmaf_rn(static_cast<float>(rrow[col]), a.sres, v);
            static_cast<int8_t*>(a.out)[o] = requant(v, a.rcp);
          }
        }
    }
}

}  // namespace

extern "C" {

int og_qconv_args_bytes() { return static_cast<int>(sizeof(Args)); }

// The tile width this launch takes for C_out (16, 32 or 64).
int og_qconv_tile_n(int cout) { return cout <= 16 ? 16 : cout <= 32 ? 32 : 64; }

// args: one Args (ops/qconv_cuda.py's _Args), read by the host and passed by
// value into the launch's parameter space.
int og_qconv(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  const long long m = static_cast<long long>(a.n) * a.ho * a.wo;
  if (m == 0 || a.cout == 0) return static_cast<int>(cudaGetLastError());
  const int bn = og_qconv_tile_n(a.cout);
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((a.cout + bn - 1) / bn));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 16) {
    qconv_kernel<16><<<grid, kThreads, 0, s>>>(a);
  } else if (bn == 32) {
    qconv_kernel<32><<<grid, kThreads, 0, s>>>(a);
  } else {
    qconv_kernel<64><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
