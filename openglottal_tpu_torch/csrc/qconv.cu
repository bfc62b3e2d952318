// The int8 convolution of the int8 serving mode: s8 x s8 -> s32 on Hopper's
// warpgroup tensor-core instruction (wgmma), with its dequantising and
// requantising epilogue, in one launch per layer.
//
//   og_qconv  <- the int8 convolutions of openglottal_tpu/models/quant.py:
//                _qconv / _qconv_relu_q (every U-Net conv but the stem),
//                _YoloWalk.cbs (every YOLOv8n ConvBNSiLU but the stem, with
//                the C2f bottleneck's residual) and _YoloWalk.head_conv (the
//                detect head's last 1x1 convolutions, f32 logits)
//
// Replaces no Pallas kernel: the reference lets XLA lower
// conv_general_dilated(..., preferred_element_type=int32) and fuse the
// epilogue into it.  PyTorch has no int8 convolution on CUDA, and an im2col
// matrix through an int8 matmul would write the activation nine times over
// and the s32 product to device memory before the epilogue.  Here the s32
// sums live in registers and only the layer's int8 (or f32) output is
// written.
//
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
// into one fma, turns the division by the constant scale into a
// multiplication by its float32 reciprocal, and computes exp with a Cephes
// polynomial whose multiply-adds it fuses, flushing subnormal results
// (exp_xla below).  Every float operation here is an explicitly rounded
// intrinsic, so nvcc cannot contract or reorder them, and
// ops/qconv_cuda.py's plain version repeats them one by one.
//
// Design.  An implicit GEMM: M = N*Ho*Wo output pixels, N = C_out, K =
// kh*kw*C_in, on wgmma.mma_async.m64nBNk32.s32.s8.s8 (BN = 16, 32, 64, 128
// or 256 after C_out: the whole of C_out <= 256 in one tile, so the input
// is read once for all output channels; C_out 512 takes two column tiles).
// Both operands are K-major in shared memory, which 8-bit wgmma requires.
// Blocks are persistent (one per SM, walking tiles with the grid's stride)
// and warp-specialised: TMA and cp.async fill a ring of stages guarded by
// mbarriers, two consumer warpgroups run wgmma on it.  Two forms, chosen
// per launch by shape (og_qconv_form; ops/qconv_cuda.halo_stages states
// the same rule):
//
//   * the halo form (stride 1, C_in a multiple of 32, C_out <= 128, the
//     weights small enough to stay in shared memory: every U-Net layer at
//     64x64 and wider, the windowed decoder's too).  The weights come once
//     per block by TMA; a stage is a tile's input window, one 4-D TMA box
//     per input row and 16-channel chunk with the zero border from TMA's
//     out-of-bounds fill; wgmma reads each of the kh x kw taps straight
//     from the window through a shifted descriptor, so the input crosses
//     L2 about (rows + 2) / rows times instead of kh x kw times, and no
//     im2col is formed.  The consumer warpgroups take alternate tiles of
//     up to four 64-pixel blocks, so one's epilogue runs under the other's
//     wgmma (qconv_halo_kernel).
//   * the gathering form (the rest: stride 2, C_in 16 or 48, C_out 256 and
//     512, the 32x32 and smaller levels, whose weights are large).  A tile
//     is 128 output pixels by BN; a stage is 128 bytes of K (one row of
//     the 128-byte swizzle, four k32 steps: a whole tap's channels at C_in
//     128, two taps at 64, four at 32, eight at 16).  The weights' box
//     {128 bytes of K, BN rows} comes by TMA with the 128-byte swizzle;
//     the activations are gathered by a producer warpgroup with cp.async,
//     16 bytes an instruction, zero-filled at the frame's border, written
//     in the same swizzle by hand, and released by
//     cp.async.mbarrier.arrive.noinc as they land.  Each row's window
//     offsets and in-frame taps are computed once a tile; past K nothing
//     is copied (the weights' out-of-bounds columns are zero).  TMA's
//     im2col mode was not taken: window views, two K sources and C_in 16 /
//     48 would need a tensor map per tap and source, and a 16-byte box row
//     costs TMA as much as a 128-byte one.  The consumers keep one stage's
//     wgmmas in flight while issuing the next (qconv_kernel).
//
// The epilogue runs on the accumulators (wgmma's s32 fragment is mma.sync's
// C layout repeated over BN / 8), stages each 64-row block's int8 output in
// shared memory and stores it in 16-byte vectors (a block of one column
// tile is one contiguous run of the output); the f32 epilogue (the detect
// head's logits) stores from the registers.
//
// What bounds a layer on this card: the 256x256 levels move more bytes than
// they take tensor-core time (a 32->32 3x3 layer does 288 int8 MACs per
// output byte), the deeper levels are operation-bound, and in the gathering
// form every tile reads the weights again from L2.
//
// Plain C interface; nothing allocates or synchronises; the launch function
// returns cudaGetLastError() (or a CUDA error code if a tensor map cannot
// be made).  The driver's cuTensorMapEncodeTiled comes through
// the runtime's entry-point query, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output pixels per gathered tile
constexpr int kBK = 128;            // K bytes per stage (one swizzle row)
constexpr int kTileA = kBM * kBK;   // 16 KB
constexpr int kThreads = 384;       // consumers: warpgroups 0, 1; producer: 2

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

// What the host derives from Args for one launch of the gathering form.
struct Plan {
  long long m;        // output pixels
  long long tiles;    // row tiles * column tiles
  int k;              // kh * kw * (c0 + c1)
  int kt;             // stages per tile: ceil(k / 128)
  int tiles_n;        // column tiles
};

// The gathering form's ring stages by tile width: as many as shared memory
// holds beside the output tile (the 256-wide tiles are operation-bound: 3
// suffice).
template <int BN> struct Ring;
template <> struct Ring<16> { static constexpr int kStages = 8; };
template <> struct Ring<32> { static constexpr int kStages = 8; };
template <> struct Ring<64> { static constexpr int kStages = 6; };
template <> struct Ring<128> { static constexpr int kStages = 5; };
template <> struct Ring<256> { static constexpr int kStages = 3; };

// The gathering form's dynamic shared memory, from a 1024-byte aligned base
// (the swizzle's period): the A stages, the B stages, the int8 output
// tile, two row tables (a tile's rows: offsets into both sources, tap
// masks), the full and empty barriers.
template <int BN>
struct Smem {
  static constexpr int kStages = Ring<BN>::kStages;
  static constexpr int kTileB = BN * kBK;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kTileA;
  static constexpr int kOut = kB + kStages * kTileB;
  static constexpr int kRows = kOut + kBM * BN;       // 2 x 128 x 2 offsets
  static constexpr int kMasks = kRows + 2 * kBM * 16;  // 2 x 128 tap masks
  static constexpr int kBars = kMasks + 2 * kBM * 4;
  static constexpr int kAlloc = kBars + 2 * kStages * 8 + 1024;
};

// ── PTX ─────────────────────────────────────────────────────────────────

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of the given parity to complete.  A wait of more than
// ~10 s (2^34 cycles) can only be a fault of the ring's bookkeeping: it traps,
// so the launch fails with an error instead of hanging the process.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Arrives on the barrier once all of this thread's earlier cp.async have
// landed; the barrier's count includes the arrival (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins the accumulators' registers at this point of the program, so that
// the compiler moves no read or write of them across a wgmma's issue or wait.
template <int R>
__device__ __forceinline__ void fence_acc(int* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");
}

// A shared-memory matrix descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle: start address >> 4, leading offset 16 bytes (not
// read for this layout), stride 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// A descriptor of a K-major tile without swizzle: 8-row core matrices of
// 16-byte rows stored contiguously (128 bytes), `kstride` bytes between the
// two core matrices of a k32 step, 128 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr,
                                               uint32_t kstride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kstride >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// wgmma.mma_async m64nNk32 s8 x s8 -> s32, A and B from descriptors; the
// accumulators are N / 2 registers a thread.
template <int N> struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};


// q(v) = clip(rint(v * rcp), -127, 127) as int8
__device__ __forceinline__ int8_t requant(float v, float rcp) {
  float q = rintf(__fmul_rn(v, rcp));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// exp as XLA's CPU code computes it (ops/qconv_cuda.exp_xla, step for step):
// n = clamp(floor(fma(x, log2 e, 0.5)), -127, 127); a = x - n ln 2 in two
// fmas; a degree-5 Cephes polynomial in fmas; times 2^n (0 for n = -127);
// a subnormal result flushed to 0.
__device__ __forceinline__ float flush32(float v) {
  return v < 1.17549435e-38f ? 0.f : v;
}

__device__ __forceinline__ float exp_xla(float x) {
  x = fminf(fmaxf(x, -87.8f), 88.8f);
  const float n = fminf(
      fmaxf(floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f)), -127.f),
      127.f);
  float r = __fmaf_rn(-0.693359375f, n, x);
  r = __fmaf_rn(2.12194440e-4f, n, r);
  float z = __fmaf_rn(r, 1.9875691500e-4f, 1.3981999507e-3f);
  z = __fmaf_rn(z, r, 8.3334519073e-3f);
  z = __fmaf_rn(z, r, 4.1665795894e-2f);
  z = __fmaf_rn(z, r, 1.6666665459e-1f);
  z = __fmaf_rn(z, r, 5.0000001201e-1f);
  z = __fadd_rn(__fmaf_rn(z, __fmul_rn(r, r), r), 1.f);
  const float pow2 = __int_as_float((static_cast<int>(n) + 127) << 23);
  return flush32(__fmul_rn(z, pow2));
}

// ── the epilogue, on one warpgroup's 64 rows of a tile ──────────────────

// acc: the thread's wgmma fragment of one m64 block, output pixels m0 ..
// m0 + 63 (those at or past pm are not stored), columns n0 ..; stage_out:
// the warpgroup's staging area (64 x BN bytes).
template <int BN>
__device__ __forceinline__ void epilogue(const Args& a, long long pm,
                                         long long m0, int n0, const int* acc,
                                         uint8_t* stage_out) {
  const int wg = threadIdx.x >> 7;
  const int ct = threadIdx.x & 127;
  const int warp = ct >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ncols = min(BN, a.cout - n0);      // this tile's columns
  const int rloc = warp * 16 + g;              // rows rloc, rloc + 8
  if (a.epi == kF32) {
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + rloc + 8 * h;
      if (row >= pm) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          if (col >= ncols) continue;
          const float mul = __fmul_rn(a.sx, __ldg(a.sw + n0 + col));
          out[row * a.cout + n0 + col] = __fmaf_rn(
              __int2float_rn(acc[4 * j + 2 * h + e]), mul,
              __ldg(a.b + n0 + col));
        }
    }
    return;
  }
  named_sync(2 + wg, 128);          // the last tile's copy has read it
  if (a.epi == kReluQ) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col >= ncols) continue;
        const float mul = __fmul_rn(a.sx, __ldg(a.sw + n0 + col));
        const float bias = __ldg(a.b + n0 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = __fmaf_rn(
              __int2float_rn(acc[4 * j + 2 * h + e]), mul, bias);
          stage_out[(rloc + 8 * h) * ncols + col] =
              static_cast<uint8_t>(requant(fmaxf(y, 0.f), a.rcp));
        }
      }
  } else {
    const int8_t* rrow[2] = {nullptr, nullptr};
    if (a.res != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + rloc + 8 * h;
        if (row >= pm) continue;
        const long long q = row / a.wo;
        const int wo = static_cast<int>(row - q * a.wo);
        const int n = static_cast<int>(q / a.ho);
        const int ho = static_cast<int>(q - static_cast<long long>(n) *
                                        a.ho);
        rrow[h] = a.res + n * a.res_img + ho * a.res_row + wo * a.res_pix
                  + n0;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col >= ncols) continue;
        const float mul = __fmul_rn(a.sx, __ldg(a.sw + n0 + col));
        const float bias = __ldg(a.b + n0 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = __fmaf_rn(
              __int2float_rn(acc[4 * j + 2 * h + e]), mul, bias);
          const float sig = flush32(__fdiv_rn(1.f,
                                              __fadd_rn(exp_xla(-y), 1.f)));
          float v = __fmul_rn(y, sig);
          if (rrow[h] != nullptr)
            v = __fmaf_rn(static_cast<float>(rrow[h][col]), a.sres, v);
          stage_out[(rloc + 8 * h) * ncols + col] =
              static_cast<uint8_t>(requant(v, a.rcp));
        }
      }
  }
  named_sync(2 + wg, 128);          // the block's 64 rows are staged

  // store the block's rows in 16-byte vectors
  const long long row0 = m0;
  const long long left = pm - row0;
  const int nrows = left <= 0 ? 0 : left < 64 ? static_cast<int>(left) : 64;
  const uint8_t* src = stage_out;
  int8_t* out = static_cast<int8_t*>(a.out);
  if (ncols == a.cout) {            // the rows are one run of the output
    int8_t* dst = out + row0 * a.cout;
    const int nb = nrows * ncols;
    const bool aligned = ((reinterpret_cast<uintptr_t>(dst) |
                           reinterpret_cast<uintptr_t>(src)) & 15) == 0;
    const int nv = aligned ? nb & ~15 : 0;
    for (int i = ct * 16; i < nv; i += 128 * 16)
      *reinterpret_cast<int4*>(dst + i) =
          *reinterpret_cast<const int4*>(src + i);
    for (int i = nv + ct; i < nb; i += 128)
      dst[i] = static_cast<int8_t>(src[i]);
  } else if (((a.cout | n0 | ncols) & 15) == 0) {
    const int per_row = ncols >> 4;
    for (int i = ct; i < nrows * per_row; i += 128) {
      const int r = i / per_row, c16 = (i - r * per_row) * 16;
      *reinterpret_cast<int4*>(out + (row0 + r) * a.cout + n0 + c16) =
          *reinterpret_cast<const int4*>(src + r * ncols + c16);
    }
  } else {
    for (int i = ct; i < nrows * ncols; i += 128) {
      const int r = i / ncols, c = i - r * ncols;
      out[(row0 + r) * a.cout + n0 + c] = static_cast<int8_t>(src[i]);
    }
  }
}

// ── the gathering form's producer: B by TMA, A by cp.async ──────────────

template <int BN>
__device__ __forceinline__ void produce(const CUtensorMap* wmap,
                                        const Args& a, const Plan& p,
                                        uint8_t* smem) {
  using L = Smem<BN>;
  constexpr int S = L::kStages;
  const uint32_t sA = smem_u32(smem + L::kA), sB = smem_u32(smem + L::kB);
  const uint32_t full = smem_u32(smem + L::kBars), empty = full + 8 * S;
  longlong2* offs = reinterpret_cast<longlong2*>(smem + L::kRows);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L::kMasks);
  const int pt = threadIdx.x - 256;
  const int chunk = pt & 7;          // this thread's 16 bytes of each row
  const int r0 = pt >> 3;            // its rows: r0, r0 + 16, ..., r0 + 112
  const uint32_t swz = static_cast<uint32_t>((chunk ^ (r0 & 7)) << 4);
  const int cin = a.c0 + a.c1;
  int slot = 0, phase = 0, buf = 0;

  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long tm = tile / p.tiles_n;
    const int n0 = static_cast<int>(tile - tm * p.tiles_n) * BN;
    const long long m0 = tm * kBM;
    // row pt of the tile: its window's offset into each source and the
    // taps that fall inside the frame (bit 31: the row is below M)
    longlong2* off = offs + buf * kBM;
    uint32_t* mask = masks + buf * kBM;
    buf ^= 1;
    {
      const long long m = m0 + pt;
      longlong2 o = make_longlong2(0, 0);
      uint32_t bits = 0;
      if (m < p.m) {
        const long long q = m / a.wo;
        const int wo = static_cast<int>(m - q * a.wo);
        const int n = static_cast<int>(q / a.ho);
        const int ho = static_cast<int>(q - static_cast<long long>(n) * a.ho);
        const int hi0 = ho * a.stride - a.pad, wi0 = wo * a.stride - a.pad;
        o.x = n * a.x0_img + hi0 * a.x0_row + wi0 * a.x0_pix;
        o.y = n * a.x1_img + hi0 * a.x1_row + wi0 * a.x1_pix;
        bits = 1u << 31;
        for (int dy = 0; dy < a.kh; ++dy)
          for (int dx = 0; dx < a.kw; ++dx)
            if (hi0 + dy >= 0 && hi0 + dy < a.h && wi0 + dx >= 0 &&
                wi0 + dx < a.w_in)
              bits |= 1u << (dy * a.kw + dx);
      }
      off[pt] = o;
      mask[pt] = bits;
    }
    named_sync(1, 128);

    for (int kt = 0; kt < p.kt; ++kt) {
      mbar_wait(empty + 8 * slot, phase ^ 1);
      if (pt == 0) {
        mbar_arrive_tx(full + 8 * slot, L::kTileB);
        tma_load_2d(sB + slot * L::kTileB, wmap, kt * kBK, n0,
                    full + 8 * slot);
      }
      // this thread's chunk of K: one tap, 16 channels of one source.  Past
      // K nothing is copied: B's columns there are zero (the tensor map's
      // out-of-bounds fill), so whatever the stage holds adds nothing.
      const int k = kt * kBK + chunk * 16;
      if (k < p.k) {
        const int tap = k / cin;
        const int c = k - tap * cin;
        const int dy = tap / a.kw, dx = tap - dy * a.kw;
        const bool second = c >= a.c0;
        const int8_t* base = second
            ? a.x1 + (c - a.c0) + dy * a.x1_row + dx * a.x1_pix
            : a.x0 + c + dy * a.x0_row + dx * a.x0_pix;
        const uint32_t bit = 1u << tap;
        const uint32_t dst = sA + slot * kTileA + r0 * kBK + swz;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int r = r0 + 16 * s;
          const uint32_t bits = mask[r];
          if (bits == 0) continue;       // past M: the row is not stored
          const longlong2 o = off[r];
          const bool inside = (bits & bit) != 0;
          const int8_t* src = inside ? base + (second ? o.y : o.x) : a.w;
          cp_async16(dst + s * 16 * kBK, src, inside);
        }
      }
      cp_async_arrive(full + 8 * slot);
      if (++slot == S) { slot = 0; phase ^= 1; }
    }
  }
}

// ── the gathering form's consumers: wgmma over the ring, the epilogue ───

template <int BN>
__device__ __forceinline__ void consume(const Args& a, const Plan& p,
                                        uint8_t* smem) {
  using L = Smem<BN>;
  constexpr int S = L::kStages;
  const uint32_t sA = smem_u32(smem + L::kA), sB = smem_u32(smem + L::kB);
  const uint32_t full = smem_u32(smem + L::kBars), empty = full + 8 * S;
  uint8_t* stage_out = smem + L::kOut;
  const int wg = threadIdx.x >> 7;         // 0 or 1: rows 64 wg .. + 63
  const int lane = threadIdx.x & 31;
  int slot = 0, phase = 0;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long tm = tile / p.tiles_n;
    const int n0 = static_cast<int>(tile - tm * p.tiles_n) * BN;
    const long long m0 = tm * kBM;
    // one stage's four k32 steps in flight while the next is issued; a
    // stage is freed once the steps after it were issued and it is done
    int prev = -1;
    for (int kt = 0; kt < p.kt; ++kt) {
      mbar_wait(full + 8 * slot, phase);
      fence_proxy_async();             // the cp.async bytes, to wgmma's view
      const uint64_t da = desc_sw128(sA + slot * kTileA + wg * 64 * kBK);
      const uint64_t db = desc_sw128(sB + slot * L::kTileB);
      fence_acc<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)   // 32 bytes: +2 in the descriptor
        Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc<BN / 2>(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = slot;
      if (++slot == S) { slot = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    epilogue<BN>(a, p.m, m0 + wg * 64, n0, acc, stage_out + wg * 64 * BN);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ Args a, const Plan p) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    const uint32_t full = smem_u32(smem + L::kBars);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);            // producer threads + TMA
      mbar_init(full + 8 * (L::kStages + s), 8);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256)
    produce<BN>(&wmap, a, p, smem);
  else
    consume<BN>(a, p, smem);
}

// ── the halo form: stride-1 layers with resident weights ────────────────

// What the host derives for the halo form (halo_plan below).  A tile is
// one consumer warpgroup's: mb blocks of 64 output pixels, tr output rows
// of tw pixels (tw = min(128, 64 mb), or 64 where the output is 64 pixels
// wide or less), so each block lies in one row.  A block past the row's end or the
// frame's last row is not stored.
struct Halo {
  long long m, tiles;
  int segs, groups;    // tiles along a row, groups of tr rows a frame
  int kb;              // 128-byte K blocks of the resident weights
  int tw, tr;          // a tile's output rows and pixels a row
  int hr, hw;          // a stage's input rows and pixels (tw + kw - 1)
  int plane;           // bytes of one (input row, 16-channel chunk) plane
  int ch, ch0;         // 16-channel chunks of both sources, of the first
  int stages;          // even: the two warpgroups take alternate stages
  int mb, per_sm;      // the kernel's shape (its list is above the kernel)
  int off_halo, off_out, off_bars, bytes;   // dynamic shared memory
};

constexpr int kHaloThreads = 288;   // consumers: warpgroups 0, 1; producer

// A kernel's shape: MB blocks of 64 pixels in a warpgroup's tile, PER_SM
// thread blocks an SM.  Two blocks an SM give the epilogue, the bytes-bound
// layers' cost, twice the warps to hide its latency, at 96 registers a
// thread and half the shared memory; the accumulators (MB x BN / 2
// registers) fit without spilling in every shape taken:
//   BN 16: 4 blocks, 2 an SM;  BN 32: 2 blocks, 2 an SM;
//   BN 64: 1 block, 2 an SM, or (weights too large for half the shared
//          memory) 2 blocks, 1 an SM;  BN 128: 1 block, 1 an SM.

// The weights stay in shared memory for the block's life (their [C_out][K]
// rows in 128-byte K blocks, the 128-byte swizzle, by TMA once).  A stage
// holds the input window of one tile: for each of its hr rows and each
// 16-channel chunk, a plane of hw pixels x 16 bytes, one 4-D TMA box of the
// NHWC source (its out-of-bounds fill is the zero border).  A plane is
// what wgmma's unswizzled K-major layout reads: 8 pixels of 16 bytes make
// a core matrix, the next chunk's plane is the other half of a k32 step.
// So tap (dy, dx) of a block of 64 pixels is the same planes read from row
// dy, dx pixels on: nine descriptors over one copy of the input, no
// im2col.  The two consumer warpgroups take alternate tiles (ping-pong),
// so one's epilogue runs under the other's wgmma; within a tile the blocks'
// wgmmas interleave (independent accumulators).  One producer thread issues
// the boxes.
template <int BN, int MB, int PER_SM>
__global__ void __launch_bounds__(kHaloThreads, PER_SM)
qconv_halo_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap0,
                  const __grid_constant__ CUtensorMap xmap1,
                  const __grid_constant__ Args a, const Halo h) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sB = smem_u32(smem), sH = smem_u32(smem + h.off_halo);
  const uint32_t full = smem_u32(smem + h.off_bars);
  const uint32_t empty = full + 8 * h.stages, wfull = empty + 8 * h.stages;
  const int stage_bytes = h.hr * h.ch * h.plane;
  if (threadIdx.x == 0) {
    for (int s = 0; s < h.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);      // the consuming warpgroup's warps
    }
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    mbar_arrive_tx(wfull, h.kb * BN * kBK);
    for (int j = 0; j < h.kb; ++j)
      tma_load_2d(sB + j * BN * kBK, &wmap, j * kBK, 0, wfull);
    int slot = 0, phase = 0;
    for (long long tile = blockIdx.x; tile < h.tiles; tile += gridDim.x) {
      const long long q = tile / h.segs;
      const int wo0 = static_cast<int>(tile - q * h.segs) * h.tw;
      const int n = static_cast<int>(q / h.groups);
      const int ho0 = static_cast<int>(q - static_cast<long long>(n) *
                                       h.groups) * h.tr;
      mbar_wait(empty + 8 * slot, phase ^ 1);
      mbar_arrive_tx(full + 8 * slot, h.hr * h.ch * h.hw * 16);
      const uint32_t dst = sH + slot * stage_bytes;
      for (int r = 0; r < h.hr; ++r)
        for (int c = 0; c < h.ch; ++c) {
          const bool second = c >= h.ch0;
          tma_load_4d(dst + (r * h.ch + c) * h.plane,
                      second ? &xmap1 : &xmap0,
                      (second ? c - h.ch0 : c) * 16, wo0 - a.pad,
                      ho0 - a.pad + r, n, full + 8 * slot);
        }
      if (++slot == h.stages) { slot = 0; phase ^= 1; }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int cin = h.ch * 16;
  uint8_t* stage_out = smem + h.off_out + wg * 64 * BN;
  int acc[MB][BN / 2];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0;
  mbar_wait(wfull, 0);
  // the block's tiles alternate between the warpgroups: this one's are
  // the i-th with i = wg, wg + 2, ..., in stage i % stages
  long long i = wg;
  for (long long tile = blockIdx.x + wg * static_cast<long long>(gridDim.x);
       tile < h.tiles; tile += 2ll * gridDim.x, i += 2) {
    const int slot = static_cast<int>(i % h.stages);
    mbar_wait(full + 8 * slot, static_cast<int>((i / h.stages) & 1));
    const uint32_t win = sH + slot * stage_bytes;
#pragma unroll
    for (int b = 0; b < MB; ++b) fence_acc<BN / 2>(acc[b]);
    wgmma_fence();
    int scale = 0;
    for (int dy = 0; dy < a.kh; ++dy)
      for (int dx = 0; dx < a.kw; ++dx) {
        const int k_tap = (dy * a.kw + dx) * cin;
        for (int c = 0; c < h.ch; c += 2) {
          const int k = k_tap + c * 16;
          const uint64_t db = desc_sw128(sB + (k >> 7) * BN * kBK +
                                         (k & 127));
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            const int row = b * 64 / h.tw, col = b * 64 - row * h.tw;
            const uint32_t at = win + ((row + dy) * h.ch + c) * h.plane +
                                (col + dx) * 16;
            Wgmma<BN>::mma(acc[b], desc_plain(at, h.plane), db, scale);
          }
          scale = 1;
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < MB; ++b) fence_acc<BN / 2>(acc[b]);
    if (lane == 0) mbar_arrive(empty + 8 * slot);

    const long long q = tile / h.segs;
    const int wo0 = static_cast<int>(tile - q * h.segs) * h.tw;
    const int n = static_cast<int>(q / h.groups);
    const int ho0 = static_cast<int>(q - static_cast<long long>(n) *
                                     h.groups) * h.tr;
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      const int ho = ho0 + b * 64 / h.tw;
      const int wo = wo0 + b * 64 - (b * 64 / h.tw) * h.tw;
      const int valid = ho < a.ho && wo < a.wo
                            ? (a.wo - wo < 64 ? a.wo - wo : 64) : 0;
      const long long first = (static_cast<long long>(n) * a.ho + ho) *
                              a.wo + wo;
      epilogue<BN>(a, first + valid, first, 0, acc[b], stage_out);
    }
  }
}

// ── host ────────────────────────────────────────────────────────────────

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Lets the tile width's kernel take its dynamic shared memory (once).
template <int BN>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      qconv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<BN>::kAlloc);
  configured = e == cudaSuccess;
  return e;
}

template <int BN>
int blocks_per_sm() {
  int n = 0;
  if (configure<BN>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, qconv_kernel<BN>, kThreads, Smem<BN>::kAlloc) != cudaSuccess)
    return -1;
  return n;
}

constexpr int kSmemMax = 232448;     // a block's dynamic shared memory

bool halo_fit(const Args& a, int bn, Halo* h);

// The halo form's plan, or false where the layer does not fit it: stride 1,
// C_in a multiple of 32, C_out <= 128, and the weights with at least two
// stages beside them in shared memory.
bool halo_plan(const Args& a, int bn, Halo* h) {
  const int cin = a.c0 + a.c1;
  if (a.stride != 1 || cin % 32 != 0 || a.cout > 128) return false;
  // the kernel's shapes for this tile width, the first whose stages fit
  for (int shape = 0; shape < 2; ++shape) {
    h->per_sm = bn <= 64 && shape == 0 ? 2 : 1;
    h->mb = bn <= 16 ? 4 : bn <= 32 ? 2 : bn == 64 && h->per_sm == 1 ? 2 : 1;
    if (halo_fit(a, bn, h)) return true;
    if (bn == 128) break;
  }
  return false;
}

// The tile and ring of the halo form at h->mb and h->per_sm: false where two
// stages do not fit.
bool halo_fit(const Args& a, int bn, Halo* h) {
  const int cin = a.c0 + a.c1;
  const int mb = h->mb;
  const int tw = a.wo > 64 ? (mb * 64 < 128 ? mb * 64 : 128) : 64;
  const int tr = mb * 64 / tw;
  h->segs = (a.wo + tw - 1) / tw;
  h->groups = (a.ho + tr - 1) / tr;
  h->tw = tw;
  h->tr = tr;
  h->hr = tr + a.kh - 1;
  h->hw = tw + a.kw - 1;
  if (h->hw > 256) return false;                    // a TMA box's extent
  h->plane = (h->hw * 16 + 127) / 128 * 128;
  h->ch = cin / 16;
  h->ch0 = a.c0 / 16;
  h->kb = (a.kh * a.kw * cin + kBK - 1) / kBK;
  const int weights = h->kb * bn * kBK, stage = h->hr * h->ch * h->plane;
  const int out = 2 * 64 * bn;
  const int budget = h->per_sm == 2 ? (kSmemMax - 2048) / 2 : kSmemMax;
  const int free_bytes = budget - 1024 - weights - out - 8 * 17;
  h->stages = (free_bytes / stage < 8 ? free_bytes / stage : 8) & ~1;
  if (h->stages < 2) return false;
  h->off_halo = weights;
  h->off_out = h->off_halo + h->stages * stage;
  h->off_bars = h->off_out + out;
  h->bytes = h->off_bars + 8 * (2 * h->stages + 1) + 1024;
  h->m = static_cast<long long>(a.n) * a.ho * a.wo;
  h->tiles = static_cast<long long>(a.n) * h->groups * h->segs;
  return true;
}

// One source as a 4-D tensor {C, W, H, N} of bytes, boxes of 16 channels by
// hw pixels of one row.
bool encode_source(EncodeTiled encode, CUtensorMap* map, const int8_t* x,
                   int c, const Args& a, long long pix, long long row,
                   long long img, int hw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(a.w_in),
                              static_cast<cuuint64_t>(a.h),
                              static_cast<cuuint64_t>(a.n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(pix),
                                 static_cast<cuuint64_t>(row),
                                 static_cast<cuuint64_t>(img)};
  const cuuint32_t box[4] = {16, static_cast<cuuint32_t>(hw), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights as a [C_out][K] byte matrix, boxes of {128 bytes, BN rows}
// with the 128-byte swizzle.
bool encode_weights(EncodeTiled encode, CUtensorMap* map, const Args& a,
                    int k, int bn) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(a.cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(a.w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MB, int PER_SM>
int launch_halo(const Args& a, const Halo& h, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_halo_kernel<BN, MB, PER_SM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap wmap, xmap0, xmap1;
  if (!encode_weights(encode, &wmap, a, a.kh * a.kw * (a.c0 + a.c1), BN) ||
      !encode_source(encode, &xmap0, a.x0, a.c0, a, a.x0_pix, a.x0_row,
                     a.x0_img, h.hw) ||
      (a.c1 > 0 && !encode_source(encode, &xmap1, a.x1, a.c1, a, a.x1_pix,
                                  a.x1_row, a.x1_img, h.hw)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.c1 == 0) xmap1 = xmap0;
  const long long slots = static_cast<long long>(sm_count()) * h.per_sm;
  const unsigned grid = static_cast<unsigned>(h.tiles < slots ? h.tiles
                                                              : slots);
  qconv_halo_kernel<BN, MB, PER_SM><<<grid, kHaloThreads, h.bytes, stream>>>(
      wmap, xmap0, xmap1, a, h);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  using L = Smem<BN>;
  const cudaError_t configured = configure<BN>();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap wmap;
  if (!encode_weights(encode, &wmap, a, p.k, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sms = sm_count();
  const unsigned grid = static_cast<unsigned>(p.tiles < sms ? p.tiles : sms);
  qconv_kernel<BN><<<grid, kThreads, L::kAlloc, stream>>>(wmap, a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int og_qconv_args_bytes() { return static_cast<int>(sizeof(Args)); }

// The tile width this launch takes for C_out (16, 32, 64, 128 or 256).
int og_qconv_tile_n(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64
       : cout <= 128 ? 128 : 256;
}

static int gather_stages(int bn) {
  switch (bn) {
    case 16: return Ring<16>::kStages;
    case 32: return Ring<32>::kStages;
    case 64: return Ring<64>::kStages;
    case 128: return Ring<128>::kStages;
    default: return Ring<256>::kStages;
  }
}

static int gather_blocks_per_sm(int bn) {
  switch (bn) {
    case 16: return blocks_per_sm<16>();
    case 32: return blocks_per_sm<32>();
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    default: return blocks_per_sm<256>();
  }
}

static int gather_smem_bytes(int bn) {
  switch (bn) {
    case 16: return Smem<16>::kAlloc;
    case 32: return Smem<32>::kAlloc;
    case 64: return Smem<64>::kAlloc;
    case 128: return Smem<128>::kAlloc;
    default: return Smem<256>::kAlloc;
  }
}

// Which form a launch of these arguments takes: 1 the halo form, 0 the
// gathering form.  shape[0..3] receive its ring stages, its thread blocks
// an SM (-1 on an error), its dynamic shared memory bytes and the 64-pixel
// blocks of a consumer warpgroup's tile.
int og_qconv_form(const void* args, int* shape) {
  const Args a = *static_cast<const Args*>(args);
  const int bn = og_qconv_tile_n(a.cout);
  Halo h;
  if (halo_plan(a, bn, &h)) {
    shape[0] = h.stages;
    shape[1] = h.per_sm;
    shape[2] = h.bytes;
    shape[3] = h.mb;
    return 1;
  }
  shape[0] = gather_stages(bn);
  shape[1] = gather_blocks_per_sm(bn);
  shape[2] = gather_smem_bytes(bn);
  shape[3] = 1;
  return 0;
}

// args: one Args (ops/qconv_cuda.py's _Args), read by the host and passed by
// value into the launch's parameter space with the weights' tensor map.
int og_qconv(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  Plan p;
  p.m = static_cast<long long>(a.n) * a.ho * a.wo;
  if (p.m == 0 || a.cout == 0) return static_cast<int>(cudaGetLastError());
  const int bn = og_qconv_tile_n(a.cout);
  p.k = a.kh * a.kw * (a.c0 + a.c1);
  p.kt = (p.k + kBK - 1) / kBK;
  p.tiles_n = (a.cout + bn - 1) / bn;
  p.tiles = (p.m + kBM - 1) / kBM * p.tiles_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Halo h;
  if (halo_plan(a, bn, &h)) {
    switch (bn) {
      case 16: return launch_halo<16, 4, 2>(a, h, s);
      case 32: return launch_halo<32, 2, 2>(a, h, s);
      case 64: return h.per_sm == 2 ? launch_halo<64, 1, 2>(a, h, s)
                                    : launch_halo<64, 2, 1>(a, h, s);
      default: return launch_halo<128, 1, 1>(a, h, s);
    }
  }
  switch (bn) {
    case 16: return launch<16>(a, p, s);
    case 32: return launch<32>(a, p, s);
    case 64: return launch<64>(a, p, s);
    case 128: return launch<128>(a, p, s);
    default: return launch<256>(a, p, s);
  }
}

}  // extern "C"
