// The in-box mask area of pipeline 3 (YOLO + U-Net), counted from the U-Net's
// logits in one pass.
//
//   og_box_count  <- the count of openglottal_tpu/pipelines.py
//                    _unet_windowed_areas_chunk_fn (logits > 0 inside each
//                    frame's gate box, on the decoder's window) and
//                    _box_area_sums (the same on the whole frame)
//
// Replaces no Pallas kernel: the reference lets XLA fuse the compare, the two
// box masks and the sum.  Eager PyTorch would write the boolean mask, the
// masked mask and a reduction's partial sums to device memory; here the
// head's output is read once, as it is (bfloat16 or float32, no cast pass),
// and one float32 per frame is written.
//
// For x (N, H, W) in row-major order, a threshold, per-frame valid (N,) bytes
// and boxes (N, 4) int32 (x0, y0, x1, y1) in frame coordinates, and the
// window's frame-level origin (oy, ox):
//
//   area[n] = valid[n] ? #{(i, j) : x[n,i,j] > thr,
//                                   y0 <= oy + i < y1, x0 <= ox + j < x1} : 0
//
// Design (correct and simple first): one block per frame.  The block clips
// the box to the window and reads only the rows and columns inside it: warp
// w takes rows i0 + w, i0 + w + kWarps, ..., its lanes walk a row's columns
// 32 at a time (consecutive lanes, consecutive addresses).  Counts are
// integers, summed by warp shuffles and then across warps in shared memory;
// thread 0 stores the frame's count.  A frame that is not valid stores 0
// without reading x.  The origin is read from device memory when given as a
// pointer (an int64 the decoder computed on the card; no host round-trip),
// else taken from the launch arguments.
//
// Plain C interface; nothing allocates or synchronises; the function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
box_count_kernel(const T* __restrict__ x, float thr,
                 const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ boxes,
                 const int64_t* __restrict__ oy_dev,
                 const int64_t* __restrict__ ox_dev, int oy_arg, int ox_arg,
                 float* __restrict__ out, int h, int w) {
  const int n = blockIdx.x;
  if (!valid[n]) {                 // uniform across the block
    if (threadIdx.x == 0) out[n] = 0.0f;
    return;
  }
  const long long oy = oy_dev ? oy_dev[0] : oy_arg;
  const long long ox = ox_dev ? ox_dev[0] : ox_arg;
  const int32_t* b = boxes + 4 * n;
  // the box in window coordinates, clipped to the window
  const int i0 = (int)max(0LL, (long long)b[1] - oy);
  const int i1 = (int)min((long long)h, (long long)b[3] - oy);
  const int j0 = (int)max(0LL, (long long)b[0] - ox);
  const int j1 = (int)min((long long)w, (long long)b[2] - ox);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* xn = x + (size_t)n * h * w;
  int count = 0;
  for (int i = i0 + warp; i < i1; i += kWarps) {
    const T* row = xn + (size_t)i * w;
    for (int j = j0 + lane; j < j1; j += 32) {
      count += as_float(row[j]) > thr;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  __shared__ int part[kWarps];
  if (lane == 0) part[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kWarps ? part[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
    }
    if (lane == 0) out[n] = (float)count;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  oy / ox: device pointers to one int64
// each, or null to use oy_arg / ox_arg.
int og_box_count(const void* x, int dtype, float thr, const void* valid,
                 const void* boxes, const void* oy, const void* ox,
                 int oy_arg, int ox_arg, void* out, int n, int h, int w,
                 void* stream) {
  if (n <= 0) return cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* b = static_cast<const int32_t*>(boxes);
  const auto* py = static_cast<const int64_t*>(oy);
  const auto* px = static_cast<const int64_t*>(ox);
  auto* o = static_cast<float*>(out);
  if (dtype == 0) {
    box_count_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(x), thr, v, b, py, px, oy_arg, ox_arg, o, h,
        w);
  } else if (dtype == 1) {
    box_count_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), thr, v, b, py, px, oy_arg,
        ox_arg, o, h, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
