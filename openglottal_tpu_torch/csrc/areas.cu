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
// One launch counts a table of chunks (up to kMaxChunks; a cohort's chunk j
// of every video).  For chunk c with x (N, H, W) in row-major order, per-frame
// valid (N,) bytes and boxes (N, 4) int32 (x0, y0, x1, y1) in frame
// coordinates, and the window's frame-level origin (oy, ox):
//
//   out[n] = valid[n] ? #{(i, j) : x[n,i,j] > thr,
//                                  y0 <= oy + i < y1, x0 <= ox + j < x1} : 0
//
// Design.  What bounds the count is latency, not bytes: a served chunk is
// 128 frames whose boxes hold a few thousand elements each (~1 MB of
// bfloat16 in all, 0.3 us at the card's bytes rate), and an empty launch
// takes ~1.9 us where it is timed (back to back, CUDA events).  The first
// form (one 256-thread block per frame, 2-byte loads, one row's loads after
// another, and a load of `valid` before those of the box and the origin)
// took 8.6-9.0 us a chunk.  Here, for each frame:
//   * `valid`, the box and the origin are loaded together, and then the
//     box's elements: two dependent rounds of loads, no more;
//   * one block of 1024 threads (512 when the table holds more frames than
//     the card's SMs take at two such blocks each) takes the box's (row,
//     16-byte vector) items flat, so a thread issues one or two independent
//     16-B loads (8 bfloat16 or 4 float32 values) and no row waits for
//     another: the rows are spread over the block's 32 warps;
//   * rows are not 16-B aligned in general (the box's first column, an
//     unaligned buffer): each row is cut at its own 16-B boundaries into a
//     head and a tail of fewer than 8 elements, read one by one by two more
//     items of the row, and a body of aligned vectors; no byte outside the
//     box's columns is read;
//   * the count is summed by warp shuffles and once through shared memory;
//     warp 0 stores the frame's float (an integer, so exact).
// Splitting each frame's rows over several blocks (bands), so that a chunk
// spans more than one wave of SMs, was measured first (chip runs on an H100,
// standalone, the served shape): as clusters of 1-8 blocks joined through
// distributed shared memory 6.2-8.3 us, as blocks adding into a zeroed
// output 6.3-6.5 us with its memset; one block per frame 4.6-4.9 us.  The
// launch and the two rounds of loads are the time; more blocks only add
// scheduling and a cross-block sum.
//
// The origin is read from device memory when given as a pointer (an int64
// the decoder computed on the card; no host round-trip), else taken from the
// table.  The table is passed by value (the launch's parameter space, read
// in place as a __grid_constant__), so no host-to-device copy precedes the
// launch.
//
// Plain C interface; nothing allocates or synchronises; the function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxChunks = 48;    // table entries one launch takes (3 KB)

// One chunk of the table (the C layout of ops/areas_cuda.py's _Chunk).
struct Chunk {
  const void* x;          // (n, h, w) logits, float32 or bfloat16
  const uint8_t* valid;   // (n,)
  const int32_t* boxes;   // (n, 4)
  const int64_t* oy;      // the origin on the device, or null ...
  const int64_t* ox;
  float* out;             // (n,)
  int n;
  int first;              // the chunk's first frame in the launch's grid
  int oy_arg;             // ... and then these
  int ox_arg;
};

struct Table {
  Chunk c[kMaxChunks];
};

__device__ __forceinline__ int count_gt(float4 v, float thr) {
  return (v.x > thr) + (v.y > thr) + (v.z > thr) + (v.w > thr);
}

// Eight bfloat16 values: element 2k is the low half of word k.
__device__ __forceinline__ int count_gt(uint4 v, float thr) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  int c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c += (__uint_as_float(u[k] << 16) > thr) +
         (__uint_as_float(u[k] & 0xffff0000u) > thr);
  }
  return c;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// T: float or __nv_bfloat16; V: its 16-B vector.  kThreads: 1024 or 512.
template <typename T, typename V, int kThreads>
__global__ void __launch_bounds__(kThreads)
box_count_kernel(const __grid_constant__ Table table, int n_chunks, float thr,
                 int h, int w) {
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kWarps = kThreads / 32;
  const int frame = blockIdx.x;
  int c = 0;
  while (c + 1 < n_chunks && table.c[c + 1].first <= frame) ++c;
  const Chunk& ch = table.c[c];
  const int n = frame - ch.first;
  // one round of loads: the flag, the origin and the box
  const int valid = ch.valid[n];
  const long long oy = ch.oy ? ch.oy[0] : ch.oy_arg;
  const long long ox = ch.ox ? ch.ox[0] : ch.ox_arg;
  const int32_t* bp = ch.boxes + 4 * n;     // 4-B aligned: four loads
  const int4 b = make_int4(bp[0], bp[1], bp[2], bp[3]);
  if (!valid) {                    // uniform across the block
    if (threadIdx.x == 0) ch.out[n] = 0.0f;
    return;
  }
  // the box in window coordinates, clipped to the window
  const int i0 = (int)max(0LL, (long long)b.y - oy);
  const int i1 = (int)min((long long)h, (long long)b.w - oy);
  const int j0 = (int)max(0LL, (long long)b.x - ox);
  const int j1 = (int)min((long long)w, (long long)b.z - ox);
  int count = 0;
  if (i1 > i0 && j1 > j0) {
    // the (row, item) pairs of the box: item 0 the row's unaligned head,
    // 1 its tail, 2.. the aligned vectors between
    const int len = j1 - j0;
    const int items = len / kPerVec + 2;
    const T* xn = static_cast<const T*>(ch.x) + (size_t)n * h * w;
    for (int k = threadIdx.x; k < (i1 - i0) * items; k += kThreads) {
      const int r = i0 + k / items;
      const int item = k % items;
      const T* row = xn + (size_t)r * w + j0;
      const int off = (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
      const int head = min(len, (kPerVec - off) % kPerVec);
      const int body = (len - head) / kPerVec;
      if (item >= 2) {
        if (item - 2 < body) {
          const V v = __ldg(reinterpret_cast<const V*>(row + head) + item - 2);
          count += count_gt(v, thr);
        }
      } else {
        // the head (item 0) or the tail (item 1), under kPerVec elements
        const int e0 = item == 0 ? 0 : head + body * kPerVec;
        const int e1 = item == 0 ? head : len;
#pragma unroll
        for (int e = 0; e < kPerVec - 1; ++e) {
          if (e0 + e < e1) count += as_float(row[e0 + e]) > thr;
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kWarps ? part[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
    if (lane == 0) ch.out[n] = (float)count;
  }
}

template <typename T, typename V>
void launch(const Table& table, int n_chunks, int frames, int big_blocks,
            float thr, int h, int w, cudaStream_t stream) {
  if (frames <= big_blocks) {
    box_count_kernel<T, V, kMaxThreads><<<frames, kMaxThreads, 0, stream>>>(
        table, n_chunks, thr, h, w);
  } else {
    box_count_kernel<T, V, kMaxThreads / 2>
        <<<frames, kMaxThreads / 2, 0, stream>>>(table, n_chunks, thr, h, w);
  }
}

}  // namespace

extern "C" {

// The C layout of one table entry, for the binding's check.
int og_box_count_entry_bytes() { return (int)sizeof(Chunk); }

// dtype: 0 = float32, 1 = bfloat16.  chunks: a host array of n_chunks
// entries (any number; one launch per kMaxChunks), every x (n, h, w) of the
// same dtype, h and w; an entry's oy / ox are device pointers to one int64
// each, or null to use oy_arg / ox_arg; `first` is filled here.
int og_box_count(const void* chunks, int n_chunks, int dtype, float thr, int h,
                 int w, void* stream) {
  if (n_chunks < 0 || h <= 0 || w <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Chunk* in = static_cast<const Chunk*>(chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // as many 1024-thread blocks as the card runs at once (two per SM)
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  for (int c0 = 0; c0 < n_chunks;) {
    Table table;
    int k = 0, frames = 0;
    for (; c0 < n_chunks && k < kMaxChunks; ++c0) {
      if (in[c0].n < 0) return (int)cudaErrorInvalidValue;
      if (in[c0].n == 0) continue;
      table.c[k] = in[c0];
      table.c[k].first = frames;
      frames += in[c0].n;
      ++k;
    }
    if (k == 0) continue;
    if (dtype == 0) {
      launch<float, float4>(table, k, frames, 2 * sms, thr, h, w, s);
    } else {
      launch<__nv_bfloat16, uint4>(table, k, frames, 2 * sms, thr, h, w, s);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
