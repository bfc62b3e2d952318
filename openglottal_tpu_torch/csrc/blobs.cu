// Connected-component min-propagation kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) fixpoint kernels of
// openglottal_tpu/ops/blobs_pallas.py:
//
//   og_dual_cc        <- dual_cc_pallas_batch        (_make_dual_batch_kernel)
//   og_dual_min_prop  <- dual_min_prop_pallas_batch  (_make_dual_batch_kernel,
//                                                     with_init=True)
//   og_min_prop       <- min_prop_pallas_batch       (_make_batch_kernel,
//                                                     with_init=True)
//   og_cc_batch       <- connected_components_pallas_batch
//                                                    (_make_batch_kernel,
//                                                     with_init=False)
//   og_cc             <- connected_components_pallas (_make_kernel)
//
// Shared semantics.  Every frame of a (T, H, W) stack is independent.  A
// pixel's region code is 0 (inactive), 1 (propagates 8-connected) or 2
// (propagates 4-connected); two pixels are linked only when they are
// neighbours under the rule of their code AND carry the same code, so values
// never cross regions.  The output of an active pixel is the minimum of
// `init` over its component, where `init` defaults to the frame-local flat
// index r*W + c (plain connected-component labelling: a component's id is
// its minimum flat index).  Inactive pixels read H*W.  `init` values above
// H*W read as H*W.
//
// Design for this card.  The TPU kernel stacks frames into one VMEM grid and
// sweeps whole arrays (segmented row/column min-scans plus a 3x3 min) until
// nothing changes, because wide vector rolls are what that machine is good
// at.  On Hopper that would cost sweeps x H*W x log(W) shared-memory traffic
// per frame with a block-wide barrier in every sweep.  The fixpoint is unique
// (min over the component), so this kernel reaches it directly with a
// min-root union-find instead:
//
//   0. one thread block per frame (grid = T, frames run in parallel on the
//      132 SMs, nothing carries over between blocks); the frame's codes are
//      staged into shared memory with 16-byte loads, all in flight at once;
//   1. parent[p] = first pixel of p's horizontal run of equal code (a warp
//      ballot per 32 pixels, no atomics);
//   2. runs of neighbouring rows are united where they overlap (and across
//      diagonals when the code is 1).  A union hangs the larger root under
//      the smaller with atomicMin, so a root is always the minimum flat index
//      of its tree;
//   3. after a block barrier the run starts chase their parent chains to the
//      root (= the component id); any other pixel is two hops from it;
//   4. with `init`: the root's OWN parent slot becomes the component's value
//      slot.  Values are stored as v - (H*W + 1), which is negative, so a
//      slot tells by its sign whether it still holds a pixel index or already
//      a value, and the roots need no separate "none" initialisation: each
//      active pixel atomicMin's its value into its root's slot while others
//      are still finding their roots (a negative slot is a root); after a
//      barrier each pixel follows at most three slots to its value.
//
// Bound: bytes.  Each launch must read 1 B/pixel of code (+ 4 B of init) and
// write 4 B of output; the union-find itself does O(H*W) near-constant work.
// What the design does about it: the parent grid and the codes live in
// dynamic shared memory whenever they fit the 227 KB a block may use, so
// device memory sees exactly one read of each input and one write of the
// output.  Between those the work is latency-bound: dependent shared-memory
// loads along parent chains, atomics, barriers, each thread walking its share
// of the frame in order.  So the design spends its resources on threads in
// flight: 1024 threads a block (a pixel's chain is walked by the thread that
// owns it, so twice the threads halve each thread's walk), and a layout small
// enough that two blocks share an SM, 64 warps, the most an SM holds.  With
// or without `init` a frame takes 5 B/pixel (a 128x128 window: 64 KB parents
// + 16 KB codes): the value slot in the root's parent slot is what lets the
// `init` forms fit it, where a per-pixel value grid would take 9 B/pixel
// (144 KB at 128x128, one block per SM).
// A frame of up to 46,484 pixels fits (216x215 does, 217x215 does not); a
// larger one (256x256) runs the same code with the forest in device memory
// (L2-resident): in the output buffer without `init`, in a scratch buffer the
// wrapper allocates with it.  `layout` below is the one place that decides
// this, for the launch and for the wrapper's scratch.  og_cc is one frame,
// hence ONE block on one of the card's 132 SMs: its time is a block's
// latency, not bytes over bandwidth.
//
// Plain C interface: raw pointers, sizes, stream.  Nothing is allocated
// here and nothing synchronises.  Each launch function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Two blocks of 1024 threads fill an SM's 2048 thread slots; ptxas then has
// 32 registers a thread, which the kernel fits without spilling.
constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 2;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB usable per block on sm_90

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Where a launch keeps its grids: `smem` bytes of dynamic shared memory for
// parents and codes (0: the frame does not fit, parents in device memory),
// and `scratch` bytes of device memory the wrapper must provide.
struct Layout {
  size_t smem;
  size_t scratch;
};

Layout layout(int t, int h, int w, bool with_init) {
  const size_t hw = static_cast<size_t>(h) * w;
  // parents, then the codes at the alignment of the frame's own bytes
  const size_t smem = align16(align16(hw * 4) + 16 + hw);
  if (smem <= kMaxDynamicSmem) return {smem, 0};
  return {0, with_init ? hw * 4 * t : 0};
}

__device__ __forceinline__ int ld(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void st(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// Root of x, halving the path on the way: every visited pixel is re-pointed
// at its grandparent.  A parent always is an ancestor with a smaller index
// and parent[r] == r marks a root, so a racing plain store can only swap one
// ancestor for another (a root is never written here: its grandparent is
// itself); chains stay short however the unions interleave.
__device__ __forceinline__ int find_root_halving(int* parent, int x) {
  int p = ld(parent + x);
  while (p != x) {
    const int gp = ld(parent + p);
    if (gp == p) return p;
    st(parent + x, gp);
    x = gp;
    p = ld(parent + x);
  }
  return x;
}

// Root of x, reading only.  The final flattening must use this one: a late
// halving store could put an ancestor back where a root was just written.
__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = ld(parent + x);
  while (p != x) {
    x = p;
    p = ld(parent + x);
  }
  return x;
}

// Unite the trees of a and b, keeping the smaller root (Komura / Playne-Hawick
// label equivalence with atomicMin).  atomicMin returns the slot's true old
// value, so a concurrent re-parenting is noticed and retried.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  bool done = false;
  while (!done) {
    a = find_root_halving(parent, a);
    b = find_root_halving(parent, b);
    if (a < b) {
      int old = atomicMin(parent + b, a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      int old = atomicMin(parent + a, b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  }
}

// code byte -> region code.  conn_code == 0: the byte IS the code (dual
// kernels).  Otherwise the byte is a bool region mask and active pixels get
// conn_code (1 = 8-connected, 2 = 4-connected).
__device__ __forceinline__ int region_code(uint8_t byte, int conn_code) {
  return conn_code == 0 ? static_cast<int>(byte) : (byte ? conn_code : 0);
}

// in_smem: parents and codes in dynamic shared memory (see `layout`);
// otherwise parents in `scratch` (with init) or `out` and codes read from
// device memory where they are needed.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
min_root_fixpoint_kernel(const uint8_t* __restrict__ code_g,
                         const int* __restrict__ init_g,
                         int* __restrict__ out_g,
                         int* __restrict__ scratch_g,
                         int h, int w, int conn_code, int in_smem) {
  extern __shared__ __align__(16) int smem[];
  const int hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const uint8_t* code_in = code_g + base;
  const int* init = init_g ? init_g + base : nullptr;
  int* out = out_g + base;

  int* parent = out;             // plain CC builds its forest in the output
  uint8_t* code_s = nullptr;
  if (in_smem) {
    parent = smem;
    // the staged codes sit at the same offset from a 16-byte boundary as
    // the frame's own bytes, so the copy is 16-byte loads and stores
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(code_in) & 15);
    code_s = reinterpret_cast<uint8_t*>(smem) +
             align16(static_cast<size_t>(hw) * 4) + mis;
    const int head = min(hw, (16 - mis) & 15);
    const int n16 = (hw - head) >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(code_in + head);
    uint4* dst = reinterpret_cast<uint4*>(code_s + head);
#pragma unroll 4
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = __ldg(src + i);
    for (int i = threadIdx.x; i < head; i += blockDim.x) code_s[i] = code_in[i];
    for (int i = head + (n16 << 4) + threadIdx.x; i < hw; i += blockDim.x)
      code_s[i] = code_in[i];
    __syncthreads();
  } else if (init) {
    parent = scratch_g + base;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kEdge = -1;      // "code" beyond the frame: equals no code
  constexpr int kNoPixel = -2;   // lanes past the end of a row

  auto code_at = [&](int p) -> int {
    return region_code(code_s ? code_s[p] : code_in[p], conn_code);
  };

  // Every pass walks the frame the same way: a warp takes a row, 32 pixels
  // at a time (coalesced, conflict-free, no division to find row and column).

  // 1. the horizontal runs: parent[p] = first pixel of p's run of equal code.
  // A ballot marks where the code changes; the highest mark at or below a
  // lane is its run start (or the start carried over from the previous
  // chunk).  This joins every horizontal link without a single atomic.
  for (int r = warp; r < h; r += nwarps) {
    int carry = 0;            // run start (column) reaching into this chunk
    int prev_code = kEdge;    // code left of the chunk
    for (int x0 = 0; x0 < w; x0 += 32) {
      const int x = x0 + lane;
      const int p = r * w + x;
      const int c = x < w ? code_at(p) : kNoPixel;
      int left = __shfl_up_sync(kAll, c, 1);
      if (lane == 0) left = prev_code;
      const unsigned bits = __ballot_sync(kAll, x < w && c != left);
      const unsigned mine = bits & (kAll >> (31 - lane));
      if (x < w) parent[p] = r * w + (mine ? x0 + 31 - __clz(mine) : carry);
      if (bits) carry = x0 + 31 - __clz(bits);
      prev_code = __shfl_sync(kAll, c, 31);
    }
  }
  __syncthreads();

  // Codes of a row chunk: own, left neighbour, and whether the lane's pixel
  // starts a run.  Lanes past the row end get kNoPixel.
  auto row_codes = [&](int r, int x0, int& c, int& left) {
    const int x = x0 + lane;
    c = x < w ? code_at(r * w + x) : kNoPixel;
    left = __shfl_up_sync(kAll, c, 1);
    if (lane == 0) left = x0 > 0 ? code_at(r * w + x0 - 1) : kEdge;
  };

  // 2. vertical links.  Two runs in neighbouring rows that overlap are joined
  // once, at the leftmost column of the overlap: there either the lower run
  // or the upper run starts.  Diagonal links (code 1 only) matter only where
  // the pixel straight above has another code; otherwise the diagonal
  // neighbour lies in the same run as the pixel above.
  for (int r = warp + 1; r < h; r += nwarps) {
    for (int x0 = 0; x0 < w; x0 += 32) {
      int c, left, up, up_left;
      row_codes(r, x0, c, left);
      row_codes(r - 1, x0, up, up_left);
      int up_right = __shfl_down_sync(kAll, up, 1);
      const int x = x0 + lane;
      if (lane == 31) up_right = x + 1 < w ? code_at((r - 1) * w + x + 1) : kEdge;
      const int p = r * w + x;
      if (c <= 0) {
        // inactive, or past the end of the row
      } else if (up == c) {
        if (left != c || up_left != c) unite(parent, p, p - w);
      } else if (c == 1) {
        if (up_left == c) unite(parent, p, p - w - 1);
        if (up_right == c) unite(parent, p, p - w + 1);
      }
    }
  }
  __syncthreads();

  // 3. the run starts chase their chains to the root.  (Read-only find: see
  // find_root.)  Concurrent flattening only replaces a parent by its root, so
  // every chain still ends there.
  for (int r = warp; r < h; r += nwarps) {
    for (int x0 = 0; x0 < w; x0 += 32) {
      int c, left;
      row_codes(r, x0, c, left);
      if (c > 0 && left != c) {
        const int p = r * w + x0 + lane;
        parent[p] = find_root(parent, p);
      }
    }
  }
  __syncthreads();

  // Root of an active pixel now: a run start holds it; any other pixel's
  // parent is its run start or, after path halving, an ancestor of that — a
  // run start either way (a pixel inside a run never was a root, so nothing
  // was ever hung under it) — and one more hop ends at the root.  So the
  // slots other pixels read are those of run starts; a slot that is not a
  // run start's is read only by its own pixel.
  if (!init) {
    // With the forest in the output buffer (parent == out) a slot is read by
    // other pixels only if it is a run start's, and that one is rewritten
    // with the value it already holds.
    for (int r = warp; r < h; r += nwarps)
#pragma unroll 4
      for (int x = lane; x < w; x += 32) {
        const int p = r * w + x;
        out[p] = code_at(p) == 0 ? hw : ld(parent + ld(parent + p));
      }
    return;
  }

  // 4. min of init over each component, gathered in the root's own slot as
  // v - (H*W + 1) < 0.  While this runs a root's slot holds either its own
  // index or a value, and no other slot changes.  The init loads of four
  // chunks of a row are issued before any of their atomics.
  const int bias = hw + 1;
  for (int r = warp; r < h; r += nwarps)
    for (int x0 = 0; x0 < w; x0 += 4 * 32) {
      int v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = x0 + 32 * k + lane;
        v[k] = x < w ? init[r * w + x] : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = x0 + 32 * k + lane;
        const int p = r * w + x;
        if (x >= w || code_at(p) == 0) continue;
        const int e = min(v[k], hw) - bias;
        const int a = ld(parent + p);
        int root = p;
        if (a >= 0 && a != p) {          // p is no root
          if (e == -1) continue;         // H*W: the root's own value is <= it
          const int b = ld(parent + a);  // a's root, or a value if a is one
          root = (b < 0 || b == a) ? a : b;
        }
        if (e < ld(parent + root)) atomicMin(parent + root, e);
      }
    }
  __syncthreads();

  // 5. every root's slot holds its component's value now (a root gathers its
  // own): follow the slots to the first negative one.
  for (int r = warp; r < h; r += nwarps)
#pragma unroll 4
    for (int x = lane; x < w; x += 32) {
      const int p = r * w + x;
      int v = hw;
      if (code_at(p) != 0) {
        v = ld(parent + p);
        if (v >= 0) v = ld(parent + v);
        if (v >= 0) v = ld(parent + v);
        v += bias;
      }
      out[p] = v;
    }
}

cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(min_root_fixpoint_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxDynamicSmem));
}

int launch(const void* code, const void* init, void* out, void* scratch,
           int t, int h, int w, int conn_code, cudaStream_t stream) {
  if (t <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(t, h, w, init != nullptr);
  if (lay.scratch != 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  min_root_fixpoint_kernel<<<t, kThreads, lay.smem, stream>>>(
      static_cast<const uint8_t*>(code), static_cast<const int*>(init),
      static_cast<int*>(out), static_cast<int*>(scratch), h, w, conn_code,
      lay.smem != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device scratch (int32 parents) the launch needs for this shape;
// 0 when the grids fit shared memory.  with_init: 1 for the min_prop forms.
long long og_scratch_bytes(int t, int h, int w, int with_init) {
  return static_cast<long long>(layout(t, h, w, with_init != 0).scratch);
}

// Bytes of dynamic shared memory a launch at this frame size takes (0: the
// grids are in device memory).
long long og_smem_bytes(int h, int w) {
  return static_cast<long long>(layout(1, h, w, false).smem);
}

// Thread blocks of a launch at this frame size that fit one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error.
int og_blocks_per_sm(int h, int w) {
  cudaError_t err = allow_max_smem();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, min_root_fixpoint_kernel, kThreads, layout(1, h, w, false).smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// code: (T,H,W) uint8 in {0,1,2}; out: (T,H,W) int32.
int og_dual_cc(const void* code, void* out, int t, int h, int w, void* stream) {
  return launch(code, nullptr, out, nullptr, t, h, w, 0,
                static_cast<cudaStream_t>(stream));
}

// code: (T,H,W) uint8 in {0,1,2}; init, out: (T,H,W) int32.
int og_dual_min_prop(const void* code, const void* init, void* out,
                     void* scratch, int t, int h, int w, void* stream) {
  return launch(code, init, out, scratch, t, h, w, 0,
                static_cast<cudaStream_t>(stream));
}

// region: (T,H,W) bool bytes; init (T,H,W) int32 or null (= flat index, i.e.
// connected components); connectivity 4 or 8.
int og_min_prop(const void* region, const void* init, void* out, void* scratch,
                int t, int h, int w, int connectivity, void* stream) {
  if (connectivity != 4 && connectivity != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(region, init, out, scratch, t, h, w,
                connectivity == 8 ? 1 : 2, static_cast<cudaStream_t>(stream));
}

// region: (T,H,W) bool bytes; out: (T,H,W) int32 labels (component id = min
// frame-local flat index, outside = H*W); connectivity 4 or 8.
int og_cc_batch(const void* region, void* out, int t, int h, int w,
                int connectivity, void* stream) {
  if (connectivity != 4 && connectivity != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(region, nullptr, out, nullptr, t, h, w,
                connectivity == 8 ? 1 : 2, static_cast<cudaStream_t>(stream));
}

// One frame: region (H,W) bool bytes; out (H,W) int32 labels.
int og_cc(const void* region, void* out, int h, int w, int connectivity,
          void* stream) {
  return og_cc_batch(region, out, 1, h, w, connectivity, stream);
}

}  // extern "C"
