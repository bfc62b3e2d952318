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
// its minimum flat index).  Inactive pixels read H*W.
//
// Design for this card.  The TPU kernel stacks frames into one VMEM grid and
// sweeps whole arrays (segmented row/column min-scans plus a 3x3 min) until
// nothing changes, because wide vector rolls are what that machine is good
// at.  On Hopper that would cost sweeps x H*W x log(W) shared-memory traffic
// per frame with a block-wide barrier in every sweep.  The fixpoint is unique
// (min over the component), so this kernel reaches it directly with a
// min-root union-find instead:
//
//   1. one thread block per frame (grid = T, frames run in parallel on the
//      132 SMs, nothing carries over between blocks);
//   2. parent[p] = first pixel of p's horizontal run of equal code (a warp
//      ballot per 32 pixels, no atomics); then runs of neighbouring rows are
//      united where they overlap (and across diagonals when the code is 1).
//      A union hangs the larger root under the smaller with atomicMin, so a
//      root is always the minimum flat index of its tree;
//   3. after a block barrier the run starts chase their parent chains to the
//      root (= the component id) and the other pixels take it from them;
//   4. with `init`: val[root] = atomicMin over the component's init values
//      (a racy read skips the atomic when the slot is already as small), and
//      after a barrier each pixel reads val[root].
//
// Bound: bytes.  Each launch must read 1 B/pixel of code (+ 4 B of init) and
// write 4 B of output; the union-find itself does O(H*W) near-constant work.
// What the design does about it: the parent grid (and the value grid) live in
// dynamic shared memory whenever they fit the 227 KB a block may use (a 128x128
// window: 64 KB parents + 64 KB values + 16 KB code), so device memory sees
// exactly one read of each input and one write of the output.  A 256x256
// frame (256 KB of parents) does not fit; there the same block-per-frame
// code runs with the parent grid in the output buffer / a scratch buffer in
// device memory (L2-resident), chosen by the host function below.  Measured on
// an H100 the kernel is still far from the bytes bound (PERF.md has the
// numbers): what limits it is integer instruction issue and shared-memory
// latency in the passes over the frame (five of them, ~100 instructions per
// pixel in all), not device memory.
//
// og_cc_batch and og_cc are the same kernel without `init`: the labels are
// the roots themselves, so there is no value grid and no fourth pass.  A frame
// up to 46,489 pixels (215x215) keeps parents and codes in shared memory; a
// larger one (256x256) builds its forest directly in the output buffer (no
// scratch).  og_cc is one frame, hence ONE block on one of the card's 132 SMs:
// its time is a block's latency, not bytes over bandwidth.
//
// Plain C interface: raw pointers, sizes, stream.  Nothing is allocated
// here and nothing synchronises.  Each function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB usable per block on sm_90

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

// smem_mode: 0 = parents/values/code all in device memory,
//            1 = parents + code in shared memory, values in `out`,
//            2 = parents + values + code in shared memory.
__global__ void __launch_bounds__(kThreads)
min_root_fixpoint_kernel(const uint8_t* __restrict__ code_g,
                         const int* __restrict__ init_g,
                         int* __restrict__ out_g,
                         int* __restrict__ scratch_g,
                         int h, int w, int conn_code, int smem_mode) {
  extern __shared__ int smem[];
  const int hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const uint8_t* code_in = code_g + base;
  const int* init = init_g ? init_g + base : nullptr;
  int* out = out_g + base;

  int* parent;
  int* val = nullptr;
  uint8_t* code_s = nullptr;
  if (smem_mode == 0) {
    // plain CC can build the forest directly in the output buffer
    parent = init ? scratch_g + base : out;
    if (init) val = out;
  } else {
    parent = smem;
    if (smem_mode == 2) {
      val = smem + hw;
      code_s = reinterpret_cast<uint8_t*>(smem + 2 * hw);
    } else {
      val = out;
      code_s = reinterpret_cast<uint8_t*>(smem + hw);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kEdge = -1;      // "code" beyond the frame: equals no code
  constexpr int kNoPixel = -2;   // lanes past the end of a row

  // Every pass walks the frame the same way: a warp takes a row, 32 pixels
  // at a time (coalesced, conflict-free, no division to find row and column).

  // 1. region codes into shared memory, value slots to "none", and the
  // horizontal runs: parent[p] = first pixel of p's run of equal code.  A
  // ballot marks where the code changes; the highest mark at or below a lane
  // is its run start (or the start carried over from the previous chunk).
  // This joins every horizontal link without a single atomic.
  for (int r = warp; r < h; r += nwarps) {
    int carry = 0;            // run start (column) reaching into this chunk
    int prev_code = kEdge;    // code left of the chunk
    for (int x0 = 0; x0 < w; x0 += 32) {
      const int x = x0 + lane;
      const int p = r * w + x;
      const int c = x < w ? region_code(code_in[p], conn_code) : kNoPixel;
      int left = __shfl_up_sync(kAll, c, 1);
      if (lane == 0) left = prev_code;
      const unsigned bits = __ballot_sync(kAll, x < w && c != left);
      const unsigned mine = bits & (kAll >> (31 - lane));
      if (x < w) {
        parent[p] = r * w + (mine ? x0 + 31 - __clz(mine) : carry);
        if (code_s) code_s[p] = static_cast<uint8_t>(c);
        if (init) val[p] = hw;
      }
      if (bits) carry = x0 + 31 - __clz(bits);
      prev_code = __shfl_sync(kAll, c, 31);
    }
  }
  __syncthreads();

  auto code_at = [&](int p) -> int {
    return code_s ? static_cast<int>(code_s[p]) : region_code(code_in[p], conn_code);
  };
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
  // was ever hung under it) — and one more hop ends at the root.
  auto root_of = [&](int p) -> int { return ld(parent + ld(parent + p)); };

  if (!init) {
    // With the forest in the output buffer (parent == out) a slot is read by
    // other pixels only if it is a run start's, and that one is rewritten
    // with the value it already holds.
    for (int r = warp; r < h; r += nwarps)
      for (int x = lane; x < w; x += 32) {
        const int p = r * w + x;
        out[p] = code_at(p) == 0 ? hw : root_of(p);
      }
    return;
  }

  // 4. min of init over each component, gathered at its root
  for (int r = warp; r < h; r += nwarps)
    for (int x = lane; x < w; x += 32) {
      const int p = r * w + x;
      if (code_at(p) == 0) continue;
      const int v = init[p];
      int* slot = val + root_of(p);
      if (v < ld(slot)) atomicMin(slot, v);
    }
  __syncthreads();
  // val may alias out (values kept in the output buffer): a root rewrites its
  // own slot with the value it already holds, and a non-root's slot is read by
  // nobody (values are only ever read at roots), so the gather is hazard-free.
  for (int r = warp; r < h; r += nwarps)
    for (int x = lane; x < w; x += 32) {
      const int p = r * w + x;
      out[p] = code_at(p) == 0 ? hw : ld(val + root_of(p));
    }
}

int launch(const void* code, const void* init, void* out, void* scratch,
           int t, int h, int w, int conn_code, cudaStream_t stream) {
  if (t <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t need2 = hw * 9;   // parents + values + code bytes
  const size_t need1 = hw * 5;   // parents + code bytes
  int mode = 0;
  size_t smem = 0;
  if (init != nullptr && need2 <= kMaxDynamicSmem) {
    mode = 2;
    smem = need2;
  } else if (need1 <= kMaxDynamicSmem) {
    mode = 1;
    smem = need1;
  }
  if (mode == 0 && init != nullptr && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  smem = (smem + 15) & ~static_cast<size_t>(15);
  cudaError_t err = cudaFuncSetAttribute(
      min_root_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxDynamicSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  min_root_fixpoint_kernel<<<t, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(code), static_cast<const int*>(init),
      static_cast<int*>(out), static_cast<int*>(scratch), h, w, conn_code, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device scratch (int32 parents) the launch needs for this shape;
// 0 when the grids fit shared memory.  with_init: 1 for the min_prop forms.
long long og_scratch_bytes(int t, int h, int w, int with_init) {
  const size_t hw = static_cast<size_t>(h) * w;
  if (!with_init) return 0;
  if (hw * 5 <= kMaxDynamicSmem) return 0;
  return static_cast<long long>(hw) * 4 * t;
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
