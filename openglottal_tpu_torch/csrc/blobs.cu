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
// (min over the component), so both kernels below reach it directly with a
// min-root union-find instead.
//
// THE LABELLING FORM (label_kernel: og_dual_cc, og_cc_batch, og_cc, and
// og_min_prop without init) -- frames of up to 46,484 pixels, as before.
// What it is built against: the per-pass clock64() cycles of the fixpoint
// body below on the served inputs (tools/blob_cycles.py, NVIDIA H100 80GB
// HBM3, 700 W, 1980 MHz, medians a block): guided-vft's 128x128 windows
// 4,444 staging, 16,680 runs, 70,395 unions, 40,930 finds, 15,117 output
// (146,718 in all, two blocks an SM, 500 windows in two waves); vft's 48x40
// crops 2,176 / 3,663 / 11,951 / 5,018 / 3,611.  Unions and finds are three
// quarters: 32 warps unite rows all over the frame at once, so the runs of a
// frame-spanning component chain row under row and every find walks that
// chain (a frame that is one component costs 89,000 cycles).  Measured beside
// it: routing its loads and atomics through shared-window instructions
// changes nothing, and joining its rows in rounds alone makes it slower.  The
// passes are bound by instruction throughput, and lanes of a warp that
// take different paths through a join run one after another.  So this form
// spends few instructions a pixel and keeps the lanes of a warp on one path:
//
//   a. a group of 1-8 warps a frame (a warp for each >= 4 rows) and as many
//      frames in a block of <= 256 threads as keep every SM busy, each group
//      with its own named barrier (bar.sync id, n; one warp: __syncwarp);
//   b. the codes staged with 16-byte loads, then two bit planes (code 1:
//      8-connected, code 2: 4-connected; a bit a pixel) by two ballots per
//      32 pixels, and 16-bit parents (a frame of the form has at most 46,484
//      pixels), kept only at run starts and set to themselves;
//   c. a thread a 32-pixel word finds, by shifts and masks of the planes,
//      the word's run starts, its active pixels and the joins of its row to
//      the row above: once per overlap of equal code, at the overlap's
//      leftmost column, and, for code 1, across a diagonal where the pixel
//      above has another code;
//   d. the rows joined in log2(H) rounds, a thread a row: in round j the
//      rows 2^j (2i + 1) join the block of 2^j rows above them to the block
//      from them on, blocks that no other thread of the round touches, so
//      joins are plain loads and stores without atomics (finds halve their
//      paths), and a tree spans one block of 2^(j+1) rows after round j;
//      the lanes of a warp join in lock-step (one join, one chain step a
//      lane), so a warp pays for its longest chain, not for every lane's;
//   e. every run start's slot set to its root (read-only finds, lock-step);
//   f. each active pixel reads its run start's slot: one shared load a
//      pixel, int32 labels written a row at a time, coalesced.
//
// A root is always the minimum flat index of its tree (a join hangs the
// larger root under the smaller), so the labels are the fixpoint's.  Not
// taken: the init forms, which keep the fixpoint body (its init gather had
// been redesigned before), and frames whose planes, parents and work space
// do not fit shared memory, which keep the fixpoint body in its shared or
// device memory layout.
//
// THE FIXPOINT FORM (min_root_fixpoint_kernel: og_dual_min_prop, og_min_prop
// with init, and frames too large for the labelling form):
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
// the form (labelling or fixpoint, frames a block, warps a frame, shared or
// device memory), for the launch, for the wrapper's scratch and for the
// queries (og_layout).  og_cc is one frame, hence one group of warps on one
// of the card's 132 SMs: its time is a group's latency, not bytes over
// bandwidth.
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

// The labelling form: blocks of at most 256 threads, a group of 1-8 warps a
// frame (a warp for each >= 8 rows), as many frames a block as keep every
// SM busy.
constexpr int kLabelThreads = 256;
constexpr int kLabelWarps = kLabelThreads / 32;
constexpr int kLabelBlocksPerSm = 4;
constexpr int kRowsPerWarp = 4;
constexpr unsigned kAll = 0xffffffffu;

// Streaming multiprocessors of the current device (132 on an H100 SXM).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

__host__ __device__ inline int plane_words(int w) { return (w + 31) >> 5; }

// Shared memory of one frame in the labelling form: the two bit planes, the
// 16-bit parents, and a work space that first holds the frame's codes as
// staged (at the alignment of its own bytes), then five words for each word
// of the planes (struct Words).
__host__ __device__ inline size_t label_frame_bytes(int h, int w) {
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t n_words = static_cast<size_t>(h) * plane_words(w);
  const size_t work = hw + 15 > 20 * n_words ? hw + 15 : 20 * n_words;
  return align16(8 * n_words) + align16(2 * hw) + align16(work);
}

// Where a launch keeps its grids: `smem` bytes of dynamic shared memory a
// block (0: the frame does not fit, parents in device memory), `scratch`
// bytes of device memory the wrapper must provide, and the labelling form's
// `frames` a block and `warps` a frame (frames == 0: the fixpoint form).
struct Layout {
  size_t smem;
  size_t scratch;
  int frames;
  int warps;
};

Layout layout(int t, int h, int w, bool with_init) {
  const size_t hw = static_cast<size_t>(h) * w;
  // parents, then the codes at the alignment of the frame's own bytes
  const size_t smem = align16(align16(hw * 4) + 16 + hw);
  if (smem > kMaxDynamicSmem) return {0, with_init ? hw * 4 * t : 0, 0, 0};
  const size_t frame = label_frame_bytes(h, w);
  if (with_init || frame > kMaxDynamicSmem) return {smem, 0, 0, 0};
  int warps = 1;
  while (warps < kLabelWarps && 2 * warps * kRowsPerWarp <= h) warps *= 2;
  int frames = kLabelWarps / warps;
  if (frames > t / sm_count()) frames = t / sm_count() > 0 ? t / sm_count() : 1;
  while (frames > 1 && frames * frame > kMaxDynamicSmem) --frames;
  return {frames * frame, 0, frames, warps};
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

// ── the labelling form ──────────────────────────────────────────────────

// The forest's loads and stores, by shared-window address (LDS / STS), kept
// in program order (volatile) where threads of a frame read slots that
// another thread may be writing.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int lds16(unsigned a) {
  unsigned v;
  asm volatile("ld.volatile.shared.u16 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return static_cast<int>(v);
}
__device__ __forceinline__ void sts16(unsigned a, int v) {
  asm volatile("st.volatile.shared.u16 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
// A frame's forest: 16-bit parents, two to a 32-bit word of shared memory,
// slot i at shared address base + 2i.
struct Forest16 {
  unsigned base;

  __device__ __forceinline__ int get(int i) const { return lds16(base + 2 * i); }
  __device__ __forceinline__ void set(int i, int v) const {
    sts16(base + 2 * i, v);
  }
};

// Roots of a and b (-1: none) for every lane of a warp, the lanes stepping
// up their chains in lock-step: the loop runs as often as the longest chain
// of the warp needs, with no divergence of code.  kHalve: each step also
// re-points the slot it leaves at its grandparent (path halving; only for a
// thread that alone changes these trees), else the walk only reads.
template <bool kHalve>
__device__ __forceinline__ void roots2(const Forest16& f, int& a, int& b) {
  bool more = a >= 0;
  while (__any_sync(kAll, more)) {
    if (more) {
      const int pa = f.get(a), pb = f.get(b);
      more = pa != a || pb != b;
      if (kHalve) {
        const int ga = f.get(pa), gb = f.get(pb);
        f.set(a, ga);
        f.set(b, gb);
        a = ga;
        b = gb;
      } else {
        a = pa;
        b = pb;
      }
    }
  }
}

// Barrier of one frame's group: named barrier `id` for `threads` threads,
// or the warp's own when the group is one warp.
__device__ __forceinline__ void pass_barrier(int id, int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
}

// Run starts of a 32-pixel word: where a pixel of code 1 (plane a) or code 2
// (plane b) follows another code; ca / cb: bit 31 of the word to the left.
__device__ __forceinline__ unsigned run_starts(unsigned a, unsigned b,
                                               unsigned ca, unsigned cb) {
  return (a & ~((a << 1) | ca)) | (b & ~((b << 1) | cb));
}

// Column of the highest set bit of m (a mask of word k), or `carry` (the
// last run start to the left) when m is empty.
__device__ __forceinline__ int last_start(unsigned m, int k, int carry) {
  return m ? (k << 5) + 31 - __clz(m) : carry;
}

// The words a frame keeps for each 32-pixel word (r, k) of the labelling
// form, after its bit planes: run starts, active pixels, and the joins of
// row r to row r - 1 there (vertical, left and right diagonal).
struct Words {
  unsigned* s;
  unsigned* act;
  unsigned* vert;
  unsigned* dl;
  unsigned* dr;
};

// Join row r to row r - 1 (valid: r names a row), by ONE thread of a warp
// whose lanes all call this at once, each for its own row: every run of row r
// to the runs of row r - 1 it touches, once per overlap of equal code at the
// overlap's leftmost column (a run start of one of the two rows), and, for
// code 1, across a diagonal where the pixel above has another code (the
// diagonal neighbour then starts or ends a run above).  No other thread
// changes the trees of the two blocks of rows meanwhile, so plain stores do.
// The lanes make their joins in lock-step, one a step.
__device__ __forceinline__ void merge_row(const Forest16& f, const Words& m,
                                          int r, int w, int words,
                                          bool valid) {
  const int i0 = r * words;
  const int row = r * w, up = row - w;
  int rs = 0, rsu = 0;                           // last run start left
  for (int k = 0; k < words; ++k) {
    unsigned s = 0, su = 0, v = 0, vl = 0, d = 0;
    if (valid) {
      s = m.s[i0 + k];
      su = m.s[i0 - words + k];
      v = m.vert[i0 + k];
      vl = v | m.dl[i0 + k];
      d = m.dr[i0 + k];
    }
    while (__any_sync(kAll, (vl | d) != 0)) {
      // this lane's next join: with the pixel above (vertical) or up-left
      // of it (diagonal), else up-right of it (diagonal)
      int a = -1, b = -1;
      if (vl | d) {
        const bool first = vl != 0;
        const int i = __ffs(first ? vl : d) - 1;
        const unsigned le = kAll >> (31 - i);    // bits 0..i
        a = row + last_start(s & le, k, rs);
        b = first ? up + last_start(su & (v >> i & 1u ? le : le >> 1), k, rsu)
                  : up + (k << 5) + i + 1;
        if (first) vl &= vl - 1;
        else d &= d - 1;
      }
      const int a0 = a, b0 = b;
      roots2<true>(f, a, b);
      if (a0 >= 0) {                   // the joined starts point at the root
        const int root = min(a, b);
        f.set(max(a, b), root);
        f.set(a0, root);
        f.set(b0, root);
      }
    }
    rs = last_start(s, k, rs);
    rsu = last_start(su, k, rsu);
  }
}

// frames frames a block, `warps` warps a frame (see `layout`); the grids in
// dynamic shared memory, label_frame_bytes(h, w) a frame.
__global__ void __launch_bounds__(kLabelThreads, kLabelBlocksPerSm)
label_kernel(const uint8_t* __restrict__ code_g, int* __restrict__ out_g,
             int t, int h, int w, int conn_code, int frames, int warps) {
  extern __shared__ __align__(16) unsigned lsm[];
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) / warps;      // frame slot in the block
  const int g = (threadIdx.x >> 5) - slot * warps;  // warp in the frame
  const int frame = blockIdx.x * frames + slot;
  if (frame >= t) return;
  const int hw = h * w;
  const int words = plane_words(w);
  const int n_words = h * words;
  const int tid = g * 32 + lane;                    // thread in the frame
  const int bar_id = 1 + slot;
  const int bar_n = warps * 32;
  const uint8_t* code_in = code_g + static_cast<size_t>(frame) * hw;
  int* out = out_g + static_cast<size_t>(frame) * hw;
  unsigned* pa = lsm + slot * (label_frame_bytes(h, w) / 4);  // code 1 plane
  unsigned* pb = pa + n_words;                                // code 2 plane
  unsigned* parents = pa + align16(static_cast<size_t>(8) * n_words) / 4;
  unsigned* work = parents + align16(2 * static_cast<size_t>(hw)) / 4;
  const Forest16 f{shared_addr(parents)};
  const Words m{work, work + n_words, work + 2 * n_words, work + 3 * n_words,
                work + 4 * n_words};

  // 1. the frame's codes staged in the work space with 16-byte loads, at
  // the alignment of the frame's own bytes
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(code_in) & 15);
  uint8_t* stage = reinterpret_cast<uint8_t*>(work) + mis;
  {
    const int a0 = min(hw, (16 - mis) & 15);       // first 16-B aligned byte
    const int n16 = (hw - a0) >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(code_in + a0);
    uint4* dst = reinterpret_cast<uint4*>(stage + a0);
#pragma unroll 4
    for (int i = tid; i < n16; i += bar_n) dst[i] = __ldg(src + i);
    for (int i = tid; i < a0; i += bar_n) stage[i] = code_in[i];
    for (int i = a0 + (n16 << 4) + tid; i < hw; i += bar_n)
      stage[i] = code_in[i];
  }
  pass_barrier(bar_id, bar_n);

  // 2. a warp a row: the two bit planes by two ballots per 32 pixels, and
  // parent := self at every run start
  for (int r = g; r < h; r += warps) {
    unsigned ca = 0, cb = 0;
    for (int k = 0; k < words; ++k) {
      const int x = (k << 5) + lane;
      const int c = x < w ? region_code(stage[r * w + x], conn_code) : 0;
      const unsigned a = __ballot_sync(kAll, c == 1);
      const unsigned b = __ballot_sync(kAll, c == 2);
      if (lane == 0) {
        pa[r * words + k] = a;
        pb[r * words + k] = b;
      }
      if (run_starts(a, b, ca, cb) >> lane & 1u) f.set(r * w + x, r * w + x);
      ca = a >> 31;
      cb = b >> 31;
    }
  }
  pass_barrier(bar_id, bar_n);

  // 3. a thread a word (r, k), all words at once: its run starts, active
  // pixels and joins to row r - 1, by shifts and masks of the planes (into
  // the work space: the staged codes are no longer read)
  for (int i = tid; i < n_words; i += bar_n) {
    const int r = i / words, k = i - r * words;
    const unsigned a = pa[i], b = pb[i];
    const unsigned ca = k ? pa[i - 1] >> 31 : 0u, cb = k ? pb[i - 1] >> 31 : 0u;
    unsigned vert = 0, dl = 0, dr = 0;
    if (r > 0) {
      const int u = i - words;
      const unsigned au = pa[u], bu = pb[u];
      const unsigned cau = k ? pa[u - 1] >> 31 : 0u;
      const unsigned cbu = k ? pb[u - 1] >> 31 : 0u;
      const unsigned an = k + 1 < words ? pa[u + 1] : 0u;
      const unsigned va = a & au, vb = b & bu;
      vert = (va & ~((va << 1) | (ca & cau))) | (vb & ~((vb << 1) | (cb & cbu)));
      const unsigned da = a & ~au;                // code 1, other code above
      dl = da & ((au << 1) | cau);
      dr = da & ((au >> 1) | (an << 31));
    }
    m.s[i] = run_starts(a, b, ca, cb);
    m.act[i] = a | b;
    m.vert[i] = vert;
    m.dl[i] = dl;
    m.dr[i] = dr;
  }
  pass_barrier(bar_id, bar_n);

  // 4. the rows joined in rounds, a thread a row: in round j the rows
  // r = 2^j (2i + 1) join the 2^j rows above them to the 2^j rows from r on,
  // two blocks no other row of the round touches; a tree spans one block of
  // 2^(j+1) rows after round j, so a find is short
  for (int step = 1; step < h; step *= 2) {
    for (int r = step * (2 * tid + 1); __any_sync(kAll, r < h);
         r += 2 * step * bar_n)
      merge_row(f, m, r, w, words, r < h);
    pass_barrier(bar_id, bar_n);
  }

  // 5. every run start's slot := its root (a thread a word, the lanes in
  // lock-step; a read-only find: a slot that another thread flattens
  // meanwhile still leads to the same root)
  for (int i = tid; __any_sync(kAll, i < n_words); i += bar_n) {
    const int r = i / words, k = i - r * words;
    unsigned s = i < n_words ? m.s[i] : 0u;
    while (__any_sync(kAll, s != 0)) {
      int x = -1;
      if (s) {
        x = r * w + (k << 5) + __ffs(s) - 1;
        s &= s - 1;
      }
      int rx = x, same = x;
      roots2<false>(f, rx, same);
      if (x >= 0) f.set(x, rx);
    }
  }
  pass_barrier(bar_id, bar_n);

  // 6. labels, a warp a row: each active pixel reads its run start's slot;
  // inactive pixels read H*W
  const uint16_t* slots = reinterpret_cast<const uint16_t*>(parents);
  const unsigned le = kAll >> (31 - lane);
  for (int r = g; r < h; r += warps) {
    int rs = 0;
#pragma unroll 4
    for (int k = 0; k < words; ++k) {
      const unsigned s = m.s[r * words + k], act = m.act[r * words + k];
      const unsigned ms = s & le;
      const int x = (k << 5) + lane;
      if (x < w)
        out[r * w + x] = (act >> lane & 1u)
                             ? slots[r * w + (ms ? (k << 5) + 31 - __clz(ms) : rs)]
                             : hw;
      rs = last_start(s, k, rs);
    }
  }
}

cudaError_t allow_max_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      min_root_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxDynamicSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(label_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxDynamicSmem));
}

// Thread blocks of this launch's kernel that fit one SM at once.
cudaError_t blocks_per_sm(const Layout& lay, int* n) {
  if (lay.frames > 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, label_kernel, lay.frames * lay.warps * 32, lay.smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, min_root_fixpoint_kernel, kThreads, lay.smem);
}

int launch(const void* code, const void* init, void* out, void* scratch,
           int t, int h, int w, int conn_code, cudaStream_t stream) {
  if (t <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(t, h, w, init != nullptr);
  if (lay.scratch != 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lay.frames > 0) {
    label_kernel<<<(t + lay.frames - 1) / lay.frames,
                   lay.frames * lay.warps * 32, lay.smem, stream>>>(
        static_cast<const uint8_t*>(code), static_cast<int*>(out), t, h, w,
        conn_code, lay.frames, lay.warps);
  } else {
    min_root_fixpoint_kernel<<<t, kThreads, lay.smem, stream>>>(
        static_cast<const uint8_t*>(code), static_cast<const int*>(init),
        static_cast<int*>(out), static_cast<int*>(scratch), h, w, conn_code,
        lay.smem != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device scratch (int32 parents) the launch needs for this shape;
// 0 when the grids fit shared memory.  with_init: 1 for the min_prop forms.
long long og_scratch_bytes(int t, int h, int w, int with_init) {
  return static_cast<long long>(layout(t, h, w, with_init != 0).scratch);
}

// The form a launch of this shape takes (`layout`), into out[7]: dynamic
// shared memory a block, device scratch, frames a block (0: the fixpoint
// form), warps a frame, threads a block, blocks the launch has, and blocks
// that fit one SM at once (or minus a CUDA error).
int og_layout(int t, int h, int w, int with_init, long long* out) {
  if (t <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(t, h, w, with_init != 0);
  cudaError_t err = allow_max_smem();
  int n = 0;
  if (err == cudaSuccess) err = blocks_per_sm(lay, &n);
  out[0] = static_cast<long long>(lay.smem);
  out[1] = static_cast<long long>(lay.scratch);
  out[2] = lay.frames;
  out[3] = lay.warps;
  out[4] = lay.frames > 0 ? lay.frames * lay.warps * 32 : kThreads;
  out[5] = lay.frames > 0 ? (t + lay.frames - 1) / lay.frames : t;
  out[6] = err == cudaSuccess ? n : -static_cast<int>(err);
  return static_cast<int>(err);
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
