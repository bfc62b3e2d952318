// Design variants of csrc/areas.cu's in-box count, timed on the served
// chunk shape: 128 frames of a 160x160 bfloat16 window, a 70x120 box in
// each, the origin on the device.  Each variant is checked against the
// first form (v0) and timed by CUDA events over 200 launches queued behind
// ~10 ms of spinning (the launch floor shows as `empty`).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o box_count_variants openglottal_tpu_torch/tools/box_count_variants.cu
//   ./box_count_variants        # one "name ms" line per variant
//
//   v0            the first form: one 256-thread block per frame, 2-B loads
//   v1 / v2       each frame's rows over a cluster of `b` blocks joined
//                 through distributed shared memory (v2: the frame's flag,
//                 box and origin loaded together)
//   v3            one block per frame, 256 / 512 / 1024 threads, the box's
//                 (row, 16-B vector) items flat over the threads
//   v4            rows over `b` blocks adding into a zeroed output (memset)
//   vtab          v3 reading its chunks from a table passed by value (the
//                 form csrc/areas.cu takes), 1 and 8 chunks, 512 / 1024
//                 threads, u2: two items' loads issued before counting
//
// vtab n8 is a table of 8 chunks (8 x 128 frames over the same logits).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf;

__global__ void spin(long long c) { long long t = clock64(); while (clock64() - t < c) {} }
__global__ void empty_k() {}
__global__ void one_load(const uint8_t* v, float* o) { if (threadIdx.x == 0) o[blockIdx.x] = v[blockIdx.x]; }

// V0: old
__global__ void __launch_bounds__(256) v0(const bf* x, float thr, const uint8_t* valid, const int* boxes, const long long* oyp, const long long* oxp, float* out, int h, int w) {
  const int n = blockIdx.x;
  if (!valid[n]) { if (threadIdx.x == 0) out[n] = 0; return; }
  long long oy = oyp[0], ox = oxp[0];
  const int* b = boxes + 4 * n;
  int i0 = max(0LL, (long long)b[1] - oy), i1 = min((long long)h, (long long)b[3] - oy);
  int j0 = max(0LL, (long long)b[0] - ox), j1 = min((long long)w, (long long)b[2] - ox);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5; int c = 0;
  const bf* xn = x + (size_t)n * h * w;
  for (int i = i0 + warp; i < i1; i += 8) for (int j = j0 + lane; j < j1; j += 32) c += __bfloat162float(xn[(size_t)i * w + j]) > thr;
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(~0u, c, o);
  __shared__ int p[8]; if (!lane) p[warp] = c; __syncthreads();
  if (!warp) { c = lane < 8 ? p[lane] : 0; for (int o = 16; o; o >>= 1) c += __shfl_down_sync(~0u, c, o); if (!lane) out[n] = c; }
}

__device__ __forceinline__ int cnt8(uint4 v, float thr) {
  unsigned u[4] = {v.x, v.y, v.z, v.w}; int c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c += (__uint_as_float(u[k] << 16) > thr) + (__uint_as_float(u[k] & 0xffff0000u) > thr);
  return c;
}

// the band body: rows [r0, r1) of the box, items flat over threads
template <int T>
__device__ __forceinline__ int band_count(const bf* xn, int w, int r0, int r1, int j0, int j1, float thr) {
  int count = 0;
  const int len = j1 - j0, items = len / 8 + 2;
  for (int k = threadIdx.x; k < (r1 - r0) * items; k += T) {
    const int r = r0 + k / items, item = k % items;
    const bf* row = xn + (size_t)r * w + j0;
    const int off = (int)((reinterpret_cast<uintptr_t>(row) & 15) / 2);
    const int head = min(len, (8 - off) % 8);
    const int body = (len - head) / 8;
    if (item >= 2) {
      if (item - 2 < body) count += cnt8(__ldg(reinterpret_cast<const uint4*>(row + head) + item - 2), thr);
    } else {
      const int e0 = item == 0 ? 0 : head + body * 8, e1 = item == 0 ? head : len;
#pragma unroll
      for (int e = 0; e < 7; ++e) if (e0 + e < e1) count += __bfloat162float(row[e0 + e]) > thr;
    }
  }
  return count;
}

template <int T>
__device__ __forceinline__ int block_sum(int c) {
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(~0u, c, o);
  __shared__ int p[T / 32]; __shared__ int tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!lane) p[warp] = c; __syncthreads();
  if (!warp) { c = lane < T / 32 ? p[lane] : 0; for (int o = 16; o; o >>= 1) c += __shfl_down_sync(~0u, c, o); if (!lane) tot = c; }
  __syncthreads();
  return tot;
}

// V1 current (cluster, metadata loads in order); V2 hoisted metadata
template <bool HOIST>
__global__ void __launch_bounds__(256) vcl(const bf* x, float thr, const uint8_t* valid, const int* boxes, const long long* oyp, const long long* oxp, float* out, int h, int w, int bands) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / bands, rank = blockIdx.x % bands;
  int v; long long oy, ox; int4 b;
  if (HOIST) {
    v = valid[n]; oy = oyp[0]; ox = oxp[0]; b = *reinterpret_cast<const int4*>(boxes + 4 * n);
    if (!v) { if (rank == 0 && threadIdx.x == 0) out[n] = 0; return; }
  } else {
    if (!valid[n]) { if (rank == 0 && threadIdx.x == 0) out[n] = 0; return; }
    oy = oyp[0]; ox = oxp[0]; b = make_int4(boxes[4 * n], boxes[4 * n + 1], boxes[4 * n + 2], boxes[4 * n + 3]);
  }
  int i0 = max(0LL, (long long)b.y - oy), i1 = min((long long)h, (long long)b.w - oy);
  int j0 = max(0LL, (long long)b.x - ox), j1 = min((long long)w, (long long)b.z - ox);
  int c = 0;
  if (i1 > i0 && j1 > j0) { const int per = (i1 - i0 + bands - 1) / bands; const int r0 = i0 + rank * per; c = band_count<256>(x + (size_t)n * h * w, w, r0, min(i1, r0 + per), j0, j1, thr); }
  __shared__ int total;
  int t = block_sum<256>(c);
  if (threadIdx.x == 0) total = t;
  cluster.sync();
  if (rank == 0 && threadIdx.x < 32) {
    int s = threadIdx.x < bands ? *cluster.map_shared_rank(&total, threadIdx.x) : 0;
    for (int o = 16; o; o >>= 1) s += __shfl_down_sync(~0u, s, o);
    if (threadIdx.x == 0) out[n] = s;
  }
  cluster.sync();
}

// V3: one block per frame, T threads, flat items, hoisted
template <int T>
__global__ void __launch_bounds__(T) vblk(const bf* x, float thr, const uint8_t* valid, const int* boxes, const long long* oyp, const long long* oxp, float* out, int h, int w) {
  const int n = blockIdx.x;
  int v = valid[n]; long long oy = oyp[0], ox = oxp[0]; int4 b = *reinterpret_cast<const int4*>(boxes + 4 * n);
  if (!v) { if (threadIdx.x == 0) out[n] = 0; return; }
  int i0 = max(0LL, (long long)b.y - oy), i1 = min((long long)h, (long long)b.w - oy);
  int j0 = max(0LL, (long long)b.x - ox), j1 = min((long long)w, (long long)b.z - ox);
  int c = (i1 > i0 && j1 > j0) ? band_count<T>(x + (size_t)n * h * w, w, i0, i1, j0, j1, thr) : 0;
  int t = block_sum<T>(c);
  if (threadIdx.x == 0) out[n] = t;
}

// V4: bands without clusters: atomicAdd into a zeroed output
__global__ void __launch_bounds__(256) vat(const bf* x, float thr, const uint8_t* valid, const int* boxes, const long long* oyp, const long long* oxp, float* out, int h, int w, int bands) {
  const int n = blockIdx.x / bands, rank = blockIdx.x % bands;
  int v = valid[n]; long long oy = oyp[0], ox = oxp[0]; int4 b = *reinterpret_cast<const int4*>(boxes + 4 * n);
  if (!v) return;
  int i0 = max(0LL, (long long)b.y - oy), i1 = min((long long)h, (long long)b.w - oy);
  int j0 = max(0LL, (long long)b.x - ox), j1 = min((long long)w, (long long)b.z - ox);
  int c = 0;
  if (i1 > i0 && j1 > j0) { const int per = (i1 - i0 + bands - 1) / bands; const int r0 = i0 + rank * per; c = band_count<256>(x + (size_t)n * h * w, w, r0, min(i1, r0 + per), j0, j1, thr); }
  int t = block_sum<256>(c);
  if (threadIdx.x == 0 && t) atomicAdd(out + n, (float)t);
}


struct Chunk { const void* x; const uint8_t* valid; const int32_t* boxes; const int64_t* oy; const int64_t* ox; float* out; int n; int first; int oy_arg; int ox_arg; };
template <int C> struct Table { Chunk c[C]; };

// items of a frame's box, 2 per thread per round, loads issued first
template <int T>
__device__ __forceinline__ int box_items2(const bf* xn, int w, int i0, int i1, int j0, int j1, float thr) {
  int count = 0;
  const int len = j1 - j0, items = len / 8 + 2, total = (i1 - i0) * items;
  for (int k0 = threadIdx.x; k0 < total; k0 += 2 * T) {
    uint4 vv[2]; bool isv[2]; int sc[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + u * T; isv[u] = false;
      if (k >= total) continue;
      const int r = i0 + k / items, item = k % items;
      const bf* row = xn + (size_t)r * w + j0;
      const int off = (int)((reinterpret_cast<uintptr_t>(row) & 15) / 2);
      const int head = min(len, (8 - off) % 8), body = (len - head) / 8;
      if (item >= 2) {
        if (item - 2 < body) { vv[u] = __ldg(reinterpret_cast<const uint4*>(row + head) + item - 2); isv[u] = true; }
      } else {
        const int e0 = item == 0 ? 0 : head + body * 8, e1 = item == 0 ? head : len;
#pragma unroll
        for (int e = 0; e < 7; ++e) if (e0 + e < e1) sc[u] += __bfloat162float(row[e0 + e]) > thr;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) count += sc[u] + (isv[u] ? cnt8(vv[u], thr) : 0);
  }
  return count;
}

template <int C, int T, bool U2>
__global__ void __launch_bounds__(T) vtab(const __grid_constant__ Table<C> table, int nc, float thr, int h, int w) {
  const int frame = blockIdx.x;
  int c = 0;
  while (c + 1 < nc && table.c[c + 1].first <= frame) ++c;
  const Chunk& ch = table.c[c];
  const int n = frame - ch.first;
  const int v = ch.valid[n];
  const long long oy = ch.oy ? ch.oy[0] : ch.oy_arg, ox = ch.ox ? ch.ox[0] : ch.ox_arg;
  const int4 b = *reinterpret_cast<const int4*>(ch.boxes + 4 * n);
  if (!v) { if (threadIdx.x == 0) ch.out[n] = 0; return; }
  int i0 = max(0LL, (long long)b.y - oy), i1 = min((long long)h, (long long)b.w - oy);
  int j0 = max(0LL, (long long)b.x - ox), j1 = min((long long)w, (long long)b.z - ox);
  const bf* xn = static_cast<const bf*>(ch.x) + (size_t)n * h * w;
  int cnt = 0;
  if (i1 > i0 && j1 > j0) cnt = U2 ? box_items2<T>(xn, w, i0, i1, j0, j1, thr) : band_count<T>(xn, w, i0, i1, j0, j1, thr);
  int t = block_sum<T>(cnt);
  if (threadIdx.x == 0) ch.out[n] = t;
}

template <typename F>
float timeit(F f, cudaStream_t s, int reps) {
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  f(); cudaStreamSynchronize(s);
  spin<<<1, 1, 0, s>>>(20000000LL);
  cudaEventRecord(a, s);
  for (int i = 0; i < reps; ++i) f();
  cudaEventRecord(b, s); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  return ms / reps;
}

int main() {
  const int N = 128, H = 160, W = 160, K = 8;
  cudaStream_t s; cudaStreamCreate(&s);
  std::vector<bf> hx((size_t)K * N * H * W);
  srand(1);
  for (auto& e : hx) e = __float2bfloat16((rand() / (float)RAND_MAX) - 0.5f);
  std::vector<int> hb(4 * N); std::vector<uint8_t> hv(N, 1);
  for (int n = 0; n < N; ++n) { int cx = 128 + rand() % 5, cy = 110 + rand() % 5; hb[4*n] = cx - 35; hb[4*n+1] = cy - 60; hb[4*n+2] = cx + 35; hb[4*n+3] = cy + 60; }
  long long hoy = 50, hox = 42;
  bf* x; int* bx; uint8_t* v; long long *oy, *ox; float* out; float* ref;
  cudaMalloc(&x, hx.size() * 2); cudaMalloc(&bx, hb.size() * 4); cudaMalloc(&v, N); cudaMalloc(&oy, 8); cudaMalloc(&ox, 8); cudaMalloc(&out, K * N * 4); cudaMalloc(&ref, K * N * 4);
  cudaMemcpy(x, hx.data(), hx.size() * 2, cudaMemcpyHostToDevice); cudaMemcpy(bx, hb.data(), hb.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(v, hv.data(), N, cudaMemcpyHostToDevice); cudaMemcpy(oy, &hoy, 8, cudaMemcpyHostToDevice); cudaMemcpy(ox, &hox, 8, cudaMemcpyHostToDevice);
  auto cl = [&](auto kern, int bands) {
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(N * bands); cfg.blockDim = dim3(256); cfg.stream = s;
    cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = bands; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, kern, (const bf*)x, 0.0f, (const uint8_t*)v, (const int*)bx, (const long long*)oy, (const long long*)ox, out, H, W, bands);
  };
  const int reps = 200;
  v0<<<N, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, ref, H, W); cudaDeviceSynchronize();
  std::vector<float> r(N), g(N);
  cudaMemcpy(r.data(), ref, N * 4, cudaMemcpyDeviceToHost);
  auto check = [&](const char* name) { cudaDeviceSynchronize(); cudaMemcpy(g.data(), out, N * 4, cudaMemcpyDeviceToHost); int bad = 0; for (int i = 0; i < N; ++i) bad += g[i] != r[i]; printf("%s check bad=%d err=%s\n", name, bad, cudaGetErrorString(cudaGetLastError())); };
  printf("empty %.5f\n", timeit([&] { empty_k<<<1, 32, 0, s>>>(); }, s, reps));
  printf("one_load %.5f\n", timeit([&] { one_load<<<1, 32, 0, s>>>(v, out); }, s, reps));
  printf("one_load_640 %.5f\n", timeit([&] { one_load<<<640, 256, 0, s>>>(v, out); }, s, reps));
  printf("v0_old %.5f\n", timeit([&] { v0<<<N, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); }, s, reps));
  for (int bands : {1, 2, 3, 5, 8}) {
    cl(vcl<false>, bands); char nm[64]; snprintf(nm, 64, "v1_cluster b%d", bands); check(nm);
    printf("v1_cluster b%d %.5f\n", bands, timeit([&] { cl(vcl<false>, bands); }, s, reps));
    cl(vcl<true>, bands); snprintf(nm, 64, "v2_hoist b%d", bands); check(nm);
    printf("v2_hoist b%d %.5f\n", bands, timeit([&] { cl(vcl<true>, bands); }, s, reps));
  }
  vblk<256><<<N, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); check("v3_256");
  printf("v3_block256 %.5f\n", timeit([&] { vblk<256><<<N, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); }, s, reps));
  vblk<512><<<N, 512, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); check("v3_512");
  printf("v3_block512 %.5f\n", timeit([&] { vblk<512><<<N, 512, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); }, s, reps));
  vblk<1024><<<N, 1024, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); check("v3_1024");
  printf("v3_block1024 %.5f\n", timeit([&] { vblk<1024><<<N, 1024, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W); }, s, reps));
  for (int bands : {2, 5}) {
    cudaMemsetAsync(out, 0, N * 4, s); vat<<<N * bands, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W, bands); char nm[64]; snprintf(nm, 64, "v4_atomic b%d", bands); check(nm);
    printf("v4_atomic+memset b%d %.5f\n", bands, timeit([&] { cudaMemsetAsync(out, 0, N * 4, s); vat<<<N * bands, 256, 0, s>>>(x, 0.0f, v, bx, oy, ox, out, H, W, bands); }, s, reps));
  }
  printf("memset %.5f\n", timeit([&] { cudaMemsetAsync(out, 0, N * 4, s); }, s, reps));

  {
    Table<48> t48{}; Table<8> t8{}; Table<1> t1{};
    for (int c = 0; c < 8; ++c) {
      Chunk e{x, v, bx, (const int64_t*)oy, (const int64_t*)ox, out + c * N, N, c * N, 0, 0};
      t48.c[c] = e; t8.c[c] = e; if (c == 0) t1.c[0] = e;
    }
    vtab<1, 1024, false><<<N, 1024, 0, s>>>(t1, 1, 0.0f, H, W); check("vtab1");
    printf("vtab cap1 T1024 %.5f\n", timeit([&] { vtab<1, 1024, false><<<N, 1024, 0, s>>>(t1, 1, 0.0f, H, W); }, s, reps));
    vtab<1, 1024, true><<<N, 1024, 0, s>>>(t1, 1, 0.0f, H, W); check("vtab1 u2");
    printf("vtab cap1 T1024 u2 %.5f\n", timeit([&] { vtab<1, 1024, true><<<N, 1024, 0, s>>>(t1, 1, 0.0f, H, W); }, s, reps));
    printf("vtab cap1 T512 u2 %.5f\n", timeit([&] { vtab<1, 512, true><<<N, 512, 0, s>>>(t1, 1, 0.0f, H, W); }, s, reps));
    printf("vtab cap1 T512 %.5f\n", timeit([&] { vtab<1, 512, false><<<N, 512, 0, s>>>(t1, 1, 0.0f, H, W); }, s, reps));
    printf("vtab cap8 n1 T1024 %.5f\n", timeit([&] { vtab<8, 1024, false><<<N, 1024, 0, s>>>(t8, 1, 0.0f, H, W); }, s, reps));
    printf("vtab cap48 n1 T1024 %.5f\n", timeit([&] { vtab<48, 1024, false><<<N, 1024, 0, s>>>(t48, 1, 0.0f, H, W); }, s, reps));
    printf("vtab cap8 n8 T1024 %.5f\n", timeit([&] { vtab<8, 1024, false><<<N * 8, 1024, 0, s>>>(t8, 8, 0.0f, H, W); }, s, reps));
    printf("vtab cap8 n8 T1024 u2 %.5f\n", timeit([&] { vtab<8, 1024, true><<<N * 8, 1024, 0, s>>>(t8, 8, 0.0f, H, W); }, s, reps));
    printf("vtab cap8 n8 T512 %.5f\n", timeit([&] { vtab<8, 512, false><<<N * 8, 512, 0, s>>>(t8, 8, 0.0f, H, W); }, s, reps));
    printf("vtab cap8 n8 T512 u2 %.5f\n", timeit([&] { vtab<8, 512, true><<<N * 8, 512, 0, s>>>(t8, 8, 0.0f, H, W); }, s, reps));
    printf("vtab cap48 n8 T1024 %.5f\n", timeit([&] { vtab<48, 1024, false><<<N * 8, 1024, 0, s>>>(t48, 8, 0.0f, H, W); }, s, reps));
    vtab<8, 1024, true><<<N * 8, 1024, 0, s>>>(t8, 8, 0.0f, H, W); cudaDeviceSynchronize();
    std::vector<float> all(8 * N); cudaMemcpy(all.data(), out, 8 * N * 4, cudaMemcpyDeviceToHost);
    int bad = 0; for (int i = 0; i < 8 * N; ++i) bad += all[i] != r[i % N]; printf("vtab n8 bad=%d\n", bad);
  }
  return 0;
}
