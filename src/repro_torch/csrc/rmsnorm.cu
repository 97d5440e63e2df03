// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (body ::_kernel).
// Per row of d values, in f32 whatever the input type:
//
//   var = sum(x^2) / d;   y = x * (1 / sqrt(var + eps)) * scale
//
// and y is written in x's type (f32 or bf16); scale is f32 or bf16.
//
// Bound on the H100: bytes.  The row is read once and written once (the
// scale is d values, read from L2 by every row); 4 operations an element
// are far below the card's ~20 f32 operations per byte.  At the federated
// fit's shape, 504 rows of 4096 bf16, that is 8.27 MB, 2.5 us at
// 3.35 TB/s; at the other shapes the bound is under the ~5 us a launch
// costs, so a call is latency: one trip to memory and back, and how well
// the grid covers the card's 132 SMs.
//
// Design:
//  * A row is split over TPR threads of a block (a group), and over CL
//    blocks of a thread-block cluster where it is too long for one block;
//    a block holds RPB groups.  The launcher picks (TPR, RPB, CL, NV) from
//    (rows, d, SM count): kernels/rmsnorm.py::rmsnorm_layout, which the
//    CPU tests pin.  On the H100 one block a row measured faster than a
//    cluster a row even where the rows are fewer than the SMs (64 rows of
//    4096 f32), so a cluster serves only rows over 2048 chunks.
//  * Thread g of a row's TPR * CL threads owns the row's 16-byte chunks
//    g, g + TPR * CL, ... (NV of them: 8 bf16 or 4 f32 values each), so one
//    pass of the row's threads reads a contiguous span.  Every load of a
//    thread, x's NV chunks and the matching scale values, is issued before
//    the first is used: the scale arrives with x, not one dependent trip
//    after the reduction.  The scale's type is a template parameter.
//  * The sum of squares: a warp shuffle, then shared memory across the
//    group's warps, then, in a cluster, each block's row sum read from
//    every block of the cluster through distributed shared memory, summed
//    in rank order (so every block gets the same f32 sum).  A block signals
//    that it has read its peers before it stores, and waits for the others
//    only after its stores, so no block leaves while a peer still reads it.
//  * x is read with streaming loads (read once) and y written with
//    streaming stores; the scale is read through the cache (every row).
//  * A row whose length or addresses do not allow 16-byte chunks is read
//    and written element by element in the same layout.  Rows are not
//    padded to a tile: the reference pads to its row block, this kernel
//    masks the last group's row instead.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // a block's threads (TPR * RPB)
constexpr int kMaxCluster = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}
template <typename U>
__device__ __forceinline__ U zero() {
  U z;
  from_f(0.0f, &z);
  return z;
}

// W values of type U, aligned to their size: one 16-byte chunk of x, or
// the scale values of one chunk (8, 16 or 32 bytes).
template <typename U, int W>
struct alignas(W * sizeof(U)) Vec {
  U v[W];
};

template <typename U, int W>
__device__ __forceinline__ Vec<U, W> load_cached(const U* p) {
  return *reinterpret_cast<const Vec<U, W>*>(p);
}

template <typename T>
__device__ __forceinline__ Vec<T, 16 / sizeof(T)> load_stream(const T* p) {
  const int4 r = __ldcs(reinterpret_cast<const int4*>(p));
  Vec<T, 16 / sizeof(T)> c;
  *reinterpret_cast<int4*>(&c) = r;
  return c;
}

template <typename T>
__device__ __forceinline__ void store_stream(T* p,
                                             const Vec<T, 16 / sizeof(T)>& c) {
  __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&c));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// T: x and y type.  S: scale type.  NV: 16-byte chunks a thread holds.
// Runtime (uniform over the launch): tpr threads a row in a block, cl
// blocks a row (the cluster's size), vec: rows may be read as chunks.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, float eps, int vec,
               int tpr, int cl) {
  constexpr int W = 16 / sizeof(T);
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float rowsum[kMaxThreads / 32];
  const int rpb = blockDim.x / tpr;
  const int rank = cl > 1 ? static_cast<int>(blockIdx.x % cl) : 0;
  const int rib = threadIdx.x / tpr;            // row in the block
  const int t = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x / cl) * rpb + rib;
  // Every thread reaches every barrier below: a dead row only masks.
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * d;
  const int g = rank * tpr + t;                 // thread of the row
  const int stride = tpr * cl;                  // chunks a pass

  Vec<T, W> xc[NV];
  Vec<S, W> sc[NV];
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * stride + g) * W;
      if (live && e0 < d) xc[j] = load_stream(xr + e0);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * stride + g) * W;
      if (live && e0 < d) sc[j] = load_cached<S, W>(scale + e0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * stride + g) * W;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const bool in = live && e0 + i < d;
        xc[j].v[i] = in ? xr[e0 + i] : zero<T>();
        sc[j].v[i] = in ? scale[e0 + i] : zero<S>();
      }
    }
  }

  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * stride + g) * W;
    if (live && e0 < d) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float v = to_f(xc[j].v[i]);
        ss = fmaf(v, v, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {
    const int wpr = tpr / 32;                   // warps a row
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int w = 0; w < wpr; ++w) ss += partial[rib * wpr + w];
  }
  if (cl > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) rowsum[rib] = ss;
    cluster.sync();
    ss = 0.0f;
    for (int r = 0; r < cl; ++r)
      ss += *cluster.map_shared_rank(&rowsum[rib], r);
    cluster_arrive();                           // done reading the peers
  }
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  if (live) {
    T* yr = y + row * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e0 = (j * stride + g) * W;
      if (e0 >= d) continue;
      Vec<T, W> c;
#pragma unroll
      for (int i = 0; i < W; ++i)
        from_f(to_f(xc[j].v[i]) * inv * to_f(sc[j].v[i]), &c.v[i]);
      if (vec) {
        store_stream(yr + e0, c);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (e0 + i < d) yr[e0 + i] = c.v[i];
      }
    }
  }
  if (cl > 1) cluster_wait();                   // peers done reading this
}

template <typename T, typename S, int NV>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, int vec, int tpr, int rpb, int cl, cudaStream_t st) {
  const long long groups = (rows + rpb - 1) / rpb;
  const long long grid = groups * cl;
  if (grid > 2147483647LL) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(tpr * rpb), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, rmsnorm_kernel<T, S, NV>, static_cast<const T*>(x),
      static_cast<const S*>(scale), static_cast<T*>(y), rows, d, eps, vec,
      tpr, cl);
  return static_cast<int>(rc);
}

template <typename T, typename S>
int launch_nv(int nv, const void* x, const void* scale, void* y,
              long long rows, int d, float eps, int vec, int tpr, int rpb,
              int cl, cudaStream_t st) {
  switch (nv) {
    case 1:
      return launch<T, S, 1>(x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st);
    case 2:
      return launch<T, S, 2>(x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st);
    case 4:
      return launch<T, S, 4>(x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st);
    default:
      return -1;
  }
}

}  // namespace

// x, y: rows x d, contiguous, of one type (x_bf16: bf16, else f32); scale:
// d values (scale_bf16: bf16, else f32).  vec: x, y and scale are aligned
// to their chunks and d is a whole number of 16-byte chunks of x.  The
// layout: tpr threads a row in a block (a multiple of 32), rpb rows a
// block (tpr * rpb <= 512), cl blocks a row (a cluster of 1, 2 or 4), nv
// chunks a thread (1, 2 or 4), with nv * tpr * cl chunks covering d.
extern "C" int rn_rmsnorm(const void* x, int x_bf16, const void* scale,
                          int scale_bf16, void* y, long long rows, int d,
                          float eps, int vec, int tpr, int rpb, int cl,
                          int nv, void* stream) {
  const int w = x_bf16 ? 8 : 4;
  if (rows < 1 || d < 1 || tpr < 32 || tpr % 32 || rpb < 1 ||
      tpr * rpb > kMaxThreads || (cl != 1 && cl != 2 && cl != kMaxCluster) ||
      static_cast<long long>(nv) * tpr * cl * w < d)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_bf16)
    rc = scale_bf16 ? launch_nv<__nv_bfloat16, __nv_bfloat16>(
                          nv, x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st)
                    : launch_nv<__nv_bfloat16, float>(
                          nv, x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st);
  else
    rc = scale_bf16 ? launch_nv<float, __nv_bfloat16>(
                          nv, x, scale, y, rows, d, eps, vec, tpr, rpb, cl, st)
                    : launch_nv<float, float>(nv, x, scale, y, rows, d, eps,
                                              vec, tpr, rpb, cl, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
