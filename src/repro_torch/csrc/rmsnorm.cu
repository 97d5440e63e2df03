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
// 3.35 TB/s.  Design: a row is one group of TPR threads, a warp for d <=
// 1024 (eight rows to a 256-thread block) and the whole 256-thread block
// above that.  Thread t of a group owns the row's 16-byte chunks t, t + TPR,
// ... (8 bf16 or 4 f32 values each), so a group's loads cover the row
// contiguously, and it holds its NV chunks in registers between the sum of
// squares (a warp shuffle, then shared memory across the block's warps) and
// the scaled write: every byte moves once.  A row whose length or address
// does not allow 16-byte chunks is read element by element in the same
// layout.  Rows are not padded to a tile: the reference pads to its row
// block, this kernel masks the last group's row instead.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
struct alignas(16) Chunk {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float scale_at(const void* scale, int bf16,
                                          long long i) {
  return bf16 ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(scale)[i])
              : static_cast<const float*>(scale)[i];
}

// T: x and y type.  TPR: threads a row (32 or kThreads).  NV: 16-byte
// chunks a thread holds.  vec: rows may be read as 16-byte chunks.
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const void* __restrict__ scale,
               int scale_bf16, T* __restrict__ y, long long rows, int d,
               float eps, int vec) {
  constexpr int W = Chunk<T>::N;
  constexpr int kGroups = kThreads / TPR;
  __shared__ float partial[kThreads / 32];
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * kGroups +
                        threadIdx.x / TPR;
  // With TPR == kThreads every thread of the block shares one row, so the
  // block-wide barrier below is reached by all or none of them.
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * d;

  float v[NV][W];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * TPR + t) * W;
    if (vec && live && e0 < d) {
      const Chunk<T> c = *reinterpret_cast<const Chunk<T>*>(xr + e0);
#pragma unroll
      for (int i = 0; i < W; ++i) v[j][i] = to_f(c.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        v[j][i] = (live && e0 + i < d) ? to_f(xr[e0 + i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) ss = fmaf(v[j][i], v[j][i], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (TPR > 32) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) ss += partial[w];
  }
  if (!live) return;
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e0 = (j * TPR + t) * W;
    if (e0 >= d) continue;
    if (vec) {
      Chunk<T> c;
#pragma unroll
      for (int i = 0; i < W; ++i)
        from_f(v[j][i] * inv * scale_at(scale, scale_bf16, e0 + i), &c.v[i]);
      *reinterpret_cast<Chunk<T>*>(yr + e0) = c;
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (e0 + i < d)
          from_f(v[j][i] * inv * scale_at(scale, scale_bf16, e0 + i),
                 yr + e0 + i);
    }
  }
}

template <typename T, int TPR>
int launch_nv(int nv, const void* x, const void* scale, int scale_bf16,
              void* y, long long rows, int d, float eps, int vec,
              cudaStream_t st) {
  const long long groups = kThreads / TPR;
  const long long grid = (rows + groups - 1) / groups;
  if (grid > 2147483647LL) return -1;
#define RMSNORM_CASE(N)                                                    \
  case N:                                                                  \
    rmsnorm_kernel<T, TPR, N><<<static_cast<unsigned>(grid), kThreads, 0,  \
                                st>>>(static_cast<const T*>(x), scale,     \
                                      scale_bf16, static_cast<T*>(y),      \
                                      rows, d, eps, vec);                  \
    return 0;
  switch (nv) {
    RMSNORM_CASE(1)
    RMSNORM_CASE(2)
    RMSNORM_CASE(4)
    RMSNORM_CASE(8)
    RMSNORM_CASE(16)
    default:
      return -1;
  }
#undef RMSNORM_CASE
}

template <typename T>
int launch_type(const void* x, const void* scale, int scale_bf16, void* y,
                long long rows, int d, float eps, int vec, cudaStream_t st) {
  constexpr int W = Chunk<T>::N;
  const int tpr = d <= 1024 ? 32 : kThreads;
  const int chunks = (d + W - 1) / W;
  int nv = 1;
  while (nv * tpr < chunks) nv *= 2;
  if (tpr == 32)
    return launch_nv<T, 32>(nv, x, scale, scale_bf16, y, rows, d, eps, vec,
                            st);
  return launch_nv<T, kThreads>(nv, x, scale, scale_bf16, y, rows, d, eps,
                                vec, st);
}

}  // namespace

// x, y: rows x d, contiguous, of one type (x_bf16: bf16, else f32); scale:
// d values (scale_bf16: bf16, else f32).  vec: x and y are 16-byte aligned
// and d is a whole number of 16-byte chunks.  d <= 16 * 256 chunks.
extern "C" int rn_rmsnorm(const void* x, int x_bf16, const void* scale,
                          int scale_bf16, void* y, long long rows, int d,
                          float eps, int vec, void* stream) {
  if (rows < 1 || d < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      x_bf16 ? launch_type<__nv_bfloat16>(x, scale, scale_bf16, y, rows, d,
                                          eps, vec, st)
             : launch_type<float>(x, scale, scale_bf16, y, rows, d, eps, vec,
                                  st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
