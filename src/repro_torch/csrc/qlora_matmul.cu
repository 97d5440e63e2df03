// Fused QLoRA matmul for Hopper (sm_90a):
//
//   y = x . dequant_nf4(Wq) + s . (x . A) . B
//
// Replaces the TPU kernel repro/kernels/qlora_matmul.py::qlora_matmul (body
// ::_kernel).  x is (M, K) f32 or bf16; Wq is (K, N/2) bytes, two NF4 codes
// each, the high nibble the even column; absmax is (K, N/qblock) f32, one
// scale per (row, column block); A (K, r) and B (r, N) are f32 and s is a
// float passed by value.  Every product and sum is f32; y is written in x's
// type.  The 16-entry NF4 code book comes from the caller.
//
// Bound on the H100: operations.  At the federated fit's site (M 504,
// K = N = 4096, r 8) the kernel does 17.0 GFLOP against 18.0 MB moved.  In
// bf16 on the tensor cores that would be 17 us; this kernel keeps the f32
// arithmetic that the reference specifies, on the CUDA cores, whose f32
// rate (67 TFLOP/s) puts its floor at 0.25 ms.  Tensor cores are a later
// design's question: they change the arithmetic.
//
// Design: a classic tiled GEMM on the CUDA cores.  Each 256-thread block
// owns one 64 x 64 tile of y and walks K in steps of 32 inside the block
// (the TPU kernel's sequential K grid axis and its VMEM scratch become this
// loop and registers; nothing carries between blocks).  Per step:
//   * the x tile (64 x 32) is converted to f32 and stored in shared memory,
//     transposed, so that a thread reads its 4 rows as one 16-byte load;
//   * the packed codes (32 rows x 32 bytes) are read 4 bytes (8 codes) a
//     thread, decoded through the code book held in shared memory and
//     multiplied by their row's absmax, once per step for all 64 rows of
//     the tile (no one-hot product: that is the TPU's way to its MXU);
//   * each thread accumulates a 4 x 4 patch of x . W in registers, and beside
//     it its share of the 64 x r product x . A (the LoRA bypass), from the
//     same x tile in shared memory.
// The epilogue stages x . A and the B tile in shared memory and adds
// s . (x . A) . B to each thread's patch before the one write of y.  M, N and
// K may be ragged: the loads past an edge read zeros and the stores past it
// are dropped.  The one layout rule is N % qblock == 0.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int XS = BM + 4;   // padded row of the transposed x tile

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

template <int RP>
struct Smem {
  static constexpr int kMain = BK * XS + BK * BN + BK * RP;
  static constexpr int kEpi = BM * (RP + 1) + RP * BN;
  static constexpr int kFloats = kMain > kEpi ? kMain : kEpi;
};

// T: x and y type.  RP: the LoRA rank r rounded up to 4, 8, 16, 32 or 64.
// xvec: x rows may be read as 16-byte chunks (K a whole number of them,
// x 16-byte aligned).  wvec: code rows may be read 4 bytes at a time.
template <typename T, int RP>
__global__ void __launch_bounds__(kThreads)
qlora_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wq,
             const float* __restrict__ absmax, const float* __restrict__ la,
             const float* __restrict__ lb, const float* __restrict__ code,
             T* __restrict__ y, int M, int N, int K, int r, int qblock,
             float s, int xvec, int wvec) {
  __shared__ __align__(16) float smem[Smem<RP>::kFloats];
  __shared__ float book[16];
  float* xs = smem;                    // [BK][XS], x tile transposed
  float* ws = xs + BK * XS;            // [BK][BN], dequantized W tile
  float* as = ws + BK * BN;            // [BK][RP], A tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // the thread's 4 x 4 patch
  const int xr = tid / 4, xc = tid % 4;     // its share of x . A
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = N / 2;
  const int nblk = N / qblock;
  if (tid < 16) book[tid] = code[tid];

  float acc[4][4] = {};
  float xa[RP / 4] = {};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile -> xs[kk][m] in f32
    constexpr int W = Chunk<T>::N;
    if (xvec) {
      for (int c = tid; c < BM * BK / W; c += kThreads) {
        const int m = c / (BK / W), kk = (c % (BK / W)) * W;
        float v[W] = {};
        if (m0 + m < M && k0 + kk < K) {
          const Chunk<T> ch = *reinterpret_cast<const Chunk<T>*>(
              x + static_cast<long long>(m0 + m) * K + k0 + kk);
#pragma unroll
          for (int i = 0; i < W; ++i) v[i] = to_f(ch.v[i]);
        }
#pragma unroll
        for (int i = 0; i < W; ++i) xs[(kk + i) * XS + m] = v[i];
      }
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int m = e / BK, kk = e % BK;
        xs[kk * XS + m] = (m0 + m < M && k0 + kk < K)
            ? to_f(x[static_cast<long long>(m0 + m) * K + k0 + kk]) : 0.0f;
      }
    }
    // codes -> ws[kk][c]: thread owns row kk, columns [c0, c0 + 8)
    {
      const int kk = tid / 8, c0 = (tid % 8) * 8;
      const int k = k0 + kk, n = n0 + c0;
      float v[8] = {};
      if (k < K && n < N) {
        const uint8_t* row = wq + static_cast<long long>(k) * half;
        uint32_t bytes = 0;            // byte i of the 4 in bits 8i..8i+7
        if (wvec && n + 8 <= N) {
          bytes = *reinterpret_cast<const uint32_t*>(row + n / 2);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n + 2 * i < N)
              bytes |= static_cast<uint32_t>(row[n / 2 + i]) << (8 * i);
        }
        const float* am = absmax + static_cast<long long>(k) * nblk;
        int blk = n / qblock, rem = n - blk * qblock;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (n + i < N) {
            const uint32_t byte = (bytes >> (8 * (i / 2))) & 0xFFu;
            v[i] = book[i % 2 == 0 ? byte >> 4 : byte & 0xFu] * am[blk];
          }
          if (++rem == qblock) {
            rem = 0;
            ++blk;
          }
        }
      }
      float4* dst = reinterpret_cast<float4*>(ws + kk * BN + c0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    // A tile -> as[kk][j]
    for (int e = tid; e < BK * RP; e += kThreads) {
      const int kk = e / RP, j = e % RP;
      as[e] = (k0 + kk < K && j < r)
          ? la[static_cast<long long>(k0 + kk) * r + j] : 0.0f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(xs + kk * XS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(ws + kk * BN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      const float xm = xs[kk * XS + xr];
#pragma unroll
      for (int j = 0; j < RP / 4; ++j)
        xa[j] = fmaf(xm, as[kk * RP + xc + 4 * j], xa[j]);
    }
    __syncthreads();
  }

  // epilogue: y = acc + s . (x . A) . B
  float* xas = smem;                   // [BM][RP + 1]
  float* bs = xas + BM * (RP + 1);     // [RP][BN]
#pragma unroll
  for (int j = 0; j < RP / 4; ++j) xas[xr * (RP + 1) + xc + 4 * j] = xa[j];
  for (int e = tid; e < RP * BN; e += kThreads) {
    const int j = e / BN, c = e % BN;
    bs[e] = (j < r && n0 + c < N)
        ? lb[static_cast<long long>(j) * N + n0 + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) break;
      float lora = 0.0f;
#pragma unroll
      for (int q = 0; q < RP; ++q)
        lora = fmaf(xas[(ty * 4 + i) * (RP + 1) + q], bs[q * BN + tx * 4 + j],
                    lora);
      from_f(acc[i][j] + s * lora, y + static_cast<long long>(m) * N + n);
    }
  }
}

template <typename T>
int launch_rank(int rp, const void* x, const void* wq, const void* absmax,
                const void* la, const void* lb, const void* code, void* y,
                int M, int N, int K, int r, int qblock, float s, int xvec,
                int wvec, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return -1;
#define QLORA_CASE(R)                                                      \
  case R:                                                                  \
    qlora_kernel<T, R><<<grid, kThreads, 0, st>>>(                         \
        static_cast<const T*>(x), static_cast<const uint8_t*>(wq),         \
        static_cast<const float*>(absmax), static_cast<const float*>(la),  \
        static_cast<const float*>(lb), static_cast<const float*>(code),    \
        static_cast<T*>(y), M, N, K, r, qblock, s, xvec, wvec);            \
    return 0;
  switch (rp) {
    QLORA_CASE(4)
    QLORA_CASE(8)
    QLORA_CASE(16)
    QLORA_CASE(32)
    QLORA_CASE(64)
    default:
      return -1;
  }
#undef QLORA_CASE
}

}  // namespace

// x (M, K) of x_bf16 ? bf16 : f32 and y (M, N) of the same type; wq (K,
// N/2) u8; absmax (K, N/qblock), la (K, r), lb (r, N), code (16) f32; all
// contiguous.  1 <= r <= 64, N % qblock == 0, N even.  xvec / wvec as the
// kernel's.
extern "C" int qm_qlora_matmul(const void* x, int x_bf16, const void* wq,
                               const void* absmax, const void* la,
                               const void* lb, const void* code, void* y,
                               int M, int N, int K, int r, int qblock,
                               float s, int xvec, int wvec, void* stream) {
  if (M < 1 || N < 2 || K < 1 || r < 1 || r > 64 || qblock < 1 ||
      N % 2 != 0 || N % qblock != 0)
    return -1;
  int rp = 4;
  while (rp < r) rp *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      x_bf16 ? launch_rank<__nv_bfloat16>(rp, x, wq, absmax, la, lb, code, y,
                                          M, N, K, r, qblock, s, xvec, wvec,
                                          st)
             : launch_rank<float>(rp, x, wq, absmax, la, lb, code, y, M, N, K,
                                  r, qblock, s, xvec, wvec, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
