// Flash attention for Hopper (sm_90a): causal or full, online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body ::_kernel).  q, k, v, o are (B, H, S, D), f32 or bf16 (one type), D
// 64 or 128.  Per query row, in f32:
//
//   s_j = (q . k_j) * D^-0.5,  masked to -FLT_MAX (finite) where j > i under
//   the causal mask;  o = sum_j softmax(s)_j v_j,  divided at the end by
//   max(l, 1e-30);  o is written in q's type.
//
// Bound on the H100: bytes at the federated fit's shape (8 series x 32
// heads, S 63, D 128, bf16: 16.5 MB, 4.9 us at 3.35 TB/s, against 0.26
// GFLOP), operations at long S (the reference benchmark's 4 x 8 x 1024 x 128
// f32 does 8.6 GFLOP causal, 0.13 ms at the f32 rate of 67 TFLOP/s).  This
// first kernel keeps the TPU kernel's f32 arithmetic on the CUDA cores.
//
// Design: one 256-thread block owns one (b, h) and a tile of 64 query rows,
// and loops over key tiles of 64 (the TPU grid's sequential KV axis and its
// m / l / acc scratch become this loop and registers).  Each tile's K and V
// are converted to f32 once into shared memory (64 KB at D 128, dynamic) and
// read by all 64 rows.  Four neighbouring lanes share a query row: lane g of
// the four owns the row's 16-byte chunks g, g + 4, ... of q and of the f32
// accumulator, so the four read 64 consecutive bytes of a key row and the
// eight rows of a warp read the same key (a broadcast).  Keys go 16 at a
// time: partial dots, two shuffles to sum them across the four lanes, one
// online-softmax rescale per 16 keys, then p . V.  Under the causal mask the
// key tiles wholly above the block's last row are skipped (the TPU kernel
// visits them masked; their probabilities underflow to exactly 0, so
// skipping changes nothing), and the blocks with the most tiles are started
// first.  A ragged S needs no padding: keys past S read as zeros with the
// mask fill, query rows past S are not written.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 64;       // keys a shared-memory tile
constexpr int KC = 16;        // keys a softmax step
constexpr float kFill = -FLT_MAX;   // the reference's finfo(f32).min

// four consecutive values of p as a float4
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       float scale) {
  constexpr int NC = D / 16;          // 16-byte f32 chunks a lane owns
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [BKV][D]
  float* vs = smem + BKV * D;         // [BKV][D]

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest first
  const long long head = static_cast<long long>(blockIdx.y) * S * D;
  const int q0 = tile * BQ;
  const int row = threadIdx.x / 4, g = threadIdx.x % 4;
  const int qi = q0 + row;

  float4 qv[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qv[c] = qi < S ? load4(q + head + static_cast<long long>(qi) * D +
                           (g + 4 * c) * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kFill, l = 0.0f;

  const int kv_end = CAUSAL ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                  // the last tile's readers are done
    for (int e = threadIdx.x; e < BKV * D / 4; e += kThreads) {
      const int j = e / (D / 4), d = (e % (D / 4)) * 4;
      const long long off = head + static_cast<long long>(k0 + j) * D + d;
      const bool in = k0 + j < S;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(ks + j * D + d, in ? load4(k + off) : z);
      store4(vs + j * D + d, in ? load4(v + off) : z);
    }
    __syncthreads();

    const int n_keys = min(BKV, kv_end - k0);
    for (int j0 = 0; j0 < n_keys; j0 += KC) {
      float sc[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* kr = ks + (j0 + j) * D + g * 4;
        float p = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kk = load4(kr + 16 * c);
          p = fmaf(qv[c].x, kk.x, p);
          p = fmaf(qv[c].y, kk.y, p);
          p = fmaf(qv[c].z, kk.z, p);
          p = fmaf(qv[c].w, kk.w, p);
        }
        sc[j] = p;
      }
      float mc = kFill;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float p = sc[j];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        const int kj = k0 + j0 + j;
        p = (kj < S && (!CAUSAL || kj <= qi)) ? p * scale : kFill;
        sc[j] = p;
        mc = fmaxf(mc, p);
      }
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 a = acc[c];
        a.x *= corr;
        a.y *= corr;
        a.z *= corr;
        a.w *= corr;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float4 vv = load4(vs + (j0 + j) * D + (g + 4 * c) * 4);
          a.x = fmaf(sc[j], vv.x, a.x);
          a.y = fmaf(sc[j], vv.y, a.y);
          a.z = fmaf(sc[j], vv.z, a.z);
          a.w = fmaf(sc[j], vv.w, a.w);
        }
        acc[c] = a;
      }
    }
  }

  if (qi >= S) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 a = acc[c];
    store4(o + head + static_cast<long long>(qi) * D + (g + 4 * c) * 4,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, float scale, cudaStream_t st) {
  constexpr int kSmem = 2 * BKV * D * static_cast<int>(sizeof(float));
  // Raise the dynamic shared memory limit once a device, outside any
  // CUDA-graph capture that later launches may be part of.
  static bool ready[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (!ready[dev]) {
    if (cudaFuncSetAttribute(flash_attention_kernel<T, D, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    ready[dev] = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_attention_kernel<T, D, CAUSAL><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, scale);
  return 0;
}

template <typename T>
int launch_d(int D, int causal, const void* q, const void* k, const void* v,
             void* o, int BH, int S, float scale, cudaStream_t st) {
  if (D == 64)
    return causal ? launch<T, 64, true>(q, k, v, o, BH, S, scale, st)
                  : launch<T, 64, false>(q, k, v, o, BH, S, scale, st);
  if (D == 128)
    return causal ? launch<T, 128, true>(q, k, v, o, BH, S, scale, st)
                  : launch<T, 128, false>(q, k, v, o, BH, S, scale, st);
  return -1;
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, of one type (bf16:
// bf16, else f32); D in {64, 128}; scale = D^-0.5.
extern "C" int fa_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int bf16, int BH,
                                  int S, int D, int causal, float scale,
                                  void* stream) {
  if (BH < 1 || BH > 65535 || S < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      bf16 ? launch_d<__nv_bfloat16>(D, causal, q, k, v, o, BH, S, scale, st)
           : launch_d<float>(D, causal, q, k, v, o, BH, S, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
