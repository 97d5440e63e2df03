// Fused wire hop of the federated upload for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/ring_allreduce.py::_hop_int8_kernel
// and ::_hop_bf16_kernel (launched by _hop_pallas through fused_hop).  Per
// row of `qblock` f32 values:
//
//   acc' = acc + deq(codes)           deq: codes * scale (int8), f32 (bf16)
//   t    = acc' + res
//   int8: s = max(|t|) / 127, floored at 1e-30;  q = clip(rint(t / s), ±127)
//         send q (int8) and s;  res' = t - q * s
//   bf16: o = bf16_rn(t);  send o;  res' = t - f32(o)
//
// The quantize-only form (no codes received: the first send of a phase, and
// every host-loop upload) reads no codes or scales and adds +0.0, which is
// what the reference computes from its zero-filled codes.
//
// Bit for bit with the plain version (repro_torch/kernels/wire_hop.py):
// every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract a*b + c into
// one FMA; the scale and the code are true quotients, not products with a
// reciprocal; rounding to int is rintf (half to even, as torch.round and
// jnp.round), not roundf (half away from zero); the bf16 cast is
// __float2bfloat16_rn.  The absmax is a max, which is exact in any order.
//
// Bound on the H100: bytes.  The int8 wire reads acc, res (f32) and codes
// (int8) and writes acc, res and codes, plus a scale in and out per row:
// 4+4+1 in, 4+4+1 out = 18 B per element and 8 B per row (8.39M elements
// of LLaMA-2-7B-width adapters: 151 MB, 45 us at 3.35 TB/s).  The bf16 wire
// moves 20 B per element (two-byte codes, no scales).  Design: one warp per
// row; lane l owns the row's elements [l*PER, (l+1)*PER), PER = qblock/32,
// so with qblock 128 each lane moves one 16-byte vector of acc and of res
// and 4 (int8) or 8 (bf16) bytes of codes, and a warp's loads cover the row
// contiguously.  The row's t stays in registers between the absmax (a warp
// shuffle reduction) and the requantization, so every byte is read once and
// written once.  Rows are walked grid-stride; the last row is not padded.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// PER consecutive f32 values at p, in 16-byte loads when PER allows.
template <int PER>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&out)[PER]) {
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PER; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
      out[i + 2] = x.z;
      out[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) out[i] = p[i];
  }
}

template <int PER>
__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          const float (&in)[PER]) {
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(in[i], in[i + 1], in[i + 2], in[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) p[i] = in[i];
  }
}

// PER consecutive 1- or 2-byte codes at p, in 4- or 8-byte loads when PER
// allows.
template <int PER, typename T>
__device__ __forceinline__ void load_codes(const T* __restrict__ p,
                                           T (&out)[PER]) {
  using W = typename std::conditional<sizeof(T) == 1, char4, uint2>::type;
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<W*>(out + i) = *reinterpret_cast<const W*>(p + i);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) out[i] = p[i];
  }
}

template <int PER, typename T>
__device__ __forceinline__ void store_codes(T* __restrict__ p,
                                            const T (&in)[PER]) {
  using W = typename std::conditional<sizeof(T) == 1, char4, uint2>::type;
  if constexpr (PER % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<W*>(p + i) = *reinterpret_cast<const W*>(in + i);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) p[i] = in[i];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// INT8: the int8 wire (else bf16).  HAS_IN: codes (and scales) were
// received (else the quantize-only form).  PER: values per lane.
template <bool INT8, bool HAS_IN, int PER>
__global__ void __launch_bounds__(kThreads)
wire_hop_kernel(const float* __restrict__ acc, const void* __restrict__ codes,
                const float* __restrict__ scales,
                const float* __restrict__ res, float* __restrict__ oacc,
                void* __restrict__ ocodes, float* __restrict__ oscales,
                float* __restrict__ ores, long long rows) {
  constexpr int Q = PER * 32;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
       row < rows; row += warps) {
    const long long base = row * Q + lane * PER;
    float a[PER], r[PER];
    load_f32<PER>(acc + base, a);
    load_f32<PER>(res + base, r);
    if constexpr (HAS_IN) {
      if constexpr (INT8) {
        const float s_in = scales[row];
        alignas(4) int8_t cv[PER];
        load_codes<PER>(static_cast<const int8_t*>(codes) + base, cv);
#pragma unroll
        for (int i = 0; i < PER; ++i)
          a[i] = __fadd_rn(a[i], __fmul_rn(static_cast<float>(cv[i]), s_in));
      } else {
        alignas(8) __nv_bfloat16 cv[PER];
        load_codes<PER>(static_cast<const __nv_bfloat16*>(codes) + base, cv);
#pragma unroll
        for (int i = 0; i < PER; ++i)
          a[i] = __fadd_rn(a[i], __bfloat162float(cv[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) a[i] = __fadd_rn(a[i], 0.0f);
    }
    store_f32<PER>(oacc + base, a);

    float t[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) t[i] = __fadd_rn(a[i], r[i]);

    if constexpr (INT8) {
      float m = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) m = fmaxf(m, fabsf(t[i]));
      m = warp_max(m);
      const float s = fmaxf(__fdiv_rn(m, 127.0f), 1e-30f);
      alignas(4) int8_t q8[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float q =
            fminf(fmaxf(rintf(__fdiv_rn(t[i], s)), -127.0f), 127.0f);
        q8[i] = static_cast<int8_t>(q);
        r[i] = __fsub_rn(t[i], __fmul_rn(q, s));
      }
      store_codes<PER>(static_cast<int8_t*>(ocodes) + base, q8);
      if (lane == 0) oscales[row] = s;
    } else {
      alignas(8) __nv_bfloat16 o[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        o[i] = __float2bfloat16_rn(t[i]);
        r[i] = __fsub_rn(t[i], __bfloat162float(o[i]));
      }
      store_codes<PER>(static_cast<__nv_bfloat16*>(ocodes) + base, o);
    }
    store_f32<PER>(ores + base, r);
  }
}

template <bool INT8, bool HAS_IN>
int launch_per(int per, const float* acc, const void* codes,
               const float* scales, const float* res, float* oacc,
               void* ocodes, float* oscales, float* ores, long long rows,
               int grid, cudaStream_t st) {
#define WIRE_HOP_CASE(P)                                                   \
  case P:                                                                  \
    wire_hop_kernel<INT8, HAS_IN, P><<<grid, kThreads, 0, st>>>(           \
        acc, codes, scales, res, oacc, ocodes, oscales, ores, rows);       \
    return 0;
  switch (per) {
    WIRE_HOP_CASE(1)
    WIRE_HOP_CASE(2)
    WIRE_HOP_CASE(4)
    WIRE_HOP_CASE(8)
    WIRE_HOP_CASE(16)
    WIRE_HOP_CASE(32)
    default:
      return -1;
  }
#undef WIRE_HOP_CASE
}

}  // namespace

// int8: 1 for the int8 wire, 0 for bf16.  codes == NULL selects the
// quantize-only form (scales then unused).  qblock in {32, ..., 1024}, a
// power of two; f32 and 16-byte-aligned buffers of rows * qblock values.
extern "C" int wh_wire_hop(int int8, const void* acc, const void* codes,
                           const void* scales, const void* res, void* oacc,
                           void* ocodes, void* oscales, void* ores,
                           long long rows, int qblock, int grid,
                           void* stream) {
  if (rows < 1 || qblock < 32 || qblock > 1024 || qblock % 32 != 0 ||
      grid < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = qblock / 32;
  const float* a = static_cast<const float*>(acc);
  const float* sc = static_cast<const float*>(scales);
  const float* r = static_cast<const float*>(res);
  float* oa = static_cast<float*>(oacc);
  float* os = static_cast<float*>(oscales);
  float* orr = static_cast<float*>(ores);
  int rc;
  if (int8) {
    rc = codes ? launch_per<true, true>(per, a, codes, sc, r, oa, ocodes, os,
                                        orr, rows, grid, st)
               : launch_per<true, false>(per, a, codes, sc, r, oa, ocodes,
                                         os, orr, rows, grid, st);
  } else {
    rc = codes ? launch_per<false, true>(per, a, codes, sc, r, oa, ocodes,
                                         os, orr, rows, grid, st)
               : launch_per<false, false>(per, a, codes, sc, r, oa, ocodes,
                                          os, orr, rows, grid, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
