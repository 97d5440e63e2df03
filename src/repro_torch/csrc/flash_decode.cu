// Split-KV flash-decode for Hopper (sm_90a): one decode token per request
// against a contiguous ring cache or a paged block pool.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (contiguous ring) and ::_flash_decode_paged (paged pool), body ::_kernel.
//
// Work split.  One thread block per (split, kv_head, batch row).  The split
// covers a contiguous range of logical slots; the block's 8 warps walk it
// 4 slots per warp per iteration, each warp keeping its own online-softmax
// state (m, l, acc) for the G = H / Hk queries of its KV head.  The loop
// inside the block replaces the TPU's sequential grid axis and its VMEM
// scratch carry; at the end the warps merge through shared memory and the
// block writes one (m, l, acc) partial per query.  The cross-split combine
// stays in the PyTorch wrapper, as the reference keeps it outside Pallas.
//
// Bound on the H100: bytes.  Every valid slot's K and V row is read once
// (2 * Hk * D * elem bytes per slot); the arithmetic is 4 * G * D flops per
// slot and head, far below the card's ratio of ~295 flops per byte.  The
// design therefore keeps loads wide (8 bytes per lane for a bf16 row of
// 128), keeps several rows in flight per warp, and never loads a row whose
// slot the mask drops (empty ring slots, ungranted table entries, slots
// outside the window).
//
// Semantics kept from the reference:
//   * the mask comes from the slot positions kv_pos exactly as _slot_mask
//     does (causal / prefix / full, window, kv_pos < 0 == empty);
//   * the finite fill -1e30: a row with no valid slot ends with m = -1e30,
//     l = 0, acc = 0, which the combine turns into an exact 0, never NaN;
//   * int8 caches are dequantized at load time from the per-slot, per-head
//     bf16 absmax scales; scores are f32 throughout.
//
// Plain C interface, loaded with ctypes.  Every entry point returns
// cudaGetLastError() after its launch, or -1 for a shape or type the
// kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;          // slots in flight per warp
constexpr float kNeg = -1e30f;      // finite mask fill (see header)

enum Kind { kCausal = 0, kPrefix = 1, kFull = 2 };
enum KvType { kBf16 = 0, kF32 = 1, kInt8 = 2 };

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// N consecutive elements at p (aligned to N elements) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(x.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// _slot_mask of the reference for one slot.
__device__ __forceinline__ bool slot_keep(int kp, int qp, int plen, int kind,
                                          int window) {
  bool m;
  if (kind == kCausal) {
    m = kp <= qp;
  } else if (kind == kPrefix) {
    m = (kp <= qp) || (kp < plen);
  } else {
    m = true;
  }
  if (window > 0 && kind != kFull) m = m && (qp - kp < window);
  return m && kp >= 0;
}

template <typename KT, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const void* __restrict__ q_raw, int q_f32,
                    const KT* __restrict__ k, const KT* __restrict__ v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ tbl,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ prefix_len,
                    float* __restrict__ out_m, float* __restrict__ out_l,
                    float* __restrict__ out_acc, int Hk, int S, int bs, int T,
                    int n_splits, int split_len, int kind, int window,
                    float softcap, float scale) {
  constexpr int EPL = D / 32;       // elements of a row per lane
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool quant = k_scale != nullptr;

  // The G queries of KV head h: heads h*G .. h*G+G-1 of row b.
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t off = (static_cast<size_t>(b) * Hk * G + h * G + g) * D +
                       lane * EPL;
    if (q_f32) {
      load_row<float, EPL>(static_cast<const float*>(q_raw) + off, qr[g]);
    } else {
      load_row<__nv_bfloat16, EPL>(
          static_cast<const __nv_bfloat16*>(q_raw) + off, qr[g]);
    }
  }
  const int qp = q_pos[b];
  const int plen = prefix_len[b];
  const int s_log = PAGED ? T * bs : S;
  const int begin = split * split_len;
  const int end = min(begin + split_len, s_log);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  for (int base = begin + warp * kUnroll; base < end;
       base += kWarps * kUnroll) {
    // Resolve the warp's slots to physical rows; every lane computes the
    // same answer, so the branches below are warp-uniform.
    size_t row[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      ok[u] = false;
      row[u] = 0;
      if (t < end) {
        if (PAGED) {
          const int e = tbl[static_cast<size_t>(b) * T + t / bs];
          if (e >= 0) {           // ungranted entries are dropped wholesale
            row[u] = static_cast<size_t>(e) * bs + t % bs;
            ok[u] = true;
          }
        } else {
          row[u] = static_cast<size_t>(b) * S + t;
          ok[u] = true;
        }
        if (ok[u]) ok[u] = slot_keep(kv_pos[row[u]], qp, plen, kind, window);
      }
    }
    float kr[kUnroll][EPL], vr[kUnroll][EPL], ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ks[u] = 1.f;
      vs[u] = 1.f;
      if (ok[u]) {
        const size_t hr = row[u] * Hk + h;
        load_row<KT, EPL>(k + hr * D + lane * EPL, kr[u]);
        load_row<KT, EPL>(v + hr * D + lane * EPL, vr[u]);
        if (quant) {
          ks[u] = __bfloat162float(k_scale[hr]);
          vs[u] = __bfloat162float(v_scale[hr]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = kNeg;
        if (ok[u]) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) d += qr[g][i] * kr[u][i];
          float x = warp_sum(d) * ks[u] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[u] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) {                // masked p is exactly 0: skipped
          const float p = expf(s[u] - mx);
          l[g] += p;
          const float pv = p * vs[u];
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] += pv * vr[u][i];
        }
      }
      m[g] = mx;
    }
  }

  // Merge the warps' states: out = sum_w exp(m_w - M) * (l_w, acc_w).
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    const size_t o = ((static_cast<size_t>(b) * Hk + h) * n_splits + split) *
                         G + g;
    out_acc[o * D + d] = A;
    if (d == 0) {
      out_m[o] = M;
      out_l[o] = L;
    }
  }
}

template <typename KT, int D, int G, bool PAGED>
int launch(const void* q, int q_f32, const void* k, const void* v,
           const void* k_scale, const void* v_scale, const int* kv_pos,
           const int* tbl, const int* q_pos, const int* prefix_len,
           float* out_m, float* out_l, float* out_acc, int B, int Hk, int S,
           int bs, int T, int n_splits, int split_len, int kind, int window,
           float softcap, float scale, cudaStream_t stream) {
  const dim3 grid(n_splits, Hk, B);
  flash_decode_kernel<KT, D, G, PAGED><<<grid, kThreads, 0, stream>>>(
      q, q_f32, static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), kv_pos, tbl, q_pos,
      prefix_len, out_m, out_l, out_acc, Hk, S, bs, T, n_splits, split_len,
      kind, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Instantiated only for the head geometries of the ported configurations:
// G = 2 (qwen3-0.6b and its smoke config), D = 128 (full width) or 64
// (smoke), for each cache type and layout -- 12 kernels.  A configuration
// with another G or D adds its case here.
extern "C" int fd_flash_decode(
    const void* q, int q_f32, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const int* kv_pos,
    const int* tbl, const int* q_pos, const int* prefix_len, float* out_m,
    float* out_l, float* out_acc, int B, int Hk, int G, int D, int S, int bs,
    int T, int n_splits, int split_len, int kind, int window, float softcap,
    float scale, int kv_type, int paged, void* stream) {
  if (kv_type == kInt8 && (k_scale == nullptr || v_scale == nullptr))
    return -1;
  if (kv_type != kInt8 && (k_scale != nullptr || v_scale != nullptr))
    return -1;
  if (paged && tbl == nullptr) return -1;
  if (G != 2 || (D != 64 && D != 128)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_LAUNCH(KT, DD, PG)                                                \
  return launch<KT, DD, 2, PG>(q, q_f32, k, v, k_scale, v_scale, kv_pos,     \
                               tbl, q_pos, prefix_len, out_m, out_l,        \
                               out_acc, B, Hk, S, bs, T, n_splits,          \
                               split_len, kind, window, softcap, scale, st)
#define FD_LAYOUT(KT, DD)               \
  if (paged) FD_LAUNCH(KT, DD, true);   \
  FD_LAUNCH(KT, DD, false)
#define FD_HEAD_DIM(KT)                 \
  if (D == 128) { FD_LAYOUT(KT, 128); } \
  FD_LAYOUT(KT, 64)
  switch (kv_type) {
    case kBf16: { FD_HEAD_DIM(__nv_bfloat16); }
    case kF32: { FD_HEAD_DIM(float); }
    case kInt8: { FD_HEAD_DIM(int8_t); }
    default:
      return -1;
  }
#undef FD_HEAD_DIM
#undef FD_LAYOUT
#undef FD_LAUNCH
}
