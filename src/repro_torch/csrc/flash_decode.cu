// Flash-decode for Hopper (sm_90a): one decode token per request against a
// contiguous ring cache (ring_decode_kernel) or a paged block pool
// (flash_decode_kernel).
//
// Replaces the TPU kernels repro/kernels/flash_decode.py::flash_decode
// (contiguous ring) and ::_flash_decode_paged (paged pool), body ::_kernel.
//
// Both are bound by bytes on the H100: every valid slot's K and V row is
// read once (2 * Hk * D * elem bytes per slot), against 4 * G * D flops per
// slot and head, far below the card's ~295 flops per byte.  What limits a
// decode call at the main path's sizes is how many of those bytes are in
// flight: the fixed batch's ring (B=4, Hk=8, 576 slots, bf16) is 9.4 MB,
// 2.8 us at 3.35 TB/s, spread over only B * Hk = 32 (row, head) pairs.
//
// Ring kernel.  The design answers that bound in three ways:
//   * splits chosen for the card: the wrapper (_ring_splits in
//     kernels/flash_decode.py) cuts each (row, head)'s slots into up to 8
//     contiguous splits so that about two blocks of a few dozen slots or
//     more run on each of the 132 SMs (256 blocks of 72 slots at the fixed
//     batch), and fewer where the card could not hold every (row, head)'s
//     cluster at once (fd_ring_max_clusters);
//   * loads in flight: a lane group of D * elem / 16 lanes (16 for a bf16
//     row of 128) owns a slot, each lane one 16-byte vector of its K and V
//     rows, so a warp takes several slots per load; each warp keeps two
//     register buffers of U = 4 slots per lane group and issues the next
//     pass's rows before it computes on the current one, so a pass's loads
//     wait behind one memory latency, not one per slot (the slot positions,
//     which decide what is loaded, are read one pass earlier still); a dot
//     product is summed over the group's lanes only (4 shuffles for bf16
//     D 128);
//   * the combine folded into the launch: the splits of one (row, head) are
//     one thread-block cluster (launched with cudaLaunchKernelEx).  Each
//     block merges its warps' online-softmax states through shared memory;
//     then block 0 of the cluster reads every block's (m, l, acc) through
//     distributed shared memory in split order and writes the (B, 1, H, D)
//     output in q's type, or the merged f32 partials.  One launch a call,
//     no other device work, the same result run to run.
// q_pos and prefix_len are read in place (a stride of 0 for a scalar) or
// passed as values; a 1-D kv_pos is read with a row stride of 0.
//
// Paged kernel (unchanged from the first port; its redesign is later
// work).  One 256-thread block per (split, kv_head, batch row); the split
// covers a contiguous range of logical slots, resolved through the block
// table; 8 warps walk it 4 slots per warp per iteration, each with its own
// online-softmax state for the G = H / Hk queries of its KV head, merged
// through shared memory into one (m, l, acc) partial per split.  The
// cross-split combine stays in the PyTorch wrapper.
//
// Semantics kept from the reference, in both kernels:
//   * the mask comes from the slot positions kv_pos exactly as _slot_mask
//     does (causal / prefix / full, window, kv_pos < 0 == empty); a row
//     whose slot the mask drops is never loaded;
//   * the finite fill -1e30: a row with no valid slot ends with m = -1e30,
//     l = 0, acc = 0, which the combine turns into an exact 0, never NaN;
//   * int8 caches are dequantized at load time from the per-slot, per-head
//     bf16 absmax scales; scores are f32 throughout; softcap is kept.
//
// Head geometries: both kernels are instantiated for the (G, D) pairs of
// the ported configurations only (with_heads below): G = 2 with D 64
// (qwen3-0.6b's smoke config) or 128 (qwen3-0.6b), and G = 1 (multi-head
// attention) with D 32 (fedtime-llama2-7b's smoke config) or 128
// (fedtime-llama2-7b), each for the three cache types: 12 kernels each.  A
// ring slot is owned by a lane group of D * elem / 16 lanes, which at D 32
// is 4 lanes for bf16, 8 for f32 and 2 for int8; the dot products are
// summed over the group by xor shuffles of LPS / 2 .. 1 and the groups of a
// warp merged by shuffles of LPS .. 16, which holds for any LPS that
// divides 32.
//
// Plain C interface, loaded with ctypes.  Every entry point returns
// cudaGetLastError() (or the launch's own error) after its launch, or -1
// for a shape, head geometry or type the kernels are not built for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

template <typename KT, int D, int G>
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
                    float* __restrict__ out_acc, int Hk, int bs, int T,
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
  const int begin = split * split_len;
  const int end = min(begin + split_len, T * bs);

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
        const int e = tbl[static_cast<size_t>(b) * T + t / bs];
        if (e >= 0) {             // ungranted entries are dropped wholesale
          row[u] = static_cast<size_t>(e) * bs + t % bs;
          ok[u] = slot_keep(kv_pos[row[u]], qp, plen, kind, window);
        }
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

template <typename KT, int D, int G>
int launch(const void* q, int q_f32, const void* k, const void* v,
           const void* k_scale, const void* v_scale, const int* kv_pos,
           const int* tbl, const int* q_pos, const int* prefix_len,
           float* out_m, float* out_l, float* out_acc, int B, int Hk, int bs,
           int T, int n_splits, int split_len, int kind, int window,
           float softcap, float scale, cudaStream_t stream) {
  const dim3 grid(n_splits, Hk, B);
  flash_decode_kernel<KT, D, G><<<grid, kThreads, 0, stream>>>(
      q, q_f32, static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), kv_pos, tbl, q_pos,
      prefix_len, out_m, out_l, out_acc, Hk, bs, T, n_splits, split_len,
      kind, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Ring kernel
// ---------------------------------------------------------------------------

constexpr int kRingWarps = 4;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kRingUnroll = 4;      // slots a lane group holds per buffer
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr unsigned kFull32 = 0xffffffffu;

// The 16 / sizeof(KT) elements of a 16-byte vector as floats (exact).
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
// int8: byte b + 128 placed in the mantissa of 2**23 (a byte permute),
// then 2**23 + 128 taken off: exact, and at the float add's rate rather
// than the int-to-float converter's.
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[16]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;          // b + 128, per byte
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(u, 0x4b000000u, j | 0x7440)) -
          8388736.0f;
  }
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One pass's worth of a lane group's slots: its lane's 16 bytes of each
// slot's K and V row, the int8 scales' bf16 bits (1.0 for other caches),
// and whether the mask keeps the slot.  Nothing here is converted where it
// is loaded: a use of a loaded value would stall the warp until it came.
template <int U>
struct RingBuf {
  uint4 k[U], v[U];
  unsigned short ks[U], vs[U];
  bool ok[U];
};

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

template <typename KT, int D, int G>
__global__ void __launch_bounds__(kRingThreads)
ring_decode_kernel(const void* __restrict__ q_raw, int q_f32,
                   const KT* __restrict__ k, const KT* __restrict__ v,
                   const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale,
                   const int* __restrict__ kv_pos, long long kvp_stride,
                   const int* __restrict__ q_pos, int q_pos_stride,
                   int q_pos_val, const int* __restrict__ prefix_len,
                   int plen_stride, int plen_val, void* __restrict__ out,
                   float* __restrict__ out_m, float* __restrict__ out_l,
                   float* __restrict__ out_acc, int Hk, int S, int kind,
                   int window, float softcap, float scale) {
  constexpr int VE = 16 / static_cast<int>(sizeof(KT));  // elems a vector
  constexpr int LPS = D / VE;                             // lanes a slot
  constexpr int SPW = 32 / LPS;                           // slots a load
  constexpr int U = kRingUnroll;
  constexpr int kPass = kRingWarps * SPW * U;             // slots a pass
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "lane groups");

  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPS;         // the lane group: one slot at a time
  const int c = lane % LPS;           // the lane's vector of the row
  const bool quant = k_scale != nullptr;
  const int H = Hk * G;

  // The lane's VE elements of the G queries of KV head h.
  float qr[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t off = (static_cast<size_t>(b) * H + h * G + g) * D + c * VE;
#pragma unroll
    for (int i = 0; i < VE; ++i)
      qr[g][i] = q_f32 ? static_cast<const float*>(q_raw)[off + i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(
                             q_raw)[off + i]);
  }
  const int qp = q_pos ? q_pos[static_cast<long long>(b) * q_pos_stride]
                       : q_pos_val;
  const int plen = prefix_len
                       ? prefix_len[static_cast<long long>(b) * plen_stride]
                       : plen_val;
  // balanced splits: every split of a ring of S >= n_splits slots is
  // non-empty
  const int begin = static_cast<int>(static_cast<long long>(split) * S /
                                     n_splits);
  const int end = static_cast<int>(static_cast<long long>(split + 1) * S /
                                   n_splits);
  const int* kvp = kv_pos + b * kvp_stride;
  const size_t row0 = static_cast<size_t>(b) * S;

  float m[G], l[G], acc[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[g][i] = 0.f;
  }

  // The slot positions of pass `pass` (-1 past the split's end).
  auto load_pos = [&](int (&kp)[U], int pass) {
    const int base = begin + pass * kPass + warp * (SPW * U) + grp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * SPW;
      kp[u] = t < end ? __ldg(kvp + t) : -1;
    }
  };

  // Start the loads of pass `pass` from its positions: the K / V rows (and
  // scales) of the slots the mask keeps; a dropped slot reads zeros.
  auto issue = [&](RingBuf<U>& f, const int (&kp)[U], int pass) {
    const int base = begin + pass * kPass + warp * (SPW * U) + grp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t hr = (row0 + base + u * SPW) * Hk + h;
      f.ok[u] = slot_keep(kp[u], qp, plen, kind, window);
      f.k[u] = make_uint4(0u, 0u, 0u, 0u);
      f.v[u] = f.k[u];
      f.ks[u] = 0x3f80;               // bf16 1.0
      f.vs[u] = 0x3f80;
      if (f.ok[u]) {
        f.k[u] = load16(k + hr * D + c * VE);
        f.v[u] = load16(v + hr * D + c * VE);
        if (quant) {
          f.ks[u] = __ldg(reinterpret_cast<const unsigned short*>(k_scale) +
                          hr);
          f.vs[u] = __ldg(reinterpret_cast<const unsigned short*>(v_scale) +
                          hr);
        }
      }
    }
  };

  // The online-softmax step over one pass's slots.
  auto consume = [&](const RingBuf<U>& f) {
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VE];
      unpack(f.k[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VE; ++i) d = fmaf(qr[g][i], kf[i], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int o = LPS / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(kFull32, s[u][g], o);
    float p[U][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (f.ok[u]) {
          float x = s[u][g] * bf16_bits(f.ks[u]) * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[u][g] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
        p[u][g] = f.ok[u] ? expf(s[u][g] - mx) : 0.f;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (f.ok[u]) {                  // masked p is exactly 0: skipped
        float vf[VE];
        unpack(f.v[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          l[g] += p[u][g];
          const float pv = p[u][g] * bf16_bits(f.vs[u]);
#pragma unroll
          for (int i = 0; i < VE; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
        }
      }
    }
  };

  // Two register buffers: the next pass's rows are in flight while the
  // current pass is consumed, and the positions of the pass after it, so
  // that no load of a pass waits on another load of the same pass.
  const int n_pass = (end - begin + kPass - 1) / kPass;
  RingBuf<U> fa, fb;
  int pa[U], pb[U];
  load_pos(pa, 0);
  load_pos(pb, 1);
  if (n_pass > 0) issue(fa, pa, 0);
  for (int pass = 0; pass < n_pass; pass += 2) {
    if (pass + 1 < n_pass) issue(fb, pb, pass + 1);
    load_pos(pa, pass + 2);
    consume(fa);
    if (pass + 1 >= n_pass) break;
    if (pass + 2 < n_pass) issue(fa, pa, pass + 2);
    load_pos(pb, pass + 3);
    consume(fb);
  }

  // Merge the lane groups of each warp (lanes c, c + LPS, ...).
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = m[g];
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull32, M, o));
    const float cr = expf(m[g] - M);
    float L = l[g] * cr;
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) L += __shfl_xor_sync(kFull32, L, o);
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      float a = acc[g][i] * cr;
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) a += __shfl_xor_sync(kFull32, a, o);
      acc[g][i] = a;
    }
    m[g] = M;
    l[g] = L;
  }

  // Merge the warps into the block's partial, in warp order.
  __shared__ float sm_m[kRingWarps][G];
  __shared__ float sm_l[kRingWarps][G];
  __shared__ float sm_acc[kRingWarps][G][D];
  __shared__ float part_m[G];
  __shared__ float part_l[G];
  __shared__ float part_acc[G][D];
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) sm_acc[warp][g][c * VE + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kRingThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) {
      const float cr = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * cr;
      A += sm_acc[w][g][d] * cr;
    }
    part_acc[g][d] = A;
    if (d == 0) {
      part_m[g] = M;
      part_l[g] = L;
    }
  }

  // Merge the cluster's splits in split order, in block 0, through
  // distributed shared memory; the second barrier keeps every block's
  // shared memory alive until block 0 has read it.
  cluster.sync();
  if (split == 0) {
    for (int idx = threadIdx.x; idx < G * D; idx += kRingThreads) {
      const int g = idx / D;
      const int d = idx % D;
      float mr[kMaxCluster];
      float M = kNeg;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mr[r] = r < n_splits ? *cluster.map_shared_rank(&part_m[g], r) : kNeg;
        M = fmaxf(M, mr[r]);
      }
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < n_splits) {
          const float cr = expf(mr[r] - M);
          L += *cluster.map_shared_rank(&part_l[g], r) * cr;
          A += *cluster.map_shared_rank(&part_acc[g][d], r) * cr;
        }
      }
      // (B, 1, H, D) and (B, Hk, G, D) share one index
      const size_t o = (static_cast<size_t>(b) * Hk + h) * G + g;
      if (out_acc != nullptr) {
        out_acc[o * D + d] = A;
        if (d == 0) {
          out_m[o] = M;
          out_l[o] = L;
        }
      } else {
        const float y = A / fmaxf(L, 1e-30f);
        if (q_f32)
          static_cast<float*>(out)[o * D + d] = y;
        else
          static_cast<__nv_bfloat16*>(out)[o * D + d] =
              __float2bfloat16_rn(y);
      }
    }
  }
  cluster.sync();
}

template <typename KT, int D, int G>
int launch_ring(const void* q, int q_f32, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const int* kv_pos,
                long long kvp_stride, const int* q_pos, int q_pos_stride,
                int q_pos_val, const int* prefix_len, int plen_stride,
                int plen_val, void* out, float* out_m, float* out_l,
                float* out_acc, int B, int Hk, int S, int n_splits, int kind,
                int window, float softcap, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, Hk, B);
  cfg.blockDim = dim3(kRingThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, ring_decode_kernel<KT, D, G>, q, q_f32,
      static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), kv_pos, kvp_stride, q_pos,
      q_pos_stride, q_pos_val, prefix_len, plen_stride, plen_val, out, out_m,
      out_l, out_acc, Hk, S, kind, window, softcap, scale);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of n_splits ring blocks the device can hold at once.
template <typename KT, int D, int G>
int ring_max_clusters(int n_splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, 1, 1);
  cfg.blockDim = dim3(kRingThreads, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, ring_decode_kernel<KT, D, G>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
struct Tag {
  using type = T;
};
template <int V>
using IntC = std::integral_constant<int, V>;

// fn(Tag<KT>) for the cache type's element type; -1 for another type.
template <typename Fn>
int with_kv_type(int kv_type, Fn&& fn) {
  switch (kv_type) {
    case kBf16: return fn(Tag<__nv_bfloat16>{});
    case kF32: return fn(Tag<float>{});
    case kInt8: return fn(Tag<int8_t>{});
    default: return -1;
  }
}

// fn(IntC<D>, IntC<G>) for an instantiated head geometry; -1 for another.
template <typename Fn>
int with_heads(int G, int D, Fn&& fn) {
  if (G == 2 && D == 64) return fn(IntC<64>{}, IntC<2>{});
  if (G == 2 && D == 128) return fn(IntC<128>{}, IntC<2>{});
  if (G == 1 && D == 32) return fn(IntC<32>{}, IntC<1>{});
  if (G == 1 && D == 128) return fn(IntC<128>{}, IntC<1>{});
  return -1;
}

}  // namespace

// The paged pool: per-split f32 partials out_m, out_l (B, Hk, n_splits, G)
// and out_acc (B, Hk, n_splits, G, D); (G, D) one of with_heads' pairs.
extern "C" int fd_flash_decode_paged(
    const void* q, int q_f32, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const int* kv_pos,
    const int* tbl, const int* q_pos, const int* prefix_len, float* out_m,
    float* out_l, float* out_acc, int B, int Hk, int G, int D, int bs, int T,
    int n_splits, int split_len, int kind, int window, float softcap,
    float scale, int kv_type, void* stream) {
  if (kv_type == kInt8 && (k_scale == nullptr || v_scale == nullptr))
    return -1;
  if (kv_type != kInt8 && (k_scale != nullptr || v_scale != nullptr))
    return -1;
  if (tbl == nullptr) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kv_type(kv_type, [&](auto kt) {
    using KT = typename decltype(kt)::type;
    return with_heads(G, D, [&](auto d, auto g) {
      return launch<KT, decltype(d)::value, decltype(g)::value>(
          q, q_f32, k, v, k_scale, v_scale, kv_pos, tbl, q_pos, prefix_len,
          out_m, out_l, out_acc, B, Hk, bs, T, n_splits, split_len, kind,
          window, softcap, scale, st);
    });
  });
}

// The contiguous ring: q (B, 1, H, D) bf16 / f32; k, v (B, S, Hk, D) of
// kv_type; kv_pos int32 with row stride kvp_stride (0: one (S,) row for
// every request); q_pos / prefix_len read at q_pos[b * stride] where the
// pointer is given, else the value.  Writes out (B, 1, H, D) in q's type,
// or with out == nullptr the merged f32 partials out_m, out_l (B, Hk, G)
// and out_acc (B, Hk, G, D).  n_splits in [1, min(8, S)] (one cluster per
// (row, head)); (G, D) one of with_heads' pairs.
extern "C" int fd_flash_decode_ring(
    const void* q, int q_f32, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const int* kv_pos,
    long long kvp_stride, const int* q_pos, int q_pos_stride, int q_pos_val,
    const int* prefix_len, int plen_stride, int plen_val, void* out,
    float* out_m, float* out_l, float* out_acc, int B, int Hk, int G, int D,
    int S, int n_splits, int kind, int window, float softcap, float scale,
    int kv_type, void* stream) {
  if (kv_type == kInt8 && (k_scale == nullptr || v_scale == nullptr))
    return -1;
  if (kv_type != kInt8 && (k_scale != nullptr || v_scale != nullptr))
    return -1;
  if ((out == nullptr) == (out_acc == nullptr)) return -1;
  if (out_acc != nullptr && (out_m == nullptr || out_l == nullptr)) return -1;
  if (B < 1 || B > 65535 || Hk < 1 || Hk > 65535 || S < 1) return -1;
  if (n_splits < 1 || n_splits > kMaxCluster || n_splits > S) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kv_type(kv_type, [&](auto kt) {
    using KT = typename decltype(kt)::type;
    return with_heads(G, D, [&](auto d, auto g) {
      return launch_ring<KT, decltype(d)::value, decltype(g)::value>(
          q, q_f32, k, v, k_scale, v_scale, kv_pos, kvp_stride, q_pos,
          q_pos_stride, q_pos_val, prefix_len, plen_stride, plen_val, out,
          out_m, out_l, out_acc, B, Hk, S, n_splits, kind, window, softcap,
          scale, st);
    });
  });
}

// How many clusters of n_splits ring blocks (one (row, head) each) the
// current device holds at once, for the kernel of this cache type and head
// geometry (G, D) -- the one a call with them launches; -1 on an error.
// Clusters must fit inside one GPC, so a kernel that fits few blocks an SM
// fits fewer large clusters than its blocks suggest.
extern "C" int fd_ring_max_clusters(int kv_type, int G, int D, int n_splits) {
  if (n_splits < 1 || n_splits > kMaxCluster) return -1;
  return with_kv_type(kv_type, [&](auto kt) {
    using KT = typename decltype(kt)::type;
    return with_heads(G, D, [&](auto d, auto g) {
      return ring_max_clusters<KT, decltype(d)::value, decltype(g)::value>(
          n_splits);
    });
  });
}
