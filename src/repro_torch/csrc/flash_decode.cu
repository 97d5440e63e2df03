// Flash-decode for Hopper (sm_90a): one decode token per request against a
// contiguous ring cache or a paged block pool, one kernel for both
// (decode_kernel, templated on the layout).
//
// Replaces the TPU kernels repro/kernels/flash_decode.py::flash_decode
// (contiguous ring) and ::_flash_decode_paged (paged pool), body ::_kernel.
//
// Bound by bytes on the H100: every valid slot's K and V row is read once
// (2 * Hk * D * elem bytes per slot), against 4 * G * D flops per slot and
// head, far below the card's ~295 flops per byte.  What limits a decode call
// at the main path's sizes is how many of those bytes are in flight and how
// many memory trips stand between the launch and the first row: the fixed
// batch's ring (B=4, Hk=8, 576 slots, bf16) is 9.4 MB, 2.8 us at 3.35
// TB/s, spread over only B * Hk = 32 (row, head) pairs; the engine's pool
// (12 lanes of 8 table entries of 16 slots) reads 1.8 MB at G = 2.
//
// The design answers that bound in four ways:
//   * splits chosen for the card: the wrapper (_ring_splits / _paged_splits
//     in kernels/flash_decode.py) cuts each (row, head)'s slots into up to 8
//     splits so that about two blocks run on each of the 132 SMs (256
//     blocks of 72 slots at the fixed batch), and fewer where the card could
//     not hold every (row, head)'s cluster at once (fd_ring_max_clusters,
//     fd_paged_max_clusters).  A ring split is a contiguous run of slots,
//     floor(i * S / n) .. floor((i + 1) * S / n); a paged split is a run of
//     whole table entries, floor(i * T / n) .. floor((i + 1) * T / n), so
//     an uneven last split is allowed in both;
//   * loads in flight: a lane group of D * elem / 16 lanes (16 for a bf16
//     row of 128), rounded up to a power of two, owns a slot, each lane one
//     16-byte vector of its K and V rows, so a warp takes several slots per
//     load; each warp keeps two
//     register buffers of U = 4 slots per lane group and issues the next
//     pass's rows before it computes on the current one, so a pass's loads
//     wait behind one memory latency, not one per slot (the slot positions,
//     which decide what is loaded, are read one pass earlier still); a dot
//     product is summed over the group's lanes only (4 shuffles for bf16
//     D 128);
//   * the paged pool's table staged once: a block first copies its split's
//     table entries into shared memory with one coalesced load (kStage
//     entries at a time), so resolving a slot to its physical row is a
//     shared-memory read, and the pass-ahead position reads and the
//     double-buffered row loads run as on the ring.  An entry of -1 gives
//     its slots position -1: neither kv_pos nor the rows are read;
//   * the combine folded into the launch: the splits of one (row, head) are
//     one thread-block cluster (launched with cudaLaunchKernelEx).  Each
//     block merges its warps' online-softmax states through shared memory;
//     then block 0 of the cluster reads every block's (m, l, acc) through
//     distributed shared memory in split order and writes the (B, 1, H, D)
//     output in q's type, or the merged f32 partials.  One launch a call,
//     no other device work, the same result run to run.
// q_pos and prefix_len are read in place (a stride of 0 for a scalar) or
// passed as values; a 1-D ring kv_pos is read with a row stride of 0.
//
// Semantics kept from the reference:
//   * the mask comes from the slot positions kv_pos exactly as _slot_mask
//     does (causal / prefix / full, window, kv_pos < 0 == empty); a row
//     whose slot the mask drops is never loaded;
//   * the finite fill -1e30: a row with no valid slot ends with m = -1e30,
//     l = 0, acc = 0, which the merge turns into an exact 0, never NaN; a
//     split with no granted table entry is such a state and merges to
//     nothing;
//   * a paged table entry past the pool reads the pool's last block, as the
//     plain version's clamp does;
//   * int8 caches are dequantized at load time from the per-slot, per-head
//     bf16 absmax scales; scores are f32 throughout; softcap is kept.
//
// Head geometries: the kernel is instantiated for the (G, D) pairs of the
// ported configurations only (with_heads below): G = 2 with D 64
// (qwen3-0.6b's smoke config) or 128 (qwen3-0.6b, qwen3-1.7b, gemma2-27b),
// G = 1 (multi-head attention) with D 32 (fedtime-llama2-7b's smoke config),
// 64 (seamless-m4t-medium's self and cross attention), 80 (zamba2-2.7b's
// shared attention) or 128 (fedtime-llama2-7b, qwen2-moe-a2.7b), G = 3 with
// D 64 (smollm-360m) and G = 4 with D 128 (mixtral-8x7b), each for the
// three cache types and both layouts: 48 kernels.  A lane keeps G query rows and G accumulators of
// VE floats in registers, so G = 4 at D 128 in f32 is the instance nearest
// to spilling: ptxas's report (chip_smoke.py, phase 1) says what it holds.  A slot is owned by a lane group of D * elem / 16 lanes, which at
// D 32 is 4 lanes for bf16, 8 for f32 and 2 for int8; the dot products are
// summed over the group by xor shuffles of LPS / 2 .. 1 and the groups of a
// warp merged by shuffles of LPS .. 16, which holds for any LPS that
// divides 32.  A row of D * elem / 16 vectors that is not a power of two
// (D 80: 10 for bf16, 20 for f32, 5 for int8) takes the next power of two
// of lanes (16, 32, 8); the lanes past the row are idle: their query and
// rows are zeros, loaded from nowhere, so they add exactly 0 to every dot
// product and hold a zero accumulator, which they never write.  At a power
// of two every lane is live and the kernel is the one it was.
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

constexpr float kNeg = -1e30f;      // finite mask fill (see header)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;          // slots a lane group holds per buffer
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kStage = 64;          // paged table entries staged at a time
constexpr unsigned kFull32 = 0xffffffffu;

enum Kind { kCausal = 0, kPrefix = 1, kFull = 2 };
enum KvType { kBf16 = 0, kF32 = 1, kInt8 = 2 };

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

// softcap * tanh(x / softcap), out of line: inlined, tanhf's code in every
// unrolled slot of the pass loop made each call slower (about 0.5 us at the
// engine's pool, on the card), softcap or not.
__device__ __noinline__ float soft_cap(float x, float softcap) {
  return softcap * tanhf(x / softcap);
}

// Everything a call passes to the kernel.
struct DecodeArgs {
  const void* q;
  int q_f32;
  const void* k;
  const void* v;
  const __nv_bfloat16* k_scale;     // int8 caches only
  const __nv_bfloat16* v_scale;
  const int* kv_pos;                // ring (B, S) / (S,); pool (nb, bs)
  long long kvp_stride;             // ring: kv_pos's row stride (0: one row)
  const int* tbl;                   // pool: (B, T) table; ring: nullptr
  int T, bs, nb;                    // pool: entries a row, block size, blocks
  unsigned bs_mul;                  // t / bs == umulhi(t, bs_mul) >> bs_shr
  int bs_shr;                       //   for 0 <= t < 2**31 (bs_mul 0: bs 1)
  const int* q_pos;                 // read at q_pos[b * stride], else value
  int q_pos_stride, q_pos_val;
  const int* prefix_len;
  int plen_stride, plen_val;
  void* out;                        // (B, 1, H, D) in q's type, or nullptr
  float* out_m;                     // and the merged partials instead
  float* out_l;
  float* out_acc;
  int Hk, S;                        // S: the ring's slots (a pool's T * bs)
  int kind, window;
  float softcap, scale;
};

template <typename KT, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ DecodeArgs a) {
  constexpr int VE = 16 / static_cast<int>(sizeof(KT));  // elems a vector
  constexpr int NV = D / VE;                              // vectors a row
  // lanes a slot: the least power of two >= NV (NV itself but at D 80)
  constexpr int LPS = NV <= 1 ? 1 : NV <= 2 ? 2 : NV <= 4 ? 4
                      : NV <= 8 ? 8 : NV <= 16 ? 16 : 32;
  constexpr int SPW = 32 / LPS;                           // slots a load
  constexpr int U = kUnroll;
  constexpr int kPass = kWarps * SPW * U;                 // slots a pass
  static_assert(D % VE == 0 && NV <= 32, "a row is whole 16-byte vectors");
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "lane groups");

  const KT* __restrict__ k = static_cast<const KT*>(a.k);
  const KT* __restrict__ v = static_cast<const KT*>(a.v);
  const int* __restrict__ kv_pos = a.kv_pos;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hk = a.Hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPS;         // the lane group: one slot at a time
  const int c = lane % LPS;           // the lane's vector of the row
  const bool live = NV == LPS || c < NV;   // else idle: past the row
  const bool quant = a.k_scale != nullptr;
  const int H = Hk * G;

  // The lane's VE elements of the G queries of KV head h.
  float qr[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t off = (static_cast<size_t>(b) * H + h * G + g) * D + c * VE;
#pragma unroll
    for (int i = 0; i < VE; ++i)
      qr[g][i] = !live ? 0.f
                 : a.q_f32 ? static_cast<const float*>(a.q)[off + i]
                           : __bfloat162float(
                                 static_cast<const __nv_bfloat16*>(
                                     a.q)[off + i]);
  }
  const int qp = a.q_pos ? a.q_pos[static_cast<long long>(b) * a.q_pos_stride]
                         : a.q_pos_val;
  const int plen =
      a.prefix_len ? a.prefix_len[static_cast<long long>(b) * a.plen_stride]
                   : a.plen_val;
  const int kind = a.kind, window = a.window;
  const float scale = a.scale, softcap = a.softcap;

  float m[G], l[G], acc[G][VE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[g][i] = 0.f;
  }

  // The pool's table entries of the current stage: entry e0 + i at [i].
  __shared__ int sm_tbl[PAGED ? kStage : 1];
  int e0 = 0;
  const int bs = a.bs;
  const int* kvp = kv_pos + (PAGED ? 0 : b * a.kvp_stride);
  const size_t row0 = PAGED ? 0 : static_cast<size_t>(b) * a.S;

  // The slot positions of pass `pass` of [lo, hi) (-1 past its end or
  // where a pool's table entry is ungranted), and for a pool each slot's
  // physical row, kept for issue.  The block index t / bs is a multiply
  // and a shift by the wrapper's magic: a division by a runtime value is
  // ~20 instructions (it made a long pool's call 11-17% slower on the card).
  auto load_pos = [&](int (&kp)[U], int (&rw)[U], int lo, int hi,
                      int pass) {
    const int base = lo + pass * kPass + warp * (SPW * U) + grp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * SPW;
      kp[u] = -1;
      rw[u] = 0;
      if (t < hi) {
        if constexpr (PAGED) {
          const int blk =
              a.bs_mul ? static_cast<int>(
                             __umulhi(static_cast<unsigned>(t), a.bs_mul) >>
                             a.bs_shr)
                       : t;
          const int e = sm_tbl[blk - e0];
          if (e >= 0) {
            rw[u] = e * bs + (t - blk * bs);
            kp[u] = __ldg(kv_pos + rw[u]);
          }
        } else {
          kp[u] = __ldg(kvp + t);
        }
      }
    }
  };

  // Start the loads of pass `pass` from its positions: the K / V rows (and
  // scales) of the slots the mask keeps; a dropped slot reads zeros.
  auto issue = [&](RingBuf<U>& f, const int (&kp)[U], const int (&rw)[U],
                   int lo, int pass) {
    const int base = lo + pass * kPass + warp * (SPW * U) + grp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      f.ok[u] = slot_keep(kp[u], qp, plen, kind, window);
      f.k[u] = make_uint4(0u, 0u, 0u, 0u);
      f.v[u] = f.k[u];
      f.ks[u] = 0x3f80;               // bf16 1.0
      f.vs[u] = 0x3f80;
      if (f.ok[u] && live) {          // kept: granted and inside [lo, hi)
        const size_t row = PAGED ? static_cast<size_t>(rw[u])
                                 : row0 + base + u * SPW;
        const size_t hr = row * Hk + h;
        f.k[u] = load16(k + hr * D + c * VE);
        f.v[u] = load16(v + hr * D + c * VE);
        if (quant) {
          f.ks[u] = __ldg(reinterpret_cast<const unsigned short*>(a.k_scale) +
                          hr);
          f.vs[u] = __ldg(reinterpret_cast<const unsigned short*>(a.v_scale) +
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
          if (softcap > 0.f) x = soft_cap(x, softcap);
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

  // The slots [lo, hi) through two register buffers: the next pass's rows
  // are in flight while the current pass is consumed, and the positions of
  // the pass after it, so that no load of a pass waits on another load of
  // the same pass.
  auto walk = [&](int lo, int hi) {
    const int n_pass = (hi - lo + kPass - 1) / kPass;
    RingBuf<U> fa, fb;
    int pa[U], pb[U], ra[U], rb[U];
    load_pos(pa, ra, lo, hi, 0);
    load_pos(pb, rb, lo, hi, 1);
    if (n_pass > 0) issue(fa, pa, ra, lo, 0);
    for (int pass = 0; pass < n_pass; pass += 2) {
      if (pass + 1 < n_pass) issue(fb, pb, rb, lo, pass + 1);
      load_pos(pa, ra, lo, hi, pass + 2);
      consume(fa);
      if (pass + 1 >= n_pass) break;
      if (pass + 2 < n_pass) issue(fa, pa, ra, lo, pass + 2);
      load_pos(pb, rb, lo, hi, pass + 3);
      consume(fb);
    }
  };

  if constexpr (PAGED) {
    // whole table entries: every split of a row of T >= n_splits entries
    // holds at least one
    const int e_begin = static_cast<int>(static_cast<long long>(split) * a.T /
                                         n_splits);
    const int e_end = static_cast<int>(
        static_cast<long long>(split + 1) * a.T / n_splits);
    const int* row_tbl = a.tbl + static_cast<long long>(b) * a.T;
    for (e0 = e_begin; e0 < e_end; e0 += kStage) {
      const int n_e = min(kStage, e_end - e0);
      __syncthreads();                // the last stage's readers are done
      for (int i = threadIdx.x; i < n_e; i += kThreads)
        sm_tbl[i] = min(__ldg(row_tbl + e0 + i), a.nb - 1);
      __syncthreads();
      walk(e0 * bs, (e0 + n_e) * bs);
    }
  } else {
    // balanced splits: every split of a ring of S >= n_splits slots is
    // non-empty
    walk(static_cast<int>(static_cast<long long>(split) * a.S / n_splits),
         static_cast<int>(static_cast<long long>(split + 1) * a.S / n_splits));
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
      float x = acc[g][i] * cr;
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) x += __shfl_xor_sync(kFull32, x, o);
      acc[g][i] = x;
    }
    m[g] = M;
    l[g] = L;
  }

  // Merge the warps into the block's partial, in warp order.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
  __shared__ float part_m[G];
  __shared__ float part_l[G];
  __shared__ float part_acc[G][D];
  if (grp == 0 && live) {
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
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
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
      if (a.out_acc != nullptr) {
        a.out_acc[o * D + d] = A;
        if (d == 0) {
          a.out_m[o] = M;
          a.out_l[o] = L;
        }
      } else {
        const float y = A / fmaxf(L, 1e-30f);
        if (a.q_f32)
          static_cast<float*>(a.out)[o * D + d] = y;
        else
          static_cast<__nv_bfloat16*>(a.out)[o * D + d] =
              __float2bfloat16_rn(y);
      }
    }
  }
  cluster.sync();
}

// One cluster of n_splits blocks per (row, head): grid (n_splits, Hk, B).
cudaLaunchConfig_t cluster_config(int n_splits, int Hk, int B,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, Hk, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename KT, int D, int G, bool PAGED>
int launch(const DecodeArgs& a, int B, int n_splits, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(n_splits, a.Hk, B, attr);
  cfg.stream = stream;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, decode_kernel<KT, D, G, PAGED>, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of n_splits blocks the device can hold at once.
template <typename KT, int D, int G, bool PAGED>
int max_clusters(int n_splits) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_splits, 1, 1, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, decode_kernel<KT, D, G, PAGED>,
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
  if (G == 1 && D == 64) return fn(IntC<64>{}, IntC<1>{});
  if (G == 1 && D == 80) return fn(IntC<80>{}, IntC<1>{});
  if (G == 1 && D == 128) return fn(IntC<128>{}, IntC<1>{});
  if (G == 3 && D == 64) return fn(IntC<64>{}, IntC<3>{});
  if (G == 4 && D == 128) return fn(IntC<128>{}, IntC<4>{});
  return -1;
}

// The checks both layouts share, then the launch of the instance.
template <bool PAGED>
int dispatch(const DecodeArgs& a, int B, int G, int D, int n_splits,
             int kv_type, void* stream) {
  if (kv_type == kInt8 && (a.k_scale == nullptr || a.v_scale == nullptr))
    return -1;
  if (kv_type != kInt8 && (a.k_scale != nullptr || a.v_scale != nullptr))
    return -1;
  if ((a.out == nullptr) == (a.out_acc == nullptr)) return -1;
  if (a.out_acc != nullptr && (a.out_m == nullptr || a.out_l == nullptr))
    return -1;
  if (B < 1 || B > 65535 || a.Hk < 1 || a.Hk > 65535 || a.S < 1) return -1;
  if (n_splits < 1 || n_splits > kMaxCluster) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kv_type(kv_type, [&](auto kt) {
    using KT = typename decltype(kt)::type;
    return with_heads(G, D, [&](auto d, auto g) {
      return launch<KT, decltype(d)::value, decltype(g)::value, PAGED>(
          a, B, n_splits, st);
    });
  });
}

template <bool PAGED>
int dispatch_max_clusters(int kv_type, int G, int D, int n_splits) {
  if (n_splits < 1 || n_splits > kMaxCluster) return -1;
  return with_kv_type(kv_type, [&](auto kt) {
    using KT = typename decltype(kt)::type;
    return with_heads(G, D, [&](auto d, auto g) {
      return max_clusters<KT, decltype(d)::value, decltype(g)::value, PAGED>(
          n_splits);
    });
  });
}

}  // namespace

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
  if (n_splits > S) return -1;
  const DecodeArgs a = {q, q_f32, k, v,
                        static_cast<const __nv_bfloat16*>(k_scale),
                        static_cast<const __nv_bfloat16*>(v_scale), kv_pos,
                        kvp_stride, nullptr, 0, 0, 0, 0u, 0, q_pos,
                        q_pos_stride, q_pos_val, prefix_len, plen_stride,
                        plen_val, out, out_m, out_l, out_acc, Hk, S, kind,
                        window, softcap, scale};
  return dispatch<false>(a, B, G, D, n_splits, kv_type, stream);
}

// The paged pool: k, v (nb, bs, Hk, D) of kv_type; kv_pos (nb, bs) int32;
// tbl (B, T) int32 physical block ids (-1: ungranted); bs_mul, bs_shr the
// magic of a division by bs (kernels/flash_decode.py::_fast_divisor);
// everything else as for the ring.  n_splits in [1, min(8, T)], each split
// whole table entries.
extern "C" int fd_flash_decode_paged(
    const void* q, int q_f32, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const int* kv_pos,
    const int* tbl, int T, int bs, int nb, unsigned bs_mul, int bs_shr,
    const int* q_pos,
    int q_pos_stride, int q_pos_val, const int* prefix_len, int plen_stride,
    int plen_val, void* out, float* out_m, float* out_l, float* out_acc,
    int B, int Hk, int G, int D, int n_splits, int kind, int window,
    float softcap, float scale, int kv_type, void* stream) {
  if (tbl == nullptr || T < 1 || bs < 1 || nb < 1 || n_splits > T) return -1;
  if (static_cast<long long>(T) * bs > 0x7fffffffLL ||
      static_cast<long long>(nb) * bs > 0x7fffffffLL)
    return -1;
  const DecodeArgs a = {q, q_f32, k, v,
                        static_cast<const __nv_bfloat16*>(k_scale),
                        static_cast<const __nv_bfloat16*>(v_scale), kv_pos,
                        0, tbl, T, bs, nb, bs_mul, bs_shr, q_pos,
                        q_pos_stride, q_pos_val, prefix_len, plen_stride,
                        plen_val, out, out_m, out_l, out_acc, Hk, T * bs,
                        kind, window, softcap, scale};
  return dispatch<true>(a, B, G, D, n_splits, kv_type, stream);
}

// How many clusters of n_splits blocks (one (row, head) each) the current
// device holds at once, for the ring or paged kernel of this cache type and
// head geometry (G, D) -- the one a call with them launches; -1 on an
// error.  Clusters must fit inside one GPC, so a kernel that fits few blocks
// an SM fits fewer large clusters than its blocks suggest.
extern "C" int fd_ring_max_clusters(int kv_type, int G, int D, int n_splits) {
  return dispatch_max_clusters<false>(kv_type, G, D, n_splits);
}

extern "C" int fd_paged_max_clusters(int kv_type, int G, int D,
                                     int n_splits) {
  return dispatch_max_clusters<true>(kv_type, G, D, n_splits);
}
