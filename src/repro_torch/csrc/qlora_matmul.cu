// Fused QLoRA matmul for Hopper (sm_90a):
//
//   y = x . dequant_nf4(Wq) + s . (x . A) . B
//
// Replaces the TPU kernel repro/kernels/qlora_matmul.py::qlora_matmul (body
// ::_kernel).  x is (M, K) f32 or bf16; Wq is (K, N/2) bytes, two NF4 codes
// each, the high nibble the even column; absmax is (K, N/qblock) f32, one
// scale per (row, column block); A (K, r) and B (r, N) are f32 and s is a
// float passed by value.  The reference fixes f32 arithmetic: w = code[q] *
// absmax in f32, every product and sum f32; y is written in x's type.  The
// 16-entry NF4 code book comes from the caller.
//
// Bound on the H100: operations.  At the federated fit's site (M 504,
// K = N = 4096, r 8) a call does 17.0 GFLOP against 18.0 MB moved: 17 us
// at the bf16 tensor-core rate, 0.25 ms at the f32 rate of the CUDA cores.
// Two kernels, one a call, chosen by x's type:
//
// bf16 x (qlora_mma_kernel): the tensor cores.  x is exact in bf16, so
// only w needs more bits than one bf16 value holds: one bf16 copy of w errs
// by about 2**-9 of each product, which at K = 4096 breaks the reference's
// atol 1e-4 on outputs near 0.  Each block owns a 128 x 128 tile of y (4 x 32
// = 128 blocks at the fit's site, one wave on 132 SMs) and walks K in steps
// of 32.  Per step:
//   * the block decodes its 32 x 128 code tile once, through the code book
//     in shared memory, times the row's absmax, into two bf16 tiles w_hi =
//     bf16(w) and w_lo = bf16(w - w_hi) (w to about 17 bits);
//   * mma.sync m16n8k16 (bf16 in, f32 accumulate) runs x . w_hi + x . w_lo
//     into one f32 accumulator, fragments by ldmatrix (.trans for w) from
//     XOR-swizzled tiles; a warp's 16 x . w_hi products come before its 16
//     x . w_lo ones, so that no MMA waits on the one before it;
//   * the LoRA bypass x . A runs on the same x tile with A split into three
//     bf16 parts whose sum is A exactly: every product is the f32 product
//     and the sums are f32, as the reference's (r <= 64; 3 r / 8 MMAs a
//     16-deep slice beside the 32 of x . w).
// The warps have roles.  Eight MMA warps (2 x 4, each a 64 x 32 tile) run
// the MMAs of step kt from decoded stage kt % 2 and issue the cp.async of
// step kt + 3's x tile; four decode warps issue the cp.async of step
// kt + 3's codes, scales and A values into a ring of four raw stages and
// decode step kt + 1 into the other decoded stage.  One barrier a step.
// The epilogue adds s . (x . A) . B in f32 (x . A and the B tile through
// shared memory) before the one write of y.  The split doubles the MMA
// work: the design's floor is 34 GFLOP at the bf16 rate, 0.034 ms.  What
// holds it above that (PERF.md): mma.sync runs at about half the rate of
// Hopper's wgmma, and a step moves ~124 KB through shared memory (ldmatrix
// reads of x and of both halves of w, the decode's stores), ~1000 cycles
// at 128 bytes a cycle.
//
// f32 x (qlora_kernel): a tiled GEMM on the CUDA cores, the f32 FMAs of the
// reference.  Each 256-thread block owns one 64 x 64 tile of y and walks K
// in steps of 32 (the TPU kernel's sequential K grid axis and its VMEM
// scratch become this loop and registers; nothing carries between blocks).
// Per step:
//   * the x tile (64 x 32) is stored in shared memory, transposed, so that a
//     thread reads its 4 rows as one 16-byte load;
//   * the packed codes (32 rows x 32 bytes) are read 4 bytes (8 codes) a
//     thread, decoded through the code book held in shared memory and
//     multiplied by their row's absmax, once per step for all 64 rows of
//     the tile (no one-hot product: that is the TPU's way to its MXU);
//   * each thread accumulates a 4 x 4 patch of x . W in registers, and beside
//     it its share of the 64 x r product x . A (the LoRA bypass), from the
//     same x tile in shared memory.
// The epilogue stages x . A and the B tile in shared memory and adds
// s . (x . A) . B to each thread's patch before the one write of y.
//
// Both: M, N and K may be ragged (the loads past an edge read zeros and the
// stores past it are dropped); the one layout rule is N % qblock == 0.
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
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16 x: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;                  // 2 (M) x 4 (N), the MMAs
constexpr int kDecWarps = 4;                  // the loads and the decode
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kBlockThreads = kMmaThreads + kDecThreads;
constexpr int TM = 128, TN = 128, TK = 32;    // block tile, K step
constexpr int kApad = TK + 8;                 // row of a transposed A part
constexpr int kStages = 4;                    // raw stages in the ring
// Scales a row of the tile spans at qblock >= 8: (TN - 1) / 8 + 2.
constexpr int kScaleW = (TN - 1) / 8 + 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, or zeros when !valid (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 t) {
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Element offsets in the swizzled tiles.  x: [TM][TK] bf16, 4 chunks of 16
// bytes a row, XOR-ed with (row / 2) % 4 so that ldmatrix's 8 rows of one
// chunk column fall in 8 distinct bank groups.  w: [TK][TN] bf16, 16 chunks
// a row, XOR-ed with row % 8.
__device__ __forceinline__ int swz_x(int row, int chunk) {
  return row * TK + ((chunk ^ ((row >> 1) & 3)) << 3);
}
__device__ __forceinline__ int swz_w(int row, int chunk) {
  return row * TN + ((chunk ^ (row & 7)) << 3);
}

// Dynamic shared memory of the bf16 kernel, in bytes.  A ring of kStages
// raw stages, as loaded (the x tile, the packed codes, the rows' scales
// and the A tile), and two decoded stages (w_hi, w_lo and the three A
// parts); the epilogue's f32 x . A and B tiles reuse the front.
template <int RP>
struct MmaSmem {
  static constexpr int kX = TM * TK * 2;                  // [TM][TK] bf16
  static constexpr int kCodes = TK * TN / 2;              // [TK][TN / 2] u8
  static constexpr int kScales = TK * kScaleW * 4;        // [TK][kScaleW]
  static constexpr int kA = RP * TK * 4;                  // [RP / 4][128]
  static constexpr int kRaw = kX + kCodes + kScales + kA;
  static constexpr int kW = TK * TN * 2;                  // w_hi or w_lo
  static constexpr int kParts = 3 * RP * kApad * 2;       // [3][RP][kApad]
  static constexpr int kDec = 2 * kW + kParts;
  static constexpr int kMain = kStages * kRaw + 2 * kDec;
  static constexpr int kEpi = (TM * (RP + 1) + RP * TN) * 4;
  static constexpr int kBytes = kMain > kEpi ? kMain : kEpi;
};

// RP: r rounded up to 8, 16, 32 or 64.  SMALLQ: qblock < 8, so that the 8
// columns of a group may span more than two scales (each is read from
// global memory where it is used); else a group spans at most two, picked
// per column by a mask fixed per thread.
//
// Warp roles: warps 0-7 issue the cp.async of step kt + kStages - 1's x
// tile and run the MMAs of step kt on decoded stage kt % 2; warps 8-11
// issue the cp.async of that step's codes, scales and A values into the
// raw ring and decode raw step kt + 1 into the other decoded stage.  One
// barrier a step.
template <int RP, bool SMALLQ>
__global__ void __launch_bounds__(kBlockThreads, 1)
qlora_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ wq,
                 const float* __restrict__ absmax,
                 const float* __restrict__ la, const float* __restrict__ lb,
                 const float* __restrict__ code,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K, int r,
                 int qblock, float s, int xvec) {
  using Sm = MmaSmem<RP>;
  static_assert(kStages >= 3, "two steps of loads in flight at least");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float book[16];
  auto raw = [&](int kt) { return smem + (kt % kStages) * Sm::kRaw; };
  auto xs = [&](int kt) {
    return reinterpret_cast<__nv_bfloat16*>(raw(kt));
  };
  auto rcodes = [&](int kt) { return raw(kt) + Sm::kX; };
  auto rscales = [&](int kt) {
    return reinterpret_cast<float*>(raw(kt) + Sm::kX + Sm::kCodes);
  };
  auto ra = [&](int kt) {
    return reinterpret_cast<float*>(raw(kt) + Sm::kX + Sm::kCodes +
                                    Sm::kScales);
  };
  auto dec = [&](int kt) {
    return smem + kStages * Sm::kRaw + (kt & 1) * Sm::kDec;
  };
  auto wh = [&](int kt) { return reinterpret_cast<__nv_bfloat16*>(dec(kt)); };
  auto wl = [&](int kt) {
    return reinterpret_cast<__nv_bfloat16*>(dec(kt) + Sm::kW);
  };
  auto ap = [&](int kt) {
    return reinterpret_cast<__nv_bfloat16*>(dec(kt) + 2 * Sm::kW);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool mma_warp = warp < kMmaWarps;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int half = N / 2;
  const int nblk = N / qblock;
  if (tid < 16) book[tid] = code[tid];
  // 16-byte code rows: N a multiple of 32 and wq 16-byte aligned
  const bool cvec = N % 32 == 0 &&
                    (reinterpret_cast<uintptr_t>(wq) & 15u) == 0;

  // ---- the decode warps' share: K row dk of a step, and its 8-column
  // groups g = 0..3 at chunks dq + 4 g of the w tile (columns col[g] ..
  // col[g] + 7)
  const int dt = tid - kMmaThreads;           // 0 .. 127 in the decode warps
  const int dk = dt >> 2, dq = dt & 3;
  const int blk0 = n0 / qblock;               // the tile's first scale
  const int sw = (min(n0 + TN, N) - 1) / qblock - blk0 + 1;  // its scales
  int col[4], sidx[4];            // a group's first column and scale
  unsigned inside[4], upper[4];   // per column: < N; uses the next scale
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    col[g] = n0 + (dq + 4 * g) * 8;
    sidx[g] = min(col[g], N - 1) / qblock - blk0;
    inside[g] = upper[g] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (col[g] + i < N) inside[g] |= 1u << i;
      if (!SMALLQ && col[g] + i < N &&
          (col[g] + i) / qblock != col[g] / qblock)
        upper[g] |= 1u << i;
    }
  }

  // Step kt's loads into its raw stage (zeros past K, M and N):
  // cp.async where the layout allows (xvec, cvec), else plain loads.  The
  // MMA warps take the x tile when its rows are 16-byte aligned (load_x,
  // two 16-byte chunks a thread), the decode warps the rest (load).
  auto load_x = [&](int kt) {
    if (!xvec) return;
    const int k0 = kt * TK;
    __nv_bfloat16* xd = xs(kt);
#pragma unroll
    for (int q = 0; q < TM * TK / 8 / kMmaThreads; ++q) {
      const int e = tid + q * kMmaThreads;
      const int row = e >> 2, ch = e & 3;
      const int gm = m0 + row, gk = k0 + ch * 8;
      const bool valid = gm < M && gk < K;
      const __nv_bfloat16* src =
          valid ? x + static_cast<long long>(gm) * K + gk : x;
      cp_async16(xd + swz_x(row, ch), src, valid);
    }
  };
  auto load = [&](int kt) {
    const int k0 = kt * TK;
    __nv_bfloat16* xd = xs(kt);
    if (!xvec) {
      for (int e = dt; e < TM * TK; e += kDecThreads) {
        const int row = e / TK, kk = e % TK;
        const int gm = m0 + row, gk = k0 + kk;
        xd[swz_x(row, kk >> 3) + (kk & 7)] =
            (gm < M && gk < K) ? x[static_cast<long long>(gm) * K + gk]
                               : __float2bfloat16_rn(0.0f);
      }
    }
    {                                 // codes: row dk, bytes 16 dq .. + 15
      const int k = k0 + dk;
      const int c = n0 + dq * 32;     // the chunk's first column
      uint8_t* cd = rcodes(kt) + dk * (TN / 2) + dq * 16;
      const uint8_t* row = wq + static_cast<long long>(k < K ? k : 0) * half;
      if (cvec) {
        const bool valid = k < K && c < N;
        cp_async16(cd, valid ? row + c / 2 : wq, valid);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          cd[b] = (k < K && c + 2 * b < N) ? row[c / 2 + b] : 0;
      }
    }
    if constexpr (!SMALLQ) {          // the rows' scales: [TK][kScaleW]
      float* sd = rscales(kt);
      for (int e = dt; e < TK * sw; e += kDecThreads) {
        const int row = e / sw, j = e % sw;
        const bool valid = k0 + row < K;
        cp_async4(sd + row * kScaleW + j,
                  absmax + (valid ? static_cast<long long>(k0 + row) * nblk +
                                        blk0 + j
                                  : 0),
                  valid);
      }
    }
    float* ad = ra(kt);
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) {
      const int e = dt + i * kDecThreads;
      const int kk = e / RP, j = e % RP;
      const bool valid = k0 + kk < K && j < r;
      cp_async4(ad + e,
                la + (valid ? static_cast<long long>(k0 + kk) * r + j : 0),
                valid);
    }
  };

  // Raw step kt into decoded stage kt: the thread's 32 codes into w_hi and
  // w_lo, and its share of the A tile into the three parts (a = p0 + p1 +
  // p2, exactly).
  auto decode = [&](int kt) {
    const uint8_t* cd = rcodes(kt) + dk * (TN / 2);
    const float* sd = rscales(kt) + dk * kScaleW;
    const float* am_row = nullptr;
    if constexpr (SMALLQ) {
      const int k = kt * TK + dk;
      if (k < K) am_row = absmax + static_cast<long long>(k) * nblk;
    }
    // Every shared-memory read first, every store last: a load the
    // compiler cannot prove apart from an earlier store waits for it.
    uint32_t codes[4];
    float sc0[4], sc1[4], c[4][8];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      codes[g] = *reinterpret_cast<const uint32_t*>(cd + (dq + 4 * g) * 4);
      sc0[g] = sc1[g] = 0.0f;
      if constexpr (!SMALLQ) {
        sc0[g] = sd[sidx[g]];
        if (upper[g]) sc1[g] = sd[sidx[g] + 1];
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = (codes[g] >> (8 * (i / 2))) & 0xffu;
        c[g][i] = book[i % 2 == 0 ? byte >> 4 : byte & 0xfu];
      }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * p + h;
          float sc;
          if constexpr (SMALLQ)
            sc = (am_row && ((inside[g] >> i) & 1u))
                     ? __ldg(am_row + (col[g] + i) / qblock) : 0.0f;
          else
            sc = ((upper[g] >> i) & 1u) ? sc1[g] : sc0[g];
          w[h] = ((inside[g] >> i) & 1u) ? c[g][i] * sc : 0.0f;
        }
        const __nv_bfloat162 t = __floats2bfloat162_rn(w[0], w[1]);
        hi[g][p] = bf16x2_bits(t);
        lo[g][p] = bf16x2_bits(__floats2bfloat162_rn(w[0] - __low2float(t),
                                                     w[1] - __high2float(t)));
      }
    const float* src = ra(kt);
    float av[RP / 4];
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) av[i] = src[dt + i * kDecThreads];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int off = swz_w(dk, dq + 4 * g);
      *reinterpret_cast<uint4*>(wh(kt) + off) =
          make_uint4(hi[g][0], hi[g][1], hi[g][2], hi[g][3]);
      *reinterpret_cast<uint4*>(wl(kt) + off) =
          make_uint4(lo[g][0], lo[g][1], lo[g][2], lo[g][3]);
    }
    __nv_bfloat16* dst = ap(kt);
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) {
      const int e = dt + i * kDecThreads;
      const int kk = e / RP, j = e % RP;
      const float a = av[i];
      const __nv_bfloat16 p0 = __float2bfloat16_rn(a);
      const float r1 = a - __bfloat162float(p0);
      const __nv_bfloat16 p1 = __float2bfloat16_rn(r1);
      const __nv_bfloat16 p2 = __float2bfloat16_rn(r1 - __bfloat162float(p1));
      dst[(0 * RP + j) * kApad + kk] = p0;
      dst[(1 * RP + j) * kApad + kk] = p1;
      dst[(2 * RP + j) * kApad + kk] = p2;
    }
  };

  // ---- the MMA warps' share: a 64 x 32 tile of y and x . A of m16 tile
  // `warp`
  const int wm = (warp >> 2) & 1, wn = warp & 3;
  const int gr = lane >> 2, tig = lane & 3;   // fragment row / column
  float acc[4][4][4];                 // [m16 tile][n8 tile][fragment]
  float xa[RP / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) xa[j][q] = 0.0f;

  // The MMAs of one 16-deep slice kk of step kt: x . w_hi for the warp's
  // 16 (m16, n8) tiles, then x . w_lo (each accumulator's two products 16
  // MMAs apart), with x . A's three parts in between.
  auto mma_slice = [&](int kt, int kk) {
    const __nv_bfloat16* xt = xs(kt);
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ach = kk * 2 + (lane >> 4);
    uint32_t af[4][4], bh[2][4], bl[2][4], xf[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4(af[mt], xt + swz_x(wm * 64 + mt * 16 + arow, ach));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int ch = wn * 4 + np * 2 + (lane >> 4);
      ldmatrix_x4_trans(bh[np], wh(kt) + swz_w(kk * 16 + arow, ch));
      ldmatrix_x4_trans(bl[np], wl(kt) + swz_w(kk * 16 + arow, ch));
    }
    ldmatrix_x4(xf, xt + swz_x(warp * 16 + arow, ach));
    const __nv_bfloat16* a0 = ap(kt) + gr * kApad + kk * 16 + 2 * tig;
    auto lora = [&](int part) {
#pragma unroll
      for (int jt = 0; jt < RP / 8; ++jt) {
        const __nv_bfloat16* b = a0 + (part * RP + jt * 8) * kApad;
        mma_bf16(xa[jt], xf, *reinterpret_cast<const uint32_t*>(b),
                 *reinterpret_cast<const uint32_t*>(b + 8));
      }
    };
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mt][2 * np], af[mt], bh[np][0], bh[np][1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bh[np][2], bh[np][3]);
      }
    lora(0);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mt][2 * np], af[mt], bl[np][0], bl[np][1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bl[np][2], bl[np][3]);
      }
      if (mt == 1) lora(1);
    }
    lora(2);
  };

  const int nk = (K + TK - 1) / TK;
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) {
      if (mma_warp)
        load_x(kt);
      else
        load(kt);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 3>();       // steps 0 and 1 are in
  __syncthreads();                    // (and the code book)
  if (!mma_warp) decode(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int fill = kt + kStages - 1;
    if (mma_warp) {
      if (fill < nk) load_x(fill);
      cp_async_commit();
      mma_slice(kt, 0);
      mma_slice(kt, 1);
    } else {
      if (fill < nk) load(fill);
      cp_async_commit();
      if (kt + 1 < nk) decode(kt + 1);
    }
    cp_async_wait<kStages - 3>();     // step kt + 2 is in
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: y = acc + s . (x . A) . B, x . A and the B tile through
  // shared memory.
  float* xas = reinterpret_cast<float*>(smem);          // [TM][RP + 1]
  float* bsm = xas + TM * (RP + 1);                     // [RP][TN]
  if (mma_warp) {
#pragma unroll
    for (int jt = 0; jt < RP / 8; ++jt) {
      const int row = warp * 16 + gr;
      const int j = jt * 8 + 2 * tig;
      xas[row * (RP + 1) + j] = xa[jt][0];
      xas[row * (RP + 1) + j + 1] = xa[jt][1];
      xas[(row + 8) * (RP + 1) + j] = xa[jt][2];
      xas[(row + 8) * (RP + 1) + j + 1] = xa[jt][3];
    }
  }
  for (int e = tid; e < RP * TN; e += kBlockThreads) {
    const int j = e / TN, c = e % TN;
    bsm[e] = (j < r && n0 + c < N)
                 ? lb[static_cast<long long>(j) * N + n0 + c] : 0.0f;
  }
  __syncthreads();
  if (!mma_warp) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int nl = wn * 32 + nt * 8 + 2 * tig;         // even; N is even
    if (n0 + nl >= N) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int rw = wm * 64 + mt * 16 + gr;           // rows rw, rw + 8
      float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int j = 0; j < RP; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bsm + j * TN + nl);
        const float xa0 = xas[rw * (RP + 1) + j];
        const float xa1 = xas[(rw + 8) * (RP + 1) + j];
        l[0] = fmaf(xa0, b.x, l[0]);
        l[1] = fmaf(xa0, b.y, l[1]);
        l[2] = fmaf(xa1, b.x, l[2]);
        l[3] = fmaf(xa1, b.y, l[3]);
      }
      const float* c = acc[mt][nt];
      const long long o = static_cast<long long>(m0 + rw) * N + n0 + nl;
      if (m0 + rw < M)
        *reinterpret_cast<__nv_bfloat162*>(y + o) =
            __floats2bfloat162_rn(c[0] + s * l[0], c[1] + s * l[1]);
      if (m0 + rw + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + o + 8LL * N) =
            __floats2bfloat162_rn(c[2] + s * l[2], c[3] + s * l[3]);
    }
  }
}

// Launch one instance, raising its dynamic shared-memory limit once a
// device (on the first call, which callers make before any CUDA-graph
// capture).
template <int RP, bool SMALLQ>
int launch_mma_instance(const void* x, const void* wq, const void* absmax,
                        const void* la, const void* lb, const void* code,
                        void* y, int M, int N, int K, int r, int qblock,
                        float s, int xvec, cudaStream_t st) {
  static bool ready[64] = {};
  constexpr int bytes = MmaSmem<RP>::kBytes;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  if (grid.y > 65535) return -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (!ready[dev]) {
    if (cudaFuncSetAttribute(qlora_mma_kernel<RP, SMALLQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    ready[dev] = true;
  }
  qlora_mma_kernel<RP, SMALLQ><<<grid, kBlockThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(absmax), static_cast<const float*>(la),
      static_cast<const float*>(lb), static_cast<const float*>(code),
      static_cast<__nv_bfloat16*>(y), M, N, K, r, qblock, s, xvec);
  return 0;
}

int launch_mma(int rp, const void* x, const void* wq, const void* absmax,
               const void* la, const void* lb, const void* code, void* y,
               int M, int N, int K, int r, int qblock, float s, int xvec,
               cudaStream_t st) {
#define QLORA_MMA_RANK(R)                                                    \
  case R:                                                                    \
    return qblock < 8                                                        \
        ? launch_mma_instance<R, true>(x, wq, absmax, la, lb, code, y, M, N, \
                                       K, r, qblock, s, xvec, st)            \
        : launch_mma_instance<R, false>(x, wq, absmax, la, lb, code, y, M,   \
                                        N, K, r, qblock, s, xvec, st);
  switch (rp) {
    QLORA_MMA_RANK(8)
    QLORA_MMA_RANK(16)
    QLORA_MMA_RANK(32)
    QLORA_MMA_RANK(64)
    default:
      return -1;
  }
#undef QLORA_MMA_RANK
}

}  // namespace

// x (M, K) of x_bf16 ? bf16 : f32 and y (M, N) of the same type; wq (K,
// N/2) u8; absmax (K, N/qblock), la (K, r), lb (r, N), code (16) f32; all
// contiguous, lb 8-byte aligned.  1 <= r <= 64, N % qblock == 0, N even.
// xvec: x rows may be read as 16-byte chunks (K a whole number of them, x
// 16-byte aligned); wvec: code rows may be read 4 bytes at a time.  bf16
// launches qlora_mma_kernel, f32 qlora_kernel.
extern "C" int qm_qlora_matmul(const void* x, int x_bf16, const void* wq,
                               const void* absmax, const void* la,
                               const void* lb, const void* code, void* y,
                               int M, int N, int K, int r, int qblock,
                               float s, int xvec, int wvec, void* stream) {
  if (M < 1 || N < 2 || K < 1 || r < 1 || r > 64 || qblock < 1 ||
      N % 2 != 0 || N % qblock != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_bf16) {
    int rp = 8;
    while (rp < r) rp *= 2;
    rc = launch_mma(rp, x, wq, absmax, la, lb, code, y, M, N, K, r, qblock,
                    s, xvec, st);
  } else {
    int rp = 4;
    while (rp < r) rp *= 2;
    rc = launch_rank<float>(rp, x, wq, absmax, la, lb, code, y, M, N, K, r,
                            qblock, s, xvec, wvec, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
