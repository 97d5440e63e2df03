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
// at the bf16 tensor-core rate.  At the reference benchmark's f32 shape
// (512, 1024, 1024, r 8) it does 1.07 GFLOP against 4.85 MB: 6.6 us as
// 3xTF32 (three TF32 products at 494.7 TFLOP/s for each f32 one).  Two
// kernels, one a call, chosen by x's type:
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
//     of each 16-deep slice into zeroed partials, which are added into the
//     f32 accumulators rounded to nearest (the tensor cores truncate as
//     they accumulate: one chain over K = 11,008 missed the limit);
//     fragments by ldmatrix (.trans for w) from XOR-swizzled tiles;
//   * the LoRA bypass x . A runs on the same x tile with A split into three
//     bf16 parts whose sum is A exactly: every product is the f32 product
//     and the sums are f32, as the reference's (r <= 64; 3 r / 8 MMAs a
//     16-deep slice beside the 32 of x . w), into zeroed partials too.
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
// f32 x (qlora_tf32_kernel): the tensor cores, as 3xTF32.  One TF32 product
// (10 mantissa bits a side) errs by about 2**-11 of each product and misses
// the reference's atol 1e-4 at K >= 1024, as do both two-product variants
// (tests/test_torch_kernel_designs.py emulates all four).  So x and w are
// each split once into TF32 halves (hi: cvt.rna's rounding, lo: the
// remainder truncated; integer ops on the bit pattern, since cvt issues at
// a quarter of their rate) and x_lo . w_hi + x_hi . w_lo + x_hi . w_hi is
// summed into one f32 accumulator (x_lo . w_lo, 2**-22 of a product, is
// dropped).  Each block owns a 64 x 64 tile of y: 8 x 16 = 128 blocks at
// the reference benchmark's (512, 1024, 1024), one wave on 132 SMs, where a
// 128 x 128 tile would give 32.  The skeleton is the bf16 kernel's: four MMA
// warps (2 x 2, each 32 x 32, mma.sync m16n8k8 tf32) and four decode
// warps; a cp.async ring of four raw stages (x f32, codes, scales, A:
// 11,392 bytes a stage at r <= 8, 18,560 at r 64); two decoded stages of
// fragment tiles (w_hi / w_lo, A's halves and x_hi / x_lo: 34,816 bytes a
// stage at r <= 8, 49,152 at r 64); 115,200 / 172,544 bytes of shared
// memory in all.  Per step the decode warps turn the codes into the TF32
// halves of w = code[q] * absmax (the f32 product, as the reference's) and
// split x and A once, into fragment-native tiles: a lane's fragment is one
// 16-byte load free of bank conflicts (the raw x tile's 16-byte chunks are
// XOR-swizzled by row, the w tiles' lane slots by the n8 tile's parity).
// The LoRA bypass x . A runs as 3xTF32 on the same x halves (3 r_p / 8
// MMAs a k8 slice beside the warp's 24 of x . w); its error, about 2**-21
// of each product, is far inside the limit.  The tensor cores truncate
// as they accumulate, so each step's MMAs run into zeroed partials that
// are added into the f32 accumulators, rounded to nearest (one chain over
// K = 4096 drifts by 3.5e-4).  The epilogue is the bf16 kernel's, in f32.
//
// Both: M, N and K may be ragged (the loads past an edge read zeros and the
// stores past it are dropped); the one layout rule is N % qblock == 0.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

  // The MMAs of one 16-deep slice kk of step kt, each m16 tile's x . w_hi
  // and x . w_lo into zeroed partials p that are then added into acc, and
  // x . A's three parts into zeroed partials px added into xa: the tensor
  // cores truncate as they accumulate, and one chain of MMAs over K =
  // 11,008 (fedtime-llama2-7b's w_down) drifts past the limit, the LoRA
  // chain the most (tests/test_torch_kernel_designs.py emulates both).  A
  // tile's four x . w_lo MMAs follow its four x . w_hi ones, with one of
  // x . A's parts between them in the first three tiles.
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
    float px[RP / 8][4];
#pragma unroll
    for (int jt = 0; jt < RP / 8; ++jt)
#pragma unroll
      for (int q = 0; q < 4; ++q) px[jt][q] = 0.0f;
    auto lora = [&](int part) {
#pragma unroll
      for (int jt = 0; jt < RP / 8; ++jt) {
        const __nv_bfloat16* b = a0 + (part * RP + jt * 8) * kApad;
        mma_bf16(px[jt], xf, *reinterpret_cast<const uint32_t*>(b),
                 *reinterpret_cast<const uint32_t*>(b + 8));
      }
    };
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float p[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[j][q] = 0.0f;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(p[2 * np], af[mt], bh[np][0], bh[np][1]);
        mma_bf16(p[2 * np + 1], af[mt], bh[np][2], bh[np][3]);
      }
      if (mt < 3) lora(mt);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(p[2 * np], af[mt], bl[np][0], bl[np][1]);
        mma_bf16(p[2 * np + 1], af[mt], bl[np][2], bl[np][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] += p[j][q];
    }
#pragma unroll
    for (int jt = 0; jt < RP / 8; ++jt)
#pragma unroll
      for (int q = 0; q < 4; ++q) xa[jt][q] += px[jt][q];
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

// ---------------------------------------------------------------------------
// f32 x: 3xTF32 mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 32;      // block tile, K step
constexpr int kTfMmaWarps = 4;                // 2 (M) x 2 (N), 32 x 32 each
constexpr int kTfDecWarps = 4;                // the loads and the decode
constexpr int kTfMmaThreads = 32 * kTfMmaWarps;
constexpr int kTfDecThreads = 32 * kTfDecWarps;
constexpr int kTfThreads = kTfMmaThreads + kTfDecThreads;
// Scales a row of the tile spans at qblock >= 8: (FN - 1) / 8 + 2.
constexpr int kTfScaleW = (FN - 1) / 8 + 2;

// x as hi + lo, both TF32 (10 mantissa bits): hi = x rounded to nearest
// with ties away from zero (cvt.rna.tf32.f32's result, on the bit pattern:
// half of the 13 dropped bits added, then cleared), lo = x - hi (exact in
// f32) truncated to TF32.  hi + lo is within 2**-21 of x, relative.
// Integer ops run at 64 lanes a clock an SM, cvt at 16.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a . b: m16n8k8, tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Float offset of element (row, col) of the raw x tile [FM][FK] f32: its
// 16-byte chunks XOR-ed with row % 8, so that an A fragment's 32 reads (rows
// gr and gr + 8, columns tig and tig + 4 of a k8 slice) hit 32 banks.
__device__ __forceinline__ int swz_xf(int row, int col) {
  return row * FK + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// Dynamic shared memory of the f32 kernel, in bytes.  A ring of kStages raw
// stages, as loaded (x f32, the packed codes, the rows' scales, the A
// tile), and two decoded stages of fragment tiles: lane l's 16 bytes of
// fragment (i, ks) at [i][ks][l], so that a warp reads a fragment with one
// conflict-free 16-byte load a lane.  w: [ks][nt] of (b0 hi, b1 hi, b0 lo,
// b1 lo); A: [ks][jt] likewise; x: hi and lo tiles of (a0, a1, a2, a3) at
// [mt][ks].  The epilogue's x . A and B tiles reuse the front.
template <int RP>
struct TfSmem {
  static constexpr int kX = FM * FK * 4;                  // 8,192
  static constexpr int kCodes = FK * FN / 2;              // 1,024
  static constexpr int kScales = FK * kTfScaleW * 4;      // 1,152
  static constexpr int kA = FK * RP * 4;
  static constexpr int kRaw = kX + kCodes + kScales + kA;
  static constexpr int kW = 2 * FK * FN * 4;              // 16,384
  static constexpr int kAF = 2 * FK * RP * 4;
  static constexpr int kXF = 2 * FM * FK * 4;             // 16,384
  static constexpr int kDec = kW + kAF + kXF;
  static constexpr int kMain = kStages * kRaw + 2 * kDec;
  static constexpr int kEpi = (FM * (RP + 1) + RP * FN) * 4;
  static constexpr int kBytes = kMain > kEpi ? kMain : kEpi;
};

// RP: r rounded up to 8, 16, 32 or 64.  SMALLQ: qblock < 8 (as in
// qlora_mma_kernel).  Warp roles: warps 0-3 issue the cp.async of step
// kt + kStages - 1's x tile and run the MMAs of step kt on decoded stage
// kt % 2; warps 4-7 issue the cp.async of that step's codes, scales and A
// values and decode raw step kt + 1 into the other decoded stage.  One
// barrier a step.
template <int RP, bool SMALLQ>
__global__ void __launch_bounds__(kTfThreads, 1)
qlora_tf32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wq,
                  const float* __restrict__ absmax,
                  const float* __restrict__ la, const float* __restrict__ lb,
                  const float* __restrict__ code, float* __restrict__ y,
                  int M, int N, int K, int r, int qblock, float s, int xvec) {
  using Sm = TfSmem<RP>;
  constexpr int JT = RP / 8;                  // n8 tiles of x . A
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float book[16];
  auto raw = [&](int kt) { return smem + (kt % kStages) * Sm::kRaw; };
  auto xs = [&](int kt) { return reinterpret_cast<float*>(raw(kt)); };
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
  auto wf = [&](int kt) { return reinterpret_cast<uint4*>(dec(kt)); };
  auto af = [&](int kt) {
    return reinterpret_cast<uint4*>(dec(kt) + Sm::kW);
  };
  auto xf = [&](int kt) {                     // x hi, then x lo at + FM FK / 4
    return reinterpret_cast<uint4*>(dec(kt) + Sm::kW + Sm::kAF);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool mma_warp = warp < kTfMmaWarps;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int half = N / 2;
  const int nblk = N / qblock;
  if (tid < 16) book[tid] = code[tid];
  // 16-byte code rows: N a multiple of 32 and wq 16-byte aligned
  const bool cvec = N % 32 == 0 &&
                    (reinterpret_cast<uintptr_t>(wq) & 15u) == 0;

  // ---- the decode warps' share of w: K rows kk0 = 8 ks + tig and kk0 + 4
  // of a step, columns col .. col + 7 (n8 tile nt): lanes (gr, tig) of
  // fragment (ks, nt) for gr = 0..7.
  const int dt = tid - kTfMmaThreads;         // 0 .. 127 in the decode warps
  const int dks = (dt >> 5) & 3, dtig = dt & 3, dnt = (dt >> 2) & 7;
  const int blk0 = n0 / qblock;               // the tile's first scale
  const int sw = (min(n0 + FN, N) - 1) / qblock - blk0 + 1;  // its scales
  const int col = n0 + dnt * 8;
  const int sidx = min(col, N - 1) / qblock - blk0;
  unsigned inside = 0u, upper = 0u;           // per column: < N; next scale
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (col + i < N) inside |= 1u << i;
    if (!SMALLQ && col + i < N && (col + i) / qblock != col / qblock)
      upper |= 1u << i;
  }

  // Step kt's loads into its raw stage (zeros past K, M and N): cp.async
  // where the layout allows (xvec, cvec), else plain loads.  The MMA warps
  // take the x tile when its rows are 16-byte aligned (load_x, four
  // 16-byte chunks a thread), the decode warps the rest (load).
  auto load_x = [&](int kt) {
    if (!xvec) return;
    const int k0 = kt * FK;
    float* xd = xs(kt);
#pragma unroll
    for (int q = 0; q < FM * FK / 4 / kTfMmaThreads; ++q) {
      const int e = tid + q * kTfMmaThreads;
      const int row = e >> 3, ch = e & 7;
      const int gm = m0 + row, gk = k0 + ch * 4;
      const bool valid = gm < M && gk < K;
      const float* src = valid ? x + static_cast<long long>(gm) * K + gk : x;
      cp_async16(xd + swz_xf(row, ch * 4), src, valid);
    }
  };
  auto load = [&](int kt) {
    const int k0 = kt * FK;
    if (!xvec) {
      float* xd = xs(kt);
      for (int e = dt; e < FM * FK; e += kTfDecThreads) {
        const int row = e / FK, kk = e % FK;
        const int gm = m0 + row, gk = k0 + kk;
        xd[swz_xf(row, kk)] =
            (gm < M && gk < K) ? x[static_cast<long long>(gm) * K + gk] : 0.0f;
      }
    }
    if (dt < FK * 2) {                // codes: row dt / 2, bytes 16 (dt % 2)
      const int kk = dt >> 1, q = dt & 1;
      const int k = k0 + kk;
      const int c = n0 + q * 32;      // the chunk's first column
      uint8_t* cd = rcodes(kt) + kk * (FN / 2) + q * 16;
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
    if constexpr (!SMALLQ) {          // the rows' scales: [FK][kTfScaleW]
      float* sd = rscales(kt);
      for (int e = dt; e < FK * sw; e += kTfDecThreads) {
        const int row = e / sw, j = e % sw;
        const bool valid = k0 + row < K;
        cp_async4(sd + row * kTfScaleW + j,
                  absmax + (valid ? static_cast<long long>(k0 + row) * nblk +
                                        blk0 + j
                                  : 0),
                  valid);
      }
    }
    float* ad = ra(kt);
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) {
      const int e = dt + i * kTfDecThreads;
      const int kk = e / RP, j = e % RP;
      const bool valid = k0 + kk < K && j < r;
      cp_async4(ad + e,
                la + (valid ? static_cast<long long>(k0 + kk) * r + j : 0),
                valid);
    }
  };

  // Raw step kt into decoded stage kt: the thread's 16 weights (8 columns
  // of rows kk0 and kk0 + 4) as TF32 halves, and its shares of the A tile
  // and of the x tile (lane `lane` of A fragment (mt, dks) for each mt).
  auto decode = [&](int kt) {
    const int kk0 = dks * 8 + dtig;
    const uint8_t* cd = rcodes(kt) + dnt * 4;
    const float* sd = rscales(kt);
    const float* am0 = nullptr;
    const float* am1 = nullptr;
    if constexpr (SMALLQ) {
      const int k = kt * FK + kk0;
      if (k < K) am0 = absmax + static_cast<long long>(k) * nblk;
      if (k + 4 < K) am1 = absmax + static_cast<long long>(k + 4) * nblk;
    }
    // Every shared-memory read first, every store last.
    const uint32_t codes0 = *reinterpret_cast<const uint32_t*>(
        cd + kk0 * (FN / 2));
    const uint32_t codes1 = *reinterpret_cast<const uint32_t*>(
        cd + (kk0 + 4) * (FN / 2));
    float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
    if constexpr (!SMALLQ) {
      s00 = sd[kk0 * kTfScaleW + sidx];
      s10 = sd[(kk0 + 4) * kTfScaleW + sidx];
      if (upper) {
        s01 = sd[kk0 * kTfScaleW + sidx + 1];
        s11 = sd[(kk0 + 4) * kTfScaleW + sidx + 1];
      }
    }
    float c0[8], c1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b0 = (codes0 >> (8 * (i / 2))) & 0xffu;
      const uint32_t b1 = (codes1 >> (8 * (i / 2))) & 0xffu;
      c0[i] = book[i % 2 == 0 ? b0 >> 4 : b0 & 0xfu];
      c1[i] = book[i % 2 == 0 ? b1 >> 4 : b1 & 0xfu];
    }
    float av[2][RP / 8];                // 16 RP fragment lanes of A
#pragma unroll
    for (int i = 0; i < RP / 8; ++i) {
      const int f = dt + i * kTfDecThreads;   // lane f % 32 of fragment f / 32
      const int fl = f & 31, fb = f >> 5;
      const int kk = (fb / JT) * 8 + (fl & 3), j = (fb % JT) * 8 + (fl >> 2);
      av[0][i] = ra(kt)[kk * RP + j];
      av[1][i] = ra(kt)[(kk + 4) * RP + j];
    }
    float xv[4][4];
    const float* xr = xs(kt);
    const int xc = dks * 8 + (lane & 3);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + (lane >> 2);
      xv[mt][0] = xr[swz_xf(row, xc)];
      xv[mt][1] = xr[swz_xf(row + 8, xc)];
      xv[mt][2] = xr[swz_xf(row, xc + 4)];
      xv[mt][3] = xr[swz_xf(row + 8, xc + 4)];
    }
    uint4 wo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float sc0, sc1;
      const bool in = (inside >> i) & 1u;
      if constexpr (SMALLQ) {
        sc0 = (am0 && in) ? __ldg(am0 + (col + i) / qblock) : 0.0f;
        sc1 = (am1 && in) ? __ldg(am1 + (col + i) / qblock) : 0.0f;
      } else {
        const bool up = (upper >> i) & 1u;
        sc0 = up ? s01 : s00;
        sc1 = up ? s11 : s10;
      }
      split_tf32(in ? c0[i] * sc0 : 0.0f, wo[i].x, wo[i].z);
      split_tf32(in ? c1[i] * sc1 : 0.0f, wo[i].y, wo[i].w);
    }
    uint4* wd = wf(kt) + (dks * 8 + dnt) * 32;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wd[(i * 4 + dtig) ^ ((dnt & 1) << 2)] = wo[i];
#pragma unroll
    for (int i = 0; i < RP / 8; ++i) {
      uint4 o;
      split_tf32(av[0][i], o.x, o.z);
      split_tf32(av[1][i], o.y, o.w);
      af(kt)[dt + i * kTfDecThreads] = o;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint4 h, l;
      split_tf32(xv[mt][0], h.x, l.x);
      split_tf32(xv[mt][1], h.y, l.y);
      split_tf32(xv[mt][2], h.z, l.z);
      split_tf32(xv[mt][3], h.w, l.w);
      const int o = (mt * 4 + dks) * 32 + lane;
      xf(kt)[o] = h;
      xf(kt)[FM * FK / 4 + o] = l;
    }
  };

  // ---- the MMA warps' share: a 32 x 32 tile of y (m16 tiles 2 wm, 2 wm +
  // 1; n8 tiles 4 wn .. 4 wn + 3) and x . A of m16 tile `warp` (= 2 wm +
  // wn, one of its own).  The tensor cores add an MMA's products into its
  // accumulator with truncation, not rounding, so a chain of them drifts
  // toward zero by up to an ulp of the accumulator each: 1,536 MMAs at
  // K = 4096 read 3.5e-4, over the limit.  Each step's MMAs run into zeroed
  // partials (pa, px: 12 MMAs a chain), which are added into acc and xa in
  // f32, rounded to nearest.
  const int wm = warp >> 1, wn = warp & 1;
  const int gr = lane >> 2, tig = lane & 3;   // fragment row / column
  float acc[2][4][4], pa[2][4][4];    // [m16 tile][n8 tile][fragment]
  float xa[JT][4], px[JT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
  for (int j = 0; j < JT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) xa[j][q] = 0.0f;

  // x . A's three products for n8 tile j of slice ks, on the x halves of
  // m16 tile `warp`.
  auto lora = [&](int kt, int ks, const uint32_t (&h)[4],
                  const uint32_t (&l)[4]) {
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const uint4 ab = af(kt)[(ks * JT + j) * 32 + lane];
      mma_tf32(px[j], l, ab.x, ab.y);
      mma_tf32(px[j], h, ab.z, ab.w);
      mma_tf32(px[j], h, ab.x, ab.y);
    }
  };
  // The MMAs of k8 slice ks of step kt into the partials: x_lo . w_hi for
  // the warp's 8 (m16, n8) tiles, then x_hi . w_lo, then x_hi . w_hi (each
  // partial's three products 8 MMAs apart, the small terms first), and
  // x . A's.
  auto mma_slice = [&](int kt, int ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int o = ((wm * 2 + mi) * 4 + ks) * 32 + lane;
      const uint4 h = xf(kt)[o];
      const uint4 l = xf(kt)[FM * FK / 4 + o];
      ah[mi][0] = h.x; ah[mi][1] = h.y; ah[mi][2] = h.z; ah[mi][3] = h.w;
      al[mi][0] = l.x; al[mi][1] = l.y; al[mi][2] = l.z; al[mi][3] = l.w;
    }
    uint4 b[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int nt = wn * 4 + ni;
      b[ni] = wf(kt)[(ks * 8 + nt) * 32 + (lane ^ ((nt & 1) << 2))];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_tf32(pa[mi][ni], al[mi], b[ni].x, b[ni].y);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_tf32(pa[mi][ni], ah[mi], b[ni].z, b[ni].w);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_tf32(pa[mi][ni], ah[mi], b[ni].x, b[ni].y);
    if (wn == 0)                      // warp-uniform
      lora(kt, ks, ah[0], al[0]);
    else
      lora(kt, ks, ah[1], al[1]);
  };
  auto mma_step = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[i][j][q] = 0.0f;
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) px[j][q] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < FK / 8; ++ks) mma_slice(kt, ks);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += pa[i][j][q];
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) xa[j][q] += px[j][q];
  };

  const int nk = (K + FK - 1) / FK;
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
      mma_step(kt);
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
  float* xas = reinterpret_cast<float*>(smem);          // [FM][RP + 1]
  float* bsm = xas + FM * (RP + 1);                     // [RP][FN]
  if (mma_warp) {
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const int row = warp * 16 + gr;
      const int c = j * 8 + 2 * tig;
      xas[row * (RP + 1) + c] = xa[j][0];
      xas[row * (RP + 1) + c + 1] = xa[j][1];
      xas[(row + 8) * (RP + 1) + c] = xa[j][2];
      xas[(row + 8) * (RP + 1) + c + 1] = xa[j][3];
    }
  }
  for (int e = tid; e < RP * FN; e += kTfThreads) {
    const int j = e / FN, c = e % FN;
    bsm[e] = (j < r && n0 + c < N)
                 ? lb[static_cast<long long>(j) * N + n0 + c] : 0.0f;
  }
  __syncthreads();
  if (!mma_warp) return;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int nl = wn * 32 + ni * 8 + 2 * tig;         // even; N is even
    if (n0 + nl >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rw = wm * 32 + mi * 16 + gr;           // rows rw, rw + 8
      float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int j = 0; j < RP; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bsm + j * FN + nl);
        const float xa0 = xas[rw * (RP + 1) + j];
        const float xa1 = xas[(rw + 8) * (RP + 1) + j];
        l[0] = fmaf(xa0, bv.x, l[0]);
        l[1] = fmaf(xa0, bv.y, l[1]);
        l[2] = fmaf(xa1, bv.x, l[2]);
        l[3] = fmaf(xa1, bv.y, l[3]);
      }
      const float* c = acc[mi][ni];
      const long long o = static_cast<long long>(m0 + rw) * N + n0 + nl;
      if (m0 + rw < M)
        *reinterpret_cast<float2*>(y + o) =
            make_float2(c[0] + s * l[0], c[1] + s * l[1]);
      if (m0 + rw + 8 < M)
        *reinterpret_cast<float2*>(y + o + 8LL * N) =
            make_float2(c[2] + s * l[2], c[3] + s * l[3]);
    }
  }
}

template <int RP, bool SMALLQ>
int launch_tf32_instance(const void* x, const void* wq, const void* absmax,
                         const void* la, const void* lb, const void* code,
                         void* y, int M, int N, int K, int r, int qblock,
                         float s, int xvec, cudaStream_t st) {
  static bool ready[64] = {};
  constexpr int bytes = TfSmem<RP>::kBytes;
  const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  if (grid.y > 65535) return -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (!ready[dev]) {
    if (cudaFuncSetAttribute(qlora_tf32_kernel<RP, SMALLQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    ready[dev] = true;
  }
  qlora_tf32_kernel<RP, SMALLQ><<<grid, kTfThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(absmax), static_cast<const float*>(la),
      static_cast<const float*>(lb), static_cast<const float*>(code),
      static_cast<float*>(y), M, N, K, r, qblock, s, xvec);
  return 0;
}

int launch_tf32(int rp, const void* x, const void* wq, const void* absmax,
                const void* la, const void* lb, const void* code, void* y,
                int M, int N, int K, int r, int qblock, float s, int xvec,
                cudaStream_t st) {
#define QLORA_TF32_RANK(R)                                                    \
  case R:                                                                     \
    return qblock < 8                                                         \
        ? launch_tf32_instance<R, true>(x, wq, absmax, la, lb, code, y, M, N, \
                                        K, r, qblock, s, xvec, st)            \
        : launch_tf32_instance<R, false>(x, wq, absmax, la, lb, code, y, M,   \
                                         N, K, r, qblock, s, xvec, st);
  switch (rp) {
    QLORA_TF32_RANK(8)
    QLORA_TF32_RANK(16)
    QLORA_TF32_RANK(32)
    QLORA_TF32_RANK(64)
    default:
      return -1;
  }
#undef QLORA_TF32_RANK
}

}  // namespace

// x (M, K) of x_bf16 ? bf16 : f32 and y (M, N) of the same type; wq (K,
// N/2) u8; absmax (K, N/qblock), la (K, r), lb (r, N), code (16) f32; all
// contiguous, lb 8-byte aligned.  1 <= r <= 64, N % qblock == 0, N even.
// xvec: x rows may be read as 16-byte chunks (K a whole number of them, x
// 16-byte aligned).  bf16 launches qlora_mma_kernel, f32 qlora_tf32_kernel.
extern "C" int qm_qlora_matmul(const void* x, int x_bf16, const void* wq,
                               const void* absmax, const void* la,
                               const void* lb, const void* code, void* y,
                               int M, int N, int K, int r, int qblock,
                               float s, int xvec, void* stream) {
  if (M < 1 || N < 2 || K < 1 || r < 1 || r > 64 || qblock < 1 ||
      N % 2 != 0 || N % qblock != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rp = 8;
  while (rp < r) rp *= 2;
  const int rc = x_bf16 ? launch_mma(rp, x, wq, absmax, la, lb, code, y, M, N,
                                     K, r, qblock, s, xvec, st)
                        : launch_tf32(rp, x, wq, absmax, la, lb, code, y, M,
                                      N, K, r, qblock, s, xvec, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
