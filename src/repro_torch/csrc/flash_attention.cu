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
// does 8.6 GFLOP causal: in bf16 8.7 us at 989 TFLOP/s; in f32, with each
// product taken as three TF32 products on the tensor cores, 25.8 GFLOP,
// 0.052 ms at TF32's 494.7 TFLOP/s).  The first port of this kernel
// converted every K / V tile to f32 in shared memory and had four lanes
// share a query row, so each 16-byte shared-memory load fed 4 FMAs:
// shared-memory wavefronts, not arithmetic, set its pace, and its 137
// registers a thread left one block an SM (two waves at the fit's shape).
// Two kernels replace it, one for each type:
//
// bf16 (fa_mma_kernel): the tensor cores.  A block of 4 warps owns 64 query
// rows of one (b, h), 16 a warp, and walks key tiles of 64.  K / V tiles stay
// bf16 in shared memory (32 KB for K + V at D 128, XOR-swizzled 16-byte
// chunks so that ldmatrix reads no bank twice) and are double-buffered with
// cp.async: the next tile is on its way while this one is used, and a
// tile's V while its scores are computed.
// S = Q . K^T runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with Q
// and K fragments loaded by ldmatrix; the products are exact and the sums
// f32, so this is the f32 arithmetic up to the order of the sums.  The
// online softmax stays in f32 registers (a row's max and sum over the four
// lanes that hold it).  P . V keeps p at about 16 bits: p = p_hi + p_lo,
// p_hi = bf16(p), p_lo = bf16(p - p_hi), two MMAs into one f32 accumulator,
// V fragments by ldmatrix.trans.  At D 128, 80 KB of shared memory and
// ~234 registers a thread give two blocks an SM: the fit's 256 blocks run
// in one wave.
//
// f32 (fa_tf32_kernel): the tensor cores in 3xTF32.  The CUDA cores' f32
// FMAs (67 TFLOP/s; the register-tiled kernel before this one reached
// 19.5) are slower than three TF32 products at 494.7.  Each f32 operand x
// is split as x_hi = x rounded to TF32 (10 mantissa bits, nearest, ties
// away: cvt.rna's result, computed with integer ops on the bit pattern,
// since cvt runs at a quarter of their rate) and x_lo = x - x_hi truncated
// to TF32, and a . b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi on
// mma.sync.m16n8k8 (tf32 in, f32 accumulate): the products are exact and
// the dropped a_lo b_lo is 2**-22 of the product, so the result keeps the
// f32 limit; one TF32 product alone misses it
// (tests/test_torch_kernel_designs.py emulates both).  As in the bf16
// kernel a block of 4 warps owns 64 query rows, 16 a warp, and K and V
// tiles are double-buffered with cp.async; here a tile is 32 keys, copied
// raw (16 KB each at D 128, XOR-swizzled 16-byte chunks).  Q is split once,
// as it leaves shared memory, into 128 registers of TF32 halves; the K and
// V values are split by each warp as it loads its fragments (float4 loads:
// the fragments' k and output columns are permuted so that a lane's
// operands are contiguous), and p as it leaves the score tile, whose C
// fragment is P's A fragment.  The online softmax is f32.  A key tile
// wholly above a warp's rows is skipped by that warp.  At D 128, 96 KB of
// shared memory and ~250 registers a thread give two blocks an SM.
//
// Both: the finite -FLT_MAX fill; key tiles wholly above the causal
// diagonal are skipped (the TPU kernel visits them masked; their
// probabilities underflow to exactly 0, so skipping changes nothing); the
// blocks with the most tiles start first; a ragged S needs no padding (keys
// past S read as zeros under the fill, query rows past S are not written).
// The dynamic shared-memory limit is raised once a device, on the first
// launch, which callers make before any CUDA-graph capture.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 64;       // keys a tile
constexpr float kFill = -FLT_MAX;   // the reference's finfo(f32).min
constexpr unsigned kAll = 0xffffffffu;

// Raise a kernel's dynamic shared-memory limit once a device.
template <typename Kernel>
int ensure_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (!ready[dev]) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    ready[dev] = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;    // 4 warps x 16 query rows (both types)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16
// tile whose chunks are XOR-swizzled by the row's low three bits.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Rows r0 .. r0 + 63 of a (S, D) head into a swizzled tile; rows past S
// are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* g, int r0,
                                          int S) {
  constexpr int CPR = D / 8;          // 16-byte chunks a row
  for (int e = threadIdx.x; e < BKV * CPR; e += kMmaThreads) {
    const int r = e / CPR, ch = e % CPR;
    const bool valid = r0 + r < S;
    const __nv_bfloat16* src =
        valid ? g + static_cast<long long>(r0 + r) * D + ch * 8 : g;
    cp_async16(tile + swz<D>(r, ch), src, valid);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads, 2)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, float scale) {
  constexpr int KS = D / 16;          // k-steps of Q . K^T
  constexpr int NT = BKV / 8;         // key n-tiles of a score tile
  constexpr int DT = D / 8;           // d n-tiles of the output
  extern __shared__ __align__(128) __nv_bfloat16 smem_h[];
  __nv_bfloat16* qs = smem_h;                       // [BQ][D]
  __nv_bfloat16* ks = qs + BQ * D;                  // [2][BKV][D]
  __nv_bfloat16* vs = ks + 2 * BKV * D;             // [2][BKV][D]

  const int tile = gridDim.x - 1 - blockIdx.x;      // longest first
  const long long head = static_cast<long long>(blockIdx.y) * S * D;
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;         // fragment row / column
  const int row_a = q0 + warp * 16 + gr;            // the lane's two rows
  const int row_b = row_a + 8;

  const int kv_end = CAUSAL ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  // cp.async groups in order: {Q, K0}, {V0}, then {K t+1}, {V t+1} for
  // each tile t, so that Q . K^T runs while V is on its way.
  load_tile<D>(qs, q + head, q0, S);
  load_tile<D>(ks, k + head, 0, S);
  cp_async_commit();
  load_tile<D>(vs, v + head, 0, S);
  cp_async_commit();

  uint32_t qf[KS][4];
  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[j][i] = 0.f;
  float m[2] = {kFill, kFill}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const bool next = t + 1 < n_tiles;
    if (next) {
      load_tile<D>(ks + (st ^ 1) * BKV * D, k + head, (t + 1) * BKV, S);
      cp_async_commit();
      load_tile<D>(vs + (st ^ 1) * BKV * D, v + head, (t + 1) * BKV, S);
      cp_async_commit();
      cp_async_wait<3>();               // K t is in
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qf[kk], qs + swz<D>(r, kk * 2 + (lane >> 4)));
      }
    }
    const __nv_bfloat16* kt = ks + st * BKV * D;
    const __nv_bfloat16* vt = vs + st * BKV * D;
    const int k0 = t * BKV;

    // S = Q . K^T for the warp's 16 rows x 64 keys.
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, kt + swz<D>(key, kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(sacc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // Scale, mask, online softmax (rows row_a: i 0-1, row_b: i 2-3).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * tig + (i & 1);
        const int row = i < 2 ? row_a : row_b;
        const bool keep = key < S && (!CAUSAL || key <= row);
        const float x = keep ? sacc[j][i] * scale : kFill;
        sacc[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sacc[j][i] - m[i >> 1]);
        sacc[j][i] = p;
        l[i >> 1] += p;
      }
    }

    if (next)                           // V t is in
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // O += P . V, with P as p_hi + p_lo (two bf16 MMAs).
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      const float* c0 = sacc[2 * kk];
      const float* c1 = sacc[2 * kk + 1];
      const float src[4][2] = {{c0[0], c0[1]}, {c0[2], c0[3]},
                               {c1[0], c1[1]}, {c1[2], c1[3]}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(src[i][0], src[i][1]);
        ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[i] = pack_bf16(src[i][0] - __low2float(hi),
                          src[i][1] - __high2float(hi));
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vt + swz<D>(key, dp * 2 + (lane >> 4)));
        mma_bf16(oacc[2 * dp], ph, b[0], b[1]);
        mma_bf16(oacc[2 * dp], pl, b[0], b[1]);
        mma_bf16(oacc[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(oacc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                  // this stage is refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kAll, l[r], 1);
    l[r] += __shfl_xor_sync(kAll, l[r], 2);
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * tig;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + head + static_cast<long long>(row_a) * D + col) =
          __floats2bfloat162_rn(oacc[j][0] * l[0], oacc[j][1] * l[0]);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + head + static_cast<long long>(row_b) * D + col) =
          __floats2bfloat162_rn(oacc[j][2] * l[1], oacc[j][3] * l[1]);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTf32Keys = 32;       // keys a tile

// x as hi + lo, both TF32 (10 mantissa bits): hi = x rounded to nearest
// with ties away from zero (cvt.rna.tf32.f32's result, on the bit pattern:
// half of the 13 dropped bits added, then cleared), lo = x - hi (exact in
// f32) truncated to TF32.  hi + lo is within 2**-21 of x, relative.  Integer
// and f32 adds run at 64 and 128 lanes a clock an SM, cvt at 16.
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

// c += a . b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, 2**-22
// of the product, is dropped), the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Float offset of 16-byte chunk `chunk` of row `row` in a [rows][D] f32
// tile, the chunks XOR-swizzled by the row: bit 2 by its parity, bits 0-1 by
// row / 2.  The Q and K fragments' float4 loads (rows gr + 8 i, chunks 4c +
// tig) and the V fragments' (rows 2 tig and 2 tig + 1, chunks gr * D / 32 +
// cc) then read no bank twice in a quarter-warp at D 128 (V at D 64: twice).
template <int D>
__device__ __forceinline__ int swz_f32(int row, int chunk) {
  return row * D + ((chunk ^ (((row & 1) << 2) | ((row >> 1) & 3))) << 2);
}

// Rows r0 .. r0 + ROWS - 1 of a (S, D) f32 head into a swizzled tile; rows
// past S are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* g,
                                              int r0, int S) {
  constexpr int CPR = D / 4;          // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CPR; e += kMmaThreads) {
    const int r = e / CPR, ch = e % CPR;
    const bool valid = r0 + r < S;
    const float* src =
        valid ? g + static_cast<long long>(r0 + r) * D + ch * 4 : g;
    cp_async16(tile + swz_f32<D>(r, ch), src, valid);
  }
}

// 4 warps of 16 query rows a block, as in the bf16 kernel.  The fragments'
// k index is permuted so that a lane's operands lie side by side: in k-step
// h of a 16-wide d chunk c, a lane's A columns tig and tig + 4 are d = 16 c
// + 4 tig + 2 h and + 1 (one float4 of Q or K serves both k-steps), and in
// P . V a lane's A columns tig and tig + 4 are keys 2 tig and 2 tig + 1,
// which is where the score tile's C fragment holds them (no shuffles).  The
// output columns are permuted too: n-tile j's column n is d = n * D / 8 +
// j, so a lane's V operands are D / 8 consecutive floats of one row and its
// outputs D / 8 consecutive floats of each of its rows.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads)
fa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S,
               float scale) {
  constexpr int KC = D / 16;          // 16-wide d chunks: two k-steps each
  constexpr int NT = kTf32Keys / 8;   // key n-tiles of a score tile
  constexpr int DT = D / 8;           // output n-tiles
  constexpr int VC = D / 32;          // float4s of a V row a lane reads
  constexpr int TILE = kTf32Keys * D;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                 // [BQ][D]
  float* ks = qs + BQ * D;            // [2][32][D]
  float* vs = ks + 2 * TILE;          // [2][32][D]

  const int tile = gridDim.x - 1 - blockIdx.x;      // longest first
  const long long head = static_cast<long long>(blockIdx.y) * S * D;
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;         // fragment row / column
  const int row_a = q0 + warp * 16 + gr;            // the lane's two rows
  const int row_b = row_a + 8;
  const int warp_last = q0 + warp * 16 + 15;        // the warp's last row

  const int kv_end = CAUSAL ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + kTf32Keys - 1) / kTf32Keys;

  // cp.async groups in order: {Q, K0}, {V0}, then {K t+1}, {V t+1} for each
  // tile t, so that Q . K^T runs while V is on its way.
  load_tile_f32<D, BQ>(qs, q + head, q0, S);
  load_tile_f32<D, kTf32Keys>(ks, k + head, 0, S);
  cp_async_commit();
  load_tile_f32<D, kTf32Keys>(vs, v + head, 0, S);
  cp_async_commit();

  // The lane's Q, split once into TF32 halves as it leaves shared memory:
  // the A fragments of k-steps 2 c and 2 c + 1 (rows row_a, row_b; d = 16 c
  // + 4 tig + 2 h and + 1).
  uint32_t qh[KC][2][4], ql[KC][2][4];
  cp_async_wait<1>();                 // Q and K0 are in
  __syncthreads();
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const float4 qa = *reinterpret_cast<const float4*>(
        qs + swz_f32<D>(warp * 16 + gr, 4 * c + tig));
    const float4 qb = *reinterpret_cast<const float4*>(
        qs + swz_f32<D>(warp * 16 + gr + 8, 4 * c + tig));
    const float qv[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                            {qb.x, qb.y, qb.z, qb.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split_tf32(qv[0][2 * h], qh[c][h][0], ql[c][h][0]);
      split_tf32(qv[1][2 * h], qh[c][h][1], ql[c][h][1]);
      split_tf32(qv[0][2 * h + 1], qh[c][h][2], ql[c][h][2]);
      split_tf32(qv[1][2 * h + 1], qh[c][h][3], ql[c][h][3]);
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[j][i] = 0.f;
  float m[2] = {kFill, kFill}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const bool next = t + 1 < n_tiles;
    if (next) {
      load_tile_f32<D, kTf32Keys>(ks + (st ^ 1) * TILE, k + head,
                                  (t + 1) * kTf32Keys, S);
      cp_async_commit();
      load_tile_f32<D, kTf32Keys>(vs + (st ^ 1) * TILE, v + head,
                                  (t + 1) * kTf32Keys, S);
      cp_async_commit();
      cp_async_wait<3>();               // K t is in
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const float* kt = ks + st * TILE;
    const float* vt = vs + st * TILE;
    const int k0 = t * kTf32Keys;
    // a key tile wholly above the warp's rows adds nothing: skipped
    const bool active = !CAUSAL || k0 <= warp_last;

    // S = Q . K^T for the warp's 16 rows x 32 keys, then the online softmax
    // (rows row_a: i 0-1, row_b: i 2-3).
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[j][i] = 0.f;
    if (active) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kt + swz_f32<D>(nt * 8 + gr, 4 * c + tig));
          const float b0[2] = {kk.x, kk.y}, b1[2] = {kk.z, kk.w};
          mma_3xtf32(sacc[nt], qh[c][0], ql[c][0], b0);
          mma_3xtf32(sacc[nt], qh[c][1], ql[c][1], b1);
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + j * 8 + 2 * tig + (i & 1);
          const int row = i < 2 ? row_a : row_b;
          const bool keep = key < S && (!CAUSAL || key <= row);
          const float x = keep ? sacc[j][i] * scale : kFill;
          sacc[j][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        oacc[j][0] *= corr[0];
        oacc[j][1] *= corr[0];
        oacc[j][2] *= corr[1];
        oacc[j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(sacc[j][i] - m[i >> 1]);
          sacc[j][i] = p;
          l[i >> 1] += p;
        }
      }
    }

    if (next)                           // V t is in
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // O += P . V, P's A fragment straight from the score tile's C fragment.
    if (active) {
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(sacc[kk][0], ph[0], pl[0]);
        split_tf32(sacc[kk][2], ph[1], pl[1]);
        split_tf32(sacc[kk][1], ph[2], pl[2]);
        split_tf32(sacc[kk][3], ph[3], pl[3]);
        const int key = kk * 8 + 2 * tig;
#pragma unroll
        for (int cc = 0; cc < VC; ++cc) {
          const float4 v0 = *reinterpret_cast<const float4*>(
              vt + swz_f32<D>(key, gr * VC + cc));
          const float4 v1 = *reinterpret_cast<const float4*>(
              vt + swz_f32<D>(key + 1, gr * VC + cc));
          const float b[4][2] = {{v0.x, v1.x}, {v0.y, v1.y}, {v0.z, v1.z},
                                 {v0.w, v1.w}};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma_3xtf32(oacc[4 * cc + e], ph, pl, b[e]);
        }
      }
    }
    __syncthreads();                  // this stage is refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kAll, l[r], 1);
    l[r] += __shfl_xor_sync(kAll, l[r], 2);
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  // the lane's columns n = 2 tig and 2 tig + 1 of n-tile j are d = n * DT + j
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= S) continue;
    float* dst = o + head + static_cast<long long>(row) * D;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < DT; j += 4)
        *reinterpret_cast<float4*>(dst + (2 * tig + n) * DT + j) =
            make_float4(oacc[j][2 * r + n] * l[r],
                        oacc[j + 1][2 * r + n] * l[r],
                        oacc[j + 2][2 * r + n] * l[r],
                        oacc[j + 3][2 * r + n] * l[r]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
int launch_mma(const void* q, const void* k, const void* v, void* o, int BH,
               int S, float scale, cudaStream_t st) {
  constexpr int kSmem = 5 * BQ * D * static_cast<int>(sizeof(__nv_bfloat16));
  static bool ready[64] = {};
  const int rc = ensure_smem(fa_mma_kernel<D, CAUSAL>, kSmem, ready);
  if (rc != 0) return rc;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  fa_mma_kernel<D, CAUSAL><<<grid, kMmaThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, scale);
  return 0;
}

template <int D, bool CAUSAL>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int BH,
                int S, float scale, cudaStream_t st) {
  constexpr int kSmem =
      (BQ + 4 * kTf32Keys) * D * static_cast<int>(sizeof(float));
  static bool ready[64] = {};
  const int rc = ensure_smem(fa_tf32_kernel<D, CAUSAL>, kSmem, ready);
  if (rc != 0) return rc;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  fa_tf32_kernel<D, CAUSAL><<<grid, kMmaThreads, kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale);
  return 0;
}

template <int D>
int launch_d(int bf16, int causal, const void* q, const void* k,
             const void* v, void* o, int BH, int S, float scale,
             cudaStream_t st) {
  if (bf16)
    return causal ? launch_mma<D, true>(q, k, v, o, BH, S, scale, st)
                  : launch_mma<D, false>(q, k, v, o, BH, S, scale, st);
  return causal ? launch_tf32<D, true>(q, k, v, o, BH, S, scale, st)
                : launch_tf32<D, false>(q, k, v, o, BH, S, scale, st);
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
  int rc = -1;
  if (D == 64)
    rc = launch_d<64>(bf16, causal, q, k, v, o, BH, S, scale, st);
  else if (D == 128)
    rc = launch_d<128>(bf16, causal, q, k, v, o, BH, S, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
