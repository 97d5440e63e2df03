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
// f32 does 8.6 GFLOP causal, 0.13 ms at the f32 rate of 67 TFLOP/s).  The
// first port of this kernel converted every K / V tile to f32 in shared
// memory and had four lanes share a query row, so each 16-byte shared-memory
// load fed 4 FMAs: shared-memory wavefronts, not arithmetic, set its pace,
// and its 137 registers a thread left one block an SM (two waves at the
// fit's shape).  Two kernels replace it:
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
// f32 (fa_f32_kernel): register tiles on the CUDA cores (the f32 FMAs are
// kept, so the f32 limit holds).  A block of 128 threads owns 64 query rows
// and walks key tiles of 64.  Q^T and K^T are staged in shared memory
// (transposed once, on the way in), so a thread's 8 x 4 score tile takes
// two 16-byte loads of q and one of k per d for 32 FMAs; the scores go
// through shared memory (P^T, in K^T's place) to a thread's 8-row x 8-column
// tile of P . V, which takes four 16-byte loads per key for 64 FMAs.
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

constexpr int kMmaThreads = 128;    // 4 warps x 16 query rows

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
// f32: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 8;                      // query rows a thread
constexpr int kF32Threads = BQ / kRows * 16;  // row groups x 16 col groups
constexpr int kLd = BQ + 4;         // padded row of Q^T, K^T and P^T

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows r0 .. r0 + 63 of a (S, D) head, transposed into t[D][kLd]; rows past
// S are zeros.  A warp takes 32 rows of one 16-byte column chunk, so its
// shared-memory stores are 32 consecutive floats.
template <int D>
__device__ __forceinline__ void load_transposed(float* t, const float* g,
                                                int r0, int S) {
  for (int e = threadIdx.x; e < BQ * (D / 4); e += kF32Threads) {
    const int r = e % BQ, ch = e / BQ;
    const float4 x = r0 + r < S
                         ? __ldg(reinterpret_cast<const float4*>(
                               g + static_cast<long long>(r0 + r) * D +
                               ch * 4))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    t[(ch * 4 + 0) * kLd + r] = x.x;
    t[(ch * 4 + 1) * kLd + r] = x.y;
    t[(ch * 4 + 2) * kLd + r] = x.z;
    t[(ch * 4 + 3) * kLd + r] = x.w;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kF32Threads)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              float scale) {
  constexpr int RC = D / 64;          // float4 column chunks a thread owns
  constexpr int R4 = kRows / 4;       // float4s of a thread's rows
  extern __shared__ __align__(16) float smem_f[];
  float* qt = smem_f;                 // Q^T [D][kLd]
  float* kt = qt + D * kLd;           // K^T [D][kLd], then P^T [BKV][kLd]
  float* vt = kt + D * kLd;           // V [BKV][D]

  const int tile = gridDim.x - 1 - blockIdx.x;      // longest first
  const long long head = static_cast<long long>(blockIdx.y) * S * D;
  const int q0 = tile * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = ty * kRows;          // the thread's query rows
  const int c0 = tx * 4;              // its 4 keys; its columns c0 + 64 j

  load_transposed<D>(qt, q + head, q0, S);

  float acc[kRows][RC][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kFill;
    l[i] = 0.f;
  }

  const int kv_end = CAUSAL ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();                  // the last tile's readers are done
    load_transposed<D>(kt, k + head, k0, S);
    for (int e = threadIdx.x; e < BKV * (D / 4); e += kF32Threads) {
      const int j = e / (D / 4), d = (e % (D / 4)) * 4;
      const float4 x = k0 + j < S
                           ? __ldg(reinterpret_cast<const float4*>(
                                 v + head + static_cast<long long>(k0 + j) *
                                                D + d))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vt + j * D + d) = x;
    }
    __syncthreads();

    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows];
#pragma unroll
      for (int h = 0; h < R4; ++h) {
        const float4 x = ld4(qt + d * kLd + r0 + 4 * h);
        qv[4 * h] = x.x;
        qv[4 * h + 1] = x.y;
        qv[4 * h + 2] = x.z;
        qv[4 * h + 3] = x.w;
      }
      const float4 kk = ld4(kt + d * kLd + c0);
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, mask, online softmax; a row's 64 keys lie on the 16 lanes of
    // one half-warp (tx), so its max is four shuffles.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c0 + j;
        const bool keep = kj < S && (!CAUSAL || kj <= qi);
        s[i][j] = keep ? s[i][j] * scale : kFill;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < RC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        l[i] += s[i][j];
      }
    }
    __syncthreads();                  // K^T is read; P^T takes its place
    float* pt = kt;                   // P^T [BKV][kLd]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < R4; ++h)
        *reinterpret_cast<float4*>(pt + (c0 + j) * kLd + r0 + 4 * h) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                        s[4 * h + 3][j]);
    __syncthreads();

    const int n_keys = min(BKV, kv_end - k0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      float pv[kRows];
#pragma unroll
      for (int h = 0; h < R4; ++h) {
        const float4 x = ld4(pt + j * kLd + r0 + 4 * h);
        pv[4 * h] = x.x;
        pv[4 * h + 1] = x.y;
        pv[4 * h + 2] = x.z;
        pv[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < RC; ++cc) {
        const float4 vv = ld4(vt + j * D + cc * 64 + c0);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][cc][0] = fmaf(pv[i], vv.x, acc[i][cc][0]);
          acc[i][cc][1] = fmaf(pv[i], vv.y, acc[i][cc][1]);
          acc[i][cc][2] = fmaf(pv[i], vv.z, acc[i][cc][2]);
          acc[i][cc][3] = fmaf(pv[i], vv.w, acc[i][cc][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(kAll, li, off);
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int cc = 0; cc < RC; ++cc)
      *reinterpret_cast<float4*>(o + head + static_cast<long long>(qi) * D +
                                 cc * 64 + c0) =
          make_float4(acc[i][cc][0] * inv, acc[i][cc][1] * inv,
                      acc[i][cc][2] * inv, acc[i][cc][3] * inv);
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
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int S, float scale, cudaStream_t st) {
  constexpr int kSmem =
      (2 * D * kLd + BKV * D) * static_cast<int>(sizeof(float));
  static bool ready[64] = {};
  const int rc = ensure_smem(fa_f32_kernel<D, CAUSAL>, kSmem, ready);
  if (rc != 0) return rc;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  fa_f32_kernel<D, CAUSAL><<<grid, kF32Threads, kSmem, st>>>(
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
  return causal ? launch_f32<D, true>(q, k, v, o, BH, S, scale, st)
                : launch_f32<D, false>(q, k, v, o, BH, S, scale, st);
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
