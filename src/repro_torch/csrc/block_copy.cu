// Copy-on-write block move of the paged KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::paged_block_copy:
// physical block src's tile is copied to block dst in every layer of one
// layer-stacked pool leaf (L, n_blocks, ...).  The copy moves raw bytes, so
// it is exact for every leaf type (bf16/f32 K and V, int8 codes, bf16
// scales, int32 kv_pos).
//
// Unlike the reference, which returns a new array (`.at[:, dst].set`), this
// kernel updates the pool in place: the pool is one preallocated buffer and
// a copy of it per CoW event would move the whole pool.
//
// Bound on the H100: launch latency.  One event moves 2 * L * block bytes
// (28 layers x 32 KB per K or V leaf at qwen3-0.6b, block 16 = 1.8 MB),
// well under a microsecond of memory time at 3.35 TB/s.  Grid (chunks, L);
// 16-byte vector copies when the block size allows, else bytes.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(uint8_t* __restrict__ leaf, long long layer_bytes,
                  long long block_bytes, long long src, long long dst) {
  const long long n = block_bytes / static_cast<long long>(sizeof(W));
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  uint8_t* layer = leaf + static_cast<long long>(blockIdx.y) * layer_bytes;
  const W* s = reinterpret_cast<const W*>(layer + src * block_bytes);
  W* d = reinterpret_cast<W*>(layer + dst * block_bytes);
  d[i] = s[i];
}

}  // namespace

extern "C" int bc_block_copy(void* leaf, int L, long long n_blocks,
                             long long block_bytes, long long src,
                             long long dst, void* stream) {
  if (L < 1 || L > 65535 || src < 0 || dst < 0 || src >= n_blocks ||
      dst >= n_blocks || block_bytes < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long layer_bytes = n_blocks * block_bytes;
  const bool vec = block_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(leaf) % 16 == 0;
  const long long n = vec ? block_bytes / 16 : block_bytes;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), L);
  if (vec) {
    block_copy_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<uint8_t*>(leaf), layer_bytes, block_bytes, src, dst);
  } else {
    block_copy_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint8_t*>(leaf), layer_bytes, block_bytes, src, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
