// Copy-on-write block move of the paged KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::paged_block_copy:
// physical block src's tile is copied to block dst in every layer of a
// layer-stacked pool leaf (L, n_blocks, ...).  One launch copies every leaf
// of a copy-on-write event (K, V and kv_pos; an int8 pool adds K's and V's
// scales): up to kMaxLeaves leaf descriptors go to the kernel by value.  The
// copy moves raw bytes, so it is exact for every leaf type (bf16/f32 K and
// V, int8 codes, bf16 scales, int32 kv_pos).
//
// Unlike the reference, which returns a new array (`.at[:, dst].set`), this
// kernel updates the pool in place: the pool is one preallocated buffer and
// a copy of it per CoW event would move the whole pool.
//
// Bound on the H100: launch latency.  One event moves 2 * L * block bytes a
// leaf (qwen3-0.6b, 16-slot blocks: 28 layers x 32 KB for K and for V, 3.7
// MB in all, ~1.1 us at 3.35 TB/s), so its cost was the one launch a leaf
// (three an event).  Now an event is one launch.  The grid walks the
// leaves' (layer, chunk) units in order, a leaf's first block given by the
// host; each thread issues kUnroll 16-byte loads (bytes where a leaf's
// blocks are not 16-byte aligned) before its stores, so that more than one
// chunk a thread is in flight.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // loads in flight a thread
constexpr int kPerBlock = kThreads * kUnroll;  // elements a block copies
constexpr int kMaxLeaves = 8;

struct Leaf {
  uint8_t* base;
  long long layer_bytes;                     // n_blocks * block_bytes
  long long src_off, dst_off;                // src / dst * block_bytes
  long long n;                               // elements a block: 16 B or 1 B
  long long units;                           // grid blocks a layer
  long long first;                           // the leaf's first grid block
  int vec;                                   // 16-byte elements
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
};

template <typename W>
__device__ __forceinline__ void copy_unit(const Leaf& f, long long layer,
                                          long long chunk) {
  uint8_t* lp = f.base + layer * f.layer_bytes;
  const W* s = reinterpret_cast<const W*>(lp + f.src_off);
  W* d = reinterpret_cast<W*>(lp + f.dst_off);
  const long long i0 = chunk * kPerBlock + threadIdx.x;
  W v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + static_cast<long long>(u) * kThreads;
    if (i < f.n) v[u] = s[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + static_cast<long long>(u) * kThreads;
    if (i < f.n) d[i] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const __grid_constant__ Leaves a) {
  const long long b = blockIdx.x;
  int j = 0;
#pragma unroll
  for (int q = 1; q < kMaxLeaves; ++q)
    if (q < a.count && b >= a.leaf[q].first) j = q;
  const Leaf& f = a.leaf[j];
  const long long local = b - f.first;
  const long long layer = local / f.units, chunk = local % f.units;
  if (f.vec)
    copy_unit<uint4>(f, layer, chunk);
  else
    copy_unit<uint8_t>(f, layer, chunk);
}

}  // namespace

// Copies block src to block dst in every layer of each of the `count`
// leaves (count <= 8): leaf i at bases[i], layers[i] layers of n_blocks[i]
// blocks of block_bytes[i] bytes, contiguous.  One launch on `stream`.
extern "C" int bc_block_copy_leaves(int count, void* const* bases,
                                    const int* layers,
                                    const long long* n_blocks,
                                    const long long* block_bytes,
                                    long long src, long long dst,
                                    void* stream) {
  if (count < 1 || count > kMaxLeaves) return -1;
  Leaves a = {};
  a.count = count;
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    const long long bb = block_bytes[i], nb = n_blocks[i];
    if (layers[i] < 1 || bb < 1 || src < 0 || dst < 0 || src >= nb ||
        dst >= nb)
      return -1;
    Leaf& f = a.leaf[i];
    f.base = static_cast<uint8_t*>(bases[i]);
    f.layer_bytes = nb * bb;
    f.src_off = src * bb;
    f.dst_off = dst * bb;
    f.vec = bb % 16 == 0 && reinterpret_cast<uintptr_t>(bases[i]) % 16 == 0;
    f.n = f.vec ? bb / 16 : bb;
    f.units = (f.n + kPerBlock - 1) / kPerBlock;
    f.first = total;
    total += f.units * layers[i];
  }
  if (total > 0x7fffffffLL) return -1;
  block_copy_kernel<<<static_cast<unsigned>(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
