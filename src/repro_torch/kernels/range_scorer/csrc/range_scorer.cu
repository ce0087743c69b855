// Range-scorer kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kernels/range_scorer/kernel.py).
//
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so a refused launch is reported where it happened.
// The Python wrappers allocate the outputs and check device, dtype, shape
// and contiguity before any pointer reaches this file.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;       // postings per block (core.clustered_index.BLOCK)
constexpr int kPackDirBits = 27;  // core.clustered_index.PACK_DIR_BITS
constexpr int kScatterThreads = 256;
constexpr int64_t kScatterMaxCtas = 132 * 16;  // 16 CTAs per SM of an H100

// scatter_accumulate
//
// Replaces the TPU kernel _scatter_kernel, launched by
// scatter_accumulate_pallas (src/repro/kernels/range_scorer/kernel.py:47
// and :72): acc[s] = sum of vals[p] over ids[p] == s, for s in [0, s_pad);
// ids below 0 or at/after s_pad are dropped.
//
// Bound: bytes. Each posting is read once (id and value, 8 B) and the
// accumulator written once (4 B per slot); there is one add per posting.
// The TPU recast the scatter as a one-hot fp32 matmul because it has no
// per-element scatter; Hopper has integer atomics in L2, so the kernel is
// a direct scatter: one thread per posting (grid-stride), coalesced reads
// of ids and vals, and atomicAdd on int32 for the survivors. Integer
// addition is order-free, so the result is bitwise the one-hot product's.
// The wrapper zeroes acc. Zero values are skipped: padding lanes carry 0.
__global__ void __launch_bounds__(kScatterThreads)
scatter_accumulate_kernel(const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ vals, int64_t n,
                          int32_t* __restrict__ acc, int64_t s_pad) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int32_t id = ids[p];
    if (id >= 0 && id < s_pad) {
      const int32_t v = vals[p];
      if (v != 0) atomicAdd(acc + id, v);
    }
  }
}

// unpack_locals
//
// Replaces the TPU kernel _unpack_kernel, launched by unpack_locals_pallas
// (src/repro/kernels/range_scorer/kernel.py:107 and :161): decodes
// bit-packed docid deltas of B blocks into [B*128] range-local ids, -1 for
// lanes past the block length and for pruned or padding rows.
//
// Bound: bytes. A block reads its directory row (start, len, entry, first
// docid, keep: 17 B), ceil(len*w/32) words of the stream, and writes 128
// ids (512 B). The TPU sliced a fixed 128-word window per block out of a
// zero-padded stream and selected among the widths with static repeats;
// here one 128-thread CTA owns one block and lane j reads only the one
// word that holds its delta, and only when j < len, so a narrow block
// costs a few words. The 128-lane inclusive prefix sum is a warp shuffle
// scan per warp plus one shared-memory pass over the four warp totals; it
// runs in uint32, whose wraparound equals the reference's int32 cumsum.
// An invalid row (keep == 0 or start < 0) writes -1 and reads no word.
__global__ void __launch_bounds__(kBlock)
unpack_locals_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ pack_dir,
                     const int32_t* __restrict__ pack_firsts,
                     const uint8_t* __restrict__ keep,
                     const int32_t* __restrict__ range_start,
                     int32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  int32_t* row = out + (int64_t)b * kBlock;
  // Uniform across the CTA, so no thread is left waiting at the barrier.
  if (keep[b] == 0 || starts[b] < 0) {
    row[j] = -1;
    return;
  }
  const int len = lens[b];
  const int entry = max(pack_dir[b], 0);
  const int64_t word_start = entry & ((1 << kPackDirBits) - 1);
  const int code = entry >> kPackDirBits;
  const int w = code == 0 ? 0 : (2 << code);  // PACK_WIDTHS = (0, 4, 8, 16, 32)

  uint32_t delta = 0;
  if (j < len && w > 0 && n_words > 0) {
    const int bit = j * w;
    int64_t idx = word_start + (bit >> 5);
    idx = idx < n_words ? idx : n_words - 1;  // the reference's clamp
    const uint32_t word = words[idx];
    // A shift by 32 is undefined in C++, so width 32 takes its own branch.
    delta = w == 32 ? word : (word >> (bit & 31)) & ((1u << w) - 1u);
  }

  const int lane = j & 31;
  const int warp = j >> 5;
  uint32_t x = delta;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  __shared__ uint32_t warp_total[kBlock / 32];
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  for (int i = 0; i < warp; ++i) x += warp_total[i];

  const uint32_t doc = (uint32_t)pack_firsts[b] + x;
  row[j] = j < len ? (int32_t)(doc - (uint32_t)*range_start) : -1;
}

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int rs_scatter_accumulate(const void* ids, const void* vals, int64_t n,
                          void* acc, int64_t s_pad, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int64_t ctas = (n + kScatterThreads - 1) / kScatterThreads;
  if (ctas > kScatterMaxCtas) ctas = kScatterMaxCtas;
  scatter_accumulate_kernel<<<(unsigned)ctas, kScatterThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)vals, n, (int32_t*)acc, s_pad);
  return (int)cudaGetLastError();
}

int rs_unpack_locals(const void* words, int64_t n_words, const void* starts,
                     const void* lens, const void* pack_dir,
                     const void* pack_firsts, const void* keep,
                     const void* range_start, int64_t n_blocks, void* out,
                     void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  unpack_locals_kernel<<<(unsigned)n_blocks, kBlock, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)starts,
      (const int32_t*)lens, (const int32_t*)pack_dir,
      (const int32_t*)pack_firsts, (const uint8_t*)keep,
      (const int32_t*)range_start, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
