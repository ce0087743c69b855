// Range-scorer kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kernels/range_scorer/kernel.py).
//
// Every kernel launches on the caller's stream, allocates nothing, and its
// entry point returns cudaGetLastError() so a refused launch is reported
// where it happened. The Python wrappers allocate the outputs and check
// device, dtype, shape and contiguity before any pointer reaches this file.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;       // postings per block (core.clustered_index.BLOCK)
constexpr int kPackDirBits = 27;  // core.clustered_index.PACK_DIR_BITS
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScatterThreads = 256;
constexpr int64_t kScatterMaxCtas = 132 * 16;  // 16 CTAs per SM of an H100

// ------------------------------------------------------ shared decode helpers
//
// The packed docid decode, used by unpack_locals_kernel and by
// range_step_kernel alike, so the two decodes cannot drift apart.

// A merged directory entry -> (first word of the block's run, width in bits).
__device__ __forceinline__ void dir_entry(int32_t entry, int64_t* word_start, int* w) {
  entry = max(entry, 0);
  *word_start = entry & ((1 << kPackDirBits) - 1);
  const int code = entry >> kPackDirBits;
  *w = code == 0 ? 0 : (2 << code);  // PACK_WIDTHS = (0, 4, 8, 16, 32)
}

// The word that holds the delta of lane j of a block of length len (0 when
// the lane reads none): only a lane inside the block reads a word, and
// only the one word that holds its delta.
__device__ __forceinline__ uint32_t lane_word(const uint32_t* __restrict__ words,
                                              int64_t n_words, int64_t word_start,
                                              int w, int j, int len) {
  if (j >= len || w == 0 || n_words <= 0) return 0u;
  int64_t idx = word_start + ((j * w) >> 5);
  idx = idx < n_words ? idx : n_words - 1;  // the reference's clamp
  return words[idx];
}

// Lane j's delta, bits [j*w, (j+1)*w) of its word; 0 past the length.
__device__ __forceinline__ uint32_t lane_delta(uint32_t word, int w, int j, int len) {
  if (j >= len || w == 0) return 0u;
  const int bit = j * w;
  // A shift by 32 is undefined in C++, so width 32 takes its own branch.
  return w == 32 ? word : (word >> (bit & 31)) & ((1u << w) - 1u);
}

// Inclusive prefix sum over the 32 lanes of a warp, in uint32: its
// wraparound equals the reference's int32 cumsum.
__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

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
// Off the engine's path since range_step_kernel fuses it (ops.score_blocks
// still runs it).
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
// word that holds its delta (lane_word), and only when j < len, so a
// narrow block costs a few words. The 128-lane inclusive prefix sum is a
// warp shuffle scan per warp plus one shared-memory pass over the four
// warp totals. An invalid row (keep == 0 or start < 0) writes -1 and reads
// no word. Off the engine's path since range_step_kernel fuses it
// (ops.score_blocks still runs it).
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
  int64_t word_start;
  int w;
  dir_entry(pack_dir[b], &word_start, &w);

  const int lane = j & 31;
  const int warp = j >> 5;
  uint32_t x = warp_scan(
      lane_delta(lane_word(words, n_words, word_start, w, j, len), w, j, len), lane);
  __shared__ uint32_t warp_total[kBlock / 32];
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  for (int i = 0; i < warp; ++i) x += warp_total[i];

  const uint32_t doc = (uint32_t)pack_firsts[b] + x;
  row[j] = j < len ? (int32_t)(doc - (uint32_t)*range_start) : -1;
}

// range_step
//
// Replaces, on the engine's path, both TPU kernels above (_scatter_kernel,
// src/repro/kernels/range_scorer/kernel.py:47, and _unpack_kernel, :107)
// together with the XLA code around them in the reference's
// score_range_step (src/repro/core/range_daat.py:162-220): one query's
// whole range step in one launch. From the state (vals[k], ids[k],
// postings, blocks) and B block ids it computes
//   keep    = id >= 0 [and maximp + rest > theta, theta = vals[k-1]],
//   acc[s]  = sum of widened impacts of the kept blocks' lanes whose
//             range-local docid is s (int32 or packed docids),
//   range top-k of acc under (score desc, local id asc): lax.top_k's order,
//   merge with the state under (score desc, id asc, id -1 last),
// and writes the new state, counters advanced, into a fresh buffer
// out = vals[k] | postings | blocks | ids[k].
//
// Bound: bytes, and far below what one launch costs. The step reads B
// block rows, the kept blocks' impacts and docids (or packed words) once,
// and the state; the accumulator never leaves the chip. At the engine's
// widths (B = 32..256 blocks, k = 10) that is a few to tens of kilobytes,
// nanoseconds at HBM rate, so latency sets the time: the launch, then the
// CTA's barrier-separated phases below, one after another. The design's
// point is that a range costs one launch instead of ~67 eager operations.
//
// Design. One CTA of 1024 threads per range: a range's work (a few
// thousand postings, an s_pad of ~10^4 slots) fits one SM, and the anytime
// loop needs the result before it decides on the next range anyway.
//   * Accumulator: int32 in dynamic shared memory, zeroed by the CTA, one
//     shared-memory atomicAdd per valid lane (integer addition is
//     order-free, so the sums are bitwise the reference's). Up to
//     kMaxSharedSlots slots; a larger s_pad takes a global scratch buffer
//     the wrapper allocates and the kernel zeroes (same code, templated).
//   * Scatter: warp w takes blocks w, w+32, ...; lane l owns lanes l, l+32,
//     l+64, l+96 of the block, so loads are coalesced. Each lane issues its
//     four impacts and four docids (or packed words) before any of them is
//     used: the index is far larger than L2, so a block costs three
//     dependent cold loads (id, directory row, postings), not one pair per
//     chunk. Packed docids decode with the shared helpers: a warp scan per
//     32-lane chunk, carried.
//     Tensor cores do not apply (the TPU used a one-hot matmul only for
//     want of a scatter); TMA bulk copies do not fit either, since blk_start
//     is not 16-byte aligned: plain coalesced loads.
//   * Range top-k without a sort of acc: a binary search over the score
//     finds T, the k-th largest value (log2(max score) counting passes over
//     acc, each one CTA reduction), with g = #(score > T). Up to
//     kRegSlots * 1024 slots each thread holds its slots in registers for
//     the search and the candidate pass. One ordered pass
//     then takes every slot above T and the first k - g slots equal to T
//     (ballot + scan of warp counts, in slot order), so ties go to the
//     smallest local id as in lax.top_k. Zero scores become (0, -1).
//   * Merge: the k state entries and k candidates, as 64-bit keys
//     (score, 2^32-1 - id'), id' = id or INT32_MAX for id < 0, bitonic-sorted
//     descending in shared memory (n = next_pow2(2k) <= 2048: one warp when
//     n <= 64); the first k are the new state.
// Scores are sums of non-negative impacts, so never negative; 1 <= k <=
// min(s_pad, kMaxK). The step itself is range_step_body, which the
// traverse kernel below runs once per scored range of its loop.
constexpr int kStepThreads = 1024;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kRegSlots = 16;  // accumulator slots a thread keeps in registers
constexpr int kMaxK = 1024;
constexpr int kMaxSortN = 2 * kMaxK;
constexpr int kSortBytes = kMaxSortN * (8 + 4);  // keys and ids
constexpr int kSmemOptIn = 232448;               // per-block opt-in limit of sm_90
constexpr int kStaticReserve = 1024;             // the kernel's static shared memory
// Slots of the largest shared-memory accumulator. The top-k scratch is
// reserved for k = kMaxK whatever k is, so the placement depends on s_pad
// alone. kernel.py mirrors this number (SHARED_ACC_SLOTS).
constexpr int kMaxSharedSlots = (kSmemOptIn - kStaticReserve - kSortBytes) / 4;

// The index and the settings a range step reads, shared by both kernels.
struct IndexArgs {
  const int32_t* docs;      // [n_docs] int32 (int32 format)
  const void* impacts;      // [n_imps] int32, or int8 biased by 128
  const int32_t* blk_start;
  const int32_t* blk_len;
  const int32_t* blk_maximp;
  const uint32_t* words;    // packed format: stream, directory, first docids
  const int32_t* pack_dir;
  const int32_t* pack_first;
  int64_t n_docs;
  int64_t n_imps;
  int64_t n_words;
  int s_pad;
  int k;
  int sort_n;
  int prune;
};

// One top-k state: vals[k], ids[k] and the two counters, in global or
// shared memory.
struct StateRef {
  int32_t* vals;
  int32_t* ids;
  int32_t* postings;
  int32_t* blocks;
};

// The state laid out vals[k] | postings | blocks | ids[k] at base.
__device__ __forceinline__ StateRef state_at(int32_t* base, int k) {
  return StateRef{base, base + k + 2, base + k, base + k + 1};
}

// The step's static shared memory, declared by each kernel that runs it.
struct StepShared {
  int32_t red[2 * 32];   // cta_reduce's two buffers
  int32_t cnt2[2 * 64];  // the candidate pass's two buffers of warp counts
  uint32_t counters[2];  // postings and blocks of the kept blocks
};

static_assert(sizeof(StepShared) + 5 * 4 <= kStaticReserve,
              "the kernels' static shared memory outgrew its reserve");

struct StepArgs {
  IndexArgs ix;
  const int32_t* blk_ids;   // [B], -1 padded
  const int32_t* rest;      // [B]
  const int32_t* range_start;
  const int32_t* vals;      // state in
  const int32_t* ids;
  const int32_t* postings;
  const int32_t* blocks;
  int32_t* out;             // state out: vals[k] | postings | blocks | ids[k]
  int32_t* acc_global;      // [s_pad] scratch for the global placement
  int n_blocks;
};

__device__ __forceinline__ uint64_t heap_key(int32_t val, int32_t id) {
  const uint32_t ikey = id >= 0 ? (uint32_t)id : 0x7fffffffu;
  return ((uint64_t)((uint32_t)val ^ 0x80000000u) << 32) | (uint64_t)(0xffffffffu - ikey);
}

// Sum or max of one int per thread over the CTA, returned to every thread.
// red holds two 32-int buffers used in turn (parity), so one barrier per
// call suffices: a buffer is rewritten only after the next call's barrier.
template <bool kMax>
__device__ __forceinline__ int32_t cta_reduce(int32_t x, int32_t* red, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? __reduce_max_sync(kFull, x) : __reduce_add_sync(kFull, x);
  if (lane == 0) red[parity * 32 + warp] = x;
  __syncthreads();
  const int32_t y = red[parity * 32 + lane];
  return kMax ? __reduce_max_sync(kFull, y) : __reduce_add_sync(kFull, y);
}

// One range step of one query on the whole CTA: the state `in` and B
// block ids in, the new state written to `out` (which must not alias
// `in`: the merge reads the old state while it writes the new one). skey
// and sid are the sort scratch, acc the [s_pad] accumulator (shared or
// global), all owned by the caller. Every thread of the CTA must call it:
// it is full of CTA barriers.
template <bool kSharedAcc, bool kPacked, bool kInt8>
__device__ __forceinline__ void range_step_body(
    const IndexArgs& a, const int32_t* __restrict__ blk_ids,
    const int32_t* __restrict__ rest, int n_blocks, uint32_t rs, StateRef in,
    StateRef out, uint64_t* skey, int32_t* sid, int32_t* acc, StepShared& sh) {
  int32_t* red = sh.red;
  int32_t* cnt2 = sh.cnt2;
  uint32_t* counters = sh.counters;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int k = a.k, s_pad = a.s_pad;
  const int32_t theta = in.vals[k - 1];

  for (int s = tid; s < s_pad; s += kStepThreads) acc[s] = 0;
  if (tid < 2) counters[tid] = 0u;
  __syncthreads();

  // Scatter: warp w scores blocks w, w + 32, ... into acc.
  uint32_t my_post = 0u, my_blocks = 0u;
  for (int b = warp; b < n_blocks; b += kStepWarps) {
    const int32_t id = blk_ids[b];
    const int32_t safe = id < 0 ? 0 : id;
    const int32_t start = a.blk_start[safe];
    const int len = a.blk_len[safe];
    bool keep = id >= 0;
    if (a.prune) {
      // Block-level refinement: own max impact plus the other terms'
      // bounds must beat theta (int32 wraparound, as in the reference).
      keep = keep && (int32_t)((uint32_t)a.blk_maximp[safe] + (uint32_t)rest[b]) > theta;
    }
    if (!keep) continue;  // uniform across the warp
    my_post += (uint32_t)len;
    my_blocks += 1u;
    if (start < 0) continue;
    int64_t word_start = 0;
    int w = 0;
    uint32_t carry = 0u;
    if (kPacked) {
      dir_entry(a.pack_dir[safe], &word_start, &w);
      carry = (uint32_t)a.pack_first[safe];
    }
    // Issue every load of the block's lanes first: impacts, and docids or
    // packed words. Offsets clamp to the array's end, as in the reference.
    uint32_t doc_or_word[kBlock / 32];
    int32_t imp[kBlock / 32];
#pragma unroll
    for (int c = 0; c < kBlock / 32; ++c) {
      const int j = 32 * c + lane;
      const int64_t off = (int64_t)start + j;
      doc_or_word[c] = 0u;
      imp[c] = 0;
      if (j < len) {
        const int64_t io = off < a.n_imps ? off : a.n_imps - 1;
        imp[c] = kInt8 ? (int32_t)static_cast<const int8_t*>(a.impacts)[io] + 128
                       : static_cast<const int32_t*>(a.impacts)[io];
        if (!kPacked) doc_or_word[c] = (uint32_t)a.docs[off < a.n_docs ? off : a.n_docs - 1];
      }
      if (kPacked) doc_or_word[c] = lane_word(a.words, a.n_words, word_start, w, j, len);
    }
#pragma unroll
    for (int c = 0; c < kBlock / 32; ++c) {
      if (32 * c >= len) break;  // uniform
      const int j = 32 * c + lane;
      int32_t local;
      if (kPacked) {
        const uint32_t x = warp_scan(lane_delta(doc_or_word[c], w, j, len), lane);
        local = (int32_t)(carry + x - rs);
        carry += __shfl_sync(kFull, x, 31);
      } else {
        local = (int32_t)(doc_or_word[c] - rs);
      }
      if (j < len && local >= 0 && local < s_pad && imp[c] != 0) {
        atomicAdd(acc + local, imp[c]);
      }
    }
  }
  if (lane == 0 && my_blocks != 0u) {
    atomicAdd(&counters[0], my_post);
    atomicAdd(&counters[1], my_blocks);
  }
  __syncthreads();

  // This thread's slots tid, tid + 1024, ... in registers where they fit
  // (-1, below every score, past s_pad).
  const bool in_regs = s_pad <= kRegSlots * kStepThreads;
  int32_t slot[kRegSlots];
#pragma unroll
  for (int i = 0; i < kRegSlots; ++i) {
    const int s = tid + i * kStepThreads;
    slot[i] = in_regs && s < s_pad ? acc[s] : -1;
  }

  // T = the k-th largest score; g = #(score > T). Invariants of the search:
  // #(score >= lo) >= k, and g = #(score >= hi + 1).
  int32_t mx = 0;
  if (in_regs) {
#pragma unroll
    for (int i = 0; i < kRegSlots; ++i) mx = max(mx, slot[i]);
  } else {
    for (int s = tid; s < s_pad; s += kStepThreads) mx = max(mx, acc[s]);
  }
  int parity = 0;
  int32_t lo = 0, hi = cta_reduce<true>(mx, red, parity), g = 0;
  while (lo < hi) {
    parity ^= 1;
    const int32_t mid = lo + (int32_t)(((uint32_t)(hi - lo) + 1u) >> 1);
    int32_t c = 0;
    if (in_regs) {
#pragma unroll
      for (int i = 0; i < kRegSlots; ++i) c += slot[i] >= mid;
    } else {
      for (int s = tid; s < s_pad; s += kStepThreads) c += acc[s] >= mid;
    }
    c = cta_reduce<false>(c, red, parity);
    if (c >= k) {
      lo = mid;
    } else {
      hi = mid - 1;
      g = c;
    }
  }
  const int32_t T = lo;
  const int need = k - g;  // slots equal to T to take, smallest local id first

  // Candidates: slots above T at [k, k+g), slots equal to T at [k+g, 2k),
  // each placed by its rank in slot order (ballots and a scan of the warp
  // counts), so no atomics and ties keep lax.top_k's order. Zero scores
  // carry id -1, as in the reference.
  int gt_base = 0, eq_base = 0;
  const bool take_eq = T > 0;
  for (int base = 0, i = 0; base < s_pad && (gt_base < g || (take_eq && eq_base < need));
       base += kStepThreads, ++i) {
    const int s = base + tid;
    int32_t v = -1;
    if (in_regs) {
      // Registers cannot be indexed at run time: select slot[i] by unrolling.
#pragma unroll
      for (int r = 0; r < kRegSlots; ++r) v = r == i ? slot[r] : v;
    } else if (s < s_pad) {
      v = acc[s];
    }
    const unsigned gt = __ballot_sync(kFull, v > T);
    const unsigned eq = take_eq ? __ballot_sync(kFull, v == T) : 0u;
    parity ^= 1;
    int32_t* cnt = cnt2 + parity * 64;
    if (lane == 0) {
      cnt[warp] = __popc(gt);
      cnt[32 + warp] = __popc(eq);
    }
    __syncthreads();
    const uint32_t gx = warp_scan((uint32_t)cnt[lane], lane);
    const uint32_t ex = warp_scan((uint32_t)cnt[32 + lane], lane);
    const int g_before = warp == 0 ? 0 : (int)__shfl_sync(kFull, gx, warp - 1);
    const int e_before = warp == 0 ? 0 : (int)__shfl_sync(kFull, ex, warp - 1);
    const int32_t cand_id = (int32_t)((uint32_t)s + rs);
    if (v > T) {
      const int p = k + gt_base + g_before + __popc(gt & lt_mask);
      skey[p] = heap_key(v, cand_id);
      sid[p] = cand_id;
    } else if (take_eq && v == T) {
      const int rank = eq_base + e_before + __popc(eq & lt_mask);
      if (rank < need) {
        skey[k + g + rank] = heap_key(v, cand_id);
        sid[k + g + rank] = cand_id;
      }
    }
    gt_base += (int)__shfl_sync(kFull, gx, 31);
    eq_base += (int)__shfl_sync(kFull, ex, 31);
  }
  if (!take_eq) {
    for (int i = g + tid; i < k; i += kStepThreads) {
      skey[k + i] = heap_key(0, -1);
      sid[k + i] = -1;
    }
  }
  for (int i = tid; i < k; i += kStepThreads) {
    skey[i] = heap_key(in.vals[i], in.ids[i]);
    sid[i] = in.ids[i];
  }
  for (int i = 2 * k + tid; i < a.sort_n; i += kStepThreads) {
    skey[i] = 0ull;  // below every real key
    sid[i] = -1;
  }
  __syncthreads();

  // Bitonic sort of sort_n (key, id) pairs, descending.
  const int n = a.sort_n;
  const bool one_warp = n <= 64;
  if (!one_warp || warp == 0) {
    for (int size = 2; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < n / 2; t += kStepThreads) {
          const int i = 2 * stride * (t / stride) + (t % stride);
          const int j = i + stride;
          const bool desc = (i & size) == 0;
          const uint64_t ki = skey[i], kj = skey[j];
          if (desc ? ki < kj : ki > kj) {
            skey[i] = kj;
            skey[j] = ki;
            const int32_t tmp = sid[i];
            sid[i] = sid[j];
            sid[j] = tmp;
          }
        }
        if (one_warp) {
          __syncwarp();
        } else {
          __syncthreads();
        }
      }
    }
  }
  if (one_warp) __syncthreads();

  for (int i = tid; i < k; i += kStepThreads) {
    out.vals[i] = (int32_t)((uint32_t)(skey[i] >> 32) ^ 0x80000000u);
    out.ids[i] = sid[i];
  }
  if (tid == 0) {
    *out.postings = (int32_t)((uint32_t)*in.postings + counters[0]);
    *out.blocks = (int32_t)((uint32_t)*in.blocks + counters[1]);
  }
}

template <bool kSharedAcc, bool kPacked, bool kInt8>
__global__ void __launch_bounds__(kStepThreads)
range_step_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepShared sh;
  uint64_t* skey = reinterpret_cast<uint64_t*>(smem);
  int32_t* sid = reinterpret_cast<int32_t*>(skey + a.ix.sort_n);
  int32_t* acc = kSharedAcc ? sid + a.ix.sort_n : a.acc_global;
  range_step_body<kSharedAcc, kPacked, kInt8>(
      a.ix, a.blk_ids, a.rest, a.n_blocks, (uint32_t)*a.range_start,
      StateRef{const_cast<int32_t*>(a.vals), const_cast<int32_t*>(a.ids),
               const_cast<int32_t*>(a.postings), const_cast<int32_t*>(a.blocks)},
      state_at(a.out, a.ix.k), skey, sid, acc, sh);
}

// traverse
//
// Replaces, on the whole-query and batched paths, both TPU kernels above
// inside the reference's device-side loop: _traverse_loop's
// lax.while_loop (src/repro/core/range_daat.py:301-383), vmapped over N
// queries by batched_traverse (:432-487) and batched_traverse_resume
// (:490-545), each iteration a score_range_step that reaches
// _scatter_kernel (src/repro/kernels/range_scorer/kernel.py:47) and, for
// packed docids, _unpack_kernel (:107). One CTA of 1024 threads per lane
// (grid = N) walks its lane's processing order from a carry in
//   vals[k] | postings | blocks | ids[k] | i | exit_safe | exit_budget
// and writes the carry out, same layout, once at the end. Each iteration
// thread 0 takes the decision, as the reference's loop body does: stop if
// i >= R, an exit flag is set or `quantum` iterations ran; else set
//   exit_safe   = safe_stop & (bound[i] <= theta) & (theta > 0),
//   exit_budget = (postings >= budget) | (i >= maxr)     (signed int32),
// and, when neither is set, score range order[i] with range_step_body and
// advance i. The iteration that finds an exit scores nothing, leaves i
// alone and still counts toward the quantum, so chained quanta end where
// one uninterrupted run ends. Every thread reads the decision from shared
// memory between two barriers, so the CTA takes one decision per
// iteration (a thread that disagreed would deadlock at the step's
// barriers).
//
// Bound: latency, as range_step: per scored range the bytes are those of
// one range step (block rows, kept postings) plus 2B+2 plan entries; the
// loop removes the host's launch, state copy and theta read per range,
// not the step's own barrier-separated phases. The state lives in shared
// memory in two buffers (old and new), swapped after each step; the
// accumulator is shared memory up to kMaxTraverseSlots (the two state
// buffers for k = kMaxK take 16,400 bytes of the budget) and otherwise
// the lane's own [s_pad] slice of a [N, s_pad] global scratch, re-zeroed
// by every step. A dummy lane (budget 0 or maxr 0) stops at its first
// decision.
//
// Stacked shards. The index may be S range shards stacked row by row
// (every column [S, W], range_starts [S, R]; the reference's
// sharded_batched_traverse, src/repro/serving/sharded.py:98-156, runs
// device_traverse under a double vmap over [N, S]). Lane n then reads
// shard n % S, the reference's [N, S] row-major order: each column's
// pointer advances by shard times its row stride, range_starts by
// shard * R, and the gather clamps use the row widths W (n_docs, n_imps,
// n_words), as the reference's vmapped gathers clamp within one shard's
// padded row. One launch serves every (query, shard) pair; S = 1 is the
// unstacked index, every stride 0.
constexpr int kStateBytes = 2 * (2 * kMaxK + 2) * 4;  // two states at k = kMaxK
// kernel.py mirrors this number (TRAVERSE_SHARED_ACC_SLOTS).
constexpr int kMaxTraverseSlots =
    (kSmemOptIn - kStaticReserve - kSortBytes - kStateBytes) / 4;

// The reference's traced gather index into an axis of n: a negative index
// counts from the end, then the index clamps to [0, n).
__device__ __forceinline__ int32_t gather_index(int32_t i, int32_t n) {
  i = i < 0 ? i + n : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct TraverseArgs {
  IndexArgs ix;
  const int32_t* range_starts;  // [R], or [S, R] for stacked shards
  const int32_t* blk_tab;       // [N, R, B], -1 padded
  const int32_t* rest_tab;      // [N, R, B]
  const int32_t* order;         // [N, R]
  const int32_t* bounds;        // [N, R]
  const int32_t* budget;        // [N]
  const int32_t* maxr;          // [N]
  const int32_t* carry_in;      // [N, 2k+5]
  int32_t* carry_out;           // [N, 2k+5]
  int32_t* acc_global;          // [N, s_pad] scratch for the global placement
  int64_t docs_stride;          // stacked shards: row strides of docs, impacts,
  int64_t imps_stride;          // the block columns (blk_*, pack_dir,
  int64_t blk_stride;           // pack_first) and the packed words, in
  int64_t words_stride;         // elements (0 when unstacked)
  int n_shards;                 // S >= 1: lane n reads shard n % S
  int n_ranges;
  int n_blocks;
  int quantum;                  // < 0: run to an exit
  int safe_stop;
};

// The index as lane n's shard sees it: every column advanced to the
// shard's row (its widths are already the row widths).
template <bool kPacked, bool kInt8>
__device__ __forceinline__ IndexArgs shard_index(const TraverseArgs& t, int64_t shard) {
  IndexArgs a = t.ix;
  if (shard == 0) return a;
  if (kPacked) {
    a.words += shard * t.words_stride;
  } else {
    a.docs += shard * t.docs_stride;
  }
  a.impacts = static_cast<const char*>(a.impacts) +
              shard * t.imps_stride * (kInt8 ? 1 : 4);
  a.blk_start += shard * t.blk_stride;
  a.blk_len += shard * t.blk_stride;
  a.blk_maximp += shard * t.blk_stride;
  if (kPacked) {
    a.pack_dir += shard * t.blk_stride;
    a.pack_first += shard * t.blk_stride;
  }
  return a;
}

template <bool kSharedAcc, bool kPacked, bool kInt8>
__global__ void __launch_bounds__(kStepThreads)
traverse_kernel(const __grid_constant__ TraverseArgs t) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepShared sh;
  // The loop's control: decision (0 stop, 1 exit found, 2 score), range,
  // cursor, exit_safe, exit_budget.
  __shared__ int32_t ctl[5];
  const int64_t n = blockIdx.x;
  const int64_t shard = n % t.n_shards;
  const IndexArgs a = shard_index<kPacked, kInt8>(t, shard);
  const int32_t* range_starts = t.range_starts + shard * t.n_ranges;
  const int k = a.k, width = 2 * k + 2, R = t.n_ranges;
  uint64_t* skey = reinterpret_cast<uint64_t*>(smem);
  int32_t* sid = reinterpret_cast<int32_t*>(skey + a.sort_n);
  int32_t* cur = sid + a.sort_n;
  int32_t* nxt = cur + width;
  int32_t* acc = kSharedAcc ? nxt + width : t.acc_global + n * a.s_pad;
  const int tid = threadIdx.x;

  const int32_t* cin = t.carry_in + n * (width + 3);
  for (int j = tid; j < width; j += kStepThreads) cur[j] = cin[j];
  if (tid == 0) {
    ctl[2] = cin[width];
    ctl[3] = cin[width + 1];
    ctl[4] = cin[width + 2];
  }
  const int32_t* order = t.order + n * R;
  const int32_t* bounds = t.bounds + n * R;
  const int32_t budget = t.budget[n], maxr = t.maxr[n];
  int steps = 0;  // thread 0's count of iterations
  for (;;) {
    __syncthreads();  // the last step's state is written; ctl was read
    if (tid == 0) {
      const int32_t i = ctl[2];
      int32_t d = 0;
      if (i < R && ctl[3] == 0 && ctl[4] == 0 && (t.quantum < 0 || steps < t.quantum)) {
        const int32_t theta = cur[k - 1];
        const int32_t s_safe =
            t.safe_stop && bounds[gather_index(i, R)] <= theta && theta > 0;
        const int32_t s_budget = cur[k] >= budget || i >= maxr;
        ctl[3] = s_safe;
        ctl[4] = s_budget;
        d = s_safe || s_budget ? 1 : 2;
        if (d == 2) {
          ctl[1] = gather_index(order[gather_index(i, R)], R);
          ctl[2] = i + 1;
        }
        ++steps;
      }
      ctl[0] = d;
    }
    __syncthreads();
    const int32_t d = ctl[0];
    if (d == 0) break;
    if (d == 2) {
      const int32_t r = ctl[1];
      const int64_t row = (n * R + r) * t.n_blocks;
      range_step_body<kSharedAcc, kPacked, kInt8>(
          a, t.blk_tab + row, t.rest_tab + row, t.n_blocks, (uint32_t)range_starts[r],
          state_at(cur, k), state_at(nxt, k), skey, sid, acc, sh);
      int32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  int32_t* cout = t.carry_out + n * (width + 3);
  for (int j = tid; j < width; j += kStepThreads) cout[j] = cur[j];
  if (tid == 0) {
    cout[width] = ctl[2];
    cout[width + 1] = ctl[3];
    cout[width + 2] = ctl[4];
  }
}

// Raise the kernel's dynamic shared-memory limit to `bytes` the first time
// a launch needs more than the default 48 KB, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int variant, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices][8] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev][variant] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev][variant] = bytes;
  return err;
}

template <bool kSharedAcc, bool kPacked, bool kInt8>
cudaError_t launch_range_step(const StepArgs& a, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(range_step_kernel<kSharedAcc, kPacked, kInt8>,
                                     kSharedAcc * 4 + kPacked * 2 + kInt8, smem);
  if (err != cudaSuccess) return err;
  range_step_kernel<kSharedAcc, kPacked, kInt8><<<1, kStepThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kSharedAcc, bool kPacked, bool kInt8>
cudaError_t launch_traverse(const TraverseArgs& t, unsigned n_lanes, size_t smem,
                            cudaStream_t stream) {
  const cudaError_t err = allow_smem(traverse_kernel<kSharedAcc, kPacked, kInt8>,
                                     kSharedAcc * 4 + kPacked * 2 + kInt8, smem);
  if (err != cudaSuccess) return err;
  traverse_kernel<kSharedAcc, kPacked, kInt8><<<n_lanes, kStepThreads, smem, stream>>>(t);
  return cudaGetLastError();
}

// The index arguments both entry points take, checked; false if refused.
bool index_args(IndexArgs* a, const void* docs, int64_t n_docs, const void* impacts,
                int64_t n_imps, const void* blk_start, const void* blk_len,
                const void* blk_maximp, const void* words, int64_t n_words,
                const void* pack_dir, const void* pack_first, int packed, int64_t k,
                int64_t s_pad, int prune) {
  if (k < 1 || k > kMaxK || k > s_pad || s_pad > INT32_MAX ||
      (packed ? (words == nullptr && n_words > 0) : n_docs <= 0) || n_imps <= 0) {
    return false;
  }
  int sort_n = 2;
  while (sort_n < 2 * k) sort_n <<= 1;
  a->docs = (const int32_t*)docs;
  a->impacts = impacts;
  a->blk_start = (const int32_t*)blk_start;
  a->blk_len = (const int32_t*)blk_len;
  a->blk_maximp = (const int32_t*)blk_maximp;
  a->words = (const uint32_t*)words;
  a->pack_dir = (const int32_t*)pack_dir;
  a->pack_first = (const int32_t*)pack_first;
  a->n_docs = n_docs;
  a->n_imps = n_imps;
  a->n_words = n_words;
  a->s_pad = (int)s_pad;
  a->k = (int)k;
  a->sort_n = sort_n;
  a->prune = prune;
  return true;
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

// One range step. acc_global is null for the shared-memory accumulator
// (s_pad <= kMaxSharedSlots) and a [s_pad] int32 scratch buffer otherwise.
int rs_range_step(const void* docs, int64_t n_docs, const void* impacts,
                  int64_t n_imps, int impacts_int8, const void* blk_start,
                  const void* blk_len, const void* blk_maximp, const void* words,
                  int64_t n_words, const void* pack_dir, const void* pack_first,
                  int packed, const void* blk_ids, const void* rest, int64_t n_blocks,
                  const void* range_start, const void* vals, const void* ids,
                  const void* postings, const void* blocks, int64_t k, int64_t s_pad,
                  int prune, void* acc_global, void* out, void* stream) {
  StepArgs a;
  if (!index_args(&a.ix, docs, n_docs, impacts, n_imps, blk_start, blk_len, blk_maximp,
                  words, n_words, pack_dir, pack_first, packed, k, s_pad, prune) ||
      n_blocks < 0 || n_blocks > INT32_MAX ||
      (acc_global == nullptr && s_pad > kMaxSharedSlots)) {
    return (int)cudaErrorInvalidValue;
  }
  a.blk_ids = (const int32_t*)blk_ids;
  a.rest = (const int32_t*)rest;
  a.range_start = (const int32_t*)range_start;
  a.vals = (const int32_t*)vals;
  a.ids = (const int32_t*)ids;
  a.postings = (const int32_t*)postings;
  a.blocks = (const int32_t*)blocks;
  a.out = (int32_t*)out;
  a.acc_global = (int32_t*)acc_global;
  a.n_blocks = (int)n_blocks;
  const bool shared_acc = acc_global == nullptr;
  const size_t smem = (size_t)a.ix.sort_n * 12 + (shared_acc ? (size_t)s_pad * 4 : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((shared_acc ? 4 : 0) + (packed ? 2 : 0) + (impacts_int8 ? 1 : 0)) {
    case 0: err = launch_range_step<false, false, false>(a, smem, st); break;
    case 1: err = launch_range_step<false, false, true>(a, smem, st); break;
    case 2: err = launch_range_step<false, true, false>(a, smem, st); break;
    case 3: err = launch_range_step<false, true, true>(a, smem, st); break;
    case 4: err = launch_range_step<true, false, false>(a, smem, st); break;
    case 5: err = launch_range_step<true, false, true>(a, smem, st); break;
    case 6: err = launch_range_step<true, true, false>(a, smem, st); break;
    default: err = launch_range_step<true, true, true>(a, smem, st); break;
  }
  return (int)err;
}

// N lanes' whole-query loops from their carries. acc_global is null for
// the shared-memory accumulator (s_pad <= kMaxTraverseSlots) and a
// [n_lanes, s_pad] int32 scratch buffer otherwise; quantum < 0 runs each
// lane to an exit. With n_shards = S > 1 the index columns are S stacked
// rows (n_docs, n_imps and n_words the row widths, the strides their row
// strides, range_starts [S, n_ranges]) and lane n reads row n % S.
int rs_traverse(const void* docs, int64_t n_docs, const void* impacts, int64_t n_imps,
                int impacts_int8, const void* blk_start, const void* blk_len,
                const void* blk_maximp, const void* words, int64_t n_words,
                const void* pack_dir, const void* pack_first, int packed,
                const void* range_starts, const void* blk_tab, const void* rest_tab,
                const void* order, const void* bounds, const void* budget,
                const void* maxr, const void* carry_in, void* carry_out,
                int64_t n_lanes, int64_t n_ranges, int64_t n_blocks, int64_t k,
                int64_t s_pad, int64_t quantum, int safe_stop, int prune,
                void* acc_global, int64_t n_shards, int64_t docs_stride,
                int64_t imps_stride, int64_t blk_stride, int64_t words_stride,
                void* stream) {
  TraverseArgs t;
  if (!index_args(&t.ix, docs, n_docs, impacts, n_imps, blk_start, blk_len, blk_maximp,
                  words, n_words, pack_dir, pack_first, packed, k, s_pad, prune) ||
      n_lanes < 1 || n_lanes > 65535 || n_ranges < 1 || n_ranges > INT32_MAX ||
      n_blocks < 0 || n_blocks > INT32_MAX || quantum > INT32_MAX ||
      n_shards < 1 || n_lanes % n_shards != 0 ||
      (n_shards > 1 && (docs_stride < 0 || imps_stride < n_imps ||
                        blk_stride < 1 || words_stride < 0)) ||
      (acc_global == nullptr && s_pad > kMaxTraverseSlots)) {
    return (int)cudaErrorInvalidValue;
  }
  t.docs_stride = docs_stride;
  t.imps_stride = imps_stride;
  t.blk_stride = blk_stride;
  t.words_stride = words_stride;
  t.n_shards = (int)n_shards;
  t.range_starts = (const int32_t*)range_starts;
  t.blk_tab = (const int32_t*)blk_tab;
  t.rest_tab = (const int32_t*)rest_tab;
  t.order = (const int32_t*)order;
  t.bounds = (const int32_t*)bounds;
  t.budget = (const int32_t*)budget;
  t.maxr = (const int32_t*)maxr;
  t.carry_in = (const int32_t*)carry_in;
  t.carry_out = (int32_t*)carry_out;
  t.acc_global = (int32_t*)acc_global;
  t.n_ranges = (int)n_ranges;
  t.n_blocks = (int)n_blocks;
  t.quantum = quantum < 0 ? -1 : (int)quantum;
  t.safe_stop = safe_stop;
  const bool shared_acc = acc_global == nullptr;
  const size_t smem = (size_t)t.ix.sort_n * 12 + (size_t)(2 * k + 2) * 8 +
                      (shared_acc ? (size_t)s_pad * 4 : 0);
  const unsigned g = (unsigned)n_lanes;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((shared_acc ? 4 : 0) + (packed ? 2 : 0) + (impacts_int8 ? 1 : 0)) {
    case 0: err = launch_traverse<false, false, false>(t, g, smem, st); break;
    case 1: err = launch_traverse<false, false, true>(t, g, smem, st); break;
    case 2: err = launch_traverse<false, true, false>(t, g, smem, st); break;
    case 3: err = launch_traverse<false, true, true>(t, g, smem, st); break;
    case 4: err = launch_traverse<true, false, false>(t, g, smem, st); break;
    case 5: err = launch_traverse<true, false, true>(t, g, smem, st); break;
    case 6: err = launch_traverse<true, true, false>(t, g, smem, st); break;
    default: err = launch_traverse<true, true, true>(t, g, smem, st); break;
  }
  return (int)err;
}

}  // extern "C"
