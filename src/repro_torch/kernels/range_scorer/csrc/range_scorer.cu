// Range-scorer kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kernels/range_scorer/kernel.py).
//
// Every kernel launches on the caller's stream, allocates nothing, and its
// entry point returns cudaGetLastError() so a refused launch is reported
// where it happened. The Python wrappers allocate the outputs and check
// device, dtype, shape and contiguity before any pointer reaches this file.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 128;       // postings per block (core.clustered_index.BLOCK)
constexpr int kPackDirBits = 27;  // core.clustered_index.PACK_DIR_BITS
constexpr unsigned kFull = 0xffffffffu;

// scatter_accumulate's plan (kernel.scatter_plan mirrors these): one CTA
// of kScatterThreads holds up to kScatterLoneSlots accumulator slots for
// up to kScatterLonePostings postings; else, up to one cluster's slots,
// a cluster of kScatterMaxCluster CTAs (a non-portable size above 8), each
// holding up to kScatterCtaSlots in dynamic shared memory; beyond that the
// accumulator lies in device memory. The thresholds are measured
// (chip_smoke.py --kernels, scatter_crossover; PERF.md): device memory
// beat several clusters at every P measured.
constexpr int kScatterThreads = 512;
constexpr int kScatterCtaSlots = 51200;  // 204,800 B of the 232,448 B opt-in
constexpr int kScatterLoneSlots = 12288;  // 48 KB
constexpr int kScatterLonePostings = 4096;
constexpr int kScatterPortableCluster = 8;
constexpr int kScatterMaxCluster = 16;
constexpr int kScatterUnroll = 4;  // 16-byte quads of ids and values in flight a thread
// scatter_accumulate's placements (the wrapper's plan.code)
constexpr int kScatterLone = 0;     // one CTA, no cluster
constexpr int kScatterCluster = 1;  // clusters, each owning a slice of s_pad
constexpr int kScatterGlobal = 2;   // device memory, one cooperative launch
constexpr int kUnpackWarps = 8;     // unpack_locals: blocks a CTA decodes, a warp each
static_assert(kScatterLoneSlots <= kScatterCtaSlots && kScatterLonePostings > 0,
              "the plan's constants, read by kernel.scatter_plan");

// ------------------------------------------------------ shared decode helpers
//
// The packed docid decode of range_step_kernel and traverse_kernel;
// unpack_locals_kernel shares dir_entry and warp_scan and decodes four
// lanes a thread with quad_deltas.

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
// per-element scatter; Hopper has integer atomics, so the kernel is a
// direct scatter. Integer addition is order-free, so atomics in any order
// give the one-hot product's bits.
//
// Design: the accumulator lives on chip and is written once, in one launch.
//   * kScatterLone: one CTA holds all s_pad slots in shared memory, zeroes
//     them, adds every posting with a shared-memory atomic and writes the
//     slots out in 16-byte stores.
//   * kScatterCluster: a thread-block cluster holds s_pad in its
//     distributed shared memory, each CTA a slice of `slots`. The CTAs
//     share out the postings and add each one into its owner's slice
//     (the owner by a multiply-shift, mapa, red.shared::cluster); a
//     cluster.sync() after the zeroing
//     comes before any remote add, one before the write-out keeps every
//     CTA resident until no remote add is left. Where s_pad exceeds one
//     cluster, several clusters each own a slice and read every posting,
//     dropping the ids outside it (more reads, mostly from L2).
//   * kScatterGlobal: the accumulator in device memory: one cooperative
//     launch zeroes it, syncs the grid and adds with global atomics.
// Each thread issues its first kScatterUnroll quads of ids and values
// before it zeroes, so the zeroing hides under the first load round.
// Zero values are skipped: padding lanes carry 0. Off the engine's path
// since range_step_kernel fuses it (ops.score_blocks still runs it).
struct ScatterArgs {
  const int32_t* ids;
  const int32_t* vals;
  int64_t n;
  int32_t* acc;
  int64_t s_pad;
  int slots;       // slots a CTA owns (shared-memory placements)
  int vec;         // ids and vals are 16-byte aligned: quad loads
  uint64_t magic;  // ceil(2^40 / slots): r / slots = (r * magic) >> 40 for r < 2^24
};

// Add v into slot `off` of cluster CTA `owner`'s slice: the slice's
// address in that CTA (mapa) and a reduction in distributed shared memory
// that returns nothing (red.shared::cluster).
__device__ __forceinline__ void cluster_add(uint32_t slice, uint32_t owner, uint32_t off,
                                            int32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(slice + 4 * off), "r"(owner));
  asm volatile("red.shared::cluster.add.s32 [%0], %1;" ::"r"(remote), "r"(v) : "memory");
}

// A thread's postings of [p0, p1): quads q = q0 + t, q0 + t + stride, ...
// kScatterUnroll at a time, loaded ahead of their adds; `ready` runs once
// the first quads are in flight, `add(id, v)` once per posting.
template <typename Ready, typename Add>
__device__ __forceinline__ void scatter_postings(const ScatterArgs& a, int64_t p0, int64_t p1,
                                                 int64_t t, int64_t stride, Ready ready,
                                                 Add add) {
  if (!a.vec) {
    ready();
    for (int64_t p = p0 + t; p < p1; p += stride) add(a.ids[p], a.vals[p]);
    return;
  }
  const int4* __restrict__ ids4 = reinterpret_cast<const int4*>(a.ids);
  const int4* __restrict__ vals4 = reinterpret_cast<const int4*>(a.vals);
  const int64_t q1 = p1 >> 2;  // p0 is a multiple of 4
  int4 id[kScatterUnroll], v[kScatterUnroll];
  int64_t q = (p0 >> 2) + t;
  auto load = [&](int64_t base) {
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      const int64_t qq = base + u * stride;
      v[u] = qq < q1 ? __ldg(vals4 + qq) : make_int4(0, 0, 0, 0);
      id[u] = qq < q1 ? __ldg(ids4 + qq) : make_int4(-1, -1, -1, -1);
    }
  };
  load(q);
  ready();
  while (q < q1) {
#pragma unroll
    for (int u = 0; u < kScatterUnroll; ++u) {
      add(id[u].x, v[u].x);
      add(id[u].y, v[u].y);
      add(id[u].z, v[u].z);
      add(id[u].w, v[u].w);
    }
    q += kScatterUnroll * stride;
    load(q);
  }
  // The tail past the last quad (p0 is past it where it was clamped to n).
  for (int64_t p = ((q1 << 2) > p0 ? (q1 << 2) : p0) + t; p < p1; p += stride) {
    add(a.ids[p], a.vals[p]);
  }
}

template <int kPlacement>
__global__ void __launch_bounds__(kScatterThreads)
scatter_accumulate_kernel(const ScatterArgs a) {
  if constexpr (kPlacement == kScatterGlobal) {
    cg::grid_group grid = cg::this_grid();
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    int32_t* __restrict__ acc = a.acc;
    const int64_t s_pad = a.s_pad;
    scatter_postings(
        a, 0, a.n, t, stride,
        [&] {
          int4* acc4 = reinterpret_cast<int4*>(acc);
          for (int64_t i = t; i < (s_pad >> 2); i += stride) acc4[i] = make_int4(0, 0, 0, 0);
          for (int64_t s = ((s_pad >> 2) << 2) + t; s < s_pad; s += stride) acc[s] = 0;
          grid.sync();
        },
        [&](int32_t id, int32_t v) {
          if (v != 0 && id >= 0 && id < s_pad) atomicAdd(acc + id, v);
        });
  } else {
    extern __shared__ int4 smem4[];
    int32_t* slot = reinterpret_cast<int32_t*>(smem4);
    unsigned csize = 1, rank = 0;
    if constexpr (kPlacement == kScatterCluster) {
      csize = cg::this_cluster().num_blocks();
      rank = cg::this_cluster().block_rank();
    }
    const int slots = a.slots;  // a multiple of 4
    const int64_t span = (int64_t)csize * slots;
    const int64_t lo = (int64_t)(blockIdx.x / csize) * span;  // this cluster's first slot
    // This cluster's slots, [lo, lo + width), below s_pad <= INT32_MAX.
    const uint32_t width = (uint32_t)((lo + span < a.s_pad ? lo + span : a.s_pad) - lo);
    const int32_t lo32 = (int32_t)lo;
    const uint32_t slice = (uint32_t)__cvta_generic_to_shared(slot);
    // This CTA's share of the postings, a multiple of 4 long.
    const int64_t share = (((a.n + csize - 1) / csize) + 3) & ~(int64_t)3;
    const int64_t p0 = (int64_t)rank * share < a.n ? (int64_t)rank * share : a.n;
    const int64_t p1 = p0 + share < a.n ? p0 + share : a.n;
    auto sync = [] {
      if constexpr (kPlacement == kScatterCluster) {
        cg::this_cluster().sync();
      } else {
        __syncthreads();
      }
    };
    scatter_postings(
        a, p0, p1, threadIdx.x, blockDim.x,
        [&] {
          for (int i = threadIdx.x; i < slots / 4; i += blockDim.x) {
            smem4[i] = make_int4(0, 0, 0, 0);
          }
          sync();
        },
        [&](int32_t id, int32_t v) {
          const uint32_t r = (uint32_t)id - (uint32_t)lo32;  // ids below lo wrap past width
          if (v == 0 || r >= width) return;
          if constexpr (kPlacement == kScatterCluster) {
            const uint32_t owner = (uint32_t)(((uint64_t)r * a.magic) >> 40);
            cluster_add(slice, owner, r - owner * (uint32_t)slots, v);
          } else {
            atomicAdd(slot + r, v);
          }
        });
    sync();
    const int64_t g0 = lo + (int64_t)rank * slots;
    const int64_t left = a.s_pad - g0;  // slots of s_pad from g0 on
    const int cnt = left <= 0 ? 0 : left < slots ? (int)left : slots;
    int4* out4 = reinterpret_cast<int4*>(a.acc + g0);  // acc and g0 16-byte aligned
    for (int i = threadIdx.x; i < cnt / 4; i += blockDim.x) out4[i] = smem4[i];
    for (int i = (cnt & ~3) + threadIdx.x; i < cnt; i += blockDim.x) a.acc[g0 + i] = slot[i];
  }
}

// An empty kernel: the launch floor that chip_smoke.py times through the
// wrappers' binding (rs_noop), beside the kernels' own times.
__global__ void noop_kernel() {}

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
// zero-padded stream and selected among the widths with static repeats.
// Here one warp decodes a block and a CTA of kUnpackWarps warps eight
// consecutive blocks, so their directory rows arrive in one coalesced
// round. Lane l owns lanes 4l..4l+3 of the block: their 4w bits lie in one
// word for w <= 8, two for w = 16 and four for w = 32 (quad_deltas), read
// only below the length. A scan over its four deltas, then a warp-shuffle
// scan of the lanes' totals, gives the prefix sum in uint32, whose
// wraparound is the reference's int32 cumsum; each lane stores its four
// ids in one 16-byte streaming store (evict-first: the caller reads them
// once). No shared memory and no barrier: the kernel
// waits on two dependent global rounds (the row, then the words), the
// dependency floor, and an invalid row (keep == 0 or start < 0) decodes
// as a block of length 0, reading no word. Off the engine's path since
// range_step_kernel fuses it (ops.score_blocks still runs it).

// The deltas of lanes j0..j0+3 (j0 = 4l) of a block of width w and length
// len; 0 past the length. Each word index takes the reference's clamp at
// the stream's end.
__device__ __forceinline__ void quad_deltas(const uint32_t* __restrict__ words, int64_t n_words,
                                            int64_t word_start, int w, int j0, int len,
                                            uint32_t d[4]) {
  d[0] = d[1] = d[2] = d[3] = 0u;
  if (w == 0 || n_words <= 0 || j0 >= len) return;
  auto word = [&](int j) {
    const int64_t idx = word_start + (((int64_t)j * w) >> 5);
    return __ldg(words + (idx < n_words ? idx : n_words - 1));
  };
  if (w <= 8) {  // one word holds the four
    const uint32_t x = word(j0);
    const uint32_t mask = (1u << w) - 1u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j0 + i < len) d[i] = (x >> (((j0 + i) * w) & 31)) & mask;
    }
  } else if (w == 16) {  // two words, two lanes each
    const uint32_t x = word(j0);
    const uint32_t y = j0 + 2 < len ? word(j0 + 2) : 0u;
    d[0] = x & 0xffffu;
    d[1] = j0 + 1 < len ? x >> 16 : 0u;
    d[2] = j0 + 2 < len ? y & 0xffffu : 0u;
    d[3] = j0 + 3 < len ? y >> 16 : 0u;
  } else {  // a word a lane
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j0 + i < len) d[i] = word(j0 + i);
    }
  }
}

__global__ void __launch_bounds__(kUnpackWarps * 32)
unpack_locals_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ pack_dir,
                     const int32_t* __restrict__ pack_firsts,
                     const uint8_t* __restrict__ keep,
                     const int32_t* __restrict__ range_start, int64_t n_blocks,
                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kUnpackWarps + (threadIdx.x >> 5);
  if (b >= n_blocks) return;  // whole warps: no barrier follows
  // The row, one round of independent loads.
  const bool valid = (__ldg(keep + b) != 0) & (__ldg(starts + b) >= 0);
  const int32_t row_len = __ldg(lens + b);
  const int len = valid ? row_len : 0;
  int64_t word_start;
  int w;
  dir_entry(__ldg(pack_dir + b), &word_start, &w);
  const uint32_t base0 = (uint32_t)__ldg(pack_firsts + b) - (uint32_t)__ldg(range_start);

  const int j0 = 4 * lane;
  uint32_t d[4];
  quad_deltas(words, n_words, word_start, w, j0, len, d);
  const uint32_t s1 = d[0] + d[1], s2 = s1 + d[2], s3 = s2 + d[3];
  const uint32_t base = base0 + (warp_scan(s3, lane) - s3);
  const int4 ids = make_int4(j0 < len ? (int32_t)(base + d[0]) : -1,
                             j0 + 1 < len ? (int32_t)(base + s1) : -1,
                             j0 + 2 < len ? (int32_t)(base + s2) : -1,
                             j0 + 3 < len ? (int32_t)(base + s3) : -1);
  __stcs(reinterpret_cast<int4*>(out + b * kBlock) + lane, ids);  // streamed: read once
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
//   the top k of state ∪ {(acc[s], range_start + s) : acc[s] > 0} under
//   (score desc, id asc, id -1 last),
// and writes the new state, counters advanced, into a fresh buffer
// out = vals[k] | postings | blocks | ids[k].
//
// Bound: latency, then instruction throughput. The step moves a few kilobytes
// (B block rows, the kept blocks' postings, the state): nanoseconds at HBM
// rate. It waits on a chain of dependent global loads (block ids, their
// directory rows, their postings), each a round trip of about a
// microsecond cold, and between its phases on CTA barriers. The phase
// timer (the kTimed variant, which only chip_smoke.py launches) measured
// the design before this one at 18.5 µs a step, 15.2 µs of it in the
// selection: an 11-pass binary search for the k-th score, an ordered
// candidate pass of up to 10 rounds and a shared-memory bitonic sort, each
// step a barrier over 32 warps. With those chains gone, what is left is
// the load rounds and the work every warp runs: 32 warps share the SM's
// four schedulers, so an instruction that all warps run costs eight
// scheduler cycles. The design keeps whole warps out of work they need not do.
//
// Design. One CTA of 1024 threads per range.
//   * Directory in one round: thread t loads block t's id and rest bound,
//     then its directory row, and takes the pruning decision; the kept
//     blocks are compacted into shared memory (one warp-aggregated atomic
//     per warp). Blocks beyond 1024 take further rounds. range_step starts
//     the first round's loads before it zeroes its accumulator, so the two
//     overlap.
//   * Scatter: warp w takes kept blocks w, w + 32, ... (range_step two
//     at a time, issuing both blocks' loads before it uses any; traverse,
//     whose loop state leaves fewer registers, one) and starts a block's
//     impact and docid (or packed word) loads before it uses any; one shared-memory atomicAdd per valid lane into an int32
//     accumulator (integer addition is order-free, so the sums are bitwise
//     the reference's). Packed docids decode with the shared helpers. An
//     add that takes a slot from zero lists the slot as touched (impacts
//     are non-negative, so once per slot), one atomic per block, so the
//     passes below visit the touched slots and not all s_pad.
//   * Selection by filter. Under the strict total order heap_key (score,
//     then id) the top-k set is unique, so any exact selection under that
//     key is bitwise the reference's (lax.top_k, then the lexsort merge).
//     A slot can enter the new state only if its key beats the state's
//     smallest key tau: the filter keeps those slots (one pass over the
//     touched slots, compacted in any order with one warp-aggregated
//     atomic per warp) and zeroes the others. After the first range few
//     survive, and often none.
//   * Exact selection when many survive (the first range, or k large): a
//     radix select over the survivors' 64-bit keys, 8 bits a pass from the
//     highest bit in which they differ, two barriers a pass; it stops when
//     the bins it takes whole hold exactly k keys, or at most 32.
//   * Merge: the m <= max(k, 32) selected survivors are sorted (in
//     registers by warp 0 when m <= 32, else a bitonic sort), then each
//     element of the sorted state and of the sorted survivors finds its
//     output position by a binary search in the other list (state first on
//     equal keys): no sort of the union. With k <= 32 and m <= 32, warp 0
//     does all of it without a CTA barrier.
//   * The accumulator is left zeroed (the filter zeroes the losers, the
//     selection the survivors), so the traverse loop's next step needs no
//     zero pass.
// Placements. The accumulator (s_pad slots, a kCandCap survivor list and a
// kTouchedCap list of touched slots; more survivors or touched slots than
// listed fall back to visiting the touched slots, or all s_pad) lies in
// dynamic shared memory when it fits beside the top-k scratch, else in a
// global scratch the wrapper allocates; the top-k scratch (the sorted
// survivors, a sorted copy of the state and, in traverse, the two states)
// lies in shared memory up to kTopSharedMax bytes, else in a global
// scratch: the same code, templated on both placements. So any
// 1 <= k <= s_pad runs on the card.
//
// A state from the engine is sorted; one that is not (a test's hand-made
// carry) is first sorted by rank into the scratch. Scores are sums of
// non-negative impacts, so never negative; zero scores never enter, which
// equals the reference's (0, -1) candidates, the smallest keys there are.
constexpr int kStepThreads = 1024;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kCandCap = 2048;       // survivors listed; more rescan the touched slots
constexpr int kTouchedCap = 8192;    // touched slots listed; more rescan the accumulator
constexpr int kAccLists = kCandCap + kTouchedCap;  // the two lists, after acc
constexpr int kTopSharedMax = 98304;  // top-k scratch bytes kept in shared memory
constexpr int kSmemOptIn = 232448;    // per-block opt-in limit of sm_90
constexpr int kStaticReserve = 20480;  // the kernels' static shared memory
constexpr int kSmemRanges = 256;      // traverse keeps order and bounds on chip up to this R

// The top-k scratch. Candidate keys: cap_c(k) = next_pow2(max(k, 32))
// uint64; the sorted state: vals[k] | ids[k]; and, in traverse, the two
// states of 2k + 2 int32 each. kernel.py mirrors these sizes.
__host__ __device__ constexpr int cap_c(int k) {
  int c = 32;
  while (c < k) c <<= 1;
  return c;
}
__host__ __device__ constexpr int64_t top_bytes(int k, bool traverse) {
  return 8 * (int64_t)cap_c(k) + 8 * (int64_t)k + (traverse ? 8 * (int64_t)(2 * k + 2) : 0);
}
constexpr bool top_shared(int k, bool traverse) { return top_bytes(k, traverse) <= kTopSharedMax; }
// Accumulator slots that fit in shared memory beside the top-k scratch.
constexpr int64_t shared_acc_slots(int k, bool traverse) {
  return (kSmemOptIn - kStaticReserve - (top_shared(k, traverse) ? top_bytes(k, traverse) : 0)) /
             4 - kAccLists;
}

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

// The phase timer's slots: cycles per phase (thread 0's clock64 between
// the phase boundaries), then the last boundary's clock and the steps.
enum Phase { kDecide, kZero, kDirectory, kScatter, kSelect, kCandidates, kMerge,
             kWrite, kPhases };
constexpr int kClockSlots = kPhases + 2;

// A kept block's directory row, compacted for the scatter.
struct KeptBlock {
  int32_t start, len, dir, first;
};

// A step's counters and cuts, zeroed before the step (reset_step). The
// traverse loop keeps two, used by alternate steps, so thread 0 readies the
// next step's while this one runs and a step needs no barrier of its own
// before its first atomic.
struct StepScalars {
  unsigned long long tau;        // the state's smallest key
  unsigned long long kor, kand;  // OR and AND of the survivors' keys
  int32_t n_kept[2];             // kept blocks of this round and the next
  int32_t n_cand;                // survivors of the filter
  int32_t n_touched;             // slots the scatter made nonzero
  int32_t n_sel;                 // survivors taken for the merge
  int32_t unsorted;
  uint32_t counters[2];          // postings and blocks of the kept blocks
};

// The step's static shared memory, declared by each kernel that runs it.
struct StepShared {
  KeptBlock kept[kStepThreads];  // one round's kept blocks
  uint32_t hist[256];            // the radix select's bins, zero between passes
  StepScalars sc[2];
  unsigned long long prefix;     // the radix select's chosen bits
  int32_t remaining, done, taken;
  long long clk[kClockSlots];    // the timed variant's phase clocks
};

// Thread 0 readies a step's scalars; a barrier must follow before use.
__device__ __forceinline__ void reset_step(StepScalars& sv) {
  sv.tau = ~0ull;
  sv.kor = 0ull;
  sv.kand = ~0ull;
  sv.n_kept[0] = sv.n_kept[1] = 0;
  sv.n_cand = sv.n_sel = sv.n_touched = 0;
  sv.unsorted = 0;
  sv.counters[0] = sv.counters[1] = 0u;
}

// The timed variant: thread 0 charges the cycles since the last boundary
// to `phase`. Compiles to nothing in the engine's variants.
template <bool kTimed>
__device__ __forceinline__ void mark(StepShared& sh, int phase) {
  if (kTimed && threadIdx.x == 0) {
    const long long now = clock64();
    sh.clk[phase] += now - sh.clk[kPhases];
    sh.clk[kPhases] = now;
  }
}

// The top-k scratch of one step: sorted candidate keys and a sorted copy
// of the state, in shared or global memory.
struct TopScratch {
  uint64_t* sc;     // [cap_c(k)]
  int32_t* sa_vals;  // [k]
  int32_t* sa_ids;   // [k]
};

// range_step's first round of block table entries and directory rows,
// loaded while the accumulator is zeroed and held in registers by thread t
// for block t; r < 0 when nothing was fetched (traverse).
struct Prefetch {
  int r;
  int32_t id, rest, start, len, maximp, dir, first;
};

// A prefetch load, kept where it is written: the compiler could sink a
// plain load past the zero pass to its first use, and the prefetch would
// overlap nothing; a volatile asm load stays in place, and the thread
// waits only where it reads the register. The read-only path (.nc) is
// right: the index and the block tables do not change during a launch.
__device__ __forceinline__ int32_t ld_early(const int32_t* p) {
  int32_t v;
  asm volatile(
      "{\n\t.reg .u64 g;\n\tcvta.to.global.u64 g, %1;\n\t"
      "ld.global.nc.b32 %0, [g];\n\t}"
      : "=r"(v)
      : "l"(p));
  return v;
}

// The directory row of a prefetched block id (zeros for a padding id).
template <bool kPacked>
__device__ __forceinline__ void load_row(const IndexArgs& a, Prefetch& p) {
  p.start = p.len = p.maximp = p.dir = p.first = 0;
  if (p.id >= 0) {
    p.start = ld_early(a.blk_start + p.id);
    p.len = ld_early(a.blk_len + p.id);
    p.maximp = ld_early(a.blk_maximp + p.id);
    if (kPacked) {
      p.dir = ld_early(a.pack_dir + p.id);
      p.first = ld_early(a.pack_first + p.id);
    }
  }
}

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
  int32_t* acc_global;      // [s_pad + kAccLists] scratch for the global placement
  int32_t* top_global;      // top_bytes(k, false) scratch for the global placement
  long long* timing;        // the timed variant's [kPhases + 1] clocks
  int n_blocks;
};

__device__ __forceinline__ uint64_t heap_key(int32_t val, int32_t id) {
  const uint32_t ikey = id >= 0 ? (uint32_t)id : 0x7fffffffu;
  return ((uint64_t)((uint32_t)val ^ 0x80000000u) << 32) | (uint64_t)(0xffffffffu - ikey);
}

__device__ __forceinline__ int32_t key_score(uint64_t key) {
  return (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
}

// A range candidate's id from its key (ids within a range are >= 0).
__device__ __forceinline__ int32_t key_id(uint64_t key) {
  return (int32_t)(0xffffffffu - (uint32_t)key);
}

__device__ __forceinline__ uint64_t min64(uint64_t x, uint64_t y) { return x < y ? x : y; }
__device__ __forceinline__ uint64_t max64(uint64_t x, uint64_t y) { return x < y ? y : x; }

__device__ __forceinline__ uint64_t warp_min64(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min64(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// 32 keys, one per lane, sorted descending across the warp (bitonic).
__device__ __forceinline__ uint64_t warp_sort_desc(uint64_t x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, x, stride);
      const bool desc = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      x = lower == desc ? max64(x, y) : min64(x, y);
    }
  }
  return x;
}

// #{i < n : key(a_i) >= x} over a state sorted by key, descending.
__device__ __forceinline__ int count_ge(const int32_t* vals, const int32_t* ids, int n,
                                        uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (heap_key(vals[mid], ids[mid]) >= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #{j < n : keys[j] > x} over keys sorted descending.
__device__ __forceinline__ int count_gt(const uint64_t* keys, int n, uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] > x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A warp's loads of one block: lane l's impacts and docids (or packed
// words) of lanes l, l + 32, l + 64, l + 96, all started before any is used.
// Offsets clamp to the array's end, as in the reference.
template <bool kPacked, bool kInt8>
__device__ __forceinline__ void load_block(const IndexArgs& a, const KeptBlock& kb, int lane,
                                           uint32_t (&dw)[kBlock / 32],
                                           int32_t (&imp)[kBlock / 32]) {
  int64_t word_start = 0;
  int w = 0;
  if (kPacked) dir_entry(kb.dir, &word_start, &w);
#pragma unroll
  for (int c = 0; c < kBlock / 32; ++c) {
    const int j = 32 * c + lane;
    const int64_t off = (int64_t)kb.start + j;
    dw[c] = 0u;
    imp[c] = 0;
    if (j < kb.len) {
      const int64_t io = off < a.n_imps ? off : a.n_imps - 1;
      imp[c] = kInt8 ? (int32_t)static_cast<const int8_t*>(a.impacts)[io] + 128
                     : static_cast<const int32_t*>(a.impacts)[io];
      if (!kPacked) dw[c] = (uint32_t)a.docs[off < a.n_docs ? off : a.n_docs - 1];
    }
    if (kPacked) dw[c] = lane_word(a.words, a.n_words, word_start, w, j, kb.len);
  }
}

// ... and its scatter into acc (packed docids decode here: a warp scan per
// 32-lane chunk, carried). A slot an add takes from zero is appended to
// the touched list (impacts are non-negative, so once per slot and step),
// one atomic per block.
template <bool kPacked>
__device__ __forceinline__ void scatter_block(int32_t* acc, int32_t* touched,
                                              int32_t* n_touched, const KeptBlock& kb,
                                              int lane, uint32_t rs, int s_pad,
                                              const uint32_t (&dw)[kBlock / 32],
                                              const int32_t (&imp)[kBlock / 32]) {
  int64_t word_start = 0;
  int w = 0;
  uint32_t carry = (uint32_t)kb.first;
  if (kPacked) dir_entry(kb.dir, &word_start, &w);
  // The block's slots first, then its adds, then their results: the four
  // atomics are in flight together. old is 0 where an add took a slot
  // from zero, 1 where no add happened.
  int32_t loc[kBlock / 32], old[kBlock / 32];
#pragma unroll
  for (int c = 0; c < kBlock / 32; ++c) {
    const int j = 32 * c + lane;
    loc[c] = -1;  // no add
    if (32 * c >= kb.len) continue;  // uniform
    if (kPacked) {
      const uint32_t x = warp_scan(lane_delta(dw[c], w, j, kb.len), lane);
      loc[c] = (int32_t)(carry + x - rs);
      carry += __shfl_sync(kFull, x, 31);
    } else {
      loc[c] = (int32_t)(dw[c] - rs);
    }
    if (!(j < kb.len && loc[c] >= 0 && loc[c] < s_pad && imp[c] != 0)) loc[c] = -1;
  }
#pragma unroll
  for (int c = 0; c < kBlock / 32; ++c) old[c] = loc[c] >= 0 ? atomicAdd(acc + loc[c], imp[c]) : 1;
  int total = 0;
#pragma unroll
  for (int c = 0; c < kBlock / 32; ++c) total += __popc(__ballot_sync(kFull, old[c] == 0));
  if (total == 0) return;  // uniform
  int base = 0;
  if (lane == 0) base = atomicAdd(n_touched, total);
  base = __shfl_sync(kFull, base, 0);
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kBlock / 32; ++c) {
    const unsigned fm = __ballot_sync(kFull, old[c] == 0);
    const int p = base + __popc(fm & lt_mask);
    if (old[c] == 0 && p < kTouchedCap) touched[p] = loc[c];
    base += __popc(fm);
  }
}

// One range step of one query on the whole CTA: the state `in` and B
// block ids in, the new state written to `out` (which must not alias
// `in`). acc is the [s_pad] accumulator, all zero on entry and left all
// zero; cand its [kCandCap] survivor list and the [kTouchedCap] touched
// list after it; top the top-k scratch. The caller has run reset_step on
// sv and a barrier, and zeroed sh.hist. With copy_state (range_step) the
// caller has also copied the state into top.sa_vals/sa_ids (`in` may be
// global memory), and the step reads that copy. pf is the first round's
// prefetched block table entries and rows (pf.r < 0: none). Every thread
// of the CTA must call it: it is full of CTA barriers.
template <bool kPacked, bool kInt8, bool kTimed, bool kPairs>
__device__ __forceinline__ void range_step_body(
    const IndexArgs& a, const int32_t* __restrict__ blk_ids,
    const int32_t* __restrict__ rest, int n_blocks, uint32_t rs, StateRef in,
    StateRef out, TopScratch top, bool copy_state, int32_t* acc, int32_t* cand,
    StepShared& sh, StepScalars& sv, const Prefetch& pf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int k = a.k, s_pad = a.s_pad;
  const int32_t theta = in.vals[k - 1];

  int32_t* touched = cand + kCandCap;
  // The state's smallest key (the filter's cut tau), whether it is sorted,
  // and range_step's copy of it: run while the first round's postings load,
  // visible after the scatter's barrier.
  const int32_t* st_vals = copy_state ? top.sa_vals : in.vals;
  const int32_t* st_ids = copy_state ? top.sa_ids : in.ids;
  auto analyze_state = [&]() {
    if (32 * warp >= k) return;  // whole warps that hold entries
    uint64_t mn = ~0ull;
    bool unsorted = false;
    for (int i = tid; i < k; i += kStepThreads) {
      const uint64_t key = heap_key(st_vals[i], st_ids[i]);
      mn = min64(mn, key);
      if (i + 1 < k && key < heap_key(st_vals[i + 1], st_ids[i + 1])) unsorted = true;
    }
    mn = warp_min64(mn);
    if (lane == 0) atomicMin(&sv.tau, (unsigned long long)mn);
    if (unsorted) sv.unsorted = 1;
  };

  // Directory, then scatter, 1024 blocks a round.
  uint32_t my_post = 0u, my_blocks = 0u;
  int par = 0;
  for (int c0 = 0; c0 < n_blocks; c0 += kStepThreads, par ^= 1) {
    const int b = c0 + tid;
    KeptBlock kb{0, 0, 0, 0};
    bool keep = false;
    // Warps past the round's blocks skip to the barrier: with 32 warps on
    // four schedulers, every instruction a warp need not run is time.
    if (c0 + 32 * warp < n_blocks) {
    if (b < n_blocks) {
      int32_t id, rb, maximp = 0;
      if (c0 == 0 && pf.r >= 0) {
        id = pf.id;
        rb = pf.rest;
        kb = KeptBlock{pf.start, pf.len, pf.dir, pf.first};
        maximp = pf.maximp;
      } else {
        id = blk_ids[b];
        rb = rest[b];
        if (id >= 0) {
          kb.start = a.blk_start[id];
          kb.len = a.blk_len[id];
          maximp = a.blk_maximp[id];
          if (kPacked) {
            kb.dir = a.pack_dir[id];
            kb.first = a.pack_first[id];
          }
        }
      }
      // Block-level refinement: own max impact plus the other terms'
      // bounds must beat theta (int32 wraparound, as in the reference).
      keep = id >= 0 && (!a.prune || (int32_t)((uint32_t)maximp + (uint32_t)rb) > theta);
    }
    if (keep) {
      my_post += (uint32_t)kb.len;
      my_blocks += 1u;
    }
    const bool listed = keep && kb.start >= 0;
    const unsigned lm = __ballot_sync(kFull, listed);
    int base = 0;
    if (lane == 0 && lm != 0u) base = atomicAdd(&sv.n_kept[par], __popc(lm));
    base = __shfl_sync(kFull, base, 0);
    if (listed) sh.kept[base + __popc(lm & lt_mask)] = kb;
    }
    __syncthreads();
    if (c0 == 0) {
      mark<kTimed>(sh, kDirectory);
      analyze_state();
    }
    if (tid == 0) sv.n_kept[par ^ 1] = 0;
    const int nk = sv.n_kept[par];
    for (int j = warp; j < nk; j += (kPairs ? 2 : 1) * kStepWarps) {
      const KeptBlock k0 = sh.kept[j];
      uint32_t dw0[kBlock / 32];
      int32_t imp0[kBlock / 32];
      load_block<kPacked, kInt8>(a, k0, lane, dw0, imp0);
      if (kPairs && j + kStepWarps < nk) {  // uniform across the warp
        const KeptBlock k1 = sh.kept[j + kStepWarps];
        uint32_t dw1[kBlock / 32];
        int32_t imp1[kBlock / 32];
        load_block<kPacked, kInt8>(a, k1, lane, dw1, imp1);
        scatter_block<kPacked>(acc, touched, &sv.n_touched, k0, lane, rs, s_pad, dw0, imp0);
        scatter_block<kPacked>(acc, touched, &sv.n_touched, k1, lane, rs, s_pad, dw1, imp1);
      } else {
        scatter_block<kPacked>(acc, touched, &sv.n_touched, k0, lane, rs, s_pad, dw0, imp0);
      }
    }
    __syncthreads();
  }
  if (n_blocks <= 0) {
    analyze_state();
    __syncthreads();  // tau and the sorted flag, visible
  }
  mark<kTimed>(sh, kScatter);
  my_post = __reduce_add_sync(kFull, my_post);
  my_blocks = __reduce_add_sync(kFull, my_blocks);
  if (lane == 0 && my_blocks != 0u) {
    atomicAdd(&sv.counters[0], my_post);
    atomicAdd(&sv.counters[1], my_blocks);
  }

  // A hand-made state that is not sorted: sort it by rank into the scratch.
  StateRef st = copy_state ? StateRef{top.sa_vals, top.sa_ids, nullptr, nullptr} : in;
  if (sv.unsorted) {
    for (int i = tid; i < k; i += kStepThreads) {
      const uint64_t key = heap_key(in.vals[i], in.ids[i]);
      int r = 0;
      for (int j = 0; j < k; ++j) {
        const uint64_t other = heap_key(in.vals[j], in.ids[j]);
        r += other > key || (other == key && j < i);
      }
      top.sa_vals[r] = in.vals[i];
      top.sa_ids[r] = in.ids[i];
    }
    st = StateRef{top.sa_vals, top.sa_ids, nullptr, nullptr};
  }

  // Filter: a slot survives if its key beats tau; losers are zeroed here.
  // It visits the touched slots (all of acc if more were touched than
  // listed): every other slot is zero.
  const uint64_t tau = sv.tau;
  const int n_touched = sv.n_touched;
  const bool touched_listed = n_touched <= kTouchedCap;
  const int span = touched_listed ? n_touched : s_pad;
  {
    uint32_t or_hi = 0u, or_lo = 0u, and_hi = ~0u, and_lo = ~0u;  // of the survivors
    for (int base = 0; base < span; base += kStepThreads) {
      const int j = base + tid;
      int s = 0;
      int32_t v = 0;
      if (j < span) {
        s = touched_listed ? touched[j] : j;
        v = acc[s];
      }
      bool surv = false;
      if (v > 0) {
        const uint64_t key = heap_key(v, (int32_t)(rs + (uint32_t)s));
        surv = key > tau;
        if (surv) {
          or_hi |= (uint32_t)(key >> 32);
          or_lo |= (uint32_t)key;
          and_hi &= (uint32_t)(key >> 32);
          and_lo &= (uint32_t)key;
        } else {
          acc[s] = 0;
        }
      }
      const unsigned sm = __ballot_sync(kFull, surv);
      if (sm != 0u) {  // uniform across the warp
        int b0 = 0;
        if (lane == 0) b0 = atomicAdd(&sv.n_cand, __popc(sm));
        b0 = __shfl_sync(kFull, b0, 0);
        const int p = b0 + __popc(sm & lt_mask);
        if (surv && p < kCandCap) cand[p] = s;
      }
    }
    or_hi = __reduce_or_sync(kFull, or_hi);
    or_lo = __reduce_or_sync(kFull, or_lo);
    and_hi = __reduce_and_sync(kFull, and_hi);
    and_lo = __reduce_and_sync(kFull, and_lo);
    if (lane == 0 && or_hi != 0u) {
      atomicOr(&sv.kor, ((unsigned long long)or_hi << 32) | or_lo);
      atomicAnd(&sv.kand, ((unsigned long long)and_hi << 32) | and_lo);
    }
  }
  __syncthreads();
  const int n = sv.n_cand;
  const bool listed = n <= kCandCap;
  // The survivors, each visited by one thread per pass: listed survivors
  // by list position, else every touched slot (or every slot) still above
  // zero. fn(valid, key) runs on every thread of every round, so it may
  // use warp intrinsics; `clear` zeroes each survivor after it.
  auto visit = [&](auto&& fn, bool clear) {
    const int len = listed ? n : span;
    for (int base = 0; base < len; base += kStepThreads) {
      const int j = base + tid;
      int s = 0;
      int32_t v = 0;
      if (j < len) {
        s = listed ? cand[j] : touched_listed ? touched[j] : j;
        v = acc[s];
      }
      fn(v > 0, v > 0 ? heap_key(v, (int32_t)(rs + (uint32_t)s)) : 0ull);
      if (clear && v > 0) acc[s] = 0;
    }
  };
  // m survivors go to the merge: all of them when n <= max(k, 32), else
  // the k best (radix select). They land in top.sc, sorted descending.
  int m = n;
  if (n == 0) {  // nothing beats the state: it is the new state
    mark<kTimed>(sh, kSelect);
    mark<kTimed>(sh, kCandidates);
  } else if (n <= 32) {
    mark<kTimed>(sh, kSelect);
    if (warp == 0) {
      uint64_t key = 0ull;
      if (lane < n) {
        const int s = cand[lane];
        key = heap_key(acc[s], (int32_t)(rs + (uint32_t)s));
        acc[s] = 0;
      }
      mark<kTimed>(sh, kCandidates);
      top.sc[lane] = warp_sort_desc(key, lane);
      __syncwarp();
    }
  } else {
    uint64_t prefix = 0ull;
    int shift = 0;
    if (n > k) {
      // Radix select of the k-th largest key, 8 bits a pass from the
      // highest bit in which the survivors differ (the filter's OR and AND).
      const uint64_t kor = sv.kor, kand = sv.kand;
      shift = 64 - __clzll((long long)(kor ^ kand));
      prefix = shift == 64 ? 0ull : kand & ~((1ull << shift) - 1ull);
      int remaining = k;
      while (shift > 0) {
        const int d = min(8, shift);
        shift -= d;
        const int above = shift + d;
        visit([&](bool valid, uint64_t key) {
          if (valid && (above == 64 || (key >> above) == (prefix >> above))) {
            atomicAdd(&sh.hist[(key >> shift) & ((1u << d) - 1u)], 1u);
          }
        }, false);
        __syncthreads();
        if (warp == 0) {
          // Lane l holds bins 8(31 - l) .. 8(31 - l) + 7: lane 0 the top.
          const int b0 = 8 * (31 - lane);
          uint32_t h[8], sum = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            h[i] = sh.hist[b0 + i];
            sh.hist[b0 + i] = 0u;
            sum += h[i];
          }
          const uint32_t incl = warp_scan(sum, lane);  // keys in bins >= b0
          const unsigned hit = __ballot_sync(kFull, incl >= (uint32_t)remaining);
          if (lane == __ffs(hit) - 1) {
            uint32_t over = incl - sum;
#pragma unroll
            for (int i = 7; i >= 0; --i) {
              if (over + h[i] >= (uint32_t)remaining) {
                // Bin b0 + i holds the k-th key. Taking it whole takes
                // `take` keys: stop when that is exactly k, or few enough
                // for warp 0 to sort (the merge keeps the best k of them).
                const int rem = remaining - (int)over;
                const int take = k - rem + (int)h[i];
                sh.prefix = prefix | ((unsigned long long)(b0 + i) << shift);
                sh.remaining = rem;
                sh.done = h[i] == (uint32_t)rem || take <= 32;
                sh.taken = take;
                break;
              }
              over += h[i];
            }
          }
        }
        __syncthreads();
        prefix = sh.prefix;
        remaining = sh.remaining;
        m = sh.taken;
        if (sh.done) break;
      }
    }
    mark<kTimed>(sh, kSelect);
    // Gather the m survivors into top.sc (any order), zeroing their slots.
    const int n_sort = m <= 32 ? 32 : cap_c(m);
    visit([&](bool valid, uint64_t key) {
      const bool take = valid && (n <= k || (key >> shift) >= (prefix >> shift));
      const unsigned tm = __ballot_sync(kFull, take);
      if (tm == 0u) return;  // uniform
      int b0 = 0;
      if (lane == 0) b0 = atomicAdd(&sv.n_sel, __popc(tm));
      const int p = __shfl_sync(kFull, b0, 0) + __popc(tm & lt_mask);
      if (take && p < m) top.sc[p] = key;
    }, true);
    for (int i = m + tid; i < n_sort; i += kStepThreads) top.sc[i] = 0ull;
    __syncthreads();
    mark<kTimed>(sh, kCandidates);
    if (m <= 32) {
      if (warp == 0) {
        top.sc[lane] = warp_sort_desc(top.sc[lane], lane);
        __syncwarp();
      }
    } else {
      // Bitonic sort of n_sort keys, descending (one warp when n_sort <= 64).
      uint64_t* sk = top.sc;
      const bool one_warp = n_sort <= 64;
      if (!one_warp || warp == 0) {
        for (int size = 2; size <= n_sort; size <<= 1) {
          for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = tid; t < n_sort / 2; t += kStepThreads) {
              const int i = 2 * stride * (t / stride) + (t % stride);
              const int j = i + stride;
              const bool desc = (i & size) == 0;
              const uint64_t ki = sk[i], kj = sk[j];
              if (desc ? ki < kj : ki > kj) {
                sk[i] = kj;
                sk[j] = ki;
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
    }
  }

  // Merge: each element of the sorted state and of the sorted survivors
  // takes its output position from a binary search in the other list.
  const bool warp_merge = k <= 32 && m <= 32;
  if (!warp_merge) __syncthreads();
  if (!warp_merge || warp == 0) {
    for (int j = tid; j < m; j += kStepThreads) {
      const uint64_t x = top.sc[j];
      const int p = j + count_ge(st.vals, st.ids, k, x);
      if (p < k) {
        out.vals[p] = key_score(x);
        out.ids[p] = key_id(x);
      }
    }
    for (int i = tid; i < k; i += kStepThreads) {
      const int32_t v = st.vals[i], id = st.ids[i];
      const int p = i + count_gt(top.sc, m, heap_key(v, id));
      if (p < k) {
        out.vals[p] = v;
        out.ids[p] = id;
      }
    }
  }
  mark<kTimed>(sh, kMerge);
  if (tid == 0) {
    *out.postings = (int32_t)((uint32_t)*in.postings + sv.counters[0]);
    *out.blocks = (int32_t)((uint32_t)*in.blocks + sv.counters[1]);
  }
  mark<kTimed>(sh, kWrite);
}

// The timed variant's clocks: zeroed, started (thread 0 only).
__device__ __forceinline__ void start_clock(StepShared& sh) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < kClockSlots; ++p) sh.clk[p] = 0;
    sh.clk[kPhases] = clock64();
  }
}

// ... and written out: cycles per phase, then the steps, as int64.
__device__ __forceinline__ void write_clock(const StepShared& sh, long long* out) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPhases; ++p) out[p] = sh.clk[p];
    out[kPhases] = sh.clk[kPhases + 1];
  }
}

// The top-k scratch carved from `base` (8-byte aligned): candidate keys,
// then the state copy.
__device__ __forceinline__ TopScratch top_at(void* base, int k) {
  uint64_t* sc = static_cast<uint64_t*>(base);
  int32_t* sa = reinterpret_cast<int32_t*>(sc + cap_c(k));
  return TopScratch{sc, sa, sa + k};
}

template <bool kSharedAcc, bool kSharedTop, bool kPacked, bool kInt8, bool kTimed>
__global__ void __launch_bounds__(kStepThreads)
range_step_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepShared sh;
  if (kTimed) start_clock(sh);
  const int k = a.ix.k, s_pad = a.ix.s_pad;
  unsigned char* dyn = smem;
  TopScratch top;
  if (kSharedTop) {
    top = top_at(dyn, k);
    dyn += top_bytes(k, false);
  } else {
    top = top_at(a.top_global, k);
  }
  int32_t* acc = kSharedAcc ? reinterpret_cast<int32_t*>(dyn) : a.acc_global;
  int32_t* cand = acc + s_pad;
  // The first round's block ids and rows load while the accumulator is
  // zeroed: the body starts with its directory in registers.
  const int tid = threadIdx.x;
  Prefetch pf;
  pf.r = a.n_blocks > 0 ? 0 : -1;
  if (tid < a.n_blocks) {
    pf.id = ld_early(a.blk_ids + tid);
    pf.rest = ld_early(a.rest + tid);
  }
  for (int s = tid; s < s_pad; s += kStepThreads) acc[s] = 0;
  for (int i = tid; i < 256; i += kStepThreads) sh.hist[i] = 0u;
  if (tid == 0) reset_step(sh.sc[0]);
  for (int i = tid; i < k; i += kStepThreads) {
    top.sa_vals[i] = a.vals[i];
    top.sa_ids[i] = a.ids[i];
  }
  if (tid < a.n_blocks) load_row<kPacked>(a.ix, pf);
  __syncthreads();
  mark<kTimed>(sh, kZero);
  range_step_body<kPacked, kInt8, kTimed, true>(
      a.ix, a.blk_ids, a.rest, a.n_blocks, (uint32_t)*a.range_start,
      StateRef{const_cast<int32_t*>(a.vals), const_cast<int32_t*>(a.ids),
               const_cast<int32_t*>(a.postings), const_cast<int32_t*>(a.blocks)},
      state_at(a.out, k), top, true, acc, cand, sh, sh.sc[0], pf);
  if (kTimed) {
    __syncthreads();
    if (threadIdx.x == 0) sh.clk[kPhases + 1] = 1;
    write_clock(sh, a.timing);
  }
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
// Bound: latency and throughput, as range_step. Every thread takes the loop's
// decision itself, from the same carry and state in shared memory (the
// lane's order and bounds are copied on chip at entry, R <= kSmemRanges),
// so a step costs one loop barrier, not a decision by thread 0 between
// two; the step's counters are double-buffered by step parity, so thread 0
// readies the next step's while this one runs. The accumulator is zeroed
// once at entry and left zero by every step. Loading the next range's
// block ids and directory rows into registers a step ahead was tried and
// timed slower: the registers it holds across the step cost more than the
// load round it hides. The states live in two buffers (old and new), swapped after each step, in
// shared memory with the rest of the top-k scratch up to kTopSharedMax
// bytes, else in the lane's global scratch; the accumulator lies in
// shared memory up to shared_acc_slots(k, true) slots, else in the lane's
// [s_pad + kAccLists] slice of a global scratch. A dummy lane (budget 0 or
// maxr 0) stops at its first decision.
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
  int32_t* acc_global;          // [N, s_pad + kAccLists] scratch, global placement
  int32_t* top_global;          // [N, top_bytes(k, true) / 4] scratch, global placement
  long long* timing;            // the timed variant's [N, kPhases + 1] clocks
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

// The traverse loop's own static shared memory: what a lane's steps read
// but never change (the index as the lane's shard sees it, its buffers, its
// caps), kept here and read again after each barrier rather than held in
// registers across the step body, which needs all 64 a thread has; and
// the lane's order and bounds, on chip when R <= kSmemRanges.
struct LoopShared {
  IndexArgs ix;
  unsigned char* top_base;      // the lane's top-k scratch and two states
  int32_t* acc;                 // the lane's accumulator and slot lists
  const int32_t* range_starts;  // the lane's shard's row
  int32_t budget, maxr;
  int32_t order[kSmemRanges];
  int32_t bounds[kSmemRanges];
};

static_assert(sizeof(StepShared) + sizeof(LoopShared) <= kStaticReserve,
              "the kernels' static shared memory outgrew its reserve");

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

template <bool kSharedAcc, bool kSharedTop, bool kPacked, bool kInt8, bool kTimed>
__global__ void __launch_bounds__(kStepThreads)
traverse_kernel(const __grid_constant__ TraverseArgs t) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepShared sh;
  __shared__ LoopShared ls;
  if (kTimed) start_clock(sh);
  const int k = t.ix.k, width = 2 * k + 2, R = t.n_ranges, B = t.n_blocks, s_pad = t.ix.s_pad;
  const int tid = threadIdx.x;
  {
    const int64_t n = blockIdx.x, shard = n % t.n_shards;
    unsigned char* top_base = kSharedTop ? smem
        : reinterpret_cast<unsigned char*>(t.top_global) + n * top_bytes(k, true);
    int32_t* acc = kSharedAcc
        ? reinterpret_cast<int32_t*>(smem + (kSharedTop ? top_bytes(k, true) : 0))
        : t.acc_global + n * (int64_t)(s_pad + kAccLists);
    if (tid == 0) {
      ls.ix = shard_index<kPacked, kInt8>(t, shard);
      ls.top_base = top_base;
      ls.acc = acc;
      ls.range_starts = t.range_starts + shard * R;
      ls.budget = t.budget[n];
      ls.maxr = t.maxr[n];
    }
    int32_t* cur = reinterpret_cast<int32_t*>(top_base + top_bytes(k, false));
    const int32_t* cin = t.carry_in + n * (width + 3);
    for (int j = tid; j < width; j += kStepThreads) cur[j] = cin[j];
    for (int s = tid; s < s_pad; s += kStepThreads) acc[s] = 0;
    for (int j = tid; j < 256; j += kStepThreads) sh.hist[j] = 0u;
    if (R <= kSmemRanges) {
      for (int j = tid; j < R; j += kStepThreads) {
        ls.order[j] = t.order[n * R + j];
        ls.bounds[j] = t.bounds[n * R + j];
      }
    }
    if (tid == 0) reset_step(sh.sc[0]);
  }
  // The loop's control, in registers: every thread reads the same carry
  // and state, so every thread takes the same decision.
  const int32_t* cin = t.carry_in + (int64_t)blockIdx.x * (width + 3);
  int32_t i = cin[width], exit_safe = cin[width + 1], exit_budget = cin[width + 2];
  Prefetch none;
  none.r = -1;
  int steps = 0, parity = 0;
  // The lane's state buffer p (0 or 1), and an entry of its order or bounds.
  auto state_buf = [&](int p) {
    return reinterpret_cast<int32_t*>(ls.top_base + top_bytes(k, false)) + p * width;
  };
  auto lane_entry = [&](const int32_t* on_chip, const int32_t* global, int32_t j) {
    return R <= kSmemRanges ? on_chip[j] : global[(int64_t)blockIdx.x * R + j];
  };
  for (;;) {
    __syncthreads();  // the last step's state is written
    if (!(i < R && exit_safe == 0 && exit_budget == 0 && (t.quantum < 0 || steps < t.quantum))) {
      break;
    }
    ++steps;
    const int32_t* cur = state_buf(parity);
    const int32_t theta = cur[k - 1];
    exit_safe = t.safe_stop && lane_entry(ls.bounds, t.bounds, gather_index(i, R)) <= theta &&
                theta > 0;
    exit_budget = cur[k] >= ls.budget || i >= ls.maxr;
    mark<kTimed>(sh, kDecide);
    if (exit_safe || exit_budget) continue;
    const int32_t r = gather_index(lane_entry(ls.order, t.order, gather_index(i, R)), R);
    ++i;
    if (kTimed && tid == 0) ++sh.clk[kPhases + 1];
    // The step after this one uses the other scalars: ready them now.
    if (tid == 0) reset_step(sh.sc[parity ^ 1]);
    const int64_t row = ((int64_t)blockIdx.x * R + r) * B;
    int32_t* acc = ls.acc;
    // One block per warp at a time: the second block's registers would
    // spill here, and timed slower.
    range_step_body<kPacked, kInt8, kTimed, false>(
        ls.ix, t.blk_tab + row, t.rest_tab + row, B, (uint32_t)ls.range_starts[r],
        state_at(state_buf(parity), k), state_at(state_buf(parity ^ 1), k),
        top_at(ls.top_base, k), false, acc, acc + s_pad, sh, sh.sc[parity], none);
    parity ^= 1;
  }
  const int32_t* cur = state_buf(parity);
  int32_t* cout = t.carry_out + (int64_t)blockIdx.x * (width + 3);
  for (int j = tid; j < width; j += kStepThreads) cout[j] = cur[j];
  if (tid == 0) {
    cout[width] = i;
    cout[width + 1] = exit_safe;
    cout[width + 2] = exit_budget;
  }
  if (kTimed) write_clock(sh, t.timing + (int64_t)blockIdx.x * (kPhases + 1));
}

// Raise the kernel's dynamic shared-memory limit to `bytes` the first time
// a launch needs more than the default 48 KB with its static shared memory
// (up to kStaticReserve), once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int variant, size_t bytes) {
  if (bytes + kStaticReserve <= 48 * 1024) return cudaSuccess;
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices][32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev][variant] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev][variant] = bytes;
  return err;
}

template <bool kSharedAcc, bool kSharedTop, bool kPacked, bool kInt8, bool kTimed = false>
cudaError_t launch_range_step(const StepArgs& a, size_t smem, cudaStream_t stream) {
  const auto kernel = range_step_kernel<kSharedAcc, kSharedTop, kPacked, kInt8, kTimed>;
  const cudaError_t err = allow_smem(
      kernel, kTimed * 16 + kSharedAcc * 8 + kSharedTop * 4 + kPacked * 2 + kInt8, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kStepThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kSharedAcc, bool kSharedTop, bool kPacked, bool kInt8, bool kTimed = false>
cudaError_t launch_traverse(const TraverseArgs& t, unsigned n_lanes, size_t smem,
                            cudaStream_t stream) {
  const auto kernel = traverse_kernel<kSharedAcc, kSharedTop, kPacked, kInt8, kTimed>;
  const cudaError_t err = allow_smem(
      kernel, kTimed * 16 + kSharedAcc * 8 + kSharedTop * 4 + kPacked * 2 + kInt8, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_lanes, kStepThreads, smem, stream>>>(t);
  return cudaGetLastError();
}

// Every engine variant of a launcher, chosen at run time; the timed
// variant (int8 impacts, packed docids, both shared placements) only
// when asked for.
#define RS_DISPATCH(LAUNCH, ARGS, ...)                                                   \
  switch ((shared_acc ? 8 : 0) + (shared_top ? 4 : 0) + (packed ? 2 : 0) +               \
          (impacts_int8 ? 1 : 0)) {                                                      \
    case 0: return (int)LAUNCH<false, false, false, false>(ARGS, __VA_ARGS__);           \
    case 1: return (int)LAUNCH<false, false, false, true>(ARGS, __VA_ARGS__);            \
    case 2: return (int)LAUNCH<false, false, true, false>(ARGS, __VA_ARGS__);            \
    case 3: return (int)LAUNCH<false, false, true, true>(ARGS, __VA_ARGS__);             \
    case 4: return (int)LAUNCH<false, true, false, false>(ARGS, __VA_ARGS__);            \
    case 5: return (int)LAUNCH<false, true, false, true>(ARGS, __VA_ARGS__);             \
    case 6: return (int)LAUNCH<false, true, true, false>(ARGS, __VA_ARGS__);             \
    case 7: return (int)LAUNCH<false, true, true, true>(ARGS, __VA_ARGS__);              \
    case 8: return (int)LAUNCH<true, false, false, false>(ARGS, __VA_ARGS__);            \
    case 9: return (int)LAUNCH<true, false, false, true>(ARGS, __VA_ARGS__);             \
    case 10: return (int)LAUNCH<true, false, true, false>(ARGS, __VA_ARGS__);            \
    case 11: return (int)LAUNCH<true, false, true, true>(ARGS, __VA_ARGS__);             \
    case 12: return (int)LAUNCH<true, true, false, false>(ARGS, __VA_ARGS__);            \
    case 13: return (int)LAUNCH<true, true, false, true>(ARGS, __VA_ARGS__);             \
    case 14: return (int)LAUNCH<true, true, true, false>(ARGS, __VA_ARGS__);             \
    default: return (int)LAUNCH<true, true, true, true>(ARGS, __VA_ARGS__);              \
  }

// The index arguments both entry points take, checked; false if refused.
bool index_args(IndexArgs* a, const void* docs, int64_t n_docs, const void* impacts,
                int64_t n_imps, const void* blk_start, const void* blk_len,
                const void* blk_maximp, const void* words, int64_t n_words,
                const void* pack_dir, const void* pack_first, int packed, int64_t k,
                int64_t s_pad, int prune) {
  if (k < 1 || k > s_pad || s_pad > INT32_MAX - kAccLists ||
      (packed ? (words == nullptr && n_words > 0) : n_docs <= 0) || n_imps <= 0) {
    return false;
  }
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
  a->prune = prune;
  return true;
}

// Whether the wrapper's placements are the ones the limits allow.
bool placements_ok(bool shared_acc, bool shared_top, int64_t k, int64_t s_pad,
                   bool traverse) {
  return shared_top == top_shared((int)k, traverse) &&
         shared_acc == (s_pad <= shared_acc_slots((int)k, traverse));
}

// Dynamic shared memory of a launch.
size_t smem_bytes(bool shared_acc, bool shared_top, int64_t k, int64_t s_pad,
                  bool traverse) {
  return (shared_top ? (size_t)top_bytes((int)k, traverse) : 0) +
         (shared_acc ? (size_t)(s_pad + kAccLists) * 4 : 0);
}

// Whether a scatter plan is one rs_scatter_accumulate takes at s_pad.
bool scatter_plan_ok(int placement, int cluster, int clusters, int slots, int64_t s_pad) {
  if (placement == kScatterGlobal) return cluster == 0 && clusters == 0 && slots == 0;
  if (slots < 4 || slots % 4 != 0 || slots > kScatterCtaSlots || clusters < 1) return false;
  if (placement == kScatterLone) return cluster == 1 && clusters == 1 && slots >= s_pad;
  return placement == kScatterCluster && cluster >= 2 && cluster <= kScatterMaxCluster &&
         clusters <= 65535 / cluster && (int64_t)cluster * clusters * slots >= s_pad;
}

// The scatter kernels' attributes, set once a device: the dynamic
// shared-memory opt-in of the shared placements and, for a cluster above
// the portable 8, the non-portable cluster size.
template <typename Kernel>
cudaError_t scatter_attributes(Kernel kernel, int placement, int cluster) {
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices][2] = {}, wide_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err;
  if (placement != kScatterGlobal && !smem_set[dev][placement]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kScatterCtaSlots * 4);
    if (err != cudaSuccess) return err;
    smem_set[dev][placement] = true;
  }
  if (cluster > kScatterPortableCluster && !wide_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set[dev] = true;
  }
  return cudaSuccess;
}

// A launch configuration of `ctas` CTAs of kScatterThreads: a cluster
// dimension for kScatterCluster, cooperative for kScatterGlobal.
cudaLaunchConfig_t scatter_config(cudaLaunchAttribute* attr, int placement, int64_t ctas,
                                  int cluster, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kScatterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (placement == kScatterCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else if (placement == kScatterGlobal) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// cudaLaunchKernelEx's code, with the error it may leave pending cleared.
cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <int kPlacement>
cudaError_t launch_scatter(const ScatterArgs& a, int cluster, int clusters,
                           cudaStream_t stream) {
  const auto kernel = scatter_accumulate_kernel<kPlacement>;
  const cudaError_t err = scatter_attributes(kernel, kPlacement, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = scatter_config(attr, kPlacement, (int64_t)cluster * clusters,
                                                cluster, (size_t)a.slots * 4, stream);
  return launched(cudaLaunchKernelEx(&cfg, kernel, a));
}

// The global placement: a cooperative grid no larger than the device
// holds at once (measured once a device) nor than the work needs.
cudaError_t launch_scatter_global(const ScatterArgs& a, cudaStream_t stream) {
  const auto kernel = scatter_accumulate_kernel<kScatterGlobal>;
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return err;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kScatterThreads, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms;
  }
  const int64_t quads = ((a.n > a.s_pad ? a.n : a.s_pad) + 3) / 4;
  int64_t ctas = (quads + kScatterThreads - 1) / kScatterThreads;
  ctas = ctas < 1 ? 1 : ctas > resident[dev] ? resident[dev] : ctas;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = scatter_config(attr, kScatterGlobal, ctas, 0, 0, stream);
  return launched(cudaLaunchKernelEx(&cfg, kernel, a));
}

}  // namespace

extern "C" {

const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// acc[s] = sum of vals[p] over ids[p] == s for s in [0, s_pad), in one
// launch of the placement kernel.scatter_plan chose: placement
// kScatterLone (cluster = clusters = 1), kScatterCluster (`clusters`
// clusters of `cluster` CTAs) or kScatterGlobal (cluster = clusters = slots
// = 0); `slots` is a CTA's share of the accumulator, a multiple of 4.
int rs_scatter_accumulate(const void* ids, const void* vals, int64_t n, void* acc,
                          int64_t s_pad, int placement, int cluster, int clusters, int slots,
                          void* stream) {
  if (n < 0 || s_pad < 1 || s_pad > INT32_MAX || ((uintptr_t)acc & 15) != 0 ||
      !scatter_plan_ok(placement, cluster, clusters, slots, s_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  const ScatterArgs a{(const int32_t*)ids, (const int32_t*)vals, n, (int32_t*)acc, s_pad,
                      slots, (((uintptr_t)ids | (uintptr_t)vals) & 15) == 0,
                      slots > 0 ? ((1ull << 40) + slots - 1) / (uint64_t)slots : 0};
  const cudaStream_t st = (cudaStream_t)stream;
  if (placement == kScatterGlobal) return (int)launch_scatter_global(a, st);
  if (placement == kScatterLone) return (int)launch_scatter<kScatterLone>(a, 1, 1, st);
  return (int)launch_scatter<kScatterCluster>(a, cluster, clusters, st);
}

// The most clusters of `cluster` CTAs with `slots` accumulator slots each
// that the current device holds at once (cudaOccupancyMaxActiveClusters),
// into *count: whether, and how wide, a cluster size schedules.
int rs_scatter_clusters(int cluster, int slots, int* count) {
  if (cluster < 1 || cluster > kScatterMaxCluster || slots < 4 || slots % 4 ||
      slots > kScatterCtaSlots) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = scatter_accumulate_kernel<kScatterCluster>;
  cudaError_t err = scatter_attributes(kernel, kScatterCluster, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scatter_config(attr, kScatterCluster, cluster, cluster,
                                          (size_t)slots * 4, nullptr);
  *count = 0;
  err = cudaOccupancyMaxActiveClusters(count, (const void*)kernel, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// An empty kernel on the stream: the launch floor of the binding.
int rs_noop(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int rs_unpack_locals(const void* words, int64_t n_words, const void* starts,
                     const void* lens, const void* pack_dir,
                     const void* pack_firsts, const void* keep,
                     const void* range_start, int64_t n_blocks, void* out,
                     void* stream) {
  if (((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n_blocks <= 0) return (int)cudaGetLastError();
  const int64_t ctas = (n_blocks + kUnpackWarps - 1) / kUnpackWarps;
  if (ctas > INT32_MAX) return (int)cudaErrorInvalidValue;
  unpack_locals_kernel<<<(unsigned)ctas, kUnpackWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)starts,
      (const int32_t*)lens, (const int32_t*)pack_dir,
      (const int32_t*)pack_firsts, (const uint8_t*)keep,
      (const int32_t*)range_start, n_blocks, (int32_t*)out);
  return (int)cudaGetLastError();
}

// One range step. acc_global is null for the shared-memory accumulator
// (s_pad <= shared_acc_slots(k, false)) and a [s_pad + kAccLists] int32
// scratch otherwise; top_global is null for the shared-memory top-k
// scratch (top_shared(k, false)) and a scratch of top_bytes(k, false)
// bytes otherwise. timing, when not null, launches the timed variant
// (int8 impacts, packed docids, both placements shared) and receives its
// [kPhases + 1] int64 clocks.
int rs_range_step(const void* docs, int64_t n_docs, const void* impacts,
                  int64_t n_imps, int impacts_int8, const void* blk_start,
                  const void* blk_len, const void* blk_maximp, const void* words,
                  int64_t n_words, const void* pack_dir, const void* pack_first,
                  int packed, const void* blk_ids, const void* rest, int64_t n_blocks,
                  const void* range_start, const void* vals, const void* ids,
                  const void* postings, const void* blocks, int64_t k, int64_t s_pad,
                  int prune, void* acc_global, void* top_global, void* out, void* timing,
                  void* stream) {
  StepArgs a;
  const bool shared_acc = acc_global == nullptr, shared_top = top_global == nullptr;
  if (!index_args(&a.ix, docs, n_docs, impacts, n_imps, blk_start, blk_len, blk_maximp,
                  words, n_words, pack_dir, pack_first, packed, k, s_pad, prune) ||
      n_blocks < 0 || n_blocks > INT32_MAX ||
      !placements_ok(shared_acc, shared_top, k, s_pad, false)) {
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
  a.top_global = (int32_t*)top_global;
  a.timing = (long long*)timing;
  a.n_blocks = (int)n_blocks;
  const size_t smem = smem_bytes(shared_acc, shared_top, k, s_pad, false);
  const cudaStream_t st = (cudaStream_t)stream;
  if (timing != nullptr) {
    if (!shared_acc || !shared_top || !packed || !impacts_int8) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)launch_range_step<true, true, true, true, true>(a, smem, st);
  }
  RS_DISPATCH(launch_range_step, a, smem, st)
}

// N lanes' whole-query loops from their carries. acc_global is null for
// the shared-memory accumulator (s_pad <= shared_acc_slots(k, true)) and
// an [n_lanes, s_pad + kAccLists] int32 scratch otherwise; top_global is
// null for the shared-memory top-k scratch and [n_lanes] scratches of
// top_bytes(k, true) bytes otherwise; quantum < 0 runs each lane to an
// exit. With n_shards = S > 1 the index columns are S stacked rows
// (n_docs, n_imps and n_words the row widths, the strides their row
// strides, range_starts [S, n_ranges]) and lane n reads row n % S.
// timing, when not null, launches the timed variant (as rs_range_step's)
// and receives [n_lanes, kPhases + 1] int64 clocks.
int rs_traverse(const void* docs, int64_t n_docs, const void* impacts, int64_t n_imps,
                int impacts_int8, const void* blk_start, const void* blk_len,
                const void* blk_maximp, const void* words, int64_t n_words,
                const void* pack_dir, const void* pack_first, int packed,
                const void* range_starts, const void* blk_tab, const void* rest_tab,
                const void* order, const void* bounds, const void* budget,
                const void* maxr, const void* carry_in, void* carry_out,
                int64_t n_lanes, int64_t n_ranges, int64_t n_blocks, int64_t k,
                int64_t s_pad, int64_t quantum, int safe_stop, int prune,
                void* acc_global, void* top_global, int64_t n_shards, int64_t docs_stride,
                int64_t imps_stride, int64_t blk_stride, int64_t words_stride,
                void* timing, void* stream) {
  TraverseArgs t;
  const bool shared_acc = acc_global == nullptr, shared_top = top_global == nullptr;
  if (!index_args(&t.ix, docs, n_docs, impacts, n_imps, blk_start, blk_len, blk_maximp,
                  words, n_words, pack_dir, pack_first, packed, k, s_pad, prune) ||
      n_lanes < 1 || n_lanes > 65535 || n_ranges < 1 || n_ranges > INT32_MAX ||
      n_blocks < 0 || n_blocks > INT32_MAX || quantum > INT32_MAX ||
      n_shards < 1 || n_lanes % n_shards != 0 ||
      (n_shards > 1 && (docs_stride < 0 || imps_stride < n_imps ||
                        blk_stride < 1 || words_stride < 0)) ||
      !placements_ok(shared_acc, shared_top, k, s_pad, true)) {
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
  t.top_global = (int32_t*)top_global;
  t.timing = (long long*)timing;
  t.n_ranges = (int)n_ranges;
  t.n_blocks = (int)n_blocks;
  t.quantum = quantum < 0 ? -1 : (int)quantum;
  t.safe_stop = safe_stop;
  const size_t smem = smem_bytes(shared_acc, shared_top, k, s_pad, true);
  const unsigned g = (unsigned)n_lanes;
  const cudaStream_t st = (cudaStream_t)stream;
  if (timing != nullptr) {
    if (!shared_acc || !shared_top || !packed || !impacts_int8) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)launch_traverse<true, true, true, true, true>(t, g, smem, st);
  }
  RS_DISPATCH(launch_traverse, t, g, smem, st)
}

}  // extern "C"
