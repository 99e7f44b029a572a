// Two-stage scorer, stage 1: per item tile, dequantize int8 factors,
// score them against each query row in f32 and emit the tile's local
// top-c. Hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside `build_pallas_shortlist`
// (predictionio_tpu/ops/scoring.py:885) and computes what the reference
// actually serves with, `_shortlist_scan` (ops/scoring.py:237): the
// Pallas kernel takes no exclusion mask, this one does.
//
//   u      [B, R]      f32   query rows, already rotated and truncated
//   tiles  [nt, T, R]  int8  quantized item factors, item-major
//   scales [nt, T]     f32   per-item dequantization scale
//   mask   [B, nt*T]   u8    optional, nonzero = excluded
//   vals   [B, nt*c]   f32   out: tile t's candidates at [t*c, (t+1)*c)
//   ids    [B, nt*c]   i32   out: global item ids
//
// Score of item i of tile t for row b: (sum_r u[b,r] * q[t,i,r]) * s[t,i];
// -inf when t*T+i >= n_items or the item is masked. Candidates come out
// value descending, ties by ascending id (the rule of lax.top_k and of
// ops/topk.merge_topk). Slots beyond a tile's finite scores carry -inf
// (and the tile's first id).
//
// Bound on the card: every tile byte read once, nt*T*R + nt*T*4 bytes
// (+ B*nt*T for a mask). At 10M items, scan rank 32 and T = 16384 that
// is about 360 MB, 0.107 ms at 3.35 TB/s; at large B the 2*B*nt*T*R f32
// operations (67 TFLOP/s on the CUDA cores) bound it instead, 0.62 ms at
// B = 64 (f32 FMA), or 0.17 ms where the product runs on the tensor
// cores (two TF32 products a score).
//
// Design. A cluster of G CTAs (G <= 8, the portable size) takes one
// (tile, group of BR query rows); CTA r of the cluster scores the slice
// [r*S, (r+1)*S) of the tile. The host picks C, BR, G, the stage and the
// shared memory bytes (ops/kernels.shortlist_plan) and this file
// recomputes the layout and refuses a mismatch. What each part does
// about the four things that held the first version back:
//  1. Selection without c serial block-argmax rounds. Each candidate
//     becomes a unique 47-bit key: an order-preserving u32 of its score
//     over 15 bits of (T-1-local id), so larger is better and ties go to
//     the lower id by construction. Three finishes, by c:
//     - c <= 8: every thread keeps its own top-C (C = 2, 4 or 8) per row
//       in registers while it scores (a floor shared by the warp skips
//       most insertions for C = 8), and no score is kept; the lists are
//       merged by shuffles over each warp, then over the CTA's warps,
//       then over the cluster in rank 0, which writes the top c.
//     - 8 < c <= 16 (C = 16, the masked queries' c): a queue a row in
//       shared memory. A score whose key beats the row's floor is
//       appended (one atomic a warp; until the row has a floor, only
//       scores at or above the c-th largest of the warp's lanes' best);
//       when a stage could overflow the queue, the row's warp cuts it to
//       its 16 best (chunks of 32 keys sorted over the warp and merged
//       into the 16; chunks that cannot enter are skipped) and the floor
//       becomes the c-th best key. Append counts rotate over three
//       rounds, so a stage reads, appends to and clears different ones
//       and takes a barrier of its own only when it cuts. At the end
//       each CTA's 16 best go to rank 0, which merges them the same way.
//       Per-thread lists of 16 spilled registers and filled from half the
//       items a thread sees (PERF.md).
//     - c > 16: every key of the slice is kept and a radix select finds
//       the c-th largest in at most six 8-bit digit passes: each CTA
//       builds the row's digit histogram over its own keys (warp-
//       aggregated atomics), the row's owner CTA (row b % G) sums the G
//       histograms through distributed shared memory, picks the digit
//       and writes the row's new state into every CTA; a row stops as
//       soon as its chosen bin holds exactly the count still needed.
//       Every CTA then counts its keys at or above the threshold, reads
//       the counts of the ranks below it and writes its winners into the
//       owner's buffer from there on; the owner sorts the c winners
//       (bitonic: steps of 64 and more over the CTA, the rest a warp per
//       64 keys; in shared memory, or in a global scratch buffer the
//       wrapper allocates when c is too large) and writes them.
//     One launch per call.
//  2. Too few blocks: G > 1 spreads one tile over up to 8 SMs when
//     groups x tiles x rows is small next to the card's 132 SMs.
//  3. Tiles read once per row: the slice is staged 512 items at a time
//     (fewer where R is large: 256 down to 16, then 256 items of a chunk
//     of each row's bytes at a time, so any R fits) into shared memory
//     with cp.async (a ring of three, two stages in flight, one CTA
//     barrier a stage; 16-byte pieces swizzled so eight neighbouring
//     rows' reads hit distinct banks), and each thread dequantizes an
//     item's bytes once and multiplies them into all BR rows of its group
//     (a register tile of 2 items x BR rows). A tile is read from device
//     memory once per group of up to 8 rows (the groups of one tile run
//     side by side and share it through L2).
//     At R = 32, groups of 8 rows and c <= 4 (the serve cell's batches)
//     the product runs on the tensor cores instead (mma.sync m16n8k8
//     TF32: an int8 is exact in TF32, u is split into TF32 hi and lo
//     parts, two products a score, f32 accumulation), which holds the
//     smoke's rows at its tolerance (1e-5).
//  4. Residency: no [T] score row. With c <= 16 nothing of the slice's
//     scores is kept but the queues; otherwise the keys of the CTA's
//     slice only (S = T/G items x BR rows), and the select's histograms,
//     counters and sort buffers reuse the staging buffers once scoring
//     is done.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIpt = 2;                       // items a thread scores at once
constexpr int kStages = 3;                    // staging ring: two loads in flight
constexpr int kBins = 256;
constexpr int kPasses = 6;                    // digits of a 47-bit key
constexpr unsigned kLidMask = 0x7FFFu;        // 15 bits: T <= 32768
constexpr int kQueue = 16;                    // C of the queue finish
constexpr int kQueueSlack = 64;               // a queue: a stage's items + 64
constexpr int kMaxDevices = 64;

struct RowSel {
  unsigned long long prefix;   // digits fixed so far; the threshold once done
  unsigned long long mask;     // which bits of prefix are fixed
  int need;                    // winners still to find under prefix
  int done;
};

// Byte offsets into dynamic shared memory. ops/kernels.shortlist_smem_bytes
// mirrors make_layout line for line.
struct Layout {
  unsigned u, keys, region, stage_bytes, stage_scales, stage_mask, stage_u, wtop,
      gtop, qbuf, qfloor, qcnt, hist, state, count, sort, total;
  int S, owned, cpad, r4, stage_items, qcap;
  int rc;    // bytes of each item's row a stage holds: R, or a chunk of it
  int nrc;   // stages an item block takes (1 unless the rows are chunked)
};

__host__ __device__ inline unsigned align16(unsigned long long x) {
  return static_cast<unsigned>((x + 15) & ~15ull);
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ inline Layout make_layout(int C, int BR, int G, int T, int R,
                                   int cand, int stage_items, bool sort_smem,
                                   bool masked, int rc) {
  Layout L{};
  L.r4 = (R + 3) & ~3;
  L.S = (((T + G - 1) / G) + 15) & ~15;
  L.owned = (BR + G - 1) / G;
  L.cpad = pow2_at_least(cand);
  L.stage_items = stage_items;
  L.rc = rc;
  L.nrc = (R + rc - 1) / rc;
  unsigned long long off = 0;
  L.u = 0;   // u of the group, [r4][BR]; with rows in chunks, in each stage
  if (L.nrc == 1) off += align16(4ull * L.r4 * BR);
  L.keys = static_cast<unsigned>(off);
  if (C == 0) off += align16(4ull * BR * L.S);
  // rank 0's lists of every CTA's top C: written by other CTAs while this
  // one may still be scoring, so outside the staging ring
  L.gtop = static_cast<unsigned>(off);
  if (C > 0) off += align16(8ull * BR * G * C);
  // the queues, their floors and three rounds of append counts: kept
  // across stages
  L.qcap = stage_items + kQueueSlack;
  L.qbuf = static_cast<unsigned>(off);
  if (C == kQueue) off += align16(8ull * BR * L.qcap);
  L.qfloor = static_cast<unsigned>(off);
  if (C == kQueue) off += align16(8ull * BR);
  L.qcnt = static_cast<unsigned>(off);
  if (C == kQueue) off += align16(12ull * BR);
  L.region = static_cast<unsigned>(off);
  // a stage: the items' bytes, their scales, and each row's mask bytes
  L.stage_scales = align16(static_cast<unsigned long long>(stage_items) * rc + 16);
  L.stage_mask = L.stage_scales + 4u * stage_items;
  L.stage_u = L.stage_mask + (masked ? static_cast<unsigned>(BR * stage_items) : 0u);
  L.stage_bytes = L.stage_u + (L.nrc > 1 ? 4u * rc * BR : 0u);
  const unsigned long long stage_end = off + kStages * static_cast<unsigned long long>(L.stage_bytes);
  unsigned long long p = off;
  if (C == kQueue) {
    L.total = stage_end > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<unsigned>(stage_end);
    return L;
  }
  if (C > 0) {
    // the warps' top-C lists of every row
    L.wtop = static_cast<unsigned>(p);
    p += align16(8ull * BR * kWarps * C);
    const unsigned long long total = stage_end > p ? stage_end : p;
    L.total = total > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<unsigned>(total);
    return L;
  }
  L.hist = static_cast<unsigned>(p);
  p += 2ull * BR * kBins * 4;
  L.state = static_cast<unsigned>(p);
  p += align16(sizeof(RowSel) * static_cast<unsigned long long>(BR));
  L.count = static_cast<unsigned>(p);
  p += align16(12ull * BR);   // per row: winners here, offset, next slot
  L.sort = static_cast<unsigned>(p);
  if (sort_smem) p += 8ull * L.owned * L.cpad;
  const unsigned long long total = stage_end > p ? stage_end : p;
  L.total = total > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<unsigned>(total);
  return L;
}

// order-preserving u32 of a finite score (-0 counts as +0); 0 is never a
// key, so 0 marks "no candidate"
__device__ __forceinline__ unsigned score_key(float s) {
  unsigned bits = __float_as_uint(s);
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long combine(unsigned key, int lid) {
  return key ? (static_cast<unsigned long long>(key) << 15) |
                   (kLidMask - static_cast<unsigned>(lid))
             : 0ull;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dequantize the 4 int8 of a word exactly: (2^23 + (b ^ 0x80)) - (2^23 + 128)
__device__ __forceinline__ void bytes_to_floats(unsigned w, float (&f)[4]) {
  const unsigned x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651u)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652u)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653u)) - 8388736.f;
}

// round to TF32 (10 mantissa bits), as a bit pattern for mma
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D += A * B on the tensor cores: m16n8k8, TF32 inputs, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// keep a descending (value, lid) list; lids arrive ascending, so an equal
// value stays behind the earlier item
template <int C>
__device__ __forceinline__ void list_insert(float (&v)[C], int (&id)[C],
                                            float s, int lid) {
  v[C - 1] = s;
  id[C - 1] = lid;
#pragma unroll
  for (int q = C - 1; q > 0; --q) {
    if (v[q] > v[q - 1]) {
      const float tv = v[q];
      v[q] = v[q - 1];
      v[q - 1] = tv;
      const int ti = id[q];
      id[q] = id[q - 1];
      id[q - 1] = ti;
    }
  }
}

__device__ __forceinline__ void order_desc(unsigned long long& a,
                                           unsigned long long& b) {
  if (a < b) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// Two descending lists of C unique keys, this lane's and the one of lane
// ^ off, to the top C of both, descending: the larger of a[q] and the
// other's b[C-1-q] is a bitonic sequence holding the top C; a bitonic
// merge sorts it.
template <int C>
__device__ __forceinline__ void merge_xor(unsigned long long (&a)[C], int off) {
  unsigned long long b[C];
#pragma unroll
  for (int q = 0; q < C; ++q) b[q] = __shfl_xor_sync(0xffffffffu, a[q], off);
#pragma unroll
  for (int q = 0; q < C; ++q) a[q] = a[q] > b[C - 1 - q] ? a[q] : b[C - 1 - q];
#pragma unroll
  for (int j = C / 2; j > 0; j >>= 1)
#pragma unroll
    for (int q = 0; q < C; ++q)
      if ((q & j) == 0) order_desc(a[q], a[q + j]);
}

// The warp's 16 best of n unique keys (0: none) in keys[0, n): lane q <
// 16 returns the q-th best (0 where there are fewer), lanes 16..31 return
// 0. The keys go 32 at a time, one a lane, and only those above the 16th
// best so far count. A chunk with more than 8 of them is sorted over the
// warp (bitonic) and merged: the larger of the q-th best and the chunk's
// (15-q)-th, a bitonic sequence holding the 16 best of both, is sorted.
// Fewer are inserted one at a time (each lane keeps its key, takes the
// new one, or takes its upper neighbour's), a far shorter chain.
__device__ __forceinline__ unsigned long long warp_top16(
    const unsigned long long* keys, int n, int lane) {
  unsigned long long top = 0ull, kth = 0ull;
  for (int base = 0; base < n; base += 32) {
    unsigned long long x = base + lane < n ? keys[base + lane] : 0ull;
    if (x <= kth) x = 0ull;
    unsigned live = __ballot_sync(0xffffffffu, x != 0ull);
    if (!live) continue;
    if (__popc(live) > 8) {
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, j);
          x = (((lane & j) == 0) == ((lane & k) == 0)) ? (x > y ? x : y)
                                                       : (x < y ? x : y);
        }
      const unsigned long long y = __shfl_sync(0xffffffffu, x, (15 - lane) & 31);
      if (lane < 16 && y > top) top = y;
#pragma unroll
      for (int j = 8; j > 0; j >>= 1) {
        const unsigned long long z = __shfl_xor_sync(0xffffffffu, top, j);
        top = (lane & j) == 0 ? (top > z ? top : z) : (top < z ? top : z);
      }
    } else {
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const unsigned long long key = __shfl_sync(0xffffffffu, x, src);
        const unsigned long long up = __shfl_up_sync(0xffffffffu, top, 1);
        if (lane < 16 && key > top) top = (lane == 0 || up > key) ? key : up;
      }
    }
    kth = __shfl_sync(0xffffffffu, top, 15);
  }
  return top;
}

// Rows a group may have: 8, or 32 / C for the register lists.
__host__ __device__ constexpr int max_rows(int C) {
  return (C == 0 || C == kQueue) ? 8 : (32 / C < 8 ? 32 / C : 8);
}

// C == 0: every item of the slice keeps its key (c > 16).
// C == 16: a queue a row in shared memory (8 < c <= 16).
// C = 2, 4, 8: each thread keeps its top-C per row in registers (c <= C).
// CTAs an SM should hold (a register cap), the fastest of 2, 3 and 4 at
// the smoke's shapes on the H100: four (64 registers) for lists of 2, one
// row, or two rows with lists of at most 4 or a queue; three for lists
// of 8 or four rows of queues; else two.
template <int C, int BR>
constexpr int min_ctas() {
  if constexpr (C == kQueue) return BR <= 2 ? 4 : (BR == 4 ? 3 : 2);
  return (C == 2 || BR == 1 || (BR == 2 && C <= 4)) ? 4 : (C >= 8 ? 3 : 2);
}

// TC: the product on the tensor cores (R = 32, 8 rows, c <= 4).
template <int C, int BR, bool TC>
__global__ void __launch_bounds__(kThreads, min_ctas<C, BR>())
shortlist_kernel(const float* __restrict__ u, const int8_t* __restrict__ tiles,
                 const float* __restrict__ scales,
                 const uint8_t* __restrict__ mask, float* __restrict__ vals,
                 int32_t* __restrict__ ids,
                 unsigned long long* __restrict__ scratch, int B, int nt,
                 int T, int R, int n_items, int cand, int G, int sort_smem,
                 Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / G;
  const int ngroups = (B + BR - 1) / BR;
  const int g = cid % ngroups;
  const int t = cid / ngroups;
  const int b0 = g * BR;
  const int nb = min(BR, B - b0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_pad = static_cast<long long>(nt) * T;
  const long long tbase = static_cast<long long>(t) * T;
  const int S = L.S;
  const int slice0 = rank * S;
  const int slice_end = min(T, slice0 + S);
  const int slice_len = max(0, slice_end - slice0);
  const int nslots = S;   // the select's candidates: the slice's keys

  float* uT = reinterpret_cast<float*>(smem + L.u);   // [r4][BR]
  unsigned* keys = reinterpret_cast<unsigned*>(smem + L.keys);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
  RowSel* st = reinterpret_cast<RowSel*>(smem + L.state);
  int* counters = reinterpret_cast<int*>(smem + L.count);
  unsigned long long* sortb =
      reinterpret_cast<unsigned long long*>(smem + L.sort);

  for (int i = tid; i < (L.nrc == 1 ? L.r4 * BR : 0); i += kThreads) {
    const int r = i / BR, b = i - (i / BR) * BR;
    uT[i] = (r < R && b < nb) ? u[static_cast<long long>(b0 + b) * R + r] : 0.f;
  }
  if constexpr (C == 0) {
    for (int b = 0; b < BR; ++b)
      for (int s = slice_len + tid; s < S; s += kThreads) keys[b * S + s] = 0u;
  }

  unsigned long long* qbuf = reinterpret_cast<unsigned long long*>(smem + L.qbuf);
  unsigned long long* qfloor = reinterpret_cast<unsigned long long*>(smem + L.qfloor);
  // Appends of selection stage ks count in qoff[ks % 3][b] from the
  // row's base (qbase[b], the same in every thread): the counts a stage
  // reads (round ks - 1), the ones it appends to (ks) and the ones it
  // zeroes (ks + 1) differ, so a stage needs no barrier of its own
  // unless a queue is cut.
  int* qoff = reinterpret_cast<int*>(smem + L.qcnt);
  if constexpr (C == kQueue) {
    if (tid < BR) qfloor[tid] = 0ull;
    if (tid < 3 * BR) qoff[tid] = 0;
  }

  constexpr int CL = (C > 0 && C != kQueue) ? C : 1;
  float lv[BR][CL];
  int li[BR][CL];
  float floor_v[BR];   // an item at or below it cannot reach the top c
#pragma unroll
  for (int b = 0; b < BR; ++b) floor_v[b] = -INFINITY;
#pragma unroll
  for (int b = 0; b < BR; ++b)
#pragma unroll
    for (int q = 0; q < CL; ++q) {
      lv[b][q] = -INFINITY;
      li[b][q] = 0;
    }
  // the queue's floor of each row, as a key and as a score (-inf: none)
  unsigned long long qfl[C == kQueue ? BR : 1];
  float qft[C == kQueue ? BR : 1];
  int qbase[C == kQueue ? BR : 1];
  int ks = 0;   // selection stages done
#pragma unroll
  for (int b = 0; b < (C == kQueue ? BR : 1); ++b) {
    qfl[b] = 0ull;
    qft[b] = -INFINITY;
    qbase[b] = 0;
  }

  // ---- scoring: the slice in stages of stage_items, a ring of three ----
  // With rows in chunks (nrc > 1) a block of stage_items items takes nrc
  // stages, one chunk of rc bytes of each row a stage; the products add
  // up over the chunks and the block's scores are final at its last.
  const int si = L.stage_items;
  const int nrc = L.nrc;
  const int rc = L.rc;
  const int n_st = (slice_len + si - 1) / si * nrc;
  unsigned char* stage0 = smem + L.region;
  const int8_t* tile_bytes = tiles + tbase * R;
  // 16-byte pieces of whole rows (the wrapper checks tiles is 16-aligned)
  const bool v16 = (R & 15) == 0 && nrc == 1;
  // byte offset of 16-byte piece h of staged item i. When R is a multiple
  // of 32, pieces h and h^1 swap places in every other group of four
  // items, so the 16-byte reads of 8 neighbouring items (one shared
  // memory wavefront) hit 32 distinct banks instead of 16 twice.
  const int swz = (R & 31) == 0 ? 1 : 0;
  auto chunk16 = [&](int i, int h) -> int {
    return i * R + 16 * (h ^ (((i >> 2) & 1) & swz));
  };
  // nbytes from src to dst: 16-byte cp.async where src is aligned, the
  // rest (or all of it) by plain loads, visible after the next barrier
  auto copy_bytes = [&](unsigned char* dst, const unsigned char* src,
                        int nbytes) {
    int done16 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      done16 = nbytes & ~15;
      for (int q = tid * 16; q < done16; q += kThreads * 16)
        cp_async16(dst + q, src + q);
    }
    for (int q = done16 + tid; q < nbytes; q += kThreads) dst[q] = src[q];
  };
  auto issue = [&](int k) {
    unsigned char* dst = stage0 + (k % kStages) * L.stage_bytes;
    const int kb = nrc == 1 ? k : k / nrc;
    const int kr = k - kb * nrc;
    const int i0 = slice0 + kb * si;
    const int n = min(si, slice_end - i0);
    const int8_t* src = tile_bytes + static_cast<long long>(i0) * R;
    copy_bytes(dst + L.stage_scales,
               reinterpret_cast<const unsigned char*>(scales + tbase + i0), 4 * n);
    if (mask) {
      for (int b = 0; b < nb; ++b)
        copy_bytes(dst + L.stage_mask + b * si,
                   mask + static_cast<long long>(b0 + b) * n_pad + tbase + i0, n);
    }
    if (nrc > 1) {   // bytes [kr*rc, +w) of each row, at a stride of rc
      const int off = kr * rc;
      const int w = min(rc, R - off);
      // and u's [off, off + w) of each row, [r][BR], 0 up to a multiple of 4
      float* su = reinterpret_cast<float*>(dst + L.stage_u);
      for (int q = tid; q < ((w + 3) & ~3) * BR; q += kThreads) {
        const int r = q / BR;
        const int b = q - r * BR;
        su[q] = (r < w && b < nb) ? u[static_cast<long long>(b0 + b) * R + off + r] : 0.f;
      }
      if ((R & 15) == 0) {   // rc and off are multiples of 16 too
        const int pieces = w >> 4;
        for (int q = tid; q < n * pieces; q += kThreads) {
          const int i = q / pieces;
          const int h = q - i * pieces;
          cp_async16(dst + i * rc + 16 * h,
                     src + static_cast<long long>(i) * R + off + 16 * h);
        }
      } else {
        for (int q = tid; q < n * w; q += kThreads) {
          const int i = q / w;
          const int o = q - i * w;
          dst[i * rc + o] = reinterpret_cast<const unsigned char*>(
              src)[static_cast<long long>(i) * R + off + o];
        }
      }
    } else if (v16) {   // whole 16-byte pieces of rows, swizzled (see chunk16)
      const int r16 = R >> 4;
      // a shift where R / 16 is a power of two (R = 16, 32, 64, ...): the
      // division would cost more than the copy it addresses
      const int sh = (r16 & (r16 - 1)) == 0 ? __ffs(r16) - 1 : -1;
      for (int q = tid; q < n * r16; q += kThreads) {
        const int i = sh >= 0 ? q >> sh : q / r16;
        cp_async16(dst + chunk16(i, q - i * r16), src + 16 * q);
      }
    } else {
      copy_bytes(dst, reinterpret_cast<const unsigned char*>(src), n * R);
    }
  };

  // stage k is in buffer k % 3; every iteration commits one group (empty
  // past the end), so "all but the newest group done" means stage k has
  // landed
  if (n_st > 0) issue(0);
  cp_async_commit();
  if (n_st > 1) issue(1);
  cp_async_commit();
  // Tensor-core path: per stage a warp scores its 64 items as 4 tiles of
  // 16 items x 8 rows, 4 k-steps of 8 of R = 32, each an exact TF32 int8
  // operand times u split into TF32 hi and lo parts (two mma a k-step,
  // f32 accumulation). Lane (g, t) of a tile loads bytes [8t, 8t+8) of
  // items g and g+8; k-step k takes bytes 2k and 2k+1 as its columns t
  // and t+4, so u's fragments follow the same order. It holds the scores
  // of items g, g+8 for rows 2t, 2t+1 and keeps lists for those two rows.
  const int tg = lane >> 2, tq = lane & 3;
  unsigned bh[4][2], bl[4][2];
  float tv[2][C > 0 ? C : 1];
  int ti[2][C > 0 ? C : 1];
  if constexpr (TC) {
    __syncthreads();   // uT, written by every thread above
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = uT[(8 * tq + 2 * kk + h) * BR + tg];
        bh[kk][h] = to_tf32(x);
        bl[kk][h] = to_tf32(x - __uint_as_float(bh[kk][h]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < (C > 0 ? C : 1); ++q) {
        tv[r][q] = -INFINITY;
        ti[r][q] = 0;
      }
  }
  float acc[kIpt][BR];   // the products, summed over a block's chunks
  int kr = 0;            // this stage's chunk of its block
  for (int k = 0; k < n_st; ++k, kr = kr + 1 == nrc ? 0 : kr + 1) {
    cp_async_wait<1>();
    __syncthreads();   // stage k landed; every thread is done with k - 1
    if (k + 2 < n_st) issue(k + 2);   // into k - 1's buffer
    cp_async_commit();
    const bool last = kr == nrc - 1;   // the block's scores are final
    if constexpr (C == kQueue) {
      if (last) {
        // each queue's length after the last selection stage; cut every
        // queue this stage could overflow to its 16 best (the decision
        // is the same in every thread: no one writes these counts now)
        const int* prev = qoff + ((ks + 2) % 3) * BR;
        int len[BR];
        bool any = false;
        int mine = 0;   // the length of this warp's row
#pragma unroll
        for (int b = 0; b < BR; ++b) {
          len[b] = qbase[b] + prev[b];
          any = any || len[b] > L.qcap - si;
          if (b == warp) mine = len[b];
        }
        if (any) {
          if (warp < nb && mine > L.qcap - si) {
            unsigned long long* q = qbuf + warp * L.qcap;
            const unsigned long long top = warp_top16(q, mine, lane);
            __syncwarp();
            if (lane < kQueue) q[lane] = top;
            const unsigned long long fl = __shfl_sync(0xffffffffu, top, cand - 1);
            if (lane == 0) qfloor[warp] = fl;
          }
          __syncthreads();
#pragma unroll
          for (int b = 0; b < BR; ++b) {
            if (len[b] > L.qcap - si) {   // held more than 64 keys: now 16
              len[b] = kQueue;
              qfl[b] = qfloor[b];
              qft[b] = key_score(static_cast<unsigned>(qfl[b] >> 15));
            }
          }
        }
#pragma unroll
        for (int b = 0; b < BR; ++b) qbase[b] = len[b];
        if (tid < BR) qoff[((ks + 1) % 3) * BR + tid] = 0;
      }
    }
    const unsigned char* sb = stage0 + (k % kStages) * L.stage_bytes;
    const int i0 = slice0 + (nrc == 1 ? k : k / nrc) * si;
    const int n = min(si, slice_end - i0);
    if constexpr (TC) {
      const float* ssc = reinterpret_cast<const float*>(sb + L.stage_scales);
#pragma unroll
      for (int m = 0; m < kIpt; ++m) {
        // the warp's two tiles of this half: items jb + 16h + [0, 16)
        const int jb = m * kThreads + warp * 32;
        uint2 q[2][2];   // [tile][item g, g + 8]: bytes [8t, 8t + 8)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = jb + 16 * h + tg + 8 * e;
            q[h][e] = jj < n ? *reinterpret_cast<const uint2*>(
                                   sb + chunk16(jj, tq >> 1) + 8 * (tq & 1))
                             : make_uint2(0u, 0u);   // dequantizes to zeros
          }
        // hi and lo products in separate accumulators: four independent
        // mma chains, summed once at the end
        float dh[2][4], dl[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dh[h][e] = 0.f;
            dl[h][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned w0 = (kk < 2 ? q[h][0].x : q[h][0].y) ^ 0x80808080u;
            const unsigned w1 = (kk < 2 ? q[h][1].x : q[h][1].y) ^ 0x80808080u;
            const unsigned s0 = 0x7650u | ((2 * kk) & 3), s1 = 0x7650u | ((2 * kk + 1) & 3);
            const unsigned a0 = __float_as_uint(__uint_as_float(__byte_perm(w0, 0x4B000000u, s0)) - 8388736.f);
            const unsigned a1 = __float_as_uint(__uint_as_float(__byte_perm(w1, 0x4B000000u, s0)) - 8388736.f);
            const unsigned a2 = __float_as_uint(__uint_as_float(__byte_perm(w0, 0x4B000000u, s1)) - 8388736.f);
            const unsigned a3 = __float_as_uint(__uint_as_float(__byte_perm(w1, 0x4B000000u, s1)) - 8388736.f);
            mma_tf32(dl[h], a0, a1, a2, a3, bl[kk][0], bl[kk][1]);
            mma_tf32(dh[h], a0, a1, a2, a3, bh[kk][0], bh[kk][1]);
          }
        // d[e]: (item g, row 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = jb + 16 * h + tg + (e >> 1) * 8;
            const int r = e & 1;
            const int b = 2 * tq + r;
            if (jj >= n || b >= nb) continue;
            const int lid = i0 + jj;
            const long long gid = tbase + lid;
            if (gid >= n_items || (mask && sb[L.stage_mask + b * si + jj])) continue;
            const float sv = (dl[h][e] + dh[h][e]) * ssc[jj];
            if (sv > tv[r][C - 1]) list_insert<C>(tv[r], ti[r], sv, lid);
          }
      }
    } else {
    int j[kIpt];
    bool have[kIpt];
#pragma unroll
    for (int m = 0; m < kIpt; ++m) {
      j[m] = m * kThreads + tid;
      have[m] = j[m] < n;
    }
    if (kr == 0) {
#pragma unroll
      for (int m = 0; m < kIpt; ++m)
#pragma unroll
        for (int b = 0; b < BR; ++b) acc[m][b] = 0.f;
    }
    // one word (4 bytes of R) of each item: dequantize once, multiply
    // into every row of the group
    // u's rows from r = 0 on: resident, or this stage's chunk of them
    const float* ubase =
        nrc == 1 ? uT : reinterpret_cast<const float*>(sb + L.stage_u);
    auto word_step = [&](const unsigned (&wd)[kIpt], int w) {
      float f[kIpt][4];
#pragma unroll
      for (int m = 0; m < kIpt; ++m) bytes_to_floats(wd[m], f[m]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* ur = ubase + (w + q) * BR;
        float uu[BR];
        if constexpr (BR % 4 == 0) {
#pragma unroll
          for (int i = 0; i < BR / 4; ++i) {
            const float4 v4 = reinterpret_cast<const float4*>(ur)[i];
            uu[4 * i] = v4.x;
            uu[4 * i + 1] = v4.y;
            uu[4 * i + 2] = v4.z;
            uu[4 * i + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < BR; ++b) uu[b] = ur[b];
        }
#pragma unroll
        for (int m = 0; m < kIpt; ++m)
#pragma unroll
          for (int b = 0; b < BR; ++b)
            acc[m][b] = fmaf(f[m][q], uu[b], acc[m][b]);
      }
    };
    if (v16) {
      for (int w = 0; w < R; w += 16) {
        uint4 q4[kIpt];
#pragma unroll
        for (int m = 0; m < kIpt; ++m)
          q4[m] = have[m] ? *reinterpret_cast<const uint4*>(sb + chunk16(j[m], w >> 4))
                          : make_uint4(0u, 0u, 0u, 0u);
        unsigned wd[kIpt];
#pragma unroll
        for (int m = 0; m < kIpt; ++m) wd[m] = q4[m].x;
        word_step(wd, w);
#pragma unroll
        for (int m = 0; m < kIpt; ++m) wd[m] = q4[m].y;
        word_step(wd, w + 4);
#pragma unroll
        for (int m = 0; m < kIpt; ++m) wd[m] = q4[m].z;
        word_step(wd, w + 8);
#pragma unroll
        for (int m = 0; m < kIpt; ++m) wd[m] = q4[m].w;
        word_step(wd, w + 12);
      }
    } else {
      // rows at a stride of rs in the stage, holding bytes [kr*rc, +wend)
      // of each (wend rounded up to 4: u is 0 there, and a byte past the
      // row's end dequantizes to a finite value)
      const int rs = nrc == 1 ? R : rc;
      const int wend = nrc == 1 ? L.r4 : (min(rc, R - kr * rc) + 3) & ~3;
      const bool al4 = (rs & 3) == 0;
      for (int w = 0; w < wend; w += 4) {
        unsigned wd[kIpt];
#pragma unroll
        for (int m = 0; m < kIpt; ++m) {
          wd[m] = 0u;   // dequantizes to zeros
          if (have[m]) {
            const unsigned char* p = sb + j[m] * rs + w;
            wd[m] = al4 ? *reinterpret_cast<const unsigned*>(p)
                        : (static_cast<unsigned>(p[0]) |
                           (static_cast<unsigned>(p[1]) << 8) |
                           (static_cast<unsigned>(p[2]) << 16) |
                           (static_cast<unsigned>(p[3]) << 24));
          }
        }
        word_step(wd, w);
      }
    }
    if (last) {
      if constexpr (C == kQueue) {
        // append each score whose key beats its row's floor (one atomic
        // a warp and row). Until a row has a floor, the c-th largest of
        // the warp's lanes' best scores of this stage is one: c items of
        // the warp are at or above it.
        const unsigned lt_mask = (1u << lane) - 1u;
        float sc[kIpt][BR];
        bool live[kIpt][BR];
#pragma unroll
        for (int m = 0; m < kIpt; ++m) {
          const bool valid = have[m] && tbase + i0 + j[m] < n_items;
          const float scl =
              have[m] ? reinterpret_cast<const float*>(sb + L.stage_scales)[j[m]] : 0.f;
#pragma unroll
          for (int b = 0; b < BR; ++b) {
            sc[m][b] = acc[m][b] * scl;
            live[m][b] = valid && b < nb && !(mask && sb[L.stage_mask + b * si + j[m]]);
          }
        }
#pragma unroll
        for (int b = 0; b < BR; ++b) {
          float thr = qft[b];
          if (qfl[b] == 0ull) {   // the same in every thread
            float x = -INFINITY;
#pragma unroll
            for (int m = 0; m < kIpt; ++m)
              if (live[m][b]) x = fmaxf(x, sc[m][b]);
#pragma unroll
            for (int k2 = 2; k2 <= 32; k2 <<= 1)
#pragma unroll
              for (int j2 = k2 >> 1; j2 > 0; j2 >>= 1) {
                const float y = __shfl_xor_sync(0xffffffffu, x, j2);
                x = (((lane & j2) == 0) == ((lane & k2) == 0)) ? fmaxf(x, y) : fminf(x, y);
              }
            thr = __shfl_sync(0xffffffffu, x, cand - 1);
          }
#pragma unroll
          for (int m = 0; m < kIpt; ++m) {
            bool take = live[m][b] && sc[m][b] >= thr;
            unsigned long long x = 0ull;
            if (take) {
              x = combine(score_key(sc[m][b]), i0 + j[m]);
              take = x > qfl[b];
            }
            const unsigned bal = __ballot_sync(0xffffffffu, take);
            if (bal) {
              const int leader = __ffs(bal) - 1;
              int pos = 0;
              if (lane == leader) pos = atomicAdd(qoff + (ks % 3) * BR + b, __popc(bal));
              pos = __shfl_sync(0xffffffffu, pos, leader);
              if (take) qbuf[b * L.qcap + qbase[b] + pos + __popc(bal & lt_mask)] = x;
            }
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < kIpt; ++m) {
          if (!have[m]) continue;
          const int lid = i0 + j[m];
          const long long gid = tbase + lid;
          const bool valid = gid < n_items;
          const float scl = reinterpret_cast<const float*>(sb + L.stage_scales)[j[m]];
#pragma unroll
          for (int b = 0; b < BR; ++b) {
            const float s = acc[m][b] * scl;
            const bool dead = !valid || b >= nb ||
                              (mask && sb[L.stage_mask + b * si + j[m]]);
            if constexpr (C == 0) {
              keys[b * S + (lid - slice0)] = dead ? 0u : score_key(s);
            } else {
              if (!dead && s > floor_v[b]) {
                list_insert<C>(lv[b], li[b], s, lid);
                floor_v[b] = fmaxf(floor_v[b], lv[b][C - 1]);
              }
            }
          }
        }
      }
    }
    }
    if constexpr (C == kQueue) ks += last ? 1 : 0;
    if constexpr (C == 8) {
      // Floors for the slice's c-th best, from items of this and earlier
      // stages only (so with lower ids than any later item): a lane's
      // C-th best (C >= c items at or above it), and the (C/2)-th largest
      // of the warp's lanes' second-best values (C/2 lanes with two items
      // at or above it). The warp keeps the highest, so long lists fill
      // less often.
#pragma unroll
      for (int b = 0; b < BR; ++b) {
        float x = lv[b][1];   // bitonic sort of the lanes' values, descending
#pragma unroll
        for (int k2 = 2; k2 <= 32; k2 <<= 1)
#pragma unroll
          for (int j2 = k2 >> 1; j2 > 0; j2 >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, j2);
            x = (((lane & j2) == 0) == ((lane & k2) == 0)) ? fmaxf(x, y) : fminf(x, y);
          }
        float f = fmaxf(floor_v[b], __shfl_sync(0xffffffffu, x, C / 2 - 1));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          f = fmaxf(f, __shfl_xor_sync(0xffffffffu, f, off));
        floor_v[b] = f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the staging ring is free from here on

  if constexpr (C == kQueue) {
    // ---- 8 < c <= 16: each row's warp sends the CTA's 16 best of its
    // queue to rank 0, which merges the G lists and writes the top c ----
    unsigned long long* gtop = reinterpret_cast<unsigned long long*>(smem + L.gtop);
    int mine = 0;   // the length of this warp's row's queue
#pragma unroll
    for (int b = 0; b < BR; ++b)
      if (b == warp && ks > 0) mine = qbase[b] + qoff[((ks + 2) % 3) * BR + b];
    if (warp < nb) {
      const unsigned long long top = warp_top16(qbuf + warp * L.qcap, mine, lane);
      if (lane < kQueue)
        cluster.map_shared_rank(gtop, 0)[(warp * G + rank) * kQueue + lane] = top;
    }
    cluster.sync();   // rank 0 holds every CTA's lists; no remote access after
    if (rank != 0 || warp >= nb) return;
    const unsigned long long x = warp_top16(gtop + warp * G * kQueue, G * kQueue, lane);
    if (lane < cand) {
      const long long out = static_cast<long long>(b0 + warp) * nt * cand +
                            static_cast<long long>(t) * cand + lane;
      vals[out] = x ? key_score(static_cast<unsigned>(x >> 15)) : -INFINITY;
      ids[out] = static_cast<int32_t>(
          tbase + (x ? kLidMask - static_cast<unsigned>(x & kLidMask) : 0u));
    }
    return;
  } else if constexpr (C > 0) {
    // ---- c <= C: merge the threads' lists (keys as in the radix path) ----
    unsigned long long* wtop = reinterpret_cast<unsigned long long*>(smem + L.wtop);
    unsigned long long* gtop = reinterpret_cast<unsigned long long*>(smem + L.gtop);
#pragma unroll
    for (int b = 0; b < BR; ++b) {
      unsigned long long a[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if constexpr (TC) {
          const bool mine = (b >> 1) == tq;
          const float v = mine ? tv[b & 1][q] : -INFINITY;
          a[q] = v == -INFINITY ? 0ull : combine(score_key(v), ti[b & 1][q]);
        } else {
          a[q] = lv[b][q] == -INFINITY ? 0ull : combine(score_key(lv[b][q]), li[b][q]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) merge_xor<C>(a, off);
      if (lane == 0)
#pragma unroll
        for (int q = 0; q < C; ++q) wtop[(b * kWarps + warp) * C + q] = a[q];
    }
    __syncthreads();
    // a warp a row: the CTA's top C into rank 0's list of this rank
    for (int b = warp; b < nb; b += kWarps) {
      unsigned long long a[C];
#pragma unroll
      for (int q = 0; q < C; ++q)
        a[q] = lane < kWarps ? wtop[(b * kWarps + lane) * C + q] : 0ull;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) merge_xor<C>(a, off);
      if (lane == 0) {
        unsigned long long* dst = cluster.map_shared_rank(gtop, 0) + (b * G + rank) * C;
#pragma unroll
        for (int q = 0; q < C; ++q) dst[q] = a[q];
      }
    }
    cluster.sync();   // rank 0 holds every CTA's lists; no remote access after
    if (rank != 0) return;
    for (int b = warp; b < nb; b += kWarps) {
      unsigned long long a[C];
#pragma unroll
      for (int q = 0; q < C; ++q) a[q] = lane < G ? gtop[(b * G + lane) * C + q] : 0ull;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) merge_xor<C>(a, off);
      if (lane == 0) {
        const long long out0 = static_cast<long long>(b0 + b) * nt * cand +
                               static_cast<long long>(t) * cand;
#pragma unroll
        for (int q = 0; q < C; ++q) {
          if (q < cand) {
            const unsigned long long x = a[q];
            vals[out0 + q] = x ? key_score(static_cast<unsigned>(x >> 15)) : -INFINITY;
            ids[out0 + q] = static_cast<int32_t>(
                tbase + (x ? kLidMask - static_cast<unsigned>(x & kLidMask) : 0u));
          }
        }
      }
    }
    return;
  } else {
  // ---- c > 16: histograms, counters (over the staging buffers) ----
  for (int i = tid; i < 2 * BR * kBins; i += kThreads) hist[i] = 0u;
  if (tid < BR) {
    st[tid].prefix = 0ull;
    st[tid].mask = 0ull;
    st[tid].need = cand;
    st[tid].done = tid >= nb;
  }
  for (int i = tid; i < 3 * BR; i += kThreads) counters[i] = 0;
  const int nown = rank < nb ? (nb - 1 - rank) / G + 1 : 0;
  auto row_buf = [&](int o) -> unsigned long long* {
    const int b = rank + o * G;
    return sort_smem ? sortb + static_cast<long long>(o) * L.cpad
                     : scratch + (static_cast<long long>(b0 + b) * nt + t) *
                                     L.cpad;
  };
  for (int o = 0; o < nown; ++o) {
    unsigned long long* rb = row_buf(o);
    for (int i = tid; i < L.cpad; i += kThreads) rb[i] = 0ull;
  }
  __syncthreads();

  auto candidate = [&](int b, int s) -> unsigned long long {
    return combine(keys[b * S + s], slice0 + s);
  };

  // ---- radix select: the c-th largest key of each row over the cluster ----
  for (int p = 0; p < kPasses; ++p) {
    bool all_done = true;
    for (int b = 0; b < BR; ++b) all_done = all_done && st[b].done;
    if (all_done) break;   // the same in every CTA of the cluster
    const int shift = p < kPasses - 1 ? 39 - 8 * p : 0;
    unsigned* h = hist + (p & 1) * BR * kBins;
    for (int b = 0; b < BR; ++b) {
      if (st[b].done) continue;
      const unsigned long long pre = st[b].prefix, msk = st[b].mask;
      for (int base = 0; base < nslots; base += kThreads) {
        const int s = base + tid;
        bool pred = false;
        unsigned bin = 0;
        if (s < nslots) {
          const unsigned long long x = candidate(b, s);
          if (x && (x & msk) == pre) {
            pred = true;
            bin = static_cast<unsigned>((x >> shift) & 0xFFu);
          }
        }
        const unsigned act = __ballot_sync(0xffffffffu, pred);
        if (pred) {
          const unsigned peers = __match_any_sync(act, bin);
          if (lane == __ffs(peers) - 1) atomicAdd(&h[b * kBins + bin], __popc(peers));
        }
      }
    }
    cluster.sync();   // every CTA's histograms of this pass are complete
    // the owner of each row sums its histograms over the cluster, picks
    // the digit and writes the row's new state into every CTA
    for (int o = warp; o < nown; o += kWarps) {
      const int b = rank + o * G;
      RowSel* rs = st + b;
      if (rs->done) continue;
      unsigned cnt[8];
      unsigned lsum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) cnt[i] = 0;
      // this lane's 8 bins of two ranks at a time: 16-byte loads
      for (int r = 0; r < G; r += 2) {
        const uint4* h0 = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(h, r) + b * kBins + lane * 8);
        const uint4 a0 = h0[0], a1 = h0[1];
        uint4 c0 = make_uint4(0u, 0u, 0u, 0u), c1 = c0;
        if (r + 1 < G) {
          const uint4* h1 = reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(h, r + 1) + b * kBins + lane * 8);
          c0 = h1[0];
          c1 = h1[1];
        }
        cnt[0] += a0.x + c0.x; cnt[1] += a0.y + c0.y;
        cnt[2] += a0.z + c0.z; cnt[3] += a0.w + c0.w;
        cnt[4] += a1.x + c1.x; cnt[5] += a1.y + c1.y;
        cnt[6] += a1.z + c1.z; cnt[7] += a1.w + c1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) lsum += cnt[i];
      unsigned incl = lsum;   // sum over this lane and every lane above it
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      const unsigned total = __shfl_sync(0xffffffffu, incl, 0);
      const unsigned need = static_cast<unsigned>(rs->need);
      const unsigned long long pre = rs->prefix, msk = rs->mask;
      __syncwarp();
      if (total < need) {
        // fewer finite scores than c: admit them all
        if (lane == 0) {
          for (int r = 0; r < G; ++r) {
            RowSel* rr = cluster.map_shared_rank(rs, r);
            rr->prefix = 1ull;
            rr->done = 1;
          }
        }
        continue;
      }
      unsigned above = incl - lsum;
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        if (above < need && need <= above + cnt[i]) {
          const unsigned left = need - above;
          for (int r = 0; r < G; ++r) {
            RowSel* rr = cluster.map_shared_rank(rs, r);
            rr->prefix = pre | (static_cast<unsigned long long>(lane * 8 + i) << shift);
            rr->mask = msk | (0xFFull << shift);
            rr->need = static_cast<int>(left);
            rr->done = cnt[i] == left;
          }
        }
        above += cnt[i];
      }
    }
    // the other buffer was last read (remotely too) before this pass's sync
    unsigned* h2 = hist + ((p + 1) & 1) * BR * kBins;
    for (int i = tid; i < BR * kBins; i += kThreads) h2[i] = 0u;
    cluster.sync();   // the new row states are visible in every CTA
  }

  // ---- compaction: every key >= the row's threshold to the row's owner ----
  // Each CTA counts its winners, reads the counts of the ranks below it
  // (one round trip, all rows at once) and writes its winners into the
  // owner's buffer from that offset on.
  int* lcount = counters;            // [BR] winners in this CTA
  int* loffset = counters + BR;      // [BR] winners in the ranks below
  int* lnext = counters + 2 * BR;    // [BR] next free slot from loffset
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int b = 0; b < nb; ++b) {
    const unsigned long long thr = st[b].prefix;
    for (int base = 0; base < nslots; base += kThreads) {
      const int s = base + tid;
      const unsigned long long x = s < nslots ? candidate(b, s) : 0ull;
      const unsigned bal = __ballot_sync(0xffffffffu, x != 0ull && x >= thr);
      if (lane == 0 && bal) atomicAdd(lcount + b, __popc(bal));
    }
  }
  cluster.sync();
  if (tid < nb) {
    int below = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < rank) below += *cluster.map_shared_rank(lcount + tid, r);
    loffset[tid] = below;
  }
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const unsigned long long thr = st[b].prefix;
    const int owner = b % G;
    const int slot = b / G;
    unsigned long long* buf =
        sort_smem ? cluster.map_shared_rank(sortb + static_cast<long long>(slot) * L.cpad, owner)
                  : scratch + (static_cast<long long>(b0 + b) * nt + t) * L.cpad;
    buf += loffset[b];
    for (int base = 0; base < nslots; base += kThreads) {
      const int s = base + tid;
      const unsigned long long x = s < nslots ? candidate(b, s) : 0ull;
      const bool win = x != 0ull && x >= thr;
      const unsigned bal = __ballot_sync(0xffffffffu, win);
      if (bal) {
        const int leader = __ffs(bal) - 1;
        int pos = 0;
        if (lane == leader) pos = atomicAdd(lnext + b, __popc(bal));
        pos = __shfl_sync(0xffffffffu, pos, leader);
        if (win) buf[pos + __popc(bal & lt_mask)] = x;
      }
    }
  }
  cluster.sync();   // no CTA touches another's shared memory after this

  // ---- the owner sorts its rows' winners and writes them ----
  if (nown == 0) return;
  const int cpad = L.cpad;
  const int half = cpad >> 1;
  const int pairs = nown * half;
  const int half_log = half > 0 ? __ffs(half) - 1 : 0;
  // Bitonic sort, descending. Steps whose partner distance is 64 or more
  // run over the whole CTA; the rest of each merge runs inside blocks of
  // 64 keys (one pair a lane, a warp a block), with only warp syncs.
  const int blk = cpad < 64 ? cpad : 64;
  const int nblk = nown * (cpad / blk);
  auto cmp_swap = [&](int o, int i, int jj, int k) {
    unsigned long long* rb = row_buf(o);
    const unsigned long long a = rb[i], c2 = rb[i + jj];
    if ((a < c2) == ((i & k) == 0)) {
      rb[i] = c2;
      rb[i + jj] = a;
    }
  };
  for (int k = 2; k <= cpad; k <<= 1) {
    int jj = k >> 1;
    for (; jj >= 64; jj >>= 1) {
      for (int pi = tid; pi < pairs; pi += kThreads) {
        const int o = pi >> half_log;
        const int q = pi & (half - 1);
        cmp_swap(o, 2 * q - (q & (jj - 1)), jj, k);
      }
      __syncthreads();
    }
    for (int bi = warp; bi < nblk; bi += kWarps) {
      const int per_row = cpad / blk;
      const int o = bi / per_row;
      const int base = (bi - o * per_row) * blk;
      for (int j2 = jj; j2 > 0; j2 >>= 1) {
        if (lane < blk / 2)
          cmp_swap(o, base + 2 * lane - (lane & (j2 - 1)), j2, k);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nown * cand; e += kThreads) {
    const int o = e / cand;
    const int q = e - o * cand;
    const int b = rank + o * G;
    const unsigned long long x = row_buf(o)[q];
    const long long out = static_cast<long long>(b0 + b) * nt * cand +
                          static_cast<long long>(t) * cand + q;
    if (x == 0ull) {
      vals[out] = -INFINITY;
      ids[out] = static_cast<int32_t>(tbase);
    } else {
      vals[out] = key_score(static_cast<unsigned>(x >> 15));
      ids[out] = static_cast<int32_t>(tbase + (kLidMask - static_cast<unsigned>(x & kLidMask)));
    }
  }
  }
}

struct Args {
  const float* u;
  const int8_t* tiles;
  const float* scales;
  const uint8_t* mask;
  float* vals;
  int32_t* ids;
  unsigned long long* scratch;
  int B, nt, T, R, n_items, cand, G, sort_smem;
};

// Let every launch of an instance use the card's opt-in maximum of
// shared memory: set once an instance and device, to the same value
// whichever thread gets there first, so launches of one instance at
// different sizes from different threads never undo each other.
template <int C, int BR, bool TC>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(shortlist_kernel<C, BR, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int C, int BR, bool TC = false>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t stream) {
  cudaError_t err = allow_max_smem<C, BR, TC>();
  if (err != cudaSuccess) return err;
  const long long ngroups = (a.B + BR - 1) / BR;
  const long long blocks = static_cast<long long>(a.G) * a.nt * ngroups;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, shortlist_kernel<C, BR, TC>, a.u, a.tiles, a.scales, a.mask, a.vals,
      a.ids, a.scratch, a.B, a.nt, a.T, a.R, a.n_items, a.cand, a.G,
      a.sort_smem, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_rows(int BR, const Args& a, const Layout& L,
                          cudaStream_t s) {
  switch (BR) {
    case 1: return launch<C, 1>(a, L, s);
    case 2: return launch<C, 2>(a, L, s);
    case 4:
      if constexpr (max_rows(C) >= 4) return launch<C, 4>(a, L, s);
      break;
    case 8:
      if constexpr (max_rows(C) >= 8) return launch<C, 8>(a, L, s);
      break;
  }
  return cudaErrorInvalidValue;
}

bool pow2_in(int x, int lo, int hi) {
  return x >= lo && x <= hi && (x & (x - 1)) == 0;
}

// stage_items: a power of two from 16 to 512; rc: the whole row, or a
// chunk of it that is a multiple of 16 (rows chunked, 256 items a stage)
bool plan_ok(int C, int BR, int G, int R, int stage_items, int rc) {
  const bool c_ok = C == 0 || C == 2 || C == 4 || C == 8 || C == kQueue;
  const bool br_ok = pow2_in(BR, 1, 8) && BR <= max_rows(C);
  const bool g_ok = pow2_in(G, 1, 8);
  const bool si_ok = pow2_in(stage_items, 16, kThreads * kIpt);
  const bool rc_ok = rc == R || (rc > 0 && rc < R && rc % 16 == 0 &&
                                 stage_items == kThreads);
  return c_ok && br_ok && g_ok && si_ok && rc_ok;
}

}  // namespace

// Shared memory bytes of a launch plan (the host's plan must agree).
extern "C" long long pio_shortlist_smem_bytes(int C, int BR, int G, int T,
                                              int R, int cand,
                                              int stage_items, int sort_smem,
                                              int masked, int rc) {
  if (!plan_ok(C, BR, G, R, stage_items, rc)) return -1;
  return make_layout(C, BR, G, T, R, cand, stage_items, sort_smem != 0,
                     masked != 0, rc).total;
}

// Plain C entry point (bound with ctypes). Shapes are validated by the
// Python wrapper (ops/kernels.py), which also picks the plan: C (0; a
// per-thread list of 2, 4 or 8; or the queue, 16, when c <= C), BR rows
// per group, G CTAs per tile, the stage's items, the bytes of each row a
// stage holds, where the sort runs, whether the product runs on the
// tensor cores and the shared memory bytes. Returns the launch's
// cudaError_t: cudaErrorInvalidValue for a plan this file does not lay
// out the same way.
extern "C" int pio_shortlist_topc(const void* u, const void* tiles,
                                  const void* scales, const void* mask,
                                  void* vals, void* ids, void* scratch, int B,
                                  int nt, int T, int R, int n_items, int cand,
                                  int C, int BR, int G, int stage_items,
                                  int rc, int sort_smem, int tc,
                                  long long smem_bytes, void* stream) {
  if (!plan_ok(C, BR, G, R, stage_items, rc) || (C > 0 && cand > C) ||
      (!sort_smem && scratch == nullptr) ||
      (tc && !((C == 2 || C == 4) && BR == 8 && R == 32 && rc == R)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(C, BR, G, T, R, cand, stage_items, sort_smem != 0,
                               mask != nullptr, rc);
  if (static_cast<long long>(L.total) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(u),    static_cast<const int8_t*>(tiles),
         static_cast<const float*>(scales), static_cast<const uint8_t*>(mask),
         static_cast<float*>(vals),       static_cast<int32_t*>(ids),
         static_cast<unsigned long long*>(scratch),
         B, nt, T, R, n_items, cand, G, sort_smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tc)
    return static_cast<int>(C == 2 ? launch<2, 8, true>(a, L, s)
                                   : launch<4, 8, true>(a, L, s));
  switch (C) {
    case 0: err = dispatch_rows<0>(BR, a, L, s); break;
    case 2: err = dispatch_rows<2>(BR, a, L, s); break;
    case 4: err = dispatch_rows<4>(BR, a, L, s); break;
    case 8: err = dispatch_rows<8>(BR, a, L, s); break;
    default: err = dispatch_rows<kQueue>(BR, a, L, s); break;
  }
  return static_cast<int>(err);
}

// Name of an error code, for the wrapper's exception message.
extern "C" const char* pio_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
