// Merge apply (K1), zamboni compact (K2) and fused apply+compact (K3)
// kernels for Hopper (sm_90a), and the sharded document's per-op exchange
// beside them (X1, X2 and the two in one launch; at the end of the file),
// bound to Python through a plain C interface.
//
// Replaces the three Pallas TPU kernels of the reference package:
//   K1  fluidframework_tpu/ops/pallas_kernel.py   _apply_values / apply_ops_packed
//   K2  fluidframework_tpu/ops/pallas_compact.py  compact_values / compact_packed
//   K3  fluidframework_tpu/ops/pallas_compact.py  _fused_kernel / apply_compact_packed
//
// Layout (all int32, C-contiguous; identical to the reference's packed
// layout): tables [N_LANES, D, S], scalars [D, N_SCALARS], ops [D, K, 10].
//
// Tiers. Every device function is templated over the table accessor DocT,
// so every tier runs one body of code; the caller names the tier.
//   - warp (S <= 512; K1 and K3, K2 refuses it): one warp per document,
//     a CTA of one warp (the register budget holds an SM to 24 such warps
//     up to 128 rows and 16 above, under its 32 CTAs, so more documents a
//     CTA add none resident; 4 a CTA ran 4% slower at 128 x 100,000 on an
//     H100). The doc's 15 lanes live in the CTA's dynamic shared memory
//     (15 ints a row: 7.7 KB at 128 rows), moved coalesced (16 bytes a
//     lane where aligned); the op
//     loop's scratch (A, C, F; B = C) stays
//     in registers, lane i holding row 32 j + i of tile j (DocT<T_WARP,
//     NT>, NT = warp_tiles(S) tiles, the tile loops unrolled by
//     for_tiles), so the prefix is a warp scan with a carry, first hits
//     ballots, the prefix at a hit a shuffle, the row move the shared
//     move_rows with no block barrier (__syncwarp orders shared memory);
//     an op's row is loaded one op ahead. Each op walks only the tiles
//     below min(S, count + 2), count the op's own (every row at or past
//     count is free; an op adds at most 2 rows). K3's compaction places
//     each head row in shared memory as its one pass goes (tiles bottom
//     up; a head moves to a row at most its own), then turns each LEN
//     into the merged length. Only the rows below the input's count are
//     loaded (cp.async, 16 bytes a copy, none through registers; the rest
//     filled), and in place only the rows below the larger count are
//     stored back: every other row is free before and after.
//   - shared (S <= 2,048; K1, K2, K3): one CTA per document, up to 256
//     threads. The doc's rows below live (below), three scratch arrays of
//     as many rows and a flag byte a row live in dynamic shared memory for
//     the whole op loop (sized for S rows: 146 KB at S = 2,048, so one CTA
//     per SM there; 9.3 KB at 128). Each op of K1 walks only the rows
//     below min(S, count + 2), count the op's own.
//   - cluster (2,048 < S <= 16,384; K1, K2, K3): one thread-block cluster of
//     C = ceil(S / 1,024) CTAs per document (3-16; above 8 a non-portable
//     size), 256 threads each, sized from S. CTA c holds rows [c*SL,
//     c*SL + n) of all 15 lanes plus its scratch in its own shared memory,
//     in the shared tier's layout (SL = live/C rounded up to 32 rows, at
//     most S/C so rounded, at most 1,024: 74 KB, 3 CTAs per SM; the last
//     slices may be shorter or empty; K2 keeps SL = S/C so rounded).
//     Every reduction of the op loop
//     reads the other CTAs' warp totals through distributed shared memory
//     after a cluster barrier, so every scalar stays uniform across the
//     cluster. Slices of 2,048 rows (512 threads, 1 CTA per SM, C <= 8)
//     ran 13-46% slower at 4,096-16,384 rows on an H100, so the slices are
//     1,024 rows. A cluster that cannot be scheduled fails the launch.
//     On both tiers only the rows below the input's count are loaded (the
//     rest of [0, live) filled); in place only the rows below the larger
//     of the input and output counts are stored (every other row is free
//     before and after), out of place the rows past them as fill.
//   - global (16,384 < S <= 65,536, launches of at least as many documents
//     as the card has SMs; ops/_cuda.py routes fewer, where the split tier
//     gives each document 2 CTAs or more, to the split tier): K1 and K3 run
//     one CTA of 512 threads per document; the lanes stay in tables_out
//     (lane stride D*S) and the scratch arrays in a per-doc slice of a
//     device workspace the wrapper allocates. Barriers order the global
//     writes. K2 runs there on the split tier's code with at most 8 CTAs
//     per document (a portable cluster).
//   - split (S <= 2^30; K1, K2, K3): the global tier's layout (the table
//     in tables_out, the scratch in the workspace), each document split
//     over a thread-block cluster of C = min(16, ceil(SMs / D)) CTAs of
//     512 threads (above 8 a non-portable size), so one large document
//     still covers 16 SMs. The warp totals meet
//     through DSMEM after a cluster barrier, and cluster barriers
//     (release/acquire at cluster scope) order the global writes: a row
//     another CTA wrote is read only after one, never through the
//     non-coherent load path. The only such reads are K1's row move (the
//     two rows below a slice, read before the barrier that lets their
//     owner overwrite them), the prefix at a hit row, and K2's gather and
//     store. 2^30 is the largest table the kernels' int row indices
//     address; a table the card cannot hold fails at allocation, in the
//     wrapper.
//   Every tier walks only the rows below live = min(S, count + 2K) (K2:
//   count), count read at the launch's start (live_rows): every row at
//   or past count is free (K1 moves rows up from below count, K2 refills
//   the rows past its heads with free rows; every port path that writes a
//   table keeps this), and an op adds at most 2 rows, so no row at or
//   past live changes. The host sizes the grid from S alone (nothing is
//   read back); each CTA cuts [0, live) into C slices of SL = ceil(live /
//   C) rows (a multiple of 32, at most S) and each slice into the warps'
//   blocks, fixed for the launch, so every row stays with the thread that
//   reads it in the op loop's passes and the row move needs no barrier
//   after it (the warp and shared tiers narrow each op further to the
//   rows below min(S, count + 2)). A sharded document's shard (9c: about 10,000 of
//   65,536 rows; one card: 65,681 of 524,288) is walked over its rows in
//   use, not its capacity.
//   C stays at most 16, one cluster: a document spread over more CTAs
//   would meet its warp totals through global memory behind a grid-wide
//   barrier on every reduction of every op (not built; PERF.md §6).
//
// K1's op loop (apply_ops_doc) gives each warp a contiguous block of rows
// and walks it in 32-row tiles, lane i on row tile + i, so one lane access
// of a warp is one 128-byte line (global) or 32 distinct banks (shared).
//   - Prefix of visible lengths: a warp shuffle scan per tile with a carry
//     in a register, then one scan of the warp totals over the block or
//     cluster (one barrier).
//   - First hits: __ballot_sync + __ffs per tile, then a min over the warps
//     of the block or cluster (one barrier).
//   - One row move per op. The splits and the insert of an op compose into
//     one displacement of at most 2 rows (final row r takes old row y =
//     r - d(r), then the split-length edits): move_rows reads the previous
//     warp's top tile (when it lies in the previous CTA: through DSMEM on
//     the cluster tier, from global memory on the split tier), one
//     barrier, then each warp walks its tiles from the top down taking
//     its sources by __shfl_sync from the tile and the one below it.
//   Each op costs 3 barriers (insert) or 4 (remove/annotate), against 5-8
//   with per-thread chunks and one shift per split.
// K2 (compact_doc, also K3's second half) is one gather, computed on the
// original rows in the same warp tiles. Row r is kept unless it is a
// reclaimable tombstone; p(r) is the previous kept row (a ballot of keep
// per tile, __clz of the mask below the lane, the last kept row of the
// earlier tiles in registers); r is a merge head if it is kept and does
// not merge into p(r). Output row h takes the h-th head, with LEN =
// plen(next head) - plen(head) (plen: the exclusive prefix of LEN over kept
// rows; total for the last head); rows past n_heads take their lane's
// fill. Int32 sums wrap alike in any order, so this equals the reference's
// squeeze-then-merge bit for bit. Per document: one pass over the rows, one
// block (or cluster) step that combines the warps' head counts, length
// sums and first/last kept rows (a warp's first kept row may merge into an
// earlier warp's last one) and, on the global memory tiers, the first row
// that is not a head, one pass that writes each head's source row and
// prefix length at its output index, one barrier, and the store: on the
// shared and cluster tiers it goes straight from shared memory to
// tables_out, the output rows below the larger of count and n_heads (the
// rows below count cross memory once in, once out);
// on the global and split tiers it runs in place over the output rows
// from the one below the first row that is not a head (every row below it
// is its own head) up to live, in rounds of STORE_ROWS rows a thread (K3:
// K3_STORE_ROWS): all 15 lanes of a round's rows are loaded into
// registers, one barrier, then stored. Output row h takes row C[h] >= h,
// so a round reads only rows at or above its first and writes only rows
// below the next round's first: one barrier a round, where the
// lane-by-lane store took 15 and two passes over every row of the slice.
// K3 runs K1's loop, one barrier, and K2 in one CTA (or cluster).
// The TPU-side workarounds (Hillis-Steele shift ladders, the f32
// permutation matmul, the 256-row compact cap) are not carried over.
//
// Bounds on this card. Each op is a chain of barriers over a small table
// (on the warp tier, of shuffles over the live tiles),
// so all three kernels are latency-bound, not bandwidth-bound: their byte
// floor is 2 x 15 x S x 4 B x D of table traffic plus D x K x 40 B of ops
// (1.55 GB per round at 100,000 docs x 128 rows x 16 ops, 0.46 ms at
// 3.35 TB/s); the work needs only the rows below live = min(S, count +
// 2K), 2 x 15 x live x 4 B a document, which every tier keeps to (the
// shared, cluster and warp tiers load only the rows below count). Warp
// tier: K x (2-4 passes of the live tiles, each tile a warp scan or
// ballots, no barrier) a warp, 16-24 warps an SM. Shared tier: K x (3-4
// barriers + 2-4 passes of live/threads rows). Cluster tier: the same
// with cluster barriers (each a round trip over the SMs of the cluster)
// and passes over slices of up to 1,024 rows; 256 docs at 8,192 rows are
// 2,048 CTAs,
// about 5 waves at 3 CTAs per SM. Global tier: the passes go to L2/HBM
// (coalesced), with one CTA per doc, so D < 132 leaves SMs idle; below
// one document an SM the split tier takes the launch. Split tier:
// the same passes over live/C-row slices, each op a few cluster barriers
// over up to 16 SMs; once the live rows and their workspace (73 B a row)
// pass the 50 MB L2, each pass pays HBM. K2 itself is one pass over the
// rows and one store per document, with 3 barriers (and one a store round
// on the global memory tiers), so it is bound by its bytes once enough
// CTAs are in flight: each thread loads all 15 lanes of a row before it
// stores any.
//
// Ops with an unknown type (outside 0..6) change nothing but the cur_seq /
// min_seq bookkeeping and the ERR_CLIENT bit, as in the Pallas K1.

#include <atomic>
#include <cooperative_groups.h>
#include <mutex>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int N_LANES = 15;
constexpr int OP_WIDTH = 10;
constexpr int N_SCALARS = 8;
constexpr int SMEM_MAX_CAP = 2048;      // largest shared-tier table
constexpr int CLUSTER_MAX_CAP = 16384;  // largest cluster-tier table
constexpr int GLOBAL_MAX_CAP = 65536;   // largest global-tier table
constexpr int MAX_CAP = 1 << 30;  // largest split-tier table (int row indices)
constexpr int MAX_THREADS = 256;        // shared tier
constexpr int CLUSTER_ROWS = 1024;      // rows per CTA of a cluster, at most
constexpr int CLUSTER_THREADS = 256;    // cluster tier
constexpr int GLOBAL_THREADS = 512;     // global and split tiers
constexpr int SPLIT_MAX_CTAS = 16;      // CTAs per doc on the split tier
// K2's CTAs per doc at most on the global tier (the split tier gives it
// SPLIT_MAX_CTAS, as K1 and K3). On an H100, each launch on a fresh table:
// at 16,385-65,536 rows 8 beat 16 1.7-2.4x (9c's 8 x 65,536, 32,768 x 16),
// on the split tier 16 beat 8 1.1-1.45x where many rows lie below count
// and tied (within 4%) at the one card's 65,681 of 524,288 (PERF.md §6).
constexpr int K2_MAX_CTAS = 8;
// Rows a thread holds a round of K2's store on the global and split tiers
// (K3: 2, so that its op loop and the store fit 128 registers unspilled).
constexpr int STORE_ROWS = 4;
constexpr int K3_STORE_ROWS = 2;
// CTAs per SM that each entry's register budget aims at (the second
// argument of __launch_bounds__; see ctas_per_sm). The shared tier: 4 (64
// registers a thread) up to SMEM_NARROW_CAP rows, where more CTAs fit an
// SM and the kernels are bound by how many do; 3 (85) above it for K1/K3,
// where shared memory holds at most 3 CTAs (at 1,024 rows; 1 at 2,048).
// On an H100 either budget was 2-14% slower on the other side of the cap;
// K2 keeps 4 at every width (2 and 8 were no faster). Every entry on the
// cluster tier 3 (85).
constexpr int SMEM_NARROW_CAP = 512;
constexpr int SMEM_CTAS_PER_SM = 4;
constexpr int SMEM_WIDE_CTAS_PER_SM = 3;
constexpr int CLUSTER_CTAS_PER_SM = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;  // devices whose SM count is cached
constexpr int MAX_CLUSTER = 16;  // the most CTAs of a (non-portable) cluster
// The warp tier: tables of up to WARP_MAX_CAP rows, one document (one
// warp) a CTA. Register budget (warp_ctas_per_sm, CTAs of one warp an
// SM): 85 a thread up to 128 rows (4 tiles of scratch a lane), 128 above.
constexpr int WARP_MAX_CAP = 512;
constexpr int WARP_NARROW_CTAS_PER_SM = 24;
constexpr int WARP_WIDE_CTAS_PER_SM = 16;

// T_SPLIT: the table in global memory, a cluster of CTAs per document.
// The C entries' tier 3 selects it for every entry; tier 2 selects it for
// K2 alone. T_WARP (tier 4): one warp a document, K1 and K3 only.
enum Tier { T_SMEM = 0, T_CLUSTER = 1, T_GLOBAL = 2, T_SPLIT = 3, T_WARP = 4 };

enum Lane {
  L_KIND, L_ORIG, L_OFF, L_LEN, L_SEQ, L_CLIENT, L_LSEQ, L_RSEQ, L_RLSEQ,
  L_RBITS, L_RBITS2, L_RBITS3, L_ASEQ, L_ALSEQ, L_AVAL
};
enum Field {
  F_TYPE, F_POS1, F_POS2, F_SEQ, F_REF, F_CLIENT, F_LSEQ, F_ARG, F_LEN, F_MSN
};
constexpr int SC_COUNT = 0, SC_MIN_SEQ = 1, SC_CUR_SEQ = 2, SC_SELF = 3,
              SC_ERR = 4;

constexpr int UNASSIGNED_SEQ = -1;
constexpr int RSEQ_NONE = 1 << 30;
constexpr int NORM_NEW_LOCAL = (1 << 30) + 2;
constexpr int NORM_EXISTING_LOCAL = (1 << 30) + 1;
constexpr int KIND_FREE = 0, KIND_TEXT = 1;
constexpr int OP_NOOP = 0, OP_INSERT = 1, OP_REMOVE = 2, OP_ANNOTATE = 3,
              OP_ACK_INSERT = 4, OP_ACK_REMOVE = 5, OP_ACK_ANNOTATE = 6;
constexpr int MAX_WRITERS = 93;
constexpr int ERR_CAPACITY = 1, ERR_RANGE = 2, ERR_CLIENT = 4;

// Warp-total scratch: one array per block- or cluster-wide reduction site,
// so a site never overwrites totals another thread (or CTA) may still be
// reading.
constexpr int WS_SCAN1 = 0, WS_MIN = 32, WS_SCAN2 = 128, WS_CMP = 160,
              WS_SIZE = 320;


// One document's table (or, on the cluster and split tiers, this CTA's
// slice of it) as the block (on the warp tier: the warp) sees it. Rows are
// addressed by their local index lr; the row's index in the whole table is
// base + lr. The op loop and K2 walk this warp's rows [wlo, whi) in 32-row
// tiles, tile j at row wlo + 32 j, and keep each row's scratch (A, B, C, F)
// through the accessors a/b/c/f: in the arrays below on every tier but the
// warp tier, in registers there (NT tiles a lane, lane i holding row
// 32 j + i of tile j), where the tile loops are unrolled.
template <int TIER, int NT = 1>
struct DocT {
  static constexpr int kTier = TIER;
  // Cluster barriers and DSMEM warp totals; the table in global memory.
  static constexpr bool kCluster = TIER == T_CLUSTER || TIER == T_SPLIT;
  static constexpr bool kGlobal = TIER == T_GLOBAL || TIER == T_SPLIT;
  // One warp a document: no block barrier, scratch in registers.
  static constexpr bool kWarp = TIER == T_WARP;
  static constexpr int kTiles = NT;
  // Warp totals a lane reads at most in a block- or cluster-wide
  // reduction (the tier's most warps, 32 a lane).
  static constexpr int kPerLane =
      ((TIER == T_SMEM      ? MAX_THREADS / 32
        : TIER == T_CLUSTER ? MAX_CLUSTER * CLUSTER_THREADS / 32
        : TIER == T_GLOBAL  ? GLOBAL_THREADS / 32
                            : MAX_CLUSTER * GLOBAL_THREADS / 32) +
       31) / 32;
  int *L;            // lane 0, local row 0
  size_t ls;         // lane stride: D*S (global), SL (shared, cluster)
  int *A, *B, *C;    // [n] scratch (global and split: slices of [S])
  unsigned char *F;  // [n] flags
  int S;             // rows of the whole table
  int base, n;       // this CTA's rows [base, base + n)
  int SL;            // rows per slice (a multiple of 32 or S; S on the
                     // warp tier)
  int live;          // rows the op loop and K2 walk: [0, live) (live_rows)
  int rank, nranks;  // this CTA in the cluster (0 and 1 otherwise)
  int wlo, whi;      // this warp's local rows [wlo, whi) (warp tier: the
                     // rows below min(S, count + 2), set for each op;
                     // shared tier: clipped there for each op)
  int *ws;           // [WS_SIZE] warp totals
  // Warp tier: A and C of tile j's row (B = C there: a warp's prefix is
  // the document's), and F of tile j's row as bit j.
  mutable int rA[NT], rC[NT];
  mutable unsigned rF;
  __device__ int &a(int j, int lr) const {
    if constexpr (kWarp) return rA[j]; else return A[lr];
  }
  __device__ int &b(int j, int lr) const {
    if constexpr (kWarp) return rC[j]; else return B[lr];
  }
  __device__ int &c(int j, int lr) const {
    if constexpr (kWarp) return rC[j]; else return C[lr];
  }
  __device__ bool f(int j, int lr) const {
    if constexpr (kWarp) return (rF >> j) & 1u; else return F[lr];
  }
  __device__ void set_f(int j, int lr, bool v) const {
    if constexpr (kWarp)
      rF = (rF & ~(1u << j)) | ((unsigned)v << j);
    else
      F[lr] = v;
  }
  __device__ int &at(int lane, int lr) const {
    if constexpr (kGlobal)  // lr < 0 reaches an earlier slice (split)
      return L[(ptrdiff_t)lane * (ptrdiff_t)ls + lr];
    else
      return L[lane * (int)ls + lr];
  }
  // The same shared address in CTA `rk` of the cluster (itself otherwise).
  template <class T>
  __device__ T *remote(T *p, int rk) const {
    if constexpr (kCluster)
      return cg::this_cluster().map_shared_rank(p, rk);
    else
      return p;
  }
  // A barrier over every thread that shares the table (release/acquire).
  __device__ void sync() const {
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else if constexpr (kWarp)
      __syncwarp();
    else
      __syncthreads();
  }
};

// Call fn(j, t0) for each 32-row tile j of this warp's rows [wlo, whi),
// t0 its first row. The warp tier runs the loop unrolled over its NT
// tiles, skipping those past whi (uniform in the warp): its scratch is
// indexed by constants alone and stays in registers. Every other tier,
// and a loop that keeps no scratch (SCRATCH false), runs a plain loop.
template <bool SCRATCH = true, class Doc, class Fn>
__device__ __forceinline__ void for_tiles(const Doc &d, Fn &&fn) {
  if constexpr (Doc::kWarp && SCRATCH) {
#pragma unroll
    for (int j = 0; j < Doc::kTiles; ++j)
      if (32 * j < d.whi) fn(j, 32 * j);
  } else {
    for (int t0 = d.wlo, j = 0; t0 < d.whi; t0 += 32, ++j) fn(j, t0);
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int lane_fill(int l) {
  return l == L_KIND ? KIND_FREE : (l == L_RSEQ ? RSEQ_NONE : 0);
}

__device__ __forceinline__ bool removed_by_slot(int b1, int b2, int b3,
                                                int client) {
  if (client < 0 || client >= MAX_WRITERS) return false;
  const int lane = client / 31;
  const int bits = lane == 0 ? b1 : (lane == 1 ? b2 : b3);
  return (bits >> (client - 31 * lane)) & 1;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Exclusive scan of warp totals (`wtot`, uniform in the warp) over the
// block or cluster, in warp order (CTA rank, then warp): returns this
// warp's offset and writes the total. One barrier. A lane loads all its
// totals (up to 8 on the split tier: 16 CTAs of 16 warps) before it adds
// any, so the DSMEM round trips overlap rather than follow one another.
template <class Doc>
__device__ __forceinline__ int doc_excl_scan(const Doc &d, int wtot, int *ws, int &total) {
  if constexpr (Doc::kWarp) {  // the warp is the document
    total = wtot;
    return 0;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) ws[w] = wtot;
  d.sync();
  const int g = d.rank * nw + w, nt = d.nranks * nw;
  int v[Doc::kPerLane];
#pragma unroll
  for (int j = 0; j < Doc::kPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = 0;
    if (i < nt) {
      const int rk = Doc::kCluster ? i / nw : 0;
      v[j] = d.remote(ws, rk)[i - rk * nw];
    }
  }
  int off = 0, tot = 0;
#pragma unroll
  for (int j = 0; j < Doc::kPerLane; ++j) {
    tot += v[j];
    if (lane + 32 * j < g) off += v[j];
  }
  total = warp_sum(tot);
  return warp_sum(off);
}

// Min of three warp-uniform values over the block or cluster (ws holds 96
// ints). One barrier; the loads overlap as in doc_excl_scan.
template <class Doc>
__device__ __forceinline__ void doc_min3(const Doc &d, int &a, int &b, int &c, int *ws) {
  if constexpr (Doc::kWarp) return;  // already the document's
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    ws[w] = a;
    ws[32 + w] = b;
    ws[64 + w] = c;
  }
  d.sync();
  const int nt = d.nranks * nw;
  int va[Doc::kPerLane], vb[Doc::kPerLane], vc[Doc::kPerLane];
#pragma unroll
  for (int j = 0; j < Doc::kPerLane; ++j) {
    const int i = lane + 32 * j;
    va[j] = vb[j] = vc[j] = INT_MAX;
    if (i < nt) {
      const int rk = Doc::kCluster ? i / nw : 0;
      const int *p = d.remote(ws, rk);
      const int k = i - rk * nw;
      va[j] = p[k];
      vb[j] = p[32 + k];
      vc[j] = p[64 + k];
    }
  }
#pragma unroll
  for (int j = 0; j < Doc::kPerLane; ++j) {
    a = min(a, va[j]);
    b = min(b, vb[j]);
    c = min(c, vc[j]);
  }
  a = warp_min(a);
  b = warp_min(b);
  c = warp_min(c);
}

// Scratch row r (an index into the whole table) of array p, wherever in
// the cluster it lies.
template <class Doc>
__device__ __forceinline__ int row_value(const Doc &d, int *p, int r) {
  if constexpr (Doc::kTier == T_CLUSTER) {
    const int rk = r / d.SL;
    return d.remote(p, rk)[r - rk * d.SL];
  } else {
    return p[r - d.base];
  }
}

// The run prefix B of row r (an index into the whole table; uniform in
// the warp). Warp tier: a shuffle from the lane that holds it, one a tile
// with the row's tile kept (the scratch is indexed by constants alone, or
// it leaves the registers).
template <class Doc>
__device__ __forceinline__ int prefix_at(const Doc &d, int r) {
  if constexpr (Doc::kWarp) {
    int v = 0;
#pragma unroll
    for (int j = 0; j < Doc::kTiles; ++j) {
      const int x = __shfl_sync(FULL, d.rC[j], r & 31);
      if (j == r >> 5) v = x;
    }
    return v;
  } else {
    return row_value(d, d.B, r);
  }
}

// Write scratch row r (an index into the whole table) of array p.
template <class Doc>
__device__ __forceinline__ void put_row(const Doc &d, int *p, int r, int v) {
  if constexpr (Doc::kTier == T_CLUSTER) {
    const int rk = r / d.SL;
    d.remote(p, rk)[r - rk * d.SL] = v;
  } else {
    p[r - d.base] = v;
  }
}

// Lane l of table row r (an index into the whole table), wherever in the
// cluster it lies.
template <class Doc>
__device__ __forceinline__ int lane_at(const Doc &d, int l, int r) {
  if constexpr (Doc::kTier == T_CLUSTER) {
    const int rk = r / d.SL;
    return d.remote(d.L, rk)[l * d.SL + r - rk * d.SL];
  } else {
    return d.at(l, r - d.base);
  }
}

struct Op {
  int ty, pos1, pos2, seqn, refn, clientn, lseqn, arg, ilen, msn;
  bool is_ins, is_rem, is_ann, is_range, local_op, is_local;
};

// Visible length of a row from the op's perspective (reference
// mergeTree.ts:916-1004), from its lanes' values; `by_client` = the op's
// writer removed it (removed_by_slot); `part` = the row takes part in the
// walk.
__device__ __forceinline__ int perspective_of(int kind, int seq, int client,
                                              int length, int rseq,
                                              bool by_client, const Op &o,
                                              int min_seq, bool &part) {
  const bool live = kind != KIND_FREE;
  const bool removed = rseq != RSEQ_NONE;
  const bool r_acked = removed && rseq != UNASSIGNED_SEQ;
  const bool skip = r_acked && rseq <= min_seq;
  const int rseq_eff = rseq == UNASSIGNED_SEQ ? RSEQ_NONE : rseq;
  const bool hidden = removed && (rseq_eff <= o.refn || by_client);
  const int seq_eff = seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq;
  const bool ins_vis = client == o.clientn || seq_eff <= o.refn;
  const int vis_remote = (!hidden && ins_vis) ? length : 0;
  const int vis_local = removed ? 0 : length;
  part = live && !skip;
  return part ? (o.is_local ? vis_local : vis_remote) : 0;
}

// The same for local row lr of the table (K1's perspective; X1 reads its
// rows' lanes itself and calls perspective_of).
template <class Doc>
__device__ __forceinline__ int perspective(const Doc &d, int lr, const Op &o,
                                           int min_seq, bool &part) {
  const int kind = d.at(L_KIND, lr), seq = d.at(L_SEQ, lr);
  const int client = d.at(L_CLIENT, lr), length = d.at(L_LEN, lr);
  const int rseq = d.at(L_RSEQ, lr);
  const bool by_client = removed_by_slot(
      d.at(L_RBITS, lr), d.at(L_RBITS2, lr), d.at(L_RBITS3, lr), o.clientn);
  return perspective_of(kind, seq, client, length, rseq, by_client, o,
                        min_seq, part);
}

// breakTie (mergeTree.ts:1719): an insert whose normalized seq is
// `op_norm` lands before a zero-length row of seq `seq` it reaches. K1's
// placement and X1's owner resolution share it, so ownership and the
// owner's own insert cannot disagree.
__device__ __forceinline__ bool ties_before(int op_norm, int seq) {
  return op_norm > (seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq);
}

// Perspective pass over this warp's rows: A = visible length, F = takes
// part, C = the warp-local exclusive prefix. Returns the warp's total.
// Only the row's own thread reads A, F and C.
template <class Doc>
__device__ __forceinline__ int perspective_pass(const Doc &d, const Op &o, int min_seq) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for_tiles(d, [&](int j, int t0) {
    const int lr = t0 + lane;
    int v = 0;
    if (lr < d.whi) {
      bool part;
      v = perspective(d, lr, o, min_seq, part);
      d.a(j, lr) = v;
      d.set_f(j, lr, part);
    }
    const int inc = warp_incl_scan(v);
    if (lr < d.whi) d.c(j, lr) = carry + inc - v;
    carry += __shfl_sync(FULL, inc, 31);
  });
  return carry;
}

// An op's row move: up to two stages composed into one displacement.
// Stage 1 is a boundary split at q1 (row q1 keeps length l1, the copy at
// q1+1 starts l1 further in); stage 2 is a split at q2 (in post-stage-1
// rows) or an insert of the op's new row at qi. Each stage moves the rows
// past its edge up by one (from qi on for the insert).
struct Move {
  bool e1, e2, ei;
  int q1, l1, q2, l2, qi;
};

// The two rows below local row t0 (the only ones a displacement of at most
// 2 reaches), packed one value per lane: lane i < 15 holds lane-of-table i
// of row t0 - 1, lane 15 + i lane-of-table i of row t0 - 2 (lanes 30-31
// hold nothing). A row below 0 reads as zeros; a row below the slice is
// read from the previous CTA, through DSMEM on the cluster tier and from
// global memory on the split tier.
template <class Doc>
__device__ __forceinline__ int rows_below(const Doc &d, int t0) {
  const int lane = threadIdx.x & 31;
  if (lane >= 2 * N_LANES) return 0;
  const int l = lane < N_LANES ? lane : lane - N_LANES;
  const int lr = t0 - (lane < N_LANES ? 1 : 2);
  if (lr >= 0) return d.at(l, lr);
  if (d.rank == 0) return 0;
  if constexpr (Doc::kTier == T_SPLIT)
    return d.at(l, lr);  // the previous slice's rows, in global memory
  else
    return d.remote(d.L, d.rank - 1)[l * d.SL + d.SL + lr];
}

// One pass that applies a Move in place: final row r takes old row
// y = r - d(r), d in {0, 1, 2} and non-decreasing in r, then the split
// edits. Rows below the lowest edge do not change. Each warp whose bottom
// tile moves first reads the two rows below its block (the previous
// warp's, or the previous CTA's); then one barrier; then it walks its
// tiles from the top down: it loads the tile and the two rows
// below it (still unwritten) and takes each row's source by __shfl_sync.
// Every row is written by the thread that reads it in the op loop's
// passes, so no barrier is needed after the pass.
template <class Doc>
__device__ __forceinline__ void move_rows(const Doc &d, const Move &mv, const Op &o) {
  const int lane = threadIdx.x & 31;
  int low = INT_MAX;
  if (mv.e1) low = min(low, mv.q1);
  if (mv.e2) low = min(low, mv.q2);
  if (mv.ei) low = min(low, mv.qi);
  const int lo_l = low - d.base;  // local; may lie outside [0, n)
  const int t_bot =
      lo_l <= d.wlo ? d.wlo : d.wlo + ((lo_l - d.wlo) >> 5) * 32;
  const bool active = t_bot < d.whi;
  const int bnd = active && t_bot == d.wlo ? rows_below(d, d.wlo) : 0;
  d.sync();
  if (!active) return;
  const int t_top = d.wlo + ((d.whi - 1 - d.wlo) >> 5) * 32;
  for (int t0 = t_top; t0 >= t_bot; t0 -= 32) {
    const int lr = t0 + lane, r = d.base + lr;
    int cur[N_LANES];
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) cur[l] = lr < d.whi ? d.at(l, lr) : 0;
    const int below = t0 == d.wlo ? bnd : rows_below(d, t0);
    bool is_new = false;
    int x = r;
    if (mv.ei) {
      is_new = r == mv.qi;
      if (r > mv.qi) x = r - 1;
    }
    if (mv.e2 && r > mv.q2) x = r - 1;
    const int y = (mv.e1 && x > mv.q1) ? x - 1 : x;
    const int j = lane - (r - y);  // source lane; -1, -2: the rows below
    const int jb = j == -2 ? N_LANES : 0;
    const bool write = lr < d.whi && r >= low;
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) {
      const int a = __shfl_sync(FULL, cur[l], j & 31);
      const int b = __shfl_sync(FULL, below, l + jb);
      int v = j >= 0 ? a : b;
      if (is_new) {
        v = 0;
        if (l == L_KIND) v = KIND_TEXT;
        if (l == L_ORIG) v = o.arg;
        if (l == L_LEN) v = o.ilen;
        if (l == L_SEQ) v = o.seqn;
        if (l == L_CLIENT) v = o.clientn;
        if (l == L_LSEQ) v = o.local_op ? o.lseqn : 0;
        if (l == L_RSEQ) v = RSEQ_NONE;
      } else if (l == L_OFF || l == L_LEN) {
        if (mv.e1 && x == mv.q1 && l == L_LEN) v = mv.l1;
        if (mv.e1 && x == mv.q1 + 1) v += l == L_OFF ? mv.l1 : -mv.l1;
        if (mv.e2 && r == mv.q2 && l == L_LEN) v = mv.l2;
        if (mv.e2 && r == mv.q2 + 1) v += l == L_OFF ? mv.l2 : -mv.l2;
      }
      if (write) d.at(l, lr) = v;
    }
  }
}

struct Scalars {
  int count, min_seq, cur_seq, self_client, err;
};

// K1's op loop (every tier): the unified insert / remove / annotate / ack
// pipeline of the reference's _apply_values, one op at a time, every
// scalar uniform across the block or cluster. The caller synchronizes
// before anyone reads rows another thread wrote here.
template <class Doc>
__device__ __forceinline__ void apply_ops_doc(Doc &d, const int *ops_doc,
                                              int K, Scalars &sc) {
  const int S = d.S;
  const int lane = threadIdx.x & 31;
  // Warp tier: lane f < OP_WIDTH holds field f of the next op, loaded one
  // op ahead, so an op's row is not a memory latency on the chain.
  int ahead = 0;
  if constexpr (Doc::kWarp)
    if (lane < OP_WIDTH && K > 0) ahead = ops_doc[lane];
  // The shared tier clips this warp's block of the launch's cut of [0,
  // live) to the rows below each op's min(S, count + 2), with no barrier
  // (the block's end restored after the loop). On an H100 the clip ran
  // 0-7% faster than the launch's cut at every narrow path (K 8, 16, 64),
  // never slower; cutting those rows anew into the warps' blocks (a
  // barrier where they change) ran 2-9% slower than no narrowing (PERF.md
  // §6, PR 24).
  constexpr bool kOpCut = Doc::kTier == T_SMEM;
  const int whi0 = d.whi;
  for (int k = 0; k < K; ++k) {
    const int *p = ops_doc + (size_t)k * OP_WIDTH;
    int now = 0;
    if constexpr (Doc::kWarp) {
      // The op walks the rows below min(S, count + 2) alone (every row at
      // or past count is free, and an op adds at most 2).
      d.whi = min(S, clampi(sc.count, 0, S) + 2);
      now = ahead;
      if (lane < OP_WIDTH && k + 1 < K) ahead = p[OP_WIDTH + lane];
    }
    if constexpr (kOpCut)  // the same rows on the shared tier (base 0)
      d.whi = clampi(clampi(sc.count, 0, S) + 2, d.wlo, whi0);
    auto field = [&](int f) {
      if constexpr (Doc::kWarp)
        return __shfl_sync(FULL, now, f);
      else
        return p[f];
    };
    Op o;
    o.ty = field(F_TYPE);
    o.pos1 = field(F_POS1);
    o.pos2 = field(F_POS2);
    o.seqn = field(F_SEQ);
    o.refn = field(F_REF);
    o.clientn = field(F_CLIENT);
    o.lseqn = field(F_LSEQ);
    o.arg = field(F_ARG);
    o.ilen = field(F_LEN);
    o.msn = field(F_MSN);
    o.is_ins = o.ty == OP_INSERT;
    o.is_rem = o.ty == OP_REMOVE;
    o.is_ann = o.ty == OP_ANNOTATE;
    o.is_range = o.is_rem || o.is_ann;
    o.local_op = o.seqn == UNASSIGNED_SEQ;
    o.is_local = o.clientn == sc.self_client;
    if (o.clientn >= MAX_WRITERS) sc.err |= ERR_CLIENT;

    if (o.is_ins || o.is_range) {
      // -- perspective + exclusive prefix of visible lengths ------------
      int total;
      const int off = doc_excl_scan(d, perspective_pass(d, o, sc.min_seq),
                                    d.ws + WS_SCAN1, total);
      // -- first hits; B = the whole-table prefix, which other threads
      //    (and CTAs) read at idx1/idx2 and which is written only here,
      //    after the scan's barrier ---------------------------------------
      const int op_norm = o.local_op ? NORM_NEW_LOCAL : o.seqn;
      int m1 = S, m2 = S, mp = S;
      for_tiles(d, [&](int j, int t0) {
        const int lr = t0 + lane;
        bool h1 = false, h2 = false, hp = false;
        if (lr < d.whi) {
          const int v = d.a(j, lr);
          const bool part = d.f(j, lr);
          const int run = d.c(j, lr) + off;
          d.b(j, lr) = run;
          const int rem1 = o.pos1 - run, rem2 = o.pos2 - run;
          h1 = part && v > 0 && rem1 > 0 && rem1 < v;
          h2 = part && v > 0 && rem2 > 0 && rem2 < v;
          hp = part && ((v > 0 && rem1 >= 0 && rem1 < v) ||
                        (v == 0 && rem1 == 0 &&
                         ties_before(op_norm, d.at(L_SEQ, lr))));
        }
        const unsigned b1 = __ballot_sync(FULL, h1);
        const unsigned b2 = __ballot_sync(FULL, h2);
        const unsigned bp = __ballot_sync(FULL, hp);
        const int r0 = d.base + t0 - 1;
        if (m1 == S && b1) m1 = r0 + __ffs(b1);
        if (m2 == S && b2) m2 = r0 + __ffs(b2);
        if (mp == S && bp) mp = r0 + __ffs(bp);
      });
      doc_min3(d, m1, m2, mp, d.ws + WS_MIN);
      const bool has1 = m1 < S, has2 = m2 < S, hasp = mp < S;
      const int idx1 = m1, idx2 = m2;
      const int split1 = has1 ? o.pos1 - prefix_at(d, idx1) : 0;
      const int split2 = has2 ? o.pos2 - prefix_at(d, idx2) : 0;
      const int idxp = hasp ? mp : sc.count;

      // -- capacity / do flags (sequential checks) ---------------------
      const int count = sc.count;
      const int sh = has1 ? 2 : 1;
      const bool cap_err_i = o.is_ins && count + sh > S;
      const bool do_ins = o.is_ins && !cap_err_i;
      const bool do_a_rng = o.is_range && has1 && count + 1 <= S;
      const bool cap_a = o.is_range && has1 && count + 1 > S;
      const int count_a = count + (do_a_rng ? 1 : 0);
      const bool do_b_rng = o.is_range && has2 && count_a + 1 <= S;
      const bool cap_b = o.is_range && has2 && count_a + 1 > S;
      if (cap_err_i || cap_a || cap_b) sc.err |= ERR_CAPACITY;
      if (o.is_ins && !hasp && o.pos1 > total) sc.err |= ERR_RANGE;
      if (o.is_range && o.pos2 > total) sc.err |= ERR_RANGE;

      // -- split A at pos1, then split B at pos2 (post-A rows) or the
      //    insert, as one row move ---------------------------------------
      Move mv;
      mv.e1 = do_a_rng || (do_ins && has1);
      mv.q1 = idx1;
      mv.l1 = split1;
      mv.e2 = do_b_rng;
      mv.q2 = idx2 + (do_a_rng ? 1 : 0);
      mv.l2 = (do_a_rng && idx1 == idx2) ? split2 - split1 : split2;
      mv.ei = do_ins;
      mv.qi = has1 ? idx1 + 1 : idxp;
      if (mv.e1 || mv.e2 || mv.ei) move_rows(d, mv, o);
      sc.count = o.is_range ? count_a + (do_b_rng ? 1 : 0)
                            : (do_ins ? count + sh : count);
    }

    const bool is_ack = o.ty == OP_ACK_INSERT || o.ty == OP_ACK_REMOVE ||
                        o.ty == OP_ACK_ANNOTATE;
    if (o.is_range || is_ack) {
      int off2 = 0;
      if (o.is_range) {
        // -- covered rows: post-split perspective ------------------------
        int total2;
        off2 = doc_excl_scan(d, perspective_pass(d, o, sc.min_seq),
                             d.ws + WS_SCAN2, total2);
      }
      const int lo = o.clientn < 31 ? (1 << clampi(o.clientn, 0, 30)) : 0;
      const int mid = (o.clientn >= 31 && o.clientn < 62)
                          ? (1 << clampi(o.clientn - 31, 0, 30)) : 0;
      const int hi = o.clientn >= 62 ? (1 << clampi(o.clientn - 62, 0, 30))
                                     : 0;
      for_tiles(d, [&](int j, int t0) {
        const int lr = t0 + lane;
        if (lr >= d.whi) return;
        bool cov = false;
        if (o.is_range) {
          const int v = d.a(j, lr);
          const int run = d.c(j, lr) + off2;
          cov = d.f(j, lr) && v > 0 && run >= o.pos1 && run + v <= o.pos2;
        }
        int rseq = d.at(L_RSEQ, lr), rlseq = d.at(L_RLSEQ, lr);
        int aseq = d.at(L_ASEQ, lr), alseq = d.at(L_ALSEQ, lr);
        // remove marks (markRangeRemoved)
        if (cov && o.is_rem) {
          const bool not_removed = rseq == RSEQ_NONE;
          const bool was_local = rseq == UNASSIGNED_SEQ;
          if (not_removed && o.local_op) rlseq = o.lseqn;
          if (not_removed || was_local) rseq = o.seqn;
          d.at(L_RBITS, lr) |= lo;
          d.at(L_RBITS2, lr) |= mid;
          d.at(L_RBITS3, lr) |= hi;
        }
        // annotate marks (single-lane LWW)
        if (cov && o.is_ann && (o.local_op || alseq == 0)) {
          d.at(L_AVAL, lr) = o.arg;
          aseq = o.seqn;
          alseq = o.local_op ? o.lseqn : 0;
        }
        // acks of own ops (ackPendingSegment)
        const bool live = d.at(L_KIND, lr) != KIND_FREE;
        if (o.ty == OP_ACK_INSERT && live &&
            d.at(L_SEQ, lr) == UNASSIGNED_SEQ && d.at(L_LSEQ, lr) == o.lseqn) {
          d.at(L_SEQ, lr) = o.seqn;
          d.at(L_LSEQ, lr) = 0;
        }
        if (o.ty == OP_ACK_REMOVE && live && rlseq == o.lseqn) {
          if (rseq == UNASSIGNED_SEQ) rseq = o.seqn;
          rlseq = 0;
        }
        if (o.ty == OP_ACK_ANNOTATE && live && alseq == o.lseqn) {
          aseq = o.seqn;
          alseq = 0;
        }
        d.at(L_RSEQ, lr) = rseq;
        d.at(L_RLSEQ, lr) = rlseq;
        d.at(L_ASEQ, lr) = aseq;
        d.at(L_ALSEQ, lr) = alseq;
      });
    }
    // -- bookkeeping (collab window floor / current seq) ----------------
    sc.cur_seq = max(sc.cur_seq, o.seqn);
    sc.min_seq = max(sc.min_seq, o.msn);
  }
  if constexpr (kOpCut) d.whi = whi0;
}

// A row as the sibling re-merge (reference packParent subset) sees it:
// row q takes the next kept row r in when both are acked, unremoved text
// rows with no pending stamp, of one insert (orig, seq, client) and one
// annotation, and r starts where q ends.
struct MRow {
  int orig, seq, client, aseq, aval, off, end;  // end = off + len
  int ok;    // text, not removed, no pending stamp (may take r in)
  int join;  // ok and seq assigned (may join q)
};

template <class Get>
__device__ __forceinline__ MRow merge_row(Get get) {
  MRow m;
  m.orig = get(L_ORIG);
  m.seq = get(L_SEQ);
  m.client = get(L_CLIENT);
  m.aseq = get(L_ASEQ);
  m.aval = get(L_AVAL);
  m.off = get(L_OFF);
  m.end = (int)((unsigned)m.off + (unsigned)get(L_LEN));
  m.ok = get(L_KIND) == KIND_TEXT && get(L_RSEQ) == RSEQ_NONE &&
         get(L_ALSEQ) == 0 && get(L_LSEQ) == 0;
  m.join = m.ok && m.seq != UNASSIGNED_SEQ;
  return m;
}

__device__ __forceinline__ bool merges(const MRow &q, const MRow &r) {
  return q.ok && r.join && r.orig == q.orig && r.off == q.end &&
         r.seq == q.seq && r.client == q.client && r.aseq == q.aseq &&
         r.aval == q.aval;
}

// The fields of `m` the next row compares, from lane `src` of the warp.
__device__ __forceinline__ MRow shfl_row(const MRow &m, int src) {
  MRow q;
  q.orig = __shfl_sync(FULL, m.orig, src);
  q.seq = __shfl_sync(FULL, m.seq, src);
  q.client = __shfl_sync(FULL, m.client, src);
  q.aseq = __shfl_sync(FULL, m.aseq, src);
  q.aval = __shfl_sync(FULL, m.aval, src);
  q.end = __shfl_sync(FULL, m.end, src);
  q.ok = __shfl_sync(FULL, m.ok, src);
  q.off = 0;
  q.join = 0;
  return q;
}

struct CompactSums {
  int off_h, n_heads;  // heads in earlier warps; in the table
  int off_len, total;  // LEN over kept rows of earlier warps; of the table
  bool merged;         // this warp's first kept row joins an earlier row
  int first_move;      // the first row that is not a head (global memory
                       // tiers; INT_MAX for none): rows below it stay put
};

// The block (or cluster) step of the compaction. Each warp gives its
// count of heads (its first kept row counted as one), its kept rows' LEN
// sum, its first and last kept rows and (global memory tiers) its first
// row that is no tentative head; after one barrier every warp reads all
// of them (through DSMEM on the cluster tier), finds for each warp the
// last kept row before it (an exclusive max scan) and whether that warp's
// first kept row merges into it, and takes its own offsets, the totals and
// the table's first row that is not a head.
template <class Doc>
__device__ __forceinline__ CompactSums compact_sums(const Doc &d, int tent, int lsum, int fk,
                                    int lk, int fnh, int *ws) {
  if constexpr (Doc::kWarp)  // one warp: its sums are the document's
    return CompactSums{0, tent, 0, lsum, false, INT_MAX};
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    ws[w] = tent;
    ws[32 + w] = lsum;
    ws[64 + w] = fk;
    ws[96 + w] = lk;
    if constexpr (Doc::kGlobal) ws[128 + w] = fnh;
  }
  d.sync();
  const int g = d.rank * nw + w, nt = d.nranks * nw;
  CompactSums t{0, 0, 0, 0, false, INT_MAX};
  int carry = -1;  // last kept row of the warps before this chunk
  for (int i0 = 0; i0 < nt; i0 += 32) {
    const int i = i0 + lane;
    int th = 0, tl = 0, f = -1, k = -1, nh = INT_MAX;
    if (i < nt) {
      const int rk = Doc::kCluster ? i / nw : 0;
      const int *p = d.remote(ws, rk);
      const int j = i - rk * nw;
      th = p[j];
      tl = p[32 + j];
      f = p[64 + j];
      k = p[96 + j];
      if constexpr (Doc::kGlobal) nh = p[128 + j];
    }
    int inc = k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc = max(inc, n);
    }
    int prev = __shfl_up_sync(FULL, inc, 1);
    prev = max(lane == 0 ? -1 : prev, carry);
    carry = max(carry, __shfl_sync(FULL, inc, 31));
    bool m = false;
    if (f >= 0 && prev >= 0)
      m = merges(merge_row([&](int l) { return lane_at(d, l, prev); }),
                 merge_row([&](int l) { return lane_at(d, l, f); }));
    th -= m;
    if constexpr (Doc::kGlobal)
      t.first_move = min(t.first_move, m ? min(f, nh) : nh);
    if (i < g) {
      t.off_h += th;
      t.off_len += tl;
    }
    t.n_heads += th;
    t.total += tl;
    if (i == g) t.merged = m;
  }
  t.off_h = warp_sum(t.off_h);
  t.n_heads = warp_sum(t.n_heads);
  t.off_len = warp_sum(t.off_len);
  t.total = warp_sum(t.total);
  t.merged = __any_sync(FULL, t.merged);
  if constexpr (Doc::kGlobal) t.first_move = warp_min(t.first_move);
  return t;
}

// K2 (every tier; reference compact_values): reclaim acked tombstones at
// or below min_seq with no pending stamp, squeeze the kept rows down and
// re-merge adjacent splits of one insert, as one gather (see the top of
// the file). Shared and cluster tiers: the output rows below the larger of
// `count_in` (the launch's input count) and n_heads go to `out` (this
// CTA's rows of lane 0 of tables_out, lane stride `plane`); every row past
// them is free in the input and the output. Global tier: in place. Warp
// tier: in place in the warp's shared memory (`out` unused). Returns
// n_heads. The caller synchronizes before the call.
template <int STORE, class Doc>
__device__ __forceinline__ int compact_doc(const Doc &d, int min_seq, int *out,
                           size_t plane, int count_in) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  // -- keep, p(r), tentative heads; A = warp-local prefix of kept LEN ----
  // (the warp tier keeps no scratch: it places each tile's heads as the
  // pass goes, below)
  MRow cq{};          // the last kept row of this warp's earlier tiles
  bool has_q = false;
  int tent = 0, lsum = 0, fk = -1, lk = -1, fnh = INT_MAX;
  for_tiles<!Doc::kWarp>(d, [&](int j, int t0) {
    const int lr = t0 + lane;
    const bool valid = lr < d.whi;
    bool keep = false;
    int len = 0;
    MRow m{};
    if (valid) {
      const int rseq = d.at(L_RSEQ, lr);
      const bool live = d.at(L_KIND, lr) != KIND_FREE;
      const bool pending = d.at(L_LSEQ, lr) != 0 || d.at(L_RLSEQ, lr) != 0 ||
                           d.at(L_ALSEQ, lr) != 0;
      const bool reclaim = !pending && rseq != RSEQ_NONE &&
                           rseq != UNASSIGNED_SEQ && rseq <= min_seq;
      keep = live && !reclaim;
      m = merge_row([&](int l) { return d.at(l, lr); });
      len = keep ? d.at(L_LEN, lr) : 0;
    }
    const unsigned km = __ballot_sync(FULL, keep);
    const unsigned below = km & lt;
    MRow q = shfl_row(m, below ? 31 - __clz(below) : lane);
    if (!below) q = cq;
    const bool head = keep && !((below || has_q) && merges(q, m));
    const unsigned hb = __ballot_sync(FULL, head);
    if constexpr (!Doc::kWarp)
      if (valid) d.set_f(j, lr, head);
    if constexpr (Doc::kGlobal) {
      const unsigned nb = __ballot_sync(FULL, valid && !head);
      if (fnh == INT_MAX && nb) fnh = d.base + t0 + __ffs(nb) - 1;
    }
    const int inc = warp_incl_scan(len);
    if constexpr (Doc::kWarp) {
      // The warp tier compacts as the pass goes, tiles bottom up: each
      // head row is read into registers, one __syncwarp, then written to
      // its output row h, at most its own (so no row a later tile reads is
      // overwritten), its LEN lane holding for now its kept-LEN prefix.
      int v[N_LANES];
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) v[l] = head ? d.at(l, lr) : 0;
      v[L_LEN] = lsum + inc - len;
      __syncwarp();
      if (head) {
#pragma unroll
        for (int l = 0; l < N_LANES; ++l)
          d.at(l, tent + __popc(hb & lt)) = v[l];
      }
    } else {
      if (valid) d.a(j, lr) = lsum + inc - len;
    }
    tent += __popc(hb);
    lsum += __shfl_sync(FULL, inc, 31);
    if (km) {
      const int last = 31 - __clz(km);
      cq = shfl_row(m, last);
      has_q = true;
      lk = d.base + t0 + last;
      if (fk < 0) fk = d.base + t0 + __ffs(km) - 1;
    }
  });
  const CompactSums t =
      compact_sums(d, tent, lsum, fk, lk, fnh, d.ws + WS_CMP);
  if constexpr (Doc::kWarp) {
    // The heads sit at rows [0, n_heads), each LEN lane holding its kept-LEN
    // prefix: the merged length is the next head's prefix (the total for
    // the last) less its own. Each lane reads both before any writes.
    // Then rows [n_heads, whi) take their lane's fill (rows past whi are
    // free already). The caller stores the table. The pass wrote head
    // rows that other lanes read here: only __syncwarp orders one lane's
    // shared-memory writes before another's reads.
    __syncwarp();
    const int nh = t.n_heads;
    for (int h0 = 0; h0 < nh; h0 += 32) {
      const int h = h0 + lane;
      int p = 0, q = 0;
      if (h < nh) {
        p = d.at(L_LEN, h);
        q = h + 1 < nh ? d.at(L_LEN, h + 1) : t.total;
      }
      __syncwarp();
      if (h < nh) d.at(L_LEN, h) = q - p;
    }
    for (int r = nh + lane; r < d.whi; r += 32) {
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) d.at(l, r) = lane_fill(l);
    }
    return nh;
  }
  // -- each head's source row (C) and prefix length (B), at its output
  //    index, in the CTA that owns that output row --------------------------
  int run = t.off_h;
  for (int t0 = d.wlo; t0 < d.whi; t0 += 32) {
    const int lr = t0 + lane;
    bool head = false;
    if (lr < d.whi)
      head = d.f(0, lr) && !(t.merged && d.base + lr == fk);
    const unsigned hb = __ballot_sync(FULL, head);
    if (head) {
      const int h = run + __popc(hb & lt);
      put_row(d, d.C, h, d.base + lr);
      put_row(d, d.B, h, t.off_len + d.a(0, lr));
    }
    run += __popc(hb);
  }
  d.sync();
  // -- the store ------------------------------------------------------------
  const int nh = t.n_heads;
  if constexpr (Doc::kGlobal) {
    // In place, over output rows [lo, live): every row below the first row
    // that is not a head is its own head, so rows below lo keep all their
    // lanes (row lo = first_move - 1 may take a longer LEN). Output row h
    // takes row C[h] >= h, so the store walks the rows in rounds of
    // STORE rows a thread, upward: a round loads all 15 lanes of its
    // rows into registers, one barrier, then stores them. A round reads
    // rows at or above its own first row, which no earlier round wrote,
    // and writes rows no later round reads, so it needs no second barrier.
    const int lo = max(min(t.first_move, d.live) - 1, 0);
    const int T = d.nranks * (int)blockDim.x;
    const int g = d.rank * (int)blockDim.x + (int)threadIdx.x;
    for (int h0 = lo; h0 < d.live; h0 += T * STORE) {
      int v[STORE][N_LANES];
#pragma unroll
      for (int i = 0; i < STORE; ++i) {
        const int h = h0 + i * T + g;
        if (h >= d.live) continue;
        if (h < nh) {
          const int src = row_value(d, d.C, h);
          const int b = row_value(d, d.B, h);
#pragma unroll
          for (int l = 0; l < N_LANES; ++l)
            v[i][l] = l == L_LEN ? (h + 1 < nh ? row_value(d, d.B, h + 1)
                                               : t.total) - b
                                 : lane_at(d, l, src);
        } else {
#pragma unroll
          for (int l = 0; l < N_LANES; ++l) v[i][l] = lane_fill(l);
        }
      }
      d.sync();
#pragma unroll
      for (int i = 0; i < STORE; ++i) {
        const int h = h0 + i * T + g;
        if (h >= d.live) continue;
#pragma unroll
        for (int l = 0; l < N_LANES; ++l) d.at(l, h - d.base) = v[i][l];
      }
    }
  } else {
    const int n = min(d.n, max(count_in, nh) - d.base);
    // All 15 lanes of a row are read (from the CTA that holds its source
    // row, through DSMEM on the cluster tier) before any is stored, so
    // the reads are in flight together.
    for (int hl = threadIdx.x; hl < n; hl += blockDim.x) {
      const int h = d.base + hl;
      const bool is_head = h < nh;
      int v[N_LANES];
      if (is_head) {
        const int s = d.C[hl];
        const int len =
            (h + 1 < nh ? row_value(d, d.B, h + 1) : t.total) - d.B[hl];
#pragma unroll
        for (int l = 0; l < N_LANES; ++l)
          v[l] = l == L_LEN ? len : lane_at(d, l, s);
      } else {
#pragma unroll
        for (int l = 0; l < N_LANES; ++l) v[l] = lane_fill(l);
      }
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) out[l * plane + hl] = v[l];
    }
  }
  return nh;
}

extern __shared__ int smem_raw[];

// Rows [0, live) of a table of S rows whose count is `count` at a
// launch's start that a launch of K ops walks on the global and split
// tiers: every row at or past count is free (K1 moves rows up from below
// count, K2 fills rows past its heads with free rows) and an op raises
// count by at most 2, so no row at or past count + 2K changes.
__device__ __forceinline__ int live_rows(int S, int count, int K) {
  return (int)min((long long)S,
                  (long long)clampi(count, 0, S) + 2LL * (long long)K);
}

// Ints of global-tier workspace per document: scratch A, B, C and the flag
// bytes F (each S rows long, in that order).
__host__ __device__ size_t work_ints(int S) {
  return (size_t)3 * S + (S + 3) / 4;
}

__host__ __device__ constexpr int ctas_per_sm(int tier, bool wide) {
  return tier == T_CLUSTER ? CLUSTER_CTAS_PER_SM
         : tier >= T_GLOBAL ? 1
         : wide             ? SMEM_WIDE_CTAS_PER_SM
                            : SMEM_CTAS_PER_SM;
}

// MODE 0: K1 apply. MODE 1: K2 compact. MODE 2: K3 apply then compact.
// WIDE: a shared-tier K1/K3 entry for tables past SMEM_NARROW_CAP rows.
// SL: rows per CTA (the cluster and split tiers; S otherwise). `work`:
// the global and split tiers' workspace.
template <int MODE, int TIER, bool WIDE = false>
__global__ void __launch_bounds__(
    TIER == T_SMEM ? MAX_THREADS
                   : (TIER == T_CLUSTER ? CLUSTER_THREADS : GLOBAL_THREADS),
    ctas_per_sm(TIER, WIDE))
merge_kernel(const int *__restrict__ ops, const int *tables_in,
             const int *scalars_in, int *tables_out, int *scalars_out,
             int *work, int n_docs, int S, int K, int SL) {
  __shared__ int ws[WS_SIZE];
  __shared__ int count_sh;  // the input's count, read again after the loop
  DocT<TIER> d;
  int doc = blockIdx.x;
  d.rank = 0;
  d.nranks = 1;
  if constexpr (DocT<TIER>::kCluster) {
    const cg::cluster_group cl = cg::this_cluster();
    d.rank = (int)cl.block_rank();
    d.nranks = (int)cl.num_blocks();
    doc = blockIdx.x / d.nranks;
  }
  const size_t plane = (size_t)n_docs * S;
  const size_t base = (size_t)doc * S;
  int sc_in[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i)
    sc_in[i] = scalars_in[(size_t)doc * N_SCALARS + i];
  d.S = S;
  // The rows the op loop and K2 walk, cut into this launch's slices: at
  // most S rows (a shared-tier table may be narrower than a tile, and its
  // shared memory holds S rows) and on the cluster tier at most the host's
  // SL rows, which its shared memory holds. K2 keeps the host's slices on
  // the cluster tier, its rows below count in the first CTAs: on an H100
  // they ran it 13-17% faster than slices of ceil(count / C) rows at 8,192
  // and 16,384 rows on random states (2% slower at 4,096) and 9-21% at
  // 4,096-8,192 on the deep cell's, where they ran K1 6-32% slower
  // (PERF.md §6, PR 24).
  const int count_in = clampi(sc_in[SC_COUNT], 0, S);
  if (threadIdx.x == 0) count_sh = count_in;
  d.live = live_rows(S, count_in, MODE == 1 ? 0 : K);
  if (TIER != T_CLUSTER || MODE != 1)
    SL = min(S, ((d.live + d.nranks - 1) / d.nranks + 31) / 32 * 32);
  d.SL = SL;
  d.base = d.rank * SL;
  d.n = max(0, min(SL, d.live - d.base));
  d.ws = ws;
  const size_t row0 = base + d.base;
  if constexpr (DocT<TIER>::kGlobal) {
    d.L = tables_out + row0;
    d.ls = plane;
    int *wk = work + (size_t)doc * work_ints(S);
    d.A = wk + d.base;
    d.B = wk + S + d.base;
    d.C = wk + (size_t)2 * S + d.base;
    d.F = reinterpret_cast<unsigned char *>(wk + (size_t)3 * S) + d.base;
  } else {
    d.L = smem_raw;
    d.ls = SL;
    d.A = d.L + N_LANES * SL;
    d.B = d.A + SL;
    d.C = d.B + SL;
    d.F = reinterpret_cast<unsigned char *>(d.C + SL);
  }
  // Warp w owns local rows [w*RW, (w+1)*RW), RW a whole number of 32-row
  // tiles, the same on every CTA of a cluster.
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int RW = ((SL + 31) / 32 + nw - 1) / nw * 32;
  d.wlo = min(w * RW, d.n);
  d.whi = min(d.wlo + RW, d.n);

  // Shared and cluster tiers: load this CTA's rows below the input's
  // count (the rest of its slice takes its lanes' fills). Global and split
  // tiers: the table is updated where it lies in tables_out, so copy
  // tables_in there, every row, when they differ.
  // All 15 lanes of a row are loaded before any is stored, so a thread
  // has 15 loads in flight rather than one.
  if constexpr (DocT<TIER>::kGlobal) {
    if (tables_in != tables_out) {
      const int T = d.nranks * (int)blockDim.x;
      for (int r = d.rank * (int)blockDim.x + (int)threadIdx.x; r < S;
           r += T) {
        int v[N_LANES];
#pragma unroll
        for (int l = 0; l < N_LANES; ++l)
          v[l] = tables_in[l * plane + base + r];
#pragma unroll
        for (int l = 0; l < N_LANES; ++l)
          tables_out[l * plane + base + r] = v[l];
      }
    }
  } else {
    const int loaded = min(d.n, count_in - d.base);
    for (int r = threadIdx.x; r < d.n; r += blockDim.x) {
      int v[N_LANES];
      if (r < loaded) {
#pragma unroll
        for (int l = 0; l < N_LANES; ++l)
          v[l] = tables_in[l * plane + row0 + r];
      } else {
#pragma unroll
        for (int l = 0; l < N_LANES; ++l) v[l] = lane_fill(l);
      }
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) d.at(l, r) = v[l];
    }
  }
  Scalars sc{sc_in[SC_COUNT], sc_in[SC_MIN_SEQ], sc_in[SC_CUR_SEQ],
             sc_in[SC_SELF], sc_in[SC_ERR]};
  // Every CTA of a cluster has started (and loaded) before any DSMEM read.
  d.sync();

  if constexpr (MODE != 1)
    apply_ops_doc(d, ops + (size_t)doc * K * OP_WIDTH, K, sc);
  int n_heads = 0;
  if constexpr (MODE != 0) {
    if constexpr (MODE == 2) d.sync();  // the op loop's rows, table-wide
    n_heads = compact_doc<MODE == 2 ? K3_STORE_ROWS : STORE_ROWS>(
        d, sc.min_seq, tables_out + row0, plane, count_sh);
  }
  // No CTA exits (or stores) while another may still read its rows.
  d.sync();

  if constexpr (!DocT<TIER>::kGlobal) {
    // Every row at or past both counts is free before and after: in place
    // it is not stored, out of place it takes its lanes' fills (K2 and K3
    // stored their rows below it in compact_doc).
    const int stored =
        max(count_sh, clampi(MODE == 0 ? sc.count : n_heads, 0, S));
    if constexpr (MODE == 0) {
      const int n = min(d.n, stored - d.base);
      for (int l = 0; l < N_LANES; ++l)
        for (int r = threadIdx.x; r < n; r += blockDim.x)
          tables_out[l * plane + row0 + r] = d.at(l, r);
    }
    if (tables_in != tables_out) {
      const int T = d.nranks * (int)blockDim.x;
      for (int l = 0; l < N_LANES; ++l)
        for (int r = stored + d.rank * (int)blockDim.x + (int)threadIdx.x;
             r < S; r += T)
          tables_out[l * plane + base + r] = lane_fill(l);
    }
  }
  if (threadIdx.x == 0 && d.rank == 0) {
    int out[N_SCALARS] = {MODE == 0 ? sc.count : n_heads, sc.min_seq,
                          sc.cur_seq, sc.self_client, sc.err, 0, 0, 0};
    if (MODE == 1) {
      // K2 alone keeps every scalar column but the count.
      for (int i = 1; i < N_SCALARS; ++i) out[i] = sc_in[i];
    }
    for (int i = 0; i < N_SCALARS; ++i)
      scalars_out[(size_t)doc * N_SCALARS + i] = out[i];
  }
}

size_t smem_bytes(int rows) {
  return (size_t)(N_LANES + 3) * rows * sizeof(int) + ((rows + 15) / 16) * 16;
}

// -- the warp tier ------------------------------------------------------------

// Tiles of scratch a lane keeps on the warp tier for tables of S rows.
__host__ __device__ constexpr int warp_tiles(int S) {
  return S <= 64 ? 2 : S <= 128 ? 4 : S <= 256 ? 8 : 16;
}

// The warp tier's CTAs (one warp each) per SM the register budget aims
// at: up to 4 tiles WARP_NARROW_CTAS_PER_SM, above WARP_WIDE_CTAS_PER_SM.
__host__ __device__ constexpr int warp_ctas_per_sm(int NT) {
  return NT <= 4 ? WARP_NARROW_CTAS_PER_SM : WARP_WIDE_CTAS_PER_SM;
}

// Copy one document's N_LANES lanes of S rows from `src` (lane stride
// `sls`) to `dst` (lane stride `dls`), one warp: 16 bytes a lane where
// `vec` (both sides' lanes aligned to 16 bytes, S a multiple of 4), else 4,
// a lane's next row 32 rows on; each lane issues the loads of 5 lanes
// before it stores any.
__device__ __forceinline__ void warp_copy(int *dst, size_t dls,
                                          const int *src, size_t sls, int S,
                                          bool vec) {
  const int lane = threadIdx.x & 31;
  constexpr int G = 5;
  static_assert(N_LANES % G == 0, "whole groups of lanes");
  if (vec) {
    for (int i = lane; i < S / 4; i += 32) {
#pragma unroll
      for (int l0 = 0; l0 < N_LANES; l0 += G) {
        int4 v[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[g] = reinterpret_cast<const int4 *>(src + (l0 + g) * sls)[i];
#pragma unroll
        for (int g = 0; g < G; ++g)
          reinterpret_cast<int4 *>(dst + (l0 + g) * dls)[i] = v[g];
      }
    }
  } else {
    for (int r = lane; r < S; r += 32) {
#pragma unroll
      for (int l0 = 0; l0 < N_LANES; l0 += G) {
        int v[G];
#pragma unroll
        for (int g = 0; g < G; ++g) v[g] = src[(l0 + g) * sls + r];
#pragma unroll
        for (int g = 0; g < G; ++g) dst[(l0 + g) * dls + r] = v[g];
      }
    }
  }
}

// Rows [lo, hi) of the warp's table take their lanes' fills.
template <class Doc>
__device__ __forceinline__ void warp_fill(const Doc &d, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int r = lo + lane; r < hi; r += 32) {
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) d.at(l, r) = lane_fill(l);
  }
}

// Load one document's N_LANES lanes of S rows (S a multiple of 4, both
// sides 16-byte aligned) from global memory (lane stride `sls`) into
// shared memory (lane stride `dls`), one warp, by cp.async: 16 bytes a
// copy, every copy of the table in flight at once and none through
// registers; returns when all have landed (the caller's __syncwarp then
// shows them to the warp).
__device__ __forceinline__ void warp_load_async(int *dst, size_t dls,
                                                const int *src, size_t sls,
                                                int S) {
  const int lane = threadIdx.x & 31;
  for (int i = 4 * lane; i < S; i += 4 * 32) {
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) {
      const unsigned to =
          (unsigned)__cvta_generic_to_shared(dst + l * dls + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(src + l * sls + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K1 (MODE 0) and K3 (MODE 2) on the warp tier: the one warp of CTA b
// runs document b, its N_LANES x S table in the CTA's dynamic shared
// memory, the op loop's scratch in registers (DocT<T_WARP, NT>, NT =
// warp_tiles(S)), each op over the rows below min(S, count + 2);
// __syncwarp orders shared memory.
template <int MODE, int NT>
__global__ void __launch_bounds__(32, warp_ctas_per_sm(NT))
merge_warp_kernel(const int *__restrict__ ops, const int *tables_in,
                  const int *scalars_in, int *tables_out, int *scalars_out,
                  int n_docs, int S, int K, bool vec) {
  static_assert(MODE != 1, "K2 has no warp tier");
  const int lane = threadIdx.x & 31;
  const int doc = blockIdx.x;
  DocT<T_WARP, NT> d;
  d.L = smem_raw;
  d.ls = S;
  d.A = d.B = d.C = nullptr;
  d.F = nullptr;
  d.S = S;
  d.base = 0;
  d.n = S;
  d.SL = S;
  d.rank = 0;
  d.nranks = 1;
  d.wlo = 0;
  d.whi = S;
  d.ws = nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) d.rA[j] = d.rC[j] = 0;
  d.rF = 0;
  const size_t plane = (size_t)n_docs * S;
  const size_t base = (size_t)doc * S;
  int sc_in[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i)
    sc_in[i] = scalars_in[(size_t)doc * N_SCALARS + i];
  // Every row at or past count is free: only the rows below it are
  // loaded (to a multiple of 4 on the vector path), the rest filled.
  const int count_in = clampi(sc_in[SC_COUNT], 0, S);
  d.live = live_rows(S, count_in, K);  // each op narrows it (whi)
  const int loaded = vec ? min(S, (count_in + 3) & ~3) : count_in;
  if (vec)
    warp_load_async(d.L, S, tables_in + base, plane, loaded);
  else
    warp_copy(d.L, S, tables_in + base, plane, loaded, false);
  warp_fill(d, loaded, S);
  Scalars sc{sc_in[SC_COUNT], sc_in[SC_MIN_SEQ], sc_in[SC_CUR_SEQ],
             sc_in[SC_SELF], sc_in[SC_ERR]};
  __syncwarp();
  apply_ops_doc(d, ops + (size_t)doc * K * OP_WIDTH, K, sc);
  __syncwarp();
  int count = sc.count;
  if constexpr (MODE == 2) {
    d.whi = clampi(sc.count, 0, S);  // every row past count is free
    count = compact_doc<K3_STORE_ROWS>(d, sc.min_seq, nullptr, plane,
                                       count_in);
    __syncwarp();
  }
  // In place, the rows at or past both counts are free before and after:
  // only the rows below the larger are stored. Out of place, every row.
  int stored = S;
  if (tables_in == tables_out) {
    stored = max(clampi(count, 0, S), count_in);
    if (vec) stored = min(S, (stored + 3) & ~3);
  }
  warp_copy(tables_out + base, plane, d.L, S, stored, vec);
  if (lane == 0) {
    const int out[N_SCALARS] = {count, sc.min_seq, sc.cur_seq,
                                sc.self_client, sc.err, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < N_SCALARS; ++i)
      scalars_out[(size_t)doc * N_SCALARS + i] = out[i];
  }
}

// Raise kernel `kern`'s dynamic shared memory cap on the current device to
// `smem` bytes where its cap there (`cap`, one entry a device, only
// rising) lies below: once a device and size, not a host call in front of
// every launch.
template <class Kern>
int smem_cap(Kern kern, size_t smem, std::atomic<size_t> (&cap)[MAX_DEVICES]) {
  static std::mutex setup;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem <= cap[dev].load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(setup);
  if (smem <= cap[dev].load(std::memory_order_relaxed)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cap[dev].store(smem, std::memory_order_release);
  return 0;
}

// A launch of clusters of C CTAs (`threads` each, `smem` bytes of dynamic
// shared memory, SL rows) per doc: the cluster tier (C = ceil(S /
// CLUSTER_ROWS), the slices in shared memory) and the split tier (the
// table in global memory). Returns an error when such a cluster cannot be
// scheduled; it never falls back to another tier. The cluster's
// occupancy is asked once a device, C and smem size (`checked`: smem + 1
// where done) and the kernel's attributes set only where they grow (its
// dynamic shared memory cap, `smem_cap`, only rises), not on every launch:
// they are host calls in front of each launch, which a CUDA-event time and
// a sharded document's op both wait behind.
template <int MODE, int TIER>
int launch_cluster(const int *ops, const int *tables_in, const int *scalars_in,
                   int *tables_out, int *scalars_out, int *work, int n_docs,
                   int S, int K, int C, int threads, size_t smem,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long>
      checked[MAX_DEVICES][MAX_CLUSTER + 1];
  static std::atomic<size_t> cap[MAX_DEVICES];
  static std::mutex setup;
  if (C < 1 || C > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int SL = ((S + C - 1) / C + 31) / 32 * 32;
  auto kern = merge_kernel<MODE, TIER>;
  const bool known =
      checked[dev][C].load(std::memory_order_relaxed) == smem + 1;
  std::unique_lock<std::mutex> lock(setup, std::defer_lock);
  if (!known) {
    lock.lock();
    const int ce = smem_cap(kern, smem, cap);
    if (ce != 0) return ce;
    if (C > 8) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_docs * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!known) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void *)kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    checked[dev][C].store(smem + 1, std::memory_order_relaxed);
  }
  return (int)cudaLaunchKernelEx(&cfg, kern, ops, tables_in, scalars_in,
                                 tables_out, scalars_out, work, n_docs, S, K,
                                 SL);
}

// The shared tier: one CTA of up to MAX_THREADS threads per doc.
template <int MODE, bool WIDE>
int launch_smem(const int *ops, const int *tables_in, const int *scalars_in,
                int *tables_out, int *scalars_out, int n_docs, int S, int K,
                cudaStream_t stream) {
  static std::atomic<size_t> cap[MAX_DEVICES];
  const int threads = min((S + 31) / 32 * 32, MAX_THREADS);
  const size_t smem = smem_bytes(S);
  const int e = smem_cap(merge_kernel<MODE, T_SMEM, WIDE>, smem, cap);
  if (e != 0) return e;
  merge_kernel<MODE, T_SMEM, WIDE><<<n_docs, threads, smem, stream>>>(
      ops, tables_in, scalars_in, tables_out, scalars_out, nullptr, n_docs, S,
      K, S);
  return 0;
}

// The current device's SM count, asked of the runtime once a device.
int sm_count(int &sms) {
  static std::atomic<int> known[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  sms = known[dev].load(std::memory_order_relaxed);
  if (sms > 0) return 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) known[dev].store(sms, std::memory_order_relaxed);
  return (int)e;
}

// The split tier: each doc over a cluster of C = ceil(SMs / n_docs) CTAs,
// at most `max_ctas` and at least 1, so a few large documents still
// cover the card's SMs.
template <int MODE>
int launch_split(const int *ops, const int *tables_in, const int *scalars_in,
                 int *tables_out, int *scalars_out, int *work, int n_docs,
                 int S, int K, int max_ctas, cudaStream_t stream) {
  int sms = 0;
  const int ce = sm_count(sms);
  if (ce != 0) return ce;
  const int C = max(1, min(max_ctas, (sms + n_docs - 1) / n_docs));
  return launch_cluster<MODE, T_SPLIT>(ops, tables_in, scalars_in, tables_out,
                                       scalars_out, work, n_docs, S, K, C,
                                       GLOBAL_THREADS, 0, stream);
}

// The warp tier: K1 or K3 (MODE 0 or 2), one CTA of one warp a document,
// the kernel of warp_tiles(S) tiles.
template <int MODE, int NT>
int launch_warp_nt(const int *ops, const int *tables_in,
                   const int *scalars_in, int *tables_out, int *scalars_out,
                   int n_docs, int S, int K, cudaStream_t stream) {
  static std::atomic<size_t> cap[MAX_DEVICES];
  auto kern = merge_warp_kernel<MODE, NT>;
  const size_t smem = (size_t)N_LANES * S * sizeof(int);
  const int e = smem_cap(kern, smem, cap);
  if (e != 0) return e;
  const bool vec = S % 4 == 0 && ((uintptr_t)tables_in & 15) == 0 &&
                   ((uintptr_t)tables_out & 15) == 0;
  kern<<<n_docs, 32, smem, stream>>>(ops, tables_in, scalars_in, tables_out,
                                     scalars_out, n_docs, S, K, vec);
  return 0;
}

template <int MODE>
int launch_warp(const int *ops, const int *tables_in, const int *scalars_in,
                int *tables_out, int *scalars_out, int n_docs, int S, int K,
                cudaStream_t stream) {
  switch (warp_tiles(S)) {
    case 2:
      return launch_warp_nt<MODE, 2>(ops, tables_in, scalars_in, tables_out,
                                     scalars_out, n_docs, S, K, stream);
    case 4:
      return launch_warp_nt<MODE, 4>(ops, tables_in, scalars_in, tables_out,
                                     scalars_out, n_docs, S, K, stream);
    case 8:
      return launch_warp_nt<MODE, 8>(ops, tables_in, scalars_in, tables_out,
                                     scalars_out, n_docs, S, K, stream);
    default:
      return launch_warp_nt<MODE, 16>(ops, tables_in, scalars_in,
                                      tables_out, scalars_out, n_docs, S, K,
                                      stream);
  }
}

// tier T_SMEM: S <= SMEM_MAX_CAP. T_CLUSTER: S <= CLUSTER_MAX_CAP.
// T_GLOBAL: S <= GLOBAL_MAX_CAP (K2 there runs on T_SPLIT). T_SPLIT: S <=
// MAX_CAP. K2 on the global tier on at most K2_MAX_CTAS CTAs a doc, on the
// split tier on SPLIT_MAX_CTAS as K1 and K3. The last two take
// n_docs * work_ints(S) ints at `work`. T_WARP: S <= WARP_MAX_CAP, K1 and
// K3 only (K2 is refused).
template <int MODE>
int launch(const int *ops, const int *tables_in, const int *scalars_in,
           int *tables_out, int *scalars_out, int *work, int n_docs, int S,
           int K, int tier, void *stream) {
  if (n_docs < 1 || S < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tier == T_SMEM) {
    if (S > SMEM_MAX_CAP) return (int)cudaErrorInvalidValue;
    int e;
    if (MODE != 1 && S > SMEM_NARROW_CAP)  // K2 keeps one entry
      e = launch_smem<MODE, MODE != 1>(ops, tables_in, scalars_in, tables_out,
                                       scalars_out, n_docs, S, K, st);
    else
      e = launch_smem<MODE, false>(ops, tables_in, scalars_in, tables_out,
                                   scalars_out, n_docs, S, K, st);
    if (e != 0) return e;
  } else if (tier == T_CLUSTER) {
    if (S > CLUSTER_MAX_CAP) return (int)cudaErrorInvalidValue;
    const int C = (S + CLUSTER_ROWS - 1) / CLUSTER_ROWS;
    const int e = launch_cluster<MODE, T_CLUSTER>(
        ops, tables_in, scalars_in, tables_out, scalars_out, nullptr, n_docs,
        S, K, C, CLUSTER_THREADS, smem_bytes(((S + C - 1) / C + 31) / 32 * 32),
        st);
    if (e != 0) return e;
  } else if (tier == T_GLOBAL) {
    if (S > GLOBAL_MAX_CAP || work == nullptr)
      return (int)cudaErrorInvalidValue;
    if constexpr (MODE == 1) {
      const int e = launch_split<MODE>(ops, tables_in, scalars_in, tables_out,
                                       scalars_out, work, n_docs, S, K,
                                       K2_MAX_CTAS, st);
      if (e != 0) return e;
    } else {
      merge_kernel<MODE, T_GLOBAL><<<n_docs, GLOBAL_THREADS, 0, st>>>(
          ops, tables_in, scalars_in, tables_out, scalars_out, work, n_docs,
          S, K, S);
    }
  } else if (tier == T_SPLIT) {
    if (S > MAX_CAP || work == nullptr) return (int)cudaErrorInvalidValue;
    const int e = launch_split<MODE>(
        ops, tables_in, scalars_in, tables_out, scalars_out, work, n_docs, S,
        K, SPLIT_MAX_CTAS, st);
    if (e != 0) return e;
  } else if (tier == T_WARP) {
    if constexpr (MODE == 1) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (S > WARP_MAX_CAP) return (int)cudaErrorInvalidValue;
      const int e = launch_warp<MODE>(ops, tables_in, scalars_in, tables_out,
                                      scalars_out, n_docs, S, K, st);
      if (e != 0) return e;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// -- X1 and X2: the sharded document's per-op exchange ----------------------
//
// Replace the exchange half of the reference's
//   fluidframework_tpu/parallel/sharded_doc.py  _shard_apply_one
// (the body of a jitted shard_map: the per-shard perspective, two scalar
// all_gathers, then the owner, offsets and ERR_RANGE; no pl.pallas_call).
// A document's shards sit in one packed pair per device group,
// [N_LANES, n_g, S] / [n_g, N_SCALARS]; the op row is read in place from
// the uploaded [K, OP_WIDTH] buffer. On one device group (every layout one
// card runs) an op is two launches on one stream, shard_exchange (X1 with
// X2 run by its last CTA) and K1; on several, X1 on each group, the stats
// copied between the cards, then X2 and K1 on each. Nothing is read back
// to the host.
//
// X1 (shard_stats) writes [n_g, 3] per shard: its visible length, whether
// it holds rows (count > 0), and whether an insert at its end may land in
// it. The last is the placement predicate of K1 evaluated at rem = total -
// prefix, computed in one pass without a prefix scan: a row of positive
// visible length has prefix + vis <= total, so it never fires there; a
// zero-length row fires iff it takes part, breaks the tie
// (ties_before) and prefix == total, i.e. no row after it has positive
// visible length. So tail = last eligible zero row > last positive row,
// both maxima of row indices (-1 for none), and the length is a sum; all
// three are free of order, and the int32 sum wraps as the plain version's
// int64 sum cast to int32 does. (The two forms agree while a shard's
// visible length stays below 2^32 and no length is negative.)
//
// X1 reads only rows below the shard's count: count is the high-water
// mark of used rows, every row at or past it is free (K1 shifts rows up
// from below it, K2 refills the tail with free rows), and a free row takes
// no part. The plain version walks every row, as the reference does, so
// each hold of the kernel against it also checks that bound. The grid is
// C CTAs a shard, C picked by the host from S alone (X1_CTAS_PER_SM CTAs
// a SM, at least X1_MIN_ROWS rows of S a CTA), so nothing is read back;
// each CTA reads the shard's count and takes its share of [0, count), so
// the work follows the live rows. A thread takes X1_VEC consecutive rows
// at a time, one 16-byte load a lane where the lanes are aligned (S a
// multiple of 4), and issues the loads of every lane the perspective needs
// (kind, length, seq, writer, removed seq, and the one removers lane of
// the op's writer) for X1_UNROLL such vectors before it reduces any: two
// memory latencies (the op row and scalars, then the lanes) in place of
// one or two a row. Each CTA reduces its rows and folds them into its
// shard's row of the accumulators [n_g + 1, 3] with atomics, then takes a
// ticket (the last row); the CTA that takes the launch's last one writes
// every shard's stats and resets the accumulators for the next op (no
// memset launch). Bound: bytes, the six lanes of each row below count,
// three scalars a shard and the op row (about 1.9 MB, 0.6 us, for 80,000
// rows); the latencies of the loads, the fold's atomics and the launch
// set the time.
//
// X2 (shard_resolve) is one CTA a device group. It reads the [n, 3] stats
// of every shard (row_of[j]: the row holding shard j) and the op row, scans
// the lengths into exclusive offsets (in dynamic shared memory), finds the
// global length, the first shard whose placement fires and the last one
// holding rows, and writes the group's rewritten rows [n_g, 1, OP_WIDTH]
// (K1's op input; at[i]: the shard index of the group's i-th shard): the
// owner gets the INSERT at its local, clamped position and every other
// shard a NOOP; REMOVE/ANNOTATE get the range clamped into the shard, a
// NOOP where it is empty; every other type passes. The global ERR_RANGE
// is ORed into each shard's err lane here, before K1: K1 only ever ORs
// that lane, never reads it as a gate. Its 3 us on the card are a launch's
// own latency, so on one device group it is not a launch: shard_exchange
// is X1 whose CTA that writes the group's stats (the last ticket: every
// CTA of the group has folded) keeps them in shared memory and runs X2's
// body, resolve_group, on them.

constexpr int X1_THREADS = 256;
// X1's grid: X1_CTAS_PER_SM CTAs a SM, at least X1_MIN_ROWS rows of S a
// CTA (16 CTAs a shard at 8 x 65,536, 128 at 1 x 524,288). On an H100
// 1,024 and 2,048 rows were 0.5-0.8 us slower a launch at the sharded
// paths' shapes and 8,192 0.3-0.4 us (fewer CTAs fold fewer atomics into
// one address, more CTAs load fewer rows each).
constexpr int X1_MIN_ROWS = 4096;
constexpr int X1_CTAS_PER_SM = 2;
constexpr int X1_VEC = 4;            // rows a lane's 16-byte load holds
constexpr int X1_UNROLL = 2;         // vectors a thread loads, then reduces
constexpr int X1_LANES = 6;          // lanes X1 reads a row
constexpr int X2_THREADS = 128;
constexpr int X2_MAX_SHARDS = 8192;        // X2's offsets in 32 KB of smem
constexpr int EXCHANGE_MAX_SHARDS = 2048;  // its offsets and stats in 32 KB
constexpr int ST_VIS = 0, ST_LIVE = 1, ST_TAIL = 2, N_STATS = 3;
// X1's accumulators a shard; the row after the shards' holds the launch's
// ticket in its first column.
constexpr int ACC_VIS = 0, ACC_POS = 1, ACC_ZERO = 2, N_ACC = 3;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_incl_scan_u(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Take a ticket at p (an acq_rel atomic add): returns the count before
// this one. This thread's earlier writes and atomics are visible to
// whoever takes a later ticket, and its later reads see every earlier
// taker's. (__threadfence before and after a relaxed add was 0.3-0.7 us
// slower a launch on an H100.)
__device__ __forceinline__ int take_ticket(int *p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// CTAs of X1 a shard.
int x1_ctas(int n_g, int S, int sms) {
  const int fill = (X1_CTAS_PER_SM * sms + n_g - 1) / n_g;
  const int most = (S + X1_MIN_ROWS - 1) / X1_MIN_ROWS;
  return max(1, min(fill, most));
}

static_assert(X1_VEC == 4, "X1 loads a lane's rows as one int4");

// Rows [r, r + X1_VEC) of one lane (p: its row 0) into v, r < hi: one
// 16-byte load where `vec` (the lanes aligned at every X1_VEC-th row, so
// the vector lies inside the lane), else one load a row below hi. Rows at
// or past hi are never used.
__device__ __forceinline__ void x1_load(int (&v)[X1_VEC], const int *p, int r,
                                        int hi, bool vec) {
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4 *>(p + r));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < X1_VEC; ++i) v[i] = r + i < hi ? __ldg(p + r + i) : 0;
  }
}

// One CTA of X1: shard blockIdx.x / C, its (blockIdx.x % C)-th share of
// the rows below the shard's count. Reduces its rows and folds them into
// the shard's accumulators; the CTA that takes the launch's last ticket
// writes every shard's stats (also into `sstats`, shared memory, where
// not null) and resets the accumulators. Returns, in every thread,
// whether this CTA wrote them. `scalars` is read with plain loads:
// shard_exchange writes its err lanes later in the same launch.
__device__ bool x1_cta(const int *op, const int *tables, const int *scalars,
                       int *stats, int *acc, int n_g, int S, int C, bool vec,
                       int *sstats) {
  __shared__ unsigned s_vis[X1_THREADS / 32];
  __shared__ int s_pos[X1_THREADS / 32], s_zero[X1_THREADS / 32];
  __shared__ bool s_wrote;
  const int shard = blockIdx.x / C, c = blockIdx.x % C;
  const int *L = tables + (size_t)shard * S;
  const size_t ls = (size_t)n_g * S;
  const int *sc = scalars + (size_t)shard * N_SCALARS;
  Op o{};
  o.seqn = op[F_SEQ];
  o.refn = op[F_REF];
  o.clientn = op[F_CLIENT];
  o.is_local = o.clientn == sc[SC_SELF];
  const int min_seq = sc[SC_MIN_SEQ];
  const int n = min(max(sc[SC_COUNT], 0), S);
  const int op_norm = o.seqn == UNASSIGNED_SEQ ? NORM_NEW_LOCAL : o.seqn;
  // removed_by_slot reads only the removers lane of the op's writer.
  const int l_rb = L_RBITS + (o.clientn >= 0 && o.clientn < MAX_WRITERS
                                  ? o.clientn / 31 : 0);
  const int lanes[X1_LANES] = {L_KIND, L_LEN, L_SEQ, L_CLIENT, L_RSEQ, l_rb};
  // This CTA's rows [lo, hi), R a multiple of X1_VEC (aligned vectors).
  const int R = ((n + C - 1) / C + X1_VEC - 1) / X1_VEC * X1_VEC;
  const int lo = (int)min((long long)c * R, (long long)n);
  const int hi = min(n, lo + R);
  unsigned vis = 0;
  int last_pos = -1, last_zero = -1;
  const int step = X1_VEC * (int)blockDim.x;
  for (int r0 = lo + X1_VEC * (int)threadIdx.x; r0 < hi;
       r0 += step * X1_UNROLL) {
    int v[X1_UNROLL][X1_LANES][X1_VEC];
#pragma unroll
    for (int u = 0; u < X1_UNROLL; ++u)
      if (r0 + u * step < hi) {
#pragma unroll
        for (int l = 0; l < X1_LANES; ++l)
          x1_load(v[u][l], L + lanes[l] * ls, r0 + u * step, hi, vec);
      }
#pragma unroll
    for (int u = 0; u < X1_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < X1_VEC; ++i) {
        const int r = r0 + u * step + i;
        if (r >= hi) continue;
        bool part;
        const int rb = v[u][5][i];
        const int x = perspective_of(
            v[u][0][i], v[u][2][i], v[u][3][i], v[u][1][i], v[u][4][i],
            removed_by_slot(rb, rb, rb, o.clientn), o, min_seq, part);
        vis += (unsigned)x;
        if (x > 0)
          last_pos = max(last_pos, r);
        else if (part && x == 0 && ties_before(op_norm, v[u][2][i]))
          last_zero = max(last_zero, r);
      }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  vis = warp_sum_u(vis);
  last_pos = warp_max(last_pos);
  last_zero = warp_max(last_zero);
  if (lane == 0) {
    s_vis[w] = vis;
    s_pos[w] = last_pos;
    s_zero[w] = last_zero;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
      vis += s_vis[i];
      last_pos = max(last_pos, s_pos[i]);
      last_zero = max(last_zero, s_zero[i]);
    }
  }
  // Every CTA folds into its shard's row; the one that takes the launch's
  // last ticket writes every shard's stats and resets the rows; the
  // exchange's tail then reads them from this CTA's shared memory. (A
  // ticket a shard, then one over the shards, with the stats read back from
  // L2, was 0.5 us slower a launch at 8 shards on an H100.)
  int *ticket = acc + (size_t)n_g * N_ACC;
  if (threadIdx.x == 0) {
    bool last = true;
    if (gridDim.x > 1) {
      int *a = acc + (size_t)shard * N_ACC;
      atomicAdd(reinterpret_cast<unsigned *>(a + ACC_VIS), vis);
      atomicMax(a + ACC_POS, last_pos);
      atomicMax(a + ACC_ZERO, last_zero);
      last = take_ticket(ticket) == (int)gridDim.x - 1;
    } else {
      const int st[N_STATS] = {(int)vis, n > 0, last_zero > last_pos};
      for (int f = 0; f < N_STATS; ++f) {
        stats[f] = st[f];
        if (sstats) sstats[f] = st[f];
      }
    }
    s_wrote = last;
  }
  __syncthreads();
  if (!s_wrote) return false;
  if (gridDim.x > 1) {
    for (int j = threadIdx.x; j < n_g; j += blockDim.x) {
      int *a = acc + (size_t)j * N_ACC;
      const unsigned v =
          atomicExch(reinterpret_cast<unsigned *>(a + ACC_VIS), 0u);
      const int p = atomicExch(a + ACC_POS, -1);
      const int z = atomicExch(a + ACC_ZERO, -1);
      const int st[N_STATS] = {
          (int)v, scalars[(size_t)j * N_SCALARS + SC_COUNT] > 0, z > p};
      for (int f = 0; f < N_STATS; ++f) {
        stats[(size_t)j * N_STATS + f] = st[f];
        if (sstats) sstats[j * N_STATS + f] = st[f];
      }
    }
    if (threadIdx.x == 0) atomicExch(ticket, 0);
    __syncthreads();
  }
  return true;
}

// X2's body: one CTA resolves op `op` for a device group from the stats
// [n, 3] of every shard (shard j in row row_of[j], in row j where row_of
// is null), writes the rows of the group's shards (the i-th is shard at[i],
// shard i where at is null) into rows [n_g, OP_WIDTH] and ORs the global
// ERR_RANGE into their err lanes. offsets: [n] ints of dynamic shared
// memory (each shard's exclusive offset). `stats` is global memory
// written before the launch (X2) or this CTA's shared memory
// (shard_exchange).
__device__ void resolve_group(const int *op, const int *stats,
                              const int *row_of, const int *at, int *scalars,
                              int *rows, int n, int n_g, int *offsets) {
  __shared__ unsigned ws[32];
  __shared__ int s_first, s_last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ty = op[F_TYPE], pos1 = op[F_POS1], pos2 = op[F_POS2];
  if (threadIdx.x == 0) {
    s_first = n;  // no shard's placement fires
    s_last = 0;   // no shard holds rows: shard 0
  }
  __syncthreads();
  unsigned carry = 0;  // int32 sums wrap as the plain version's
  for (int base = 0; base < n; base += blockDim.x) {
    const int j = base + (int)threadIdx.x;
    const int *st = j < n ? stats + (size_t)(row_of ? row_of[j] : j) *
                                        N_STATS
                          : nullptr;
    const unsigned t = st ? (unsigned)st[ST_VIS] : 0u;
    const unsigned inc = warp_incl_scan_u(t);
    if (lane == 31) ws[w] = inc;
    __syncthreads();
    unsigned before = 0, tot = 0;
    for (int i = 0; i < nw; ++i) {
      if (i < w) before += ws[i];
      tot += ws[i];
    }
    if (st) {
      const unsigned off = carry + before + inc - t;
      offsets[j] = (int)off;
      const int p = (int)((unsigned)pos1 - off), len = (int)t;
      if ((p >= 0 && p < len) || (p == len && st[ST_TAIL] != 0))
        atomicMin(&s_first, j);
      if (st[ST_LIVE] != 0) atomicMax(&s_last, j);
    }
    carry += tot;
    __syncthreads();  // ws is reused; offsets and the extrema are final
  }
  const int first = s_first;
  const int owner = first < n ? first : s_last;
  const int total = (int)carry;
  const bool is_ins = ty == OP_INSERT;
  const bool is_rng = ty == OP_REMOVE || ty == OP_ANNOTATE;
  // Out of range in GLOBAL coordinates: per-shard clamping would make
  // streams legal that the single-table kernel flags.
  const bool range_err =
      is_ins ? (first >= n && pos1 > total) : (is_rng && pos2 > total);
  for (int i = threadIdx.x; i < n_g; i += blockDim.x) {
    const int j = at ? at[i] : i;
    const unsigned off = (unsigned)offsets[j];
    const int len =
        stats[(size_t)(row_of ? row_of[j] : j) * N_STATS + ST_VIS];
    const int a = min(max((int)((unsigned)pos1 - off), 0), len);
    const int b = min(max((int)((unsigned)pos2 - off), 0), len);
    int *row = rows + (size_t)i * OP_WIDTH;
#pragma unroll
    for (int f = 0; f < OP_WIDTH; ++f) row[f] = op[f];
    row[F_POS1] = (is_ins || is_rng) ? a : pos1;
    row[F_POS2] = is_rng ? b : pos2;
    row[F_TYPE] = is_ins ? (j == owner ? OP_INSERT : OP_NOOP)
                         : (is_rng && a >= b ? OP_NOOP : ty);
    if (range_err)
      atomicOr(scalars + (size_t)i * N_SCALARS + SC_ERR, ERR_RANGE);
  }
}

__global__ void __launch_bounds__(X1_THREADS)
shard_stats_kernel(const int *__restrict__ op, const int *tables,
                   const int *scalars, int *stats, int *acc, int n_g, int S,
                   int C, bool vec) {
  x1_cta(op, tables, scalars, stats, acc, n_g, S, C, vec, nullptr);
}

__global__ void __launch_bounds__(X2_THREADS)
shard_resolve_kernel(const int *__restrict__ op,
                     const int *__restrict__ stats,
                     const int *__restrict__ row_of,
                     const int *__restrict__ at, int *scalars, int *rows,
                     int n, int n_g) {
  extern __shared__ int offsets[];  // [n]: each shard's exclusive offset
  resolve_group(op, stats, row_of, at, scalars, rows, n, n_g, offsets);
}

// X1 on one device group (its n_g shards in order), then X2 in the CTA
// that writes the group's stats, from its shared-memory copy of them.
__global__ void __launch_bounds__(X1_THREADS)
shard_exchange_kernel(const int *__restrict__ op, const int *tables,
                      int *scalars, int *stats, int *acc, int *rows, int n_g,
                      int S, int C, bool vec) {
  extern __shared__ int smem[];  // [4 n_g]: offsets, then stats
  if (x1_cta(op, tables, scalars, stats, acc, n_g, S, C, vec, smem + n_g))
    resolve_group(op, smem + n_g, nullptr, nullptr, scalars, rows, n_g, n_g,
                  smem);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// tables_out/scalars_out may alias tables_in/scalars_in (in-place update).
// `tier`: 0 shared, 1 cluster, 2 global, 3 split, 4 warp (K1 and K3 only;
// merge_compact refuses it); the global and split tiers take a device
// buffer of n_docs * merge_work_ints(S) int32 at `work` (NULL otherwise).

int merge_apply(const int *ops, const int *tables_in, const int *scalars_in,
                int *tables_out, int *scalars_out, int *work, int n_docs,
                int S, int K, int tier, void *stream) {
  return launch<0>(ops, tables_in, scalars_in, tables_out, scalars_out, work,
                   n_docs, S, K, tier, stream);
}

int merge_compact(const int *tables_in, const int *scalars_in,
                  int *tables_out, int *scalars_out, int *work, int n_docs,
                  int S, int tier, void *stream) {
  return launch<1>(nullptr, tables_in, scalars_in, tables_out, scalars_out,
                   work, n_docs, S, 0, tier, stream);
}

int merge_apply_compact(const int *ops, const int *tables_in,
                        const int *scalars_in, int *tables_out,
                        int *scalars_out, int *work, int n_docs, int S, int K,
                        int tier, void *stream) {
  return launch<2>(ops, tables_in, scalars_in, tables_out, scalars_out, work,
                   n_docs, S, K, tier, stream);
}

int merge_smem_max_capacity(void) { return SMEM_MAX_CAP; }

int merge_cluster_max_capacity(void) { return CLUSTER_MAX_CAP; }

int merge_global_max_capacity(void) { return GLOBAL_MAX_CAP; }

int merge_max_capacity(void) { return MAX_CAP; }

int merge_warp_max_capacity(void) { return WARP_MAX_CAP; }

int merge_split_max_ctas(void) { return SPLIT_MAX_CTAS; }

long long merge_work_ints(int S) { return (long long)work_ints(S); }

// X1: `op` points at one row of the uploaded [K, OP_WIDTH] buffer;
// tables/scalars are a device group's packed pair of n_g shards of S rows;
// writes stats [n_g, 3]. `acc` is [n_g + 1, 3] int32 accumulators, (0, -1,
// -1) a row before the first launch and left so after each.
int shard_stats(const int *op, const int *tables, const int *scalars,
                int *stats, int *acc, int n_g, int S, void *stream) {
  if (n_g < 1 || S < 1 || acc == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(sms);
  if (e != 0) return e;
  const int C = x1_ctas(n_g, S, sms);
  const bool vec = ((uintptr_t)tables & 15) == 0 && S % X1_VEC == 0;
  shard_stats_kernel<<<n_g * C, X1_THREADS, 0, (cudaStream_t)stream>>>(
      op, tables, scalars, stats, acc, n_g, S, C, vec);
  return (int)cudaGetLastError();
}

// X2: stats [n, 3] of every shard (row_of[j] the row of shard j), the op
// row, the group's shard indices at [n_g]; writes rows [n_g, OP_WIDTH] and
// ORs ERR_RANGE into scalars[:, SC_ERR] of the group's shards.
int shard_resolve(const int *op, const int *stats, const int *row_of,
                  const int *at, int *scalars, int *rows, int n, int n_g,
                  void *stream) {
  if (n < 1 || n > X2_MAX_SHARDS || n_g < 1 || n_g > n ||
      row_of == nullptr || at == nullptr)
    return (int)cudaErrorInvalidValue;
  shard_resolve_kernel<<<1, X2_THREADS, (size_t)n * sizeof(int),
                         (cudaStream_t)stream>>>(op, stats, row_of, at,
                                                 scalars, rows, n, n_g);
  return (int)cudaGetLastError();
}

// X1 and X2 in one launch on one device group (all n_g shards, in order):
// X1's stats [n_g, 3], then the rows [n_g, OP_WIDTH] and ERR_RANGE ORed
// into scalars[:, SC_ERR], as shard_resolve with row_of and at the
// identity. `acc` as for shard_stats.
int shard_exchange(const int *op, const int *tables, int *scalars,
                   int *stats, int *acc, int *rows, int n_g, int S,
                   void *stream) {
  if (n_g < 1 || n_g > EXCHANGE_MAX_SHARDS || S < 1 || acc == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(sms);
  if (e != 0) return e;
  const int C = x1_ctas(n_g, S, sms);
  const bool vec = ((uintptr_t)tables & 15) == 0 && S % X1_VEC == 0;
  shard_exchange_kernel<<<n_g * C, X1_THREADS,
                          4 * (size_t)n_g * sizeof(int),
                          (cudaStream_t)stream>>>(
      op, tables, scalars, stats, acc, rows, n_g, S, C, vec);
  return (int)cudaGetLastError();
}

int shard_max_shards(void) { return X2_MAX_SHARDS; }

int shard_exchange_max_shards(void) { return EXCHANGE_MAX_SHARDS; }

const char *merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
