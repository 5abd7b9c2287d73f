// Merge apply (K1), zamboni compact (K2) and fused apply+compact (K3)
// kernels for Hopper (sm_90a), bound to Python through a plain C interface.
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
// so the three tiers run one body of code; the caller names the tier.
//   - shared (S <= 2,048; K1, K2, K3): one CTA per document, up to 256
//     threads. The doc's 15 lanes x S rows, three S-row scratch arrays and
//     an S-byte flag array live in dynamic shared memory for the whole op
//     loop (146 KB at S = 2,048, so one CTA per SM there; 9.3 KB at 128).
//   - cluster (2,048 < S <= 16,384; K1, K2, K3): one thread-block cluster of
//     C = ceil(S / 1,024) CTAs per document (3-16; above 8 a non-portable
//     size), 256 threads each. CTA c holds rows [c*SL, c*SL + n) of all
//     15 lanes plus its scratch in its own shared memory, in the shared
//     tier's layout (SL = S/C rounded up to 32 rows, at most 1,024: 74 KB,
//     3 CTAs per SM; the last slice may be shorter). Every reduction of the
//     op loop reads the other CTAs' warp totals through distributed shared
//     memory after a cluster barrier, so every scalar stays uniform across
//     the cluster. The table is loaded once and stored once, coalesced.
//     Slices of 2,048 rows (512 threads, 1 CTA per SM, C <= 8) ran 13-46%
//     slower at 4,096-16,384 rows on an H100, so the slices are 1,024 rows.
//     A cluster that cannot be scheduled fails the launch.
//   - global (16,384 < S <= 65,536): one CTA of 512 threads per document;
//     the lanes stay in tables_out (lane stride D*S) and the scratch
//     arrays in a per-doc slice of a device workspace the wrapper
//     allocates. Barriers order the global writes. K2 runs there on the
//     split tier: the same, but each document split over a cluster of C
//     CTAs (C = ceil(SMs / D), at most 8), slices of SL rows as on the
//     cluster tier, so a few large documents still cover every SM; the
//     warp totals meet through DSMEM and cluster barriers order the
//     global writes.
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
//     warp's top tile (through DSMEM when it lies in the previous CTA),
//     one barrier, then each warp walks its tiles from the top down taking
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
// earlier warp's last one), one pass that writes each head's source row and
// prefix length at its output index, one barrier, and the store: on the
// shared and cluster tiers it goes straight from shared memory to
// tables_out by warp tiles (the table crosses memory once in, once out);
// on the global tier each lane is gathered into the workspace, one
// barrier, and written back in place. K3 runs K1's loop and K2 back to
// back in one CTA (or cluster).
// The TPU-side workarounds (Hillis-Steele shift ladders, the f32
// permutation matmul, the 256-row compact cap) are not carried over.
//
// Bounds on this card. Each op is a chain of barriers over a small table,
// so all three kernels are latency-bound, not bandwidth-bound: their byte
// floor is 2 x 15 x S x 4 B x D of table traffic plus D x K x 40 B of ops
// (1.55 GB per round at 100,000 docs x 128 rows x 16 ops, 0.46 ms at
// 3.35 TB/s). Shared tier: K x (3-4 barriers + 2-4 passes of S/threads
// rows). Cluster tier: the same with cluster barriers (each a round trip
// over the SMs of the cluster) and passes over 1,024-row slices; 256 docs
// at 8,192 rows are 2,048 CTAs, about 5 waves at 3 CTAs per SM. Global
// tier: the passes go to L2/HBM (coalesced), with one CTA per doc, so
// D < 132 leaves SMs idle (K2 splits the doc instead). K2 itself is one
// pass over the rows and one store per document, with 3 barriers (14 more
// on the global tier), so it is bound by its bytes once enough CTAs are in
// flight: each thread loads all 15 lanes of a row before it stores any.
//
// Ops with an unknown type (outside 0..6) change nothing but the cur_seq /
// min_seq bookkeeping and the ERR_CLIENT bit, as in the Pallas K1.

#include <cooperative_groups.h>
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
constexpr int MAX_CAP = 65536;          // largest global-tier table
constexpr int MAX_THREADS = 256;        // shared tier
constexpr int CLUSTER_ROWS = 1024;      // rows per CTA of a cluster, at most
constexpr int CLUSTER_THREADS = 256;    // cluster tier
constexpr int GLOBAL_THREADS = 512;     // global and split tiers
constexpr int SPLIT_MAX_CTAS = 8;       // CTAs per doc on the split tier
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

// T_SPLIT is K2's form of the global tier: the table in global memory, a
// cluster of CTAs per document (internal; the C entries' tier 2 selects it).
enum Tier { T_SMEM = 0, T_CLUSTER = 1, T_GLOBAL = 2, T_SPLIT = 3 };

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
constexpr int OP_INSERT = 1, OP_REMOVE = 2, OP_ANNOTATE = 3,
              OP_ACK_INSERT = 4, OP_ACK_REMOVE = 5, OP_ACK_ANNOTATE = 6;
constexpr int MAX_WRITERS = 93;
constexpr int ERR_CAPACITY = 1, ERR_RANGE = 2, ERR_CLIENT = 4;

// Warp-total scratch: one array per block- or cluster-wide reduction site,
// so a site never overwrites totals another thread (or CTA) may still be
// reading.
constexpr int WS_SCAN1 = 0, WS_MIN = 32, WS_SCAN2 = 128, WS_CMP = 160,
              WS_SIZE = 288;

// One document's table (or, on the cluster and split tiers, this CTA's
// slice of it) as the block sees it. Rows are addressed by their local
// index lr; the row's index in the whole table is base + lr.
template <int TIER>
struct DocT {
  static constexpr int kTier = TIER;
  // Cluster barriers and DSMEM warp totals; the table in global memory.
  static constexpr bool kCluster = TIER == T_CLUSTER || TIER == T_SPLIT;
  static constexpr bool kGlobal = TIER == T_GLOBAL || TIER == T_SPLIT;
  int *L;            // lane 0, local row 0
  size_t ls;         // lane stride: D*S (global), S (shared), SL (cluster)
  int *A, *B, *C;    // [n] scratch (global and split: slices of [S])
  unsigned char *F;  // [n] flags
  int S;             // rows of the whole table
  int base, n;       // this CTA's rows [base, base + n)
  int SL;            // rows per slice (cluster, split; S otherwise)
  int rank, nranks;  // this CTA in the cluster (0 and 1 otherwise)
  int wlo, whi;      // this warp's local rows [wlo, whi)
  int *ws;           // [WS_SIZE] warp totals
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
    else
      __syncthreads();
  }
};

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
// warp's offset and writes the total. One barrier.
template <class Doc>
__device__ int doc_excl_scan(const Doc &d, int wtot, int *ws, int &total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) ws[w] = wtot;
  d.sync();
  const int g = d.rank * nw + w;
  int off = 0, tot = 0;
  for (int i = lane; i < d.nranks * nw; i += 32) {
    const int rk = Doc::kCluster ? i / nw : 0;
    const int v = d.remote(ws, rk)[i - rk * nw];
    tot += v;
    if (i < g) off += v;
  }
  total = warp_sum(tot);
  return warp_sum(off);
}

// Min of three warp-uniform values over the block or cluster (ws holds 96
// ints). One barrier.
template <class Doc>
__device__ void doc_min3(const Doc &d, int &a, int &b, int &c, int *ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    ws[w] = a;
    ws[32 + w] = b;
    ws[64 + w] = c;
  }
  d.sync();
  for (int i = lane; i < d.nranks * nw; i += 32) {
    const int rk = Doc::kCluster ? i / nw : 0;
    const int *p = d.remote(ws, rk);
    const int j = i - rk * nw;
    a = min(a, p[j]);
    b = min(b, p[32 + j]);
    c = min(c, p[64 + j]);
  }
  a = warp_min(a);
  b = warp_min(b);
  c = warp_min(c);
}

// Scratch row r (an index into the whole table) of array p, wherever in
// the cluster it lies.
template <class Doc>
__device__ int row_value(const Doc &d, int *p, int r) {
  if constexpr (Doc::kTier == T_CLUSTER) {
    const int rk = r / d.SL;
    return d.remote(p, rk)[r - rk * d.SL];
  } else {
    return p[r - d.base];
  }
}

// Write scratch row r (an index into the whole table) of array p.
template <class Doc>
__device__ void put_row(const Doc &d, int *p, int r, int v) {
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
__device__ int lane_at(const Doc &d, int l, int r) {
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

// Visible length of local row lr from the op's perspective (reference
// mergeTree.ts:916-1004); `part` = the row takes part in the walk.
template <class Doc>
__device__ __forceinline__ int perspective(const Doc &d, int lr, const Op &o,
                                           int min_seq, bool &part) {
  const int kind = d.at(L_KIND, lr), seq = d.at(L_SEQ, lr);
  const int client = d.at(L_CLIENT, lr), length = d.at(L_LEN, lr);
  const int rseq = d.at(L_RSEQ, lr);
  const bool live = kind != KIND_FREE;
  const bool removed = rseq != RSEQ_NONE;
  const bool r_acked = removed && rseq != UNASSIGNED_SEQ;
  const bool skip = r_acked && rseq <= min_seq;
  const int rseq_eff = rseq == UNASSIGNED_SEQ ? RSEQ_NONE : rseq;
  const bool by_client = removed_by_slot(
      d.at(L_RBITS, lr), d.at(L_RBITS2, lr), d.at(L_RBITS3, lr), o.clientn);
  const bool hidden = removed && (rseq_eff <= o.refn || by_client);
  const int seq_eff = seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq;
  const bool ins_vis = client == o.clientn || seq_eff <= o.refn;
  const int vis_remote = (!hidden && ins_vis) ? length : 0;
  const int vis_local = removed ? 0 : length;
  part = live && !skip;
  return part ? (o.is_local ? vis_local : vis_remote) : 0;
}

// Perspective pass over this warp's rows: A = visible length, F = takes
// part, C = the warp-local exclusive prefix. Returns the warp's total.
// Only the row's own thread reads A, F and C.
template <class Doc>
__device__ int perspective_pass(const Doc &d, const Op &o, int min_seq) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int t0 = d.wlo; t0 < d.whi; t0 += 32) {
    const int lr = t0 + lane;
    int v = 0;
    if (lr < d.whi) {
      bool part;
      v = perspective(d, lr, o, min_seq, part);
      d.A[lr] = v;
      d.F[lr] = part;
    }
    const int inc = warp_incl_scan(v);
    if (lr < d.whi) d.C[lr] = carry + inc - v;
    carry += __shfl_sync(FULL, inc, 31);
  }
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
// hold nothing). A row below 0 reads as zeros; on the cluster tier a row
// below the slice is read from the previous CTA through DSMEM.
template <class Doc>
__device__ __forceinline__ int rows_below(const Doc &d, int t0) {
  const int lane = threadIdx.x & 31;
  if (lane >= 2 * N_LANES) return 0;
  const int l = lane < N_LANES ? lane : lane - N_LANES;
  const int lr = t0 - (lane < N_LANES ? 1 : 2);
  if (lr >= 0) return d.at(l, lr);
  if (d.rank == 0) return 0;
  return d.remote(d.L, d.rank - 1)[l * d.SL + d.SL + lr];
}

// One pass that applies a Move in place: final row r takes old row
// y = r - d(r), d in {0, 1, 2} and non-decreasing in r, then the split
// edits. Rows below the lowest edge do not change. Each warp whose bottom
// tile moves first reads the two rows below its block (the previous
// warp's, or the previous CTA's through DSMEM); then one barrier; then it
// walks its tiles from the top down: it loads the tile and the two rows
// below it (still unwritten) and takes each row's source by __shfl_sync.
// Every row is written by the thread that reads it in the op loop's
// passes, so no barrier is needed after the pass.
template <class Doc>
__device__ void move_rows(const Doc &d, const Move &mv, const Op &o) {
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
__device__ void apply_ops_doc(const Doc &d, const int *ops_doc, int K,
                              Scalars &sc) {
  const int S = d.S;
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; ++k) {
    const int *p = ops_doc + (size_t)k * OP_WIDTH;
    Op o;
    o.ty = p[F_TYPE];
    o.pos1 = p[F_POS1];
    o.pos2 = p[F_POS2];
    o.seqn = p[F_SEQ];
    o.refn = p[F_REF];
    o.clientn = p[F_CLIENT];
    o.lseqn = p[F_LSEQ];
    o.arg = p[F_ARG];
    o.ilen = p[F_LEN];
    o.msn = p[F_MSN];
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
      for (int t0 = d.wlo; t0 < d.whi; t0 += 32) {
        const int lr = t0 + lane;
        bool h1 = false, h2 = false, hp = false;
        if (lr < d.whi) {
          const int v = d.A[lr];
          const bool part = d.F[lr];
          const int run = d.C[lr] + off;
          d.B[lr] = run;
          const int rem1 = o.pos1 - run, rem2 = o.pos2 - run;
          h1 = part && v > 0 && rem1 > 0 && rem1 < v;
          h2 = part && v > 0 && rem2 > 0 && rem2 < v;
          const int seq = d.at(L_SEQ, lr);
          const int seg_norm =
              seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq;
          hp = part && ((v > 0 && rem1 >= 0 && rem1 < v) ||
                        (v == 0 && rem1 == 0 && op_norm > seg_norm));
        }
        const unsigned b1 = __ballot_sync(FULL, h1);
        const unsigned b2 = __ballot_sync(FULL, h2);
        const unsigned bp = __ballot_sync(FULL, hp);
        const int r0 = d.base + t0 - 1;
        if (m1 == S && b1) m1 = r0 + __ffs(b1);
        if (m2 == S && b2) m2 = r0 + __ffs(b2);
        if (mp == S && bp) mp = r0 + __ffs(bp);
      }
      doc_min3(d, m1, m2, mp, d.ws + WS_MIN);
      const bool has1 = m1 < S, has2 = m2 < S, hasp = mp < S;
      const int idx1 = m1, idx2 = m2;
      const int split1 = has1 ? o.pos1 - row_value(d, d.B, idx1) : 0;
      const int split2 = has2 ? o.pos2 - row_value(d, d.B, idx2) : 0;
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
      for (int lr = d.wlo + lane; lr < d.whi; lr += 32) {
        bool cov = false;
        if (o.is_range) {
          const int v = d.A[lr];
          const int run = d.C[lr] + off2;
          cov = d.F[lr] && v > 0 && run >= o.pos1 && run + v <= o.pos2;
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
      }
    }
    // -- bookkeeping (collab window floor / current seq) ----------------
    sc.cur_seq = max(sc.cur_seq, o.seqn);
    sc.min_seq = max(sc.min_seq, o.msn);
  }
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
};

// The block (or cluster) step of the compaction. Each warp gives its
// count of heads (its first kept row counted as one), its kept rows' LEN
// sum and its first and last kept rows; after one barrier every warp reads
// all of them (through DSMEM on the cluster tier), finds for each warp the
// last kept row before it (an exclusive max scan) and whether that warp's
// first kept row merges into it, and takes its own offsets and the totals.
template <class Doc>
__device__ CompactSums compact_sums(const Doc &d, int tent, int lsum, int fk,
                                    int lk, int *ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    ws[w] = tent;
    ws[32 + w] = lsum;
    ws[64 + w] = fk;
    ws[96 + w] = lk;
  }
  d.sync();
  const int g = d.rank * nw + w, nt = d.nranks * nw;
  CompactSums t{0, 0, 0, 0, false};
  int carry = -1;  // last kept row of the warps before this chunk
  for (int i0 = 0; i0 < nt; i0 += 32) {
    const int i = i0 + lane;
    int th = 0, tl = 0, f = -1, k = -1;
    if (i < nt) {
      const int rk = Doc::kCluster ? i / nw : 0;
      const int *p = d.remote(ws, rk);
      const int j = i - rk * nw;
      th = p[j];
      tl = p[32 + j];
      f = p[64 + j];
      k = p[96 + j];
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
  return t;
}

// K2 (every tier; reference compact_values): reclaim acked tombstones at
// or below min_seq with no pending stamp, squeeze the kept rows down and
// re-merge adjacent splits of one insert, as one gather (see the top of
// the file). Shared and cluster tiers: the result goes to `out` (this
// CTA's rows of lane 0 of tables_out, lane stride `plane`). Global tier:
// in place. Returns n_heads. The caller synchronizes before the call.
template <class Doc>
__device__ int compact_doc(const Doc &d, int min_seq, int *out,
                           size_t plane) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  // -- keep, p(r), tentative heads; A = warp-local prefix of kept LEN ----
  MRow cq{};          // the last kept row of this warp's earlier tiles
  bool has_q = false;
  int tent = 0, lsum = 0, fk = -1, lk = -1;
  for (int t0 = d.wlo; t0 < d.whi; t0 += 32) {
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
    if (valid) d.F[lr] = head;
    tent += __popc(__ballot_sync(FULL, head));
    const int inc = warp_incl_scan(len);
    if (valid) d.A[lr] = lsum + inc - len;
    lsum += __shfl_sync(FULL, inc, 31);
    if (km) {
      const int last = 31 - __clz(km);
      cq = shfl_row(m, last);
      has_q = true;
      lk = d.base + t0 + last;
      if (fk < 0) fk = d.base + t0 + __ffs(km) - 1;
    }
  }
  const CompactSums t = compact_sums(d, tent, lsum, fk, lk, d.ws + WS_CMP);
  // -- each head's source row (C) and prefix length (B), at its output
  //    index, in the CTA that owns that output row --------------------------
  int run = t.off_h;
  for (int t0 = d.wlo; t0 < d.whi; t0 += 32) {
    const int lr = t0 + lane;
    bool head = false;
    if (lr < d.whi)
      head = d.F[lr] && !(t.merged && d.base + lr == fk);
    const unsigned hb = __ballot_sync(FULL, head);
    if (head) {
      const int h = run + __popc(hb & lt);
      put_row(d, d.C, h, d.base + lr);
      put_row(d, d.B, h, t.off_len + d.A[lr]);
    }
    run += __popc(hb);
  }
  d.sync();
  // -- the store ------------------------------------------------------------
  const int nh = t.n_heads;
  if constexpr (Doc::kGlobal) {
    // In place: each lane is gathered into A, one barrier over the table,
    // then written back; a thread reads and writes only A[hl] of its own
    // output rows, so the next lane needs no second barrier.
    for (int l = 0; l < N_LANES; ++l) {
      if (l == L_LEN) {
        for (int hl = threadIdx.x; hl < d.n; hl += blockDim.x) {
          const int h = d.base + hl;
          d.at(l, hl) =
              h < nh ? (h + 1 < nh ? row_value(d, d.B, h + 1) : t.total) -
                           d.B[hl]
                     : 0;
        }
        continue;
      }
      for (int hl = threadIdx.x; hl < d.n; hl += blockDim.x)
        d.A[hl] = d.base + hl < nh ? lane_at(d, l, d.C[hl]) : lane_fill(l);
      d.sync();
      for (int hl = threadIdx.x; hl < d.n; hl += blockDim.x)
        d.at(l, hl) = d.A[hl];
    }
  } else {
    for (int hl = threadIdx.x; hl < d.n; hl += blockDim.x) {
      const int h = d.base + hl;
      const bool is_head = h < nh;
      int s = 0, len = 0;
      if (is_head) {
        s = d.C[hl];
        len = (h + 1 < nh ? row_value(d, d.B, h + 1) : t.total) - d.B[hl];
      }
#pragma unroll
      for (int l = 0; l < N_LANES; ++l)
        out[l * plane + hl] = !is_head       ? lane_fill(l)
                              : l == L_LEN ? len
                                           : lane_at(d, l, s);
    }
  }
  return nh;
}

extern __shared__ int smem_raw[];

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

// MODE 0: K1 apply. MODE 1: K2 compact. MODE 2: K3 apply then compact
// (T_SPLIT: K2 only). WIDE: a shared-tier K1/K3 entry for tables past
// SMEM_NARROW_CAP rows. SL: rows per CTA (the cluster and split tiers; S
// otherwise). `work`: the global and split tiers' workspace.
template <int MODE, int TIER, bool WIDE = false>
__global__ void __launch_bounds__(
    TIER == T_SMEM ? MAX_THREADS
                   : (TIER == T_CLUSTER ? CLUSTER_THREADS : GLOBAL_THREADS),
    ctas_per_sm(TIER, WIDE))
merge_kernel(const int *__restrict__ ops, const int *tables_in,
             const int *scalars_in, int *tables_out, int *scalars_out,
             int *work, int n_docs, int S, int K, int SL) {
  __shared__ int ws[WS_SIZE];
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
  d.S = S;
  d.SL = SL;
  d.base = d.rank * SL;
  d.n = max(0, min(SL, S - d.base));
  d.ws = ws;
  const size_t row0 = base + d.base;
  if constexpr (DocT<TIER>::kGlobal) {
    d.L = tables_out + row0;
    d.ls = plane;
    int *wk = work + (size_t)doc * work_ints(S);
    d.A = wk + d.base;
    d.B = wk + S + d.base;
    d.C = wk + 2 * S + d.base;
    d.F = reinterpret_cast<unsigned char *>(wk + 3 * S) + d.base;
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

  // Shared and cluster tiers: load this CTA's rows. Global and split
  // tiers: the table is updated where it lies in tables_out, so copy
  // tables_in there when they differ.
  // All 15 lanes of a row are loaded before any is stored, so a thread
  // has 15 loads in flight rather than one.
  if (!DocT<TIER>::kGlobal || tables_in != tables_out) {
    for (int r = threadIdx.x; r < d.n; r += blockDim.x) {
      int v[N_LANES];
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) v[l] = tables_in[l * plane + row0 + r];
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) {
        if constexpr (DocT<TIER>::kGlobal)
          tables_out[l * plane + row0 + r] = v[l];
        else
          d.at(l, r) = v[l];
      }
    }
  }
  int sc_in[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i)
    sc_in[i] = scalars_in[(size_t)doc * N_SCALARS + i];
  Scalars sc{sc_in[SC_COUNT], sc_in[SC_MIN_SEQ], sc_in[SC_CUR_SEQ],
             sc_in[SC_SELF], sc_in[SC_ERR]};
  // Every CTA of a cluster has started (and loaded) before any DSMEM read.
  d.sync();

  if constexpr (MODE != 1)
    apply_ops_doc(d, ops + (size_t)doc * K * OP_WIDTH, K, sc);
  int n_heads = 0;
  if constexpr (MODE != 0) {
    if constexpr (MODE == 2) d.sync();  // the op loop's rows, table-wide
    n_heads = compact_doc(d, sc.min_seq, tables_out + row0, plane);
  }
  // No CTA exits (or stores) while another may still read its rows.
  d.sync();

  if constexpr (MODE == 0 && !DocT<TIER>::kGlobal) {
    for (int l = 0; l < N_LANES; ++l)
      for (int r = threadIdx.x; r < d.n; r += blockDim.x)
        tables_out[l * plane + row0 + r] = d.at(l, r);
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

template <class Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A launch of clusters of C CTAs (`threads` each, `smem` bytes of dynamic
// shared memory, SL rows) per doc: the cluster tier (C = ceil(S /
// CLUSTER_ROWS), the slices in shared memory) and K2's split tier (the
// table in global memory). Returns an error when such a cluster cannot be
// scheduled; it never falls back to another tier.
template <int MODE, int TIER>
int launch_cluster(const int *ops, const int *tables_in, const int *scalars_in,
                   int *tables_out, int *scalars_out, int *work, int n_docs,
                   int S, int K, int C, int threads, size_t smem,
                   cudaStream_t stream) {
  const int SL = ((S + C - 1) / C + 31) / 32 * 32;
  auto kern = merge_kernel<MODE, TIER>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
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
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void *)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  return (int)cudaLaunchKernelEx(&cfg, kern, ops, tables_in, scalars_in,
                                 tables_out, scalars_out, work, n_docs, S, K,
                                 SL);
}

// The shared tier: one CTA of up to MAX_THREADS threads per doc.
template <int MODE, bool WIDE>
int launch_smem(const int *ops, const int *tables_in, const int *scalars_in,
                int *tables_out, int *scalars_out, int n_docs, int S, int K,
                cudaStream_t stream) {
  const int threads = min((S + 31) / 32 * 32, MAX_THREADS);
  const size_t smem = smem_bytes(S);
  const cudaError_t e = allow_smem(merge_kernel<MODE, T_SMEM, WIDE>, smem);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<MODE, T_SMEM, WIDE><<<n_docs, threads, smem, stream>>>(
      ops, tables_in, scalars_in, tables_out, scalars_out, nullptr, n_docs, S,
      K, S);
  return 0;
}

// tier T_SMEM: S <= SMEM_MAX_CAP. T_CLUSTER: S <= CLUSTER_MAX_CAP.
// T_GLOBAL: S <= MAX_CAP, with n_docs * work_ints(S) ints at `work` (K2
// there runs on T_SPLIT).
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
    if (S > MAX_CAP || work == nullptr) return (int)cudaErrorInvalidValue;
    if constexpr (MODE == 1) {
      // K2 splits each doc over enough CTAs (at most SPLIT_MAX_CTAS, a
      // portable cluster) that the launch covers every SM.
      int dev = 0, sms = 0;
      cudaError_t ce = cudaGetDevice(&dev);
      if (ce == cudaSuccess)
        ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (ce != cudaSuccess) return (int)ce;
      const int C = max(1, min(SPLIT_MAX_CTAS, (sms + n_docs - 1) / n_docs));
      const int e = launch_cluster<MODE, T_SPLIT>(
          ops, tables_in, scalars_in, tables_out, scalars_out, work, n_docs,
          S, K, C, GLOBAL_THREADS, 0, st);
      if (e != 0) return e;
    } else {
      merge_kernel<MODE, T_GLOBAL><<<n_docs, GLOBAL_THREADS, 0, st>>>(
          ops, tables_in, scalars_in, tables_out, scalars_out, work, n_docs,
          S, K, S);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// tables_out/scalars_out may alias tables_in/scalars_in (in-place update).
// `tier`: 0 shared, 1 cluster, 2 global; the global
// tier takes a device buffer of n_docs * merge_work_ints(S) int32 at
// `work` (NULL otherwise).

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

int merge_max_capacity(void) { return MAX_CAP; }

long long merge_work_ints(int S) { return (long long)work_ints(S); }

const char *merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
