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
// Design. One CTA per document, in one of two tiers that run the same
// device code (every device function is templated over the Doc type):
//   - shared tier (S <= 2,048): the doc's 15 lanes x S rows, three S-row
//     scratch arrays and an S-byte flag array live in dynamic shared
//     memory for the whole K-op loop (S=128: 9.3 KB; S=2048: 146 KB, above
//     the 48 KB default, so the launcher raises the limit with
//     cudaFuncSetAttribute); 256 threads.
//   - global tier (2,048 < S <= 65,536): a table of 15 x S x 4 B (240 KB
//     at 4,096 rows, 3.75 MB at 65,536) does not fit the 227 KB one CTA may
//     use, so the lanes stay in tables_out (lane stride D*S, copied from
//     tables_in first when the two differ) and the scratch arrays sit in a
//     per-doc slice of a device workspace the wrapper allocates; 512
//     threads. Barriers order global writes within the block, so the
//     in-place row shifts stay correct. Accesses stride by the chunk length
//     and are not coalesced.
// Each thread owns a contiguous chunk of R = ceil(S / threads) rows.
//   - Prefix sums: a per-thread serial sum over its chunk, a warp-shuffle
//     scan of the chunk totals, and one shared array of warp totals.
//   - first_true: a block min-reduce over per-thread first hits.
//   - value_at: one read of a scratch row.
//   - Row shifts (B-tree row inserts) run in place: each thread saves the
//     one row it reads from its left neighbour's chunk, a barrier, then it
//     shifts its own chunk from the top down.
//   - K2 is a stream compaction: a scan of `keep`, a direct scatter, then a
//     second scan and scatter over the merge heads.
//   - K3 calls K1's and K2's device functions back to back, so the table
//     never leaves the CTA (shared tier) or is not re-copied (global tier)
//     between them.
// The TPU-side workarounds (Hillis-Steele shift ladders, the f32
// permutation matmul, the 256-row compact cap) are not carried over.
//
// Bound on this card: K1 and K2 are latency-bound on the K sequential
// block-scan steps (each op is a chain of barriers over a small table), not
// bandwidth-bound. Their byte floor is 2 x 15 x S x 4 B x D of table traffic
// plus D x K x 40 B of ops: about 1.55 GB per round at 100,000 docs x 128
// rows x 16 ops, about 0.46 ms at 3.35 TB/s. The global tier also re-reads
// the table from L2 on every op pass, which the byte floor does not count.
//
// Ops with an unknown type (outside 0..6) change nothing but the cur_seq /
// min_seq bookkeeping and the ERR_CLIENT bit, as in the Pallas K1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_LANES = 15;
constexpr int OP_WIDTH = 10;
constexpr int N_SCALARS = 8;
constexpr int SMEM_MAX_CAP = 2048;   // largest shared-tier table
constexpr int MAX_CAP = 65536;       // largest global-tier table
constexpr int MAX_THREADS = 256;     // shared tier
constexpr int GLOBAL_THREADS = 512;  // global tier
constexpr unsigned FULL = 0xffffffffu;

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

// Warp-total scratch: one 32-entry array per block-wide reduction site, so
// a site never overwrites totals another thread may still be reading.
constexpr int WS_SCAN1 = 0, WS_MIN = 32, WS_SCAN2 = 128, WS_KEEP = 160,
              WS_HEAD = 192, WS_VLEN = 224, WS_SIZE = 256;

// One document's table as the block sees it. G = false: the lanes are a
// private [N_LANES][S] copy in shared memory. G = true: they are the doc's
// rows of the packed [N_LANES, D, S] tables in global memory (lane stride
// ls = D*S).
template <bool G>
struct DocT {
  int *L;            // lane 0, row 0 of this doc
  size_t ls;         // lane stride (global tier)
  int *A, *B, *C;    // [S] scratch
  unsigned char *F;  // [S] flags
  int S;
  int r0, r1;        // this thread's rows [r0, r1)
  int *ws;           // [WS_SIZE] warp totals
  __device__ int &at(int lane, int r) const {
    if constexpr (G)
      return L[(size_t)lane * ls + r];
    else
      return L[lane * S + r];
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

// Exclusive scan of per-thread chunk totals over the block: returns this
// thread's offset and writes the block total. One barrier.
__device__ int block_excl_scan(int x, int *ws, int &total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = warp_incl_scan(x);
  if (lane == 31) ws[w] = inc;
  __syncthreads();
  int off = 0, tot = 0;
  for (int i = 0; i < nw; ++i) {
    const int v = ws[i];
    if (i < w) off += v;
    tot += v;
  }
  total = tot;
  return off + inc - x;
}

// Block-wide min of three values (ws holds 96 ints). One barrier.
__device__ void block_min3(int &a, int &b, int &c, int *ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_min(a);
  b = warp_min(b);
  c = warp_min(c);
  if (lane == 0) {
    ws[w] = a;
    ws[32 + w] = b;
    ws[64 + w] = c;
  }
  __syncthreads();
  for (int i = 0; i < nw; ++i) {
    a = min(a, ws[i]);
    b = min(b, ws[32 + i]);
    c = min(c, ws[64 + i]);
  }
}

struct Op {
  int ty, pos1, pos2, seqn, refn, clientn, lseqn, arg, ilen, msn;
  bool is_ins, is_rem, is_ann, is_range, local_op, is_local;
};

// Visible length of row r from the op's perspective (reference
// mergeTree.ts:916-1004); `part` = the row takes part in the walk.
template <class Doc>
__device__ __forceinline__ int perspective(const Doc &d, int r, const Op &o,
                                           int min_seq, bool &part) {
  const int kind = d.at(L_KIND, r), seq = d.at(L_SEQ, r);
  const int client = d.at(L_CLIENT, r), length = d.at(L_LEN, r);
  const int rseq = d.at(L_RSEQ, r);
  const bool live = kind != KIND_FREE;
  const bool removed = rseq != RSEQ_NONE;
  const bool r_acked = removed && rseq != UNASSIGNED_SEQ;
  const bool skip = r_acked && rseq <= min_seq;
  const int rseq_eff = rseq == UNASSIGNED_SEQ ? RSEQ_NONE : rseq;
  const bool by_client = removed_by_slot(
      d.at(L_RBITS, r), d.at(L_RBITS2, r), d.at(L_RBITS3, r), o.clientn);
  const bool hidden = removed && (rseq_eff <= o.refn || by_client);
  const int seq_eff = seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq;
  const bool ins_vis = client == o.clientn || seq_eff <= o.refn;
  const int vis_remote = (!hidden && ins_vis) ? length : 0;
  const int vis_local = removed ? 0 : length;
  part = live && !skip;
  return part ? (o.is_local ? vis_local : vis_remote) : 0;
}

// Rows r > q take row r-1's lanes; then row q gets length `split` and
// row q+1 (the old row q) is advanced by `split` — a boundary split.
template <class Doc>
__device__ void shift_split(const Doc &d, int q, int split) {
  int bnd[N_LANES];
  const int a = d.r0;
  const bool need_bnd = a < d.r1 && a > q;  // a > q >= 0, so a >= 1
  if (need_bnd) {
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) bnd[l] = d.at(l, a - 1);
  }
  __syncthreads();
  for (int r = d.r1 - 1; r >= d.r0; --r) {
    if (r > q) {
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) {
        int v = (r == a) ? bnd[l] : d.at(l, r - 1);
        if (r == q + 1) {
          if (l == L_OFF) v += split;
          if (l == L_LEN) v -= split;
        }
        d.at(l, r) = v;
      }
    } else if (r == q) {
      d.at(L_LEN, r) = split;
    }
  }
  __syncthreads();
}

// Rows r >= q take row r-1's lanes, then row q becomes `row`.
template <class Doc>
__device__ void shift_insert(const Doc &d, int q, const int (&row)[N_LANES]) {
  int bnd[N_LANES];
  const int a = d.r0;
  const bool need_bnd = a < d.r1 && a > q && a >= 1;
  if (need_bnd) {
#pragma unroll
    for (int l = 0; l < N_LANES; ++l) bnd[l] = d.at(l, a - 1);
  }
  __syncthreads();
  for (int r = d.r1 - 1; r >= d.r0; --r) {
    if (r > q) {
      // Row 0 shifts in zeros (only reachable with q < 0).
#pragma unroll
      for (int l = 0; l < N_LANES; ++l)
        d.at(l, r) = r == 0 ? 0 : ((r == a) ? bnd[l] : d.at(l, r - 1));
    } else if (r == q) {
#pragma unroll
      for (int l = 0; l < N_LANES; ++l) d.at(l, r) = row[l];
    }
  }
  __syncthreads();
}

struct Scalars {
  int count, min_seq, cur_seq, self_client, err;
};

// K1's op loop (both tiers): the unified insert / remove / annotate / ack
// pipeline of the reference's _apply_values, one op at a time, every scalar
// uniform across the block.
template <class Doc>
__device__ void apply_ops_doc(const Doc &d, const int *ops_doc, int K,
                              Scalars &sc) {
  const int S = d.S;
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
      int loc = 0;
      for (int r = d.r0; r < d.r1; ++r) {
        bool part;
        const int v = perspective(d, r, o, sc.min_seq, part);
        d.A[r] = v;
        d.F[r] = part;
        loc += v;
      }
      int total;
      int run = block_excl_scan(loc, d.ws + WS_SCAN1, total);
      const int op_norm = o.local_op ? NORM_NEW_LOCAL : o.seqn;
      int m1 = S, m2 = S, mp = S;
      for (int r = d.r0; r < d.r1; ++r) {
        const int v = d.A[r];
        const bool part = d.F[r];
        d.B[r] = run;
        const int rem1 = o.pos1 - run, rem2 = o.pos2 - run;
        if (m1 == S && part && v > 0 && rem1 > 0 && rem1 < v) m1 = r;
        if (m2 == S && part && v > 0 && rem2 > 0 && rem2 < v) m2 = r;
        const int seq = d.at(L_SEQ, r);
        const int seg_norm = seq == UNASSIGNED_SEQ ? NORM_EXISTING_LOCAL : seq;
        const bool place =
            part && ((v > 0 && rem1 >= 0 && rem1 < v) ||
                     (v == 0 && rem1 == 0 && op_norm > seg_norm));
        if (mp == S && place) mp = r;
        run += v;
      }
      block_min3(m1, m2, mp, d.ws + WS_MIN);
      const bool has1 = m1 < S, has2 = m2 < S, hasp = mp < S;
      const int idx1 = m1, idx2 = m2;
      const int split1 = has1 ? o.pos1 - d.B[idx1] : 0;
      const int split2 = has2 ? o.pos2 - d.B[idx2] : 0;
      const int idxp = hasp ? mp : sc.count;
      __syncthreads();  // B is rewritten below; every split is read

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

      // -- split A at pos1, split B at pos2 (post-A space), insert --------
      const bool do_a = do_a_rng || (do_ins && has1);
      if (do_a) shift_split(d, idx1, split1);
      if (do_b_rng) {
        const bool same_row = do_a_rng && idx1 == idx2;
        const int q_b = idx2 + (do_a_rng ? 1 : 0);
        shift_split(d, q_b, same_row ? split2 - split1 : split2);
      }
      if (do_ins) {
        const int q_i = has1 ? idx1 + 1 : idxp;
        int row[N_LANES];
#pragma unroll
        for (int l = 0; l < N_LANES; ++l) row[l] = 0;
        row[L_KIND] = KIND_TEXT;
        row[L_ORIG] = o.arg;
        row[L_LEN] = o.ilen;
        row[L_SEQ] = o.seqn;
        row[L_CLIENT] = o.clientn;
        row[L_LSEQ] = o.local_op ? o.lseqn : 0;
        row[L_RSEQ] = RSEQ_NONE;
        shift_insert(d, q_i, row);
      }
      sc.count = o.is_range ? count_a + (do_b_rng ? 1 : 0)
                            : (do_ins ? count + sh : count);
    }

    const bool is_ack = o.ty == OP_ACK_INSERT || o.ty == OP_ACK_REMOVE ||
                        o.ty == OP_ACK_ANNOTATE;
    if (o.is_range || is_ack) {
      int run = 0;
      if (o.is_range) {
        // -- covered rows: post-split perspective -----------------------
        int loc = 0;
        for (int r = d.r0; r < d.r1; ++r) {
          bool part;
          const int v = perspective(d, r, o, sc.min_seq, part);
          d.A[r] = v;
          d.F[r] = part;
          loc += v;
        }
        int total2;
        run = block_excl_scan(loc, d.ws + WS_SCAN2, total2);
      }
      int lo, mid, hi;
      lo = o.clientn < 31 ? (1 << clampi(o.clientn, 0, 30)) : 0;
      mid = (o.clientn >= 31 && o.clientn < 62)
                ? (1 << clampi(o.clientn - 31, 0, 30)) : 0;
      hi = o.clientn >= 62 ? (1 << clampi(o.clientn - 62, 0, 30)) : 0;
      for (int r = d.r0; r < d.r1; ++r) {
        bool cov = false;
        if (o.is_range) {
          const int v = d.A[r];
          cov = d.F[r] && v > 0 && run >= o.pos1 && run + v <= o.pos2;
          run += v;
        }
        int rseq = d.at(L_RSEQ, r), rlseq = d.at(L_RLSEQ, r);
        int aseq = d.at(L_ASEQ, r), alseq = d.at(L_ALSEQ, r);
        // remove marks (markRangeRemoved)
        const bool m_rem = cov && o.is_rem;
        if (m_rem) {
          const bool not_removed = rseq == RSEQ_NONE;
          const bool was_local = rseq == UNASSIGNED_SEQ;
          if (not_removed && o.local_op) rlseq = o.lseqn;
          if (not_removed || was_local) rseq = o.seqn;
          d.at(L_RBITS, r) |= lo;
          d.at(L_RBITS2, r) |= mid;
          d.at(L_RBITS3, r) |= hi;
        }
        // annotate marks (single-lane LWW)
        if (cov && o.is_ann && (o.local_op || alseq == 0)) {
          d.at(L_AVAL, r) = o.arg;
          aseq = o.seqn;
          alseq = o.local_op ? o.lseqn : 0;
        }
        // acks of own ops (ackPendingSegment)
        const bool live = d.at(L_KIND, r) != KIND_FREE;
        if (o.ty == OP_ACK_INSERT && live &&
            d.at(L_SEQ, r) == UNASSIGNED_SEQ && d.at(L_LSEQ, r) == o.lseqn) {
          d.at(L_SEQ, r) = o.seqn;
          d.at(L_LSEQ, r) = 0;
        }
        if (o.ty == OP_ACK_REMOVE && live && rlseq == o.lseqn) {
          if (rseq == UNASSIGNED_SEQ) rseq = o.seqn;
          rlseq = 0;
        }
        if (o.ty == OP_ACK_ANNOTATE && live && alseq == o.lseqn) {
          aseq = o.seqn;
          alseq = 0;
        }
        d.at(L_RSEQ, r) = rseq;
        d.at(L_RLSEQ, r) = rlseq;
        d.at(L_ASEQ, r) = aseq;
        d.at(L_ALSEQ, r) = alseq;
      }
    }
    // -- bookkeeping (collab window floor / current seq) ----------------
    sc.cur_seq = max(sc.cur_seq, o.seqn);
    sc.min_seq = max(sc.min_seq, o.msn);
    __syncthreads();
  }
}

// Scatter the rows flagged in F to row dst[r] (all lanes); rows at or past
// `n` that nobody fills take their lane's free value. Row `len_lane`, if
// set, takes `len_of(r)` instead of its own length. Two barriers per lane.
// A row's destination may lie in another thread's chunk, so every flagged
// row of a lane is staged in `stage`, a scratch array the caller has free,
// before any is written.
template <class Doc, typename LenFn>
__device__ void squeeze(const Doc &d, const int *dst, int *stage, int n,
                        bool merge_len, LenFn len_of) {
  for (int l = 0; l < N_LANES; ++l) {
    for (int r = d.r0; r < d.r1; ++r)
      if (d.F[r]) stage[r] = d.at(l, r);
    __syncthreads();
    for (int r = d.r0; r < d.r1; ++r) {
      if (r >= n) d.at(l, r) = lane_fill(l);
      if (d.F[r])
        d.at(l, dst[r]) = (merge_len && l == L_LEN) ? len_of(r) : stage[r];
    }
    __syncthreads();
  }
}

// K2 (both tiers; reference compact_values): reclaim acked tombstones at
// or below min_seq with no pending stamp, squeeze live rows down, then
// re-merge adjacent splits of one insert. Returns n_heads.
template <class Doc>
__device__ int compact_doc(const Doc &d, int min_seq) {
  __syncthreads();
  int loc = 0;
  for (int r = d.r0; r < d.r1; ++r) {
    const int rseq = d.at(L_RSEQ, r);
    const bool live = d.at(L_KIND, r) != KIND_FREE;
    const bool pending = d.at(L_LSEQ, r) != 0 || d.at(L_RLSEQ, r) != 0 ||
                         d.at(L_ALSEQ, r) != 0;
    const bool reclaim = live && !pending && rseq != RSEQ_NONE &&
                         rseq != UNASSIGNED_SEQ && rseq <= min_seq;
    const bool keep = live && !reclaim;
    d.F[r] = keep;
    loc += keep;
  }
  int n;
  int run = block_excl_scan(loc, d.ws + WS_KEEP, n);
  for (int r = d.r0; r < d.r1; ++r) {
    d.A[r] = run;
    run += d.F[r];
  }
  squeeze(d, d.A, d.B, n, false, [](int) { return 0; });

  // -- sibling re-merge (packParent subset) --------------------------------
  int loc_h = 0, loc_v = 0;
  for (int r = d.r0; r < d.r1; ++r) {
    const bool valid = r < n;
    bool mergeable = false;
    if (valid && r > 0) {
      const int q = r - 1;
      mergeable = d.at(L_KIND, r) == KIND_TEXT && d.at(L_KIND, q) == KIND_TEXT &&
                  d.at(L_ORIG, r) == d.at(L_ORIG, q) &&
                  d.at(L_OFF, r) == d.at(L_OFF, q) + d.at(L_LEN, q) &&
                  d.at(L_SEQ, r) == d.at(L_SEQ, q) &&
                  d.at(L_CLIENT, r) == d.at(L_CLIENT, q) &&
                  d.at(L_SEQ, r) != UNASSIGNED_SEQ &&
                  d.at(L_RSEQ, r) == RSEQ_NONE && d.at(L_RSEQ, q) == RSEQ_NONE &&
                  d.at(L_ASEQ, r) == d.at(L_ASEQ, q) &&
                  d.at(L_AVAL, r) == d.at(L_AVAL, q) &&
                  d.at(L_ALSEQ, r) == 0 && d.at(L_ALSEQ, q) == 0 &&
                  d.at(L_LSEQ, r) == 0 && d.at(L_LSEQ, q) == 0;
    }
    const bool head = valid && !mergeable;
    d.F[r] = head;
    loc_h += head;
    loc_v += valid ? d.at(L_LEN, r) : 0;
  }
  int n_heads, total;
  int run_h = block_excl_scan(loc_h, d.ws + WS_HEAD, n_heads);
  int run_v = block_excl_scan(loc_v, d.ws + WS_VLEN, total);
  for (int r = d.r0; r < d.r1; ++r) {
    d.B[r] = run_h;       // head destination
    if (d.F[r]) d.C[run_h] = run_v;  // prefix length of each head, by dest
    run_h += d.F[r];
    run_v += r < n ? d.at(L_LEN, r) : 0;
  }
  __syncthreads();
  // Merged length of head t = (next head's prefix length, or total) - own.
  const int *B = d.B, *C = d.C;
  squeeze(d, d.B, d.A, n_heads, true, [=](int r) {
    const int t = B[r];
    return (t + 1 < n_heads ? C[t + 1] : total) - C[t];
  });
  return n_heads;
}

extern __shared__ int smem_raw[];

// Ints of global-tier workspace per document: scratch A, B, C and the flag
// bytes F.
__host__ __device__ size_t work_ints(int S) {
  return (size_t)3 * S + (S + 3) / 4;
}

// MODE 0: K1 apply. MODE 1: K2 compact. MODE 2: K3 apply then compact.
// G: the global tier (lanes in tables_out, scratch in `work`).
template <int MODE, bool G>
__global__ void __launch_bounds__(G ? GLOBAL_THREADS : MAX_THREADS)
merge_kernel(const int *__restrict__ ops, const int *tables_in,
             const int *scalars_in, int *tables_out, int *scalars_out,
             int *work, int n_docs, int S, int K) {
  __shared__ int ws[WS_SIZE];
  const int doc = blockIdx.x;
  const size_t plane = (size_t)n_docs * S;
  const size_t base = (size_t)doc * S;
  DocT<G> d;
  d.S = S;
  d.ws = ws;
  if constexpr (G) {
    d.L = tables_out + base;
    d.ls = plane;
    d.A = work + (size_t)doc * work_ints(S);
  } else {
    d.L = smem_raw;
    d.ls = S;
    d.A = d.L + N_LANES * S;
  }
  d.B = d.A + S;
  d.C = d.B + S;
  d.F = reinterpret_cast<unsigned char *>(d.C + S);
  const int R = (S + blockDim.x - 1) / blockDim.x;
  d.r0 = min((int)threadIdx.x * R, S);
  d.r1 = min(d.r0 + R, S);

  // Shared tier: load the private copy. Global tier: the table is updated
  // where it lies in tables_out, so copy tables_in there when they differ.
  if (!G || tables_in != tables_out) {
    for (int l = 0; l < N_LANES; ++l)
      for (int r = threadIdx.x; r < S; r += blockDim.x) {
        const int v = tables_in[l * plane + base + r];
        if constexpr (G)
          tables_out[l * plane + base + r] = v;
        else
          d.at(l, r) = v;
      }
  }
  int sc_in[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i)
    sc_in[i] = scalars_in[(size_t)doc * N_SCALARS + i];
  Scalars sc{sc_in[SC_COUNT], sc_in[SC_MIN_SEQ], sc_in[SC_CUR_SEQ],
             sc_in[SC_SELF], sc_in[SC_ERR]};
  __syncthreads();

  if (MODE != 1) apply_ops_doc(d, ops + (size_t)doc * K * OP_WIDTH, K, sc);
  int n_heads = 0;
  if (MODE != 0) n_heads = compact_doc(d, sc.min_seq);
  __syncthreads();

  if constexpr (!G) {
    for (int l = 0; l < N_LANES; ++l)
      for (int r = threadIdx.x; r < S; r += blockDim.x)
        tables_out[l * plane + base + r] = d.at(l, r);
  }
  if (threadIdx.x == 0) {
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

size_t smem_bytes(int S) {
  return (size_t)(N_LANES + 3) * S * sizeof(int) + ((S + 15) / 16) * 16;
}

// work == nullptr: the shared tier (S <= SMEM_MAX_CAP). Otherwise the
// global tier (S <= MAX_CAP), with n_docs * work_ints(S) ints at `work`.
template <int MODE>
int launch(const int *ops, const int *tables_in, const int *scalars_in,
           int *tables_out, int *scalars_out, int *work, int n_docs, int S,
           int K, void *stream) {
  if (n_docs < 1 || S < 1 || K < 0) return (int)cudaErrorInvalidValue;
  int threads = (S + 31) / 32 * 32;
  if (work == nullptr) {
    if (S > SMEM_MAX_CAP) return (int)cudaErrorInvalidValue;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    const size_t smem = smem_bytes(S);
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel<MODE, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    merge_kernel<MODE, false><<<n_docs, threads, smem, (cudaStream_t)stream>>>(
        ops, tables_in, scalars_in, tables_out, scalars_out, nullptr, n_docs,
        S, K);
  } else {
    if (S > MAX_CAP) return (int)cudaErrorInvalidValue;
    if (threads > GLOBAL_THREADS) threads = GLOBAL_THREADS;
    merge_kernel<MODE, true><<<n_docs, threads, 0, (cudaStream_t)stream>>>(
        ops, tables_in, scalars_in, tables_out, scalars_out, work, n_docs, S,
        K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// tables_out/scalars_out may alias tables_in/scalars_in (in-place update).
// `work` selects the tier: NULL for the shared tier, else a device buffer
// of n_docs * merge_work_ints(S) int32 for the global tier.

int merge_apply(const int *ops, const int *tables_in, const int *scalars_in,
                int *tables_out, int *scalars_out, int *work, int n_docs,
                int S, int K, void *stream) {
  return launch<0>(ops, tables_in, scalars_in, tables_out, scalars_out, work,
                   n_docs, S, K, stream);
}

int merge_compact(const int *tables_in, const int *scalars_in,
                  int *tables_out, int *scalars_out, int *work, int n_docs,
                  int S, void *stream) {
  return launch<1>(nullptr, tables_in, scalars_in, tables_out, scalars_out,
                   work, n_docs, S, 0, stream);
}

int merge_apply_compact(const int *ops, const int *tables_in,
                        const int *scalars_in, int *tables_out,
                        int *scalars_out, int *work, int n_docs, int S, int K,
                        void *stream) {
  return launch<2>(ops, tables_in, scalars_in, tables_out, scalars_out, work,
                   n_docs, S, K, stream);
}

int merge_smem_max_capacity(void) { return SMEM_MAX_CAP; }

int merge_max_capacity(void) { return MAX_CAP; }

long long merge_work_ints(int S) { return (long long)work_ints(S); }

const char *merge_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
