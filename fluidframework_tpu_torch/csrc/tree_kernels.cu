// SharedTree rebase scans for Hopper (sm_90a), bound to Python through a
// plain C interface.
//
// Replaces the reference package's two jitted device scans of the
// SharedTree rebase path (XLA programs, not pl.pallas_call sites):
//   T1  fluidframework_tpu/tree/device_trunk.py:161 batched_trunk_scan
//       (jit over vmap of a lax.scan; the W-deep ring fold a fori_loop)
//   T2  fluidframework_tpu/tree/device_em.py:129    batched_em_trunk_scan_ring
//       (jit over vmap of a lax.scan; a fori_loop over the R attach runs,
//       an associative_scan cummax)
// The reference compiles each dispatch into one device program; here each
// dispatch is one launch: one CTA per document, the document's whole
// C-commit stream inside it, every per-commit step a handful of block
// phases separated by __syncthreads.
//
// The dense IR (ops/tree_kernel.py) as device functions: _prefix and
// _pool_positions become two or three block prefix sums in one pass
// (block_scan), _apply (apply_change) and rebase_change (c_after=False, the
// only form the scans use) become phases of per-thread strided loops over
// the Lc slots, Lc + 1 boundaries and Pc pool atoms. Every transport keeps
// the plain version's semantics, so the result matches it bit for bit in
// every int32 lane: a position outside [0, size) is dropped; several
// writers to one slot sum (atomicAdd on ints: order-free, so exact); a
// gather outside the range reads 0; sums and prefix sums wrap as int32;
// multihots drop ids outside [0, U) and never hold id 0; output slots past
// Lc are dropped while L still counts them. The attach pool's boundary of
// atom k (#{b : bcum[b] <= k}) is a binary search when the prefix sum came
// out non-decreasing (block_scan reports it) and a count otherwise.
//
// Layout (int32, C-contiguous, the plain versions' lanes):
//   T1  doc_ids [N, Lc], L [N]; commit lanes del/mid/moff [N, C, Lc],
//       ins [N, C, Lc+1], ids/pmid/poff [N, C, Pc], ref/seq [N, C];
//       out doc_ids [N, Lc], L [N], err [N].
//   T2  ring_ids [N, W, Lc], ring_L/ring_seq [N, W], mov_seq0 [N]; commit
//       lanes dm/mv [N, C, Lc], ic [N, C, Lc+1], ii [N, C, Pc],
//       rs/rl/ro [N, C, R], refs/seqs [N, C]; out as T1.
//
// Tiers. Each kernel's per-document state is two regions: the ring (T1:
// W changesets of 4 Lc + 1 + 3 Pc ints plus L and seq; T2: W states of Lc
// ids plus L and seq) and the rest (the incoming change, the document, the
// prefix sums and pool scratch; T2 also its multihot bitset of U bits).
//   - shared: both regions in dynamic shared memory (up to SMEM_BYTES, the
//     227 KB a CTA may opt in to less this file's static shared memory).
//     T1 at config 3b's widths (Lc 128, Pc 32, W 16): 47,572 bytes; T2 at
//     the EditManager's bucket of config 3c (Lc 512, W 16, U 512): 47,304.
//   - global: the ring in a per-document slice of a device workspace the
//     wrapper allocates (read again every commit, so it stays in L2 at the
//     batch sizes the scans run), the rest in shared memory if it fits and
//     in the workspace after the ring otherwise. Every access goes through
//     a generic pointer, so one body of code serves both tiers, and
//     __syncthreads orders the global accesses of the block as it does the
//     shared ones.
//
// Bound. The work per commit is O(W * (Lc + Pc)) int ops and a few dozen
// block barriers per active ring entry (T1) or attach run (T2); the bytes
// are the commit lanes read once. At the scans' batch sizes the card is far
// from both peaks: the kernels are bound by the sequential commit loop's
// barrier latency, which the design keeps low by holding the ring and the
// scratch on chip and skipping inactive ring entries and empty runs (a
// uniform branch per CTA: the plain version computes them and selects).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Dynamic shared memory a CTA may take: the H100's 227 KB opt-in (232,448
// bytes) less 1 KB for the static shared memory below; tree_scan_kernel.py's
// SMEM_BYTES.
constexpr long long SMEM_BYTES = 231424;
// Limits of both kernels (tree_scan_kernel.py's MAX_*). At these limits one
// document's workspace slice stays below 2^31 ints.
constexpr int MAX_LC = 65536;
constexpr int MAX_PC = 65536;
constexpr int MAX_W = 1024;
constexpr int MAX_R = 1024;
constexpr int MAX_U = 1 << 26;
constexpr int MIN_THREADS = 128;
constexpr int MAX_THREADS = 512;
constexpr int T_SHARED = 0;
constexpr int T_GLOBAL = 1;
// block_scan's scratch: 32 partial sums for each of up to 3 arrays, then
// the flag word at a fixed slot, so scans of different widths never race.
constexpr int SCAN_ARRAYS = 3;
constexpr int RED_WORDS = 32 * SCAN_ARRAYS + 1;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Python's x % m for m > 0 (torch.remainder on int32).
__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// Inclusive prefix sums of K arrays of n ints, in place, with int32
// wrap-around (the plain version's int32 cumsum). Each thread sums a
// contiguous chunk, the chunk totals are scanned with warp shuffles, then
// each chunk is rewritten from its offset. Returns bit q set where array q
// did not come out non-decreasing. Ends with a barrier: every thread sees
// the results.
template <int K>
__device__ unsigned block_scan(int *const (&a)[K], int n, unsigned *red) {
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = (T + 31) >> 5;
  const int per = (n + T - 1) / T;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  unsigned s[K], incl[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    unsigned v = 0;
    for (int j = lo; j < hi; ++j) v += (unsigned)a[q][j];
    s[q] = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    incl[q] = v;
    if (lane == 31) red[warp * SCAN_ARRAYS + q] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      unsigned v = lane < nw ? red[lane * SCAN_ARRAYS + q] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += y;
      }
      if (lane < nw) red[lane * SCAN_ARRAYS + q] = v;
    }
    // Every reader of the previous scan's flag passed the barrier above.
    if (lane == 0) red[32 * SCAN_ARRAYS] = 0u;
  }
  __syncthreads();
  unsigned bad = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    unsigned run =
        (warp > 0 ? red[(warp - 1) * SCAN_ARRAYS + q] : 0u) + incl[q] - s[q];
    int prev = (int)run;
    for (int j = lo; j < hi; ++j) {
      run += (unsigned)a[q][j];
      if (j > 0 && (int)run < prev) bad |= 1u << q;
      prev = (int)run;
      a[q][j] = (int)run;
    }
  }
  if (bad) atomicOr(&red[32 * SCAN_ARRAYS], bad);
  __syncthreads();
  return red[32 * SCAN_ARRAYS];
}

// #{j < n : b[j] <= k} (the plain version's comparison-matrix
// searchsorted): a binary search over a non-decreasing b, a count otherwise.
__device__ __forceinline__ int count_leq(const int *b, int n, int k,
                                         bool mono) {
  if (mono) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (b[m] <= k) lo = m + 1;
      else hi = m;
    }
    return lo;
  }
  int c = 0;
  for (int j = 0; j < n; ++j) c += b[j] <= k;
  return c;
}

__device__ __forceinline__ bool member(const unsigned *bits, int id, int U) {
  return id >= 0 && id < U && ((bits[id >> 5] >> (id & 31)) & 1u);
}

// -- T1: the positional trunk scan -----------------------------------------

// One changeset in dense IR, its seven lanes back to back (4 Lc + 1 + 3 Pc
// ints, the order of tree_kernel.DenseChange).
struct Ch {
  int *del, *ins, *ids, *mid, *moff, *pmid, *poff;
};

__device__ __forceinline__ Ch change_at(int *p, int Lc, int Pc) {
  Ch c;
  c.del = p;
  c.ins = p + Lc;
  c.ids = c.ins + Lc + 1;
  c.mid = c.ids + Pc;
  c.moff = c.mid + Lc;
  c.pmid = c.moff + Lc;
  c.poff = c.pmid + Pc;
  return c;
}

struct Scratch {
  int *dex, *bcum, *cbcum, *tpos, *kpos, *kb, *klive, *kcum;
};

// rebase_change(c, o, L) (c_after=False) into `out` (4 Lc + 1 + 3 Pc ints,
// none aliasing c or o). Phases: the prefix sums of o's detaches (dex, the
// exclusive Dex_b), o's attaches (bcum) and c's attaches (cbcum); o's pool
// positions and c's atom boundaries through o's boundary map; every input
// slot's landing position in o's output (tpos) and c's dead move atoms;
// the live atoms' new pool slots; the scatters.
__device__ void rebase(const Ch c, const Ch o, const int L, const Ch out,
                       const int E, const Scratch s, const int Lc,
                       const int Pc, unsigned *red) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int b = t; b <= Lc; b += T) {
    if (b < Lc)
      s.dex[b + 1] = max(o.del[b], (int)(o.mid[b] > 0)) * (int)(b < L);
    else
      s.dex[0] = 0;
    s.bcum[b] = o.ins[b] * (int)(b <= L);
    s.cbcum[b] = c.ins[b] * (int)(b <= L);
  }
  for (int j = t; j < E; j += T) out.del[j] = 0;  // the whole output change
  __syncthreads();
  int *const arrs[3] = {s.dex, s.bcum, s.cbcum};
  const unsigned bad = block_scan<3>(arrs, Lc + 1, red);
  const bool o_mono = !(bad & 2u), c_mono = !(bad & 4u);
  const int o_total = s.bcum[Lc], c_total = s.cbcum[Lc];
  for (int k = t; k < Pc; k += T) {
    const int ob = count_leq(s.bcum, Lc + 1, k, o_mono);
    s.kpos[k] = wadd(wsub(ob, s.dex[clampi(ob, 0, Lc)]), k);
    // b_map at the atom's boundary: b - Dex_b + (bcum - icnt) of o.
    const int cb = clampi(count_leq(s.cbcum, Lc + 1, k, c_mono), 0, Lc);
    const int oicnt = o.ins[cb] * (int)(cb <= L);
    s.kb[k] = wsub(wadd(wsub(cb, s.dex[cb]), s.bcum[cb]), oicnt);
  }
  __syncthreads();
  for (int i = t; i < Lc; i += T) {
    const bool ov = i < L;
    const int dm = max(o.del[i], (int)(o.mid[i] > 0)) * (int)ov;
    int tp = -1;
    if (ov && dm == 0) {
      tp = wadd(wsub(i, s.dex[i]), s.bcum[i]);
    } else if (ov && o.mid[i] > 0) {
      // The move's destination: the sum over o's live atoms with its tag.
      const int mi = o.mid[i], mo = o.moff[i];
      unsigned acc = 0;
      for (int k = 0; k < Pc; ++k)
        if (k < o_total && o.pmid[k] == mi && o.poff[k] == mo)
          acc += (unsigned)s.kpos[k];
      tp = (int)acc;
    }
    s.tpos[i] = tp;
  }
  for (int k = t; k < Pc; k += T) {
    // A move-in atom of c dies when o deleted its source slot.
    bool dead = false;
    const int pm = c.pmid[k];
    if (pm > 0) {
      const int po = c.poff[k];
      for (int i = 0; i < L && i < Lc && !dead; ++i)
        dead = c.mid[i] == pm && c.moff[i] == po && o.del[i] > 0;
    }
    const int live = (!dead && k < c_total) ? 1 : 0;
    s.klive[k] = live;
    s.kcum[k] = live;
  }
  __syncthreads();
  int *const karr[1] = {s.kcum};
  block_scan<1>(karr, Pc, red);
  for (int i = t; i < Lc; i += T) {
    const int tp = s.tpos[i];
    if (i < L && tp >= 0 && tp < Lc) {
      if (c.del[i] > 0) atomicAdd(&out.del[tp], c.del[i]);
      if (c.mid[i] > 0) {
        atomicAdd(&out.mid[tp], c.mid[i]);
        atomicAdd(&out.moff[tp], c.moff[i]);
      }
    }
  }
  for (int k = t; k < Pc; k += T) {
    if (s.klive[k]) {
      const int b = s.kb[k];
      if (b >= 0 && b <= Lc) atomicAdd(&out.ins[b], 1);
      const int g = s.kcum[k] - 1;  // live atoms keep their order
      out.ids[g] = c.ids[k];
      out.pmid[g] = c.pmid[k];
      out.poff[g] = c.poff[k];
    }
  }
  __syncthreads();
}

// apply_change(doc, L, c) into `out` (Lc ids); returns the new length.
__device__ int apply_change(const int *doc, const int L, const Ch c,
                            int *out, const Scratch s, const int Lc,
                            const int Pc, unsigned *red) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int b = t; b <= Lc; b += T) {
    if (b < Lc)
      s.dex[b + 1] = max(c.del[b], (int)(c.mid[b] > 0)) * (int)(b < L);
    else
      s.dex[0] = 0;
    s.bcum[b] = c.ins[b] * (int)(b <= L);
  }
  for (int i = t; i < Lc; i += T) out[i] = 0;
  __syncthreads();
  int *const arrs[2] = {s.dex, s.bcum};
  const unsigned bad = block_scan<2>(arrs, Lc + 1, red);
  const bool mono = !(bad & 2u);
  const int total = s.bcum[Lc];
  const int new_L = wadd(wsub(L, s.dex[Lc]), total);
  for (int i = t; i < Lc; i += T) {
    if (i < L && max(c.del[i], (int)(c.mid[i] > 0)) == 0) {
      const int sp = wadd(wsub(i, s.dex[i]), s.bcum[i]);
      if (sp >= 0 && sp < Lc) atomicAdd(&out[sp], doc[i]);
    }
  }
  for (int k = t; k < Pc; k += T) {
    if (k < total) {
      const int b = count_leq(s.bcum, Lc + 1, k, mono);
      const int ip = wadd(wsub(b, s.dex[clampi(b, 0, Lc)]), k);
      if (ip >= 0 && ip < Lc) {
        int v = c.ids[k];
        const int pm = c.pmid[k];
        if (pm > 0) {
          // A move-in atom pulls the value its tag detached.
          const int po = c.poff[k];
          unsigned acc = 0;
          for (int j = 0; j < L && j < Lc; ++j)
            if (c.mid[j] == pm && c.moff[j] == po) acc += (unsigned)doc[j];
          v = (int)acc;
        }
        atomicAdd(&out[ip], v);
      }
    }
  }
  __syncthreads();
  return new_L;
}

// Where a kernel's two regions live: in dynamic shared memory or in the
// document's slice of the workspace, at an int offset.
struct Place {
  long long work_ints;  // per document
  long long ring_off, rest_off;
  int ring_g, rest_g;
};

struct TrunkArgs {
  const int *doc_in, *L_in, *del, *ins, *ids, *mid, *moff, *pmid, *poff,
      *ref, *seq;
  int *doc_out, *L_out, *err_out, *work;
  int C, Lc, Pc, W;
  Place pl;
};

extern __shared__ int tree_smem[];

__global__ void __launch_bounds__(MAX_THREADS)
    trunk_scan_kernel(const TrunkArgs a) {
  __shared__ unsigned red[RED_WORDS];
  const int n = blockIdx.x, T = blockDim.x, t = threadIdx.x;
  const int C = a.C, Lc = a.Lc, Pc = a.Pc, W = a.W;
  const int E = 4 * Lc + 1 + 3 * Pc;
  int *const gw = a.work ? a.work + (size_t)n * a.pl.work_ints : nullptr;
  int *const ring = (a.pl.ring_g ? gw : tree_smem) + a.pl.ring_off;
  int *const ring_L = ring + (size_t)W * E;
  int *const ring_seq = ring_L + W;
  int *p = (a.pl.rest_g ? gw : tree_smem) + a.pl.rest_off;
  int *cur = p;
  p += E;
  int *nxt = p;
  p += E;
  int *doc = p;
  p += Lc;
  int *dout = p;
  p += Lc;
  Scratch s;
  s.dex = p;
  p += Lc + 1;
  s.bcum = p;
  p += Lc + 1;
  s.cbcum = p;
  p += Lc + 1;
  s.tpos = p;
  p += Lc;
  s.kpos = p;
  p += Pc;
  s.kb = p;
  p += Pc;
  s.klive = p;
  p += Pc;
  s.kcum = p;

  const size_t dn = (size_t)n * Lc;
  for (int i = t; i < Lc; i += T) doc[i] = a.doc_in[dn + i];
  for (int w = t; w < W; w += T) {  // seq 0 = an empty slot
    ring_L[w] = 0;
    ring_seq[w] = 0;
  }
  int L = a.L_in[n], err = 0, max_ev = 0;
  __syncthreads();
  for (int k = 0; k < C; ++k) {
    const size_t ck = (size_t)n * C + k;
    const int ref = a.ref[ck];
    // Ring-window guard: an evicted entry with seq > ref would be skipped.
    if (ref < max_ev && max_ev > 0) err = 1;
    {
      const Ch c = change_at(cur, Lc, Pc);
      for (int i = t; i < Lc; i += T) {
        c.del[i] = a.del[ck * Lc + i];
        c.mid[i] = a.mid[ck * Lc + i];
        c.moff[i] = a.moff[ck * Lc + i];
      }
      for (int b = t; b <= Lc; b += T) c.ins[b] = a.ins[ck * (Lc + 1) + b];
      for (int j = t; j < Pc; j += T) {
        c.ids[j] = a.ids[ck * Pc + j];
        c.pmid[j] = a.pmid[ck * Pc + j];
        c.poff[j] = a.poff[ck * Pc + j];
      }
    }
    __syncthreads();
    // Fold over the ring oldest -> newest (slot k % W is the oldest); an
    // inactive entry leaves the change as it is.
    for (int j = 0; j < W; ++j) {
      const int w = (k + j) % W;
      const int sw = ring_seq[w];
      if (sw > ref && sw > 0) {
        rebase(change_at(cur, Lc, Pc), change_at(ring + (size_t)w * E, Lc, Pc),
               ring_L[w], change_at(nxt, Lc, Pc), E, s, Lc, Pc, red);
        int *const tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
    const int new_L =
        apply_change(doc, L, change_at(cur, Lc, Pc), dout, s, Lc, Pc, red);
    // Push (c, L, seq) over the oldest slot; record the evicted seq.
    const int slot = k % W;
    max_ev = max(max_ev, ring_seq[slot]);
    __syncthreads();
    int *const e = ring + (size_t)slot * E;
    for (int j = t; j < E; j += T) e[j] = cur[j];
    if (t == 0) {
      ring_L[slot] = L;
      ring_seq[slot] = a.seq[ck];
    }
    int *const tmp = doc;
    doc = dout;
    dout = tmp;
    L = new_L;
    __syncthreads();
  }
  for (int i = t; i < Lc; i += T) a.doc_out[dn + i] = doc[i];
  if (t == 0) {
    a.L_out[n] = L;
    a.err_out[n] = err;
  }
}

// -- T2: the EditManager ring scan ------------------------------------------

constexpr int ERR_RING_MISS = 1;
constexpr int ERR_CAPACITY = 2;
constexpr int ERR_MOVE_EVICTED = 4;

struct EmArgs {
  const int *ring_ids, *ring_L, *ring_seq, *mov0, *dm, *ic, *ii, *rs, *rl,
      *ro, *refs, *seqs, *mv;
  int *doc_out, *L_out, *err_out, *work;
  int C, Lc, Pc, W, R, U;
  Place pl;
};

__global__ void __launch_bounds__(MAX_THREADS)
    em_scan_kernel(const EmArgs a) {
  __shared__ unsigned red[RED_WORDS];
  // [0], [1]: "the commit moves" for even and odd commits; [2]: the run's
  // anchor slot (max); [3]: the anchor's position (sum).
  __shared__ int sc[4];
  const int n = blockIdx.x, T = blockDim.x, t = threadIdx.x;
  const int C = a.C, Lc = a.Lc, Pc = a.Pc, W = a.W, R = a.R, U = a.U;
  const int BW = (U + 31) >> 5;
  int *const gw = a.work ? a.work + (size_t)n * a.pl.work_ints : nullptr;
  int *const ring = (a.pl.ring_g ? gw : tree_smem) + a.pl.ring_off;
  int *const ring_L = ring + (size_t)W * Lc;
  int *const ring_seq = ring_L + W;
  int *p = (a.pl.rest_g ? gw : tree_smem) + a.pl.rest_off;
  unsigned *const bits = (unsigned *)p;
  p += BW;
  int *doc = p;
  p += Lc;
  int *dout = p;
  p += Lc;
  int *const post = p;
  p += Lc;
  int *const av = p;
  p += Lc;
  int *const det = p;
  p += Lc;
  int *const dex = p;
  p += Lc + 1;
  int *const bcum = p;

  const size_t rn = (size_t)n * W;
  for (size_t j = t; j < (size_t)W * Lc; j += T)
    ring[j] = a.ring_ids[rn * Lc + j];
  for (int w = t; w < W; w += T) {
    ring_L[w] = a.ring_L[rn + w];
    ring_seq[w] = a.ring_seq[rn + w];
  }
  // The carry starts as the ring's newest slot.
  for (int i = t; i < Lc; i += T)
    doc[i] = a.ring_ids[(rn + W - 1) * Lc + i];
  int L = a.ring_L[rn + W - 1], mov = a.mov0[n], err = 0;
  if (t == 0) {
    sc[0] = 0;
    sc[1] = 0;
  }
  __syncthreads();
  for (int k = 0; k < C; ++k) {
    const size_t ck = (size_t)n * C + k;
    const int ref = a.refs[ck];
    // 1. Author view at ref: the latest ring state with 0 <= seq <= ref,
    //    the hit slots summed (a miss reads an empty view).
    int best = -1;
    for (int w = 0; w < W; ++w) {
      const int sw = ring_seq[w];
      if (sw >= 0 && sw <= ref && sw > best) best = sw;
    }
    if (best < 0) {
      err |= ERR_RING_MISS;
      if (mov > ref) err |= ERR_MOVE_EVICTED;
    }
    unsigned acc_L = 0;
    for (int w = 0; w < W; ++w)
      if (best >= 0 && ring_seq[w] == best) acc_L += (unsigned)ring_L[w];
    const int av_L = (int)acc_L;
    int moves = 0;
    for (int i = t; i < Lc; i += T) {
      unsigned acc = 0;
      for (int w = 0; w < W; ++w)
        if (best >= 0 && ring_seq[w] == best)
          acc += (unsigned)ring[(size_t)w * Lc + i];
      av[i] = (int)acc;
      const int m = a.mv[ck * Lc + i];
      const int d = max(a.dm[ck * Lc + i], m);  // move-outs detach too
      moves |= m > 0;
      det[i] = d;
      dex[i + 1] = max(d, 0) * (int)(i < av_L);
      post[i] = 0;
    }
    for (int b = t; b <= Lc; b += T)
      bcum[b] = a.ic[ck * (Lc + 1) + b] * (int)(b <= av_L);
    for (int j = t; j < BW; j += T) bits[j] = 0u;
    if (t == 0) dex[0] = 0;
    if (moves) atomicOr(&sc[k & 1], 1);
    __syncthreads();
    int *const arrs[2] = {dex, bcum};
    const unsigned bad = block_scan<2>(arrs, Lc + 1, red);
    const bool mono = !(bad & 2u);
    const int total = bcum[Lc];
    // 2. Post view: the commit applied to the author view (no move lanes).
    // 3. The detached ids of the author view as a multihot over U.
    for (int i = t; i < Lc; i += T) {
      if (i < av_L) {
        if (det[i] <= 0) {
          const int sp = wadd(wsub(i, dex[i]), bcum[i]);
          if (sp >= 0 && sp < Lc) atomicAdd(&post[sp], av[i]);
        } else {
          const int id = av[i];
          if (id > 0 && id < U) atomicOr(&bits[id >> 5], 1u << (id & 31));
        }
      }
    }
    for (int j = t; j < Pc; j += T) {
      if (j < total) {
        const int b = count_leq(bcum, Lc + 1, j, mono);
        const int ip = wadd(wsub(b, dex[clampi(b, 0, Lc)]), j);
        if (ip >= 0 && ip < Lc) atomicAdd(&post[ip], a.ii[ck * Pc + j]);
      }
    }
    __syncthreads();
    //    Drop the detached ids from the trunk (a compaction).
    for (int i = t; i < Lc; i += T) {
      const int cd = (i < L && member(bits, doc[i], U)) ? 1 : 0;
      det[i] = cd;
      dex[i + 1] = cd;
      dout[i] = 0;
    }
    if (t == 0) dex[0] = 0;
    __syncthreads();
    int *const darr[1] = {dex};
    block_scan<1>(darr, Lc + 1, red);
    for (int i = t; i < Lc; i += T) {
      if (i < L && !det[i]) {
        const int sp = wsub(i, dex[i]);
        if (sp >= 0 && sp < Lc) atomicAdd(&dout[sp], doc[i]);
      }
    }
    int L2 = wsub(L, dex[Lc]);
    __syncthreads();
    int *cur = dout, *spare = doc;
    // 4. Attach runs in wire order, each after the nearest left post-view
    //    neighbour present in the evolving output. A run without slots or
    //    without ids changes nothing.
    for (int r = 0; r < R; ++r) {
      const size_t cr = ck * R + r;
      const int st = a.rs[cr], len = a.rl[cr], off = a.ro[cr];
      if (!(st >= 0 && len > 0)) continue;
      for (int j = t; j < BW; j += T) bits[j] = 0u;
      if (t == 0) {
        sc[2] = -1;
        sc[3] = 0;
      }
      __syncthreads();
      for (int i = t; i < Lc; i += T) {
        if (i < L2) {
          const int id = cur[i];
          if (id > 0 && id < U) atomicOr(&bits[id >> 5], 1u << (id & 31));
        }
      }
      __syncthreads();
      if (st > 0) {  // the cummax of present post-view slots at st - 1
        const int idx = min(st - 1, Lc - 1);
        int best_i = -1;
        for (int i = t; i <= idx; i += T)
          if (member(bits, post[i], U)) best_i = i;
        if (best_i >= 0) atomicMax(&sc[2], best_i);
      }
      for (int i = t; i < Lc; i += T) spare[i] = 0;
      __syncthreads();
      const int anchor_at = st > 0 ? sc[2] : -1;
      if (anchor_at >= 0) {
        const int anchor = post[clampi(anchor_at, 0, Lc - 1)];
        unsigned acc = 0;
        for (int i = t; i < Lc; i += T)
          if (i < L2 && cur[i] == anchor) acc += (unsigned)(i + 1);
        if (acc) atomicAdd((unsigned *)&sc[3], acc);
      }
      __syncthreads();
      // Insert `len` ids of the pool rotated by `off` at boundary p (after
      // the anchor), counted only where p is a boundary of the document.
      const int pb = anchor_at >= 0 ? sc[3] : 0;
      const bool inc = pb >= 0 && pb <= Lc && pb <= L2;
      const int v = inc ? len : 0;
      for (int i = t; i < Lc; i += T) {
        if (i < L2) {
          const int sp = (inc && i >= pb) ? wadd(i, v) : i;
          if (sp >= 0 && sp < Lc) atomicAdd(&spare[sp], cur[i]);
        }
      }
      for (int j = t; j < Pc; j += T) {
        if (j < v) {
          const int ip = wadd(pb, j);
          if (ip >= 0 && ip < Lc)
            atomicAdd(&spare[ip], a.ii[ck * Pc + floor_mod(wadd(j, off), Pc)]);
        }
      }
      L2 = wadd(L2, v);
      __syncthreads();
      int *const tmp = cur;
      cur = spare;
      spare = tmp;
    }
    // 5. Capacity. 6. Push the new trunk state over the oldest slot; the
    //    watermark remembers the newest move-bearing commit.
    if (L2 > Lc) err |= ERR_CAPACITY;
    const int slot = k % W;
    for (int i = t; i < Lc; i += T) ring[(size_t)slot * Lc + i] = cur[i];
    const int sq = a.seqs[ck];
    if (sc[k & 1]) mov = sq;
    if (t == 0) {
      ring_L[slot] = L2;
      ring_seq[slot] = sq;
      sc[(k + 1) & 1] = 0;  // read last by commit k - 1, before a barrier
    }
    doc = cur;
    dout = spare;
    L = L2;
    __syncthreads();
  }
  for (int i = t; i < Lc; i += T) a.doc_out[(size_t)n * Lc + i] = doc[i];
  if (t == 0) {
    a.L_out[n] = L;
    a.err_out[n] = err;
  }
}

// -- host side --------------------------------------------------------------

long long trunk_entry_ints(int Lc, int Pc) { return 4LL * Lc + 1 + 3LL * Pc; }

long long trunk_ring_ints(int Lc, int Pc, int W) {
  return (long long)W * trunk_entry_ints(Lc, Pc) + 2LL * W;
}

long long trunk_rest_ints(int Lc, int Pc) {
  return 2 * trunk_entry_ints(Lc, Pc) + 2LL * Lc + 3LL * (Lc + 1) + Lc +
         4LL * Pc;
}

long long em_ring_ints(int Lc, int W) { return (long long)W * Lc + 2LL * W; }

long long em_rest_ints(int Lc, int U) {
  return (U + 31LL) / 32 + 5LL * Lc + 2LL * (Lc + 1);
}

// The placement of the two regions on a tier; false where the tier cannot
// take them.
bool place(long long ring, long long rest, int tier, Place *pl,
           long long *smem) {
  *pl = Place{};
  if (tier == T_SHARED) {
    pl->rest_off = ring;
    *smem = 4 * (ring + rest);
    return *smem <= SMEM_BYTES;
  }
  if (tier != T_GLOBAL) return false;
  pl->ring_g = 1;
  if (4 * rest <= SMEM_BYTES) {
    pl->work_ints = ring;
    *smem = 4 * rest;
  } else {
    pl->rest_g = 1;
    pl->rest_off = ring;
    pl->work_ints = ring + rest;
    *smem = 0;
  }
  return true;
}

int threads_for(int Lc) {
  int t = MIN_THREADS;
  while (t < Lc && t < MAX_THREADS) t <<= 1;
  return t;
}

bool shapes_ok(int n_docs, int C, int Lc, int Pc, int W) {
  return n_docs >= 1 && C >= 0 && Lc >= 1 && Lc <= MAX_LC && Pc >= 1 &&
         Pc <= MAX_PC && W >= 1 && W <= MAX_W;
}

template <typename Kern, typename Args>
int launch_tree(Kern kern, const Args &a, int n_docs, int threads,
                long long smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n_docs, threads, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each scan launches on `stream` and returns cudaGetLastError() (0 = ok).
// `tier`: 0 shared, 1 global; the global tier takes a device buffer of
// n_docs * tree_*_work_ints(...) int32 at `work` (NULL otherwise). Inputs
// are not modified.

int tree_trunk_scan(const int *doc_in, const int *L_in, const int *del,
                    const int *ins, const int *ids, const int *mid,
                    const int *moff, const int *pmid, const int *poff,
                    const int *ref, const int *seq, int *doc_out, int *L_out,
                    int *err_out, int *work, int n_docs, int C, int Lc,
                    int Pc, int W, int tier, void *stream) {
  if (!shapes_ok(n_docs, C, Lc, Pc, W)) return (int)cudaErrorInvalidValue;
  TrunkArgs a{doc_in, L_in, del, ins, ids, mid, moff, pmid, poff, ref, seq,
              doc_out, L_out, err_out, work, C, Lc, Pc, W, Place{}};
  long long smem;
  if (!place(trunk_ring_ints(Lc, Pc, W), trunk_rest_ints(Lc, Pc), tier,
             &a.pl, &smem) ||
      (a.pl.work_ints > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_tree(trunk_scan_kernel, a, n_docs, threads_for(Lc), smem,
                     (cudaStream_t)stream);
}

int tree_em_ring_scan(const int *ring_ids, const int *ring_L,
                      const int *ring_seq, const int *mov_seq0,
                      const int *dm, const int *ic, const int *ii,
                      const int *rs, const int *rl, const int *ro,
                      const int *refs, const int *seqs, const int *mv,
                      int *doc_out, int *L_out, int *err_out, int *work,
                      int n_docs, int C, int Lc, int Pc, int W, int R, int U,
                      int tier, void *stream) {
  if (!shapes_ok(n_docs, C, Lc, Pc, W) || R < 0 || R > MAX_R || U < 1 ||
      U > MAX_U)
    return (int)cudaErrorInvalidValue;
  EmArgs a{ring_ids, ring_L, ring_seq, mov_seq0, dm, ic, ii, rs, rl, ro,
           refs, seqs, mv, doc_out, L_out, err_out, work, C, Lc, Pc, W, R, U,
           Place{}};
  long long smem;
  if (!place(em_ring_ints(Lc, W), em_rest_ints(Lc, U), tier, &a.pl, &smem) ||
      (a.pl.work_ints > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_tree(em_scan_kernel, a, n_docs, threads_for(Lc), smem,
                     (cudaStream_t)stream);
}

// Per-document workspace ints and dynamic shared memory bytes of a tier
// (-1 where the tier cannot take the shape).
long long tree_trunk_work_ints(int Lc, int Pc, int W, int tier) {
  Place pl;
  long long smem;
  return place(trunk_ring_ints(Lc, Pc, W), trunk_rest_ints(Lc, Pc), tier,
               &pl, &smem) ? pl.work_ints : -1;
}

long long tree_trunk_smem_bytes(int Lc, int Pc, int W, int tier) {
  Place pl;
  long long smem;
  return place(trunk_ring_ints(Lc, Pc, W), trunk_rest_ints(Lc, Pc), tier,
               &pl, &smem) ? smem : -1;
}

long long tree_em_work_ints(int Lc, int W, int U, int tier) {
  Place pl;
  long long smem;
  return place(em_ring_ints(Lc, W), em_rest_ints(Lc, U), tier, &pl, &smem)
             ? pl.work_ints : -1;
}

long long tree_em_smem_bytes(int Lc, int W, int U, int tier) {
  Place pl;
  long long smem;
  return place(em_ring_ints(Lc, W), em_rest_ints(Lc, U), tier, &pl, &smem)
             ? smem : -1;
}

long long tree_smem_budget(void) { return SMEM_BYTES; }

const char *tree_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
