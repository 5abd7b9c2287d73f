// SharedTree rebase scans and changeset algebra for Hopper (sm_90a), bound
// to Python through a plain C interface.
//
// Replaces the reference package's two jitted device scans of the
// SharedTree rebase path (XLA programs, not pl.pallas_call sites), and the
// four jitted entry points of its dense changeset algebra, A1-A4 (see their
// section below):
//   T1  fluidframework_tpu/tree/device_trunk.py:161 batched_trunk_scan
//       (jit over vmap of a lax.scan; the W-deep ring fold a fori_loop)
//   T2  fluidframework_tpu/tree/device_em.py:129    batched_em_trunk_scan_ring
//       (jit over vmap of a lax.scan; a fori_loop over the R attach runs,
//       an associative_scan cummax)
// The reference compiles each dispatch into one device program; here each
// dispatch is one launch, the document's whole C-commit stream inside it.
//
// The dense IR (ops/tree_kernel.py) as device functions: _prefix and
// _pool_positions become two or three prefix sums in one pass, _apply
// (apply_change) and rebase_change (c_after=False, the only form the scans
// use) become phases of strided loops over the Lc slots, Lc + 1 boundaries
// and Pc pool atoms. Every transport keeps the plain version's semantics,
// so the result matches it bit for bit in every int32 lane: a position
// outside [0, size) is dropped; several writers to one slot sum (atomicAdd
// on ints: order-free, so exact); a gather outside the range reads 0; sums
// and prefix sums wrap as int32; multihots drop ids outside [0, U) and
// never hold id 0; output slots past Lc are dropped while L still counts
// them. The attach pool's boundary of atom k (#{b : bcum[b] <= k}) is a
// binary search when the prefix sum came out non-decreasing (the scan
// reports it) and a count otherwise.
//
// Layout (int32, C-contiguous, the plain versions' lanes):
//   T1  doc_ids [N, Lc], L [N]; commit lanes del/mid/moff [N, C, Lc],
//       ins [N, C, Lc+1], ids/pmid/poff [N, C, Pc], ref/seq [N, C];
//       out doc_ids [N, Lc], L [N], err [N].
//   T2  ring_ids [N, W, Lc], ring_L/ring_seq [N, W], mov_seq0 [N]; commit
//       lanes dm/mv [N, C, Lc], ic [N, C, Lc+1], ii [N, C, Pc],
//       rs/rl/ro [N, C, R], refs/seqs [N, C]; out as T1.
//
// What bounds them. The work per commit is O(W * (Lc + Pc)) int ops for T1
// (one rebase per active ring entry) and O(Lc + R * Lc) for T2, and the
// bytes are the commit lanes read once: at the scans' batch sizes the card
// is far from both peaks (T1 at config 3b: 39x its byte floor on the CTA
// tiers, 15x on the warp tier). Each commit depends on the one before, so
// the time is the commit loop's latency. clock64() stamps (the repository's
// tools/tree_scan_profile.py) put a CTA's waits at __syncthreads at 2-4% of
// its cycles: the phases' own chains of shared-memory accesses, the
// commit's lane loads (19-28%) and a second wave of CTAs (as long as the
// first at configs 3b and 3c) take the time. The warp tier answers those:
// a document on one warp, so 8 share an SM and 1,024 run in one wave; the
// next commit's lanes staged while the current one computes; T1's newest
// ring entries cached in the slice. A warp is slower than a CTA on a lone
// wide document, so tree_scan_kernel.tier gives it a launch only where the
// CTA tiers would fill the card. Tensor cores do not apply: the work is
// int32 prefix sums, scatters and compares with wrap-around; there is no
// product for wgmma, and int8 MMA cannot hold int32 sums exactly.
//
// Tiers. Each kernel's per-document state is two regions: the ring (T1:
// W changesets of 4 Lc + 1 + 3 Pc ints plus L and seq; T2: W states of Lc
// ids plus L and seq) and the rest (the incoming change, the document, the
// prefix sums and pool scratch; T2 also its multihot bitset of U bits).
//   - warp: one warp a document, D documents a CTA (each in its own slice
//     of the dynamic shared memory), so a phase ends at a __syncwarp and no
//     block barrier runs in the commit loop. Prefix sums are warp scans
//     (per-lane chunk sums and __shfl_up_sync; the non-decreasing flag a
//     __reduce_or_sync), the move loops warp-cooperative (each lane tests
//     its own slots or atoms, __ballot_sync picks the atoms or slots to
//     resolve and __reduce_add_sync / __any_sync combine, in the same
//     wrap-around int32 sums), T2's anchor cummax and anchor position warp
//     reductions. The next commit's lanes are staged into a second buffer
//     of the slice by cp.async while the current one computes (4 bytes a
//     copy: the lanes' rows of Lc + 1, Pc and R ints are not 16-byte
//     aligned in general, and 16-byte copies into a padded layout measured
//     slower). The ring lies in the slice (ring_g 0) or in the document's
//     workspace (ring_g 1); there T1 keeps its newest entries in the slice
//     too, stages each older entry it folds while the one before folds,
//     and T2 stages the author view it reads.
//   - shared: one CTA a document, both regions in dynamic shared memory (up
//     to SMEM_BYTES, the 227 KB a CTA may opt in to less this file's static
//     shared memory), every phase closed by __syncthreads.
//   - global: as shared, with the ring in a per-document slice of a device
//     workspace the wrapper allocates (read again every commit, so it stays
//     in L2 at the batch sizes the scans run), the rest in shared memory if
//     it fits and in the workspace after the ring otherwise. Every access
//     goes through a generic pointer, so one body of code serves both CTA
//     tiers, and __syncthreads orders the global accesses of the block as
//     it does the shared ones.
// The CTA tiers skip inactive ring entries and empty runs (a uniform branch
// per CTA; the plain version computes them and selects), as the warp tier
// does per warp.

#include <cuda_runtime.h>
#include <stddef.h>

// Phase stamps of the algebra kernels A2 and A4: empty here;
// tools/tree_scan_profile.py --algebra defines them in its copy of this file
// (clock64() stamps by thread 0 of a CTA or lane 0 of a warp, each closing
// phase j).
#ifndef ALG_PHASE
#define ALG_PHASE(j)
#define ALG_PROF_BEGIN
#define ALG_PROF_END(n, who)
#endif

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
// The warp tier, its ring in the slice or in the workspace.
constexpr int T_WARP = 2;
constexpr int T_WARP_RING_G = 3;
// Documents (warps) a CTA of the warp tier holds at most.
constexpr int WARP_MAX_D = 8;
// Ring entries T1's warp tier caches in the slice at most, with its ring in
// the workspace.
constexpr int WARP_CACHE_MAX = 8;
constexpr unsigned FULL = 0xffffffffu;
// block_scan's scratch: 32 partial sums for each of up to 3 arrays, then
// the flag word at a fixed slot, so scans of different widths never race.
constexpr int SCAN_ARRAYS = 3;
constexpr int RED_WORDS = 32 * SCAN_ARRAYS + 1;
// CtaGroup::offsets' scratch in red: each warp's K totals at SCAN_ARRAYS
// words a warp, then each warp's flags from GROUP_FLAGS.
constexpr int GROUP_FLAGS = SCAN_ARRAYS * (MAX_THREADS / 32);

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

// rebase_change(c, o, L, C_AFTER) into `out` (4 Lc + 1 + 3 Pc ints, none
// aliasing c or o). Phases: the prefix sums of o's detaches (dex, the
// exclusive Dex_b), o's attaches (bcum) and c's attaches (cbcum); o's pool
// positions and c's atom boundaries through o's boundary map; every input
// slot's landing position in o's output (tpos) and c's dead move atoms;
// the live atoms' new pool slots; the scatters. The scans take C_AFTER =
// false; true (c sequenced after o) puts c's attaches after o's at a
// boundary and cancels c's moves of units o moved too (o's move wins): the
// move-out is dropped and its move-in atoms with it.
template <bool C_AFTER>
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
  ALG_PHASE(1);
  int *const arrs[3] = {s.dex, s.bcum, s.cbcum};
  const unsigned bad = block_scan<3>(arrs, Lc + 1, red);
  ALG_PHASE(2);
  const bool o_mono = !(bad & 2u), c_mono = !(bad & 4u);
  const int o_total = s.bcum[Lc], c_total = s.cbcum[Lc];
  for (int k = t; k < Pc; k += T) {
    const int ob = count_leq(s.bcum, Lc + 1, k, o_mono);
    s.kpos[k] = wadd(wsub(ob, s.dex[clampi(ob, 0, Lc)]), k);
    // b_map at the atom's boundary: b - Dex_b + (bcum - icnt) of o
    // (C_AFTER: + bcum).
    const int cb = clampi(count_leq(s.cbcum, Lc + 1, k, c_mono), 0, Lc);
    const int oicnt = C_AFTER ? 0 : o.ins[cb] * (int)(cb <= L);
    s.kb[k] = wsub(wadd(wsub(cb, s.dex[cb]), s.bcum[cb]), oicnt);
  }
  __syncthreads();
  ALG_PHASE(3);
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
  ALG_PHASE(4);
  for (int k = t; k < Pc; k += T) {
    // A move-in atom of c dies when o deleted its source slot (C_AFTER:
    // or moved it).
    bool dead = false;
    const int pm = c.pmid[k];
    if (pm > 0) {
      const int po = c.poff[k];
      for (int i = 0; i < L && i < Lc && !dead; ++i)
        dead = c.mid[i] == pm && c.moff[i] == po &&
               ((C_AFTER && o.mid[i] > 0) || o.del[i] > 0);
    }
    const int live = (!dead && k < c_total) ? 1 : 0;
    s.klive[k] = live;
    s.kcum[k] = live;
  }
  __syncthreads();
  ALG_PHASE(5);
  int *const karr[1] = {s.kcum};
  block_scan<1>(karr, Pc, red);
  ALG_PHASE(6);
  for (int i = t; i < Lc; i += T) {
    const int tp = s.tpos[i];
    if (i < L && tp >= 0 && tp < Lc) {
      if (c.del[i] > 0) atomicAdd(&out.del[tp], c.del[i]);
      // C_AFTER: o's move wins, c's move-out of the unit is dropped.
      if (c.mid[i] > 0 && !(C_AFTER && o.mid[i] > 0)) {
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
  ALG_PHASE(7);
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
// document's slice of the workspace, at an int offset. The warp tier gives
// each of its `docs` documents a `slice` of shared-memory ints (the rest,
// and the ring unless ring_g).
struct Place {
  long long work_ints;  // per document
  long long ring_off, rest_off;
  int ring_g, rest_g;
  long long slice;
  int docs;   // documents a CTA: 1 on the CTA tiers
  int cache;  // T1's warp tier: the newest ring entries kept in the slice
};

struct TrunkArgs {
  const int *doc_in, *L_in, *del, *ins, *ids, *mid, *moff, *pmid, *poff,
      *ref, *seq;
  int *doc_out, *L_out, *err_out, *work;
  int N, C, Lc, Pc, W;
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
        rebase<false>(change_at(cur, Lc, Pc),
                      change_at(ring + (size_t)w * E, Lc, Pc), ring_L[w],
                      change_at(nxt, Lc, Pc), E, s, Lc, Pc, red);
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
  int N, C, Lc, Pc, W, R, U;
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

// -- the warp tier: one warp a document -------------------------------------

// Asynchronous 4-byte copies from device memory into shared memory
// (cp.async): the next commit's lanes, and with the ring in the workspace
// the next ring entry, land while the warp computes. 4 bytes a copy: the
// lanes' rows (Lc + 1, Pc and R ints) are not 16-byte aligned in general.
__device__ __forceinline__ void cp_async4(int *smem, const int *gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest copy groups are in
// flight (0 or 1).
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying n ints from src to the slice at dst, lane j taking ints j,
// j + 32, ... (the mapping every writer of the ring uses too, so a lane
// re-reads what it wrote itself).
__device__ __forceinline__ void stage(int *dst, const int *src, int n,
                                      int lane) {
  for (int j = lane; j < n; j += 32) cp_async4(dst + j, src + j);
}

// block_scan for one warp over its slice: inclusive int32 prefix sums of K
// arrays of n ints in place; bit q set where array q did not come out
// non-decreasing. Each lane sums a contiguous chunk, the chunk totals are
// scanned with shuffles, each chunk is rewritten from its offset. Ends with
// __syncwarp.
template <int K>
__device__ unsigned warp_scan(int *const (&a)[K], int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) >> 5;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  unsigned s[K], run[K];
#pragma unroll
  for (int q = 0; q < K; ++q) s[q] = 0;
  for (int j = lo; j < hi; ++j) {
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] += (unsigned)a[q][j];
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    unsigned v = s[q];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v += y;
    }
    run[q] = v - s[q];
  }
  unsigned bad = 0;
  int prev[K];
#pragma unroll
  for (int q = 0; q < K; ++q) prev[q] = (int)run[q];
  for (int j = lo; j < hi; ++j) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      run[q] += (unsigned)a[q][j];
      if (j > 0 && (int)run[q] < prev[q]) bad |= 1u << q;
      prev[q] = (int)run[q];
      a[q][j] = (int)run[q];
    }
  }
  __syncwarp();
  return __reduce_or_sync(FULL, bad);
}

// rebase() for one warp, in both tie forms: the same phases with __syncwarp
// between them. The landing position of each of o's slots is scattered as
// soon as it is known; a slot that o moved takes the sum of its move tag's
// live atoms, every lane summing its own atoms. A move-in atom of c dies
// where o deleted its source slot, every lane testing its own slots. T1's
// warp kernel takes C_AFTER = false, A2's warp tier both.
template <bool C_AFTER>
__device__ void rebase_w(const Ch c, const Ch o, const int L, const Ch out,
                         const int E, const Scratch s, const int Lc,
                         const int Pc) {
  const int lane = threadIdx.x & 31;
  for (int b = lane; b <= Lc; b += 32) {
    if (b < Lc)
      s.dex[b + 1] = max(o.del[b], (int)(o.mid[b] > 0)) * (int)(b < L);
    else
      s.dex[0] = 0;
    s.bcum[b] = o.ins[b] * (int)(b <= L);
    s.cbcum[b] = c.ins[b] * (int)(b <= L);
  }
  for (int j = lane; j < E; j += 32) out.del[j] = 0;  // the whole output
  __syncwarp();
  ALG_PHASE(1);
  int *const arrs[3] = {s.dex, s.bcum, s.cbcum};
  const unsigned bad = warp_scan<3>(arrs, Lc + 1);
  ALG_PHASE(2);
  const bool o_mono = !(bad & 2u), c_mono = !(bad & 4u);
  const int o_total = s.bcum[Lc], c_total = s.cbcum[Lc];
  for (int k = lane; k < Pc; k += 32) {
    const int ob = count_leq(s.bcum, Lc + 1, k, o_mono);
    s.kpos[k] = wadd(wsub(ob, s.dex[clampi(ob, 0, Lc)]), k);
    // b_map at the atom's boundary: b - Dex_b + (bcum - icnt) of o
    // (C_AFTER: + bcum).
    const int cb = clampi(count_leq(s.cbcum, Lc + 1, k, c_mono), 0, Lc);
    const int oicnt = C_AFTER ? 0 : o.ins[cb] * (int)(cb <= L);
    s.kb[k] = wsub(wadd(wsub(cb, s.dex[cb]), s.bcum[cb]), oicnt);
  }
  __syncwarp();
  ALG_PHASE(3);
  for (int i0 = 0; i0 < Lc; i0 += 32) {
    const int i = i0 + lane;
    const bool ov = i < Lc && i < L;
    int tp = -1;
    bool moved = false;
    if (ov) {
      const int om = o.mid[i];
      if (max(o.del[i], (int)(om > 0)) == 0)
        tp = wadd(wsub(i, s.dex[i]), s.bcum[i]);
      else
        moved = om > 0;
    }
    for (unsigned pend = __ballot_sync(FULL, moved); pend;
         pend &= pend - 1) {
      const int src = __ffs(pend) - 1;
      const int mi = o.mid[i0 + src], mo = o.moff[i0 + src];
      unsigned acc = 0;
      for (int k = lane; k < Pc && k < o_total; k += 32)
        if (o.pmid[k] == mi && o.poff[k] == mo) acc += (unsigned)s.kpos[k];
      const unsigned tot = __reduce_add_sync(FULL, acc);
      if (lane == src) tp = (int)tot;
    }
    if (ov && tp >= 0 && tp < Lc) {
      if (c.del[i] > 0) atomicAdd(&out.del[tp], c.del[i]);
      // C_AFTER: o's move wins, c's move-out of the unit is dropped.
      if (c.mid[i] > 0 && !(C_AFTER && o.mid[i] > 0)) {
        atomicAdd(&out.mid[tp], c.mid[i]);
        atomicAdd(&out.moff[tp], c.moff[i]);
      }
    }
  }
  ALG_PHASE(4);
  for (int k0 = 0; k0 < Pc; k0 += 32) {
    const int k = k0 + lane;
    const int pm = k < Pc ? c.pmid[k] : 0;
    bool dead = false;
    for (unsigned pend = __ballot_sync(FULL, pm > 0); pend;
         pend &= pend - 1) {
      // A move-in atom of c dies when o deleted its source slot (C_AFTER:
      // or moved it).
      const int src = __ffs(pend) - 1;
      const int pms = c.pmid[k0 + src], pos = c.poff[k0 + src];
      bool hit = false;
      for (int i = lane; i < L && i < Lc; i += 32)
        hit |= c.mid[i] == pms && c.moff[i] == pos &&
               ((C_AFTER && o.mid[i] > 0) || o.del[i] > 0);
      const bool any = __any_sync(FULL, hit);
      if (lane == src) dead = any;
    }
    if (k < Pc) {
      const int live = (!dead && k < c_total) ? 1 : 0;
      s.klive[k] = live;
      s.kcum[k] = live;
    }
  }
  __syncwarp();
  ALG_PHASE(5);
  int *const karr[1] = {s.kcum};
  warp_scan<1>(karr, Pc);
  ALG_PHASE(6);
  for (int k = lane; k < Pc; k += 32) {
    if (s.klive[k]) {
      const int b = s.kb[k];
      if (b >= 0 && b <= Lc) atomicAdd(&out.ins[b], 1);
      const int g = s.kcum[k] - 1;  // live atoms keep their order
      out.ids[g] = c.ids[k];
      out.pmid[g] = c.pmid[k];
      out.poff[g] = c.poff[k];
    }
  }
  __syncwarp();
  ALG_PHASE(7);
}

// apply_change() for one warp; a move-in atom's value is summed by every
// lane over its own slots.
__device__ int apply_w(const int *doc, const int L, const Ch c, int *out,
                       const Scratch s, const int Lc, const int Pc) {
  const int lane = threadIdx.x & 31;
  for (int b = lane; b <= Lc; b += 32) {
    if (b < Lc)
      s.dex[b + 1] = max(c.del[b], (int)(c.mid[b] > 0)) * (int)(b < L);
    else
      s.dex[0] = 0;
    s.bcum[b] = c.ins[b] * (int)(b <= L);
  }
  for (int i = lane; i < Lc; i += 32) out[i] = 0;
  __syncwarp();
  int *const arrs[2] = {s.dex, s.bcum};
  const unsigned bad = warp_scan<2>(arrs, Lc + 1);
  const bool mono = !(bad & 2u);
  const int total = s.bcum[Lc];
  const int new_L = wadd(wsub(L, s.dex[Lc]), total);
  for (int i = lane; i < Lc; i += 32) {
    if (i < L && max(c.del[i], (int)(c.mid[i] > 0)) == 0) {
      const int sp = wadd(wsub(i, s.dex[i]), s.bcum[i]);
      if (sp >= 0 && sp < Lc) atomicAdd(&out[sp], doc[i]);
    }
  }
  for (int k0 = 0; k0 < Pc; k0 += 32) {
    const int k = k0 + lane;
    int ip = -1, v = 0, pm = 0;
    if (k < Pc && k < total) {
      const int b = count_leq(s.bcum, Lc + 1, k, mono);
      ip = wadd(wsub(b, s.dex[clampi(b, 0, Lc)]), k);
      v = c.ids[k];
      pm = c.pmid[k];
    }
    const bool ok = ip >= 0 && ip < Lc;
    for (unsigned pend = __ballot_sync(FULL, ok && pm > 0); pend;
         pend &= pend - 1) {
      // A move-in atom pulls the value its tag detached.
      const int src = __ffs(pend) - 1;
      const int pms = c.pmid[k0 + src], pos = c.poff[k0 + src];
      unsigned acc = 0;
      for (int j = lane; j < L && j < Lc; j += 32)
        if (c.mid[j] == pms && c.moff[j] == pos) acc += (unsigned)doc[j];
      const unsigned tot = __reduce_add_sync(FULL, acc);
      if (lane == src) v = (int)tot;
    }
    if (ok) atomicAdd(&out[ip], v);
  }
  __syncwarp();
  return new_L;
}

// Start staging commit k of document n into `dst` (a changeset, then ref
// and seq at E and E + 1) as one copy group.
__device__ void stage_trunk_commit(const TrunkArgs &a, int *dst, int n,
                                   int k, int E, int lane) {
  const int Lc = a.Lc, Pc = a.Pc;
  const size_t ck = (size_t)n * a.C + k;
  const Ch d = change_at(dst, Lc, Pc);
  stage(d.del, a.del + ck * Lc, Lc, lane);
  stage(d.ins, a.ins + ck * (Lc + 1), Lc + 1, lane);
  stage(d.ids, a.ids + ck * Pc, Pc, lane);
  stage(d.mid, a.mid + ck * Lc, Lc, lane);
  stage(d.moff, a.moff + ck * Lc, Lc, lane);
  stage(d.pmid, a.pmid + ck * Pc, Pc, lane);
  stage(d.poff, a.poff + ck * Pc, Pc, lane);
  if (lane == 0) {
    cp_async4(dst + E, a.ref + ck);
    cp_async4(dst + E + 1, a.seq + ck);
  }
  cp_async_commit();
}

// Ring slot (oldest + j) mod W, for 0 <= oldest, j < W.
__device__ __forceinline__ int ring_slot(int oldest, int j, int W) {
  const int w = oldest + j;
  return w < W ? w : w - W;
}

// The first ring position j >= j0 (oldest first from slot `oldest`) whose
// entry the commit folds: seq > ref and the slot not empty. W when none.
__device__ __forceinline__ int next_active(const int *ring_seq, int oldest,
                                           int j0, int W, int ref) {
  for (int j = j0, w = ring_slot(oldest, j0, W); j < W; ++j) {
    const int sw = ring_seq[w];
    if (sw > ref && sw > 0) return j;
    if (++w == W) w = 0;
  }
  return W;
}

// T1 on the warp tier. A document's slice: [the ring, unless in the
// workspace] ring_L [W] ring_seq [W], three changeset buffers of E + 2 ints
// (the current change, the rebase output, the next commit being staged),
// [with the ring in the workspace: two staged ring entries and the newest
// `cache` entries, E ints each], the document and its next state [Lc]
// each, dex/bcum/cbcum [Lc + 1] each, kpos/kb/klive/kcum [Pc] each. A
// commit folds the entries newer than its ref, mostly the newest few (at
// config 3b 1.6 a commit, 92% of them among the newest 5), so the cache
// serves most folds from the slice and the rest are staged from the
// workspace, the next while the current one folds.
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    trunk_warp_kernel(const TrunkArgs a) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.pl.docs + wid;
  if (n >= a.N) return;
  const int C = a.C, Lc = a.Lc, Pc = a.Pc, W = a.W;
  const int E = 4 * Lc + 1 + 3 * Pc;
  const bool ring_g = a.pl.ring_g;
  int *p = tree_smem + (size_t)wid * a.pl.slice;
  int *ring;
  if (ring_g) {
    ring = a.work + (size_t)n * a.pl.work_ints;
  } else {
    ring = p;
    p += (size_t)W * E;
  }
  int *const ring_L = p;
  p += W;
  int *const ring_seq = p;
  p += W;
  int *cur = p;
  p += E + 2;
  int *nxt = p;
  p += E + 2;
  int *stg = p;
  p += E + 2;
  int *ob = p, *ob_next = p + E;  // the staged ring entries
  const int M = a.pl.cache;
  int *const cache = p + 2 * E;
  if (ring_g) p += (size_t)(2 + M) * E;
  int *doc = p;
  p += Lc;
  int *dout = p;
  p += Lc;
  Scratch s;
  s.tpos = nullptr;
  s.dex = p;
  p += Lc + 1;
  s.bcum = p;
  p += Lc + 1;
  s.cbcum = p;
  p += Lc + 1;
  s.kpos = p;
  p += Pc;
  s.kb = p;
  p += Pc;
  s.klive = p;
  p += Pc;
  s.kcum = p;

  const size_t dn = (size_t)n * Lc;
  stage(doc, a.doc_in + dn, Lc, lane);
  if (C > 0) stage_trunk_commit(a, cur, n, 0, E, lane);
  else cp_async_commit();
  for (int w = lane; w < W; w += 32) {  // seq 0 = an empty slot
    ring_L[w] = 0;
    ring_seq[w] = 0;
  }
  int L = a.L_in[n], err = 0, max_ev = 0;
  // slot = k % W, the oldest entry and the one commit k overwrites; cslot =
  // k % M, the cache slot commit k's entry takes.
  for (int k = 0, slot = 0, cslot = 0; k < C; ++k) {
    cp_async_wait(0);
    __syncwarp();  // commit k's lanes are in `cur`
    const int ref = cur[E], seq = cur[E + 1];
    if (k + 1 < C) stage_trunk_commit(a, stg, n, k + 1, E, lane);
    // Ring-window guard: an evicted entry with seq > ref would be skipped.
    if (ref < max_ev && max_ev > 0) err = 1;
    // Fold over the ring oldest -> newest (slot k % W is the oldest); an
    // inactive entry leaves the change as it is.
    if (!ring_g) {
      for (int j = 0; j < W; ++j) {
        const int w = ring_slot(slot, j, W);
        const int sw = ring_seq[w];
        if (sw > ref && sw > 0) {
          rebase_w<false>(change_at(cur, Lc, Pc),
                   change_at(ring + (size_t)w * E, Lc, Pc), ring_L[w],
                   change_at(nxt, Lc, Pc), E, s, Lc, Pc);
          int *const tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }
    } else {
      // Position j holds the entry of commit k - W + j (an active entry was
      // pushed, so it is >= 0), a = W - 1 - j commits old: the newest M lie
      // in the cache at (k - 1 - a) mod M; each older active entry is
      // staged into `ob` while the one before it folds.
      const int last_g = W - 1 - M;
      int j = next_active(ring_seq, slot, 0, W, ref);
      if (j <= last_g) {
        stage(ob, ring + (size_t)ring_slot(slot, j, W) * E, E, lane);
        cp_async_commit();
      }
      while (j < W) {
        const int jn = next_active(ring_seq, slot, j + 1, W, ref);
        int *o;
        if (j <= last_g) {
          if (jn <= last_g) {
            stage(ob_next, ring + (size_t)ring_slot(slot, jn, W) * E, E,
                  lane);
            cp_async_commit();
          }
          cp_async_wait(jn <= last_g);
          __syncwarp();
          o = ob;
          ob = ob_next;
          ob_next = o;
        } else {
          const int c = cslot - 1 - (W - 1 - j);  // > -M - 1
          o = cache + (size_t)(c < 0 ? c + M : c) * E;
        }
        rebase_w<false>(change_at(cur, Lc, Pc), change_at(o, Lc, Pc),
                 ring_L[ring_slot(slot, j, W)], change_at(nxt, Lc, Pc), E, s,
                 Lc, Pc);
        int *const tmp = cur;
        cur = nxt;
        nxt = tmp;
        j = jn;
      }
    }
    const int new_L = apply_w(doc, L, change_at(cur, Lc, Pc), dout, s, Lc,
                              Pc);
    // Push (c, L, seq) over the oldest slot; record the evicted seq.
    max_ev = max(max_ev, ring_seq[slot]);
    __syncwarp();
    int *const e = ring + (size_t)slot * E;
    int *const ce = M > 0 ? cache + (size_t)cslot * E : nullptr;
    for (int j = lane; j < E; j += 32) {
      const int v = cur[j];
      e[j] = v;
      if (ce) ce[j] = v;
    }
    if (lane == 0) {
      ring_L[slot] = L;
      ring_seq[slot] = seq;
    }
    int *const tmp = doc;
    doc = dout;
    dout = tmp;
    L = new_L;
    // The staged commit becomes the current change; the two others free.
    int *const fa = cur;
    cur = stg;
    stg = nxt;
    nxt = fa;
    if (++slot == W) slot = 0;
    if (M > 0 && ++cslot == M) cslot = 0;
    __syncwarp();
  }
  cp_async_wait(0);
  __syncwarp();
  for (int i = lane; i < Lc; i += 32) a.doc_out[dn + i] = doc[i];
  if (lane == 0) {
    a.L_out[n] = L;
    a.err_out[n] = err;
  }
}

// Start staging commit k of document n into `dst` (the layout of
// em_warp_kernel's commit buffers) as one copy group.
__device__ void stage_em_commit(const EmArgs &a, int *dst, int n, int k,
                                int lane) {
  const int Lc = a.Lc, Pc = a.Pc, R = a.R;
  const size_t ck = (size_t)n * a.C + k;
  stage(dst, a.dm + ck * Lc, Lc, lane);
  stage(dst + Lc, a.mv + ck * Lc, Lc, lane);
  stage(dst + 2 * Lc, a.ic + ck * (Lc + 1), Lc + 1, lane);
  int *const q = dst + 3 * Lc + 1;
  stage(q, a.ii + ck * Pc, Pc, lane);
  stage(q + Pc, a.rs + ck * R, R, lane);
  stage(q + Pc + R, a.rl + ck * R, R, lane);
  stage(q + Pc + 2 * R, a.ro + ck * R, R, lane);
  if (lane == 0) {
    cp_async4(q + Pc + 3 * R, a.refs + ck);
    cp_async4(q + Pc + 3 * R + 1, a.seqs + ck);
  }
  cp_async_commit();
}

// T2 on the warp tier. A document's slice: [the ring, W states of Lc ids,
// unless in the workspace] ring_L [W] ring_seq [W], the bitset
// [(U + 31) / 32], the trunk state and its next [Lc] each, post [Lc], the
// author view [Lc], dex/bcum [Lc + 1] each, two commit buffers (the
// current commit, the next being staged) of dm [Lc] mv [Lc] ic [Lc + 1]
// ii [Pc] rs/rl/ro [R] ref seq. A ring in the workspace holds only pushed
// states, each staged into the author view when it is the one the commit
// reads.
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    em_warp_kernel(const EmArgs a) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.pl.docs + wid;
  if (n >= a.N) return;
  const int C = a.C, Lc = a.Lc, Pc = a.Pc, W = a.W, R = a.R, U = a.U;
  const int BW = (U + 31) >> 5;
  const int S = 3 * Lc + 1 + Pc + 3 * R + 2;
  const bool ring_g = a.pl.ring_g;
  int *p = tree_smem + (size_t)wid * a.pl.slice;
  int *ring;
  if (ring_g) {
    ring = a.work + (size_t)n * a.pl.work_ints;
  } else {
    ring = p;
    p += (size_t)W * Lc;
  }
  int *const ring_L = p;
  p += W;
  int *const ring_seq = p;
  p += W;
  unsigned *const bits = (unsigned *)p;
  p += BW;
  int *doc = p;
  p += Lc;
  int *dout = p;
  p += Lc;
  int *const post = p;
  p += Lc;
  int *const avb = p;
  p += Lc;
  int *const dex = p;
  p += Lc + 1;
  int *const bcum = p;
  p += Lc + 1;
  int *cm = p, *cm_next = p + S;  // the current and the next commit

  // The initial ring and the carry (the ring's newest slot) are staged
  // with commit 0. A ring in the workspace holds only pushed states: slot w
  // is read from ring_ids until commit w overwrites it.
  const size_t rn = (size_t)n * W;
  const int *const ring0 = a.ring_ids + rn * Lc;
  if (!ring_g) stage(ring, ring0, W * Lc, lane);
  stage(ring_L, a.ring_L + rn, W, lane);
  stage(ring_seq, a.ring_seq + rn, W, lane);
  stage(doc, ring0 + (size_t)(W - 1) * Lc, Lc, lane);
  if (C > 0) stage_em_commit(a, cm, n, 0, lane);
  else cp_async_commit();
  int L = a.ring_L[rn + W - 1], mov = a.mov0[n], err = 0;
  for (int k = 0; k < C; ++k) {
    cp_async_wait(0);
    __syncwarp();  // commit k's lanes are in cm
    const int *const cdm = cm;
    const int *const cmv = cdm + Lc;
    const int *const cic = cdm + 2 * Lc;
    const int *const cii = cdm + 3 * Lc + 1;
    const int *const crs = cii + Pc;
    const int *const crl = crs + R;
    const int *const cro = crl + R;
    const int ref = cro[R], sq = cro[R + 1];
    // 1. Author view at ref: the latest ring state with 0 <= seq <= ref,
    //    the hit slots summed (a miss reads an empty view).
    int best = -1;
    for (int w = lane; w < W; w += 32) {
      const int sw = ring_seq[w];
      if (sw >= 0 && sw <= ref && sw > best) best = sw;
    }
    best = __reduce_max_sync(FULL, best);
    unsigned acc_L = 0, hits = 0;
    int hw = -1;
    for (int w = lane; w < W; w += 32) {
      if (best >= 0 && ring_seq[w] == best) {
        acc_L += (unsigned)ring_L[w];
        ++hits;
        hw = w;
      }
    }
    const int av_L = (int)__reduce_add_sync(FULL, acc_L);
    hits = __reduce_add_sync(FULL, hits);
    hw = __reduce_max_sync(FULL, hw);
    if (best < 0) {
      err |= ERR_RING_MISS;
      if (mov > ref) err |= ERR_MOVE_EVICTED;
    }
    const int *av = avb;
    bool staged = false;
    if (hits == 1 && !ring_g) {
      av = ring + (size_t)hw * Lc;
    } else if (hits == 1) {
      stage(avb, (hw < k ? ring : ring0) + (size_t)hw * Lc, Lc, lane);
      cp_async_commit();
      staged = true;
    } else {
      for (int i = lane; i < Lc; i += 32) {
        unsigned acc = 0;
        for (int w = 0; w < W; ++w)
          if (best >= 0 && ring_seq[w] == best)
            acc += (unsigned)(ring_g && w >= k ? ring0 : ring)[
                (size_t)w * Lc + i];
        avb[i] = (int)acc;
      }
    }
    if (k + 1 < C) stage_em_commit(a, cm_next, n, k + 1, lane);
    bool mv_any = false;
    for (int i = lane; i < Lc; i += 32) {
      const int m = cmv[i];
      const int d = max(cdm[i], m);  // move-outs detach too
      mv_any |= m > 0;
      dex[i + 1] = max(d, 0) * (int)(i < av_L);
      post[i] = 0;
    }
    for (int b = lane; b <= Lc; b += 32) bcum[b] = cic[b] * (int)(b <= av_L);
    for (int j = lane; j < BW; j += 32) bits[j] = 0u;
    if (lane == 0) dex[0] = 0;
    const bool moves = __any_sync(FULL, mv_any);
    if (staged) cp_async_wait(k + 1 < C);
    __syncwarp();
    int *const arrs[2] = {dex, bcum};
    const unsigned bad = warp_scan<2>(arrs, Lc + 1);
    const bool mono = !(bad & 2u);
    const int total = bcum[Lc];
    // 2. Post view: the commit applied to the author view (no move lanes).
    // 3. The detached ids of the author view as a multihot over U.
    for (int i = lane; i < Lc; i += 32) {
      if (i < av_L) {
        if (max(cdm[i], cmv[i]) <= 0) {
          const int sp = wadd(wsub(i, dex[i]), bcum[i]);
          if (sp >= 0 && sp < Lc) atomicAdd(&post[sp], av[i]);
        } else {
          const int id = av[i];
          if (id > 0 && id < U) atomicOr(&bits[id >> 5], 1u << (id & 31));
        }
      }
    }
    for (int j = lane; j < Pc; j += 32) {
      if (j < total) {
        const int b = count_leq(bcum, Lc + 1, j, mono);
        const int ip = wadd(wsub(b, dex[clampi(b, 0, Lc)]), j);
        if (ip >= 0 && ip < Lc) atomicAdd(&post[ip], cii[j]);
      }
    }
    __syncwarp();
    //    Drop the detached ids from the trunk (a compaction).
    for (int i = lane; i < Lc; i += 32) {
      dex[i + 1] = (i < L && member(bits, doc[i], U)) ? 1 : 0;
      dout[i] = 0;
    }
    if (lane == 0) dex[0] = 0;
    __syncwarp();
    int *const darr[1] = {dex};
    warp_scan<1>(darr, Lc + 1);
    for (int i = lane; i < Lc; i += 32) {
      if (i < L && !member(bits, doc[i], U)) {
        const int sp = wsub(i, dex[i]);
        if (sp >= 0 && sp < Lc) atomicAdd(&dout[sp], doc[i]);
      }
    }
    int L2 = wsub(L, dex[Lc]);
    __syncwarp();
    int *cur = dout, *spare = doc;
    // 4. Attach runs in wire order, each after the nearest left post-view
    //    neighbour present in the evolving output. A run without slots or
    //    without ids changes nothing.
    for (int r = 0; r < R; ++r) {
      const int st = crs[r], len = crl[r], off = cro[r];
      if (!(st >= 0 && len > 0)) continue;
      for (int j = lane; j < BW; j += 32) bits[j] = 0u;
      __syncwarp();
      for (int i = lane; i < Lc; i += 32) {
        if (i < L2) {
          const int id = cur[i];
          if (id > 0 && id < U) atomicOr(&bits[id >> 5], 1u << (id & 31));
        }
      }
      __syncwarp();
      int anchor_at = -1;
      if (st > 0) {  // the cummax of present post-view slots at st - 1
        const int idx = min(st - 1, Lc - 1);
        int best_i = -1;
        for (int i = lane; i <= idx; i += 32)
          if (member(bits, post[i], U)) best_i = i;
        anchor_at = __reduce_max_sync(FULL, best_i);
      }
      int pb = 0;
      if (anchor_at >= 0) {
        const int anchor = post[clampi(anchor_at, 0, Lc - 1)];
        unsigned acc = 0;
        for (int i = lane; i < Lc; i += 32)
          if (i < L2 && cur[i] == anchor) acc += (unsigned)(i + 1);
        pb = (int)__reduce_add_sync(FULL, acc);
      }
      for (int i = lane; i < Lc; i += 32) spare[i] = 0;
      __syncwarp();
      // Insert `len` ids of the pool rotated by `off` at boundary p (after
      // the anchor), counted only where p is a boundary of the document.
      const bool inc = pb >= 0 && pb <= Lc && pb <= L2;
      const int v = inc ? len : 0;
      for (int i = lane; i < Lc; i += 32) {
        if (i < L2) {
          const int sp = (inc && i >= pb) ? wadd(i, v) : i;
          if (sp >= 0 && sp < Lc) atomicAdd(&spare[sp], cur[i]);
        }
      }
      for (int j = lane; j < Pc; j += 32) {
        if (j < v) {
          const int ip = wadd(pb, j);
          if (ip >= 0 && ip < Lc)
            atomicAdd(&spare[ip], cii[floor_mod(wadd(j, off), Pc)]);
        }
      }
      L2 = wadd(L2, v);
      __syncwarp();
      int *const tmp = cur;
      cur = spare;
      spare = tmp;
    }
    // 5. Capacity. 6. Push the new trunk state over the oldest slot; the
    //    watermark remembers the newest move-bearing commit.
    if (L2 > Lc) err |= ERR_CAPACITY;
    const int slot = k % W;
    for (int i = lane; i < Lc; i += 32) ring[(size_t)slot * Lc + i] = cur[i];
    if (moves) mov = sq;
    if (lane == 0) {
      ring_L[slot] = L2;
      ring_seq[slot] = sq;
    }
    doc = cur;
    dout = spare;
    L = L2;
    int *const tmp = cm;
    cm = cm_next;
    cm_next = tmp;
    __syncwarp();
  }
  cp_async_wait(0);
  __syncwarp();
  for (int i = lane; i < Lc; i += 32) a.doc_out[(size_t)n * Lc + i] = doc[i];
  if (lane == 0) {
    a.L_out[n] = L;
    a.err_out[n] = err;
  }
}

// -- A1-A4: the changeset algebra -------------------------------------------
//
// The reference's four jitted entry points of the dense algebra,
// fluidframework_tpu/ops/tree_kernel.py:587-592 (jit over vmap of
// apply_change :238, rebase_change :258, invert_change :339 and
// compose_change :382; XLA programs, not pl.pallas_call sites), each one
// launch: a group of threads a document (a CTA, or a warp on the warp tier)
// reads its input lanes (rows of any stride), runs the device function and
// writes every output lane. rebase is the device function T1 runs (its tie
// form as C_AFTER, on the warp tier rebase_w); apply, invert and compose
// are below, each one body for every tier over a thread group (CtaGroup,
// WarpGroup), with the transport semantics of this file's header (T1 keeps
// its own apply_change and apply_w).
//
// What bounds them. A document is O(Lc + Pc) int ops of prefix sums and
// scatters, the move-effect tables' tag searches (O(Lc * Pc) compares at
// most, only for move-bearing slots and atoms) and compose's rank (below);
// the bytes are the lanes read and written once, 1-2 us at the main
// shapes. A call is a wave of documents, each a chain of phases: latency,
// as for T1. The design answers the chain's links:
//   - the inputs: rebase's and compose's 15 rows arrive as one group of
//     4-byte cp.async copies into shared memory, waited on once, so the
//     rows' latencies overlap instead of queueing behind each other's
//     stores (the global tier reads them where they lie: take_row). TMA
//     does not fit: the rows are Lc + 1 and Pc ints at any row stride (a
//     lane sliced out of a commit batch), so they are not 16-byte aligned.
//     apply and invert stage nothing: each thread loads its own chunk of
//     the slots and boundaries into registers, a batch of loads in flight
//     at once, and two passes over the chunk replace the staged copy, the
//     fill, the block scan and the store (apply_alg, invert_alg);
//   - the barriers: on the warp tier a document is one warp, up to
//     WARP_MAX_D a CTA, each in its own slice of the dynamic shared memory,
//     its phases closed by __syncwarp;
//   - the tag searches: a move tag's sum over the pool atoms or slots is
//     warp-cooperative (each lane its own atoms, __ballot_sync picks the
//     slots to resolve, __reduce_add_sync / __any_sync combine, in the same
//     wrap-around int32 sums), in compose on every tier, in rebase_w;
//     apply's live move-in atoms record their positions and every warp
//     sums its slots' values by tag into them, one add a warp (apply_alg);
//   - compose's rank, below.
//
// Tiers: warp as above; shared, one CTA a document, the region in dynamic
// shared memory up to SMEM_BYTES; global, the region in the document's
// slice of a workspace the wrapper allocates. Each CTA kernel is
// instantiated once a tier.
//
// Compose's attach pool is one stable sort of Lc + 2 Pc candidate keys of
// which the first Pc are kept: each live candidate (key < BIG = Lc + 2 Pc +
// 2) takes its stable rank #{j : key_j < key_i} + #{j < i : key_j == key_i}
// and, where that is below Pc, the pool slot of that rank. A negative key
// (only where a detach lane holds more than 1) takes that comparison count
// over every candidate. The others are counted: a histogram of the live
// keys in [0, BIG) and its scan give the keys below each key. One warp
// then walks the candidates in index order, 32 at a time: __match_any_sync
// groups a chunk's equal keys, a candidate's rank is n_neg + (keys below
// its key) + cursor[key] + its peers in lower lanes, and the group's lowest
// lane advances cursor[key] by the group's size; (Lc + 2 Pc) / 32 steps and
// no order-dependent atomics, where a comparison count takes (Lc + 2 Pc)^2
// / T compares a thread (on the global tier cursor[] lives in the
// workspace, each step a round trip to L2). An atom's anchor, the gap
// after the last in-place unit before it, is a binary search over the
// in-place units compacted in input order where their output positions
// came out non-decreasing (every well-formed change), a max over them
// otherwise.

constexpr int A_APPLY = 0;
constexpr int A_REBASE = 1;
constexpr int A_INVERT = 2;
constexpr int A_COMPOSE = 3;
// Input and output lanes of an entry at most: two changes and L in, a
// change and compose's overflow flag out.
constexpr int ALG_IN = 15;
constexpr int ALG_OUT = 8;

struct AlgArgs {
  const int *in[ALG_IN];
  long long st[ALG_IN];  // each input lane's row stride, in ints
  int *out[ALG_OUT];     // C-contiguous [N, width] lanes ([N]: L, overflow)
  int *work;
  long long work_ints;  // a document's slice of the workspace (global tier)
  long long slice;      // a document's shared-memory ints (warp tier)
  int N, Lc, Pc;
  int docs;  // documents a CTA: 1 on the CTA tiers
};

// A CTA-tier document's region: the dynamic shared memory, or on the global
// tier its slice of the workspace. Each CTA kernel is instantiated per tier
// (GLOBAL), so the shared tier's accesses compile as shared-memory ones.
template <bool GLOBAL>
__device__ __forceinline__ int *alg_region(const AlgArgs &a) {
  return GLOBAL ? a.work + (size_t)blockIdx.x * a.work_ints : tree_smem;
}

// How A2 and A4 take their input rows: staged into shared memory by 4-byte
// cp.async copies (the caller commits and waits for them), or read where
// they lie (the global tier; the device functions only read their inputs).
enum Take { TAKE_ASYNC, TAKE_IN_PLACE };

// Document n's row of input lane q (w ints), taken `how`; a staged row
// lands in the region at p, p moving past it.
__device__ __forceinline__ int *take_row(const AlgArgs &a, int q, int w,
                                         int n, int *&p, Take how, int t,
                                         int T) {
  const int *const src = a.in[q] + (long long)n * a.st[q];
  if (how == TAKE_IN_PLACE) return const_cast<int *>(src);
  int *const dst = p;
  for (int j = t; j < w; j += T) cp_async4(dst + j, src + j);
  p += w;
  return dst;
}

// A change's seven lanes from input lanes q0 .. q0 + 6 (take_row), staged
// back to back in change_at's order.
__device__ __forceinline__ Ch take_change(const AlgArgs &a, int q0, int n,
                                          int Lc, int Pc, int *&p,
                                          Take how, int t, int T) {
  Ch d;
  d.del = take_row(a, q0, Lc, n, p, how, t, T);
  d.ins = take_row(a, q0 + 1, Lc + 1, n, p, how, t, T);
  d.ids = take_row(a, q0 + 2, Pc, n, p, how, t, T);
  d.mid = take_row(a, q0 + 3, Lc, n, p, how, t, T);
  d.moff = take_row(a, q0 + 4, Lc, n, p, how, t, T);
  d.pmid = take_row(a, q0 + 5, Pc, n, p, how, t, T);
  d.poff = take_row(a, q0 + 6, Pc, n, p, how, t, T);
  return d;
}

__device__ __forceinline__ int load_int(const AlgArgs &a, int q, int n) {
  return a.in[q][(long long)n * a.st[q]];
}

// Wait for this thread's copies; the caller's barrier then publishes them.
__device__ __forceinline__ void loads_landed() {
  cp_async_commit();
  cp_async_wait(0);
}

// w ints of src into document n's row of output lane q.
__device__ __forceinline__ void store_row(const AlgArgs &a, int q,
                                          const int *src, int w, int n,
                                          int t, int T) {
  int *const dst = a.out[q] + (size_t)n * w;
  for (int j = t; j < w; j += T) dst[j] = src[j];
}

__device__ __forceinline__ void store_change(const AlgArgs &a, const Ch s,
                                             int Lc, int Pc, int n, int t,
                                             int T) {
  store_row(a, 0, s.del, Lc, n, t, T);
  store_row(a, 1, s.ins, Lc + 1, n, t, T);
  store_row(a, 2, s.ids, Pc, n, t, T);
  store_row(a, 3, s.mid, Lc, n, t, T);
  store_row(a, 4, s.moff, Lc, n, t, T);
  store_row(a, 5, s.pmid, Pc, n, t, T);
  store_row(a, 6, s.poff, Pc, n, t, T);
}

// The threads that compute one document: a CTA (block barriers,
// block_scan) or one warp of a warp-tier CTA (__syncwarp, warp_scan). t and
// T: the thread's index in the group and the group's size; wid: the warp's
// index in the group. sync_or: a barrier that also returns the OR of p
// over the group. offsets: the exclusive prefix sums of K per-thread
// chunk sums over the group in thread order and their totals, with int32
// wrap-around (warp shuffles; on a CTA the warps' totals cross one block
// barrier, and every warp scans them itself), returning the OR of `flags`
// over the group; it orders every memory access the group made before it.
// Called once a kernel (a CTA reuses red's words).
struct CtaGroup {
  int t, T, wid;
  unsigned *red;
  __device__ void sync() const { __syncthreads(); }
  __device__ bool sync_or(bool p) const { return __syncthreads_or(p); }
  template <int K>
  __device__ unsigned scan(int *const (&x)[K], int n) const {
    return block_scan<K>(x, n, red);
  }
  template <int K>
  __device__ unsigned offsets(const unsigned (&s)[K], unsigned (&off)[K],
                              unsigned (&tot)[K], unsigned flags) const {
    const int lane = t & 31, nw = (T + 31) >> 5;
    unsigned incl[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      unsigned v = s[q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += y;
      }
      incl[q] = v;
      if (lane == 31) red[wid * SCAN_ARRAYS + q] = v;
    }
    flags = __reduce_or_sync(FULL, flags);
    if (lane == 0) red[GROUP_FLAGS + wid] = flags;
    __syncthreads();
    flags = __reduce_or_sync(FULL, lane < nw ? red[GROUP_FLAGS + lane] : 0u);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      unsigned w = lane < nw ? red[lane * SCAN_ARRAYS + q] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += y;
      }
      const unsigned below = __shfl_sync(FULL, w, (wid + 31) & 31);
      tot[q] = __shfl_sync(FULL, w, 31);
      off[q] = (wid > 0 ? below : 0u) + incl[q] - s[q];
    }
    return flags;
  }
};

struct WarpGroup {
  int t, T, wid;
  __device__ void sync() const { __syncwarp(); }
  __device__ bool sync_or(bool p) const {
    __syncwarp();
    return __any_sync(FULL, p);
  }
  template <int K>
  __device__ unsigned scan(int *const (&x)[K], int n) const {
    return warp_scan<K>(x, n);
  }
  template <int K>
  __device__ unsigned offsets(const unsigned (&s)[K], unsigned (&off)[K],
                              unsigned (&tot)[K], unsigned flags) const {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < K; ++q) {
      unsigned v = s[q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, v, d);
        if (t >= d) v += y;
      }
      tot[q] = __shfl_sync(FULL, v, 31);
      off[q] = v - s[q];
    }
    return __reduce_or_sync(FULL, flags);
  }
};

// The move tags of the warp's slots i0 + lane whose bit is set in `pend`
// resolved warp-cooperatively: for each, the wrap-around sum of vals[k]
// over the pool atoms k < n_atoms with that tag, every lane summing its own
// atoms; the slot's own lane takes the sum in place of r.
__device__ __forceinline__ int tag_sums(unsigned pend, const int *mid,
                                        const int *moff, int i0,
                                        const int *pmid, const int *poff,
                                        const int *vals, int n_atoms, int r) {
  const int lane = threadIdx.x & 31;
  for (; pend; pend &= pend - 1) {
    const int src = __ffs(pend) - 1;
    const int mi = mid[i0 + src], mo = moff[i0 + src];
    unsigned acc = 0;
    for (int k = lane; k < n_atoms; k += 32)
      if (pmid[k] == mi && poff[k] == mo) acc += (unsigned)vals[k];
    const unsigned tot = __reduce_add_sync(FULL, acc);
    if (lane == src) r = (int)tot;
  }
  return r;
}

struct ComposeScratch {
  int *adex, *abcum, *bdex, *bbcum;  // [Lc + 1]; adex later icnt
  int *apos, *bpos, *slot;           // [Pc]
  int *iq, *o2q, *cidx, *cq2;        // [Lc]; iq first p1
  int *key;                          // [Lc + 2 Pc]
  int *pos;                          // [BIG + 1]
  int *sc;                           // [3]
};

// compose_change(a, b, L) into `out` (4 Lc + 1 + 3 Pc ints, contiguous) by
// the group g; returns the overflow flag. Phases: a's prefix
// sums; a's pool positions and b's prefix sums over a's output (length La);
// b's pool positions; every unit's position in a's output (p1) and every
// position of a's output in b's (o2q), through the move-effect tables; each
// unit's fate (q2, its position in b's output), the in-place ones' q2 (iq,
// -1 for the others) and the candidate keys; the in-place units compacted,
// the live and negative keys counted and histogrammed; the histogram's
// scan; the ranks; the pool and its anchors.
template <class G>
__device__ int compose(const G g, const Ch a, const Ch b, const int L,
                       const Ch out, const int E, const ComposeScratch s,
                       const int Lc, const int Pc) {
  const int t = g.t, T = g.T, lane = threadIdx.x & 31;
  const int NC = Lc + 2 * Pc, BIG = NC + 2;
  for (int q = t; q <= Lc; q += T) {
    if (q < Lc)
      s.adex[q + 1] = max(a.del[q], (int)(a.mid[q] > 0)) * (int)(q < L);
    else
      s.adex[0] = 0;
    s.abcum[q] = a.ins[q] * (int)(q <= L);
  }
  for (int j = t; j < E; j += T) out.del[j] = 0;  // the whole output change
  for (int v = t; v <= BIG; v += T) s.pos[v] = 0;
  if (t < 3) s.sc[t] = 0;  // live candidates, negative keys, "not monotone"
  g.sync();
  ALG_PHASE(1);
  int *const aa[2] = {s.adex, s.abcum};
  const bool a_mono = !(g.template scan<2>(aa, Lc + 1) & 2u);
  ALG_PHASE(2);
  const int a_total = s.abcum[Lc];
  const int La = wadd(wsub(L, s.adex[Lc]), a_total);
  for (int k = t; k < Pc; k += T) {
    const int ab = count_leq(s.abcum, Lc + 1, k, a_mono);
    s.apos[k] = wadd(wsub(ab, s.adex[clampi(ab, 0, Lc)]), k);
  }
  for (int q = t; q <= Lc; q += T) {
    if (q < Lc)
      s.bdex[q + 1] = max(b.del[q], (int)(b.mid[q] > 0)) * (int)(q < La);
    else
      s.bdex[0] = 0;
    s.bbcum[q] = b.ins[q] * (int)(q <= La);
  }
  g.sync();
  ALG_PHASE(3);
  int *const ba[2] = {s.bdex, s.bbcum};
  const bool b_mono = !(g.template scan<2>(ba, Lc + 1) & 2u);
  ALG_PHASE(4);
  const int b_total = s.bbcum[Lc];
  for (int m = t; m < Pc; m += T) {
    const int bq = count_leq(s.bbcum, Lc + 1, m, b_mono);
    s.bpos[m] = wadd(wsub(bq, s.bdex[clampi(bq, 0, Lc)]), m);
  }
  g.sync();
  ALG_PHASE(5);
  // A kept slot goes to its survivor position, a moved one to the sum of
  // its tag's live move-in atoms' positions, any other to -1; each warp
  // takes 32 slots at a time.
  const int a_atoms = min(Pc, a_total), b_atoms = min(Pc, b_total);
  for (int i0 = g.wid * 32; i0 < Lc; i0 += T) {
    const int i = i0 + lane;
    int p = -1, o2 = -1;
    bool am = false, bm = false;
    if (i < Lc && i < L) {
      const int m = a.mid[i];
      if (max(a.del[i], (int)(m > 0)) == 0)
        p = wadd(wsub(i, s.adex[i]), s.abcum[i]);
      else
        am = m > 0;
    }
    if (i < Lc && i < La) {
      const int m = b.mid[i];
      if (max(b.del[i], (int)(m > 0)) == 0)
        o2 = wadd(wsub(i, s.bdex[i]), s.bbcum[i]);
      else
        bm = m > 0;
    }
    p = tag_sums(__ballot_sync(FULL, am), a.mid, a.moff, i0, a.pmid, a.poff,
                 s.apos, a_atoms, p);
    o2 = tag_sums(__ballot_sync(FULL, bm), b.mid, b.moff, i0, b.pmid, b.poff,
                  s.bpos, b_atoms, o2);
    if (i < Lc) {
      s.iq[i] = p;
      s.o2q[i] = o2;
    }
  }
  g.sync();
  ALG_PHASE(6);
  // A unit's fate: q2 = its position in b's output (-1 dead, -2 where a put
  // it past Lc). In place where a and b both kept it; a composed move (key
  // q2) where it lives elsewhere; a delete where it died. a's insert atoms
  // land where b put their position, b's at their own.
  for (int i = t; i < Lc; i += T) {
    const int p = s.iq[i];
    const bool in = p >= 0 && p < Lc;
    const int q2 = p < 0 ? -1 : (in ? s.o2q[p] : -2);
    const bool valid = i < L, alive = valid && q2 >= 0;
    const bool inplace = alive && max(a.del[i], (int)(a.mid[i] > 0)) == 0 &&
                         in && p < La &&
                         max(b.del[p], (int)(b.mid[p] > 0)) == 0;
    out.del[i] = (int)(valid && !alive);
    s.key[i] = alive && !inplace ? q2 : BIG;
    s.iq[i] = inplace ? q2 : -1;
    s.adex[i + 1] = (int)inplace;  // icnt
  }
  if (t == 0) s.adex[0] = 0;
  for (int k = t; k < Pc; k += T) {
    int key = BIG;
    if (k < a_total && a.pmid[k] == 0) {
      const int ap = s.apos[k];
      const int o2 = ap >= 0 && ap < Lc ? s.o2q[ap] : -2;
      if (o2 >= 0) key = o2;
    }
    s.key[Lc + k] = key;
    s.key[Lc + Pc + k] = k < b_total && b.pmid[k] == 0 ? s.bpos[k] : BIG;
  }
  g.sync();
  ALG_PHASE(7);
  int *const ia[1] = {s.adex};
  g.template scan<1>(ia, Lc + 1);
  ALG_PHASE(8);
  const int n_in = s.adex[Lc];
  // The in-place units in input order (cidx) with their q2 (cq2); the live
  // candidates and the negative keys among them counted, the others
  // histogrammed one slot up (pos[v + 1]: the keys equal to v).
  for (int i = t; i < Lc; i += T) {
    const int q2 = s.iq[i];
    if (q2 >= 0) {
      const int c = s.adex[i + 1] - 1;
      s.cidx[c] = i;
      s.cq2[c] = q2;
    }
  }
  int live = 0, neg = 0;
  for (int j = t; j < NC; j += T) {
    const int kj = s.key[j];
    if (kj < BIG) {
      ++live;
      if (kj < 0)
        ++neg;
      else
        atomicAdd(&s.pos[kj + 1], 1);
    }
  }
  live = __reduce_add_sync(FULL, live);
  neg = __reduce_add_sync(FULL, neg);
  if (lane == 0) {
    if (live) atomicAdd(&s.sc[0], live);
    if (neg) atomicAdd(&s.sc[1], neg);
  }
  g.sync();
  ALG_PHASE(9);
  bool unsorted = false;
  for (int c = t + 1; c < n_in; c += T) unsorted |= s.cq2[c - 1] > s.cq2[c];
  if (__any_sync(FULL, unsorted) && lane == 0) s.sc[2] = 1;
  const int n_live = s.sc[0], n_neg = s.sc[1];
  int *const ha[1] = {s.pos};
  g.template scan<1>(ha, BIG + 1);  // pos[v]: the live keys in [0, v)
  ALG_PHASE(10);
  if (n_neg > 0) {
    for (int j = t; j < NC; j += T) {
      const int kj = s.key[j];
      if (kj >= 0) continue;
      int r = 0;
      for (int l = 0; l < NC; ++l) {
        const int kl = s.key[l];
        r += kl < kj || (kl == kj && l < j);
      }
      if (r < Pc) s.slot[r] = j;
    }
  }
  if (g.wid == 0 && n_neg < Pc) {
    // One warp walks the candidates in index order; pos[v] counts on as
    // the cursor of key v.
    const unsigned below = (1u << lane) - 1;
    for (int j0 = 0; j0 < NC; j0 += 32) {
      const int j = j0 + lane;
      const int kj = j < NC ? s.key[j] : BIG;
      const bool ranked = kj >= 0 && kj < BIG;
      const unsigned peers = __match_any_sync(FULL, ranked ? kj : -1);
      const int lead = __ffs(peers) - 1;
      int base = 0;
      if (ranked && lane == lead) {
        base = s.pos[kj];
        s.pos[kj] = base + __popc(peers);
      }
      base = __shfl_sync(FULL, base, lead);
      if (ranked) {
        const int r = n_neg + base + __popc(peers & below);
        if (r < Pc) s.slot[r] = j;
      }
      __syncwarp();
    }
  }
  g.sync();
  ALG_PHASE(11);
  // Pool slot k holds the rank-k candidate: a unit (a composed move with
  // the fresh tag k + 1, its input slot moved out under it) or an insert
  // atom (its id). Each atom counts at its anchor boundary: a binary search
  // where the in-place units' q2 came out non-decreasing, else the max
  // over the in-place units, each warp taking its atoms and every lane its
  // own units.
  const bool mono = !s.sc[2];
  const int n_pool = min(Pc, n_live);
  for (int k = t; k < n_pool; k += T) {
    const int j = s.slot[k];
    if (j < Lc) {
      out.pmid[k] = k + 1;
      out.mid[j] = k + 1;
    } else {
      out.ids[k] = j < Lc + Pc ? a.ids[j - Lc] : b.ids[j - Lc - Pc];
    }
    if (mono) {
      const int pos = s.key[j];
      int lo = 0, hi = n_in;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (s.cq2[m] < pos) lo = m + 1;
        else hi = m;
      }
      atomicAdd(&out.ins[lo > 0 ? s.cidx[lo - 1] + 1 : 0], 1);
    }
  }
  if (!mono) {
    for (int k = g.wid; k < n_pool; k += T >> 5) {
      const int pos = s.key[s.slot[k]];
      int bnd = 0;
      for (int i = lane; i < Lc; i += 32) {
        const int q2 = s.iq[i];
        if (q2 >= 0 && q2 < pos) bnd = i + 1;
      }
      bnd = __reduce_max_sync(FULL, bnd);
      if (lane == 0) atomicAdd(&out.ins[bnd], 1);
    }
  }
  g.sync();
  ALG_PHASE(12);
  return (int)(n_live > Pc);
}

// The largest attach count a boundary may carry for A1 and A3 to take the
// fast path: at most 65,537 boundaries of at most this many atoms sum below
// 2^31, so where the first boundary's count is at most ICNT_FAST and every
// later one's in [0, ICNT_FAST] the prefix sum is non-decreasing without a
// check.
constexpr int ICNT_FAST = 32767;
// Elements of a thread's chunk A1 and A3 load at once: the first batch is
// kept in registers from pass 1 to pass 2, later batches are loaded again.
constexpr int BATCH = 4;

// A1's and A3's view of one document: the input rows where they lie, the
// thread's chunk of the slots [lo, hi) and of the boundaries [lo, hib) (the
// thread with the last slots also takes boundary Lc).
struct DocRows {
  const int *doc, *del, *ins, *ids, *mid, *moff, *pmid, *poff;
  int L, lo, hi, hib, Lc;
};

template <class G>
__device__ __forceinline__ DocRows doc_rows(const G g, const AlgArgs &a,
                                            int n) {
  DocRows r;
  const int *in[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) in[q] = a.in[q] + (long long)n * a.st[q];
  r.doc = in[0];
  r.del = in[2];
  r.ins = in[3];
  r.ids = in[4];
  r.mid = in[5];
  r.moff = in[6];
  r.pmid = in[7];
  r.poff = in[8];
  r.L = in[1][0];
  r.Lc = a.Lc;
  const int per = (r.Lc + g.T - 1) / g.T;
  r.lo = min(r.Lc, g.t * per);
  r.hi = min(r.Lc, r.lo + per);
  r.hib = r.hi + (int)(r.hi == r.Lc && r.lo < r.hi);
  return r;
}

// One element of a chunk: boundary j's attach count and, where j < Lc,
// slot j's lanes and document value (zeros past the document's Lc slots).
struct Elem {
  int ins, del, mid, moff, doc;
};

// Elements j0 .. j0 + BATCH - 1 of the chunk (those below hib), every load
// issued before any is used.
__device__ __forceinline__ void load_batch(const DocRows &r, int j0,
                                           Elem (&e)[BATCH]) {
#pragma unroll
  for (int q = 0; q < BATCH; ++q) {
    const int j = j0 + q;
    const bool b = j < r.hib, s = b && j < r.Lc;
    e[q].ins = b ? __ldg(r.ins + j) : 0;
    e[q].del = s ? __ldg(r.del + j) : 0;
    e[q].mid = s ? __ldg(r.mid + j) : 0;
    e[q].moff = s ? __ldg(r.moff + j) : 0;
    e[q].doc = s ? __ldg(r.doc + j) : 0;
  }
}

// fn(j, e) for every element of the chunk in order: the first batch from
// `held`, the others a batch at a time.
template <class F>
__device__ __forceinline__ void each_elem(const DocRows &r,
                                          const Elem (&held)[BATCH], F fn) {
#pragma unroll
  for (int q = 0; q < BATCH; ++q)
    if (r.lo + q < r.hib) fn(r.lo + q, held[q]);
  for (int j0 = r.lo + BATCH; j0 < r.hib; j0 += BATCH) {
    Elem e[BATCH];
    load_batch(r, j0, e);
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      if (j0 + q < r.hib) fn(j0 + q, e[q]);
  }
}

// Slot j's detach count (max(del, moved out) inside the document, else 0)
// and boundary j's attach count (inside the document, else 0).
__device__ __forceinline__ int detach_of(const DocRows &r, int j,
                                         const Elem &e) {
  return j < r.Lc ? max(e.del, (int)(e.mid > 0)) * (int)(j < r.L) : 0;
}

__device__ __forceinline__ int attach_of(const DocRows &r, int j,
                                         const Elem &e) {
  return e.ins * (int)(j <= r.L);
}

// Pass 1 of A1 and A3 over the held batch and the rest of the chunk: the
// sums of the detach counts (s[0]), the attach counts (s[1]) and, for K =
// 3, the detached slots (s[2]); returns 1 where an attach count past the
// first boundary lies outside [0, ICNT_FAST] (the searching path).
template <int K>
__device__ __forceinline__ unsigned chunk_sums(const DocRows &r,
                                               const Elem (&held)[BATCH],
                                               unsigned (&s)[K]) {
  unsigned risky = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) s[q] = 0;
  each_elem(r, held, [&](int j, const Elem &e) {
    const int d = detach_of(r, j, e), ic = attach_of(r, j, e);
    s[0] += (unsigned)d;
    s[1] += (unsigned)ic;
    if constexpr (K == 3) s[2] += (unsigned)(d != 0);
    risky |= (unsigned)(ic > ICNT_FAST || (j > 0 && ic < 0));
  });
  return risky;
}

// Pass 2's walk of the boundaries: bc runs from the chunk's offset to
// bcum[j] at element j; where `slow` is false fn(k, ip) takes each
// pool atom k < n_atoms with bcum[j - 1] <= k < bcum[j] at ip = j - dex[j]
// + k (its boundary is j), else bcum and dex are recorded for the search
// and `bad` notes a fall.
template <class F>
__device__ __forceinline__ void boundary_atoms(int j, int ic, int dx,
                                               int &bc, bool slow,
                                               int n_atoms, int *bcum,
                                               int *dex, bool &bad, F fn) {
  const int bprev = bc;
  bc = wadd(bc, ic);
  if (!slow) {
    for (int k = max(0, bprev); k < min(bc, n_atoms); ++k)
      fn(k, wadd(wsub(j, dx), k));
  } else {
    bcum[j] = bc;
    dex[j] = dx;
    bad |= j > 0 && bc < bprev;
  }
}

// The searching path: after a group barrier every thread's atoms k < n_atoms
// find their boundary in the recorded bcum (a binary search where it came
// out non-decreasing, a count otherwise).
template <class G, class F>
__device__ __forceinline__ void searched_atoms(const G g, bool bad,
                                               int n_atoms, const int *bcum,
                                               const int *dex, int Lc, F fn) {
  const bool mono = !g.sync_or(bad);
  for (int k = g.t; k < n_atoms; k += g.T) {
    const int b = count_leq(bcum, Lc + 1, k, mono);
    fn(k, wadd(wsub(b, dex[clampi(b, 0, Lc)]), k));
  }
}

// A1: apply_change(doc, L, c) for document n by the group g, its inputs
// read where they lie and its output scattered into doc_out (zeroed first,
// int atomicAdd). Region (ints): bcum and dex [Lc + 1] (the searching
// path's), the pool's ids, pmid and poff [Pc] staged, each atom's output
// position where it is a live move-in atom (else -1) and its sum [2 Pc].
// Each thread takes
// a chunk of the slots and boundaries, loaded a batch at a time: pass 1
// sums it (chunk_sums), offsets gives each chunk its prefix, pass 2 walks
// it again, scattering its survivors and, at each boundary b, the pool
// atoms with bcum[b - 1] <= k < bcum[b] where the attach counts are in
// range (else each thread's atoms search the recorded bcum). A move-in
// atom adds, at its position, the sum of the document's values at every
// slot j < L whose move tag is its own: each live move-in atom records its
// position and, after a barrier, every warp sums the values of its slots
// with the tag of each recorded atom, a batch of a thread's slots at a
// time, and adds the sum into the atom's (one add a warp: duplicate tags
// do not pile onto one word); after another, each atom adds its sum. No
// thread walks more than its chunk and its atoms, and per batch the pool.
template <class G>
__device__ void apply_alg(const G g, const AlgArgs &a, int n, int *p) {
  const int t = g.t, T = g.T, Lc = a.Lc, Pc = a.Pc;
  const DocRows r = doc_rows(g, a, n);
  int *const out = a.out[0] + (size_t)n * Lc;
  int *const bcum = p, *const dex = p + Lc + 1;
  int *const sids = dex + Lc + 1, *const spm = sids + Pc,
             *const spo = spm + Pc;
  int *const mip = spo + Pc, *const msum = mip + Pc;
  const bool own = t < Pc;  // pool atom k = t, loaded with the chunk
  const int k_ids = own ? __ldg(r.ids + t) : 0;
  const int k_pm = own ? __ldg(r.pmid + t) : 0;
  const int k_po = own ? __ldg(r.poff + t) : 0;
  Elem held[BATCH];
  load_batch(r, r.lo, held);
  for (int j = t; j < Lc; j += T) out[j] = 0;
  unsigned sum[2], off[2], tot[2];
  const unsigned risky = chunk_sums(r, held, sum);
  unsigned has_min = (unsigned)(k_pm > 0);
  if (own) {
    sids[t] = k_ids;
    spm[t] = k_pm;
    spo[t] = k_po;
  }
  for (int k = t + T; k < Pc; k += T) {
    const int pm = __ldg(r.pmid + k);
    sids[k] = __ldg(r.ids + k);
    spm[k] = pm;
    spo[k] = __ldg(r.poff + k);
    has_min |= (unsigned)(pm > 0);
  }
  for (int k = t; k < Pc; k += T) {
    mip[k] = -1;
    msum[k] = 0;
  }
  const unsigned f =
      g.template offsets<2>(sum, off, tot, risky | has_min << 1);
  ALG_PHASE(0);
  const bool slow = f & 1u, moves = f & 2u;
  const int total = (int)tot[1], n_atoms = min(Pc, total);
  // Atom k at output position ip: an insert adds its id, a move-in atom
  // records its position.
  auto atom = [&](int k, int ip) {
    if (ip < 0 || ip >= Lc) return;
    if (spm[k] > 0)
      mip[k] = ip;
    else
      atomicAdd(&out[ip], sids[k]);
  };
  int dx = (int)off[0], bc = (int)off[1];
  bool bad = false;
  each_elem(r, held, [&](int j, const Elem &e) {
    boundary_atoms(j, attach_of(r, j, e), dx, bc, slow, n_atoms, bcum, dex,
                   bad, atom);
    const int d = detach_of(r, j, e);
    if (j < Lc && j < r.L && d == 0) {
      const int sp = wadd(wsub(j, dx), bc);
      if (sp >= 0 && sp < Lc) atomicAdd(&out[sp], e.doc);
    }
    dx = wadd(dx, d);
  });
  if (t == 0) a.out[1][n] = wadd(wsub(r.L, (int)tot[0]), total);
  ALG_PHASE(1);
  if (slow) searched_atoms(g, bad, n_atoms, bcum, dex, Lc, atom);
  ALG_PHASE(2);
  if (moves) g.sync();
  ALG_PHASE(3);
  if (moves) {
    // A batch of the chunk's slots at a time, each recorded atom's tag
    // matched against every thread's batch, summed over the warp and added
    // to the atom's sum by one lane (the loops are uniform over the group).
    const int per = (Lc + T - 1) / T;
    for (int b = 0; b * BATCH < per; ++b) {
      Elem e[BATCH];
      if (b == 0) {
#pragma unroll
        for (int q = 0; q < BATCH; ++q) e[q] = held[q];
      } else {
        load_batch(r, r.lo + b * BATCH, e);
      }
      for (int k = 0; k < n_atoms; ++k) {
        if (mip[k] < 0) continue;
        const int pm = spm[k], po = spo[k];
        unsigned v = 0;
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int j = r.lo + b * BATCH + q;
          if (j < r.hi && j < r.L && e[q].mid == pm && e[q].moff == po)
            v += (unsigned)e[q].doc;
        }
        v = __reduce_add_sync(FULL, v);
        if ((t & 31) == 0 && v) atomicAdd(&msum[k], (int)v);
      }
    }
    g.sync();
    for (int k = t; k < n_atoms; k += T)
      if (mip[k] >= 0) atomicAdd(&out[mip[k]], msum[k]);
  }
  ALG_PHASE(4);
}

// A1, one CTA a document (the region in shared memory, or on the global
// tier in the document's slice of the workspace). In: doc, L, the change's
// seven lanes; out: doc, L. A1's and A3's CTA kernels are held to 64
// registers, so 8 CTAs of 128 threads share an SM (without the cap 96-112
// registers: a second wave at 1,024 documents).
template <bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    alg_apply_kernel(const AlgArgs a) {
  __shared__ unsigned red[RED_WORDS];
  ALG_PROF_BEGIN;
  const int n = blockIdx.x, t = threadIdx.x;
  apply_alg(CtaGroup{t, (int)blockDim.x, t >> 5, red}, a, n,
            alg_region<GLOBAL>(a));
  ALG_PROF_END(n, t == 0);
}

// A1 on the warp tier: one warp a document, its slice A1's region.
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    alg_apply_warp_kernel(const AlgArgs a) {
  ALG_PROF_BEGIN;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.docs + wid;
  if (n >= a.N) return;
  apply_alg(WarpGroup{lane, 32, 0}, a, n, tree_smem + (size_t)wid * a.slice);
  ALG_PROF_END(n, lane == 0);
}

// A2: rebase_change(c, o, L, C_AFTER). Region: [c and o, staged except on
// the global tier], the output change, dex/bcum/cbcum [Lc + 1], tpos [Lc],
// kpos/kb/klive/kcum [Pc]. In: c's and o's seven lanes, L; out: the
// change.
template <bool C_AFTER, bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS)
    alg_rebase_kernel(const AlgArgs a) {
  __shared__ unsigned red[RED_WORDS];
  ALG_PROF_BEGIN;
  const int n = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int Lc = a.Lc, Pc = a.Pc, E = 4 * Lc + 1 + 3 * Pc;
  constexpr Take st = GLOBAL ? TAKE_IN_PLACE : TAKE_ASYNC;
  int *p = alg_region<GLOBAL>(a);
  const Ch c = take_change(a, 0, n, Lc, Pc, p, st, t, T),
           o = take_change(a, 7, n, Lc, Pc, p, st, t, T),
           out = change_at(p, Lc, Pc);
  p += E;
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
  const int L = load_int(a, 14, n);
  loads_landed();
  __syncthreads();
  ALG_PHASE(0);
  rebase<C_AFTER>(c, o, L, out, E, s, Lc, Pc, red);
  store_change(a, out, Lc, Pc, n, t, T);
  ALG_PHASE(8);
  ALG_PROF_END(n, t == 0);
}

// A2 on the warp tier: one warp a document. Its slice: c, o and the output
// change, dex/bcum/cbcum [Lc + 1], kpos/kb/klive/kcum [Pc] (rebase_w
// scatters each landing position as it finds it).
template <bool C_AFTER>
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    alg_rebase_warp_kernel(const AlgArgs a) {
  ALG_PROF_BEGIN;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.docs + wid;
  if (n >= a.N) return;
  const int Lc = a.Lc, Pc = a.Pc, E = 4 * Lc + 1 + 3 * Pc;
  int *p = tree_smem + (size_t)wid * a.slice;
  const Ch c = take_change(a, 0, n, Lc, Pc, p, TAKE_ASYNC, lane, 32),
           o = take_change(a, 7, n, Lc, Pc, p, TAKE_ASYNC, lane, 32),
           out = change_at(p, Lc, Pc);
  p += E;
  Scratch s;
  s.tpos = nullptr;
  s.dex = p;
  p += Lc + 1;
  s.bcum = p;
  p += Lc + 1;
  s.cbcum = p;
  p += Lc + 1;
  s.kpos = p;
  p += Pc;
  s.kb = p;
  p += Pc;
  s.klive = p;
  p += Pc;
  s.kcum = p;
  const int L = load_int(a, 14, n);
  loads_landed();
  __syncwarp();
  ALG_PHASE(0);
  rebase_w<C_AFTER>(c, o, L, out, E, s, Lc, Pc);
  store_change(a, out, Lc, Pc, n, lane, 32);
  ALG_PHASE(8);
  ALG_PROF_END(n, lane == 0);
}

// A3: invert_change(doc, L, c) for document n by the group g, its inputs
// read where they lie: c's insert atoms become deletes and its move-in
// atoms return move-outs (the same tag) at their output positions; c's
// detached slots become one attach atom each at the slot's position among
// the survivors, pooled in input order: a deleted slot revives its
// document id, a moved-out one becomes the return move-in. The detach,
// move and attach lanes are zeroed, then scattered by int atomicAdd; the
// pool lanes are written once each, the detached slots' in their order
// (each chunk's offset in the detached count) and the rest 0. Region
// (ints): bcum and dex [Lc + 1] (as A1's), pmid and poff [Pc] staged. The
// passes are A1's.
template <class G>
__device__ void invert_alg(const G g, const AlgArgs &a, int n, int *p) {
  const int t = g.t, T = g.T, Lc = a.Lc, Pc = a.Pc;
  const DocRows r = doc_rows(g, a, n);
  const size_t nl = (size_t)n * Lc, np = (size_t)n * Pc;
  int *const o_del = a.out[0] + nl, *const o_ins = a.out[1] + n * (Lc + 1LL);
  int *const o_ids = a.out[2] + np, *const o_mid = a.out[3] + nl;
  int *const o_moff = a.out[4] + nl, *const o_pmid = a.out[5] + np;
  int *const o_poff = a.out[6] + np;
  int *const bcum = p, *const dex = p + Lc + 1;
  int *const spm = dex + Lc + 1, *const spo = spm + Pc;
  const bool own = t < Pc;  // pool atom k = t, loaded with the chunk
  const int k_pm = own ? __ldg(r.pmid + t) : 0;
  const int k_po = own ? __ldg(r.poff + t) : 0;
  Elem held[BATCH];
  load_batch(r, r.lo, held);
  for (int j = t; j < Lc; j += T) {
    o_del[j] = 0;
    o_mid[j] = 0;
    o_moff[j] = 0;
  }
  for (int j = t; j <= Lc; j += T) o_ins[j] = 0;
  unsigned sum[3], off[3], tot[3];
  const unsigned risky = chunk_sums(r, held, sum);
  if (own) {
    spm[t] = k_pm;
    spo[t] = k_po;
  }
  for (int k = t + T; k < Pc; k += T) {
    spm[k] = __ldg(r.pmid + k);
    spo[k] = __ldg(r.poff + k);
  }
  const bool slow = g.template offsets<3>(sum, off, tot, risky) != 0;
  ALG_PHASE(0);
  const int n_atoms = min(Pc, (int)tot[1]);
  // Atom k at output position ip: an insert becomes a delete, a move-in
  // atom the return move-out.
  auto atom = [&](int k, int ip) {
    if (ip < 0 || ip >= Lc) return;
    const int pm = spm[k];
    if (pm == 0) {
      atomicAdd(&o_del[ip], 1);
    } else if (pm > 0) {
      atomicAdd(&o_mid[ip], pm);
      atomicAdd(&o_moff[ip], spo[k]);
    }
  };
  int dx = (int)off[0], bc = (int)off[1], dc = (int)off[2];
  bool bad = false;
  each_elem(r, held, [&](int j, const Elem &e) {
    boundary_atoms(j, attach_of(r, j, e), dx, bc, slow, n_atoms, bcum, dex,
                   bad, atom);
    const int d = detach_of(r, j, e);
    if (d != 0) {
      const int sp = wadd(wsub(j, dx), bc);
      if (sp >= 0 && sp <= Lc) atomicAdd(&o_ins[sp], 1);
      if (dc < Pc) {  // the detached slots keep their order
        o_ids[dc] = e.del != 0 ? e.doc : 0;
        o_pmid[dc] = e.mid > 0 ? e.mid : 0;
        o_poff[dc] = e.mid > 0 ? e.moff : 0;
      }
      ++dc;
    }
    dx = wadd(dx, d);
  });
  for (int k = (int)tot[2] + t; k < Pc; k += T) {
    o_ids[k] = 0;
    o_pmid[k] = 0;
    o_poff[k] = 0;
  }
  ALG_PHASE(1);
  if (slow) searched_atoms(g, bad, n_atoms, bcum, dex, Lc, atom);
  ALG_PHASE(2);
}

// A3, one CTA a document. In: doc, L, the change's seven lanes; out: the
// change.
template <bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    alg_invert_kernel(const AlgArgs a) {
  __shared__ unsigned red[RED_WORDS];
  ALG_PROF_BEGIN;
  const int n = blockIdx.x, t = threadIdx.x;
  invert_alg(CtaGroup{t, (int)blockDim.x, t >> 5, red}, a, n,
             alg_region<GLOBAL>(a));
  ALG_PROF_END(n, t == 0);
}

// A3 on the warp tier: one warp a document, its slice A3's region.
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    alg_invert_warp_kernel(const AlgArgs a) {
  ALG_PROF_BEGIN;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.docs + wid;
  if (n >= a.N) return;
  invert_alg(WarpGroup{lane, 32, 0}, a, n, tree_smem + (size_t)wid * a.slice);
  ALG_PROF_END(n, lane == 0);
}

// A4's region after its inputs ([a and b, staged except on the global
// tier]): the output change, then ComposeScratch in its order.
__device__ __forceinline__ void compose_region(int *p, int Lc, int Pc,
                                               Ch *out, ComposeScratch *s) {
  const int E = 4 * Lc + 1 + 3 * Pc, NC = Lc + 2 * Pc;
  *out = change_at(p, Lc, Pc);
  p += E;
  int **const rows[11] = {&s->adex, &s->abcum, &s->bdex, &s->bbcum,
                          &s->apos, &s->bpos,  &s->slot, &s->iq,
                          &s->o2q,  &s->cidx,  &s->cq2};
  for (int r = 0; r < 11; ++r) {
    *rows[r] = p;
    p += r < 4 ? Lc + 1 : (r < 7 ? Pc : Lc);
  }
  s->key = p;
  p += NC;
  s->pos = p;
  s->sc = p + NC + 3;
}

// A4: compose_change, one CTA a document. In: a's and b's seven lanes, L;
// out: the change, the overflow.
template <bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS)
    alg_compose_kernel(const AlgArgs a) {
  __shared__ unsigned red[RED_WORDS];
  ALG_PROF_BEGIN;
  const int n = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int Lc = a.Lc, Pc = a.Pc, E = 4 * Lc + 1 + 3 * Pc;
  constexpr Take st = GLOBAL ? TAKE_IN_PLACE : TAKE_ASYNC;
  int *p = alg_region<GLOBAL>(a);
  const Ch ca = take_change(a, 0, n, Lc, Pc, p, st, t, T),
           cb = take_change(a, 7, n, Lc, Pc, p, st, t, T);
  Ch out;
  ComposeScratch s;
  compose_region(p, Lc, Pc, &out, &s);
  const int L = load_int(a, 14, n);
  loads_landed();
  __syncthreads();
  ALG_PHASE(0);
  const int ovf =
      compose(CtaGroup{t, T, t >> 5, red}, ca, cb, L, out, E, s, Lc, Pc);
  store_change(a, out, Lc, Pc, n, t, T);
  if (t == 0) a.out[7][n] = ovf;
  ALG_PHASE(13);
  ALG_PROF_END(n, t == 0);
}

// A4 on the warp tier: one warp a document, its slice A4's region.
__global__ void __launch_bounds__(32 * WARP_MAX_D)
    alg_compose_warp_kernel(const AlgArgs a) {
  ALG_PROF_BEGIN;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * a.docs + wid;
  if (n >= a.N) return;
  const int Lc = a.Lc, Pc = a.Pc, E = 4 * Lc + 1 + 3 * Pc;
  int *p = tree_smem + (size_t)wid * a.slice;
  const Ch ca = take_change(a, 0, n, Lc, Pc, p, TAKE_ASYNC, lane, 32),
           cb = take_change(a, 7, n, Lc, Pc, p, TAKE_ASYNC, lane, 32);
  Ch out;
  ComposeScratch s;
  compose_region(p, Lc, Pc, &out, &s);
  const int L = load_int(a, 14, n);
  loads_landed();
  __syncwarp();
  ALG_PHASE(0);
  const int ovf =
      compose(WarpGroup{lane, 32, 0}, ca, cb, L, out, E, s, Lc, Pc);
  store_change(a, out, Lc, Pc, n, lane, 32);
  if (lane == 0) a.out[7][n] = ovf;
  ALG_PHASE(13);
  ALG_PROF_END(n, lane == 0);
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

// A document's shared-memory slice on the warp tier (the layouts above
// trunk_warp_kernel and em_warp_kernel) and its ring's ints in the
// workspace when the ring lies there.
// (T1's without its cache of ring entries.)
long long trunk_warp_slice(int Lc, int Pc, int W, int ring_g) {
  const long long E = trunk_entry_ints(Lc, Pc);
  return (ring_g ? 2 * E : W * E) + 2LL * W + 3 * (E + 2) + 2LL * Lc +
         3LL * (Lc + 1) + 4LL * Pc;
}

long long em_warp_slice(int Lc, int Pc, int W, int R, int U, int ring_g) {
  const long long S = 3LL * Lc + 1 + Pc + 3LL * R + 2;
  return (ring_g ? 0 : (long long)W * Lc) + 2LL * W + (U + 31LL) / 32 +
         4LL * Lc + 2LL * (Lc + 1) + 2 * S;
}

// The placement of the two regions on a CTA tier; false where the tier
// cannot take them.
bool place(long long ring, long long rest, int tier, Place *pl,
           long long *smem) {
  *pl = Place{};
  pl->docs = 1;
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

// Documents a CTA of the warp tier holds at `slice` ints each: as many as
// fit SMEM_BYTES, at most WARP_MAX_D.
long long warp_docs(long long slice) {
  const long long d = SMEM_BYTES / (4 * slice);
  return d < WARP_MAX_D ? d : WARP_MAX_D;
}

// The ring entries T1's warp tier caches with its ring in the workspace:
// as many (up to WARP_CACHE_MAX and W) as leave its documents a CTA as
// they are without a cache.
int trunk_warp_cache(int Lc, int Pc, int W) {
  const long long E = trunk_entry_ints(Lc, Pc);
  const long long base = trunk_warp_slice(Lc, Pc, W, 1);
  const long long d0 = warp_docs(base);
  int m = 0;
  while (d0 >= 1 && m < WARP_CACHE_MAX && m < W &&
         warp_docs(base + (m + 1) * E) >= d0)
    ++m;
  return m;
}

// The warp tier: as many documents a CTA as their slices fit SMEM_BYTES,
// at most WARP_MAX_D; false where not one fits.
bool place_warp(long long slice, long long ring_work, int ring_g, Place *pl,
                long long *smem) {
  *pl = Place{};
  const long long d = warp_docs(slice);
  if (d < 1) return false;
  pl->docs = (int)d;
  pl->slice = slice;
  pl->ring_g = ring_g;
  pl->work_ints = ring_g ? ring_work : 0;
  *smem = 4 * slice * pl->docs;
  return true;
}

bool place_trunk(int Lc, int Pc, int W, int tier, Place *pl,
                 long long *smem) {
  if (tier == T_WARP || tier == T_WARP_RING_G) {
    const int g = tier == T_WARP_RING_G;
    const int m = g ? trunk_warp_cache(Lc, Pc, W) : 0;
    const long long E = trunk_entry_ints(Lc, Pc);
    if (!place_warp(trunk_warp_slice(Lc, Pc, W, g) + m * E, (long long)W * E,
                    g, pl, smem))
      return false;
    pl->cache = m;
    return true;
  }
  return place(trunk_ring_ints(Lc, Pc, W), trunk_rest_ints(Lc, Pc), tier,
               pl, smem);
}

bool place_em(int Lc, int Pc, int W, int R, int U, int tier, Place *pl,
              long long *smem) {
  if (tier == T_WARP || tier == T_WARP_RING_G) {
    const int g = tier == T_WARP_RING_G;
    return place_warp(em_warp_slice(Lc, Pc, W, R, U, g), (long long)W * Lc,
                      g, pl, smem);
  }
  return place(em_ring_ints(Lc, W), em_rest_ints(Lc, U), tier, pl, smem);
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
int launch_tree(Kern kern, const Args &a, int blocks, int threads,
                long long smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, threads, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

// One launch of a kernel's tier: the warp kernel over ceil(N / D) CTAs of
// D warps, or the CTA kernel over N CTAs.
template <typename Args>
int launch_tier(void (*cta)(Args), void (*warp)(Args), const Args &a,
                long long smem, cudaStream_t st) {
  if (a.pl.slice > 0) {
    const int d = a.pl.docs;
    return launch_tree(warp, a, (a.N + d - 1) / d, 32 * d, smem, st);
  }
  return launch_tree(cta, a, a.N, threads_for(a.Lc), smem, st);
}

// A1-A4's region on a tier: ints a document takes (the layouts above
// alg_*_kernel): its staged inputs (on the global tier none, but A1's
// copies) and the rest; rebase's tpos only on the CTA tiers.
long long alg_ints(int op, int Lc, int Pc, int tier) {
  const long long E = trunk_entry_ints(Lc, Pc), l1 = Lc + 1LL;
  const long long nc = Lc + 2LL * Pc;
  const bool staged = tier != T_GLOBAL;
  switch (op) {
    case A_APPLY:
      return 2 * l1 + 5LL * Pc;
    case A_REBASE:
      return (staged ? 2 * E : 0) + E + 3 * l1 + 4LL * Pc +
             (tier == T_WARP ? 0 : Lc);
    case A_INVERT:
      return 2 * l1 + 2LL * Pc;
    case A_COMPOSE:
      return (staged ? 2 * E : 0) + E + 4 * l1 + 3LL * Pc + 4LL * Lc +
             2 * nc + 6;
  }
  return -1;
}

// A1-A4's placement on a tier: the region in dynamic shared memory while it
// fits SMEM_BYTES (shared), in the workspace (global), or one warp's slice
// of a CTA's dynamic shared memory, `docs` of them (warp: A2 and A4); false
// where the tier cannot take it.
bool place_alg(int op, int Lc, int Pc, int tier, long long *work_ints,
               long long *smem, int *docs) {
  if (op < A_APPLY || op > A_COMPOSE) return false;
  *work_ints = 0;
  *docs = 1;
  if (tier == T_SHARED) {
    *smem = 4 * alg_ints(op, Lc, Pc, tier);
    return *smem <= SMEM_BYTES;
  }
  if (tier == T_WARP) {
    const long long slice = alg_ints(op, Lc, Pc, tier);
    const long long d = warp_docs(slice);
    if (d < 1) return false;
    *docs = (int)d;
    *smem = 4 * slice * d;
    return true;
  }
  if (tier != T_GLOBAL) return false;
  *work_ints = alg_ints(op, Lc, Pc, tier);
  *smem = 0;
  return true;
}

// One launch of A1-A4's CTA kernels on the shared tier or (GLOBAL) the
// global tier: N CTAs of threads_for(Lc) threads, for A1 and A3 of
// threads_for(Lc / BATCH) (a batch of slots a thread: at 3c's Lc 512 a
// CTA of 128, so 1,024 documents run in one wave).
template <bool GLOBAL>
int launch_alg_cta(int op, int c_after, const AlgArgs &a, long long smem,
                   cudaStream_t st) {
  const int n = a.N, thr = threads_for(op == A_APPLY || op == A_INVERT
                                           ? (a.Lc + BATCH - 1) / BATCH
                                           : a.Lc);
  switch (op) {
    case A_APPLY:
      return launch_tree(alg_apply_kernel<GLOBAL>, a, n, thr, smem, st);
    case A_REBASE:
      return c_after ? launch_tree(alg_rebase_kernel<true, GLOBAL>, a, n,
                                   thr, smem, st)
                     : launch_tree(alg_rebase_kernel<false, GLOBAL>, a, n,
                                   thr, smem, st);
    case A_INVERT:
      return launch_tree(alg_invert_kernel<GLOBAL>, a, n, thr, smem, st);
  }
  return launch_tree(alg_compose_kernel<GLOBAL>, a, n, thr, smem, st);
}

// One launch of A1-A4: N CTAs of threads_for(Lc) threads, or on the warp
// tier ceil(N / docs) CTAs of `docs` warps. Inputs: 9 lanes (apply,
// invert: doc, L, a change) or 15 (rebase, compose: two changes, L);
// outputs 2 (apply: doc, L), 7 (a change) or 8 (compose: and the overflow
// flag).
int launch_alg(int op, int c_after, const int *const *in,
               const long long *stride, int *const *out, int *work,
               int n_docs, int Lc, int Pc, int tier, cudaStream_t st) {
  if (n_docs < 1 || Lc < 1 || Lc > MAX_LC || Pc < 1 || Pc > MAX_PC)
    return (int)cudaErrorInvalidValue;
  long long work_ints, smem;
  int docs;
  if (!place_alg(op, Lc, Pc, tier, &work_ints, &smem, &docs) ||
      (work_ints > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  AlgArgs a{};
  const int n_in = op == A_APPLY || op == A_INVERT ? 9 : 15;
  const int n_out = op == A_APPLY ? 2 : (op == A_COMPOSE ? 8 : 7);
  for (int q = 0; q < n_in; ++q) {
    a.in[q] = in[q];
    a.st[q] = stride[q];
  }
  for (int q = 0; q < n_out; ++q) a.out[q] = out[q];
  a.work = work;
  a.work_ints = work_ints;
  a.N = n_docs;
  a.Lc = Lc;
  a.Pc = Pc;
  a.docs = docs;
  if (tier == T_WARP) {
    a.slice = alg_ints(op, Lc, Pc, tier);
    const int blocks = (n_docs + docs - 1) / docs, thr = 32 * docs;
    switch (op) {
      case A_APPLY:
        return launch_tree(alg_apply_warp_kernel, a, blocks, thr, smem, st);
      case A_INVERT:
        return launch_tree(alg_invert_warp_kernel, a, blocks, thr, smem, st);
      case A_COMPOSE:
        return launch_tree(alg_compose_warp_kernel, a, blocks, thr, smem, st);
    }
    return c_after ? launch_tree(alg_rebase_warp_kernel<true>, a, blocks, thr,
                                 smem, st)
                   : launch_tree(alg_rebase_warp_kernel<false>, a, blocks,
                                 thr, smem, st);
  }
  return tier == T_GLOBAL ? launch_alg_cta<true>(op, c_after, a, smem, st)
                          : launch_alg_cta<false>(op, c_after, a, smem, st);
}

}  // namespace

extern "C" {

// Each scan launches on `stream` and returns cudaGetLastError() (0 = ok).
// `tier`: 0 shared, 1 global, 2 warp (the ring in shared memory), 3 warp
// (the ring in the workspace); the global tier and tier 3 take a device
// buffer of n_docs * tree_*_work_ints(...) int32 at `work` (NULL
// otherwise). Inputs are not modified.

int tree_trunk_scan(const int *doc_in, const int *L_in, const int *del,
                    const int *ins, const int *ids, const int *mid,
                    const int *moff, const int *pmid, const int *poff,
                    const int *ref, const int *seq, int *doc_out, int *L_out,
                    int *err_out, int *work, int n_docs, int C, int Lc,
                    int Pc, int W, int tier, void *stream) {
  if (!shapes_ok(n_docs, C, Lc, Pc, W)) return (int)cudaErrorInvalidValue;
  TrunkArgs a{doc_in,  L_in,  del,     ins,  ids,    mid, moff, pmid,
              poff,    ref,   seq,     doc_out, L_out, err_out, work,
              n_docs,  C,     Lc,      Pc,   W,      Place{}};
  long long smem;
  if (!place_trunk(Lc, Pc, W, tier, &a.pl, &smem) ||
      (a.pl.work_ints > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_tier(trunk_scan_kernel, trunk_warp_kernel, a, smem,
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
  EmArgs a{ring_ids, ring_L, ring_seq, mov_seq0, dm,     ic,      ii,
           rs,       rl,     ro,       refs,     seqs,   mv,      doc_out,
           L_out,    err_out, work,    n_docs,   C,      Lc,      Pc,
           W,        R,      U,        Place{}};
  long long smem;
  if (!place_em(Lc, Pc, W, R, U, tier, &a.pl, &smem) ||
      (a.pl.work_ints > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_tier(em_scan_kernel, em_warp_kernel, a, smem,
                     (cudaStream_t)stream);
}

// Per-document workspace ints, dynamic shared memory bytes a CTA and
// documents a CTA of a tier code (-1 where the tier cannot take the shape).
long long tree_trunk_work_ints(int Lc, int Pc, int W, int tier) {
  Place pl;
  long long smem;
  return place_trunk(Lc, Pc, W, tier, &pl, &smem) ? pl.work_ints : -1;
}

long long tree_trunk_smem_bytes(int Lc, int Pc, int W, int tier) {
  Place pl;
  long long smem;
  return place_trunk(Lc, Pc, W, tier, &pl, &smem) ? smem : -1;
}

long long tree_trunk_docs(int Lc, int Pc, int W, int tier) {
  Place pl;
  long long smem;
  return place_trunk(Lc, Pc, W, tier, &pl, &smem) ? pl.docs : -1;
}

long long tree_em_work_ints(int Lc, int Pc, int W, int R, int U, int tier) {
  Place pl;
  long long smem;
  return place_em(Lc, Pc, W, R, U, tier, &pl, &smem) ? pl.work_ints : -1;
}

long long tree_em_smem_bytes(int Lc, int Pc, int W, int R, int U, int tier) {
  Place pl;
  long long smem;
  return place_em(Lc, Pc, W, R, U, tier, &pl, &smem) ? smem : -1;
}

long long tree_em_docs(int Lc, int Pc, int W, int R, int U, int tier) {
  Place pl;
  long long smem;
  return place_em(Lc, Pc, W, R, U, tier, &pl, &smem) ? pl.docs : -1;
}

// A1-A4, the changeset algebra (ops/tree_algebra_kernel.py): `in` and
// `stride` hold each input lane's pointer and row stride in ints (L's
// element stride), `out` the output lanes' pointers (C-contiguous). `tier`:
// 0 shared, 1 global (a device buffer of n_docs *
// tree_algebra_work_ints(...) int32 at `work`), 2 warp (rebase and
// compose). Inputs are not modified.

int tree_apply(const int *const *in, const long long *stride,
               int *const *out, int *work, int n_docs, int Lc, int Pc,
               int tier, void *stream) {
  return launch_alg(A_APPLY, 0, in, stride, out, work, n_docs, Lc, Pc, tier,
                    (cudaStream_t)stream);
}

int tree_rebase(const int *const *in, const long long *stride,
                int *const *out, int *work, int n_docs, int Lc, int Pc,
                int c_after, int tier, void *stream) {
  return launch_alg(A_REBASE, c_after, in, stride, out, work, n_docs, Lc, Pc,
                    tier, (cudaStream_t)stream);
}

int tree_invert(const int *const *in, const long long *stride,
                int *const *out, int *work, int n_docs, int Lc, int Pc,
                int tier, void *stream) {
  return launch_alg(A_INVERT, 0, in, stride, out, work, n_docs, Lc, Pc, tier,
                    (cudaStream_t)stream);
}

int tree_compose(const int *const *in, const long long *stride,
                 int *const *out, int *work, int n_docs, int Lc, int Pc,
                 int tier, void *stream) {
  return launch_alg(A_COMPOSE, 0, in, stride, out, work, n_docs, Lc, Pc,
                    tier, (cudaStream_t)stream);
}

// Per-document workspace ints and dynamic shared memory bytes a CTA of
// entry `op` (0 apply, 1 rebase, 2 invert, 3 compose) on a tier code (-1
// where the tier cannot take the shape).
long long tree_algebra_work_ints(int op, int Lc, int Pc, int tier) {
  long long w, smem;
  int d;
  return place_alg(op, Lc, Pc, tier, &w, &smem, &d) ? w : -1;
}

long long tree_algebra_smem_bytes(int op, int Lc, int Pc, int tier) {
  long long w, smem;
  int d;
  return place_alg(op, Lc, Pc, tier, &w, &smem, &d) ? smem : -1;
}

long long tree_smem_budget(void) { return SMEM_BYTES; }

const char *tree_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
