"""Where T1 and T2's CTA tiers spend a commit, from ``clock64()`` stamps.

Run on a machine with an H100 (from the repository's root):

    python3 -m tools.tree_scan_profile [--warp]

It copies ``csrc/tree_kernels.cu`` into the git-ignored build directory
with stamps added to the one-CTA-a-document kernels (``trunk_scan_kernel``,
``em_scan_kernel``): thread 0 of each CTA sums the cycles it waits in
``__syncthreads`` and the cycles of each phase of the commit loop, and every
thread sums the cycles it spends in the serial move loops (the largest
thread's sum is the loops' share of the critical path). It builds that copy
with ``nvcc``, runs it on the shared tier at config 3b's shape (T1: 1,024
documents x 125 commits, Lc 128, Pc 32, W 16) and config 3c's (T2: 1,024 x
128, Lc 512, W 16, R 16), and prints each share of a CTA's cycles, the
rebases a commit, and the CUDA-event time of the unstamped kernel at N =
1,024 against N = 528 (one wave: 4 CTAs an SM at these shapes' shared
memory) as the second wave's cost. With ``--warp`` it stamps the warp
kernels instead (lane 0 of each warp sums the cycles of each phase of its
document's commit loop) and prints each phase's share at the same shapes.
With ``--algebra [--source PATH]`` it stamps the algebra kernels A1-A4
(``alg_*_kernel``, rebase in both tie forms) and their warp-tier kernels
instead, through the source's ``ALG_PHASE`` markers: thread 0 of each CTA,
or lane 0 of each warp on the warp tier, sums the cycles of each phase of
its document, and each phase's share of a document's cycles is printed,
beside the device ms a call, on every tier the library takes at config 3b's
widths (1,024 documents, Lc 128, Pc 32) and 3c's (1,024, Lc 512, Pc 8),
on ``chip_smoke.algebra_case``'s commits, and at the global tier's hold
(64 documents, Lc 8,192, Pc 32, raw lanes). ``--source`` builds another
copy of ``tree_kernels.cu`` (a variant, or an earlier design: where it
lacks the markers only the times are printed); the tiers and workspaces
are then the library's own. The
result also goes to ``tree_profile.json`` in the smoke's output directory
(``chip_smoke.OUT_DIR``).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import tree_algebra_kernel as TAK
from fluidframework_tpu_torch.ops import tree_scan_kernel as TSK

PROF_WORDS = 8
RINGS_BY_CODE = {TSK.code("warp", r): r for r in TSK.RINGS}
_DEFS = r'''
__device__ unsigned long long *tree_prof;
__shared__ long long prof_bar;
__shared__ long long prof_mv[512];
#define PSYNC() do { const long long _t0 = clock64(); __syncthreads(); \
  if (threadIdx.x == 0) prof_bar += clock64() - _t0; } while (0)
#define MV_BEGIN const long long _tm = clock64();
#define MV_END prof_mv[threadIdx.x] += clock64() - _tm;
'''
_SETTER = r'''
extern "C" int tree_prof_set(void *p) {
  return (int)cudaMemcpyToSymbol(tree_prof, &p, sizeof(p));
}
'''


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) < count:
        raise RuntimeError(f"profile anchor not found: {old!r}")
    return src.replace(old, new, count)


def _between(src: str, start: str, end: str, fn) -> str:
    """Apply ``fn`` to the text from ``start`` up to ``end``."""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + fn(src[i:j]) + src[j:]


def _kernel_open(src: str, name: str, words: str) -> str:
    """Reset the stamps at the top of kernel ``name``; at its end thread 0
    writes ``words`` (the totals) to its CTA's record."""
    head = f"{name}(const "
    i = src.index(head)
    body = src.index("{", i) + 1
    src = src[:body] + (
        "\n  const long long _t_all = clock64();"
        "\n  if (threadIdx.x == 0) prof_bar = 0;"
        "\n  prof_mv[threadIdx.x] = 0;"
        "\n  long long p_load = 0, p_mid = 0, p_tail = 0, p_n = 0;"
        "\n  __syncthreads();") + src[body:]
    end = src.index("\n  if (t == 0) {\n    a.L_out[n] = L;", body)
    return src[:end] + (
        "\n  __syncthreads();"
        "\n  if (threadIdx.x == 0) {"
        "\n    long long mv = 0;"
        "\n    for (int j = 0; j < blockDim.x; ++j) mv = max(mv, prof_mv[j]);"
        f"\n    const long long w[{PROF_WORDS}] = {{{words}}};"
        f"\n    for (int j = 0; j < {PROF_WORDS}; ++j)"
        f"\n      tree_prof[(size_t)blockIdx.x * {PROF_WORDS} + j] = w[j];"
        "\n  }") + src[end:]


def instrumented_source() -> str:
    """The kernel source with the stamps added to the CTA kernels."""
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    src = _sub(src, "#include <stddef.h>\n", "#include <stddef.h>\n" + _DEFS)
    cta = ("template <int K>\n__device__ unsigned block_scan",
           "// -- the warp tier")
    src = _between(src, *cta, lambda s: s.replace("__syncthreads();",
                                                  "PSYNC();"))
    # The serial move loops: a moved slot's destination, a dead move-in
    # atom, a move-in atom's value.
    src = _sub(src, "      const int mi = o.mid[i], mo = o.moff[i];\n",
               "      MV_BEGIN\n      const int mi = o.mid[i], mo = o.moff[i];\n")
    src = _sub(src, "      tp = (int)acc;\n    }\n    s.tpos[i] = tp;",
               "      tp = (int)acc;\n      MV_END\n    }\n    s.tpos[i] = tp;")
    src = _sub(src, "    if (pm > 0) {\n      const int po = c.poff[k];\n",
               "    if (pm > 0) {\n      MV_BEGIN\n      const int po = c.poff[k];\n")
    src = _sub(src, "o.del[i] > 0);\n    }\n",
               "o.del[i] > 0);\n      MV_END\n    }\n")
    src = _sub(src, "          const int po = c.poff[k];\n          unsigned acc",
               "          MV_BEGIN\n          const int po = c.poff[k];\n"
               "          unsigned acc")
    src = _sub(src, "          v = (int)acc;\n",
               "          v = (int)acc;\n          MV_END\n")
    # T1: the commit's lane loads (to the barrier after them), the fold,
    # apply_change and the push; rebases counted.
    src = _kernel_open(src, "trunk_scan_kernel",
                       "clock64() - _t_all, p_load, p_mid, p_tail, prof_bar, "
                       "p_n, mv, 0")
    t1 = ("trunk_scan_kernel(const TrunkArgs a)", "// -- T2")
    src = _between(src, *t1, lambda s: _sub(_sub(_sub(_sub(s,
        "    const size_t ck = (size_t)n * C + k;\n",
        "    long long _tk = clock64();\n"
        "    const size_t ck = (size_t)n * C + k;\n"),
        "    PSYNC();\n    // Fold over the ring",
        "    PSYNC();\n    if (t == 0) p_load += clock64() - _tk;\n"
        "    _tk = clock64();\n    // Fold over the ring"),
        "      if (sw > ref && sw > 0) {\n",
        "      if (sw > ref && sw > 0) {\n        ++p_n;\n"),
        "    const int new_L =\n        apply_change(",
        "    if (t == 0) p_mid += clock64() - _tk;\n    _tk = clock64();\n"
        "    const int new_L =\n        apply_change(").replace(
        "    L = new_L;\n    PSYNC();\n",
        "    L = new_L;\n    PSYNC();\n"
        "    if (t == 0) p_tail += clock64() - _tk;\n"))
    # T2: the commit's loads and fills (to the barrier before the first
    # scan), the post view and the compaction, the attach runs (counted),
    # and the push.
    src = _kernel_open(src, "em_scan_kernel",
                       "clock64() - _t_all, p_load, p_mid, p_tail, prof_bar, "
                       "p_n, mv, 0")
    t2 = ("em_scan_kernel(const EmArgs a)", "// -- the warp tier")
    src = _between(src, *t2, lambda s: _sub(_sub(_sub(_sub(_sub(s,
        "    const size_t ck = (size_t)n * C + k;\n",
        "    long long _tk = clock64();\n"
        "    const size_t ck = (size_t)n * C + k;\n"),
        "    PSYNC();\n    int *const arrs[2] = {dex, bcum};",
        "    PSYNC();\n    if (t == 0) p_load += clock64() - _tk;\n"
        "    _tk = clock64();\n    int *const arrs[2] = {dex, bcum};"),
        "      if (!(st >= 0 && len > 0)) continue;\n",
        "      if (!(st >= 0 && len > 0)) continue;\n      ++p_n;\n"),
        "    int *cur = dout, *spare = doc;\n",
        "    int *cur = dout, *spare = doc;\n"
        "    if (t == 0) p_mid += clock64() - _tk;\n    _tk = clock64();\n"),
        "    doc = cur;\n    dout = spare;\n    L = L2;\n    PSYNC();\n",
        "    doc = cur;\n    dout = spare;\n    L = L2;\n    PSYNC();\n"
        "    if (t == 0) p_tail += clock64() - _tk;\n"))
    # The stamps' static shared memory puts every launch past the default
    # 48 KB: opt in to the dynamic size always.
    src = _sub(src, "  if (smem > 48 * 1024) {", "  if (smem > 0) {")
    return src + _SETTER


_WDEFS = r'''
__shared__ long long wprof[8][16];
__shared__ long long wlast[8];
#define WSTAMP(j) do { if ((threadIdx.x & 31) == 0) { \
  const long long _n = clock64(); \
  wprof[threadIdx.x >> 5][j] += _n - wlast[threadIdx.x >> 5]; \
  wlast[threadIdx.x >> 5] = _n; } } while (0)
'''
# The warp kernels' phases: each stamp closes phase j, the cycles since
# the warp's previous stamp.
WARP_PHASES = {
    "T1": ("rebase fill+zero", "rebase scan", "rebase pool search",
           "rebase slots", "rebase dead atoms", "rebase pool scatter",
           "apply fill+scan", "apply scatter", "commit wait",
           "push", "entry staging and wait", "next commit's copies issued"),
    "T2": ("next commit's copies issued", "fill+view wait", "scan",
           "post+bits", "compaction", "run bits", "run anchor",
           "run scatter", "commit wait", "push", "author view"),
}
# Where each stamp goes: "|" marks the spot in its anchor.
_WARP_STAMPS = (
    # T1, in rebase_w / apply_w / trunk_warp_kernel
    ("out.del[j] = 0;  // the whole output\n  __syncwarp();\n|", 0),
    ("  const unsigned bad = warp_scan<3>(arrs, Lc + 1);\n|", 1),
    ("  ALG_PHASE(3);\n|  for (int i0 = 0; i0 < Lc; i0 += 32) {\n", 2),
    ("|  for (int k0 = 0; k0 < Pc; k0 += 32) {\n    const int k = k0 + lane;"
     "\n    const int pm", 3),
    ("|  int *const karr[1] = {s.kcum};\n  warp_scan<1>(karr, Pc);\n", 4),
    ("  ALG_PHASE(7);\n|}\n\n// apply_change() for one warp", 5),
    ("  const int new_L = wadd(wsub(L, s.dex[Lc]), total);\n|"
     "  for (int i = lane; i < Lc; i += 32) {\n", 6),
    ("  __syncwarp();\n|  return new_L;\n", 7),
    ("    __syncwarp();  // commit k's lanes are in `cur`\n|", 8),
    ("    if (M > 0 && ++cslot == M) cslot = 0;\n    __syncwarp();\n|", 9),
    ("          cp_async_wait(jn <= last_g);\n          __syncwarp();\n|", 10),
    ("    if (k + 1 < C) stage_trunk_commit(a, stg, n, k + 1, E, lane);\n|",
     11),
    ("|    const int new_L = apply_w(", 10),
    # T2, in em_warp_kernel
    ("|    if (k + 1 < C) stage_em_commit(a, cm_next, n, k + 1, lane);\n", 10),
    ("    if (k + 1 < C) stage_em_commit(a, cm_next, n, k + 1, lane);\n|", 0),
    ("    if (staged) cp_async_wait(k + 1 < C);\n    __syncwarp();\n|", 1),
    ("    const unsigned bad = warp_scan<2>(arrs, Lc + 1);\n|", 2),
    ("    __syncwarp();\n|    //    Drop the detached ids", 3),
    ("    int L2 = wsub(L, dex[Lc]);\n    __syncwarp();\n|", 4),
    ("      __syncwarp();\n|      int anchor_at = -1;\n", 5),
    ("      __syncwarp();\n|      // Insert `len` ids", 6),
    ("      L2 = wadd(L2, v);\n      __syncwarp();\n|", 7),
    ("    __syncwarp();  // commit k's lanes are in cm\n|", 8),
    ("    cm_next = tmp;\n    __syncwarp();\n|", 9),
)


def instrumented_warp_source() -> str:
    """The kernel source with the stamps added to the warp kernels: each
    warp's lane 0 sums the cycles of each phase, written per document."""
    with open(_cuda.TREE_SOURCE) as f:
        src = f.read()
    src = _sub(src, "#include <stddef.h>\n", "#include <stddef.h>\n"
               "__device__ unsigned long long *tree_prof;\n" + _WDEFS)
    for anchor, j in _WARP_STAMPS:
        src = _sub(src, anchor.replace("|", ""),
                   anchor.replace("|", f"  WSTAMP({j});\n"))
    for kern in ("trunk_warp_kernel", "em_warp_kernel"):
        i = src.index(f"{kern}(const ")
        i = src.index("  if (n >= a.N) return;\n", i) + len(
            "  if (n >= a.N) return;\n")
        src = src[:i] + ("  if (lane == 0) {\n"
                         "    for (int j = 0; j < 16; ++j) wprof[wid][j] = 0;"
                         "\n    wlast[wid] = clock64();\n  }\n") + src[i:]
        j = src.index("  if (lane == 0) {\n    a.L_out[n] = L;", i)
        src = src[:j] + ("  if (lane == 0)\n    for (int q = 0; q < 16; ++q)\n"
                         "      tree_prof[(size_t)n * 16 + q] = wprof[wid][q];"
                         "\n") + src[j:]
    return src + _SETTER


_ADEFS = r'''
__device__ unsigned long long *tree_prof;
__shared__ unsigned aprof[8][16];
__shared__ long long alast[8];
#define ALG_STAMPER ((threadIdx.x & 31) == 0 && threadIdx.x < 256)
#define ALG_PHASE(j) do { if (ALG_STAMPER) { \
  const long long _n = clock64(); \
  aprof[threadIdx.x >> 5][j] += (unsigned)(_n - alast[threadIdx.x >> 5]); \
  alast[threadIdx.x >> 5] = _n; } } while (0)
#define ALG_PROF_BEGIN do { if (ALG_STAMPER) { \
  for (int _j = 0; _j < 16; ++_j) aprof[threadIdx.x >> 5][_j] = 0; \
  alast[threadIdx.x >> 5] = clock64(); } } while (0)
#define ALG_PROF_END(n, who) do { if ((who) && ALG_STAMPER) \
  for (int _j = 0; _j < 16; ++_j) \
    tree_prof[(size_t)(n) * 16 + _j] = aprof[threadIdx.x >> 5][_j]; \
  } while (0)
'''
# The algebra kernels' phases, in the order of their ALG_PHASE markers: each
# stamp closes phase j, the cycles since the previous stamp.
ALG_PHASES = {
    TAK.A1: ("load+offsets", "scatters", "non-monotone atoms",
             "move-in barrier", "move-in resolve"),
    TAK.A3: ("load+offsets", "scatters and pool", "non-monotone atoms"),
    TAK.A2: ("load", "fill+zero", "scan", "pool positions",
             "slot landing and moved-slot search", "dead move-in atoms",
             "kcum scan", "scatters", "store"),
    TAK.A4: ("load", "fill a+zero", "scan a", "a pool+fill b", "scan b",
             "b pool", "p1/o2q tag searches", "fate+keys", "icnt scan",
             "compaction+counts+histogram", "rank prep", "rank",
             "pool+anchors", "store"),
}


def instrumented_algebra_source(path: str = None) -> str:
    """``path`` (the package's kernel source by default) with its
    ``ALG_PHASE`` markers defined as clock64() stamps."""
    with open(path or _cuda.TREE_SOURCE) as f:
        src = f.read()
    src = _sub(src, "#include <stddef.h>\n", "#include <stddef.h>\n" + _ADEFS)
    src = _sub(src, "  if (smem > 48 * 1024) {", "  if (smem > 0) {")
    return src + _SETTER


def build(warp: bool = False, algebra: str = None) -> ctypes.CDLL:
    """Build an instrumented copy of the kernel source: the CTA stamps,
    the warp stamps, or (``algebra``: a source path or "") the algebra
    stamps."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "profile")
    os.makedirs(out_dir, exist_ok=True)
    tag = ("algebra" if algebra is not None else "warp" if warp else "cta")
    src = os.path.join(out_dir, f"tree_kernels_profile_{tag}.cu")
    with open(src, "w") as f:
        f.write(instrumented_algebra_source(algebra or None)
                if algebra is not None else instrumented_warp_source()
                if warp else instrumented_source())
    so = os.path.join(out_dir, f"libtree_profile_{tag}.so")
    res = subprocess.run(
        [_cuda._nvcc(), "-gencode", _cuda.ARCH, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    cdll = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    if algebra is not None:
        TAK._bind(cdll)
        _cuda.bind(cdll, [("tree_prof_set", [p], i)])
        return cdll
    _cuda.bind(cdll, [
        ("tree_trunk_scan", [p] * 15 + [i] * 6 + [p], i),
        ("tree_em_ring_scan", [p] * 17 + [i] * 8 + [p], i),
        ("tree_prof_set", [p], i)])
    return cdll


def _run(cdll, entry, tensors, shape, dev, prof=None, tier_code=None):
    """One launch of ``entry`` on the shared tier (or ``tier_code``) into
    fresh outputs."""
    N, C, Lc, Pc, W, R, U = shape
    out = [torch.empty((N, Lc), dtype=torch.int32, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev)]
    if prof is not None and cdll.tree_prof_set(prof.data_ptr()) != 0:
        raise RuntimeError("tree_prof_set failed")
    ints = [N, C, Lc, Pc, W] + ([R, U] if entry == TSK.T2 else [])
    code = tier_code or TSK.code("shared")
    t, ring = (("warp", RINGS_BY_CODE[code]) if code >= TSK.TIER_CODES["warp"]
               else ({v: k for k, v in TSK.TIER_CODES.items()}[code], None))
    work_ints = TSK.placement(entry, Lc, Pc, W, U, t, R, ring)[1]
    work = (torch.empty(N * work_ints, dtype=torch.int32, device=dev)
            if work_ints else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(cdll, entry)(*[x.data_ptr() for x in (*tensors, *out)],
                               work.data_ptr() if work is not None else None, *ints, tier_code or TSK.code("shared"),
                               stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return out


def _ms(fn, reps=5) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def profile(dev) -> dict:
    from chip_smoke import em_case, trunk_case

    cdll = build()
    res = {}
    docs, L0, cb = trunk_case(dev, 1024, 125, 16, 128, 32, 0.0)
    t1 = TSK._trunk_inputs(docs, L0, cb, 16)
    rings, ecb, U = em_case(dev, 1024, 128, 512)
    t2 = TSK._em_inputs(*rings, ecb, U)
    for key, entry, (tensors, shape) in (("T1", TSK.T1, t1),
                                         ("T2", TSK.T2, t2)):
        N, C = shape[0], shape[1]
        prof = torch.zeros(N * PROF_WORDS, dtype=torch.int64, device=dev)
        _run(cdll, entry, tensors, shape, dev, prof)
        torch.cuda.synchronize()
        w = prof.view(N, PROF_WORDS).double().sum(0).tolist()
        total = w[0]
        row = {"cta_cycles_mean": total / N,
               "share_barrier_wait": w[4] / total,
               "share_commit_loads": w[1] / total,
               "share_" + ("fold" if key == "T1" else "post_compaction"):
                   w[2] / total,
               "share_" + ("apply_push" if key == "T1" else "runs_push"):
                   w[3] / total,
               "share_move_loops_max_thread": w[6] / total,
               ("rebases_per_commit" if key == "T1"
                else "runs_per_commit"): w[5] / (N * C)}
        # The unstamped kernel (the repository's build) over every
        # document, and over one wave's.
        on = TSK.trunk_scan_on if key == "T1" else TSK.em_ring_scan_on
        args = ((docs, L0, cb, 16) if key == "T1" else (*rings, ecb, U))
        one = tuple(type(x)(*[y[:528].contiguous() for y in x])
                    if isinstance(x, tuple) else
                    x[:528].contiguous() if torch.is_tensor(x) else x
                    for x in args)
        full_ms = _ms(lambda: on("shared", None, *args))
        wave_ms = _ms(lambda: on("shared", None, *one))
        row.update(ms_1024_docs=full_ms, ms_528_docs=wave_ms,
                   shape=dict(zip("N C Lc Pc W R U".split(), shape)))
        res[key] = row
        print(f"{key} shared tier at {row['shape']}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "shape"), flush=True)
    return res


def profile_warp(dev) -> dict:
    """The warp tier's phases at the same shapes, its ring where
    ``warp_ring`` puts it: each phase's share of a document's cycles."""
    from chip_smoke import em_case, trunk_case

    cdll = build(warp=True)
    res = {}
    docs, L0, cb = trunk_case(dev, 1024, 125, 16, 128, 32, 0.0)
    rings, ecb, U = em_case(dev, 1024, 128, 512)
    for key, entry, (tensors, shape) in (
            ("T1", TSK.T1, TSK._trunk_inputs(docs, L0, cb, 16)),
            ("T2", TSK.T2, TSK._em_inputs(*rings, ecb, U))):
        N, C, Lc, Pc, W, R, U_ = shape
        ring = TSK.warp_ring(entry, Lc, Pc, W, R, U_)
        prof = torch.zeros(N * 16, dtype=torch.int64, device=dev)
        _run(cdll, entry, tensors, shape, dev, prof, TSK.code("warp", ring))
        torch.cuda.synchronize()
        w = prof.view(N, 16).double().sum(0).tolist()
        total = sum(w)
        row = {"ring": ring, "doc_cycles_mean": total / N,
               **{f"share {name}": w[j] / total
                  for j, name in enumerate(WARP_PHASES[key])}}
        res[key + "_warp"] = row
        print(f"{key} warp tier ({ring} ring): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    return res


# The algebra's profile shapes: (label, documents, Lc, Pc, lanes), 7a's and
# 7b's widths on commits and the global tier's hold on raw lanes.
ALG_SHAPES = (("3b", 1024, 128, 32, "commits"),
              ("3c", 1024, 512, 8, "commits"),
              ("global-raw", 64, 8192, 32, "raw"))


def profile_algebra(dev, source: str = None) -> dict:
    """A1-A4 (rebase in both tie forms) on every tier the library takes at
    :data:`ALG_SHAPES`: the kernel's device ms a call
    (``chip_smoke._queued_ms``) and, where the source stamps it, each phase's
    share of a document's cycles (thread 0 of a CTA, lane 0 of a warp) and
    a document's mean cycles."""
    from chip_smoke import _queued_ms, algebra_case

    cdll = build(algebra=source or "")
    res = {}
    for label, n, lc, pc, lanes in ALG_SHAPES:
        docs, L, a, b = algebra_case(dev, n, lc, pc, lanes)
        for entry, extra in ((TAK.A1, ()), (TAK.A2, (0,)), (TAK.A2, (1,)),
                             (TAK.A3, ()), (TAK.A4, ())):
            op = TAK.ENTRIES.index(entry)
            ins = ([docs, L, *a] if entry in (TAK.A1, TAK.A3)
                   else [*a, *b, L])
            for t, c in TAK.TIER_CODES.items():
                if cdll.tree_algebra_smem_bytes(op, lc, pc, c) < 0:
                    continue
                outs = TAK._outputs(entry, None, n, lc, pc, dev)
                prof = torch.zeros(n * 16, dtype=torch.int64, device=dev)
                if cdll.tree_prof_set(prof.data_ptr()) != 0:
                    raise RuntimeError("tree_prof_set failed")
                work = cdll.tree_algebra_work_ints(op, lc, pc, c)

                def run():
                    TAK.launch(cdll, entry, t, ins, outs, dev, (n, lc, pc),
                               extra, work)

                run()
                torch.cuda.synchronize()
                names = ALG_PHASES.get(entry, ())
                w = prof.view(n, 16).double().sum(0).tolist()[:len(names)]
                total = sum(w)
                key = (f"{label} {entry}{' c_after' if extra == (1,) else ''}"
                       f" {t}")
                res[key] = {"ms": _queued_ms(dev, run)}
                if total:
                    res[key].update(doc_cycles_mean=total / n, **{
                        f"share {p}": w[j] / total
                        for j, p in enumerate(names)})
                print(f"{key}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res[key].items()), flush=True)
        del docs, L, a, b
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("tree_scan_profile needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if "--algebra" in sys.argv:
        i = sys.argv.index("--source") + 1 if "--source" in sys.argv else 0
        rows = profile_algebra(dev, sys.argv[i] if i else None)
    else:
        rows = profile_warp(dev) if "--warp" in sys.argv else profile(dev)
    res = dict(card=smi, **rows)
    from chip_smoke import OUT_DIR

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tree_profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
