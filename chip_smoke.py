"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (``nvcc``, into the package's ``_build/``)
and the native ticket loop (``g++``), then:

1. kernels — holds K1 (merge apply), K2 (compact) and K3 (apply+compact)
   bit-exactly against their plain PyTorch versions on the card, at
   D=4096 docs x K=16 ops and S in {128, 512, 2048} rows, on random states
   and op streams that include capacity overflow, out-of-range positions,
   unknown writers, and local ops with acks; times each (median of
   CUDA-event timings) beside its byte-floor bound;
2. main path — drives ``TpuFleetService`` at 100,000 docs x capacity 128 x
   16 ops/doc/round: a warm-up round plus 3 timed rounds at
   compact_every=1 (a scribe sweep of n_docs/3 docs in each), then 2 rounds
   at compact_every=2 with a standalone compaction between them, so K1 and
   K2 launch too; asserts zero ticket errors, a
   clean device err lane, and final tables/scalars bit-equal to a replay
   through the plain versions from a copy of the start state; then times
   each kernel against its plain version at the main path's shapes.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero. A
longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fluidframework_tpu_torch.ops import _cuda
from fluidframework_tpu_torch.ops import apply_kernel as K1
from fluidframework_tpu_torch.ops import compact_kernel as K2
from fluidframework_tpu_torch.protocol.constants import (
    ERR_CAPACITY,
    ERR_CLIENT,
    ERR_RANGE,
    F_ARG,
    F_CLIENT,
    F_LEN,
    F_LSEQ,
    F_MSN,
    F_POS1,
    F_POS2,
    F_REF,
    F_SEQ,
    F_TYPE,
    NO_CLIENT,
    OP_INSERT,
    OP_REMOVE,
    OP_WIDTH,
    RSEQ_NONE,
    UNASSIGNED_SEQ,
)
from fluidframework_tpu_torch.ops.segment_state import SEGMENT_LANES
from fluidframework_tpu_torch.service.fleet_service import TpuFleetService
from fluidframework_tpu_torch.utils.native import _load_ticket

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

KERNELS = {
    "K1_merge_apply": dict(
        wrapper=K1.apply_ops_packed, plain=K1.apply_plain, takes_ops=True,
        replaces="fluidframework_tpu/ops/pallas_kernel.py:389",
    ),
    "K2_zamboni_compact": dict(
        wrapper=K2.compact_packed, plain=K2.compact_plain, takes_ops=False,
        replaces="fluidframework_tpu/ops/pallas_compact.py:186",
    ),
    "K3_fused_apply_compact": dict(
        wrapper=K2.apply_compact_packed, plain=K2.apply_compact_plain,
        takes_ops=True,
        replaces="fluidframework_tpu/ops/pallas_compact.py:273",
    ),
}


class RoundGen:
    """Config 5's ``generate_round`` (bench_configs.py): per doc, K-1
    inserts/removes at random positions and a closing whole-doc remove, so
    device tables stay bounded. Host content only — ticketing is the
    service's job."""

    def __init__(self, n_docs: int, k: int, seed: int):
        self.n, self.k = n_docs, k
        self.rng = np.random.default_rng(seed)
        self.lengths = np.zeros(n_docs, np.int64)
        self.cseqs = np.zeros(n_docs, np.int64)

    def __call__(self, svc):
        n, k = self.n, self.k
        rows = np.zeros((n, k, OP_WIDTH), np.int32)
        intents = np.zeros((n, k, 3), np.int32)
        start_seq = svc.fseq.doc_state[:, 0].astype(np.int64)
        for i in range(k):
            self.cseqs[:] += 1
            intents[:, i, 0] = 0
            intents[:, i, 1] = self.cseqs
            intents[:, i, 2] = start_seq + i
            if i == k - 1:
                rows[:, i, F_TYPE] = OP_REMOVE
                rows[:, i, F_POS1] = 0
                rows[:, i, F_POS2] = self.lengths
                self.lengths[:] = 0
            else:
                roll = self.rng.random(n)
                pos = self.rng.random(n)
                rem = (self.lengths >= 6) & (roll < 0.4)
                a = (pos * np.maximum(self.lengths - 2, 1)).astype(np.int64)
                rows[:, i, F_TYPE] = np.where(rem, OP_REMOVE, OP_INSERT)
                rows[:, i, F_POS1] = np.where(
                    rem, a, (pos * (self.lengths + 1)).astype(np.int64)
                )
                rows[:, i, F_POS2] = np.where(rem, a + 2, 0)
                rows[:, i, F_ARG] = np.where(rem, 0, 10 + i)
                rows[:, i, F_LEN] = np.where(rem, 0, 3)
                self.lengths[:] += np.where(rem, -2, 3)
        return intents, rows


def random_case(rng, n_docs: int, cap: int, k: int, device):
    """A random packed state and op batch that reach every kernel branch:
    tables up to full (capacity overflow), positions past the visible
    length (ERR_RANGE), writer slots past the cap (ERR_CLIENT), pending
    local rows with acks of them, tombstones below and above min_seq."""
    d, s = n_docs, cap
    count = rng.integers(0, s + 1, d)
    near_full = rng.random(d) < 0.25
    count[near_full] = s - rng.integers(0, 3, near_full.sum())
    live = np.arange(s)[None, :] < count[:, None]
    shape = (d, s)
    lanes = {}
    lanes["kind"] = np.ones(shape, np.int64)
    lanes["orig"] = rng.integers(1, 40, shape)
    lanes["off"] = rng.integers(0, 6, shape)
    lanes["length"] = rng.integers(1, 6, shape)
    local_ins = rng.random(shape) < 0.1
    lanes["seq"] = np.where(local_ins, UNASSIGNED_SEQ,
                            rng.integers(1, 200, shape))
    lanes["client"] = rng.integers(0, 8, shape)
    lanes["lseq"] = np.where(local_ins, rng.integers(1, 20, shape), 0)
    rsel = rng.random(shape)
    lanes["rseq"] = np.where(rsel < 0.7, RSEQ_NONE, np.where(
        rsel < 0.8, UNASSIGNED_SEQ, rng.integers(1, 200, shape)))
    lanes["rlseq"] = np.where((rsel >= 0.7) & (rsel < 0.8),
                              rng.integers(1, 20, shape), 0)
    removed = lanes["rseq"] != RSEQ_NONE
    lanes["rbits"] = np.where(removed, 1 << rng.integers(0, 8, shape), 0)
    lanes["rbits2"] = np.zeros(shape, np.int64)
    lanes["rbits3"] = np.zeros(shape, np.int64)
    ann = rng.random(shape) < 0.2
    lanes["aseq"] = np.where(ann, rng.integers(1, 200, shape), 0)
    lanes["alseq"] = np.where(ann & (rng.random(shape) < 0.3),
                              rng.integers(1, 20, shape), 0)
    lanes["aval"] = np.where(ann, rng.integers(1, 9, shape), 0)
    fills = {"kind": 0, "rseq": RSEQ_NONE}
    tables = np.stack([
        np.where(live, lanes[n], fills.get(n, 0)) for n in SEGMENT_LANES
    ]).astype(np.int32)
    scalars = np.zeros((d, K1.N_SCALARS), np.int32)
    scalars[:, K1.SC_COUNT] = count
    scalars[:, K1.SC_MIN_SEQ] = rng.integers(0, 120, d)
    scalars[:, K1.SC_CUR_SEQ] = 200
    scalars[:, K1.SC_SELF] = np.where(rng.random(d) < 0.5, NO_CLIENT, 2)

    ops = np.zeros((d, k, OP_WIDTH), np.int32)
    ty = rng.choice(8, size=(d, k), p=[.04, .4, .2, .15, .07, .07, .05, .02])
    pos1 = rng.integers(0, 3 * s + 20, (d, k))
    local = rng.random((d, k)) < 0.2
    ops[:, :, F_TYPE] = ty
    ops[:, :, F_POS1] = pos1
    ops[:, :, F_POS2] = pos1 + rng.integers(1, 40, (d, k))
    ops[:, :, F_SEQ] = np.where(local, UNASSIGNED_SEQ,
                                201 + np.arange(k)[None, :])
    ops[:, :, F_REF] = rng.integers(100, 201, (d, k))
    ops[:, :, F_CLIENT] = np.where(rng.random((d, k)) < 0.03,
                                   rng.integers(93, 100, (d, k)),
                                   rng.integers(0, 8, (d, k)))
    ops[:, :, F_LSEQ] = rng.integers(1, 20, (d, k))
    ops[:, :, F_ARG] = rng.integers(1, 40, (d, k))
    ops[:, :, F_LEN] = rng.integers(1, 6, (d, k))
    ops[:, :, F_MSN] = 100 + np.cumsum(rng.integers(0, 4, (d, k)), axis=1)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(tables), as_t(scalars), as_t(ops)


def _median_ms(fn, reset, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each on a
    freshly reset input (the reset runs outside the timed window)."""
    times = []
    for _ in range(reps):
        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_bytes(name: str, d: int, s: int, k: int) -> int:
    """Bytes the function must move: the tables and scalars read once and
    written once, the ops read once."""
    nbytes = 2 * (K1.N_LANES * d * s * 4 + d * K1.N_SCALARS * 4)
    if KERNELS[name]["takes_ops"]:
        nbytes += d * k * OP_WIDTH * 4
    return nbytes


def hold_kernel(name: str, t0, s0, ops, kernel_reps=10, plain_reps=3):
    """Run one kernel wrapper and its plain version on the same input on
    the card; assert bit equality; return (max_abs_err, ms, plain_ms)."""
    spec = KERNELS[name]
    args = (ops,) if spec["takes_ops"] else ()
    want = spec["plain"](t0, s0, *args)
    t, s = t0.clone(), s0.clone()
    spec["wrapper"](t, s, *args)
    torch.cuda.synchronize()
    err = max(int((t.long() - want[0].long()).abs().max()),
              int((s.long() - want[1].long()).abs().max()))
    if not (torch.equal(t, want[0]) and torch.equal(s, want[1])):
        bad = (t != want[0]).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: kernel != plain, max_abs_err {err}, "
                             f"first [lane, doc, row] {bad}")
    del want

    def reset():
        t.copy_(t0)
        s.copy_(s0)

    ms = _median_ms(lambda: spec["wrapper"](t, s, *args), reset, kernel_reps)
    plain_ms = _median_ms(lambda: spec["plain"](t0, s0, *args), lambda: None,
                          plain_reps)
    return err, ms, plain_ms


def phase_kernels(device, report):
    rows = []
    for cap in (128, 512, 2048):
        rng = np.random.default_rng(cap)
        t0, s0, ops = random_case(rng, 4096, cap, 16, device)
        for name in KERNELS:
            err, ms, plain_ms = hold_kernel(name, t0, s0, ops)
            b = bound_bytes(name, 4096, cap, 16)
            rows.append(dict(kernel=name, docs=4096, cap=cap, k=16,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b / HBM_BYTES_PER_S * 1e3,
                             bound_bytes=b))
            print(f"kernels S={cap} {name}: exact, {ms:.4f} ms "
                  f"(plain {plain_ms:.3f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms)", flush=True)
        t, s = t0.clone(), s0.clone()
        K1.apply_ops_packed(t, s, ops)
        errs = s[:, K1.SC_ERR]
        cov = {bit: float(((errs & v) != 0).float().mean())
               for bit, v in (("capacity", ERR_CAPACITY),
                              ("range", ERR_RANGE), ("client", ERR_CLIENT))}
        print(f"kernels S={cap} err-bit coverage (share of docs): {cov}",
              flush=True)
        rows[-1]["err_coverage"] = cov
        del t0, s0, ops, t, s
        torch.cuda.empty_cache()
    report["phase_kernels"] = rows


def phase_main_path(device, report, n_docs=100_000, cap=128, k=16):
    """Config 5 through the service API; returns the inputs the main-path
    kernel timings use."""
    svc = TpuFleetService(n_docs, capacity=cap, compact_every=1,
                          device=device)
    svc.join_writer(0)
    print(f"main path: {n_docs} docs x {cap} rows x {k} ops/doc/round, "
          f"native_ticket={svc.fseq.native_available}", flush=True)
    gen = RoundGen(n_docs, k, seed=0)
    start = (svc.tables.clone(), svc.scalars.clone())
    replay = []  # (plain version, ops on the card) per state update

    def commit(tok):
        due = (svc.rounds_applied + 1) % svc.compact_every == 0
        replay.append((K2.apply_compact_plain if due else K1.apply_plain,
                       tok[2]))
        err, stamped = svc.commit_round(tok)
        if err.any():
            raise AssertionError(f"{int((err != 0).sum())} docs refused")
        return stamped

    def sweep_round(tok, next_batch):
        stamped = commit(tok)
        pend = svc.begin_summarize_dirty(threshold=1, max_docs=n_docs // 3)
        nxt = svc.stage_round(*next_batch) if next_batch else None
        pend.stage()
        done = pend.finish()
        return stamped, nxt, done

    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    # Warm-up round (config 5: a full round, then scribe sweeps).
    t_w = time.perf_counter()
    tok = svc.stage_round(*gen(svc))
    _, tok, _ = sweep_round(tok, gen(svc))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_w

    rounds = 3
    ev = []
    summaries = []
    # Host wall per stage of the loop, summed over the timed rounds:
    # gen = traffic generation (the client side, not the service),
    # stage_round = ticketing + stamping + op-wire upload, commit = kernel
    # enqueue, sweep = the scribe's begin + stage + finish.
    host = dict(gen=0.0, stage_round=0.0, ticket=0.0, commit=0.0, sweep=0.0)
    sweep_parts: dict = {}
    clock = time.perf_counter
    t0 = clock()
    for r in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        th = clock()
        a.record()
        stamped = commit(tok)
        b.record()
        host["commit"] += clock() - th
        ev.append((a, b))
        th = clock()
        pend = svc.begin_summarize_dirty(threshold=1, max_docs=n_docs // 3)
        host["sweep"] += clock() - th
        th = clock()
        batch = gen(svc)
        host["gen"] += clock() - th
        th = clock()
        tok = svc.stage_round(*batch)
        host["stage_round"] += clock() - th
        host["ticket"] += svc.last_ticket_s
        th = clock()
        pend.stage()
        summaries.append(pend.finish())
        host["sweep"] += clock() - th
        for key, v in pend.breakdown.items():
            sweep_parts[key] = sweep_parts.get(key, 0.0) + v
    torch.cuda.synchronize()
    dt = clock() - t0
    commit_ms = [x.elapsed_time(y) for x, y in ev]
    if int(svc.device_errors().sum()) != 0:
        raise AssertionError("device err lane is set after the timed rounds")

    # Two rounds at compact_every=2: the first applies with K1 alone and a
    # standalone compaction (K2) follows it. The state before the last
    # round and its ops are the inputs of the main-path kernel timings.
    svc.compact_every = 2
    stamped = commit(tok)
    tok = svc.stage_round(*gen(svc))
    svc.compact()
    replay.append((K2.compact_plain, None))
    pre = (svc.tables.clone(), svc.scalars.clone())
    stamped = commit(tok)
    torch.cuda.synchronize()
    launches = {name: spec["wrapper"].launches
                for name, spec in KERNELS.items()}
    errs = int(svc.device_errors().sum())
    if errs != 0:
        raise AssertionError(f"device err lane sum {errs} != 0")
    tele = svc.telemetry_slice(4)
    text_rows = int(svc.doc_state(0).count)
    del stamped

    # Replay every committed round through the plain versions, on the card,
    # from a copy of the start state.
    t, s = start
    for plain, ops in replay:
        t, s = plain(t, s) if ops is None else plain(t, s, ops)
    if not (torch.equal(t, svc.tables) and torch.equal(s, svc.scalars)):
        raise AssertionError("service state != plain replay")
    del t, s, start
    torch.cuda.empty_cache()

    ops_total = n_docs * k * rounds
    main = dict(
        n_docs=n_docs, cap=cap, k=k, rounds_timed=rounds,
        ops_per_s=ops_total / dt, ms_per_round=dt / rounds * 1e3,
        warmup_s=warm_s,
        host_ms_per_round={key: v / rounds * 1e3 for key, v in host.items()},
        sweep_ms_per_round={key: v / rounds for key, v in
                            sweep_parts.items()},
        k3_share_of_round=sum(commit_ms) / (dt * 1e3),
        commit_event_ms=commit_ms, launches=launches,
        summaries=summaries, native_ticket=svc.fseq.native_available,
        wire16_rounds=svc.wire16_rounds, wire32_rounds=svc.wire32_rounds,
        telemetry_rows_in_use=int(tele[:, 1].sum()), doc0_count=text_rows,
        replay_exact=True,
    )
    report["main_path"] = main
    print(f"main path: {main['ops_per_s']:.0f} ops/s, "
          f"{main['ms_per_round']:.2f} ms/round, K3 commit "
          f"{np.median(commit_ms):.4f} ms (CUDA events), host ms/round "
          f"{ {k2: round(v, 2) for k2, v in main['host_ms_per_round'].items()} }, "
          f"native_ticket={main['native_ticket']}, summaries {summaries}, "
          "replay exact", flush=True)
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return pre, replay[-1][1], launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report["card"] = smi

    t_b = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        so = pool.submit(_cuda.build)
        ticket = pool.submit(_load_ticket)
        so.result()
        ticket.result()
    report["build_s"] = time.perf_counter() - t_b
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)

    phase_kernels(device, report)
    (t0, s0), ops, launches = phase_main_path(device, report)
    torch.cuda.empty_cache()

    # Each kernel against its plain version at the main path's shapes.
    d, cap = t0.shape[1], t0.shape[2]
    k = ops.shape[1]
    kernels = []
    for name, spec in KERNELS.items():
        err, ms, plain_ms = hold_kernel(name, t0, s0, ops)
        b = bound_bytes(name, d, cap, k)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluidframework_tpu_torch/csrc/merge_kernels.cu",
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        })
        print(f"main-path shape {name}: {ms:.4f} ms (plain {plain_ms:.2f} "
              f"ms, bound {kernels[-1]['bound_ms']:.4f} ms)", flush=True)
    report["kernels"] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
