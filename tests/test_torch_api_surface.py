"""The port's public surface against the reference's API report, and the
thin functions that complete it against their reference functions.

``api-report/fluidframework_tpu.api.txt`` lists every module of the
reference and each public name in it (classes, constants, functions,
imported names included). Read here and never written, it is walked
against ``fluidframework_tpu_torch``: every module and every name must
exist at the same subpath, except exactly five entries that are not
ported by design (:data:`NOT_PORTED`). The thin functions added for
names the port lacked (``merge_kernel.perspective`` and
``insert_place_mask``, ``device_trunk.trunk_scan``,
``device_em.em_trunk_scan_one`` and ``em_trunk_scan_ring_one``,
``sharded_doc.sharded_apply_ops``, ``native.native_ticket_available``)
are held to the reference's on the CPU, bit for bit;
``sharded_apply_ops`` against the reference's run under ``shard_map`` on
the eight virtual CPU devices of tests/conftest.py.
"""

import importlib
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from fluidframework_tpu.ops import merge_kernel as RM
from fluidframework_tpu.ops import segment_state as RS
from fluidframework_tpu.parallel import sharded_doc as RSD
from fluidframework_tpu.parallel.mesh import compat_shard_map
from fluidframework_tpu.testing.fuzz import random_acked_stream
from fluidframework_tpu.testing.oracle import OracleDoc
from fluidframework_tpu.testing import tree_streams as RTS
from fluidframework_tpu.tree import device_em as RE
from fluidframework_tpu.tree import device_trunk as RT
from fluidframework_tpu.utils import native as ref_native
from fluidframework_tpu_torch.interop import segment_state_from_numpy
from fluidframework_tpu_torch.ops import merge_kernel as M
from fluidframework_tpu_torch.ops.segment_state import SegmentState
from fluidframework_tpu_torch.parallel import sharded_doc as SD
from fluidframework_tpu_torch.protocol.constants import (
    F_POS1,
    F_TYPE,
    NO_CLIENT,
    OP_INSERT,
)
from fluidframework_tpu_torch.tree import device_em as DE
from fluidframework_tpu_torch.tree import device_trunk as DT
from fluidframework_tpu_torch.utils import native
from test_torch_sharded_doc import baseline_doc
from test_torch_tree_scan import raw_em, same, streams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(REPO, "api-report", "fluidframework_tpu.api.txt")

# (module, name); name None = the whole module.
NOT_PORTED = {
    ("ops.pallas_kernel", None),
    ("ops.pallas_compact", None),
    ("parallel.aot", None),
    ("ops.segment_state", "interactive_device"),
    ("parallel.mesh", "compat_shard_map"),
}


def read_report() -> dict:
    """{module (without the package prefix): [(kind, name), ...]}."""
    out, cur = {}, None
    with open(REPORT) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if not line.startswith(" "):
                mod = line.rstrip(":")
                cur = mod[len("fluidframework_tpu"):].lstrip(".")
                out[cur] = []
            else:
                kind, name = line.split()
                out[cur].append((kind, name))
    return out


REPORT_MODULES = read_report()


def port_module(mod: str):
    return importlib.import_module(
        "fluidframework_tpu_torch" + (f".{mod}" if mod else ""))


def test_report_is_the_reference_surface():
    assert len(REPORT_MODULES) == 109
    assert sum(len(v) for v in REPORT_MODULES.values()) == 952
    for mod, _name in NOT_PORTED:
        assert mod in REPORT_MODULES


@pytest.mark.parametrize("mod", sorted(REPORT_MODULES))
def test_module_and_names_exist_in_the_port(mod):
    if (mod, None) in NOT_PORTED:
        with pytest.raises(ModuleNotFoundError):
            port_module(mod)
        return
    m = port_module(mod)
    missing = [name for _kind, name in REPORT_MODULES[mod]
               if not hasattr(m, name) and (mod, name) not in NOT_PORTED]
    assert not missing, f"{mod} lacks {missing}"
    for kind, name in REPORT_MODULES[mod]:
        if (mod, name) in NOT_PORTED:
            assert not hasattr(m, name)
        elif kind in ("class", "def"):
            assert callable(getattr(m, name)), (mod, name)


def test_exactly_five_entries_are_not_ported():
    absent = set()
    for mod, names in REPORT_MODULES.items():
        try:
            m = port_module(mod)
        except ModuleNotFoundError:
            absent.add((mod, None))
            continue
        absent |= {(mod, n) for _k, n in names if not hasattr(m, n)}
    assert absent == NOT_PORTED


def _plain(v) -> bool:
    """A constant made of numbers, strings and tuples of them."""
    if isinstance(v, tuple):
        return all(_plain(x) for x in v)
    return v is None or isinstance(v, (int, str, float, bool))


def test_constants_equal_the_reference():
    compared = 0
    for mod, names in sorted(REPORT_MODULES.items()):
        if (mod, None) in NOT_PORTED:
            continue
        ref = importlib.import_module(
            "fluidframework_tpu" + (f".{mod}" if mod else ""))
        port = port_module(mod)
        for kind, name in names:
            if kind != "const":
                continue
            a, b = getattr(ref, name), getattr(port, name)
            if _plain(a):
                assert a == b, (mod, name)
                compared += 1
    assert compared > 200


# ---------------------------------------------------------------------------
# merge_kernel.perspective / insert_place_mask


def ref_state(seed, cap=64, client=1, n_ops=48):
    """A reference single-document state after a random acked stream
    (inserts, removes, annotates, local ops and acks), its op rows."""
    rng = np.random.default_rng(seed)
    track = OracleDoc(client)
    rows = np.stack(random_acked_stream(rng, n_ops, {}, track)).astype(
        np.int32)
    state = RM.jit_apply_ops(RS.make_state(cap, client), rows)
    return state, rows


def as_port(state):
    return segment_state_from_numpy(
        [np.asarray(x) for x in RS.to_host(state)], device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_perspective_and_insert_place_mask_match_the_reference(seed):
    state, rows = ref_state(seed)
    port = as_port(state)
    top = int(np.asarray(state.cur_seq))
    for ref_seq in (0, top // 2, top):
        for client in (0, 1, 2, 93, NO_CLIENT):
            for is_local in (False, True):
                part, vis = RM.perspective(state, ref_seq, client, is_local)
                gp, gv = M.perspective(port, ref_seq, client, is_local)
                assert gp.dtype == torch.bool and gv.dtype == torch.int32
                np.testing.assert_array_equal(gp.numpy(), np.asarray(part))
                np.testing.assert_array_equal(gv.numpy(), np.asarray(vis))
                for op in rows[rows[:, F_TYPE] == OP_INSERT][:6]:
                    prefix = np.cumsum(np.asarray(vis)) - np.asarray(vis)
                    rem = (op[F_POS1] - prefix).astype(np.int32)
                    want = RM.insert_place_mask(state, op, part, vis, rem)
                    got = M.insert_place_mask(port, op, gp, gv,
                                              torch.from_numpy(rem))
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))


def test_perspective_on_a_batch_equals_each_document():
    states = [ref_state(s)[0] for s in range(3)]
    batch = SegmentState(*[torch.stack(list(x)) for x in zip(
        *[as_port(s) for s in states])])
    refs = torch.tensor([5, 9, 40], dtype=torch.int32)
    clients = torch.tensor([0, 1, 2], dtype=torch.int32)
    local = torch.tensor([False, True, False])
    part, vis = M.perspective(batch, refs, clients, local)
    for d, s in enumerate(states):
        rp, rv = RM.perspective(s, int(refs[d]), int(clients[d]),
                                bool(local[d]))
        np.testing.assert_array_equal(part[d].numpy(), np.asarray(rp))
        np.testing.assert_array_equal(vis[d].numpy(), np.asarray(rv))


def test_reexported_helpers_are_the_port_functions():
    from fluidframework_tpu_torch.ops import segment_state as S

    assert M.removed_by_slot is S.removed_by_slot
    assert M.writer_bits is S.writer_bits
    assert SD.insert_place_mask is M.insert_place_mask
    assert SD.perspective is M.perspective
    assert SD.make_state is S.make_state


# ---------------------------------------------------------------------------
# device_trunk.trunk_scan, device_em.em_trunk_scan_one / _ring_one


@pytest.mark.parametrize("move_prob", [0.0, 0.2])
def test_trunk_scan_matches_the_reference(move_prob):
    Lc, Pc, W = 32, 16, 8
    batch = RTS.to_device_batch(streams(11, 3, 20, W, Lc, move_prob), Lc, Pc)
    for d in range(3):
        one = RT.CommitBatch(*[None if x is None else np.asarray(x)[d]
                               for x in batch])
        ids, L = np.zeros(Lc, np.int32), np.int32(0)
        ref = RT.trunk_scan(ids, L, one, W)
        got = DT.trunk_scan(ids, L, DT.CommitBatch(*one), W, device="cpu")
        assert got[1].shape == () and got[2].shape == ()
        same(ref, got, f"trunk_scan doc {d}")
        row = DT.batched_trunk_scan(np.zeros((3, Lc), np.int32),
                                    np.zeros(3, np.int32),
                                    DT.CommitBatch(*batch), W, device="cpu")
        same([x[d] for x in row], got, f"batched row {d}")


@pytest.mark.parametrize("seed", range(2))
def test_em_scans_one_match_the_reference(seed):
    rings, mov, lanes, U, W = raw_em(seed, N=3)
    for d in range(3):
        ring_d = [np.asarray(x)[d] for x in rings]
        lanes_d = [np.asarray(x)[d] for x in lanes]
        ref = RE.em_trunk_scan_ring_one(*ring_d, np.int32(mov[d]),
                                        RE.EmCommitBatch(*lanes_d), U)
        got = DE.em_trunk_scan_ring_one(*ring_d, int(mov[d]),
                                        DE.EmCommitBatch(*lanes_d), U,
                                        device="cpu")
        same(ref, got, f"ring one doc {d}")
        doc, L, base = ring_d[0][-1], ring_d[1][-1], ring_d[2][-1]
        ref1 = RE.em_trunk_scan_one(doc, L, base,
                                    RE.EmCommitBatch(*lanes_d[:8]), W, U)
        got1 = DE.em_trunk_scan_one(doc, L, base,
                                    DE.EmCommitBatch(*lanes_d[:8]), W, U,
                                    device="cpu")
        same(ref1, got1, f"single-base one doc {d}")


def test_apply_change_is_reexported():
    from fluidframework_tpu_torch.ops import tree_kernel

    assert DE.apply_change is tree_kernel.apply_change
    assert DT.apply_change is tree_kernel.apply_change


# ---------------------------------------------------------------------------
# sharded_doc.sharded_apply_ops against the reference under shard_map


def ref_sharded_step(n: int):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seg",))
    spec = RS.SegmentState(*([P("seg")] * len(RS.SegmentState._fields)))

    def step(state, ops):
        squeezed = RS.SegmentState(*[x[0] for x in state])
        out = RSD.sharded_apply_ops(squeezed, ops, "seg", n)
        return RS.SegmentState(*[x[None] for x in out])

    return jax.jit(compat_shard_map(step, mesh=mesh, in_specs=(spec, P()),
                                    out_specs=spec))


@pytest.mark.parametrize("seed", range(3))
def test_sharded_apply_ops_matches_shard_map(seed):
    n = 8
    assert len(jax.devices()) >= n
    payloads = {}
    base, next_seq = baseline_doc(24, payloads)
    ref_doc = RSD.ShardedDoc(shard_cap=64)
    ref_doc.load_single(base)
    start = ref_doc.state
    track = OracleDoc(NO_CLIENT)
    h = [np.asarray(x) for x in base]
    from fluidframework_tpu.ops import encode as REN

    for i in range(int(h[15])):
        track.apply(REN.insert(3 * i, int(h[1][i]), 3, seq=i + 1, ref=i,
                               client=0))
    rng = np.random.default_rng(seed + 7)
    ops = np.stack(random_acked_stream(rng, 30, payloads, track,
                                       caught_up=True, seq0=next_seq)
                   ).astype(np.int32)
    want = ref_sharded_step(n)(start, ops)
    port_in = SegmentState(*[torch.from_numpy(np.array(x)) for x in start])
    before = [x.clone() for x in port_in]
    got = SD.sharded_apply_ops(port_in, ops)
    for f, a, b in zip(SegmentState._fields, want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for a, b in zip(before, port_in):
        assert torch.equal(a, b)  # the input is left as it was
    # The same ops through ShardedDoc.apply on an 8-entry CPU mesh.
    from fluidframework_tpu_torch.parallel.mesh import Mesh

    doc = SD.ShardedDoc(64, Mesh(["cpu"] * n, "seg"))
    doc.load_state([np.asarray(x) for x in start])
    doc.apply(ops)
    for f, a, b in zip(SegmentState._fields, doc.state, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


# ---------------------------------------------------------------------------
# utils.native.native_ticket_available


def test_native_ticket_available_equals_the_reference():
    assert native.native_ticket_available() == \
        ref_native.native_ticket_available()
    assert native.native_ticket_available() == \
        native.NativeTicketLoop().available
