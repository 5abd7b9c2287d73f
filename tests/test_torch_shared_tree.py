"""The port's SharedTree over its ContainerRuntime against the reference.

Each test runs the same script on the reference (``ContainerRuntime`` +
``SharedTree`` over ``LocalFluidService``, device ingest as XLA on the
CPU) and on the port (the same classes, ``SharedTree(device="cpu")``),
and compares every replica's tree, the ingest counters (device vs host
commits and the fallback reasons) and the summaries.
"""

import numpy as np
import pytest

from fluidframework_tpu.runtime.container import ContainerRuntime as RefRT
from fluidframework_tpu.service.local_server import (
    LocalFluidService as RefSvc,
)
from fluidframework_tpu.tree.shared_tree import SharedTree as RefTree
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service.local_server import LocalFluidService
from fluidframework_tpu_torch.tree import SharedTree


class Side:
    """One package's service and runtimes, each with a tree "tree"."""

    def __init__(self, port: bool, n: int):
        if port:
            self.svc = LocalFluidService()
            self.make = lambda: ContainerRuntime(
                self.svc, "doc", channels=(SharedTree("tree", device="cpu"),))
        else:
            self.svc = RefSvc()
            self.make = lambda: RefRT(self.svc, "doc",
                                      channels=(RefTree("tree"),))
        self.rts = [self.make() for _ in range(n)]

    def join(self):
        self.rts.append(self.make())

    @property
    def trees(self):
        return [rt.get_channel("tree") for rt in self.rts]

    def drain(self):
        for rt in self.rts:
            rt.flush()
        busy = True
        while busy:
            busy = any(rt.process_incoming() for rt in self.rts)


def both(n=3):
    return Side(False, n), Side(True, n)


def check(ref: Side, port: Side):
    assert [t.get() for t in port.trees] == [t.get() for t in ref.trees]
    assert [t.ingest_stats for t in port.trees] == \
        [t.ingest_stats for t in ref.trees]


@pytest.mark.parametrize("move_prob", [0.0, 0.1])
def test_config3_script_in_lockstep(move_prob):
    """``config3_tree_rebase``'s editing loop (3 sessions, a flush every 4
    edits, ``process_incoming`` every 8) on both packages, compared at
    every incoming step and at the end, where all replicas converge."""
    sides = both()
    rng = np.random.default_rng(3)
    for i in range(120):
        k = int(rng.integers(0, 3))
        r = rng.random()
        for side in sides:
            t = side.trees[k]
            n = len(t)
            if move_prob and n > 3 and r < move_prob:
                t.move_nodes(i % (n - 1), 1, (i * 7) % (n - 1))
            elif n > 2 and r < 0.3 + move_prob:
                t.delete_nodes(i % (n - 1), 1)
            else:
                t.insert_nodes((i * 5) % (n + 1), [i])
            if i % 4 == 0:
                side.rts[k].flush()
            if i % 8 == 0:
                for rt in side.rts:
                    rt.process_incoming()
        if i % 8 == 0:
            check(*sides)
    for side in sides:
        side.drain()
    check(*sides)
    ref, port = sides
    got = [t.get() for t in port.trees]
    assert got[0] == got[1] == got[2]
    stats = [t.ingest_stats for t in port.trees]
    assert sum(s["device_commits"] + s["host_commits"] for s in stats) > 0


def test_catchup_rides_device_in_lockstep():
    """A fresh client catching up on a backlog drains its ingest boxcar
    through the device path on first read, then collaborates live."""
    sides = both(1)
    for side in sides:
        a = side.rts[0]
        ta = side.trees[0]
        for i in range(12):
            ta.insert_nodes(len(ta.get()), [f"item{i}"])
            a.flush()
            a.process_incoming()
        side.join()
        side.rts[1].process_incoming()
        assert side.trees[1].get() == ta.get()
    check(*sides)
    stats = sides[1].trees[1].ingest_stats
    assert stats["device_batches"] >= 1 and stats["device_commits"] >= 10
    for side in sides:
        a, b = side.rts
        side.trees[1].insert_nodes(0, ["from-b"])
        b.flush()
        a.process_incoming()
        b.process_incoming()
    check(*sides)


def test_summary_load_round_trip():
    """A summary after concurrent edits loads into a new client on each
    side; the summaries' tree blobs agree across packages and the loaded
    replica keeps collaborating."""
    sides = both(2)
    for side in sides:
        t0, t1 = side.trees
        t0.insert_nodes(0, list(range(10)))
        side.drain()
        t1.delete_nodes(2, 3)
        t0.move_nodes(0, 2, 4)
        t1.insert_nodes(1, ["x", "y"])
        side.drain()
        side.rts[0].submit_summary()
        side.drain()
    ref, port = sides
    assert port.rts[0].summarize()["channels"]["tree"] == \
        ref.rts[0].summarize()["channels"]["tree"]
    for side in sides:
        side.join()
        side.rts[2].process_incoming()
        side.trees[2].insert_nodes(0, ["late"])
        side.drain()
    check(ref, port)
    got = [t.get() for t in port.trees]
    assert got[0] == got[1] == got[2] and got[0][0] == "late"
