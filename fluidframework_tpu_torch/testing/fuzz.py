"""Fuzz op-stream generators shared by the test suite and the bench's
on-device state-parity check.

The reference pins merge semantics with randomized "farm" suites
(``packages/dds/merge-tree/src/test/client.conflictFarm.spec.ts``); the
generator here produces the sequenced-stream equivalent: valid fully-acked
op soups evolved alongside the pure-Python oracle so device kernels can be
compared byte-for-byte against it.
"""

from __future__ import annotations

import numpy as np

from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.testing.oracle import OracleDoc


def random_acked_stream(
    rng: np.random.Generator,
    n_ops: int,
    payloads: dict,
    track: OracleDoc,
    msn_lag: int | None = None,
    caught_up: bool = False,
    seq0: int = 1,
):
    """Valid fully-acked sequenced ops, evolving alongside an oracle.

    ``msn_lag``: if set, each op carries ``msn = max(0, seq - msn_lag)`` so
    the collab window advances behind the stream — compaction (zamboni)
    then has real tombstones to reclaim mid-stream.

    ``caught_up``: pin every insert's refSeq to ``seq - 1``. With random
    (older) refs, a position drawn from the latest text can exceed the
    op's own perspective — both kernel and oracle then clamp identically
    (ERR_RANGE set), which is fine for parity fuzz but not for an
    err-free artifact stream.
    """
    ops = []
    next_orig = len(payloads) + 1
    for seq in range(seq0, seq0 + n_ops):
        msn = max(0, seq - msn_lag) if msn_lag is not None else 0
        length = len(track.text(payloads))
        kind = int(rng.integers(0, 3)) if length > 0 else 0
        client = int(rng.integers(0, 6))
        if kind == 0:
            n = int(rng.integers(1, 6))
            # Distinct content per insert so text comparison catches
            # ordering bugs, not just length bugs.
            payloads[next_orig] = "".join(
                chr(97 + int(rng.integers(0, 26))) for _ in range(n)
            )
            ref = (
                seq - 1
                if caught_up or msn >= seq - 1
                else int(rng.integers(msn, seq))
            )
            op = E.insert(
                int(rng.integers(0, length + 1)), next_orig, n,
                seq=seq, ref=ref, client=client, msn=msn,
            )
            next_orig += 1
        elif kind == 1:
            a = int(rng.integers(0, length))
            b = int(rng.integers(a + 1, length + 1))
            op = E.remove(a, b, seq=seq, ref=seq - 1, client=client, msn=msn)
        else:
            a = int(rng.integers(0, length))
            b = int(rng.integers(a + 1, length + 1))
            op = E.annotate(
                a, b, int(rng.integers(1, 100)), seq=seq, ref=seq - 1,
                client=client, msn=msn,
            )
        ops.append(op)
        track.apply(op)
    return ops
