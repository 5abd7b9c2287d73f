"""Sequenced op batches of the bench's packed-kernel configurations.

Copies of the generators in ``bench.py`` (``build_op_stream``: config 2
and config 2b) and ``bench_configs.py`` (``config4_matrix_axis_merge``'s
inline script), so the port reproduces those configurations' inputs
without importing either (both import the reference package). Each
returns int32 ops [D, K, OP_WIDTH]: 16 distinct document scripts tiled
over the D documents, each closed by a whole-document remove that
advances the collab window past every stamp, so after compaction the
table is empty again and the same stream replays validly forever.
"""

from __future__ import annotations

import numpy as np

from fluidframework_tpu_torch.ops import encode as E
from fluidframework_tpu_torch.protocol.constants import OP_WIDTH


def build_op_stream(n_docs: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """Config 2b's batches: an insert/remove mix with fully-acked refs
    (``bench.build_op_stream``)."""
    ops = np.zeros((n_docs, k, OP_WIDTH), np.int32)
    for d in range(min(n_docs, 16)):  # 16 distinct doc scripts, tiled
        length = 0
        seq = 0
        for i in range(k - 1):
            seq += 1
            if length >= 8 and rng.random() < 0.45:
                a = int(rng.integers(0, length - 2))
                b = a + int(rng.integers(1, 3))
                ops[d, i] = E.remove(a, b, seq=seq, ref=seq - 1,
                                     client=int(rng.integers(0, 8)))
                length -= b - a
            else:
                ops[d, i] = E.insert(
                    int(rng.integers(0, length + 1)), 1000 + i, 4,
                    seq=seq, ref=seq - 1, client=int(rng.integers(0, 8)),
                )
                length += 4
        ops[d, k - 1] = E.remove(0, length, seq=k, ref=k - 1, client=0,
                                 msn=k)
    for d in range(16, n_docs):
        ops[d] = ops[d % 16]
    return ops


def matrix_axis_stream(n_docs: int, k: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Config 4's batches: ``n_docs`` kernel documents (two permutation
    vectors per matrix), row/col inserts of 4, removes and annotates of 2
    (``bench_configs.config4_matrix_axis_merge``)."""
    ops = np.zeros((n_docs, k, OP_WIDTH), np.int32)
    for d in range(min(n_docs, 16)):
        length = 0
        for i in range(k - 1):
            seq = i + 1
            roll = rng.random()
            if length > 6 and roll < 0.3:
                a = int(rng.integers(0, length - 2))
                ops[d, i] = E.remove(a, a + 2, seq=seq, ref=seq - 1,
                                     client=int(rng.integers(0, 8)))
                length -= 2
            elif length > 4 and roll < 0.5:
                a = int(rng.integers(0, length - 2))
                ops[d, i] = E.annotate(a, a + 2, 1 + i % 7, seq=seq,
                                       ref=seq - 1,
                                       client=int(rng.integers(0, 8)))
            else:
                ops[d, i] = E.insert(int(rng.integers(0, length + 1)),
                                     100 + i, 4, seq=seq, ref=seq - 1,
                                     client=int(rng.integers(0, 8)))
                length += 4
        ops[d, k - 1] = E.remove(0, length, seq=k, ref=k - 1, client=0,
                                 msn=k)
    for d in range(16, n_docs):
        ops[d] = ops[d % 16]
    return ops
