"""The packed multi-doc unpack.

Counterpart of ``unpack_packed_doc_states`` in
``fluidframework_tpu/parallel/mesh.py``; the rest of the mesh (``DocShard``
over several devices) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from fluidframework_tpu_torch.ops.apply_kernel import (
    SC_COUNT,
    SC_CUR_SEQ,
    SC_ERR,
    SC_MIN_SEQ,
    SC_SELF,
)
from fluidframework_tpu_torch.ops.segment_state import (
    SEGMENT_LANES,
    SegmentState,
)


def unpack_packed_doc_states(
    host: np.ndarray, docs, s: int, pad: int = 0
) -> dict:
    """Split one packed-layout multi-doc readback — ``[L, pad, S]`` lane
    planes followed by ``[pad, N_SCALARS]`` scalar rows, flattened into one
    vector — into per-doc SegmentStates of numpy arrays (``pad`` rows
    beyond ``len(docs)`` are gather padding, discarded)."""
    pad = pad or len(docs)
    nl = len(SEGMENT_LANES)
    lanes = host[: nl * pad * s].reshape(nl, pad, s)
    scal = host[nl * pad * s:].reshape(pad, -1)
    return {
        d: SegmentState(
            **{k: lanes[i, j] for i, k in enumerate(SEGMENT_LANES)},
            count=scal[j, SC_COUNT],
            min_seq=scal[j, SC_MIN_SEQ],
            cur_seq=scal[j, SC_CUR_SEQ],
            self_client=scal[j, SC_SELF],
            err=scal[j, SC_ERR],
        )
        for j, d in enumerate(docs)
    }
