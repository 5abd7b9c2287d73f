"""The SharedString wire lowering the service's device stage uses.

Counterpart of ``fluidframework_tpu/models/shared_string.py``, of which
only :func:`row_from_wire` is ported: sequenced SharedString wire contents
become one int32 kernel row (``ops/encode.py``), byte-identical to what a
client replica applies. The SharedString DDS itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fluidframework_tpu_torch.ops import encode as E


def row_from_wire(
    contents: dict, *, seq: int, ref: int, client: int, msn: int,
    payloads: dict,
) -> Optional[np.ndarray]:
    """Lower sequenced SharedString wire contents to one kernel op row.
    Inserts record their payload text into ``payloads``; returns None for
    non-kernel ops (interval-collection bodies)."""
    k = contents.get("k")
    common = dict(seq=seq, ref=ref, client=client, msn=msn)
    if k == "ins":
        payloads[contents["orig"]] = contents["text"]
        return E.insert(
            contents["pos"], contents["orig"], len(contents["text"]),
            **common,
        )
    if k == "rem":
        return E.remove(contents["start"], contents["end"], **common)
    if k == "ann":
        return E.annotate(
            contents["start"], contents["end"], contents["val"], **common
        )
    return None
