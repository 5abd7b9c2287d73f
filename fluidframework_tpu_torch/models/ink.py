"""Ink — append-only stroke DDS.

Reference: ``packages/dds/ink`` (``ink.ts``): strokes are created with a
pen and extended with stylus points; all operations are append-only and
therefore conflict-free — the total order fixes the stroke ordering, and
points within one stroke only ever come from its creator in submission
order. Points are kept as a NumPy ``(n, 4)`` float32 array per stroke
(x, y, time, pressure) — the natural lowering for batched rendering or
device-side stroke processing.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np

from fluidframework_tpu_torch.protocol.types import SequencedDocumentMessage
from fluidframework_tpu_torch.runtime.shared_object import SharedObject


class InkStroke:
    def __init__(self, stroke_id: str, pen: dict):
        self.id = stroke_id
        self.pen = dict(pen)  # color/thickness (IPen)
        self._points = np.zeros((0, 4), np.float32)

    @property
    def points(self) -> np.ndarray:
        return self._points

    def _append(self, pts: List[List[float]]) -> None:
        self._points = np.concatenate(
            [self._points, np.asarray(pts, np.float32).reshape(-1, 4)]
        )


class Ink(SharedObject):
    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._strokes: Dict[str, InkStroke] = {}
        self._order: List[str] = []  # sequenced stroke order
        self._counter = itertools.count(1)

    # -- reads ----------------------------------------------------------------

    def get_stroke(self, stroke_id: str) -> Optional[InkStroke]:
        return self._strokes.get(stroke_id)

    def strokes(self) -> List[InkStroke]:
        return [self._strokes[sid] for sid in self._order]

    # -- local edits ----------------------------------------------------------

    def create_stroke(self, pen: Optional[dict] = None) -> InkStroke:
        sid = f"{self.client_id}-{next(self._counter)}"
        stroke = InkStroke(sid, pen or {})
        self._strokes[sid] = stroke
        self._order.append(sid)
        self.submit_local_message({"k": "stroke", "id": sid, "pen": stroke.pen})
        return stroke

    def append_points(
        self, stroke_id: str, points: List[List[float]]
    ) -> None:
        """Append (x, y, time, pressure) rows to a stroke we created."""
        stroke = self._strokes[stroke_id]
        stroke._append(points)
        self.submit_local_message(
            {"k": "pts", "id": stroke_id, "pts": [list(map(float, p)) for p in points]}
        )

    def clear(self) -> None:
        self._strokes.clear()
        self._order.clear()
        self.submit_local_message({"k": "clear"})

    # -- sequenced stream -----------------------------------------------------

    def process_core(
        self,
        msg: SequencedDocumentMessage,
        local: bool,
        local_metadata: Optional[Any],
    ) -> None:
        c = msg.contents
        if local:
            if c["k"] == "stroke" and c["id"] in self._strokes:
                # Re-seat at the total-order position: optimistic creates
                # sit at the tail until acked, so every replica converges
                # on the sequenced stroke order.
                self._order.remove(c["id"])
                self._order.append(c["id"])
            return  # append-only otherwise: optimistic apply was final
        if c["k"] == "stroke":
            if c["id"] not in self._strokes:
                self._strokes[c["id"]] = InkStroke(c["id"], c["pen"])
                self._order.append(c["id"])
        elif c["k"] == "pts":
            stroke = self._strokes.get(c["id"])
            if stroke is not None:  # cleared concurrently: drop
                stroke._append(c["pts"])
        elif c["k"] == "clear":
            self._strokes.clear()
            self._order.clear()

    # -- summary / load -------------------------------------------------------

    def summarize_core(self) -> dict:
        return {
            "strokes": [
                {
                    "id": s.id,
                    "pen": s.pen,
                    "pts": self._strokes[sid]._points.tolist(),
                }
                for sid in self._order
                for s in (self._strokes[sid],)
            ]
        }

    def load_core(self, summary: dict) -> None:
        self._strokes.clear()
        self._order.clear()
        for ent in summary["strokes"]:
            stroke = InkStroke(ent["id"], ent["pen"])
            if ent["pts"]:
                stroke._append(ent["pts"])
            self._strokes[ent["id"]] = stroke
            self._order.append(ent["id"])
