"""Debugger driver — intercept and step live traffic.

Reference: ``packages/drivers/debugger``: wraps any document service so a
debugger can observe every op, pause the inbound stream, and single-step
delivery while the app runs unmodified.

A copy of ``fluidframework_tpu/drivers/debugger_driver.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class DebuggerConnection:
    """Connection wrapper: inbound ops hold in a staging queue while
    paused; ``step(n)`` releases them one (or n) at a time."""

    def __init__(self, inner, controller: "DebuggerController"):
        self._inner = inner
        self._ctl = controller
        self.doc_id = inner.doc_id
        self.client_id = inner.client_id
        self.join_seq = getattr(inner, "join_seq", 0)
        self.conn_no = getattr(inner, "conn_no", 0)
        self.initial_summary = inner.initial_summary
        self._staged: List[Any] = []
        self.nacks = inner.nacks
        self.signals = inner.signals
        self.on_nack: Optional[Callable] = None
        inner.on_nack = lambda nk: self.on_nack and self.on_nack(nk)

    @property
    def inbox(self):  # live view for code that inspects it directly
        return self._staged if self._ctl.paused else self._inner.inbox

    def submit(self, msg) -> None:
        self._ctl.record("out", self.doc_id, msg)
        self._inner.submit(msg)

    def submit_signal(self, content) -> None:
        self._inner.submit_signal(content)

    def take_inbox(self, n: Optional[int] = None):
        # Pull everything the service has into staging first.
        self._staged.extend(self._inner.take_inbox())
        if self._ctl.paused:
            budget = min(self._ctl.pending_steps(), len(self._staged))
        else:
            budget = len(self._staged)
        n = budget if n is None else min(n, budget)
        out, self._staged[:] = self._staged[:n], self._staged[n:]
        if self._ctl.paused:
            # Consume only what was actually released: unused steps stay
            # available (for this or any other paused connection).
            self._ctl.consume_steps(len(out))
        for m in out:
            self._ctl.record("in", self.doc_id, m)
        return out

    def disconnect(self) -> None:
        self._inner.disconnect()


class DebuggerController:
    """Shared debugger state: pause/step controls + a traffic log."""

    def __init__(self) -> None:
        self.paused = False
        self._steps = 0
        self.log: List[tuple] = []  # (direction, doc_id, message)
        self.on_record: Optional[Callable[[str, str, Any], None]] = None

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    def pending_steps(self) -> int:
        return self._steps

    def consume_steps(self, n: int) -> None:
        self._steps = max(0, self._steps - n)

    def record(self, direction: str, doc_id: str, msg) -> None:
        self.log.append((direction, doc_id, msg))
        if self.on_record:
            self.on_record(direction, doc_id, msg)


class DebuggerFluidService:
    """Service wrapper handing out debugger-instrumented connections."""

    def __init__(self, inner, controller: Optional[DebuggerController] = None):
        self.inner = inner
        self.controller = controller or DebuggerController()

    @property
    def store(self):
        return self.inner.store

    def connect(self, doc_id: str, mode: str = "write", from_seq: int = 0):
        return DebuggerConnection(
            self.inner.connect(doc_id, mode, from_seq), self.controller
        )

    def get_deltas(self, doc_id: str, from_seq: int = 0, to_seq=None):
        return self.inner.get_deltas(doc_id, from_seq, to_seq)

    def disconnect(self, doc_id: str, client_id: int) -> None:
        self.inner.disconnect(doc_id, client_id)
