"""Preemption-aware shutdown (``veto_tpu/utils/preemption.py``): SIGTERM
becomes a flag that the training loop reads once per iteration; the loop
finishes the step in flight, saves a checkpoint and exits cleanly."""

from __future__ import annotations

import signal
from typing import Iterable

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Installable signal → flag adapter::

        guard = PreemptionGuard().install()
        for it, batch in enumerate(loader):
            step(state, batch)
            if guard.requested:
                ckpt.save(it + 1, state)
                break
        guard.restore()
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._requested = False
        self._prev: dict = {}

    def _handler(self, signum, frame):
        self._requested = True

    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    @property
    def requested(self) -> bool:
        return self._requested

    def restore(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
