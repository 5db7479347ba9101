"""Preemption-safe shutdown: catch SIGTERM/SIGINT, finish the step,
checkpoint, exit cleanly (a copy of `repro.ft.preemption`). The solve's
checkpointer polls `requested()` at restart boundaries."""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    def requested(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:  # for tests
        self._flag.set()


class SignalAt:
    """A log sink that sends this process `sig` when the trainer logs
    step `step` ("step     3 loss ..."): a preemption at a chosen step,
    as the checkpoint tests' fault plans crash at a chosen site."""

    def __init__(self, step: int, sig=signal.SIGTERM):
        self.step, self.sig = step, sig

    def __call__(self, msg: str) -> None:
        if msg.startswith(f"step {self.step:5d} "):
            signal.raise_signal(self.sig)
