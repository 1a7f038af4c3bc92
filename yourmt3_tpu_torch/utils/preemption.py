"""Preemption-safe training (SURVEY.md §5.3 failure detection / elastic).

The reference's story is "crash → rerun with ckpt_path=last". Here:
SIGTERM/SIGINT set a flag the train loop polls each step; on preemption
it writes a final checkpoint (train/checkpoint.py, written to a temporary
file and renamed) and exits cleanly, so `--resume runs/<exp>/last`
continues where it stopped.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    _instance: Optional["PreemptionGuard"] = None

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False

    @classmethod
    def instance(cls) -> "PreemptionGuard":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def install(self) -> None:
        if self._installed:
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.getsignal(sig)

                def handler(signum, frame, _prev=prev):
                    self._flag.set()
                    # second signal falls through to the previous handler
                    signal.signal(signum, _prev)

                signal.signal(sig, handler)
            except ValueError:
                pass  # not main thread; polling still works via request()
        self._installed = True

    def request(self) -> None:
        """Programmatic preemption (tests, external watchers)."""
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def reset(self) -> None:
        self._flag.clear()
