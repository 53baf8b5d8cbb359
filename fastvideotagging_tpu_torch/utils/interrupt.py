"""Graceful-stop handling for long training runs (a copy of
``fastvideotagging_tpu/utils/interrupt.py``).

A ``GracefulStopper`` turns the first SIGINT/SIGTERM into a flag that the
fit loop polls (checkpoint, then a clean return), while a second signal
falls through to the previous handler, so a hard kill stays available.
"""

from __future__ import annotations

import signal

from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.interrupt")


class GracefulStopper:
    """Context manager: SIGINT/SIGTERM set .stop_requested (first time)."""

    def __init__(self, signals=(signal.SIGINT, signal.SIGTERM)):
        self.signals = signals
        self.stop_requested = False
        self._previous = {}

    def _handle(self, signum, frame):
        if self.stop_requested:  # second signal: restore default behavior
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            if callable(prev):
                prev(signum, frame)
                return  # a returning prev handler must not re-arm us below
            raise KeyboardInterrupt
        self.stop_requested = True
        log.warning("stop requested (signal %d) — will checkpoint and exit "
                    "at the next step boundary; repeat to force", signum)

    def __enter__(self):
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False
