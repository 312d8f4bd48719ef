"""Monitored subprocess pipes for crash-isolated workers.

PyTorch-port copy of ``torchft_tpu/multiprocessing.py``.  Analog of the reference's ``_MonitoredPipe``
(reference: torchft/multiprocessing.py:10-31): a Connection wrapper whose
``recv`` polls with a deadline, re-raises exceptions that were sent through
the pipe, and turns a closed pipe into an ``EOFError`` — so a dead worker
subprocess surfaces as a clean, catchable failure in the parent instead of
a hang.
"""

from __future__ import annotations

import multiprocessing.connection as mp_conn
import time
from typing import Any, Optional


class _MonitoredPipe:
    """Poll-based pipe reader with timeout + exception passthrough."""

    def __init__(self, pipe: "mp_conn.Connection") -> None:
        self._pipe = pipe

    def send(self, obj: Any) -> None:
        self._pipe.send(obj)

    def recv(self, timeout: "Optional[float]" = None) -> Any:
        """Receive one object; raises it if it's an Exception.

        Raises TimeoutError if nothing arrives within ``timeout`` seconds,
        EOFError if the other end is closed.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(f"pipe recv timed out after {timeout}s")
            if self._pipe.poll(min(remaining, 0.1) if remaining is not None else 0.1):
                obj = self._pipe.recv()  # raises EOFError on closed pipe
                if isinstance(obj, Exception):
                    raise obj
                return obj

    def close(self) -> None:
        self._pipe.close()

    def closed(self) -> bool:
        return self._pipe.closed
