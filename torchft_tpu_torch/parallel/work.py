"""Async work handles for collective operations.

Analog of the reference's Work objects and `_DummyWork`
(reference: torchft/work.py:9-20 and manager.py:1015-1298 _ManagedWork).
A Work wraps a ``concurrent.futures.Future`` carrying the op's result
(numpy arrays for host-mediated collectives).  ``then`` chains callbacks
lazily, mirroring the reference's callback-chain semantics without CUDA
streams — on TPU, device-side async is owned by XLA, and these handles
sequence the *host-side* DCN collectives.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Callable, Optional, TypeVar

from torchft_tpu_torch.utils.futures import future_timeout

T = TypeVar("T")


class Work:
    """Handle to an in-flight collective; resolves to the op's value."""

    def __init__(self, future: "Future[Any]") -> None:
        self._future = future

    def wait(self, timeout: "Optional[float]" = None) -> Any:
        """Block until complete; raises the op's error if it failed."""
        return self._future.result(timeout=timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: "Optional[float]" = None) -> "Optional[BaseException]":
        return self._future.exception(timeout=timeout)

    def get_future(self) -> "Future[Any]":
        return self._future

    def then(self, fn: "Callable[[Any], Any]") -> "Work":
        """Chain: returns a Work resolving to ``fn(result)``.

        Errors propagate: if this work failed, the chained work fails with
        the same exception without invoking ``fn``.
        """
        out: Future = Future()

        def _done(f: "Future[Any]") -> None:
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            try:
                out.set_result(fn(f.result()))
            except Exception as e:  # noqa: BLE001 - propagate into the chain
                out.set_exception(e)

        self._future.add_done_callback(_done)
        return Work(out)

    def with_timeout(self, timeout: float) -> "Work":
        return Work(future_timeout(self._future, timeout))


def completed_work(value: Any = None) -> Work:
    """A Work that is already complete (reference _DummyWork analog)."""
    fut: Future = Future()
    fut.set_result(value)
    return Work(fut)


def failed_work(exc: BaseException) -> Work:
    fut: Future = Future()
    fut.set_exception(exc)
    return Work(fut)
