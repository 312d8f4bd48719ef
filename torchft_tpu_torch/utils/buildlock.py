"""Build one output file once across processes.

Two processes that find an output missing or stale at the same moment
(thread replica groups are one process, but a launcher starts several)
must not compile into the same file.  :func:`build_once` holds an
exclusive ``fcntl.flock`` on ``<output>.lock`` for the whole build,
re-checks staleness once it holds the lock (so the second process reuses
what the first built), and has the build write a temporary name of its
own (pid and a random suffix) that ``os.replace`` moves over the output:
a reader never sees a half-written file.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import uuid
from typing import Callable, Iterator


@contextlib.contextmanager
def locked(path: str) -> Iterator[None]:
    """Hold an exclusive flock on ``path + ".lock"`` (created if absent)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path + ".lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def temp_name(path: str) -> str:
    """A name beside ``path`` that no other process or call uses."""
    return f"{path}.tmp{os.getpid()}.{uuid.uuid4().hex[:8]}"


def replace_or_discard(tmp: str, path: str, ok: bool) -> None:
    """Move a finished build over ``path``, or delete a failed one."""
    if ok:
        os.replace(tmp, path)
        return
    with contextlib.suppress(OSError):
        os.remove(tmp)


def build_once(
    path: str, stale: Callable[[], bool], build: Callable[[str], None]
) -> bool:
    """Run ``build(tmp)`` under the lock when ``stale()`` still holds
    there, then move ``tmp`` over ``path``.  Returns True when this call
    built the output; a raising build leaves no temporary file."""
    with locked(path):
        if not stale():
            return False
        tmp = temp_name(path)
        try:
            build(tmp)
        except BaseException:
            replace_or_discard(tmp, path, ok=False)
            raise
        replace_or_discard(tmp, path, ok=True)
        return True
