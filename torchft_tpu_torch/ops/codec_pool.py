"""Worker pool that drives the GIL-releasing codec per row-block.

The quantized-collective codec (ops/quantization.py row-range surface,
native/quant.cc) is a pure memory-bandwidth kernel whose rows are
independent — per-row absmax, per-row scale.  A single Python thread can
therefore only ever use one core of it; this module fans a chunk's rows
across a small process-wide :class:`~concurrent.futures.ThreadPoolExecutor`
(``TORCHFT_QUANT_THREADS`` workers, default ``min(cores, 8)``), and the
native kernels release the GIL for the duration of each block, so the
codec scales across cores for BOTH wire formats (int8 and the fp8 RNE
encode / LUT decode leg).

Handoff is lock-free from the caller's perspective: tasks flow through
the executor's internal queue; completion is signalled through the
returned futures (no bespoke condition variables for the lock-discipline
pass to frown at).  Each collective carries a :class:`CodecTrace` that
tasks stamp with busy intervals — merged at the end into the true
codec-busy wall, the ``C`` of the overlap-efficiency gauge
``torchft_quant_overlap_efficiency`` (docs/observability.md).

The pool is sized once, at first use (``TORCHFT_QUANT_THREADS`` is read
then); it is shared by every collective and replica rank hosted in the
process, which keeps total codec concurrency at the machine's core
budget instead of multiplying per rank.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

from torchft_tpu_torch.utils.env import env_int

# Below this many rows a block is not worth a task handoff (~20 us of
# executor overhead vs ~10 us/64-row-block of codec at 2048 cols).
MIN_BLOCK_ROWS = 64

_executors: "dict[str, ThreadPoolExecutor]" = {}
_executor_lock = threading.Lock()


def pool_threads() -> int:
    """Configured codec worker count (``TORCHFT_QUANT_THREADS``)."""
    return env_int(
        "TORCHFT_QUANT_THREADS", min(os.cpu_count() or 1, 8), minimum=1
    )


def get_executor(lane: str = "tx") -> ThreadPoolExecutor:
    """Process-wide codec pool for one LANE, sized at first use.

    Two lanes exist so the receive side of the pipeline is never starved
    by the send side: ``tx`` runs capture work (quantize peer slices /
    own-slice copies — ALL chunks of a collective are enqueued at call
    time to honor the snapshot contract), ``rx`` runs reduce/requant and
    dequant blocks dispatched as wire ops complete.  On one FIFO pool,
    chunk 0's reduce would queue behind every later chunk's quantize and
    the wire would stall at two outstanding alltoalls in the codec-bound
    regime; separate lanes keep the advertised quantize(i+1) ∥ wire(i) ∥
    reduce(i-1) interleave live.  Both lanes share the machine through
    the OS scheduler (the kernels are GIL-free and memory-bound, so the
    brief 2x oversubscription degrades gracefully).
    """
    ex = _executors.get(lane)
    if ex is None:
        with _executor_lock:
            ex = _executors.get(lane)
            if ex is None:
                ex = ThreadPoolExecutor(
                    max_workers=pool_threads(),
                    thread_name_prefix=f"tft_codec_{lane}",
                )
                _executors[lane] = ex
    return ex


class CodecTrace:
    """Per-collective scratchpad for pipeline accounting and abort.

    ``intervals`` collects (start, end) perf-counter pairs from codec
    tasks (list.append is atomic under the GIL — no lock on the hot
    path); :meth:`busy_seconds` merges them into wall-clock during which
    at least one codec task was executing.  ``abort()`` makes remaining
    queued tasks no-ops so a failed collective drains its workers instead
    of burning cores on a result nobody will read.
    """

    def __init__(self) -> None:
        self.intervals: "List[Tuple[float, float]]" = []
        self.wire_intervals: "List[Tuple[float, float]]" = []
        self._aborted = threading.Event()

    def abort(self) -> None:
        self._aborted.set()

    @property
    def aborted(self) -> bool:
        return self._aborted.is_set()

    def add_wire(self, t0: float, t1: float) -> None:
        self.wire_intervals.append((t0, t1))

    @staticmethod
    def _merged(intervals: "List[Tuple[float, float]]") -> float:
        return merged_seconds(intervals)

    def busy_seconds(self) -> float:
        """Merged codec-busy wall across all tasks of this collective."""
        return self._merged(self.intervals)

    def wire_seconds(self) -> float:
        """Merged wire-busy wall (collective-op execution intervals)."""
        return self._merged(self.wire_intervals)


def merged_seconds(intervals: "List[Tuple[float, float]]") -> float:
    """Total seconds covered by the UNION of (start, end) intervals —
    concurrent busy windows must not double-count.  Shared by the codec
    trace (busy/wire walls) and the serving relay's cut-through
    occupancy gauge."""
    total = 0.0
    end = float("-inf")
    for t0, t1 in sorted(intervals):
        if t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def block_bounds(n_rows: int, min_rows: int = MIN_BLOCK_ROWS) -> "List[Tuple[int, int]]":
    """Split ``n_rows`` into up to ``pool_threads()`` contiguous blocks of
    at least ``min_rows`` rows (one block when too small to split)."""
    if n_rows <= 0:
        return []
    n_blocks = max(1, min(pool_threads(), n_rows // max(min_rows, 1) or 1))
    base, rem = divmod(n_rows, n_blocks)
    bounds = []
    start = 0
    for b in range(n_blocks):
        n = base + (1 if b < rem else 0)
        bounds.append((start, start + n))
        start += n
    return bounds


def run_blocks(
    n_rows: int,
    fn: "Callable[[int, int], None]",
    trace: "Optional[CodecTrace]" = None,
    min_rows: int = MIN_BLOCK_ROWS,
    lane: str = "tx",
) -> "List[Future]":
    """Fan ``fn(r0, r1)`` over row blocks on the codec pool.

    Returns the block futures (callers wait or chain completion).  Tasks
    observe ``trace.aborted`` (skip) and stamp busy intervals.  A block
    that raises carries its exception on the future — callers must
    surface it (the pipeline aborts on the first failed block).
    ``lane``: ``"tx"`` for capture work, ``"rx"`` for the
    wire-completion-driven reduce/dequant stages (see
    :func:`get_executor`).
    """
    executor = get_executor(lane)

    def task(r0: int, r1: int) -> None:
        if trace is not None and trace.aborted:
            return
        t0 = time.perf_counter()
        fn(r0, r1)
        if trace is not None:
            trace.intervals.append((t0, time.perf_counter()))

    return [
        executor.submit(task, r0, r1) for r0, r1 in block_bounds(n_rows, min_rows)
    ]
