"""Size-keyed scratch-buffer pool for host collective staging.

Large numpy allocations are mmap-backed: every fresh buffer pays a
page-fault per 4 KiB on first touch, which on the DCN host path costs
~5x the actual write (measured 144 ms vs 28 ms to fill 232 MB on the
bench host).  The quantized-collective codec stages (accumulators, packed
wire buffers, padded row-blocks) and the TCP ring's scratch chunks have
exact, repeating sizes and clear ownership windows — a pool turns their
per-fragment page-fault bill into a one-time warmup.

The reference has the same concept on device (its CUDA caching allocator
does this transparently for torch tensors); on the host side numpy has no
caching allocator, so the framework carries a small explicit one.

Contract: ``take`` returns an UNINITIALIZED array (np.empty semantics);
``give`` hands memory back — the caller must guarantee no other live
reference (views included) escapes.  Never ``give`` a buffer the caller
returned to user code.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np


class BufferPool:
    def __init__(self, max_bytes: "int | None" = None) -> None:
        if max_bytes is None:
            from torchft_tpu_torch.utils.env import env_int

            max_bytes = env_int("TORCHFT_BUFPOOL_MB", 2048, minimum=0) << 20
        self.max_bytes = max_bytes
        self._free: "Dict[Tuple[int, str], List[np.ndarray]]" = {}
        self._held = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def take(self, shape, dtype=np.float32) -> np.ndarray:
        dt = np.dtype(dtype)
        size = int(np.prod(shape, dtype=np.int64)) if not np.isscalar(shape) else int(shape)
        key = (size, dt.str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                arr = lst.pop()
                self._held -= arr.nbytes
                self.hits += 1
                return arr.reshape(shape)
            self.misses += 1
        return np.empty(shape, dtype=dt)

    def give(self, arr: "np.ndarray | None") -> None:
        if arr is None or arr.nbytes == 0 or not arr.flags.c_contiguous:
            return
        # normalize views produced by take()'s reshape back to their base
        # allocation so the whole buffer is reusable
        base = arr
        while isinstance(base.base, np.ndarray) and base.base.nbytes == arr.nbytes:
            base = base.base
        # Only pool arrays that OWN their memory (malloc'd by numpy).  A
        # view over foreign memory — e.g. the Baby PG's zero-copy
        # /dev/shm-backed receive buffers, whose close/unlink finalizer
        # would be pinned for as long as the pool holds the view — must
        # fall to the GC instead.  This is enforced here, at the seam,
        # so no recycle call site has to know which PG produced a buffer.
        if base.base is not None:
            return
        key = (base.size, base.dtype.str)
        with self._lock:
            if self._held + base.nbytes > self.max_bytes:
                return  # over cap: drop on the floor, OS reclaims
            self._free.setdefault(key, []).append(base)
            self._held += base.nbytes

    def clear(self) -> None:
        with self._lock:
            self._free.clear()
            self._held = 0


# Process-wide default pool: collective staging buffers repeat sizes
# across fragments AND across replica ranks hosted in one process.
POOL = BufferPool()
