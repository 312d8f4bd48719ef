"""ProcessGroup checkpoint transport: push weights over collectives.

Analog of the reference PG transport
(reference: torchft/checkpointing/pg_transport.py:27-300), ported from
``torchft_tpu/checkpointing/pg_transport.py``: the sender ships a pickled
metadata frame (skeleton + per-leaf shape/dtype) followed by each array as a
raw buffer over tagged point-to-point sends; the receiver reconstructs,
optionally **in place** into an existing same-structure state dict (no
reallocation — the fast path for healing into live training state).

Tensors go to the host to be sent.  An in-place target that is a CPU tensor
receives straight from the socket; a CUDA tensor receives into a host
staging buffer and is then filled with one copy, so the live device tensors
(model parameters, ``torch.optim`` state) keep their identity.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from torchft_tpu_torch.checkpointing.serialization import (
    _flatten,
    _leaf_meta,
    _wire_dtype,
    host_view,
    matches,
    to_leaf,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.parallel.process_group import ProcessGroup
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.futures import context_timeout
from torchft_tpu_torch.utils.pytree import tree_unflatten

logger = logging.getLogger(__name__)

_META_TAG = 3000
_TENSOR_TAG = 3001


class PGTransport(CheckpointTransport[Any]):
    """Checkpoint transport over a ProcessGroup's send/recv.

    Args:
        pg: the (replica-dimension) process group; src/dst ranks are replica
            ranks within the current quorum.
        timeout: per-transfer deadline.  Both directions ARM it: the whole
            send/recv runs under a ``utils.futures.context_timeout`` whose
            expiry callback is ``pg.abort`` — a dead peer mid-stream cannot
            wedge healing past the deadline, because the abort closes the
            sockets out from under every queued op.
        state_dict_fn: optional callable returning a same-structure state
            dict whose buffers are received into (in-place fast path).
    """

    def __init__(
        self,
        pg: ProcessGroup,
        timeout: float = 60.0,
        state_dict_fn: "Optional[Callable[[], Any]]" = None,
    ) -> None:
        self._pg = pg
        self._timeout = timeout
        self._state_dict_fn = state_dict_fn

    def metadata(self) -> str:
        return "<n/a>"  # rendezvous rides the quorum PG; nothing to publish

    def send_checkpoint(
        self, dst_ranks: "List[int]", step: int, state_dict: Any, timeout: float
    ) -> None:
        _faults.check("transport.send", step=step)
        skeleton, leaves = _flatten(state_dict)
        metas = []
        arrays: List[Optional[np.ndarray]] = []
        for leaf in leaves:
            meta, arr = _leaf_meta(leaf)
            metas.append(meta)
            arrays.append(arr)
        # Trace propagation: the source's round context rides the metadata
        # frame, so the destination's receive span joins the SOURCE's
        # per-step trace — both endpoints of one heal in one trace (the
        # HTTP transport does the same with a traceparent header).
        header_doc = {"step": step, "skeleton": skeleton, "leaves": metas}
        traceparent = _tracing.current_traceparent()
        if traceparent is not None:
            header_doc["traceparent"] = traceparent
        header = np.frombuffer(
            pickle.dumps(header_doc),
            dtype=np.uint8,
        )
        t0 = time.perf_counter()
        nbytes = header.nbytes + sum(a.nbytes for a in arrays if a is not None)
        # Armed per-transfer deadline: a receiver that dies mid-stream
        # leaves sends wedged on full socket buffers; expiry aborts the
        # PG, failing every queued op fast instead of wedging healing.
        with _flightrec.track(
            "checkpoint.pg.send", step=step, dst_ranks=list(dst_ranks),
            bytes=nbytes,
        ), context_timeout(self._pg.abort, timeout):
            for dst in dst_ranks:
                # submit the whole stream, then reap: the PG worker
                # executes in submission order, and keeping its queue
                # non-empty lets it drain the socket continuously instead
                # of idling one thread-wakeup round trip per leaf
                works = [self._pg.send(header, dst, tag=_META_TAG)]
                for i, arr in enumerate(arrays):
                    if arr is not None:
                        works.append(
                            self._pg.send(
                                arr.reshape(-1).view(np.uint8), dst, tag=_TENSOR_TAG + i
                            )
                        )
                for w in works:
                    w.wait(timeout=timeout)
                _metrics.CHECKPOINT_BYTES.labels(
                    transport="pg", direction="send"
                ).inc(nbytes)
        _metrics.CHECKPOINT_DURATION.labels(
            transport="pg", direction="send"
        ).observe(time.perf_counter() - t0)

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> Any:
        _faults.check("transport.recv", step=step)
        t0 = time.perf_counter()
        # Armed per-transfer deadline (see send_checkpoint): expiry aborts
        # the PG so a dead/stalled sender cannot wedge healing — the
        # receiving replica latches the error and re-heals next quorum.
        with _flightrec.track(
            "checkpoint.pg.recv", step=step, src_rank=src_rank,
        ), context_timeout(self._pg.abort, timeout):
            return self._recv_checkpoint(src_rank, step, timeout, t0)

    def _recv_checkpoint(
        self, src_rank: int, step: int, timeout: float, t0: float
    ) -> Any:
        header_bytes = self._pg.recv(src_rank, tag=_META_TAG).wait(timeout=timeout)
        header = pickle.loads(header_bytes.tobytes())
        if header["step"] != step:
            raise RuntimeError(
                f"checkpoint step mismatch: expected {step}, got {header['step']}"
            )
        # In-place fast path: receive into the live state dict's buffers.
        inplace_leaves: "Optional[List[Any]]" = None
        if self._state_dict_fn is not None:
            try:
                existing = self._state_dict_fn()
                inplace_leaves = _flatten(existing)[1]
                if len(inplace_leaves) != len(header["leaves"]):
                    inplace_leaves = None
            except Exception:  # noqa: BLE001 - fall back to fresh alloc
                inplace_leaves = None

        leaves: List[Any] = []
        try:
            # Submit every tensor recv up front (the PG worker runs them in
            # order, streaming the socket without per-leaf wakeup gaps);
            # in-place targets go straight to the wire reader as
            # recv(out=...) (uint8 view: the wire carries flat bytes).
            works: "List[Optional[Any]]" = []
            for i, meta in enumerate(header["leaves"]):
                if meta["kind"] == "object":
                    works.append(None)
                    continue
                target = None
                out = None
                if inplace_leaves is not None and matches(
                    inplace_leaves[i], meta
                ):
                    target = inplace_leaves[i]
                    out = (
                        target
                        if isinstance(target, np.ndarray)
                        else host_view(target)
                    )
                    if out is None:  # device tensor: stage on the host
                        out = np.empty(
                            meta["shape"], dtype=_wire_dtype(meta["dtype"])
                        )
                works.append(
                    (
                        self._pg.recv(
                            src_rank,
                            tag=_TENSOR_TAG + i,
                            out=None
                            if out is None
                            else out.reshape(-1).view(np.uint8),
                        ),
                        target,
                        out,
                    )
                )

            for meta, w in zip(header["leaves"], works):
                if w is None:
                    leaves.append(meta["value"])
                    continue
                work, target, out = w
                raw = work.wait(timeout=timeout)
                if isinstance(target, torch.Tensor):
                    if host_view(target) is None:
                        target.copy_(to_leaf(out, meta))
                    leaves.append(target)
                elif target is not None:
                    leaves.append(target)
                else:
                    # raw is a fresh private buffer; the reshaped view owns it
                    leaves.append(
                        to_leaf(
                            raw.view(_wire_dtype(meta["dtype"])).reshape(
                                meta["shape"]
                            ),
                            meta,
                        )
                    )
        except Exception:
            # Abandoning mid-stream (including a failure while still
            # SUBMITTING — e.g. a malformed leaf meta) leaves the tag
            # stream desynced AND queued in-place recvs that would keep
            # writing into LIVE training buffers as bytes arrive.  Abort
            # tears the PG down so no queued op ever executes; the Manager
            # latches the error and reconfigures at the next quorum.
            self._pg.abort()
            raise
        nbytes = header_bytes.nbytes + sum(
            l.nbytes
            if isinstance(l, np.ndarray)
            else l.numel() * l.element_size()
            for l in leaves
            if isinstance(l, (np.ndarray, torch.Tensor))
        )
        _metrics.CHECKPOINT_BYTES.labels(transport="pg", direction="recv").inc(
            nbytes
        )
        _metrics.CHECKPOINT_DURATION.labels(
            transport="pg", direction="recv"
        ).observe(time.perf_counter() - t0)
        # Distributed tracing: continue the source's context from the
        # metadata frame — this receive lands as a heal.recv span in the
        # SOURCE's per-step trace, next to its heal_send phase.  The
        # mirrored flight record keeps the traced phase visible in
        # post-mortem dumps too (span-vocab lint's 2-hop flight rule).
        tracer = _tracing.get_tracer()
        if tracer is not None:
            ctx = _tracing.TraceContext.from_traceparent(
                header.get("traceparent")
            )
            if ctx is not None and ctx.sampled:
                end_ns = time.time_ns()
                start_ns = end_ns - int((time.perf_counter() - t0) * 1e9)
                _flightrec.record(
                    "heal.recv", start_ns=start_ns, step=step,
                    src_rank=src_rank, bytes=nbytes,
                )
                tracer.export_span(
                    name="heal.recv",
                    trace_id=ctx.trace_id,
                    parent_span_id=ctx.span_id,
                    start_ns=start_ns,
                    end_ns=end_ns,
                    attributes={
                        "transport": "pg",
                        "step": step,
                        "src_rank": src_rank,
                        "bytes": nbytes,
                    },
                )
        return tree_unflatten(header["skeleton"], leaves)
