"""Quantized collectives: 8-bit allreduce / reduce-scatter over the FT PG,
run as a chunked software pipeline that hides the codec behind the wire.

PyTorch port of ``torchft_tpu/ops/collectives.py``; the pipeline, the wire
format and the Work accounting are the JAX package's, byte for byte.  What
differs: inputs are torch tensors (CPU or CUDA) or numpy arrays, results
come back in each leaf's dtype (a tensor leaf as a CPU tensor, a numpy leaf
as a numpy array; bf16 rounded to nearest even from the f32 result, as
``ml_dtypes`` does in the JAX package), the device quantize is kernel D in
CUDA (``ops/pallas_quant.py``).  With ``TORCHFT_PLAN_VERIFY`` set, the
hierarchical plan is checked live by ``analysis/plan_verify``, as in the
JAX package.

Analog of the reference's quantized collectives
(reference: torchft/collectives.py:159-415): quantize per-rank row-slices,
``alltoall`` the slices, locally dequant-reduce-requant the owned slice,
``allgather`` the reduced slices, dequantize.  Cuts DCN bytes ~4x for f32
gradients (int8 payload + f32 row scales) at the cost of quantization error
— the DiLoCo outer-gradient path is tolerant to this by design.

**Pipeline shape** (r5 found the monolithic form codec-bound: int8 sync
spent 83% of its wall in a single-threaded host codec while the NIC sat
idle).  The flat row-matrix is split into K chunks of
``TORCHFT_QUANT_CHUNK_ROWS`` rows (auto-sized to ~4 MiB of payload per
peer when unset), and the stages overlap the way DynamiQ / Prime PCCL
pipeline compressed collectives (PAPERS.md):

- quantize(chunk i+1)  ∥  alltoall(chunk i)  ∥  reduce-requant(chunk i-1)
  ∥  allgather/dequant of earlier chunks;
- the codec itself is row-blocked across a small worker pool
  (``TORCHFT_QUANT_THREADS``, ops/codec_pool.py) driving the GIL-releasing
  native kernels (native/quant.cc row-range entry points), so both wire
  formats scale across cores;
- wire buffers, accumulators and reduced pieces cycle through
  ``utils/bufpool.POOL`` — after the first collective of a given shape,
  steady-state allocation is zero.

Every rank submits the SAME fixed interleave of PG ops
(``a2a_0, a2a_1, ag_0, a2a_2, ag_1, …``) from a dedicated driver thread,
so the single-worker PG executes identical op sequences on every socket
(the collective-ordering contract); per-chunk stage readiness only gates
*when* the next submission happens, never its order.  That contract —
like every PG collective's — assumes ONE collective in flight per
process group at a time: a second concurrent quantized collective on the
same PG would interleave its driver's submissions timing-dependently and
desync the op streams across ranks.  The shipped callers respect this
(DiLoCo serializes fragment syncs; ``Manager.allreduce`` is issued from
the step protocol).  Chunking is by rows
and quantization is per-row, so chunked output is bit-identical to the
monolithic codec (K=1) on finite inputs — asserted for both wire formats
in tests/test_quantized_collectives.py.

Two bit-compatible quantizers feed the same wire format:

- **device path** (default when every input is a CUDA tensor and the wire
  is int8): kernel D (``ops/pallas_quant.py``, CUDA) runs in one launch on
  the caller's current stream *before* any host copy; a CUDA event is
  recorded after it, and the pipeline then copies each chunk's int8
  payload + f32 row scales device→host as a capture task that first waits
  on that event (a codec-pool thread copies on its own current stream), so
  the PCIe hops overlap earlier chunks' sends;
- **host path** (native/numpy codec, ``ops/quantization.py``) for host
  arrays, CPU tensors or ``device_quantize=False``.  A rank's OWN
  row-slice skips the codec entirely: it is captured straight into the
  chunk's f32 accumulator at call time (zero codec time + zero
  quantization error on own data, and one fewer memory pass than a
  snapshot-then-copy).

Observability: ``torchft_quant_codec_seconds`` /
``torchft_quant_wire_seconds`` histograms per stage,
``torchft_quant_overlap_efficiency`` gauge per collective, one flight
record per chunk per hop, and chaos injects mid-pipeline: the existing
``pg.allreduce`` site is consulted before every chunk's alltoall (no
step context — unconstrained rules fire), plus ``pg.allreduce.chunk``
with ``step`` = chunk index for deterministic per-hop targeting.

SUM and AVG only, floating-point inputs only (parity: reference
collectives.py:336-344).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Tuple

import logging

import numpy as np
import torch

from torchft_tpu_torch.ops import codec_pool as _cpool
from torchft_tpu_torch.ops import quantization as q
from torchft_tpu_torch.ops import topology as _topo
from torchft_tpu_torch.parallel.process_group import (
    ProcessGroup,
    REDUCE_AVG,
    REDUCE_SUM,
)
# host numpy view of an input leaf (a CUDA tensor copied to the host, bf16
# widened exactly to f32, as the JAX package's ``astype(float32)`` does)
from torchft_tpu_torch.parallel.process_group import _allreduce_in as _host
from torchft_tpu_torch.parallel.work import Work, completed_work
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import lockcheck as _lockcheck
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.bufpool import POOL as _POOL
from torchft_tpu_torch.utils.env import env_int

logger = logging.getLogger(__name__)

# Auto chunk sizing: one chunk's per-peer int8/fp8 payload, when
# TORCHFT_QUANT_CHUNK_ROWS is unset.  ~4 MiB keeps per-message overhead
# (<0.1%) negligible while giving a flagship-scale fragment (~14k slice
# rows at 2048 cols) a pipeline depth of ~7.
_AUTO_CHUNK_PAYLOAD_BYTES = 4 << 20
# Runaway guard: a pathological TORCHFT_QUANT_CHUNK_ROWS=1 on a huge
# fragment must not turn one collective into 50k wire messages.
_MAX_CHUNKS = 1024


def _resolve_chunk_rows(slice_rows: int, cols: int) -> int:
    """Rows per pipeline chunk.  ``TORCHFT_QUANT_CHUNK_ROWS`` when set
    (>0), else auto from the wire-buffer size target.  Clamped to
    [ceil(slice_rows/_MAX_CHUNKS), slice_rows].  Like
    ``TORCHFT_QUANT_WIRE``, the knob must agree across ranks — divergent
    chunking desyncs the op streams and fails loudly mid-collective.
    The auto target is deliberately NOT scaled to the WAN
    bandwidth-delay product: growing chunks to hide per-message RTT
    also serializes the codec behind the wire (the overlap r5 built the
    pipeline for), and the latency bill is the hierarchical plan's to
    cut — by sending fewer inter-host messages, not bigger ones
    (docs/benchmarks.md §3d)."""
    rows = env_int("TORCHFT_QUANT_CHUNK_ROWS", 0, minimum=0)
    if rows <= 0:
        rows = max(_AUTO_CHUNK_PAYLOAD_BYTES // max(cols, 1), 1)
    rows = max(rows, -(-slice_rows // _MAX_CHUNKS))
    return max(1, min(rows, slice_rows))


def _chunk_bounds(n_rows: int, chunk_rows: int) -> "List[Tuple[int, int]]":
    return [
        (a, min(a + chunk_rows, n_rows)) for a in range(0, n_rows, chunk_rows)
    ]


def _check_world(received: "List[np.ndarray]", world: int, op: str) -> None:
    if len(received) != world:
        raise RuntimeError(
            f"{op} returned {len(received)} buffers for world {world} "
            "(degraded result from an error-swallowing PG?)"
        )


def _recycle_wire_bufs(
    send_bufs: "List[np.ndarray]",
    received: "List[np.ndarray]",
    my_rank: int,
    exclude: "Optional[np.ndarray]" = None,
) -> None:
    """Return dead wire buffers to the pool after a reduce consumed them.

    Send side: a packed buffer is drained to the sockets once the
    alltoall resolves — but a degraded (error-swallowing) PG can resolve
    with the INPUT arrays themselves, so anything aliased into
    ``received`` is skipped here and given exactly once below.  Receive
    side: id-deduped (any PG may alias slots); 0-byte own slots no-op in
    ``give``.  ``exclude``: a buffer already given elsewhere (the
    allgather path's own reduced piece) that must not be double-given
    even if a PG aliases it into the result.
    """
    for r, b in enumerate(send_bufs):
        if r != my_rank and not any(b is rcv for rcv in received):
            _POOL.give(b)
    seen_ids = set()
    for b in received:
        if b is not exclude and id(b) not in seen_ids:
            seen_ids.add(id(b))
            _POOL.give(b)


def _slice_rows(rows: int, world: int) -> "List[tuple[int, int]]":
    """Contiguous row ranges per rank (last rank takes the remainder)."""
    base = rows // world
    bounds = []
    start = 0
    for r in range(world):
        n = base + (1 if r < rows % world else 0)
        bounds.append((start, start + n))
        start += n
    return bounds


def _fill_tail(src: np.ndarray, tail: np.ndarray, g0: int, cols: int) -> None:
    """Fill a pool block for a chunk spanning the padded tail: whatever of
    the FLAT source remains past global row ``g0`` (including a partial
    last row), zero-filled beyond it."""
    flat = tail.ravel()
    avail = max(src.size - g0 * cols, 0)
    if avail > 0:
        flat[:avail] = src[g0 * cols :]
    flat[avail:] = 0.0


class _ChunkPipeline:
    """Shared state + driver of one chunked quantized collective.

    Thread roles:

    - **caller thread**: captures the contribution (quantizes peer
      slices / copies the own slice into per-chunk accumulators) by
      fanning row blocks onto the codec pool, then blocks until every
      capture task ran — the call-time-snapshot contract: the caller may
      mutate its arrays the moment the submit returns;
    - **driver thread** (one per collective): submits every PG op in the
      fixed global interleave, gated on stage futures;
    - **codec pool** (process-wide): row-block tasks — pure compute,
      never blocks, so abort always drains;
    - **PG worker**: completion callbacks only timestamp, recycle and
      dispatch the next codec stage — they never block the wire.
    """

    def __init__(
        self,
        pg: ProcessGroup,
        collective: str,
        wire_dtype: str,
        divisor: int,
        cols: int,
        chunks: "List[Tuple[int, int]]",
    ) -> None:
        self.pg = pg
        self.collective = collective
        self.wire_dtype = wire_dtype
        self.divisor = divisor
        self.cols = cols
        self.chunks = chunks
        self.my_rank = pg.rank()
        self.world = pg.size()
        self.trace = _cpool.CodecTrace()
        k = len(chunks)
        self.ready: "List[Future]" = [Future() for _ in range(k)]
        self.reduce_done: "List[Future]" = [Future() for _ in range(k)]
        self.dequant_done: "List[Future]" = [Future() for _ in range(k)]
        self.send_bufs: "List[Optional[List[np.ndarray]]]" = [None] * k
        self.accs: "List[Optional[np.ndarray]]" = [None] * k
        self.pieces: "List[Optional[np.ndarray]]" = [None] * k
        self.out_fut: Future = Future()
        self.error: "Optional[BaseException]" = None
        self._latch_lock = _lockcheck.lock("quant.pipeline_latch")
        self._last_wire_done: "Optional[float]" = None
        # per-hop wire-busy accounting (PG worker thread only — the
        # single-worker FIFO serializes every completion callback)
        self.hop_wire_s: "Dict[str, float]" = {}
        self.t_call = time.perf_counter()
        # Distributed tracing: capture the submitting thread's context
        # (the Manager's round) at construction — completion callbacks
        # run on PG-worker/driver threads, where the thread-local is not
        # bound.  Per-chunk/per-hop child spans mirror the quant.chunk
        # flight records; None when tracing is off or the step unsampled.
        self.trace_ctx = _tracing.get_current()
        # per-wait budget: each PG op enforces its own deadline
        # (pg._timeout), so a stage future unresolved past that plus grace
        # means a lost callback, not a slow wire
        self.op_timeout = float(getattr(pg, "_timeout", 60.0)) + 30.0
        self.stats: "Dict[str, Any]" = {"n_chunks": k, "wire": wire_dtype}
        self.codec_s_box = [0.0]

    # -- error funnel ----------------------------------------------------

    def abort(self, exc: BaseException) -> None:
        """First error wins; queued codec tasks become no-ops; every
        pending stage future (and the result) fails so no waiter hangs."""
        first = False
        with self._latch_lock:
            if self.error is None:
                self.error = exc
                first = True
        if not first:
            return
        self.trace.abort()
        _flightrec.record(
            "quant.pipeline",
            status="error",
            collective=self.collective,
            wire=self.wire_dtype,
            chunks=len(self.chunks),
            error=repr(exc),
        )
        # failed-collective span (ok=false): the trace ledger names the
        # aborting replica from this alone
        tracer = _tracing.get_tracer()
        ctx = self.trace_ctx
        if tracer is not None and ctx is not None:
            end_ns = time.time_ns()
            tracer.export_span(
                name="quant.pipeline",
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=end_ns
                - int((time.perf_counter() - self.t_call) * 1e9),
                end_ns=end_ns,
                attributes={
                    "collective": self.collective,
                    "wire": self.wire_dtype,
                    "error": repr(exc),
                },
                ok=False,
            )
        for futs in self._stage_future_lists():
            for f in futs:
                try:
                    f.set_exception(exc)
                except Exception:  # noqa: BLE001 - already resolved
                    pass
        try:
            self.out_fut.set_exception(exc)
        except Exception:  # noqa: BLE001 - already resolved
            pass

    def _stage_future_lists(self) -> "Tuple[List[Future], ...]":
        """Every stage-future list ``abort`` must fail so no waiter
        hangs; plan pipelines extend this with their hop stages."""
        return (self.ready, self.reduce_done, self.dequant_done)

    def _await(self, fut: Future) -> None:
        try:
            fut.result(timeout=self.op_timeout)
        except FuturesTimeoutError:
            exc = TimeoutError(
                f"quantized {self.collective} pipeline stage did not "
                f"resolve within {self.op_timeout:.0f}s"
            )
            self.abort(exc)
            raise exc from None

    # -- stage plumbing --------------------------------------------------

    def chain(
        self, futs: "List[Future]", done_cb: "Callable[[], None]",
        stage_fut: Future,
    ) -> None:
        """When every codec future succeeds, run ``done_cb`` then resolve
        ``stage_fut``; the first failure aborts the pipeline."""
        remaining = [len(futs)]

        def _one(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                self.abort(exc)
                return
            with self._latch_lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                try:
                    done_cb()
                    stage_fut.set_result(None)
                except BaseException as e:  # noqa: BLE001 - funnel
                    self.abort(e)

        if not futs:
            try:
                done_cb()
                stage_fut.set_result(None)
            except BaseException as e:  # noqa: BLE001 - funnel
                self.abort(e)
            return
        for f in futs:
            f.add_done_callback(_one)

    def submit_wire(
        self, op: str, hop: str, k: int, work: Work, nbytes: int,
        submit_t: float, on_ok: "Callable[[Any], None]",
    ) -> None:
        """Attach the wire-accounting completion callback to a PG op: the
        op's *execution* interval is [max(submit, previous completion),
        completion] — exact under the PG's single-worker FIFO.  ``op`` is
        the PG primitive (alltoall/allgather/send/recv/sendrecv), ``hop``
        the reduction-plan stage it serves (``flat`` on the flat
        schedule; ``intra.*``/``inter.*`` on hierarchical plans)."""

        def _cb(f: Future) -> None:
            t1 = time.perf_counter()
            prev = self._last_wire_done
            t0 = submit_t if prev is None else max(submit_t, prev)
            self._last_wire_done = t1
            wire_s = max(t1 - t0, 0.0)
            if t1 > t0:
                self.trace.add_wire(t0, t1)
            self.hop_wire_s[hop] = self.hop_wire_s.get(hop, 0.0) + wire_s
            _metrics.QUANT_WIRE_SECONDS.labels(
                op=op, hop=hop, wire=self.wire_dtype
            ).observe(wire_s)
            exc = f.exception()
            _flightrec.record(
                "quant.chunk",
                status="ok" if exc is None else "error",
                collective=self.collective,
                pg_op=op,
                hop=hop,
                chunk=k,
                chunks=len(self.chunks),
                nbytes=nbytes,
                wire_s=round(wire_s, 6),
                **({"error": repr(exc)} if exc is not None else {}),
            )
            # one child span per (chunk, hop) wire op, mirroring the
            # flight record — the trace-ledger's wire attribution
            tracer = _tracing.get_tracer()
            ctx = self.trace_ctx
            if tracer is not None and ctx is not None:
                end_ns = time.time_ns()
                tracer.export_span(
                    name="quant.chunk",
                    trace_id=ctx.trace_id,
                    parent_span_id=ctx.span_id,
                    start_ns=end_ns - int(wire_s * 1e9),
                    end_ns=end_ns,
                    attributes={
                        "collective": self.collective,
                        "pg_op": op,
                        "hop": hop,
                        "chunk": k,
                        "nbytes": nbytes,
                    },
                    ok=exc is None,
                )
            if exc is not None:
                self.abort(exc)
                return
            try:
                on_ok(f.result())
            except BaseException as e:  # noqa: BLE001 - funnel
                self.abort(e)

        work.get_future().add_done_callback(_cb)

    # -- stages ----------------------------------------------------------

    def submit_alltoall(self, k: int) -> None:
        bufs = self.send_bufs[k]
        assert bufs is not None
        nbytes = sum(
            b.nbytes for r, b in enumerate(bufs) if r != self.my_rank
        )
        t = time.perf_counter()
        self.submit_wire(
            "alltoall", "flat", k, self.pg.alltoall(bufs), nbytes, t,
            lambda received: self.on_alltoall(k, received),
        )

    def on_alltoall(self, k: int, received: "List[np.ndarray]") -> None:
        """Dispatch chunk ``k``'s dequant-reduce(-requant) row blocks (PG
        worker thread: enqueue only, never compute)."""
        _check_world(received, self.world, "alltoall")
        a, b = self.chunks[k]
        ck = b - a
        acc = self.accs[k]
        if acc is not None:
            # host path: acc pre-filled with the own slice at capture
            bufs = [r for i, r in enumerate(received) if i != self.my_rank]
            overwrite_first = False
        else:
            # device path: every slot (own included) is a wire buffer
            bufs = received
            acc = _POOL.take((ck, self.cols), np.float32)
            self.accs[k] = acc
            overwrite_first = True
        # one header check per received buffer (the loud cross-rank
        # wire-format guard), hoisted off the per-row-block hot path
        for buf in bufs:
            q.validate_packed(buf, self.wire_dtype)
        requant = self.collective == "allreduce"
        piece: "Optional[np.ndarray]" = None
        if requant:
            piece = q.new_packed(ck, self.cols, self.wire_dtype, pool=_POOL)
            self.pieces[k] = piece
        t_red = time.perf_counter()

        def block(r0: int, r1: int) -> None:
            ow = overwrite_first
            for buf in bufs:
                q.fma_rows_packed(
                    buf, ck, self.cols, r0, r1, self.wire_dtype,
                    acc, r0, overwrite=ow,
                )
                ow = False
            if self.divisor:
                q.div_rows(acc, r0, r1, self.divisor)
            if requant:
                q.quantize_rows_packed(
                    acc, r0, piece, ck, self.cols, r0, r1, self.wire_dtype
                )

        # rx lane: never queued behind pending capture (tx) work, so the
        # reduce starts the moment the chunk lands even while later
        # chunks are still quantizing
        futs = _cpool.run_blocks(ck, block, self.trace, lane="rx")

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="reduce", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_red)
            send = self.send_bufs[k]
            if send is not None:
                _recycle_wire_bufs(send, received, self.my_rank)
                self.send_bufs[k] = None
            if requant:
                # allreduce: acc is scratch once requantized into piece
                _POOL.give(self.accs[k])
                self.accs[k] = None
            # reduce_scatter: acc IS the caller's output region — keep it

        self.chain(futs, done, self.reduce_done[k])

    def submit_allgather(self, k: int, full_mat: np.ndarray,
                         bounds: "List[Tuple[int, int]]") -> None:
        piece = self.pieces[k]
        assert piece is not None
        nbytes = (self.world - 1) * piece.nbytes
        t = time.perf_counter()
        self.submit_wire(
            "allgather", "flat", k, self.pg.allgather(piece), nbytes, t,
            lambda gathered: self.on_allgather(k, gathered, full_mat, bounds),
        )

    def on_allgather(
        self, k: int, gathered: "List[np.ndarray]", full_mat: np.ndarray,
        bounds: "List[Tuple[int, int]]",
    ) -> None:
        """Dequantize every rank's reduced piece straight into its offset
        of the full output matrix (PG worker thread: enqueue only)."""
        _check_world(gathered, self.world, "allgather")
        for gbuf in gathered:
            q.validate_packed(gbuf, self.wire_dtype)
        a, b = self.chunks[k]
        ck = b - a
        t_dq = time.perf_counter()
        futs: "List[Future]" = []
        for r, gbuf in enumerate(gathered):
            base = bounds[r][0] + a

            def block(r0: int, r1: int, gbuf=gbuf, base=base) -> None:
                q.dequant_rows_into(
                    gbuf, ck, self.cols, r0, r1, self.wire_dtype,
                    full_mat, base + r0,
                )

            futs += _cpool.run_blocks(ck, block, self.trace, lane="rx")

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="dequant", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_dq)
            piece = self.pieces[k]
            _POOL.give(piece)
            self.pieces[k] = None
            _recycle_wire_bufs([], gathered, self.my_rank, exclude=piece)

        self.chain(futs, done, self.dequant_done[k])

    # -- capture (caller thread) ----------------------------------------

    def capture_chunk(
        self, k: int, futs: "List[Future]", give_after: "List[np.ndarray]",
        t_cap: float,
    ) -> None:
        """Latch chunk ``k``'s capture tasks into ``ready[k]``."""

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="quantize", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_cap)
            for blk in give_after:
                _POOL.give(blk)

        self.chain(futs, done, self.ready[k])

    def capture_host_chunks(
        self,
        bounds: "List[Tuple[int, int]]",
        source_rows: np.ndarray,
        acc_for_chunk: "Callable[[int, int, int], np.ndarray]",
        src_flat: "Optional[np.ndarray]" = None,
        full_rows: "Optional[int]" = None,
    ) -> "List[Future]":
        """Caller-thread capture for the host codec path: per chunk,
        quantize every peer slice into packed pool buffers and copy the
        own slice into its accumulator (the call-time snapshot).

        ``source_rows``: C-contiguous f32 ``(*, cols)`` the slices read
        from.  ``src_flat``/``full_rows``: when set, chunks whose global
        rows extend past ``full_rows`` read a zero-padded pool tail block
        filled from the flat source (the allreduce's padded row matrix).
        ``acc_for_chunk(k, a, b)``: the chunk's f32 accumulator — a pool
        block for the allreduce, a region of the caller-visible output
        for the reduce-scatter.  Returns the capture futures for
        :meth:`wait_captured`.
        """
        futs_all: "List[Future]" = []
        for k, (a, b) in enumerate(self.chunks):
            ck = b - a
            t_cap = time.perf_counter()
            bufs_k: "List[np.ndarray]" = []
            futs_k: "List[Future]" = []
            give_after: "List[np.ndarray]" = []
            for r in range(self.world):
                g0 = bounds[r][0] + a
                if full_rows is not None and g0 + ck > full_rows:
                    tail = _POOL.take((ck, self.cols), np.float32)
                    give_after.append(tail)
                    _fill_tail(src_flat, tail, g0, self.cols)
                    block_src, row0 = tail, 0
                else:
                    block_src, row0 = source_rows, g0
                if r == self.my_rank:
                    # own slice: captured straight into the chunk's f32
                    # accumulator — no codec time, no quantization error
                    # on own data, and the reduce fma-accumulates into it
                    # in place (one fewer pass than snapshot-then-copy)
                    acc = acc_for_chunk(k, a, b)
                    self.accs[k] = acc

                    def copy_own(
                        r0: int, r1: int, acc=acc, bs=block_src, row0=row0
                    ) -> None:
                        np.copyto(acc[r0:r1], bs[row0 + r0 : row0 + r1])

                    futs_k += _cpool.run_blocks(ck, copy_own, self.trace)
                    bufs_k.append(np.empty(0, dtype=np.uint8))
                else:
                    buf = q.new_packed(
                        ck, self.cols, self.wire_dtype, pool=_POOL
                    )
                    bufs_k.append(buf)

                    def quant_peer(
                        r0: int, r1: int, buf=buf, bs=block_src, row0=row0,
                        ck=ck,
                    ) -> None:
                        q.quantize_rows_packed(
                            bs, row0 + r0, buf, ck, self.cols, r0, r1,
                            self.wire_dtype,
                        )

                    futs_k += _cpool.run_blocks(ck, quant_peer, self.trace)
            self.send_bufs[k] = bufs_k
            self.capture_chunk(k, futs_k, give_after, t_cap)
            futs_all += futs_k
        return futs_all

    # -- driver ----------------------------------------------------------

    def drive(
        self,
        on_finish: "Callable[[], Any]",
        full_mat: "Optional[np.ndarray]" = None,
        bounds: "Optional[List[Tuple[int, int]]]" = None,
    ) -> None:
        """Driver-thread body: every PG op in the fixed global interleave
        (``a2a_0, a2a_1, ag_0, a2a_2, ag_1, …``), gated on stage futures.
        The allgather leg runs when ``full_mat``/``bounds`` are given
        (allreduce); without them the pipeline ends at the reduces
        (reduce-scatter).  ``on_finish`` assembles the result after the
        last stage."""
        try:
            n = len(self.chunks)
            allgather = full_mat is not None
            for k in range(n):
                if self.error is not None:
                    return
                # chaos mid-pipeline (docs/robustness.md): the existing
                # pg.allreduce site is consulted per chunk WITHOUT step
                # context, so unconstrained rules (prob/times) inject
                # mid-pipeline while step-constrained rules keep their
                # training-step meaning; pg.allreduce.chunk carries the
                # CHUNK index for deterministic per-hop targeting.
                _faults.check("pg.allreduce")
                _faults.check("pg.allreduce.chunk", step=k)
                self._await(self.ready[k])
                self.submit_alltoall(k)
                if allgather and k >= 1:
                    self._await(self.reduce_done[k - 1])
                    self.submit_allgather(k - 1, full_mat, bounds)
            if allgather:
                self._await(self.reduce_done[n - 1])
                self.submit_allgather(n - 1, full_mat, bounds)
                waits = self.dequant_done
            else:
                waits = self.reduce_done
            for fut in waits:
                self._await(fut)
            self.finish_stats()
            self.out_fut.set_result(on_finish())
        except BaseException as e:  # noqa: BLE001 - funnel
            self.abort(e)

    def start_driver(
        self,
        on_finish: "Callable[[], Any]",
        full_mat: "Optional[np.ndarray]" = None,
        bounds: "Optional[List[Tuple[int, int]]]" = None,
    ) -> None:
        threading.Thread(
            target=self.drive,
            args=(on_finish, full_mat, bounds),
            name="tft_quant_pipeline",
            daemon=True,
        ).start()

    def wait_captured(self, futs: "List[Future]") -> None:
        """Block the caller until its contribution is fully captured —
        the call-time-snapshot contract.  A capture failure surfaces
        synchronously, like the monolithic codec's did."""
        futures_wait(futs, timeout=self.op_timeout)
        for f in futs:
            if not f.done():
                exc: BaseException = TimeoutError(
                    "codec pool did not capture the contribution in time"
                )
                self.abort(exc)
                raise exc
            e = f.exception()
            if e is not None:
                self.abort(e)
                raise e

    # -- finish ----------------------------------------------------------

    def finish_stats(self) -> None:
        """Compute the overlap accounting and publish it (driver thread,
        after the last stage)."""
        wall = time.perf_counter() - self.t_call
        codec_s = self.trace.busy_seconds()
        wire_s = self.trace.wire_seconds()
        floor = min(codec_s, wire_s)
        efficiency = (
            1.0
            if floor <= 0.0
            else max(0.0, min(1.0, (codec_s + wire_s - wall) / floor))
        )
        self.codec_s_box[0] = codec_s
        self.stats.update(
            wall_s=wall,
            codec_s=codec_s,
            wire_s=wire_s,
            overlap_efficiency=efficiency,
            hop_wire_s={
                h: round(v, 6) for h, v in sorted(self.hop_wire_s.items())
            },
        )
        _metrics.QUANT_OVERLAP_EFFICIENCY.labels(wire=self.wire_dtype).set(
            efficiency
        )
        _flightrec.record(
            "quant.pipeline",
            collective=self.collective,
            wire=self.wire_dtype,
            chunks=len(self.chunks),
            wall_s=round(wall, 6),
            codec_s=round(codec_s, 6),
            wire_s=round(wire_s, 6),
            overlap_efficiency=round(efficiency, 4),
        )
        # collective-level span: carries the codec/wire busy split the
        # trace ledger uses to attribute this wall time to codec vs wire
        tracer = _tracing.get_tracer()
        ctx = self.trace_ctx
        if tracer is not None and ctx is not None:
            end_ns = time.time_ns()
            tracer.export_span(
                name="quant.pipeline",
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=end_ns - int(wall * 1e9),
                end_ns=end_ns,
                attributes={
                    "collective": self.collective,
                    "wire": self.wire_dtype,
                    "chunks": len(self.chunks),
                    "codec_s": round(codec_s, 6),
                    "wire_s": round(wire_s, 6),
                    "overlap_efficiency": round(efficiency, 4),
                },
            )


class _HierPipeline(_ChunkPipeline):
    """Topology-aware multi-hop pipeline: executes a synthesized
    :class:`~torchft_tpu_torch.ops.topology.ReductionPlan` per chunk instead of
    the flat alltoall/allgather schedule.

    Rows are sliced per *group* (slice ``j`` owned by group ``j``'s
    leader); a chunk covers rows ``[a, b)`` of every slice at once, so
    one chunk's working set is a stacked ``(m*ck, cols)`` block.  Hops
    per chunk (ops/topology.py module docstring): ``intra.reduce`` →
    ``inter.exchange`` → ``inter.gather`` → ``intra.bcast``, with
    requantization at each hop boundary.  The driver staggers hops
    across chunks (intra hops of chunk k overlap inter wire of chunk
    k-1), submitting every rank's ops in the same global (chunk, hop)
    interleave so per-socket op streams stay consistent.

    All ranks dequantize the same reduced-piece bytes at the end, so the
    result is bit-identical across every rank of the collective — the
    property the hierarchical golden fixture pins.
    """

    def __init__(
        self,
        pg: ProcessGroup,
        wire_dtype: str,
        divisor: int,
        cols: int,
        chunks: "List[Tuple[int, int]]",
        plan: Any,
        bounds: "List[Tuple[int, int]]",
        full_mat: np.ndarray,
    ) -> None:
        super().__init__(pg, "allreduce", wire_dtype, divisor, cols, chunks)
        self.plan = plan
        self.topo = plan.topology
        self.m = self.topo.n_groups
        self.gidx = plan.group_index
        self.is_leader = plan.is_leader
        self.leader_rank = self.topo.leader(self.gidx)
        self.bounds = bounds
        self.full_mat = full_mat
        k = len(chunks)
        # hop-stage futures (the driver's gates); abort fails them all
        self.s1 = [Future() for _ in range(k)]  # intra reduce complete
        self.s2 = [Future() for _ in range(k)]  # own slice reduced+requant
        self.s3 = [Future() for _ in range(k)]  # all pieces held
        self.s4 = [Future() for _ in range(k)]  # chunk dequantized
        self._s1_bufs: "List[List[Optional[np.ndarray]]]" = [[] for _ in range(k)]
        self._s1_remaining = [0] * k
        self._exch_recv: "List[List[Optional[np.ndarray]]]" = [[] for _ in range(k)]
        self._s2_remaining = [0] * k
        self._pieces_all: "List[List[Optional[np.ndarray]]]" = [
            [None] * self.m for _ in range(k)
        ]
        self._s3_remaining = [0] * k
        self._s4_parts = [0] * k
        self._s4_send_remaining = [0] * k
        self.stats["topology"] = self.topo.describe()
        self.stats["plan"] = plan.describe()

    def _stage_future_lists(self) -> "Tuple[List[Future], ...]":
        return super()._stage_future_lists() + (
            self.s1, self.s2, self.s3, self.s4,
        )

    # -- hop 1: intra.reduce ---------------------------------------------

    def submit_intra_reduce(self, k: int) -> None:
        a, b = self.chunks[k]
        ck = b - a
        rows = self.m * ck
        if not self.is_leader:
            bufs = self.send_bufs[k]
            assert bufs is not None
            buf = bufs[0]
            t = time.perf_counter()
            self.submit_wire(
                "send", "intra.reduce", k,
                self.pg.send(buf, self.leader_rank, tag=4 * k),
                buf.nbytes, t,
                lambda _res, k=k, buf=buf: self._intra_send_done(k, buf),
            )
            return
        members = self.plan.hops[0].recvs
        if not members:
            self._intra_reduce_ready(k, [])
            return
        with self._latch_lock:
            self._s1_remaining[k] = len(members)
            self._s1_bufs[k] = [None] * len(members)
        nbytes = q.packed_nbytes(rows, self.cols)
        for i, rm in enumerate(members):
            t = time.perf_counter()
            self.submit_wire(
                "recv", "intra.reduce", k, self.pg.recv(rm, tag=4 * k),
                nbytes, t,
                lambda buf, k=k, i=i: self._intra_recv_one(k, i, buf),
            )

    def _intra_send_done(self, k: int, buf: np.ndarray) -> None:
        _POOL.give(buf)
        self.send_bufs[k] = None
        self.s1[k].set_result(None)

    def _intra_recv_one(self, k: int, i: int, buf: np.ndarray) -> None:
        q.validate_packed(buf, self.wire_dtype)
        with self._latch_lock:
            self._s1_bufs[k][i] = buf
            self._s1_remaining[k] -= 1
            last = self._s1_remaining[k] == 0
        if last:
            # single codec batch over ALL member bufs once the last one
            # landed: recvs serialize on the PG worker anyway, and one
            # batch keeps concurrent += off overlapping acc rows
            self._intra_reduce_ready(k, list(self._s1_bufs[k]))
            self._s1_bufs[k] = []

    def _intra_reduce_ready(
        self, k: int, member_bufs: "List[Optional[np.ndarray]]"
    ) -> None:
        a, b = self.chunks[k]
        ck = b - a
        rows = self.m * ck
        acc = self.accs[k]
        own_bufs: "List[np.ndarray]" = []
        if acc is None:
            # device-quantize path: the leader's own contribution is a
            # packed wire buffer too (quantized on-chip in one launch)
            own_bufs = list(self.send_bufs[k] or [])
            self.send_bufs[k] = None
            acc = _POOL.take((rows, self.cols), np.float32)
            self.accs[k] = acc
            overwrite_first = True
        else:
            overwrite_first = False
        bufs = own_bufs + [m for m in member_bufs if m is not None]
        if not bufs:
            self.s1[k].set_result(None)
            return
        t_red = time.perf_counter()

        def block(r0: int, r1: int) -> None:
            ow = overwrite_first
            for buf in bufs:
                q.fma_rows_packed(
                    buf, rows, self.cols, r0, r1, self.wire_dtype,
                    acc, r0, overwrite=ow,
                )
                ow = False

        futs = _cpool.run_blocks(rows, block, self.trace, lane="rx")

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="reduce", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_red)
            for buf in bufs:
                _POOL.give(buf)

        self.chain(futs, done, self.s1[k])

    # -- hop 2: inter.exchange -------------------------------------------

    def submit_inter_exchange(self, k: int) -> None:
        if not self.is_leader:
            self.s2[k].set_result(None)
            return
        if self.m == 1:
            self._finalize_own_slice(k, [])
            return
        a, b = self.chunks[k]
        ck = b - a
        acc = self.accs[k]
        assert acc is not None
        # requantize each foreign group's slice of the partial sum (the
        # hop-boundary requant), then pairwise-exchange with the other
        # leaders in the plan's offset order
        ex_bufs: "Dict[int, np.ndarray]" = {}
        futs_by_g: "Dict[int, List[Future]]" = {}
        t_q = time.perf_counter()
        for j in range(self.m):
            if j == self.gidx:
                continue
            buf = q.new_packed(ck, self.cols, self.wire_dtype, pool=_POOL)
            ex_bufs[j] = buf

            def requant(r0: int, r1: int, buf=buf, off=j * ck) -> None:
                q.quantize_rows_packed(
                    acc, off + r0, buf, ck, self.cols, r0, r1,
                    self.wire_dtype,
                )

            futs_by_g[j] = _cpool.run_blocks(ck, requant, self.trace)
        self.chain(
            [f for fs in futs_by_g.values() for f in fs],
            lambda: _metrics.QUANT_CODEC_SECONDS.labels(
                stage="quantize", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_q),
            Future(),
        )
        hop = self.plan.hops[1]
        with self._latch_lock:
            self._s2_remaining[k] = self.m - 1
            self._exch_recv[k] = [None] * (self.m - 1)
        for o, (dst, src) in enumerate(zip(hop.sends, hop.recvs)):
            dst_g = self.topo.group_index(dst)
            self.wait_captured(futs_by_g[dst_g])
            buf = ex_bufs[dst_g]
            t = time.perf_counter()
            self.submit_wire(
                "sendrecv", "inter.exchange", k,
                self.pg.sendrecv(buf, dst, src, tag=4 * k + 1),
                buf.nbytes, t,
                lambda rbuf, k=k, o=o, sbuf=buf: self._exch_one(
                    k, o, sbuf, rbuf
                ),
            )

    def _exch_one(
        self, k: int, o: int, sent: np.ndarray, rbuf: np.ndarray
    ) -> None:
        if rbuf is not sent:  # degraded PGs may alias the input back
            _POOL.give(sent)
        q.validate_packed(rbuf, self.wire_dtype)
        with self._latch_lock:
            self._exch_recv[k][o] = rbuf
            self._s2_remaining[k] -= 1
            last = self._s2_remaining[k] == 0
        if last:
            self._finalize_own_slice(
                k, [x for x in self._exch_recv[k] if x is not None]
            )
            self._exch_recv[k] = []

    def _finalize_own_slice(
        self, k: int, rbufs: "List[np.ndarray]"
    ) -> None:
        """Fold peer leaders' partial sums into the own slice, divide
        (AVG fusion), requantize into the broadcast piece."""
        a, b = self.chunks[k]
        ck = b - a
        g = self.gidx
        acc = self.accs[k]
        assert acc is not None
        piece = q.new_packed(ck, self.cols, self.wire_dtype, pool=_POOL)
        self.pieces[k] = piece
        t_red = time.perf_counter()

        def block(r0: int, r1: int) -> None:
            for rbuf in rbufs:
                q.fma_rows_packed(
                    rbuf, ck, self.cols, r0, r1, self.wire_dtype,
                    acc, g * ck + r0, overwrite=False,
                )
            if self.divisor:
                q.div_rows(acc, g * ck + r0, g * ck + r1, self.divisor)
            q.quantize_rows_packed(
                acc, g * ck + r0, piece, ck, self.cols, r0, r1,
                self.wire_dtype,
            )

        futs = _cpool.run_blocks(ck, block, self.trace, lane="rx")

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="reduce", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_red)
            seen = set()
            for rbuf in rbufs:
                if id(rbuf) not in seen:
                    seen.add(id(rbuf))
                    _POOL.give(rbuf)
            # every slice is now either requantized (sent or piece) —
            # the f32 accumulator is scratch from here
            _POOL.give(acc)
            self.accs[k] = None

        self.chain(futs, done, self.s2[k])

    # -- hop 3: inter.gather ---------------------------------------------

    def submit_inter_gather(self, k: int) -> None:
        if not self.is_leader:
            self.s3[k].set_result(None)
            return
        piece = self.pieces[k]
        assert piece is not None
        self._pieces_all[k][self.gidx] = piece
        if self.m == 1:
            self.s3[k].set_result(None)
            return
        hop = self.plan.hops[2]
        with self._latch_lock:
            self._s3_remaining[k] = self.m - 1
        for dst, src in zip(hop.sends, hop.recvs):
            src_g = self.topo.group_index(src)
            t = time.perf_counter()
            self.submit_wire(
                "sendrecv", "inter.gather", k,
                self.pg.sendrecv(piece, dst, src, tag=4 * k + 2),
                piece.nbytes, t,
                lambda rbuf, k=k, src_g=src_g: self._gather_one(
                    k, src_g, rbuf
                ),
            )

    def _gather_one(self, k: int, src_g: int, rbuf: np.ndarray) -> None:
        q.validate_packed(rbuf, self.wire_dtype)
        with self._latch_lock:
            self._pieces_all[k][src_g] = rbuf
            self._s3_remaining[k] -= 1
            last = self._s3_remaining[k] == 0
        if last:
            self.s3[k].set_result(None)

    # -- hop 4: intra.bcast ----------------------------------------------

    def _s4_part_done(self, k: int) -> None:
        with self._latch_lock:
            self._s4_parts[k] -= 1
            last = self._s4_parts[k] == 0
        if last:
            self.s4[k].set_result(None)

    def submit_intra_bcast(self, k: int) -> None:
        a, b = self.chunks[k]
        ck = b - a
        pn = q.packed_nbytes(ck, self.cols)
        if not self.is_leader:
            t = time.perf_counter()
            with self._latch_lock:
                self._s4_parts[k] = 1
            self.submit_wire(
                "recv", "intra.bcast", k,
                self.pg.recv(self.leader_rank, tag=4 * k + 3),
                self.m * pn, t,
                lambda bundle, k=k: self._bcast_recv(k, bundle),
            )
            return
        pieces = self._pieces_all[k]
        assert all(p is not None for p in pieces)
        members = self.plan.hops[3].sends
        with self._latch_lock:
            self._s4_parts[k] = 1 + (1 if members else 0)
            self._s4_send_remaining[k] = len(members)
        if members:
            bundle = _POOL.take(self.m * pn, np.uint8)
            for j, p in enumerate(pieces):
                bundle[j * pn : (j + 1) * pn] = p
            for rm in members:
                t = time.perf_counter()
                self.submit_wire(
                    "send", "intra.bcast", k,
                    self.pg.send(bundle, rm, tag=4 * k + 3),
                    bundle.nbytes, t,
                    lambda _res, k=k, bundle=bundle: self._bcast_send_done(
                        k, bundle
                    ),
                )
        self._dequant_pieces(k, list(pieces), give=pieces, owner=True)

    def _bcast_send_done(self, k: int, bundle: np.ndarray) -> None:
        with self._latch_lock:
            self._s4_send_remaining[k] -= 1
            last = self._s4_send_remaining[k] == 0
        if last:
            _POOL.give(bundle)
            self._s4_part_done(k)

    def _bcast_recv(self, k: int, bundle: np.ndarray) -> None:
        a, b = self.chunks[k]
        ck = b - a
        pn = q.packed_nbytes(ck, self.cols)
        pieces = [bundle[j * pn : (j + 1) * pn] for j in range(self.m)]
        self._dequant_pieces(k, pieces, give=[bundle], owner=False)

    def _dequant_pieces(
        self,
        k: int,
        pieces: "List[np.ndarray]",
        give: "List[Optional[np.ndarray]]",
        owner: bool,
    ) -> None:
        """Dequantize every slice's reduced piece straight into its
        offset of the full output matrix (same bytes on every rank →
        bit-identical results across the collective)."""
        a, b = self.chunks[k]
        ck = b - a
        for p in pieces:
            q.validate_packed(p, self.wire_dtype)
        t_dq = time.perf_counter()
        futs: "List[Future]" = []
        for j, p in enumerate(pieces):
            base = self.bounds[j][0] + a

            def blk(r0: int, r1: int, p=p, base=base) -> None:
                q.dequant_rows_into(
                    p, ck, self.cols, r0, r1, self.wire_dtype,
                    self.full_mat, base + r0,
                )

            futs += _cpool.run_blocks(ck, blk, self.trace, lane="rx")

        def done() -> None:
            _metrics.QUANT_CODEC_SECONDS.labels(
                stage="dequant", wire=self.wire_dtype
            ).observe(time.perf_counter() - t_dq)
            seen = set()
            for buf in give:
                if buf is not None and id(buf) not in seen:
                    seen.add(id(buf))
                    _POOL.give(buf)
            if owner:
                self.pieces[k] = None
                self._pieces_all[k] = [None] * self.m
            self._s4_part_done(k)

        self.chain(futs, done, Future())

    # -- driver ----------------------------------------------------------

    def drive(
        self,
        on_finish: "Callable[[], Any]",
        full_mat: "Optional[np.ndarray]" = None,
        bounds: "Optional[List[Tuple[int, int]]]" = None,
    ) -> None:
        """Plan-driven driver: tick t submits intra.reduce(t),
        inter.exchange(t-1), inter.gather(t-2), intra.bcast(t-3) — the
        stagger that overlaps chunk k's intra hops with chunk k-1's
        inter-host wire.  Every rank runs the identical loop, so the
        global submission interleave is uniform (per-socket stream
        consistency) and a chaos abort leaves all ranks at the same
        stream position (PG reuse after a mid-pipeline fault)."""
        try:
            n = len(self.chunks)
            for t in range(n + 3):
                if self.error is not None:
                    return
                if t < n:
                    # same chaos contract as the flat driver, per chunk
                    _faults.check("pg.allreduce")
                    _faults.check("pg.allreduce.chunk", step=t)
                    self._await(self.ready[t])
                    self.submit_intra_reduce(t)
                if 0 <= t - 1 < n:
                    self._await(self.s1[t - 1])
                    # per-hop chaos: fired before the inter-host hops of
                    # this chunk are submitted (step = chunk index)
                    _faults.check("pg.allreduce.hop", step=t - 1)
                    self.submit_inter_exchange(t - 1)
                if 0 <= t - 2 < n:
                    self._await(self.s2[t - 2])
                    self.submit_inter_gather(t - 2)
                if 0 <= t - 3 < n:
                    self._await(self.s3[t - 3])
                    self.submit_intra_bcast(t - 3)
            for fut in self.s4:
                self._await(fut)
            self.finish_stats()
            self.out_fut.set_result(on_finish())
        except BaseException as e:  # noqa: BLE001 - funnel
            self.abort(e)


def _is_float(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return bool(np.issubdtype(a.dtype, np.floating))


def _out_leaf(flat: np.ndarray, kind: "Tuple[bool, Any]") -> Any:
    """An f32 host result in the input leaf's kind and dtype: a tensor
    leaf comes back as a CPU tensor (zero-copy when f32), a numpy leaf as
    a numpy array."""
    is_tensor, dtype = kind
    if is_tensor:
        t = torch.from_numpy(flat)
        return t if dtype == torch.float32 else t.to(dtype)
    return np.asarray(flat, dtype=dtype)


def _device_quantize(
    arrays: "List[Any]", rows: int, cols: int
) -> "Tuple[torch.Tensor, torch.Tensor, Optional[torch.cuda.Event]]":
    """Kernel D over all leaves, concatenated as f32 into a zeroed
    ``(rows, cols)`` matrix on their device.  Returns the device scales and
    payload, and the CUDA event recorded after the launch on the caller's
    stream (None on the CPU, where the twin ran)."""
    from torchft_tpu_torch.ops import pallas_quant as pq

    tensors = [
        a if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(a))
        for a in arrays
    ]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("device_quantize needs every leaf on one device")
    mat = torch.zeros(rows * cols, dtype=torch.float32, device=dev)
    off = 0
    for t in tensors:
        n = t.numel()
        mat[off : off + n].copy_(t.detach().reshape(-1))
        off += n
    scales, payload = pq.quantize_int8(mat.view(rows, cols))
    event = None
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return scales, payload, event


def _copy_rows(
    event: "Optional[torch.cuda.Event]", scales_dev: torch.Tensor,
    payload_dev: torch.Tensor, g0: int, sc: np.ndarray, pl: np.ndarray,
) -> None:
    """Device rows ``[g0, g0 + len(sc))`` of the quantized matrix into the
    packed host views ``sc``/``pl`` (codec-pool thread).  The copy waits on
    ``event`` on this thread's current stream, so it never reads rows the
    kernel has not written, whatever stream the caller launched on; the
    copy into pageable memory returns when it is done."""
    n = sc.shape[0]
    if event is None:
        torch.from_numpy(sc).copy_(scales_dev[g0 : g0 + n])
        torch.from_numpy(pl).copy_(payload_dev[g0 : g0 + n])
        return
    with torch.cuda.device(scales_dev.device):
        torch.cuda.current_stream().wait_event(event)
        torch.from_numpy(sc).copy_(scales_dev[g0 : g0 + n])
        torch.from_numpy(pl).copy_(payload_dev[g0 : g0 + n])


def _attach_accounting(
    work: Work, pipe: "Optional[_ChunkPipeline]", wire_bytes: int,
    unquantized: int, wire_dtype: str, device_quantized: bool = False,
) -> Work:
    work.wire_bytes = wire_bytes
    work.unquantized_wire_bytes = unquantized
    work.device_quantized = device_quantized
    work.wire_dtype = wire_dtype
    if pipe is not None:
        # both written once, at pipeline completion (finish_stats) —
        # read them AFTER wait(); mid-flight reads see 0.0 / partial keys
        work.codec_s_box = pipe.codec_s_box
        work.quant_stats = pipe.stats
    return work


def _resolve_topology(
    topology: "None | str | _topo.Topology", world: int
) -> "Optional[_topo.Topology]":
    """Explicit Topology object, spec string, or (None) the
    ``TORCHFT_TOPOLOGY`` env default — ``None`` result = flat."""
    if isinstance(topology, _topo.Topology):
        if topology.world != world:
            raise ValueError(
                f"topology describes {topology.world} ranks, "
                f"collective world is {world}"
            )
        return topology
    if isinstance(topology, str):
        return _topo.parse_topology(topology, world)
    return _topo.resolve_topology(world)


def allreduce_quantized(
    arrays: "List[Any]",
    op: str,
    pg: ProcessGroup,
    average_by: "int | None" = None,
    device_quantize: "Optional[bool]" = None,
    wire_dtype: "Optional[str]" = None,
    topology: "None | str | _topo.Topology" = None,
) -> Work:
    """8-bit quantized allreduce of a list of float arrays.

    Returns a Work resolving to the dequantized reduced arrays (f32
    precision loss ~1e-2 relative; see tests for bounds).  The Work
    carries ``wire_bytes`` / ``unquantized_wire_bytes`` attributes with
    the measured per-rank wire payload, a ``codec_s_box`` (codec-busy
    seconds, filled as stages run) and ``quant_stats`` (per-collective
    pipeline accounting incl. ``overlap_efficiency``) — read after
    ``wait``.

    Args:
        average_by: divide the sum by this count (fused into the requant
            step); defaults to pg.size() when op is AVG.
        device_quantize: quantize on the device with kernel D before the
            device→host copy.  Default: auto — on when every input is a
            CUDA tensor and the wire is int8.  ``True`` with CPU tensors
            or numpy arrays takes kernel D's plain twin on the CPU.  int8
            wire only (the fp8 leg is host-codec).
        wire_dtype: ``"int8"`` (default) or ``"fp8_e4m3"`` — the payload
            format on the DCN wire (same byte count either way; the
            reference's fp8e4nv/int8 pair, torchft/quantization.py:30-41).
            Defaults to ``TORCHFT_QUANT_WIRE`` when set.
        topology: wire topology selecting the reduction plan — a
            :class:`~torchft_tpu_torch.ops.topology.Topology`, a spec string
            (``TORCHFT_TOPOLOGY`` grammar), or None for the env default.
            Flat (unset) runs today's alltoall/allgather schedule
            bit-identically; a grouped topology runs the hierarchical
            multi-hop plan (intra-host reduce → inter-host leader
            exchange → intra-host broadcast, requantizing at hop
            boundaries).  Must agree across ranks.
    """
    if op not in (REDUCE_SUM, REDUCE_AVG):
        raise ValueError(f"quantized allreduce supports sum/avg, got {op}")
    wire_dtype = q.resolve_wire(wire_dtype)  # validate before any comm
    # normalize non-array inputs (lists, Python scalars) without touching
    # device arrays
    arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a) for a in arrays]
    for a in arrays:
        if not _is_float(a):
            raise ValueError("quantized allreduce requires floating point arrays")
    if device_quantize is None:
        device_quantize = wire_dtype == q.WIRE_INT8 and all(
            isinstance(a, torch.Tensor) and a.is_cuda for a in arrays
        )
    elif device_quantize and wire_dtype != q.WIRE_INT8:
        raise ValueError(
            "device_quantize supports the int8 wire only (no fp8 quantize "
            "kernel — the host codec carries fp8)"
        )

    shapes = [tuple(a.shape) for a in arrays]
    sizes = [
        int(a.numel()) if isinstance(a, torch.Tensor) else int(a.size)
        for a in arrays
    ]
    out_kinds = [(isinstance(a, torch.Tensor), a.dtype) for a in arrays]

    world = pg.size()
    if world <= 1:
        out = [
            a.detach().cpu().clone() if isinstance(a, torch.Tensor) else np.array(a)
            for a in arrays
        ]
        if op == REDUCE_AVG and average_by:
            out = [a / average_by for a in out]
        solo = completed_work(out)
        return _attach_accounting(solo, None, 0, 0, wire_dtype)
    divisor = average_by if average_by is not None else (world if op == REDUCE_AVG else 0)

    # Flatten all arrays into one (rows, cols) matrix of quantization rows so
    # a single pipelined alltoall/allgather schedule covers every gradient
    # (the reference fuses arrays into one comm buffer the same way).
    total = sum(sizes)
    if total == 0:
        # nothing to reduce: zero-size outputs, no wire, no pipeline
        solo = completed_work([
            torch.zeros(s, dtype=dt) if is_t else np.zeros(s, dt)
            for s, (is_t, dt) in zip(shapes, out_kinds)
        ])
        return _attach_accounting(solo, None, 0, 0, wire_dtype)
    cols = 2048 if total >= 2048 else max(total, 1)
    topo = _resolve_topology(topology, world)
    if topo is not None:
        return _allreduce_hier(
            arrays, pg, topo, divisor, device_quantize, wire_dtype,
            shapes, sizes, out_kinds, total, cols,
        )
    rows = -(-total // cols)
    # pad rows to a multiple of world so row-slices are even
    rows = -(-rows // world) * world
    bounds = _slice_rows(rows, world)
    slice_rows = rows // world  # identical for every rank by construction
    chunks = _chunk_bounds(slice_rows, _resolve_chunk_rows(slice_rows, cols))

    pipe = _ChunkPipeline(pg, "allreduce", wire_dtype, divisor, cols, chunks)
    my_rank = pipe.my_rank
    # The full output matrix escapes to the caller as views — never pooled.
    full_mat = np.empty((rows, cols), dtype=np.float32)

    # ---- capture: quantize peer slices / copy the own slice, per chunk --
    capture_futs: "List[Future]" = []
    if device_quantize:
        scales_dev, payload_dev, event = _device_quantize(arrays, rows, cols)
        for k, (a, b) in enumerate(chunks):
            ck = b - a
            t_cap = time.perf_counter()
            bufs_k: "List[np.ndarray]" = []
            futs_k: "List[Future]" = []
            for r in range(world):
                g0 = bounds[r][0] + a
                buf = q.new_packed(ck, cols, wire_dtype, pool=_POOL)
                bufs_k.append(buf)

                def copy_chunk(r0: int, r1: int, g0=g0, buf=buf, ck=ck) -> None:
                    # device→host hop of this chunk's slice: overlaps the
                    # sends of earlier chunks (the PCIe/DMA leg of the
                    # pipeline). Row-range [r0, r1) is the whole chunk —
                    # transfers are not worth sub-splitting.
                    sc, pl = q._packed_views(buf, ck, cols, wire_dtype)
                    _copy_rows(
                        event, scales_dev, payload_dev, g0 + r0,
                        sc[r0:r1], pl[r0:r1],
                    )

                futs_k += _cpool.run_blocks(
                    ck, copy_chunk, pipe.trace, min_rows=ck
                )
            pipe.send_bufs[k] = bufs_k
            pipe.capture_chunk(k, futs_k, [], t_cap)
            capture_futs += futs_k
    else:
        np_arrays = [_host(a) for a in arrays]
        # Zero-copy flatten: a single contiguous f32 input (THE hot case —
        # a DiLoCo pseudograd fragment) is viewed, not copied; multi-array
        # inputs concatenate once.  Chunks then quantize straight off the
        # source; only chunks spanning the padded tail pay a small zeroed
        # copy.
        if (
            len(np_arrays) == 1
            and np_arrays[0].dtype == np.float32
            and np_arrays[0].flags.c_contiguous
        ):
            src = np_arrays[0].ravel()
        else:
            src = np.concatenate(
                [a.astype(np.float32, copy=False).ravel() for a in np_arrays]
            )
        full_rows = src.size // cols
        src2d = src[: full_rows * cols].reshape(full_rows, cols)

        capture_futs = pipe.capture_host_chunks(
            bounds,
            src2d,
            lambda k, a, b: _POOL.take((b - a, cols), np.float32),
            src_flat=src,
            full_rows=full_rows,
        )

    def assemble() -> "List[Any]":
        full = full_mat.ravel()[:total]
        out = []
        offset = 0
        for shape, size, kind in zip(shapes, sizes, out_kinds):
            # zero-copy view when the leaf is already f32 (disjoint
            # slices of the output matrix)
            out.append(
                _out_leaf(full[offset : offset + size].reshape(shape), kind)
            )
            offset += size
        return out

    pipe.start_driver(assemble, full_mat, bounds)

    # call-time-snapshot contract: the contribution is fully captured
    # before the submit returns (capture overlaps the driver's wire ops on
    # earlier chunks, so this blocks for ~the codec's quantize leg only)
    pipe.wait_captured(capture_futs)

    out_work = Work(pipe.out_fut)
    # Observability: measured wire bytes vs the unquantized f32 equivalent
    # (the ~4x reduction the codec exists for).  alltoall leg: only slots
    # bound for peers hit the wire (self-delivery is a local copy); the
    # allgather leg then sends each reduced piece to (w-1) peers.
    # Computed from the chunk plan, not the live buffers — those recycle
    # into the pool as the pipeline drains.
    packed_total = sum(q.packed_nbytes(b - a, cols) for a, b in chunks)
    wire_bytes = 2 * (world - 1) * packed_total
    return _attach_accounting(
        out_work, pipe, wire_bytes, 4 * total, wire_dtype,
        device_quantized=bool(device_quantize),
    )


def _allreduce_hier(
    arrays: "List[Any]",
    pg: ProcessGroup,
    topo: "_topo.Topology",
    divisor: int,
    device_quantize: bool,
    wire_dtype: str,
    shapes: "List[Tuple[int, ...]]",
    sizes: "List[int]",
    out_kinds: "List[Tuple[bool, Any]]",
    total: int,
    cols: int,
) -> Work:
    """Hierarchical-plan body of :func:`allreduce_quantized`: rows are
    sliced per GROUP (padded to a multiple of the group count) and the
    synthesized plan runs per chunk on a :class:`_HierPipeline`."""
    rank = pg.rank()
    m = topo.n_groups
    rows = -(-total // cols)
    # pad rows to a multiple of the group count so group slices are even
    rows = -(-rows // m) * m
    bounds = _slice_rows(rows, m)
    slice_rows = rows // m
    chunks = _chunk_bounds(slice_rows, _resolve_chunk_rows(slice_rows, cols))
    plan = _topo.synthesize_plan(topo, rank)
    # TORCHFT_PLAN_VERIFY: validate the fleet-wide plan this rank's
    # schedule is a slice of, at the one build point every rank passes.
    from torchft_tpu_torch.analysis import plan_verify as _pv

    if _pv.enabled():
        from torchft_tpu_torch.analysis import plan_ir as _pir

        _pv.check_live(
            _pir.reduction_ir(topo, wire=wire_dtype,
                              slice_nbytes=slice_rows * cols)
        )
    # The full output matrix escapes to the caller as views — never pooled.
    full_mat = np.empty((rows, cols), dtype=np.float32)
    pipe = _HierPipeline(
        pg, wire_dtype, divisor, cols, chunks, plan, bounds, full_mat
    )

    capture_futs: "List[Future]" = []
    if device_quantize:
        scales_dev, payload_dev, event = _device_quantize(arrays, rows, cols)
        for k, (a, b) in enumerate(chunks):
            ck = b - a
            t_cap = time.perf_counter()
            buf = q.new_packed(m * ck, cols, wire_dtype, pool=_POOL)
            pipe.send_bufs[k] = [buf]
            futs_k: "List[Future]" = []
            for j in range(m):
                g0 = bounds[j][0] + a

                def copy_chunk(
                    r0: int, r1: int, g0=g0, buf=buf, off=j * ck, ck=ck
                ) -> None:
                    # device→host hop of this chunk's slice rows, stacked
                    # at the slice's offset of the packed stage-1 buffer
                    sc, pl = q._packed_views(buf, m * ck, cols, wire_dtype)
                    _copy_rows(
                        event, scales_dev, payload_dev, g0 + r0,
                        sc[off + r0 : off + r1], pl[off + r0 : off + r1],
                    )

                futs_k += _cpool.run_blocks(
                    ck, copy_chunk, pipe.trace, min_rows=ck
                )
            pipe.capture_chunk(k, futs_k, [], t_cap)
            capture_futs += futs_k
    else:
        np_arrays = [_host(a) for a in arrays]
        if (
            len(np_arrays) == 1
            and np_arrays[0].dtype == np.float32
            and np_arrays[0].flags.c_contiguous
        ):
            src = np_arrays[0].ravel()
        else:
            src = np.concatenate(
                [a.astype(np.float32, copy=False).ravel() for a in np_arrays]
            )
        full_rows = src.size // cols
        src2d = src[: full_rows * cols].reshape(full_rows, cols)
        for k, (a, b) in enumerate(chunks):
            ck = b - a
            t_cap = time.perf_counter()
            futs_k = []
            give_after: "List[np.ndarray]" = []
            if pipe.is_leader:
                # leader contribution stays raw f32 (zero codec time and
                # zero quantization error on own data, like the flat
                # pipeline's own slice)
                acc = _POOL.take((m * ck, cols), np.float32)
                pipe.accs[k] = acc
            else:
                buf = q.new_packed(m * ck, cols, wire_dtype, pool=_POOL)
                pipe.send_bufs[k] = [buf]
            for j in range(m):
                g0 = bounds[j][0] + a
                if g0 + ck > full_rows:
                    tail = _POOL.take((ck, cols), np.float32)
                    give_after.append(tail)
                    _fill_tail(src, tail, g0, cols)
                    block_src, row0 = tail, 0
                else:
                    block_src, row0 = src2d, g0
                if pipe.is_leader:

                    def copy_own(
                        r0: int, r1: int, acc=acc, bs=block_src,
                        row0=row0, off=j * ck,
                    ) -> None:
                        np.copyto(
                            acc[off + r0 : off + r1],
                            bs[row0 + r0 : row0 + r1],
                        )

                    futs_k += _cpool.run_blocks(ck, copy_own, pipe.trace)
                else:

                    def quant_member(
                        r0: int, r1: int, buf=buf, bs=block_src,
                        row0=row0, off=j * ck, ck=ck,
                    ) -> None:
                        q.quantize_rows_packed(
                            bs, row0 + r0, buf, m * ck, cols,
                            off + r0, off + r1, wire_dtype,
                        )

                    futs_k += _cpool.run_blocks(ck, quant_member, pipe.trace)
            pipe.capture_chunk(k, futs_k, give_after, t_cap)
            capture_futs += futs_k

    def assemble() -> "List[Any]":
        full = full_mat.ravel()[:total]
        out = []
        offset = 0
        for shape, size, kind in zip(shapes, sizes, out_kinds):
            out.append(
                _out_leaf(full[offset : offset + size].reshape(shape), kind)
            )
            offset += size
        return out

    pipe.start_driver(assemble)
    pipe.wait_captured(capture_futs)

    out_work = Work(pipe.out_fut)
    # Egress accounting from the plan (live buffers recycle as the
    # pipeline drains): members ship one stacked quantized copy up;
    # leaders pay the two inter-host hops plus the member broadcast.
    packed_slice = sum(q.packed_nbytes(b - a, cols) for a, b in chunks)
    packed_stacked = sum(
        q.packed_nbytes(m * (b - a), cols) for a, b in chunks
    )
    if pipe.is_leader:
        n_members = len(topo.members(pipe.gidx))
        inter = 2 * (m - 1) * packed_slice
        wire_bytes = inter + n_members * m * packed_slice
    else:
        inter = 0
        wire_bytes = packed_stacked
    work = _attach_accounting(
        out_work, pipe, wire_bytes, 4 * total, wire_dtype,
        device_quantized=bool(device_quantize),
    )
    # inter-host egress alone — the bytes the WAN RTT/bandwidth model
    # actually charges for; bench reports it next to the hop telemetry
    work.inter_wire_bytes = inter
    return work


def reduce_scatter_quantized(
    array: Any, op: str, pg: ProcessGroup, wire_dtype: "Optional[str]" = None
) -> Work:
    """8-bit quantized reduce-scatter: the alltoall+reduce legs of the
    pipeline without the allgather (reference collectives.py:159-294).
    Resolves to this rank's dequantized row-slice of the reduction.
    ``wire_dtype`` defaults to ``TORCHFT_QUANT_WIRE`` like the allreduce
    (one env knob, both collectives).  Always runs the flat plan:
    reduce-scatter's output contract is per-RANK row slices, which a
    group-sliced hierarchical plan would redefine — ``TORCHFT_TOPOLOGY``
    applies to the allreduce only.  A tensor input resolves to a CPU
    tensor, a numpy input to a numpy array, f32 either way."""
    if op not in (REDUCE_SUM, REDUCE_AVG):
        raise ValueError(f"quantized reduce_scatter supports sum/avg, got {op}")
    wire_dtype = q.resolve_wire(wire_dtype)
    is_tensor = isinstance(array, torch.Tensor)
    if not is_tensor:
        array = np.asarray(array)
    if not _is_float(array):
        raise ValueError("quantized reduce_scatter requires floating point arrays")
    np_array = _host(array)
    kind = (is_tensor, torch.float32 if is_tensor else np.float32)
    world = pg.size()
    if world <= 1:
        solo = completed_work(_out_leaf(np_array.astype(np.float32), kind))
        return _attach_accounting(solo, None, 0, 0, wire_dtype)
    if np_array.shape[0] % world != 0:
        raise ValueError(
            f"reduce_scatter dim0 {np_array.shape[0]} not divisible by {world}"
        )
    divisor = world if op == REDUCE_AVG else 0

    rows_total = np_array.shape[0]
    cols = int(np.prod(np_array.shape[1:], dtype=np.int64)) or 1
    mat = np.ascontiguousarray(
        np_array.reshape(rows_total, cols), dtype=np.float32
    )
    bounds = _slice_rows(rows_total, world)
    my_rank = pg.rank()
    my_rows = bounds[my_rank][1] - bounds[my_rank][0]
    chunks = _chunk_bounds(my_rows, _resolve_chunk_rows(my_rows, cols))
    pipe = _ChunkPipeline(
        pg, "reduce_scatter", wire_dtype, divisor, cols, chunks
    )
    out_shape = (my_rows,) + np_array.shape[1:]
    # the raw f32 result (no requant: the reduced slice stays local, so
    # requantizing would only add error) — escapes to the caller, so a
    # plain allocation, and the per-chunk accumulators are REGIONS of it
    out_mat = np.empty((my_rows, cols), dtype=np.float32)

    # own-slice accumulators ARE regions of the caller-visible output; the
    # reduce fma-accumulates peers into them in place, no requant
    capture_futs = pipe.capture_host_chunks(
        bounds, mat, lambda k, a, b: out_mat[a:b]
    )
    pipe.start_driver(lambda: _out_leaf(out_mat.reshape(out_shape), kind))
    pipe.wait_captured(capture_futs)

    out_work = Work(pipe.out_fut)
    # no allgather hop here: only the alltoall's peer slots cross the wire
    # (computed from the chunk plan — live buffers recycle as chunks drain)
    wire_bytes = (world - 1) * sum(
        q.packed_nbytes(b - a, cols) for a, b in chunks
    )
    return _attach_accounting(
        out_work, pipe, wire_bytes, 4 * (rows_total - my_rows) * cols,
        wire_dtype,
    )
