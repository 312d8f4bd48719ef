"""HTTP checkpoint transport: pull-based live weight streaming.

PyTorch port of ``torchft_tpu/checkpointing/http_transport.py`` (reference:
torchft/checkpointing/http_transport.py:73-299): each worker runs
a daemon HTTP server; ``send_checkpoint`` stages the state dict (host copies)
under an RWLock and serves ``GET /checkpoint/{step}/{full|metadata|chunk_i}``;
receivers fetch the full stream or parallel-fetch round-robin chunks with a
thread pool.  The RWLock guarantees the staged snapshot cannot be replaced
mid-serve; ``disallow_checkpoint`` retires it before the optimizer mutates
parameters.

Striped heal (docs/architecture.md "Striped heal"): heal
snapshots can instead stage as a cut-through fragment stream
(``send_checkpoint_streamed`` — header first, digest manifest last) and
a healer stripes disjoint fragment ranges across every max-step quorum
peer (``recv_checkpoint_striped`` — per-fragment failover, delta diffs,
decode overlapping wire into retained ``into=`` buffers), all over the
shared fragment plane (``checkpointing/fragments.py``).

What differs from the JAX package: state leaves are torch tensors
(flattened in JAX's order by ``utils.pytree``).  ``send_checkpoint``
snapshots them by copy (a CUDA tensor to the host once, a CPU tensor
cloned), since an optimizer updates them in place after the commit; the
streamed path serializes every fragment to bytes before it returns.  A
heal decodes into the receiver's existing tensors, on whatever device
they live.  With a durable fragment store attached (``attach_store``),
versions absent from RAM serve their fragments from disk and
``/store/versions`` lists the disk's restore catalog, so a cold-start
restore rides the same striped fetch as a live heal.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import fragdata as _fragdata
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.retry import RetryPolicy
from torchft_tpu_torch.utils.pytree import tree_flatten, tree_map
from torchft_tpu_torch.utils.rwlock import RWLock

logger = logging.getLogger(__name__)

# Checkpoint fetch retry: the healer and the sender learn the quorum
# simultaneously, so the sender may still be device->host staging the
# snapshot — poll through retryable 503s (and connection errors during a
# sender restart) with jittered backoff until the receiver's deadline.
# Permanent failures (404 bad path / chunk range) fail immediately.
#: Staged-snapshot slots kept live at once (heal steps + reshard epochs);
#: oldest-inserted evicts first.  4 covers a heal and a reshard in flight
#: plus one superseded generation of each.
_MAX_STAGED = 4

_FETCH_POLICY = RetryPolicy(
    name="transport.http.fetch",
    base_delay=0.05,
    multiplier=2.0,
    max_delay=1.0,
    retry_if=lambda e: (
        e.code == 503
        if isinstance(e, urllib.error.HTTPError)
        else isinstance(e, (urllib.error.URLError, ConnectionError, OSError))
    ),
)


class _Staged:
    """One staged snapshot slot.

    ``complete=False`` is the serving tier's CUT-THROUGH state: the
    document is still streaming in fragment by fragment
    (``stage_streamed_part``).  While incomplete, a missing ``frag_*``
    resource is a retryable 503 (the child/client polls until the relay
    stages it — that IS the cut-through overlap) and whole-document
    resources (``full``/``metadata``/``chunk_*``) 503 too: a torn
    version must never serve.  ``pooled`` tracks bufpool-backed buffers
    this slot owns; they return to the pool when the slot is retired.

    ``grace``: streamed HEAL slots hold serialized BYTES — immutable
    copies, unlike the legacy host-array snapshot that aliases the live
    optimizer state — so they may legally outlive the step commit.  A
    positive grace survives that many ``disallow_checkpoint`` rounds
    before retiring, which keeps a striped healer's multi-request fetch
    window open across the sources' commit instead of tearing it at the
    first fast peer's ``should_commit``.
    """

    __slots__ = ("sd", "num_chunks", "complete", "pooled", "grace")

    def __init__(
        self,
        sd: Any,
        num_chunks: int = 1,
        complete: bool = True,
        grace: int = 0,
    ):
        self.sd = sd
        self.num_chunks = num_chunks
        self.complete = complete
        self.pooled: "List[Any]" = []
        self.grace = grace

    def release(self) -> None:
        from torchft_tpu_torch.utils.bufpool import POOL

        for buf in self.pooled:
            POOL.give(buf)
        self.pooled = []


class _HTTPServerIPv6(ThreadingHTTPServer):
    address_family = socket.AF_INET6
    daemon_threads = True


def _make_server() -> ThreadingHTTPServer:
    # IPv6 dual-stack when available (reference: torchft/http.py:5-7).
    try:
        return _HTTPServerIPv6(("::", 0), _Handler)
    except OSError:
        return ThreadingHTTPServer(("0.0.0.0", 0), _Handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Idle keep-alive reap: persistent fetcher connections (serving tier,
    # serving/fetcher.py) would otherwise pin one server thread each for
    # the life of the client; a timed-out WAIT for the next request
    # closes the connection.  Scoped to the between-requests wait only
    # (re-armed below, disarmed before serving): an in-flight response
    # body — a multi-GB heal stream stalling on a congested link — must
    # block like it always did, not die at the idle timeout.
    timeout = 30.0
    transport: "HTTPTransport"  # injected per-server subclass attr

    def handle_one_request(self) -> None:
        self.connection.settimeout(self.timeout)
        super().handle_one_request()

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet
        logger.debug("http: " + fmt, *args)

    def _retry_later(self, message: str) -> None:
        # Retryable 503 WITHOUT closing the connection (``send_error``
        # sends ``Connection: close``): the cut-through pollers re-ask
        # the same keep-alive connection every few ms — a reconnect per
        # poll would dominate the poll itself at WAN RTTs.
        body = message.encode("utf-8", "replace")
        self.send_response(503, "retry later")
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except BrokenPipeError:
            pass

    def _send_bytes(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except BrokenPipeError:
            pass

    def _serve_store_catalog(self, transport: "HTTPTransport") -> None:
        """``/store/versions``: this rank's durable-store restore
        inventory (version -> cut id, fragment list, digest-valid
        fragments) for fleet-wide cold-start cut selection."""
        import json

        store = transport._store
        if store is None:
            self.send_error(404, "no durable store attached")
            return
        try:
            body = json.dumps(store.catalog()).encode()
        except Exception as e:
            self.send_error(503, f"store catalog unavailable: {e}")
            return
        self._send_bytes(body, "application/json")

    def _serve_from_store(
        self, transport: "HTTPTransport", step: int, what: str
    ) -> bool:
        """Serve a ``frag_*`` resource for a version that is NOT
        RAM-staged from the attached durable store.  Returns True when a
        response (200 or permanent 404) was written; False falls through
        to the retryable 503 (the version may simply be staging late).

        Called under the staged read lock — disk reads are local and
        bounded, and the lock is writer-priority so stagers stay live.
        """
        from torchft_tpu_torch.checkpointing import fragments as frags

        store = transport._store
        if store is None or not what.startswith("frag_"):
            return False
        name = what[len("frag_"):]
        t0_ns = time.time_ns()
        if name == frags.MANIFEST_FRAG:
            body = store.manifest_bytes(step)
            if body is None:
                return False
        elif name == frags.HEADER_FRAG:
            manifest = store.manifest(step)
            if manifest is None:
                return False
            body = ser.serialize(
                {k: v for k, v in manifest.items() if k != "digests"}
            )
        else:
            if store.manifest(step) is None:
                return False
            frag = store.fragment(step, name)
            if frag is None:
                # Version known but this blob is torn/missing: permanent
                # 404 so the striped restorer fails over to another disk
                # immediately instead of polling a hole.
                self.send_error(404, "fragment missing or torn on disk")
                return True
            body = frag
        self._send_bytes(body, "application/octet-stream")
        _metrics.CHECKPOINT_BYTES.labels(
            transport="http", direction="send"
        ).inc(len(body))
        _flightrec.record(
            "checkpoint.http.send", start_ns=t0_ns, step=step,
            bytes=len(body), resource=what, source="store",
        )
        return True

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        # request received: the idle-reap timeout must not bound the
        # serve itself (see class docstring; re-armed per request above)
        self.connection.settimeout(None)
        transport = self.server.transport  # type: ignore[attr-defined]
        parts = self.path.strip("/").split("/")
        # /nativeport — native fragment data-plane discovery: 200 + port
        # when this node mirrors frag_* payloads into the C++ server,
        # 404 = python-only node.  Clients cache either definitive
        # answer (checkpointing/fragdata.py _resolve_port).
        if parts == ["nativeport"]:
            native = transport._frag_native
            if native is None:
                self.send_error(404, "no native data plane")
            else:
                self._send_bytes(str(native.port).encode(), "text/plain")
            return
        # /store/versions — the durable store's restore catalog (plain
        # JSON, not a framed RPC: the wire-schema lock is untouched).
        if parts == ["store", "versions"]:
            self._serve_store_catalog(transport)
            return
        # /checkpoint/{step}/{what}
        if len(parts) != 3 or parts[0] != "checkpoint":
            self.send_error(404, "unknown path")
            return
        try:
            step = int(parts[1])
        except ValueError:
            self.send_error(400, "bad step")
            return
        what = parts[2]
        if what.startswith("frag_"):
            # Cut-through long-poll: when the step is STREAMING in and
            # this fragment hasn't landed yet, block briefly server-side
            # until the relay stages it — a child's fragment request
            # then costs one round trip, not a client poll loop whose
            # backoff would add dead time between fragment arrivals.
            # Returns immediately for complete/absent steps (those take
            # the plain 404/503 paths below).  Its read-lock timeout
            # maps to the same retryable busy-503 every other lock
            # timeout in this request takes, never an unhandled raise.
            # Client-driven park window (X-TFT-Poll-Ms): a cut-through
            # chain's child would rather wait here — woken the moment
            # the fragment stages — than eat a 503 + retry-ladder cycle
            # that duplicates request load exactly when the parent is
            # busiest.  Absent/garbage header keeps the 250 ms default.
            try:
                poll_ms = float(
                    self.headers.get("X-TFT-Poll-Ms") or 250.0
                )
            except (TypeError, ValueError):
                poll_ms = 250.0
            max_wait = min(max(poll_ms, 0.0), 5000.0) / 1e3
            try:
                transport.await_streamed_part(
                    step, f"frag:{what[len('frag_'):]}", max_wait=max_wait
                )
            except TimeoutError:
                self.send_error(503, "checkpoint busy")
                return
        try:
            # Hold the read lock for the whole serve so the snapshot can't be
            # retired mid-stream (reference http_transport.py:77-131).
            with transport._staged_lock.r_lock(timeout=transport._lock_timeout):
                staged = transport._staged.get(step)
                if staged is None:
                    # Not in RAM: a cold-start restorer may still be able
                    # to serve this version from the attached durable
                    # fragment store (blobs digest-verified at read; a
                    # torn blob 404s so the striped fetch fails over).
                    if self._serve_from_store(transport, step, what):
                        return
                    # Healer raced the sender's staging: retryable 503 (the
                    # receiver polls until its deadline). Permanent problems
                    # (bad path, chunk out of range) stay 404 and fail fast.
                    self._retry_later(
                        f"no checkpoint staged for step {step}"
                    )
                    return
                state_dict, num_chunks = staged.sd, staged.num_chunks
                raw: "Optional[memoryview]" = None
                if not staged.complete and not what.startswith("frag_"):
                    # A streaming (cut-through) slot serves ONLY its
                    # staged fragments: a whole-document read of a torn
                    # version must never complete — poll until finished.
                    self._retry_later(
                        f"step {step} is still streaming in"
                    )
                    return
                if what == "full":
                    indices = None
                elif what == "metadata":
                    indices = []
                elif what.startswith("chunk_"):
                    idx = int(what[len("chunk_"):])
                    chunks = ser.split_chunks(ser.num_leaves(state_dict), num_chunks)
                    if idx >= len(chunks):
                        self.send_error(404, "chunk out of range")
                        return
                    indices = chunks[idx]
                elif what.startswith("frag_"):
                    # Version-keyed fragment serving (serving/ tier): the
                    # staged doc maps "frag:<name>" to one fragment.  A
                    # fragment staged as raw wire bytes (publisher encode
                    # or relay cut-through passthrough) is served
                    # VERBATIM — no serialize pass, Content-Length is the
                    # buffer length; a decoded sub-dict takes the pytree
                    # path.  A missing name on a COMPLETE document is a
                    # permanent 404 (the staged manifest names every
                    # fragment); on a streaming document it is the
                    # retryable not-yet-relayed 503 — that poll IS the
                    # cut-through overlap.
                    frag = state_dict.get(f"frag:{what[len('frag_'):]}")
                    if frag is None:
                        if not staged.complete:
                            self._retry_later(
                                f"fragment {what} of step {step} not "
                                f"relayed yet"
                            )
                        else:
                            self.send_error(404, "unknown fragment")
                        return
                    raw = ser.raw_view(frag)
                    state_dict = frag
                    indices = None
                elif what.startswith("part_"):
                    # Reshard slice-diff serving (parallel/layout.py): the
                    # staged doc maps "for:<rank>" to the slices planned
                    # for that destination; serve exactly that sub-dict so
                    # the wire carries only the destination's missing
                    # intervals.  An empty sub-dict (nothing routed through
                    # this source) is a valid, tiny payload — NOT a 404 —
                    # so a racing fetcher can distinguish "staged, nothing
                    # for you" from "not staged yet" (503 above).
                    try:
                        part = int(what[len("part_"):])
                    except ValueError:
                        self.send_error(400, "bad part rank")
                        return
                    state_dict = state_dict.get(f"for:{part}", {})
                    indices = None
                else:
                    self.send_error(404, "unknown resource")
                    return
                # Stream straight to the socket: no materialized copy per
                # fetcher (multi-GB state dicts, N concurrent healers).
                # Raw passthrough fragments skip the serialize pass
                # entirely — the relay's verified bytes go out verbatim.
                if raw is not None:
                    total = len(raw)

                    def writer(out: Any, _raw: memoryview = raw) -> None:
                        out.write(_raw)

                else:
                    total, writer = ser.prepare(
                        state_dict, chunk_indices=indices
                    )
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(total))
                self.end_headers()
                t0 = time.perf_counter()
                t0_ns = time.time_ns()
                writer(self.wfile)
                _metrics.CHECKPOINT_BYTES.labels(
                    transport="http", direction="send"
                ).inc(total)
                _metrics.CHECKPOINT_DURATION.labels(
                    transport="http", direction="send"
                ).observe(time.perf_counter() - t0)
                _flightrec.record(
                    "checkpoint.http.send", start_ns=t0_ns, step=step,
                    bytes=total, resource=what,
                )
                # Distributed tracing: the healing destination sends its
                # round context as a ``traceparent`` header; the source's
                # serve lands as a heal.send span IN THE DESTINATION'S
                # TRACE — source and destination of one heal share a
                # trace (docs/observability.md "Distributed tracing").
                tracer = _tracing.get_tracer()
                if tracer is not None:
                    ctx = _tracing.TraceContext.from_traceparent(
                        self.headers.get("traceparent")
                    )
                    if ctx is not None and ctx.sampled:
                        tracer.export_span(
                            name="heal.send",
                            trace_id=ctx.trace_id,
                            parent_span_id=ctx.span_id,
                            start_ns=t0_ns,
                            end_ns=time.time_ns(),
                            attributes={
                                "transport": "http",
                                "step": step,
                                "bytes": total,
                                "resource": what,
                            },
                        )
        except TimeoutError:
            self.send_error(503, "checkpoint busy")
        except BrokenPipeError:
            pass


class HTTPTransport(CheckpointTransport[Any]):
    """Pull-based checkpoint transport over HTTP.

    Args:
        timeout: default lock/serve timeout.
        num_chunks: if > 0, receivers parallel-fetch this many round-robin
            leaf chunks; 0 fetches one full stream.
        state_dict_fn: optional callable returning a same-structure state
            dict whose numpy buffers are received into — the in-place
            warm-page fast path (PGTransport parity; cold allocations
            page-fault during recv and halve effective bandwidth).
    """

    #: This transport can serve the live-reshard slice-diff protocol
    #: (multi-slot staging + ``part_<rank>`` resources + ``resource=``
    #: fetches); parallel/layout.py gates data-moving switches on it.
    supports_reshard = True

    #: This transport can stage/receive the striped fragment heal
    #: protocol (``send_checkpoint_streamed`` +
    #: ``recv_checkpoint_striped``); the Manager gates the streamed heal
    #: path on this being literally ``True`` so duck-typed test doubles
    #: keep the legacy whole-document path.
    supports_striped_heal = True

    def __init__(
        self,
        timeout: float = 60.0,
        num_chunks: int = 0,
        state_dict_fn: "Optional[Callable[[], Any]]" = None,
        max_staged: int = _MAX_STAGED,
        native: "Optional[bool]" = None,
    ) -> None:
        self._lock_timeout = timeout
        self._num_chunks = num_chunks
        self._state_dict_fn = state_dict_fn
        # Staged-slot budget: heal/reshard transports keep the default;
        # the weight-serving tier sizes it to its version window so a
        # burst of publishes cannot retire a version clients still fetch.
        self._max_staged = max(int(max_staged), 1)
        # Staged snapshots keyed by step.  Heal staging uses the real
        # (>= 0) step and is retired per step by disallow_checkpoint();
        # live-reshard staging (parallel/layout.py) uses NEGATIVE keys
        # derived from the layout epoch so it survives the per-step heal
        # retirement until the switch commits or rolls back.  Bounded:
        # oldest slots are evicted past _MAX_STAGED.
        self._staged: "dict[int, _Staged]" = {}
        # writer_priority: staging/retirement must acquire in bounded
        # time even under a dense fetch storm (the serving tier's
        # 503-polling clients keep the read side continuously occupied —
        # a reader-preferring lock starves the stager forever).
        self._staged_lock = RWLock(timeout=timeout, writer_priority=True)
        # wakes fragment long-pollers (await_streamed_part) whenever the
        # staged set changes — never held together with _staged_lock
        self._stream_cond = threading.Condition()
        self._server = _make_server()
        self._server.transport = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            # small poll interval: shutdown() blocks until the serve loop
            # polls, and transport teardown sits on the recovery-latency
            # critical path (default 0.5s poll = up to 0.5s per shutdown)
            target=lambda: self._server.serve_forever(poll_interval=0.05),
            name="torchft_http",
            daemon=True,
        )
        self._thread.start()
        host = socket.gethostname()
        self._address = f"http://{host}:{self._server.server_address[1]}"
        # Native zero-copy fragment DATA plane: raw ``frag:*`` staging is
        # mirrored into a C++ sidecar server (native/fragserver.cc) that
        # serves payload bytes via writev out of pooled buffers, GIL-free.
        # Python keeps every control decision — plans, manifests, staging
        # lifecycle, telemetry — and advertises the data port at
        # ``/nativeport``.  ``native=None`` follows the
        # TORCHFT_FRAG_NATIVE gate; any create failure degrades this node
        # to python-only serving (the mirror is an accelerator, never a
        # correctness dependency).
        # Durable fragment store (checkpointing/store.py): when attached,
        # versions absent from RAM serve their fragments from disk —
        # cold-start restore rides the exact same frag_* resources and
        # striped fetch path as live heal.
        self._store: "Optional[Any]" = None
        self._frag_native: "Optional[_fragdata.FragDataServer]" = None
        if _fragdata.enabled() if native is None else bool(native):
            try:
                self._frag_native = _fragdata.FragDataServer()
            except Exception:
                logger.warning(
                    "native fragment data plane unavailable; "
                    "serving fragments from Python",
                    exc_info=True,
                )

    def metadata(self) -> str:
        return self._address

    def attach_store(self, store: Any) -> None:
        """Expose a durable :class:`~torchft_tpu_torch.checkpointing.store.
        FragmentStore` through this server: peers' cold-start restores
        fetch ``frag_*`` resources of spilled versions (and the
        ``/store/versions`` catalog) exactly like a live heal."""
        self._store = store

    def send_checkpoint(
        self, dst_ranks: "List[int]", step: int, state_dict: Any, timeout: float
    ) -> None:
        _faults.check("transport.send", step=step)
        # Pull transport: stage a host snapshot; receivers fetch within their
        # own timeout.  The snapshot is a copy: the optimizer updates the
        # live tensors in place once the step commits, and a view of a CPU
        # tensor would then serve the next step's values.
        t0_ns = time.time_ns()
        host_sd = tree_map(ser.host_copy, state_dict)
        with self._staged_lock.w_lock(timeout=timeout):
            self._put_locked(step, _Staged(host_sd, max(self._num_chunks, 1)))
        self._native_mirror_complete(step, host_sd)
        self._wake_stream_waiters()
        _flightrec.record(
            "checkpoint.http.stage", start_ns=t0_ns, step=step,
            dst_ranks=list(dst_ranks),
        )

    def _put_locked(self, step: int, staged: _Staged) -> None:
        old = self._staged.pop(step, None)
        if old is not None:
            old.release()
            self._native_retire(step)
        self._staged[step] = staged
        while len(self._staged) > self._max_staged:
            evicted = next(iter(self._staged))
            self._staged.pop(evicted).release()
            self._native_retire(evicted)

    # -- native data-plane mirror -------------------------------------
    #
    # Every mirror call is best-effort: the native server accelerates
    # raw frag_* serves, but the Python slot remains the source of truth
    # — on any mirror failure peers transparently fall back to the
    # Python data path (fragments._raw_data_plane), so these helpers
    # swallow rather than surface errors.  ``retire`` is non-blocking
    # native-side (in-flight serves recycle their buffer on last deref),
    # so calling it under the staged write lock is safe.

    def _native_retire(self, step: int) -> None:
        if self._frag_native is not None:
            try:
                self._frag_native.retire(step)
            except Exception:
                logger.debug("native frag retire failed", exc_info=True)

    def _native_begin(self, step: int) -> None:
        if self._frag_native is not None:
            try:
                self._frag_native.begin(step)
            except Exception:
                logger.debug("native frag begin failed", exc_info=True)

    def _native_stage(self, step: int, key: Any, value: Any) -> None:
        srv = self._frag_native
        if (
            srv is None
            or not isinstance(key, str)
            or not key.startswith("frag:")
        ):
            return
        raw = ser.raw_view(value)
        if raw is None:
            return  # control parts (header/manifest dicts) stay Python
        try:
            srv.stage(step, "frag_" + key[len("frag:"):], raw)
        except Exception:
            logger.debug("native frag stage failed", exc_info=True)

    def _native_finish(self, step: int) -> None:
        if self._frag_native is not None:
            try:
                self._frag_native.finish(step)
            except Exception:
                logger.debug("native frag finish failed", exc_info=True)

    def _native_mirror_complete(self, step: int, sd: Any) -> None:
        """Mirror the raw ``frag:*`` parts of a COMPLETE document in one
        begin/stage*/finish stroke (the ``send_checkpoint`` path — e.g. a
        pre-serialized fragment document staged whole)."""
        if self._frag_native is None or not isinstance(sd, dict):
            return
        raws = [
            (k, ser.raw_view(v))
            for k, v in sd.items()
            if isinstance(k, str) and k.startswith("frag:")
        ]
        raws = [(k, r) for k, r in raws if r is not None]
        if not raws:
            return
        self._native_begin(step)
        for k, raw in raws:
            self._native_stage(step, k, raw)
        self._native_finish(step)

    # -- per-fragment (cut-through) staging ---------------------------------
    #
    # The serving tier's streaming relay (serving/replica.py)
    # stages one version FRAGMENT BY FRAGMENT: children and clients poll
    # ``frag_<name>`` and get each fragment the moment it lands (503
    # while missing), while whole-document reads 503 until the version
    # is finished — cut-through can never serve a torn version.

    def _wake_stream_waiters(self) -> None:
        with self._stream_cond:
            self._stream_cond.notify_all()

    def await_streamed_part(
        self, step: int, key: str, max_wait: float
    ) -> None:
        """Server-side fragment long-poll: block up to ``max_wait``
        while the slot for ``step`` is STREAMING and ``key`` has not
        landed.  Returns immediately for absent/complete slots and when
        the part arrives — the caller re-reads state under the lock and
        takes the normal serve/503/404 path."""
        deadline = time.monotonic() + max_wait
        while True:
            with self._staged_lock.r_lock(timeout=self._lock_timeout):
                staged = self._staged.get(step)
                if staged is None or staged.complete or key in staged.sd:
                    return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            with self._stream_cond:
                self._stream_cond.wait(min(remaining, 0.05))

    def begin_streamed_checkpoint(
        self,
        step: int,
        state_dict: Any,
        timeout: "Optional[float]" = None,
        grace: int = 1,
    ) -> None:
        """Stage an INCOMPLETE document (normally just the manifest);
        fragments arrive via :meth:`stage_streamed_part`.  ``grace``:
        ``disallow_checkpoint`` rounds the finished slot survives (see
        ``_Staged`` — streamed slots hold immutable bytes, so one round
        of grace keeps a striped healer's window open across the
        sources' commit)."""
        with self._staged_lock.w_lock(timeout=timeout or self._lock_timeout):
            self._put_locked(
                step, _Staged(dict(state_dict), 1, complete=False, grace=grace)
            )
        self._native_begin(step)
        for k, v in dict(state_dict).items():
            self._native_stage(step, k, v)
        self._wake_stream_waiters()

    def stage_streamed_part(
        self,
        step: int,
        key: str,
        value: Any,
        pooled: bool = False,
        timeout: "Optional[float]" = None,
    ) -> None:
        """Add one part (``frag:<name>`` -> raw wire bytes) to a
        streaming slot.  ``pooled=True`` transfers ownership of a
        bufpool-backed buffer to the slot (returned to the pool on
        retirement).  Raises ``KeyError`` when the slot was evicted
        mid-stream (version window overrun by newer publishes)."""
        with self._staged_lock.w_lock(timeout=timeout or self._lock_timeout):
            staged = self._staged.get(step)
            if staged is None:
                raise KeyError(
                    f"streamed staging slot for step {step} was evicted"
                )
            staged.sd[key] = value
            if pooled:
                staged.pooled.append(value)
        self._native_stage(step, key, value)
        self._wake_stream_waiters()

    def finish_streamed_checkpoint(
        self, step: int, timeout: "Optional[float]" = None
    ) -> None:
        """Mark a streaming slot complete: whole-document reads serve."""
        with self._staged_lock.w_lock(timeout=timeout or self._lock_timeout):
            staged = self._staged.get(step)
            if staged is None:
                raise KeyError(
                    f"streamed staging slot for step {step} was evicted"
                )
            staged.complete = True
        self._native_finish(step)
        self._wake_stream_waiters()

    def streamed_parts(self, step: int) -> "Optional[set]":
        """Part keys of a still-streaming slot (``None`` when absent or
        already complete) — lets an interrupted relay pull RESUME from
        the fragments it already verified instead of refetching."""
        with self._staged_lock.r_lock(timeout=self._lock_timeout):
            staged = self._staged.get(step)
            if staged is None or staged.complete:
                return None
            return set(staged.sd)

    def copy_staged_part(
        self, step: int, key: str, timeout: "Optional[float]" = None
    ) -> "Optional[Any]":
        """Pooled copy of one raw part of a COMPLETE staged document
        (``None`` when absent or not raw wire bytes) — the delta relay
        pull reuses unchanged fragments from version v-1 without wire.
        A copy, not a shared reference: the source slot may retire (and
        return ITS buffer to the pool) while the new slot still serves.
        """
        from torchft_tpu_torch.utils.bufpool import POOL

        with self._staged_lock.r_lock(timeout=timeout or self._lock_timeout):
            staged = self._staged.get(step)
            if staged is None or not staged.complete:
                return None
            raw = ser.raw_view(staged.sd.get(key))
            if raw is None:
                return None
            buf = POOL.take(len(raw), np.uint8)
            buf[:] = np.frombuffer(raw, dtype=np.uint8)
            return buf

    def send_checkpoint_streamed(
        self,
        dst_ranks: "List[int]",
        step: int,
        state_dict: Any,
        timeout: float,
        fragments: "Optional[int]" = None,
    ) -> "dict":
        """Stage a heal snapshot as a CUT-THROUGH fragment stream
        (docs/architecture.md "Striped heal"): the digest-less header
        serves immediately, each fragment serves the moment it encodes
        (a healer's striped fetch overlaps this host's snapshot/encode),
        and the digest manifest lands last.  Returns the manifest.

        The step protocol calls this instead of :meth:`send_checkpoint`
        when streamed heal is enabled (``TORCHFT_HEAL_STREAM``); the
        staged document serves the same ``frag_*`` resources the serving
        tier uses, so the whole fragment fetch plane applies."""
        from torchft_tpu_torch.checkpointing import fragments as frags

        _faults.check("transport.send", step=step)
        t0_ns = time.time_ns()
        manifest = frags.stage_heal_checkpoint(
            self, step, state_dict, fragments=fragments, timeout=timeout
        )
        _flightrec.record(
            "checkpoint.http.stage", start_ns=t0_ns, step=step,
            dst_ranks=list(dst_ranks),
            fragments=len(manifest.get("fragments", ())),
        )
        return manifest

    def recv_checkpoint_striped(
        self,
        sources: "List[str]",
        step: int,
        timeout: float,
        local_state_fn: "Optional[Callable[[], Any]]" = None,
        delta: "Optional[bool]" = None,
        plane: str = "heal",
    ) -> "tuple[Any, dict]":
        """Striped multi-source heal receive.

        ``plane`` names the provenance plane these transfers audit
        under: ``heal`` for live heals, ``restore`` when the sources
        are durable-store disks (the cold-start path).

        ``sources`` are transport base addresses in trust order —
        ``sources[0]`` is the quorum-assigned PRIMARY whose manifest
        defines truth; the rest are max-step peers whose bitwise-
        replicated state lets the healer stripe disjoint fragment
        ranges across every uplink at once.  Per-fragment failover: a
        dead/slow/poisoned stripe source's fragments move to the
        survivors (ultimately the primary).

        Two modes:

        - **delta** (``TORCHFT_HEAL_DELTA``, on, and a local state
          snapshot is available): fetch the primary's digest manifest,
          hash the local state into the same fragment layout, and fetch
          ONLY the fragments whose digest moved — rejoin wire scales
          with the update delta, not model size.  Every fetched
          fragment verifies against the primary digest on receipt.
        - **full**: fetch the digest-less header first (served before
          the source has encoded anything), stripe ALL fragments while
          the source is still encoding, then verify the recorded
          hashes against the primary's manifest (staged last) and
          refetch any mismatch from the primary alone.

        Decode of fragment *i* (straight into the retained ``into=``
        leaf buffers) overlaps the wire of every in-flight stripe.

        Returns ``(state_dict, info)`` where ``info`` carries the phase
        split (``heal_manifest``/``heal_diff``/``heal_wire``/
        ``heal_decode``), mode, fragment counts and wire bytes.  Falls
        back to the legacy single-source whole-document fetch when the
        primary's staged document has no fragments (mixed-config
        fleet)."""
        import urllib.error as _uerr

        from torchft_tpu_torch.checkpointing import fragments as frags
        from torchft_tpu_torch.ops.codec_pool import merged_seconds
        from torchft_tpu_torch.utils.bufpool import POOL
        from torchft_tpu_torch.utils.env import env_bool, env_float

        _faults.check("transport.recv", step=step)
        if not sources:
            raise ValueError("striped heal: no sources")
        primary = sources[0]
        deadline = time.monotonic() + timeout
        phases: "dict[str, float]" = {}
        info: "dict[str, Any]" = {"sources": len(sources)}
        with _flightrec.track(
            "checkpoint.http.recv", step=step, src_rank=0,
            sources=len(sources),
        ) as op:
            local_state, into = self._build_into_map(local_state_fn)
            use_delta = (
                delta
                if delta is not None
                else env_bool("TORCHFT_HEAL_DELTA", True)
            ) and local_state is not None

            # -- manifest phase: the primary defines truth.  Delta needs
            # the digests (staged last — waits out the source's encode);
            # full mode starts from the digest-less header (staged
            # first) so the stripe overlaps the source's encode.
            t0 = time.perf_counter()
            want = frags.MANIFEST_FRAG if use_delta else frags.HEADER_FRAG
            try:
                mbuf = frags.fetch_raw(
                    primary, step, f"frag_{want}",
                    timeout=max(deadline - time.monotonic(), 0.001),
                    role="heal", native=plane != "restore",
                )
            except _uerr.HTTPError as e:
                if e.code != 404:
                    raise
                # Source staged a legacy whole-document snapshot (mixed
                # config): take the classic path against the primary.
                result = self._recv_checkpoint(
                    0, primary, step,
                    max(deadline - time.monotonic(), 0.001),
                )
                op.update(mode="legacy")
                info.update(mode="legacy", phases=phases)
                return frags.maybe_decode_heal_doc(result), info
            try:
                manifest = frags.decode_manifest(mbuf)
            finally:
                POOL.give(mbuf)
            phases["heal_manifest"] = time.perf_counter() - t0

            names = [str(n) for n in manifest["fragments"]]
            num_leaves = int(manifest["num_leaves"])

            # TORCHFT_PLAN_VERIFY: the stripe assignment is a plan —
            # validate its coverage (disjoint, exhaustive round-robin
            # leaf ranges across the resolved sources) before any
            # fragment goes on the wire.
            from torchft_tpu_torch.analysis import plan_verify as _pv

            if _pv.enabled():
                from torchft_tpu_torch.analysis import plan_ir as _pir

                _pv.check_live(
                    _pir.stripe_ir(sources, len(names), num_leaves,
                                   step=step)
                )

            # -- diff phase: hash the local state into the source's
            # fragment layout; identical digests need no wire at all.
            t0 = time.perf_counter()
            changed = list(names)
            leaves: "dict[int, Any]" = {}
            if use_delta:
                local_leaves = tree_flatten(local_state)[0]
                if len(local_leaves) == num_leaves:
                    _n, mine = frags.local_fragment_digests(
                        local_state, len(names)
                    )
                    src_digests = manifest.get("digests") or {}
                    changed = [
                        n for n in names
                        if src_digests.get(n) != mine.get(n)
                    ]
                    for name in names:
                        if name not in changed:
                            for slot in frags.fragment_slots(
                                name, num_leaves, len(names)
                            ):
                                leaves[slot] = local_leaves[slot]
            phases["heal_diff"] = time.perf_counter() - t0
            mode = "delta" if use_delta else "full"

            # -- wire + decode: striped fetch across every source,
            # decode of fragment i overlapping the wire of the rest.
            decode_busy = [0.0]
            decode_failed: "List[str]" = []

            def _decode(name: str, buf: Any, _sha: str) -> None:
                t_d = time.perf_counter()
                try:
                    sub_into = (
                        frags.fragment_into_map(
                            name, num_leaves, len(names), into
                        )
                        if into
                        else None
                    )
                    decoded = frags.decode_fragment(buf, into=sub_into)
                    # Trust boundary: the slot keys come from the (in
                    # full mode, not-yet-verified) fragment bytes — a
                    # corrupt fragment claiming FOREIGN slots could
                    # otherwise overwrite other fragments' leaves with
                    # garbage the per-fragment repair pass would never
                    # restore.  Anything but exactly this fragment's
                    # round-robin slot set is a decode failure.
                    expected = set(
                        frags.fragment_slots(name, num_leaves, len(names))
                    )
                    if set(decoded) != expected:
                        raise ValueError(
                            f"fragment {name}: slots {sorted(decoded)[:4]}"
                            f"... do not match its layout"
                        )
                    leaves.update(decoded)
                except Exception:  # noqa: BLE001 - repaired below
                    # Garbage that happened to land before verification
                    # (full mode verifies AFTER the stripe): remember
                    # the fragment for the digest-verified repair pass.
                    decode_failed.append(name)
                finally:
                    POOL.give(buf)
                decode_busy[0] += time.perf_counter() - t_d

            t0 = time.perf_counter()
            failover_s = env_float(
                "TORCHFT_HEAL_FAILOVER_S", 2.0, minimum=0.05
            )
            stats = frags.striped_fetch(
                sources, step, changed, deadline,
                digests=manifest.get("digests") if use_delta else None,
                source_budget=failover_s,
                on_buf=_decode,
                plane=plane,
            )
            wire_bytes = stats["wire_bytes"]
            failovers = stats["failovers"]
            sources_used = set(stats["sources_used"])

            if not use_delta and changed:
                # Deferred verify: the digest manifest (staged last —
                # the source has finished encoding by the time the
                # stripe drains) checks every recorded hash.
                mfull = frags.fetch_raw(
                    primary, step, f"frag_{frags.MANIFEST_FRAG}",
                    timeout=max(deadline - time.monotonic(), 0.001),
                    role="heal", native=plane != "restore",
                )
                try:
                    manifest = frags.decode_manifest(mfull)
                finally:
                    POOL.give(mfull)
            digests = manifest.get("digests") or {}
            bad = sorted(
                set(decode_failed)
                | {
                    n for n in changed
                    if n in stats["hashes"]
                    and digests.get(n, stats["hashes"][n])
                    != stats["hashes"][n]
                }
            )
            if bad:
                # Repair pass: mismatched/undecodable fragments refetch
                # from the PRIMARY alone, digest-verified on receipt; a
                # decode failure here is terminal (the primary's own
                # bytes are truth — there is nothing left to fail over
                # to).
                _metrics.HEAL_FRAG_FAILOVERS.inc(len(bad))
                failovers += len(bad)
                decode_failed.clear()
                restats = frags.striped_fetch(
                    [primary], step, bad, deadline,
                    digests=digests, on_buf=_decode,
                    plane=plane,
                )
                wire_bytes += restats["wire_bytes"]
                sources_used |= set(restats["sources_used"])
                if decode_failed:
                    raise ValueError(
                        f"striped heal: fragments {decode_failed} from "
                        f"the primary verified but failed to decode"
                    )
            loop_wall = time.perf_counter() - t0
            wire_busy = merged_seconds(stats["spans"])
            phases["heal_decode"] = decode_busy[0]
            phases["heal_wire"] = max(
                wire_busy, loop_wall - decode_busy[0], 0.0
            )

            _metrics.HEAL_WIRE_BYTES.labels(mode=mode).inc(wire_bytes)
            # the gauge reports sources that DELIVERED fragments, not
            # the configured list — a degraded stripe (dead peers, all
            # bytes from the primary) must read as 1, not len(sources);
            # a delta heal that fetched nothing still talked to the
            # primary for the manifest, hence the floor of 1
            _metrics.HEAL_STRIPE_SOURCES.set(max(len(sources_used), 1))
            _metrics.HEAL_CHANGED_FRAGMENTS.set(len(changed))
            _metrics.CHECKPOINT_DURATION.labels(
                transport="http", direction="recv"
            ).observe(sum(phases.values()))
            state = frags.assemble(manifest, leaves)
            # provenance: the heal destination now holds every fragment
            # of this version (fetched AND delta-reused — reuse means
            # the local bytes already hash to the source digest)
            from torchft_tpu_torch.checkpointing import provenance as _prov

            h_ms = int(manifest.get("created_ns", 0) // 1_000_000)
            for name in names:
                _prov.note_hold(
                    _prov.frag_id("heal", name), step,
                    digests.get(name, ""), version_ms=h_ms, role="heal",
                )
            info.update(
                mode=mode,
                fragments=len(names),
                changed=len(changed),
                wire_bytes=wire_bytes,
                failovers=failovers,
                sources_used=len(sources_used),
                phases=phases,
            )
            op.update(
                mode=mode, fragments=len(names), changed=len(changed),
                bytes=wire_bytes, failovers=failovers,
            )
        return state, info

    def recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        resource: "Optional[str]" = None,
    ) -> Any:
        """Fetch a staged snapshot from ``metadata``'s server.  With
        ``resource`` (e.g. ``part_<rank>``, the reshard slice-diff
        payload) that single resource is fetched instead of the
        full/chunked stream."""
        _faults.check("transport.recv", step=step)
        # in-flight op for the whole heal fetch: a healer wedged mid-fetch
        # shows up in the flight dump with src/step context
        with _flightrec.track(
            "checkpoint.http.recv", step=step, src_rank=src_rank,
        ):
            return self._recv_checkpoint(
                src_rank, metadata, step, timeout, resource
            )

    def _build_into_map(
        self, state_fn: "Optional[Callable[[], Any]]" = None
    ) -> "tuple[Optional[Any], Optional[dict]]":
        """Snapshot the local state and build the ``{global leaf slot:
        ndarray}`` in-place receive map for ``serialization.deserialize_from``
        (the warm-buffer fast path — cold allocations page-fault during
        the socket reads and roughly halve effective recv bandwidth).

        Only the user-supplied state callable may fail (it is arbitrary
        training code); that fallback is LOUD — logged and counted in
        ``torchft_heal_into_fallbacks_total`` — because silently decoding
        into fresh arrays every heal is a decode-path perf regression,
        not a benign default.  Returns ``(state, into)``, both ``None``
        when no state callable is available."""
        fn = state_fn if state_fn is not None else self._state_dict_fn
        if fn is None:
            return None, None
        try:
            state = fn()
        except Exception as e:  # noqa: BLE001 - user state fn, but LOUD
            logger.warning(
                "heal recv: state_dict_fn failed (%s: %s); decoding into "
                "freshly allocated arrays this heal",
                type(e).__name__, e,
            )
            _metrics.HEAL_INTO_FALLBACKS.inc()
            return None, None
        existing = tree_flatten(state)[0]
        into = {
            i: leaf
            for i, leaf in enumerate(existing)
            if isinstance(leaf, (np.ndarray, torch.Tensor))
        }
        return state, into

    def _recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        resource: "Optional[str]" = None,
    ) -> Any:
        base = f"{metadata}/checkpoint/{step}"
        deadline = time.monotonic() + timeout
        t_recv = time.perf_counter()

        _state, into = self._build_into_map()

        # Trace propagation: the destination's round context rides a
        # ``traceparent`` header so the SOURCE's serve spans join this
        # replica's per-step trace (None when tracing is off/unsampled).
        traceparent = _tracing.current_traceparent()

        def fetch(path: str):
            # Retry/backoff policy: _FETCH_POLICY (module top) — retryable
            # 503s and connection errors poll until the receiver's deadline.
            def attempt(budget: "Optional[float]"):
                t = max(budget if budget is not None else 0.001, 0.001)
                req = urllib.request.Request(
                    f"{base}/{path}",
                    headers=(
                        {"traceparent": traceparent} if traceparent else {}
                    ),
                )
                with urllib.request.urlopen(req, timeout=t) as resp:
                    _metrics.CHECKPOINT_BYTES.labels(
                        transport="http", direction="recv"
                    ).inc(int(resp.headers.get("Content-Length") or 0))
                    return ser.deserialize_from(resp, into=into)

            return _FETCH_POLICY.run(
                attempt,
                timeout=max(deadline - time.monotonic(), 0.001),
                op="transport.http.fetch",
                on_retry=lambda e, n, d: _metrics.CHECKPOINT_RETRIES.labels(
                    transport="http"
                ).inc(),
            )

        def _done() -> None:
            _metrics.CHECKPOINT_DURATION.labels(
                transport="http", direction="recv"
            ).observe(time.perf_counter() - t_recv)

        if resource is not None:
            skeleton, leaves, n = fetch(resource)
            _done()
            return ser.reassemble(skeleton, leaves, n)

        if self._num_chunks <= 0:
            skeleton, leaves, n = fetch("full")
            _done()
            return ser.reassemble(skeleton, leaves, n)

        # Parallel chunk fetch (reference http_transport.py:244-267).
        with ThreadPoolExecutor(max_workers=self._num_chunks) as pool:
            results = list(pool.map(fetch, [f"chunk_{i}" for i in range(self._num_chunks)]))
        _done()
        skeleton, _, n = results[0]
        merged: dict = {}
        for _, leaves, _ in results:
            merged.update(leaves)
        return ser.reassemble(skeleton, merged, n)

    def disallow_checkpoint(self) -> None:
        """Retire heal snapshots (real, >= 0 step keys) before the
        optimizer mutates parameters.  Reshard staging (negative keys)
        stays until its switch commits/rolls back — peers may still be
        mid-fetch when this group's step commits.  Streamed heal slots
        with remaining ``grace`` survive (they hold immutable serialized
        bytes, not aliases of the live state — see ``_Staged``); each
        call burns one grace round so nothing lingers unbounded."""
        retired: "List[int]" = []
        with self._staged_lock.w_lock(timeout=self._lock_timeout):
            for k in [k for k in self._staged if k >= 0]:
                staged = self._staged[k]
                if staged.grace > 0:
                    staged.grace -= 1
                    continue
                self._staged.pop(k).release()
                retired.append(k)
        for k in retired:
            self._native_retire(k)
        self._wake_stream_waiters()

    def retire_checkpoint(self, step: int) -> None:
        """Drop one staged snapshot (the reshard slots' explicit
        retirement path); no-op when absent."""
        with self._staged_lock.w_lock(timeout=self._lock_timeout):
            staged = self._staged.pop(step, None)
            if staged is not None:
                staged.release()
        self._native_retire(step)
        self._wake_stream_waiters()

    def staged_steps(self) -> "List[int]":
        """Step/version keys currently staged (insertion order — the
        eviction order).  The serving tier uses this as "which versions
        do I still hold"; tests assert retention windows with it."""
        with self._staged_lock.r_lock(timeout=self._lock_timeout):
            return list(self._staged)

    def shutdown(self, wait: bool = True) -> None:
        if self._frag_native is not None:
            try:
                self._frag_native.shutdown()
            except Exception:
                pass
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5)
