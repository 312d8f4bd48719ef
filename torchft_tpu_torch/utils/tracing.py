"""Distributed tracing for the quorum/recovery hot path.

Third leg of the telemetry layer (logs: utils/otel.py, metrics:
utils/metrics.py), grown from the PR-1 single-process span tree into
**fleet-wide causal tracing**:

- **Per-step trace ids are deterministic** (:func:`step_trace_id` hashes
  ``(JOB_ID, step)``), so every replica group, the lighthouse, and both
  heal endpoints land in ONE trace per training step without any
  coordination RPC — the property the cross-replica critical-path ledger
  (``torchft-torch-diagnose --trace``) joins on.
- **Causal propagation** rides a W3C-traceparent-style context
  (:class:`TraceContext`: ``trace_id``, ``span_id``, sampled flag)
  carried as the ``traceparent`` envelope field of every framed-JSON RPC
  (``coordination._RpcClient`` injects, the native servers continue it —
  see docs/protocol.md "Wire surface"), as an HTTP header on the
  checkpoint heal path, and as a metadata field on PGTransport streams.
- **Native server spans** (``rpc.<method>`` around each handler) are
  relayed back to this module's exporter through a ctypes span-sink
  callback (``_native.SPAN_SINK_CFUNC`` → ``tft_set_span_sink``), the
  same provider-callback idiom as the lighthouse /metrics supplement.
- **Sinks**: the OTLP/HTTP ``/v1/traces`` exporter (``TORCHFT_USE_OTEL``)
  and/or a crash-durable JSONL file (``TORCHFT_TRACE_FILE``) so tier-1
  tests and air-gapped post-mortems need no collector.  O_APPEND writes
  keep multi-process runs safe on one file.
- **Sampling**: ``TORCHFT_TRACE_SAMPLE`` (fraction of steps, default 1)
  decides per *step* from the deterministic trace id, so all replicas
  sample the same steps and sampled traces stay complete.

The disabled path stays zero-cost: with no tracer installed every entry
point is a ``None`` check (budget-tested like the flight recorder's).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from torchft_tpu_torch.utils.otel import BatchedOTLPHTTPExporter, _kv_list

logger = logging.getLogger(__name__)


def new_trace_id() -> str:
    """128-bit trace id as 32 lowercase hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit span id as 16 lowercase hex chars."""
    return os.urandom(8).hex()


def step_trace_id(step: int, job_id: "Optional[str]" = None) -> str:
    """The deterministic per-step trace id every replica derives
    identically: sha256 over ``(JOB_ID, step)``.  One training step ==
    one trace across the whole fleet, with zero coordination."""
    if job_id is None:
        from torchft_tpu_torch.utils.env import env_str

        job_id = env_str("JOB_ID", "unknown")
    digest = hashlib.sha256(
        f"torchft-step:{job_id}:{int(step)}".encode()
    ).hexdigest()
    return digest[:32]


@dataclass(frozen=True)
class TraceContext:
    """One position in a trace: (trace_id, span_id) plus the sampled
    flag.  ``span_id`` is the id child spans parent to."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def child(self) -> "TraceContext":
        """A fresh context under this one (new span id, same trace)."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled)

    def to_traceparent(self) -> str:
        """W3C-style ``00-<trace_id>-<span_id>-<flags>`` encoding — the
        wire form carried in RPC envelopes and HTTP headers."""
        return (
            f"00-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    @staticmethod
    def from_traceparent(value: "Optional[str]") -> "Optional[TraceContext]":
        """Parse the wire form; None on anything malformed (a hostile or
        stale peer must never break the server).  Exactly as strict as
        the native parser (net.cc parse_traceparent): fixed field
        lengths, pure-hex fields — the two sides must agree on what is
        a valid context or a trace silently splits between them."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id, flags = parts
        if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
            return None
        hexdigits = "0123456789abcdefABCDEF"
        if not all(
            c in hexdigits for field in (trace_id, span_id, flags) for c in field
        ):
            return None
        return TraceContext(trace_id, span_id, sampled=flags != "00")


class OTLPHTTPSpanExporter(BatchedOTLPHTTPExporter):
    """Batched OTLP/HTTP (JSON encoding) span exporter: the shared
    ``BatchedOTLPHTTPExporter`` pipeline (daemon flush thread, atexit
    flush, dropped counter, a dead collector never kills training) with
    the ``/v1/traces`` encoding.  ``export`` takes the internal span dict
    produced by :meth:`Tracer.export_span`."""

    path_suffix = "/v1/traces"

    def __init__(self, endpoint: str, max_batch: int = 128, **kw: Any) -> None:
        super().__init__(endpoint, max_batch=max_batch, **kw)

    def _encode(self, batch: "List[Dict[str, Any]]") -> bytes:
        spans = []
        for s in batch:
            span: "Dict[str, Any]" = {
                "traceId": s["trace_id"],
                "spanId": s["span_id"],
                "name": s["name"],
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s["start_ns"]),
                "endTimeUnixNano": str(s["end_ns"]),
                "attributes": _kv_list(s.get("attributes", {})),
                "status": {"code": 1 if s.get("ok", True) else 2},
            }
            if s.get("parent_span_id"):
                span["parentSpanId"] = s["parent_span_id"]
            spans.append(span)
        doc = {
            "resourceSpans": [
                {
                    "resource": self._resource,
                    "scopeSpans": [
                        {"scope": {"name": "torchft_tpu"}, "spans": spans}
                    ],
                }
            ]
        }
        return json.dumps(doc, default=str).encode()


class FileSpanSink:
    """Crash-durable JSONL span sink (``TORCHFT_TRACE_FILE``): one JSON
    object per finished span, written with a single O_APPEND ``write``
    so concurrent processes sharing the file never interleave lines.
    This is the sink the tier-1 round-trip test and the diagnose ledger
    read — no collector required."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fd: "Optional[int]" = None
        self._closed = False

    def export(self, span: "Dict[str, Any]") -> None:
        line = (json.dumps(span, default=str) + "\n").encode()
        try:
            with self._lock:
                if self._closed:
                    # a racing emitter that grabbed the tracer before
                    # uninstall must not silently reopen the file and
                    # leak the fd — late spans are dropped instead
                    return
                if self._fd is None:
                    self._fd = os.open(
                        self.path,
                        os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                        0o644,
                    )
                os.write(self._fd, line)
        except OSError:
            logger.debug("trace file write failed", exc_info=True)

    def flush(self, timeout: "Optional[float]" = None) -> bool:
        return True  # every export is already a completed write()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


class Tracer:
    """Span factory over the configured sinks (OTLP exporter and/or the
    JSONL file sink).  One call per finished span; context PROPAGATION is
    the thread-local module state below plus the wire fields — the
    tracer itself stays a dumb emitter."""

    def __init__(
        self,
        exporter: "Optional[OTLPHTTPSpanExporter]" = None,
        sink: "Optional[FileSpanSink]" = None,
        sample: float = 1.0,
    ) -> None:
        self.exporter = exporter
        self.sink = sink
        self.sample = min(max(float(sample), 0.0), 1.0)

    def sample_step(self, step: int, job_id: "Optional[str]" = None) -> bool:
        """Deterministic per-step sampling decision, identical on every
        replica (derived from the step trace id, not local randomness),
        so a sampled step's trace is always COMPLETE across the fleet."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        frac = int(step_trace_id(step, job_id)[:8], 16) / float(1 << 32)
        return frac < self.sample

    def export_span(
        self,
        name: str,
        trace_id: str,
        start_ns: int,
        end_ns: int,
        span_id: "Optional[str]" = None,
        parent_span_id: "Optional[str]" = None,
        attributes: "Optional[Dict[str, Any]]" = None,
        ok: bool = True,
    ) -> str:
        """Record one finished span; returns its span id."""
        sid = span_id or new_span_id()
        span = {
            "name": name,
            "trace_id": trace_id,
            "span_id": sid,
            "parent_span_id": parent_span_id,
            "start_ns": int(start_ns),
            "end_ns": int(end_ns),
            "attributes": attributes or {},
            "ok": ok,
        }
        if self.exporter is not None:
            self.exporter.export(span)
        if self.sink is not None:
            self.sink.export(span)
        return sid

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.close()
        if self.sink is not None:
            self.sink.close()


_tracer: "Optional[Tracer]" = None
_tracer_lock = threading.Lock()
_tls = threading.local()

# Keeps the ctypes callback object alive while registered natively.
_native_sink_cfunc: Any = None


def install_tracer(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide tracer spans are emitted to."""
    global _tracer
    with _tracer_lock:
        _tracer = tracer
    # If the native coordination core is already loaded, wire its span
    # sink now; otherwise server construction does it (coordination.py).
    install_native_span_sink()
    return tracer


def uninstall_tracer() -> None:
    global _tracer
    with _tracer_lock:
        old, _tracer = _tracer, None
    _uninstall_native_span_sink()
    if old is not None:
        old.close()


def get_tracer() -> "Optional[Tracer]":
    """The installed tracer, or None (the common case — callers must treat
    tracing as strictly optional and zero-cost when absent)."""
    return _tracer


# ---------------------------------------------------------------------------
# thread-local current context (the propagation anchor)
# ---------------------------------------------------------------------------


def set_current(ctx: "Optional[TraceContext]") -> None:
    """Bind ``ctx`` as this thread's current trace position.  The Manager
    sets its round context on the caller and async-quorum threads; RPC
    clients and the heal transports read it back for injection."""
    _tls.ctx = ctx


def get_current() -> "Optional[TraceContext]":
    """This thread's current context, or None.  Zero-cost fast path:
    with no tracer installed this returns None without touching the
    thread-local at all."""
    if _tracer is None:
        return None
    return getattr(_tls, "ctx", None)


def current_traceparent() -> "Optional[str]":
    """The wire form of the current context, or None when tracing is off,
    no context is bound, or the step was not sampled — the ONE call every
    injection point (RPC envelope, HTTP header, PG metadata) makes."""
    if _tracer is None:
        return None
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not ctx.sampled:
        return None
    return ctx.to_traceparent()


# ---------------------------------------------------------------------------
# native span sink (rpc.* server spans -> this process's tracer)
# ---------------------------------------------------------------------------


def _on_native_span(payload: bytes) -> None:
    """ctypes callback target: one finished native server span as JSON.
    Must never raise into native code."""
    tracer = _tracer
    if tracer is None:
        return
    try:
        span = json.loads(payload.decode())
        tracer.export_span(
            name=str(span["name"]),
            trace_id=str(span["trace_id"]),
            span_id=span.get("span_id") or None,
            parent_span_id=span.get("parent_span_id") or None,
            start_ns=int(span["start_ns"]),
            end_ns=int(span["end_ns"]),
            attributes=dict(span.get("attributes") or {}),
            ok=bool(span.get("ok", True)),
        )
    except Exception:  # noqa: BLE001 - telemetry must not wedge a server
        logger.debug("bad native span payload", exc_info=True)


def install_native_span_sink(force_load: bool = False) -> bool:
    """Register the span-sink callback with the native library so the
    coordination servers' ``rpc.<method>`` spans reach the Python
    exporter.  By default only wires up when the native lib is ALREADY
    loaded (installing a tracer must not trigger a native build);
    ``coordination._NativeServer`` calls with ``force_load=True`` once a
    server exists.  Idempotent; no-op without an installed tracer."""
    global _native_sink_cfunc
    if _tracer is None:
        return False
    from torchft_tpu_torch import _native

    if not force_load and not _native.loaded():
        return False
    with _tracer_lock:
        if _native_sink_cfunc is not None:
            return True  # already registered
        cb = _native.SPAN_SINK_CFUNC(_on_native_span)
        _native.get_lib().tft_set_span_sink(cb)
        _native_sink_cfunc = cb
    return True


def _uninstall_native_span_sink() -> None:
    global _native_sink_cfunc
    with _tracer_lock:
        cb, _native_sink_cfunc = _native_sink_cfunc, None
    if cb is None:
        return
    from torchft_tpu_torch import _native

    if _native.loaded():
        _native.get_lib().tft_set_span_sink(_native.SPAN_SINK_CFUNC())


# ---------------------------------------------------------------------------
# env wiring
# ---------------------------------------------------------------------------


def maybe_install_from_env() -> "Optional[Tracer]":
    """Install the process tracer when either trace surface is enabled:
    ``TORCHFT_USE_OTEL`` (OTLP/HTTP exporter; endpoint from
    ``OTEL_EXPORTER_OTLP_TRACES_ENDPOINT`` / ``OTEL_EXPORTER_OTLP_ENDPOINT``)
    and/or ``TORCHFT_TRACE_FILE`` (JSONL span sink).  Step sampling from
    ``TORCHFT_TRACE_SAMPLE`` (fraction of steps, default 1.0)."""
    from torchft_tpu_torch.utils.env import env_bool, env_float, env_str

    use_otel = env_bool("TORCHFT_USE_OTEL")
    trace_file = env_str("TORCHFT_TRACE_FILE")
    if not use_otel and not trace_file:
        return None
    if _tracer is not None:
        return _tracer
    exporter: "Optional[OTLPHTTPSpanExporter]" = None
    if use_otel:
        endpoint = (
            env_str("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT")
            or env_str("OTEL_EXPORTER_OTLP_ENDPOINT")
            or "http://localhost:4318"
        )
        exporter = OTLPHTTPSpanExporter(endpoint)
    sink = FileSpanSink(trace_file) if trace_file else None
    sample = env_float("TORCHFT_TRACE_SAMPLE", 1.0, minimum=0.0)
    return install_tracer(Tracer(exporter, sink, sample=sample))
