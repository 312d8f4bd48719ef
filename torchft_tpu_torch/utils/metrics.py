"""Unified metrics layer: registry, Prometheus exposition, OTLP export.

The structured-event pipeline (utils/logging.py) answers "what happened";
this module answers "how often / how long / how many bytes" — the live,
NON-destructive observability surface an elastic trainer needs (consumers
take deltas of ``Manager.phase_times`` snapshots).  Reliable-collective
systems (Prime PCCL, PAPERS.md) treat per-phase counters as first-class
diagnostics; same stance here.

Three building blocks, stdlib only (this environment ships no
prometheus_client / opentelemetry SDK):

- a thread-safe :class:`Registry` of :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` families with labeled children
  (``.labels(replica_id=..., phase=...)``).  Counter and Histogram
  families additionally maintain an **unlabeled aggregate series** (the
  sum over all children) so a fresh process — or a scraper that wants the
  cluster-wide total without PromQL — always sees every family's series,
  zero-valued before first use;
- Prometheus text exposition (:meth:`Registry.render`, text format 0.0.4
  with full label escaping) served by the lighthouse dashboard port
  (native ``GET /metrics``, see coordination.py), by the opt-in
  per-manager :class:`MetricsHTTPServer` (``TORCHFT_METRICS_PORT``), and
  parseable back via :func:`parse_text_exposition` (tests + the tier-1
  smoke check);
- an OTLP/HTTP **metrics** exporter (``POST /v1/metrics``, JSON encoding,
  cumulative temporality) in the style of ``utils/otel.py``'s log
  exporter, gated on the same ``TORCHFT_USE_OTEL`` env.

Failure policy matches every sink in this framework: a dead collector or
a wedged scraper never takes down training.

Every torchft-exported instrument is defined at the bottom of this module
(one source of truth for the docs table in docs/observability.md).
"""

from __future__ import annotations

import atexit
import bisect
import json
import logging
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torchft_tpu_torch.utils import lockcheck
from torchft_tpu_torch.utils.env import env_bool, env_float, env_int, env_str

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Fixed exponential latency buckets: 1 ms .. ~65 s doubling, suitable for
# everything from a sub-ms fast quorum to a full heal over a slow link.
DEFAULT_BUCKETS: "Tuple[float, ...]" = tuple(0.001 * 2**i for i in range(17))

# Process start, the OTLP cumulative-sum start timestamp.
_START_NS = time.time_ns()


def _fmt_value(v: float) -> str:
    """Prometheus sample-value formatting (ints without the trailing .0)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(items: "Sequence[Tuple[str, str]]") -> str:
    if not items:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in items
    )
    return "{" + inner + "}"


class _Metric:
    """One metric family: name, help, label names, children keyed by label
    values.  All mutation goes through ``self._lock`` — increments arrive
    from the training loop, the async quorum thread, PG worker threads and
    checkpoint server threads concurrently."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: "Sequence[str]" = (),
        registry: "Optional[Registry]" = None,
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lockcheck.lock(f"metrics.{name}")
        self._children: "Dict[Tuple[str, ...], Any]" = {}
        self._default = self._new_state()
        if registry is None:
            registry = REGISTRY
        registry.register(self)

    # subclass hooks ------------------------------------------------------
    def _new_state(self) -> Any:
        raise NotImplementedError

    def labels(self, **labelvalues: Any) -> "_BoundChild":
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_state()
                self._children[key] = child
        return _BoundChild(self, child)

    def _series(self) -> "List[Tuple[Tuple[Tuple[str, str], ...], Any]]":
        """Snapshot [(label_items, state_copy)] — default series first.
        The default (unlabeled) series renders for counters/histograms
        always, and for gauges only when the family is unlabeled (a sum
        of last-set gauge values is not a meaningful gauge)."""
        with self._lock:
            out: "List[Tuple[Tuple[Tuple[str, str], ...], Any]]" = []
            if not self.labelnames or self.kind != "gauge":
                out.append(((), self._copy_state(self._default)))
            for key, child in self._children.items():
                out.append(
                    (tuple(zip(self.labelnames, key)), self._copy_state(child))
                )
            return out

    def _copy_state(self, state: Any) -> Any:
        return state


class _BoundChild:
    """A (family, child-state) pair returned by ``labels()``; updates fan
    into the child AND the family's unlabeled aggregate (counters and
    histograms — see module docstring)."""

    __slots__ = ("_metric", "_state")

    def __init__(self, metric: _Metric, state: Any) -> None:
        self._metric = metric
        self._state = state

    def inc(self, amount: float = 1) -> None:
        self._metric._inc_state(self._state, amount, aggregate=True)

    def dec(self, amount: float = 1) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        self._metric._set_state(self._state, value)

    def observe(self, value: float) -> None:
        self._metric._observe_state(self._state, value, aggregate=True)

    def get(self) -> Any:
        return self._metric._read_state(self._state)


class Counter(_Metric):
    kind = "counter"

    def _new_state(self) -> "List[float]":
        return [0.0]

    def inc(self, amount: float = 1) -> None:
        self._inc_state(self._default, amount, aggregate=False)

    def get(self) -> float:
        return self._read_state(self._default)

    def _inc_state(self, state: "List[float]", amount: float, aggregate: bool) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            state[0] += amount
            if aggregate and state is not self._default:
                self._default[0] += amount

    def _set_state(self, state: Any, value: float) -> None:
        raise TypeError("set() is not valid on a counter")

    def _observe_state(self, state: Any, value: float, aggregate: bool) -> None:
        raise TypeError("observe() is not valid on a counter")

    def _read_state(self, state: "List[float]") -> float:
        with self._lock:
            return state[0]

    def _copy_state(self, state: "List[float]") -> float:
        return state[0]


class Gauge(_Metric):
    kind = "gauge"

    def _new_state(self) -> "List[float]":
        return [0.0]

    def set(self, value: float) -> None:
        self._set_state(self._default, value)

    def inc(self, amount: float = 1) -> None:
        self._inc_state(self._default, amount, aggregate=False)

    def dec(self, amount: float = 1) -> None:
        self.inc(-amount)

    def get(self) -> float:
        return self._read_state(self._default)

    def _inc_state(self, state: "List[float]", amount: float, aggregate: bool) -> None:
        with self._lock:
            state[0] += amount

    def _set_state(self, state: "List[float]", value: float) -> None:
        with self._lock:
            state[0] = float(value)

    def _observe_state(self, state: Any, value: float, aggregate: bool) -> None:
        raise TypeError("observe() is not valid on a gauge")

    def _read_state(self, state: "List[float]") -> float:
        with self._lock:
            return state[0]

    def _copy_state(self, state: "List[float]") -> float:
        return state[0]


class _HistState:
    __slots__ = ("buckets", "sum", "count")

    def __init__(self, nbuckets: int) -> None:
        self.buckets = [0] * nbuckets  # per-bucket counts (not cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: "Sequence[str]" = (),
        buckets: "Optional[Sequence[float]]" = None,
        registry: "Optional[Registry]" = None,
    ) -> None:
        bounds = tuple(sorted(DEFAULT_BUCKETS if buckets is None else buckets))
        if not bounds or any(
            b >= n for b, n in zip(bounds, bounds[1:])
        ):
            raise ValueError("histogram buckets must be strictly increasing")
        self.bounds = bounds  # upper bounds, +Inf implicit
        super().__init__(name, help, labelnames, registry)

    def _new_state(self) -> _HistState:
        return _HistState(len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        self._observe_state(self._default, value, aggregate=False)

    def get(self) -> "Dict[str, Any]":
        return self._read_state(self._default)

    def _observe_state(self, state: _HistState, value: float, aggregate: bool) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            for s in (
                (state, self._default)
                if aggregate and state is not self._default
                else (state,)
            ):
                s.buckets[idx] += 1
                s.sum += value
                s.count += 1

    def _inc_state(self, state: Any, amount: float, aggregate: bool) -> None:
        raise TypeError("inc() is not valid on a histogram")

    def _set_state(self, state: Any, value: float) -> None:
        raise TypeError("set() is not valid on a histogram")

    def _read_state(self, state: _HistState) -> "Dict[str, Any]":
        with self._lock:
            return self._copy_state(state)

    def _copy_state(self, state: _HistState) -> "Dict[str, Any]":
        # cumulative bucket counts, Prometheus-style
        cum: "List[int]" = []
        total = 0
        for c in state.buckets:
            total += c
            cum.append(total)
        return {
            "bounds": self.bounds,
            "buckets": cum,  # len(bounds)+1, last == count (+Inf)
            "sum": state.sum,
            "count": state.count,
        }


class Registry:
    """Named collection of metric families; renders and snapshots them."""

    def __init__(self) -> None:
        self._lock = lockcheck.lock("metrics.registry")
        self._metrics: "Dict[str, _Metric]" = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> "Optional[_Metric]":
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> "List[_Metric]":
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every family."""
        lines: "List[str]" = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for label_items, value in m._series():
                if m.kind == "histogram":
                    for bound, cum in zip(
                        list(value["bounds"]) + [float("inf")], value["buckets"]
                    ):
                        items = label_items + (("le", _fmt_value(bound)),)
                        lines.append(
                            f"{m.name}_bucket{_render_labels(items)} {cum}"
                        )
                    lines.append(
                        f"{m.name}_sum{_render_labels(label_items)} "
                        f"{_fmt_value(value['sum'])}"
                    )
                    lines.append(
                        f"{m.name}_count{_render_labels(label_items)} "
                        f"{value['count']}"
                    )
                else:
                    lines.append(
                        f"{m.name}{_render_labels(label_items)} "
                        f"{_fmt_value(value)}"
                    )
        return "\n".join(lines) + "\n"

    def collect(self) -> "List[Dict[str, Any]]":
        """Structured snapshot for the OTLP encoder (and tests)."""
        out: "List[Dict[str, Any]]" = []
        for m in self.metrics():
            out.append(
                {
                    "name": m.name,
                    "help": m.help,
                    "kind": m.kind,
                    "series": [
                        {"labels": dict(items), "value": value}
                        for items, value in m._series()
                    ],
                }
            )
        return out


REGISTRY = Registry()


def _get_or_create(
    cls: type, name: str, help: str, labelnames: "Sequence[str]", registry: "Optional[Registry]", **kw: Any
) -> Any:
    reg = registry if registry is not None else REGISTRY
    existing = reg.get(name)
    if existing is not None:
        if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with a different "
                f"kind/labels"
            )
        return existing
    return cls(name, help, labelnames, registry=reg, **kw)


def counter(
    name: str, help: str, labelnames: "Sequence[str]" = (), registry: "Optional[Registry]" = None
) -> Counter:
    """Get-or-create a :class:`Counter` in ``registry`` (default global)."""
    return _get_or_create(Counter, name, help, labelnames, registry)


def gauge(
    name: str, help: str, labelnames: "Sequence[str]" = (), registry: "Optional[Registry]" = None
) -> Gauge:
    """Get-or-create a :class:`Gauge` in ``registry`` (default global)."""
    return _get_or_create(Gauge, name, help, labelnames, registry)


def histogram(
    name: str,
    help: str,
    labelnames: "Sequence[str]" = (),
    buckets: "Optional[Sequence[float]]" = None,
    registry: "Optional[Registry]" = None,
) -> Histogram:
    """Get-or-create a :class:`Histogram` in ``registry`` (default global)."""
    return _get_or_create(
        Histogram, name, help, labelnames, registry, buckets=buckets
    )


# ---------------------------------------------------------------------------
# text-exposition parser (round-trip tests + the tier-1 /metrics smoke check)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?[0-9]+))?$"
)
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


def _unescape_label_value(v: str) -> str:
    # single left-to-right scan: sequential str.replace would corrupt a
    # literal backslash followed by 'n' ('a\\nb' escapes to 'a\\\\nb'; the
    # naive '\\n'-first replace turns that into backslash+newline)
    out: "List[str]" = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v) and v[i + 1] in ('n', '\\', '"'):
            out.append({"n": "\n", "\\": "\\", '"': '"'}[v[i + 1]])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(v: str) -> float:
    if v == "+Inf":
        return float("inf")
    if v == "-Inf":
        return float("-inf")
    return float(v)  # raises ValueError on garbage — the validator's job


def parse_text_exposition(text: str) -> "Dict[str, Dict[str, Any]]":
    """Strict parser for the Prometheus text format subset this module
    (and the native lighthouse endpoint) emits.

    Returns ``{family: {"type": ..., "help": ..., "samples":
    {(sample_name, ((label, value), ...)): float}}}``; raises
    ``ValueError`` on any malformed line — the tier-1 smoke check runs the
    whole scrape through this to catch label-escaping regressions.
    """
    families: "Dict[str, Dict[str, Any]]" = {}

    def family_for(sample_name: str) -> "Dict[str, Any]":
        for suffix in ("_bucket", "_sum", "_count", ""):
            base = sample_name[: -len(suffix)] if suffix else sample_name
            if base in families and (
                not suffix or families[base]["type"] == "histogram"
            ):
                return families[base]
        return families.setdefault(
            sample_name, {"type": "untyped", "help": "", "samples": {}}
        )

    for lineno, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP ") :]
            name, _, help_text = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ValueError(f"line {lineno}: bad HELP name {name!r}")
            families.setdefault(
                name, {"type": "untyped", "help": "", "samples": {}}
            )["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE ") :].split(" ")
            if len(parts) != 2 or not _NAME_RE.match(parts[0]) or parts[
                1
            ] not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            families.setdefault(
                parts[0], {"type": "untyped", "help": "", "samples": {}}
            )["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels: "List[Tuple[str, str]]" = []
        raw = m.group("labels")
        if raw is not None:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_PAIR_RE.match(raw, pos)
                if not lm:
                    raise ValueError(
                        f"line {lineno}: malformed labels {raw!r}"
                    )
                labels.append(
                    (lm.group("name"), _unescape_label_value(lm.group("value")))
                )
                pos = lm.end()
        try:
            value = _parse_value(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value in {line!r}") from e
        fam = family_for(m.group("name"))
        key = (m.group("name"), tuple(labels))
        if key in fam["samples"]:
            raise ValueError(f"line {lineno}: duplicate sample {key!r}")
        fam["samples"][key] = value
    return families


def quantile_from_histogram(
    families: "Dict[str, Dict[str, Any]]",
    name: str,
    q: float,
    labels: "Sequence[Tuple[str, str]]" = (),
) -> float:
    """Estimate the ``q`` quantile (0..1) of a parsed histogram family.

    Standard Prometheus upper-bound estimation: find the first bucket
    whose cumulative count reaches ``q * count`` and return its ``le``
    bound (conservative — the true value is at or below it; ``+Inf``
    degrades to the largest finite bound).  ``labels`` narrows to one
    child's series, exactly as rendered.  Raises ``KeyError`` for a
    missing family and ``ValueError`` for an empty histogram — a p99
    assertion against a histogram nobody observed must fail loudly, not
    return 0.
    """
    fam = families[name]
    want = tuple(sorted(labels))
    buckets: "List[Tuple[float, float]]" = []  # (le, cumulative count)
    total = 0.0
    for (sample, sample_labels), value in fam["samples"].items():
        rest = tuple(
            sorted((k, v) for k, v in sample_labels if k != "le")
        )
        if rest != want:
            continue
        if sample == f"{name}_bucket":
            le = dict(sample_labels).get("le", "")
            buckets.append(
                (float("inf") if le == "+Inf" else float(le), value)
            )
        elif sample == f"{name}_count":
            total = value
    if total <= 0 or not buckets:
        raise ValueError(f"histogram {name}{dict(want)} has no observations")
    buckets.sort()
    rank = q * total
    largest_finite = max(
        (le for le, _ in buckets if le != float("inf")), default=float("inf")
    )
    for le, cum in buckets:
        if cum >= rank:
            return largest_finite if le == float("inf") else le
    return largest_finite


# ---------------------------------------------------------------------------
# per-process HTTP scrape server (the per-manager surface)
# ---------------------------------------------------------------------------


class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    registry: Registry  # injected per-server

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet
        logger.debug("metrics http: " + fmt, *args)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404, "try /metrics")
            return
        try:
            body = self.registry.render().encode()
        except Exception as e:  # noqa: BLE001 - a scrape never kills training
            logger.warning("metrics render failed: %s", e)
            self.send_error(500, "render failed")
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsHTTPServer:
    """Tiny threaded scrape endpoint: ``GET /metrics`` on ``port``.

    ``port=0`` picks an ephemeral port (tests).  Serving runs on a daemon
    thread; ``close()`` stops it.
    """

    def __init__(self, port: int = 0, registry: "Optional[Registry]" = None) -> None:
        handler = type(
            "_BoundMetricsHandler",
            (_MetricsHandler,),
            {"registry": registry if registry is not None else REGISTRY},
        )
        self._server = ThreadingHTTPServer(("", port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=lambda: self._server.serve_forever(poll_interval=0.1),
            name="torchft_metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def address(self) -> str:
        return f"{socket.gethostname()}:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


_env_server: "Optional[MetricsHTTPServer]" = None
_env_server_lock = threading.Lock()


def maybe_serve_from_env() -> "Optional[MetricsHTTPServer]":
    """Start the process-wide scrape server when ``TORCHFT_METRICS_PORT``
    is set (idempotent — every Manager in the process calls this; the
    first one wins).  Port conflicts are logged, never raised: a taken
    metrics port must not take down training."""
    global _env_server
    port = env_int("TORCHFT_METRICS_PORT", 0, minimum=0)
    if not port:
        return None
    with _env_server_lock:
        if _env_server is not None:
            return _env_server
        try:
            _env_server = MetricsHTTPServer(port)
        except (OSError, ValueError) as e:
            logger.warning(
                "could not start metrics server on port %s: %s", port, e
            )
            return None
        return _env_server


# ---------------------------------------------------------------------------
# OTLP/HTTP metrics exporter (POST /v1/metrics, JSON encoding)
# ---------------------------------------------------------------------------


class OTLPMetricsExporter:
    """Periodic cumulative-snapshot push of a registry to an OTLP/HTTP
    collector, in the style of ``utils/otel.py``'s log exporter: daemon
    flush thread, same resource-attribute loading, same failure policy
    (failed posts drop with a warning and a ``dropped`` counter)."""

    def __init__(
        self,
        endpoint: str,
        registry: "Optional[Registry]" = None,
        resource_attributes: "Optional[Dict[str, Any]]" = None,
        service_name: str = "torchft_tpu",
        interval_s: float = 10.0,
        timeout_s: float = 5.0,
    ) -> None:
        from torchft_tpu_torch.utils.otel import _kv_list, load_resource_attributes

        self._endpoint = endpoint.rstrip("/")
        if not self._endpoint.endswith("/v1/metrics"):
            self._endpoint += "/v1/metrics"
        self._registry = registry if registry is not None else REGISTRY
        if resource_attributes is None:
            resource_attributes = load_resource_attributes(service_name)
        attrs = {"service.name": service_name, **resource_attributes}
        self._resource = {"attributes": _kv_list(attrs)}
        self._interval_s = interval_s
        self._timeout_s = timeout_s
        self._stop = threading.Event()
        self.exported = 0  # successful posts
        self.dropped = 0  # failed posts
        self._thread = threading.Thread(
            target=self._run, name="otlp_metrics_exporter", daemon=True
        )
        self._thread.start()
        atexit.register(self._atexit_flush)

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.flush()

    def flush(self) -> bool:
        """Encode + post the current cumulative snapshot; True on 2xx."""
        from torchft_tpu_torch.utils.otel import post_otlp

        try:
            post_otlp(self._endpoint, self.encode(), self._timeout_s)
            self.exported += 1
            return True
        except Exception as e:  # noqa: BLE001 - a sink never kills training
            self.dropped += 1
            logger.warning("OTLP metrics export failed: %s", e)
            return False

    def encode(self) -> bytes:
        """OTLP JSON ``resourceMetrics`` document for the current snapshot
        (cumulative temporality; counters are monotonic sums)."""
        from torchft_tpu_torch.utils.otel import _kv_list

        now = str(time.time_ns())
        start = str(_START_NS)
        metrics_out: "List[Dict[str, Any]]" = []
        for fam in self._registry.collect():
            entry: "Dict[str, Any]" = {
                "name": fam["name"],
                "description": fam["help"],
            }
            if fam["kind"] == "histogram":
                points = []
                for s in fam["series"]:
                    v = s["value"]
                    # OTLP bucketCounts are per-bucket, not cumulative
                    cum = v["buckets"]
                    per = [c - p for c, p in zip(cum, [0] + cum[:-1])]
                    points.append(
                        {
                            "attributes": _kv_list(s["labels"]),
                            "startTimeUnixNano": start,
                            "timeUnixNano": now,
                            "count": str(v["count"]),
                            "sum": v["sum"],
                            "bucketCounts": [str(c) for c in per],
                            "explicitBounds": list(v["bounds"]),
                        }
                    )
                entry["histogram"] = {
                    "dataPoints": points,
                    "aggregationTemporality": 2,  # CUMULATIVE
                }
            else:
                points = [
                    {
                        "attributes": _kv_list(s["labels"]),
                        "startTimeUnixNano": start,
                        "timeUnixNano": now,
                        "asDouble": float(s["value"]),
                    }
                    for s in fam["series"]
                ]
                if fam["kind"] == "counter":
                    entry["sum"] = {
                        "dataPoints": points,
                        "aggregationTemporality": 2,
                        "isMonotonic": True,
                    }
                else:
                    entry["gauge"] = {"dataPoints": points}
            metrics_out.append(entry)
        doc = {
            "resourceMetrics": [
                {
                    "resource": self._resource,
                    "scopeMetrics": [
                        {
                            "scope": {"name": "torchft_tpu"},
                            "metrics": metrics_out,
                        }
                    ],
                }
            ]
        }
        return json.dumps(doc, default=str).encode()

    def _atexit_flush(self) -> None:
        if not self._stop.is_set():
            self.flush()

    def close(self) -> None:
        self._stop.set()
        try:
            atexit.unregister(self._atexit_flush)
        except Exception:  # noqa: BLE001 - interpreter-state dependent
            pass
        self._thread.join(timeout=self._timeout_s + 1.0)


_env_metrics_exporter: "Optional[OTLPMetricsExporter]" = None


def maybe_export_from_env() -> "Optional[OTLPMetricsExporter]":
    """Start the OTLP metrics push when ``TORCHFT_USE_OTEL`` is truthy
    (same gate and endpoint resolution as the log exporter:
    ``OTEL_EXPORTER_OTLP_METRICS_ENDPOINT``, else
    ``OTEL_EXPORTER_OTLP_ENDPOINT``, else the OTLP default)."""
    global _env_metrics_exporter
    if not env_bool("TORCHFT_USE_OTEL"):
        return None
    if _env_metrics_exporter is not None:
        return _env_metrics_exporter
    endpoint = (
        env_str("OTEL_EXPORTER_OTLP_METRICS_ENDPOINT")
        or env_str("OTEL_EXPORTER_OTLP_ENDPOINT")
        or "http://localhost:4318"
    )
    # runs at `import torchft_tpu`: a typo'd env var degrades to the
    # default inside env_float, never crashes training
    interval = env_float("TORCHFT_METRICS_EXPORT_INTERVAL_S", 10.0)
    _env_metrics_exporter = OTLPMetricsExporter(endpoint, interval_s=interval)
    return _env_metrics_exporter


# ---------------------------------------------------------------------------
# torchft instruments — the one place every exported metric is defined
# (docs/observability.md carries the rendered table; keep the two in sync)
# ---------------------------------------------------------------------------

QUORUM_DURATION = histogram(
    "torchft_quorum_duration_seconds",
    "Wall-clock seconds per FT protocol phase (quorum_wait/quorum_rpc/"
    "pg_configure/heal_send/heal_recv/host_sync/ring/commit)",
    ("replica_id", "phase"),
)
QUORUM_CHANGES = counter(
    "torchft_quorum_changes_total",
    "Quorum membership changes observed (PG reconfigures triggered)",
    ("replica_id",),
)
COMMITS = counter(
    "torchft_commits_total",
    "should_commit votes by outcome",
    ("replica_id", "result"),
)
ERRORS = counter(
    "torchft_errors_total",
    "Errors latched into the step protocol (report_error)",
    ("replica_id",),
)
HEALS = counter(
    "torchft_heals_total",
    "Live checkpoint transfers by direction (send=to peers, recv=healing)",
    ("replica_id", "direction"),
)
ALLREDUCES = counter(
    "torchft_allreduce_total",
    "Fault-tolerant allreduce submissions",
    ("replica_id",),
)
STEP = gauge(
    "torchft_step",
    "Current committed step of this replica",
    ("replica_id",),
)
PARTICIPANTS = gauge(
    "torchft_participants",
    "Live participant count of the current quorum",
    ("replica_id",),
)
PG_RECONFIGURES = counter(
    "torchft_pg_reconfigures_total",
    "Process-group configure() completions by transport",
    ("transport",),
)
PG_ABORTS = counter(
    "torchft_pg_aborts_total",
    "Process-group abort() calls by transport",
    ("transport",),
)
CHECKPOINT_BYTES = counter(
    "torchft_checkpoint_bytes_total",
    "Checkpoint payload bytes streamed by transport and direction",
    ("transport", "direction"),
)
CHECKPOINT_DURATION = histogram(
    "torchft_checkpoint_duration_seconds",
    "Checkpoint send/recv wall-clock seconds by transport and direction",
    ("transport", "direction"),
)
CHECKPOINT_RETRIES = counter(
    "torchft_checkpoint_retries_total",
    "Checkpoint fetch retries (sender not yet staged / transient errors)",
    ("transport",),
)
HEAL_INTO_FALLBACKS = counter(
    "torchft_heal_into_fallbacks_total",
    "Heal receives that could NOT reuse the retained leaf buffers "
    "(state_dict_fn failed/mismatched — the decode allocates fresh "
    "arrays; a nonzero rate means the zero-alloc heal path regressed)",
)
HEAL_FRAG_FAILOVERS = counter(
    "torchft_heal_frag_failovers_total",
    "Striped-heal fragments that failed over to another stripe source "
    "(dead source, budget expiry, or digest mismatch)",
)
HEAL_STRIPE_SOURCES = gauge(
    "torchft_heal_stripe_sources",
    "Stripe sources the most recent striped heal fetched across "
    "(1 = primary only)",
)
HEAL_WIRE_BYTES = counter(
    "torchft_heal_wire_bytes_total",
    "Striped-heal fragment bytes fetched, by mode (full vs delta — "
    "delta bytes scale with the changed-fragment count)",
    ("mode",),
)
HEAL_CHANGED_FRAGMENTS = gauge(
    "torchft_heal_changed_fragments",
    "Fragments the most recent delta heal actually fetched (digest "
    "diff vs the rejoiner's own state); equals the fragment count on "
    "a full heal",
)
PLAN_VERIFY_TOTAL = counter(
    "torchft_plan_verify_total",
    "Live topology plans validated at their commit point under "
    "TORCHFT_PLAN_VERIFY, by plane (reduction/serving/stripe) and "
    "verdict (accept/reject/error) — any reject is a synthesized plan "
    "that violated a named invariant (see tft-verify --scenario plan)",
    ("plane", "verdict"),
)
STORE_SPILL_BYTES = counter(
    "torchft_store_spill_bytes_total",
    "Fragment bytes newly written by the durable store spill path "
    "(dedup by digest: unchanged fragments cost zero — steady-state "
    "write amplification scales with the update delta)",
)
STORE_SPILL_FAILURES = counter(
    "torchft_store_spill_failures_total",
    "Spill attempts that failed and were skipped (the spill tier "
    "degrades — it never raises into or stalls a training step)",
)
STORE_RESTORE_BYTES = counter(
    "torchft_store_restore_bytes_total",
    "Wire bytes fetched by whole-fleet cold restore, by mode (delta "
    "restores reuse surviving local fragments and fetch only the diff)",
    ("mode",),
)
STORE_TORN_BLOBS = counter(
    "torchft_store_torn_blobs_total",
    "Store blob reads that failed sha256 digest verify (torn write or "
    "bit rot) — treated as missing so restore fails over, never served",
)
STORE_VERSIONS = gauge(
    "torchft_store_versions",
    "Durable store versions currently on this rank's disk after "
    "retirement under the TORCHFT_STORE_VERSIONS window",
)
DILOCO_SYNC_SECONDS = gauge(
    "torchft_diloco_last_sync_seconds",
    "Duration of the most recent DiLoCo fragment sync (perform_sync)",
    ("fragment",),
)
DILOCO_WIRE_BYTES = gauge(
    "torchft_diloco_last_wire_bytes",
    "Wire bytes of the most recent DiLoCo fragment allreduce (quantized "
    "actual when available, else payload bytes)",
    ("fragment",),
)
QUANT_CODEC_SECONDS = histogram(
    "torchft_quant_codec_seconds",
    "Quantized-collective codec wall per pipeline chunk by stage "
    "(quantize/reduce/dequant) and wire format (ops/collectives.py)",
    ("stage", "wire"),
)
QUANT_WIRE_SECONDS = histogram(
    "torchft_quant_wire_seconds",
    "Quantized-collective wire-op execution seconds per pipeline chunk "
    "by PG op (alltoall/allgather/send/recv/sendrecv), reduction-plan "
    "hop (flat, or intra.reduce/inter.exchange/inter.gather/intra.bcast "
    "on hierarchical plans) and wire format",
    ("op", "hop", "wire"),
)
QUANT_OVERLAP_EFFICIENCY = gauge(
    "torchft_quant_overlap_efficiency",
    "Codec/wire overlap achieved by the last quantized collective: "
    "(codec_s + wire_s - wall) / min(codec_s, wire_s), 1.0 = perfectly "
    "pipelined, 0.0 = fully serialized",
    ("wire",),
)
LAYOUT_EPOCH = gauge(
    "torchft_layout_epoch",
    "Active layout epoch of the online-parallelism-switching protocol "
    "(parallel/layout.py; monotone, bumped per committed switch)",
    ("replica_id",),
)
LAYOUT_SWITCHES = counter(
    "torchft_layout_switches_total",
    "Layout-switch commit rounds by outcome (committed = the whole "
    "fleet activated the staged layout; rolled_back = the epoch was "
    "burned and the old layout kept)",
    ("replica_id", "result"),
)
RESHARD_BYTES = counter(
    "torchft_reshard_bytes_total",
    "Bytes fetched from peers by the live-reshard slice-diff transfers "
    "(parallel/layout.py; only missing intervals cross the wire)",
    ("replica_id",),
)
FAULTS_INJECTED = counter(
    "torchft_faults_injected_total",
    "Chaos faults injected by site and action (utils/faults.py registry)",
    ("site", "action"),
)
RETRIES = counter(
    "torchft_retries_total",
    "RetryPolicy retries by operation (utils/retry.py)",
    ("op",),
)
RETRY_BACKOFF = histogram(
    "torchft_retry_backoff_seconds",
    "Backoff slept before each retry attempt, by operation",
    ("op",),
)
FLIGHT_DUMPS = counter(
    "torchft_flight_dumps_total",
    "Flight-recorder dumps written, by trigger "
    "(pg_abort/manager_error/signal/manual; utils/flightrecorder.py)",
    ("trigger",),
)
LOCK_CYCLES = counter(
    "torchft_lock_cycles_total",
    "Distinct lock-order cycles (potential deadlocks) observed by the "
    "TORCHFT_LOCKCHECK runtime detector (utils/lockcheck.py)",
    ("edge",),
)
LOCK_HOLD_OUTLIERS = counter(
    "torchft_lock_hold_outliers_total",
    "Lock holds exceeding TORCHFT_LOCKCHECK_HOLD_MS, by lock name "
    "(utils/lockcheck.py; straggler-origin telemetry)",
    ("name",),
)
SERVING_PUBLISHES = counter(
    "torchft_serving_versions_published_total",
    "Weight versions published into the serving tier by wire format "
    "(serving/publisher.py; f32 = raw, int8 = quantized payload)",
    ("wire",),
)
SERVING_PUBLISH_SECONDS = histogram(
    "torchft_serving_publish_seconds",
    "Wall seconds to encode + stage one published weight version "
    "(serving/publisher.py) by wire format",
    ("wire",),
)
SERVING_FETCH_SECONDS = histogram(
    "torchft_serving_fetch_seconds",
    "Weight-version fetch wall seconds by role (relay = tree node "
    "pulling from its parent, client = inference client fetch incl. "
    "failover)",
    ("role",),
)
SERVING_FETCH_BYTES = counter(
    "torchft_serving_fetch_bytes_total",
    "Bytes received by serving-tier fetches, by role (relay/client)",
    ("role",),
)
SERVING_FAILOVERS = counter(
    "torchft_serving_failovers_total",
    "Serving fetches that moved to another source after a failure "
    "(dead parent / killed server mid-fetch), by role",
    ("role",),
)
SERVING_PLAN_EPOCH = gauge(
    "torchft_serving_plan_epoch",
    "Distribution-tree plan epoch this process last adopted, by role "
    "(publisher/server/client; monotone — lags the lighthouse's "
    "torchft_lighthouse_serving_epoch only during a tree switch)",
    ("role",),
)
SERVING_TREE_DEPTH = gauge(
    "torchft_serving_tree_depth",
    "Depth of the adopted distribution tree (serving_plan max node "
    "depth; 0 = every server pulls the publisher directly)",
    (),
)
SERVING_VERSION = gauge(
    "torchft_serving_version",
    "Newest weight version this process holds/has published, by role",
    ("role",),
)
SERVING_WIRE_WAIT = counter(
    "torchft_serving_wire_wait_seconds_total",
    "Seconds serving-tier fetches slept to honor the WAN wire model "
    "(TORCHFT_WIRE_RTT_MS + TORCHFT_WIRE_GBPS across the "
    "TORCHFT_TOPOLOGY boundary; serving/wire.py), by source peer host — "
    "worst-K bounded tier (TORCHFT_LINK_TOPK names + 'other'); the "
    "unlabeled aggregate is the process total",
    ("peer",),
)
SERVING_RELAY_DECODE = histogram(
    "torchft_serving_relay_decode_seconds",
    "Seconds a serving relay spent deserializing pulled payload content "
    "per pull, by mode (serving/replica.py): flat = whole-payload "
    "store-and-forward decode, stream = cut-through passthrough — "
    "manifest-only, ~0 (fragments are verified opaque bytes, never "
    "decoded on the relay)",
    ("mode",),
)
SERVING_CUT_OCCUPANCY = gauge(
    "torchft_serving_cut_through_occupancy",
    "Pipeline occupancy of the last streamed relay pull: overlap of "
    "fragment wire time (UNION of the in-flight fetch intervals, so "
    "parallel fetches don't double-count) with verify/stage time, "
    "(wire_s + proc_s - wall_s) / min(wire_s, proc_s) clamped to "
    "[0, 1] — the serving twin of torchft_quant_overlap_efficiency "
    "(serving/replica.py)",
    (),
)
PG_WIRE_WAIT = counter(
    "torchft_pg_wire_wait_seconds_total",
    "Seconds ProcessGroupTCP sends slept to honor the WAN wire model "
    "(first-byte RTT + token-bucket debt on boundary-crossing messages; "
    "parallel/process_group.py), by peer host — worst-K bounded tier "
    "(TORCHFT_LINK_TOPK names + 'other'); the unlabeled aggregate is "
    "the process total",
    ("peer",),
)
LINK_GOODPUT = gauge(
    "torchft_link_goodput_bytes_per_s",
    "Passively measured link goodput by peer host and transfer plane "
    "(reduction/fragments/rpc; utils/linkstats.py) — worst-K WAN links "
    "only (TORCHFT_LINK_TOPK); fleet-local truth in "
    "torchft_link_pairs_tracked / torchft_link_goodput_min_bytes_per_s",
    ("peer", "plane"),
)
LINK_RTT_P99 = gauge(
    "torchft_link_rtt_p99_seconds",
    "Windowed p99 first-byte latency of a measured link by peer host "
    "and plane (TORCHFT_LINK_WINDOW samples; utils/linkstats.py) — "
    "worst-K WAN links only",
    ("peer", "plane"),
)
LINK_PAIRS = gauge(
    "torchft_link_pairs_tracked",
    "Links (peer, plane) in this process's full passive link table "
    "(worst-K of these export per-peer series)",
    (),
)
LINK_GOODPUT_MIN = gauge(
    "torchft_link_goodput_min_bytes_per_s",
    "Lowest measured WAN-link goodput in the full link table (one "
    "series at any fleet size — the aggregate under the worst-K tier)",
    (),
)
FRAG_HELD = gauge(
    "torchft_frag_held",
    "Fragments in this process's provenance version vector "
    "(checkpointing/provenance.py) — every fragment this holder has "
    "staged/verified/spilled, any payload family",
    (),
)
FRAG_HOPS = counter(
    "torchft_frag_hops_total",
    "Fragment transfers audited by the provenance plane, by transfer "
    "plane (serving/heal/restore) and digest verdict (ok / mismatch / "
    "torn) — a nonzero mismatch or torn count is a poisoned-fragment "
    "signal (triage with torchft-torch-diagnose --fragment)",
    ("plane", "verdict"),
)
FRAG_STAMP_AGE = gauge(
    "torchft_frag_stamp_age_seconds",
    "Publish-stamp age of a held fragment at digest-refresh time, by "
    "frag id — worst-K stalest only (TORCHFT_FRAG_TOPK names + "
    "'other'); fleet per-fragment staleness on one clock lives in the "
    "lighthouse /fragments.json matrix",
    ("frag",),
)
FRAG_STAMP_AGE_MAX = gauge(
    "torchft_frag_stamp_age_max_seconds",
    "Oldest publish stamp across the full local provenance vector (one "
    "series at any fragment count — the aggregate under the worst-K "
    "tier)",
    (),
)
SERVING_STALENESS = histogram(
    "torchft_serving_staleness_seconds",
    "Serving staleness ledger: publish-stamp age of a weight version at "
    "the moment a node finished holding/fetching it, by role "
    "(publisher = encode+stage+advertise lag, server = publish-to-relay "
    "propagation, client = publish-to-consumer; stamps ride the payload "
    "manifest on the publisher's clock, so depth legs compare on ONE "
    "clock)",
    ("role",),
)
HA_FAILOVERS = counter(
    "torchft_ha_failovers_total",
    "Lighthouse RPCs that moved to another endpoint of the "
    "TORCHFT_LIGHTHOUSE list after a dead/unreachable peer "
    "(coordination-plane HA failover walk)",
    (),
)
HA_REDIRECTS = counter(
    "torchft_ha_redirects_total",
    "Lighthouse RPCs redirected to the current leader after a "
    "NOT_LEADER reply from a follower peer",
    (),
)
