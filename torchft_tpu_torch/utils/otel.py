"""OTLP/HTTP log exporter behind the structured-event seam.

Analog of the reference's OTEL pipeline (reference: torchft/otel.py:42-86
— a Tee of ConsoleLogExporter + OTLPLogExporter behind a
BatchLogRecordProcessor, resource attributes loaded from the file named
by ``TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON``, all gated on
``TORCHFT_USE_OTEL``).  This environment ships no opentelemetry SDK, so
the exporter speaks the OTLP/HTTP **JSON** logs protocol directly
(`POST <endpoint>/v1/logs` with a `resourceLogs` document, per the OTLP
spec's stable JSON encoding) — ~100 lines of stdlib instead of an SDK
dependency, wired into the same :class:`EventExporter` registry every
other sink uses.

Pipeline shape mirrors the reference:

- **batching**: records buffer in memory and flush on a background
  thread every ``flush_interval_s`` or ``max_batch`` records, whichever
  first (the reference's BatchLogRecordProcessor);
- **resource attributes**: constructor arg, else the JSON file named by
  ``TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON`` (same env knob; the file
  maps exporter name -> attribute dict, reference otel.py:50-58);
- **console tee**: the event pipeline already tees every record to
  stdlib logging (utils/logging.py log_event), so only the OTLP leg
  lives here;
- **gating**: :func:`maybe_install_from_env` installs an exporter when
  ``TORCHFT_USE_OTEL`` is truthy, endpoint from
  ``OTEL_EXPORTER_OTLP_LOGS_ENDPOINT`` / ``OTEL_EXPORTER_OTLP_ENDPOINT``
  (the standard OTEL env vars).

Failure policy matches every sink in this framework: the collector being
down must never take down training — failed posts are dropped with a
warning and a ``dropped`` counter for tests/ops to inspect.
"""

from __future__ import annotations

import atexit
import json
import logging
import threading
import urllib.request
from typing import Any, Dict, List, Optional

from torchft_tpu_torch.utils.env import env_bool, env_str
from torchft_tpu_torch.utils.logging import EventExporter, register_exporter

logger = logging.getLogger(__name__)

TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON = "TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON"

_SEVERITY = {
    # event kind -> (OTLP severityNumber, severityText)
    # (mirror _LOGGERS in utils/logging.py when extending: an unmapped
    # kind silently exports as INFO, which buries errors)
    "quorum": (9, "INFO"),
    "commit": (9, "INFO"),
    "error": (17, "ERROR"),
    "abort": (17, "ERROR"),
    "heal": (9, "INFO"),
    "reconfigure": (9, "INFO"),
    # injected chaos faults are deliberate, but a collector should still
    # be able to alert on them leaking into a production deployment
    "fault": (13, "WARN"),
    # layout switches are planned membership responses, not errors; the
    # rolled_back outcome is surfaced via the event body + metrics
    "layout": (9, "INFO"),
}


def _any_value(v: Any) -> "Dict[str, Any]":
    """Encode a Python value as an OTLP AnyValue (JSON encoding)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # spec: int64 as JSON string
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    return {"stringValue": json.dumps(v, default=str)}


def _kv_list(attrs: "Dict[str, Any]") -> "List[Dict[str, Any]]":
    return [{"key": k, "value": _any_value(v)} for k, v in attrs.items()]


def load_resource_attributes(name: str = "torchft_tpu") -> "Dict[str, Any]":
    """Resource attrs for ``name`` from the file named by
    ``TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON`` (reference otel.py:50-58:
    the file maps logger name -> attribute dict).  Missing file/key -> {}.
    """
    path = env_str(TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON)
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        attrs = data.get(name, {}) if isinstance(data, dict) else {}
        return attrs if isinstance(attrs, dict) else {}
    except (OSError, ValueError) as e:
        logger.warning("could not load OTEL resource attributes: %s", e)
        return {}


def post_otlp(endpoint: str, body: bytes, timeout_s: float) -> None:
    """POST one OTLP JSON document; raises on non-2xx or network failure
    (callers own the drop-with-warning failure policy).  The one HTTP leg
    shared by the logs, traces, and metrics exporters."""
    req = urllib.request.Request(
        endpoint,
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        if not (200 <= resp.status < 300):
            raise OSError(f"collector returned HTTP {resp.status}")


class BatchedOTLPHTTPExporter:
    """Shared OTLP/HTTP batch pipeline (logs + traces legs subclass this;
    the metrics leg pushes snapshots instead of batching records, so it
    only shares :func:`post_otlp`).

    Records buffer in memory and flush on a daemon thread every
    ``flush_interval_s`` or ``max_batch`` records, whichever first; an
    atexit flush ships a dying replica's last batch; exports after
    ``close()`` count into ``dropped`` rather than vanishing; failed posts
    drop with a warning — a dead collector never takes down training.

    Subclasses set ``path_suffix`` and implement ``_encode(batch)``.
    """

    path_suffix = "/v1/logs"

    def __init__(
        self,
        endpoint: str,
        resource_attributes: "Optional[Dict[str, Any]]" = None,
        service_name: str = "torchft_tpu",
        max_batch: int = 64,
        flush_interval_s: float = 2.0,
        timeout_s: float = 5.0,
    ) -> None:
        self._endpoint = endpoint.rstrip("/")
        if not self._endpoint.endswith(self.path_suffix):
            self._endpoint += self.path_suffix
        if resource_attributes is None:
            resource_attributes = load_resource_attributes(service_name)
        attrs = {"service.name": service_name, **resource_attributes}
        self._resource = {"attributes": _kv_list(attrs)}
        self._max_batch = max_batch
        self._flush_interval_s = flush_interval_s
        self._timeout_s = timeout_s
        self._buf: "List[Dict[str, Any]]" = []
        self._cv = threading.Condition()
        self._closed = False
        self._posting = False
        self.exported = 0  # records acknowledged by the collector
        self.dropped = 0  # records lost (network failure or post-close)
        self._thread = threading.Thread(
            target=self._run, name="otlp_exporter", daemon=True
        )
        self._thread.start()
        # The last records of a dying replica (the abort/error that explains
        # the death) are exactly the ones an FT postmortem needs: flush the
        # buffer at interpreter exit instead of losing the final batch.
        atexit.register(self._atexit_flush)

    def export(self, record: "Dict[str, Any]") -> None:
        with self._cv:
            if self._closed:
                # a post-close export is a lost record, not a silent no-op:
                # ops dashboards alert on `dropped`
                self.dropped += 1
                return
            self._buf.append(record)
            if len(self._buf) >= self._max_batch:
                self._cv.notify()

    def _atexit_flush(self) -> None:
        if not self._closed:
            self.flush(timeout=2.0)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        try:
            atexit.unregister(self._atexit_flush)
        except Exception:  # noqa: BLE001 - interpreter-state dependent
            pass
        self._thread.join(timeout=self._timeout_s + 1.0)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until the current buffer has been posted (tests, and the
        pre-exit flush an FT system wants for its last records)."""
        import time as _t

        with self._cv:
            self._cv.notify()
        t0 = _t.monotonic()
        while True:
            with self._cv:
                if not self._buf and not self._posting:
                    return True
            if _t.monotonic() - t0 > timeout:
                return False
            _t.sleep(0.01)

    # -- internals ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._buf and not self._closed:
                    self._cv.wait(timeout=self._flush_interval_s)
                batch, self._buf = self._buf, []
                closed = self._closed
                self._posting = bool(batch)
            if batch:
                try:
                    self._post(batch)
                finally:
                    with self._cv:
                        self._posting = False
            if closed:
                return

    def _encode(self, batch: "List[Dict[str, Any]]") -> bytes:
        raise NotImplementedError

    def _post(self, batch: "List[Dict[str, Any]]") -> None:
        try:
            post_otlp(self._endpoint, self._encode(batch), self._timeout_s)
            self.exported += len(batch)
        except Exception as e:  # noqa: BLE001 - a sink never kills training
            self.dropped += len(batch)
            logger.warning(
                "OTLP export of %d record(s) to %s failed: %s",
                len(batch),
                self._endpoint,
                e,
            )


class OTLPHTTPExporter(BatchedOTLPHTTPExporter, EventExporter):
    """Batched OTLP/HTTP (JSON encoding) log exporter.

    Every structured event becomes one OTLP logRecord: ``ts`` ->
    timeUnixNano, ``kind`` -> severity + an attribute, ``message`` ->
    body, remaining extras -> attributes.
    """

    path_suffix = "/v1/logs"

    def _encode(self, batch: "List[Dict[str, Any]]") -> bytes:
        records = []
        for rec in batch:
            rec = dict(rec)
            ts = rec.pop("ts", None)
            kind = rec.pop("kind", "quorum")
            message = rec.pop("message", "")
            num, text = _SEVERITY.get(kind, (9, "INFO"))
            records.append(
                {
                    "timeUnixNano": str(int((ts or 0.0) * 1e9)),
                    "severityNumber": num,
                    "severityText": text,
                    "body": {"stringValue": str(message)},
                    "attributes": _kv_list({"event.kind": kind, **rec}),
                }
            )
        doc = {
            "resourceLogs": [
                {
                    "resource": self._resource,
                    "scopeLogs": [
                        {
                            "scope": {"name": "torchft_tpu"},
                            "logRecords": records,
                        }
                    ],
                }
            ]
        }
        return json.dumps(doc, default=str).encode()


def maybe_install_from_env() -> "Optional[OTLPHTTPExporter]":
    """Install an OTLP exporter into the event pipeline when
    ``TORCHFT_USE_OTEL`` is truthy (reference otel.py:43-44 gate).
    Endpoint: ``OTEL_EXPORTER_OTLP_LOGS_ENDPOINT``, else
    ``OTEL_EXPORTER_OTLP_ENDPOINT``, else the OTLP default
    ``http://localhost:4318``."""
    # explicit truthy whitelist: "off"/"no"/typos must NOT install an
    # exporter that spams connection-refused warnings all run
    if not env_bool("TORCHFT_USE_OTEL"):
        return None
    endpoint = (
        env_str("OTEL_EXPORTER_OTLP_LOGS_ENDPOINT")
        or env_str("OTEL_EXPORTER_OTLP_ENDPOINT")
        or "http://localhost:4318"
    )
    exporter = OTLPHTTPExporter(endpoint)
    register_exporter(exporter)
    return exporter
