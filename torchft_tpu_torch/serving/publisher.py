"""WeightPublisher: the training-side mouth of the serving tier.

PyTorch port of ``torchft_tpu/serving/publisher.py``.  ``publish``
encodes the state it is given as it is: the Manager's hook hands it a
host copy taken under the state-dict read lock, since torch updates
tensors in place.  ``last_publish`` holds the last publish's ``encode_s``,
``stage_s``, ``bytes`` and ``version``.

Snapshots committed weights (fed by ``Manager.attach_weight_publisher``
per committed step, or called directly per DiLoCo fragment/outer sync)
and publishes them as versioned, optionally int8-quantized payloads
staged in the HTTP checkpoint transport — the same zero-steady-state-
allocation wire path heal and reshard use.  When given a lighthouse
address it registers as the ``publisher`` serving role, so the
lighthouse-synthesized distribution tree roots at this process and every
serving replica learns new versions from its heartbeat replies.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Dict, Optional

from torchft_tpu_torch.checkpointing import provenance as _prov
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.serving import payload as _payload
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.env import env_float, env_int, env_str

logger = logging.getLogger(__name__)

__all__ = ["WeightPublisher"]


class WeightPublisher:
    """Publish versioned weight payloads for the serving tier.

    Args:
        lighthouse_addr: when set, a daemon thread heartbeats the
            ``publisher`` serving role (registration + freshest version
            + discovery address); without it the publisher is a
            standalone staging server reachable by explicit address.
        replica_id: serving-member id (defaults to ``publisher``).
        wire: payload wire format — ``f32`` or ``int8`` (default from
            ``TORCHFT_SERVING_QUANT``, f32 when unset).
        fragments: fragments per payload (the delta-fetch unit; align
            with the DiLoCo fragment count).  Default
            ``TORCHFT_SERVING_FRAGMENTS``.
        max_versions: staged versions retained; a publish burst never
            retires a version inside this window while clients still
            fetch it.  Default ``TORCHFT_SERVING_VERSIONS``.
        store: optional durable :class:`~torchft_tpu_torch.checkpointing.
            store.FragmentStore` — each published document's fragments
            (already-encoded wire bytes + digest manifest) also spill to
            disk via ``put_doc``, no re-encode; a spill failure degrades
            (logged + counted), never failing the publish.
    """

    def __init__(
        self,
        lighthouse_addr: "Optional[str]" = None,
        replica_id: str = "publisher",
        wire: "Optional[str]" = None,
        fragments: "Optional[int]" = None,
        max_versions: "Optional[int]" = None,
        heartbeat_interval: "Optional[float]" = None,
        store: "Optional[Any]" = None,
    ) -> None:
        self._store = store
        self._wire = wire if wire is not None else (
            env_str("TORCHFT_SERVING_QUANT") or _payload.WIRE_F32
        )
        self._fragments = (
            fragments
            if fragments is not None
            else env_int("TORCHFT_SERVING_FRAGMENTS", 1, minimum=1)
        )
        self._transport = HTTPTransport(
            max_staged=(
                max_versions
                if max_versions is not None
                else env_int("TORCHFT_SERVING_VERSIONS", 4, minimum=1)
            ),
        )
        self._replica_id = replica_id
        # _version = newest successfully STAGED version (the advertised
        # latest); _reserved = newest version number minted — reserved
        # under the lock so concurrent publishes can never share a
        # version, advertised only after its bytes are actually staged
        # (a failed publish burns its number instead of advertising a
        # version clients could never fetch).
        self._version = 0
        self._reserved = 0
        # Staleness ledger: publish wall-stamp (ms, THIS process's clock
        # — the reference clock every staleness comparison uses) of
        # _version, taken from the manifest's created_ns so the stamp
        # advertised here is bit-identical to the one relays/clients
        # read out of the fetched manifest.
        self._version_ms = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # publish() sets this so the next heartbeat (which advertises the
        # new version fleet-wide) fires immediately instead of waiting
        # out the interval — version propagation latency is one beat.
        self._nudge = threading.Event()
        self._hb_thread: "Optional[threading.Thread]" = None
        self.last_publish: "Dict[str, Any]" = {}
        self._client: Any = None
        if lighthouse_addr:
            from torchft_tpu_torch.coordination import LighthouseClient

            self._client = LighthouseClient(lighthouse_addr)
            interval = (
                heartbeat_interval
                if heartbeat_interval is not None
                else env_float("TORCHFT_SERVING_HB_S", 0.5, minimum=0.01)
            )
            self._hb_thread = threading.Thread(
                target=self._hb_loop,
                args=(interval,),
                name="tft_serving_pub_hb",
                daemon=True,
            )
            self._hb_thread.start()

    # -- discovery ---------------------------------------------------------

    def address(self) -> str:
        """HTTP base address serving ``/checkpoint/<version>/...``."""
        return self._transport.metadata()

    def latest_version(self) -> int:
        with self._lock:
            return self._version

    def latest_version_ms(self) -> int:
        """Publish wall-stamp (ms since epoch, this process's clock) of
        :meth:`latest_version` — the staleness ledger's reference point
        (0 before the first publish)."""
        with self._lock:
            return self._version_ms

    def _hb_loop(self, interval: float) -> None:
        # Pacing loop (not a retry loop): one registration heartbeat per
        # interval; RPC failures are logged and the next beat retries
        # naturally.  Event.wait doubles as the shutdown latch.
        while not self._stop.is_set():
            # provenance piggyback: consumed-on-send, handed back to the
            # registry when the RPC fails so no vector change is lost
            digest = _prov.PROV.maybe_digest(socket.gethostname())
            try:
                reply = self._client.serving_heartbeat(
                    self._replica_id,
                    self.address(),
                    role="publisher",
                    version=self.latest_version(),
                    version_ms=self.latest_version_ms(),
                    fragments=digest,
                )
                _metrics.SERVING_PLAN_EPOCH.labels(role="publisher").set(
                    reply["plan_epoch"]
                )
            except Exception as e:  # noqa: BLE001 - keep beating
                _prov.PROV.restore_digest(digest)
                logger.warning("serving heartbeat failed: %s", e)
            self._nudge.wait(interval)
            self._nudge.clear()

    # -- publication -------------------------------------------------------

    def publish(
        self,
        state_dict: Any,
        version: "Optional[int]" = None,
        timeout: float = 60.0,
    ) -> int:
        """Publish ``state_dict`` as the next (or given) weight version;
        returns the version number staged.  Versions must be monotone —
        the version key IS the fetch coordinate."""
        with self._lock:
            v = self._reserved + 1 if version is None else int(version)
            if v <= self._reserved:
                raise ValueError(
                    f"serving version must be monotone: {v} <= "
                    f"{self._reserved}"
                )
            # Reserve INSIDE the lock: two concurrent publish() calls
            # must never mint the same version (same version = same
            # bytes everywhere is the tier's core invariant).
            self._reserved = v
        _faults.check("serving.publish", replica=self._replica_id, step=v)
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        doc = _payload.encode_payload(
            state_dict, v, wire=self._wire, fragments=self._fragments
        )
        t_enc = time.perf_counter()
        self._transport.send_checkpoint([], v, doc, timeout=timeout)
        t_stage = time.perf_counter()
        # Durable spill hook: the staged document already holds every
        # fragment's wire bytes + the digest manifest, so the spill is
        # pure disk writes (deduped by digest) — publish() runs on the
        # manager's single publish worker, already off the training hot
        # path.  Failures degrade and are counted by the store.
        if self._store is not None:
            try:
                self._store.put_doc(doc)
            except Exception as e:  # noqa: BLE001 - spill never fails publish
                _metrics.STORE_SPILL_FAILURES.inc()
                logger.warning("durable spill of v%s failed: %s", v, e)
        # Staleness ledger: the manifest's created_ns IS the publish
        # stamp — advertised here and carried in the payload, so every
        # tier reads the same number.
        v_ms = int(
            doc[f"frag:{_payload.MANIFEST_FRAG}"].get("created_ns", 0)
            // 1_000_000
        )
        # provenance: the publisher is the origin holder — its manifest
        # stamp is the reference clock every fleet staleness row uses
        manifest = doc[f"frag:{_payload.MANIFEST_FRAG}"]
        p_digests = manifest.get("digests") or {}
        for name in manifest.get("fragments") or ():
            _prov.note_hold(
                _prov.frag_id("weights", name), v,
                p_digests.get(name, ""), version_ms=v_ms,
                role="publisher", publisher=True,
            )
        with self._lock:
            if v > self._version:
                self._version = v
                self._version_ms = v_ms
        # Advertise synchronously: when publish() returns, the version is
        # discoverable fleet-wide (a lighthouse hiccup degrades to the
        # background beat rather than failing the publish).
        if self._client is not None:
            try:
                self._client.serving_heartbeat(
                    self._replica_id, self.address(),
                    role="publisher", version=v, version_ms=v_ms,
                )
            except Exception as e:  # noqa: BLE001 - next beat re-advertises
                logger.warning("serving publish advertise failed: %s", e)
                self._nudge.set()
        # publisher-role staleness = publish->advertise lag on the
        # publisher's own clock (encode + staging + the advertise RPC)
        if v_ms > 0:
            _metrics.SERVING_STALENESS.labels(role="publisher").observe(
                max(time.time() - v_ms / 1e3, 0.0)
            )
        dt = time.perf_counter() - t0
        self.last_publish = {
            "version": v,
            "encode_s": t_enc - t0,
            "stage_s": t_stage - t_enc,
            "bytes": sum(
                len(doc[f"frag:{n}"]) for n in manifest.get("fragments") or ()
            ),
        }
        _metrics.SERVING_PUBLISHES.labels(wire=self._wire).inc()
        _metrics.SERVING_PUBLISH_SECONDS.labels(wire=self._wire).observe(dt)
        _metrics.SERVING_VERSION.labels(role="publisher").set(v)
        _flightrec.record(
            "serving.publish", start_ns=t0_ns, step=v, wire=self._wire,
            fragments=self._fragments,
        )
        tracer = _tracing.get_tracer()
        ctx = _tracing.get_current()
        if tracer is not None and ctx is not None and ctx.sampled:
            tracer.export_span(
                name="serving.publish",
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=t0_ns,
                end_ns=time.time_ns(),
                attributes={"version": v, "wire": self._wire},
            )
        return v

    def retire(self, version: int) -> None:
        """Explicitly drop one staged version (normally the bounded
        staging window retires oldest-first on its own)."""
        self._transport.retire_checkpoint(version)

    def staged_versions(self) -> "list[int]":
        return self._transport.staged_steps()

    def shutdown(self) -> None:
        self._stop.set()
        self._nudge.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        if self._client is not None:
            self._client.close()
        self._transport.shutdown()
