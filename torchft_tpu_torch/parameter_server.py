"""Fault-tolerant parameter server built on reconfigurable ProcessGroups.

PyTorch port of ``torchft_tpu/parameter_server.py`` (reference:
torchft/parameter_server.py:31-195): the server runs a tiny HTTP endpoint;
``GET /new_session`` mints a uuid session, replies with a per-session
rendezvous store prefix, then *hijacks the handler thread* to configure a
fresh 2-rank ProcessGroup (server rank 0, client rank 1) and hand it to the
abstract ``forward`` — one thread per live session, no Lighthouse required.

Differences by design: rendezvous uses the C++ StoreServer
(``torchft_tpu_torch.coordination``) instead of torch TCPStore, and the
exchanged payloads go through the port's host-mediated process groups
(``ProcessGroupTCP`` or ``ProcessGroupBabyTCP``): CUDA tensors cross to the
host inside the PG, as in every other collective of the port.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.parallel.process_group import ProcessGroup, _routable_local_ip
from torchft_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

# Session-mint retry: the server may still be binding (rolling restart)
# or briefly saturated — poll connection-level failures and retryable
# 503s with jittered backoff inside the caller's deadline.  A 400 (bad
# path) or any other HTTP error is permanent and fails immediately.
_SESSION_POLICY = RetryPolicy(
    name="parameter_server.new_session",
    base_delay=0.05,
    multiplier=2.0,
    max_delay=1.0,
    retry_if=lambda e: (
        e.code == 503
        if isinstance(e, urllib.error.HTTPError)
        else isinstance(e, (urllib.error.URLError, ConnectionError, OSError))
    ),
)


class ParameterServer(ABC):
    """Threaded parameter server over the FT collective layer.

    Subclasses implement :meth:`new_process_group` (an unconfigured PG,
    e.g. ``ProcessGroupTCP``) and :meth:`forward` (the per-session serving
    loop). Reference: torchft/parameter_server.py:31-128.
    """

    #: How long :meth:`shutdown` waits for its sessions' threads to end.
    SHUTDOWN_JOIN_S = 30.0

    def __init__(self, port: int = 0, store_port: int = 0) -> None:
        self._store = StoreServer(bind=f":{store_port}")
        # live sessions: id -> (its handler thread, its PG); closed once
        # shutdown begins, so no session starts after it
        self._sessions: "Dict[str, Tuple[threading.Thread, Optional[ProcessGroup]]]" = {}
        self._sessions_lock = threading.Lock()
        self._closing = False

        ps = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug("ps http: " + fmt, *args)

            def do_GET(self) -> None:
                if self.path != "/new_session":
                    self.send_response(400)
                    self.send_header("Content-type", "text/plain")
                    self.end_headers()
                    self.wfile.write(b"invalid path\n")
                    return

                session_id = str(uuid.uuid4())
                store_addr = f"{ps._store.address()}/session/{session_id}"
                logger.info("creating new session %s", session_id)

                body = json.dumps(
                    {"session_id": session_id, "store_addr": store_addr}
                ).encode()
                self.send_response(200)
                self.send_header("Content-type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                # Content-Length lets the client complete the request while
                # this thread stays hijacked as the session's serving thread.
                self.wfile.flush()
                self.close_connection = True

                try:
                    ps._handle_session(session_id, store_addr)
                except Exception:
                    if ps._closing:
                        logger.info("session %s ended by shutdown", session_id)
                    else:
                        logger.exception("session %s failed", session_id)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=lambda: self._server.serve_forever(poll_interval=0.05),
            name="tft_param_server",
            daemon=True,
        )
        self._thread.start()
        logger.info("started ParameterServer on %s", self.address())

    def address(self) -> str:
        """HTTP address to create a new session: ``http://host:port/new_session``."""
        port = self._server.socket.getsockname()[1]
        # hostnames aren't guaranteed resolvable across hosts/containers;
        # advertise the interface that routes to our own store
        host = _routable_local_ip(self._store.address())
        return f"http://{host}:{port}/new_session"

    def shutdown(self) -> None:
        """Stop minting, end every session, then stop the store.

        A session's thread may wait in its PG's ``configure`` (a store
        ``get`` for its client, which may never come) or in ``forward``.
        Each PG is aborted, again until its thread ends (an abort that
        lands before ``configure`` starts is undone by it), and the threads
        are joined within ``SHUTDOWN_JOIN_S``; only then is the native store
        stopped.  Stopping it under a waiting ``get`` could kill the
        process: the JAX ``ParameterServer`` keeps that order."""
        self._server.shutdown()
        self._server.server_close()
        with self._sessions_lock:
            self._closing = True
        deadline = time.monotonic() + self.SHUTDOWN_JOIN_S
        while True:
            # read on every pass: a session that registered before the close
            # may get its PG only now
            with self._sessions_lock:
                alive = [(t, pg) for t, pg in self._sessions.values() if t.is_alive()]
            if not alive or time.monotonic() >= deadline:
                break
            for _, pg in alive:
                if pg is not None:
                    pg.abort()
            alive[0][0].join(0.2)
        if alive:
            logger.warning("session threads %s still running at shutdown",
                           [t.name for t, _ in alive])
        self._store.shutdown()

    # -- session plumbing --------------------------------------------------

    def _handle_session(self, session_id: str, store_addr: str) -> None:
        me = threading.current_thread()
        with self._sessions_lock:
            if self._closing:
                return
            self._sessions[session_id] = (me, None)
        try:
            pg = self.new_process_group()
            with self._sessions_lock:
                self._sessions[session_id] = (me, pg)
            # server is always rank 0 (reference parameter_server.py:170-175)
            pg.configure(store_addr, replica_id="0", rank=0, world_size=2)
            try:
                self.forward(session_id, pg)
            finally:
                pg.shutdown()
        finally:
            with self._sessions_lock:
                self._sessions.pop(session_id, None)

    @classmethod
    def new_session(cls, address: str, timeout: float = 30.0) -> ProcessGroup:
        """Client side: mint a session and return a configured PG (rank 1).

        The mint request runs under the unified retry layer
        (``_SESSION_POLICY``): connection failures and retryable 503s
        are polled with jittered backoff until ``timeout``; permanent
        HTTP errors fail immediately."""

        def attempt(budget: "Optional[float]") -> dict:
            t = max(budget if budget is not None else 0.001, 0.001)
            with urllib.request.urlopen(address, timeout=t) as f:
                return json.load(f)

        data = _SESSION_POLICY.run(
            attempt, timeout=timeout, op="parameter_server.new_session"
        )

        logger.info(
            "connecting to session %s at %s", data["session_id"], data["store_addr"]
        )
        pg = cls.new_process_group()
        # client is always rank 1 (reference parameter_server.py:148-168)
        pg.configure(data["store_addr"], replica_id="0", rank=1, world_size=2)
        return pg

    # -- to implement ------------------------------------------------------

    @classmethod
    @abstractmethod
    def new_process_group(cls) -> ProcessGroup:
        """A new *unconfigured* ProcessGroup for one session's pair."""

    @abstractmethod
    def forward(self, session_id: str, pg: ProcessGroup) -> None:
        """Per-session serving loop, called on a dedicated thread.

        Server rank is 0, client rank is 1; loop over ops (e.g. recv grads,
        broadcast params) until the client disconnects — a failed collective
        raises, the PG is freed, and the client must open a new session.
        """
