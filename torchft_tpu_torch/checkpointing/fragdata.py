"""Native zero-copy fragment data plane — the Python control side.

PyTorch port of ``torchft_tpu/checkpointing/fragdata.py``, over the port's
``_native.py`` (the same ``native/`` library).

The C++ server/client pair in ``native/fragserver.{h,cc}`` owns the
fragment *data* plane: staged payload bytes are served verbatim via
writev out of pooled registered buffers (zero user-space copies
steady-state), and the receive path lands bytes straight into this
process's bufpool buffers and sha256-digests them with the GIL released
(ctypes drops it around every native call).  Python keeps the *control*
plane: plans, manifests, digests-of-record, staging lifecycle, version
advertisement, and ALL telemetry (fault sites, linkstats, provenance,
wire-shaper charging, flight/span records stay in ``fragments.py``).

Wiring:

- ``HTTPTransport`` owns one :class:`FragDataServer` per transport and
  mirrors its raw ``frag:*`` staging into it (begin/stage/finish/retire)
  — the handoff contract in docs/architecture.md;
- the Python HTTP server advertises the native data port at
  ``/nativeport`` (404 = this node serves fragments from Python only);
- ``fragments.fetch_raw`` dispatches raw ``frag_*`` GETs through
  :func:`fetch_native` behind the ``TORCHFT_FRAG_NATIVE`` gate (default
  on when the ``.so`` is present), falling back to the Python path on
  any native miss — Mock transports, non-mirrored resources, and
  gated-off peers keep working unchanged.
"""

from __future__ import annotations

import ctypes
import http.client
import json
import threading
import urllib.error
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from torchft_tpu_torch.utils.bufpool import POOL
from torchft_tpu_torch.utils.env import env_bool

__all__ = [
    "FragDataServer",
    "available",
    "enabled",
    "fetch_native",
    "native_sha256",
    "reset_port_cache",
]

_gate_lock = threading.Lock()
_lib_ok: "Optional[bool]" = None

_U8P = None  # lazily bound ctypes.POINTER(c_uint8)


def _native_lib():
    from torchft_tpu_torch import _native

    return _native.get_lib()


def available() -> bool:
    """True when the native library loads and exposes the fragment C API
    (cached — the first call may trigger the in-place native build)."""
    global _lib_ok
    if _lib_ok is None:
        with _gate_lock:
            if _lib_ok is None:
                try:
                    _lib_ok = bool(
                        hasattr(_native_lib(), "tft_frag_server_create")
                    )
                except Exception:
                    _lib_ok = False
    return bool(_lib_ok)


def enabled() -> bool:
    """The ``TORCHFT_FRAG_NATIVE`` gate: default on when the native
    library is present; ``0`` forces the pure-Python data plane (Mock
    transports, mixed-fleet interop, fallback tests).  Read per call so
    tests can flip the knob without reimporting."""
    if not env_bool("TORCHFT_FRAG_NATIVE", True):
        return False
    return available()


def _u8ptr(arr: np.ndarray):
    global _U8P
    if _U8P is None:
        _U8P = ctypes.POINTER(ctypes.c_uint8)
    return arr.ctypes.data_as(_U8P)


class FragDataServer:
    """Lifecycle wrapper for one native fragment data server.

    ``HTTPTransport`` drives it with the staging handoff contract:
    ``begin(step)`` opens a streaming version, ``stage()`` hands one raw
    payload down (the native side copies ONCE into a pooled registered
    buffer and wakes parked long-pollers), ``finish(step)`` seals the
    version, ``retire(step)`` drops it (non-blocking: buffers referenced
    by in-flight serves are recycled on last deref)."""

    def __init__(self, bind_host: str = "") -> None:
        lib = _native_lib()
        handle = lib.tft_frag_server_create(bind_host.encode(), 0)
        if handle < 0:
            from torchft_tpu_torch import _native

            raise RuntimeError(
                f"native fragserver create failed: {_native.last_error()}"
            )
        self._lib = lib
        self._handle = handle
        self.port = int(lib.tft_frag_server_port(handle))

    def begin(self, step: int) -> None:
        self._lib.tft_frag_begin(self._handle, int(step))

    def stage(self, step: int, resource: str, value) -> bool:
        """Mirror one raw wire-bytes payload; returns False when the
        version is unknown/retired (not mirrored — Python still owns
        serving it)."""
        mv = memoryview(value)
        if not mv.c_contiguous:
            return False
        arr = (
            np.frombuffer(mv, dtype=np.uint8)
            if mv.nbytes
            else np.empty(0, dtype=np.uint8)
        )
        rc = self._lib.tft_frag_stage(
            self._handle,
            int(step),
            resource.encode(),
            _u8ptr(arr),
            arr.nbytes,
        )
        return rc == 0

    def finish(self, step: int) -> None:
        self._lib.tft_frag_finish(self._handle, int(step))

    def retire(self, step: int) -> None:
        self._lib.tft_frag_retire(self._handle, int(step))

    def counters(self) -> "Dict[str, int]":
        from torchft_tpu_torch import _native

        ptr = self._lib.tft_frag_counters(self._handle)
        return json.loads(_native.take_string(ptr))

    def inject(self, mode: str, param_ms: int = 0, count: int = 0) -> None:
        """Chaos hook: the next ``count`` data requests ``drop`` (close
        mid-exchange) or ``delay`` ``param_ms`` before the body."""
        rc = self._lib.tft_frag_inject(
            self._handle, mode.encode(), int(param_ms), int(count)
        )
        if rc != 0:
            raise ValueError(f"bad inject mode: {mode}")

    def shutdown(self) -> None:
        if self._handle >= 0:
            self._lib.tft_server_shutdown(self._handle)
            self._handle = -1


# ---- client-side endpoint resolution --------------------------------------
# One control round trip per base: GET /nativeport on the Python control
# server names the data port (404 = python-only node, cached; transport
# errors are NOT cached so a transient outage can't pin a peer to the
# slow path forever).

_ports_lock = threading.Lock()
_ports: "Dict[str, Optional[int]]" = {}


def reset_port_cache() -> None:
    """Test hook: forget resolved data ports (transports are ephemeral
    in-process, so a stale positive entry can otherwise outlive its
    server across test cases)."""
    with _ports_lock:
        _ports.clear()


def _drop_port(base: str) -> None:
    """Invalidate one cached data-port mapping (the peer restarted, or
    an ephemeral-port collision aliased a dead native server onto a new
    transport's control port) — the next fetch re-resolves."""
    with _ports_lock:
        _ports.pop(base, None)


def _resolve_port(base: str, timeout: float) -> "Optional[int]":
    with _ports_lock:
        if base in _ports:
            return _ports[base]
    u = urlparse(base)
    port: "Optional[int]" = None
    cache = False
    try:
        conn = http.client.HTTPConnection(
            u.hostname or "127.0.0.1",
            u.port or 80,
            timeout=max(timeout, 0.05),
        )
        try:
            conn.request("GET", "/nativeport")
            resp = conn.getresponse()
            body = resp.read()
            cache = True  # a definitive control-plane answer either way
            if resp.status == 200:
                port = int(body.strip() or b"0") or None
        finally:
            conn.close()
    except (OSError, ValueError, http.client.HTTPException):
        port = None
    if cache:
        with _ports_lock:
            if len(_ports) > 4096:
                _ports.clear()
            _ports[base] = port
    return port


def fetch_native(
    base: str, version: int, resource: str, timeout: float
) -> "Optional[Tuple[np.ndarray, str, float]]":
    """Try the native data plane for one raw fragment GET.

    Returns ``(pooled uint8 buffer, sha256 hex, first_byte_seconds)`` on
    success; ``None`` when the caller should fall back to the Python
    path (peer has no native server, the fragment isn't mirrored there,
    or the data connection failed — a transport error also invalidates
    the cached port so a stale mapping cannot pin the slow path).
    Raises ``urllib.error.HTTPError(503)`` for retryable-busy (the
    cut-through long-poll contract) — exactly the exception surface the
    fragment retry policy already handles."""
    port = _resolve_port(base, timeout)
    if port is None:
        return None
    lib = _native_lib()
    u = urlparse(base)
    addr = f"{u.hostname or '127.0.0.1'}:{port}".encode()
    n = ctypes.c_int64(0)
    fb = ctypes.c_double(0.0)
    timeout_ms = max(int(timeout * 1000), 1)
    rc = lib.tft_frag_fetch_begin(
        addr,
        int(version),
        resource.encode(),
        timeout_ms,
        ctypes.byref(n),
        ctypes.byref(fb),
    )
    if rc == 503:
        raise urllib.error.HTTPError(
            f"{base}/checkpoint/{version}/{resource}",
            503,
            "native fragment still streaming",
            None,  # type: ignore[arg-type]
            None,
        )
    if rc < 0:
        _drop_port(base)
        return None  # transport error: Python path decides (it shares
        # the peer's fate — a live peer serves, a dead one raises the
        # URLError the retry/failover ladder already handles)
    if rc != 200:
        return None  # 404 (or anything unexpected): Python owns this one
    nbytes = int(n.value)
    buf = POOL.take(nbytes, np.uint8)
    sha = ctypes.create_string_buffer(65)
    # ctypes releases the GIL here: body receive + sha256 over the wire
    # buffer run native while other Python threads keep executing
    rc = lib.tft_frag_fetch_body(_u8ptr(buf), nbytes, sha, timeout_ms)
    if rc != 0:
        POOL.give(buf)
        _drop_port(base)
        return None  # connection died mid-body: refetch via Python
    return buf, sha.value.decode(), float(fb.value)


def native_sha256(buf) -> "Optional[str]":
    """sha256 hex of one buffer via the native kernel (GIL released), or
    None when the native library is unavailable."""
    if not available():
        return None
    mv = memoryview(buf)
    if not mv.c_contiguous:
        return None
    arr = (
        np.frombuffer(mv, dtype=np.uint8)
        if mv.nbytes
        else np.empty(0, dtype=np.uint8)
    )
    out = ctypes.create_string_buffer(65)
    if _native_lib().tft_sha256_hex(_u8ptr(arr), arr.nbytes, out) != 0:
        return None
    return out.value.decode()
