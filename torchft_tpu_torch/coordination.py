"""Coordination API: native servers + protocol clients.

Public low-level surface for building custom fault-tolerance algorithms,
analog of reference torchft/coordination.py:18-33 (which re-exports the Rust
Lighthouse/Manager client+server classes).  Servers run native C++ threads
(see ``native/``); clients speak the framed-JSON protocol directly from
Python — socket waits release the GIL, mirroring the reference's
GIL-releasing PyO3 calls (reference: src/lib.rs:153-281).

Wire format: 4-byte big-endian length + UTF-8 JSON.
Request: ``{"method": ..., "params": {...}, "timeout_ms": N,
"traceparent": "00-<trace>-<span>-<flags>"?}`` — the optional
``traceparent`` envelope field carries the distributed-tracing context
(utils/tracing.py); servers continue it into one ``rpc.<method>`` span
per request and propagate it on their own downstream RPCs.
Response: ``{"ok": true, "result": {...}}`` or
``{"ok": false, "error": msg, "code": "timeout"?}``.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

from torchft_tpu_torch import _native
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import linkstats as _linkstats
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils import tracing as _tracing
from torchft_tpu_torch.utils.env import env_bool
from torchft_tpu_torch.utils.retry import RetryPolicy

__all__ = [
    "LighthouseServer",
    "LighthouseClient",
    "ManagerServer",
    "ManagerClient",
    "StoreServer",
    "StoreClient",
    "NotLeaderError",
    "Quorum",
    "QuorumMember",
    "QuorumResult",
    "parse_endpoints",
]


def _to_ms(timeout: "float | timedelta") -> int:
    if isinstance(timeout, timedelta):
        return int(timeout.total_seconds() * 1000)
    return int(timeout * 1000)


# ---------------------------------------------------------------------------
# data types (mirror reference proto/torchft.proto:37-53 and _torchft.pyi)
# ---------------------------------------------------------------------------


@dataclass
class QuorumMember:
    replica_id: str
    address: str = ""
    store_address: str = ""
    step: int = 0
    world_size: int = 1
    shrink_only: bool = False
    commit_failures: int = 0
    # Online parallelism switching (parallel/layout.py): the member's
    # current/staged layout epoch — the monotone counter the two-phase
    # layout commit is keyed on (docs/protocol.md "Layout epochs").
    layout_epoch: int = 0
    data: str = ""

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuorumMember":
        """Build from the wire-protocol dict (tolerates missing fields)."""
        return QuorumMember(
            replica_id=d.get("replica_id", ""),
            address=d.get("address", ""),
            store_address=d.get("store_address", ""),
            step=d.get("step", 0),
            world_size=d.get("world_size", 1),
            shrink_only=d.get("shrink_only", False),
            commit_failures=d.get("commit_failures", 0),
            layout_epoch=d.get("layout_epoch", 0),
            data=d.get("data", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        """Wire-protocol dict for RPC payloads."""
        return {
            "replica_id": self.replica_id,
            "address": self.address,
            "store_address": self.store_address,
            "step": self.step,
            "world_size": self.world_size,
            "shrink_only": self.shrink_only,
            "commit_failures": self.commit_failures,
            "layout_epoch": self.layout_epoch,
            "data": self.data,
        }


@dataclass
class Quorum:
    quorum_id: int
    participants: List[QuorumMember] = field(default_factory=list)
    created_ms: int = 0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Quorum":
        """Build from the wire-protocol dict."""
        return Quorum(
            quorum_id=d.get("quorum_id", 0),
            participants=[QuorumMember.from_dict(p) for p in d.get("participants", [])],
            created_ms=d.get("created_ms", 0),
        )


@dataclass
class QuorumResult:
    """Per-replica instructions computed from a cluster quorum.

    Field parity with reference torchft/_torchft.pyi QuorumResult.
    """

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 1
    recover_src_manager_address: str = ""
    recover_src_replica_rank: Optional[int] = None
    recover_dst_replica_ranks: List[int] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_replica_rank: Optional[int] = None
    max_world_size: int = 1
    heal: bool = False
    commit_failures: int = 0
    # Online parallelism switching (parallel/layout.py): the min/max
    # layout epoch reported across the quorum (min == max == E is the
    # fleet-wide commit signal for a staged layout at epoch E) and the
    # participant roster in replica-rank order — each entry carries
    # replica_id, manager address, layout_epoch and the opaque shard
    # manifest, which is what lets every group compute the same reshard
    # slice-diff plan with zero extra RPCs.
    max_layout_epoch: int = 0
    min_layout_epoch: int = 0
    # roster entries are {replica_id, address, layout_epoch, data} dicts
    participants: List[Any] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuorumResult":
        """Build from the wire-protocol dict."""
        return QuorumResult(
            quorum_id=d.get("quorum_id", 0),
            replica_rank=d.get("replica_rank", 0),
            replica_world_size=d.get("replica_world_size", 1),
            recover_src_manager_address=d.get("recover_src_manager_address", ""),
            recover_src_replica_rank=d.get("recover_src_replica_rank"),
            recover_dst_replica_ranks=list(d.get("recover_dst_replica_ranks", [])),
            store_address=d.get("store_address", ""),
            max_step=d.get("max_step", 0),
            max_replica_rank=d.get("max_replica_rank"),
            max_world_size=d.get("max_world_size", 1),
            heal=d.get("heal", False),
            commit_failures=d.get("commit_failures", 0),
            max_layout_epoch=d.get("max_layout_epoch", 0),
            min_layout_epoch=d.get("min_layout_epoch", 0),
            participants=list(d.get("participants", [])),
        )


# ---------------------------------------------------------------------------
# protocol client
# ---------------------------------------------------------------------------


def parse_host_port(addr: str) -> "tuple[str, int]":
    """Split "host:port" (including "[v6]:port" and ":port") — the one
    address parser shared by every client/probe in the package."""
    if addr.startswith("["):
        host, _, port = addr[1:].partition("]:")
        return host, int(port)
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def parse_endpoints(addrs: str) -> "List[str]":
    """Split a ``TORCHFT_LIGHTHOUSE`` value into endpoint addresses:
    ``"host1:p1,host2:p2,host3:p3"`` -> ``["host1:p1", ...]`` (whitespace
    around entries tolerated; empty entries dropped).  A single-address
    value parses to a one-element list — every lighthouse client accepts
    both forms (coordination-plane HA, docs/architecture.md)."""
    return [part.strip() for part in addrs.split(",") if part.strip()]


class RpcError(RuntimeError):
    pass


class NotLeaderError(RpcError):
    """A follower lighthouse peer declined a leader-only method
    (coordination-plane HA).  ``leader`` is the follower's freshest hint
    for the current lease holder ("" when it knows none) — failover
    clients jump straight to it instead of walking the whole list."""

    def __init__(self, message: str, leader: str = "") -> None:
        super().__init__(message)
        self.leader = leader


#: Frame-size ceiling shared with the native side (native/net.h
#: kMaxFrameBytes): a reply header claiming more is a corrupt or hostile
#: peer, not a large message — fail the connection instead of trying to
#: buffer gigabytes.
_MAX_FRAME_BYTES = 512 * 1024 * 1024


# Connect retry: the same curve the old ad-hoc loop used (100ms base,
# x1.5, 10s cap) plus full jitter so replicas re-dialing a restarted
# server do not dogpile it in lockstep.  Retryable: any OSError (refused,
# unreachable, per-attempt socket timeout) until the deadline budget —
# the budget, not the attempt count, bounds the wait.
_CONNECT_POLICY = RetryPolicy(
    name="rpc.connect",
    base_delay=0.1,
    multiplier=1.5,
    max_delay=10.0,
    retryable=(OSError,),
)


class _RpcClient:
    """Persistent framed-JSON connection; reconnects with backoff on failure.

    ``fault_site``: optional chaos injection site consulted inside each
    call's send/recv attempt (utils/faults.py) — an injected ``drop`` takes
    exactly the broken-connection code path, an injected ``raise`` escapes
    like any non-connection error.
    """

    def __init__(
        self,
        addr: str,
        connect_timeout: float = 10.0,
        fault_site: "Optional[str]" = None,
        resolve: "Optional[Callable[[], str]]" = None,
    ) -> None:
        self._connect_timeout = connect_timeout
        self._fault_site = fault_site
        # ``resolve``: where the server is published now; asked after each
        # refused connect and each broken connection, so a client wired to
        # a server that moved (a restarted one) follows it within one
        # connect budget
        self._resolve = resolve
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._set_addr(addr)

    def _set_addr(self, addr: str) -> None:
        from torchft_tpu_torch.utils.hostident import local_host_identities

        self._addr = addr
        # link-state plane (utils/linkstats.py): every round trip on this
        # connection is one rpc-plane RTT sample against the peer host —
        # resolved once per address, not per call
        host, _port = parse_host_port(addr)
        self._link_host = host or "unknown"
        self._link_local = self._link_host in local_host_identities()

    def _host_port(self) -> "tuple[str, int]":
        return parse_host_port(self._addr)

    def _follow(self) -> None:
        """After a refused connect or a broken connection: take the address
        ``resolve`` returns (a resolver that fails leaves the address as it
        is)."""
        try:
            addr = self._resolve()  # type: ignore[misc]
        except Exception:  # noqa: BLE001 - keep dialing the old address
            return
        if addr and addr != self._addr:
            self._set_addr(addr)

    def _connect(self, deadline: float) -> socket.socket:
        def attempt(budget: "Optional[float]") -> socket.socket:
            host, port = self._host_port()
            try:
                sock = socket.create_connection(
                    (host, port), timeout=min(budget if budget else 5.0, 5.0)
                )
            except OSError:
                if self._resolve is not None:
                    self._follow()
                raise
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock

        try:
            return _CONNECT_POLICY.run(
                attempt,
                timeout=max(deadline - time.monotonic(), 0.0),
                op="rpc.connect",
            )
        except TimeoutError as e:
            raise TimeoutError(
                f"timeout connecting to {self._addr}: {e.__cause__ or e}"
            ) from e

    def call(
        self,
        method: str,
        params: Dict[str, Any],
        timeout: "float | timedelta",
        idempotent: bool = True,
    ) -> Dict[str, Any]:
        """One RPC round trip.

        ``idempotent``: when True (default) a call that dies on a broken
        connection is re-sent ONCE after reconnecting (e.g. the server
        restarted between calls on this pooled connection).  A re-send can
        double-deliver a request whose first copy was applied before the
        connection died, so non-idempotent methods — ``should_commit``
        votes, whose double delivery could corrupt the commit barrier —
        must pass False and surface the ConnectionError to their caller
        instead.
        """
        timeout_s = (
            timeout.total_seconds() if isinstance(timeout, timedelta) else timeout
        )
        deadline = time.monotonic() + timeout_s
        attempts = 2 if idempotent else 1
        # Pooled-connection lock: one in-flight request per connection IS
        # the contract; callers queue on the round trip by design, and
        # every socket op under it is deadline-bounded (settimeout above
        # each send/recv) — hence the lint waiver.
        # Distributed tracing: the current context (bound by the Manager
        # around its round) rides the request envelope; None when tracing
        # is off or the step is unsampled — the disabled path is one
        # module-global check (budget-tested in tests/test_tracing.py).
        traceparent = _tracing.current_traceparent()
        # Opt-in WAN realism for coordination RPCs (TORCHFT_WIRE_RPC=1):
        # one serving-wire-model charge per round trip — first-byte RTT
        # across the TORCHFT_TOPOLOGY boundary (payloads are sub-KB, so
        # bandwidth debt is noise; nbytes=0 skips the bucket).  Scope:
        # the Python client side only — native peer-to-peer traffic
        # (lease exchanges, C++ heartbeats) is in-process and unshaped.
        # Default off (one env test per call; the bench flips it
        # mid-process, so it cannot be latched at import); the serving
        # import resolves lazily only when enabled.
        charged = 0.0
        if env_bool("TORCHFT_WIRE_RPC", False):
            from torchft_tpu_torch.serving import wire as _serving_wire

            charged = _serving_wire.get_shaper().charge(self._addr, 0)
        with self._lock:  # tft-lint: allow(lock-discipline)
            for attempt in range(attempts):
                if self._sock is None:
                    self._sock = self._connect(
                        min(deadline, time.monotonic() + self._connect_timeout)
                    )
                req: "Dict[str, Any]" = {
                    "method": method,
                    "params": params,
                    "timeout_ms": max(int((deadline - time.monotonic()) * 1000), 1),
                }
                if traceparent is not None:
                    req["traceparent"] = traceparent
                payload = json.dumps(req).encode()
                try:
                    if self._fault_site is not None:
                        _faults.check(self._fault_site)
                    self._sock.settimeout(max(deadline - time.monotonic(), 0.001))
                    t0 = time.perf_counter()
                    self._sock.sendall(struct.pack(">I", len(payload)) + payload)
                    reply = self._recv_frame(deadline)
                    # rpc-plane link sample: one RTT per round trip (the
                    # whole wall IS first-byte — sub-KB payloads carry no
                    # bandwidth signal, so goodput stays unestimated on
                    # this plane).  A shaped (TORCHFT_WIRE_RPC) call to a
                    # local host keys under a WAN pseudo-host so the
                    # modeled link never averages into the local fabric.
                    rtt = charged + (time.perf_counter() - t0)
                    wan_local = charged > 0.0 and self._link_local
                    _linkstats.record(
                        self._link_host + "#wan" if wan_local
                        else self._link_host,
                        "rpc",
                        len(payload) + len(reply),
                        rtt,
                        first_byte_s=rtt,
                        local=self._link_local and charged == 0.0,
                    )
                    break
                except (OSError, ConnectionError) as e:
                    self.close()
                    if isinstance(e, socket.timeout):
                        raise TimeoutError(
                            f"rpc {method} to {self._addr} timed out: {e}"
                        ) from e
                    failed_at = self._addr
                    if self._resolve is not None:
                        # a connection that broke may have reached another
                        # process's listener on a moved server's old port
                        self._follow()
                    if attempt == attempts - 1:
                        # Connection-level failure, not a deadline: report it
                        # as such so callers can tell a crashed server from a
                        # protocol wait expiring.
                        raise ConnectionError(
                            f"rpc {method} to {failed_at} failed: {e}"
                        ) from e
                    # Broken connection (e.g. server restarted): retry once.
                    continue
            # A reply that does not parse to a JSON object is a protocol
            # violation (corrupt frame, non-UTF8 bytes, wrong peer): fail
            # the call cleanly and drop the connection so the next call
            # starts fresh instead of desynchronizing on this one.
            try:
                resp = json.loads(reply)
            except (UnicodeDecodeError, ValueError) as e:
                self.close()
                raise RpcError(
                    f"rpc {method} to {self._addr}: malformed reply frame: {e}"
                ) from e
            if not isinstance(resp, dict):
                self.close()
                raise RpcError(
                    f"rpc {method} to {self._addr}: reply is not a JSON "
                    f"object: {type(resp).__name__}"
                )
            if not resp.get("ok"):
                if resp.get("code") == "timeout":
                    raise TimeoutError(resp.get("error", "timeout"))
                if resp.get("code") == "not_leader":
                    raise NotLeaderError(
                        resp.get("error", "not the leader"),
                        leader=resp.get("leader", ""),
                    )
                raise RpcError(resp.get("error", "rpc failed"))
            return resp.get("result", {})

    def _recv_frame(self, deadline: float) -> bytes:
        assert self._sock is not None
        header = self._recv_exact(4, deadline)
        (length,) = struct.unpack(">I", header)
        if length > _MAX_FRAME_BYTES:
            raise ConnectionError(
                f"frame length {length} exceeds the {_MAX_FRAME_BYTES}-byte "
                f"protocol ceiling (corrupt or non-protocol peer)"
            )
        return self._recv_exact(length, deadline)

    def _recv_exact(self, n: int, deadline: float) -> bytes:
        assert self._sock is not None
        buf = b""
        while len(buf) < n:
            self._sock.settimeout(max(deadline - time.monotonic(), 0.001))
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed by peer")
            buf += chunk
        return buf

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


#: Per-hop connect budget inside a failover walk: a DEAD endpoint (port
#: refused/unreachable) must cost this long, not the caller's deadline —
#: the walk itself is the retry layer across endpoints, and endpoints
#: that were merely slow get revisited by the next walk pass anyway.
_FAILOVER_CONNECT_SLICE_S = 0.35

# A full failover-walk pass that found no servable leader (every peer
# dead or answering NOT_LEADER — the fleet is mid-election) is retried
# on this policy: short jittered backoff inside the caller's deadline
# budget.  The budget, never the attempt count, bounds the wait.
_WALK_POLICY = RetryPolicy(
    name="rpc.failover",
    base_delay=0.05,
    multiplier=1.5,
    max_delay=0.5,
    retryable=(ConnectionError, NotLeaderError),
)


class _FailoverRpcClient:
    """Multi-endpoint framed-JSON client (coordination-plane HA).

    Wraps one :class:`_RpcClient` per endpoint of a comma-list address,
    walks dead endpoints, follows ``NOT_LEADER`` redirects to the named
    holder, and stays pinned to whichever endpoint last answered.  One
    walk pass visits every endpoint at most once (plus bounded redirect
    hops); passes are retried on the unified retry layer while the fleet
    elects, inside the caller's deadline.  A dead endpoint costs a
    bounded connect slice, never the whole deadline — the endpoint that
    answers gets all remaining budget (quorum is a long-poll).

    With a single endpoint the behavior is exactly ``_RpcClient``'s (no
    walk, no policy wrap) — the pre-HA wire behavior.
    """

    def __init__(
        self,
        addrs: str,
        connect_timeout: float = 10.0,
        fault_site: "Optional[str]" = None,
    ) -> None:
        self._endpoints = parse_endpoints(addrs)
        if not self._endpoints:
            raise ValueError(f"no lighthouse endpoints in {addrs!r}")
        self._connect_timeout = connect_timeout
        self._fault_site = fault_site
        self._clients: "Dict[str, _RpcClient]" = {}
        self._cur = 0
        self._redirect = ""  # leader hint from a NOT_LEADER reply

    def endpoints(self) -> "List[str]":
        return list(self._endpoints)

    def current(self) -> str:
        """The endpoint the next call will try first."""
        return self._redirect or self._endpoints[self._cur]

    def _client_for(self, addr: str, connect_slice: float) -> _RpcClient:
        client = self._clients.get(addr)
        if client is None:
            client = _RpcClient(
                addr, connect_slice, fault_site=self._fault_site
            )
            self._clients[addr] = client
        else:
            # per-hop connect budget: bounded by the walk, not the ctor
            client._connect_timeout = connect_slice
        return client

    def _advance(self) -> None:
        self._redirect = ""
        self._cur = (self._cur + 1) % len(self._endpoints)

    def _walk_once(
        self,
        method: str,
        params: "Dict[str, Any]",
        budget: float,
        idempotent: bool,
        stats: "Dict[str, int]",
    ) -> "Dict[str, Any]":
        deadline = time.monotonic() + budget
        n = len(self._endpoints)
        # every endpoint once + a redirect hop per follower answer
        last: "Optional[Exception]" = None
        for _hop in range(2 * n + 2):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            addr = self._redirect or self._endpoints[self._cur]
            connect_slice = min(
                self._connect_timeout,
                _FAILOVER_CONNECT_SLICE_S,
                max(remaining, 0.05),
            )
            client = self._client_for(addr, connect_slice)
            try:
                return client.call(
                    method, params, remaining, idempotent=idempotent
                )
            except NotLeaderError as e:
                last = e
                stats["redirects"] += 1
                _metrics.HA_REDIRECTS.inc()
                if e.leader and e.leader != addr:
                    self._redirect = e.leader
                else:
                    self._advance()
            except (ConnectionError, TimeoutError, OSError) as e:
                # the caller's own deadline expiring on a live endpoint is
                # a timeout, not a dead peer: surface it unchanged
                if (
                    isinstance(e, TimeoutError)
                    and deadline - time.monotonic() <= 0.001
                ):
                    raise
                last = e
                stats["failovers"] += 1
                _metrics.HA_FAILOVERS.inc()
                # dead peer (or dead hinted leader): resume the list walk
                self._advance()
        if isinstance(last, NotLeaderError):
            raise last  # fleet mid-election: retryable by the walk policy
        raise ConnectionError(
            f"rpc {method} failed on every lighthouse endpoint "
            f"{self._endpoints}: {last}"
        ) from last

    def call(
        self,
        method: str,
        params: "Dict[str, Any]",
        timeout: "float | timedelta",
        idempotent: bool = True,
    ) -> "Dict[str, Any]":
        timeout_s = (
            timeout.total_seconds() if isinstance(timeout, timedelta) else timeout
        )
        if len(self._endpoints) == 1:
            return self._client_for(
                self._endpoints[0], self._connect_timeout
            ).call(method, params, timeout_s, idempotent=idempotent)
        stats = {"failovers": 0, "redirects": 0}
        t0_ns = time.time_ns()

        def attempt(budget: "Optional[float]") -> "Dict[str, Any]":
            return self._walk_once(
                method,
                params,
                budget if budget is not None else timeout_s,
                idempotent,
                stats,
            )

        try:
            return _WALK_POLICY.run(attempt, timeout=timeout_s, op="rpc.failover")
        finally:
            if stats["failovers"] or stats["redirects"]:
                # one record per walked call: who we ended up on and what
                # the walk cost — the post-mortem trail of a failover
                _flightrec.record(
                    "ha.failover",
                    start_ns=t0_ns,
                    method=method,
                    endpoint=self.current(),
                    failovers=stats["failovers"],
                    redirects=stats["redirects"],
                )
                tracer = _tracing.get_tracer()
                ctx = _tracing.get_current()
                if tracer is not None and ctx is not None and ctx.sampled:
                    tracer.export_span(
                        name="rpc.failover",
                        trace_id=ctx.trace_id,
                        parent_span_id=ctx.span_id,
                        start_ns=t0_ns,
                        end_ns=time.time_ns(),
                        attributes={
                            "method": method,
                            "endpoint": self.current(),
                            "failovers": stats["failovers"],
                            "redirects": stats["redirects"],
                        },
                    )

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()


# ---------------------------------------------------------------------------
# servers (native C++, lifecycle via ctypes)
# ---------------------------------------------------------------------------


class _NativeServer:
    def __init__(self, handle: int) -> None:
        if handle < 0:
            raise RuntimeError(f"server create failed: {_native.last_error()}")
        self._handle: Optional[int] = handle
        self._address = _native.take_string(
            _native.get_lib().tft_server_address(handle)
        )
        # A native server exists, so its rpc.* spans have somewhere to go:
        # register the process span sink (idempotent; no-op when no tracer
        # is installed).  force_load is safe — the lib is loaded by now.
        _tracing.install_native_span_sink(force_load=True)

    def address(self) -> str:
        """``host:port`` the server is listening on (resolves port 0)."""
        return self._address

    def shutdown(self) -> None:
        """Stop the server and release its socket; idempotent."""
        if self._handle is not None:
            _native.get_lib().tft_server_shutdown(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.shutdown()
        except Exception:
            pass

    def __enter__(self) -> "_NativeServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()


class LighthouseServer(_NativeServer):
    """Cluster quorum authority (C++). Reference: src/lighthouse.rs.

    Binds ``[::]:port`` (port 0 = ephemeral); serves framed-JSON RPC, an
    HTML dashboard, and Prometheus ``GET /metrics`` on the same port.  The
    /metrics exposition is the native lighthouse counters plus this
    process's ``torchft_tpu_torch.utils.metrics`` registry, rendered live via a
    provider callback — the one scrape endpoint a single-host job needs.
    """

    def __init__(
        self,
        bind: str = ":0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        status_page_size: "Optional[int]" = None,
        straggler_topk: "Optional[int]" = None,
        timeline_ring: "Optional[int]" = None,
        serving_fanout: "Optional[int]" = None,
        peers: "Optional[Sequence[str] | str]" = None,
        lease_timeout_ms: "Optional[int]" = None,
    ) -> None:
        from torchft_tpu_torch.utils.env import env_int

        host, _, port = bind.rpartition(":")
        # Coordination-plane HA: ``peers`` names the OTHER lighthouse
        # peers of the replicated coordination plane (list or comma
        # string; self-exclusion is the caller's job — ha.fleet and the
        # CLI handle it).  Empty = single-process mode, wire-identical to
        # the pre-HA server.
        if peers is None:
            peers_csv = ""
        elif isinstance(peers, str):
            peers_csv = peers
        else:
            peers_csv = ",".join(peers)
        lib = _native.get_lib()
        handle = lib.tft_lighthouse_create(
            host.encode(),
            int(port or 0),
            min_replicas,
            join_timeout_ms,
            quorum_tick_ms,
            heartbeat_timeout_ms,
            # fleet-scale status plane sizing (docs/observability.md):
            # rows per /status.json + dashboard page, worst-K straggler
            # export, and the cluster step-timeline ring length
            status_page_size
            if status_page_size is not None
            else env_int("TORCHFT_STATUS_PAGE_SIZE", 16, minimum=1),
            straggler_topk
            if straggler_topk is not None
            else env_int("TORCHFT_STRAGGLER_TOPK", 8, minimum=1),
            timeline_ring
            if timeline_ring is not None
            else env_int("TORCHFT_TIMELINE_RING", 256, minimum=1),
            # weight-serving distribution-tree arity (serving_plan RPC)
            serving_fanout
            if serving_fanout is not None
            else env_int("TORCHFT_SERVING_FANOUT", 2, minimum=1),
            peers_csv.encode(),
            lease_timeout_ms
            if lease_timeout_ms is not None
            else env_int("TORCHFT_LIGHTHOUSE_LEASE_MS", 1000, minimum=40),
        )
        super().__init__(handle)
        self._metrics_cb: Any = None
        self._install_metrics_provider()

    def ha_info(self) -> "Dict[str, Any]":
        """Coordination-plane HA introspection: ``{"enabled", "term",
        "is_leader", "leader", "peers", "takeovers_total", "quorum_id"}``.
        Single-process mode reports ``enabled=False``, ``is_leader=True``,
        term 0."""
        if self._handle is None:
            raise RuntimeError("lighthouse server is shut down")
        ptr = _native.get_lib().tft_lighthouse_ha_info(self._handle)
        return json.loads(_native.take_string(ptr))

    def _install_metrics_provider(self) -> None:
        from torchft_tpu_torch.utils import metrics as _metrics

        import ctypes

        def _provider(buf: Any, cap: int) -> int:
            # Contract (native/lighthouse.h MetricsProvider): write up to
            # ``cap`` bytes; return bytes written, or -needed if too small.
            # Never raise: a scrape must not be able to wedge the server.
            try:
                text = _metrics.REGISTRY.render().encode()
            except Exception:  # noqa: BLE001
                return 0
            if len(text) > cap:
                return -len(text)
            ctypes.memmove(buf, text, len(text))
            return len(text)

        # the CFUNCTYPE object must outlive the native registration
        self._metrics_cb = _native.METRICS_PROVIDER_CFUNC(_provider)
        _native.get_lib().tft_lighthouse_set_metrics_provider(
            self._handle, self._metrics_cb
        )

    def shutdown(self) -> None:
        """Stop the server and release its socket; idempotent.

        Clears the /metrics provider BEFORE tearing the server down so no
        native HTTP thread can call into a collected callback (shutdown
        drains in-flight connections before returning)."""
        if self._handle is not None and self._metrics_cb is not None:
            _native.get_lib().tft_lighthouse_set_metrics_provider(
                self._handle, _native.METRICS_PROVIDER_CFUNC()
            )
            self._metrics_cb = None
        super().shutdown()


class StoreServer(_NativeServer):
    """Rendezvous key-value store (C++). Replaces torch TCPStore usage."""

    def __init__(self, bind: str = ":0") -> None:
        host, _, port = bind.rpartition(":")
        lib = _native.get_lib()
        handle = lib.tft_store_create(host.encode(), int(port or 0))
        super().__init__(handle)


class ManagerServer(_NativeServer):
    """Per-replica-group coordination server (C++). Reference: src/manager.rs."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        store_address: str,
        world_size: int,
        bind: str = ":0",
        heartbeat_interval: "float | timedelta" = 0.1,
        connect_timeout: "float | timedelta" = 10.0,
        quorum_retries: int = 0,
    ) -> None:
        host, _, port = bind.rpartition(":")
        lib = _native.get_lib()
        handle = lib.tft_manager_create(
            replica_id.encode(),
            lighthouse_addr.encode(),
            host.encode(),
            int(port or 0),
            store_address.encode(),
            world_size,
            _to_ms(heartbeat_interval),
            _to_ms(connect_timeout),
            quorum_retries,
        )
        super().__init__(handle)

    def report_progress(self, step: int, inflight_op: str = "") -> None:
        """Record this replica group's training progress; the native
        heartbeat loop piggybacks it (``step``, ``last_step_wall_ms``,
        ``inflight_op``) on every lighthouse heartbeat so the lighthouse
        can compute per-replica step lag and straggler scores."""
        if self._handle is None:
            return
        _native.get_lib().tft_manager_report_progress(
            self._handle, int(step), inflight_op.encode()
        )

    def report_summary(self, summary: "Dict[str, Any]") -> None:
        """Record this replica group's per-step digest (``step``,
        ``phase_ms`` name->ms, ``codec_busy_s``, ``wire_busy_s``); the
        next lighthouse heartbeat carries it exactly once, feeding the
        cluster step-timeline (``/timeline.json``)."""
        if self._handle is None:
            return
        rc = _native.get_lib().tft_manager_report_summary(
            self._handle, json.dumps(summary).encode()
        )
        if rc != 0:
            raise RuntimeError(_native.last_error())

    def report_links(self, links: "Dict[str, Any]") -> None:
        """Record this replica's bounded link-state digest
        (``LinkRegistry.maybe_digest``: ``{"host", "rows"}``); the next
        lighthouse heartbeat carries it exactly once (consumed-on-send,
        restored on RPC failure — the per-step-digest idiom), feeding the
        fleet host-pair matrix (``/links.json``)."""
        if self._handle is None:
            return
        # chaos site: a dropped/raised link report degrades to stale
        # matrix rows; it must never wedge the heartbeat loop
        _faults.check("lighthouse.links")
        rc = _native.get_lib().tft_manager_report_links(
            self._handle, json.dumps(links).encode()
        )
        if rc != 0:
            raise RuntimeError(_native.last_error())

    def report_fragments(self, fragments: "Dict[str, Any]") -> None:
        """Record this replica's bounded fragment-provenance digest
        (``ProvenanceRegistry.maybe_digest``: ``{"host", "frags"}``); the
        next lighthouse heartbeat carries it exactly once
        (consumed-on-send, restored on RPC failure — the links-digest
        idiom), feeding the fleet per-(host, frag_id) version matrix
        (``/fragments.json``)."""
        if self._handle is None:
            return
        # chaos site: a dropped/raised fragment report degrades to stale
        # matrix rows; it must never wedge the heartbeat loop
        _faults.check("lighthouse.fragments")
        rc = _native.get_lib().tft_manager_report_fragments(
            self._handle, json.dumps(fragments).encode()
        )
        if rc != 0:
            raise RuntimeError(_native.last_error())


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------


class LighthouseClient:
    """Client for LighthouseServer. Reference: src/lib.rs:483-591.

    ``addr`` may be a single ``host:port`` or the HA comma list
    (``TORCHFT_LIGHTHOUSE=h1:p,h2:p,h3:p``): with multiple endpoints
    every call rides the failover walk — dead peers are skipped within a
    bounded connect slice, ``NOT_LEADER`` replies are followed to the
    current lease holder, and mid-election passes are retried on the
    unified retry layer inside the caller's timeout.
    """

    def __init__(self, addr: str, connect_timeout: "float | timedelta" = 10.0) -> None:
        ct = (
            connect_timeout.total_seconds()
            if isinstance(connect_timeout, timedelta)
            else connect_timeout
        )
        self._client = _FailoverRpcClient(addr, ct, fault_site="lighthouse.rpc")

    def quorum(
        self,
        replica_id: str,
        timeout: "float | timedelta",
        address: str = "",
        store_address: str = "",
        step: int = 0,
        world_size: int = 1,
        shrink_only: bool = False,
        commit_failures: int = 0,
        data: "Dict[str, Any] | None" = None,
    ) -> Quorum:
        """Join the next quorum as ``replica_id`` and block until it forms.

        Doubles as an implicit heartbeat (reference src/lighthouse.rs:
        498-544); ``data`` is an opaque JSON dict carried to all members.

        Id convention: the segment after the last ``:`` is the INCARNATION
        suffix (the Manager appends ``:uuid4``). A joiner supersedes any
        member sharing its non-empty prefix — the stale incarnation is
        evicted immediately so a fast-restarted replica re-forms quorum
        without waiting out heartbeat expiry. Ids without ``:`` (or with
        an empty prefix) never supersede anything.
        """
        member = QuorumMember(
            replica_id=replica_id,
            address=address,
            store_address=store_address,
            step=step,
            world_size=world_size,
            shrink_only=shrink_only,
            commit_failures=commit_failures,
            data=json.dumps(data) if data else "",
        )
        result = self._client.call("quorum", {"member": member.to_dict()}, timeout)
        return Quorum.from_dict(result["quorum"])

    def heartbeat(
        self,
        replica_id: str,
        timeout: "float | timedelta" = 5.0,
        step: "Optional[int]" = None,
        last_step_wall_ms: "Optional[int]" = None,
        inflight_op: "Optional[str]" = None,
        summary: "Optional[Dict[str, Any]]" = None,
        links: "Optional[Dict[str, Any]]" = None,
        fragments: "Optional[Dict[str, Any]]" = None,
    ) -> Dict[str, Any]:
        """Mark ``replica_id`` live; lighthouse expiry is heartbeat_timeout_ms.

        Optional progress piggyback (straggler telemetry): ``step`` is the
        replica's committed step, ``last_step_wall_ms`` the sender-clock
        wall time (ms) the step last advanced, ``inflight_op`` what the
        replica is currently doing.  The lighthouse folds these into
        per-replica step lag and straggler scores (``/status.json``
        ``stragglers``, ``/metrics`` ``torchft_replica_step_lag`` /
        ``torchft_straggler_score``).  ``summary`` is the per-step digest
        (``step``, ``phase_ms`` name->ms, ``codec_busy_s``,
        ``wire_busy_s``) aggregated into the cluster step-timeline
        (``/timeline.json``) — send a given step's digest ONCE.  ``links``
        is the replica's bounded link-state digest
        (``LinkRegistry.maybe_digest``: ``{"host", "rows"}``) folded into
        the fleet host-pair matrix (``/links.json``) — likewise send each
        digest ONCE.  Returns the server reply (e.g.
        ``{"superseded": true}`` for an evicted incarnation)."""
        # chaos site: the straggler-telemetry path must itself be
        # chaos-testable (docs/robustness.md site table)
        _faults.check("lighthouse.heartbeat", replica=replica_id)
        params: "Dict[str, Any]" = {"replica_id": replica_id}
        if step is not None:
            params["step"] = int(step)
        if last_step_wall_ms is not None:
            params["last_step_wall_ms"] = int(last_step_wall_ms)
        if inflight_op is not None:
            params["inflight_op"] = inflight_op
        if summary is not None:
            params["summary"] = summary
        if links is not None:
            # chaos site: a dropped/raised link report must degrade to
            # stale matrix rows, never wedge the heartbeat itself — the
            # caller catches and re-queues (docs/robustness.md)
            _faults.check("lighthouse.links", replica=replica_id)
            params["links"] = links
        if fragments is not None:
            # chaos site: same degrade contract as ``links`` — a lost
            # fragment digest leaves stale provenance rows, the caller
            # restores the digest and re-sends next beat
            _faults.check("lighthouse.fragments", replica=replica_id)
            params["fragments"] = fragments
        return self._client.call("heartbeat", params, timeout)

    def status(
        self,
        timeout: "float | timedelta" = 5.0,
        page: "Optional[int]" = None,
        per_page: "Optional[int]" = None,
        replica: "Optional[str]" = None,
    ) -> Dict[str, Any]:
        """Quorum/participant/heartbeat snapshot (the dashboard's data).

        The same document as ``GET /status.json``: row arrays
        (``heartbeats``, ``stragglers``, ``prev_quorum.participants``)
        are paginated — ``page``/``per_page`` select a slice (defaults:
        page 0 of the server's ``TORCHFT_STATUS_PAGE_SIZE``), ``replica``
        shards every array down to one replica id.  Fleet-wide truth is
        always present regardless of page: ``*_total`` counts, ``pages``,
        ``max_step``, and ``summary`` (counts + the worst-K stragglers by
        score).  See docs/observability.md for the schema."""
        params: "Dict[str, Any]" = {}
        if page is not None:
            params["page"] = int(page)
        if per_page is not None:
            params["per_page"] = int(per_page)
        if replica is not None:
            params["replica"] = replica
        return self._client.call("status", params, timeout)

    def serving_heartbeat(
        self,
        replica_id: str,
        address: str,
        role: str = "server",
        version: int = 0,
        capacity: int = 0,
        version_ms: int = 0,
        timeout: "float | timedelta" = 5.0,
        fragments: "Optional[Dict[str, Any]]" = None,
    ) -> Dict[str, Any]:
        """Register/refresh a weight-serving member (docs/architecture.md
        "Weight-serving tier").  ``role`` is ``publisher`` (training-side
        WeightPublisher, the tree's source) or ``server`` (relay/leaf
        serving replica); ``address`` is the member's HTTP
        checkpoint-transport base address; ``version`` the newest weight
        version it holds; ``capacity`` overrides the tree fanout for this
        node (0 = server default); ``version_ms`` is the PUBLISH
        wall-clock stamp (ms) of ``version`` — the publisher's clock,
        carried unmodified through the tree so the lighthouse can compute
        per-node serving staleness on a single clock (0 = unknown).
        ``fragments`` is the member's bounded fragment-provenance digest
        (``ProvenanceRegistry.maybe_digest``: ``{"host", "frags"}``)
        folded into the fleet fragment-version matrix
        (``/fragments.json``) — send each digest ONCE (consumed-on-send;
        restore on failure).  Expiry follows the lighthouse heartbeat
        timeout.  Returns ``{"plan_epoch", "latest_version"}`` — a
        ``plan_epoch`` differing from the adopted one means the tree
        re-formed and :meth:`serving_plan` should be re-fetched."""
        params: "Dict[str, Any]" = {
            "replica_id": replica_id,
            "address": address,
            "role": role,
            "version": int(version),
            "capacity": int(capacity),
            "version_ms": int(version_ms),
        }
        if fragments is not None:
            # chaos site: shared with the manager-heartbeat piggyback —
            # the caller restores the digest and re-sends next beat
            _faults.check("lighthouse.fragments", replica=replica_id)
            params["fragments"] = fragments
        result = self._client.call("serving_heartbeat", params, timeout)
        return {
            "plan_epoch": result["plan_epoch"],
            "latest_version": result["latest_version"],
        }

    def serving_plan(self, timeout: "float | timedelta" = 5.0) -> Dict[str, Any]:
        """The synthesized weight-distribution fan-out plan (same document
        as ``GET /serving.json``): monotone ``epoch``, ``root_source``
        (max-version publisher address), ``publishers``, and ``nodes`` —
        one entry per serving replica with ``parent`` ("" = root, pulls
        from ``root_source``), ``depth`` and ``children``.  Synthesis is
        deterministic over the replica_id-ordered membership, so every
        reader of epoch E sees the identical tree."""
        result = self._client.call("serving_plan", {}, timeout)
        return {
            "epoch": result["epoch"],
            "generated_ms": result["generated_ms"],
            "fanout": result["fanout"],
            "latest_version": result["latest_version"],
            "root_source": result["root_source"],
            "publishers": result["publishers"],
            "nodes": result["nodes"],
            "depth": result["depth"],
        }

    def lease(
        self,
        term: int,
        candidate: str,
        timeout: "float | timedelta" = 5.0,
    ) -> Dict[str, Any]:
        """One leadership-lease request against a single lighthouse peer
        (coordination-plane HA; the native electors drive this RPC in
        production — this client exists for tests, chaos drills and
        external election tooling).  ``term`` is the candidate's proposed
        monotone term, ``candidate`` its advertised RPC address.  Reply:
        ``{"granted", "term", "holder"}`` — ``granted`` is False when the
        peer already promised this term to another candidate or its
        current promise has not lapsed (lease shielding).  Note this RPC
        is served by every peer, leader or follower."""
        # chaos site: the lease/election path must itself be
        # chaos-testable (docs/robustness.md site table)
        _faults.check("lighthouse.lease", step=term)
        params: "Dict[str, Any]" = {
            "term": int(term),
            "candidate": candidate,
        }
        result = self._client.call("lease", params, timeout)
        return {
            "granted": result["granted"],
            "term": result["term"],
            "holder": result["holder"],
        }

    def timeline(self, timeout: "float | timedelta" = 5.0) -> Dict[str, Any]:
        """The rolling cluster step-timeline (same document as
        ``GET /timeline.json``): per-step buckets aggregated from the
        heartbeat-piggybacked replica digests (replicas seen, phase
        mean/max, codec/wire busy, first/last report stamps) plus the
        worst-K straggler snapshot — one scrape answers "what was the
        whole fleet doing at step N"."""
        return self._client.call("timeline", {}, timeout)

    def links(
        self,
        timeout: "float | timedelta" = 5.0,
        page: "Optional[int]" = None,
        per_page: "Optional[int]" = None,
    ) -> Dict[str, Any]:
        """The fleet link-state matrix (same document as
        ``GET /links.json``): host-pair rows aggregated from the
        heartbeat-piggybacked link digests — per (reporting host, peer
        host, plane): goodput, first-byte p50/p99, sample count and
        report age.  ``rows`` is paginated like ``/status.json``
        (``page``/``per_page``); fleet truth (``rows_total``, ``pages``,
        ``version``, ``hosts``, ``worst``) is present on every page.
        ``version`` is monotone — equal versions mean an identical
        matrix.  See docs/observability.md "Link-state plane"."""
        # chaos site: shared with the report path — a faulted links plane
        # degrades reads the same way it degrades reports
        _faults.check("lighthouse.links")
        params: "Dict[str, Any]" = {}
        if page is not None:
            params["page"] = int(page)
        if per_page is not None:
            params["per_page"] = int(per_page)
        return self._client.call("links", params, timeout)

    def fragments(
        self,
        timeout: "float | timedelta" = 5.0,
        page: "Optional[int]" = None,
        per_page: "Optional[int]" = None,
    ) -> Dict[str, Any]:
        """The fleet fragment-version matrix (same document as
        ``GET /fragments.json``): per-(holder host, fragment id) rows
        aggregated from the heartbeat-piggybacked provenance digests —
        version, digest8, publish stamp, staleness vs. the freshest
        stamp any holder reports for that fragment (publisher's clock,
        so the comparison is skew-free).  ``rows`` is paginated like
        ``/links.json`` (``page``/``per_page``); fleet truth
        (``rows_total``, ``pages``, ``version``, ``hosts``, ``frags``,
        ``stalest``) is present on every page.  ``version`` is monotone
        — equal versions mean an identical matrix.  See
        docs/observability.md "Fragment provenance plane"."""
        # chaos site: shared with the report path — a faulted fragments
        # plane degrades reads the same way it degrades reports
        _faults.check("lighthouse.fragments")
        params: "Dict[str, Any]" = {}
        if page is not None:
            params["page"] = int(page)
        if per_page is not None:
            params["per_page"] = int(per_page)
        return self._client.call("fragments", params, timeout)

    def close(self) -> None:
        """Close the underlying connection; the client is unusable after."""
        self._client.close()


class ManagerClient:
    """Client for ManagerServer. Reference: src/lib.rs:153-281."""

    def __init__(
        self,
        addr: str,
        connect_timeout: "float | timedelta" = 10.0,
        resolve: "Optional[Callable[[], str]]" = None,
    ) -> None:
        ct = (
            connect_timeout.total_seconds()
            if isinstance(connect_timeout, timedelta)
            else connect_timeout
        )
        self._client = _RpcClient(addr, ct, resolve=resolve)

    def address(self) -> str:
        """The server address this client dials now."""
        return self._client._addr

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout: "float | timedelta",
        init_sync: bool = True,
        commit_failures: int = 0,
        layout_epoch: int = 0,
        layout_data: str = "",
    ) -> QuorumResult:
        """Per-rank quorum entry.  ``layout_epoch`` / ``layout_data`` are
        the online-parallelism-switching fields (parallel/layout.py): the
        group's current/staged layout epoch and its opaque shard manifest,
        forwarded into the lighthouse QuorumMember so every participant's
        result carries the fleet's epoch spread + manifests."""
        result = self._client.call(
            "quorum",
            {
                "group_rank": group_rank,
                "step": step,
                "checkpoint_metadata": checkpoint_metadata,
                "shrink_only": shrink_only,
                "init_sync": init_sync,
                "commit_failures": commit_failures,
                "layout_epoch": layout_epoch,
                "layout_data": layout_data,
            },
            timeout,
        )
        return QuorumResult.from_dict(result)

    def _checkpoint_metadata(self, rank: int, timeout: "float | timedelta") -> str:
        result = self._client.call("checkpoint_metadata", {"rank": rank}, timeout)
        return result["checkpoint_metadata"]

    def should_commit(
        self,
        group_rank: int,
        step: int,
        should_commit: bool,
        timeout: "float | timedelta",
    ) -> bool:
        """Vote on committing ``step``; blocks until all group ranks vote and
        returns the AND across them (reference src/manager.rs:423-479).

        Non-idempotent on the wire: a blind re-send after a broken
        connection could deliver this rank's vote twice (e.g. across a
        server restart) and release the barrier with a stale tally, so a
        connection failure surfaces to the Manager — which votes False and
        lets the protocol's normal abstain path handle it."""
        result = self._client.call(
            "should_commit",
            {"group_rank": group_rank, "step": step, "should_commit": should_commit},
            timeout,
            idempotent=False,
        )
        return result["should_commit"]

    def kill(self, msg: str = "", timeout: "float | timedelta" = 5.0) -> None:
        """Ask the remote replica's manager to exit its process."""
        try:
            self._client.call("kill", {"msg": msg}, timeout)
        except (TimeoutError, ConnectionError, RpcError):
            pass  # the remote process exits mid-RPC by design

    def close(self) -> None:
        """Close the underlying connection; the client is unusable after."""
        self._client.close()


class StoreClient:
    """Client for StoreServer: set/get(wait)/delete_prefix."""

    def __init__(self, addr: str, connect_timeout: "float | timedelta" = 10.0) -> None:
        ct = (
            connect_timeout.total_seconds()
            if isinstance(connect_timeout, timedelta)
            else connect_timeout
        )
        self._client = _RpcClient(addr, ct)

    def set(self, key: str, value: str, timeout: "float | timedelta" = 10.0) -> None:
        """Publish ``key`` (wakes any blocked ``get(wait=True)``)."""
        self._client.call("set", {"key": key, "value": value}, timeout)

    def get(
        self, key: str, timeout: "float | timedelta" = 10.0, wait: bool = True
    ) -> str:
        """Read ``key``; with ``wait`` blocks until it is set or timeout."""
        if wait:
            # the blocking rendezvous wait PG configure / manager discovery
            # park on — the chaos layer's store-barrier injection site
            _faults.check("store.barrier")
        result = self._client.call("get", {"key": key, "wait": wait}, timeout)
        return result["value"]

    def delete_prefix(self, prefix: str, timeout: "float | timedelta" = 10.0) -> int:
        """Remove all keys under ``prefix``; returns the count removed."""
        result = self._client.call("delete_prefix", {"prefix": prefix}, timeout)
        return result["removed"]

    def num_keys(self, timeout: "float | timedelta" = 10.0) -> int:
        """Total keys currently stored (tests/diagnostics)."""
        return self._client.call("num_keys", {}, timeout)["count"]

    def close(self) -> None:
        """Close the underlying connection; the client is unusable after."""
        self._client.close()


def compute_quorum_results(
    replica_id: str, group_rank: int, quorum: Quorum, init_sync: bool = True
) -> QuorumResult:
    """Pure quorum-result math (native). Reference: src/manager.rs:489-624."""
    lib = _native.get_lib()
    quorum_json = json.dumps(
        {
            "quorum_id": quorum.quorum_id,
            "participants": [p.to_dict() for p in quorum.participants],
            "created_ms": quorum.created_ms,
        }
    )
    ptr = lib.tft_compute_quorum_results(
        replica_id.encode(), group_rank, quorum_json.encode(), 1 if init_sync else 0
    )
    return QuorumResult.from_dict(json.loads(_native.take_string(ptr)))
