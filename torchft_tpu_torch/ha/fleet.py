"""LighthouseFleet: N in-process lighthouse peers with leased leadership.

PyTorch-port copy of ``torchft_tpu/ha/fleet.py``.  The test and smoke
harness for coordination-plane HA: picks N free ports, starts N native
``LighthouseServer`` peers wired to each other (again on fresh ports when
a port was taken before its peer bound it), and exposes the
leader/term introspection plus targeted kills the chaos tests drive.  Production deployments run
one ``python -m torchft_tpu_torch.lighthouse --peers ...`` process per node
instead — the wire behavior is identical.
"""

from __future__ import annotations

import socket
from typing import Any, Dict, List, Optional

from torchft_tpu_torch.ha.endpoints import format_endpoints
from torchft_tpu_torch.utils.retry import RetryPolicy

__all__ = ["LighthouseFleet", "pick_free_ports"]

# Leader-wait poll: a fixed-cadence probe under the unified retry layer
# (deadline budget, torchft_retries_total accounting) — elections settle
# within ~a lease, so the cadence is a fraction of the default lease.
_WAIT_LEADER_POLICY = RetryPolicy(
    name="ha.wait_leader",
    base_delay=0.02,
    multiplier=1.0,
    max_delay=0.02,
    jitter=False,
    retryable=(ConnectionError,),
)


#: Times :class:`LighthouseFleet` builds its peers, each time on fresh
#: ports, when a peer's port was taken between its pick and its bind.
FLEET_BIND_ATTEMPTS = 5


def _bind_failed(err: BaseException) -> bool:
    return "Address already in use" in str(err)


def pick_free_ports(n: int) -> "List[int]":
    """``n`` distinct currently-free TCP ports.

    Bind-then-close: something else can bind a port before the server
    does.  Each peer must know every other peer's address before it
    starts, so the peers cannot bind port 0 and publish it; a failed
    bind starts them all again on fresh ports
    (:class:`LighthouseFleet`, ``FLEET_BIND_ATTEMPTS``).  All sockets are
    held open until every port is picked so the n ports are distinct.
    """
    socks: "List[socket.socket]" = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class LighthouseFleet:
    """``n`` lighthouse peers in this process, leased leadership armed.

    Args mirror :class:`torchft_tpu_torch.coordination.LighthouseServer`;
    ``lease_timeout_ms`` is kept deliberately small by default (300 ms)
    so tests exercise real takeovers quickly.  ``addresses()`` is the
    comma list to hand to clients/``TORCHFT_LIGHTHOUSE``.
    """

    def __init__(
        self,
        n: int = 3,
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 50,
        heartbeat_timeout_ms: int = 5000,
        lease_timeout_ms: int = 300,
        host: str = "127.0.0.1",
    ) -> None:
        from torchft_tpu_torch.coordination import LighthouseServer

        if n < 1:
            raise ValueError("fleet needs at least one peer")
        self._host = host
        #: times the peers were built again on fresh ports after a bind
        #: failed (0 on a quiet host)
        self.restarts = 0
        self._servers: "List[Optional[LighthouseServer]]" = []
        for attempt in range(FLEET_BIND_ATTEMPTS):
            self._ports = pick_free_ports(n)
            self._endpoints = [f"{host}:{p}" for p in self._ports]
            self._servers = []
            try:
                for i in range(n):
                    others = [ep for j, ep in enumerate(self._endpoints) if j != i]
                    self._servers.append(
                        LighthouseServer(
                            bind=f"{host}:{self._ports[i]}",
                            min_replicas=min_replicas,
                            join_timeout_ms=join_timeout_ms,
                            quorum_tick_ms=quorum_tick_ms,
                            heartbeat_timeout_ms=heartbeat_timeout_ms,
                            peers=others,
                            lease_timeout_ms=lease_timeout_ms,
                        )
                    )
                break
            except RuntimeError as e:
                # a peer's port was taken after the pick: the peers made so
                # far know it, so all of them go and the fleet is built
                # again on fresh ports
                self.shutdown()
                if not _bind_failed(e) or attempt + 1 == FLEET_BIND_ATTEMPTS:
                    raise
                self.restarts += 1
        self._lease_timeout_ms = lease_timeout_ms

    # -- introspection -----------------------------------------------------

    def endpoints(self) -> "List[str]":
        return list(self._endpoints)

    def addresses(self) -> str:
        """The ``TORCHFT_LIGHTHOUSE`` comma-list value for this fleet."""
        return format_endpoints(self._endpoints)

    def ha_info(self, i: int) -> "Dict[str, Any]":
        server = self._servers[i]
        if server is None:
            raise RuntimeError(f"peer {i} was killed")
        return server.ha_info()

    def alive(self) -> "List[int]":
        return [i for i, s in enumerate(self._servers) if s is not None]

    def leader_index(self) -> "Optional[int]":
        """The peer currently leading, or None mid-election."""
        for i in self.alive():
            try:
                if self.ha_info(i)["is_leader"]:
                    return i
            except RuntimeError:
                continue
        return None

    def leader_address(self) -> "Optional[str]":
        i = self.leader_index()
        return None if i is None else self._endpoints[i]

    def wait_for_leader(self, timeout: float = 10.0) -> int:
        """Block until some peer leads; returns its index."""

        def attempt(_budget: "Optional[float]") -> int:
            i = self.leader_index()
            if i is None:
                raise ConnectionError("no lighthouse leader yet")
            return i

        try:
            return _WAIT_LEADER_POLICY.run(
                attempt, timeout=timeout, op="ha.wait_leader"
            )
        except TimeoutError as e:
            raise TimeoutError(
                f"no lighthouse leader elected within {timeout}s "
                f"(alive: {self.alive()})"
            ) from e

    def term(self) -> int:
        """The current leader's term (0 when no leader)."""
        i = self.leader_index()
        return 0 if i is None else int(self.ha_info(i)["term"])

    # -- chaos -------------------------------------------------------------

    def kill(self, i: int) -> None:
        """Hard-stop peer ``i`` (its socket closes; clients see a dead
        endpoint, exactly like a SIGKILL'd process)."""
        server = self._servers[i]
        if server is not None:
            self._servers[i] = None
            server.shutdown()

    def kill_leader(self, timeout: float = 10.0) -> int:
        """Kill the current leader; returns its index."""
        i = self.wait_for_leader(timeout)
        self.kill(i)
        return i

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        for i in list(range(len(self._servers))):
            self.kill(i)

    def __enter__(self) -> "LighthouseFleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
