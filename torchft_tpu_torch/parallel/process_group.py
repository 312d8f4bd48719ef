"""Reconfigurable process groups: the fault-tolerant collective layer.

PyTorch port of ``torchft_tpu/parallel/process_group.py`` (itself a rebuild
of the reference's reconfigurable ProcessGroup hierarchy, reference:
torchft/process_group.py:133-2023).  The fault-tolerance properties:

- **reconfigure**: ``configure(store_addr, replica_id, rank, world_size)``
  tears down and re-forms the group with new membership (keyed by the
  per-quorum store prefix) without restarting the process.
- **abortable with deadline**: every op takes the group timeout; ``abort()``
  cancels in-flight ops by closing sockets, never killing the process.
- **error latching**: after a failure every op fails fast (or is swallowed by
  ``ErrorSwallowingProcessGroupWrapper``) until the next configure.
- **host-mediated path**: collectives run over TCP on host buffers (numpy),
  the Gloo analog.  Torch tensors are accepted anywhere an array is: a CUDA
  tensor is copied to the host on the PG worker thread (``_as_numpy``), so
  the copy overlaps the caller.

Numpy has no bfloat16.  The allreduce reduces a bf16 tensor leaf as the JAX
package reduces an ``ml_dtypes`` bf16 leaf: widened exactly to f32 on the
host (its int16 bit pattern shifted into the high half of a 32-bit word, so
the device-to-host copy stays at 2 bytes per element), bucketed with the f32
leaves, reduced on the ring in f32 and rounded back to bf16 to nearest even
(``torch.Tensor.to`` rounds as ``ml_dtypes`` does); it comes back as a CPU
bf16 tensor.  ``reduce_scatter`` reduces bf16 the same way.  The ops that
move data without reducing it (``broadcast``, ``allgather``, ``alltoall``,
``sendrecv``, ``send``, ``recv``) carry a bf16 tensor as its 16-bit
patterns, never converted: a uint16 view (:class:`_BF16Bits`) that the
wire header names ``bfloat16``, as the JAX package names an ``ml_dtypes``
bf16 array, and that comes back out as a CPU bf16 tensor.  The
subprocess-isolated ``ProcessGroupBabyTCP`` of the JAX package is not
ported yet.
"""

from __future__ import annotations

import logging
import pickle
import queue
import socket
import struct
import threading
import time
import uuid
import concurrent.futures as concurrent_futures
from abc import ABC, abstractmethod
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.coordination import StoreClient
from torchft_tpu_torch.parallel.work import Work, completed_work, failed_work
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import linkstats as _linkstats
from torchft_tpu_torch.utils import lockcheck as _lockcheck
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils.bufpool import POOL as _pool
from torchft_tpu_torch.utils.env import env_float

logger = logging.getLogger(__name__)

_TORCH_TO_NUMPY: Dict[torch.dtype, Any] = {
    torch.float64: np.float64,
    torch.float32: np.float32,
    torch.float16: np.float16,
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.int16: np.int16,
    torch.int8: np.int8,
    torch.uint8: np.uint8,
    torch.bool: np.bool_,
}

REDUCE_SUM = "sum"
REDUCE_AVG = "avg"
REDUCE_MAX = "max"
REDUCE_MIN = "min"

# in-place reduction ufuncs for ring steps (AVG divides at the end)
_REDUCE_UFUNCS: Dict[str, Any] = {
    REDUCE_SUM: np.add,
    REDUCE_AVG: np.add,
    REDUCE_MAX: np.maximum,
    REDUCE_MIN: np.minimum,
}


def _is_float_dtype(dtype: np.dtype) -> bool:
    """True for numpy floats AND ml_dtypes extension floats (bfloat16,
    float8_*) — np.issubdtype misses the latter (they register as kind 'V';
    same pitfall as manager._is_floating, manager.py:67)."""
    return np.issubdtype(dtype, np.floating) or dtype.name.startswith(
        ("bfloat", "float8")
    )


def _accumulation_dtype(dtype: np.dtype) -> np.dtype:
    """Accumulation dtype for ring partial sums.

    Floats accumulate in f32 (f64 stays f64): the replica dimension is
    small, the ring reduces each chunk in a fixed order on exactly one rank
    before allgather, so results are bitwise identical across ranks at any
    precision — and f32 halves the wire bytes vs f64 promotion. Half-width
    floats (f16 and the ml_dtypes TPU types bf16/fp8) widen to f32 for
    precision; integers widen to 64-bit to avoid silent overflow.
    """
    if _is_float_dtype(dtype):
        return np.dtype(np.float64) if dtype.itemsize >= 8 else np.dtype(np.float32)
    if np.issubdtype(dtype, np.signedinteger):
        return np.dtype(np.int64)
    if np.issubdtype(dtype, np.unsignedinteger):
        return np.dtype(np.uint64)
    return dtype


_BF16 = "bfloat16"


class _BF16Bits(np.ndarray):
    """A bf16 tensor's 16-bit patterns on the host: a uint16 array that
    the wire header names ``bfloat16`` and that an op's result turns back
    into a bf16 tensor (:func:`_host_result`)."""


def _dtype_name(a: np.ndarray) -> str:
    """The dtype an array travels under on the wire."""
    return _BF16 if isinstance(a, _BF16Bits) else str(a.dtype)


def _as_numpy(x: Any) -> np.ndarray:
    """Host view of an array: a CPU tensor shares its memory, a CUDA
    tensor is copied to the host (blocking on the work that produces it).
    A bf16 tensor becomes its bit patterns (:class:`_BF16Bits`)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            bits = x.detach().contiguous().cpu().view(torch.int16).numpy()
            return bits.view(np.uint16).view(_BF16Bits)
        if x.dtype not in _TORCH_TO_NUMPY:
            raise TypeError(
                f"process group leaves must have a numpy dtype or be bf16, "
                f"got {x.dtype}"
            )
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_result(x: Any) -> Any:
    """An op's result as the caller gets it: bf16 bit patterns (alone or
    in a list) become CPU bf16 tensors, everything else is unchanged."""
    if isinstance(x, _BF16Bits):
        bits = np.asarray(x).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if isinstance(x, list):
        return [_host_result(a) for a in x]
    return x


def _allreduce_in(x: Any) -> np.ndarray:
    """Host array an allreduce reduces: :func:`_as_numpy`, except that a
    bf16 tensor widens exactly to f32 (module docstring)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        bits = x.detach().cpu().contiguous().view(torch.int16).numpy()
        return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return _as_numpy(x)


def _allreduce_out(x: Any, reduced: np.ndarray) -> Any:
    """An allreduce result in its input leaf's type: a bf16 leaf's f32
    result rounds back to a bf16 tensor (nearest even), the rest stay
    numpy."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(reduced)).to(torch.bfloat16)
    return reduced


def _np_dtype(x: Any) -> np.dtype:
    """Numpy dtype of an array-like or a tensor, without a host copy."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TORCH_TO_NUMPY:
            raise TypeError(f"no numpy dtype for {x.dtype}")
        return np.dtype(_TORCH_TO_NUMPY[x.dtype])
    return np.dtype(x.dtype)


def _check_recv_buffer(out: np.ndarray, shape: Any, dtype: str) -> None:
    """Validate a caller-supplied in-place recv buffer against the wire
    header: shape, dtype, and contiguity must all match (a silent
    value-cast or reshape would mask a buffer-setup bug)."""
    if (
        _dtype_name(out) != dtype
        or tuple(out.shape) != tuple(shape)
        or not out.flags.c_contiguous
    ):
        raise RuntimeError(
            f"in-place recv buffer mismatch: {out.shape}/{out.dtype} vs "
            f"wire {tuple(shape)}/{dtype}"
        )


def _routable_local_ip(store_addr: str) -> str:
    """Local IP of the interface that routes to the store host.

    Hostnames are not guaranteed resolvable across hosts/containers; the
    interface used to reach the rendezvous store is by construction routable
    from every peer that also reaches the store.
    """
    host, _, port = store_addr.rpartition(":")
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect((host or "127.0.0.1", int(port or 1)))
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        return socket.gethostname()


class ProcessGroup(ABC):
    """Abstract reconfigurable process group over host buffers.

    API parity with the reference base ProcessGroup
    (reference: torchft/process_group.py:133-386), adapted to numpy/pytree
    data instead of torch tensors.
    """

    def __init__(self, timeout: float = 60.0) -> None:
        self._timeout = timeout

    # -- lifecycle ---------------------------------------------------------

    @abstractmethod
    def configure(
        self, store_addr: str, replica_id: str, rank: int, world_size: int
    ) -> None:
        """(Re)initialize membership. store_addr is ``host:port/prefix``."""

    @abstractmethod
    def abort(self) -> None:
        """Cancel in-flight ops and latch an aborted error."""

    @abstractmethod
    def errored(self) -> Optional[Exception]:
        """Latched failure, or None if healthy."""

    def shutdown(self) -> None:
        self.abort()

    def set_timeout(self, timeout: float) -> None:
        self._timeout = timeout

    # -- topology ----------------------------------------------------------

    @abstractmethod
    def rank(self) -> int: ...

    @abstractmethod
    def size(self) -> int: ...

    # -- collectives -------------------------------------------------------

    @abstractmethod
    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work: ...

    @abstractmethod
    def allgather(self, array: Any) -> Work:
        """Resolves to a list of ``size()`` arrays, indexed by rank."""

    @abstractmethod
    def broadcast(self, array: Any, root: int = 0) -> Work: ...

    @abstractmethod
    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        """Reduce then scatter row-chunks; resolves to this rank's chunk.

        ``array.shape[0]`` must be divisible by ``size()``.
        """

    @abstractmethod
    def alltoall(self, arrays: "List[Any]") -> Work:
        """Exchange: sends arrays[i] to rank i; resolves to received list."""

    def sendrecv(self, array: Any, dst: int, src: int, tag: int = 0) -> Work:
        """Simultaneous send-to-``dst`` + receive-from-``src`` as ONE op;
        resolves to the received array.  The deadlock-free pairwise
        exchange primitive multi-hop reduction plans are built from
        (ops/topology.py): both directions drain concurrently even when
        payloads exceed socket buffers, which two serialized send/recv
        ops on the single worker cannot guarantee.  Backends without a
        native implementation reject it."""
        return failed_work(
            RuntimeError(f"{type(self).__name__} does not support sendrecv")
        )

    @abstractmethod
    def send(self, array: Any, dst: int, tag: int = 0) -> Work: ...

    @abstractmethod
    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        """Resolves to the received array (shape/dtype carried on the wire).
        ``out``: backends that can, receive in place into this buffer."""

    def barrier(self) -> Work:
        return self.allreduce([np.zeros(1, dtype=np.float32)])


class ProcessGroupDummy(ProcessGroup):
    """World-size-1 no-op group (reference: torchft/process_group.py:960-1081).

    Used to bootstrap wrappers before the first quorum and in tests.
    """

    def __init__(self, rank: int = 0, world: int = 1, timeout: float = 60.0) -> None:
        super().__init__(timeout)
        assert world == 1, "ProcessGroupDummy only supports world_size 1"
        self._rank = rank
        self._world = world
        self._errored: Optional[Exception] = None
        self.configure_count = 0

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self.configure_count += 1
        self._errored = None

    def abort(self) -> None:
        self._errored = RuntimeError("aborted")

    def errored(self) -> Optional[Exception]:
        return self._errored

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world

    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work:
        return completed_work(
            [_allreduce_out(a, _allreduce_in(a).copy()) for a in arrays]
        )

    def allgather(self, array: Any) -> Work:
        return completed_work(_host_result([_as_numpy(array).copy()]))

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return completed_work(_host_result(_as_numpy(array).copy()))

    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        return completed_work(_host_result(_as_numpy(array).copy()))

    def alltoall(self, arrays: "List[Any]") -> Work:
        return completed_work(_host_result([_as_numpy(a).copy() for a in arrays]))

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return failed_work(RuntimeError("send not supported on world-size-1 group"))

    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        return failed_work(RuntimeError("recv not supported on world-size-1 group"))


# ---------------------------------------------------------------------------
# TCP backend (host-mediated DCN collectives — the Gloo analog)
# ---------------------------------------------------------------------------

_HELLO_MAGIC = 0x7F7A11AA


class _PeerConn:
    """A connected, rank-identified socket to one peer."""

    def __init__(self, sock: socket.socket, rank: int) -> None:
        self.sock = sock
        self.rank = rank
        sock.setblocking(True)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _TokenBucket:
    """Egress token bucket shared by a PG's sender threads.

    ``consume(n)`` debits ``n`` bytes and sleeps off any debt, so the
    long-run egress rate converges to ``rate`` bytes/s while short bursts
    up to ``burst`` pass unthrottled (one socket-buffer's worth — shaping
    below that granularity would only measure syscall overhead).  The
    sleep happens OUTSIDE the lock: concurrent senders each serve their
    own debt, and because debits are serialized under the lock the debt
    each sender sleeps for is its own marginal contribution.
    """

    def __init__(self, rate_bytes_per_s: float, burst: int = 4 << 20) -> None:
        self.rate = float(rate_bytes_per_s)
        self.burst = float(burst)
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = _lockcheck.lock("pg.token_bucket")
        # Own ledger (bytes debited / seconds slept serving debt): tests
        # assert pacing on these instead of wall-clock deltas, which CI
        # scheduler noise can invert.
        self.consumed_bytes = 0
        self.slept_s = 0.0

    def consume(self, nbytes: int) -> float:
        """Debit ``nbytes``; returns the seconds slept serving the debt
        (the shaper-wait the per-peer wait accounting attributes)."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            self._tokens -= nbytes
            self.consumed_bytes += int(nbytes)
            debt = -self._tokens
        if debt > 0:
            wait = debt / self.rate
            time.sleep(wait)
            with self._lock:
                self.slept_s += wait
            return wait
        return 0.0


class _PGAborted(RuntimeError):
    pass


class NotParticipatingError(RuntimeError):
    """Raised by ``ManagedProcessGroup.rank()`` when the replica has no rank
    in the current quorum (it is healing or excluded).  Contrast with the
    reference, whose managed PG always has a local rank (torchft/
    process_group.py:1233-1266) because healing replicas still hold one."""


class ProcessGroupTCP(ProcessGroup):
    """Fault-tolerant collectives over a full TCP mesh of host processes.

    The cross-replica-group (DCN) collective backend: rendezvous through the
    quorum primary's store under a per-quorum prefix (set by the Manager,
    reference: torchft/manager.py:659-690), full-mesh connect, then ring
    algorithms on host buffers.  Bandwidth-optimal ring allreduce /
    reduce-scatter; direct sends for broadcast/gather at the small world
    sizes of the replica dimension.

    All ops run in submission order on a single worker thread; both
    endpoints of each socket submit the same collective sequence so streams
    stay in sync (the standard collective contract).
    """

    def __init__(
        self,
        timeout: float = 60.0,
        bandwidth_gbps: "Optional[float]" = None,
        rtt_ms: "Optional[float]" = None,
    ) -> None:
        super().__init__(timeout)
        self._rank = -1
        self._world = 0
        self._peers: Dict[int, _PeerConn] = {}
        self._listener: Optional[socket.socket] = None
        self._errored: Optional[Exception] = None
        self._aborted = False
        self._generation = 0
        # Egress bandwidth shaping (token bucket across all sender
        # threads).  Two uses: benchmarking the quantized wire under a
        # *measured* DCN bandwidth instead of loopback's effectively
        # infinite one, and capping a training job's DCN footprint on
        # shared links.  None = unshaped; TORCHFT_WIRE_GBPS supplies a
        # default (decimal GB/s, e.g. "0.5").
        if bandwidth_gbps is None:
            env = env_float("TORCHFT_WIRE_GBPS", 0.0)
            bandwidth_gbps = env if env > 0 else None
        self._bucket: "Optional[_TokenBucket]" = (
            _TokenBucket(bandwidth_gbps * 1e9) if bandwidth_gbps else None
        )
        # WAN latency model (TORCHFT_WIRE_RTT_MS): per-MESSAGE first-byte
        # delay on the shaped path, charged only on sends that cross a
        # host/slice boundary of the TORCHFT_TOPOLOGY descriptor (flat /
        # unset topology = every peer is across a boundary, the
        # multi-region flat-ring premise).  Deliberately decoupled from
        # the token bucket: the bucket paces PAYLOAD CHUNKS (bandwidth
        # debt accumulates per byte), while latency is paid once per
        # message no matter how many pacing chunks it splits into — so a
        # K-chunk message costs rtt + bytes/rate, never K*rtt
        # (tests/test_topology.py pins the composition).  The token
        # bucket is boundary-scoped the same way: with a declared
        # topology, BOTH shaping legs model the WAN boundary and
        # intra-host messages ride the (loopback/ICI-fast) local fabric
        # unshaped; with flat/unset topology every peer is across the
        # boundary, so existing shaped setups behave byte-identically.
        if rtt_ms is None:
            rtt_ms = env_float("TORCHFT_WIRE_RTT_MS", 0.0)
        self._rtt_s = max(rtt_ms, 0.0) / 1e3
        # ranks whose messages cross a topology boundary (computed per
        # configure from TORCHFT_TOPOLOGY; empty while unconfigured)
        self._inter_peers: "frozenset[int]" = frozenset()
        # link-state plane identities (utils/linkstats.py): per peer
        # rank, the peer host learned at configure and the derived
        # (link label, is_local) pair — a same-host peer across a
        # declared topology boundary gets a ``host#gN`` pseudo-host so
        # the shaped link is never averaged into the local fabric
        self._peer_hosts: "Dict[int, str]" = {}
        self._link_labels: "Dict[int, Tuple[str, bool]]" = {}
        # In-flight op handle in the process-wide flight recorder
        # (utils/flightrecorder.py; subsumes the old ad-hoc ``_flight``
        # dict).  The FlightOp serializes its own updates (worker + sender
        # threads write); _flight_swap_lock guards the TAKE of the handle
        # so the worker's success path and a concurrent abort() cannot
        # both finish the same op (the loser would mislabel a completed
        # collective as aborted).
        self._flight_op: "Optional[_flightrec.FlightOp]" = None
        self._flight_swap_lock = _lockcheck.lock("pg.tcp.flight_swap")
        self._replica_id = ""
        self._lock = _lockcheck.lock("pg.tcp.state")
        self._worker: Optional[threading.Thread] = None
        self._sender: "Optional[concurrent_futures.ThreadPoolExecutor]" = None
        self._queue: "queue.Queue[Optional[Tuple[int, Callable[[], Any], Future]]]" = (
            queue.Queue()
        )

    def set_bandwidth(self, gbps: "Optional[float]") -> None:
        """(Re)shape egress to ``gbps`` decimal GB/s; None removes the cap.
        Takes effect from the next send — in-flight chunks finish at the
        old rate."""
        self._bucket = _TokenBucket(gbps * 1e9) if gbps else None

    def set_rtt(self, rtt_ms: "Optional[float]") -> None:
        """(Re)set the modeled per-message boundary latency; None/0
        removes it.  Takes effect from the next send; boundary membership
        re-derives at the next configure."""
        self._rtt_s = max(rtt_ms or 0.0, 0.0) / 1e3

    def _boundary_peers(self, rank: int, world: int) -> "frozenset[int]":
        """Peers across a TORCHFT_TOPOLOGY host/slice boundary — the set
        BOTH wire-model legs (RTT and token bucket) charge on.
        Flat/unset topology: every peer (a flat ring spanning regions
        pays the boundary on every hop — and pre-topology shaped setups
        keep their exact behavior).  Computed unconditionally per
        configure: ``set_bandwidth``/``set_rtt`` may arm shaping AFTER
        membership forms."""
        if world <= 1:
            return frozenset()
        from torchft_tpu_torch.ops.topology import resolve_topology

        topo = resolve_topology(world)
        if topo is None:
            return frozenset(r for r in range(world) if r != rank)
        return frozenset(
            r for r in range(world) if r != rank and topo.inter(rank, r)
        )

    def _link_peer_labels(
        self, world: int
    ) -> "Dict[int, Tuple[str, bool]]":
        """(link label, is_local) per connected peer for the passive
        link-state plane.  Cross-host peers key by their real host; a
        same-host peer across the declared topology boundary keys by the
        ``host#gN`` pseudo-host (its topology group) so WAN-modeled and
        local-fabric traffic never share an estimator — intra-host pairs
        report unshaped-fast, boundary pairs report the modeled link."""
        from torchft_tpu_torch.ops.topology import resolve_topology
        from torchft_tpu_torch.utils.hostident import local_host_identities

        topo = resolve_topology(world) if world > 1 else None
        local_ids = local_host_identities()
        labels: "Dict[int, Tuple[str, bool]]" = {}
        for r, host in self._peer_hosts.items():
            wan = r in self._inter_peers
            if wan and topo is not None and host in local_ids:
                label = f"{host}#g{topo.group_index(r)}"
            else:
                label = host
            labels[r] = (label, not wan)
        return labels

    # -- lifecycle ---------------------------------------------------------

    def configure(
        self, store_addr: str, replica_id: str, rank: int, world_size: int
    ) -> None:
        # chaos site: a reconfigure failure here surfaces to the Manager's
        # configure try-block, which latches it and re-forms next quorum
        _faults.check("pg.reconfigure", replica=replica_id)
        self._replica_id = replica_id
        t_cfg_ns = time.time_ns()
        self._teardown()
        deadline = time.monotonic() + self._timeout

        with self._lock:
            self._errored = None
            self._aborted = False
            self._generation += 1
            gen = self._generation
        self._rank = rank
        self._world = world_size
        self._inter_peers = self._boundary_peers(rank, world_size)

        if world_size == 1:
            self._peers = {}
            self._peer_hosts = {}
            self._link_labels = {}
            self._start_worker(gen)
            _metrics.PG_RECONFIGURES.labels(transport="tcp").inc()
            _flightrec.record(
                "pg.configure", start_ns=t_cfg_ns, replica_id=replica_id,
                rank=rank, world=world_size,
            )
            return

        addr, _, prefix = store_addr.partition("/")
        store = StoreClient(addr, connect_timeout=self._timeout)
        try:
            try:
                listener = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
                listener.bind(("", 0))
            except OSError:
                # Host without IPv6 (ipv6.disable=1 containers).
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.bind(("", 0))
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.listen(world_size)
            self._listener = listener
            # Advertise the interface address peers can actually route to:
            # the local IP of a connection toward the store host (hostnames
            # may not resolve across container boundaries).
            host = _routable_local_ip(addr)
            port = listener.getsockname()[1]
            store.set(f"{prefix}/rank_{rank}", f"{host}:{port}")

            peers: Dict[int, _PeerConn] = {}
            peer_hosts: Dict[int, str] = {}
            # Deterministic connect direction avoids duplicate links: lower
            # ranks dial higher ranks; higher ranks accept.
            for peer in range(rank + 1, world_size):
                peer_addr = store.get(
                    f"{prefix}/rank_{peer}",
                    timeout=max(deadline - time.monotonic(), 0.001),
                )
                phost, _, pport = peer_addr.rpartition(":")
                sock = socket.create_connection(
                    (phost, int(pport)),
                    timeout=max(deadline - time.monotonic(), 0.001),
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(struct.pack(">II", _HELLO_MAGIC, rank))
                peers[peer] = _PeerConn(sock, peer)
                peer_hosts[peer] = phost
            for _ in range(rank):
                listener.settimeout(max(deadline - time.monotonic(), 0.001))
                sock, _ = listener.accept()
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                magic, peer_rank = struct.unpack(">II", self._read_exact_sock(sock, 8, deadline))
                if magic != _HELLO_MAGIC:
                    raise RuntimeError("bad hello from peer")
                peers[peer_rank] = _PeerConn(sock, peer_rank)
                try:
                    peer_hosts[peer_rank] = sock.getpeername()[0]
                except OSError:
                    peer_hosts[peer_rank] = "unknown"
            self._peers = peers
            self._peer_hosts = peer_hosts
            self._link_labels = self._link_peer_labels(world_size)
            self._start_worker(gen)
            _metrics.PG_RECONFIGURES.labels(transport="tcp").inc()
            _flightrec.record(
                "pg.configure", start_ns=t_cfg_ns, replica_id=replica_id,
                rank=rank, world=world_size,
            )
        except Exception as e:
            _flightrec.record(
                "pg.configure", status="error", start_ns=t_cfg_ns,
                replica_id=replica_id, rank=rank, world=world_size,
                error=repr(e),
            )
            self._teardown()
            raise
        finally:
            store.close()

    def _start_worker(self, gen: int) -> None:
        # Fresh queue per generation so stale ops/poison pills from a prior
        # configure can never reach the new worker. Swapped under the lock so
        # _submit can never enqueue onto a retired queue.
        with self._lock:
            self._queue = queue.Queue()
            self._sender = concurrent_futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pg_tcp_sender"
            )
            self._worker = threading.Thread(
                target=self._worker_loop,
                args=(gen, self._queue),
                name="pg_tcp_worker",
                daemon=True,
            )
            self._worker.start()

    def _teardown(self) -> None:
        with self._lock:
            self._generation += 1  # invalidate the running worker
            peers = list(self._peers.values())
            self._peers = {}
            listener = self._listener
            self._listener = None
            old_queue = self._queue
            old_queue.put(None)  # wake the worker so it can exit
        for p in peers:
            p.close()
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout=5.0)
        with self._lock:
            # After this, _submit fails fast instead of enqueueing into limbo.
            self._worker = None
            sender, self._sender = self._sender, None
        if sender is not None:
            # don't wait: a sendall stuck on a dead peer unwedges itself when
            # the socket close (above) fails it
            sender.shutdown(wait=False)
        # Fail any ops still sitting in the retired queue so no Work handle
        # is left unresolved (a hang is worse than an error in FT code).
        while True:
            try:
                item = old_queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[2].set_exception(_PGAborted("process group torn down"))

    def abort(self) -> None:
        self._dump_flight("process group aborted", dump=False)
        _flightrec.record(
            "pg.abort", status="abort", replica_id=self._replica_id,
            rank=self._rank, world=self._world,
        )
        # one dump per abort, whether or not an op was in flight: the ring
        # around the abort IS the postmortem evidence
        _flightrec.dump("process group aborted", trigger="pg_abort")
        _metrics.PG_ABORTS.labels(transport="tcp").inc()
        with self._lock:
            self._aborted = True
            if self._errored is None:
                self._errored = _PGAborted("process group aborted")
        self._teardown()

    def errored(self) -> Optional[Exception]:
        return self._errored

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world

    # -- op submission -----------------------------------------------------

    def _submit(self, fn: "Callable[[], Any]", op: str = "op") -> Work:
        fut: Future = Future()
        with self._lock:
            if self._errored is not None:
                return failed_work(self._errored)
            if self._worker is None:
                return failed_work(
                    _PGAborted("process group not configured/running")
                )
            # Enqueue under the lock: the queue object is swapped by
            # _teardown/_start_worker under the same lock, so this item can
            # never land on a retired queue with no worker to fail it.
            self._queue.put((self._generation, fn, fut, op))
        return Work(fut)

    def _worker_loop(self, gen: int, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            self._run_item(gen, item)
            # an idle worker pins nothing: the last op's closure, inputs,
            # future and result (whose callbacks reach the Manager and the
            # training state) go before the next blocking get
            del item

    def _run_item(
        self, gen: int, item: "Tuple[int, Callable[[], Any], Future, str]"
    ) -> None:
        """Run one queued op on the worker (or fail it if its generation
        is gone) and resolve its future."""
        item_gen, fn, fut, op = item
        with self._lock:
            superseded = self._generation != gen
            errored = self._errored
        if superseded or item_gen != gen or errored is not None:
            # Keep draining so every queued Work resolves — abandoned
            # futures would hang their waiters forever.
            fut.set_exception(
                errored or _PGAborted("process group reconfigured")
            )
            return
        self._flight_op = _flightrec.start(
            op,
            kind="collective",
            generation=item_gen,
            rank=self._rank,
            world=self._world,
            replica_id=self._replica_id,
        )
        try:
            result = fn()
            with self._flight_swap_lock:
                flight_op, self._flight_op = self._flight_op, None
            if flight_op is not None:
                flight_op.finish("ok")
            fut.set_result(_host_result(result))
        except Exception as e:  # noqa: BLE001 - latch every op failure
            # Flight-recorder dump BEFORE latching: when a wedged
            # collective dies (deadline, peer reset), the op-level state
            # — what was in flight, with whom, how far it got — is the
            # evidence the postmortem needs (reference dumps the NCCL
            # flight recorder on abort for the same reason,
            # torchft/process_group.py:89-108,830-838).
            self._dump_flight(f"collective failed: {e!r}", error=repr(e))
            with self._lock:
                if self._errored is None:
                    self._errored = e
            fut.set_exception(e)

    # -- flight recorder ---------------------------------------------------

    def _flight_io(self, **kw: Any) -> None:
        """Merge current transfer state (direction, peer, tag, bytes) into
        the in-flight op record (worker or sender thread)."""
        op = self._flight_op
        if op is not None:
            op.update(**kw)

    def _flight_progress(self, nbytes: int) -> None:
        op = self._flight_op
        if op is not None:
            op.add_bytes(nbytes)

    def _dump_flight(self, reason: str, dump: bool = True, **extra: Any) -> None:
        """Finish the in-flight op as failed: the completed record lands in
        the process flight ring, a legacy ``abort`` event goes to the
        structured pipeline (JSONL sink when TORCHFT_EVENTS_FILE is set),
        and — unless the caller dumps separately — the whole ring is
        dumped to TORCHFT_FLIGHT_FILE."""
        with self._flight_swap_lock:
            flight_op, self._flight_op = self._flight_op, None
        if flight_op is None:
            return
        # Best-effort: the recorder must never mask the collective error.
        try:
            rec = flight_op.finish("error", reason=reason, **extra)
            from torchft_tpu_torch.utils.logging import log_event

            f = {
                k: v
                for k, v in rec.items()
                if k not in ("status", "start_ns", "end_ns", "kind")
            }
            deadline = f.pop("deadline_mono", None)
            if deadline is not None:
                f["deadline_remaining_s"] = round(
                    deadline - time.monotonic(), 3
                )
            f["in_flight_s"] = round(
                (rec["end_ns"] - rec["start_ns"]) / 1e9, 3
            )
            log_event("abort", reason, **f)
            if dump:
                _flightrec.dump(reason, trigger="pg_abort")
        except Exception:  # noqa: BLE001 - recorder must never mask the error
            logger.exception("flight-recorder dump failed")

    # -- wire helpers ------------------------------------------------------

    @staticmethod
    def _read_exact_sock(sock: socket.socket, n: int, deadline: float) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            sock.settimeout(max(deadline - time.monotonic(), 0.001))
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed connection")
            buf.extend(chunk)
        return bytes(buf)

    def _peer(self, rank: int) -> _PeerConn:
        peer = self._peers.get(rank)
        if peer is None:
            raise _PGAborted(f"no connection to rank {rank}")
        return peer

    def _read_into_sock(
        self, sock: socket.socket, view: memoryview, deadline: float
    ) -> None:
        """recv_into a buffer — zero intermediate copies for payloads."""
        off, n = 0, len(view)
        while off < n:
            sock.settimeout(max(deadline - time.monotonic(), 0.001))
            got = sock.recv_into(view[off:], n - off)
            if got == 0:
                raise ConnectionError("peer closed connection")
            off += got
            self._flight_progress(got)

    def _send_msg(self, dst: int, tag: int, array: np.ndarray, deadline: float) -> None:
        peer = self._peer(dst)
        dtype = _dtype_name(array)
        array = np.ascontiguousarray(array)
        header = pickle.dumps({"tag": tag, "shape": array.shape, "dtype": dtype})
        self._flight_io(
            send_peer=dst, send_tag=tag, send_bytes=array.nbytes,
            deadline_mono=deadline,
        )
        wan = dst in self._inter_peers
        t0 = time.perf_counter()
        shaper_wait = 0.0
        if wan and self._rtt_s > 0.0:
            # First-byte latency of the WAN model: once per MESSAGE,
            # before any byte moves, independent of the bandwidth debt
            # the pacing loop below accrues (K pacing chunks still pay
            # 1x RTT).  Charged in the sender so a blocked receiver
            # observes the first byte RTT late, like a real WAN socket.
            time.sleep(self._rtt_s)
            shaper_wait += self._rtt_s
        # boundary-scoped shaping: only messages crossing the declared
        # topology boundary ride the modeled WAN link (flat/unset
        # topology: every peer — see __init__)
        bucket = self._bucket if wan else None
        if bucket is not None:
            shaper_wait += bucket.consume(8 + len(header))
        peer.sock.settimeout(max(deadline - time.monotonic(), 0.001))
        peer.sock.sendall(struct.pack(">II", len(header), array.nbytes) + header)
        if array.nbytes:
            # uint8 view, not memoryview.cast("B"): ml_dtypes arrays
            # (bfloat16/fp8 — the TPU training dtypes) have no
            # buffer-protocol format char and raise in cast(). The payload
            # still goes to the kernel straight from the array's buffer.
            view = memoryview(array.reshape(-1).view(np.uint8))
            if bucket is None:
                peer.sock.sendall(view)
            else:
                # shaped path: pace in 1 MB chunks so the bucket's sleeps
                # interleave with the peer's compute at sub-fragment
                # granularity (a single consume() of a GB payload would
                # model a link with GB-deep switch buffers)
                chunk_len = 1 << 20
                for off in range(0, len(view), chunk_len):
                    chunk = view[off : off + chunk_len]
                    shaper_wait += bucket.consume(len(chunk))
                    peer.sock.settimeout(
                        max(deadline - time.monotonic(), 0.001)
                    )
                    peer.sock.sendall(chunk)
        # Passive link-state measurement (utils/linkstats.py): every
        # completed send is one sample — bytes + wall on the reduction
        # plane, first-byte = the modeled RTT leg.  Shaper waits are
        # additionally attributed per peer host (worst-K label tier).
        label, is_local = self._link_labels.get(dst, ("unknown", not wan))
        _linkstats.record(
            label,
            "reduction",
            8 + len(header) + array.nbytes,
            time.perf_counter() - t0,
            first_byte_s=self._rtt_s if (wan and self._rtt_s > 0.0) else 0.0,
            local=is_local,
        )
        if shaper_wait > 0.0:
            _metrics.PG_WIRE_WAIT.labels(
                peer=_linkstats.LINKS.peer_topk_label(label)
            ).inc(shaper_wait)

    def _recv_msg(
        self,
        src: int,
        tag: int,
        deadline: float,
        out: "Optional[np.ndarray]" = None,
    ) -> np.ndarray:
        """Receive one tagged array; ``out`` receives in place (zero-alloc
        fast path for ring steps — reference pg_transport in-place recv
        analog, torchft/checkpointing/pg_transport.py:230-300)."""
        peer = self._peer(src)
        # record the blocked-on peer BEFORE the header read: a wedged recv
        # (peer never sends) hangs right here, and that is exactly the state
        # the flight recorder must capture
        self._flight_io(recv_peer=src, recv_tag=tag, deadline_mono=deadline)
        hlen, nbytes = struct.unpack(
            ">II", self._read_exact_sock(peer.sock, 8, deadline)
        )
        header = pickle.loads(self._read_exact_sock(peer.sock, hlen, deadline))
        if header["tag"] != tag:
            raise RuntimeError(
                f"collective tag mismatch: expected {tag}, got {header['tag']}"
            )
        bf16 = header["dtype"] == _BF16
        if out is None:
            # Pool-backed receive: repeated collective shapes (ring chunks,
            # the quantized pipeline's per-chunk wire buffers) re-take the
            # SAME pages their consumers gave back, so steady-state receive
            # allocation — and its mmap page-fault bill — is zero.  Buffers
            # that escape to callers simply never return to the pool (take
            # falls back to np.empty on a miss), same contract as before.
            out = _pool.take(
                header["shape"],
                np.dtype(np.uint16) if bf16 else np.dtype(header["dtype"]),
            )
            if out.nbytes != nbytes:
                raise RuntimeError(
                    f"collective payload size mismatch: header says {nbytes},"
                    f" shape/dtype imply {out.nbytes}"
                )
        else:
            _check_recv_buffer(out, header["shape"], header["dtype"])
            if out.nbytes != nbytes:
                raise RuntimeError(
                    f"collective payload size mismatch: header says {nbytes},"
                    f" shape/dtype imply {out.nbytes}"
                )
        self._flight_io(recv_bytes=nbytes)
        if nbytes:
            # uint8 view for ml_dtypes compat (see _send_msg)
            self._read_into_sock(
                peer.sock, memoryview(out.reshape(-1).view(np.uint8)), deadline
            )
        return out.view(_BF16Bits) if bf16 else out

    def _exchange(
        self,
        send_dst: int,
        send_tag: int,
        send_array: np.ndarray,
        recv_src: int,
        recv_tag: int,
        deadline: float,
        recv_out: "Optional[np.ndarray]" = None,
    ) -> np.ndarray:
        """Simultaneous send+recv without deadlocking on full TCP buffers.

        Ring steps send and receive concurrently; pushing the send to the
        persistent sender thread keeps both directions draining even when
        payloads exceed socket buffer sizes.
        """
        sender = self._sender
        if sender is None:
            raise _PGAborted("process group not configured/running")
        send_fut = sender.submit(
            self._send_msg, send_dst, send_tag, send_array, deadline
        )
        send_err: "Optional[BaseException]" = None
        try:
            received = self._recv_msg(recv_src, recv_tag, deadline, out=recv_out)
        finally:
            # always reap the send: the socket stream must never be left
            # mid-write when the next step starts (a recv error still
            # propagates; it takes precedence over any send error)
            try:
                send_fut.result(
                    timeout=max(deadline - time.monotonic(), 0.001) + 1.0
                )
            except concurrent_futures.TimeoutError:
                send_err = TimeoutError(
                    "collective send did not complete by deadline"
                )
            except BaseException as e:  # noqa: BLE001 - re-raised below
                send_err = e
        if send_err is not None:
            raise send_err
        return received

    # -- collectives -------------------------------------------------------

    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work:
        deadline_budget = self._timeout

        def run() -> List[np.ndarray]:
            # device→host materialization happens HERE, on the PG worker:
            # for CUDA-tensor inputs `_as_numpy` blocks on device compute +
            # transfer, and doing that on the caller thread would stall it
            # for the whole sync instead of letting the submit return
            # immediately (the DiLoCo overlap pattern: outer-grad allreduce
            # rides behind the next fragment's inner steps).
            deadline = time.monotonic() + deadline_budget
            np_arrays = [_allreduce_in(a) for a in arrays]
            reduced = self._allreduce_coalesced(np_arrays, op, deadline)
            return [_allreduce_out(a, r) for a, r in zip(arrays, reduced)]

        work = self._submit(run, op="allreduce")
        # Wire accounting on the UNQUANTIZED path too (parity with the
        # quantized collectives' measured wire_bytes, so bench/diagnose
        # compare f32 vs int8 traffic honestly): per-rank ring egress from
        # the same bucket plan the reduce will use, computed synchronously
        # from shapes/dtypes — device arrays stay unmaterialized.
        def _leaf(a: Any) -> "Tuple[np.dtype, int]":
            if isinstance(a, torch.Tensor):
                if a.dtype == torch.bfloat16:
                    return np.dtype(np.float32), a.numel()
                return _accumulation_dtype(_np_dtype(a)), a.numel()
            if not hasattr(a, "dtype") or not hasattr(a, "size"):
                a = np.asarray(a)
            return _accumulation_dtype(np.dtype(a.dtype)), int(a.size)

        try:
            work.wire_bytes = self._ring_wire_bytes(
                [_leaf(a) for a in arrays], self._world
            )
            work.unquantized_wire_bytes = work.wire_bytes
        except Exception:  # noqa: BLE001 - accounting must not fail the op
            logger.debug("allreduce wire accounting failed", exc_info=True)
        return work

    # Pack small same-acc-dtype leaves into buckets up to this many bytes.
    # Below the cap, coalescing wins (one ring amortizes per-message
    # latency: measured 10x at 28 tiny leaves); above it, the extra
    # concat/split memcpy costs more than the saved round trips, so big
    # leaves ring solo (zero-copy path).
    BUCKET_BYTES = 4 * 1024 * 1024

    @classmethod
    def _plan_buckets(
        cls, leaves: "List[Tuple[np.dtype, int]]"
    ) -> "List[Tuple[np.dtype, List[int], int]]":
        """Greedy same-accumulation-dtype buckets under ``BUCKET_BYTES``.

        ``leaves``: per-leaf (acc dtype, element count).  Returns
        ``(acc, leaf indices, total elements)`` per bucket, order-
        preserving — the one plan both the reduce and the wire-byte
        accounting derive from.
        """
        buckets: "List[Tuple[np.dtype, List[int], int]]" = []
        bucket_bytes: "List[int]" = []
        open_bucket: "Dict[np.dtype, int]" = {}  # acc dtype -> bucket index
        for i, (acc, size) in enumerate(leaves):
            nbytes = size * acc.itemsize
            if nbytes >= cls.BUCKET_BYTES:
                buckets.append((acc, [i], size))
                bucket_bytes.append(nbytes)
                continue
            bi = open_bucket.get(acc)
            if bi is not None and bucket_bytes[bi] + nbytes <= cls.BUCKET_BYTES:
                buckets[bi][1].append(i)
                buckets[bi] = (acc, buckets[bi][1], buckets[bi][2] + size)
                bucket_bytes[bi] += nbytes
            else:
                buckets.append((acc, [i], size))
                bucket_bytes.append(nbytes)
                open_bucket[acc] = len(buckets) - 1
        return buckets

    @classmethod
    def _ring_wire_bytes(
        cls, leaves: "List[Tuple[np.dtype, int]]", world: int
    ) -> int:
        """Per-rank ring-allreduce egress for these leaves: each bucket
        rings once, sending 2*(w-1) chunk-sized messages (reduce-scatter
        half + allgather half) of its accumulation dtype."""
        if world <= 1:
            return 0
        total = 0
        for acc, _idxs, elems in cls._plan_buckets(leaves):
            chunk = -(-elems // world)
            total += 2 * (world - 1) * chunk * acc.itemsize
        return total

    def _allreduce_coalesced(
        self, arrays: "List[np.ndarray]", op: str, deadline: float
    ) -> "List[np.ndarray]":
        """Bucketized allreduce of a gradient pytree's leaves.

        A gradient pytree is many small leaves; ringing each one costs
        2*(w-1) latency-bound exchanges per leaf. Same-accumulation-dtype
        leaves pack greedily into <= BUCKET_BYTES buckets that ring once
        (the reference's bucketized-allreduce idea,
        TORCHFT_USE_BUCKETIZATION, local_sgd.py:29); oversized leaves ring
        solo on the zero-copy path. Order-preserving.
        """
        if len(arrays) <= 1 or self._world == 1:
            # world==1: _allreduce_one is a pure copy; skip bucketing work
            # entirely (the post-failure shrunken-group hot path)
            return [self._allreduce_one(a, op, deadline) for a in arrays]
        buckets = self._plan_buckets(
            [(_accumulation_dtype(a.dtype), a.size) for a in arrays]
        )
        results: "List[Optional[np.ndarray]]" = [None] * len(arrays)
        for acc_dtype, idxs, _ in buckets:
            if len(idxs) == 1:
                i = idxs[0]
                results[i] = self._allreduce_one(arrays[i], op, deadline)
                continue
            # cast leaves individually: mixed input dtypes sharing one acc
            # dtype (f16+f32, bf16) may not have a numpy promotion rule
            flat = np.concatenate(
                [
                    np.ascontiguousarray(arrays[i])
                    .ravel()
                    .astype(acc_dtype, copy=False)
                    for i in idxs
                ]
            )
            reduced = self._allreduce_one(flat, op, deadline)
            off = 0
            for i in idxs:
                n = arrays[i].size
                results[i] = (
                    reduced[off : off + n]
                    .astype(arrays[i].dtype, copy=False)
                    .reshape(arrays[i].shape)
                )
                off += n
        return results  # type: ignore[return-value]

    def _allreduce_one(self, array: np.ndarray, op: str, deadline: float) -> np.ndarray:
        w, r = self._world, self._rank
        if w == 1:
            return array.copy()
        acc_dtype = _accumulation_dtype(array.dtype)
        inplace_reduce = _REDUCE_UFUNCS[op]
        n = array.size
        chunk = -(-n // w)
        # single private buffer; chunks are views of it, so ring steps
        # receive in place and reduce in place — the only full-size copies
        # are the pad-in and (if dtype widened) the cast back out
        # buf escapes to the caller as the result view — not poolable;
        # scratch is private to this call and its size repeats every ring
        # (page-fault amortization, utils/bufpool.py)
        buf = np.empty(chunk * w, dtype=acc_dtype)
        buf[:n] = array.ravel()
        if chunk * w > n:
            buf[n:] = 0
        chunks = [buf[i * chunk : (i + 1) * chunk] for i in range(w)]
        scratch = _pool.take(chunk, acc_dtype)

        nxt, prv = (r + 1) % w, (r - 1) % w
        # ring reduce-scatter: after w-1 steps, chunk (r+1)%w is fully reduced
        for step in range(w - 1):
            send_idx = (r - step) % w
            recv_idx = (r - step - 1) % w
            self._exchange(
                nxt, 100 + step, chunks[send_idx], prv, 100 + step, deadline,
                recv_out=scratch,
            )
            inplace_reduce(chunks[recv_idx], scratch, out=chunks[recv_idx])
        # ring allgather of the reduced chunks, received straight into place
        for step in range(w - 1):
            send_idx = (r - step + 1) % w
            recv_idx = (r - step) % w
            self._exchange(
                nxt, 200 + step, chunks[send_idx], prv, 200 + step, deadline,
                recv_out=chunks[recv_idx],
            )
        _pool.give(scratch)
        result = buf[:n]
        if op == REDUCE_AVG:
            if np.issubdtype(acc_dtype, np.floating):
                result /= w
            else:
                result = result / w
        return np.asarray(result, dtype=array.dtype).reshape(array.shape)

    def allgather(self, array: Any) -> Work:
        np_array = _as_numpy(array)
        deadline_budget = self._timeout

        def run() -> List[np.ndarray]:
            deadline = time.monotonic() + deadline_budget
            w, r = self._world, self._rank
            if w == 1:
                return [np_array.copy()]
            pieces: List[Optional[np.ndarray]] = [None] * w
            pieces[r] = np.require(np_array, requirements="C")
            nxt, prv = (r + 1) % w, (r - 1) % w
            for step in range(w - 1):
                send_idx = (r - step) % w
                recv_idx = (r - step - 1) % w
                pieces[recv_idx] = self._exchange(
                    nxt, 300 + step, pieces[send_idx], prv, 300 + step, deadline
                )
            # received pieces are already private allocations from
            # _recv_msg; only the own piece aliases the caller's array and
            # needs a defensive copy
            pieces[r] = pieces[r].copy()  # type: ignore[union-attr]
            return pieces  # type: ignore[return-value]

        return self._submit(run, op="allgather")

    def broadcast(self, array: Any, root: int = 0) -> Work:
        np_array = _as_numpy(array)
        deadline_budget = self._timeout

        def run() -> np.ndarray:
            deadline = time.monotonic() + deadline_budget
            w, r = self._world, self._rank
            if w == 1:
                return np_array.copy()
            if r == root:
                for peer in range(w):
                    if peer != r:
                        self._send_msg(peer, 400, np_array, deadline)
                return np_array.copy()
            return self._recv_msg(root, 400, deadline)

        return self._submit(run, op="broadcast")

    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        # bf16 reduces as allreduce does: widened exactly to f32, the
        # result rounded back to bf16 to nearest even
        np_array = _allreduce_in(array)
        deadline_budget = self._timeout

        def run() -> Any:
            deadline = time.monotonic() + deadline_budget
            w, r = self._world, self._rank
            if w == 1:
                return _allreduce_out(array, np_array.copy())
            if np_array.shape[0] % w != 0:
                raise ValueError(
                    f"reduce_scatter dim0 {np_array.shape[0]} not divisible by {w}"
                )
            inplace_reduce = _REDUCE_UFUNCS[op]
            rows = np_array.shape[0] // w
            acc_dtype = _accumulation_dtype(np_array.dtype)
            buf = np.empty(np_array.shape, dtype=acc_dtype)
            buf[...] = np_array
            chunks = [buf[i * rows : (i + 1) * rows] for i in range(w)]
            scratch = np.empty(chunks[0].shape, dtype=acc_dtype)
            nxt, prv = (r + 1) % w, (r - 1) % w
            # Ring schedule shifted by one vs allreduce so each rank ends
            # holding its *own* fully-reduced chunk r.
            for step in range(w - 1):
                send_idx = (r - step - 1) % w
                recv_idx = (r - step - 2) % w
                self._exchange(
                    nxt, 500 + step, chunks[send_idx], prv, 500 + step, deadline,
                    recv_out=scratch,
                )
                inplace_reduce(chunks[recv_idx], scratch, out=chunks[recv_idx])
            result = chunks[r]
            if op == REDUCE_AVG:
                if np.issubdtype(acc_dtype, np.floating):
                    result /= w
                else:
                    result = result / w
            # copy: returning a view of chunks[r] would pin the w-times
            # larger accumulation buffer for as long as the caller holds
            # the result
            return _allreduce_out(array, np.array(result, dtype=np_array.dtype))

        return self._submit(run, op="reduce_scatter")

    def alltoall(self, arrays: "List[Any]") -> Work:
        np_arrays = [_as_numpy(a) for a in arrays]
        deadline_budget = self._timeout

        def run() -> List[np.ndarray]:
            deadline = time.monotonic() + deadline_budget
            w, r = self._world, self._rank
            if len(np_arrays) != w:
                raise ValueError(f"alltoall needs {w} arrays, got {len(np_arrays)}")
            out: List[Optional[np.ndarray]] = [None] * w
            out[r] = np_arrays[r].copy()
            for offset in range(1, w):
                dst = (r + offset) % w
                src = (r - offset) % w
                out[src] = self._exchange(
                    dst, 600 + offset, np_arrays[dst], src, 600 + offset, deadline
                )
            return out  # type: ignore[return-value]

        return self._submit(run, op="alltoall")

    def sendrecv(self, array: Any, dst: int, src: int, tag: int = 0) -> Work:
        np_array = _as_numpy(array)
        deadline_budget = self._timeout

        def run() -> np.ndarray:
            deadline = time.monotonic() + deadline_budget
            if dst == self._rank and src == self._rank:
                return np.require(np_array, requirements="C").copy()
            # the same concurrent send+recv primitive the ring steps use:
            # the send drains on the sender thread while this worker
            # blocks on the receive, so paired exchanges never deadlock
            # on full TCP buffers
            return self._exchange(
                dst, 2000 + tag, np_array, src, 2000 + tag, deadline
            )

        return self._submit(run, op="sendrecv")

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        np_array = _as_numpy(array)
        deadline_budget = self._timeout

        def run() -> None:
            deadline = time.monotonic() + deadline_budget
            self._send_msg(dst, 1000 + tag, np_array, deadline)

        return self._submit(run, op="send")

    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        """``out``: receive straight into this buffer (shape/dtype must
        match the wire) — the zero-alloc path for healing into live state."""
        deadline_budget = self._timeout

        def run() -> np.ndarray:
            deadline = time.monotonic() + deadline_budget
            return self._recv_msg(src, 1000 + tag, deadline, out=out)

        return self._submit(run, op="recv")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class ProcessGroupWrapper(ProcessGroup):
    """Forwards every op to an inner PG; base for behavior-modifying wrappers."""

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__(pg._timeout)
        self._pg = pg

    @property
    def parent(self) -> ProcessGroup:
        return self._pg

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self._pg.configure(store_addr, replica_id, rank, world_size)

    def abort(self) -> None:
        self._pg.abort()

    def errored(self) -> Optional[Exception]:
        return self._pg.errored()

    def set_timeout(self, timeout: float) -> None:
        self._pg.set_timeout(timeout)

    def rank(self) -> int:
        return self._pg.rank()

    def size(self) -> int:
        return self._pg.size()

    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work:
        return self._wrap(
            self._pg.allreduce(arrays, op),
            lambda: [_allreduce_out(a, _allreduce_in(a)) for a in arrays],
        )

    def allgather(self, array: Any) -> Work:
        return self._wrap(
            self._pg.allgather(array), lambda: _host_result([_as_numpy(array)])
        )

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return self._wrap(
            self._pg.broadcast(array, root), lambda: _host_result(_as_numpy(array))
        )

    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        # Fallback keeps the success-path *shape*: this rank's row chunk.
        def fallback() -> np.ndarray:
            np_array = _as_numpy(array)
            w = max(self._pg.size(), 1)
            rows = np_array.shape[0] // w if np_array.shape[0] >= w else 1
            r = max(self._pg.rank(), 0)
            return _host_result(np_array[r * rows : (r + 1) * rows])

        return self._wrap(self._pg.reduce_scatter(array, op), fallback)

    def alltoall(self, arrays: "List[Any]") -> Work:
        return self._wrap(
            self._pg.alltoall(arrays),
            lambda: _host_result([_as_numpy(a) for a in arrays]),
        )

    def sendrecv(self, array: Any, dst: int, src: int, tag: int = 0) -> Work:
        # fallback shaped like the success path: plan exchanges are
        # same-shape both directions, so the sent array stands in
        return self._wrap(
            self._pg.sendrecv(array, dst, src, tag),
            lambda: _host_result(_as_numpy(array)),
        )

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return self._wrap(self._pg.send(array, dst, tag), lambda: None)

    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        return self._wrap(self._pg.recv(src, tag, out=out), lambda: None)

    def _wrap(self, work: Work, fallback: "Callable[[], Any]") -> Work:
        """Hook: ``fallback()`` builds a success-path-shaped substitute result."""
        return work


class ErrorSwallowingProcessGroupWrapper(ProcessGroupWrapper):
    """After the first error, ops become no-ops returning their inputs.

    Reference: torchft/process_group.py:1123-1179 — lets the training loop
    continue through a failed step; Manager.should_commit observes the error
    and triggers reconfigure.
    """

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__(pg)
        self._swallowed: Optional[Exception] = None

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        self._swallowed = None
        super().configure(store_addr, replica_id, rank, world_size)

    def errored(self) -> Optional[Exception]:
        return self._swallowed or super().errored()

    def report_error(self, exc: Exception) -> None:
        self._swallowed = exc

    def _wrap(self, work: Work, fallback: "Callable[[], Any]") -> Work:
        if self._swallowed is not None:
            return completed_work(fallback())

        out: Future = Future()

        def _done(f: "Future[Any]") -> None:
            exc = f.exception()
            if exc is not None:
                if self._swallowed is None:
                    self._swallowed = (
                        exc if isinstance(exc, Exception) else RuntimeError(str(exc))
                    )
                # Resolve with a result shaped like the success path so the
                # training loop proceeds; Manager observes errored() later.
                out.set_result(fallback())
            else:
                out.set_result(f.result())

        work.get_future().add_done_callback(_done)
        return Work(out)


class FakeProcessGroupWrapper(ProcessGroupWrapper):
    """Test-only fault injection: fail the *future* of upcoming ops.

    Reference: torchft/process_group.py:1182-1230 — lets integration tests
    inject an allreduce failure at a chosen step without touching sockets.
    """

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__(pg)
        self._next_op_error: Optional[Exception] = None
        self._next_configure_error: Optional[Exception] = None

    def report_future_error(self, exc: Exception) -> None:
        self._next_op_error = exc

    def report_configure_error(self, exc: Exception) -> None:
        self._next_configure_error = exc

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        if self._next_configure_error is not None:
            exc, self._next_configure_error = self._next_configure_error, None
            raise exc
        super().configure(store_addr, replica_id, rank, world_size)

    def _wrap(self, work: Work, fallback: "Callable[[], Any]") -> Work:
        if self._next_op_error is not None:
            exc, self._next_op_error = self._next_op_error, None
            return failed_work(exc)
        return work


class ManagedProcessGroup(ProcessGroup):
    """A ProcessGroup whose allreduce routes through a ``Manager``.

    Reference: torchft/process_group.py:1233-1266 — lets code written
    against the plain ProcessGroup API (e.g. a gradient-averaging hook or a
    mesh dimension) transparently get quorum-aware, error-swallowing,
    participant-count-scaled allreduce.  ``size()`` reports the *live*
    participant count so loss/gradient scaling stays correct as replicas
    fail and join; all other collectives and lifecycle calls are invalid on
    this wrapper — the Manager owns quorum and reconfiguration.
    """

    def __init__(self, manager: Any) -> None:
        super().__init__()
        self._manager = manager

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        raise RuntimeError(
            "ManagedProcessGroup is configured by its Manager, not directly"
        )

    def abort(self) -> None:
        raise RuntimeError("ManagedProcessGroup cannot be aborted directly")

    def shutdown(self) -> None:
        """No-op: the Manager owns the underlying PG's lifecycle."""

    def errored(self) -> Optional[Exception]:
        return self._manager.errored()

    def rank(self) -> int:
        """Replica rank within the live quorum.

        Raises ``NotParticipatingError`` while this replica is healing /
        excluded from the current quorum.  Returning a fake 0 here would let
        a healing replica silently consume rank-0's data shard; callers that
        can tolerate non-participation should use
        ``Manager.participating_rank()`` (returns ``None``) or
        ``ManagedDeviceMesh.global_batch_slice`` (returns the empty slice).
        """
        r = self._manager.participating_rank()
        if r is None:
            raise NotParticipatingError(
                "replica is not participating in the current quorum "
                "(healing or excluded); no rank is defined this step"
            )
        return r

    def size(self) -> int:
        return self._manager.num_participants()

    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work:
        # Manager.allreduce takes a pytree; a list of arrays is one.
        return self._manager.allreduce(list(arrays), reduce_op=op)

    def allgather(self, array: Any) -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))

    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))

    def alltoall(self, arrays: "List[Any]") -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))

    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        return failed_work(RuntimeError("ManagedProcessGroup only supports allreduce"))
