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
bf16 array, and that comes back out as a CPU bf16 tensor.

``ProcessGroupBabyTCP`` runs a ``ProcessGroupTCP`` in a spawned worker
process (crash isolation: a wedged or crashed collective takes the worker
down, not the trainer).  Its leaves cross to the worker through
``/dev/shm`` (or the pipe, when small) with the bf16 mark kept, and its
results are ``ProcessGroupTCP``'s, bit for bit.
"""

from __future__ import annotations

import collections
import logging
import mmap
import os
import pickle
import queue
import socket
import struct
import threading
import time
import uuid
import weakref
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
#: The longest one store ``get`` of a rendezvous waits: ``configure`` waits
#: for a peer's address in such slices, so an ``abort()`` from another
#: thread ends the wait within one (the JAX PG waits out its whole timeout).
_RENDEZVOUS_SLICE_S = 0.5


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
                peer_addr = self._rendezvous_get(store, f"{prefix}/rank_{peer}", deadline, gen)
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

    def _rendezvous_get(self, store: Any, key: str, deadline: float, gen: int) -> str:
        """``store.get(key)`` until ``deadline``, in slices of
        ``_RENDEZVOUS_SLICE_S``; raises ``_PGAborted`` once ``abort()`` (or
        a newer configure) has retired generation ``gen``.  So no wait of
        an aborted configure is left in the store's server, which may then
        be stopped (``ParameterServer.shutdown``)."""
        while True:
            left = deadline - time.monotonic()
            try:
                return store.get(key, timeout=max(min(left, _RENDEZVOUS_SLICE_S), 0.001))
            except TimeoutError:
                if left <= _RENDEZVOUS_SLICE_S:
                    raise
            if self._generation != gen:
                raise _PGAborted("process group aborted during configure")

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


# ---------------------------------------------------------------------------
# Subprocess-isolated ("Baby") process groups
# ---------------------------------------------------------------------------

# Arrays >= this cross the parent<->worker boundary as POSIX shared-memory
# segments instead of pickled pipe bytes: the pipe path costs two full
# serializations plus 2x the payload in 64 KiB pipe writes per direction
# (reference streams tensors with backpressure instead of pickling,
# torchft/process_group.py:1602-1645).
_SHM_MIN_BYTES = 1 << 20

# How much longer than the PG timeout the parent waits for a new worker's
# configure ack: the worker first has to start (spawn, import torch).
_SPAWN_GRACE_S = 30.0

# Every segment a Baby PG stages is named ``tftb_<pid ns>_<pid>_...``
# after the process that owns the op (the parent, also for its worker's
# result segments) and its pid namespace, so the segments of a process
# that died mid-op can be found and unlinked by the next Baby PG that
# configures in the same namespace.  /dev/shm may be shared with other
# pid namespaces, where a pid means another process: their segments are
# never touched.
_SHM_PREFIX = "tftb_"
_SHM_DIR = "/dev/shm"

# Segments are mapped with their pages populated up front: one call
# instead of a page fault per 4 KiB page on the first write (parent) or
# read (worker), which dominates the first op after a reconfigure, when
# every segment is new, where faults are costly (a sandboxed kernel).
_SHM_MAP_FLAGS = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)


def _read_pid_ns() -> str:
    """This process's pid namespace (the inode of ``/proc/self/ns/pid``),
    or "" where it cannot be read."""
    try:
        return str(os.stat("/proc/self/ns/pid").st_ino)
    except OSError:
        return ""


_PID_NS = _read_pid_ns()


def _shm_owner_prefix(owner_pid: int) -> str:
    """The name prefix of every segment whose op ``owner_pid`` owns."""
    return f"{_SHM_PREFIX}{_PID_NS or '0'}_{owner_pid}_"


def _shm_name(owner_pid: int, tag: str) -> str:
    return f"{_shm_owner_prefix(owner_pid)}{tag}_{uuid.uuid4().hex[:16]}"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _shm_sweep_dead() -> int:
    """Unlink the Baby segments of processes of this pid namespace that no
    longer run (a trainer SIGKILLed mid-op leaves its staged payloads
    behind: the tmpfs holds them until someone unlinks the names).
    Returns the count removed; sweeps nothing where the namespace cannot
    be read."""
    if not _PID_NS:
        return 0
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return 0
    ours = f"{_SHM_PREFIX}{_PID_NS}_"
    removed = 0
    for name in names:
        if not name.startswith(ours):
            continue
        try:
            pid = int(name[len(ours):].split("_", 1)[0])
        except ValueError:
            continue
        if _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
            removed += 1
        except OSError:
            pass
    return removed


def _shm_check_room(nbytes: int, what: str) -> None:
    """Fail before staging more than ``/dev/shm`` holds.

    A full tmpfs does not fail a segment's creation (``ftruncate`` makes
    it sparse): the first write past the tmpfs's capacity raises SIGBUS,
    which kills the process.  So the free space is read
    first, and an op that would not fit fails with this error (there is
    no quiet fallback to the pipe)."""
    if nbytes <= 0:
        return
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        return  # no /dev/shm to read: shm_open picks its own backing
    free = st.f_bavail * st.f_frsize
    if nbytes > free:
        raise RuntimeError(
            f"baby PG: staging {nbytes} bytes for {what} needs more than "
            f"the {free} bytes free in {_SHM_DIR} (size "
            f"{st.f_blocks * st.f_frsize}); a write past a full tmpfs "
            f"kills the process with SIGBUS — enlarge {_SHM_DIR} or "
            f"stage less per op"
        )


def _shm_mark(a: np.ndarray) -> bool:
    """Whether a staged array is a bf16 tensor's bit patterns
    (:class:`_BF16Bits`): the mark its ref carries across, without which
    the worker would reduce the patterns as integers."""
    return isinstance(a, _BF16Bits)


class _Seg:
    """One POSIX shared-memory segment, mapped with ``mmap``.

    Not ``multiprocessing.shared_memory``: its resource tracker is shared
    by the parent and its spawned workers and cannot be balanced across
    them, and its ``close()`` unmaps pages that numpy views derived from
    the mapping still point at (a view of a view keeps only the buffer
    object alive, not the export).  Here the mapping is never closed
    under a view: a mapping handed to numpy is unmapped when the last
    array over it is collected, and the name is unlinked explicitly by
    whoever owns the op."""

    __slots__ = ("name", "size", "mm")

    def __init__(self, name: str, size: int, mm: Any) -> None:
        self.name = name
        self.size = size
        self.mm = mm

    @classmethod
    def create(cls, nbytes: int, owner_pid: int, tag: str) -> "_Seg":
        import _posixshmem

        name = _shm_name(owner_pid, tag)
        fd = _posixshmem.shm_open(
            "/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600
        )
        try:
            os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes, flags=_SHM_MAP_FLAGS)
        except BaseException:
            os.close(fd)
            cls.unlink(name)
            raise
        os.close(fd)
        return cls(name, nbytes, mm)

    @staticmethod
    def attach(name: str, nbytes: int) -> Any:
        """Map an existing segment; the returned mmap lives as long as
        the arrays built over it."""
        import _posixshmem

        fd = _posixshmem.shm_open("/" + name, os.O_RDWR, mode=0o600)
        try:
            return mmap.mmap(fd, nbytes, flags=_SHM_MAP_FLAGS)
        finally:
            os.close(fd)

    @staticmethod
    def unlink(name: str) -> None:
        import _posixshmem

        try:
            _posixshmem.shm_unlink("/" + name)
        except FileNotFoundError:
            pass

    def release(self) -> None:
        """Unmap (unless a view still uses the mapping) and unlink."""
        try:
            self.mm.close()
        except BufferError:
            pass  # unmapped when the last view goes
        self.unlink(self.name)


class _ShmRef:
    """Pickle-tiny stand-in for an array staged in shared memory: its
    segment's name, shape, numpy dtype (pickled as the dtype itself, so an
    ``ml_dtypes`` leaf resolves as one), and ``bf16`` — the mark of a bf16
    tensor's bit patterns (:class:`_BF16Bits`, stored as uint16)."""

    __slots__ = ("name", "shape", "dtype", "bf16")

    def __init__(
        self, name: str, shape: "Tuple[int, ...]", dtype: np.dtype, bf16: bool
    ) -> None:
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.bf16 = bf16

    @classmethod
    def of(cls, name: str, a: np.ndarray, bf16: bool) -> "_ShmRef":
        return cls(name, tuple(a.shape), a.dtype, bf16)

    def __getstate__(self):
        return (self.name, self.shape, self.dtype, self.bf16)

    def __setstate__(self, state):
        self.name, self.shape, self.dtype, self.bf16 = state

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def root(self, buf: Any) -> np.ndarray:
        """The flat array over ``buf`` (a mapping of this ref's segment).
        Its base is the mapping, not an array, so every array derived from
        it (reshapes, dtype views, ``torch.from_numpy``) keeps it alive."""
        return np.frombuffer(
            buf, dtype=self.dtype, count=self.nbytes // self.dtype.itemsize
        )

    def shaped(self, root: np.ndarray) -> np.ndarray:
        """``root`` in this ref's shape, bf16-marked where the ref is."""
        arr = root.reshape(self.shape)
        return arr.view(_BF16Bits) if self.bf16 else arr

    def view(self, buf: Any) -> np.ndarray:
        """The array over ``buf``."""
        return self.shaped(self.root(buf))

    def map(self, maps: "Optional[Dict[str, Any]]" = None) -> np.ndarray:
        """A zero-copy view of the segment (mapped until it is collected);
        ``maps`` caches mappings by name across ops (a pooled segment comes
        back under its name, its pages already mapped)."""
        mm = maps.get(self.name) if maps is not None else None
        if mm is None:
            mm = _Seg.attach(self.name, self.nbytes)
            if maps is not None:
                maps[self.name] = mm
        return self.view(mm)


class _ShmIn:
    """A resolved input segment inside the worker: kept for the op's
    lifetime and reusable as the (already warm) result buffer."""

    __slots__ = ("ref", "view", "used")

    def __init__(self, ref: "_ShmRef", view: np.ndarray) -> None:
        self.ref = ref
        self.view = view
        self.used = False


def _large(a: Any) -> bool:
    return isinstance(a, np.ndarray) and a.nbytes >= _SHM_MIN_BYTES


def _leaf_nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes if isinstance(x, np.ndarray) else 0


def _write_seg(a: np.ndarray, owner_pid: int, tag: str, what: str) -> "_Seg":
    _shm_check_room(a.nbytes, what)
    seg = _Seg.create(a.nbytes, owner_pid, tag)
    dst = np.ndarray(a.shape, dtype=a.dtype, buffer=seg.mm)
    dst[...] = a
    del dst
    return seg


def _shm_resolve_value(
    value: Any, opened: "List[_ShmIn]", maps: "Optional[Dict[str, Any]]" = None
) -> Any:
    """Materialize ``_ShmRef``s as zero-copy views (through the ``maps``
    cache), recorded in ``opened`` for result reuse."""

    def resolve(a: Any) -> Any:
        if not isinstance(a, _ShmRef):
            return a
        view = a.map(maps)
        opened.append(_ShmIn(a, view))
        return view

    if isinstance(value, list):
        return [resolve(a) for a in value]
    return resolve(value)


def _shm_stage_result(
    value: Any, inputs: "List[_ShmIn]", owner_pid: int, tag: str, what: str
) -> Any:
    """Worker-side result staging: write each large result array into a
    matching (shape, dtype and bf16 mark) input segment — already-warm
    pages, no fresh allocation — falling back to a fresh segment.  Small
    values pickle."""

    def stage(a: Any) -> Any:
        if not _large(a):
            return a
        for inp in inputs:
            if (
                not inp.used
                and inp.view.shape == a.shape
                and inp.view.dtype == a.dtype
                and _shm_mark(inp.view) == _shm_mark(a)
            ):
                inp.used = True
                if inp.view is not a and not np.shares_memory(inp.view, a):
                    inp.view[...] = a
                return _ShmRef.of(inp.ref.name, a, _shm_mark(a))
        seg = _write_seg(np.ascontiguousarray(a), owner_pid, tag, what)
        seg.mm.close()
        return _ShmRef.of(seg.name, a, _shm_mark(a))

    if isinstance(value, list):
        return [stage(a) for a in value]
    return stage(value)


def _shm_discard_value(value: Any, keep: "frozenset[str]" = frozenset()) -> None:
    """Reclaim result segments whose message will never be consumed
    (reader superseded by reconfigure, future already failed, parent
    gone): dropping their refs without unlinking would pin the payload
    in /dev/shm.  ``keep``: names the parent still owns (its inputs)."""
    refs = value if isinstance(value, list) else [value]
    for a in refs:
        if isinstance(a, _ShmRef) and a.name not in keep:
            _Seg.unlink(a.name)


def _from_inner(v: Any) -> Any:
    """An inner op's result as it crosses back: a tensor becomes its host
    array (bf16 as :class:`_BF16Bits`), lists element-wise."""
    if isinstance(v, torch.Tensor):
        return _as_numpy(v)
    if isinstance(v, list):
        return [_from_inner(x) for x in v]
    return v


def _baby_worker(
    pg_cls: type,
    pipe_conn: Any,
    store_addr: str,
    replica_id: str,
    rank: int,
    world_size: int,
    timeout: float,
    owner_pid: int,
    token: str,
) -> None:
    """Worker-process loop: run the real PG, execute ops from the pipe.

    Protocol (reference worker loop, torchft/process_group.py:1470-1600):
    parent sends ``(op_id, func_name, args, kwargs)``; worker runs the op,
    *waits* the resulting Work, and replies ``(op_id, value, stats)`` on
    success or ``(op_id, exception, None)`` on failure (``stats``: the
    op's wait and its result staging, in seconds).
    ``(op_id, "__shutdown__", ...)`` exits the loop.  Collectives execute
    on a small thread pool so an in-flight op cannot block the command
    loop, matching the parent's async Work API.

    The worker never touches ``torch.cuda``: it gets host arrays only, and
    a CUDA context here would cost card memory in every worker.  Result
    segments it creates are named after the parent (``owner_pid``) and
    its PG (``token``), which unlinks them.
    """
    import concurrent.futures as cf

    pg = pg_cls()
    pg.set_timeout(timeout)
    try:
        pg.configure(store_addr, replica_id, rank, world_size)
    except Exception as e:  # noqa: BLE001 - shipped to parent
        try:
            # bare exception: _MonitoredPipe re-raises it in the parent's
            # configure with the real root cause intact
            pipe_conn.send(e)
        except (BrokenPipeError, OSError):
            pass
        return
    pipe_conn.send((-1, "configured"))

    send_lock = _lockcheck.lock("pg.baby.pipe_send")
    pool = cf.ThreadPoolExecutor(max_workers=4, thread_name_prefix="baby_op")

    def _send(op_id: int, value: Any, stats: Any) -> None:
        with send_lock:
            try:
                pipe_conn.send((op_id, value, stats))
            except (BrokenPipeError, OSError):
                # nobody will read the reply: its result segments go now
                _shm_discard_value(value)

    def _finish(op_id: int, func: str, work: Any, opened: "List[_ShmIn]") -> None:
        try:
            t0 = time.perf_counter()
            try:
                value = (
                    work.wait(timeout=timeout) if isinstance(work, Work) else work
                )
            except Exception as e:  # noqa: BLE001 - shipped to parent
                _send(op_id, e, None)
                return
            t1 = time.perf_counter()
            # stage results into the warm input segments where shapes
            # match (allreduce/broadcast/alltoall), fresh segments
            # otherwise; the parent owns every segment from here
            try:
                value = _shm_stage_result(
                    _from_inner(value), opened, owner_pid, f"o{token}", func
                )
            except Exception as e:  # noqa: BLE001 - shipped to parent
                _send(op_id, e, None)
                return
            _send(op_id, value, {
                "op_s": t1 - t0, "stage_out_s": time.perf_counter() - t1,
            })
        finally:
            # the inputs' mappings go with their last view
            opened.clear()

    # mappings of the parent's pooled segments, kept across the last two
    # ops: a recycled segment comes back under its name, already mapped
    maps: "Dict[str, Any]" = {}
    recent: "List[set]" = []
    try:
        while True:
            try:
                msg = pipe_conn.recv()
            except (EOFError, OSError):
                break
            op_id, func, args, kwargs = msg
            if func == "__shutdown__":
                break
            # enqueue on THIS thread so ops hit the inner PG in pipe order
            # (pipelined collectives must match across ranks); only the
            # wait() moves to the pool so an in-flight op can't block the
            # command loop.
            opened: "List[_ShmIn]" = []
            try:
                # bf16 bit patterns become a CPU bf16 tensor again, which the
                # inner ProcessGroupTCP reduces in f32 as in the parent
                args = [_host_result(_shm_resolve_value(a, opened, maps)) for a in args]
                recent = recent[-1:] + [{inp.ref.name for inp in opened}]
                for name in set(maps) - set().union(*recent):
                    del maps[name]
                work = getattr(pg, func)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - shipped to parent
                opened.clear()
                _send(op_id, e, None)
                continue
            pool.submit(_finish, op_id, func, work, opened)
    finally:
        pool.shutdown(wait=False)
        try:
            pg.shutdown()
        except Exception:  # noqa: BLE001 - worker teardown is best-effort
            pass


class ProcessGroupBaby(ProcessGroup):
    """Runs the real PG in a spawned subprocess for crash isolation.

    Port of ``torchft_tpu/parallel/process_group.py``'s Baby PG
    (reference: torchft/process_group.py:1358-1828).  ``configure`` kills
    any existing worker and spawns a fresh one (subprocess restart *is*
    the reconfigure); every collective is shipped over a command pipe and
    returns a Work backed by a future that a reader thread resolves.
    ``abort()`` kills the worker — the hard-cancel that a wedged socket
    stack cannot block.

    Leaves of ``_SHM_MIN_BYTES`` or more cross to the worker as ``/dev/shm``
    segments: a tensor leaf is copied straight into its segment (one copy
    from the card, where ``ProcessGroupTCP`` makes a host array first), a
    bf16 tensor as its bit patterns with the bf16 mark on its ref.  Smaller
    leaves go as :class:`ProcessGroupTCP` takes them (:func:`_as_numpy`),
    pickled.  Results are what ``ProcessGroupTCP`` returns for the same
    inputs, bit for bit: host arrays (zero-copy views of the segment the
    worker wrote them into), bf16 leaves as CPU bf16 tensors.

    Segments are pooled: an input segment whose result the caller has
    dropped is reused by the next op of its size, so steady-state staging
    writes warm pages instead of faulting in fresh tmpfs ones.  ``shutdown`` and every reconfigure unlink all of them: no segment of
    the PG stays in ``/dev/shm``, while results the caller still holds stay
    readable (a mapping outlives its name).

    Workers start via the ``spawn`` method, so no CUDA context is
    inherited and the using script must be importable without side
    effects (guard its entry point with ``if __name__ == "__main__":``).
    A worker imports this package, so with ``TORCHFT_USE_OTEL`` set it
    installs the OTLP exporters in its own process, as the JAX package's
    worker does.

    ``stats`` accumulates the parent's view of each op, in seconds:
    ``stage_in_s`` (leaves into shared memory or to host arrays),
    ``round_trip_s`` (pipe send to reply), of it ``op_s`` and
    ``stage_out_s`` (the worker's wait on the inner collective and its
    result staging), and ``wrap_s`` (mapping the results); with ``ops``,
    ``shm_in_bytes`` and ``shm_peak_bytes`` (the most this PG held in
    ``/dev/shm`` at once).
    """

    PG_CLASS: type = None  # set by subclasses

    def __init__(self, timeout: float = 60.0, max_active_work: int = 16) -> None:
        """``max_active_work``: backpressure cap on in-flight ops — each op
        can hold staged shared-memory payloads, so an unbounded submitter
        would pin unbounded host memory (reference num_active_work,
        torchft/process_group.py:1602-1645).  0 disables the cap."""
        super().__init__(timeout)
        self._proc: Optional[Any] = None
        self._pipe: Optional[Any] = None
        self._rank = -1
        self._world = -1
        self._errored_exc: Optional[Exception] = None
        self._next_op_id = 0
        self._baby_replica_id = ""
        self._gen = 0  # bumped per configure; guards against stale readers
        self._pending: Dict[int, Future] = {}
        self._pending_shm: "Dict[int, List[_Seg]]" = {}
        self._pending_t0: "Dict[int, float]" = {}
        self._max_active_work = max_active_work
        self._lock = _lockcheck.lock("pg.baby.state")
        self._cond = threading.Condition(self._lock)
        self._reader: Optional[threading.Thread] = None
        # the segment pool: free segments by size, and those that back a
        # result the caller still holds; _pool_epoch retires both at once
        self._free: "Dict[int, List[_Seg]]" = {}
        self._held: "Dict[str, _Seg]" = {}
        # segments whose results died, queued by the GC finalizer (which
        # may run on any thread, inside any lock) for the next _take
        self._dead: "collections.deque[_Seg]" = collections.deque()
        self._pool_epoch = 0
        self._shm_live = 0  # bytes of this PG's named segments
        # names this PG's segments apart from other Baby PGs of the process
        self._token = uuid.uuid4().hex[:8]
        self.stats: "Dict[str, float]" = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        with self._lock:
            self.stats = {
                "ops": 0, "stage_in_s": 0.0, "round_trip_s": 0.0, "op_s": 0.0,
                "stage_out_s": 0.0, "wrap_s": 0.0, "shm_in_bytes": 0,
                "shm_peak_bytes": self._shm_live,
            }

    def worker_pid(self) -> "Optional[int]":
        proc = self._proc
        return None if proc is None else proc.pid

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int) -> None:
        import multiprocessing as mp

        _faults.check("pg.reconfigure", replica=replica_id)
        self._kill_worker()
        _shm_sweep_dead()
        self._errored_exc = None
        self._baby_replica_id = replica_id
        self._rank = rank
        self._world = world_size

        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_baby_worker,
            args=(
                type(self).PG_CLASS,
                child_conn,
                store_addr,
                replica_id,
                rank,
                world_size,
                self._timeout,
                os.getpid(),
                self._token,
            ),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()

        from torchft_tpu_torch.multiprocessing import _MonitoredPipe

        pipe = _MonitoredPipe(parent_conn)
        with self._lock:
            self._pipe = pipe
            self._gen += 1
            gen = self._gen
        # first message acks configure; a worker-side configure failure
        # arrives as a bare exception that _MonitoredPipe re-raises here
        ack = self._recv_ack(pipe)
        if ack != (-1, "configured"):
            self._kill_worker()
            raise RuntimeError(f"unexpected configure ack from worker: {ack!r}")

        self._reader = threading.Thread(
            target=self._read_loop,
            args=(pipe, gen),
            name="baby_pg_reader",
            daemon=True,
        )
        self._reader.start()
        _metrics.PG_RECONFIGURES.labels(transport="baby").inc()

    def _recv_ack(self, pipe: Any) -> Any:
        # the worker's own configure runs under the PG timeout and ships
        # its failure here; the wait outlasts it by the worker's start (a
        # spawned Python importing torch), so the root cause arrives
        # before this side gives up
        try:
            return pipe.recv(timeout=self._timeout + _SPAWN_GRACE_S)
        except Exception:
            self._kill_worker()
            raise

    def _read_loop(self, pipe: Any, gen: int) -> None:
        while True:
            try:
                msg = pipe.recv(timeout=None)
            except Exception as e:  # noqa: BLE001 - includes EOF/reset/transport
                # EOFError (clean close) or ConnectionResetError (SIGKILL)
                # both mean the worker died; transported exceptions arrive
                # without an op id and are equally fatal to all pending ops.
                # The generation check inside _fail_all makes a stale reader
                # (whose PG was already reconfigured) a no-op.
                if isinstance(e, (EOFError, OSError)):
                    self._fail_all(RuntimeError(f"baby PG worker exited: {e!r}"), gen)
                else:
                    self._fail_all(
                        e if isinstance(e, Exception) else RuntimeError(str(e)), gen
                    )
                return
            op_id, value, wstats = msg
            with self._lock:
                if gen != self._gen:
                    # reconfigured under us; results no longer ours — but
                    # any worker-created result segments still need reaping
                    _shm_discard_value(value)
                    return
                fut = self._pending.pop(op_id, None)
                in_segs = self._pending_shm.pop(op_id, [])
                t_sent = self._pending_t0.pop(op_id, None)
                if fut is not None and isinstance(value, Exception):
                    self._errored_exc = self._errored_exc or value
                if wstats:
                    self.stats["op_s"] += wstats["op_s"]
                    self.stats["stage_out_s"] += wstats["stage_out_s"]
                if t_sent is not None:
                    self.stats["round_trip_s"] += time.perf_counter() - t_sent
                self._cond.notify_all()
            if fut is None or isinstance(value, Exception):
                if not isinstance(value, Exception):
                    _shm_discard_value(value, frozenset(g.name for g in in_segs))
                self._settle(in_segs, ())
                if fut is not None:
                    fut.set_exception(value)
                continue
            t0 = time.perf_counter()
            try:
                result, held = self._wrap(value, in_segs)
            except Exception as e:  # noqa: BLE001 - decode failure
                self._settle(in_segs, ())
                fut.set_exception(e)
                continue
            self._settle(in_segs, held)
            with self._lock:
                self.stats["wrap_s"] += time.perf_counter() - t0
            fut.set_result(_host_result(result))
            # the loop's locals would keep this result (and the segments
            # behind it) alive until the next reply: past the next op's
            # staging, which would then miss the pool
            msg = value = result = fut = None

    # -- the segment pool --------------------------------------------------

    def _take(self, nbytes: int, what: str) -> "_Seg":
        """A segment of ``nbytes``: a free one of the pool, else a new one
        (after checking that ``/dev/shm`` holds it)."""
        self._drain_dead()
        with self._lock:
            free = self._free.get(nbytes)
            if free:
                return free.pop()
        _shm_check_room(nbytes, what)
        seg = _Seg.create(nbytes, os.getpid(), f"i{self._token}")
        with self._lock:
            self._shm_live += nbytes
            self.stats["shm_peak_bytes"] = max(
                self.stats["shm_peak_bytes"], self._shm_live
            )
        return seg

    def _release(self, seg: "_Seg") -> None:
        seg.release()
        with self._lock:
            self._shm_live -= seg.size

    def _recycle(self, seg: "_Seg", epoch: int) -> None:
        """Back to the free pool, or released when the pool was retired
        since the segment was taken."""
        with self._lock:
            keep = epoch == self._pool_epoch
            if keep:
                self._free.setdefault(seg.size, []).append(seg)
        if not keep:
            self._release(seg)

    def _settle(self, in_segs: "List[_Seg]", held: "Any") -> None:
        """An op is done: its input segments that back no result go back
        to the pool."""
        with self._lock:
            epoch = self._pool_epoch
        for seg in in_segs:
            if seg.name not in held:
                self._recycle(seg, epoch)

    def _result_dead(self, seg: "_Seg", epoch: int) -> None:
        """GC finalizer of a result's last view: takes no lock."""
        if epoch == self._pool_epoch:
            self._dead.append(seg)
        else:
            seg.release()  # retired: its name is gone already

    def _drain_dead(self) -> None:
        with self._lock:
            epoch = self._pool_epoch
        while self._dead:
            seg = self._dead.popleft()
            with self._lock:
                self._held.pop(seg.name, None)
            self._recycle(seg, epoch)

    def _retire_pool(self) -> None:
        """Unlink every segment of this PG: the free ones go, and those
        backing results the caller still holds lose their names (their
        mappings stay until the results die)."""
        self._drain_dead()
        with self._lock:
            self._pool_epoch += 1
            free = [g for gs in self._free.values() for g in gs]
            self._free = {}
            held, self._held = list(self._held.values()), {}
        for seg in free:
            seg.release()
        for seg in held:
            _Seg.unlink(seg.name)
        with self._lock:
            self._shm_live = 0

    def _wrap(self, value: Any, in_segs: "List[_Seg]") -> "Tuple[Any, set]":
        """Parent-side result decode: each ``_ShmRef`` becomes a ZERO-COPY
        view.  A result the worker wrote into one of the op's input
        segments is read through this process's own mapping of it, and the
        segment returns to the pool when the caller's last view dies (a
        finalizer on the flat root array that every view keeps alive); a
        segment the worker made is mapped and its name unlinked at once
        (the mapping outlives the name).  Returns the results and the
        names of the input segments they hold."""
        mine = {g.name: g for g in in_segs}
        held: set = set()
        with self._lock:
            epoch = self._pool_epoch

        def wrap(a: Any) -> Any:
            if not isinstance(a, _ShmRef):
                return a
            seg = mine.get(a.name)
            if seg is None:
                arr = a.map()
                _Seg.unlink(a.name)
                return arr
            root = a.root(seg.mm)
            held.add(seg.name)
            with self._lock:
                self._held[seg.name] = seg
            weakref.finalize(root, self._result_dead, seg, epoch)
            return a.shaped(root)

        out = [wrap(a) for a in value] if isinstance(value, list) else wrap(value)
        return out, held

    def _stage(self, value: Any, created: "List[_Seg]", what: str) -> Any:
        """Leaves (a leaf or a list) as the worker takes them: large ones
        copied into pooled segments (a tensor straight from its device; a
        bf16 one as its bit patterns) and replaced by ``_ShmRef``s, the
        rest as host arrays (:func:`_as_numpy`)."""

        def stage(x: Any) -> Any:
            if not isinstance(x, (torch.Tensor, np.ndarray)):
                return _as_numpy(x)
            nbytes = _leaf_nbytes(x)
            if nbytes < _SHM_MIN_BYTES:
                return _as_numpy(x)
            if isinstance(x, torch.Tensor):
                bf16 = x.dtype == torch.bfloat16
                if not bf16 and x.dtype not in _TORCH_TO_NUMPY:
                    raise TypeError(
                        f"process group leaves must have a numpy dtype or "
                        f"be bf16, got {x.dtype}"
                    )
                seg = self._take(nbytes, what)
                created.append(seg)
                shape = tuple(x.shape)
                if bf16:
                    dst = np.ndarray(shape, dtype=np.int16, buffer=seg.mm)
                    torch.from_numpy(dst).copy_(x.detach().view(torch.int16))
                    host = dst.view(np.uint16).view(_BF16Bits)
                else:
                    host = np.ndarray(
                        shape, dtype=_TORCH_TO_NUMPY[x.dtype], buffer=seg.mm
                    )
                    torch.from_numpy(host).copy_(x.detach())
            else:
                seg = self._take(nbytes, what)
                created.append(seg)
                host = np.ndarray(x.shape, dtype=x.dtype, buffer=seg.mm)
                host[...] = x
                if isinstance(x, _BF16Bits):
                    host = host.view(_BF16Bits)
            return _ShmRef.of(seg.name, host, _shm_mark(host))

        if isinstance(value, list):
            return [stage(x) for x in value]
        return stage(value)

    # -- failure and teardown ----------------------------------------------

    def _fail_all(self, exc: Exception, gen: "Optional[int]" = None) -> None:
        with self._lock:
            if gen is not None and gen != self._gen:
                return  # stale reader of a pre-reconfigure worker
            self._errored_exc = self._errored_exc or exc
            pending, self._pending = self._pending, {}
            pending_shm, self._pending_shm = self._pending_shm, {}
            self._pending_t0 = {}
            self._cond.notify_all()
        for segs in pending_shm.values():
            for seg in segs:
                self._release(seg)
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    def _kill_worker(self) -> None:
        # claim pipe+proc under the lock: abort() and configure() can race
        # here, and nulling before close makes the reader thread see a stale
        # pipe (deliberate teardown), not a worker death. Bumping the
        # generation here (not just in configure) immediately invalidates
        # the old reader so it cannot latch an error after a reconfigure
        # clears the latched state.
        with self._lock:
            pipe, self._pipe = self._pipe, None
            proc, self._proc = self._proc, None
            self._gen += 1
        if pipe is not None:
            try:
                pipe.close()
            except OSError:
                pass
        if proc is not None:
            try:
                proc.terminate()
                proc.join(timeout=5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5)
            except ValueError:
                pass  # process never started (configure failed mid-spawn)
        self._fail_all(_PGAborted("process group aborted"))
        self._retire_pool()
        # result segments the dead worker made but never handed over carry
        # this PG's name; with the worker gone, nothing else will take them
        self._sweep_own_results()

    def _sweep_own_results(self) -> None:
        mine = f"{_shm_owner_prefix(os.getpid())}o{self._token}_"
        try:
            names = [n for n in os.listdir(_SHM_DIR) if n.startswith(mine)]
        except OSError:
            return
        for name in names:
            try:
                os.unlink(os.path.join(_SHM_DIR, name))
            except OSError:
                pass

    def _submit(self, func: str, data: Any, *rest: Any) -> Work:
        with self._lock:
            # backpressure: bound in-flight ops (each may pin staged shm)
            if self._max_active_work > 0:
                deadline = time.monotonic() + self._timeout
                while (
                    len(self._pending) >= self._max_active_work
                    and self._errored_exc is None
                    and self._pipe is not None
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(timeout=remaining):
                        return failed_work(
                            TimeoutError(
                                f"{len(self._pending)} ops in flight >= "
                                f"max_active_work={self._max_active_work} "
                                f"for {self._timeout}s"
                            )
                        )
            if self._errored_exc is not None:
                return failed_work(self._errored_exc)
            if self._pipe is None:
                return failed_work(RuntimeError("process group not configured"))
            op_id = self._next_op_id
            self._next_op_id += 1
            fut: Future = Future()
            self._pending[op_id] = fut
            pipe = self._pipe  # local ref: abort() may null the attribute
            self.stats["ops"] += 1
        # stage outside the lock (a copy from the card of a large leaf can
        # take a second); the segments stay the op's until it resolves
        created: "List[_Seg]" = []
        t0 = time.perf_counter()
        try:
            args = rest if data is None else (self._stage(data, created, func),) + rest
        except Exception as e:  # noqa: BLE001 - staging failure fails the op
            for seg in created:
                self._release(seg)
            with self._lock:
                self._pending.pop(op_id, None)
                self._cond.notify_all()
            return failed_work(e)
        staged = sum(seg.size for seg in created)
        with self._lock:
            self.stats["stage_in_s"] += time.perf_counter() - t0
            self.stats["shm_in_bytes"] += staged
            if op_id in self._pending:
                self._pending_shm[op_id] = created
                self._pending_t0[op_id] = time.perf_counter()
                orphaned: "List[_Seg]" = []
            else:
                # failed/aborted while staging; nothing will clean these
                orphaned = created
        for seg in orphaned:
            self._release(seg)
        try:
            pipe.send((op_id, func, args, {}))
        except (BrokenPipeError, OSError) as e:
            with self._lock:
                self._pending.pop(op_id, None)
                self._pending_t0.pop(op_id, None)
                segs = self._pending_shm.pop(op_id, [])
                self._cond.notify_all()
            for seg in segs:
                self._release(seg)
            self._errored_exc = self._errored_exc or e
            return failed_work(e)
        return Work(fut).with_timeout(self._timeout)

    # -- ProcessGroup API --------------------------------------------------

    def abort(self) -> None:
        _metrics.PG_ABORTS.labels(transport="baby").inc()
        _flightrec.record(
            "pg.abort", status="abort", transport="baby",
            replica_id=self._baby_replica_id, rank=self._rank,
            world=self._world,
        )
        _flightrec.dump("baby process group aborted", trigger="pg_abort")
        self._kill_worker()  # latches _PGAborted via _fail_all

    def errored(self) -> Optional[Exception]:
        return self._errored_exc

    def shutdown(self) -> None:
        if self._pipe is not None:
            try:
                self._pipe.send((-1, "__shutdown__", (), {}))
            except (BrokenPipeError, OSError):
                pass
        self._kill_worker()

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world

    def allreduce(self, arrays: "List[Any]", op: str = REDUCE_SUM) -> Work:
        return self._submit("allreduce", list(arrays), op)

    def allgather(self, array: Any) -> Work:
        return self._submit("allgather", array)

    def broadcast(self, array: Any, root: int = 0) -> Work:
        return self._submit("broadcast", array, root)

    def reduce_scatter(self, array: Any, op: str = REDUCE_SUM) -> Work:
        return self._submit("reduce_scatter", array, op)

    def alltoall(self, arrays: "List[Any]") -> Work:
        return self._submit("alltoall", list(arrays))

    def sendrecv(self, array: Any, dst: int, src: int, tag: int = 0) -> Work:
        return self._submit("sendrecv", array, dst, src, tag)

    def send(self, array: Any, dst: int, tag: int = 0) -> Work:
        return self._submit("send", array, dst, tag)

    def recv(self, src: int, tag: int = 0, out: "Optional[np.ndarray]" = None) -> Work:
        work = self._submit("recv", None, src, tag)
        if out is None:
            return work

        # the worker can't share the caller's buffer; emulate in-place by
        # copying the (possibly shm-backed) result into it — with the same
        # validation the direct backend's wire reader applies
        def into(x: Any) -> Any:
            arr = _as_numpy(x)
            _check_recv_buffer(out, arr.shape, _dtype_name(arr))
            out[...] = arr
            return _host_result(out.view(_BF16Bits) if _dtype_name(arr) == _BF16 else out)

        return work.then(into)


class ProcessGroupBabyTCP(ProcessGroupBaby):
    """Subprocess-isolated ProcessGroupTCP (reference ProcessGroupBabyGloo
    analog, torchft/process_group.py:1883-1923)."""

    PG_CLASS = ProcessGroupTCP
