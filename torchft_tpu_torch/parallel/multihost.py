"""Several processes (or threads) in one replica group.

PyTorch port of ``torchft_tpu/parallel/multihost.py``.  There, one replica
group of N processes joins one jax runtime (``jax.distributed.initialize``)
and XLA runs the in-group collectives of the mesh.  Here each process of
the group builds its own c10d process groups from a store that every member
reaches — a ``TCPStore`` at the coordinator address, hosted by process 0 —
and the group's inner mesh is made of them (``parallel/device_mesh.py``
``ft_init_device_mesh``).  Nothing sets a process-global default group: the
fault-tolerance layer (one ``Manager`` per process, ``group_rank`` = process
index) owns the cross-group process group, as in the JAX package.

The backend is NCCL when each process of the group owns a card, and gloo
otherwise (the CPU, or several processes sharing one card, which NCCL
refuses); the choice is explicit and logged.  ``local_worlds`` gives ranks
that are threads of one process the same view over a ``HashStore``; threads
are safe on the CPU only (on the card, the autograd engine runs every CUDA
backward of a process on one thread per device, so a rank blocked in a ring
exchange would hold up the others: use processes there).
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import threading
import time
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GroupWorld:
    """One rank's view of its replica group's ranks: a store all of them
    reach, this rank, the count, the c10d backend and the groups' timeout
    (seconds)."""

    store: Any
    rank: int
    size: int
    backend: str = "gloo"
    timeout: float = 300.0

    def new_group(self, key: str, ranks: "Sequence[int]") -> Any:
        """The c10d process group of ``ranks`` (this rank among them),
        built directly under a store prefix of its own (never the default
        group); every rank in ``ranks`` must call it."""
        ranks = list(ranks)
        prefix = f"tft_group/{key}/{'_'.join(map(str, ranks))}"
        rank, size = ranks.index(self.rank), len(ranks)
        timeout = timedelta(seconds=self.timeout)
        if self.backend == "gloo":
            return _new_gloo_group(self.store, prefix, rank, size, timeout)
        store = dist.PrefixStore(prefix, self.store)
        if self.backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            return dist.ProcessGroupNCCL(store, rank, size, opts)
        raise ValueError(f"unknown backend {self.backend!r}; expected 'gloo' or 'nccl'")


#: Times the ranks of a gloo group try its full-mesh handshake before the
#: construction fails.
GLOO_CONNECT_ATTEMPTS = 3


def _new_gloo_group(
    store: Any, prefix: str, rank: int, size: int, timeout: timedelta
) -> Any:
    """A gloo group of ``size`` ranks under ``prefix``; every rank calls it.

    Gloo connects every pair of ranks while the group is built.  On a loaded
    host that handshake sometimes fails on one rank: it reads end-of-file
    from a peer that did not fail ("Connection closed by peer"), while the
    other ranks' handshakes complete or time out.  So each rank publishes
    whether its construction succeeded, and the ranks build the group again
    under a fresh prefix until all of them have it."""
    err: "Optional[RuntimeError]" = None
    for attempt in range(GLOO_CONNECT_ATTEMPTS):
        sub = dist.PrefixStore(f"{prefix}/attempt{attempt}", store)
        try:
            pg, err = dist.ProcessGroupGloo(sub, rank, size, timeout), None
        except RuntimeError as e:  # the handshake; the group is rebuilt below
            pg, err = None, e
        sub.set(f"built/{rank}", "1" if err is None else "0")
        keys = [f"built/{r}" for r in range(size)]
        # a rank whose handshake failed fast waits for the others, which may
        # wait out their own connect timeout for it before they fail
        sub.wait(keys, 2 * timeout)
        if all(sub.get(k) == b"1" for k in keys):
            return pg
        logger.warning(
            "gloo group %s: the handshake failed on a rank (attempt %d of %d)%s",
            prefix, attempt + 1, GLOO_CONNECT_ATTEMPTS,
            f": {err}" if err is not None else "",
        )
    raise RuntimeError(
        f"gloo group {prefix}: the handshake failed {GLOO_CONNECT_ATTEMPTS} times"
    ) from err


def _default_backend(num_processes: int) -> str:
    if (
        torch.cuda.is_available()
        and dist.is_nccl_available()
        and torch.cuda.device_count() >= num_processes
    ):
        return "nccl"
    return "gloo"


def coordinator_listener(host: str = "127.0.0.1") -> "Tuple[str, socket.socket]":
    """A socket listening at a port the OS picks, and its ``host:port``:
    the coordinator address a harness hands every process of a group.

    Process 0's store serves on this very socket (``initialize_multihost(
    ..., listener=sock)``), so the port is never free between its pick
    and its bind.  The harness gives the socket to process 0 (a
    spawned process's arguments carry it; ``subprocess`` takes its fd in
    ``pass_fds``) and closes its own copy once that process has started."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.bind((host, 0))
        sock.listen(128)
    except OSError:
        sock.close()
        raise
    return f"{host}:{sock.getsockname()[1]}", sock


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: "Optional[str]" = None,
    timeout: float = 300.0,
    listener: "Optional[socket.socket]" = None,
) -> GroupWorld:
    """Join this process to its replica group: process 0 hosts a
    ``TCPStore`` at ``coordinator_address`` (``host:port``), the others
    connect to it.  ``backend`` defaults to NCCL when every process can own
    a card of this host and to gloo otherwise.  ``listener`` (process 0
    only) is a socket already listening at that port, from
    :func:`coordinator_listener`: the store takes its fd over and closes it.
    Returns the :class:`GroupWorld` the group's process groups are built
    from; sets no process-global default group."""
    host, _, port = coordinator_address.rpartition(":")
    backend = backend or _default_backend(num_processes)
    if listener is not None and process_id != 0:
        raise ValueError("only process 0 hosts the coordinator's store")
    store = dist.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0,
        timeout=timedelta(seconds=timeout), wait_for_workers=False,
        master_listen_fd=None if listener is None else listener.detach(),
    )
    logger.info(
        "replica group member %d of %d at %s: in-group backend %s",
        process_id, num_processes, coordinator_address, backend,
    )
    return GroupWorld(store, process_id, num_processes, backend, timeout)


def local_worlds(size: int, timeout: float = 30.0) -> "List[GroupWorld]":
    """``size`` gloo ranks of one process (threads) over one ``HashStore``:
    the CPU tests' and rehearsals' replica group."""
    store = dist.HashStore()
    return [GroupWorld(store, r, size, "gloo", timeout) for r in range(size)]


def run_ranks(
    fn: "Callable[[int], Any]", size: int, timeout: float = 60.0
) -> "List[Any]":
    """Run ``fn(rank)`` for ``rank in range(size)``, one thread each, and
    return the results in rank order.  A rank's exception, or a rank still
    running after ``timeout`` seconds, raises here."""
    results: "List[Any]" = [None] * size
    errors: "List[Tuple[int, BaseException]]" = []

    def run(rank: int) -> None:
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append((rank, e))

    threads = [
        threading.Thread(target=run, args=(r,), name=f"rank{r}", daemon=True)
        for r in range(size)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    if errors:
        rank, err = errors[0]
        raise RuntimeError(f"rank {rank} failed: {err!r}") from err
    if hung:
        raise TimeoutError(f"ranks still running after {timeout} s: {hung}")
    return results


def host_sharded_array(
    global_shape: "Sequence[int]",
    index: "Tuple[slice, ...]",
    fill: "Callable[[Tuple[slice, ...]], Any]",
) -> torch.Tensor:
    """This rank's shard of a global array: ``fill(index)`` (numpy or a
    tensor) for the global slices ``index`` of ``global_shape``, checked
    against the shape the slices give.  The JAX package assembles a global
    array from every process's shards (``jax.make_array_from_callback``);
    an SPMD torch program keeps only its own."""
    want = tuple(
        len(range(*s.indices(n))) for s, n in zip(index, global_shape)
    ) + tuple(global_shape[len(index):])
    out = torch.as_tensor(fill(index))
    if tuple(out.shape) != want:
        raise ValueError(f"fill gave {tuple(out.shape)} for {index}, expected {want}")
    return out


__all__ = [
    "GroupWorld",
    "coordinator_listener",
    "host_sharded_array",
    "initialize_multihost",
    "local_worlds",
    "run_ranks",
]
