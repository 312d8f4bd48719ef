"""Manager: the per-worker fault-tolerance state machine.

PyTorch port of ``torchft_tpu/manager.py`` (reference: torchft/manager.py).
Orchestrates the per-step protocol: quorum (async, overlapped with forward),
process-group reconfiguration on quorum change, live healing (send/recv of
the composite state dict), error capture, and the commit vote.

What differs from the JAX package:
- state dicts are pytrees of torch tensors, flattened in JAX's leaf order
  (``utils.pytree``), so leaf order — and the heal wire layout — match;
- the collective layer runs host-side with Work handles; a CUDA gradient is
  copied to the host on the PG worker thread and the averaged result goes
  back to the device its input leaf came from;
- the allreduce zero-fills non-participants and divides by the live
  participant count (reference manager.py:416-417,447-454);
- the durable store spill and the weight publish copy the state to the
  host under the state-dict read lock before their workers encode it,
  since torch updates tensors in place (the JAX package's arrays are
  immutable).

Heal: the default transport is ``HTTPTransport``.  With
``TORCHFT_HEAL_STREAM`` (on by default) a source stages its state as a
cut-through fragment stream and a healer stripes the fragments across
every max-step peer (``TORCHFT_HEAL_SOURCES``), or fetches only the
fragments whose digest moved against its own state (``TORCHFT_HEAL_DELTA``),
decoding into its existing tensors.  ``PGTransport`` still works when
passed in.

Env knobs (parity with reference manager.py:76-89):
``TORCHFT_LIGHTHOUSE`` (a single ``host:port`` or the coordination-plane
HA comma list ``h1:p,h2:p,h3:p`` — the native manager's lighthouse
client walks dead peers and follows ``NOT_LEADER`` redirects to the
current lease holder, so a replicated lighthouse needs no Manager-side
changes; docs/architecture.md "Coordination-plane HA"),
``TORCHFT_MANAGER_PORT``, ``TORCHFT_TIMEOUT_SEC``,
``TORCHFT_QUORUM_TIMEOUT_SEC``, ``TORCHFT_CONNECT_TIMEOUT_SEC``,
``TORCHFT_QUORUM_RETRIES`` (quorum RPC attempts on connection failure,
with exponential backoff + full jitter via ``utils.retry.RetryPolicy``
inside the quorum timeout budget — no longer a bare loop count).
Chaos: ``TORCHFT_FAULTS`` / ``TORCHFT_FAULTS_SEED`` (utils/faults.py)
inject failures at ``manager.quorum`` / ``manager.heal`` /
``pg.allreduce``.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, TypeVar, cast

import numpy as np
import torch
from torch.profiler import record_function

from torchft_tpu_torch.checkpointing import provenance as provenance
from torchft_tpu_torch.checkpointing import serialization as ser
from torchft_tpu_torch.checkpointing import store as fragment_store
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer, StoreClient, StoreServer
from torchft_tpu_torch.parallel.process_group import (
    ProcessGroup,
    REDUCE_AVG,
    REDUCE_SUM,
)
from torchft_tpu_torch.parallel.work import Work, completed_work
from torchft_tpu_torch.utils import faults as faults
from torchft_tpu_torch.utils import flightrecorder as flightrec
from torchft_tpu_torch.utils import linkstats as linkstats
from torchft_tpu_torch.utils import metrics as metrics
from torchft_tpu_torch.utils import tracing as tracing
from torchft_tpu_torch.utils.env import env_bool, env_float, env_int, env_str
from torchft_tpu_torch.utils.logging import ReplicaLogger, log_event
from torchft_tpu_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten
from torchft_tpu_torch.utils.retry import RetryPolicy
from torchft_tpu_torch.utils.rwlock import RWLock

logger = logging.getLogger(__name__)

T = TypeVar("T")

MANAGER_ADDR_KEY = "manager_addr"
REPLICA_ID_KEY = "replica_id"
#: ``<LEAVE_KEY>/<replica id>/<group rank>``: that rank has left the group's
#: ManagerServer (see ``Manager._leave_group``)
LEAVE_KEY = "manager_leave"

#: Canonical per-step phase vocabulary recorded by ``_record_phase`` (the
#: quorum_duration histogram labels, flight-recorder phase records, and
#: per-phase trace spans all use these names).  The tft-verify protocol
#: model renders its counterexample traces in the same vocabulary
#: (analysis/protocol_model.MODEL_PHASE_OPS), pinned by a tier-1 test —
#: add here BEFORE recording a new phase name.
PROTOCOL_PHASES = (
    "quorum_wait",
    "quorum_rpc",
    "pg_configure",
    "heal_send",
    "heal_recv",
    # striped-heal receive split (ISSUE 15): manifest fetch from the
    # primary / local digest diff / striped fragment wire / decode into
    # retained buffers — heal_recv stays the umbrella total.
    "heal_manifest",
    "heal_diff",
    "heal_wire",
    "heal_decode",
    "reshard",
    "layout_commit",
    "host_sync",
    "ring",
    "commit",
)

TIMEOUT_SEC = env_float("TORCHFT_TIMEOUT_SEC", 60.0)
QUORUM_TIMEOUT_SEC = env_float("TORCHFT_QUORUM_TIMEOUT_SEC", 60.0)
CONNECT_TIMEOUT_SEC = env_float("TORCHFT_CONNECT_TIMEOUT_SEC", 10.0)
QUORUM_RETRIES = env_int("TORCHFT_QUORUM_RETRIES", 0, minimum=0)


def _to_sec(t: "float | timedelta | None", default: float) -> float:
    if t is None:
        return default
    if isinstance(t, timedelta):
        return t.total_seconds()
    return float(t)


def _is_floating(dtype: Any) -> bool:
    """True for float dtypes, torch's or numpy's."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return bool(np.issubdtype(dtype, np.floating))


def _divide(x: Any, n: int) -> Any:
    """The AVG divide of a reduced host leaf, as the JAX package computes
    it.  There numpy promotes an ``ml_dtypes`` bf16 array divided by an int
    to f32, so a bf16 leaf's average is the f32 quotient of its
    bf16-rounded sum; the port does the same."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.to(torch.float32) / n
    return x / n


class WorldSizeMode(Enum):
    """How the quorum world size behaves (reference manager.py:112-127).

    DYNAMIC: the world grows/shrinks with membership; gradients are averaged
    over the live participant count.
    FIXED_WITH_SPARES: the world is capped at min_replica_size; extra healthy
    replicas are warm spares that compute but do not contribute.
    """

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class Manager:
    """Fault-tolerance manager for one worker of one replica group.

    Args:
        pg: the replica-dimension process group (reconfigured per quorum).
        min_replica_size: minimum replicas for a commit to count.
        load_state_dict / state_dict: callables for the user training state
            (pytree); more can be registered via register_state_dict_fn.
        use_async_quorum: overlap quorum with the forward pass.
        checkpoint_transport: transport for live healing; defaults to
            ``HTTPTransport(timeout=timeout)`` (``PGTransport`` over ``pg``
            works too).
        store_addr: address of this replica group's rendezvous store; if
            None and group_rank == 0, an in-process StoreServer is started.
        replica_id: stable id of this replica group; a ``:uuid`` suffix is
            appended for fast-restart disambiguation (reference :300-306).
    """

    def __init__(
        self,
        pg: ProcessGroup,
        min_replica_size: int,
        load_state_dict: "Optional[Callable[[Any], None]]" = None,
        state_dict: "Optional[Callable[[], Any]]" = None,
        use_async_quorum: bool = True,
        timeout: "float | timedelta" = TIMEOUT_SEC,
        quorum_timeout: "float | timedelta" = QUORUM_TIMEOUT_SEC,
        connect_timeout: "float | timedelta" = CONNECT_TIMEOUT_SEC,
        group_rank: "Optional[int]" = None,
        group_world_size: "Optional[int]" = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        store_addr: "Optional[str]" = None,
        lighthouse_addr: "Optional[str]" = None,
        replica_id: "Optional[str]" = None,
        port: "Optional[int]" = None,
        checkpoint_transport: "Optional[CheckpointTransport[Any]]" = None,
        init_sync: bool = True,
        max_retries: "Optional[int]" = None,
        quorum_retries: int = QUORUM_RETRIES,
        heartbeat_interval: float = 0.1,
    ) -> None:
        self._pg = pg
        self._min_replica_size = min_replica_size
        self._use_async_quorum = use_async_quorum
        self._timeout = _to_sec(timeout, TIMEOUT_SEC)
        self._quorum_timeout = _to_sec(quorum_timeout, QUORUM_TIMEOUT_SEC)
        self._connect_timeout = _to_sec(connect_timeout, CONNECT_TIMEOUT_SEC)
        self._replica_world_size_mode = world_size_mode
        self._init_sync = init_sync
        self._max_retries = max_retries
        # Real backoff semantics for quorum_retries (previously only a bare
        # loop count inside the native server): connection-level failures of
        # the quorum RPC retry with exponential backoff + full jitter, all
        # inside the quorum timeout budget.  TimeoutError is NOT retried —
        # the budget expiring IS the failure — and RpcError is not either
        # (the server already applied its own lighthouse retries).
        self._quorum_policy = RetryPolicy(
            name="manager.quorum",
            max_attempts=max(quorum_retries, 0) + 1,
            base_delay=0.25,
            multiplier=2.0,
            max_delay=5.0,
            retryable=(ConnectionError,),
        )

        self._group_rank = (
            group_rank if group_rank is not None else env_int("RANK", 0, minimum=0)
        )
        self._group_world_size = (
            group_world_size
            if group_world_size is not None
            else env_int("WORLD_SIZE", 1)
        )

        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}
        if load_state_dict is not None and state_dict is not None:
            self.register_state_dict_fn("default", load_state_dict, state_dict)

        if checkpoint_transport is None:
            from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

            checkpoint_transport = HTTPTransport(timeout=self._timeout)
        self._checkpoint_transport: CheckpointTransport[Any] = checkpoint_transport

        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_quorum"
        )
        self._quorum_future: "Optional[concurrent.futures.Future[None]]" = None

        self._state_dict_lock = RWLock(timeout=self._timeout)
        self._pending_state_dict: "Optional[Dict[str, Any]]" = None
        self._errored: "Optional[Exception]" = None
        self._healing = False
        # the last striped heal's info (mode, sources, fragments, phases)
        self._heal_info: "Dict[str, Any]" = {}
        self._recovery_future: "Optional[concurrent.futures.Future[None]]" = None
        self._participating_replica_rank: "Optional[int]" = None
        self._participating_replica_world_size: int = 0

        self._step = 0
        self._batches_committed = 0
        self._commit_failures = 0
        self._quorum_id = -1

        # Wall-clock accumulated per protocol phase — the FT-overhead
        # observability surface (the reference only exposes these as
        # profiler spans, torchft/manager.py:385,591,790); consumers read
        # the non-destructive ``phase_times`` snapshot.  ``_record_phase``
        # additionally feeds the torchft_quorum_duration_seconds histogram
        # and, when a tracer is installed, one child span per phase under
        # the round's root span.
        self._phase_acc: Dict[str, float] = {}
        self._phase_lock = threading.Lock()
        # Trace context of the in-flight quorum round (None when tracing
        # is off or the step is unsampled).  The trace id is DERIVED FROM
        # THE STEP (tracing.step_trace_id), so every replica group, the
        # lighthouse, and both heal endpoints of one training step share
        # one trace with zero coordination.
        self._round_ctx: "Optional[tracing.TraceContext]" = None
        self._round_start_ns = 0
        self._round_step = 0

        # --- coordination wiring (reference manager.py:277-325) -----------
        lighthouse_addr = lighthouse_addr or env_str("TORCHFT_LIGHTHOUSE") or None
        if lighthouse_addr is None:
            raise ValueError(
                "lighthouse_addr (or TORCHFT_LIGHTHOUSE) is required"
            )

        self._owned_store: "Optional[StoreServer]" = None
        if store_addr is None:
            if self._group_world_size != 1:
                raise ValueError(
                    "store_addr is required when group_world_size > 1"
                )
            self._owned_store = StoreServer()
            store_addr = self._owned_store.address()
        self._store_addr = store_addr
        store = StoreClient(store_addr, connect_timeout=self._connect_timeout)

        self._manager_server: "Optional[ManagerServer]" = None
        if self._group_rank == 0:
            if replica_id is None:
                replica_id = ""
            # uuid suffix: a fast-restarted replica must not be confused with
            # its dead predecessor in lighthouse state.
            new_replica_id = replica_id + ":" + str(uuid.uuid4())
            bind_port = port or env_int("TORCHFT_MANAGER_PORT", 0, minimum=0)
            self._manager_server = ManagerServer(
                replica_id=new_replica_id,
                lighthouse_addr=lighthouse_addr,
                store_address=store_addr,
                world_size=self._group_world_size,
                bind=f":{bind_port}",
                heartbeat_interval=heartbeat_interval,
                connect_timeout=self._connect_timeout,
                quorum_retries=quorum_retries,
            )
            # replica_id BEFORE manager_addr: readers probe the addr and
            # then read the id, so publishing in this order guarantees a
            # live addr is never paired with the previous incarnation's id
            store.set(REPLICA_ID_KEY, new_replica_id)
            store.set(MANAGER_ADDR_KEY, self._manager_server.address())

        # Non-zero ranks discover the group's ManagerServer through the
        # store.  After a whole-group fast restart the store still holds
        # the DEAD incarnation's address until the new rank 0 republishes
        # — probe the endpoint and re-read until a live server answers
        # (bounded by connect_timeout), instead of wiring this Manager to
        # a corpse for its whole lifetime.
        def _probe(budget: "Optional[float]") -> str:
            probe_timeout = (
                self._connect_timeout if budget is None else max(budget, 0.001)
            )
            addr = store.get(MANAGER_ADDR_KEY, timeout=probe_timeout)
            if self._manager_server is None and not self._endpoint_alive(addr):
                raise ConnectionError(
                    f"manager server at {addr} (from store) not accepting "
                    f"connections yet"
                )
            return addr

        try:
            addr = RetryPolicy(
                name="manager.store_probe",
                base_delay=0.25,
                multiplier=1.0,
                max_delay=0.25,
                jitter=False,
                retryable=(ConnectionError,),
            ).run(_probe, timeout=self._connect_timeout)
        except TimeoutError as e:
            raise TimeoutError(
                f"manager server (from store) unreachable within "
                f"connect_timeout={self._connect_timeout}s: {e.__cause__ or e}"
            ) from e
        # read the id AFTER the probe succeeds: rank 0 publishes replica_id
        # before manager_addr, so a live addr implies the matching
        # incarnation's id is already visible
        self._replica_id = store.get(REPLICA_ID_KEY, timeout=self._connect_timeout)
        # A live listener at the probed address need not be this group's
        # server: on a busy host another process can hold the dead
        # incarnation's port while the new rank 0 has not yet republished.
        # So a non-zero rank's client re-reads the store whenever its
        # server refuses a connection, and follows a republished address.
        self._client = ManagerClient(
            addr,
            connect_timeout=self._connect_timeout,
            resolve=None if self._group_rank == 0 else self._published_manager_addr,
        )
        store.close()

        self._logger = ReplicaLogger(self, self._replica_id, self._group_rank)
        # The process-wide scrape endpoint (TORCHFT_METRICS_PORT) starts
        # once, at package import (torchft_tpu_torch/__init__.py).
        # Metric labels use the STABLE replica id (the prefix before the
        # ':<uuid>' incarnation suffix): every restart would otherwise mint
        # a fresh label value, growing the process-wide registry without
        # bound across crash-and-heal cycles and resetting each series'
        # counters (breaking rate() continuity).  Events/logs keep the full
        # incarnation id — they are records, not series.
        self._metric_replica_id = (
            self._replica_id.split(":", 1)[0] or self._replica_id
        )
        # Bound metric children cached per replica: the labels() lookup is
        # ~9 us and _record_phase sits on the step hot path — caching keeps
        # the telemetry cost per phase at the observe() itself (~1 us).
        self._phase_hist: Dict[str, Any] = {}
        self._m_allreduces = metrics.ALLREDUCES.labels(
            replica_id=self._metric_replica_id
        )
        self._m_commits = {
            result: metrics.COMMITS.labels(
                replica_id=self._metric_replica_id, result=result
            )
            for result in ("success", "failure")
        }
        self._m_step = metrics.STEP.labels(replica_id=self._metric_replica_id)
        self._m_participants = metrics.PARTICIPANTS.labels(
            replica_id=self._metric_replica_id
        )
        # Cluster step-timeline digest state (guarded by _phase_lock):
        # phase_times() snapshot at the last digest, plus codec/wire busy
        # seconds accumulated from quantized collectives since then.  The
        # per-step deltas ride the native manager's lighthouse heartbeat
        # (report_summary) into /timeline.json.
        self._summary_phase_snapshot: Dict[str, float] = {}
        self._summary_codec_s = 0.0
        self._summary_wire_s = 0.0
        # Online parallelism switching (parallel/layout.py): optional
        # LayoutController attached via attach_layout().  When present,
        # every quorum entry carries this group's layout epoch + shard
        # manifest, and the async-quorum thread runs the two-phase
        # switch protocol (commit round first, then plan+stage).
        self._layout: "Optional[Any]" = None
        # Durable fragment store (checkpointing/store.py): opt-in via
        # TORCHFT_STORE_DIR.  Committed steps spill to disk off the hot
        # path (single-worker spiller) and the store is attached to the
        # checkpoint transport so peers' cold-start restores can
        # stripe-fetch spilled fragments from this rank's disk exactly
        # like a live heal.
        self._frag_store = fragment_store.store_from_env(
            self._metric_replica_id, self._group_rank
        )
        self._spiller: "Optional[Any]" = None
        self._spill_pending: "Optional[int]" = None
        self._last_spill = 0.0
        # the last spill's snapshot_s (on the caller) and the spiller's
        # skipped count; the store's last_put holds encode and write
        self._spill_info: "Dict[str, Any]" = {}
        # Weight serving (serving/publisher.py): the committed step's
        # user state is published at the next round's start
        # (attach_weight_publisher); publish_info() reports the caller's
        # snapshot time beside the publisher's encode and staging
        self._weight_publisher: "Optional[Any]" = None
        self._publish_pending: "Optional[int]" = None
        self._publish_executor: "Optional[ThreadPoolExecutor]" = None
        self._publish_info: "Dict[str, Any]" = {}
        if self._frag_store is not None:
            attach = getattr(self._checkpoint_transport, "attach_store", None)
            if attach is not None:
                attach(self._frag_store)
            self._spiller = fragment_store.StoreSpiller(self._frag_store)

    def _published_manager_addr(self) -> str:
        """The group's ManagerServer address as the store holds it now; on a
        change, this Manager takes the matching incarnation's replica id
        (rank 0 publishes the id first)."""
        store = StoreClient(self._store_addr, connect_timeout=self._connect_timeout)
        try:
            addr = store.get(MANAGER_ADDR_KEY, timeout=self._connect_timeout)
            if addr != self._client.address():
                replica_id = store.get(REPLICA_ID_KEY, timeout=self._connect_timeout)
                self._logger.warning(
                    f"manager server at {self._client.address()} unreachable; the "
                    f"store now publishes {addr} ({replica_id}): following it"
                )
                self._replica_id = replica_id
                self._logger = ReplicaLogger(self, replica_id, self._group_rank)
            return addr
        finally:
            store.close()

    @staticmethod
    def _endpoint_alive(addr: str, probe_timeout: float = 1.0) -> bool:
        """True if a TCP listener answers at ``addr`` ("host:port")."""
        from torchft_tpu_torch.coordination import parse_host_port

        try:
            with socket.create_connection(parse_host_port(addr), probe_timeout):
                return True
        except OSError:
            return False

    # ------------------------------------------------------------------
    # state dict registry
    # ------------------------------------------------------------------

    def register_state_dict_fn(
        self,
        key: str,
        load_state_dict_fn: "Callable[[Any], None]",
        state_dict_fn: "Callable[[], Any]",
    ) -> None:
        """Register a named slice of user state for healing
        (reference manager.py:355-366)."""
        self._load_state_dict_fns[key] = load_state_dict_fn
        self._user_state_dicts[key] = state_dict_fn

    def _manager_state_dict(self) -> "Dict[str, Any]":
        with self._state_dict_lock.r_lock():
            assert self._user_state_dicts, "user state_dict is not initialized"
            return {
                "user": {k: fn() for k, fn in self._user_state_dicts.items()},
                "torchft": self.state_dict(),
            }

    def state_dict(self) -> "Dict[str, int]":
        return {"step": self._step, "batches_committed": self._batches_committed}

    def load_state_dict(self, state_dict: "Dict[str, int]") -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    # Hooks for callers that mutate user state outside the step protocol
    # (reference local_sgd.py:112-124 toggles these around optimizer
    # mutation): disallow takes the state-dict write lock so a concurrent
    # checkpoint send cannot snapshot mid-mutation.
    def disallow_state_dict_read(self) -> None:
        self._state_dict_lock.acquire_write()

    def allow_state_dict_read(self) -> None:
        self._state_dict_lock.release_write()

    def attach_layout(self, controller: Any) -> Any:
        """Attach a :class:`~torchft_tpu_torch.parallel.layout.LayoutController`
        enabling online parallelism switching: on membership change the
        fleet re-plans its (dp, shard, pp) layout under a monotone layout
        epoch, re-shards registered state live over the checkpoint
        transport, and commits the switch at the same quorum round on
        every group or rolls back.  Returns the controller for chaining."""
        self._layout = controller
        if hasattr(controller, "bind"):
            controller.bind(self)
        return controller

    def layout_controller(self) -> "Optional[Any]":
        return self._layout

    def attach_weight_publisher(self, publisher: Any) -> Any:
        """Attach a :class:`~torchft_tpu_torch.serving.WeightPublisher`:
        every COMMITTED step's user state is published as weight version
        ``step`` into the serving tier.  Timing: the user applies the
        optimizer update AFTER ``should_commit`` returns, so the snapshot
        is taken at the start of the NEXT round — and flushed at
        :meth:`shutdown` for the final step.  Attach to ONE rank per job,
        typically group 0's rank 0; the publisher's versions fan out
        through the lighthouse-synthesized distribution tree.  Publish
        failures are logged, never allowed to fail training.  Returns the
        publisher for chaining."""
        self._weight_publisher = publisher
        return publisher

    def _flush_pending_publish(self, wait: bool = False) -> None:
        """Publish the last committed step's user state, if one is
        pending (called from the next round's start and from shutdown —
        both points where the user's post-commit optimizer update has
        fully materialized).

        Only the SNAPSHOT runs on the caller: under the state-dict read
        lock every leaf is copied to the host (torch updates tensors in
        place, so the publisher must not encode the live tensors).  The
        encode + staging + HTTP advertise run on a single-worker executor
        so a multi-GB publish never turns the publishing rank into the
        fleet's straggler at every ``start_quorum``.  One worker keeps
        versions ordered; ``wait`` (shutdown) drains the queue so the
        final version is staged before the transports die."""
        version, self._publish_pending = self._publish_pending, None
        pub = self._weight_publisher
        if pub is None:
            return
        if version is not None:
            t0 = time.perf_counter()
            try:
                with self._state_dict_lock.r_lock():
                    state = tree_map(ser.host_copy, {
                        k: fn() for k, fn in self._user_state_dicts.items()
                    })
            except Exception:  # noqa: BLE001 - serving never fails training
                self._logger.exception("weight-publish snapshot failed")
                return
            self._publish_info = {
                "version": version, "snapshot_s": time.perf_counter() - t0,
            }
            if self._publish_executor is None:
                self._publish_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="tft_weight_publish"
                )

            def _do_publish() -> None:
                try:
                    pub.publish(state, version=version)
                except Exception:  # noqa: BLE001 - never fails training
                    self._logger.exception(
                        "weight publish failed (serving tier degraded "
                        "this step)"
                    )

            self._publish_executor.submit(_do_publish)
        if wait and self._publish_executor is not None:
            self._publish_executor.shutdown(wait=True)
            self._publish_executor = None

    def publish_info(self) -> "Dict[str, Any]":
        """The last weight publish's ``version`` and ``snapshot_s`` (the
        host copy on the caller); empty before the first."""
        return dict(self._publish_info)

    def _flush_pending_spill(self, wait: bool = False) -> None:
        """Spill the last committed step to the durable fragment store,
        if one is pending and the ``TORCHFT_STORE_SPILL_S`` cadence has
        elapsed (0 = every commit).  Only the snapshot runs on the
        caller: under the state-dict read lock every leaf is copied to
        the host (a CUDA tensor once, a CPU tensor cloned — the optimizer
        updates them in place), so the spilled bytes are exactly what a
        live replica at this step holds.  Encode + blob writes + manifest
        publish run on the single spill worker, and a failed spill skips
        the version (counted), never failing or stalling training."""
        version, self._spill_pending = self._spill_pending, None
        spiller = self._spiller
        if spiller is None:
            return
        if wait:
            # shutdown path: drain the in-flight spill FIRST so the final
            # committed version is accepted instead of skipped (the
            # no-backlog rule exists to protect the training loop, which
            # is over by now)
            spiller.flush()
        if version is not None:
            interval = env_float("TORCHFT_STORE_SPILL_S", 0.0, minimum=0.0)
            if time.monotonic() - self._last_spill >= interval:
                t0 = time.perf_counter()
                try:
                    with self._state_dict_lock.r_lock():
                        state = tree_map(ser.host_copy, {
                            "user": {
                                k: fn()
                                for k, fn in self._user_state_dicts.items()
                            },
                            "torchft": self.state_dict(),
                        })
                except Exception:  # noqa: BLE001 - spill never fails training
                    self._logger.exception("store spill snapshot failed")
                    state = None
                self._spill_info = {
                    "version": version,
                    "snapshot_s": time.perf_counter() - t0,
                }
                if state is not None and spiller.submit(version, state):
                    self._last_spill = time.monotonic()
        if wait:
            spiller.flush()

    def store_info(self) -> "Dict[str, Any]":
        """The durable store's last spill: ``snapshot_s`` (the host copy
        on the caller), ``encode_s`` and ``write_s`` of the last spill
        the worker finished (``put_version``), ``bytes_written`` and the
        versions ``skipped`` so far; empty without a store."""
        if self._frag_store is None:
            return {}
        put = dict(self._frag_store.last_put)
        info = dict(self._spill_info)
        info.update({
            "put_version": put.pop("version", None),
            "skipped": (
                self._spiller.skipped if self._spiller is not None
                else self._spill_info.get("skipped", 0)
            ),
            **put,
        })
        return info

    # ------------------------------------------------------------------
    # quorum
    # ------------------------------------------------------------------

    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: "float | timedelta | None" = None,
    ) -> None:
        """Begin a new step: compute quorum (possibly async) and ready the PG.

        Reference: torchft/manager.py:534-589.
        """
        if self._quorum_future is not None:
            self._quorum_future.result()

        self._errored = None
        self._healing = False
        # Durable store: the previous round's committed state is fully
        # materialized by now (the user's optimizer update ran between
        # should_commit and this call) — spill it as that step's version
        # before the new round begins.
        self._flush_pending_spill()
        # Weight serving: publish the previous round's committed state
        # (attach_weight_publisher; no-op when unattached).
        self._flush_pending_publish()
        # Straggler telemetry: piggyback (step, in-flight op) on the native
        # manager's lighthouse heartbeats, so the lighthouse can compute
        # per-replica step lag and straggler scores while this replica is
        # inside the quorum protocol.
        self._report_progress("quorum")

        tracer = tracing.get_tracer()
        ctx: "Optional[tracing.TraceContext]" = None
        if tracer is not None and tracer.sample_step(self._step):
            # Deterministic per-step trace id: every replica at this step
            # derives the same one (and the same sampling decision), so a
            # sampled step's trace is complete across the whole fleet.
            ctx = tracing.TraceContext(
                tracing.step_trace_id(self._step), tracing.new_span_id()
            )
        self._round_ctx = ctx
        self._round_start_ns = time.time_ns() if ctx is not None else 0
        self._round_step = self._step
        # Bind on the caller thread too: the allreduce submit and the
        # should_commit RPC run here and must inject the same context.
        tracing.set_current(ctx)

        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal=allow_heal,
            shrink_only=shrink_only,
            quorum_timeout=_to_sec(timeout, self._quorum_timeout),
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # eagerly apply the healed state so the forward pass runs on
                # recovered weights
                self._apply_pending_state_dict()
                self._healing = False

    def wait_quorum(self) -> None:
        assert (
            self._quorum_future is not None
        ), "must call start_quorum before wait_quorum"
        t0 = time.perf_counter()
        self._quorum_future.result()
        self._record_phase("quorum_wait", time.perf_counter() - t0)

    def _async_quorum(
        self, allow_heal: bool, shrink_only: bool, quorum_timeout: float
    ) -> None:
        # The executor thread is where the quorum RPC, pg configure, and
        # the heal transfers run: bind the round's trace context so every
        # outbound RPC (manager quorum, store barriers) and the heal
        # transports carry it.
        tracing.set_current(self._round_ctx)
        try:
            t_rpc = time.perf_counter()
            with record_function("torchft::manager::_client::_quorum"):

                def _quorum_rpc(budget: "Optional[float]") -> Any:
                    # chaos site INSIDE the retry policy: an injected drop
                    # (ConnectionError) exercises the quorum_retries backoff
                    # path; an injected raise escapes to report_error
                    faults.check(
                        "manager.quorum", replica=self._replica_id, step=self._step
                    )
                    return self._client._quorum(
                        group_rank=self._group_rank,
                        step=self._step,
                        checkpoint_metadata=self._checkpoint_transport.metadata(),
                        shrink_only=shrink_only,
                        timeout=budget if budget is not None else quorum_timeout,
                        init_sync=self._init_sync,
                        commit_failures=self._commit_failures,
                        layout_epoch=(
                            0 if self._layout is None else self._layout.wire_epoch()
                        ),
                        layout_data=(
                            "" if self._layout is None else self._layout.wire_data()
                        ),
                    )

                quorum = self._quorum_policy.run(
                    _quorum_rpc, timeout=quorum_timeout, op="manager.quorum"
                )
            self._record_phase("quorum_rpc", time.perf_counter() - t_rpc)
        except Exception as e:  # noqa: BLE001 - captured into the protocol
            # Graceful capture (the reference leaves this as a TODO,
            # manager.py:566-567): the replica sits out this step and votes
            # False rather than crashing the training loop.
            self._logger.exception(f"got exception in quorum: {e}")
            self._participating_replica_rank = None
            self._participating_replica_world_size = 0
            self.report_error(e if isinstance(e, Exception) else RuntimeError(str(e)))
            return

        # Async quorum participates with the max-step cohort (healing
        # replicas contribute zeros this step); sync quorum heals eagerly so
        # everyone participates (reference manager.py:641-657).
        self._participating_replica_rank, self._participating_replica_world_size = (
            (quorum.max_replica_rank, quorum.max_world_size)
            if self._use_async_quorum or not allow_heal
            else (quorum.replica_rank, quorum.replica_world_size)
        )

        if self._replica_world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            self._participating_replica_world_size = min(
                self._participating_replica_world_size, self._min_replica_size
            )
            if (
                self._participating_replica_rank is not None
                and self._participating_replica_rank >= self._min_replica_size
            ):
                self._participating_replica_rank = None

        # Online parallelism switching, two-phase (parallel/layout.py):
        # FIRST resolve the previous round's staged switch (commit when
        # the whole quorum reports the staged epoch, else roll back and
        # burn it), THEN — if the live world no longer fits the active
        # layout — plan the next layout and run the reshard transfers on
        # this thread, where heal runs.  Neither phase may fail the
        # training step: a broken switch degrades to the old layout.
        # Runs BEFORE pg configure and the allow_heal gate: this round's
        # quorum entry already advertised our epoch report, so skipping
        # the commit round here (configure error, heal-less round) would
        # let the rest of the fleet activate without us — the exact
        # mixed-generation split the all-commit-same-epoch invariant
        # forbids.  The transfers ride the checkpoint transport, not the
        # PG, so ordering before configure is safe.
        if self._layout is not None:
            t_lc = time.perf_counter()
            outcome = ""
            try:
                faults.check(
                    "manager.layout_commit",
                    replica=self._replica_id,
                    step=quorum.max_step,
                )
                outcome = self._layout.maybe_commit(quorum)
            except Exception as e:  # noqa: BLE001 - degrade, never wedge
                self._logger.exception(f"layout commit failed: {e}")
                self._layout.abort_staged(f"layout commit failed: {e}")
                outcome = "rolled_back"
            if outcome:
                self._record_phase("layout_commit", time.perf_counter() - t_lc)
                metrics.LAYOUT_SWITCHES.labels(
                    replica_id=self._metric_replica_id, result=outcome
                ).inc()
                active = self._layout.active_layout()
                metrics.LAYOUT_EPOCH.labels(
                    replica_id=self._metric_replica_id
                ).set(active.epoch if active is not None else 0)
                log_event(
                    "layout",
                    f"layout switch {outcome}",
                    job_id=env_str("JOB_ID", "unknown"),
                    replica_id=self._replica_id,
                    rank=self._group_rank,
                    quorum_id=quorum.quorum_id,
                    step=quorum.max_step,
                    outcome=outcome,
                    layout=str(active.key() if active is not None else None),
                )
            t_rs = time.perf_counter()
            try:
                staged = self._layout.maybe_stage(self, quorum)
            except Exception as e:  # noqa: BLE001 - degrade, never wedge
                self._logger.exception(f"layout staging failed: {e}")
                self._layout.abort_staged(f"layout staging failed: {e}")
                staged = True
            if staged:
                self._record_phase("reshard", time.perf_counter() - t_rs)

        if quorum.quorum_id != self._quorum_id:
            metrics.QUORUM_CHANGES.labels(replica_id=self._metric_replica_id).inc()
            log_event(
                "quorum",
                "quorum changed",
                job_id=env_str("JOB_ID", "unknown"),
                replica_id=self._replica_id,
                rank=self._group_rank,
                quorum_id=quorum.quorum_id,
                step=quorum.max_step,
            )
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}/{self._group_rank}"
            )
            self._logger.info(
                f"reconfiguring for quorum_id={quorum.quorum_id} store={store_prefixed_addr}"
            )
            try:
                t_cfg = time.perf_counter()
                with record_function("torchft::manager::_pg::configure"):
                    self._pg.configure(
                        store_prefixed_addr,
                        self._replica_id,
                        quorum.replica_rank,
                        quorum.replica_world_size,
                    )
                self._record_phase("pg_configure", time.perf_counter() - t_cfg)
                self._quorum_id = quorum.quorum_id
                log_event(
                    "reconfigure",
                    "pg reconfigured",
                    job_id=env_str("JOB_ID", "unknown"),
                    replica_id=self._replica_id,
                    rank=self._group_rank,
                    quorum_id=quorum.quorum_id,
                    step=quorum.max_step,
                    replica_world_size=quorum.replica_world_size,
                )
            except Exception as e:  # noqa: BLE001 - captured into the protocol
                self._logger.exception(f"got exception in pg configure: {e}")
                self.report_error(e)
                return

        if not allow_heal:
            return

        # Striped heal: stream-stage fragments + stripe the receive across
        # every max-step peer when the transport carries the fragment
        # protocol (the flag must be literally True so duck-typed test
        # doubles keep the legacy path).
        streamed_heal = (
            env_bool("TORCHFT_HEAL_STREAM", True)
            and getattr(
                self._checkpoint_transport, "supports_striped_heal", False
            )
            is True
        )

        # Whole-fleet cold start: nobody in the quorum holds
        # live state (max_step == 0) but disks might — restore the newest
        # complete, consistent spilled cut through the striped heal path
        # with files as stripe sources.  Every replica computes the same
        # deterministic cut from the same fleet catalogs, so a
        # successful restore replaces this round's live init-sync
        # branches entirely; a failed one degrades to fresh init (and a
        # replica whose restore failed alone re-heals live next round
        # once its peers commit) — never a wedge.
        if (
            self._frag_store is not None
            and streamed_heal
            and self._step == 0
            and quorum.max_step == 0
        ):
            if self._maybe_cold_restore(quorum):
                return

        # Proactive stripe-source staging: a max-step participant can
        # tell healers exist this round (the max-step cohort is smaller
        # than the quorum) and stages its own fragment stream so healers
        # aggregate up-to-date uplinks beyond the assigned primary's.
        # Bounded by the SAME pure quorum math the healer's source
        # resolution applies: every healer stripes over the first
        # TORCHFT_HEAL_SOURCES max-step roster entries (minus its
        # primary), so only those participants stage.  Degrade-only: a
        # failed proactive stage merely shrinks the healer's stripe back
        # toward the primary.
        if (
            streamed_heal
            and not quorum.recover_dst_replica_ranks
            and not quorum.heal
            and quorum.max_replica_rank is not None
            and quorum.max_world_size < quorum.replica_world_size
            and self._in_stripe_source_set(quorum)
        ):
            t_send = time.perf_counter()
            try:
                with record_function(
                    "torchft::manager::_checkpoint_transport::send_checkpoint"
                ):
                    self._checkpoint_transport.send_checkpoint_streamed(
                        dst_ranks=[],
                        step=quorum.max_step,
                        state_dict=self._manager_state_dict(),
                        timeout=self._timeout,
                    )
                self._record_phase("heal_send", time.perf_counter() - t_send)
                log_event(
                    "heal",
                    "staged stripe-source checkpoint for healing peers",
                    job_id=env_str("JOB_ID", "unknown"),
                    replica_id=self._replica_id,
                    rank=self._group_rank,
                    quorum_id=quorum.quorum_id,
                    step=quorum.max_step,
                    direction="send",
                    proactive=True,
                )
            except Exception as e:  # noqa: BLE001 - degrade, never wedge
                self._logger.warning(
                    f"proactive stripe-source staging failed "
                    f"(healers fall back to fewer sources): {e}"
                )

        try:
            if quorum.recover_dst_replica_ranks:
                faults.check(
                    "manager.heal", replica=self._replica_id, step=quorum.max_step
                )
                self._logger.info(
                    f"peers need recovery from us {quorum.recover_dst_replica_ranks}"
                )
                t_send = time.perf_counter()
                with record_function(
                    "torchft::manager::_checkpoint_transport::send_checkpoint"
                ):
                    if streamed_heal:
                        self._checkpoint_transport.send_checkpoint_streamed(
                            dst_ranks=quorum.recover_dst_replica_ranks,
                            step=quorum.max_step,
                            state_dict=self._manager_state_dict(),
                            timeout=self._timeout,
                        )
                    else:
                        self._checkpoint_transport.send_checkpoint(
                            dst_ranks=quorum.recover_dst_replica_ranks,
                            step=quorum.max_step,
                            state_dict=self._manager_state_dict(),
                            timeout=self._timeout,
                        )
                self._record_phase("heal_send", time.perf_counter() - t_send)
                metrics.HEALS.labels(
                    replica_id=self._metric_replica_id, direction="send"
                ).inc()
                log_event(
                    "heal",
                    "sent checkpoint to healing peers",
                    job_id=env_str("JOB_ID", "unknown"),
                    replica_id=self._replica_id,
                    rank=self._group_rank,
                    quorum_id=quorum.quorum_id,
                    step=quorum.max_step,
                    direction="send",
                    dst_ranks=quorum.recover_dst_replica_ranks,
                )

            if quorum.heal:
                faults.check(
                    "manager.heal", replica=self._replica_id, step=quorum.max_step
                )
                self._healing = True
                t_recv = time.perf_counter()
                self._logger.info(
                    f"healing required, fetching checkpoint metadata from "
                    f"{quorum.recover_src_manager_address} max_step={quorum.max_step}"
                )
                primary_client = ManagerClient(
                    quorum.recover_src_manager_address,
                    connect_timeout=self._connect_timeout,
                )
                checkpoint_metadata = primary_client._checkpoint_metadata(
                    self._group_rank, timeout=self._timeout
                )
                primary_client.close()
                assert (
                    quorum.recover_src_replica_rank is not None
                ), "must have a recover rank when healing"
                heal_info: "Dict[str, Any]" = {}
                with record_function(
                    "torchft::manager::_checkpoint_transport::recv_checkpoint"
                ):
                    if streamed_heal:
                        sources = [checkpoint_metadata]
                        # Stripe only when genuinely BEHIND the cohort:
                        # an init-sync force-recover round has every
                        # replica at max_step with unsynchronized state —
                        # only the primary's copy is truth there.
                        if quorum.max_replica_rank is None:
                            sources += self._resolve_stripe_sources(
                                quorum, checkpoint_metadata
                            )
                        (
                            self._pending_state_dict,
                            heal_info,
                        ) = self._checkpoint_transport.recv_checkpoint_striped(
                            sources,
                            step=quorum.max_step,
                            timeout=self._timeout,
                            local_state_fn=self._manager_state_dict,
                        )
                    else:
                        self._pending_state_dict = (
                            self._checkpoint_transport.recv_checkpoint(
                                src_rank=quorum.recover_src_replica_rank,
                                metadata=checkpoint_metadata,
                                step=quorum.max_step,
                                timeout=self._timeout,
                            )
                        )
                self._heal_info = heal_info
                self.load_state_dict(self._pending_state_dict["torchft"])
                # loading the torchft dict restores the step; set it anyway
                # to make reasoning (and tests) simpler
                self._step = quorum.max_step
                # Phase split: the striped path records its four
                # sub-phases plus the residue (metadata RPC, source
                # resolution, reassembly) under the legacy heal_recv
                # name, so ledger sums stay exact and never double-count
                # a split phase against its umbrella.
                # Each name is a literal, so span-vocab can check it.
                heal_phases = heal_info.get("phases") or {}
                if "heal_manifest" in heal_phases:
                    self._record_phase(
                        "heal_manifest", heal_phases["heal_manifest"]
                    )
                if "heal_diff" in heal_phases:
                    self._record_phase("heal_diff", heal_phases["heal_diff"])
                if "heal_wire" in heal_phases:
                    self._record_phase("heal_wire", heal_phases["heal_wire"])
                if "heal_decode" in heal_phases:
                    self._record_phase(
                        "heal_decode", heal_phases["heal_decode"]
                    )
                self._record_phase(
                    "heal_recv",
                    max(
                        time.perf_counter()
                        - t_recv
                        - sum(heal_phases.values()),
                        0.0,
                    ),
                )
                metrics.HEALS.labels(
                    replica_id=self._metric_replica_id, direction="recv"
                ).inc()
                log_event(
                    "heal",
                    "received checkpoint from peer",
                    job_id=env_str("JOB_ID", "unknown"),
                    replica_id=self._replica_id,
                    rank=self._group_rank,
                    quorum_id=quorum.quorum_id,
                    step=quorum.max_step,
                    direction="recv",
                    src_rank=quorum.recover_src_replica_rank,
                    mode=heal_info.get("mode", "legacy"),
                    stripe_sources=heal_info.get("sources", 1),
                    changed_fragments=heal_info.get("changed"),
                )
        except Exception as e:  # noqa: BLE001 - captured into the protocol
            self._logger.exception(f"got exception in recovery: {e}")
            self.report_error(e)

    def _in_stripe_source_set(self, quorum: Any) -> bool:
        """True when this replica is among the first
        ``TORCHFT_HEAL_SOURCES`` max-step participants in roster order —
        the superset every healer's ``_resolve_stripe_sources`` pick
        (first ``max_sources - 1`` entries after excluding its primary)
        can reach, computed from the same roster on every peer by the
        plan layer's one copy of the first-K math."""
        from torchft_tpu_torch.analysis.plan_ir import stripe_source_cohort

        max_sources = env_int("TORCHFT_HEAL_SOURCES", 4, minimum=1)
        return self._replica_id in stripe_source_cohort(
            quorum.participants, quorum.max_step, max_sources
        )

    def _resolve_stripe_sources(
        self, quorum: Any, primary_metadata: str
    ) -> "List[str]":
        """Transport addresses of the max-step quorum peers beyond the
        assigned primary — the striped heal's extra sources.

        The participants roster (replica-rank order) carries each peer's
        manager address and step; every peer at ``max_step`` holds
        bitwise-replicated state, so its fragments must hash to the
        primary's manifest digests.  Each candidate's checkpoint
        transport address resolves through its manager's
        ``checkpoint_metadata`` RPC, in parallel and best-effort: an
        unreachable peer just shrinks the stripe.  Bounded by
        ``TORCHFT_HEAL_SOURCES`` (total sources including the primary);
        the candidate pick is the plan layer's
        :func:`~torchft_tpu_torch.analysis.plan_ir.stripe_roster`."""
        from torchft_tpu_torch.analysis.plan_ir import stripe_roster

        max_sources = env_int("TORCHFT_HEAL_SOURCES", 4, minimum=1)
        candidates = stripe_roster(
            quorum.participants,
            quorum.max_step,
            quorum.recover_src_replica_rank,
            max_sources,
        )
        if not candidates:
            return []

        def _resolve(addr: str) -> "Optional[str]":
            client = ManagerClient(
                addr, connect_timeout=self._connect_timeout
            )
            try:
                return client._checkpoint_metadata(
                    self._group_rank, timeout=self._connect_timeout
                )
            except Exception as e:  # noqa: BLE001 - best-effort stripe
                self._logger.info(
                    f"stripe source {addr} unresolvable ({e}); striping "
                    f"without it"
                )
                return None
            finally:
                client.close()

        with ThreadPoolExecutor(
            max_workers=min(len(candidates), 4),
            thread_name_prefix="tft_stripe_resolve",
        ) as pool:
            resolved = list(pool.map(_resolve, candidates))
        return [
            m for m in resolved if m and m != primary_metadata
        ]

    def _resolve_store_bases(self, quorum: Any, own: str) -> "List[str]":
        """Checkpoint-transport addresses of every reachable quorum
        participant plus our own — cold restore canvasses ALL disks
        (everyone is at step 0, so there is no max-step cohort to
        prefer).  Sorted + deduped so every replica that resolves the
        same roster derives the same base list, which keeps cut
        selection deterministic fleet-wide."""
        addrs: "List[str]" = []
        for p in quorum.participants:
            if isinstance(p, dict) and p.get("address"):
                addrs.append(p["address"])

        def _resolve(addr: str) -> "Optional[str]":
            client = ManagerClient(
                addr, connect_timeout=self._connect_timeout
            )
            try:
                return client._checkpoint_metadata(
                    self._group_rank, timeout=self._connect_timeout
                )
            except Exception as e:  # noqa: BLE001 - best-effort discovery
                self._logger.info(
                    f"store base {addr} unresolvable ({e}); restoring "
                    f"without its disk"
                )
                return None
            finally:
                client.close()

        resolved: "List[Optional[str]]" = []
        if addrs:
            with ThreadPoolExecutor(
                max_workers=min(len(addrs), 4),
                thread_name_prefix="tft_store_resolve",
            ) as pool:
                resolved = list(pool.map(_resolve, addrs))
        return sorted({m for m in resolved if m} | {own})

    def _maybe_cold_restore(self, quorum: Any) -> bool:
        """Whole-fleet cold-start restore (docs/architecture.md "Durable
        fragment store").

        Discovers spilled catalogs across every reachable disk (own +
        peers' via ``/store/versions``), picks the newest complete,
        consistent cut (:func:`~torchft_tpu_torch.checkpointing.store.
        select_cut` — deterministic, never mixes fragment versions), and
        reassembles it via ``recv_checkpoint_striped`` with disks as
        stripe sources: per-fragment failover across disks, delta reuse
        of surviving local state.  Returns True when restored (state is
        pending; the standard healing application path applies it).
        Any failure returns False — fresh init, never a wedge."""
        t0 = time.perf_counter()
        try:
            faults.check("store.restore", replica=self._replica_id, step=0)
            own = self._checkpoint_transport.metadata()
            bases = self._resolve_store_bases(quorum, own)
            catalogs: "Dict[str, Any]" = {}
            for base in bases:
                cat = fragment_store.fetch_catalog(
                    base, timeout=self._connect_timeout
                )
                if cat:
                    catalogs[base] = cat
            t_cut = time.perf_counter()
            plan = fragment_store.select_cut(catalogs)
            if plan is None:
                return False
            restore = {
                "catalog_s": t_cut - t0,
                "cut_s": time.perf_counter() - t_cut,
                "version": plan[0],
                "disks": len(plan[1]),
            }
            version, sources = plan
            # The cut fixes which disks hold the version; which one is
            # fetched as the primary is this replica's choice: its own
            # disk when that is complete.  A peer's disk as the primary
            # fails the restore if the peer exits mid-restore (the primary
            # is retried for the whole deadline, never failed over), while
            # the own disk stays up as long as this replica runs.
            if own in sources and catalogs[own][version].get("complete"):
                sources = [own] + [b for b in sources if b != own]
            self._logger.info(
                f"cold restore: selected spilled v{version} across "
                f"{len(sources)} disk(s)"
            )
            self._healing = True
            (
                self._pending_state_dict,
                info,
            ) = self._checkpoint_transport.recv_checkpoint_striped(
                sources,
                step=version,
                timeout=self._timeout,
                local_state_fn=self._manager_state_dict,
                plane="restore",
            )
            metrics.STORE_RESTORE_BYTES.labels(
                mode=info.get("mode", "full")
            ).inc(int(info.get("wire_bytes") or 0))
            self.load_state_dict(
                cast(Dict[str, int], self._pending_state_dict["torchft"])
            )
            restore["wall_s"] = time.perf_counter() - t0
            self._heal_info = dict(info, restore=restore)
            self._record_phase("heal_recv", restore["wall_s"])
            metrics.HEALS.labels(
                replica_id=self._metric_replica_id, direction="recv"
            ).inc()
            log_event(
                "heal",
                "cold-restored from durable store",
                job_id=env_str("JOB_ID", "unknown"),
                replica_id=self._replica_id,
                rank=self._group_rank,
                quorum_id=quorum.quorum_id,
                step=version,
                direction="recv",
                mode=info.get("mode", "full"),
                stripe_sources=info.get("sources", 1),
                changed_fragments=info.get("changed"),
            )
            self._logger.info(
                f"cold-restored to step {version} from {len(sources)} "
                f"store source(s) mode={info.get('mode')}"
            )
            return True
        except Exception as e:  # noqa: BLE001 - degrade to fresh init
            self._logger.warning(f"cold restore failed (starting fresh): {e}")
            self._healing = False
            self._pending_state_dict = None
            return False

    def heal_info(self) -> "Dict[str, Any]":
        """The last striped heal's info: ``mode`` (full/delta/legacy),
        ``sources``, ``fragments``, ``changed``, ``wire_bytes``,
        ``failovers``, ``sources_used`` and the ``phases`` split; empty
        before the first heal or after a heal over another transport.  A
        cold restore adds ``restore``: ``catalog_s`` (disk discovery and
        catalogs), ``cut_s`` (``select_cut``), ``version``, ``disks`` and
        ``wall_s``."""
        return dict(self._heal_info)

    def _apply_pending_state_dict(self) -> None:
        assert self._healing, "must be in healing state"
        assert self._quorum_future is not None, "must call start_quorum first"
        self._quorum_future.result()

        pending = self._pending_state_dict
        if pending is None:
            assert self.errored() is not None, (
                "checkpoint was not staged and no error occurred"
            )
            return
        self._logger.info("applying pending state dict")
        assert self._load_state_dict_fns, "user load_state_dict is not initialized"
        user_state = cast(Dict[str, Any], pending["user"])
        for key, load_fn in self._load_state_dict_fns.items():
            load_fn(user_state[key])
        self._pending_state_dict = None

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def allreduce(
        self,
        value: Any,
        should_quantize: bool = False,
        reduce_op: str = REDUCE_AVG,
        device_quantize: "Optional[bool]" = None,
    ) -> Work:
        """Fault-tolerant allreduce of a tensor/array or a pytree of them.

        Averages over the live participant count; non-participants (healing
        replicas) contribute zeros.  On error the Work completes *cleanly*
        with the input (zeroed) value and the error is tracked for
        ``should_commit`` (reference manager.py:385-467).

        Tensor leaves come back as tensors on the device they came from;
        the device→host copy runs on the PG worker thread (unquantized) or
        inside the quantized collective.  bf16 leaves are reduced in f32
        and rounded back to bf16; the AVG divide then takes that bf16 sum
        to an f32 quotient, as the JAX package's numpy does (``_divide``).

        ``should_quantize`` routes the leaves through
        :func:`~torchft_tpu_torch.ops.collectives.allreduce_quantized` (int8
        or fp8 on the wire); ``device_quantize`` is forwarded to it:
        ``None`` = auto (kernel D on the card when every leaf is a CUDA
        tensor).  A non-participant's zeros are host arrays, so it always
        takes the host codec; the wire format is shared.
        """
        if self.errored():
            return completed_work(value)

        self.wait_quorum()
        num_participants = self.num_participants()

        t_host = time.perf_counter()
        leaves, treedef = tree_flatten(value)
        # Leaves pass through unmaterialized: the PG (or the quantized
        # collective) converts them, so the device→host copy overlaps
        # whatever the caller does next instead of blocking this thread
        # (counted in the ``ring`` phase).  Non-array leaves (Python
        # scalars) still need numpy wrapping for the dtype checks below.
        send_leaves: "List[Any]" = [
            x if isinstance(x, (np.ndarray, torch.Tensor)) else np.asarray(x)
            for x in leaves
        ]
        dtypes = [x.dtype for x in send_leaves]
        devices = [
            x.device if isinstance(x, torch.Tensor) else None
            for x in send_leaves
        ]
        if not self.is_participating():
            send_leaves = [
                torch.zeros(tuple(x.shape), dtype=dt)
                if isinstance(dt, torch.dtype)
                else np.zeros(tuple(x.shape), dtype=dt)
                for x, dt in zip(send_leaves, dtypes)
            ]
        self._record_phase("host_sync", time.perf_counter() - t_host)

        if reduce_op == REDUCE_AVG:
            if not all(_is_floating(dt) for dt in dtypes):
                raise ValueError(
                    "average reduce op is only supported for floating point arrays"
                )
            pg_reduce_op = REDUCE_SUM
        else:
            pg_reduce_op = reduce_op

        self._m_allreduces.inc()
        try:
            faults.check(
                "pg.allreduce", replica=self._replica_id, step=self._step
            )
            t_submit = time.perf_counter()
            if should_quantize:
                from torchft_tpu_torch.ops.collectives import allreduce_quantized

                work = allreduce_quantized(
                    send_leaves, pg_reduce_op, self._pg,
                    device_quantize=device_quantize,
                )
            else:
                work = self._pg.allreduce(send_leaves, pg_reduce_op)

            def _postprocess(reduced: "List[Any]") -> Any:
                if reduce_op == REDUCE_AVG:
                    reduced = [_divide(x, num_participants) for x in reduced]
                return tree_unflatten(
                    treedef,
                    [
                        x if dev is None
                        else (x if isinstance(x, torch.Tensor)
                              else torch.from_numpy(x)).to(dev)
                        for x, dev in zip(reduced, devices)
                    ],
                )

            chained = work.then(_postprocess)
            # quantized-pipeline accounting for the step digest: the stats
            # dict is filled once the pipeline finished, i.e. before _done
            # fires (read through the dict, so _done holds no reference
            # back to the Work whose future calls it)
            qs = getattr(work, "quant_stats", None)

            # Track errors out-of-band: the returned Work must complete
            # cleanly so the training loop proceeds to should_commit.
            out: concurrent.futures.Future = concurrent.futures.Future()

            def _done(f: "concurrent.futures.Future[Any]") -> None:
                self._record_phase("ring", time.perf_counter() - t_submit)
                if isinstance(qs, dict):
                    with self._phase_lock:
                        self._summary_codec_s += float(qs.get("codec_s") or 0.0)
                        self._summary_wire_s += float(qs.get("wire_s") or 0.0)
                exc = f.exception()
                if exc is not None:
                    self.report_error(
                        exc if isinstance(exc, Exception) else RuntimeError(str(exc))
                    )
                    out.set_result(tree_unflatten(treedef, send_leaves))
                else:
                    out.set_result(f.result())

            chained.get_future().add_done_callback(_done)
            managed = Work(out)
            # surface the collective's wire/codec accounting on the
            # returned handle: the quantized pipeline's (wire_bytes set
            # synchronously; codec_s_box/quant_stats written at pipeline
            # completion — read after wait) and the TCP ring's measured
            # wire_bytes on the unquantized path
            for attr in (
                "wire_bytes",
                "unquantized_wire_bytes",
                "device_quantized",
                "wire_dtype",
                "codec_s_box",
                "quant_stats",
            ):
                if hasattr(work, attr):
                    setattr(managed, attr, getattr(work, attr))
            return managed
        except Exception as e:  # noqa: BLE001 - captured into the protocol
            self._logger.exception(f"got exception in allreduce -- skipping: {e}")
            self.report_error(e)
            return completed_work(value)

    # ------------------------------------------------------------------
    # errors & commit
    # ------------------------------------------------------------------

    def report_error(self, e: Exception) -> None:
        """Latch an async error; the current step will not be committed
        (reference manager.py:469-482)."""
        self._errored = e
        metrics.ERRORS.labels(replica_id=self._metric_replica_id).inc()
        log_event(
            "error",
            str(e),
            job_id=env_str("JOB_ID", "unknown"),
            replica_id=self._replica_id,
            rank=self._group_rank,
            quorum_id=self._quorum_id,
            step=self._step,
        )
        # Flight recorder: the latched error plus a crash-durable dump of
        # the ring around it — an unhandled manager error is a dump
        # trigger (utils/flightrecorder.py); no-op without
        # TORCHFT_FLIGHT_FILE.
        flightrec.record(
            "manager.error",
            status="error",
            error=str(e),
            replica_id=self._replica_id,
            rank=self._group_rank,
            quorum_id=self._quorum_id,
            step=self._step,
        )
        flightrec.dump(f"manager error: {e!r}", trigger="manager_error")

    def errored(self) -> "Optional[Exception]":
        return self._errored

    def should_commit(self, timeout: "float | timedelta | None" = None) -> bool:
        """Vote on committing this step; all group workers return the same
        value (reference manager.py:790-878)."""
        # recovery (send/recv checkpoint) must be complete before committing
        if self._quorum_future is not None:
            t_q = time.perf_counter()
            try:
                self._quorum_future.result()
            except Exception as e:  # noqa: BLE001
                self.report_error(
                    e if isinstance(e, Exception) else RuntimeError(str(e))
                )
            finally:
                self._record_phase("quorum_wait", time.perf_counter() - t_q)

        if (err := self._pg.errored()) is not None:
            self.report_error(err)

        if self._healing:
            self._apply_pending_state_dict()

        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self._errored is None
        t_commit = time.perf_counter()
        try:
            should_commit = self._client.should_commit(
                self._group_rank,
                self._step,
                local_should_commit,
                timeout=_to_sec(timeout, self._timeout),
            )
        except ConnectionError as e:
            # The vote RPC is non-idempotent (no blind resend — a double-
            # delivered vote could release the barrier with a stale tally),
            # so a broken connection surfaces here.  Abstain: latch the
            # error and treat the step as uncommitted — if the group did
            # commit without us, our step falls behind and the next quorum
            # heals us, the same path as any other failed step.
            self._logger.exception(f"should_commit rpc failed, abstaining: {e}")
            self.report_error(e)
            should_commit = False
        self._record_phase("commit", time.perf_counter() - t_commit)
        self._m_commits["success" if should_commit else "failure"].inc()
        self._m_participants.set(self.num_participants())
        self._logger.info(
            f"should_commit={should_commit} enough_replicas={enough_replicas}, "
            f"errored={self._errored}"
        )
        log_event(
            "commit",
            "commit vote",
            job_id=env_str("JOB_ID", "unknown"),
            replica_id=self._replica_id,
            rank=self._group_rank,
            quorum_id=self._quorum_id,
            step=self._step,
            commit_result=should_commit,
        )

        # Layout two-phase hook: the barrier outcome decides whether a
        # staged reshard survives into the next quorum's commit round —
        # every local rank observes the same vote, so the whole group
        # either carries the staged epoch or burns it together.
        if self._layout is not None:
            self._layout.on_step_commit(should_commit)

        self._checkpoint_transport.disallow_checkpoint()

        # Raised AFTER the round's root span closes below: the terminally
        # failed round is exactly the one a post-mortem trace needs, and
        # the thread-local context must not leak past the raise.
        retries_exhausted: "Optional[RuntimeError]" = None
        if should_commit:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            # Durable store: the committed step spills to disk at the
            # NEXT round's start (the user's post-commit optimizer update
            # must land first so the spilled bytes equal what a live
            # replica at this step holds), off the hot path on the single
            # spill worker.
            self._spill_pending = self._step
            # Weight serving: publish the committed step at the next
            # round's start, after the user's optimizer update
            # (attach_weight_publisher; no-op when unattached).
            self._publish_pending = self._step
        else:
            self._commit_failures += 1
            if (
                self._max_retries is not None
                and self._commit_failures > self._max_retries
            ):
                msg = (
                    f"should_commit failed {self._commit_failures} times "
                    f"consecutively, exceeding max_retries={self._max_retries}"
                )
                self._logger.exception(msg)
                retries_exhausted = RuntimeError(msg)
        self._m_step.set(self._step)
        # step (possibly) advanced: refresh the heartbeat-piggybacked
        # progress so lighthouse step-lag tracking follows commits, not
        # just quorum entries — and ship the step digest (phase deltas +
        # codec/wire busy) for the cluster timeline
        self._report_progress("")
        self._report_step_summary()

        # Close the quorum round's root span (children were emitted per
        # phase from _record_phase, native rpc.* server spans joined via
        # the shared trace id); the ``step`` attribute is the step the
        # round RAN, matching the trace-id derivation, so the diagnose
        # ledger joins spans, flight dumps, and the lighthouse timeline
        # on one key.
        tracer = tracing.get_tracer()
        ctx, self._round_ctx = self._round_ctx, None
        if tracer is not None and ctx is not None:
            tracer.export_span(
                name="quorum_round",
                trace_id=ctx.trace_id,
                span_id=ctx.span_id,
                start_ns=self._round_start_ns,
                end_ns=time.time_ns(),
                attributes={
                    "replica_id": self._replica_id,
                    "rank": self._group_rank,
                    "quorum_id": self._quorum_id,
                    "step": self._round_step,
                    "commit_result": should_commit,
                },
                ok=self._errored is None and retries_exhausted is None,
            )
        tracing.set_current(None)
        if retries_exhausted is not None:
            raise retries_exhausted
        return should_commit

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def _record_phase(self, name: str, dt: float) -> None:
        """Record one phase timing into every observability surface: the
        destructive accumulator (bench), the non-destructive
        torchft_quorum_duration_seconds histogram (scrapers), and — when a
        tracer is installed — a child span under the round's root span.
        Called from the caller thread AND the async quorum thread."""
        with self._phase_lock:
            self._phase_acc[name] = self._phase_acc.get(name, 0.0) + dt
        # flight record per phase: the quorum protocol's footprint in the
        # postmortem timeline (~6 records/step; record() is ~1 us)
        end_ns = time.time_ns()
        flightrec.record(
            name,
            kind="phase",
            start_ns=end_ns - int(dt * 1e9),
            end_ns=end_ns,
            replica_id=self._replica_id,
            quorum_id=self._quorum_id,
            step=self._step,
        )
        child = self._phase_hist.get(name)
        if child is None:
            # benign race: concurrent creators both resolve to the same
            # underlying child (labels() is keyed), last write wins
            child = metrics.QUORUM_DURATION.labels(
                replica_id=self._metric_replica_id, phase=name
            )
            self._phase_hist[name] = child
        child.observe(dt)
        tracer = tracing.get_tracer()
        ctx = self._round_ctx
        if tracer is not None and ctx is not None:
            end_ns = time.time_ns()
            # Phase names come from PROTOCOL_PHASES (pinned by tier-1;
            # span-vocab lint checks the literal call sites).
            tracer.export_span(
                name=name,
                trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id,
                start_ns=end_ns - int(dt * 1e9),
                end_ns=end_ns,
                attributes={
                    "replica_id": self._replica_id,
                    "quorum_id": self._quorum_id,
                    "step": self._step,
                },
            )

    def phase_times(self) -> "Dict[str, float]":
        """Non-destructive snapshot of the cumulative wall-clock seconds
        spent per protocol phase.  Safe for any number of concurrent
        consumers (bench takes deltas between snapshots); scrapers should
        prefer the ``torchft_quorum_duration_seconds`` histogram, which
        this same data also feeds.

        Caller-thread keys: ``quorum_wait`` (blocked waiting for the async
        quorum work — the part NOT hidden behind the forward pass; includes
        the wait in ``should_commit``), ``host_sync`` (caller-thread
        flatten + zero-fill; the device→host materialisation itself runs on
        the PG worker and lands in ``ring``), ``ring`` (collective
        submit→completion: device sync, queueing, the wire, and the
        host-side AVG division chained after the raw collective),
        ``commit`` (should_commit RPC barrier).

        Async-quorum-thread keys (run inside the executor, so they OVERLAP
        ``quorum_wait`` rather than adding to it — they break down what the
        caller was waiting FOR): ``quorum_rpc`` (the lighthouse-mediated
        quorum round trip), ``pg_configure`` (collective reconfigure on
        quorum change), ``heal_send`` / ``heal_recv`` (live checkpoint
        transfer to/from a recovering peer, incl. the metadata fetch),
        ``reshard`` (online-parallelism-switch staging: plan + slice-diff
        transfers into the staged buffer) and ``layout_commit`` (the
        fleet-wide activate/rollback of a staged layout at the commit
        round) — both only with a LayoutController attached.

        (``pop_phase_times``, the destructive single-consumer drain this
        replaced, was deprecated in PR 3 and removed in PR 9.)
        """
        with self._phase_lock:
            return dict(self._phase_acc)

    def _report_progress(self, inflight_op: str) -> None:
        """Push (step, in-flight op) to the group's native ManagerServer so
        its lighthouse heartbeats carry per-replica progress (rank 0 only —
        the heartbeat is per replica group).  Best-effort: progress
        telemetry never fails a step."""
        server = self._manager_server
        if server is None:
            return
        try:
            server.report_progress(self._step, inflight_op)
        except Exception:  # noqa: BLE001 - telemetry must not fail the step
            logger.debug("progress report failed", exc_info=True)

    def _report_step_summary(self) -> None:
        """Ship the per-step digest (phase-time deltas since the last
        digest, codec/wire busy seconds from quantized collectives) to the
        native ManagerServer; its next lighthouse heartbeat carries it
        once into the rolling cluster timeline (``/timeline.json``).
        Best-effort like :meth:`_report_progress`."""
        server = self._manager_server
        if server is None:
            return
        with self._phase_lock:
            phases = {
                k: round((v - self._summary_phase_snapshot.get(k, 0.0)) * 1e3, 3)
                for k, v in self._phase_acc.items()
                if v - self._summary_phase_snapshot.get(k, 0.0) > 0.0
            }
            self._summary_phase_snapshot = dict(self._phase_acc)
            codec_s, self._summary_codec_s = self._summary_codec_s, 0.0
            wire_s, self._summary_wire_s = self._summary_wire_s, 0.0
        try:
            server.report_summary(
                {
                    "step": self._step,
                    "phase_ms": phases,
                    "codec_busy_s": round(codec_s, 6),
                    "wire_busy_s": round(wire_s, 6),
                }
            )
        except Exception:  # noqa: BLE001 - telemetry must not fail the step
            logger.debug("step summary report failed", exc_info=True)
        # Piggyback the fleet link-state digest on the same heartbeat
        # channel (consumed-on-send, like the summary).  maybe_digest
        # rate-limits itself (TORCHFT_LINK_REPORT_S), so this is a no-op
        # on most steps; a faulted or failing report never touches the
        # step path.
        try:
            digest = linkstats.LINKS.maybe_digest(socket.gethostname())
            if digest is not None:
                server.report_links(digest)
        except Exception:  # noqa: BLE001 - telemetry must not fail the step
            logger.debug("link digest report failed", exc_info=True)
        # Same piggyback channel for the fragment provenance digest: hand
        # the bounded version-vector digest to the native heartbeat loop,
        # which owns consumed-on-send/restore.
        fdigest = None
        try:
            fdigest = provenance.PROV.maybe_digest(socket.gethostname())
            if fdigest is not None:
                server.report_fragments(fdigest)
        except Exception:  # noqa: BLE001 - telemetry must not fail the step
            provenance.PROV.restore_digest(fdigest)
            logger.debug("fragment digest report failed", exc_info=True)

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def participating_rank(self) -> "Optional[int]":
        if self._quorum_future is None:
            return None
        self.wait_quorum()
        return self._participating_replica_rank

    def num_participants(self) -> int:
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        assert self._participating_replica_world_size >= 0, "internal error"
        return self._participating_replica_world_size

    def is_participating(self) -> bool:
        if self._participating_replica_rank is None:
            return False
        if self._healing:
            assert self._use_async_quorum
            return False
        return True

    def replica_id(self) -> str:
        return self._replica_id

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def shutdown(self, wait: bool = True) -> None:
        """Tear down transport, servers, client and executor.

        The four legs are independent (separate sockets/threads), so they
        shut down CONCURRENTLY: during recovery the replacement replica's
        time-to-healthy includes the dying incarnation's teardown, and the
        serial version's ~40 ms (r4 recovery_phases teardown leg) was the
        second-largest addressable recovery phase.  Reference semantics
        preserved (manager.rs shutdown aborts in one Drop).
        """
        # Final committed step spills too (wait=True drains the worker),
        # so a clean shutdown leaves the newest step restorable on disk.
        self._flush_pending_spill(wait=True)
        if self._spiller is not None:
            self._spill_info["skipped"] = self._spiller.skipped
            self._spiller.shutdown()
            self._spiller = None
        # Final committed step's weight version, if a publisher is
        # attached: drain before the transports die.
        self._flush_pending_publish(wait=True)
        self._leave_group()
        legs = [
            lambda: self._checkpoint_transport.shutdown(wait=wait),
            self._client.close,
        ]
        if self._manager_server is not None:
            legs.append(self._manager_server.shutdown)
        if self._owned_store is not None:
            legs.append(self._owned_store.shutdown)
        threads = [
            threading.Thread(target=leg, daemon=True) for leg in legs[1:]
        ]
        for t in threads:
            t.start()
        legs[0]()  # checkpoint transport on the caller thread
        if wait:
            for t in threads:
                t.join(timeout=5.0)
        self._executor.shutdown(wait=wait)

    def _leave_group(self) -> None:
        """The ranks of a group leave its ManagerServer together: each marks
        its leave in the group's store, and rank 0 stops the server only
        once every other rank has, or after ``connect_timeout``.  Rank 0
        takes its last ``should_commit`` decision as soon as the barrier
        releases; stopping the server then can close a peer's connection
        before that peer's reply is written, and the peer abstains from a
        step its group committed, its next quorum finding no server."""
        if self._group_world_size == 1:
            return
        prefix = f"{LEAVE_KEY}/{self._replica_id}/"
        store = StoreClient(self._store_addr, connect_timeout=self._connect_timeout)
        try:
            if self._group_rank != 0:
                store.set(prefix + str(self._group_rank), "1")
                return
            deadline = time.monotonic() + self._connect_timeout
            for rank in range(1, self._group_world_size):
                store.get(prefix + str(rank),
                          timeout=max(deadline - time.monotonic(), 0.001))
        except Exception as e:  # noqa: BLE001 - a rank that is gone: leave anyway
            self._logger.warning(f"leaving the group without every rank: {e}")
        finally:
            store.close()

    def __enter__(self) -> "Manager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
