"""Online parallelism switching: layout planning + live resharding.

PyTorch port of ``torchft_tpu/parallel/layout.py``.  The planner, the
interval math and the epoch machine are the JAX package's, line for line.
Registered sharded state may be torch tensors (on the CPU or the card) or
numpy arrays: the held slices, the staged buffer of a switch and the
double-write all stay on the device of the held leaf, and only the slices
another group fetches go through the host (the transport stages host
copies).  A bf16 leaf moves as its 16-bit pattern, never converted.

When quorum membership changes (DynaTrain, PAPERS.md),
the fleet should not just resize the elastic DP dimension — it should
re-plan the whole (dp, shard, pp) layout and re-shard parameters live,
so the job continuously fits the hardware it has instead of degrading
permanently on a shrink or wasting a grow.

Three pieces, all deterministic so every replica group computes the same
answer from the same quorum result with zero extra coordination:

- **Planner** (:func:`plan_layout`): given the live participant count and
  declared :class:`LayoutConstraints` (divisibility, min DP for the
  batch, per-group memory ceiling), pick the best feasible
  :class:`Layout` under a total ordering (max dp, then min pp, then
  least movement vs the previous layout).
- **Epoch state machine** (:class:`LayoutState`): layouts activate under
  a monotone **layout epoch** stamped into the quorum round.  Two-phase:
  *plan+stage* during the step the membership change was observed
  (transfers run on the async-quorum thread, exactly like heal), then
  *commit* at the next quorum iff every participant reports the staged
  epoch (``min == max == E`` on the wire) — so the whole fleet switches
  at the same step or not at all.  A failed stage anywhere rolls the
  whole fleet back to the old layout and **burns** the epoch (a
  rolled-back epoch is never reused — the tft-verify ``resize`` model
  proves both properties and catches the seeded violations).
- **Reshard data path** (:class:`LayoutController`): each group computes
  the slice diff between its old and new shardings and fetches only the
  missing intervals from their current owners over the HTTP
  checkpoint-streaming machinery — heal generalized from "copy
  everything from one peer" to "re-layout from many peers".  Transfers
  ride the existing retry/backoff policy (the transport's 503-poll
  fetch policy); any failure aborts cleanly to the old layout: degrade,
  never wedge.

Sharding model: the elastic units are replica groups arranged in a
``dp x shard x pp`` grid (``world = dp * shard * pp``).  ``dp`` is the
replication degree (today's only dimension); ``shard`` partitions each
registered state leaf's flat element space; ``pp`` partitions it again
(layer-major, folded into one combined shard index ``shard * pp`` for
the host data path).  The inner per-group device layout is untouched —
this module moves state between groups.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

__all__ = [
    "Layout",
    "LayoutConstraints",
    "LayoutError",
    "ReshardError",
    "plan_layout",
    "feasible_layouts",
    "partition",
    "shard_interval",
    "interval_subtract",
    "interval_intersect",
    "plan_fetches",
    "LayoutState",
    "LayoutController",
    "RESHARD_STEP_KEY",
]


class LayoutError(RuntimeError):
    """No feasible layout exists for the given world + constraints."""


class ReshardError(RuntimeError):
    """A reshard transfer failed or left coverage gaps; the switch must
    roll back to the old layout."""


class Layout(NamedTuple):
    """One (dp, shard, pp) placement of ``world = dp*shard*pp`` replica
    groups, stamped with the monotone epoch it was planned under."""

    dp: int
    shard: int
    pp: int
    epoch: int

    @property
    def world(self) -> int:
        return self.dp * self.shard * self.pp

    @property
    def nshards(self) -> int:
        """Combined data-path shard count (``shard * pp``: pp stages own
        layer-major contiguous intervals of the flat element space)."""
        return self.shard * self.pp

    def coords(self, rank: int) -> "Tuple[int, int, int]":
        """``rank -> (dp_rank, shard_rank, pp_rank)``; rank is the
        group's index in the quorum's replica-id-sorted participant
        list (dp-major, then shard, then pp)."""
        if not (0 <= rank < self.world):
            raise ValueError(f"rank {rank} outside world {self.world}")
        dp_rank, rem = divmod(rank, self.shard * self.pp)
        shard_rank, pp_rank = divmod(rem, self.pp)
        return dp_rank, shard_rank, pp_rank

    def shard_index(self, rank: int) -> int:
        """Combined data-path shard index of ``rank`` in [0, nshards)."""
        _, shard_rank, pp_rank = self.coords(rank)
        return shard_rank * self.pp + pp_rank

    def key(self) -> "Tuple[int, int, int]":
        """Layout identity without the epoch stamp."""
        return (self.dp, self.shard, self.pp)


@dataclass(frozen=True)
class LayoutConstraints:
    """Declared feasibility constraints for the planner.

    Args:
        min_dp: minimum data-parallel degree (the effective-batch floor;
            a layout with fewer replicas than this is infeasible).
        layers: model layer count — ``pp`` must divide it.
        global_batch_size: if > 0, ``dp`` may not exceed it (a replica
            with an empty batch slice contributes nothing).
        param_bytes: total model state bytes (the sharded surface).
        shard_memory_bytes: per-group memory ceiling; if > 0 a layout is
            feasible only when ``ceil(param_bytes / nshards) <= ceiling``
            — the knob that FORCES shard growth on a shrink.
        max_pp: maximum pipeline depth to consider (1 = pp disabled).
    """

    min_dp: int = 1
    layers: int = 1
    global_batch_size: int = 0
    param_bytes: int = 0
    shard_memory_bytes: int = 0
    max_pp: int = 1

    def __post_init__(self) -> None:
        if self.min_dp < 1:
            raise ValueError(f"min_dp must be >= 1, got {self.min_dp}")
        if self.layers < 1:
            raise ValueError(f"layers must be >= 1, got {self.layers}")
        if self.max_pp < 1:
            raise ValueError(f"max_pp must be >= 1, got {self.max_pp}")


def _divisors(n: int) -> "List[int]":
    return [d for d in range(1, n + 1) if n % d == 0]


def feasible_layouts(
    world: int, constraints: LayoutConstraints
) -> "List[Tuple[int, int, int]]":
    """All (dp, shard, pp) triples with ``dp*shard*pp == world`` that
    satisfy the constraints, unordered."""
    if world < 1:
        return []
    out: "List[Tuple[int, int, int]]" = []
    for dp in _divisors(world):
        if dp < constraints.min_dp:
            continue
        if 0 < constraints.global_batch_size < dp:
            continue
        inner = world // dp
        for pp in _divisors(inner):
            if pp > constraints.max_pp or constraints.layers % pp != 0:
                continue
            shard = inner // pp
            nshards = shard * pp
            if constraints.shard_memory_bytes > 0 and constraints.param_bytes > 0:
                per = -(-constraints.param_bytes // nshards)  # ceil div
                if per > constraints.shard_memory_bytes:
                    continue
            out.append((dp, shard, pp))
    return out


def plan_layout(
    world: int,
    constraints: LayoutConstraints,
    prev: "Optional[Layout]" = None,
    epoch: int = 0,
) -> Layout:
    """Pick the best feasible layout for ``world`` groups, deterministically.

    Total ordering (so every replica picks the same plan from the same
    quorum): maximize ``dp`` (throughput), then minimize ``pp`` (bubble),
    then minimize shard-count movement vs ``prev`` (reshard bytes), then
    the smallest shard count.  Raises :class:`LayoutError` when nothing
    is feasible (e.g. the memory ceiling cannot be met at this world) —
    the caller keeps the old layout and degrades.
    """
    options = feasible_layouts(world, constraints)
    if not options:
        raise LayoutError(
            f"no feasible (dp, shard, pp) layout for world={world} under "
            f"{constraints}"
        )
    prev_nshards = prev.nshards if prev is not None else 1

    def score(opt: "Tuple[int, int, int]") -> "Tuple[int, int, int, int]":
        dp, shard, pp = opt
        return (-dp, pp, abs(shard * pp - prev_nshards), shard * pp)

    best = min(options, key=score)
    return Layout(dp=best[0], shard=best[1], pp=best[2], epoch=epoch)


# ---------------------------------------------------------------------------
# leaves: torch tensors or numpy arrays, handled alike
# ---------------------------------------------------------------------------


def _flat(x: Any) -> Any:
    """A flat view of a held leaf (a tensor stays on its device)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    return np.asarray(x).reshape(-1)


def _numel(x: Any) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.asarray(x).size)


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _copy(x: Any) -> Any:
    """An owned copy of a leaf, on the leaf's own device."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x)


def _empty_like_flat(x: Any, n: int) -> Any:
    """An uninitialised flat buffer of ``n`` elements of ``x``'s type, on
    ``x``'s device."""
    if isinstance(x, torch.Tensor):
        return torch.empty(n, dtype=x.dtype, device=x.device)
    return np.empty(n, dtype=np.asarray(x).dtype)


def _put(buf: Any, lo: int, hi: int, piece: Any) -> None:
    """``buf[lo:hi] = piece`` bit for bit; a host piece goes to the card
    when ``buf`` lives there."""
    if isinstance(buf, torch.Tensor):
        if not isinstance(piece, torch.Tensor):
            piece = torch.from_numpy(np.ascontiguousarray(piece))
        buf[lo:hi].copy_(piece.reshape(-1))
    else:
        buf[lo:hi] = np.asarray(piece).reshape(-1)


# ---------------------------------------------------------------------------
# interval math (the slice-diff engine; all [start, end) half-open)
# ---------------------------------------------------------------------------

Interval = Tuple[int, int]


def partition(n: int, k: int) -> "List[Interval]":
    """Split [0, n) into k contiguous intervals, first ``n % k`` one
    element longer — the same math as ``global_batch_slice`` so every
    element is owned under any k."""
    per, rem = divmod(n, k)
    out: "List[Interval]" = []
    start = 0
    for i in range(k):
        end = start + per + (1 if i < rem else 0)
        out.append((start, end))
        start = end
    return out


def shard_interval(n: int, shard_rank: int, nshards: int) -> Interval:
    """This shard's contiguous [start, end) of an ``n``-element leaf."""
    return partition(n, nshards)[shard_rank]


def interval_intersect(a: Interval, b: Interval) -> "Optional[Interval]":
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def interval_subtract(a: Interval, holes: "List[Interval]") -> "List[Interval]":
    """``a`` minus the union of ``holes`` as a sorted interval list."""
    out: "List[Interval]" = []
    cursor = a[0]
    for h in sorted(holes):
        cut = interval_intersect(a, h)
        if cut is None:
            continue
        if cut[0] > cursor:
            out.append((cursor, cut[0]))
        cursor = max(cursor, cut[1])
    if cursor < a[1]:
        out.append((cursor, a[1]))
    return out


def plan_fetches(
    need: Interval,
    have: "List[Interval]",
    owners: "List[Tuple[int, Interval]]",
) -> "Dict[int, List[Interval]]":
    """The slice diff: which intervals of ``need`` must be fetched from
    which owner.

    ``have`` is data already held locally (skipped); ``owners`` is an
    ORDERED list of (owner_rank, owned_interval) — when several owners
    cover the same missing piece the first in the list serves it, so
    both sides compute the identical assignment by using the same
    ordering.  Returns {owner_rank: [intervals]}, covering exactly
    ``need`` minus ``have`` (a remainder means no owner covers a piece —
    the caller must treat that as a failed reshard).
    """
    missing = interval_subtract(need, list(have))
    out: "Dict[int, List[Interval]]" = {}
    for owner_rank, owned in owners:
        still: "List[Interval]" = []
        for piece in missing:
            got = interval_intersect(piece, owned)
            if got is None:
                still.append(piece)
                continue
            out.setdefault(owner_rank, []).append(got)
            still.extend(interval_subtract(piece, [got]))
        missing = sorted(still)
        if not missing:
            break
    if missing:
        raise ReshardError(
            f"no owner covers interval(s) {missing} of {need} — "
            f"cannot complete the reshard"
        )
    return out


# ---------------------------------------------------------------------------
# epoch state machine
# ---------------------------------------------------------------------------


class LayoutState:
    """Monotone layout-epoch bookkeeping for one replica group.

    ``active`` is the layout this group runs; ``staged`` a fully
    transferred candidate awaiting the fleet-wide commit round.
    Committing enforces monotonicity (a commit at an epoch <= the active
    one, or at a burned epoch, raises — the runtime mirror of the
    tft-verify ``resize`` invariants)."""

    def __init__(self) -> None:
        self.active: "Optional[Layout]" = None
        self.staged: "Optional[Layout]" = None
        self.max_seen_epoch = 0
        self._burned: "set[int]" = set()

    @property
    def active_epoch(self) -> int:
        return self.active.epoch if self.active is not None else 0

    def observe_epoch(self, epoch: int) -> None:
        self.max_seen_epoch = max(self.max_seen_epoch, epoch)

    def next_epoch(self) -> int:
        """The epoch a fresh plan must use: past everything seen on the
        wire, everything burned, and the active epoch."""
        worst = max(
            [self.max_seen_epoch, self.active_epoch]
            + ([max(self._burned)] if self._burned else [])
        )
        return worst + 1

    def stage(self, layout: Layout) -> None:
        if layout.epoch <= self.active_epoch or layout.epoch in self._burned:
            raise LayoutError(
                f"cannot stage epoch {layout.epoch} (active "
                f"{self.active_epoch}, burned {sorted(self._burned)})"
            )
        self.staged = layout
        self.observe_epoch(layout.epoch)

    def commit(self, epoch: int) -> Layout:
        if self.staged is None or self.staged.epoch != epoch:
            raise LayoutError(f"no staged layout at epoch {epoch}")
        if epoch <= self.active_epoch:
            raise LayoutError(
                f"layout epoch must advance: active {self.active_epoch}, "
                f"commit {epoch}"
            )
        if epoch in self._burned:
            raise LayoutError(f"epoch {epoch} was rolled back and is burned")
        self.active, self.staged = self.staged, None
        return self.active

    def rollback(self, epoch: int) -> None:
        """Discard the staged layout and burn its epoch forever."""
        self._burned.add(epoch)
        if self.staged is not None and self.staged.epoch == epoch:
            self.staged = None

    def is_burned(self, epoch: int) -> bool:
        return epoch in self._burned


# ---------------------------------------------------------------------------
# the controller: plan at quorum, stage transfers, commit or roll back
# ---------------------------------------------------------------------------

#: Reshard payloads stage on the group's checkpoint transport under a
#: NEGATIVE step key derived from the epoch, so they can never collide
#: with heal staging (real steps are >= 0) and survive the per-step
#: ``disallow_checkpoint`` retirement of heal slots.
def RESHARD_STEP_KEY(epoch: int) -> int:
    return -(epoch + 1)


@dataclass
class _ShardedState:
    """One registered layout-sharded state surface."""

    sizes: "Dict[str, int]"  # leaf name -> full flat element count
    get_fn: "Callable[[], Dict[str, Any]]"
    set_fn: "Callable[[Dict[str, Any]], None]"


@dataclass
class _Staged:
    layout: Layout
    shard_index: int
    # key -> leaf -> flat buffer covering the NEW owned interval, on the
    # held leaf's device
    data: "Dict[str, Dict[str, Any]]"
    starts: "Dict[str, Dict[str, int]]"
    planned_world: int
    fetched_bytes: int = 0
    # bytes of the slices this group staged for the others to fetch
    staged_bytes: int = 0


class LayoutController:
    """Drives online parallelism switching for one Manager.

    Attach with :meth:`torchft_tpu_torch.manager.Manager.attach_layout`; the
    Manager calls :meth:`wire_epoch` / :meth:`wire_data` when joining a
    quorum, :meth:`maybe_commit` + :meth:`maybe_stage` on its
    async-quorum thread, and :meth:`on_step_commit` from the
    ``should_commit`` barrier (a failed step discards the stage, so only
    barrier-committed stages reach the fleet-wide commit round).
    """

    def __init__(self, constraints: LayoutConstraints) -> None:
        self.constraints = constraints
        self.state = LayoutState()
        self._manager: "Optional[Any]" = None
        self._sharded: "Dict[str, _ShardedState]" = {}
        # this group's current data-path shard index / count (what the
        # wire manifest advertises as owned intervals)
        self._shard_index = 0
        self._nshards = 1
        self._staged: "Optional[_Staged]" = None
        self._step_committed = False
        self._transport_warned = False
        self._listeners: "List[Callable[[Layout, Dict[str, Any]], None]]" = []
        self.last_switch: "Dict[str, Any]" = {}

    # -- registration ------------------------------------------------------

    def bind(self, manager: Any) -> None:
        """Called by ``Manager.attach_layout``: keeps the manager handle
        for transport-slot retirement, and registers the heal surface —
        while the state is UNSHARDED (nshards == 1) the owned data rides
        ordinary heal transfers, so a mid-run joiner in a fleet that has
        never switched receives real parameters instead of its init
        values (once sharded, epochs > 0 make a joiner's report stale
        and the reshard path fetches its shard instead)."""
        self._manager = manager
        manager.register_state_dict_fn(
            "__layout_sharded__", self._load_heal_state, self._heal_state
        )

    def _heal_state(self) -> "Dict[str, Any]":
        active = self.state.active
        out: "Dict[str, Any]" = {
            "layout": list(active.key()) + [active.epoch] if active else None,
            "shard_index": self._shard_index,
            "nshards": self._nshards,
            "data": None,
        }
        if self._nshards == 1 and self._sharded:
            out["data"] = {
                key: {
                    leaf: arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
                    for leaf, arr in spec.get_fn().items()
                }
                for key, spec in self._sharded.items()
            }
        return out

    def _load_heal_state(self, sd: "Dict[str, Any]") -> None:
        if not isinstance(sd, dict):
            return
        lay = sd.get("layout")
        if lay:
            self.state.observe_epoch(int(lay[3]))
        data = sd.get("data")
        if data is None or int(sd.get("nshards", 1)) != 1:
            # source holds a shard, not the full state: its slice cannot
            # heal us — the next switch's reshard path will (our stale
            # epoch report triggers it)
            return
        for key, spec in self._sharded.items():
            leaves = data.get(key)
            if leaves is None:
                continue
            sizes_ok = all(
                leaf in leaves and _numel(leaves[leaf]) == size
                for leaf, size in spec.sizes.items()
            )
            if not sizes_ok:
                logger.warning(
                    "heal payload for sharded state %r has mismatched "
                    "sizes; skipping (reshard will repair)", key
                )
                continue
            spec.set_fn({leaf: _copy(leaves[leaf]) for leaf in spec.sizes})
        if lay:
            dp, shard, pp, epoch = (int(x) for x in lay)
            if epoch >= self.state.active_epoch:
                self.state.active = Layout(dp, shard, pp, epoch)
                self._shard_index, self._nshards = 0, 1

    def _retire_slot(self, epoch: int) -> None:
        transport = getattr(self._manager, "_checkpoint_transport", None)
        if transport is not None and hasattr(transport, "retire_checkpoint"):
            try:
                transport.retire_checkpoint(RESHARD_STEP_KEY(epoch))
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                logger.debug("reshard slot retirement failed", exc_info=True)

    def register_sharded_state(
        self,
        key: str,
        sizes: "Dict[str, int]",
        get_fn: "Callable[[], Dict[str, Any]]",
        set_fn: "Callable[[Dict[str, Any]], None]",
    ) -> None:
        """Register a layout-sharded state surface: ``sizes`` maps leaf
        names to their FULL flat element counts; ``get_fn`` returns the
        currently owned flat slices (full leaves while unsharded);
        ``set_fn`` installs the re-owned slices after a commit."""
        self._sharded[key] = _ShardedState(dict(sizes), get_fn, set_fn)

    def update_sharded(
        self,
        key: str,
        fn: "Callable[[str, Any, int], None]",
    ) -> None:
        """Apply an in-place update to the owned slices of ``key`` —
        ``fn(leaf_name, flat_array, global_start)`` mutates the array (a
        flat view of a held tensor, or of the staged buffer, on its
        device).

        This is the REQUIRED mutation path while a switch may be in
        flight: a staged reshard buffer is a copy taken at the plan
        round, so the controller double-writes every update into it
        (classic migration double-write) — updates applied directly to
        the ``get_fn`` arrays between stage and commit would be lost
        when the staged buffer is installed.  Call between steps (after
        ``should_commit``), not concurrently with ``start_quorum``."""
        spec = self._sharded[key]
        held = spec.get_fn()
        for leaf, size in spec.sizes.items():
            start, _end = shard_interval(size, self._shard_index, self._nshards)
            fn(leaf, _flat(held[leaf]), start)
        if self._staged is not None:
            data = self._staged.data.get(key, {})
            starts = self._staged.starts.get(key, {})
            for leaf, arr in data.items():
                fn(leaf, arr, starts[leaf])

    def add_listener(
        self, fn: "Callable[[Layout, Dict[str, Any]], None]"
    ) -> None:
        """``fn(layout, info)`` runs after every commit (info carries
        ``store_address``, ``rank``, ``epoch``, ``prev`` — enough for a
        ManagedDeviceMesh to re-form its row/column process groups)."""
        self._listeners.append(fn)

    # -- wire surface ------------------------------------------------------

    def wire_epoch(self) -> int:
        """The epoch this group reports at quorum: the staged epoch once
        its stage survived the should_commit barrier, else the active
        epoch — unanimity of reports is the fleet's commit signal."""
        if self._staged is not None and self._step_committed:
            return self._staged.layout.epoch
        return self.state.active_epoch

    def wire_data(self) -> str:
        """Opaque manifest carried in the quorum member ``data`` field:
        this group's current data-path shard coordinates, from which any
        peer derives its owned intervals."""
        return json.dumps(
            {"shard": self._shard_index, "nshards": self._nshards}
        )

    def active_layout(self) -> "Optional[Layout]":
        return self.state.active

    def shard_coords(self) -> "Tuple[int, int]":
        """(shard_index, nshards) of the data this group currently owns."""
        return self._shard_index, self._nshards

    def owned_interval(self, leaf_size: int) -> Interval:
        return shard_interval(leaf_size, self._shard_index, self._nshards)

    # -- the two-phase protocol -------------------------------------------

    def maybe_commit(self, quorum: Any) -> str:
        """Commit round: if our stage survived the barrier and EVERY
        participant reports the same staged epoch at the planned world,
        activate; on any disagreement discard the stage and burn the
        epoch.  Returns "committed" / "rolled_back" / ""."""
        staged = self._staged
        if staged is None:
            self.state.observe_epoch(getattr(quorum, "max_layout_epoch", 0))
            return ""
        epoch = staged.layout.epoch
        unanimous = (
            self._step_committed
            and quorum.min_layout_epoch == quorum.max_layout_epoch == epoch
            and quorum.replica_world_size == staged.planned_world
        )
        if not unanimous:
            self._rollback(
                epoch,
                reason=(
                    f"epochs [{quorum.min_layout_epoch}, "
                    f"{quorum.max_layout_epoch}] world "
                    f"{quorum.replica_world_size} (planned "
                    f"{staged.planned_world}, step_committed "
                    f"{self._step_committed})"
                ),
            )
            self.state.observe_epoch(getattr(quorum, "max_layout_epoch", 0))
            return "rolled_back"
        # activate: install the re-owned slices, flip the shard coords,
        # notify listeners — at this quorum round on every group at once
        prev = self.state.active
        layout = self.state.commit(epoch)
        for key, spec in self._sharded.items():
            spec.set_fn(staged.data.get(key, {}))
        self._shard_index = staged.shard_index
        self._nshards = layout.nshards
        self._staged = None
        self._step_committed = False
        self._retire_slot(epoch)
        info = {
            "epoch": epoch,
            "prev": prev,
            "rank": quorum.replica_rank,
            "store_address": quorum.store_address,
            "fetched_bytes": staged.fetched_bytes,
            "staged_bytes": staged.staged_bytes,
        }
        self.last_switch = {
            "result": "committed",
            "layout": layout.key(),
            **{k: v for k, v in info.items() if k != "prev"},
        }
        for fn in self._listeners:
            try:
                fn(layout, info)
            except Exception:  # noqa: BLE001 - listeners must not fail a step
                logger.exception("layout listener failed")
        return "committed"

    def abort_staged(self, reason: str) -> None:
        """Discard any staged switch (burning its epoch); no-op when
        nothing is staged.  The Manager calls this when either phase of
        the switch protocol raises — a half-processed commit round must
        not commit one round late on this group alone."""
        if self._staged is not None:
            self._rollback(self._staged.layout.epoch, reason)

    def _rollback(self, epoch: int, reason: str) -> None:
        self.state.rollback(epoch)
        self._staged = None
        self._step_committed = False
        self._retire_slot(epoch)
        self.last_switch = {"result": "rolled_back", "epoch": epoch,
                           "reason": reason}
        logger.warning("layout epoch %d rolled back: %s", epoch, reason)

    def maybe_stage(self, manager: Any, quorum: Any) -> bool:
        """Plan phase: when the live world no longer matches the active
        layout (or a participant reports a stale epoch — a fresh joiner
        needing its shard), plan the next layout and run the reshard
        transfers into a staged buffer.  Any failure burns the epoch
        locally; the commit round then rolls the fleet back.  Returns
        True when a stage was attempted."""
        world = quorum.replica_world_size
        participants = list(getattr(quorum, "participants", []) or [])
        if world < 1 or len(participants) != world:
            return False
        self.state.observe_epoch(getattr(quorum, "max_layout_epoch", 0))
        if self.state.active is None:
            # implicit seed layout: today's behavior — pure DP, one shard
            self.state.active = Layout(dp=world, shard=1, pp=1, epoch=0)
            self._shard_index, self._nshards = 0, 1
        # mixed epoch reports (in EITHER direction) mean some group's
        # sharded data is not at the fleet's current generation — a fresh
        # joiner needing its shard, or this group having rolled back a
        # commit the rest completed; both resolve through a fresh switch
        reported = {int(p.get("layout_epoch", 0)) for p in participants}
        mixed = reported != {self.state.active_epoch}
        # the seed (pure-DP) layout may itself violate the declared
        # constraints (e.g. the memory ceiling demands shard > 1): an
        # infeasible active layout triggers a switch even at stable world
        active_infeasible = (
            self.state.active.key()
            not in feasible_layouts(world, self.constraints)
        )
        if (
            world == self.state.active.world
            and not mixed
            and not active_infeasible
            and self._staged is None
        ):
            return False
        if self._staged is not None:
            # a stage is already in flight toward its commit round
            return False
        epoch = self.state.next_epoch()
        try:
            layout = plan_layout(
                world, self.constraints, prev=self.state.active, epoch=epoch
            )
        except LayoutError as e:
            logger.warning("layout planning infeasible at world=%d: %s", world, e)
            return False
        if (
            layout.nshards == 1
            and self.state.active.nshards == 1
            and not mixed
        ):
            # pure-DP fleets resize with zero data movement: the layout's
            # only live dimension is dp == world, so adopt in place
            # without spending an epoch or a commit round
            self.state.active = Layout(
                dp=world, shard=1, pp=1, epoch=self.state.active_epoch
            )
            return False
        if not getattr(manager._checkpoint_transport, "supports_reshard", False):
            # a transport without the slice-diff serving surface (e.g.
            # the collective PGTransport) cannot move shards between
            # arbitrary peers: stay on the old layout — pure-DP elastic
            # resizing above still applies — instead of burning an epoch
            # per round on stages that can never complete
            if not self._transport_warned:
                self._transport_warned = True
                logger.warning(
                    "checkpoint transport %s cannot serve reshard slice "
                    "fetches (no supports_reshard); online parallelism "
                    "switching stays disabled on this group",
                    type(manager._checkpoint_transport).__name__,
                )
            return False
        t0 = time.perf_counter()
        try:
            self._stage_and_fetch(manager, quorum, layout)
        except Exception as e:  # noqa: BLE001 - degrade, never wedge
            self._rollback(epoch, reason=f"stage failed: {e}")
            log_event(
                "layout",
                "reshard stage failed; rolling back to old layout",
                replica_id=getattr(manager, "_replica_id", ""),
                step=getattr(quorum, "max_step", 0),
                epoch=epoch,
                error=str(e),
            )
            return True
        dt = time.perf_counter() - t0
        assert self._staged is not None
        log_event(
            "layout",
            "reshard staged",
            replica_id=getattr(manager, "_replica_id", ""),
            step=getattr(quorum, "max_step", 0),
            epoch=epoch,
            layout=str(layout.key()),
            fetched_bytes=self._staged.fetched_bytes,
            stage_s=round(dt, 4),
        )
        return True

    def on_step_commit(self, committed: bool) -> None:
        """should_commit barrier outcome for the step that overlapped the
        stage: every local rank of the group observes the same vote, so
        either the whole group carries the staged epoch into the commit
        round or the whole group discards it (burning the epoch)."""
        if self._staged is None:
            return
        if committed:
            self._step_committed = True
        else:
            self._rollback(
                self._staged.layout.epoch, reason="overlapping step aborted"
            )

    # -- the data path -----------------------------------------------------

    @staticmethod
    def _owner_manifests(
        participants: "List[Dict[str, Any]]",
    ) -> "List[Tuple[int, Dict[str, int]]]":
        """(rank, {shard, nshards}) of every participant holding VALID
        sharded data — those reporting the fleet's max layout epoch."""
        max_epoch = max(int(p.get("layout_epoch", 0)) for p in participants)
        owners: "List[Tuple[int, Dict[str, int]]]" = []
        for rank, p in enumerate(participants):
            if int(p.get("layout_epoch", 0)) != max_epoch:
                continue
            try:
                manifest = json.loads(p.get("data") or "{}")
            except ValueError:
                manifest = {}
            owners.append(
                (rank, {"shard": int(manifest.get("shard", 0)),
                        "nshards": max(int(manifest.get("nshards", 1)), 1)})
            )
        return owners

    def _dst_plan(
        self,
        owners: "List[Tuple[int, Dict[str, int]]]",
        layout: Layout,
        n_participants: int,
        dst_rank: int,
    ) -> "Dict[Tuple[str, str], Dict[int, List[Interval]]]":
        """The slice diff for ONE destination: per (state key, leaf),
        which intervals it must fetch from which source rank.  Pure
        function of the quorum + the plan, so the destination and every
        source compute the identical assignment independently."""
        dst_index = layout.shard_index(dst_rank)
        owner_map = dict(owners)
        plan: "Dict[Tuple[str, str], Dict[int, List[Interval]]]" = {}
        # owner preference rotates with the destination so dp replicas of
        # one shard spread the serving load instead of all hammering rank 0
        ordered = sorted(
            owners, key=lambda o: ((o[0] - dst_rank) % max(n_participants, 1))
        )
        for key, spec in self._sharded.items():
            for leaf, size in spec.sizes.items():
                need = shard_interval(size, dst_index, layout.nshards)
                have: "List[Interval]" = []
                if dst_rank in owner_map:
                    m = owner_map[dst_rank]
                    have = [shard_interval(size, m["shard"], m["nshards"])]
                src_map = plan_fetches(
                    need,
                    have,
                    [
                        (r, shard_interval(size, m["shard"], m["nshards"]))
                        for r, m in ordered
                    ],
                )
                plan[(key, leaf)] = src_map
        return plan

    def _stage_and_fetch(self, manager: Any, quorum: Any, layout: Layout) -> None:
        """Stage outgoing slices on our checkpoint transport, then fetch
        our missing slices from their current owners."""
        participants = [dict(p) for p in quorum.participants]
        my_rank = quorum.replica_rank
        new_index = layout.shard_index(my_rank)
        epoch = layout.epoch
        # chaos site, once per stage attempt (and again before each
        # remote fetch below): a bootstrap shard-up moves no bytes, so
        # without this entry check it would be untargetable
        _faults.check(
            "mesh.reshard",
            replica=getattr(manager, "_replica_id", None),
            step=epoch,
        )
        owners = self._owner_manifests(participants)
        if not owners:
            raise ReshardError("no participant holds valid sharded state")
        owner_map = dict(owners)
        i_am_valid = my_rank in owner_map

        # stage: for every other destination, the slices the shared plan
        # routes through us; they poll-fetch via our checkpoint transport
        staged_bytes = 0
        if i_am_valid:
            staged_doc: "Dict[str, Any]" = {}
            my_manifest = owner_map[my_rank]
            held_cache = {k: s.get_fn() for k, s in self._sharded.items()}
            for dst_rank in range(len(participants)):
                if dst_rank == my_rank:
                    continue
                plan = self._dst_plan(owners, layout, len(participants), dst_rank)
                out: "Dict[str, Any]" = {}
                for (key, leaf), src_map in plan.items():
                    size = self._sharded[key].sizes[leaf]
                    my_start, _my_end = shard_interval(
                        size, my_manifest["shard"], my_manifest["nshards"]
                    )
                    arr = _flat(held_cache[key][leaf])
                    for (s, e) in src_map.get(my_rank, []):
                        out[f"{key}/{leaf}/{s}:{e}"] = arr[
                            s - my_start : e - my_start
                        ]
                        staged_bytes += _nbytes(out[f"{key}/{leaf}/{s}:{e}"])
                if out:
                    staged_doc[f"for:{dst_rank}"] = out
            if staged_doc:
                manager._checkpoint_transport.send_checkpoint(
                    dst_ranks=[],
                    step=RESHARD_STEP_KEY(epoch),
                    state_dict=staged_doc,
                    timeout=manager._timeout,
                )

        # fetch: assemble our new shard from local overlap + remote slices
        my_plan = self._dst_plan(owners, layout, len(participants), my_rank)
        src_ranks = sorted(
            {
                r
                for src_map in my_plan.values()
                for r, ivs in src_map.items()
                if ivs and r != my_rank
            }
        )
        remote: "Dict[int, Dict[str, Any]]" = {}
        fetched_bytes = 0
        for src_rank in src_ranks:
            _faults.check(
                "mesh.reshard",
                replica=getattr(manager, "_replica_id", None),
                step=epoch,
            )
            doc = self._fetch_part(
                manager,
                participants[src_rank].get("address", ""),
                epoch,
                my_rank,
                src_rank,
            )
            remote[src_rank] = doc
            fetched_bytes += sum(_nbytes(v) for v in doc.values())

        new_data: "Dict[str, Dict[str, Any]]" = {}
        new_starts: "Dict[str, Dict[str, int]]" = {}
        for key, spec in self._sharded.items():
            new_data[key] = {}
            new_starts[key] = {}
            held = spec.get_fn()
            for leaf, size in spec.sizes.items():
                start, end = shard_interval(size, new_index, layout.nshards)
                local = _flat(held[leaf])
                buf = _empty_like_flat(local, end - start)
                covered: "List[Interval]" = []
                if i_am_valid:
                    m = owner_map[my_rank]
                    old = shard_interval(size, m["shard"], m["nshards"])
                    keep = interval_intersect((start, end), old)
                    if keep is not None:
                        _put(
                            buf, keep[0] - start, keep[1] - start,
                            local[keep[0] - old[0] : keep[1] - old[0]],
                        )
                        covered.append(keep)
                for src_rank, ivs in my_plan[(key, leaf)].items():
                    if src_rank == my_rank:
                        continue
                    doc = remote.get(src_rank, {})
                    for (s, e) in ivs:
                        piece = doc.get(f"{key}/{leaf}/{s}:{e}")
                        if piece is None:
                            continue
                        _put(buf, s - start, e - start, piece)
                        covered.append((s, e))
                gaps = interval_subtract((start, end), covered)
                if gaps:
                    raise ReshardError(
                        f"coverage gaps {gaps} for {key}/{leaf} "
                        f"interval [{start}, {end})"
                    )
                new_data[key][leaf] = buf
                new_starts[key][leaf] = start

        self.state.stage(layout)
        self._staged = _Staged(
            layout=layout,
            shard_index=new_index,
            data=new_data,
            starts=new_starts,
            planned_world=len(participants),
            fetched_bytes=fetched_bytes,
            staged_bytes=staged_bytes,
        )
        self._step_committed = False
        _metrics.RESHARD_BYTES.labels(
            replica_id=manager._metric_replica_id
        ).inc(fetched_bytes)
        _flightrec.record(
            "mesh.reshard",
            epoch=epoch,
            layout=str(layout.key()),
            bytes=fetched_bytes,
            replica_id=getattr(manager, "_replica_id", ""),
        )

    def _fetch_part(
        self, manager: Any, addr: str, epoch: int, my_rank: int, src_rank: int
    ) -> "Dict[str, Any]":
        """Fetch the slices source ``src_rank`` staged for us, over its
        checkpoint transport (HTTP streaming + the 503-poll retry
        policy).  The source's transport address comes from its manager's
        ``checkpoint_metadata`` RPC — the same discovery heal uses."""
        from torchft_tpu_torch.coordination import ManagerClient

        client = ManagerClient(addr, connect_timeout=manager._connect_timeout)
        try:
            metadata = client._checkpoint_metadata(
                manager._group_rank, timeout=manager._timeout
            )
        finally:
            client.close()
        doc = manager._checkpoint_transport.recv_checkpoint(
            src_rank=src_rank,
            metadata=metadata,
            step=RESHARD_STEP_KEY(epoch),
            timeout=manager._timeout,
            resource=f"part_{my_rank}",
        )
        return doc or {}
