"""LocalSGD and (Streaming) DiLoCo: communication-reducing semi-sync DP.

PyTorch port of ``torchft_tpu/local_sgd.py`` (reference:
torchft/local_sgd.py:46-797).  Model parameters are a flat
``{name: tensor}`` dict read and written through ``get_params`` /
``set_params`` callables (``set_params`` typically copies into a module's
parameters under ``torch.no_grad``); fragments are key subsets; backup
("global") parameters are CPU tensors — the CPU-backup analog of reference
:237-254.  The outer optimizer is :class:`OuterSGD`, a small SGD with
momentum and Nesterov over the host backups whose state is a dict of
tensors (so ``PGTransport`` heals it); it replays ``optax.sgd`` bit for bit.

Semantics parity:
- LocalSGD (:46-173): every ``sync_every`` inner steps, average parameters
  across the quorum and commit.
- DiLoCo / Streaming DiLoCo (:176-797): the model is split into fragments,
  each with its own outer optimizer and host backup.  Per fragment cycle of
  ``sync_every // n_fragments`` inner steps: at ``cycle - fragment_sync_delay``
  start quorum + kick off an async allreduce of the fragment's pseudogradients
  (backup - local, optionally quantized); at ``cycle`` wait, restore backup
  params, vote commit, and on success outer-step + merge local/global by
  ``fragment_update_alpha``.  Fragment order is driven by
  ``manager.current_step() % n_fragments`` so all replicas reduce the same
  fragment — avoiding the cross-replica deadlock described in reference
  :746-792.  Requires a synchronous quorum (reference :618-643).

Both listen for committed layout switches when the Manager has a
``LayoutController`` attached (``parallel/layout.py``).
"""

from __future__ import annotations

import logging
import time
from types import TracebackType
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import torch

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.work import Work
from torchft_tpu_torch.utils import faults as _faults
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]
GetParams = Callable[[], Params]
SetParams = Callable[[Params], None]


def _to_host(params: Params) -> Params:
    """A CPU copy of every tensor (never an alias of a live parameter)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


class OuterSGD:
    """SGD with optional momentum and Nesterov over host tensors: the port's
    ``optax.sgd(lr, momentum, nesterov)``.

    It computes in f32 and in optax's order, one rounded operation at a
    time (no fused multiply-add forms, which could round once where optax
    rounds twice), so it replays the JAX package's golden fixtures bit for
    bit::

        t = g + m * t                      # optax.trace
        u = g + m * t  (Nesterov)  else  u = t
        u = u * (-lr)                      # optax.scale_by_learning_rate
        p = p + u                          # optax.apply_updates

    The state is ``{"trace": {name: tensor}}`` (empty without momentum).
    """

    def __init__(self, lr: float, momentum: float = 0.0, nesterov: bool = False) -> None:
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Params) -> "Dict[str, Params]":
        if not self.momentum:
            return {"trace": {}}
        return {"trace": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}}

    def update(
        self, grads: Params, state: "Dict[str, Params]"
    ) -> "Tuple[Params, Dict[str, Params]]":
        """``(updates, new_state)`` for f32 ``grads``."""
        updates: Params = {}
        trace: Params = {}
        for k, g in grads.items():
            if self.momentum:
                t = g + self.momentum * state["trace"][k]
                trace[k] = t
                u = g + self.momentum * t if self.nesterov else t
            else:
                u = g
            updates[k] = u * (-self.lr)
        return updates, {"trace": trace}


class LocalSGD:
    """Synchronize by averaging parameters every ``sync_every`` steps.

    Usage::

        with LocalSGD(manager, get_params, set_params, sync_every=32) as lsgd:
            for batch in data:
                inner_step(model, batch)             # local-only update
                lsgd.step()                          # counts; syncs on schedule
    """

    def __init__(
        self,
        manager: Manager,
        get_params: GetParams,
        set_params: SetParams,
        sync_every: int,
    ) -> None:
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self._manager = manager
        self._get_params = get_params
        self._set_params = set_params
        self._sync_every = sync_every
        self._local_step = 0
        manager.register_state_dict_fn(
            "LocalSGD", self._load_state_dict, lambda: _to_host(self._get_params())
        )
        # Online parallelism switching (parallel/layout.py): a committed
        # layout switch changes the averaging cohort mid-cycle, so restart
        # the inner cycle — the first post-switch sync then bounds local
        # divergence by at most sync_every fresh steps, not a straddled
        # pre-switch remainder.
        controller = manager.layout_controller()
        if controller is not None:
            controller.add_listener(self._on_layout_commit)

    def _on_layout_commit(self, layout: Any, info: "Dict[str, Any]") -> None:
        self._local_step = 0

    def _load_state_dict(self, state_dict: Params) -> None:
        self._set_params(state_dict)

    def __enter__(self) -> "LocalSGD":
        return self

    def __exit__(
        self,
        exc_type: "Optional[Type[BaseException]]",
        exc_value: "Optional[BaseException]",
        traceback: "Optional[TracebackType]",
    ) -> bool:
        return False

    def step(self) -> None:
        """Count one inner optimizer step; sync when the schedule fires."""
        self._local_step += 1
        if self._local_step >= self._sync_every:
            self.sync()

    def sync(self) -> None:
        """Average parameters across the quorum (reference :112-173)."""
        # chaos site: a raise here is a replica crash at the semi-sync
        # boundary — the worst moment, mid-divergence from the backup
        _faults.check(
            "local_sgd.sync",
            replica=self._manager.replica_id(),
            step=self._manager.current_step(),
        )
        with _flightrec.track(
            "local_sgd.sync",
            replica_id=self._manager.replica_id(),
            step=self._manager.current_step(),
        ) as flight:
            self._sync(flight)

    def _sync(self, flight: "_flightrec.FlightOp") -> None:
        self._local_step = 0
        self._manager.start_quorum()
        params = self._get_params()
        avg = self._manager.allreduce(params).wait(timeout=self._manager._timeout)
        committed = self._manager.should_commit()
        flight.update(committed=committed)
        if committed:
            # Guard the mutation: an async quorum thread may be snapshotting
            # the state dict for a healing peer (reference :112-124).
            self._manager.disallow_state_dict_read()
            try:
                self._set_params(avg)
            finally:
                self._manager.allow_state_dict_read()


class _Fragment:
    """One DiLoCo fragment: key subset + host backup + outer optimizer.

    Reference: _StreamingDiLoCoFragment (local_sgd.py:176-567).
    """

    def __init__(
        self,
        manager: Manager,
        fragment_id: int,
        keys: "List[str]",
        get_params: GetParams,
        set_params: SetParams,
        outer_optimizer: OuterSGD,
        should_quantize: bool,
        fragment_update_alpha: float,
        device_quantize: "Optional[bool]" = None,
    ) -> None:
        self._manager = manager
        self._fragment_id = fragment_id
        self._keys = keys
        self._get_params = get_params
        self._set_params = set_params
        self._outer = outer_optimizer
        self._should_quantize = should_quantize
        self._device_quantize = device_quantize
        self._alpha = fragment_update_alpha

        # host ("global") backup of this fragment's params
        self.original_parameters: Params = {}
        self._outer_state: Any = None
        self._allreduce_work: "List[Work]" = []
        self._local_parameters: "Optional[Params]" = None
        self.save_parameters()
        self._outer_state = self._outer.init(self.original_parameters)
        self.register_state_dict_fn()

    def _fragment_params(self) -> Params:
        params = self._get_params()
        return {k: params[k] for k in self._keys}

    def _write_fragment(self, frag: Params) -> None:
        params = dict(self._get_params())
        params.update(frag)
        self._set_params(params)

    def save_parameters(self) -> None:
        self.original_parameters = _to_host(self._fragment_params())

    def restore_parameters(self) -> None:
        self._write_fragment(
            {k: v.clone() for k, v in self.original_parameters.items()}
        )

    def register_state_dict_fn(self) -> None:
        # per-fragment healing slice (reference :256-287).  The live backup
        # and outer-state tensors are handed out as they are: a heal runs
        # inside start_quorum on the training thread (DiLoCo's quorum is
        # synchronous), and PGTransport receives into them in place.
        key = f"StreamingDiLoCoFragment_{self._fragment_id}"

        def load_fn(sd: "Dict[str, Any]") -> None:
            self.original_parameters = dict(sd["original_parameters"])
            self._outer_state = sd["outer_optimizer"]

        def save_fn() -> "Dict[str, Any]":
            return {
                "original_parameters": self.original_parameters,
                "outer_optimizer": self._outer_state,
            }

        self._manager.register_state_dict_fn(key, load_fn, save_fn)

    def _device_pseudograds(self) -> bool:
        """True when this fragment's pseudogradients should stay on the
        device for the quantized sync: explicit ``device_quantize`` wins,
        else auto — quantized leg and the fragment's parameters are CUDA
        tensors (kernel D quantizes on the card and only the int8 payload
        + row scales cross the device→host boundary, the copies riding the
        chunk queue of the wire pipeline)."""
        if not self._should_quantize:
            return False
        if self._device_quantize is not None:
            return self._device_quantize
        return all(v.is_cuda for v in self._fragment_params().values())

    def prepare_sync(self) -> None:
        """Pseudograds = backup - local; kick off the async allreduce
        (reference :402-421)."""
        local = self._fragment_params()
        if self._device_pseudograds():
            # backup - local ON the parameters' device (one host-to-device
            # copy of the backup), so the quantized collective takes the
            # device-quantize path: the f32 pseudograds never cross PCIe
            pseudograds = {
                k: g.to(local[k].device, torch.float32)
                - local[k].detach().to(torch.float32)
                for k, g in self.original_parameters.items()
            }
        else:
            local = _to_host(local)
            pseudograds = {
                k: g.to(torch.float32) - local[k].to(torch.float32)
                for k, g in self.original_parameters.items()
            }
        # payload-byte fallback for the wire gauge (PG backends without
        # wire accounting, e.g. test fakes)
        self._payload_bytes = sum(
            v.numel() * v.element_size() for v in pseudograds.values()
        )
        assert not self._allreduce_work
        self._allreduce_work.append(
            self._manager.allreduce(
                pseudograds,
                should_quantize=self._should_quantize,
                device_quantize=self._device_quantize,
            )
        )

    def discard_pending_work(self) -> None:
        """Drop any queued allreduce work (error-path cleanup so the next
        prepare_sync's not-already-pending assert holds)."""
        self._allreduce_work.clear()
        self._local_parameters = None

    def perform_sync(self) -> bool:
        """Wait for the allreduce, vote, and outer-step on success
        (reference :423-476)."""
        assert self._allreduce_work, "perform_sync before prepare_sync"
        t_sync = time.perf_counter()
        with _flightrec.track(
            "local_sgd.fragment_sync",
            fragment=self._fragment_id,
            replica_id=self._manager.replica_id(),
            step=self._manager.current_step(),
        ) as flight:
            result = self._perform_sync()
            flight.update(committed=result)
        _metrics.DILOCO_SYNC_SECONDS.labels(fragment=str(self._fragment_id)).set(
            time.perf_counter() - t_sync
        )
        return result

    def _perform_sync(self) -> bool:
        work = self._allreduce_work.pop()
        avg_pseudograds = work.wait(timeout=self._manager._timeout)
        # the accounting only: the Work itself holds the averaged result
        self.last_stats = {
            k: getattr(work, k, None)
            for k in ("wire_bytes", "unquantized_wire_bytes", "device_quantized",
                      "wire_dtype", "quant_stats")
        }
        wire_bytes = getattr(work, "wire_bytes", None)
        if wire_bytes is None:
            # explicit None check: wire_bytes == 0 is a real measurement
            # (world size 1 sends nothing) and must not fall back to the
            # full payload size
            wire_bytes = getattr(self, "_payload_bytes", 0)
        _metrics.DILOCO_WIRE_BYTES.labels(fragment=str(self._fragment_id)).set(
            wire_bytes
        )

        # save local then roll back to the global backup: a failed commit
        # must leave us on consistent (pre-divergence) state
        self._local_parameters = _to_host(self._fragment_params())
        self.restore_parameters()

        should_commit = self._manager.should_commit()
        if should_commit:
            grads = {
                k: v.detach().to("cpu", torch.float32)
                for k, v in avg_pseudograds.items()
            }
            updates, self._outer_state = self._outer.update(grads, self._outer_state)
            new_global = {
                k: (self.original_parameters[k].to(torch.float32) + u).to(
                    self.original_parameters[k].dtype
                )
                for k, u in updates.items()
            }
            self.original_parameters = new_global
            # merge: params = (1-alpha) * global + alpha * local
            a = self._alpha
            merged = {
                k: ((1.0 - a) * g.to(torch.float32)
                    + a * self._local_parameters[k].to(torch.float32)).to(g.dtype)
                for k, g in new_global.items()
            }
            self._write_fragment(merged)
        self._local_parameters = None
        return should_commit


class DiLoCo:
    """(Streaming) DiLoCo over fragment key subsets.

    Args:
        manager: must use a synchronous quorum (use_async_quorum=False).
        fragments: list of key lists partitioning the flat param dict; one
            entry behaves as classic DiLoCo, several as Streaming DiLoCo.
        outer_optimizer: :class:`OuterSGD` (or a list, one per fragment);
            the paper (and reference) default is SGD + Nesterov momentum.
        sync_every: inner steps per full round; must be divisible by the
            fragment count.
        fragment_sync_delay: inner steps between kicking off a fragment's
            allreduce and blocking on it ("tau" in Streaming DiLoCo).
        fragment_update_alpha: local/global mixing factor.
        device_quantize: quantized leg only — compute pseudogradients on
            the parameters' device and quantize with kernel D before the
            device→host copy.  ``None`` = auto (on when the fragment's
            parameters are CUDA tensors); ``False`` forces the host codec;
            ``True`` forces the device path (on CPU tensors: kernel D's
            plain twin, as the CPU tests run it).
    """

    def __init__(
        self,
        manager: Manager,
        fragments: "List[List[str]]",
        get_params: GetParams,
        set_params: SetParams,
        outer_optimizer: "OuterSGD | List[OuterSGD]",
        sync_every: int,
        should_quantize: bool = False,
        fragment_sync_delay: int = 0,
        fragment_update_alpha: float = 0.0,
        device_quantize: "Optional[bool]" = None,
    ) -> None:
        if manager._use_async_quorum:
            raise ValueError(
                "DiLoCo requires synchronous quorum: construct the Manager "
                "with use_async_quorum=False"
            )
        if not fragments or not all(fragments):
            raise ValueError("fragments must be non-empty key lists")
        if sync_every < len(fragments):
            raise ValueError("only 1 fragment can be synchronized at a time")
        if sync_every % len(fragments) != 0:
            raise ValueError("sync_every must be divisible by the number of fragments")
        self._cycle = sync_every // len(fragments)
        if fragment_sync_delay >= self._cycle:
            raise ValueError("fragment must be synced before it is reduced again")
        if not (0.0 <= fragment_update_alpha <= 1.0):
            raise ValueError("fragment_update_alpha must be within [0, 1]")

        if isinstance(outer_optimizer, list):
            if len(outer_optimizer) != len(fragments):
                raise ValueError("need one outer optimizer per fragment")
            outers = outer_optimizer
        else:
            outers = [outer_optimizer] * len(fragments)

        self._manager = manager
        self._local_step = 0
        self._fragment_sync_delay = fragment_sync_delay
        #: the last fragment sync: ``fragment``, ``committed`` and the
        #: collective's wire and codec accounting (``wire_bytes``,
        #: ``unquantized_wire_bytes``, ``device_quantized``, ``wire_dtype``,
        #: ``quant_stats``); None before the first
        self.last_sync: "Optional[Dict[str, Any]]" = None
        self._fragments = [
            _Fragment(
                manager,
                i,
                keys,
                get_params,
                set_params,
                outers[i],
                should_quantize,
                fragment_update_alpha,
                device_quantize=device_quantize,
            )
            for i, keys in enumerate(fragments)
        ]
        # Online parallelism switching: a committed switch must not be
        # straddled by fragment state — discard any in-flight fragment
        # allreduce (its cohort is gone) and re-snapshot the outer
        # backups so no pseudogradient ever spans a layout generation.
        # DiLoCo managers are sync-quorum, so the listener runs on the
        # training-loop thread — no race with inner steps.
        controller = manager.layout_controller()
        if controller is not None:
            controller.add_listener(self._on_layout_commit)

    def _on_layout_commit(self, layout: Any, info: "Dict[str, Any]") -> None:
        for frag in self._fragments:
            frag.discard_pending_work()
            frag.save_parameters()

    def __enter__(self) -> "DiLoCo":
        return self

    def __exit__(
        self,
        exc_type: "Optional[Type[BaseException]]",
        exc_value: "Optional[BaseException]",
        traceback: "Optional[TracebackType]",
    ) -> bool:
        return False

    def _current_fragment(self) -> int:
        # driven by the committed step so every replica reduces the same
        # fragment (reference :735-741)
        return self._manager.current_step() % len(self._fragments)

    def step(self) -> None:
        """Call after each inner optimizer step (the post-hook analog,
        reference :746-792)."""
        self._local_step += 1

        if self._local_step == self._cycle - self._fragment_sync_delay:
            # chaos site: replica crash at the fragment-sync boundary (the
            # DiLoCo analog of LocalSGD.sync's injection point)
            _faults.check(
                "local_sgd.sync",
                replica=self._manager.replica_id(),
                step=self._manager.current_step(),
            )
            self._manager.start_quorum()
            fragment = self._current_fragment()
            logger.info("preparing fragment=%d step=%d", fragment, self._local_step)
            self._fragments[fragment].prepare_sync()

        if self._local_step < self._cycle:
            return
        if self._local_step == self._cycle:
            fragment = self._current_fragment()
            logger.info(
                "syncing fragment=%d step=%d manager_step=%d",
                fragment,
                self._local_step,
                self._manager.current_step(),
            )
            # Reset before the fallible sync (like LocalSGD.sync): if
            # perform_sync raises (e.g. allreduce wait timeout), a caller
            # that catches per-step errors and keeps stepping must start a
            # fresh cycle, not hit the exceeded-cycle assert below forever.
            self._local_step = 0
            frag = self._fragments[fragment]
            try:
                committed = frag.perform_sync()
            except Exception:
                frag.discard_pending_work()
                raise
            self.last_sync = {
                "fragment": fragment, "committed": committed, **frag.last_stats,
            }
            return
        raise AssertionError(
            f"local_step {self._local_step} exceeded cycle {self._cycle}"
        )


__all__ = ["DiLoCo", "LocalSGD", "OuterSGD"]
