"""FT-aware device mesh composition: a replica group's inner mesh plus the
elastic FT replicate dimension.

PyTorch port of ``torchft_tpu/parallel/device_mesh.py``.  The inner mesh is
an :class:`~torchft_tpu_torch.parallel.axis.InnerMesh` — one c10d process
group per axis over the group's ranks (``parallel/axis.py`` says why it is
not torch's ``DeviceMesh``) — and the replicate dimension is virtual, as in
the JAX package: ``num_participants`` / ``replica_rank`` are live quorum
values used for loss scaling and data sharding, and the FT allreduce runs
between the groups' same-rank members (``Manager`` with ``group_rank`` =
this rank).

Inner axes ``dp``, ``fsdp``, ``tp``, ``cp``, ``pp`` and ``ep`` are
supported: ``dp`` and ``cp`` keep the weights whole on every rank (the
gradients are summed over them), ``fsdp`` and ``tp`` shard them
(``models/transformer.py`` ``param_specs``; HSDP is the FT dimension over
such groups), ``pp`` gives each rank its stage's layers and ``ep`` its
experts (while the batch rows split over it too).  With one Manager per
rank, rank r of every group holds the same coordinates on every axis, so
it averages its shard gradients with, and heals from, rank r of the other
groups.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from torchft_tpu_torch.parallel.axis import InnerMesh, MeshAxis
from torchft_tpu_torch.parallel.multihost import GroupWorld
from torchft_tpu_torch.utils.device import resolve_device

#: the inner axes the port builds: batch (dp), weight sharding (fsdp, tp),
#: sequence (cp), pipeline stages (pp) and experts (ep)
SUPPORTED_AXES = ("dp", "fsdp", "tp", "cp", "pp", "ep")


class ManagedDeviceMesh:
    """An inner mesh plus the elastic FT replicate dimension.

    With a :class:`~torchft_tpu_torch.parallel.layout.LayoutController`
    attached (:meth:`attach_layout`), the replicate dimension itself
    becomes a live ``dp x shard x pp`` grid: on every committed layout
    switch the mesh re-forms its cross-group process groups (the dp row
    this group averages gradients with, and the shard column it
    re-partitions parameters across) against the quorum store under a
    per-epoch prefix, and ``global_batch_slice`` partitions the batch over
    the ``dp`` dimension only.

    Args:
        manager: FT manager owning the replica dimension.
        mesh: the group's :class:`InnerMesh`.
        replicate_dim_name: name reported for the virtual FT dim.
    """

    def __init__(
        self, manager: Any, mesh: InnerMesh, replicate_dim_name: str = "dp_replicate"
    ) -> None:
        self._manager = manager
        self.mesh = mesh
        self.replicate_dim_name = replicate_dim_name
        self._layout_ctrl: "Optional[Any]" = None
        self._row_pg: "Optional[Any]" = None
        self._col_pg: "Optional[Any]" = None
        self._grid_rank: "Optional[int]" = None

    # -- online parallelism switching (parallel/layout.py) -----------------

    def attach_layout(
        self,
        controller: Any,
        row_pg: "Optional[Any]" = None,
        col_pg: "Optional[Any]" = None,
    ) -> Any:
        """Subscribe this mesh to layout commits.  ``row_pg`` (optional)
        is re-configured over the dp row (same shard+pp coordinates) on
        every committed switch; ``col_pg`` over the shard column (same
        dp+pp coordinates).  Returns the controller."""
        self._layout_ctrl = controller
        self._row_pg = row_pg
        self._col_pg = col_pg
        controller.add_listener(self._on_layout_commit)
        return controller

    def _on_layout_commit(self, layout: Any, info: "Dict[str, Any]") -> None:
        """Re-form the cross-group process groups for the new grid under a
        store prefix that embeds the layout epoch, so two generations never
        rendezvous with each other."""
        rank = info.get("rank")
        self._grid_rank = rank
        if rank is None:
            return
        dp_rank, shard_rank, pp_rank = layout.coords(rank)
        store = info.get("store_address", "")
        replica_id = self._manager.replica_id()
        if self._row_pg is not None and store:
            self._row_pg.configure(
                f"{store}/torchft/layout/{layout.epoch}/row/"
                f"{shard_rank}_{pp_rank}/{dp_rank}",
                replica_id,
                dp_rank,
                layout.dp,
            )
        if self._col_pg is not None and store:
            self._col_pg.configure(
                f"{store}/torchft/layout/{layout.epoch}/col/"
                f"{dp_rank}_{pp_rank}/{shard_rank}",
                replica_id,
                shard_rank,
                layout.shard,
            )

    def layout(self) -> "Optional[Any]":
        """The active (dp, shard, pp) layout, or None when no controller
        is attached / nothing committed yet."""
        if self._layout_ctrl is None:
            return None
        return self._layout_ctrl.active_layout()

    def row_pg(self) -> "Optional[Any]":
        return self._row_pg

    def col_pg(self) -> "Optional[Any]":
        return self._col_pg

    # -- virtual replicate dim (live quorum values) ------------------------

    def num_participants(self) -> int:
        return self._manager.num_participants()

    def replica_rank(self) -> "Optional[int]":
        return self._manager.participating_rank()

    def is_participating(self) -> bool:
        return self._manager.is_participating()

    # -- composed topology -------------------------------------------------

    @property
    def axis_names(self) -> "Tuple[str, ...]":
        return (self.replicate_dim_name,) + tuple(self.mesh.axis_names)

    def shape(self) -> "Dict[str, int]":
        """Axis sizes; the replicate dim reports the live participant count
        (>=1 during 0-participant init)."""
        sizes = {self.replicate_dim_name: max(self.num_participants(), 1)}
        sizes.update(self.mesh.shape)
        return sizes

    def global_batch_slice(self, global_batch_size: int) -> "Tuple[int, int]":
        """This replica's contiguous [start, end) share of the global batch,
        given the live quorum.

        Returns the empty slice (0, 0) while not participating (healing /
        no quorum yet).  Over the participating ranks the slices tile
        [0, global_batch_size) exactly under any participant count.  With a
        committed layout whose grid matches the live participant count,
        the batch partitions over the ``dp`` dimension only and shard/pp
        peers of one dp replica receive the same slice."""
        rank = self.replica_rank()
        if rank is None or not self.is_participating():
            return 0, 0
        n = max(self.num_participants(), 1)
        layout = self.layout()
        if layout is not None and layout.world == n and layout.dp != n:
            # mid-switch (membership changed, commit pending) the flat
            # partition below keeps the tiling exact
            dp_rank, _, _ = layout.coords(rank)
            rank, n = dp_rank, layout.dp
        per, rem = divmod(global_batch_size, n)
        start = rank * per + min(rank, rem)
        end = start + per + (1 if rank < rem else 0)
        return start, end

    def __repr__(self) -> str:
        return (
            f"ManagedDeviceMesh({self.replicate_dim_name}="
            f"{max(self.num_participants(), 1)} x inner {self.mesh!r})"
        )


def ft_init_device_mesh(
    manager: Any,
    mesh_shape: "Dict[str, int]",
    groups: "Optional[GroupWorld]" = None,
    device: Any = "cuda",
    replicate_dim_name: str = "dp_replicate",
) -> ManagedDeviceMesh:
    """Build the inner mesh over this replica group's ranks and wrap it
    with the FT dim.

    ``mesh_shape`` maps inner axis names to sizes (``{"fsdp": 2, "tp":
    2}``); their
    product must equal the group's rank count (``groups.size``; one rank
    with no ``groups``).  Ranks lie row-major over the axes; every rank of
    the group calls this, and each builds one process group per axis of
    size > 1 with the ranks that differ from it only along that axis.
    ``device`` is where this rank computes."""
    dev = resolve_device(device)
    world = groups if groups is not None else GroupWorld(None, 0, 1)
    shape = tuple(int(n) for n in mesh_shape.values())
    total = int(np.prod(shape, dtype=np.int64))
    if total != world.size:
        raise ValueError(
            f"mesh_shape {mesh_shape} needs {total} ranks, the group has {world.size}"
        )
    for name, n in mesh_shape.items():
        if n > 1 and name not in SUPPORTED_AXES:
            raise ValueError(
                f"unknown inner axis {name!r} (size {n}); expected one of {SUPPORTED_AXES}"
            )
    coords = np.unravel_index(world.rank, shape) if shape else ()
    axes = []
    for i, (name, n) in enumerate(mesh_shape.items()):
        if n == 1:
            axes.append(MeshAxis(name, None, 0, 1))
            continue
        line = []
        for j in range(n):
            c = list(coords)
            c[i] = j
            line.append(int(np.ravel_multi_index(c, shape)))
        axes.append(MeshAxis(name, world.new_group(name, line), int(coords[i]), n))
    return ManagedDeviceMesh(manager, InnerMesh(axes, dev), replicate_dim_name)


__all__ = ["ManagedDeviceMesh", "SUPPORTED_AXES", "ft_init_device_mesh"]
