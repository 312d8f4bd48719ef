"""In-group mesh axes: the port's ``shard_map`` collectives.

The JAX package gets its in-group parallel axes from a ``jax.sharding.Mesh``
and ``shard_map``: inside the mapped body, ``jax.lax.axis_index``,
``axis_size``, ``ppermute``, ``all_to_all`` and ``psum`` talk to the other
devices of one axis.  PyTorch runs one program per rank (SPMD), so the port
gives each rank a :class:`MeshAxis` per axis — the axis's name, its
``torch.distributed`` c10d process group, this rank's index and the axis
size — and an :class:`InnerMesh` that holds them.

Why not ``torch.distributed.device_mesh.DeviceMesh``: the process groups
here are built directly from a store (``ProcessGroupGloo(PrefixStore(...),
rank, size, timeout)`` or ``ProcessGroupNCCL``), never as the process-global
default group: several replica groups' ranks run side by side as threads in
the CPU tests, and the fault-tolerance layer owns the cross-group process
group.  ``DeviceMesh.from_group`` accepts only groups registered with the
default world and rejects such a raw group (``TypeError: 'ProcessGroupGloo'
object is not iterable``), so the inner mesh is this small object instead.

Transport.  On NCCL a CUDA tensor goes to the group as it is.  On gloo — the
CPU tests, and several ranks sharing one card, which NCCL refuses — send,
recv and all-to-all take CPU tensors, so a CUDA tensor is copied through a
pinned host buffer and back.  That is a transport choice, not a kernel
fallback: the attention tiles still run on the card.  Each axis logs once
which path it takes.  Data-moving ops (:meth:`MeshAxis.shift`,
:meth:`MeshAxis.all_to_all`, :meth:`MeshAxis.all_gather`) move raw bytes, so
a bf16 tensor crosses as its 16-bit pattern; :meth:`MeshAxis.psum_` and
:meth:`MeshAxis.reduce_scatter` sum in f32 (f64 stays f64) and round back.
There is no fallback: a failed exchange raises.

Weight sharding (fsdp, tp) is written by hand over these ops, as the JAX
package's GSPMD places them: :func:`gather_shards` (all-gather forward,
reduce-scatter backward) gathers an fsdp-sharded weight, and
:func:`copy_to_axis` / :func:`reduce_from_axis` (identity one way, psum the
other) surround a tensor-parallel matmul pair.  Expert parallelism uses
:func:`reduce_scatter` and :func:`psum` (whose gradients are an all-gather
and a psum), and the pipeline :meth:`MeshAxis.hop` (``ppermute`` with the
non-cyclic permutation ``[(i, i + 1)]``) and :meth:`MeshAxis.broadcast`.

The differentiable ring shift and all-to-all go through dispatcher ops
(``torchft_tpu_torch::mesh_shift``, ``mesh_all_to_all``) that name their
axis by :attr:`MeshAxis.handle`, so that selective activation
checkpointing (the transformer's ``remat_policy="dots"``) can keep their
outputs: the recompute in the backward then issues no exchange, and no
rank replays a collective that the others do not.
"""

from __future__ import annotations

import collections
import itertools
import logging
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

#: the largest host buffer one psum_ bucket stages (bytes of f32)
_BUCKET_BYTES = 64 << 20
#: live axes by handle: the dispatcher ops below name their axis by an int
_AXES: "weakref.WeakValueDictionary[int, MeshAxis]" = weakref.WeakValueDictionary()
_handles = itertools.count(1)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    if flat.stride(0) != 1:  # a broadcast value: size-1 dims may keep stride 0
        flat = torch.empty_like(flat, memory_format=torch.contiguous_format).copy_(flat)
    return flat.view(torch.uint8)


def _buckets(tensors: "List[torch.Tensor]"):
    """Consecutive runs of ``tensors`` of at most :data:`_BUCKET_BYTES` of
    f32 each (a larger tensor makes a bucket of its own)."""
    bucket: "List[torch.Tensor]" = []
    size = 0
    for t in tensors:
        if bucket and size + t.numel() * 4 > _BUCKET_BYTES:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * 4
    if bucket:
        yield bucket


class MeshAxis:
    """One axis of the inner mesh: ``name``, its c10d ``group`` (None for
    an axis of size 1), this rank's ``rank`` on it and its ``size``.

    ``stats`` counts, per op (``shift``, ``hop``, ``broadcast``,
    ``all_to_all``, ``psum``, ``all_gather``, ``reduce_scatter``), the
    bytes this rank sent and the
    seconds the op held the caller; on the
    gloo path a CUDA tensor's staging copies are included (the queued
    compute that produced it is waited for before the clock starts)."""

    def __init__(self, name: str, group: Any, rank: int, size: int) -> None:
        if size > 1 and group is None:
            raise ValueError(f"axis {name!r} of size {size} needs a process group")
        self.name = name
        self.group = group
        self.rank = rank
        self.size = size
        self.backend = group.name() if group is not None else "none"
        self.stats: "collections.Counter[str]" = collections.Counter()
        self._logged = False
        self.handle = next(_handles)
        _AXES[self.handle] = self

    def __repr__(self) -> str:
        return f"MeshAxis({self.name!r}, rank {self.rank} of {self.size}, {self.backend})"

    # -- transport -------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        staged = t.device.type == "cuda" and self.backend != "nccl"
        if not self._logged:
            self._logged = True
            how = (
                "CUDA tensors staged through pinned host buffers" if staged
                else f"{t.device.type} tensors passed to the group as they are"
            )
            logger.info("mesh axis %s (rank %d of %d, %s): %s",
                        self.name, self.rank, self.size, self.backend, how)
        return staged

    def transport(self, device: "str | torch.device") -> str:
        """How this axis moves tensors of ``device``: ``"<backend>"`` or
        ``"<backend>, staged through pinned host memory"``."""
        dev = torch.device(device)
        if dev.type == "cuda" and self.backend != "nccl":
            return f"{self.backend}, staged through pinned host memory"
        return self.backend

    def _start(self, staged: bool) -> float:
        if staged:  # producers first: their time is compute, not exchange
            torch.cuda.current_stream().synchronize()
        return time.perf_counter()

    def _stop(self, op: str, t0: float, nbytes: int, staged: bool) -> None:
        if staged:
            torch.cuda.current_stream().synchronize()
        self.stats[f"{op}_bytes"] += nbytes
        self.stats[f"{op}_s"] += time.perf_counter() - t0

    @staticmethod
    def _empty_like(b: torch.Tensor, staged: bool) -> torch.Tensor:
        """A receive buffer for ``b``: pinned host memory when staged, else
        on ``b``'s device (the card's, on NCCL)."""
        if staged:
            return torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        return torch.empty_like(b)

    @staticmethod
    def _to_host(b: torch.Tensor) -> torch.Tensor:
        host = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        host.copy_(b, non_blocking=True)
        return host

    # -- ops -------------------------------------------------------------

    def shift(
        self, tensors: "Sequence[torch.Tensor]", offset: int = 1
    ) -> "List[torch.Tensor]":
        """``jax.lax.ppermute`` by ``offset``: each tensor goes to rank
        ``rank + offset`` and this rank gets rank ``rank - offset``'s, of
        the same shape and type.  Not differentiable (see :func:`shift`)."""
        if self.size == 1 or offset % self.size == 0:
            return list(tensors)
        staged = self._staged(tensors[0])
        t0 = self._start(staged)
        dst = (self.rank + offset) % self.size
        src = (self.rank - offset) % self.size
        sends = [_as_bytes(t) for t in tensors]
        if staged:
            sends = [self._to_host(b) for b in sends]
            torch.cuda.current_stream().synchronize()
        recvs = [self._empty_like(b, staged) for b in sends]
        works = []
        for tag, (snd, rcv) in enumerate(zip(sends, recvs)):
            # even ranks send first, odd ranks receive first: on NCCL, where
            # a send and a receive may queue on one stream, every hop then
            # finds its peer's matching call ahead of it
            if self.rank % 2 == 0:
                works.append(self.group.send([snd], dst, tag))
                works.append(self.group.recv([rcv], src, tag))
            else:
                works.append(self.group.recv([rcv], src, tag))
                works.append(self.group.send([snd], dst, tag))
        for w in works:
            w.wait()
        out = []
        for t, r in zip(tensors, recvs):
            if staged:
                r = r.to(t.device, non_blocking=True)
            out.append(r.view(t.dtype).reshape(t.shape))
        self._stop("shift", t0, sum(b.numel() for b in sends), staged)
        return out

    def hop(
        self, send: "Optional[Sequence[torch.Tensor]]",
        recv_like: "Optional[Sequence[torch.Tensor]]", offset: int = 1,
    ) -> "Optional[List[torch.Tensor]]":
        """One hop of ``jax.lax.ppermute`` with the non-cyclic permutation
        ``[(i, i + offset)]``: ``send`` (if given) goes to rank ``rank +
        offset``, and this rank receives (if ``recv_like`` is given) tensors
        of those shapes and types from rank ``rank - offset``, which it
        returns.  The caller knows which ranks send: a rank gives ``send``
        exactly when its peer gives ``recv_like``.  Receives are posted
        before sends, so on NCCL a line of hops resolves from its first
        rank.  Not differentiable (the pipeline orders its own backward
        hops)."""
        if not send and not recv_like:
            return None
        ref = (send or recv_like)[0]
        staged = self._staged(ref)
        t0 = self._start(staged)
        works, recvs, nbytes = [], None, 0
        if recv_like:
            src = self.rank - offset
            if not 0 <= src < self.size:
                raise ValueError(f"{self!r}: no rank {src} to receive from")
            recvs = [self._empty_like(_as_bytes(t), staged) for t in recv_like]
            works += [self.group.recv([r], src, tag) for tag, r in enumerate(recvs)]
        if send:
            dst = self.rank + offset
            if not 0 <= dst < self.size:
                raise ValueError(f"{self!r}: no rank {dst} to send to")
            sends = [_as_bytes(t) for t in send]
            if staged:
                sends = [self._to_host(b) for b in sends]
                torch.cuda.current_stream().synchronize()
            works += [self.group.send([b], dst, tag) for tag, b in enumerate(sends)]
            nbytes = sum(b.numel() for b in sends)
        for w in works:
            w.wait()
        out = None
        if recvs is not None:
            out = []
            for t, r in zip(recv_like, recvs):
                if staged:
                    r = r.to(t.device, non_blocking=True)
                out.append(r.view(t.dtype).reshape(t.shape))
        self._stop("hop", t0, nbytes, staged)
        return out

    def broadcast(
        self, tensors: "Sequence[torch.Tensor]", root: int
    ) -> "List[torch.Tensor]":
        """Rank ``root``'s ``tensors`` on every rank (each rank passes
        tensors of the same shapes and types), as raw bytes in one
        collective.  Not differentiable (the pipeline's
        ``broadcast_from_last`` gives it its gradient rule)."""
        tensors = list(tensors)
        if self.size == 1:
            return tensors
        staged = self._staged(tensors[0])
        t0 = self._start(staged)
        parts = [_as_bytes(t) for t in tensors]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        if staged:
            flat = self._to_host(flat)
            torch.cuda.current_stream().synchronize()
        self.group.broadcast(flat, root).wait()
        if staged:
            flat = flat.to(tensors[0].device, non_blocking=True)
        out, off = [], 0
        for t, p in zip(tensors, parts):
            out.append(flat[off:off + p.numel()].view(t.dtype).reshape(t.shape))
            off += p.numel()
        self._stop("broadcast", t0, flat.numel() if self.rank == root else 0, staged)
        return out

    def all_to_all_raw(
        self, x: torch.Tensor, split_dim: int, concat_dim: int
    ) -> torch.Tensor:
        """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)``:
        ``x`` splits into ``size`` equal parts along ``split_dim``, part
        ``i`` goes to rank ``i``, and the parts received are concatenated
        along ``concat_dim`` in rank order.  Not differentiable (see
        :func:`all_to_all`)."""
        if self.size == 1:
            return x
        if x.shape[split_dim] % self.size != 0:
            raise ValueError(
                f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not "
                f"split over {self.size} ranks"
            )
        staged = self._staged(x)
        t0 = self._start(staged)
        parts = torch.stack(x.chunk(self.size, dim=split_dim))
        send = _as_bytes(parts)
        if staged:
            send = self._to_host(send)
            torch.cuda.current_stream().synchronize()
        recv = self._empty_like(send, staged)
        self.group.alltoall_base(recv, send, [], []).wait()
        if staged:
            recv = recv.to(x.device, non_blocking=True)
        got = recv.view(x.dtype).reshape(parts.shape)
        out = torch.cat(got.unbind(0), dim=concat_dim)
        self._stop("all_to_all", t0, send.numel(), staged)
        return out

    def psum_(self, tensors: "Sequence[torch.Tensor]") -> None:
        """``jax.lax.psum`` in place: each floating-point tensor becomes its
        sum over the axis, the same bits on every rank.  Tensors are packed
        into buckets of at most 64 MiB and reduced in f32 (f64 in f64)."""
        if self.size == 1 or not tensors:
            return
        for t in tensors:
            if not t.is_floating_point():
                raise TypeError(f"psum_ takes floating-point tensors, got {t.dtype}")
        staged = self._staged(tensors[0])
        t0 = self._start(staged)
        nbytes = 0
        for dtype in (torch.float32, torch.float64):
            same = [t for t in tensors if (t.dtype == torch.float64) == (dtype == torch.float64)]
            for bucket in _buckets(same):
                nbytes += self._reduce_bucket(bucket, dtype, staged)
        self._stop("psum", t0, nbytes, staged)

    def _reduce_bucket(
        self, bucket: "List[torch.Tensor]", dtype: torch.dtype, staged: bool
    ) -> int:
        n = sum(t.numel() for t in bucket)
        if staged:
            flat = torch.empty(n, dtype=dtype, pin_memory=True)
        else:
            flat = torch.empty(n, dtype=dtype, device=bucket[0].device)
        off = 0
        for t in bucket:
            flat[off:off + t.numel()].copy_(t.reshape(-1), non_blocking=staged)
            off += t.numel()
        if staged:
            torch.cuda.current_stream().synchronize()
        self.group.allreduce([flat]).wait()
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape), non_blocking=staged)
            off += t.numel()
        return flat.numel() * flat.element_size()


    def all_gather(
        self, tensors: "Sequence[torch.Tensor]", dims: "Sequence[int]"
    ) -> "List[torch.Tensor]":
        """``jax.lax.all_gather(x, axis, tiled=True)`` of each tensor along
        its own ``dims[i]``: the ranks' blocks concatenated in rank order.
        Every tensor goes in one collective, as raw bytes.  Not
        differentiable (see :func:`gather_shards`)."""
        tensors, dims = list(tensors), list(dims)
        if self.size == 1 or not tensors:
            return tensors
        staged = self._staged(tensors[0])
        t0 = self._start(staged)
        parts = [_as_bytes(t) for t in tensors]
        send = torch.cat(parts) if len(parts) > 1 else parts[0]
        if staged:
            send = self._to_host(send)
            torch.cuda.current_stream().synchronize()
        recvs = [self._empty_like(send, staged) for _ in range(self.size)]
        self.group.allgather([recvs], [send]).wait()
        if staged:
            recvs = [r.to(tensors[0].device, non_blocking=True) for r in recvs]
        out = []
        off = 0
        for t, d, p in zip(tensors, dims, parts):
            blocks = [r[off:off + p.numel()].view(t.dtype).reshape(t.shape) for r in recvs]
            out.append(torch.cat(blocks, dim=d))
            off += p.numel()
        self._stop("all_gather", t0, (self.size - 1) * send.numel(), staged)
        return out

    def reduce_scatter(
        self, tensors: "Sequence[torch.Tensor]", dims: "Sequence[int]"
    ) -> "List[torch.Tensor]":
        """``jax.lax.psum_scatter(x, axis, scatter_dimension=d,
        tiled=True)`` of each tensor along its own ``dims[i]``: this rank
        gets block ``rank`` of the sum over the axis.  The blocks are
        summed in f32 (f64 stays f64) in rank order, so every rank's sum
        takes the same order, and rounded back to each tensor's type.
        Every tensor goes in one all-to-all.  Not differentiable (see
        :func:`gather_shards`)."""
        tensors, dims = list(tensors), list(dims)
        if self.size == 1 or not tensors:
            return tensors
        for t, d in zip(tensors, dims):
            if not t.is_floating_point():
                raise TypeError(f"reduce_scatter takes floating-point tensors, got {t.dtype}")
            if t.shape[d] % self.size:
                raise ValueError(
                    f"reduce_scatter: dim {d} of {tuple(t.shape)} does not "
                    f"split over {self.size} ranks")
        acc = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
        staged = self._staged(tensors[0])
        t0 = self._start(staged)
        # row j: every tensor's block j, flattened, in the accumulation type
        send = torch.cat([
            torch.stack([b.reshape(-1) for b in t.to(acc).chunk(self.size, dim=d)])
            for t, d in zip(tensors, dims)
        ], dim=1)
        if staged:
            send = self._to_host(send)
            torch.cuda.current_stream().synchronize()
        recv = self._empty_like(send, staged)
        self.group.alltoall_base(recv, send, [], []).wait()
        total = recv[0].clone()
        for i in range(1, self.size):
            total += recv[i]
        if staged:
            total = total.to(tensors[0].device, non_blocking=True)
        out = []
        off = 0
        for t, d in zip(tensors, dims):
            shape = list(t.shape)
            shape[d] //= self.size
            n = t.numel() // self.size
            out.append(total[off:off + n].reshape(shape).to(t.dtype))
            off += n
        self._stop("reduce_scatter", t0, (self.size - 1) * send[0].numel() * send.element_size(),
                   staged)
        return out


# ---------------------------------------------------------------------------
# differentiable forms (the transposes jax.lax gives ppermute and all_to_all)
# ---------------------------------------------------------------------------


@torch.library.custom_op(
    "torchft_tpu_torch::mesh_shift", mutates_args=(),
    schema="(Tensor[] xs, int axis, int offset) -> Tensor[]",
)
def _shift_op(xs: "List[torch.Tensor]", axis: int, offset: int) -> "List[torch.Tensor]":
    return _AXES[axis].shift(xs, offset)


@_shift_op.register_fake
def _(xs, axis, offset):
    return [torch.empty_like(x) for x in xs]


def _shift_setup(ctx, inputs, output) -> None:
    ctx.axis, ctx.offset = inputs[1], inputs[2]


def _shift_backward(ctx, grads):
    grads = [g.contiguous() for g in grads]
    return _shift_op(grads, ctx.axis, -ctx.offset), None, None


_shift_op.register_autograd(_shift_backward, setup_context=_shift_setup)


def shift(axis: MeshAxis, *tensors: torch.Tensor, offset: int = 1) -> "Tuple[torch.Tensor, ...]":
    """:meth:`MeshAxis.shift` under autograd (the gradient shifts back),
    as the dispatcher op ``torchft_tpu_torch::mesh_shift``."""
    if axis.size == 1 or offset % axis.size == 0:
        return tensors
    return tuple(_shift_op([t.contiguous() for t in tensors], axis.handle, offset))


@torch.library.custom_op(
    "torchft_tpu_torch::mesh_all_to_all", mutates_args=(),
    schema="(Tensor x, int axis, int split_dim, int concat_dim) -> Tensor",
)
def _all_to_all_op(x: torch.Tensor, axis: int, split_dim: int, concat_dim: int) -> torch.Tensor:
    return _AXES[axis].all_to_all_raw(x, split_dim, concat_dim)


@_all_to_all_op.register_fake
def _(x, axis, split_dim, concat_dim):
    shape = list(x.shape)
    size = _AXES[axis].size
    shape[split_dim] //= size
    shape[concat_dim] *= size
    return x.new_empty(shape)


def _all_to_all_setup(ctx, inputs, output) -> None:
    ctx.axis, ctx.dims = inputs[1], (inputs[2], inputs[3])


def _all_to_all_backward(ctx, g):
    split_dim, concat_dim = ctx.dims
    return _all_to_all_op(g.contiguous(), ctx.axis, concat_dim, split_dim), None, None, None


_all_to_all_op.register_autograd(_all_to_all_backward, setup_context=_all_to_all_setup)


def all_to_all(
    axis: MeshAxis, x: torch.Tensor, split_dim: int, concat_dim: int
) -> torch.Tensor:
    """:meth:`MeshAxis.all_to_all_raw` under autograd (the gradient takes
    the inverse all-to-all), as the dispatcher op
    ``torchft_tpu_torch::mesh_all_to_all``."""
    if axis.size == 1:
        return x
    return _all_to_all_op(x.contiguous(), axis.handle, split_dim, concat_dim)


#: the exchange ops whose outputs ``remat_policy="dots"`` keeps
EXCHANGE_OPS = (
    torch.ops.torchft_tpu_torch.mesh_shift.default,
    torch.ops.torchft_tpu_torch.mesh_all_to_all.default,
)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis: MeshAxis, x):  # type: ignore[override]
        ctx.axis = axis
        out = x.contiguous().clone()
        axis.psum_([out])
        return out

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        g = g.contiguous().clone()
        ctx.axis.psum_([g])
        return None, g


def psum(axis: MeshAxis, x: torch.Tensor) -> torch.Tensor:
    """The sum over ``axis`` of the parts its ranks hold, on every rank,
    when every rank goes on to use it for its own share of the loss: the
    gradient of each part is the sum of the ranks' output gradients (a
    psum both ways).  The MoE layer's global routing statistics and
    expert buffers are such sums."""
    if axis.size == 1:
        return x
    return _Psum.apply(axis, x)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis: MeshAxis, x, dim: int):  # type: ignore[override]
        ctx.axis, ctx.dim = axis, dim
        (out,) = axis.reduce_scatter([x.contiguous()], [dim])
        return out

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        (out,) = ctx.axis.all_gather([g.contiguous()], [ctx.dim])
        return None, out, None


def reduce_scatter(axis: MeshAxis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """:meth:`MeshAxis.reduce_scatter` under autograd: block ``rank`` of
    the sum over the axis; the gradient is all-gathered back."""
    if axis.size == 1:
        return x
    return _ReduceScatter.apply(axis, x, dim)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis: MeshAxis, dims, dtypes, *shards):  # type: ignore[override]
        ctx.axis, ctx.dims = axis, dims
        ctx.dtypes = [s.dtype for s in shards]
        return tuple(axis.all_gather(_cast(shards, dtypes), dims))

    @staticmethod
    def backward(ctx, *grads):  # type: ignore[override]
        # in each shard's own type: a bf16 gather of f32 shards sums its
        # gradient in f32 and hands it back unrounded
        grads = [g.contiguous().to(d) for g, d in zip(grads, ctx.dtypes)]
        return (None, None, None, *ctx.axis.reduce_scatter(grads, ctx.dims))


def _cast(shards, dtypes) -> "List[torch.Tensor]":
    return [s if d is None else s.to(d) for s, d in zip(shards, dtypes)]


def gather_shards(
    axis: MeshAxis, shards: "Sequence[torch.Tensor]", dims: "Sequence[int]",
    dtypes: "Sequence[Optional[torch.dtype]]",
) -> "Tuple[torch.Tensor, ...]":
    """The FSDP weight gather: :meth:`MeshAxis.all_gather` of each shard
    along its ``dims[i]`` in one collective, each first cast to
    ``dtypes[i]`` (None: as it is; a cast is elementwise, so casting before
    the gather is exact and moves fewer bytes).  The gradient of each whole
    tensor is reduce-scattered back (summed over the axis, in f32) to the
    shard's shape and type.  On an axis of size 1 only the casts apply."""
    if axis.size == 1:
        return tuple(_cast(shards, dtypes))
    return _GatherShards.apply(axis, tuple(dims), tuple(dtypes), *shards)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis: MeshAxis, x):  # type: ignore[override]
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        g = g.contiguous().clone()
        ctx.axis.psum_([g])
        return None, g


def copy_to_axis(axis: MeshAxis, x: torch.Tensor) -> torch.Tensor:
    """Identity forward, psum over ``axis`` backward: the input of a
    column-parallel matmul, whose ranks each give part of its gradient."""
    if axis.size == 1:
        return x
    return _CopyToAxis.apply(axis, x)


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis: MeshAxis, x):  # type: ignore[override]
        out = x.contiguous().clone()
        axis.psum_([out])
        return out

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return None, g


def reduce_from_axis(axis: MeshAxis, x: torch.Tensor) -> torch.Tensor:
    """psum over ``axis`` forward, identity backward: the output of a
    row-parallel matmul, each rank holding a partial sum."""
    if axis.size == 1:
        return x
    return _ReduceFromAxis.apply(axis, x)


# ---------------------------------------------------------------------------
# the inner mesh
# ---------------------------------------------------------------------------


class InnerMesh:
    """A replica group's inner mesh as one rank sees it: its axes in order
    (row-major over the group's ranks, as ``np.reshape`` lays devices out
    in a ``jax.sharding.Mesh``), this rank's coordinates, and the device it
    computes on.  An axis the mesh does not name has size 1."""

    def __init__(
        self, axes: "Sequence[MeshAxis]", device: "str | torch.device" = "cpu"
    ) -> None:
        self.axes: "Dict[str, MeshAxis]" = {a.name: a for a in axes}
        self.device = torch.device(device)

    @property
    def axis_names(self) -> "Tuple[str, ...]":
        return tuple(self.axes)

    @property
    def shape(self) -> "Dict[str, int]":
        """Axis name -> size, in order (``jax.sharding.Mesh.shape``)."""
        return {n: a.size for n, a in self.axes.items()}

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes.values():
            n *= a.size
        return n

    def axis(self, name: str) -> MeshAxis:
        a = self.axes.get(name)
        return a if a is not None else MeshAxis(name, None, 0, 1)

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def axis_index(self, name: str) -> int:
        return self.axis(name).rank

    def psum_(self, tensors: "Sequence[torch.Tensor]") -> None:
        """Sum each tensor over every axis of the mesh, in place."""
        for a in self.axes.values():
            a.psum_(tensors)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every axis, as a new tensor (no gradient)."""
        out = x.detach().clone()
        self.psum_([out])
        return out

    def stats(self) -> "Dict[str, float]":
        """Every axis's counters, summed, keyed ``<op>_bytes`` / ``<op>_s``."""
        out: "collections.Counter[str]" = collections.Counter()
        for a in self.axes.values():
            out.update(a.stats)
        return dict(out)

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={a.size}" for n, a in self.axes.items())
        return f"InnerMesh({inner}; on {self.device})"


__all__ = [
    "EXCHANGE_OPS",
    "InnerMesh",
    "MeshAxis",
    "all_to_all",
    "copy_to_axis",
    "gather_shards",
    "psum",
    "reduce_from_axis",
    "reduce_scatter",
    "shift",
]
