"""Pipeline parallelism: a GPipe schedule over the ``pp`` axis.

PyTorch port of ``torchft_tpu/parallel/pipeline.py``.  Each stage holds
``L / S`` consecutive layers; at tick ``t`` stage ``s`` runs microbatch
``t - s`` and hands its output one stage forward (:meth:`~torchft_tpu_torch.
parallel.axis.MeshAxis.hop`, the port's ``ppermute`` with ``[(i, i + 1)]``).
Bubble overhead is the standard ``(S - 1) / (M + S - 1)``.  Activations may
be a pytree (a side stream such as the MoE aux loss rides the pipe); the
last stage's outputs are broadcast over ``pp``, so every stage returns them.

What differs from the JAX package, and why.  JAX scans every tick on every
stage (bubble ticks masked with ``where``) and lets reverse-mode AD derive
the backward: the compiled program issues the same exchanges on every
stage.  An SPMD torch program has no such guarantee: autograd runs only the
nodes a rank's loss reaches, in its own order, and a stage whose hops have
no gradient would never post its half of the backward exchange.  So the
schedule is one autograd node (:class:`_GPipe`) that runs the ticks itself:

- forward: at each active tick the stage's layers run on a detached copy
  of the tick's input, under autograd, and the graph is kept; bubble ticks
  compute nothing.  Stage ``s`` sends at tick ``t`` exactly when stage
  ``s + 1`` receives, so the hops pair up without sending bubbles;
- backward: the ticks in reverse.  At tick ``t`` a stage takes its output's
  gradient (the last stage from the loss, the others from the hop of tick
  ``t + 1``), runs ``torch.autograd.grad`` through the tick's graph (a
  remat recompute happens here), adds the layers' parameter gradients, and
  hands the input's gradient one stage back.  Every stage of the same
  index issues the same exchanges in the same order, forward and
  backward, whatever the loss did on it.

The layers' parameters are inputs of the node, so their gradients reach
``.grad`` through autograd as any other's.  A stage other than the first
takes no input from the microbatches, and its outputs' gradients come from
the broadcast's backward, which hands the gradient to the last stage only.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from torchft_tpu_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

Layer = Any


def _layer_params(layer: Layer) -> "List[torch.Tensor]":
    """The tensors of ``layer`` that take gradients: a module's parameters,
    or the leaves of a pytree of tensors."""
    if isinstance(layer, nn.Module):
        return [p for p in layer.parameters() if p.requires_grad]
    return [t for t in tree_flatten(layer)[0]
            if isinstance(t, torch.Tensor) and t.requires_grad]


def _stage_apply(fn: "Callable[[Any, Layer], Any]", x: Any, layers: "Sequence[Layer]") -> Any:
    """Run this stage's layers in order over the activation pytree ``x``."""
    for layer in layers:
        x = fn(x, layer)
    return x


def _microbatch_grad(grads: "List[Optional[torch.Tensor]]", like: "List[torch.Tensor]",
                     i: int) -> "List[torch.Tensor]":
    """The loss's gradient for the last stage's output of microbatch ``i``
    (one tensor per activation leaf; zeros where the loss did not use a
    leaf)."""
    return [torch.zeros_like(t) if g is None else g[i] for g, t in zip(grads, like)]


class _GPipe(torch.autograd.Function):
    """The whole GPipe schedule of one stage as one autograd node (see the
    module docstring).  Inputs: the schedule, the microbatch leaves ``[M,
    mb, ...]`` and the stage's parameters; outputs: the output leaves ``[M,
    mb, ...]`` (the last stage's results; zeros on other stages)."""

    @staticmethod
    def forward(ctx, sched: "_Schedule", n_leaves: int, *inputs):  # type: ignore[override]
        ctx.sched = sched
        ctx.ticks = sched.run_forward(list(inputs[:n_leaves]), build_graph=True)
        return tuple(sched.outputs)

    @staticmethod
    def backward(ctx, *grads):  # type: ignore[override]
        sched: "_Schedule" = ctx.sched
        leaf_grads, param_grads = sched.run_backward(ctx.ticks, list(grads))
        ctx.ticks = None
        return (None, None, *leaf_grads, *param_grads)


class _Schedule:
    """One stage's GPipe schedule: its layers, the step function, the ``pp``
    axis, and the forward's outputs."""

    def __init__(self, layers: "Sequence[Layer]", fn: "Callable[[Any, Layer], Any]",
                 axis: Any, skeleton: Any, m: int) -> None:
        self.layers, self.fn, self.axis = list(layers), fn, axis
        self.skeleton, self.m = skeleton, m
        self.stage, self.size = axis.rank, axis.size
        self.params = [p for layer in self.layers for p in _layer_params(layer)]
        self.outputs: "List[torch.Tensor]" = []

    def active(self, t: int, stage: "Optional[int]" = None) -> bool:
        i = t - (self.stage if stage is None else stage)
        return 0 <= i < self.m

    def run_forward(self, leaves: "List[torch.Tensor]", build_graph: bool) -> "dict":
        """The forward ticks; returns each active tick's ``(inputs, outputs)``
        (detached inputs that require grad, outputs with their graph) when
        ``build_graph``."""
        s, size, m = self.stage, self.size, self.m
        like = [leaf[0] for leaf in leaves]
        self.outputs = [torch.zeros_like(leaf) for leaf in leaves]
        ticks, buf = {}, None
        for t in range(m + size - 1):
            i = t - s
            y = None
            if self.active(t):
                x = [leaf[i] for leaf in leaves] if s == 0 else buf
                if build_graph:
                    x = [v.detach().requires_grad_(v.is_floating_point()) for v in x]
                with torch.set_grad_enabled(build_graph):
                    out = _stage_apply(self.fn, tree_unflatten(self.skeleton, x), self.layers)
                y = tree_flatten(out)[0]
                if build_graph:
                    ticks[t] = (x, y)
                y = [v.detach() for v in y]
                if s == size - 1:
                    for o, v in zip(self.outputs, y):
                        o[i] = v
            # stage s sends at tick t exactly when stage s + 1 is active at
            # t + 1, which is when it receives
            send = y if s < size - 1 and y is not None else None
            recv = like if s > 0 and self.active(t + 1) else None
            buf = self.axis.hop(send, recv, 1)
        return ticks

    def run_backward(
        self, ticks: "dict", grads: "List[Optional[torch.Tensor]]"
    ) -> "Tuple[List[Optional[torch.Tensor]], List[Optional[torch.Tensor]]]":
        """The backward ticks in reverse: ``(gradients of the microbatch
        leaves (stage 0; None elsewhere), gradients of the parameters)``."""
        s, size, m = self.stage, self.size, self.m
        like = [o[0] for o in self.outputs]
        leaf_grads = [torch.zeros_like(o) for o in self.outputs] if s == 0 else None
        param_grads: "List[Optional[torch.Tensor]]" = [None] * len(self.params)
        g_in = None
        for t in reversed(range(m + size - 1)):
            i = t - s
            g_x = None
            if self.active(t):
                x, y = ticks.pop(t)
                g_y = _microbatch_grad(grads, like, i) if s == size - 1 else g_in
                pairs = [(a, b) for a, b in zip(y, g_y) if a.requires_grad]
                wrt = [v for v in x if v.requires_grad] + self.params
                got = torch.autograd.grad(
                    [a for a, _ in pairs], wrt, [b for _, b in pairs], allow_unused=True)
                n_x = len(wrt) - len(self.params)
                it = iter(got[:n_x])
                g_x = [next(it) if v.requires_grad else None for v in x]
                g_x = [torch.zeros_like(v) if g is None else g for v, g in zip(x, g_x)]
                for j, g in enumerate(got[n_x:]):
                    if g is not None:
                        param_grads[j] = g if param_grads[j] is None else param_grads[j] + g
                if s == 0:
                    for lg, g in zip(leaf_grads, g_x):
                        lg[i] = g
            # the forward's hop of tick t - 1 reversed: stage s hands its
            # input's gradient back at tick t when it was active; stage s - 1
            # receives it then, for its output of tick t - 1
            send = g_x if s > 0 and g_x is not None else None
            recv = like if s < size - 1 and self.active(t, s + 1) else None
            g_in = self.axis.hop(send, recv, -1)
        return (leaf_grads if leaf_grads is not None else [None] * len(self.outputs),
                param_grads)


class _FromLast(torch.autograd.Function):
    """The last stage's tensors broadcast over the axis; the backward hands
    the gradient to the last stage only (every stage's copy is the same
    value, and one of them stands for it)."""

    @staticmethod
    def forward(ctx, axis: Any, *tensors):  # type: ignore[override]
        ctx.last = axis.rank == axis.size - 1
        return tuple(axis.broadcast(tensors, axis.size - 1))

    @staticmethod
    def backward(ctx, *grads):  # type: ignore[override]
        if ctx.last:
            return (None, *grads)
        return (None, *[None if g is None else torch.zeros_like(g) for g in grads])


def broadcast_from_last(axis: Any, tree: Any) -> Any:
    """The last stage's pytree ``tree`` on every stage of ``axis`` (see
    :class:`_FromLast`)."""
    if axis.size == 1:
        return tree
    leaves, skeleton = tree_flatten(tree)
    return tree_unflatten(skeleton, list(_FromLast.apply(axis, *leaves)))


def pipeline_stage_outputs(
    stage_layers: "Sequence[Layer]", microbatches: Any,
    fn: "Callable[[Any, Layer], Any]", axis: Any,
) -> Any:
    """The GPipe schedule without the broadcast: the last stage's outputs
    ``[M, mb, ...]`` on the last stage, zeros elsewhere.  A caller whose
    loss lives on the last stage alone uses this and gives the other
    stages' backward a start of their own (any function of the outputs,
    whose gradient the schedule ignores there)."""
    leaves, skeleton = tree_flatten(microbatches)
    m = leaves[0].shape[0]
    sched = _Schedule(stage_layers, fn, axis, skeleton, m)
    need_graph = torch.is_grad_enabled() and (
        any(t.requires_grad for t in leaves) or any(p.requires_grad for p in sched.params))
    if not need_graph:
        sched.run_forward(leaves, build_graph=False)
        out = sched.outputs
    else:
        out = list(_GPipe.apply(sched, len(leaves), *leaves, *sched.params))
    return tree_unflatten(skeleton, out)


def pipeline_apply_local(
    stage_layers: "Sequence[Layer]", microbatches: Any,
    fn: "Callable[[Any, Layer], Any]", axis: Any,
) -> Any:
    """Per-stage GPipe body over the ``pp`` axis ``axis`` (a :class:`~
    torchft_tpu_torch.parallel.axis.MeshAxis`).

    Args:
        stage_layers: this stage's layers (modules, or pytrees of tensors).
        microbatches: activation pytree, every leaf ``[M, mb, ...]`` (every
            stage passes the same shapes; only stage 0's values enter the
            pipe).
        fn: one layer step ``fn(x, layer) -> x`` over the activation pytree.

    Returns the outputs ``[M, mb, ...]``, the same on every stage (the last
    stage's broadcast)."""
    return broadcast_from_last(axis, pipeline_stage_outputs(stage_layers, microbatches, fn, axis))


def stage_layers(layers: "Sequence[Layer]", axis: Any) -> "List[Layer]":
    """This stage's ``L / S`` consecutive layers of the whole list."""
    n, size = len(layers), axis.size
    if n % size:
        raise ValueError(f"layer count {n} not divisible by pp axis size {size}")
    per = n // size
    return list(layers[axis.rank * per:(axis.rank + 1) * per])


def split_microbatches(x: Any, microbatches: int) -> Any:
    """Each leaf ``[B, ...]`` as ``[M, B / M, ...]``."""
    b = tree_flatten(x)[0][0].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {microbatches}")
    return tree_map(lambda leaf: leaf.reshape((microbatches, b // microbatches)
                                              + tuple(leaf.shape[1:])), x)


def pipeline_apply(
    layers: "Sequence[Layer]", x: Any, fn: "Callable[[Any, Layer], Any]",
    mesh: Any, axis_name: str = "pp", microbatches: int = 4,
) -> Any:
    """GPipe-apply a stack of layers over the ``axis_name`` axis of the
    inner mesh ``mesh``: this stage runs its ``L / S`` consecutive layers of
    ``layers`` (every rank may pass the whole list; ``L`` must divide by the
    axis size).  ``x`` is a pytree of ``[B, ...]`` leaves (this rank's rows)
    whose ``B`` divides by ``microbatches``; returns the outputs in ``x``'s
    structure, the same on every stage."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.axis_names}")
    axis = mesh.axis(axis_name)
    mine = stage_layers(layers, axis)
    out = pipeline_apply_local(mine, split_microbatches(x, microbatches), fn, axis)
    leaves, skeleton = tree_flatten(x)
    flat = tree_flatten(out)[0]
    return tree_unflatten(skeleton, [o.reshape(leaf.shape) for o, leaf in zip(flat, leaves)])


__all__ = [
    "broadcast_from_last",
    "pipeline_apply",
    "pipeline_apply_local",
    "pipeline_stage_outputs",
    "split_microbatches",
    "stage_layers",
]
