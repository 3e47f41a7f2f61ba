"""Data parallelism and parameter sharding over a rank mesh (the port of
``dmlc_core_tpu/parallel/spmd.py``).

JAX compiles ``step_fn`` with shardings and XLA derives the collectives
of the partitioned step. The port runs the same step on every rank, on
its own rows of the global batch and its own block of each parameter,
and spells out the collectives that make it compute what XLA's
partitioned ``model.sgd_step`` computes on the global batch:

- **The loss is the global weighted mean.** Each data rank divides its
  ``Σ per_row·w`` by the ``all_reduce`` of ``Σ w`` over the data axis,
  not by its own ``Σ w``: a tail batch pads with weight-0 rows, and the
  data ranks get different numbers of them, so an average of local means
  weights the rows of a rank with padding more. A penalty (``l2``) is
  divided by the data axis's size, so that the data ranks' losses sum to
  the global loss.
- **Gradients are summed over the ranks that hold the same block**, one
  ``all_reduce`` per group (the parameters that share a group ride one
  buffer). Over the data axis the ranks hold other rows, so their
  gradients add. Over another axis the parameter is replicated (``w``
  and ``b`` over ``model``): every rank of that line computed the
  gradient of the same rows, so only the rank at coordinate 0 adds its
  own and the others add zeros. The sum is then the data ranks' sum,
  the same bits on every rank of the group.
- **The pair term with ``v`` on ``model``.** Each rank runs K3 on its
  contiguous ``[D, E/n]`` block and gets a partial ``½Σ_e(s²−q)`` f32[B];
  ``_SumOver`` adds the partials over ``model`` in forward and passes the
  gradient through unchanged in backward (every rank of the line holds
  the same loss, counted once). K4 then runs on the block with the same
  ``g`` on every rank of the line. ``Σv²`` of the penalty is summed the
  same way.
- **Replicas stay bit-identical**: after a step the ranks of a model line
  hold the same bits of ``w`` and ``b``, and the ranks of a data line the
  same bits of their ``v`` block, since each applies the same reduced
  gradient.
- **Kernels run as on one device**: on CUDA tensors the step runs K1-K4,
  on CPU tensors their plain versions.

A batch is this rank's rows of the global batch (its data coordinate's
``B/n`` rows, in order), as ``StagingPipeline(mesh=)`` stages them;
``shard_batch`` cuts them from a global batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import Error, check
from .mesh import Mesh

__all__ = [
    "P",
    "Placed",
    "data_parallel_step",
    "place",
    "place_model",
    "replicate",
    "shard_batch",
    "shard_params",
]


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dimension,
    e.g. ``P(None, "model")`` splits a table's columns over ``model``;
    ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _block(mesh: Mesh, shape: Sequence[int], spec: P) -> Tuple[Tuple[slice, ...], int]:
    """(index, replica_id) of this rank's block of an array of ``shape``
    placed by ``spec``: a contiguous slice on each split dimension, and
    the rank's row-major position among the ranks that hold the same
    block (the axes the spec does not name), as a JAX shard's
    ``replica_id``."""
    check(len(spec) <= len(shape), f"spec {spec!r} has more dims than shape {tuple(shape)}")
    index = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            index.append(slice(0, int(size)))
            continue
        check(axis in mesh.shape, f"spec {spec!r} names axis {axis!r} not in mesh {mesh.shape}")
        n = mesh.shape[axis]
        check(size % n == 0, f"dimension {dim} of size {size} does not split over "
                             f"{axis!r} of size {n}")
        step = size // n
        c = mesh.coords[axis]
        index.append(slice(c * step, (c + 1) * step))
    replica = 0
    for axis in mesh.axis_names:
        if axis not in spec:
            replica = replica * mesh.shape[axis] + mesh.coords[axis]
    return tuple(index), replica


class Placed:
    """One rank's block of a placed array: the port's counterpart of a
    ``jax.Array`` shard as ``addressable_shards`` lists it. ``local`` is
    the contiguous block on the rank's device, ``shape`` the global
    shape, ``index`` the block's slices of it, ``replica_id`` its place
    among the ranks that hold the same block, and ``spec`` how it was
    placed. The sharded checkpoints read these fields."""

    __slots__ = ("local", "shape", "index", "replica_id", "spec", "mesh")

    def __init__(self, local: torch.Tensor, shape, index, replica_id: int, spec: P,
                 mesh: Mesh) -> None:
        self.local = local
        self.shape = tuple(int(s) for s in shape)
        self.index = tuple(index)
        self.replica_id = int(replica_id)
        self.spec = P(*spec)
        self.mesh = mesh

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, spec={self.spec!r}, index={self.index}, "
                f"replica_id={self.replica_id})")


def place(value, mesh: Mesh, spec: P = P()) -> Placed:
    """This rank's block of the global ``value`` (a tensor or numpy
    array), copied to the mesh's device."""
    if isinstance(value, torch.Tensor):
        shape = value.shape
        index, replica = _block(mesh, shape, P(*spec))
        local = value.detach()[index].to(mesh.device, copy=True).contiguous()
    else:
        arr = np.asarray(value)
        shape = arr.shape
        index, replica = _block(mesh, shape, P(*spec))
        local = torch.from_numpy(np.array(arr[index], order="C")).to(mesh.device)
    return Placed(local, shape, index, replica, spec, mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree)


def replicate(tree, mesh: Mesh):
    """Place every array leaf of a tree fully replicated over the mesh."""
    return _tree_map(
        lambda x: place(x, mesh, P())
        if isinstance(x, (torch.Tensor, np.ndarray)) else x, tree)


def shard_params(params: Mapping[str, Any], mesh: Mesh,
                 rules: Optional[Mapping[str, P]] = None) -> Dict[str, Placed]:
    """Place params by name→spec rules; unlisted params replicate.

    Example (the FM embedding split by columns over ``model``)::

        shard_params(params, mesh, {"v": P(None, "model")})
    """
    rules = dict(rules or {})
    return {name: place(value, mesh, rules.get(name, P())) for name, value in params.items()}


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, data_axis: str = "data"):
    """This rank's rows of a global batch (numpy arrays or tensors), as
    tensors on the mesh's device: rows ``[d·B/n, (d+1)·B/n)`` for data
    coordinate ``d`` of ``n``."""
    return {k: place(v, mesh, P(data_axis)).local for k, v in batch.items()}


class _SumOver(torch.autograd.Function):
    """Sum over a group in forward, the gradient unchanged in backward."""

    @staticmethod
    def forward(ctx, x, spmd, axes):
        y = x.clone()
        spmd.all_reduce([y], axes)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Spmd:
    """What a placed model needs to compute the global step: the mesh,
    the data axis and each parameter's spec; the collectives it runs and
    their counters (``stats``: calls and bytes)."""

    def __init__(self, mesh: Mesh, data_axis: str, specs: Mapping[str, P]) -> None:
        check(data_axis in mesh.shape,
              f"data axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.specs = {k: P(*v) for k, v in specs.items()}
        self.n_data = mesh.shape[data_axis]
        self.stats = {"collectives": 0, "bytes": 0}

    def all_reduce(self, tensors: Sequence[torch.Tensor], axes: Sequence[str]) -> None:
        """Sum each tensor in place over the group of ``axes``, in one
        call (a flat buffer when there are several)."""
        group = self.mesh.group(axes)
        if group is None:
            return
        import torch.distributed as dist

        if len(tensors) == 1:
            flat = tensors[0]
        else:
            flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        if flat is not tensors[0]:
            off = 0
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n
        self.stats["collectives"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size()

    def mean(self, per_row: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """This data rank's share of the global weighted mean."""
        total = weights.detach().sum().reshape(1).float()
        self.all_reduce([total], (self.data_axis,))
        return (per_row * weights).sum() / torch.clamp(total[0], min=1e-9)

    def shard_sum(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` computed from this rank's block of ``name``, summed over
        the axes that split it (gradient unchanged)."""
        axes = [a for a in self.specs.get(name, P()) if a is not None]
        if not axes or self.mesh.group(axes) is None:
            return x
        return _SumOver.apply(x, self, tuple(axes))

    def penalty(self, x: torch.Tensor) -> torch.Tensor:
        """A term of the loss that does not depend on the rows, counted
        once over the data axis."""
        return x / self.n_data

    def _contributes(self, axes: Sequence[str]) -> bool:
        return all(self.mesh.coords[a] == 0 for a in axes if a != self.data_axis)

    def reduce(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
        """(global loss, global gradients) from this rank's: each sum over
        the ranks that hold the same block, one call per group."""
        by_group: Dict[Tuple[str, ...], list] = {}
        named = [("", P(), loss.detach().reshape(1).clone())]
        named += [(k, self.specs.get(k, P()), g) for k, g in grads.items()]
        for name, spec, t in named:
            axes = tuple(a for a in self.mesh.axis_names if a not in spec)
            if not self._contributes(axes):
                t.zero_()
            by_group.setdefault(axes, []).append(t)
        for axes, tensors in by_group.items():
            self.all_reduce(tensors, axes)
        return named[0][2][0], grads


def place_model(model, mesh: Mesh, rules: Optional[Mapping[str, P]] = None,
                data_axis: str = "data"):
    """Replace the model's parameters by this rank's blocks of them
    (``shard_params`` of its own global parameters) and hand it the
    ``Spmd`` that makes its loss and gradients the global ones. Its
    global shapes are kept (``model.placed()`` lists them). Only the FM's
    ``v`` may be split, by its columns: the kernels index the rows of
    ``w`` and ``v`` by feature id."""
    rules = {k: P(*v) for k, v in (rules or {}).items()}
    for name, spec in rules.items():
        check(name in dict(model.named_parameters()), f"rule for unknown parameter {name!r}")
        if any(a is not None for a in spec) and not (name == "v" and spec[:1] in ((), (None,))):
            raise Error(f"rule {name}: {spec!r}: the port splits only the FM's v, "
                        "by its columns (P(None, axis))")
    spmd = Spmd(mesh, data_axis, rules)
    model.place(shard_params(model.params(), mesh, rules), spmd)
    return model


class DataParallelStep:
    """``step(model, batch)`` on the mesh; see ``data_parallel_step``."""

    def __init__(self, step: Callable, mesh: Mesh, data_axis: str,
                 rules: Mapping[str, P]) -> None:
        self._step = step
        self.mesh = mesh
        self.data_axis = data_axis
        self.rules = {k: P(*v) for k, v in rules.items()}

    def __call__(self, model, batch, *args):
        spmd = getattr(model, "spmd", None)
        if spmd is None:
            place_model(model, self.mesh, self.rules, self.data_axis)
        elif (spmd.mesh is not self.mesh or spmd.data_axis != self.data_axis
              or spmd.specs != self.rules):
            raise Error("the model is placed on another mesh or by other rules")
        return self._step(model, batch, *args)


def data_parallel_step(step: Callable, mesh: Mesh, data_axis: str = "data",
                       param_rules: Optional[Mapping[str, P]] = None) -> DataParallelStep:
    """``step(model, batch) -> aux`` (e.g. ``lambda m, b: m.sgd_step(b,
    lr=0.1)``) run on the mesh: the first call places the model's
    parameters (replicated, or split per ``param_rules``), and every call
    computes the global step of the module docstring, with ``batch``
    this rank's rows. The model is updated in place, so the next call
    takes it as it stands."""
    return DataParallelStep(step, mesh, data_axis, param_rules or {})
