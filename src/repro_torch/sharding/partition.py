"""Sharding utilities (port of ``repro.sharding.partition``): spec
sanitization against a concrete mesh, DTensor placements for parameter,
batch and cache trees, and each rank's local shard.

Specs written in the model code express *intent*; meshes differ (16x16
single pod, 2x16x16 multi-pod, one process).  :func:`sanitize` drops
mesh axes that don't divide a dim evenly (vocab 49155 over model=16) and
axes absent from the mesh (``pod`` on the single-pod mesh), so one set of
annotations serves every target, elastic rescales included.

Trees are the port's: nested dicts, with lists for the per-layer
subtrees; a spec tree has the same shape with :class:`P` leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.sharding.context import axis_index, axis_size


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim sharded
    over their product, the first axis major; a one-name tuple is the
    name, as JAX's ``PartitionSpec`` has it).  Dims past its length are
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, (tuple, list)) and len(a) == 1
                                     else tuple(a) if isinstance(a, list) else a for a in axes))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _present(mesh, axis) -> bool:
    if isinstance(axis, (tuple, list)):
        return all(_present(mesh, a) for a in axis)
    return axis in mesh.mesh_dim_names


def sanitize(spec, shape, mesh) -> P:
    """Drop spec axes that are absent from the mesh or don't divide the
    dim: a tuple loses its last axis until the rest divides."""
    if spec is None:
        return P()
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        axes = list(axis) if isinstance(axis, (tuple, list)) else [axis]
        axes = [a for a in axes if _present(mesh, a)]
        while axes and shape[i] % axis_size(mesh, tuple(axes)) != 0:
            axes.pop()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def _is_spec(s) -> bool:
    return s is None or isinstance(s, P)


def _map(fn, spec_tree, tree, *, prefix: bool = False, is_leaf=_is_spec):
    """``fn(spec, leaf)`` over ``tree``'s leaves.  ``spec_tree`` has the
    tree's shape, or with ``prefix`` is a prefix of it: a spec applies to
    every leaf beneath it, and a dict key it lacks means replicated."""
    if is_leaf(spec_tree):
        return _spread(fn, spec_tree, tree) if prefix else fn(spec_tree, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, spec_tree.get(k, P()) if prefix else spec_tree[k], v,
                        prefix=prefix, is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, s, v, prefix=prefix, is_leaf=is_leaf)
                for s, v in zip(spec_tree, tree, strict=True)]
    raise TypeError(f"spec tree node {type(spec_tree).__name__} against a leaf")


def _spread(fn, spec, tree):
    if isinstance(tree, dict):
        return {k: _spread(fn, spec, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spread(fn, spec, v) for v in tree]
    return fn(spec, tree)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


class NamedSharding(NamedTuple):
    """Where a leaf lives: the mesh, its sanitized spec, and the DTensor
    placements (one ``Shard(dim)``/``Replicate()`` per mesh dim)."""
    mesh: object
    spec: P
    placements: list


def placements(mesh, spec: P) -> list:
    """DTensor placements of a sanitized spec: mesh dim ``a`` shards the
    tensor dim whose entry names it.  A tuple entry must list its axes
    in mesh order (DTensor shards the first mesh dim major)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = list(axis) if isinstance(axis, tuple) else [axis]
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} not in the mesh's order {names}")
        for i in order:
            out[i] = Shard(dim)
    return out


def tree_shardings(mesh, spec_tree, shape_tree):
    """A :class:`NamedSharding` tree from (spec intent, shapes): the
    leaves of ``shape_tree`` are tensors (``"meta"`` ones allocate
    nothing) or shape tuples."""
    def one(spec, like):
        s = sanitize(spec, _shape(like), mesh)
        return NamedSharding(mesh, s, placements(mesh, s))

    return _map(one, spec_tree, shape_tree)


def batch_spec(multi_pod: bool, extra_dims: int = 1) -> P:
    """Batch dim sharded over (pod, data); remaining dims replicated."""
    axes = ("pod", "data") if multi_pod else ("data",)
    return P(axes, *([None] * extra_dims))


def device_put_tree(tree, shardings):
    """Each leaf as a ``DTensor`` placed by its sharding
    (``distribute_tensor``: a collective, every rank calls it with the
    same tree; rank 0's values are the ones placed).

    This is the elastic-rescale path: ``checkpoint.manager.restore``
    returns host tensors, and placing them under the shardings of
    whatever mesh is current re-shards a checkpoint saved under another
    mesh shape; ``full_tensor()`` gives back the saved leaf."""
    def put(sh, t):
        return distribute_tensor(torch.as_tensor(t), sh.mesh, sh.placements)

    return _map(put, shardings, tree, is_leaf=lambda s: isinstance(s, NamedSharding))


def local_tree(tree, spec_tree, mesh):
    """Each rank's local shard of every leaf, as plain tensors: a leaf's
    sanitized spec slices each sharded dim at this rank's coordinate.
    ``spec_tree`` is a prefix of ``tree`` (a spec covers every leaf
    beneath it; a missing dict key keeps the leaf whole).  A sliced leaf
    is a copy, so the whole tensor can be freed."""
    def one(spec, t):
        s = sanitize(spec, tuple(t.shape), mesh)
        out = t
        for dim, axis in enumerate(s):
            if axis is None:
                continue
            n = axis_size(mesh, axis)
            width = t.shape[dim] // n
            out = out.narrow(dim, axis_index(mesh, axis) * width, width)
        return out if out is t else out.clone()

    return _map(one, spec_tree, tree, prefix=True)
