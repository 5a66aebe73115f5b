"""Distribution context (port of ``repro.sharding.context``): lets model
code opt into its two hand-written distributed regions when a mesh is
active.

The launchers (or a test) set the context with :func:`use_mesh`; model
code asks :func:`get_context` and, when one is set, runs the
sequence-parallel ring decode (``attention.flash_decode``) and the
expert-parallel MoE (``moe._moe_forward_expert_parallel``) over
``torch.distributed``.  Without a context every path runs on one process.

Torch has no GSPMD, so the port keeps one rule: outside the two regions
every rank holds every leaf whole (the experts aside, held as the rank's
slice) and runs the same global batch; a region takes its rank's slice of
what every rank holds and ends with the all-gathers that the reference's
``shard_map`` ``out_specs`` imply.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (``launch/mesh.py``).  Every collective a region makes goes through
the context's methods, which count its calls and bytes in
``DistContext.stats``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def axis_size(mesh, axes) -> int:
    """The number of shards of ``axes`` (a name or a tuple of names) on a
    mesh (anything with ``mesh_dim_names`` and ``shape``: a
    ``DeviceMesh``, or a stand-in in tests); an axis the mesh lacks
    counts 1."""
    if isinstance(axes, (tuple, list)):
        n = 1
        for a in axes:
            n *= axis_size(mesh, a)
        return n
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(axes, 1)


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes``, the first axis major (the
    order ``shard_map`` slices a dim sharded over a tuple of axes); an
    axis the mesh lacks is coordinate 0."""
    if not isinstance(axes, (tuple, list)):
        axes = (axes,)
    idx = 0
    for a in axes:
        if a in mesh.mesh_dim_names:
            idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


@dataclasses.dataclass
class DistContext:
    mesh: object  # DeviceMesh with named dims
    batch_axes: Tuple[str, ...] = ("data",)
    expert_axis: str = "model"
    # collective name -> [calls, bytes]; bytes are each call's local input
    stats: dict = dataclasses.field(default_factory=dict)

    def size(self, axes) -> int:
        return axis_size(self.mesh, axes)

    def index(self, axes) -> int:
        return axis_index(self.mesh, axes)

    def group(self, axis):
        """The process group of one mesh axis."""
        return self.mesh.get_group(axis)

    def _present(self, axes):
        if not isinstance(axes, (tuple, list)):
            axes = (axes,)
        return [a for a in axes if a in self.mesh.mesh_dim_names]

    def _count(self, name: str, t: torch.Tensor) -> None:
        calls, nbytes = self.stats.get(name, (0, 0))
        self.stats[name] = [calls + 1, nbytes + t.numel() * t.element_size()]

    def all_reduce(self, t: torch.Tensor, op, axes) -> torch.Tensor:
        """``t`` reduced in place with ``op`` over every present axis of
        ``axes`` (``jax.lax.pmax``/``psum`` over those axes); a
        non-contiguous ``t`` is reduced in a contiguous copy, returned."""
        t = t.contiguous()
        for a in self._present(axes):
            self._count("all_reduce", t)
            dist.all_reduce(t, op=op, group=self.group(a))
        return t

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``'s dim 0 split in ``size(axis)`` equal blocks, block ``j``
        sent to coordinate ``j``; the blocks received stacked on dim 0 in
        source order."""
        t = t.contiguous()
        out = torch.empty_like(t)
        self._count("all_to_all", t)
        dist.all_to_all_single(out, t, group=self.group(axis))
        return out

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The shards of ``t`` over ``axes`` concatenated along ``dim`` in
        coordinate order, the first axis major (the inverse of a slice
        over ``axes``)."""
        for a in reversed(self._present(axes)):
            self._count("all_gather", t)
            parts = [torch.empty_like(t) for _ in range(self.size(a))]
            dist.all_gather(parts, t.contiguous(), group=self.group(a))
            t = torch.cat(parts, dim=dim)
        return t


_CTX: Optional[DistContext] = None


def set_context(ctx: Optional[DistContext]):
    global _CTX
    _CTX = ctx


def get_context() -> Optional[DistContext]:
    return _CTX


@contextlib.contextmanager
def use_mesh(mesh, batch_axes=("data",), expert_axis="model"):
    """Set a :class:`DistContext` over ``mesh`` for the ``with`` block;
    yields it (its ``stats`` count the block's collectives)."""
    prev = _CTX
    ctx = DistContext(mesh=mesh, batch_axes=tuple(batch_axes), expert_axis=expert_axis)
    set_context(ctx)
    try:
        yield ctx
    finally:
        set_context(prev)
