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
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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
    # collective name -> [calls, result bytes] of the calls made through
    # torch.distributed; a differentiable all-to-all goes through the
    # functional collectives instead, which a dispatch mode sees (its
    # backward included), and is left out here
    result_bytes: dict = dataclasses.field(default_factory=dict)

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

    def _count(self, name: str, t: torch.Tensor, fan: int = 1, functional: bool = False) -> None:
        """One call of ``name`` on ``t``; its result holds ``fan`` times
        ``t``'s bytes (an all-gather's axis size)."""
        calls, nbytes = self.stats.get(name, (0, 0))
        size = t.numel() * t.element_size()
        self.stats[name] = [calls + 1, nbytes + size]
        if not functional:
            calls, nbytes = self.result_bytes.get(name, (0, 0))
            self.result_bytes[name] = [calls + 1, nbytes + fan * size]

    def all_reduce(self, t: torch.Tensor, op, axes) -> torch.Tensor:
        """``t`` reduced in place with ``op`` over every present axis of
        ``axes`` (``jax.lax.pmax``/``psum`` over those axes); a
        non-contiguous ``t`` is reduced in a contiguous copy, returned."""
        t = t.contiguous()
        for a in self._present(axes):
            if t.requires_grad:
                # the reduced value, with this rank's own term's gradient
                # (each rank differentiates its own copy of the result)
                red = t.detach().clone()
                self._count("all_reduce", red)
                dist.all_reduce(red, op=op, group=self.group(a))
                t = t + (red - t).detach()
            else:
                self._count("all_reduce", t)
                dist.all_reduce(t, op=op, group=self.group(a))
        return t

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``'s dim 0 split in ``size(axis)`` equal blocks, block ``j``
        sent to coordinate ``j``; the blocks received stacked on dim 0 in
        source order."""
        t = t.contiguous()
        self._count("all_to_all", t, functional=t.requires_grad)
        if t.requires_grad:  # its backward is the reverse all-to-all
            return funcol.all_to_all_single_autograd(t, None, None, self.group(axis))
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group(axis))
        return out

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The shards of ``t`` over ``axes`` concatenated along ``dim`` in
        coordinate order, the first axis major (the inverse of a slice
        over ``axes``)."""
        for a in reversed(self._present(axes)):
            self._count("all_gather", t, self.size(a))
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


# ------------------------------------------------------ DTensor-safe reshapes


def _dim_groups(old, new):
    """Pair ``old``'s dims with ``new``'s under a row-major reshape:
    ``[(old dims, new dims), ...]``, each group of equal products."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        gi, gj = [i], [j]
        po = old[i] if i < len(old) else 1
        pn = new[j] if j < len(new) else 1
        i, j = i + 1, j + 1
        while po != pn:
            if po < pn:
                po *= old[i]
                gi.append(i)
                i += 1
            else:
                pn *= new[j]
                gj.append(j)
                j += 1
        groups.append(([d for d in gi if d < len(old)], [d for d in gj if d < len(new)]))
    return groups


def shard_reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(shape)``, with a ``DTensor`` first moved to a placement
    the reshape can take (plain tensors: exactly ``t.reshape``).

    A mesh dim sharding a tensor dim that the reshape splits (a head
    split) or merges keeps its shard only when the shard lands on the
    leading new dim and divides it evenly; otherwise that mesh dim is
    replicated first (an all-gather).  GSPMD inserts such a resharding
    itself; DTensor refuses an uneven unflatten."""
    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    groups = _dim_groups(list(t.shape), shape)
    mesh = t.device_mesh

    def shards(dim):
        n = 1
        for m, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == dim:
                n *= mesh.size(m)
        return n

    def ok(dim):
        for od, nd in groups:
            if dim in od:
                if od == [dim] and len(nd) == 1:
                    return True
                return od[0] == dim and bool(nd) and shape[nd[0]] % shards(dim) == 0
        return True

    new = [Replicate() if isinstance(p, Shard) and not ok(p.dim) else p for p in t.placements]
    if new != list(t.placements):
        t = t.redistribute(mesh, new)
    return t.reshape(*shape)


def local_shard(t: torch.Tensor, mesh, placements, split=()) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements``, as a plain tensor:
    a ``DTensor`` redistributed there first (a plain ``t`` is the global
    value, replicated, and is only sliced).  ``split`` names the mesh
    dims over which the region divides its work: on those, a replicated
    input's gradient is this rank's partial sum (reduced in the
    backward, a reduce-scatter for a gathered weight); elsewhere every
    rank computes the same and the gradient keeps the placement."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if any(isinstance(p, Partial) for p in t.placements):
        # reduce a partial value on its own first: the backward cannot turn
        # the region's partial-sum gradient into another partial type
        t = t.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                                  for p in t.placements])
    grad = [Partial() if m in split and not isinstance(p, Shard) else p
            for m, p in enumerate(placements)]
    return t.redistribute(mesh, list(placements)).to_local(grad_placements=grad)


def split_dims(*placement_lists) -> list:
    """The mesh dims on which any of the placement lists is not
    replicated: where a region divides its work."""
    return sorted({m for pls in placement_lists for m, p in enumerate(pls)
                   if not isinstance(p, Replicate)})


def region_placements(t, mesh, seq_dim=None):
    """Placements for a region that runs on local shards: every mesh dim
    that shards ``t``'s dim 0 (the batch) keeps it, and the others shard
    ``seq_dim`` when given and its size divides, else replicate."""
    cur = t.placements if isinstance(t, DTensor) else [Replicate()] * mesh.ndim
    out, n_seq = [], 1
    for m, p in enumerate(cur):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif seq_dim is not None and t.shape[seq_dim] % (n_seq * mesh.size(m)) == 0:
            n_seq *= mesh.size(m)
            out.append(Shard(seq_dim))
        else:
            out.append(Replicate())
    return out


def from_local(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A contiguous ``DTensor`` of global ``shape`` from this rank's
    shard ``local`` under ``placements``; no collective runs."""
    shape = tuple(shape)
    stride, n = [], 1
    for s in reversed(shape):
        stride.append(n)
        n *= s
    return DTensor.from_local(local.contiguous(), mesh, list(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def row_placements(t, block: int = 1) -> list:
    """``t``'s placements for a region that works along the last dim in
    ``block``-wide pieces (DAP's 8-blocks): a shard of the last dim stays
    when every rank's piece holds whole blocks, and a partial sum is
    reduced; every other placement is kept."""
    mesh, last = t.device_mesh, t.ndim - 1
    out, n_last = [], 1
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == last:
            n_last *= mesh.size(m)
            out.append(p if (t.shape[last] // n_last) % block == 0 else Replicate())
        elif isinstance(p, Shard):
            out.append(p)
        else:
            out.append(Replicate())
    return out


def run_local(fn, tensors, placements):
    """``fn`` on the local shards of ``tensors`` (each redistributed to
    ``placements`` first), as a ``shard_map`` body: every output comes
    back as a ``DTensor`` under the same placements, its sharded dims
    scaled from the local shape."""
    mesh = tensors[0].device_mesh
    outs = fn(*(local_shard(t, mesh, placements) for t in tensors))

    def wrap(o):
        shape = list(o.shape)
        for m, p in enumerate(placements):
            if p.is_shard():
                shape[p.dim] *= mesh.size(m)
        return from_local(o, mesh, placements, shape)

    return tuple(wrap(o) for o in outs) if isinstance(outs, tuple) else wrap(outs)


def reduce_over(t: torch.Tensor, mesh, placements, dims, op: str) -> torch.Tensor:
    """This rank's ``t`` (a local shard under ``placements``) combined
    with ``op`` (``"sum"``, ``"max"``, ``"min"``) across the mesh dims
    ``dims``, as a plain tensor: a ``Partial`` DTensor reduced (an
    all-reduce over those dims)."""
    shape = list(t.shape)
    red, out = [], []
    for m, p in enumerate(placements):
        if m in dims:
            red.append(Partial(op))
            out.append(Replicate())
        else:
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(m)
            red.append(p)
            out.append(p)
    return from_local(t, mesh, red, shape).redistribute(mesh, out).to_local()
