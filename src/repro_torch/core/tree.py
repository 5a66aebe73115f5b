"""Parameter trees of the port and the reference's view of them.

A port tree is nested dicts of tensors whose layer-stacked subtrees
(``"layers"``, whisper's ``"enc_layers"`` and ``"dec_layers"``) are lists
of per-layer dicts (``convert.params_from_numpy``).  The reference holds
each per-layer leaf stacked over a leading ``[L, ...]`` axis, and several
of its training rules decide on that stacked leaf: W-DBB eligibility and
blocking (``core/schedule.py``), weight decay (``train/optimizer.py``)
and one compression scale (``train/compression.py``).

:func:`groups` lists a tree's leaves as the reference's leaves, in its
flattening order (dict keys sorted): a *group* is one reference leaf,
``(path, pieces, stacked)`` with ``pieces`` the per-layer tensors of a
stacked leaf (one tensor otherwise); :func:`rebuild` makes a tree of the
same shape from new pieces, group by group.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

STACKED = ("layers", "enc_layers", "dec_layers")


class Group(NamedTuple):
    path: tuple  # dict keys from the root; a stacked group's omits the layer index
    pieces: list  # per-layer tensors (stacked) or the one tensor
    stacked: bool

    def piece_paths(self) -> List[str]:
        """``"/"``-joined paths of the pieces, the layer index after the
        stacked subtree's name (``layers/3/attn/wq/w``)."""
        if not self.stacked:
            return ["/".join(self.path)]
        head, rest = self.path[0], "/".join(self.path[1:])
        return [f"{head}/{i}/{rest}" for i in range(len(self.pieces))]


def _sub_paths(t, prefix=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _sub_paths(t[k], prefix + (k,))
    else:
        yield prefix


def _get(t, path):
    for k in path:
        t = t[k]
    return t


def groups(tree: dict) -> List[Group]:
    """The reference's leaves of ``tree``, in its flattening order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k in STACKED and isinstance(v, list):
            for sub in _sub_paths(v[0]):
                out.append(Group((k,) + sub, [_get(layer, sub) for layer in v], True))
        else:
            for sub in _sub_paths(v):
                out.append(Group((k,) + sub, [_get(v, sub)], False))
    return out


def _skeleton(t):
    if isinstance(t, dict):
        return {k: _skeleton(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_skeleton(v) for v in t]
    return None


def _put(t, path, value):
    for k in path[:-1]:
        t = t[k]
    t[path[-1]] = value


def rebuild(like: dict, new_pieces) -> dict:
    """A tree shaped like ``like`` whose ``i``-th group holds
    ``new_pieces[i]`` (a list of per-layer pieces, or of one tensor)."""
    out = _skeleton(like)
    for g, pieces in zip(groups(like), new_pieces):
        if g.stacked:
            for layer, piece in zip(out[g.path[0]], pieces):
                _put(layer, g.path[1:], piece)
        else:
            _put(out, g.path, pieces[0])
    return out


def map_groups(fn: Callable, tree: dict, *others: dict) -> dict:
    """``rebuild(tree, ...)`` from ``fn(group, *other_groups_pieces)`` for
    every group, ``others`` shaped like ``tree``."""
    other_groups = [groups(o) for o in others]
    return rebuild(tree, [fn(g, *(og[i].pieces for og in other_groups))
                          for i, g in enumerate(groups(tree))])


def leaves(tree) -> list:
    """Every tensor of ``tree``, dicts in sorted-key order, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat) -> dict:
    """Inverse of :func:`leaves`: ``like``'s shape with ``flat``'s tensors."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)


def tree_map(fn: Callable, tree, *others):
    """``fn`` over corresponding leaves of trees of one shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree)]
    return fn(tree, *others)
