"""Crash-safe checkpoints (port of ``repro.checkpoint.manager``): atomic,
keep-k, readable without the tree that restores them.

* Each save writes its leaves as ``.npy`` files under ``step_<N>.tmp/``,
  then renames the directory to ``step_<N>/`` in one step: a crash
  mid-save never corrupts a published checkpoint.  Stale ``.tmp``
  directories are ignored by every read and swept by the next save.
* ``MANIFEST.json`` records the step, the leaf count, each leaf's dtype
  and shape, the tree's layout and the caller's JSON-able ``extra``.
* keep-k garbage collection, keeping milestone steps (``milestone_every``).

A tree is nested dicts (leaves in sorted-key order, as a jax pytree
flattens), lists and tuples, with numpy arrays or torch tensors as
leaves.  numpy has no bfloat16: a bf16 tensor is stored as its 16-bit
view with ``"bfloat16"`` in the manifest, and restored as a bf16 CPU
tensor bit for bit; every other leaf comes back as a numpy array.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint is structurally incompatible with the restore target
    (leaf count, a leaf's shape, or a leaf file missing on disk)."""


def _flatten(tree):
    """``(leaves, layout)``: the leaves in order, and a string naming the
    tree's structure (written to the manifest for the reader)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return "{" + ",".join(f"{k!r}:{walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ",".join(walk(v) for v in t) + "]"
        leaves.append(t)
        return "*"

    layout = walk(tree)
    return leaves, layout


def _unflatten(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)


def _host(leaf):
    """``(numpy array to write, dtype name)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sweep_stale_tmp(ckpt_dir: str) -> int:
    """Remove ``step_*.tmp`` directories left by a crashed saver."""
    n = 0
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            n += 1
    return n


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None, keep: int = 3,
         milestone_every: int | None = None, pre_publish_hook=None) -> str:
    """Atomically publish ``tree`` (and the JSON-able ``extra``) as
    ``step_<N>/``.  ``pre_publish_hook`` runs after the tmp directory is
    written and before the rename: a hook that raises leaves a ``.tmp``
    directory that every read ignores."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp)
    leaves, layout = _flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "treedef": layout,
                "extra": extra or {}, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if pre_publish_hook is not None:
        pre_publish_hook()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomic publish
    _gc(ckpt_dir, keep, milestone_every)
    return final


def _gc(ckpt_dir: str, keep: int, milestone_every: int | None = None) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else steps:
        if milestone_every and s % milestone_every == 0:
            continue  # milestones outlive the keep window
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    """Published steps, ascending (``.tmp`` directories excluded)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_manifest(ckpt_dir: str, step: int | None = None) -> dict:
    """A published step's ``MANIFEST.json``, without reading the leaves: a
    restorer reads the saved config (``extra``) before it can build the
    tree that :func:`restore` needs."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "MANIFEST.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, like_tree, step: int | None = None):
    """Restore into the structure of ``like_tree`` (its leaves give only
    shapes: numpy arrays, or torch tensors on any device, ``"meta"``
    included).  Returns ``(tree, manifest)`` with host leaves; any
    structural disagreement raises :class:`CheckpointError`."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(like_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise CheckpointError(
            f"checkpoint step {step} has {manifest['n_leaves']} leaves, "
            f"restore target expects {len(leaves)} — architecture mismatch"
        )
    new_leaves = []
    for i, like in enumerate(leaves):
        leaf_path = os.path.join(path, f"leaf_{i:05d}.npy")
        if not os.path.exists(leaf_path):
            raise CheckpointError(f"checkpoint step {step} is missing leaf file {leaf_path}")
        arr = np.load(leaf_path)
        want = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        if tuple(arr.shape) != tuple(want):
            raise CheckpointError(
                f"leaf {i} of step {step}: saved shape {tuple(arr.shape)} != expected {tuple(want)}"
            )
        if manifest["leaves"][i]["dtype"] == BF16:
            arr = torch.from_numpy(arr).view(torch.bfloat16)
        new_leaves.append(arr)
    return _unflatten(like_tree, new_leaves), manifest
