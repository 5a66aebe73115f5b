"""The training step (port of ``repro.train.train_step``): CE loss plus the
MoE aux loss, gradients, W-DBB mask projection, optional int8 gradient
compression with error feedback, AdamW.

A pure function of ``(params, opt_state, batch, masks)`` as in the
reference: the gradients are taken with ``torch.autograd.grad`` on
detached copies of the leaves, and new trees are returned.  The reference
jits it (``make_jitted_train_step``); here :func:`make_train_step` is a
plain closure, which donates nothing.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import tree
from repro_torch.models import encdec, lm
from repro_torch.sharding import context
from repro_torch.train import compression, optimizer


def loss_fn(params, batch, cfg):
    """Mean CE over the valid labels (``>= 0``) plus the aux loss; returns
    ``(loss, {"ce", "aux", "acc"})``.  The VLM's vision prefix carries
    label -1; padded-vocab logits are set to -1e30 in f32 before the
    ``logsumexp``."""
    if cfg.family == "encdec":
        logits, aux = encdec.forward(params, batch["frames"], batch["tokens"], cfg, with_aux=True)
    else:
        kw = {}
        if cfg.family == "vlm":
            kw["patch_embeds"] = batch.get("patch_embeds")
            if "pos3" in batch:
                kw["pos3"] = batch["pos3"]
        logits, aux = lm.forward(params, batch["tokens"], cfg, with_aux=True, **kw)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # VLM: the vision prefix carries no loss
        pad = logits.shape[1] - labels.shape[1]
        labels = torch.cat([torch.full((labels.shape[0], pad), -1, dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    valid = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    if isinstance(logits, DTensor):
        logz, gold, hit = _vocab_parallel_terms(logits, safe, cfg.vocab)
        n_valid = torch.clamp_min(valid.sum().float(), 1.0)
        ce = torch.sum(torch.where(valid, logz - gold, 0.0)) / n_valid
        acc = torch.sum(torch.where(valid, hit, 0.0)) / n_valid
        return ce + aux, {"ce": ce, "aux": aux, "acc": acc}
    logits_f = logits.float()
    if logits.shape[-1] != cfg.vocab:  # mask the vocab padding
        vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits_f = torch.where(vocab_ids < cfg.vocab, logits_f, -1e30)
    logz = torch.logsumexp(logits_f, dim=-1)
    gold = torch.gather(logits_f, -1, safe[..., None])[..., 0]
    n_valid = torch.clamp_min(valid.sum().float(), 1.0)
    ce = torch.sum(torch.where(valid, logz - gold, 0.0)) / n_valid
    hit = (torch.argmax(logits_f, dim=-1) == safe).float()
    acc = torch.sum(torch.where(valid, hit, 0.0)) / n_valid
    return ce + aux, {"ce": ce, "aux": aux, "acc": acc}


def _vocab_parallel_terms(logits, labels, vocab: int):
    """``(logsumexp, gold logit, argmax == label)`` per token of ``DTensor``
    logits ``[B, S, V_padded]``, as a region on the local vocabulary
    shards (the vocabulary-parallel cross entropy): each rank reduces its
    own columns, and the max, the sums and the first arg-max index are
    combined over the vocabulary's mesh dims (``Partial`` max, sum, min);
    nothing of ``[B, S, V]`` moves.  The same values as the plain path
    (padded columns at -1e30, arg-max ties to the lower index)."""
    mesh = logits.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in logits.placements]
    lead = [p if p == Shard(0) else Replicate() for p in pl]
    lg = context.local_shard(logits, mesh, pl).float()
    lab = context.local_shard(labels, mesh, lead)
    v_l = lg.shape[-1]
    shard = 0  # this rank's index along the vocabulary's mesh dims
    for m, p in enumerate(pl):
        if p == Shard(2):
            shard = shard * mesh.size(m) + mesh.get_local_rank(m)
    ids = torch.arange(v_l, device=lg.device) + shard * v_l
    lg = torch.where(ids < vocab, lg, -1e30)

    def combine(t, op):
        red = [Partial(op) if p == Shard(2) else p for p in pl]
        return context.from_local(t, mesh, red, logits.shape[:2]).redistribute(
            mesh, lead).to_local()

    lmax, lidx = lg.max(dim=-1)
    # the shift: logsumexp does not depend on it, and each rank would see
    # only its own columns' part of its gradient
    m = combine(lmax.detach(), "max")
    logz = m + torch.log(combine(torch.exp(lg - m[..., None]).sum(dim=-1), "sum"))
    local = (lab >= ids[0]) & (lab < ids[0] + v_l)
    idx = torch.clamp(lab - ids[0], 0, v_l - 1)
    gold = combine(torch.where(local, torch.gather(lg, -1, idx[..., None])[..., 0], 0.0), "sum")
    first = combine(torch.where(lmax == m, lidx + ids[0], torch.iinfo(torch.int64).max), "min")
    hit = (first == lab).float()
    shape = logits.shape[:2]
    return tuple(context.from_local(t, mesh, lead, shape) for t in (logz, gold, hit))


def _masked(t, masks):
    return tree.tree_map(
        lambda x, m: torch.where(m, x, torch.zeros_like(x)) if m.shape == x.shape else x, t, masks)


def train_step(params, opt_state: optimizer.OptState, batch, *, cfg,
               opt_cfg: optimizer.OptimizerConfig, masks=None, residuals=None):
    """Returns ``(params, opt_state, metrics[, residuals])``.

    ``masks``: the W-DBB keep-mask tree; gradients and updated params are
    projected onto it, so weights stay inside the block bound between
    mask refreshes (paper §8.1).  ``residuals``: the error-feedback state;
    given, the gradients are int8-compressed and decompressed before the
    update (the data-parallel reduce's payload)."""
    flat = tree.leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, metrics = loss_fn(tree.unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree.unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for g, p in zip(grads, flat)])
    del leaves
    if masks is not None:
        grads = _masked(grads, masks)
    new_residuals = None
    if residuals is not None:
        qtree, new_residuals = compression.compress_tree(grads, residuals)
        grads = tree.tree_map(lambda g, p: g.to(p.dtype),
                              compression.decompress_tree(qtree), params)
    new_params, new_state, opt_metrics = optimizer.update(opt_cfg, grads, opt_state, params)
    if masks is not None:
        new_params = _masked(new_params, masks)
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss, **opt_metrics).items()}
    if residuals is not None:
        return new_params, new_state, metrics, new_residuals
    return new_params, new_state, metrics


def make_train_step(cfg, opt_cfg: optimizer.OptimizerConfig):
    """``stepper(params, opt_state, batch, masks=None)``: the reference's
    ``make_jitted_train_step`` as a plain closure (no jit, no donation)."""
    fn = functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg)

    def stepper(params, opt_state, batch, masks=None):
        return fn(params, opt_state, batch, masks=masks)

    return stepper
