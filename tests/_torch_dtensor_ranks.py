"""The ranks of ``tests/test_torch_dtensor_regions.py``: each is spawned by
``torch.multiprocessing`` (gloo over a ``FileStore`` in the run's work
directory), places seeded smoke-config parameters and inputs as
``DTensor`` leaves on a (2, 2) ``("data", "model")`` mesh by the
reference's spec trees (as the dry-run places its fake ones), runs the
model through its DTensor regions, and gathers the results; rank 0
computes the plain, undistributed results beside them and writes both
to ``regions.npz``.  Imports torch and the port only."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.configs.base import MoEConfig
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models import attention, encdec, lm
from repro_torch.sharding import partition
from repro_torch.sharding.context import use_mesh
from repro_torch.train import train_step as ts

SHAPE = (2, 2)
B, S, DEC_STEPS, MAX_SEQ = 4, 16, 4, 8
MOE = MoEConfig(n_experts=4, top_k=2, capacity_factor=16.0)
FORWARD_ARCHS = ("granite_3_8b", "granite_moe_1b_a400m", "mamba2_130m", "minicpm3_4b",
                 "hymba_1_5b", "whisper_base")


def cfg_of(arch, mode="wdbb"):
    """``arch``'s smoke config in f32; ``wdbb`` (no DAP: a partial sum
    summed in another order cannot flip a top-4 selection)."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=MOE)
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(cfg.sparsity, mode=mode))


def params_of(cfg):
    return lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)


def place(t, spec_tree, mesh):
    return partition.device_put_tree(t, partition.tree_shardings(mesh, spec_tree, t))


def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()


def decode(params, cfg, cache, toks):
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        outs.append(full(logits))
    return np.concatenate(outs, axis=1)


def ring_of(cfg, batch, mesh):
    """The ring of ``lm.make_cache`` placed by ``lm.cache_specs`` (its
    batch over data), window-sharded for flash-decode when the guard
    holds, as the dry-run builds it."""
    cache = lm.make_cache(cfg, batch, MAX_SEQ, "cpu")
    spec = {k: specs.P(sp[0], ("data",), *sp[2:]) for k, sp in lm.cache_specs(cfg).items()}
    placed = place(cache, spec, mesh)
    with use_mesh(mesh) as ctx:
        if attention.window_shards(cfg, ctx, batch, cache["k"].shape[2]):
            return attention.ShardedRing(placed, ctx)
    return placed


def run(rank, world, work):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(SHAPE),
                          mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(1)
        res = {}

        def record(name, dt, plain):
            res[f"{name}_dt"], res[f"{name}_plain"] = dt, plain

        # the forward and its gradients: Megatron linears,
        # sequence-parallel attention, the MoE region and the SSD mixer
        # region, each on DTensor leaves
        def forward_and_grads(p, inputs, cfg):
            leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
            model = encdec if cfg.family == "encdec" else lm
            out = model.forward(tree.unflatten(p, leaves), *inputs, cfg)
            grads = torch.autograd.grad(out.float().square().sum(), leaves)
            return full(out), np.array([np.linalg.norm(full(g)) for g in grads])

        for arch in FORWARD_ARCHS:
            cfg = cfg_of(arch)
            toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
            inputs, specs_in = (toks,), (partition.batch_spec(False),)
            if cfg.family == "encdec":
                params = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
                p_specs = encdec.param_specs(cfg)
                frames = torch.randn((B, cfg.n_frames, cfg.d_model), generator=gen)
                inputs, specs_in = (frames, toks), (partition.batch_spec(False, 2),) + specs_in
            else:
                params, p_specs = params_of(cfg), lm.param_specs(cfg)
            plain, plain_g = forward_and_grads(params, inputs, cfg)
            placed = place(params, p_specs, mesh)
            with use_mesh(mesh), implicit_replication():
                out, out_g = forward_and_grads(
                    placed, [place(t, sp, mesh) for t, sp in zip(inputs, specs_in)], cfg)
            record(f"forward_{arch}", out, plain)
            record(f"grads_{arch}", out_g, plain_g)

        # decode over the ring: flash-decode (the window-sharded ring), the
        # key-parallel merge (batch 1: the guard fails, the window stays
        # sharded by the spec) and MLA's absorbed attention over a latent
        # sharded on its latent dim
        for arch, batch in (("granite_3_8b", B), ("granite_3_8b", 1), ("minicpm3_4b", B)):
            cfg = cfg_of(arch)
            params = params_of(cfg)
            toks = torch.randint(0, cfg.vocab, (batch, DEC_STEPS), generator=gen)
            plain = decode(params, cfg, lm.make_cache(cfg, batch, MAX_SEQ, "cpu"), toks)
            placed = place(params, specs.serving_specs(lm.param_specs(cfg)), mesh)
            cache = ring_of(cfg, batch, mesh)
            with use_mesh(mesh, batch_axes=("data",)), implicit_replication():
                got = decode(placed, cfg, cache,
                             place(toks, specs.P(("data",) if batch % 2 == 0 else None), mesh))
            record(f"decode_{arch}_b{batch}", got, plain)

        # the loss (vocabulary-parallel cross entropy) and its gradients
        cfg = cfg_of("granite_3_8b")
        params = params_of(cfg)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

        def loss_and_grads(p, b):
            leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
            loss, metrics = ts.loss_fn(tree.unflatten(p, leaves), b, cfg)
            grads = torch.autograd.grad(loss, leaves)
            return loss, metrics["acc"], grads

        loss, acc, grads = loss_and_grads(params, batch)
        placed = place(params, lm.param_specs(cfg), mesh)
        b_placed = place(batch, {k: partition.batch_spec(False) for k in batch}, mesh)
        with use_mesh(mesh), implicit_replication():
            dloss, dacc, dgrads = loss_and_grads(placed, b_placed)
        record("loss", full(dloss), full(loss))
        record("acc", full(dacc), full(acc))
        record("grad_norm", np.sqrt(sum(float((full(g) ** 2).sum()) for g in dgrads)),
               np.sqrt(sum(float((full(g) ** 2).sum()) for g in grads)))

        # DAP on a DTensor, shard by shard: bit for bit
        x = torch.randn((B, S, 64), generator=gen)
        dx = place(x, specs.P(("data",), None, "model"), mesh)
        record("dap", full(ops.dap_prune(dx, 4, 8)[0]), full(ops.dap_prune(x, 4, 8)[0]))
        if rank == 0:
            np.savez(os.path.join(work, "regions.npz"), **res)
    finally:
        dist.destroy_process_group()
