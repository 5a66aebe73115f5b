"""The ranks of ``tests/test_torch_distributed.py``: each is spawned by
``torch.multiprocessing`` (gloo over a ``FileStore`` in the run's work
directory, one thread a rank), builds the mesh and runs every case of the
file once; rank 0 writes the results to ``port_<D>x<M>.npz`` there.

Imports torch and the port only: the file's JAX side runs in its own
subprocess."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, encdec, lm
from repro_torch.sharding import partition
from repro_torch.sharding.context import use_mesh

MODES = ("own", "wdbb")  # the smoke config's own sparsity (awdbb 4/8), and wdbb
FLASH_ARCH, MOE_ARCH = "granite_3_8b", "granite_moe_1b_a400m"
# the reference's tests/test_distributed.py cases: batch 2 x 12 decode steps
# over a 16-slot ring; batch 4 x 16 tokens through 4 experts, top-2
DEC_B, DEC_S, MAX_SEQ = 2, 12, 16
MOE_B, MOE_S = 4, 16
MOE = MoEConfig(n_experts=4, top_k=2, capacity_factor=16.0)
# the other families whose ring decode runs GQA: the hybrid (its recurrent
# planes stay whole) and the enc-dec decoder's self-attention
OTHER_ARCHS = ("hymba_1_5b", "whisper_base")


def port_cfg(arch, mode):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="float32")
    if arch == MOE_ARCH:
        cfg = dataclasses.replace(cfg, moe=MOE)
    if mode == "wdbb":
        cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(cfg.sparsity, mode="wdbb"))
    return cfg


def decode_loop(params, cfg, tokens, batch):
    """``lm.make_cache`` (under whatever context is set) and one
    ``decode_step`` a token from position 0: ``(logits [B, S, V], the
    cache)``."""
    cache = lm.make_cache(cfg, batch, MAX_SEQ, "cpu")
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = lm.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        outs.append(logits)
    return torch.cat(outs, dim=1), cache


def other_decode(arch):
    """12 decode steps of ``arch``'s smoke config in f32 (seeded port
    weights; whisper's decoder over a seeded encoder output) from an
    empty ring made under whatever context is set: ``(logits, the
    cache)``."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="float32")
    gen = torch.Generator().manual_seed(3)
    if cfg.family == "encdec":
        params = encdec.init_params(cfg, gen, "cpu")
        frames = torch.randn((DEC_B, cfg.n_frames, cfg.d_model), generator=gen)
        enc = encdec.encode(params, frames, cfg)

        def step(cache, tok, t):
            return encdec.decode_step(params, cache, enc, tok, t, cfg)
    else:
        params = lm.init_params(cfg, gen, "cpu", wire_dtype=None)

        def step(cache, tok, t):
            return lm.decode_step(params, cache, tok, t, cfg)
    toks = torch.randint(0, cfg.vocab, (DEC_B, DEC_S), generator=gen)
    cache = lm.make_cache(cfg, DEC_B, MAX_SEQ, "cpu")
    outs = []
    for t in range(DEC_S):
        logits, cache = step(cache, toks[:, t:t + 1], t)
        outs.append(logits)
    return torch.cat(outs, dim=1), cache


def _elastic(tparams, cfg, work, res):
    """Place a tree under a (1, W) mesh, save its full tensors, restore
    the host leaves, and place them under a (2, W/2) and a (W/2, 2) mesh:
    each leaf's ``full_tensor()`` equals the saved one."""
    world = dist.get_world_size()
    specs = lm.param_specs(cfg)
    mesh = mesh_mod.make_host_mesh()
    placed = partition.device_put_tree(tparams, partition.tree_shardings(mesh, specs, tparams))
    full = _tmap(lambda t: t.full_tensor(), placed)
    d = os.path.join(work, "ckpt")
    if dist.get_rank() == 0:
        ckpt.save(d, 3, full)
    dist.barrier()
    restored, manifest = ckpt.restore(d, tparams)
    ok = manifest["step"] == 3
    sharded = 0
    for shape in ((2, world // 2), (world // 2, 2)):
        m = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=("data", "model"))
        again = partition.device_put_tree(restored, partition.tree_shardings(m, specs, restored))
        for (_, want), (_, got) in zip(_leaves(tparams), _leaves(again)):
            ok &= bool(torch.equal(got.full_tensor(), want))
            sharded += any(not p.is_replicate() for p in got.placements)
    res["elastic_ok"] = np.array(ok)
    res["elastic_sharded_leaves"] = np.array(sharded)


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def run(rank, world, work, shape):
    """One rank of a ``shape`` (data, model) mesh over ``world`` ranks."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, f"store_{shape[0]}x{shape[1]}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"))
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        res = {}
        dec_toks, moe_toks = inputs["dec_tokens"], inputs["moe_tokens"]
        for mode in MODES:
            cfg = port_cfg(FLASH_ARCH, mode)
            with use_mesh(mesh) as ctx:
                logits, cache = decode_loop(inputs[FLASH_ARCH], cfg, dec_toks, DEC_B)
            res[f"flash_{mode}"] = logits.numpy()
            res[f"flash_sharded_{mode}"] = np.array(isinstance(cache, attention.ShardedRing))
            res[f"flash_cache_shape_{mode}"] = np.array(cache["k"].shape)
            for name, (calls, nbytes) in ctx.stats.items():
                res[f"flash_{name}_{mode}"] = np.array([calls, nbytes])

            cfg = port_cfg(MOE_ARCH, mode)
            local = partition.local_tree(inputs[MOE_ARCH], lm.local_specs(cfg), mesh)
            res["expert_shape"] = np.array(local["layers"][0]["moe"]["gate"].shape)
            with use_mesh(mesh) as ctx:
                logits, aux = lm.forward(local, moe_toks, cfg, with_aux=True)
            res[f"ep_{mode}"] = logits.numpy()
            res[f"ep_aux_{mode}"] = aux.numpy()
            for name, (calls, nbytes) in ctx.stats.items():
                res[f"ep_{name}_{mode}"] = np.array([calls, nbytes])

        for arch in OTHER_ARCHS:
            with use_mesh(mesh):
                logits, cache = other_decode(arch)
            res[f"other_{arch}"] = logits.numpy()
            res[f"other_sharded_{arch}"] = np.array(isinstance(cache, attention.ShardedRing))

        # the guard: one row cannot shard over data, so the ring stays whole
        # and decode takes the plain ring path
        cfg = port_cfg(FLASH_ARCH, "own")
        with use_mesh(mesh) as ctx:
            logits, cache = decode_loop(inputs[FLASH_ARCH], cfg, dec_toks[:1], 1)
        res["guard_b1"] = logits.numpy()
        res["guard_b1_sharded"] = np.array(isinstance(cache, attention.ShardedRing))
        res["guard_b1_collectives"] = np.array(sum(c for c, _ in ctx.stats.values()))

        host = mesh_mod.make_host_mesh()
        res["host_mesh"] = np.array(host.shape)
        try:
            mesh_mod.make_production_mesh()
            res["production_raises"] = np.array(False)
        except ValueError:
            res["production_raises"] = np.array(True)
        if world > 1:
            _elastic(inputs[FLASH_ARCH], port_cfg(FLASH_ARCH, "own"), work, res)
        if rank == 0:
            np.savez(os.path.join(work, f"port_{shape[0]}x{shape[1]}.npz"), **res)
    finally:
        dist.destroy_process_group()
