"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace one rank's
program of every (arch x shape x mesh) cell on abstract inputs, count
its flops, bytes and collectives, and emit roofline terms
(``launch/roofline.py``).

The reference lowers each cell with GSPMD on 512 fake XLA host devices
and reads XLA's cost analysis of one device's partitioned program.  The
port has no GSPMD.  Its counterpart of one device's program is the
port's own model code running on ``DTensor`` leaves over a fake process
group of 256 or 512 ranks (``torch.testing._internal.distributed.
fake_pg``: collectives return at once), with every tensor a fake one
(``FakeTensorMode``), so nothing is allocated and no kernel runs: the
plain versions are traced, as the reference traces ``impl="jnp"``.
DTensor propagates each op's sharding and runs it on rank 0's local
shards; where a placement cannot take the next op it redistributes,
which is a collective GSPMD would also have inserted.  Constants built
inside the model are plain tensors, taken as replicated
(``implicit_replication``).

What is counted, on rank 0's local shards (:class:`_Counter`):

* flops: ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s
  rules: matmuls, convolutions, attention) on every local aten op;
* HBM bytes: each local aten op's operand and result bytes (views move
  nothing; a broadcast operand counts its distinct elements).  The
  port's program is unfused eager code, so this is the unfused count,
  not XLA's fused one: every intermediate is written and read back;
* collective bytes: each collective's result bytes, as the reference
  counts them in HLO: DTensor's redistributions (its functional
  collectives, the calls ``CommDebugMode`` lists) plus the two regions'
  own collectives (``DistContext.result_bytes``), by kind;
* memory: the local bytes of the step's arguments and outputs.  The
  peak of temporaries is not measured (``temp_bytes`` null): torch's
  ``MemTracker`` counts the global-shape fake tensors that DTensor's
  propagation makes, not one rank's shards.

Per-layer correction, as the reference's: cells are traced at 1 and 2
layers, and ``total = (c1 - body) + L * body`` with ``body = c2 - c1``.

Run it as its own process (the fake group is process-global):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, placement_types
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.base import shape_by_name
from repro_torch.core import tree
from repro_torch.launch import roofline, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, encdec, lm
from repro_torch.sharding import partition
from repro_torch.sharding.context import get_context, use_mesh
from repro_torch.train import optimizer
from repro_torch.train import train_step as ts

# the functional collectives DTensor and the differentiable regions make,
# and DTensor's shard-to-shard move, as the reference's kinds
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# DistContext's collective names -> the reference's kinds
_REGION_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                "all_to_all": "all-to-all"}


@dataclasses.dataclass
class Counts:
    """One trace's counts on rank 0's local shards."""
    flops: int = 0
    bytes_hbm: int = 0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)

    def add_coll(self, kind: str, nbytes: int, calls: int = 1) -> None:
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + int(nbytes)
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + int(calls)


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dim of stride 0 (an
    ``expand``) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    return [a for a in tree_flatten(x)[0] if isinstance(a, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Counts the local aten ops of one rank's program.

    An op on ``DTensor`` operands is handed to DTensor (``NotImplemented``),
    which runs it as local ops and collectives on the shards; those come
    back through this mode and are counted.  The global-shape ops DTensor
    runs to propagate an output's metadata are not part of the program
    and are not counted (:func:`_counting`)."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ns = func.namespace
        name = func._opname
        if ns in ("_c10d_functional", "_dtensor"):
            kind = _COLL_KIND.get(name)
            if kind is not None:
                self.counts.add_coll(kind, sum(t.numel() * t.element_size()
                                               for t in _tensors(out)))
            return out
        if ns in ("c10d", "prim") or func.is_view:
            return out
        outs = _tensors(out)
        if not outs:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.counts.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if name not in ("empty", "empty_strided", "empty_like", "new_empty",
                        "new_empty_strided", "detach", "lift_fresh"):
            self.counts.bytes_hbm += sum(_distinct_bytes(t) for t in _tensors((args, kwargs)))
            self.counts.bytes_hbm += sum(_distinct_bytes(t) for t in outs)
        return out


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as a card's mesh makes it: one
    all-to-all (on a ``"cpu"`` mesh DTensor gathers whole and chunks, as
    gloo needs, which would count ``n`` times the bytes)."""
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 funcol._resolve_group_name((mesh, mesh_dim)))


@contextlib.contextmanager
def _counting(counter: _Counter):
    """``counter`` active, with DTensor's metadata propagation left out of
    the count (it runs each op on global fake shapes: not part of any
    rank's program) and its shard-to-shard moves made as all-to-alls;
    DTensor is restored after."""
    saved = (ShardingPropagator._propagate_tensor_meta_non_cached,
             placement_types.shard_dim_alltoall)

    def uncounted(self, *args, **kwargs):
        counter.paused += 1
        try:
            return saved[0](self, *args, **kwargs)
        finally:
            counter.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        with counter:
            yield counter
    finally:
        (ShardingPropagator._propagate_tensor_meta_non_cached,
         placement_types.shard_dim_alltoall) = saved


# ------------------------------------------------------------------ the group


def ensure_fake_group(world_size: int) -> None:
    """Start the fake process group at ``world_size`` ranks (this process
    is rank 0), or keep the one already started at that size; a group of
    another size or backend is refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"dry-run needs a fake group of {world_size} ranks; this process has a "
                f"{dist.get_backend()!r} group of {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)


def _place(tree_, spec_tree, mesh):
    """Each fake leaf as a ``DTensor`` of its sanitized spec: rank 0's
    local shard (``partition.local_tree``) wrapped with the global shape,
    so no collective runs."""
    shardings = partition.tree_shardings(mesh, spec_tree, tree_)
    local = partition.local_tree(tree_, spec_tree, mesh)

    def wrap(g, loc, sh):
        return DTensor.from_local(loc, mesh, sh.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())

    return tree.tree_map(wrap, tree_, local, shardings)


def _local_bytes(x) -> int:
    total = 0
    for t in _tensors(x):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def with_layers(cfg, n: int):
    kw = {"n_layers": n}
    if cfg.family == "encdec":
        kw["n_enc_layers"] = n
    return dataclasses.replace(cfg, **kw)


class Trace(NamedTuple):
    counts: Counts
    argument_bytes: int  # rank 0's local bytes of the step's inputs
    output_bytes: int  # ... and of its outputs
    build_s: float
    trace_s: float


def trace_step(cfg, cell, mesh, multi_pod: bool, packed: bool = False) -> Trace:
    """Build the cell's abstract inputs at ``cfg``'s depth, place them on
    ``mesh`` and run the cell's step on rank 0's shards, counted."""
    t0 = time.time()
    ba = specs.batch_axes(multi_pod)
    mode = specs.fake_mode()
    if cell.kind == "train":
        params, p_specs, opt, o_specs = specs.abstract_model_state(cfg, with_opt=True)
        batch, b_specs = specs.train_batch_specs(cfg, cell, multi_pod)
        opt_cfg = optimizer.OptimizerConfig()
        with mode:
            args = (_place(params, p_specs, mesh),
                    optimizer.OptState(opt.step, _place(opt.mu, o_specs.mu, mesh),
                                       _place(opt.nu, o_specs.nu, mesh)),
                    _place(batch, b_specs, mesh))

        def step(params, opt_state, batch):
            return ts.train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg)
    elif cell.kind == "prefill":
        params, p_specs = specs.abstract_model_state(cfg, with_opt=False)
        a, a_specs = specs.prefill_specs(cfg, cell, multi_pod)
        with mode:
            args = (_place(params, p_specs, mesh), _place(a, a_specs, mesh))

        def step(params, a):
            if cfg.family == "encdec":
                return encdec.forward(params, a["frames"], a["tokens"], cfg)
            if cfg.family == "vlm":
                return lm.forward(params, a["tokens"], cfg, patch_embeds=a["patch_embeds"],
                                  pos3=a["pos3"])
            return lm.forward(params, a["tokens"], cfg)
    else:
        params, p_specs = specs.abstract_model_state(cfg, with_opt=False)
        # weight-stationary mega-TP for decode (the reference's §Perf-A1)
        p_specs = specs.serving_specs(p_specs)
        if packed:
            params, p_specs = specs.packed_state(cfg, params, p_specs)
        a, a_specs = specs.decode_specs(cfg, cell, multi_pod)
        pos = cell.seq_len - 1
        with mode:
            placed = _place(a, a_specs, mesh)
            cache = placed["cache"]
            window = a["cache"]["k"].shape[2] if "k" in a["cache"] else None
            args = (_place(params, p_specs, mesh), placed)

        def step(params, a):
            # the flash-decode guard on the global shapes, as lm.make_cache
            # decides it: a window-sharded ring decodes through the region
            c, ctx = cache, get_context()
            if window is not None and attention.window_shards(cfg, ctx, cell.global_batch,
                                                              window):
                c = attention.ShardedRing(cache, ctx)
            if cfg.family == "encdec":
                return encdec.decode_step(params, c, a["enc_out"], a["tokens"], pos, cfg)
            return lm.decode_step(params, c, a["tokens"], pos, cfg)
    t_build = time.time() - t0
    counter = _Counter()
    t0 = time.time()
    with mode, use_mesh(mesh, batch_axes=ba) as ctx, implicit_replication(), \
            _counting(counter):
        out = step(*args)
    for name, (calls, nbytes) in ctx.result_bytes.items():
        counter.counts.add_coll(_REGION_KIND[name], nbytes, calls)
    return Trace(counter.counts, _local_bytes(args), _local_bytes(out), t_build, time.time() - t0)


def _corrected(m1, m2, n_layers: int):
    body = max(0, m2 - m1)
    pre = max(0, m1 - body)
    return pre + n_layers * body


def cell_config(cfg, cell, multi_pod: bool):
    """``cfg`` as a cell traces it: an MoE routes shard-locally, one
    routing group per data shard (the reference's ``moe_groups``)."""
    if cfg.moe is None:
        return cfg
    n_batch_shards = 32 if multi_pod else 16
    return dataclasses.replace(cfg, moe_groups=min(n_batch_shards, cell.global_batch))


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               sparsity_mode: str | None = None, extra_tags: str = "",
               cfg_override=None):
    """Trace one cell at 1 and 2 layers on the fake group of 256 (single
    pod) or 512 (multi-pod) ranks; returns the reference's result dict.
    ``lower_s`` is the seconds spent building and placing the inputs,
    ``compile_s`` those spent tracing; ``roofline_scanned_raw`` holds the
    1-layer trace (the reference's scanned program counts its loop body
    once); the memory counts are corrected to the full depth like the
    roofline's."""
    cell = shape_by_name(shape_name)
    cfg = cell_config(cfg_override or configs.get_config(arch, sparsity_mode=sparsity_mode),
                      cell, multi_pod)
    ensure_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    packed = extra_tags == "packed"
    runs = [trace_step(with_layers(cfg, k), cell, mesh, multi_pod, packed=packed)
            for k in (1, 2)]
    (c1, a1, o1, b1, s1), (c2, a2, o2, b2, s2) = runs
    n_l = cfg.n_layers

    def corr(f):
        return _corrected(f(c1), f(c2), n_l)

    kinds = roofline.COLLECTIVES
    coll_break = {k: corr(lambda c: c.coll_bytes.get(k, 0)) for k in kinds}
    rl = roofline.Roofline(
        flops=corr(lambda c: c.flops),
        bytes_hbm=corr(lambda c: c.bytes_hbm),
        bytes_collective=sum(coll_break.values()),
        coll_breakdown=coll_break,
        coll_counts={k: c2.coll_counts.get(k, 0) for k in kinds},
    )
    rl_one = roofline.analyze(c1)
    mflops = roofline.model_flops(cfg, cell)
    n_dev = mesh.size()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "sparsity": cfg.sparsity.mode,
        "tags": extra_tags,
        "n_devices": n_dev,
        "lower_s": round(b1 + b2, 1),
        "compile_s": round(s1 + s2, 1),
        "memory": {
            "argument_bytes": _corrected(a1, a2, n_l),
            "output_bytes": _corrected(o1, o2, n_l),
            "temp_bytes": None,  # not measured: see the module docstring
            "code_bytes": None,
        },
        "roofline": rl.as_dict(),
        "roofline_scanned_raw": rl_one.as_dict(),
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_dev,
        "useful_flops_ratio": (mflops / n_dev) / rl.flops if rl.flops else None,
    }


def cell_id(arch, shape, mesh_name, sparsity=None, tags=""):
    sfx = f"_{sparsity}" if sparsity else ""
    tag = f"_{tags}" if tags else ""
    return f"{arch}_{shape}_{mesh_name}{sfx}{tag}"


def _fan_out(args, archs, meshes):
    """Run each (mesh, arch) as its own ``dryrun`` process, ``args.jobs``
    at a time (each holds its own fake group); print each one's output
    as it ends, and exit 1 if any failed."""
    todo = [(mp, arch) for mp in meshes for arch in archs]
    running, failed = [], []
    while todo or running:
        while todo and len(running) < args.jobs:
            mp, arch = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--mesh", "multi" if mp else "single", "--out", args.out]
            for flag, val in (("--shape", args.shape), ("--sparsity", args.sparsity)):
                if val:
                    cmd += [flag, val]
            cmd += ["--skip-existing"] * args.skip_existing + ["--packed"] * args.packed
            log = tempfile.TemporaryFile("w+")
            running.append((arch, log, subprocess.Popen(cmd, stdout=log,
                                                        stderr=subprocess.STDOUT, text=True)))
        done = [r for r in running if r[2].poll() is not None]
        if not done:
            time.sleep(0.2)
        for arch, log, proc in done:
            running.remove((arch, log, proc))
            log.seek(0)
            print("".join(line for line in log if not line.startswith("[rank")), flush=True)
            log.close()
            if proc.returncode:
                failed.append(arch)
    if failed:
        print(f"\n{len(failed)} FAILED PROCESSES: {failed}")
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--sparsity", type=str, default=None,
                    help="dense|wdbb|awdbb (default: config's own)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="DBB wire-format serving weights (decode cells)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace in this many processes at once, one (arch, mesh) each")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = configs.ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.jobs > 1:
        _fan_out(args, archs, meshes)
        return

    failures = []
    for mp in meshes:  # the fake group's size is fixed per process: one mesh at a time
        for arch in archs:
            shapes = ([shape_by_name(args.shape)] if args.shape
                      else configs.applicable_shapes(arch))
            if args.packed:
                shapes = [c for c in shapes if c.kind == "decode"]
            for cell in shapes:
                mesh_name = "multi" if mp else "single"
                tags = "packed" if args.packed else ""
                cid = cell_id(arch, cell.name, mesh_name, args.sparsity, tags)
                path = os.path.join(args.out, cid + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {cid}")
                    continue
                print(f"[dryrun] {cid} ...", flush=True)
                try:
                    res = trace_cell(arch, cell.name, mp, args.sparsity, extra_tags=tags)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    rl = res["roofline"]
                    print(
                        f"  ok trace={res['compile_s']}s "
                        f"flops/dev={rl['flops_per_device']:.3e} "
                        f"bytes/dev={rl['bytes_per_device']:.3e} "
                        f"coll/dev={rl['collective_bytes_per_device']:.3e} "
                        f"bottleneck={rl['bottleneck']} "
                        f"useful={res['useful_flops_ratio'] and round(res['useful_flops_ratio'], 3)}",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((cid, repr(e)))
                    print(f"  FAIL {cid}: {e}", flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for cid, err in failures:
            print(" ", cid, err)
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")


if __name__ == "__main__":
    main()
