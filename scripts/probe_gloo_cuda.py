#!/usr/bin/env python3
"""Whether two ranks can share one card over ``gloo`` with CUDA tensors.

    python3 scripts/probe_gloo_cuda.py [--ranks 2]

NCCL refuses two ranks on one device, so a multi-rank run of the
distributed regions on a one-card machine needs gloo to carry CUDA
tensors.  Spawns ``--ranks`` processes on card 0 (gloo over a
``FileStore`` in ``$TMPDIR``), and in each tries, on CUDA tensors, the
collectives the regions make: ``all_reduce`` (MAX and SUM, over a
``DeviceMesh`` axis group), ``all_to_all_single`` and ``all_gather``.
Prints one line a collective: ``ok`` with the values checked, or the
exception's type and message.  Exits 0 when every collective was tried
(the verdict is in the lines), non-zero when the ranks did not finish.
"""

import argparse
import os
import sys
import tempfile


def rank_main(rank, world, path, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(path, world), rank=rank,
                            world_size=world)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))
    group = mesh.get_group("model")
    lines = []

    def attempt(name, fn):
        try:
            lines.append(f"{name}: ok {fn()}")
        except Exception as e:  # the probe's verdict: record what the backend raised
            lines.append(f"{name}: {type(e).__name__}: {str(e).splitlines()[0][:300]}")

    def reduce(op, want):
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t, op=op, group=group)
        torch.cuda.synchronize()
        assert t.is_cuda and t.tolist() == [want] * 4, t.tolist()
        return t.tolist()

    def all_to_all():
        t = torch.arange(world * 2, dtype=torch.float32, device="cuda") + 100 * rank
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        torch.cuda.synchronize()
        want = [100 * src + 2 * rank + j for src in range(world) for j in range(2)]
        assert out.tolist() == want, (out.tolist(), want)
        return out.tolist()

    def all_gather():
        t = torch.full((3,), float(rank), device="cuda")
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        torch.cuda.synchronize()
        assert [p[0].item() for p in parts] == list(range(world))
        return [p[0].item() for p in parts]

    attempt("all_reduce MAX", lambda: reduce(dist.ReduceOp.MAX, float(world)))
    attempt("all_reduce SUM", lambda: reduce(dist.ReduceOp.SUM, world * (world + 1) / 2))
    attempt("all_to_all_single", all_to_all)
    attempt("all_gather", all_gather)
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp()
    mp.start_processes(rank_main, args=(args.ranks, os.path.join(work, "store"), work),
                       nprocs=args.ranks, start_method="spawn")
    print(f"{args.ranks} gloo ranks on {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}:")
    for r in range(args.ranks):
        with open(os.path.join(work, f"rank{r}.txt")) as f:
            for line in f:
                print(f"  rank {r} {line.rstrip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
