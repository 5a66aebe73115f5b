#!/usr/bin/env python3
"""Device time of paged attention (kernel #6) on the patterns a serving
step gives it, for one checkout of the port.

    python3 scripts/bench_paged_attn.py [--root DIR] [--label NAME] [--iters 50]
        [--mode gqa|latent] [--pages-per-split N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts compare in one call: run it once per checkout, in turns.  B=4
requests that cached 1000, 517, 64 and 250 tokens in 16-slot pages,
tables of 64 pages padded with the null page.  ``--mode gqa`` (the
default) runs the GQA mode at granite-3-8b's shapes (32 heads over 8 KV
heads of 128, int8 KV) and granite-moe-1b-a400m's (16 over 8 of 64,
native bf16 KV); ``--mode latent`` the MLA latent mode at minicpm3-4b's
(40 heads over one 288-wide latent, v its first 256 features, softmax
scale 1/sqrt(96)), native bf16 KV (its main path) and int8 KV.  It times
one call (median of CUDA-event times, cold L2) of four patterns:

- ``decode``: S=1, every row live;
- ``chunks``: S=16, every row a whole chunk;
- ``mixed``: S=16 as a mixed step gives it: two decode rows (1 token, 15
  padding rows at position -1), a whole chunk and a chunk tail of 10
  tokens: the padding rows have no valid key;
- ``idle``: ``mixed`` with the last request idle (positions -1, a table
  of null pages only).

``--pages-per-split`` sets the split width (``paged_attn.PAGES_PER_SPLIT``)
for this run, to measure the choice.
"""

import argparse
import statistics
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--mode", default="gqa", choices=("gqa", "latent"))
    ap.add_argument("--pages-per-split", type=int, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_paged_attn: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn

    if args.pages_per_split is not None:
        paged_attn.PAGES_PER_SPLIT = args.pages_per_split
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn):
        fn()
        times = []
        for _ in range(args.iters):
            flush.zero_()
            torch.cuda._sleep(10_000_000)  # the host enqueues while the card is busy
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, ps, p_cnt = 4, 16, 64
    n_pages = b * p_cnt + 1
    lengths = (1000, 517, 64, 250)
    pos_tbl = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")
    nxt = 1
    for i, t in enumerate(lengths):
        used = -(-t // ps)
        tables[i, :used] = torch.arange(nxt, nxt + used, device="cuda")
        pos = torch.arange(used * ps, device="cuda")
        pos_tbl[nxt:nxt + used] = torch.where(pos < t, pos, -1).reshape(used, ps).int()
        nxt += used
    if args.mode == "gqa":
        # (name, KV heads, query heads per KV head, head dim, KV dtype)
        shapes = (("granite-3-8b", 8, 4, 128, "int8"), ("granite-moe-1b-a400m", 8, 2, 64, "native"))
    else:
        shapes = (("minicpm3-4b", 1, 40, 288, "native"), ("minicpm3-4b", 1, 40, 288, "int8"))
    for arch, kv, g, d, kv_dtype in shapes:
        k = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
        if args.mode == "latent":
            v = None
            kw = dict(kv_heads=1, softmax_scale=1.0 / (96 ** 0.5), latent_dv=256)
            if kv_dtype == "int8":
                k, k_s = quant.quantize_rows(k)
                kw.update(k_scale=k_s)
            else:
                k = k.to(torch.bfloat16)
        else:
            v = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
            kw = dict(kv_heads=kv)
            if kv_dtype == "int8":
                (k, k_s), (v, v_s) = quant.quantize_rows(k), quant.quantize_rows(v)
                kw.update(k_scale=k_s, v_scale=v_s)
            else:
                k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        for pattern in ("decode", "chunks", "mixed", "idle"):
            s = 1 if pattern == "decode" else 16
            q_pos = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
            tbl = tables.clone()
            for i, t in enumerate(lengths):
                n = s if pattern in ("decode", "chunks") else (1, s, 1, s // 2 + 2)[i]
                q_pos[i, :n] = torch.arange(t - n, t, dtype=torch.int32, device="cuda")
            if pattern == "idle":
                q_pos[3], tbl[3] = -1, 0
            q = torch.randn((b, s, kv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda: paged_attn.paged_attn_cuda(q, k, v, pos_tbl, tbl, q_pos, **kw))
            print(f"{args.label}: paged_attn {args.mode} {arch} {kv_dtype}-KV {pattern} B={b} "
                  f"S={s} H={kv * g} KV={kv} D={d} P={p_cnt} PS={ps}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
