"""Serving with DBB-packed weights on the PyTorch port: the paper's W-DBB
compression applied to inference bandwidth.  Packs a DBB-compliant model
into the wire format (values + bitmask), serves a batch of prompts, and
checks that the packed path gives the dense path's tokens while
streaming fewer weight bytes; then the int8 wire and the int8 KV cache.

    PYTHONPATH=src python examples/serve_packed_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
one): the packed engine's linears run the native W-DBB matmul (kernel
#1), the int8 wire's the int8 W-DBB matmul (kernel #2).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import dbb
from repro_torch.core.schedule import prune_weights
from repro_torch.models import lm
from repro_torch.serve import paged_cache
from repro_torch.serve.engine import Engine, ServeConfig, pack_params_for_serving
from repro_torch.train.trainer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_config("granite_3_8b", smoke=True, sparsity_mode="wdbb")
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device, wire_dtype=None)

    # make the weights DBB-compliant (as W-DBB training would)
    params = prune_weights(params, dbb.DBBConfig(4, 8),
                           predicate=lambda path, w: not any(
                               s in path for s in ("embed", "norm", "ln")))

    nbytes = paged_cache.cache_nbytes  # bytes of any nest of tensors
    packed = pack_params_for_serving(params, cfg)
    layer_dense = nbytes(params["layers"])
    layer_packed = nbytes(packed["layers"])
    print(f"layer weights: dense {layer_dense / 1e6:.2f} MB -> packed "
          f"{layer_packed / 1e6:.2f} MB ({layer_dense / layer_packed:.2f}x compression)")
    layer_i8 = nbytes(pack_params_for_serving(params, cfg, wire_dtype="int8")["layers"])
    print(f"int8 wire:     dense {layer_dense / 1e6:.2f} MB -> packed {layer_i8 / 1e6:.2f} MB "
          f"({layer_dense / layer_i8:.2f}x compression)")

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 12)).astype(np.int32)

    def serve(**kw):
        return Engine(params, cfg, ServeConfig(max_seq=64, **kw), device=device).generate(
            prompts, 16)

    out_d = serve()
    out_p = serve(pack_weights=True)
    if not (out_d == out_p).all():
        raise RuntimeError("packed serving must match dense exactly")
    print("packed == dense generation: OK")
    # the paper's int8 datapath: a numerics change, not a semantics change;
    # early greedy tokens match, and a divergence compounds through the
    # feedback loop (random weights here)
    out_i8 = serve(pack_weights=True, wire_dtype="int8")
    s0 = prompts.shape[1]  # the echoed prompt is not counted
    stable = int((out_i8[:, s0:] == out_p[:, s0:]).all(axis=0).sum())
    print(f"int8 wire: {stable}/{out_p.shape[1] - s0} generated columns token-identical")

    # the int8 KV cache: ~4x fewer cache bytes, and within the int8-KV wire
    # batched and stepped serving stay byte-identical (prefill attends over
    # the same quantization round trip the cache stores)
    cfg_kv8 = dataclasses.replace(cfg, sparsity=dataclasses.replace(cfg.sparsity,
                                                                    kv_dtype="int8"))
    kv_f = nbytes(lm.make_cache(cfg, 4, 64, "meta"))
    kv_8 = nbytes(lm.make_cache(cfg_kv8, 4, 64, "meta"))
    print(f"KV cache: f32 {kv_f / 1e6:.2f} MB -> int8 {kv_8 / 1e6:.2f} MB")
    out_kv_b = serve(prefill_mode="batched", pack_weights=True, kv_dtype="int8")
    out_kv_s = serve(prefill_mode="stepped", pack_weights=True, kv_dtype="int8")
    if not (out_kv_b == out_kv_s).all():
        raise RuntimeError("int8-KV batched must match int8-KV stepped exactly")
    print("int8 KV: batched == stepped generation: OK")
    print("sample:", out_p[0].tolist())
    return dict(dense=out_d, packed=out_p, int8=out_i8, kv_batched=out_kv_b,
                kv_stepped=out_kv_s, kv_bytes=(kv_f, kv_8))


if __name__ == "__main__":
    main()
