"""What the bf16 silu's rounding costs on the card: ``epilogue.sigmoid``
(the reference's logistic, negate, exp, add and divide each rounded: four
launches) against ``torch.sigmoid`` (one launch, one rounding), on the
paths that run the silu in plain PyTorch: the MoE experts
(granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b at 8 of its 32 layers) and
the recurrent mixers (mamba2-130m, hymba-1.5b at 16 of its 32 layers).
Full width, seeded random bf16 weights, the native wire, each serving
``chip_smoke.py``'s workload: the main path's 8 requests (64-512 prompt
tokens, arrivals two iterations apart, 32 new) or the recurrent paths'
8 x 64 prompts, 32 new, stepped.

Each arch serves once to warm up, then in the order torch, rounded,
rounded, torch, in one process on one card, a fresh engine a serve.
Prints each serve's wall, generated tokens/s and silu calls (each call is
three launches more with ``epilogue.sigmoid``), whether its tokens equal
the first rounded serve's, and the card with its power limit.  Needs a
card; run from the repo root: ``python scripts/silu_ab.py``.
"""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402  (the workloads' constants)

PATHS = (("granite_moe_1b_a400m", None, "main"), ("phi3_5_moe_42b_a6_6b", 8, "main"),
         ("mamba2_130m", None, "recurrent"), ("hymba_1_5b", 16, "recurrent"))
ORDER = ("torch", "rounded", "rounded", "torch")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("silu_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import epilogue, native
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip()
    print(card)
    native.build_all()
    calls = {"n": 0}

    def counted(fn):
        def sigmoid(y):
            calls["n"] += 1
            return fn(y)
        return sigmoid

    rounded = epilogue.sigmoid
    variants = {"torch": counted(torch.sigmoid), "rounded": counted(rounded)}
    for arch, n_layers, kind in PATHS:
        cfg = configs.get_config(arch)
        depth = f"{cfg.n_layers} layers"
        if n_layers is not None:
            depth = f"{n_layers} of {cfg.n_layers} layers"
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), "cuda",
                                wire_dtype="native")
        if kind == "main":
            scfg = ServeConfig(**dict(cs.SERVE_SHAPE, wire_dtype="native", kv_dtype="native"))
            prompts, arrivals = cs.main_requests(np, cfg.vocab)
            n_new = cs.N_NEW

            def serve(eng):
                res = eng.generate_requests(prompts, n_new, arrivals=arrivals)
                return [np.asarray(r) for r in res]
        else:
            scfg = ServeConfig(pack_weights=True, max_seq=cs.REC_S0 + cs.REC_NEW,
                               wire_dtype="native", kv_dtype="native")
            prompts = np.random.default_rng(cs.SEED + 9).integers(
                0, cfg.vocab, (cs.N_REQUESTS, cs.REC_S0)).astype(np.int32)
            n_new = cs.REC_NEW

            def serve(eng):
                return list(eng.generate(prompts, n_new))

        epilogue.sigmoid = variants["rounded"]
        serve(Engine(params, cfg, scfg, device="cuda"))  # warm-up
        first = None
        for name in ORDER:
            epilogue.sigmoid = variants[name]
            eng = Engine(params, cfg, scfg, device="cuda")
            calls["n"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = serve(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if name == "rounded" and first is None:
                first = outs
            same = first is not None and all(np.array_equal(a, b) for a, b in zip(outs, first))
            print(f"silu_ab {arch} ({depth}, {kind}) {name}: wall {wall:.3f} s, "
                  f"{cs.N_REQUESTS * n_new / wall:.2f} generated tokens/s, {calls['n']} silu "
                  f"calls, tokens equal the first rounded serve's: {same} ({card})")
        epilogue.sigmoid = rounded
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
