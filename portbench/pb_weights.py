"""The benchmark's own weights: dense bf16, drawn from the seed on the
device in two calls, laid out as the port's parameter tree.

Scale rules (the port's and its JAX reference's): linears ``N(0,
1/d_in)``, the embedding ``N(0, 0.02^2)``, norm scales one.  The linears
that the engine packs come from one buffer and the leaves it keeps dense
(the embedding, MLA's ``kv_up``) from a second, so dropping the caller's
tree after the engine is built frees the first whole.  The same seed on
the same device gives the same bits, so the reference draws them again
after the window instead of keeping 16.7 GB (granite-3-8b) alive.
"""

from __future__ import annotations

import math

import torch

from pb_traffic import seed_bits


def padded_vocab(model: dict) -> int:
    m = model.get("vocab_pad_multiple", 256)
    return -(-model["vocab"] // m) * m


def layer_linears(model: dict) -> list:
    """``(path, d_in, d_out, packed)`` of one layer's linears, in the
    port's key order."""
    d, h = model["d_model"], model["n_heads"]
    mla = model.get("mla")
    if mla:
        qk = mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]
        attn = [(("attn", "q_down"), d, mla["q_lora_rank"], True),
                (("attn", "q_up"), mla["q_lora_rank"], h * qk, True),
                (("attn", "kv_down"), d, mla["kv_lora_rank"] + mla["qk_rope_head_dim"], True),
                (("attn", "kv_up"), mla["kv_lora_rank"],
                 h * (mla["qk_nope_head_dim"] + mla["v_head_dim"]), False),
                (("attn", "wo"), h * mla["v_head_dim"], d, True)]
    else:
        dh = model.get("d_head") or d // h
        kv = model["n_kv_heads"] * dh
        attn = [(("attn", "wq"), d, h * dh, True), (("attn", "wk"), d, kv, True),
                (("attn", "wv"), d, kv, True), (("attn", "wo"), h * dh, d, True)]
    f = model["d_ff"]
    return attn + [(("mlp", "gate"), d, f, True), (("mlp", "up"), d, f, True),
                   (("mlp", "down"), f, d, True)]


def _norm(n: int, device):
    return {"scale": torch.ones((n,), dtype=torch.float32, device=device)}


def draw(model: dict, seed: int, device) -> dict:
    """The dense parameter tree of ``model`` from ``seed``."""
    d, v = model["d_model"], padded_vocab(model)
    lins = layer_linears(model)
    n_layers = model["n_layers"]
    packed_n = n_layers * sum(i * o for _, i, o, p in lins if p) + d * v
    dense_n = v * d + n_layers * sum(i * o for _, i, o, p in lins if not p)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    packed = torch.randn((packed_n,), generator=gen, device=device, dtype=torch.bfloat16)
    dense = torch.randn((dense_n,), generator=gen, device=device, dtype=torch.bfloat16)
    offs = {True: 0, False: 0}
    bufs = {True: packed, False: dense}

    def take(rows: int, cols: int, is_packed: bool, std: float):
        o = offs[is_packed]
        offs[is_packed] = o + rows * cols
        return bufs[is_packed][o:o + rows * cols].view(rows, cols).mul_(std)

    params = {"embed": {"w": take(v, d, False, 0.02)}, "layers": []}
    mla = model.get("mla")
    for _ in range(n_layers):
        layer = {"ln1": _norm(d, device), "ln2": _norm(d, device), "attn": {}, "mlp": {}}
        for (group, name), d_in, d_out, is_packed in lins:
            layer[group][name] = {"w": take(d_in, d_out, is_packed, 1.0 / math.sqrt(d_in))}
        if mla:
            layer["attn"]["q_norm"] = _norm(mla["q_lora_rank"], device)
            layer["attn"]["kv_norm"] = _norm(mla["kv_lora_rank"], device)
        params["layers"].append(layer)
    params["final_norm"] = _norm(d, device)
    params["lm_head"] = {"w": take(d, v, True, 1.0 / math.sqrt(d))}
    assert offs[True] == packed_n and offs[False] == dense_n
    return params
