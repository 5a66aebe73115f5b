"""Decoder-only LM (port of ``repro.models.lm``): dense GQA or MLA, with a
dense MLP or an MoE FFN; the VLM backbone (M-RoPE over three position
streams; the vision frontend is a stub in the reference too, so text
tokens serve); the mamba2 SSM (``ssm``) and hymba's hybrid of attention
and a mamba2 mixer (``hybrid``), whose recurrent state the ring-cache
modes carry and the paged modes refuse.

Entry points: :func:`forward` (cache-less; training's, with the MoE
aux loss and per-layer remat), the one-shot and stepped
modes over the ring cache (:func:`make_cache`, :func:`prefill`,
:func:`decode_step`), continuous serving over the paged cache
(:func:`paged_step`, :func:`paged_decode_loop`, and
:func:`paged_verify` for speculative decoding), and the paged cache's
snapshot hooks (:func:`paged_cache_template`, :func:`export_decode_state`,
:func:`restore_decode_state`).

Parameters are ``{"embed": {"w"}, "layers": [per-layer dict, ...],
"final_norm": {"scale"}, "lm_head": {...}}`` — the reference's tree with
its stacked ``[L, ...]`` layer axis unstacked into a list
(``convert.params_from_numpy``), so the layer loop is a Python loop.
Both caches are written in place (``models/attention.py``,
``models/ssm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sampling import sample_or_greedy
from repro_torch.models import attention, blocks, rope, ssm
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import ring_layer
from repro_torch.models.common import (
    DATA,
    MODEL,
    checkpointed,
    dtype_of,
    linear,
    linear_specs,
    make_linear_by_columns,
    make_norm,
    norm_specs,
    pack_linear_params,
    rmsnorm,
)
from repro_torch.sharding.context import get_context
from repro_torch.sharding.partition import P


# the families this decoder-only LM serves; encdec runs through encdec.py
LM_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
# families with recurrent state: no exact one-shot fill, no paged state
RECURRENT_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family in LM_FAMILIES:
        return
    if cfg.family == "encdec":
        raise NotImplementedError(
            "family 'encdec' is not served by the decoder-only LM: drive it through "
            "repro_torch.models.encdec (encode, forward, decode_step)"
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported: the reference has no such family "
        f"(the LM serves {LM_FAMILIES}; encdec runs through models/encdec.py)"
    )


def init_params(cfg, generator: torch.Generator, device, wire_dtype: Optional[str] = "int8"):
    """Seeded random parameters with ``lm.init_lm``'s scale rules: linears
    ``N(0, 1/d_in)``, embedding ``N(0, 0.02^2)``, norms one, biases zero;
    a mamba2 mixer's own rules (``ssm.make_mamba2``).  An ``ssm`` layer is
    ``{"mixer", "ln"}``; every other family's a decoder block
    (``blocks.make_decoder_block``).

    With ``wire_dtype="int8"`` or ``"native"`` every DBB-eligible linear
    is packed to that wire as soon as it is drawn, layer by layer, so the
    dense model never sits on the device whole (16.7 GB in bf16 for
    granite-3-8b); MLA's ``kv_up``, the MoE router and the experts stay
    dense, as serving needs them.  ``None`` returns the dense parameters.
    An untied head is drawn in f32 a slice of columns at a time into its
    dtype (``common.make_linear_by_columns``), so the whole f32 head never
    exists beside the packed layers."""
    _check_family(cfg)
    dtype = dtype_of(cfg.dtype)
    sp = cfg.sparsity

    def pack(p):
        if wire_dtype is not None and p["w"].shape[0] % sp.bz == 0:
            return pack_linear_params(p, sp, wire_dtype)
        return p

    d = cfg.d_model
    emb = torch.randn((cfg.padded_vocab, d), generator=generator, device=device)
    params = {"embed": {"w": emb.mul_(0.02).to(dtype)}, "layers": []}
    del emb  # the f32 draw (4.98 GB at qwen1.5-110b's 152064 x 8192) is gone before the layers
    for _ in range(cfg.n_layers):
        if cfg.family == "ssm":
            layer = {"mixer": ssm.make_mamba2(generator, cfg, dtype=dtype, device=device,
                                              pack=pack),
                     "ln": make_norm(d, device=device)}
        else:
            layer = blocks.make_decoder_block(generator, cfg, dtype=dtype, device=device,
                                              pack=pack)
        params["layers"].append(layer)
    params["final_norm"] = make_norm(d, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = pack(make_linear_by_columns(generator, d, cfg.padded_vocab,
                                                        dtype=dtype, device=device))
    return params


def param_specs(cfg) -> dict:
    """The spec intent of every leaf of :func:`init_params`'s dense tree:
    the reference's ``init_lm`` specs with each layer's stacked spec
    unstacked (its leading ``None`` layer axis dropped), one per entry of
    ``"layers"``.  The embedding shards ``d_model`` (vocabularies rarely
    divide the model axis)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        layer = {"mixer": ssm.mamba2_specs(), "ln": norm_specs()}
    else:
        layer = blocks.decoder_block_specs(cfg)
    specs = {"embed": {"w": P(None, MODEL)}, "layers": [layer] * cfg.n_layers,
             "final_norm": norm_specs()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = linear_specs(P(DATA, MODEL))
    return specs


def local_specs(cfg) -> dict:
    """What each rank holds of the params under a context, as a prefix
    spec tree for ``partition.local_tree``: every leaf whole but the MoE
    experts, each rank's ``E / n`` slice of the model axis (the
    expert-parallel region's in-specs)."""
    if cfg.moe is None:
        return {}
    return {"layers": [{"moe": moe_mod.expert_local_specs()}] * cfg.n_layers}


def _rope_cs(cfg, positions, pos3=None):
    """cos/sin shared by every layer: M-RoPE over ``pos3 [3, B, S]`` when
    the config has sections, standard RoPE over ``positions`` otherwise."""
    dh = cfg.head_dim()
    if cfg.m_rope_sections is not None and pos3 is not None:
        return rope.mrope_cos_sin(pos3, dh, cfg.rope_theta, cfg.m_rope_sections)
    return rope.rope_cos_sin(positions, dh, cfg.rope_theta)


def _embed(params, tokens):
    return F.embedding(tokens.long(), params["embed"]["w"])


def _head(params, x, cfg):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        return torch.matmul(x, w.to(x.dtype).t())
    # the sparsity config rides along for its quantization knobs only
    # (dap_input=False): the int8 head keeps per-row activation scales
    return linear(params["lm_head"], x, sparsity=cfg.sparsity, dap_input=False)


def forward(params, tokens, cfg, *, positions=None, pos3=None, patch_embeds=None,
            with_aux: bool = False):
    """Full-sequence cache-less forward (training, one-shot prefill):
    ``tokens [B, S]`` -> logits ``[B, S', V_padded]``, or with
    ``with_aux`` the reference's ``(logits, aux)``, ``aux`` the MoE
    load-balance loss summed over the layers (f32 zero without MoE).

    ``positions [B, S']`` default to ``0..S'-1``; ``pos3 [3, B, S']`` are
    the VLM's M-RoPE streams (standard RoPE over ``positions`` without
    them); ``patch_embeds [B, S_vis, d]`` (the VLM's stubbed vision
    frontend) are concatenated before the token embeddings, so ``S' =
    S_vis + S``.  While a gradient is taken every layer is checkpointed
    as ``cfg.remat`` says (``models.common.checkpointed``)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        def ssm_layer(h, layer_p):
            return h + ssm.mamba2_forward(layer_p["mixer"], rmsnorm(h, layer_p["ln"], cfg.norm_eps),
                                          cfg)

        for layer_p in params["layers"]:
            x = checkpointed(ssm_layer, cfg.remat, x, layer_p)
    else:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        rope_cs = None if cfg.mla is not None else _rope_cs(cfg, positions, pos3)

        def layer(h, layer_p):
            return blocks.decoder_block(layer_p, h, cfg, positions, rope_cs=rope_cs,
                                        with_aux=True)

        for layer_p in params["layers"]:
            x, layer_aux = checkpointed(layer, cfg.remat, x, layer_p)
            aux = aux + layer_aux
    logits = _head(params, x, cfg)
    return (logits, aux) if with_aux else logits


def make_cache(cfg, batch: int, max_seq: int, device):
    """The stacked ring cache ``k/v [L, B, W, D]``, ``pos [L, B, W]`` for
    ``max_seq`` positions (``W = min(max_seq, window)`` under a sliding
    window).  Under the int8 KV wire the planes are int8 with per-token
    ``k_scale/v_scale [L, B, W]`` f32 planes; empty slots hold zeros with
    scale 1.0.  MLA caches the latent in k, a 1-wide dummy in v, and
    quantizes only k.  An ``ssm`` cache is the mixer's ``state [L, B, H,
    P, N]`` (f32) and ``conv [L, B, K-1, C]``; a hybrid's adds them to the
    ring as ``ssm_state``/``ssm_conv``.  An encdec cache is its decoder's
    self-attention ring.

    Under a distribution context whose flash-decode guard holds
    (``attention.window_shards``: GQA, native KV, the window and the
    batch dividing over the mesh) the ring is this rank's shard ``k/v [L,
    B / n_batch, W / n_model, D]`` (an ``attention.ShardedRing``; a
    hybrid's recurrent planes stay whole), decided here once: prefill
    fills the shard and decode runs ``attention.flash_decode``."""
    if cfg.family != "encdec":  # encdec.decode_step runs over this ring
        _check_family(cfg)
    native = dtype_of(cfg.dtype)
    if cfg.family == "ssm":
        return ssm.make_ssm_cache(batch, cfg, cfg.n_layers, native, device)
    window = max_seq if cfg.sliding_window is None else min(max_seq, cfg.sliding_window)
    kv_int8 = cfg.sparsity.kv_dtype == "int8"
    v_int8 = kv_int8 and cfg.mla is None
    kv_dim = cfg.kv_dim()
    v_dim = 1 if cfg.mla is not None else kv_dim
    ctx = get_context()
    sharded = attention.window_shards(cfg, ctx, batch, window)
    if sharded:
        lbw = (cfg.n_layers, batch // ctx.size(ctx.batch_axes),
               window // ctx.size(ctx.expert_axis))
    else:
        lbw = (cfg.n_layers, batch, window)
    cache = {
        "k": torch.zeros(lbw + (kv_dim,), dtype=torch.int8 if kv_int8 else native,
                         device=device),
        "v": torch.zeros(lbw + (v_dim,), dtype=torch.int8 if v_int8 else native,
                         device=device),
        "pos": torch.full(lbw, -1, dtype=torch.int32, device=device),
    }
    if kv_int8:
        cache["k_scale"] = torch.ones(lbw, dtype=torch.float32, device=device)
    if v_int8:
        cache["v_scale"] = torch.ones(lbw, dtype=torch.float32, device=device)
    if cfg.family == "hybrid":
        rec = ssm.make_ssm_cache(batch, cfg, cfg.n_layers, native, device)
        cache["ssm_state"], cache["ssm_conv"] = rec["state"], rec["conv"]
    return attention.ShardedRing(cache, ctx) if sharded else cache


def cache_specs(cfg) -> dict:
    """The spec intent of :func:`make_cache`'s planes (stacked ``[L,
    ...]``, as the reference's ``cache_specs``): the GQA ring's window
    over ``model`` (the sequence-parallel ``flash_decode``), MLA's latent
    over its latent dim, the int8 KV wire's scale planes as the slot
    positions, the recurrent state's batch over ``data``."""
    if cfg.family == "ssm":
        return ssm.ssm_cache_specs()
    if cfg.mla is None:
        out = {"k": P(None, DATA, MODEL, None), "v": P(None, DATA, MODEL, None),
               "pos": P(None, DATA, MODEL)}
    else:
        out = {"k": P(None, DATA, None, MODEL), "v": P(None, DATA, None, None),
               "pos": P(None, DATA, None)}
    if cfg.sparsity.kv_dtype == "int8":
        out["k_scale"] = out["pos"]
        if cfg.mla is None:
            out["v_scale"] = out["pos"]
    if cfg.family == "hybrid":
        s = ssm.ssm_cache_specs()
        out["ssm_state"], out["ssm_conv"] = s["state"], s["conv"]
    return out


def decode_step(params, cache, tokens, pos: int, cfg):
    """One decode step over the ring cache: ``tokens [B, 1]`` at position
    ``pos`` (every row).  Returns ``(logits [B, 1, V_padded], cache)``;
    the cache is written in place."""
    _check_family(cfg)
    b = tokens.shape[0]
    x = _embed(params, tokens)
    if cfg.family == "ssm":
        for i, layer_p in enumerate(params["layers"]):
            h = rmsnorm(x, layer_p["ln"], cfg.norm_eps)
            x = x + ssm.mamba2_forward(layer_p["mixer"], h, cfg, cache_layer=ring_layer(cache, i))
        return _head(params, x, cfg), cache
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    rope_cs = None
    if cfg.mla is None:
        pos3 = positions[None].expand(3, b, 1) if cfg.m_rope_sections is not None else None
        rope_cs = _rope_cs(cfg, positions, pos3)
    for i, layer_p in enumerate(params["layers"]):
        x = blocks.decoder_block(layer_p, x, cfg, positions, cache_layer=ring_layer(cache, i),
                                    decode_pos=pos, rope_cs=rope_cs)
    return _head(params, x, cfg), cache


def prefill(params, tokens, cfg, cache=None):
    """One-shot prefill of ``tokens [B, S]`` at positions ``0..S-1``: the
    logits, and with ``cache`` the filled ring too (``(logits, cache)``).
    Single pass: each attention layer attends over the fresh K/V and
    writes them into its ring in the same call, bytes equal to what
    per-token stepping writes.  The recurrent state has no exact one-shot
    fill: an ``ssm`` cache stays as it was (zero), a hybrid's attention
    ring fills and its ``ssm_state``/``ssm_conv`` stay untouched (engines
    serve both families stepped)."""
    if cache is None or cfg.family == "ssm":
        logits = forward(params, tokens, cfg)
        return logits if cache is None else (logits, cache)
    _check_family(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    # the reference's prefill passes no M-RoPE streams: text positions
    rope_cs = None if cfg.mla is not None else _rope_cs(cfg, positions)
    for i, layer_p in enumerate(params["layers"]):
        x = blocks.decoder_block(layer_p, x, cfg, positions, cache_layer=ring_layer(cache, i),
                                    rope_cs=rope_cs)
    return _head(params, x, cfg), cache


def _prepare_pages(cache, scrub_pages=None, cow_pages=None) -> None:
    """Page maintenance before a step's writes, in place and in order:
    scrub freshly allocated pages' slot positions, then copy every plane
    (and the slot positions) of each copy-on-write ``(src, dst)`` pair."""
    if scrub_pages is not None:
        cache["pos"][scrub_pages.long()] = -1
    if cow_pages is not None:
        src, dst = cow_pages[:, 0].long(), cow_pages[:, 1].long()
        for name, val in cache.items():
            if name != "pos":
                val[:, dst] = val[:, src]
        cache["pos"][dst] = cache["pos"][src]


def paged_step(params, cache, tokens, positions, page_tables, cfg,
               scrub_pages=None, cow_pages=None):
    """One continuous-batching step: ``tokens/positions [B, S]`` is a mixed
    batch (chunked prefill rows, decode rows, padding at position -1) over
    per-row page tables ``[B, P]``.  Returns ``(logits [B, S, V_padded],
    cache)``; the cache is updated in place.  The recurrent families have
    no paged state: they raise ``ValueError``."""
    _check_family(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"paged_step unsupported for recurrent family {cfg.family!r}: "
            "only attention state pages (see serve/scheduler.py)"
        )
    x = _embed(params, tokens)
    pos3 = None
    if cfg.m_rope_sections is not None:
        # text tokens: the three M-RoPE streams are equal
        pos3 = positions[None].expand(3, *positions.shape)
    rope_cs = None  # MLA rotates its own qk_rope dims in the layer
    if cfg.mla is None:
        rope_cs = _rope_cs(cfg, positions, pos3)
    _prepare_pages(cache, scrub_pages, cow_pages)
    # one shared slot-position write for the whole stack, before the
    # layers, so this step's tokens are visible to intra-chunk attention
    attention.paged_update_pos(cache["pos"], positions, page_tables)
    planes = [n for n in ("k", "v", "k_scale", "v_scale") if n in cache]
    for i, layer_p in enumerate(params["layers"]):
        cache_layer = {n: cache[n][i] for n in planes}
        cache_layer["pos"] = cache["pos"]
        x = blocks.decoder_block(
            layer_p, x, cfg, positions, cache_layer=cache_layer,
            rope_cs=rope_cs, page_tables=page_tables,
        )
    return _head(params, x, cfg), cache


def paged_decode_loop(params, cache, tokens, positions, page_tables, n_steps: int,
                      cfg, *, max_steps: int, scrub_pages=None, cow_pages=None,
                      sampling: Optional[tuple] = None):
    """``n_steps`` decode iterations of :func:`paged_step`, each sampled
    token fed back as the next input, without a host sync: the loop only
    enqueues device work, and the caller reads the results once per run.
    ``sampling`` is the rows' ``(temps, top_ks, top_ps, seeds)`` on the
    device (None: every row greedy, decided on the host); each sample is keyed on the pre-increment ``pos`` carry,
    the fed-stream position of the token whose logits it reads.

    ``tokens [B, 1]`` holds each row's last sampled token, ``positions
    [B]`` its first write position (-1: idle row, which keeps feeding
    token 0 at position -1 like the mixed step's padding).  Returns
    ``(sampled [B, max_steps] int32, bad_at [B] int32, cache)``: ``bad_at``
    is the first iteration whose raw logits held a non-finite value on an
    active row (``max_steps`` when clean).  The recurrent families raise
    ``ValueError``, as :func:`paged_step` does."""
    _check_family(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"paged_decode_loop unsupported for recurrent family {cfg.family!r}: "
            "only attention state pages"
        )
    _prepare_pages(cache, scrub_pages, cow_pages)
    b = tokens.shape[0]
    v = cfg.vocab  # slice off vocab padding before sampling
    dev = tokens.device
    out = torch.zeros((b, max_steps), dtype=torch.int32, device=dev)
    bad_at = torch.full((b,), max_steps, dtype=torch.int32, device=dev)
    toks, pos = tokens, positions
    for i in range(n_steps):
        logits, cache = paged_step(params, cache, toks, pos[:, None], page_tables, cfg)
        row = logits[:, 0, :v]
        nxt = sample_or_greedy(row, sampling, pos)
        out[:, i] = nxt
        active = pos >= 0
        bad = active & ~torch.isfinite(row).all(dim=-1)
        bad_at = torch.where(bad & (bad_at == max_steps), torch.full_like(bad_at, i), bad_at)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        pos = torch.where(active, pos + 1, pos)
        toks = nxt[:, None]
    return out, bad_at, cache


def paged_verify(params, cache, tokens, positions, page_tables, cfg,
                 sampling: Optional[tuple] = None):
    """Speculative-decode verification in one pass over the paged cache.

    ``tokens/positions [B, S]`` hold each row's candidate fed stream of one
    window: its last committed token, then the draft's proposals, at
    consecutive positions (-1 past the window).  One :func:`paged_step`
    under the target config recomputes every window position, each layer
    writing its window K/V before it attends, so whatever the draft wrote
    at those slots is overwritten; then a token is sampled at every index,
    each row's knobs repeated ``S`` times and keyed on that index's own
    fed-stream position.  Index ``j`` is the token solo decode emits after
    the row's stream extended by proposals ``1..j``.  ``sampling`` is the
    rows' device knobs, or None when every row is greedy (decided on the
    host).  Returns ``(sampled [B, S] int32, ok [B, S] bool, cache)``;
    ``ok`` says whether an index's raw logits were all finite."""
    b, s = tokens.shape
    v = cfg.vocab  # slice off vocab padding before sampling
    logits, cache = paged_step(params, cache, tokens, positions, page_tables, cfg)
    rows = logits[:, :, :v].reshape(b * s, v)
    if sampling is not None:
        sampling = tuple(a.repeat_interleave(s) for a in sampling)
    tok = sample_or_greedy(rows, sampling, positions.reshape(-1))
    ok = torch.isfinite(rows).all(dim=-1)
    return tok.reshape(b, s), ok.reshape(b, s), cache


# -- the paged cache's snapshot hooks: a snapshot stores the device layout
# as it is (int8 KV planes at wire size), nothing is re-quantized


def paged_cache_template(cfg, n_pages: int, page_size: int):
    """The paged cache's shapes and dtypes as ``"meta"`` tensors: the
    tree a restorer hands to ``checkpoint.manager.restore`` without
    allocating memory."""
    from repro_torch.serve.paged_cache import make_paged_cache

    return make_paged_cache(cfg, n_pages, page_size, "meta")


def export_decode_state(cache):
    """Device cache -> host copies, dtype-preserving (int8 planes stay
    int8, bf16 planes bf16)."""
    return {name: t.detach().to("cpu", copy=True) for name, t in cache.items()}


def restore_decode_state(host_cache, device):
    """Host cache (tensors or numpy arrays) -> device tensors; the inverse
    of :func:`export_decode_state`."""
    return {name: torch.as_tensor(a).to(device).contiguous() for name, a in host_cache.items()}
