"""Shared set-up of the ``test_torch_*`` parity suite: the same small
configuration of any ported arch (granite-3-8b, minicpm3-4b for MLA,
granite-moe-1b-a400m for MoE, qwen2-vl-72b for M-RoPE, ...) for the JAX
reference and the PyTorch port, weights drawn once by the reference and
converted bit for bit (with seeded non-zero biases where the arch has
them), and the engine's effective sparsity settings on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

# the small_cfg of tests/test_serve.py: 2 layers, narrow widths, f32
SMALL = dict(vocab=64, d_model=64, d_ff=128, n_layers=2, dtype="float32")
# the port's paged read on the fused kernel (#6's plain version on the CPU),
# named: "auto" resolves to the gather path on the CPU, as the reference's
# does, so a port test of the fused path asks for it
FUSED = dict(paged_attn="fused")


def small_cfgs(arch="granite_3_8b", **over):
    kw = dict(SMALL, **over)
    if arch == "qwen2_vl_72b" and "d_model" not in over:
        # the smoke's M-RoPE sections (8, 4, 4) need head_dim 32, as in
        # the reference's own small_cfg (tests/test_serve.py)
        kw["d_model"] = 128
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw)
    return jcfg, tcfg


def check_config_fields(arch, smoke):
    """Every field of the port's config equals the reference's, the
    nested sparsity, MLA, MoE and SSM configs field for field."""
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    for f in dataclasses.fields(tcfg):
        if f.name in ("sparsity", "mla", "moe", "ssm"):
            continue
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(tcfg.sparsity):
        assert getattr(tcfg.sparsity, f.name) == getattr(jcfg.sparsity, f.name), f.name
    for sub in ("mla", "moe", "ssm"):
        tsub, jsub = getattr(tcfg, sub), getattr(jcfg, sub)
        assert (tsub is None) == (jsub is None), sub
        if tsub is not None:
            assert [f.name for f in dataclasses.fields(tsub)] == [
                f.name for f in dataclasses.fields(jsub)
            ]
            for f in dataclasses.fields(tsub):
                assert getattr(tsub, f.name) == getattr(jsub, f.name), f"{sub}.{f.name}"
    assert (tcfg.head_dim(), tcfg.padded_vocab, tcfg.kv_dim()) == (
        jcfg.head_dim(), jcfg.padded_vocab, jcfg.kv_dim()
    )
    if tcfg.ssm is not None:
        d = tcfg.d_model
        assert (tcfg.ssm.d_inner(d), tcfg.ssm.n_heads(d)) == (jcfg.ssm.d_inner(d),
                                                               jcfg.ssm.n_heads(d))


def effective(jcfg, tcfg, kv_dtype="native", wire="int8"):
    """The configs the engines serve with: the chosen KV dtype, per-row
    activation scales on the int8 wire (the native wire quantizes no
    activation), the reference on the gather paged-attention path and the
    port on the fused kernel's plain version, by name (``FUSED``)."""
    scale = "per_row" if wire == "int8" else jcfg.sparsity.act_scale
    jsp = dataclasses.replace(
        jcfg.sparsity, act_scale=scale, kv_dtype=kv_dtype, paged_attn="gather"
    )
    tsp = dataclasses.replace(tcfg.sparsity, act_scale=scale, kv_dtype=kv_dtype, **FUSED)
    return (
        dataclasses.replace(jcfg, sparsity=jsp),
        dataclasses.replace(tcfg, sparsity=tsp),
    )


def nonzero_biases(tree, seed):
    """``tree`` (numpy leaves) with every ``"b"`` leaf replaced by seeded
    normal values of its shape and dtype: both inits draw biases as
    zeros, which would hide a bias fault in the matmul epilogues or the
    packed-linear plumbing."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.normal(size=v.shape).astype(v.dtype) if k == "b" else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(tree)


def reference_params(jcfg, seed=0, bias_seed=None):
    """(JAX params, the same params converted for the port); with
    ``bias_seed`` every bias is drawn non-zero, the same on both sides."""
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    if bias_seed is not None:
        np_params = nonzero_biases(np_params, bias_seed)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, "cpu")
    return params, tparams


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def reference_tree(tparams):
    """The port's parameter tree (raw or wire-packed) -> the reference's,
    numpy leaves, bit for bit: the inverse of ``params_from_numpy``, the
    per-layer list stacked back into ``[L, ...]`` leaves (bfloat16 as
    ml_dtypes arrays through a ``uint16`` view)."""
    import ml_dtypes

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return to_np(t.view(torch.uint16)).view(ml_dtypes.bfloat16)
        return to_np(t)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return np.stack([leaf(t) for t in layers])

    return {k: stack(v) if isinstance(v, list) else walk(v) for k, v in tparams.items()}


def leaves(tree, prefix=""):
    """``(path, leaf)`` pairs of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# the continuous-batching case of tests/test_serve.py: prompts of lengths
# 9, 5 and 12, arrivals [0, 3, 1], max_batch=2, page_size=8, chunk 4
SERVE = dict(max_seq=32, page_size=8, max_batch=2, prefill_chunk=4)
# the port's continuous packed path, named (ServeConfig's defaults are the
# reference's: dense weights, prefill_mode "auto")
PACKED = dict(prefill_mode="continuous", pack_weights=True)
LENS, ARRIVALS, N_NEW = (9, 5, 12), [0, 3, 1], 6


def prompts_for(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in LENS]


def replay_logits(jeng, teng, jcfg, tcfg, outs, n_new):
    """Both engines' packed weights replay every request's fed stream in
    one paged step (one row per request, padded with position -1);
    asserts each served token is its row's argmax and returns the logits
    of the positions that chose a token, ``(port, reference)``.  Under
    MoE a token's output depends on its co-batch (expert capacity), so
    the replay, batched unlike the served steps, is compared only port
    against reference at its own shapes."""
    fed = [w[:-1] for w in outs]
    s = max(len(f) for f in fed)
    b, ps = len(fed), jeng.scfg.page_size
    per = -(-s // ps)
    toks = np.zeros((b, s), np.int32)
    pos = np.full((b, s), -1, np.int32)
    for i, f in enumerate(fed):
        toks[i, : len(f)] = f
        pos[i, : len(f)] = np.arange(len(f))
    tables = (1 + np.arange(b * per, dtype=np.int32)).reshape(b, per)
    jl, _ = jlm.paged_step(
        jeng.params, jpc.make_paged_cache(jcfg, b * per + 1, ps), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(tables), jcfg,
    )
    tl, _ = tlm.paged_step(
        teng.params, tpc.make_paged_cache(tcfg, b * per + 1, ps, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(pos), torch.from_numpy(tables), tcfg,
    )
    jl, tl = np.array(jl), to_np(tl)
    got, want = [], []
    for i, w in enumerate(outs):
        chose = slice(len(w) - n_new - 1, len(w) - 1)
        got.append(tl[i, chose, : tcfg.vocab])
        want.append(jl[i, chose, : jcfg.vocab])
        if jcfg.moe is None:
            np.testing.assert_array_equal(got[-1].argmax(-1), w[len(w) - n_new:])
    return np.concatenate(got), np.concatenate(want)


def engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype, serve=SERVE):
    """The port's engine (on the CPU) vs the reference's continuous engine
    (gather path) on the same prompts: greedy tokens equal on this pinned
    seed, logits within 1e-4 at every position that chose a token (ULP
    differences between XLA and ATen could flip a near-tied argmax on
    other seeds).  Returns the port's kernel counters of the serve."""
    prompts = prompts_for(jcfg.vocab)
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(
        prefill_mode="continuous", pack_weights=True, wire_dtype=wire,
        kv_dtype=kv_dtype, paged_attn="gather", **serve,
    ))
    want = jeng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        wire_dtype=wire, kv_dtype=kv_dtype, **PACKED, **FUSED, **serve), device="cpu")
    ops.reset_counters()
    got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    counts = {k: (c.launches, c.plain) for k, c in ops.counters().items()}
    assert [r.finish_reason for r in teng.last_results] == ["length"] * len(prompts)
    assert all(launches == 0 for launches, _ in counts.values())
    jcfg_e, tcfg_e = effective(jcfg, tcfg, kv_dtype, wire)
    tl, jl = replay_logits(jeng, teng, jcfg_e, tcfg_e, want, N_NEW)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")
    return counts


def invariants_byte_exact(tcfg, tparams, wire, kv_dtype, serve=SERVE):
    """The port's own invariants, byte for byte: continuous == each
    request served alone, ``decode_block=1`` == 16, and a call that
    reuses cached prompt pages == the cold call.  Returns the kernel
    counters of the first serve and its engine."""
    prompts = prompts_for(tcfg.vocab)

    def eng(**kw):
        scfg = tengine.ServeConfig(**{**PACKED, **FUSED, **serve, "wire_dtype": wire,
                                      "kv_dtype": kv_dtype,
                                      **kw})
        return tengine.Engine(tparams, tcfg, scfg, device="cpu")

    ops.reset_counters()
    main = eng(prefix_cache=False)
    outs = main.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    counts = {k: (c.launches, c.plain) for k, c in ops.counters().items()}
    for i, p in enumerate(prompts):
        solo = eng().generate_requests([p], N_NEW)
        np.testing.assert_array_equal(outs[i], solo[0], err_msg=f"request {i} solo")
    one = eng(decode_block=1, prefix_cache=False)
    for a, b in zip(outs, one.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)):
        np.testing.assert_array_equal(a, b)
    assert main.decode_run_calls > 0 and one.step_calls > main.step_calls
    warm = eng()
    long_prompt = np.concatenate([prompts[2], prompts[0]])[:20]
    cold = warm.generate_requests([long_prompt], N_NEW)
    again = warm.generate_requests([long_prompt], N_NEW)
    assert warm.prefix_stats()["page_hits"] > 0
    np.testing.assert_array_equal(again[0], cold[0])
    return counts, main


# the one-shot case of tests/test_serve.py: 2 prompts of 8 tokens, 8 new
GEN_B, GEN_S0, GEN_NEW, GEN_MAX_SEQ = 2, 8, 8, 48


def gen_prompts(vocab, b=GEN_B, s0=GEN_S0, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s0)).astype(np.int32)


def generate_match(jcfg, tcfg, params, tparams, wire, kv_dtype, mode, **samp):
    """``Engine.generate`` of the port (CPU) against the reference's in
    ``mode`` ("batched" or "stepped") on packed weights: tokens equal on
    these pinned cases.  Returns the port's tokens and engine."""
    kw = dict(max_seq=GEN_MAX_SEQ, prefill_mode=mode, pack_weights=True, wire_dtype=wire,
              kv_dtype=kv_dtype, **samp)
    prompts = gen_prompts(jcfg.vocab)
    want = jengine.Engine(params, jcfg, jengine.ServeConfig(**kw)).generate(prompts, GEN_NEW)
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw), device="cpu")
    ops.reset_counters()
    got = teng.generate(prompts, GEN_NEW)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert teng.prefill_calls == (1 if mode == "batched" else GEN_S0)
    assert teng.decode_calls == GEN_NEW
    assert all(c.launches == 0 for c in ops.counters().values())
    return got, teng


# speculative decoding: the serve shape of tests/test_spec_decode.py
# (max_seq 48) over this suite's prompts and arrivals, 10 new tokens
SPEC_SERVE = dict(max_seq=48, page_size=8, max_batch=2, prefill_chunk=4)
SPEC_NEW = 10


def spec_match(jcfg, tcfg, params, tparams, wire, kv_dtype, draft, **samp):
    """One cell of the speculative matrix: the port's spec engine (CPU)
    serves the tokens of the port's plain continuous engine and of the
    reference's spec engine (gather path), with the reference's
    ``spec_stats()``.  Returns the port's spec engine."""
    prompts = prompts_for(jcfg.vocab)
    kw = dict(SPEC_SERVE, **PACKED, wire_dtype=wire, kv_dtype=kv_dtype, **samp)
    jspec = jengine.SpecConfig(draft=draft, draft_nnz=2)
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(paged_attn="gather", spec=jspec,
                                                            **kw))
    want = jeng.generate_requests(prompts, SPEC_NEW, arrivals=ARRIVALS)
    plain = tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw, **FUSED), device="cpu"
                           ).generate_requests(prompts, SPEC_NEW, arrivals=ARRIVALS)
    teng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        spec=tengine.SpecConfig(draft=draft, draft_nnz=2), **kw, **FUSED), device="cpu")
    got = teng.generate_requests(prompts, SPEC_NEW, arrivals=ARRIVALS)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], plain[i], err_msg=f"request {i}: spec != plain")
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}: != reference")
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.spec_stats()["spec_runs"] > 0 and teng.paged_compiles == 3
    return teng


def chip_smoke_module():
    """``chip_smoke.py`` as a module (its launch-count tables and rules)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stepped_plain_calls(tcfg, tparams, wire, kv_dtype):
    """A small stepped engine's plain-version calls by kernel over one
    ``generate`` (2 prompts of 6 tokens, 3 new) and its number of passes:
    what ``chip_smoke.recurrent_launches`` predicts a pass."""
    eng = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        max_seq=16, pack_weights=True, wire_dtype=wire, kv_dtype=kv_dtype), device="cpu")
    ops.reset_counters()
    eng.generate(gen_prompts(tcfg.vocab, b=2, s0=6), 3)
    return {name: c.plain for name, c in ops.counters().items()}, eng
