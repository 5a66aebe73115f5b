"""The bf16 gate's cases, run in a subprocess of their own
(``tests/test_torch_bf16_gate.py``; ``scripts/bf16_gate_departures.py``).

For one arch's cases: the reference draws the weights once (its init
jitted, every bias seeded non-zero), the port packs them (bit for bit
the reference's eager packing: ``tests/test_torch_core.py``) and
``reference_tree`` carries the packed bytes back, so both sides serve the
same weights.  Each case then runs ``paged_step`` teacher-forced on three
sides: the reference in bf16, the reference on the same weights cast to
f32, and the port (CPU) in bf16, all fed the reference's bf16 greedy
tokens: a prefill of two prompts (13 and 10 tokens) in two 8-token
chunks, then 8 decode steps; every step is a mixed step of 8 columns, as
the engine's are (a decode row carries its token and 7 padding slots).

The reference runs in a process of its own because the gate holds the
port to the reference's program as written, each bf16 operation rounded
and each division a division (its eager execution), and by default XLA's
jit keeps bf16 intermediates of a fusion in f32
(``--xla_allow_excess_precision``) and its algebraic simplifier turns a
division by a constant into a multiply (``NO_SIMPLIFY``), both
process-wide flags: the runner sets them as it is told, and the caller
chooses, as it does LLVM's optimizations (off by default,
``FAST_COMPILE``).  Compiled so, the reference's bf16 logits equal the
port's bit for bit in every case.

The families' cases (``tests/test_torch_bf16_gate_families.py``,
``FAMILY_CASES``) run the same three sides through the other serving
paths: the recurrent archs' chunked ``lm.forward`` over a prompt, then
``lm.decode_step`` stepped through it and 8 decodes over the ring
(:func:`teacher_forced_ring`); whisper's ``encode``, then its
``decode_step``; and unpacked weights (``wire`` ``"unpacked"``, the
reference's default serve: dense weights, DAP on the activations), on
``paged_step`` or whisper's decode.  The training cases
(``tests/test_torch_bf16_train_gate.py``, ``TRAIN_CASES``) run one
``train_step`` on each side (:func:`run_train`).

Run as ``python tests/_torch_bf16_gate.py OUT.npz [--eager] CASE ...``
with ``CASE`` ``arch:wire:kv`` (``wire`` ``"train"`` for a training
case) and ``src`` and ``tests`` on ``PYTHONPATH``: writes
``{case}/port``, ``/ref_bf16`` and ``/ref_f32``, the logits
``[positions, vocab]`` at every valid position in step order (a training
case: ``{case}/{side}/loss``, ``/logits`` and ``/grad/{leaf path}``).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ARCHS = ("granite_3_8b", "minicpm3_4b", "granite_moe_1b_a400m", "qwen2_vl_72b",
         "starcoder2_15b", "phi3_5_moe_42b_a6_6b", "qwen1_5_110b")
# (wire, KV dtype): both int8 and both native for every arch, the mixed
# pairs for granite (GQA) and minicpm3 (the MLA latent cache)
CASES = ([(a, "int8", "int8") for a in ARCHS] + [(a, "native", "native") for a in ARCHS]
         + [(a, w, kv) for a in ("granite_3_8b", "minicpm3_4b")
            for w, kv in (("int8", "native"), ("native", "int8"))])
# the families' cases: the recurrent archs and whisper on both wires
# (hymba's attention ring on both KV dtypes), and unpacked weights on a
# gelu arch (starcoder2: gelu MLP, QKV bias, sliding window) and whisper
FAMILY_CASES = [("mamba2_130m", "int8", "native"), ("mamba2_130m", "native", "native"),
                ("hymba_1_5b", "int8", "int8"), ("hymba_1_5b", "native", "native"),
                ("whisper_base", "int8", "native"), ("whisper_base", "native", "native"),
                ("starcoder2_15b", "unpacked", "native"), ("whisper_base", "unpacked", "native")]
# one bf16 training step: what the card trains, and gelu's backward
TRAIN_CASES = [("granite_moe_1b_a400m", "train", "native"), ("starcoder2_15b", "train", "native")]
# windows that bite in the gate's prompts
OVERRIDES = {"starcoder2_15b": dict(sliding_window=6), "hymba_1_5b": dict(sliding_window=8)}
BIAS_SEED = 11
LENS, CHUNK, N_DECODE, PS = (13, 10), 8, 8, 8
KERNEL_TOL = 2e-2  # tests/test_kernels.py: the reference's bf16 kernel tolerance
NO_EXCESS = "--xla_allow_excess_precision=false"
# XLA's algebraic simplifier off: it folds a division by a constant into a
# multiply by the reciprocal (``amax / 127`` in ``core/quant.py``), one f32
# ulp off on about 5% of the scales; without it the jitted step divides
NO_SIMPLIFY = "--xla_disable_hlo_passes=algsimp"
# LLVM's optimizations off: a step's program compiles in half the time
# (the reference's floating-point operations are the same without fast
# math; its f32 dots then sum in the port's order at minicpm3's latent
# attention, where the optimized build's vectorized order differs,
# scripts/bf16_gate_departures.py)
FAST_COMPILE = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def case_key(arch, wire, kv_dtype):
    return f"{arch}:{wire}:{kv_dtype}"


def gate_report(got, want, want32):
    """The gate on one case's logits: ``(|port - ref_bf16|, bound,
    |ref_bf16 - ref_f32|, the positions whose tokens are compared)``, the
    bound ``max(|ref_bf16 - ref_f32|, KERNEL_TOL * max|ref_f32|)`` and a
    position compared where its top two reference logits are more than
    twice the bound apart."""
    ref_gap = float(np.abs(want - want32).max())
    bound = max(ref_gap, KERNEL_TOL * float(np.abs(want32).max()))
    top2 = np.sort(want, axis=-1)[:, -2:]
    return float(np.abs(got - want).max()), bound, ref_gap, (top2[:, 1] - top2[:, 0]) > 2 * bound


def prefill_steps(vocab):
    """The two prefill chunks ``(tokens, positions) [2, CHUNK]``; a row's
    positions past its prompt are padding (-1)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    steps = []
    for c in range(2):
        toks = np.zeros((len(LENS), CHUNK), np.int32)
        pos = np.full((len(LENS), CHUNK), -1, np.int32)
        for i, p in enumerate(prompts):
            seg = p[c * CHUNK:(c + 1) * CHUNK]
            toks[i, :len(seg)] = seg
            pos[i, :len(seg)] = c * CHUNK + np.arange(len(seg))
        steps.append((toks, pos))
    return steps


def decode_step(greedy, nxt):
    """A decode step: each row's token at column 0, padding after it."""
    toks = np.zeros((len(LENS), CHUNK), np.int32)
    pos = np.full((len(LENS), CHUNK), -1, np.int32)
    toks[:, 0], pos[:, 0] = greedy, nxt
    return toks, pos


# the ring paths' prompts: two of R_LEN tokens (the smoke's SSD chunk is
# 16: a whole chunk and a padded one), or E_LEN for whisper's decoder over
# E_FRAMES encoder frames
R_BATCH, R_LEN, E_LEN, E_FRAMES = 2, 20, 6, 24
# the training step: b1 = 0 and no clipping make the step's first moment
# the masked gradient itself (``m = 0 * 0 + 1 * g``), so both sides'
# ``train_step`` hand back their gradients before the optimizer moves
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, b1=0.0, clip_norm=float("inf"))
# what the masks spare (the trainer's predicate)
TRAIN_SPARE = ("embed", "router", "norm", "ln")


def kind_of(family, wire):
    """A case's serving path: ``"train"``, ``"ring"`` (the recurrent
    families), ``"encdec"`` or ``"paged"``."""
    if wire == "train":
        return "train"
    return {"ssm": "ring", "hybrid": "ring", "encdec": "encdec"}.get(family, "paged")


def n_positions(kind):
    """The logits a case compares: every valid position of its steps."""
    if kind == "ring":
        return R_BATCH * R_LEN + R_BATCH * (R_LEN + N_DECODE)
    if kind == "encdec":
        return R_BATCH * (E_LEN + N_DECODE)
    return sum(LENS) + len(LENS) * N_DECODE


def check_case(label, got, want, want32, record_property=None):
    """The gate on one case's logits (or one training leaf): within the
    reference-derived bound of the reference's bf16 run, greedy tokens
    equal above the margin, and equal bit for bit.  Prints and records
    its line."""
    assert got.shape == want.shape == want32.shape
    assert np.isfinite(got).all(), label
    err, bound, ref_gap, sure = gate_report(got, want, want32)
    line = (f"{label}: |port - ref_bf16| {err:.4g}, bound {bound:.4g} "
            f"(|ref_bf16 - ref_f32| {ref_gap:.4g}, logits up to {np.abs(want32).max():.4g}); "
            f"tokens compared at {int(sure.sum())} of {len(sure)} positions, "
            f"{int((~sure).sum())} below the margin")
    print(line)
    if record_property is not None:
        record_property("bf16_gate", line)
    assert err <= bound, line
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure], err_msg=line)
    np.testing.assert_array_equal(got, want, err_msg=line)


PAGES_A_ROW = -(-(max(LENS) + N_DECODE) // PS)
N_PAGES = len(LENS) * PAGES_A_ROW + 1  # page 0 is the null page


def page_tables(idle=0):
    """Each prompt row's own pages, then ``idle`` rows of null pages."""
    tables = np.zeros((len(LENS) + idle, PAGES_A_ROW), np.int32)
    tables[:len(LENS)] = 1 + np.arange(len(LENS) * PAGES_A_ROW).reshape(len(LENS), -1)
    return tables


def teacher_forced(step, vocab, feed=None, idle=0):
    """The gate's steps through ``step(toks, pos)`` (numpy ``[rows,
    CHUNK]`` in, numpy f32 logits ``[rows, CHUNK, >= vocab]`` out, its
    cache its own): the two prefill chunks, then ``N_DECODE`` decode steps
    fed ``feed`` (``[N_DECODE, prompts]``) or, with None, this run's own
    greedy tokens; ``idle`` rows (token 0 at position -1) below the
    prompts.  Returns the logits at every valid position in step order
    and the decode tokens fed."""
    b = len(LENS)
    steps = prefill_steps(vocab)
    nxt = np.array(LENS, np.int32)
    logits, fed = [], []
    for k in range(len(steps) + N_DECODE):
        if k < len(steps):
            toks, pos = steps[k]
        else:
            greedy = greedy if feed is None else feed[k - len(steps)]
            fed.append(greedy)
            toks, pos = decode_step(greedy, nxt)
            nxt = nxt + 1
        toks = np.concatenate([toks, np.zeros((idle, CHUNK), np.int32)])
        pos = np.concatenate([pos, np.full((idle, CHUNK), -1, np.int32)])
        valid = pos >= 0
        logits.append(step(toks, pos)[..., :vocab][valid])
        greedy = logits[-1][np.cumsum(valid.sum(axis=1))[:b] - 1].argmax(-1).astype(np.int32)
    return np.concatenate(logits), np.stack(fed)


def port_step(params, cfg, device="cpu", idle=0):
    """The port's ``lm.paged_step`` on packed ``params`` and the engine's
    effective ``cfg``, over a new paged cache on ``device``: a
    :func:`teacher_forced` step."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import paged_cache

    tables = torch.from_numpy(page_tables(idle)).to(device)
    state = {"cache": paged_cache.make_paged_cache(cfg, N_PAGES, PS, device)}

    def step(toks, pos):
        out, state["cache"] = lm.paged_step(params, state["cache"],
                                            torch.from_numpy(toks).to(device),
                                            torch.from_numpy(pos).to(device), tables, cfg)
        return out.float().cpu().numpy()

    return step


def ring_prompts(vocab, n):
    """The ring paths' prompts, ``[R_BATCH, n]``."""
    return np.random.default_rng(5).integers(0, vocab, (R_BATCH, n)).astype(np.int32)


def encdec_frames(d_model):
    """Whisper's encoder input, ``[R_BATCH, E_FRAMES, d_model]`` f32 (each
    side casts it to the model's dtype, as a server feeds it)."""
    return np.random.default_rng(7).normal(size=(R_BATCH, E_FRAMES, d_model)).astype(np.float32)


def teacher_forced_ring(forward, decode, vocab, n_prompt, feed=None):
    """The ring paths' steps: ``forward(toks [B, S])`` (None: none) the
    logits ``[B, S, >= vocab]`` of one pass over the prompt, then
    ``decode(toks [B, 1], pos)`` (its cache its own) stepped through the
    prompt and ``N_DECODE`` decode steps fed ``feed`` (``[N_DECODE, B,
    1]``) or, with None, this run's own greedy tokens.  Returns the logits
    ``[positions, vocab]`` (the forward's, then the steps') and the
    decode tokens fed."""
    toks = ring_prompts(vocab, n_prompt)
    logits, fed = [], []
    if forward is not None:
        logits.append(forward(toks)[..., :vocab].reshape(-1, vocab))
    for t in range(n_prompt + N_DECODE):
        if t < n_prompt:
            tok = toks[:, t:t + 1]
        else:
            tok = greedy if feed is None else feed[t - n_prompt]
            fed.append(tok)
        logits.append(decode(tok, t)[..., :vocab].reshape(-1, vocab))
        greedy = logits[-1].argmax(-1).astype(np.int32)[:, None]
    return np.concatenate(logits), np.stack(fed)


def port_run(params, cfg, device="cpu", feed=None, idle=0):
    """The port's side of a serving case on ``device``, the path chosen
    by ``cfg``'s family (packed or dense ``params``, the engine's
    effective ``cfg``): ``(logits, fed)`` as :func:`teacher_forced` or
    :func:`teacher_forced_ring` return them."""
    import torch

    from repro_torch.models import encdec, lm

    kind = kind_of(cfg.family, None)
    if kind == "paged":
        return teacher_forced(port_step(params, cfg, device, idle), cfg.vocab, feed, idle)

    def numpy(t):
        return t.float().cpu().numpy()

    n_prompt = R_LEN if kind == "ring" else E_LEN
    cache = lm.make_cache(cfg, R_BATCH, n_prompt + N_DECODE, device)
    with torch.no_grad():
        if kind == "ring":
            def forward(toks):
                return numpy(lm.forward(params, torch.from_numpy(toks).to(device), cfg))

            def decode(tok, pos):
                return numpy(lm.decode_step(params, cache, torch.from_numpy(tok).to(device), pos,
                                            cfg)[0])
        else:
            forward = None
            frames = torch.from_numpy(encdec_frames(cfg.d_model)).to(device)
            enc = encdec.encode(params, frames.to(getattr(torch, cfg.dtype)), cfg)

            def decode(tok, pos):
                return numpy(encdec.decode_step(params, cache, enc,
                                                torch.from_numpy(tok).to(device), pos, cfg)[0])

        return teacher_forced_ring(forward, decode, cfg.vocab, n_prompt, feed)


def _tmap(obj, fn):
    """``fn`` on every tensor of ``obj`` (tensors, tuples, lists, and the
    dataclasses a linear takes, ``PackedAct``); anything else as it is."""
    import torch

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tmap(o, fn) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: fn(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)
                                           if isinstance(getattr(obj, f.name), torch.Tensor)})
    return obj


def _tensors(obj):
    out = []
    _tmap(obj, out.append)
    return out


def _ulps_apart(got, want):
    """Elementwise ``|got - want|`` in units of the last place of the
    tensors' largest magnitude, in their own dtype (a sum that cancels
    keeps its terms' rounding: the scale is the tensor's, not the
    element's); inf where one is NaN alone."""
    import torch

    bits = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24, torch.float64: 53}[want.dtype]
    g, w = got.double(), want.double()
    scale = torch.maximum(torch.nan_to_num(g).abs().max(), torch.nan_to_num(w).abs().max())
    _, e = torch.frexp(scale.clamp_min(torch.finfo(want.dtype).tiny))
    apart = (g - w).abs() / torch.ldexp(torch.ones_like(scale), e - bits)
    both_nan = torch.isnan(g) & torch.isnan(w)
    return torch.where(both_nan, 0.0, torch.nan_to_num(apart, nan=float("inf")))


class SiteReplay:
    """A run held site by site against a recorded one: ``record`` runs a
    case (on the CPU), keeping every call of the hooked functions (the
    sinusoidal table, the layer norms, every linear, DAP, the kernel
    wrappers, the dense linear's activation, ``mha``) with its tensor
    inputs and outputs in call order; ``replay`` runs it again (on the
    card) with each hooked call fed the recorded inputs and handing on the
    recorded output, so every site is compared at equal inputs and no
    difference spreads.  ``diffs``: ``(call, site, elements apart, the
    largest difference in ulps of the output's largest magnitude, in its
    dtype)`` of each site whose output differs (integer outputs: any
    difference is infinite).
    ``install`` hooks the port's modules through ``setter`` (a test's
    ``monkeypatch.setattr``; ``setattr`` for the life of a process)."""

    def __init__(self, device):
        self.device, self.rec, self.mode, self.i, self.diffs = device, [], "record", 0, []

    def install(self, setter=setattr):
        import types

        from repro_torch.kernels import epilogue, ops
        from repro_torch.models import attention, blocks, common, encdec, rope

        # the dense linear's activation, apart from the plain kernels'
        # epilogues (which the card's kernels do not call)
        setter(common, "epilogue", types.SimpleNamespace(**vars(epilogue)))
        hooks = [(rope, "sinusoidal_embedding"), (blocks, "layernorm"), (encdec, "layernorm"),
                 (attention, "linear"), (common, "linear"), (common, "apply_dap"),
                 (common.epilogue, "apply_act"), (attention, "mha")]
        hooks += [(ops, n) for n in ("dbb_matmul", "dbb_matmul_aw", "dbb_matmul_int8",
                                     "dbb_matmul_aw_int8", "dap_prune", "dap_prune_int8",
                                     "dap_pack", "dap_pack_int8")]
        for mod, name in hooks:
            setter(mod, name, self._wrap(getattr(mod, name), f"{mod.__name__.split('.')[-1]}.{name}"))

    def replay(self):
        """From here on, replay the recording from its first call."""
        self.mode, self.i = "replay", 0

    def _to_dev(self, t):
        return t.clone().to(self.device)

    def _wrap(self, fn, label):
        def hooked(*args, **kw):
            i, self.i = self.i, self.i + 1
            if self.mode == "record":  # in call order: the slot is taken on entry
                keep = (_tmap(args, lambda t: t.detach().clone()),
                        {k: _tmap(v, lambda t: t.detach().clone()) for k, v in kw.items()})
                self.rec.append(None)
                out = fn(*args, **kw)
                self.rec[i] = (label, keep, _tmap(out, lambda t: t.detach().cpu().clone()))
                return out
            got_label, (cargs, ckw), cout = self.rec[i]
            assert got_label == label, (i, got_label, label)
            # the recorded inputs at the top level; parameter trees stay the run's own
            args = tuple(a if isinstance(a, dict) else _tmap(c, self._to_dev)
                         for a, c in zip(args, cargs))
            kw = {k: v if isinstance(v, dict) else _tmap(ckw[k], self._to_dev)
                  for k, v in kw.items()}
            out = fn(*args, **kw)
            n, worst = 0, 0.0
            for g, w in zip(_tensors(out), _tensors(cout)):
                g = g.detach().cpu()
                if g.shape != w.shape or g.dtype != w.dtype:
                    n, worst = -1, float("inf")
                    break
                if w.is_floating_point():
                    apart = _ulps_apart(g, w)
                    n += int((apart > 0).sum())
                    worst = max(worst, float(apart.max())) if apart.numel() else worst
                elif bool((g != w).any()):
                    n, worst = n + int((g != w).sum()), float("inf")
            if n:
                self.diffs.append((i, label, n, worst))
            return _tmap(cout, self._to_dev)

        return hooked


def nonzero_extras(tree, seed):
    """``tree`` (numpy or torch leaves, either side's layout) with the
    leaves both inits draw constant made non-trivial: a mixer's ``A_log``,
    ``D``, ``dt_bias`` and conv bias ``conv_b``, and a layer norm's
    ``bias`` and ``scale`` (a norm with a bias)."""
    rng = np.random.default_rng(seed)
    spread = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.5, "D": 1.0, "bias": 0.1}

    def like(v, a):
        if isinstance(v, np.ndarray):
            return a.astype(v.dtype)
        import torch

        return torch.from_numpy(a.astype(np.float32)).to(v.dtype)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            if isinstance(v, (dict, list)):
                out[k] = walk(v)
            elif k in spread:
                out[k] = like(v, rng.normal(size=tuple(v.shape)) * spread[k])
            elif k == "scale" and "bias" in t:
                out[k] = like(v, 1 + 0.1 * rng.normal(size=tuple(v.shape)))
            else:
                out[k] = v
        return out

    return walk(tree)


def reference_weights(arch, extras=False):
    """``(jcfg, tcfg, the port's bf16 tree)`` of ``arch``'s small config
    in bf16: the reference's init jitted (``init_encdec`` for whisper),
    every bias drawn non-zero, and with ``extras`` the constant leaves of
    :func:`nonzero_extras` too."""
    import jax

    from _torch_parity import nonzero_biases, small_cfgs
    from repro.models import encdec as jed
    from repro.models import lm as jlm
    from repro_torch.convert import params_from_numpy

    jcfg, tcfg = small_cfgs(arch, dtype="bfloat16", **OVERRIDES.get(arch, {}))
    init = jed.init_encdec if jcfg.family == "encdec" else jlm.init_lm
    params = jax.jit(lambda key: init(jcfg, key)[0])(jax.random.PRNGKey(0))
    np_params = nonzero_biases(jax.tree_util.tree_map(np.asarray, params), BIAS_SEED)
    if extras:
        np_params = nonzero_extras(np_params, BIAS_SEED + 1)
    return jcfg, tcfg, params_from_numpy(np_params, "cpu")


def f32_tree(tree):
    """A port tree's floating leaves cast to f32."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_tree(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _reference_run(cfg, tparams, feed, eager):
    """The reference's side of a families case on the port tree
    ``tparams`` (packed or dense) and its config: ``(logits, fed)``."""
    import jax
    import jax.numpy as jnp

    from _torch_parity import reference_tree
    from repro.models import encdec as jed
    from repro.models import lm as jlm
    from repro.serve import paged_cache as jpc

    params = jax.tree_util.tree_map(jnp.asarray, reference_tree(tparams))
    kind = kind_of(cfg.family, None)

    def compiled(fn):
        fn = fn if eager else jax.jit(fn)

        def run(*args):
            with jax.disable_jit(eager):
                return fn(*args)

        return run

    def numpy(a):
        return np.asarray(a.astype(jnp.float32))

    if kind == "paged":
        step = compiled(lambda p, c, t, q, tab: jlm.paged_step(p, c, t, q, tab, cfg))
        tables = jnp.asarray(page_tables())
        state = {"cache": jpc.make_paged_cache(cfg, N_PAGES, PS)}

        def paged(toks, pos):
            lg, state["cache"] = step(params, state["cache"], jnp.asarray(toks),
                                      jnp.asarray(pos), tables)
            return numpy(lg)

        return teacher_forced(paged, cfg.vocab, feed)
    n_prompt = R_LEN if kind == "ring" else E_LEN
    state = {"cache": jlm.make_cache(cfg, R_BATCH, n_prompt + N_DECODE)}
    if kind == "ring":
        fwd = compiled(lambda p, t: jlm.forward(p, t, cfg)[0])
        step = compiled(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, cfg))

        def forward(toks):
            return numpy(fwd(params, jnp.asarray(toks)))

        def decode(tok, pos):
            lg, state["cache"] = step(params, state["cache"], jnp.asarray(tok), jnp.int32(pos))
            return numpy(lg)
    else:
        forward = None
        enc = compiled(lambda p, f: jed.encode(p, f, cfg))(
            params, jnp.asarray(encdec_frames(cfg.d_model)).astype(cfg.dtype))
        step = compiled(lambda p, c, e, t, pos: jed.decode_step(p, c, e, t, pos, cfg))

        def decode(tok, pos):
            lg, state["cache"] = step(params, state["cache"], enc, jnp.asarray(tok),
                                      jnp.int32(pos))
            return numpy(lg)

    return teacher_forced_ring(forward, decode, cfg.vocab, n_prompt, feed)


def run_serving(group_cases, eager=False):
    """``{key/side: logits}`` for every serving case of ``group_cases``:
    the reference in bf16 (its own greedy tokens), the reference on the
    same weights cast to f32, the port in bf16, all fed the first's
    tokens; the reference's paged attention is its fused kernel (interpret
    mode), the one #6 ports.  The families' cases draw
    :func:`nonzero_extras` too."""
    import torch

    from _torch_parity import effective
    from repro_torch.serve import engine as tengine

    torch.set_num_threads(1)
    weights, out = {}, {}
    for case in group_cases:
        arch, wire, kv_dtype = case
        extras = case in FAMILY_CASES
        if (arch, extras) not in weights:
            weights[arch, extras] = reference_weights(arch, extras)
        jcfg0, tcfg0, tparams = weights[arch, extras]
        jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, "native" if wire == "unpacked" else wire)
        jcfg = dataclasses.replace(
            jcfg, sparsity=dataclasses.replace(jcfg.sparsity, paged_attn="fused"))
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        tcfg32 = dataclasses.replace(tcfg, dtype="float32")

        def served(tp, cfg):
            return tp if wire == "unpacked" else tengine.pack_params_for_serving(tp, cfg, wire)

        tp = served(tparams, tcfg)
        key = case_key(arch, wire, kv_dtype)
        out[f"{key}/ref_bf16"], fed = _reference_run(jcfg, tp, None, eager)
        out[f"{key}/ref_f32"], _ = _reference_run(jcfg32, served(f32_tree(tparams), tcfg32), fed,
                                                  eager)
        out[f"{key}/port"], _ = port_run(tp, tcfg, "cpu", fed)
    return out


def run_train(group_cases, eager=False):
    """For every training case of ``group_cases``, one ``train_step`` on
    the same batch, weights and W-DBB masks (4 of 8, the trainer's
    predicate, computed once on the bf16 weights): the reference in bf16
    and on the weights cast to f32, the port in bf16.  Writes each side's
    loss, its forward's logits and every gradient leaf (the step's first
    moment under ``TRAIN_OPT``, f32), the leaves by their port paths."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from _torch_parity import leaves, reference_tree
    from _torch_train import batch_for, jbatch, tbatch
    from repro.core import dbb as jdbb
    from repro.core import schedule as jschedule
    from repro.models import lm as jlm
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import lm as tlm
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    torch.set_num_threads(1)
    out = {}
    for arch, wire, kv_dtype in group_cases:
        key = case_key(arch, wire, kv_dtype)
        jcfg, tcfg, tparams = reference_weights(arch, extras=True)
        np_params = reference_tree(tparams)
        batch = batch_for(jcfg)
        jmasks = jschedule.wdbb_masks(
            jax.tree_util.tree_map(jnp.asarray, np_params), jdbb.DBBConfig(4, 8),
            predicate=lambda path, w: not any(
                s in "/".join(str(getattr(k, "key", k)) for k in path) for s in TRAIN_SPARE))
        tmasks = params_from_numpy(jax.tree_util.tree_map(np.asarray, jmasks), "cpu")

        def reference(cfg, params):
            params = jax.tree_util.tree_map(jnp.asarray, params)
            step = functools.partial(jts.train_step, cfg=cfg,
                                     opt_cfg=jopt.OptimizerConfig(**TRAIN_OPT))
            fwd = (lambda p, t: jlm.forward(p, t, cfg)[0])
            if not eager:
                step, fwd = jax.jit(step), jax.jit(fwd)
            with jax.disable_jit(eager):
                _, state, metrics = step(params, jopt.init(params), jbatch(batch), masks=jmasks)
                logits = fwd(params, jnp.asarray(batch["tokens"]))
            grads = params_from_numpy(jax.tree_util.tree_map(np.asarray, state.mu), "cpu")
            return (float(metrics["loss"]), np.asarray(logits.astype(jnp.float32)), grads)

        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        sides = {"ref_bf16": reference(jcfg, np_params),
                 "ref_f32": reference(jcfg32, reference_tree(f32_tree(tparams)))}
        _, state, metrics = tts.train_step(tparams, topt.init(tparams), tbatch(batch), cfg=tcfg,
                                           opt_cfg=topt.OptimizerConfig(**TRAIN_OPT),
                                           masks=tmasks)
        with torch.no_grad():
            logits = tlm.forward(tparams, torch.from_numpy(batch["tokens"]), tcfg)
        sides["port"] = (float(metrics["loss"]), logits.float().numpy(), state.mu)
        for side, (loss, logits, grads) in sides.items():
            out[f"{key}/{side}/loss"] = np.float32(loss)
            out[f"{key}/{side}/logits"] = logits[..., :jcfg.vocab]
            for path, g in leaves(grads):
                out[f"{key}/{side}/grad{path}"] = g.float().numpy()
    return out


def run_cases(group_cases, eager=False):
    """Every case of ``group_cases`` (this process's XLA flags apply): the
    merged ``{key/...: array}``."""
    train = [c for c in group_cases if c[1] == "train"]
    serving = [c for c in group_cases if c[1] != "train"]
    return {**(run_serving(serving, eager) if serving else {}),
            **(run_train(train, eager) if train else {})}


def spawn(group_cases, out_path, excess_precision=False, simplify=False, eager=False,
          fast_compile=True):
    """Starts this file on ``group_cases`` in a new process (src and tests
    on its path, the CPU platform); returns the ``Popen``."""
    tests = Path(__file__).resolve().parent
    flags = ([os.environ.get("XLA_FLAGS", "")] + ([FAST_COMPILE] if fast_compile else [])
             + ([] if excess_precision else [NO_EXCESS]) + ([] if simplify else [NO_SIMPLIFY]))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tests.parent / "src"), str(tests)]),
               XLA_FLAGS=" ".join(flags).strip())
    args = [sys.executable, str(Path(__file__).resolve()), str(out_path)]
    args += ["--eager"] if eager else []
    args += [case_key(*c) for c in group_cases]
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def run_groups(groups, work, timeout, group_kw=None, **kw):
    """Every group in a process of its own, side by side (``group_kw``, a
    dict a group, overrides ``kw``'s flags for its group); the merged
    results.  Raises with the stderr tail of a process that failed."""
    group_kw = group_kw or [{}] * len(groups)
    procs = [(spawn(g, Path(work) / f"group{i}.npz", **dict(kw, **group_kw[i])),
              Path(work) / f"group{i}.npz") for i, g in enumerate(groups)]
    out = {}
    try:
        for proc, path in procs:
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"reference process failed ({proc.returncode}):\n{err[-3000:]}")
            out.update(np.load(path))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    out_path, flags = argv[0], [a for a in argv[1:] if a.startswith("--")]
    group = [tuple(a.split(":")) for a in argv[1:] if not a.startswith("--")]
    np.savez(out_path, **run_cases(group, eager="--eager" in flags))
