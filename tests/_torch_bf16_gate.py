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

Run as ``python tests/_torch_bf16_gate.py OUT.npz [--eager] CASE ...``
with ``CASE`` ``arch:wire:kv`` and ``src`` and ``tests`` on
``PYTHONPATH``: writes ``{case}/port``, ``/ref_bf16`` and ``/ref_f32``,
the logits ``[positions, vocab]`` at every valid position in step order.
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
OVERRIDES = {"starcoder2_15b": dict(sliding_window=6)}  # a window that bites
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


def run_reference(group_cases, eager=False):
    """``{key/side: logits}`` for every case of ``group_cases`` (this
    process's XLA flags apply)."""
    import jax
    import jax.numpy as jnp
    import torch

    from _torch_parity import effective, nonzero_biases, reference_tree, small_cfgs
    from repro.models import lm as jlm
    from repro.serve import paged_cache as jpc
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import engine as tengine

    torch.set_num_threads(1)
    weights = {}

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.float() if tree.is_floating_point() else tree

    out = {}
    for arch, wire, kv_dtype in group_cases:
        if arch not in weights:
            jcfg0, tcfg0 = small_cfgs(arch, dtype="bfloat16", **OVERRIDES.get(arch, {}))
            params = jax.jit(lambda key, c=jcfg0: jlm.init_lm(c, key)[0])(jax.random.PRNGKey(0))
            np_params = nonzero_biases(jax.tree_util.tree_map(np.asarray, params), BIAS_SEED)
            weights[arch] = (jcfg0, tcfg0, params_from_numpy(np_params, "cpu"))
        jcfg0, tcfg0, tparams = weights[arch]
        jcfg, tcfg = effective(jcfg0, tcfg0, kv_dtype, wire)
        # the reference's fused kernel, the one #6 ports (interpret mode)
        jcfg = dataclasses.replace(
            jcfg, sparsity=dataclasses.replace(jcfg.sparsity, paged_attn="fused"))
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        tcfg32 = dataclasses.replace(tcfg, dtype="float32")
        tp = tengine.pack_params_for_serving(tparams, tcfg, wire)
        tables = jnp.asarray(page_tables())

        def ref_step(cfg, packed):
            def step(p, c, t, q, tab):
                return jlm.paged_step(p, c, t, q, tab, cfg)

            fn = step if eager else jax.jit(step)
            params = jax.tree_util.tree_map(jnp.asarray, reference_tree(packed))
            state = {"cache": jpc.make_paged_cache(cfg, N_PAGES, PS)}

            def run(toks, pos):
                with jax.disable_jit(eager):
                    lg, state["cache"] = fn(params, state["cache"], jnp.asarray(toks),
                                            jnp.asarray(pos), tables)
                return np.asarray(lg.astype(jnp.float32))

            return run

        # teacher forcing: every side is fed the reference's bf16 greedy tokens
        key = case_key(arch, wire, kv_dtype)
        out[f"{key}/ref_bf16"], fed = teacher_forced(ref_step(jcfg, tp), jcfg.vocab)
        out[f"{key}/ref_f32"], _ = teacher_forced(
            ref_step(jcfg32, tengine.pack_params_for_serving(f32(tparams), tcfg32, wire)),
            jcfg.vocab, fed)
        out[f"{key}/port"], _ = teacher_forced(port_step(tp, tcfg), jcfg.vocab, fed)
    return out


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


def run_groups(groups, work, timeout, **kw):
    """Every group in a process of its own, side by side; the merged
    results.  Raises with the stderr tail of a process that failed."""
    procs = [(spawn(g, Path(work) / f"group{i}.npz", **kw), Path(work) / f"group{i}.npz")
             for i, g in enumerate(groups)]
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
    np.savez(out_path, **run_reference(group, eager="--eager" in flags))
