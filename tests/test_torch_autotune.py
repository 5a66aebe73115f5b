"""Port parity, the autotuner (``repro_torch.kernels.autotune``) against
``repro.kernels.autotune`` where the two mean the same thing: how
``paged_attn="auto"`` resolves (cache hits, the device heuristic: fused
where the compiled kernel runs, gather elsewhere), and the sweep rules (a
partial paged-attention sweep caches nothing, a full one caches its
winner).  The port's own half: a cached gather verdict that takes a CUDA
call off kernel #6 is counted and warned of; with no cache file
``get_plan`` is today's ``int8_plan`` / ``native_plan`` at every served
shape, every candidate plan is legal (``dbb_matmul.plan_error``), a
native plan's key ignores M, the JSON cache round-trips and ignores a
corrupt file, an illegal plan and a TPU tile triple; and a CPU engine at
the default ``"auto"`` serves through the gather path, as the
reference's does.

Each test clears both packages' cache variables, so no developer's cache
file is read or written."""

import functools
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import ARRIVALS, N_NEW, SERVE, prompts_for, small_cfgs
from repro.kernels import autotune as jautotune
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import autotune, dbb_matmul, ops
from repro_torch.models import attention
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

RULES = dbb_matmul.PLAN_RULES


def get_plan(kind, m, k, n):
    """``autotune.get_plan`` as the kernels call it (NNZ 4, BZ 8)."""
    return autotune.get_plan(kind, m, k, n, 4, 8, RULES)


@pytest.fixture
def clean(monkeypatch):
    """No cache file on either side; the port's in-process cache empty
    before and after; every key a test sets on the reference's removed."""
    for var in ("REPRO_AUTOTUNE_CACHE", "REPRO_TORCH_AUTOTUNE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    autotune.clear_cache()
    jautotune._load_cache()
    before = dict(jautotune._CACHE)
    yield
    autotune.clear_cache()
    jautotune._CACHE.clear()
    jautotune._CACHE.update(before)


@functools.lru_cache(maxsize=None)
def _smoke_module():
    """``chip_smoke.py``, whose tables list the served full-width shapes."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_autotune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def served_shapes():
    """``(kind, K, N)`` of every #1-#4 shape the kernel phases hold (the
    served shapes of ``PERF.md``'s kernel table, and more)."""
    mod = _smoke_module()
    int8 = [row[1:] for row in mod.LINEARS] + [row[2:] for row in mod.INT8_OTHER_LINEARS]
    out = {("aw_int8" if kind == "aw" else "w_int8", k, n) for kind, _, k, n, _ in int8}
    out |= {(kind, k, n) for _, _, kind, _, _, k, n, _ in mod.NATIVE_LINEARS}
    return sorted(out)


# -------------------------------------------------------------- reference


def _set_both(key, value):
    jautotune._CACHE[key] = value
    autotune._load_cache()
    autotune._CACHE[key] = value


@pytest.mark.parametrize("entry", [None, ("gather",), ("fused",), ("bogus",)],
                         ids=["empty", "gather_hit", "fused_hit", "bogus"])
def test_paged_attn_resolution_matches_reference(clean, entry):
    """``tests/test_paged_attn.py::test_autotune_paged_attn_kind`` on both
    sides, the same entries set: a gather hit holds everywhere, a fused
    hit only where the kernel runs (TPU for the reference, CUDA for the
    port), a bogus entry is ignored; the CPU answers as the reference's
    CPU backend does."""
    assert autotune.heuristic_paged_attn_impl("cpu") == jautotune.heuristic_paged_attn_impl("cpu")
    assert autotune.heuristic_paged_attn_impl("cuda") == "fused"
    assert jautotune.heuristic_paged_attn_impl("tpu") == "fused"
    assert autotune.heuristic_paged_attn_impl(torch.device("cpu")) == "gather"
    key = ("paged_attn", 4, 8, 16, 64, 0)
    if entry is not None:
        _set_both(key, entry)
    want_cpu = jautotune.get_paged_attn_impl(4, 8, 16, 64)  # the reference on its CPU backend
    assert autotune.get_paged_attn_impl(4, 8, 16, 64, "cpu") == want_cpu
    assert autotune.get_paged_attn_impl(4, 8, 16, 64, torch.device("cpu")) == want_cpu
    assert want_cpu == ("gather" if entry != ("fused",) else jautotune.heuristic_paged_attn_impl())
    want_cuda = "gather" if entry == ("gather",) else "fused"
    with warnings.catch_warnings(record=True) as caught:  # counted and warned of: below
        warnings.simplefilter("always")
        assert autotune.get_paged_attn_impl(4, 8, 16, 64, "cuda:0") == want_cuda
    assert len(caught) == (want_cuda == "gather")


@pytest.mark.parametrize("entry", [None, ("gather",), ("fused",), ("bogus",)],
                         ids=["empty", "gather_hit", "fused_hit", "bogus"])
def test_cuda_gather_verdict_is_counted_and_warned(clean, entry):
    """Only a cached gather verdict takes a CUDA call of ``"auto"`` off
    kernel #6: each such call, at the attention site and at the lookup, is
    counted and warns; a CPU call, an explicit knob, the heuristic and a
    fused or bogus entry neither count nor warn.  ``clear_cache`` resets
    the count."""
    key = ("paged_attn", 4, 8, 16, 64, 0)
    if entry is not None:
        autotune._load_cache()
        autotune._CACHE[key] = entry
    hit = entry == ("gather",)
    cuda = torch.device("cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = attention._paged_attn_impl(SparsityConfig(), 4, 8, 16, 64, cuda)
        assert got == ("gather" if hit else "fused")
        assert autotune.get_paged_attn_impl(4, 8, 16, 64, "cuda:0") == got
        for mode in ("gather", "fused"):
            assert attention._paged_attn_impl(SparsityConfig(paged_attn=mode), 4, 8, 16, 64,
                                              cuda) == mode
        assert attention._paged_attn_impl(None, 4, 8, 16, 64, torch.device("cpu")) == "gather"
    assert autotune.cuda_gather_calls() == (2 if hit else 0)
    assert len([w for w in caught if "off the fused" in str(w.message)]) == (2 if hit else 0)
    autotune.clear_cache()
    assert autotune.cuda_gather_calls() == 0


def test_autotune_paged_attn_sweep_rules_match_reference(clean):
    """A partial sweep answers from what it timed and caches nothing; a
    full sweep caches its winner — on both sides."""
    key = ("paged_attn", 4, 8, 16, 64, 0)

    def run_partial(impl):
        if impl == "fused":
            raise RuntimeError("the kernel cannot run here")
        return lambda: 1.0

    assert jautotune.autotune_paged_attn(run_partial, 4, 8, 16, 64) == "gather"
    timings = {}
    assert autotune.autotune_paged_attn(run_partial, 4, 8, 16, 64, timer=lambda fn: fn(),
                                        timings=timings) == "gather"
    assert key not in jautotune._CACHE and key not in autotune._CACHE
    assert timings["gather"] == 1.0 and isinstance(timings["fused"], RuntimeError)

    assert jautotune.autotune_paged_attn(lambda _: (lambda: 0), 4, 8, 16, 64) in (
        jautotune.PAGED_ATTN_IMPLS)
    assert key in jautotune._CACHE
    ms = {"gather": 2.0, "fused": 1.0}
    assert autotune.autotune_paged_attn(lambda impl: (lambda: ms[impl]), 4, 8, 16, 64,
                                        timer=lambda fn: fn()) == "fused"
    assert autotune._CACHE[key] == ("fused",)
    # a cached fused verdict routes CUDA tensors only
    assert autotune.get_paged_attn_impl(4, 8, 16, 64, "cuda") == "fused"
    assert autotune.get_paged_attn_impl(4, 8, 16, 64, "cpu") == "gather"
    # a second sweep of the key answers from the cache without running
    assert autotune.autotune_paged_attn(run_partial, 4, 8, 16, 64, timer=lambda fn: fn()) == (
        "fused")


# ------------------------------------------------------------ matmul plans


@pytest.mark.parametrize("m", [4, 8, 16, 64])
def test_get_plan_defaults_to_todays_rules(clean, m):
    """With an empty cache every served shape gets today's plan."""
    for kind, k, n in served_shapes():
        got = get_plan(kind, m, k, n)
        if kind in autotune.INT8_KINDS:
            assert got == dbb_matmul.int8_plan(m, k, n), (kind, k, n)
        else:
            assert got == dbb_matmul.native_plan(k, n), (kind, k, n)
        assert got == dbb_matmul.heuristic_plan(kind, m, k, n)


@pytest.mark.parametrize("kind", autotune.KINDS)
def test_candidate_plans_legal_and_hold_the_heuristic(kind):
    int8 = kind in autotune.INT8_KINDS
    for _, k, n in [s for s in served_shapes() if (s[0] in autotune.INT8_KINDS) == int8]:
        if (dbb_matmul.int8_body_error(k // 8, n) if int8 else
                dbb_matmul.tc_body_error(torch.bfloat16, k // 8, n)) is not None:
            continue  # the generic body takes the call: no plan to tune
        for m in (4, 64):
            cands = dbb_matmul.candidate_plans(kind, m, k, n)
            assert cands[0] == dbb_matmul.heuristic_plan(kind, m, k, n)
            assert len(set(cands)) == len(cands) > 1
            assert all(dbb_matmul.plan_error(kind, p, k, n) is None for p in cands), (k, n, cands)
            assert {p[0] for p in cands} == ({16, 64} if int8 else {64, 128})


@pytest.mark.parametrize("kind,plan,why", [
    ("w_int8", (32, 80, 7), "bm=32"),
    ("aw", (96, 56, 6), "bn=96"),
    ("aw_int8", (64, 72, 7), "whole k-steps"),
    ("w", (128, 4, 1), "whole k-steps"),
    ("aw_int8", (64, 48, 11), "splits: 1 to 8"),
    ("w", (64, 40, 0), "splits: 1 to 8"),
    ("aw_int8", (64, 64, 7), "do not cover"),
    ("aw", (128, 56, 7), "leave one empty"),
    ("w", (128, 56.0, 6), "three integers"),
    ("w_int8", (64, 1024, 256)[:2], "three integers"),
])
def test_plan_error_names_each_rule(kind, plan, why):
    """Each illegal plan names its rule (int8 at K = 4096: 32 k-steps of
    128; native at K = 2560: 40 k-steps of 64); the heuristic's plans are
    legal."""
    k, n = (4096, 4096) if kind in autotune.INT8_KINDS else (2560, 6400)
    assert why in dbb_matmul.plan_error(kind, plan, k, n)
    assert dbb_matmul.plan_error(kind, dbb_matmul.heuristic_plan(kind, 64, k, n), k, n) is None
    with pytest.raises(ValueError, match="unknown matmul kind"):
        dbb_matmul.plan_error("int4", (64, 80, 7), k, n)


def test_native_key_ignores_m(clean):
    """A native plan is a function of (K, N): a cached plan answers every
    M, so a row sums in one order whatever M is; an int8 plan keeps M."""
    k, n = 6400, 2560
    ms = {p: float(i) for i, p in enumerate(reversed(dbb_matmul.candidate_plans("aw", 64, k, n)))}
    win = autotune.autotune(lambda p: (lambda: ms[p]), 64, k, n, 4, 8, "aw", rules=RULES,
                            timer=lambda fn: fn())
    assert win == min(ms, key=ms.get) and win != dbb_matmul.heuristic_plan("aw", 64, k, n)
    assert ("aw", 0, k, n, 4, 8) in autotune._CACHE
    for m in (1, 4, 16, 64, 512):
        assert get_plan("aw", m, k, n) == win
    assert get_plan("w", 4, k, n) == dbb_matmul.native_plan(k, n)  # another kind
    k8, n8 = 4096, 4096
    win8 = autotune.autotune(lambda p: (lambda: 1.0 if p[0] == 16 else 2.0), 64, k8, n8, 4, 8,
                             "aw_int8", rules=RULES, timer=lambda fn: fn())
    assert win8[0] == 16
    assert get_plan("aw_int8", 64, k8, n8) == win8
    assert get_plan("aw_int8", 4, k8, n8) == dbb_matmul.int8_plan(4, k8, n8)


def test_autotune_with_no_candidate_running_caches_nothing(clean):
    def fail(plan):
        raise RuntimeError("no card")

    timings = {}
    got = autotune.autotune(fail, 64, 4096, 12800, 4, 8, "aw_int8", rules=RULES,
                            timer=lambda fn: fn(), timings=timings)
    assert got == dbb_matmul.int8_plan(64, 4096, 12800)
    assert autotune._CACHE == {}
    assert set(timings) == set(dbb_matmul.candidate_plans("aw_int8", 64, 4096, 12800))


@pytest.mark.parametrize("bad", ["corrupt", "illegal", "tpu_triple", "not_a_list", "bad_key"])
def test_cache_file_round_trip_and_bad_entries(clean, monkeypatch, tmp_path, bad):
    """A sweep writes its winner to the file; a fresh cache reads it back;
    a corrupt file, an illegal plan, a TPU tile triple (the reference's
    ``heuristic_tiles`` for the shape, under its own key), a value that is
    not a list and a key that is not six fields are each ignored, and the
    heuristic answers."""
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    k, n = 4096, 12800
    heur = dbb_matmul.int8_plan(64, k, n)
    win = autotune.autotune(lambda p: (lambda: 0.5 if p == (16, 256, 2) else 1.0), 64, k, n, 4,
                            8, "aw_int8", rules=RULES, timer=lambda fn: fn())
    assert win == (16, 256, 2) != heur
    raw = json.loads(path.read_text())
    assert raw == {json.dumps(["aw_int8", 64, k, n, 4, 8]): [16, 256, 2]}
    autotune.clear_cache()
    assert get_plan("aw_int8", 64, k, n) == win  # read back from the file

    key = json.dumps(["aw_int8", 64, k, n, 4, 8])
    text = {
        "corrupt": '{"["aw_int8", 64',
        "illegal": json.dumps({key: [64, 100, 2]}),
        "tpu_triple": json.dumps({key: list(jautotune.heuristic_tiles(64, k, n, 8, int8=True))}),
        "not_a_list": json.dumps({key: 7}),
        "bad_key": json.dumps({json.dumps(["aw_int8", 64, k]): [16, 256, 2], "[1": [1]}),
    }[bad]
    path.write_text(text)
    autotune.clear_cache()
    assert get_plan("aw_int8", 64, k, n) == heur


def test_memo_cleared_when_the_cache_changes(clean):
    k, n = 2560, 6400
    assert get_plan("aw", 64, k, n) == dbb_matmul.native_plan(k, n)
    win = autotune.autotune(lambda p: (lambda: 0.0 if p == (64, 320, 1) else 1.0), 64, k, n, 4,
                            8, "aw", rules=RULES, timer=lambda fn: fn())
    assert win == (64, 320, 1) and get_plan("aw", 64, k, n) == win
    autotune.clear_cache()
    assert get_plan("aw", 64, k, n) == dbb_matmul.native_plan(k, n)


# --------------------------------------------------------- the engine


def _replay(eng, outs, cfg):
    """Every request's fed stream in one paged step with ``eng``'s packed
    weights under ``cfg``: the logits of every fed position."""
    fed = [w[:-1] for w in outs]
    s, b, ps = max(len(f) for f in fed), len(fed), eng.scfg.page_size
    per = -(-s // ps)
    toks = np.zeros((b, s), np.int32)
    pos = np.full((b, s), -1, np.int32)
    for i, f in enumerate(fed):
        toks[i, : len(f)] = f
        pos[i, : len(f)] = np.arange(len(f))
    tables = (1 + np.arange(b * per, dtype=np.int32)).reshape(b, per)
    logits, _ = tlm.paged_step(eng.params, tpc.make_paged_cache(cfg, b * per + 1, ps, "cpu"),
                               torch.from_numpy(toks), torch.from_numpy(pos),
                               torch.from_numpy(tables), cfg)
    return logits


@pytest.mark.parametrize("arch", ["granite_3_8b", "minicpm3_4b"])
def test_cpu_engine_auto_serves_the_gather_path(clean, arch):
    """A continuous engine of the port on the CPU at the default
    ``paged_attn="auto"`` makes no plain fused-kernel call, serves the
    explicit ``"gather"`` engine's tokens, and its replayed logits equal
    the gather path's byte for byte — as the reference's ``"auto"`` runs
    its gather path off the TPU.  Until the repair ``"auto"`` ran the
    fused kernel's plain version, whose bf16 logits differ."""
    _, tcfg = small_cfgs(arch, dtype="bfloat16")
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    prompts = prompts_for(tcfg.vocab)
    attn = "paged_attn_latent" if tcfg.mla is not None else "paged_attn"
    engines, outs, plain = {}, {}, {}
    for mode in ("auto", "gather", "fused"):
        scfg = tengine.ServeConfig(prefill_mode="continuous", pack_weights=True,
                                   wire_dtype="native", paged_attn=mode, **SERVE)
        engines[mode] = tengine.Engine(params, tcfg, scfg, device="cpu")
        ops.reset_counters()
        outs[mode] = engines[mode].generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
        plain[mode] = ops.counters()[attn].plain
    assert engines["auto"].cfg.sparsity.paged_attn == "auto"
    assert plain["auto"] == plain["gather"] == 0 < plain["fused"]
    for a, b in zip(outs["auto"], outs["gather"]):
        np.testing.assert_array_equal(a, b)
    got = _replay(engines["auto"], outs["auto"], engines["auto"].cfg)
    gather = _replay(engines["auto"], outs["auto"], engines["gather"].cfg)
    fused = _replay(engines["auto"], outs["auto"], engines["fused"].cfg)
    assert torch.equal(got, gather)
    assert not torch.equal(got, fused)
