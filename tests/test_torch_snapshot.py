"""Port parity, durable serving (``tests/test_snapshot.py`` and
``tests/test_checkpoint.py`` on the port, on the CPU): the checkpoint
manager (atomic tmp-dir rename, keep-k with milestones, stale-tmp sweep,
typed rejection on restore), bf16 planes round-tripping bit for bit as
their 16-bit views, the serve config's durability validation, manual
snapshots and cold restores that keep the prefix cache, config-mismatch
and foreign-checkpoint rejection with the free knobs still restoring,
a cold restore after a kill byte-identical to the uninterrupted serve
over arch x wire x KV (the stream resuming at the first undelivered
token, no page leaked), a mid-save crash restoring from the previous
snapshot, serving refused while a resume is pending, the request and
scheduler state round trips, ``percentile`` and the hang watchdog, the
latency fields, and the kill-anywhere fuzz: 112 seeded kills (iteration
boundaries, between dispatch and commit, inside a save) over {GQA, MLA}
x {native, int8 wire} x {f32, int8 KV} x {plain, spec}, each followed by
a warm restore whose resumed serve equals the uninterrupted one, with a
gapless stream and no page leaked.  Models are granite-3-8b and
minicpm3-4b at ``_torch_parity.SMALL`` (f32) on the reference's weights;
"native" is dense weights, "int8" the packed int8 wire."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import FUSED, reference_params, small_cfgs
from repro.runtime import monitor as jmonitor
from repro.serve import engine as jengine
from repro_torch.checkpoint import manager
from repro_torch.models import lm
from repro_torch.runtime import monitor
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults
from repro_torch.serve.paged_cache import PageAllocator, make_paged_cache
from repro_torch.serve.scheduler import (
    Request,
    Scheduler,
    SchedulerInvariantError,
    request_from_state,
    request_state,
)

torch.set_num_threads(1)

_WEIGHTS = {}


def weights(arch="granite_3_8b"):
    if arch not in _WEIGHTS:
        jcfg, tcfg = small_cfgs(arch)
        _WEIGHTS[arch] = (tcfg, reference_params(jcfg, seed=0)[1])
    return _WEIGHTS[arch]


def mixed(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lengths]


def serve_kwargs(wire="native", kv="native", spec=False, **kw):
    out = dict(prefill_mode="continuous", max_seq=48, page_size=4, max_batch=3, max_pages=13,
               prefill_chunk=4, temperature=0.7, seed=11, kv_dtype=kv, **FUSED)
    if wire == "int8":
        out.update(pack_weights=True, wire_dtype="int8")
    if spec:
        out["spec"] = tengine.SpecConfig(draft="nnz", draft_nnz=2)
    out.update(kw)
    return out


def engine(arch="granite_3_8b", **kw):
    tcfg, tparams = weights(arch)
    return tengine.Engine(tparams, tcfg, tengine.ServeConfig(**kw), device="cpu")


def assert_no_leaks(eng, n_inflight=0):
    """Every data page is free, prefix-held or owned by a live table."""
    state = eng._cont["allocator"].export_state()
    assert len(state["tables"]) == n_inflight, state["tables"]
    held = {p for _, tbl in state["tables"] for p in tbl} | {p for p, _ in state["refs"]}
    assert len(set(state["free"]) | held) == state["n_pages"] - 1, state


def stream_cb(store):
    """on_token callback asserting in-order, gap-free delivery."""

    def cb(rid, toks, start):
        buf = store.setdefault(rid, [])
        assert start == len(buf), (rid, start, len(buf))
        buf.extend(int(t) for t in toks)

    return cb


# ------------------------------------------------------- checkpoint manager


def _tree(x=0.0):
    return {"a": np.full((2, 3), 1.0 + x, np.float32), "b": {"c": np.arange(4, dtype=np.int32)}}


def test_save_restore_roundtrip_with_extra(tmp_path):
    d = str(tmp_path)
    manager.save(d, 3, _tree(1.5), extra={"k": [1, 2], "name": "x"})
    tree, man = manager.restore(d, _tree())
    np.testing.assert_array_equal(tree["a"], _tree(1.5)["a"])
    np.testing.assert_array_equal(tree["b"]["c"], _tree()["b"]["c"])
    assert man["step"] == 3 and man["extra"] == {"k": [1, 2], "name": "x"}
    assert manager.load_manifest(d)["extra"]["name"] == "x"


def test_mid_save_crash_tmp_ignored_and_swept(tmp_path):
    d = str(tmp_path)
    manager.save(d, 1, _tree(1.0))

    class Boom(RuntimeError):
        pass

    def crash():
        raise Boom("simulated death inside save")

    with pytest.raises(Boom):
        manager.save(d, 2, _tree(2.0), pre_publish_hook=crash)
    names = set(os.listdir(d))
    assert "step_00000002.tmp" in names and "step_00000002" not in names
    assert manager.all_steps(d) == [1]
    tree, man = manager.restore(d, _tree())
    assert man["step"] == 1
    np.testing.assert_array_equal(tree["a"], _tree(1.0)["a"])
    manager.save(d, 3, _tree(3.0))
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert manager.latest_step(d) == 3


def test_keep_k_gc_retains_milestones(tmp_path):
    d = str(tmp_path)
    for s in range(1, 11):
        manager.save(d, s, _tree(float(s)), keep=3, milestone_every=5)
    assert manager.all_steps(d) == [5, 8, 9, 10]
    tree, _ = manager.restore(d, _tree(), step=5)
    np.testing.assert_array_equal(tree["a"], _tree(5.0)["a"])


@pytest.mark.parametrize("fault", ["leaves", "shape", "missing leaf"])
def test_restore_rejects_structural_mismatch(tmp_path, fault):
    d = str(tmp_path)
    manager.save(d, 1, _tree())
    like = _tree()
    if fault == "leaves":
        like = {"a": np.zeros((2, 3), np.float32)}
    elif fault == "shape":
        like["a"] = np.zeros((5,), np.float32)
    else:
        os.remove(os.path.join(d, "step_00000001", "leaf_00001.npy"))
    with pytest.raises(manager.CheckpointError, match=fault):
        manager.restore(d, like)


def test_empty_dir_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        manager.load_manifest(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        manager.restore(str(tmp_path), _tree())


def test_bf16_cache_roundtrip_bit_for_bit(tmp_path):
    """numpy has no bfloat16: bf16 planes go to disk as their 16-bit views
    with the dtype in the manifest and come back bit for bit (NaN payloads,
    -0.0 and infinities included), restored through the meta template."""
    tcfg, _ = weights()
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    cache = make_paged_cache(cfg, 5, 4, "cpu")
    gen = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        bits = torch.randint(-2**15, 2**15, cache[name].shape, generator=gen, dtype=torch.int32)
        cache[name].copy_(bits.to(torch.int16).view(torch.bfloat16))
    cache["k"].view(-1)[:4] = torch.tensor([float("nan"), -0.0, float("inf"), -float("inf")])
    cache["pos"].copy_(torch.randint(-1, 40, cache["pos"].shape, generator=gen))
    d = str(tmp_path)
    manager.save(d, 0, lm.export_decode_state(cache))
    man = manager.load_manifest(d)
    assert [leaf["dtype"] for leaf in man["leaves"]] == ["bfloat16", "int32", "bfloat16"]
    host, _ = manager.restore(d, lm.paged_cache_template(cfg, 5, 4))
    back = lm.restore_decode_state(host, "cpu")
    for name, plane in cache.items():
        assert back[name].dtype == plane.dtype, name
        if plane.dtype == torch.bfloat16:
            assert torch.equal(back[name].view(torch.int16), plane.view(torch.int16)), name
        else:
            assert torch.equal(back[name], plane), name


# ------------------------------------------------------------- config


def test_serve_config_durability_validation():
    for mod in (jengine, tengine):
        with pytest.raises(ValueError, match="snapshot_every"):
            mod.ServeConfig(snapshot_every=-1, snapshot_dir="unused")
        with pytest.raises(ValueError, match="snapshot_dir"):
            mod.ServeConfig(snapshot_every=2)
        with pytest.raises(ValueError, match="snapshot_keep"):
            mod.ServeConfig(snapshot_dir="unused", snapshot_keep=0)
        with pytest.raises(ValueError, match="hang_threshold"):
            mod.ServeConfig(hang_threshold=1.0)


def test_snapshot_and_resume_guards(tmp_path):
    with pytest.raises(ValueError, match="continuous"):
        engine(prefill_mode="batched").snapshot(str(tmp_path))
    eng = engine(**serve_kwargs())
    with pytest.raises(ValueError, match="snapshot_dir"):
        eng.snapshot()
    with pytest.raises(RuntimeError, match="nothing to resume"):
        eng.resume()


# ------------------------------------------------------ shared warm engine


@pytest.fixture(scope="module")
def snap_engine(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("snaps"))
    tcfg, tparams = weights()
    eng = engine(**serve_kwargs(snapshot_dir=d, snapshot_keep=4))
    prompts = mixed(tcfg.vocab, (9, 5, 12, 7))
    out = eng.generate_requests(prompts, 8)
    return dict(eng=eng, cfg=tcfg, params=tparams, prompts=prompts, out=out, dir=d)


def test_health_reports_step_percentiles(snap_engine):
    h = snap_engine["eng"].health()
    assert h["slow_steps"] >= 0
    assert h["step_p50_us"] > 0.0 and h["step_p99_us"] >= h["step_p50_us"]


def test_manual_snapshot_cold_restore_prefix_survives(snap_engine):
    eng, cfg, params = snap_engine["eng"], snap_engine["cfg"], snap_engine["params"]
    eng.snapshot()
    eng2 = tengine.Engine.restore(snap_engine["dir"], params, cfg, device="cpu")
    assert eng2._cont["prefix"].export_state()["entries"]
    again = eng.generate_requests(snap_engine["prompts"], 8)
    restored = eng2.generate_requests(snap_engine["prompts"], 8)
    for a, b, first in zip(again, restored, snap_engine["out"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, first)
    assert eng2.prefix_stats()["page_hits"] > 0
    assert_no_leaks(eng2)


def test_load_snapshot_rejects_serve_config_mismatch(snap_engine):
    snap_engine["eng"].snapshot()
    other = engine(**serve_kwargs(page_size=8, max_pages=7))
    with pytest.raises(manager.CheckpointError, match="page_size"):
        other.load_snapshot(snap_engine["dir"])


def test_snapshot_free_knobs_do_not_block_restore(snap_engine):
    snap_engine["eng"].snapshot()
    d = snap_engine["dir"]
    other = engine(**serve_kwargs(snapshot_dir=d, snapshot_every=7, snapshot_keep=1,
                                  hang_threshold=99.0))
    assert other.load_snapshot(d) >= 0


def test_load_snapshot_rejects_foreign_checkpoint(tmp_path, snap_engine):
    d = str(tmp_path)
    manager.save(d, 0, {"w": np.zeros((2,), np.float32)}, extra={"kind": "train_state"})
    with pytest.raises(manager.CheckpointError, match="not an engine snapshot"):
        snap_engine["eng"].load_snapshot(d)


# ------------------------------------------------ kill, restore, resume


KILL_CELLS = {  # fixed ids for xdist: arch, wire, KV dtype, spec
    "granite-native-native": ("granite_3_8b", "native", "native", False),
    "granite-int8-int8-spec": ("granite_3_8b", "int8", "int8", True),
    "minicpm3-native-int8": ("minicpm3_4b", "native", "int8", False),
    "minicpm3-int8-native-spec": ("minicpm3_4b", "int8", "native", True),
}


@pytest.mark.parametrize("cell", list(KILL_CELLS))
def test_cold_restore_after_kill_byte_identical(tmp_path, cell):
    """A kill mid-serve; a fresh engine (weights packed anew from the raw
    params) restores the last published snapshot and finishes every
    in-flight request byte-identical, the stream resuming at the first
    undelivered token, no page leaked."""
    arch, wire, kv, spec = KILL_CELLS[cell]
    tcfg, tparams = weights(arch)
    prompts = mixed(tcfg.vocab, (9, 5, 12, 7))
    d = str(tmp_path / "snap")
    ref = engine(arch, **serve_kwargs(wire, kv, spec)).generate_requests(prompts, 8)
    eng = engine(arch, **serve_kwargs(wire, kv, spec, snapshot_dir=d, snapshot_every=2,
                                      snapshot_keep=4))
    streamed = {}
    eng.set_faults(faults.FaultConfig(seed=0, kill_at=5, kill_point="iteration"))
    with pytest.raises(faults.SimulatedCrash):
        eng.generate_requests(prompts, 8, on_token=stream_cb(streamed))
    eng2 = tengine.Engine.restore(d, tparams, tcfg, device="cpu")
    resumed = {}

    def cb2(rid, toks, start):
        s0, buf = resumed.setdefault(rid, (start, []))
        assert start == s0 + len(buf), (rid, start)
        buf.extend(int(t) for t in toks)

    results = eng2.resume(on_token=cb2, delivered={r: len(t) for r, t in streamed.items()})
    assert results
    for r in results:
        assert r.ok, r
        np.testing.assert_array_equal(r.tokens, ref[r.rid - 1])
        gen = [int(t) for t in r.tokens[len(r.tokens) - r.n_generated:]]
        pre = streamed.get(r.rid, [])
        s0, buf = resumed.get(r.rid, (len(pre), []))
        assert s0 == len(pre) and pre + buf == gen
    assert_no_leaks(eng2)


def test_mid_save_crash_restores_from_previous_snapshot(tmp_path):
    tcfg, tparams = weights()
    prompts = mixed(tcfg.vocab, (9, 5, 12, 7))
    d = str(tmp_path / "snap")
    ref = engine(**serve_kwargs()).generate_requests(prompts, 8)
    eng = engine(**serve_kwargs(snapshot_dir=d, snapshot_every=2, snapshot_keep=4))
    eng.set_faults(faults.FaultConfig(seed=1, kill_at=2, kill_point="mid_save"))
    with pytest.raises(faults.SimulatedCrash):
        eng.generate_requests(prompts, 8)
    assert manager.all_steps(d) == [0]
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    eng2 = tengine.Engine.restore(d, tparams, tcfg, device="cpu")
    for r in eng2.resume():
        np.testing.assert_array_equal(r.tokens, ref[r.rid - 1])
    assert_no_leaks(eng2)


def test_serve_refused_while_resume_pending(tmp_path):
    tcfg, _ = weights()
    prompts = mixed(tcfg.vocab, (9, 5))
    d = str(tmp_path / "snap")
    eng = engine(**serve_kwargs(max_batch=2, snapshot_dir=d, snapshot_every=1))
    eng.set_faults(faults.FaultConfig(seed=2, kill_at=3, kill_point="pre_commit"))
    with pytest.raises(faults.SimulatedCrash):
        eng.generate_requests(prompts, 6)
    eng.load_snapshot(d)
    with pytest.raises(RuntimeError, match="resume"):
        eng.generate_requests(prompts, 6)
    assert eng.resume()
    assert len(eng.generate_requests(prompts, 6)) == 2


# ------------------------------------------------- scheduler state units


def _fresh_sched(max_batch=3, n_pages=13):
    return Scheduler(max_batch=max_batch, page_size=4, n_pages=n_pages, max_pages_per_req=12,
                     prefill_chunk=4, decode_block=16, allocator=PageAllocator(n_pages, 4))


def test_request_state_roundtrip():
    from repro.serve import scheduler as jsched

    req = Request(rid=7, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4,
                  stop_tokens=frozenset({3, 9}))
    req.out.extend([1, 2])
    req.computed, req.streamed, req.preemptions = 5, 1, 2
    state = request_state(req)
    back = request_from_state(state)
    np.testing.assert_array_equal(back.prompt, req.prompt)
    assert (back.rid, back.out, back.computed, back.streamed) == (7, [1, 2], 5, 1)
    assert back.stop_tokens == frozenset({3, 9}) and back.preemptions == 2
    # the reference's request state has the same keys and values
    jreq = jsched.request_from_state(state)
    assert jsched.request_state(jreq) == state


def test_scheduler_load_state_requires_fresh_and_matching_batch():
    state = _fresh_sched().export_state()
    s2 = _fresh_sched()
    s2.iteration = 3
    with pytest.raises(SchedulerInvariantError, match="fresh"):
        s2.load_state(state)
    with pytest.raises(SchedulerInvariantError, match="batch rows"):
        _fresh_sched(max_batch=2).load_state(state)


# ----------------------------------------------------------- monitor units


def test_percentile_nearest_rank():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q, want in ((50, 3.0), (0, 1.0), (100, 5.0), (99, 5.0), (30, 2.0)):
        assert monitor.percentile(xs, q) == want == jmonitor.percentile(xs, q)
    assert monitor.percentile([], 99) == 0.0


def test_hang_watchdog_flags_outliers_once_warm():
    wd = monitor.HangWatchdog(threshold=5.0, window=8, min_samples=4)
    for _ in range(4):
        assert not wd.note(0.01)
    assert wd.note(0.2) and wd.trips == 1
    assert not wd.note(0.011)
    for _ in range(20):
        wd.note(0.2)
    assert not wd.note(0.2)
    with pytest.raises(ValueError, match="threshold"):
        monitor.HangWatchdog(threshold=1.0)


def test_engine_watchdog_counts_a_slow_step(caplog):
    """A step far slower than the rolling median trips the engine's
    watchdog: counted in ``health()``, logged once."""
    eng = engine(**serve_kwargs(hang_threshold=5.0))
    for dt in [0.01] * 6 + [0.5, 0.5]:
        eng._note_step_time(dt)
    assert eng.health()["slow_steps"] == 2 and eng.slow_steps == 2
    assert sum("slow serving step" in r.getMessage() for r in caplog.records) == 1


def test_latency_fields_populated():
    tcfg, _ = weights()
    res = engine(**serve_kwargs()).serve_requests(mixed(tcfg.vocab, (9, 5, 12)), 6,
                                                  arrivals=[0, 1, 2])
    for r in res:
        assert r.ok and r.time_to_first_token > 0.0 and r.tokens_per_second > 0.0
        assert r.time_to_first_token >= r.queue_time >= 0.0


# ------------------------------------------------------- kill-anywhere fuzz


CHAOS_CELLS = [  # every axis value meets every value of every other axis
    ("granite_3_8b", "native", "native", False),
    ("granite_3_8b", "int8", "native", False),
    ("granite_3_8b", "native", "int8", True),
    ("granite_3_8b", "int8", "int8", True),
    ("minicpm3_4b", "native", "int8", False),
    ("minicpm3_4b", "int8", "int8", False),
    ("minicpm3_4b", "native", "native", True),
    ("minicpm3_4b", "int8", "native", True),
]
KILLS_PER_CELL = 14  # 8 cells x 14 = 112 seeded kill points
# a fuzzed kill_at can land past the end of a short run; each cell tallies
# the kills that fired and the floor test requires >= 100 over the matrix
_KILL_TALLY = {}


@pytest.mark.parametrize("cell", range(len(CHAOS_CELLS)),
                         ids=lambda i: "-".join(str(x) for x in CHAOS_CELLS[i]))
def test_kill_anywhere_fuzz(tmp_path, cell):
    arch, wire, kv, spec = CHAOS_CELLS[cell]
    tcfg, _ = weights(arch)
    prompts = mixed(tcfg.vocab, (9, 5, 12, 7))
    n_tok = 8
    d = str(tmp_path / "snap")
    eng = engine(arch, **serve_kwargs(wire, kv, spec, snapshot_dir=d, snapshot_every=2,
                                      snapshot_keep=50))
    # the uninterrupted serve on the same engine (prefix reuse and snapshot
    # saves change no byte, so one reference serves every kill)
    ref = eng.generate_requests(prompts, n_tok)
    rng = np.random.default_rng(1000 + cell)
    kills = 0
    for k in range(KILLS_PER_CELL):
        site = faults.KILL_POINTS[k % len(faults.KILL_POINTS)]
        # mid_save >= 2 so a published snapshot precedes the kill
        kill_at = {"iteration": 1 + int(rng.integers(6)), "pre_commit": 1 + int(rng.integers(5)),
                   "mid_save": 2 + int(rng.integers(2))}[site]
        eng.set_faults(faults.FaultConfig(seed=k, kill_at=kill_at, kill_point=site))
        rid0 = eng._rid
        streamed = {}
        try:
            out = eng.generate_requests(prompts, n_tok, on_token=stream_cb(streamed))
        except faults.SimulatedCrash:
            out = None
        eng.set_faults(None)
        if out is not None:  # the kill point fell beyond this run
            for i, row in enumerate(out):
                np.testing.assert_array_equal(row, ref[i])
            continue
        kills += 1
        step = manager.latest_step(d)
        assert step is not None, (cell, k, site, kill_at)
        eng.load_snapshot(step=step)  # warm restore: same engine, new state
        resumed = {}

        def cb2(rid, toks, start, resumed=resumed, streamed=streamed):
            assert start == len(streamed.get(rid, [])) + len(resumed.setdefault(rid, [])), (
                rid, start)
            resumed[rid].extend(int(t) for t in toks)

        results = eng.resume(on_token=cb2, delivered={r: len(t) for r, t in streamed.items()})
        resumed_rids = set()
        for r in results:
            resumed_rids.add(r.rid)
            idx = r.rid - rid0 - 1
            np.testing.assert_array_equal(r.tokens, ref[idx],
                                          err_msg=f"{CHAOS_CELLS[cell]} kill {k} ({site})")
            gen = [int(t) for t in r.tokens[len(r.tokens) - r.n_generated:]]
            assert streamed.get(r.rid, []) + resumed.get(r.rid, []) == gen
        # requests finished before the snapshot are not in it, and their
        # streams were delivered whole
        for rid, toks in streamed.items():
            if rid not in resumed_rids:
                idx = rid - rid0 - 1
                assert toks == [int(t) for t in ref[idx][len(prompts[idx]):]]
        assert_no_leaks(eng)
    _KILL_TALLY[cell] = kills
    assert kills >= 10, (cell, kills)


def test_kill_point_coverage_floor():
    """The fuzz above fired at least 100 kills over the matrix (this test
    runs after its cells, in the same process)."""
    assert len(_KILL_TALLY) == len(CHAOS_CELLS), "run with the fuzz cells of this file"
    assert sum(_KILL_TALLY.values()) >= 100, _KILL_TALLY
