"""The port's data pipeline, runtime monitor, ``Trainer`` and launchers
against the JAX reference on the CPU.

* ``MarkovLM``, ``SyntheticVision`` and ``Prefetcher``: the reference's
  batches, ``seek`` included.
* A 6-step ``Trainer`` run under awdbb with a W-DBB schedule against the
  reference ``Trainer`` from the same initial params and stream: every
  mask refresh bit for bit; the losses within 1e-4 relative (f32; the
  params part by rounding, 1e-4 absolute at most after AdamW's first
  step, see ``test_torch_train_step.py``); and before every step, each
  side's own params on that step's batch make the same Top-NNZ selection
  at every DAP call (so a selection flip fails by its call index).
* Save, restore and resume inside the port, bit for bit.
* ``PreemptionGuard`` stops the run and saves; ``StragglerDetector``
  gives the reference's verdicts.
* Both launchers' ``main`` at smoke size with ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import schedule as jschedule
from repro.data import pipeline as jpipe
from repro.runtime import monitor as jmon
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import dbb as tdbb
from repro_torch.core import schedule as tschedule
from repro_torch.core import tree
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.runtime import monitor as tmon
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from _torch_parity import small_cfgs
from _torch_train import (
    assert_same_selections,
    assert_trees_close,
    port_selections,
    reference_init,
    reference_selections,
)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
SCHED = dict(begin_step=0, end_step=4, update_every=2)
B, S = 2, 16


def _same_batches(a, b, n):
    for _ in range(n):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            assert x[k].dtype == y[k].dtype


@pytest.mark.parametrize("hosts", [(0, 1), (1, 3)])
def test_markov_lm_matches_reference(hosts):
    host_id, n_hosts = hosts
    kw = dict(vocab=96, batch=3, seq=12, seed=4, host_id=host_id, n_hosts=n_hosts)
    j, t = jpipe.MarkovLM(**kw), tpipe.MarkovLM(**kw)
    np.testing.assert_array_equal(t.probs, j.probs)
    _same_batches(iter(j), iter(t), 3)
    j.seek(7)
    t.seek(7)
    _same_batches(j, t, 2)
    assert t._step == j._step == 9


def test_synthetic_vision_matches_reference():
    kw = dict(n_classes=5, shape=(4, 4, 3), batch=6, seed=2)
    j, t = jpipe.SyntheticVision(**kw), tpipe.SyntheticVision(**kw)
    _same_batches(j, t, 3)


def test_prefetcher_yields_the_stream_and_closes():
    items = [{"x": np.full((2,), i)} for i in range(5)]
    got = [it["x"][0] for it in tpipe.Prefetcher(iter(items), depth=2)]
    want = [it["x"][0] for it in jpipe.Prefetcher(iter(items), depth=2)]
    assert got == want == list(range(5))
    pf = tpipe.Prefetcher(tpipe.MarkovLM(32, 2, 4, seed=0), depth=2)
    _same_batches(pf, jpipe.MarkovLM(32, 2, 4, seed=0), 3)
    pf.close()
    assert not pf._thread.is_alive()


def _straggler_cases():
    rng = np.random.default_rng(0)
    return [
        [(0, 1.0), (1, 1.0), (2, 3.0)],
        [(0, 1.0), (2, 2.0)],  # host 1 never reported
        [(0, 0.0), (1, 0.0)],  # a zero fleet median flags nobody
        [(int(h), float(t)) for h, t in zip(rng.integers(0, 4, 60), rng.gamma(2.0, 1.0, 60))],
    ]


@pytest.mark.parametrize("case", range(4))
def test_straggler_detector_matches_reference(case):
    j, t = jmon.StragglerDetector(4, window=5), tmon.StragglerDetector(4, window=5)
    assert t.stragglers() == j.stragglers() == []
    for host, dt in _straggler_cases()[case]:
        j.report(host, dt)
        t.report(host, dt)
        assert t.stragglers() == j.stragglers()


def _cfgs(arch="granite_3_8b"):
    return small_cfgs(arch)


def _port_trainer(tcfg, tparams, ckpt_dir=None, steps=6, sched=SCHED, data=None):
    wdbb = tschedule.WDBBSchedule(tdbb.DBBConfig(4, 8), **sched) if sched else None
    return ttrainer.Trainer(
        tcfg, topt.OptimizerConfig(**OPT),
        ttrainer.TrainerConfig(total_steps=steps, log_every=0, ckpt_dir=ckpt_dir, wdbb=wdbb),
        data if data is not None else tpipe.MarkovLM(tcfg.vocab, B, S, seed=0),
        device="cpu", params=tparams)


def _spy_masks(monkeypatch, mod, seen):
    orig = mod.wdbb_masks

    def spy(params, cfg, predicate=None):
        out = orig(params, cfg, predicate=predicate)
        seen.append((cfg.nnz, out))
        return out

    monkeypatch.setattr(mod, "wdbb_masks", spy)


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m"])
def test_trainer_matches_reference(monkeypatch, arch):
    jcfg, tcfg = _cfgs(arch)
    params, tparams = reference_init(jcfg)  # init_lm(cfg, PRNGKey(0)): the reference Trainer's
    jseen, tseen = [], []
    _spy_masks(monkeypatch, jschedule, jseen)
    _spy_masks(monkeypatch, tschedule, tseen)
    jt = jtrainer.Trainer(
        jcfg, jopt.OptimizerConfig(**OPT),
        jtrainer.TrainerConfig(total_steps=6, log_every=0,
                               wdbb=jschedule.WDBBSchedule(jdbb.DBBConfig(4, 8), **SCHED)),
        jpipe.MarkovLM(jcfg.vocab, B, S, seed=0))
    assert_trees_close(tparams, jt.params, atol=0, rtol=0, what="init")
    tt = _port_trainer(tcfg, tparams)
    probe = tpipe.MarkovLM(jcfg.vocab, B, S, seed=0)
    jh, th = [], []
    for step in range(6):
        batch = next(probe)
        assert_same_selections(port_selections(monkeypatch, tt.params, batch, tcfg),
                               reference_selections(monkeypatch, jt.params, batch, jcfg),
                               f"step {step}")
        jh += jt.run(1)
        th += tt.run(1)
    assert [n for n, _ in tseen] == [n for n, _ in jseen] == [8, 5, 4]  # steps 0, 2, 4: ceil(4 + 4 (1 - t)^3)
    for (_, tm), (_, jm) in zip(tseen, jseen):
        assert_trees_close(tm, jm, atol=0, rtol=0, what="masks")
    for k in ("loss", "ce", "aux", "acc", "grad_norm", "lr"):
        np.testing.assert_allclose([h[k] for h in th], [h[k] for h in jh], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert all(np.isfinite(h["loss"]) for h in th)
    assert all(h["step_time"] > 0 for h in th)
    assert tt.step == jt.step == 6 and int(tt.opt_state.step) == 6


def test_trainer_resume_is_bit_exact(tmp_path):
    """4 steps straight == 2 steps, save, a new trainer restored from the
    checkpoint (data stream sought), 2 steps: params, moments and step bit
    for bit (masks refresh every 2 steps: the resumed trainer recomputes
    them at step 2, as the uninterrupted run does)."""
    jcfg, tcfg = _cfgs()
    _, tparams = reference_init(jcfg)
    a = _port_trainer(tcfg, tparams)
    a.run(4)
    d = str(tmp_path / "ckpt")
    b = _port_trainer(tcfg, tparams, ckpt_dir=d)
    b.run(2)
    b.save()
    assert ckpt.latest_step(d) == 2
    c = _port_trainer(tcfg, tparams, ckpt_dir=d)  # restores at construction
    assert c.step == 2 and c.data._step == 2 and int(c.opt_state.step) == 2
    c.run(2)
    for name, x, y in (("params", a.params, c.params), ("mu", a.opt_state.mu, c.opt_state.mu),
                       ("nu", a.opt_state.nu, c.opt_state.nu), ("masks", a.masks, c.masks)):
        for p, q in zip(tree.leaves(x), tree.leaves(y)):
            assert p.dtype == q.dtype and torch.equal(p, q), name
    assert int(c.opt_state.step) == 4


def test_preemption_guard_stops_and_saves(tmp_path):
    """The guard signalled while step 2's batch is drawn: that step
    completes, the loop stops, and the final checkpoint is step 3."""
    jcfg, tcfg = _cfgs()
    _, tparams = reference_init(jcfg)
    d = str(tmp_path / "ckpt")
    tr = None

    class Signalling:
        def __init__(self):
            self.inner = tpipe.MarkovLM(tcfg.vocab, B, S, seed=0)

        def __next__(self):
            if self.inner._step == 2:
                tr.guard.signal()
            return next(self.inner)

        def seek(self, step):
            self.inner.seek(step)

    tr = _port_trainer(tcfg, tparams, ckpt_dir=d, data=Signalling())
    hist = tr.run(6)
    assert len(hist) == 3 and tr.step == 3 and tr.guard.should_stop
    assert ckpt.latest_step(d) == 3
    g, jg = tmon.PreemptionGuard(), jmon.PreemptionGuard()
    assert g.should_stop is jg.should_stop is False
    g.signal()
    jg.signal()
    assert g.should_stop is jg.should_stop is True


def test_trainer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    jcfg, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(tcfg, topt.OptimizerConfig(), ttrainer.TrainerConfig(),
                         tpipe.MarkovLM(tcfg.vocab, B, S))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--steps", "1"])


def test_trainer_draws_its_own_params():
    """Without params the trainer draws them from its generator
    (``lm.init_params(..., wire_dtype=None)``, ``encdec.init_params`` for
    whisper): the same seed, the same params."""
    for arch in ("granite_3_8b", "whisper_base"):
        _, tcfg = _cfgs(arch)
        mk = lambda: ttrainer.Trainer(  # noqa: E731
            tcfg, topt.OptimizerConfig(), ttrainer.TrainerConfig(), iter(()),
            torch.Generator().manual_seed(3), device="cpu")
        a, b = mk(), mk()
        for p, q in zip(tree.leaves(a.params), tree.leaves(b.params)):
            assert torch.equal(p, q)
        assert "dec_layers" in a.params if arch == "whisper_base" else "layers" in a.params


def test_train_launcher_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    hist = tlaunch.main(["--arch", "granite_moe_1b_a400m", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2", "--wdbb-end", "2",
                         "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.latest_step(d) == 2
    out = capsys.readouterr().out
    assert "family=moe sparsity=awdbb" in out and "final loss" in out
    # a second launch resumes from the checkpoint and runs its 3 steps on
    hist2 = tlaunch.main(["--arch", "granite_moe_1b_a400m", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", d, "--device", "cpu",
                          "--sparsity", "wdbb"])
    assert len(hist2) == 3
    assert "restored checkpoint at step 2" in capsys.readouterr().out


def test_serve_launcher_on_cpu(capsys):
    out = tserve.main(["--device", "cpu", "--pack", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"])
    assert out.shape == (2, 12)
    assert "packed=True" in capsys.readouterr().out
    out2 = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                        "--arch", "mamba2_130m"])
    assert out2.shape == (2, 12)
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--arch", "whisper_base"])
