"""A whole run of the harness on the CPU at a small size, past its look
for a card: the window, the kernel-path guard and the comparison with the
reference.  A sound run is correct; the control (the reference one
precision step below the configuration's) and each fault a served cell
can have, planted in the timed path, come out not correct against the
cell's own limit."""

import numpy as np
import pytest

import pb_harness
import pb_reference
import pb_spec
from repro_torch.models import attention, lm
from repro_torch.serve import engine as engine_mod

CELLS = {"granite-3-8b.int8": "granite-3-8b.int8.longdoc",
         "minicpm3-4b.native": "minicpm3-4b.native.longdoc"}
# the served path at a size the CPU runs in a second: kernel #6's plain
# version ("fused"), which the reference rounds as (one split a row)
MIX = {"name": "small", "prompt_len": {"dist": "loguniform", "min": 6, "max": 40},
       "output_len": {"dist": "loguniform", "min": 3, "max": 12}, "round_size": 4,
       "pairing_seed": 0,
       "engine": {"max_batch": 2, "prefill_chunk": 8, "max_seq": 56, "page_size": 8,
                  "decode_block": 4, "prefix_cache": True, "paged_attn": "fused"},
       "check": {"served_tokens": 1000}}


def small(name: str, layers: int = 2) -> dict:
    cfg = pb_spec.config(name)
    m = dict(cfg["model"], n_layers=layers, d_model=128, n_heads=4, d_ff=256, vocab=512)
    if "mla" in m:
        m["mla"] = {"q_lora_rank": 64, "kv_lora_rank": 32, "qk_nope_head_dim": 32,
                    "qk_rope_head_dim": 16, "v_head_dim": 32}
    else:
        m["n_kv_heads"] = 2
    return dict(cfg, model=m)


def limits(name: str) -> dict:
    """The cell's own limits (``checks/<cell>.json``)."""
    checks = pb_spec.load_json(pb_spec.HERE / "checks" / f"{CELLS[name]}.json")
    return {k: v["limit"] for k, v in checks.items()}


def run(name: str, seed: int = 7, layers: int = 2, **kw) -> dict:
    return pb_harness.run_cell(small(name, layers), MIX, seed, 0.0, False, "cpu", limits(name),
                               **kw)


# int4 on granite departs from the reference two layers deep; fp8 on
# minicpm3 only over many layers, so its control runs at the cell's depth
CONTROL_LAYERS = {"granite-3-8b.int8": 2, "minicpm3-4b.native": 62}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct_and_control_is_not(name):
    layers = CONTROL_LAYERS[name]
    cfg = small(name, layers)
    out = run(name, layers=layers, controls=[pb_reference.control(cfg)])
    assert out["correct"], out["checks"]
    assert out["attempted"] == MIX["round_size"] and out["failed"] == 0
    r, ctl = out["readings"], out["readings"]["control_0"]
    assert r["served"] == out["data"].gen_tokens
    for k, lim in limits(name).items():
        assert r[k] <= lim
    # the control (one precision step down) reads far from the reference
    # and fails the cell's own limits
    assert ctl["gap_mean"] > 10 * r["gap_mean"] + 0.2
    assert not all(v <= lim for v, lim in pb_harness.compared(ctl, limits(name)).values())
    for m in ("gen_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms", "pass_fill", "mfu"):
        assert pb_spec.reader(m)(out["data"]) > 0


def _token_altered(monkeypatch):
    def plus_one(orig):
        return lambda *a, **k: (orig(*a, **k) + 1) % 512
    monkeypatch.setattr(engine_mod, "sample_or_greedy", plus_one(engine_mod.sample_or_greedy))
    monkeypatch.setattr(lm, "sample_or_greedy", plus_one(lm.sample_or_greedy))


def _one_slot_altered(monkeypatch):
    """Only the tokens of batch row 0 are altered: one slot serves wrong
    answers while the others are sound."""
    def row0(orig):
        def altered(*a, **k):
            tok = orig(*a, **k).clone()
            tok[0] = (tok[0] + 1) % 512
            return tok
        return altered
    monkeypatch.setattr(engine_mod, "sample_or_greedy", row0(engine_mod.sample_or_greedy))
    monkeypatch.setattr(lm, "sample_or_greedy", row0(lm.sample_or_greedy))


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(attention, "paged_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    step = lm.paged_step

    def half(*a, **k):
        logits, cache = step(*a, **k)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, cache
    monkeypatch.setattr(lm, "paged_step", half)


@pytest.mark.parametrize("fault", [_token_altered, _one_slot_altered, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "one_slot_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_fault_in_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run("granite-3-8b.int8")
    assert not out["correct"]
    assert any(out["checks"][k][0] > lim for k, lim in limits("granite-3-8b.int8").items())


def test_sample_holds_the_longest():
    reqs = [dict(prompt=np.zeros(n, np.int32), n_gen=g) for n, g in
            [(10, 5), (50, 20), (30, 5), (20, 5), (40, 40)]]
    got = pb_harness.sample_requests(reqs, 40, seed=3)
    assert got[0] is reqs[4] and sum(r["n_gen"] for r in got) >= 40
    assert got == pb_harness.sample_requests(reqs, 40, seed=3)
