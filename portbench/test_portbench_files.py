"""The benchmark's files: every piece BENCHMARK.json names is found by
name and parses, and the entries keep to the benchmark's format."""

import json
import re

import torch

import pb_harness
import pb_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = pb_spec.benchmark()


def test_configs_parse_and_are_whole():
    for c in BENCH["configs"]:
        cfg = pb_spec.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        # every published width and the depth are the ones run
        m, pub = cfg["model"], cfg["published"]
        assert m["n_layers"] == pub["num_hidden_layers"]
        assert m["d_model"] == pub["hidden_size"]
        assert m["n_heads"] == pub["num_attention_heads"]
        assert m["n_kv_heads"] == pub["num_key_value_heads"]
        assert m["d_ff"] == pub["intermediate_size"]
        assert m["vocab"] == pub["vocab_size"]
        if "mla" in m:
            for key in ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim"):
                assert m["mla"][key] == pub[key]


def test_cells_find_their_pieces():
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        mix = pb_spec.traffic(w["traffic"])
        assert mix["name"] == w["traffic"]
        e = mix["engine"]
        assert e["max_seq"] >= mix["prompt_len"]["max"] + mix["output_len"]["max"]
        checks = pb_spec.load_json(pb_spec.HERE / "checks" / f"{w['name']}.json")
        assert checks and set(checks) <= set(pb_harness.gap_stats(torch.zeros(2), [1, 1]))
        for c in checks.values():  # set between the two readings, with room on both sides
            assert c["lower"] < c["limit"] < c["upper"]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_metrics_have_readers():
    cells = {w["name"] for w in BENCH["workloads"]}
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert callable(pb_spec.reader(m["name"]))
            assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:  # every cell reports set-up, one more end-to-end metric, one per layer
        assert len(pb_spec.metrics_for(BENCH, cell, "end_to_end")) >= 2
        assert pb_spec.metrics_for(BENCH, cell, "per_layer")


def test_benchmark_json_size_and_keys():
    raw = (pb_spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(json.loads(raw)) == {"command", "paths", "run_seconds", "configs", "workloads",
                                    "end_to_end", "per_layer"}
