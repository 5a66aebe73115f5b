"""Port parity, engine: ``Engine.generate_requests`` of the port (on the
CPU, through the kernels' plain versions) vs the reference engine
(``paged_attn="gather"``) on the same converted weights, in the setting
of ``tests/test_serve.py``'s continuous-batching parity test: prompts of
lengths 9, 5 and 12, arrivals [0, 3, 1], ``max_batch=2``,
``page_size=8``, ``prefill_chunk=4``, int8 wire, int8 and native KV.

Greedy tokens are compared for equality on this pinned seed, beside a
logits-closeness check (atol 1e-4, see ``test_torch_model.py``) on every
position that chose a token: ULP-level differences between XLA and
ATen could flip a near-tied argmax on other seeds.  The port's own
invariants hold byte-exactly inside the port: continuous == each request
served alone, ``decode_block=1`` == ``decode_block=16``, and a call that
reuses cached prompt pages == the cold call.  Also the guards: no CUDA
device without ``device="cpu"``, and each setting an earlier slice refused
(stepped, auto, unpacked, sampled, gather, speculative decoding,
periodic snapshots) now constructs as the reference's does and serves
the reference's tokens."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    ARRIVALS,
    N_NEW,
    PACKED,
    SERVE,
    engines_match,
    invariants_byte_exact,
    prompts_for,
    reference_params,
    small_cfgs,
)
from repro.serve import engine as jengine
from repro_torch.core.sampling import SamplingParams
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs()
    params, tparams = reference_params(jcfg, seed=0)
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("kv_dtype", ["int8", "native"])
def test_engine_tokens_match_reference(weights, kv_dtype):
    jcfg, tcfg, params, tparams = weights
    engines_match(jcfg, tcfg, params, tparams, "int8", kv_dtype)


def test_engine_invariants_byte_exact(weights):
    _, tcfg, _, tparams = weights
    counts, eng = invariants_byte_exact(tcfg, tparams, "int8", "int8")
    # the int8 wire's kernels and DAP (#5's int8 forms: wo's input, the
    # packed inputs), their plain versions on the CPU
    assert all(launches == 0 for launches, _ in counts.values())
    assert {k for k, (_, plain) in counts.items() if plain > 0} == {
        "dbb_matmul_int8", "dbb_matmul_aw_int8", "paged_attn", "dap_prune_int8", "dap_pack_int8"}
    # every page is back in the pool (no prefix cache holds any), and every
    # dirty page is a free one
    alloc = eng._cont["allocator"]
    assert alloc.n_free == eng.scfg.total_pages - 1
    assert alloc.dirty_pages() <= set(alloc._free)


def test_engine_without_cuda_raises(weights, monkeypatch):
    _, tcfg, _, tparams = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine(tparams, tcfg, tengine.ServeConfig(**SERVE, **PACKED, wire_dtype="int8"))


# settings earlier slices refused, now served; fixed ids for xdist ("spec"
# and "snapshots" raised NotImplementedError until speculative decoding and
# snapshots were ported; "spec" names its SpecConfig, "snapshots" writes
# into the test's temporary directory)
LIFTED = {
    "stepped": dict(prefill_mode="stepped", pack_weights=True, wire_dtype="int8"),
    "auto": dict(prefill_mode="auto"),
    "unpacked": dict(prefill_mode="continuous", pack_weights=False),
    "sampled": dict(PACKED, wire_dtype="int8", temperature=0.7, seed=11),
    "gather": dict(PACKED, wire_dtype="int8", paged_attn="gather"),
    "spec": dict(PACKED, wire_dtype="int8", spec="nnz"),
    "snapshots": dict(PACKED, wire_dtype="int8", snapshot_every=4, snapshot_dir="snapshots"),
}


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_limits_serve(weights, name, tmp_path):
    """The config constructs equal to the reference's, field for field,
    and a short CPU serve gives the reference's tokens: one-shot
    ``generate`` for the stepped and auto modes, continuous
    ``generate_requests`` otherwise."""
    jcfg, tcfg, params, tparams = weights
    kw = dict(SERVE, **LIFTED[name])
    jkw, tkw = dict(kw), dict(kw)
    if "spec" in kw:
        jkw["spec"] = jengine.SpecConfig(draft=kw["spec"])
        tkw["spec"] = tengine.SpecConfig(draft=kw["spec"])
    if "snapshot_dir" in kw:
        jkw["snapshot_dir"] = str(tmp_path / "reference")
        tkw["snapshot_dir"] = str(tmp_path / "port")
    ref, port = jengine.ServeConfig(**jkw), tengine.ServeConfig(**tkw)
    for f in dataclasses.fields(jengine.ServeConfig):
        if f.name == "spec" and ref.spec is not None:
            assert dataclasses.asdict(port.spec) == dataclasses.asdict(ref.spec)
        elif f.name != "snapshot_dir":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    jeng = jengine.Engine(params, jcfg, ref)
    teng = tengine.Engine(tparams, tcfg, port, device="cpu")
    prompts = prompts_for(jcfg.vocab)
    if port.prefill_mode in ("stepped", "auto"):
        batch = np.stack([p[:5] for p in prompts])
        want, got = jeng.generate(batch, 4), teng.generate(batch, 4)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert teng.prefill_calls == (5 if port.prefill_mode == "stepped" else 1)
        assert teng.decode_calls == 4
        return
    want = jeng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    if port.spec is not None:
        assert teng.spec_stats() == jeng.spec_stats() and teng.spec_runs > 0
    if port.snapshot_every:
        import os

        from repro_torch.checkpoint import manager

        assert manager.all_steps(port.snapshot_dir)
        assert sorted(os.listdir(port.snapshot_dir)) == sorted(os.listdir(ref.snapshot_dir))


def test_non_dense_family_and_sampling_raise(weights):
    """``encdec`` raises (whisper runs through ``models/encdec.py``, not the
    engine); sampled decoding is ported, so a
    sampling temperature constructs."""
    _, tcfg, _, tparams = weights
    with pytest.raises(NotImplementedError, match="family 'encdec' is not served"):
        tengine.Engine(tparams, dataclasses.replace(tcfg, family="encdec"),
                       tengine.ServeConfig(**SERVE), device="cpu")
    assert not SamplingParams(temperature=0.5).greedy


# reference-valid configs of the continuous packed path, over the fields
# this slice added; fixed ids for xdist
REFERENCE_VALID = {
    "auto": dict(paged_attn="auto"), "fused": dict(paged_attn="fused"),
    "snapshot_dir": dict(snapshot_dir="snapshots", snapshot_keep=1),
    "hang_threshold": dict(hang_threshold=1.5),
    "page_size_2": dict(page_size=2, max_seq=64), "page_size_4": dict(page_size=4),
    "page_size_72": dict(page_size=72),
}
REFERENCE_INVALID = {
    "paged_attn": dict(paged_attn="ring"), "snapshot_every": dict(snapshot_every=-1),
    "snapshot_without_dir": dict(snapshot_every=3), "snapshot_keep": dict(snapshot_keep=0),
    "hang_threshold": dict(hang_threshold=1.0),
}
CONTINUOUS = dict(prefill_mode="continuous", pack_weights=True)


def test_serve_config_defaults_are_the_reference_s():
    """``ServeConfig()`` equals the reference's field for field, so the
    same config serves the same thing on both (dense weights, ``"auto"``)."""
    ref, port = jengine.ServeConfig(), tengine.ServeConfig()
    for f in dataclasses.fields(jengine.ServeConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.pack_weights, port.prefill_mode) == (False, "auto")


def test_serve_config_has_every_reference_field():
    """Every field of the reference's ServeConfig exists in the port's;
    the four this slice added keep the reference's defaults."""
    import dataclasses as dc

    ref = {f.name: f.default for f in dc.fields(jengine.ServeConfig)}
    port = {f.name: f.default for f in dc.fields(tengine.ServeConfig)}
    assert set(ref) <= set(port), set(ref) - set(port)
    for name in ("paged_attn", "snapshot_dir", "snapshot_keep", "hang_threshold"):
        assert port[name] == ref[name], name


@pytest.mark.parametrize("name", list(REFERENCE_VALID))
def test_reference_valid_serve_config_constructs(name):
    kw = dict(CONTINUOUS, **REFERENCE_VALID[name])
    ref = jengine.ServeConfig(**kw)
    port = tengine.ServeConfig(**kw)
    for key in kw:
        assert getattr(port, key) == getattr(ref, key), key


@pytest.mark.parametrize("name", list(REFERENCE_INVALID))
def test_reference_invalid_serve_config_raises(name):
    """A config the reference refuses is a ValueError in the port too,
    not a slice limit."""
    kw = dict(CONTINUOUS, **REFERENCE_INVALID[name])
    with pytest.raises(ValueError):
        jengine.ServeConfig(**kw)
    with pytest.raises(ValueError):
        tengine.ServeConfig(**kw)


def test_gather_and_large_pages_on_cuda_raise(weights):
    """``paged_attn="gather"`` serves on the CPU, with no launch of the
    fused kernel's plain version.  A page above 64 slots is no slice
    limit: the tensor-core kernels walk it as 64-slot sub-pages, so no
    engine refuses ``page_size=72`` for its device (the CUDA engine
    itself is built in ``tests/test_torch_cuda.py``); on the CPU it
    serves."""
    from repro_torch.kernels import ops

    _, tcfg, _, tparams = weights
    gather = tengine.Engine(tparams, tcfg, tengine.ServeConfig(
        **SERVE, **PACKED, paged_attn="gather"), device="cpu")
    ops.reset_counters()
    outs = gather.generate_requests(prompts_for(tcfg.vocab), N_NEW, arrivals=ARRIVALS)
    assert [len(o) for o in outs] == [n + N_NEW for n in (9, 5, 12)]
    assert ops.counters()["paged_attn"].plain == 0
    scfg = tengine.ServeConfig(**dict(SERVE, **PACKED, page_size=72))
    try:  # without a card it gets as far as moving the weights there
        tengine.Engine(tparams, tcfg, scfg, device="cuda")
    except NotImplementedError as err:
        pytest.fail(f"page_size=72 refused on CUDA: {err}")
    except (AssertionError, RuntimeError) as err:
        assert "CUDA" in str(err)
    eng = tengine.Engine(tparams, tcfg, scfg, device="cpu")
    assert eng.scfg.page_size == 72
