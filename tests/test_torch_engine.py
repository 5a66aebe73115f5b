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
reuses cached prompt pages == the cold call.  Also the guards of the
slice: no CUDA device without ``device="cpu"``, and every setting this
slice does not port raises ``NotImplementedError``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import effective, reference_params, small_cfgs, to_np
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch.core.sampling import SamplingParams
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

LENS, ARRIVALS, N_NEW = (9, 5, 12), [0, 3, 1], 6
SERVE = dict(max_seq=32, page_size=8, max_batch=2, prefill_chunk=4)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in LENS]


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs()
    params, tparams = reference_params(jcfg, seed=0)
    return jcfg, tcfg, params, tparams


def _port_engine(tcfg, tparams, **kw):
    scfg = tengine.ServeConfig(**{**SERVE, **kw})
    return tengine.Engine(tparams, tcfg, scfg, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["int8", "native"])
def test_engine_tokens_match_reference(weights, kv_dtype):
    jcfg, tcfg, params, tparams = weights
    prompts = _prompts(jcfg.vocab)
    jeng = jengine.Engine(params, jcfg, jengine.ServeConfig(
        prefill_mode="continuous", pack_weights=True, wire_dtype="int8",
        kv_dtype=kv_dtype, paged_attn="gather", **SERVE,
    ))
    want = jeng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    teng = _port_engine(tcfg, tparams, kv_dtype=kv_dtype)
    got = teng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    assert [r.finish_reason for r in teng.last_results] == ["length"] * 3
    # logits closeness at every position that chose a token: each request
    # replays its fed stream solo through one paged step on both sides
    jcfg_e, tcfg_e = effective(jcfg, tcfg, kv_dtype)
    for w in want:
        fed = w[:-1][None]
        s = fed.shape[1]
        pos = np.arange(s, dtype=np.int32)[None]
        table = np.arange(1, 1 + -(-s // 8), dtype=np.int32)[None]
        jl, _ = jlm.paged_step(
            jeng.params, jpc.make_paged_cache(jcfg_e, 6, 8), jnp.asarray(fed),
            jnp.asarray(pos), jnp.asarray(table), jcfg_e,
        )
        tl, _ = tlm.paged_step(
            teng.params, tpc.make_paged_cache(tcfg_e, 6, 8, "cpu"), torch.from_numpy(fed),
            torch.from_numpy(pos), torch.from_numpy(table), tcfg_e,
        )
        chose = slice(len(w) - N_NEW - 1, s)
        jrows = np.array(jl)[0, chose, : jcfg.vocab]
        trows = to_np(tl)[0, chose, : tcfg.vocab]
        np.testing.assert_allclose(trows, jrows, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(trows.argmax(-1), w[len(w) - N_NEW:])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")


def test_engine_invariants_byte_exact(weights):
    _, tcfg, _, tparams = weights
    prompts = _prompts(tcfg.vocab)
    ops.reset_counters()
    eng = _port_engine(tcfg, tparams, kv_dtype="int8", prefix_cache=False)
    outs = eng.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)
    counts = ops.counters()
    assert all(c.launches == 0 and c.plain > 0 for c in counts.values())
    # every page is back in the pool (no prefix cache holds any), and every
    # dirty page is a free one
    alloc = eng._cont["allocator"]
    assert alloc.n_free == eng.scfg.total_pages - 1
    assert alloc.dirty_pages() <= set(alloc._free)
    # continuous == each request served alone
    for i, p in enumerate(prompts):
        solo = _port_engine(tcfg, tparams, kv_dtype="int8").generate_requests([p], N_NEW)
        np.testing.assert_array_equal(outs[i], solo[0], err_msg=f"request {i} solo")
    # decode_block 1 == 16
    one = _port_engine(tcfg, tparams, kv_dtype="int8", decode_block=1, prefix_cache=False)
    for a, b in zip(outs, one.generate_requests(prompts, N_NEW, arrivals=ARRIVALS)):
        np.testing.assert_array_equal(a, b)
    assert eng.decode_run_calls > 0 and one.step_calls > eng.step_calls
    # shared-prefix second call == cold call
    warm = _port_engine(tcfg, tparams, kv_dtype="int8")
    long_prompt = np.concatenate([prompts[2], prompts[0]])[:20]
    cold = warm.generate_requests([long_prompt], N_NEW)
    again = warm.generate_requests([long_prompt], N_NEW)
    assert warm.prefix_stats()["page_hits"] > 0
    np.testing.assert_array_equal(again[0], cold[0])


def test_engine_without_cuda_raises(weights, monkeypatch):
    _, tcfg, _, tparams = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine(tparams, tcfg, tengine.ServeConfig(**SERVE))


SLICE_LIMITS = {  # fixed ids: every xdist worker must collect the same names
    "stepped": dict(prefill_mode="stepped"), "auto": dict(prefill_mode="auto"),
    "unpacked": dict(pack_weights=False), "native_wire": dict(wire_dtype="native"),
    "sampled": dict(temperature=0.7), "spec": dict(spec="draft"),
    "snapshots": dict(snapshot_every=4),
}


@pytest.mark.parametrize("name", list(SLICE_LIMITS))
def test_slice_limits_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.ServeConfig(**SLICE_LIMITS[name])


def test_non_dense_family_and_sampling_raise(weights):
    _, tcfg, _, tparams = weights
    with pytest.raises(NotImplementedError, match="dense GQA"):
        tengine.Engine(tparams, dataclasses.replace(tcfg, family="moe"),
                       tengine.ServeConfig(**SERVE), device="cpu")
    with pytest.raises(NotImplementedError, match="threefry"):
        SamplingParams(temperature=0.5)
