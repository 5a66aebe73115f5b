"""Port parity, MoE (granite-moe-1b-a400m): the configuration, the
parameter tree, ``moe_forward``, the paged step with idle and padding
rows, and the continuous engine, each held against ``repro`` on the
same numpy inputs or converted weights, at 2 layers and the ``SMALL``
widths in f32 (4 experts, top-2).

Expert capacity couples the tokens of a step: a token's output depends
on what it is batched with, in the reference too.  So every comparison
runs both sides at identical shapes, and a ``capacity_factor`` of 0.3
(at a 16-token step) makes the dispatch drop (token, expert) pairs.
Rows with no valid key (chunk padding, idle rows) are routed and take
capacity like any other, so their attention output — the uniform mean
over their page table — has to match too.

Tolerances, with their reasons:
  * ``moe_forward``: ``y`` atol 1e-5 and ``aux`` atol 1e-6 in f32 — the
    router, expert and combine sums run in another order than XLA's;
  * paged step logits and engine logits: atol 1e-4, as for the dense
    archs (the packed matmuls' plain versions multiply in float64);
  * configuration and parameter trees: exact, bit for bit; engine:
    greedy tokens equal on the pinned seed, and the port's own
    invariants byte-exact at a capacity that drops nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    SERVE,
    check_config_fields,
    effective,
    engines_match,
    invariants_byte_exact,
    leaves,
    reference_params,
    small_cfgs,
    to_np,
)
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro.serve import paged_cache as jpc
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

ARCH = "granite_moe_1b_a400m"
DROPPING = 0.3  # capacity factor at which a 16-token step drops pairs
# the parity suite's serve shape with 8-token chunks: 16-token mixed steps
SERVE_MOE = dict(SERVE, prefill_chunk=8)


def _cfgs(capacity_factor=None):
    jcfg, tcfg = small_cfgs(ARCH)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs(DROPPING)
    params, tparams = reference_params(jcfg)
    return jcfg, tcfg, params, tparams


class _Drops:
    """Counts the (token, expert) pairs the port's dispatch drops."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = tmoe._dispatch

        def spy(*a, **kw):
            out = inner(*a, **kw)
            self.n += int((~out[2]).sum())
            return out

        monkeypatch.setattr(tmoe, "_dispatch", spy)


# ------------------------------------------------------------ config, params


@pytest.mark.parametrize("smoke", [False, True])
def test_granite_moe_config_matches_reference(smoke):
    """Every field, ``MoEConfig`` and ``moe_groups`` included."""
    check_config_fields(ARCH, smoke)
    cfg = tconfigs.get_config(ARCH, smoke=smoke)
    assert cfg.family == "moe" and cfg.moe_groups == 1
    if not smoke:
        m = cfg.moe
        assert (m.n_experts, m.top_k, m.capacity_factor) == (32, 8, 1.25)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff) == (
            24, 1024, 16, 8, 512)
        # a 64-token mixed step of the smoke's serve shape: 24 slots per expert
        assert tmoe.capacity(64, cfg) == 24 and tmoe.capacity(4, cfg) == 8


def test_moe_tree_crosses_bit_exact(weights):
    """The stacked ``[L, E, d, f]`` experts and the f32 router cross
    ``params_from_numpy`` bit for bit (bf16 experts too), and the port's
    serving pack leaves router and experts dense and packs the attention
    linears to exactly the reference's bytes."""
    jcfg, tcfg, params, tparams = weights
    raw = dict(leaves(tparams))
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    for name, leaf in leaves(np_tree):
        if name.startswith("/layers/"):
            for i in range(leaf.shape[0]):
                t = raw["/layers/" + str(i) + "/" + name[len("/layers/"):]]
                np.testing.assert_array_equal(to_np(t), leaf[i], err_msg=name)
    assert tuple(raw["/layers/1/moe/gate"].shape) == (4, 64, 128)
    assert raw["/layers/0/moe/router/w"].dtype == torch.float32
    for wire in ("native", "int8"):
        jp = jengine.pack_params_for_serving(params, jcfg, wire)
        want = dict(leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))))
        got = dict(leaves(tengine.pack_params_for_serving(tparams, tcfg, wire)))
        assert got.keys() == want.keys(), wire
        assert "/layers/0/attn/wo/w_vals" in got and "/layers/0/moe/router/w" in got
        for name in ("/layers/0/moe/router/w", "/layers/1/moe/down"):
            assert got[name] is raw[name], name  # untouched
        for name in want:
            assert got[name].dtype == want[name].dtype, (wire, name)
            np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]),
                                          err_msg=f"{wire} {name}")
    bf16, _ = jmoe.make_moe(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    for name, leaf in leaves(jax.tree_util.tree_map(np.asarray, bf16)):
        t = tensor_from_numpy(leaf)
        assert t.dtype == (torch.float32 if "router" in name else torch.bfloat16), name
        np.testing.assert_array_equal(t.view(torch.int16 if leaf.dtype.itemsize == 2
                                             else torch.int32).numpy(),
                                      leaf.view(np.int16 if leaf.dtype.itemsize == 2
                                                else np.int32), err_msg=name)


# -------------------------------------------------------------- moe_forward


def test_top_k_ties_go_to_the_lower_expert():
    """``jax.lax.top_k``'s order, ties included; ``torch.topk`` promises
    none."""
    probs = np.array([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                       [0.3, 0.2, 0.3, 0.2]]], np.float32)
    want_p, want_e = jax.lax.top_k(jnp.asarray(probs), 2)
    got_p, got_e = tmoe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("capacity_factor,drops", [(1.5, False), (DROPPING, True)],
                         ids=["drop_free", "dropping"])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_forward_vs_reference(monkeypatch, capacity_factor, drops, n_groups):
    """``(y, aux)`` against the reference's single-device ``moe_forward``
    on the same input, DAP before the router included; rows 5.. of batch
    3 repeat one token, so routing probabilities tie across rows."""
    jcfg, tcfg = _cfgs(capacity_factor)
    p, _ = jmoe.make_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    x = np.random.default_rng(0).normal(size=(4, 16, 64)).astype(np.float32)
    x[3, 5:] = x[3, 4]
    counter = _Drops(monkeypatch)
    yj, aj = jmoe.moe_forward(p, jnp.asarray(x), jcfg, n_groups=n_groups)
    yt, at = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg, n_groups=n_groups)
    assert (counter.n > 0) == drops
    assert yt.shape == (4, 16, 64) and yt.dtype == torch.float32
    np.testing.assert_allclose(to_np(yt), np.asarray(yj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=0)


# ----------------------------------------------------- paged step, idle rows


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_paged_step_idle_and_padding_rows_with_drops(weights, monkeypatch, kv_dtype):
    """Two mixed steps of 3 rows x 8 tokens: row 0 and row 1 prefill
    with padding tails (position -1), row 2 is idle (token 0 at position
    -1 over an all-null page table).  The keyless rows attend to the
    uniform mean of their table — the null page holding the last padding
    token's K/V included — and are routed like any token; at capacity
    factor 0.3 the dispatch drops pairs.  Every row's logits, padding and
    idle ones included, match the reference's."""
    jcfg, tcfg, params, tparams = weights
    jcfg_e, tcfg_e = effective(jcfg, tcfg, kv_dtype, "native")
    jp = jengine.pack_params_for_serving(params, jcfg_e, "native")
    tp = tengine.pack_params_for_serving(tparams, tcfg_e, "native")
    ps, n_pages = 8, 8
    jcache = jpc.make_paged_cache(jcfg_e, n_pages, ps)
    tcache = tpc.make_paged_cache(tcfg_e, n_pages, ps, "cpu")
    tables = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32)
    rng = np.random.default_rng(7)
    steps = (
        (np.array([0, 0, -1]), np.array([8, 5, 0])),  # (first position, valid count)
        (np.array([8, 5, -1]), np.array([3, 8, 0])),
    )
    counter = _Drops(monkeypatch)
    for first, n_valid in steps:
        pos = np.full((3, 8), -1, np.int32)
        for r in range(3):
            pos[r, : n_valid[r]] = first[r] + np.arange(n_valid[r])
        toks = np.where(pos >= 0, rng.integers(0, jcfg.vocab, (3, 8)), 0).astype(np.int32)
        jl, jcache = jlm.paged_step(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                                    jnp.asarray(tables), jcfg_e)
        tl, tcache = tlm.paged_step(tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                                    torch.from_numpy(tables), tcfg_e)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
    assert counter.n > 0
    for name in ("k", "v") + (("k_scale", "v_scale") if kv_dtype == "int8" else ()):
        np.testing.assert_allclose(to_np(tcache[name][:, 0]), np.asarray(jcache[name][:, 0]),
                                   atol=1e-4, rtol=0, err_msg=f"null page {name}")


# ------------------------------------------------------------------- engine


@pytest.mark.parametrize("wire,kv_dtype", [("native", "native"), ("native", "int8"),
                                           ("int8", "native"), ("int8", "int8")])
def test_moe_engine_matches_reference(weights, monkeypatch, wire, kv_dtype):
    """granite-moe served continuously on either wire and KV dtype, at a
    capacity that drops pairs, with idle rows in the batch: tokens equal
    to the reference's continuous engine, replay logits within 1e-4; the
    attention linears through #1/#4 or #2/#3, attention through #6, and
    the DAP of wo, of the attention input and of the MoE input through
    #5, in the wire's forms."""
    jcfg, tcfg, params, tparams = weights
    counter = _Drops(monkeypatch)
    counts = engines_match(jcfg, tcfg, params, tparams, wire, kv_dtype, serve=SERVE_MOE)
    assert counter.n > 0
    mm = {"native": {"dbb_matmul", "dbb_matmul_aw", "dap_pack"},
          "int8": {"dbb_matmul_int8", "dbb_matmul_aw_int8", "dap_prune_int8",
                   "dap_pack_int8"}}[wire]
    assert {k for k, (_, plain) in counts.items() if plain > 0} == mm | {
        "paged_attn", "dap_prune"}
    # per forward pass: wo and lm_head take dense input; wo's input (on the
    # int8 wire quantized in the same step) and the MoE input are
    # DAP-pruned, the attention input DAP-packed
    n_l = tcfg.n_layers
    passes = counts["paged_attn"][1] // n_l
    dense = "dbb_matmul" if wire == "native" else "dbb_matmul_int8"
    assert counts[dense][1] == (n_l + 1) * passes
    assert counts["dap_prune"][1] == (2 if wire == "native" else 1) * n_l * passes
    assert counts["dap_prune_int8"][1] == (0 if wire == "native" else n_l * passes)
    pack = "dap_pack" if wire == "native" else "dap_pack_int8"
    assert counts[pack][1] == n_l * passes


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_moe_invariants_byte_exact(wire):
    """At the smoke's own capacity factor (1.5: a 8-token step drops
    nothing) a token's output does not depend on its co-batch, and the
    port's invariants hold byte for byte."""
    _, tcfg = _cfgs()
    _, tparams = reference_params(_cfgs()[0])
    counts, _ = invariants_byte_exact(tcfg, tparams, wire, "int8")
    assert counts["dap_prune"][1] > 0
