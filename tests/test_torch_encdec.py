"""Port parity, the ``encdec`` family (whisper-base): ``common.layernorm``,
``rope.sinusoidal_embedding``, the cross-attention and
``encdec.encode``/``forward``/``decode_step`` against
``repro.models.encdec``'s, on weights the reference draws
(``encdec.init_encdec``) converted by ``convert.params_from_numpy`` (the
stacked ``enc_layers``/``dec_layers`` unstacked), dense and packed on
both wires, at ``_torch_parity.SMALL`` (2 + 2 layers, 24 frames).

Tolerances: f32 throughout, atol 1e-4 (``tests/test_torch_ring.py``'s
logits bound); the sinusoidal table within two f32 ulps of its largest
angle (ATen's and XLA's ``exp`` differ in the last ulp, as for M-RoPE,
and an ulp of a frequency is an ulp of ``pos * freq``: 1.2e-4 at
position 1499) plus 2e-6; the ring cache's slot positions bit for bit.
Greedy tokens of a decode loop equal the reference's on the pinned
case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import check_config_fields, chip_smoke_module, small_cfgs, to_np
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.models import rope as jrope
from repro.serve import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.models import rope as trope
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCH = "whisper_base"
B, T, S = 2, 24, 6
_SETUP = {}


def setup(wire):
    """Configs, the reference's params and the port's (packed on ``wire``
    by each side's ``pack_params_for_serving``), and the inputs."""
    if wire not in _SETUP:
        jcfg, tcfg = small_cfgs(ARCH)
        params, _ = jed.init_encdec(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, params)
        # non-zero layernorm biases and scales (the init draws 0 and 1)
        rng = np.random.default_rng(11)
        for tree in [np_params] + [np_params[k] for k in ("enc_layers", "dec_layers")]:
            for name, leaf in tree.items():
                if isinstance(leaf, dict) and "bias" in leaf:
                    leaf["bias"] = rng.normal(size=leaf["bias"].shape).astype(np.float32) * 0.1
                    leaf["scale"] = (1 + 0.1 * rng.normal(size=leaf["scale"].shape)).astype(
                        np.float32)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        tparams = params_from_numpy(np_params)
        assert len(tparams["enc_layers"]) == jcfg.n_enc_layers
        assert len(tparams["dec_layers"]) == jcfg.n_layers
        if wire is not None:
            params = jengine.pack_params_for_serving(params, jcfg, wire)
            tparams = tengine.pack_params_for_serving(tparams, tcfg, wire)
        frames = rng.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
        toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        _SETUP[wire] = (jcfg, tcfg, params, tparams, frames, toks)
    return _SETUP[wire]


@pytest.mark.parametrize("smoke", [False, True])
def test_whisper_config_matches_reference(smoke):
    check_config_fields(ARCH, smoke)


@pytest.mark.parametrize("bias", [False, True])
def test_layernorm_matches_reference(bias):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(size=64).astype(np.float32)
    want = jcommon.layernorm(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
    got = tcommon.layernorm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=0)
    made = tcommon.make_norm(64, device="cpu", bias=bias)
    assert sorted(made) == sorted(p) and not made.get("bias", torch.zeros(1)).any()


@pytest.mark.parametrize("n_pos,d", [(1500, 512), (6, 64), (3, 2)])
def test_sinusoidal_embedding_matches_reference(n_pos, d):
    got = to_np(trope.sinusoidal_embedding(n_pos, d))
    want = np.asarray(jrope.sinusoidal_embedding(n_pos, d))
    assert got.shape == want.shape == (n_pos, d) and got.dtype == np.float32
    angle_ulp = float(np.spacing(np.float32(n_pos - 1)))
    np.testing.assert_allclose(got, want, atol=2 * angle_ulp + 2e-6, rtol=0)


@pytest.mark.parametrize("wire", [None, "native", "int8"])
def test_cross_attention_matches_reference(wire):
    """``cross_attn_forward`` of decoder layer 0 over a random encoder
    output: ``wk``/``wv`` share one DAP+pack of it."""
    jcfg, tcfg, params, tparams, frames, _ = setup(wire)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 3, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["dec_layers"]["xattn"])
    want = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)
    got = tattn.cross_attn_forward(tparams["dec_layers"][0]["xattn"], torch.from_numpy(x),
                                   torch.from_numpy(enc), tcfg)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("wire", [None, "native", "int8"])
def test_encode_and_forward_match_reference(wire):
    jcfg, tcfg, params, tparams, frames, toks = setup(wire)
    want_enc = jed.encode(params, jnp.asarray(frames), jcfg)
    got_enc = ted.encode(tparams, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(to_np(got_enc), np.asarray(want_enc), atol=1e-4, rtol=0)
    want, _ = jed.forward(params, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    got = ted.forward(tparams, torch.from_numpy(frames), torch.from_numpy(toks), tcfg)
    assert got.shape == (B, S, jcfg.padded_vocab)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("wire", [None, "native", "int8"])
def test_decode_step_matches_reference(wire):
    """Teacher-forced ``decode_step`` over the ring (no positional table,
    as the reference's), then a greedy loop of 4 tokens on each side's own
    choices: logits at every step and the ring after, tokens equal."""
    jcfg, tcfg, params, tparams, frames, toks = setup(wire)
    enc_j = jed.encode(params, jnp.asarray(frames), jcfg)
    enc_t = ted.encode(tparams, torch.from_numpy(frames), tcfg)
    step = jax.jit(lambda p, c, e, t, pos: jed.decode_step(p, c, e, t, pos, jcfg))
    jc = jlm.make_cache(jcfg, B, 16)
    tc = tlm.make_cache(tcfg, B, 16, "cpu")
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    jt, tt = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    got_toks, want_toks = [], []
    for t in range(S + 4):
        jl, jc = step(params, jc, enc_j, jt, jnp.int32(t))
        tl, tc = ted.decode_step(tparams, tc, enc_t, tt, t, tcfg)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
        if t + 1 < S:
            jt, tt = jnp.asarray(toks[:, t + 1:t + 2]), torch.from_numpy(toks[:, t + 1:t + 2])
        else:
            jt = jnp.argmax(jl[:, :, :jcfg.vocab], axis=-1).astype(jnp.int32)
            tt = tl[:, :, :tcfg.vocab].argmax(dim=-1).to(torch.int32)
            want_toks.append(np.asarray(jt))
            got_toks.append(to_np(tt))
    np.testing.assert_array_equal(np.concatenate(got_toks, 1), np.concatenate(want_toks, 1))
    np.testing.assert_array_equal(to_np(tc["pos"]), np.asarray(jc["pos"]))
    np.testing.assert_allclose(to_np(tc["k"]), np.asarray(jc["k"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(tc["v"]), np.asarray(jc["v"]), atol=1e-4, rtol=0)


def test_init_params_shapes_match_reference():
    """The port's seeded ``encdec.init_params`` has the reference's tree,
    shapes and dtypes (its values are torch's draws), and packs as drawn."""
    jcfg, tcfg, _, tparams, _, _ = setup(None)
    mine = ted.init_params(tcfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(mine) == shapes(tparams)
    packed = ted.init_params(tcfg, torch.Generator().manual_seed(0), "cpu", wire_dtype="int8")
    assert "w_scale" in packed["dec_layers"][0]["xattn"]["wk"] and "w" in packed["embed"]
    with pytest.raises(ValueError, match="encdec"):
        ted.init_params(small_cfgs("granite_3_8b")[1], torch.Generator(), "cpu")


def test_chip_smoke_encdec_launches():
    """``chip_smoke.encdec_launches``, what the card's whisper run is held
    to, equals the plain calls of ``encode`` and of one ``decode_step`` on
    native-wire weights (the smoke's config, awdbb)."""
    from repro_torch.kernels import ops

    jcfg, tcfg, _, tparams, frames, toks = setup("native")
    smoke = chip_smoke_module()
    ops.reset_counters()
    enc = ted.encode(tparams, torch.from_numpy(frames), tcfg)
    got = {name: c.plain for name, c in ops.counters().items()}
    want = smoke.encdec_launches(tcfg, True)
    assert got == {name: want.get(name, 0) for name in got}
    cache = tlm.make_cache(tcfg, B, 8, "cpu")
    ops.reset_counters()
    ted.decode_step(tparams, cache, enc, torch.from_numpy(toks[:, :1]), 0, tcfg)
    got = {name: c.plain for name, c in ops.counters().items()}
    want = smoke.encdec_launches(tcfg, False)
    assert got == {name: want.get(name, 0) for name in got}
