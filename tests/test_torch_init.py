"""``lm.init_params``'s memory-bounded draw: the f32 embedding draw is
cast and dropped before the layers, and an untied head is drawn in f32 a
slice of output columns at a time into its dtype
(``common.make_linear_by_columns``) and packed in the same slices, so the
whole f32 head never exists beside the packed layers (qwen1.5-110b's
152064 x 8192 head is 4.98 GB in f32).

Held here, bit for bit, on small configs in bf16 with an untied head:
the embedding and every layer are the draws of the plain order (the
embedding first, then each layer, then the head); a head that fits one
slice is ``make_linear``'s own draw, a wider one its draws side by side;
and a head packed in slices gives exactly the bytes of one pack."""

import dataclasses

import pytest
import torch

from _torch_parity import leaves, small_cfgs
from repro_torch.models import blocks, common
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)


def _cfg(arch="granite_3_8b"):
    _, tcfg = small_cfgs(arch, dtype="bfloat16")
    assert not tcfg.tie_embeddings
    return tcfg


def _plain_draw(cfg, seed):
    """The draw order without the slicing: the embedding, each layer
    packed to the int8 wire as it is drawn, then the head whole."""
    gen = torch.Generator().manual_seed(seed)
    sp, dtype = cfg.sparsity, torch.bfloat16

    def pack(p):
        if p["w"].shape[0] % sp.bz == 0:
            return common.pack_linear_params(p, sp, "int8")
        return p

    emb = (torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen) * 0.02).to(dtype)
    layers = [blocks.make_decoder_block(gen, cfg, dtype=dtype, device="cpu", pack=pack)
              for _ in range(cfg.n_layers)]
    head = pack(common.make_linear(gen, cfg.d_model, cfg.padded_vocab, dtype=dtype,
                                   device="cpu"))
    return {"embed": {"w": emb}, "layers": layers, "lm_head": head}


@pytest.mark.parametrize("arch", ["granite_3_8b", "qwen1_5_110b"])
def test_init_params_int8_keeps_the_embedding_layer_and_small_head_bits(arch):
    """On the int8 wire the embedding's bf16 bits, every packed layer and
    (one slice at these widths) the packed head equal the plain draw's."""
    cfg = _cfg(arch)
    got = dict(leaves(tlm.init_params(cfg, torch.Generator().manual_seed(4), "cpu",
                                      wire_dtype="int8")))
    want = dict(leaves(_plain_draw(cfg, 4)))
    assert set(want) <= set(got)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert got["/lm_head/w_vals"].dtype == torch.int8


@pytest.mark.parametrize("wire", ["int8", "native"])
def test_head_drawn_and_packed_by_slices_equals_one_pack(monkeypatch, wire):
    """A head drawn in slices of 48 columns (a ragged last one) is
    ``make_linear``'s draws side by side; packed in those slices it gives
    the bytes of one pack of the whole (``w_vals``, ``w_mask``,
    ``w_scale``), and ``init_params`` packs the head it draws with no
    wire."""
    cfg = _cfg()
    d, v = cfg.d_model, cfg.padded_vocab
    monkeypatch.setattr(common, "_PACK_ELEMS", d * 48)
    assert v % 48 != 0
    dense = common.make_linear_by_columns(torch.Generator().manual_seed(9), d, v,
                                          dtype=torch.bfloat16, device="cpu")
    assert dense.keys() == {"w"} and dense["w"].shape == (d, v)
    gen = torch.Generator().manual_seed(9)
    for j in range(0, v, 48):
        part = common.make_linear(gen, d, min(48, v - j), dtype=torch.bfloat16, device="cpu")
        assert torch.equal(dense["w"][:, j:j + 48], part["w"]), j
    sliced = common.pack_linear_params(dense, cfg.sparsity, wire)
    small = dataclasses.replace(cfg, n_layers=1)
    raw = tlm.init_params(small, torch.Generator().manual_seed(2), "cpu", wire_dtype=None)
    packed = tlm.init_params(small, torch.Generator().manual_seed(2), "cpu", wire_dtype=wire)

    monkeypatch.setattr(common, "_PACK_ELEMS", 1 << 27)
    whole = common.pack_linear_params(dense, cfg.sparsity, wire)
    after = tengine.pack_params_for_serving(raw, small, wire)
    assert sliced.keys() == whole.keys() == ({"w_vals", "w_mask", "w_scale"} if wire == "int8"
                                             else {"w_vals", "w_mask"})
    for name in whole:
        assert torch.equal(sliced[name], whole[name]), name
        assert torch.equal(packed["lm_head"][name], after["lm_head"][name]), name
