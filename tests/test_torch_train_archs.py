"""One training step of every ported arch against the JAX reference on the
CPU: the port's mirror of ``tests/test_models.py::
test_arch_forward_and_train_step``, held to the reference's numbers (the
archs split over this file and ``test_torch_train_archs_more.py``).

Each arch's small configuration (``_torch_parity.small_cfgs``: 2 layers,
narrow widths, f32, the arch's awdbb sparsity, every bias non-zero) runs
one ``train_step`` on the same converted params and seeded batch (the
VLM with 8 patch embeddings and its M-RoPE streams, whisper with frames).
Before the step both forwards make the same Top-NNZ selection at every
DAP call.  Then: logits of the padded vocabulary and finite; loss and the
metrics within 1e-5 relative; moments within 1e-4 (mu) and 2e-4 (nu) of
each leaf's largest; params within 1e-4 absolute at lr 1e-3 (AdamW's
first step, ``test_torch_train_step.py``'s docstring).  And the port's
three remat modes give the same gradients bit for bit (recomputing a
layer repeats its operations in order).
"""

import dataclasses

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import tree
from repro_torch.models import lm as tlm

from _torch_parity import small_cfgs
from _torch_train import arch_step_matches, batch_for, port_grads, reference_init, tbatch

# the first half of the archs; test_torch_train_archs_more.py has the rest
ARCHS = ("granite_3_8b", "minicpm3_4b", "granite_moe_1b_a400m", "starcoder2_15b",
         "phi3_5_moe_42b_a6_6b", "qwen1_5_110b")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_train_step_matches_reference(monkeypatch, arch):
    arch_step_matches(monkeypatch, arch)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "mamba2_130m", "whisper_base",
                                  "minicpm3_4b"])
def test_remat_modes_same_grads(arch):
    jcfg, tcfg = small_cfgs(arch)
    _, tparams = reference_init(jcfg, bias_seed=2)
    batch = batch_for(jcfg)
    grads = {}
    for mode in ("none", "full", "dots"):
        grads[mode] = port_grads(dataclasses.replace(tcfg, remat=mode), tparams, batch)
    for mode in ("full", "dots"):
        for a, b in zip(tree.leaves(grads["none"]), tree.leaves(grads[mode])):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError, match="remat"):
        port_grads(dataclasses.replace(tcfg, remat="some"), tparams, batch)


def test_the_split_covers_every_arch():
    from test_torch_train_archs_more import ARCHS as MORE

    assert sorted(ARCHS + MORE) == sorted(tconfigs.ARCH_IDS)


def test_forward_positions_and_prefix():
    """Explicit ``positions`` equal to the default give the same logits; a
    VLM prefix lengthens the output by its patches; ``with_aux=False``
    keeps the serving callers' logits-only return."""
    jcfg, tcfg = small_cfgs("qwen2_vl_72b")
    _, tparams = reference_init(jcfg)
    b = tbatch(batch_for(jcfg))
    with torch.no_grad():
        a = tlm.forward(tparams, b["tokens"], tcfg)
        pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
        c = tlm.forward(tparams, b["tokens"], tcfg, positions=pos)
        d = tlm.forward(tparams, b["tokens"], tcfg, patch_embeds=b["patch_embeds"],
                        pos3=b["pos3"])
    assert torch.equal(a, c)
    assert d.shape[1] == 24 and a.shape[1] == 16
