"""Shared set-up of the ``test_torch_*`` parity suite: the same small
granite-3-8b configuration for the JAX reference and the PyTorch port,
weights drawn once by the reference and converted bit for bit, and the
engine's effective (int8-wire) sparsity settings on both sides."""

import dataclasses

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy

# the small_cfg of tests/test_serve.py: 2 layers, narrow widths, f32
SMALL = dict(vocab=64, d_model=64, d_ff=128, n_layers=2, dtype="float32")


def small_cfgs(**over):
    kw = dict(SMALL, **over)
    jcfg = dataclasses.replace(jconfigs.get_config("granite_3_8b", smoke=True), **kw)
    tcfg = dataclasses.replace(tconfigs.get_config("granite_3_8b", smoke=True), **kw)
    return jcfg, tcfg


def effective(jcfg, tcfg, kv_dtype="native"):
    """The configs the engines serve with on the int8 wire: per-row
    activation scales, the chosen KV dtype, and (reference) the gather
    paged-attention path."""
    jsp = dataclasses.replace(
        jcfg.sparsity, act_scale="per_row", kv_dtype=kv_dtype, paged_attn="gather"
    )
    tsp = dataclasses.replace(tcfg.sparsity, act_scale="per_row", kv_dtype=kv_dtype)
    return (
        dataclasses.replace(jcfg, sparsity=jsp),
        dataclasses.replace(tcfg, sparsity=tsp),
    )


def reference_params(jcfg, seed=0):
    """(JAX params, the same params converted for the port)."""
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return params, tparams


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
