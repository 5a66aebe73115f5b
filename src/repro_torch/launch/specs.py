"""Abstract stand-ins and sharding intents for every dry-run input (port
of ``repro.launch.specs``).

Each builder returns a (tree, spec tree) pair: the tree's leaves are
fake tensors of the global shapes and dtypes (``FakeTensorMode``: nothing
is allocated), the spec tree has the same shape with :class:`P` leaves,
and ``partition.tree_shardings`` accepts the pair.  Trees are the
port's: per-layer lists where the reference stacks ``[L, ...]``.
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core import tree
from repro_torch.models import encdec, lm
from repro_torch.models.common import DATA, MODEL, dtype_of
from repro_torch.serve.engine import pack_params_for_serving
from repro_torch.sharding import context
from repro_torch.sharding.partition import P
from repro_torch.train import optimizer

N_VIS = 256  # VLM stub: patch-embedding tokens per sample

_FAKE = None


def fake_mode() -> FakeTensorMode:
    """The one ``FakeTensorMode`` every stand-in of this process is made
    under (fake tensors of two modes cannot meet in one op)."""
    global _FAKE
    if _FAKE is None:
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


@contextlib.contextmanager
def _abstract():
    """Build under the fake mode (re-entrant) and without a distribution
    context: the stand-ins are global, whatever mesh is set."""
    prev = context.get_context()
    context.set_context(None)
    try:
        mode = fake_mode()
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is mode:
            yield
        else:
            with mode:
                yield
    finally:
        context.set_context(prev)


def sds(shape, dtype):
    """A fake tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    with _abstract():
        return torch.empty(shape, dtype=dtype)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool):
    """Returns (abstract batch tree, spec tree)."""
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(multi_pod)
    dt = dtype_of(cfg.dtype)
    i32 = torch.int32
    if cfg.family == "encdec":
        batch = {"frames": sds((b, cfg.n_frames, cfg.d_model), dt),
                 "tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
        spec = {"frames": P(ba, None, None), "tokens": P(ba, None), "labels": P(ba, None)}
    elif cfg.family == "vlm":
        s_text = s - N_VIS
        batch = {"tokens": sds((b, s_text), i32), "labels": sds((b, s_text), i32),
                 "patch_embeds": sds((b, N_VIS, cfg.d_model), dt),
                 "pos3": sds((3, b, s), i32)}
        spec = {"tokens": P(ba, None), "labels": P(ba, None),
                "patch_embeds": P(ba, None, None), "pos3": P(None, ba, None)}
    else:
        batch = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
        spec = {"tokens": P(ba, None), "labels": P(ba, None)}
    return batch, spec


def prefill_specs(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool):
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(multi_pod)
    dt = dtype_of(cfg.dtype)
    i32 = torch.int32
    if cfg.family == "encdec":
        args = {"frames": sds((b, cfg.n_frames, cfg.d_model), dt), "tokens": sds((b, s), i32)}
        spec = {"frames": P(ba, None, None), "tokens": P(ba, None)}
    elif cfg.family == "vlm":
        args = {"tokens": sds((b, s - N_VIS), i32),
                "patch_embeds": sds((b, N_VIS, cfg.d_model), dt),
                "pos3": sds((3, b, s), i32)}
        spec = {"tokens": P(ba, None), "patch_embeds": P(ba, None, None),
                "pos3": P(None, ba, None)}
    else:
        args = {"tokens": sds((b, s), i32)}
        spec = {"tokens": P(ba, None)}
    return args, spec


def decode_specs(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool):
    """serve_step inputs: one new token + the KV/state cache of seq_len
    (the global ring: ``lm.make_cache`` without a context)."""
    b, s = cell.global_batch, cell.seq_len
    ba = batch_axes(multi_pod)
    dt = dtype_of(cfg.dtype)
    with _abstract():
        cache = lm.make_cache(cfg, b, s, "cpu")
    # cache batch dim is axis 1 ([L, B, ...]): widen to both batch axes
    cache_spec = {k: P(sp[0], ba, *sp[2:]) for k, sp in lm.cache_specs(cfg).items()}
    args = {"cache": cache, "tokens": sds((b, 1), torch.int32), "pos": sds((), torch.int32)}
    spec = {"cache": cache_spec, "tokens": P(ba, None), "pos": P()}
    if cfg.family == "encdec":
        args["enc_out"] = sds((b, cfg.n_frames, cfg.d_model), dt)
        spec["enc_out"] = P(ba, None, None)
    return args, spec


def _param_specs(cfg: ModelConfig):
    return encdec.param_specs(cfg) if cfg.family == "encdec" else lm.param_specs(cfg)


def abstract_model_state(cfg: ModelConfig, with_opt: bool):
    """(abstract params[, abstract opt_state], spec trees): the dense
    parameters of ``init_params`` (and ``optimizer.init``'s AdamW state)
    as fake tensors."""
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    with _abstract():
        gen = torch.Generator().manual_seed(0)
        params = init(cfg, gen, "cpu", wire_dtype=None)
        specs = _param_specs(cfg)
        if not with_opt:
            return params, specs
        opt = optimizer.init(params)
    return params, specs, opt, optimizer.OptState(step=P(), mu=specs, nu=specs)


def serving_specs(spec_tree):
    """Weight-stationary decode sharding (the reference's §Perf-A1): every
    matmul weight's OUT dim shards over ('data','model') = 256-way
    mega-TP and the IN dim stays unsharded, so no weight moves; the
    cross-device traffic becomes the activation-sized partial-sum
    reduces.  Embeddings and the expert axis keep their training specs.

    The rule reads each spec as the reference holds it, a per-layer
    leaf's stacked ``[L, ...]`` (a leading ``None``): so per-layer norms
    and biases, stacked to rank 2, are rewritten as the reference
    rewrites them."""

    def rewrite(sp, stacked):
        if not isinstance(sp, P):
            return sp
        full = P(None, *sp) if stacked else sp
        if len(full) < 2 or full == P(None, MODEL) or full[0] == MODEL:
            return sp
        out = P(*([None] * (len(full) - 1)), (DATA, MODEL))
        return P(*out[1:]) if stacked else out

    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked or (k in tree.STACKED and isinstance(v, list)))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, stacked) for v in node]
        return rewrite(node, stacked)

    return walk(spec_tree, False)


def packed_state(cfg: ModelConfig, params_abs, spec_tree):
    """Abstract DBB-packed serving params + matching specs (the
    reference's §Perf-A3): ``engine.pack_params_for_serving`` on the fake
    tree, native wire.  Weights become wire format (``w_vals [K/8, NNZ,
    N]`` + ``w_mask [K/8, N]``); the spec of the original OUT dim carries
    over to each packed tensor's last dim, everything else replicated."""
    with _abstract():
        packed = pack_params_for_serving(params_abs, cfg, "native")

    def build(spec_node, node):
        if isinstance(node, list):
            return [build(s, v) for s, v in zip(spec_node, node)]
        if isinstance(node, dict):
            if "w_vals" in node:
                w_spec = spec_node["w"]
                out_axis = w_spec[-1] if len(w_spec) else None
                out = {k: P(*([None] * (node[k].ndim - 1)), out_axis)
                       for k in ("w_vals", "w_mask")}
                if "b" in node:
                    out["b"] = spec_node["b"]
                return out
            return {k: build(spec_node[k], v) for k, v in node.items()}
        return spec_node

    return packed, build(spec_tree, packed)
