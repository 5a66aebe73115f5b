"""Shared model building blocks (port of ``repro.models.common``): norms,
the packed activation hand-off and the DBB-aware linear layer.

Parameters are plain dictionaries of tensors with the reference's keys:
``{"w"}`` dense, ``{"w_vals", "w_mask"}`` on the native DBB wire (values
in the model dtype) and ``{"w_vals", "w_mask", "w_scale"}`` on the int8
wire.

Every ``make_*`` of the port has a ``*_specs`` beside it: the sharding
intent of the dense tree it draws, as the reference's ``make_*`` returns
it (``PartitionSpec`` leaves over the axis names below; sanitized against
a concrete mesh by ``sharding/partition.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import dbb, quant
from repro_torch.core.dap import apply_dap
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import epilogue, ops
from repro_torch.sharding import context
from repro_torch.sharding.partition import P

# Logical mesh axis names (launch/mesh.py).
POD, DATA, MODEL = "pod", "data", "model"
BATCH_AXES = (POD, DATA)  # batch shards over both


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# --------------------------------------------------------------------- init


def make_linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.bfloat16, device="cuda", scale: Optional[float] = None):
    """Seeded dense linear ``{"w" [d_in, d_out]}`` (+ zero ``"b"``): normal
    draws in f32 times ``1/sqrt(d_in)``, cast to ``dtype`` (the reference's
    scale rule; its random stream is JAX's and cannot be reproduced)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    params = {"w": w.mul_(scale).to(dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def make_linear_by_columns(gen: torch.Generator, d_in: int, d_out: int, *,
                           dtype=torch.bfloat16, device="cuda"):
    """:func:`make_linear`'s seeded weight (no bias), drawn in f32 a slice
    of output columns at a time (the packers' slices, ``_column_slices``)
    into the one ``dtype`` weight, so the whole f32 weight never exists (a
    152064-column head at d 8192 is 4.98 GB in f32, 2.49 GB in bf16).  A
    weight of one slice is :func:`make_linear`'s draw; a wider one draws
    another stream."""
    w = torch.empty((d_in, d_out), dtype=dtype, device=device)
    for cols in _column_slices(d_in, d_out):
        w[:, cols] = make_linear(gen, d_in, cols.stop - cols.start, dtype=dtype,
                                 device=device)["w"]
    return {"w": w}


def linear_specs(spec: P = P(DATA, MODEL), *, bias: bool = False) -> dict:
    """A linear's spec intent: ``w`` by ``spec``, a bias by its output
    axis (the reference's ``make_linear`` specs)."""
    specs = {"w": spec}
    if bias:
        specs["b"] = P(spec[-1] if len(spec) >= 2 else None)
    return specs


def norm_specs(*, bias: bool = False) -> dict:
    specs = {"scale": P(None)}
    if bias:
        specs["bias"] = P(None)
    return specs


def make_norm(d: int, *, device="cuda", bias: bool = False):
    params = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if bias:
        params["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return params


# ---------------------------------------------------- packed activation flow


@dataclasses.dataclass
class PackedAct:
    """A-DBB activation in kernel wire format — the packed hand-off shared
    by sibling linears (Q/K/V, gate/up).  On the int8 wire ``vals`` is int8
    and ``scale`` the dynamic scale (scalar, or one per token); ``dtype``
    is the dense compute dtype outputs are produced in."""

    vals: torch.Tensor  # [..., K//BZ, NNZ]
    mask: torch.Tensor  # [..., K//BZ] uint8
    cfg: dbb.DBBConfig
    k: int
    dtype: torch.dtype
    scale: Optional[torch.Tensor] = None


ActOrPacked = Union[torch.Tensor, PackedAct]


def _active_dap_spec(sp: Optional[SparsityConfig], x, layer_idx, first_layer):
    if sp is None or sp.mode != "awdbb":
        return None
    if first_layer and sp.exclude_first_layer:
        return None
    spec = sp.a_spec(layer_idx)
    if spec is None or x.shape[-1] % spec.bz != 0:
        return None
    return spec


def mlp_input_targets(p, act: str) -> tuple:
    return (p["gate"], p["up"]) if act == "swiglu" else (p["up"],)


def maybe_pack_input(x: ActOrPacked, targets: Sequence[dict],
                     sparsity: Optional[SparsityConfig] = None,
                     layer_idx: Optional[int] = None,
                     first_layer: bool = False) -> ActOrPacked:
    """DAP-prune + pack ``x`` once for a group of packed-weight linears, or
    return ``x`` unchanged when the fused A/W-DBB path does not apply."""
    if isinstance(x, PackedAct) or not targets:
        return x
    if not all(isinstance(t, dict) and "w_vals" in t for t in targets):
        return x
    spec = _active_dap_spec(sparsity, x, layer_idx, first_layer)
    if spec is None:
        return x
    if all("w_scale" in t for t in targets):  # int8 wire end to end
        vals, mask, scale = ops.dap_pack_int8(
            x, spec.nnz, spec.bz,
            act_scale=sparsity.act_scale if sparsity else "per_tensor",
        )
        return PackedAct(vals, mask, spec.cfg, x.shape[-1], x.dtype, scale)
    vals, mask = ops.dap_pack(x, spec.nnz, spec.bz)
    return PackedAct(vals, mask, spec.cfg, x.shape[-1], x.dtype)


# ------------------------------------------------------------------ forward


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if xf.device.type == "cuda":
        # CUDA picks a row reduction's order from the number of rows: the
        # mean in float64, rounded once, keeps a row's result independent
        # of its batch (the CPU sums in f32 like the reference)
        xd = xf.double()
        var = (xd * xd).mean(dim=-1, keepdim=True).float()
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 mean and variance (``scale``, optional ``bias``).
    On CUDA the two means sum in float64 and round once, as
    :func:`rmsnorm`'s does, so a row's result does not depend on its
    batch; the CPU sums in f32 like the reference."""
    xf = x.float()
    if xf.device.type == "cuda":
        mu = xf.double().mean(dim=-1, keepdim=True).float()
        c = xf - mu
        var = (c.double() * c.double()).mean(dim=-1, keepdim=True).float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        c = xf - mu
        var = (c * c).mean(dim=-1, keepdim=True)
    out = c * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(x.dtype)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with the reference's f32 result (``preferred_element_type
    =float32``), multiplied in float64 and rounded once: the library picks
    its summation order from the shapes, and float64 keeps a row's rounded
    result independent of how many rows share the call."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of products without batch dimensions (``mm``, ``addmm``),
    recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, remat: str, x: torch.Tensor, *args):
    """``fn(x, *args)`` under the reference's per-layer remat while a
    gradient flows through ``x``: ``"full"`` keeps only the layer's input
    and recomputes the layer in the backward, ``"dots"`` also keeps the
    outputs of its unbatched matmuls, ``"none"`` keeps everything.
    Without a gradient (serving) ``fn`` runs plainly."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}; none|full|dots")
    if remat == "none" or not (torch.is_grad_enabled() and x.requires_grad):
        return fn(x, *args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, x, *args, use_reentrant=False, **kw)


def linear(p, x: ActOrPacked, *, sparsity: Optional[SparsityConfig] = None,
           layer_idx: Optional[int] = None, dap_input: bool = True,
           first_layer: bool = False, act: Optional[str] = None) -> torch.Tensor:
    """DBB-aware linear ``act(x @ w (+ b))``.

    * packed input and int8 wire weights: the joint A/W-DBB matmul
      (kernel #3); a native-packed input is quantized per tensor first;
    * packed input and native wire weights: the native joint A/W-DBB
      matmul (kernel #4); an int8-packed input is dequantized first;
    * dense input and int8 wire weights: DAP (when active), dynamic
      activation quantization, then the W-DBB matmul (kernel #2); with
      per-row scales DAP and the quantization are one step
      (``ops.dap_prune_int8``);
    * dense input and native wire weights: DAP (when active), then the
      native W-DBB matmul (kernel #1);
    * packed input and dense weights: expand the wire format, then the
      dense path (DAP is not re-applied);
    * dense weights: a plain matmul.

    On ``DTensor`` operands the layer runs as a region on local shards
    (:func:`_linear_region`).
    """
    if isinstance(x.vals if isinstance(x, PackedAct) else x, DTensor):
        return _linear_region(p, x, sparsity=sparsity, layer_idx=layer_idx,
                              dap_input=dap_input, first_layer=first_layer, act=act)
    sp = sparsity
    dtype, x_scale = x.dtype, None
    if isinstance(x, PackedAct):
        if "w_vals" in p:
            cfg_w = dbb.DBBConfig(sp.w_nnz, sp.bz) if sp else dbb.DBBConfig(4, 8)
            lead = x.vals.shape[:-2]
            vals2 = x.vals.reshape((-1,) + tuple(x.vals.shape[-2:]))
            mask2 = x.mask.reshape((-1,) + tuple(x.mask.shape[-1:]))
            if "w_scale" in p:
                if x.scale is not None:
                    x_scale = x.scale if x.scale.ndim == 0 else x.scale.reshape(-1)
                else:
                    # native-packed input meets int8 weights: quantize the
                    # packed values in place, per tensor
                    vals2, x_scale = quant.quantize(vals2)
                y2 = ops.dbb_matmul_aw_int8(
                    vals2, mask2, x_scale, p["w_vals"], p["w_mask"], p["w_scale"],
                    x.cfg, cfg_w, bias=p.get("b"), act=act, out_dtype=x.dtype,
                )
            else:
                if x.scale is not None:
                    # int8-packed input meets native weights: dequantize it,
                    # with the reference's scalar-scale broadcast
                    vals2 = quant.dequantize(vals2, x.scale, dtype=x.dtype)
                y2 = ops.dbb_matmul_aw(
                    vals2, mask2, p["w_vals"], p["w_mask"], x.cfg, cfg_w,
                    bias=p.get("b"), act=act, out_dtype=x.dtype,
                )
            return y2.reshape(tuple(lead) + tuple(y2.shape[-1:]))
        vals = x.vals
        if x.scale is not None:
            axis = None if x.scale.ndim == 0 else (-2, -1)
            vals = quant.dequantize(vals, x.scale, axis=axis, dtype=x.dtype)
        x = ops.expand_act(vals, x.mask, x.cfg)
    elif dap_input:
        spec = _active_dap_spec(sp, x, layer_idx, first_layer)
        if spec is not None and "w_scale" in p and sp.act_scale == "per_row":
            # DAP and the per-row quantization in one step (#5's int8 dense form)
            x, x_scale = ops.dap_prune_int8(x, spec.nnz, spec.bz)
        elif spec is not None:
            x = apply_dap(x, spec)

    if "w_vals" in p:
        cfg = dbb.DBBConfig(sp.w_nnz, sp.bz) if sp else dbb.DBBConfig(4, 8)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if "w_scale" in p:
            y2 = ops.dbb_matmul_int8(
                x2, p["w_vals"], p["w_mask"], p["w_scale"], cfg,
                x_scale=None if x_scale is None else x_scale.reshape(-1),
                bias=p.get("b"), act=act, out_dtype=dtype,
                act_scale=sp.act_scale if sp else "per_tensor",
            )
        else:
            y2 = ops.dbb_matmul(
                x2, p["w_vals"], p["w_mask"], cfg, bias=p.get("b"), act=act,
                out_dtype=dtype,
            )
        return y2.reshape(*lead, y2.shape[-1])
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return epilogue.apply_act(y, act)


def _local_bytes(t) -> int:
    t = t.to_local() if isinstance(t, DTensor) else t
    return t.numel() * t.element_size()


def _linear_region(p, x: ActOrPacked, *, act=None, **kw) -> torch.Tensor:
    """:func:`linear` on ``DTensor`` operands, as a region on local shards
    with Megatron's layouts, chosen mesh dim by mesh dim from where the
    input and the weight lie (the weight's in dim is dim 0, its out dim
    the last, packed or not):

    * the input sharded on a leading dim (the batch): it stays, and a
      weight sharded on that mesh dim is gathered (FSDP), unless the
      weight is out-sharded there and the input is the smaller to gather
      (decode's weight-stationary layout: the input is gathered and the
      output is out-sharded);
    * the weight out-sharded: column parallel, the input gathered whole,
      the output out-sharded;
    * the weight in-sharded, or the input sharded on its in dim: row
      parallel, the input sliced (or kept) on its in dim, the output a
      partial sum, whose bias and activation are applied after the
      region (on the reduced value);
    * else replicated.

    DTensor's own matmul propagation weighs each op alone and may leave
    the sequence and the batch both sharded, which no later flatten can
    take; here the layouts are fixed by the rules above."""
    packed = isinstance(x, PackedAct)
    xs = x.vals if packed else x
    mesh = xs.device_mesh
    w = p["w"] if "w" in p else p["w_vals"]
    n_w = w.ndim - 1
    # the input's in dim (its blocks when packed), and the output's out dim
    x_k = xs.ndim - (2 if packed else 1)
    x_pl, w_pl, o_pl = [], [], []
    partial, n_k = False, 1

    def k_splits(n):  # whole 8-blocks on every rank, for DAP and the wire
        return (w.shape[0] % n == 0 and xs.shape[x_k] % n == 0
                and (packed or (xs.shape[x_k] // n) % dbb.DEFAULT_BZ == 0))

    for m in range(mesh.ndim):
        xp = xs.placements[m]
        wp = w.placements[m] if isinstance(w, DTensor) else Replicate()
        w_on = wp.dim if isinstance(wp, Shard) else None
        if isinstance(xp, Shard) and xp.dim < x_k:
            if w_on == n_w and _local_bytes(xs) < _local_bytes(w):
                x_pl.append(Replicate()), w_pl.append(Shard(n_w)), o_pl.append(Shard(x_k))
            else:
                x_pl.append(xp), w_pl.append(Replicate()), o_pl.append(xp)
        elif w_on == n_w:
            x_pl.append(Replicate()), w_pl.append(Shard(n_w)), o_pl.append(Shard(x_k))
        elif (w_on == 0 or (isinstance(xp, Shard) and xp.dim == x_k)) and k_splits(
                n_k * mesh.size(m)):
            x_pl.append(Shard(x_k)), w_pl.append(Shard(0)), o_pl.append(Partial())
            partial, n_k = True, n_k * mesh.size(m)
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), o_pl.append(Replicate())
    n_pl = [Shard(0) if o == Shard(x_k) else Replicate() for o in o_pl]  # bias, scales
    split = context.split_dims(x_pl, w_pl, o_pl)

    def loc(t, pl):
        return context.local_shard(t, mesh, pl, split) if t is not None else None

    p_loc = {}
    for name, t in p.items():
        if name in ("b", "w_scale"):
            p_loc[name] = loc(t, n_pl)
        else:
            p_loc[name] = loc(t, [Shard(t.ndim - 1) if pl == Shard(n_w) else pl for pl in w_pl])
    bias = p_loc.pop("b", None) if partial else None
    if packed:
        k_loc = x.k
        for m, pl in enumerate(x_pl):
            if pl == Shard(x_k):
                k_loc //= mesh.size(m)
        scale = x.scale
        if scale is not None:  # one scalar, or one a token: the input's leading shards
            scale = loc(scale, [pl if isinstance(pl, Shard) and pl.dim < x_k and scale.ndim
                                else Replicate() for pl in x_pl])
        x_loc = PackedAct(loc(x.vals, x_pl), loc(x.mask, x_pl), x.cfg, k_loc, x.dtype, scale)
    else:
        x_loc = loc(x, x_pl)
    y = linear(p_loc, x_loc, act=None if partial else act, **kw)
    shape = list(y.shape)
    for m, pl in enumerate(o_pl):
        if isinstance(pl, Shard):
            shape[pl.dim] *= mesh.size(m)
    y = context.from_local(y, mesh, o_pl, shape)
    if partial:
        if bias is not None:
            y = y + p["b"].to(y.dtype)
        y = epilogue.apply_act(y, act)
    return y


# weight elements packed at a time: the plain packers' temporaries (int64
# sort keys and indices among them) take about 30 bytes an element, 9.3 GB
# for qwen2-vl-72b's 8192 x 152064 head in one piece
_PACK_ELEMS = 1 << 27


def _column_slices(d_in: int, d_out: int):
    """A ``[d_in, d_out]`` weight's output columns, ``_PACK_ELEMS``
    elements a slice at most."""
    step = max(1, _PACK_ELEMS // d_in)
    return [slice(j, min(j + step, d_out)) for j in range(0, d_out, step)]


def _pack_by_columns(pack, w: torch.Tensor, cfg):
    """``pack(w, cfg)`` over slices of ``w``'s output columns, joined: a
    packer works column by column (8-blocks run along K, scales are per
    output channel), so the bytes are those of one call on all of ``w``."""
    slices = _column_slices(*w.shape)
    if len(slices) == 1:
        return pack(w, cfg)
    parts = [pack(w[:, cols], cfg) for cols in slices]
    return tuple(torch.cat(t, dim=-1) for t in zip(*parts))


def pack_linear_params(p, sp: SparsityConfig, wire_dtype: str = "native"):
    """Dense linear params -> packed DBB wire format, bias carried over:
    ``"native"`` keeps the model dtype for the values, ``"int8"``
    quantizes them with per-output-channel scales (``w_scale``)."""
    if wire_dtype not in ("native", "int8"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; native|int8")
    cfg = dbb.DBBConfig(sp.w_nnz, sp.bz)
    if wire_dtype == "int8":
        w_vals, w_mask, w_scale = _pack_by_columns(ops.pack_weight_int8, p["w"], cfg)
        out = {"w_vals": w_vals, "w_mask": w_mask, "w_scale": w_scale}
    else:
        w_vals, w_mask = _pack_by_columns(ops.pack_weight, p["w"], cfg)
        out = {"w_vals": w_vals, "w_mask": w_mask}
    if "b" in p:
        out["b"] = p["b"]
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    return epilogue.apply_act(x, "silu")


def mlp_forward(p, x: ActOrPacked, *, act: str, sparsity=None, layer_idx=None):
    """Gated (swiglu) or plain (gelu) MLP: the input is DAP-packed once for
    gate+up, the activation fuses into the matmul epilogue, and the hidden
    tensor is re-packed for the down projection."""
    kw = dict(sparsity=sparsity, layer_idx=layer_idx)
    xin = maybe_pack_input(x, mlp_input_targets(p, act), sparsity, layer_idx)
    if act == "swiglu":
        g = linear(p["gate"], xin, act="silu", **kw)
        u = linear(p["up"], xin, **kw)
        h = g * u
    else:
        h = linear(p["up"], xin, act="gelu", **kw)
    hin = maybe_pack_input(h, (p["down"],), sparsity, layer_idx)
    return linear(p["down"], hin, **kw)
