"""The plain reference: the served model's forward pass in plain PyTorch,
written from the model's description, with no kernel, cache or batching
of the program.  It imports nothing of ``repro_torch`` (nor JAX).

What it computes is what a configuration states: a pre-norm decoder
(GQA with RoPE, or MiniCPM3's multi-head latent attention), swiglu MLP,
RMSNorm, an untied head; every linear but MLA's ``kv_up`` under W-DBB
(the 4 largest magnitudes of each 8-block along the input, per output
column), every linear input but the head's under A-DBB by DAP (the 4
largest magnitudes of each 8-block, ties to the lower index); on the
int8 wire the kept weights quantized per output column and the inputs
per row (symmetric, ``amax / 127``, half to even), accumulated exactly;
the KV cache per token in int8 where the configuration says so.  Values
are rounded to bf16 where the served model stores them (linear outputs,
norms, the residual stream, attention outputs, probabilities before
``P @ V``); accumulations are exact (float64) or float32.

``precision`` names the arithmetic of the wire: ``int8`` and ``bf16``
are the configurations' own, ``int4`` and ``fp8`` (e4m3, scaled per row
or column) the step below each, which the correctness control runs.

The reference takes the dense weights the benchmark drew and derives its
pruned and quantized operands itself, layer by layer, so it fits beside
nothing else on the card.
"""

from __future__ import annotations

import math

import torch

BZ = 8
BF16 = torch.bfloat16
NEG = -1e30  # a masked logit, as kernel #6 masks


# ------------------------------------------------------------ DBB and quant


def keep_top(x: torch.Tensor, nnz: int, dim: int = -1) -> torch.Tensor:
    """Mask of the ``nnz`` largest magnitudes of each 8-block along
    ``dim``, ties to the lower index: the ``nnz`` largest keys
    ``|x| * 8 + (7 - index)``, with ``|x|`` by its float32 bits (which
    order non-negative floats as their values do)."""
    x = x.movedim(dim, -1)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // BZ, BZ)
    bits = xb.float().abs().view(torch.int32).long()
    key = bits * BZ + (BZ - 1 - torch.arange(BZ, device=x.device))
    top = key.topk(nnz, dim=-1).indices
    keep = torch.zeros(xb.shape, dtype=torch.bool, device=x.device).scatter_(-1, top, True)
    return keep.reshape(x.shape).movedim(-1, dim)


def dbb_prune(x: torch.Tensor, nnz: int, dim: int = -1, rows: int = 4096) -> torch.Tensor:
    """``x`` with all but each block's ``nnz`` largest magnitudes zeroed,
    in slices of ``rows`` along the other axis (a 2-D ``x``)."""
    out = torch.empty_like(x)
    other = 1 if dim in (0, -2) else 0
    n = x.shape[other]
    for i in range(0, n, rows):
        sl = (slice(None), slice(i, i + rows)) if other == 1 else (slice(i, i + rows),)
        part = x[sl]
        out[sl] = torch.where(keep_top(part, nnz, dim), part, torch.zeros_like(part))
    return out


class Precision:
    """How the wire carries a linear's operands and how the KV cache
    stores a token: ``quant`` is ``"int"`` (symmetric codes up to
    ``qmax``), ``"fp8"`` (e4m3 scaled to its range) or ``None`` (the
    bf16 values as they are)."""

    def __init__(self, name: str, quant, qmax: float = 0.0):
        self.name, self.quant, self.qmax = name, quant, qmax

    def codes(self, x: torch.Tensor, dim: int):
        """``x`` -> ``(codes f64, scale f32 or None)``; the scale is shared
        along ``dim`` (one per row of the other axis)."""
        if self.quant is None:
            return x.double(), None
        xf = x.float()
        amax = xf.abs().amax(dim=dim, keepdim=True)
        if self.quant == "int":
            scale = torch.where(amax > 0, amax / torch.full_like(amax, self.qmax),
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(xf / scale), -self.qmax, self.qmax)
            return q.double(), scale.squeeze(dim)
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
        return q.double(), None

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """What a KV-cache write then read returns, one scale a token
        row, in bf16."""
        q, scale = self.codes(x, -1)
        if scale is None:
            return q.to(BF16)
        return (q.float() * scale[..., None]).to(BF16)


PRECISIONS = {
    "bf16": Precision("bf16", None),
    "int8": Precision("int8", "int", 127.0),
    "int4": Precision("int4", "int", 7.0),
    "fp8": Precision("fp8", "fp8"),
}
# the control of each stated precision: the nearest one below it
CONTROL = {"int8": "int4", "bf16": "fp8"}


def wire_precision(cfg: dict) -> str:
    return "int8" if cfg["serve"]["wire_dtype"] == "int8" else "bf16"


def kv_precision(cfg: dict) -> str:
    return "int8" if cfg["serve"]["kv_dtype"] == "int8" else "bf16"


def stated(cfg: dict) -> dict:
    """The precisions the configuration states, as ``Reference`` takes them."""
    return {"wire": wire_precision(cfg), "kv": kv_precision(cfg), "dense": "bf16"}


def control(cfg: dict) -> dict:
    """Each stated precision one step down: the correctness control."""
    return {k: CONTROL[v] for k, v in stated(cfg).items()}


# ------------------------------------------------------------------ layers


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf.double() ** 2).mean(dim=-1, keepdim=True).float()
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(BF16)


def silu(y: torch.Tensor) -> torch.Tensor:
    return y * torch.reciprocal(torch.exp(-y) + 1.0)


class Linear:
    """One linear as the configuration serves it: ``w [d_in, d_out]``
    dense bf16, W-DBB pruned (unless ``dense``) and put on the wire once."""

    def __init__(self, w: torch.Tensor, prec: Precision, w_nnz: int, dense: bool = False):
        wp = w if dense else dbb_prune(w, w_nnz, dim=0)
        self.codes, self.scale = prec.codes(wp, 0)
        self.prec = prec

    def __call__(self, x: torch.Tensor, act=None, out_f32: bool = False) -> torch.Tensor:
        xc, xs = self.prec.codes(x, -1)
        y = (xc @ self.codes).float()
        if xs is not None:
            y = y * (xs[:, None] * self.scale[None, :])
        if act == "silu":
            y = silu(y)
        return y if out_f32 else y.to(BF16)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x [T, heads, D]`` (half-split pairs) at positions ``pos [T]``."""
    dim = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : dim // 2].float(), x[..., dim // 2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(BF16)


def causal_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  page: int = 16, block: int = 512) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` of one sequence, causal, with float32
    logits and sums and the probabilities rounded to bf16 before ``P @
    V`` as a paged read rounds them: keys in pages of ``page`` positions,
    each probability taken against the running maximum of the row up to
    its own page (an online softmax in one pass over the row).  Its bf16
    rounding depends on that maximum, so a reference that rounds against
    the row's global maximum departs from every served model in about a
    fifth of the outputs by one bf16 step.  ``q [S, G, H_g, D]`` over
    ``k [S, G, D]``, ``v [S, G, Dv]`` (``G`` groups of heads sharing a key
    head); returns ``[S, G, H_g, Dv]``."""
    s = q.shape[0]
    t = -(-s // page) * page
    kf = torch.zeros((t,) + tuple(k.shape[1:]), dtype=torch.float32, device=k.device)
    vf = torch.zeros((t,) + tuple(v.shape[1:]), dtype=torch.float32, device=v.device)
    kf[:s], vf[:s] = k.float(), v.float()
    kpos = torch.arange(t, device=q.device)
    out = []
    for i in range(0, s, block):
        qi = q[i:i + block].float()
        n = qi.shape[0]
        logits = torch.einsum("sghd,tgd->ghst", qi, kf) * scale
        qpos = torch.arange(i, i + n, device=q.device)[:, None]
        logits = logits.masked_fill(kpos[None, :] > qpos, NEG)
        pages = logits.unflatten(-1, (t // page, page))  # [G, H, n, pages, page]
        run = pages.amax(dim=-1).cummax(dim=-1).values  # running max at each page
        top = run[..., -1:]  # the row's max
        e = torch.exp(pages - run[..., None])
        w = torch.exp(run - top)[..., None]
        p = (e.to(BF16).float() * w).flatten(-2)
        denom = (e * w).sum(dim=(-2, -1))
        o = torch.einsum("ghst,tgv->sghv", p, vf)
        out.append(o / denom.permute(2, 0, 1)[..., None])
    return torch.cat(out).to(BF16)


# ------------------------------------------------------------------ the model


class Reference:
    """The configuration ``cfg`` (its ``model``, ``sparsity`` and ``serve``
    blocks) on the dense tree ``params``, its wire, KV cache and the
    linear it serves off the wire (MLA's ``kv_up``) computed in ``wire``,
    ``kv`` and ``dense`` (``PRECISIONS`` keys)."""

    def __init__(self, cfg: dict, params: dict, wire: str, kv: str, dense: str = "bf16",
                 page: int = 16):
        self.page = page
        self.m = cfg["model"]
        self.sp = cfg["sparsity"]
        self.params = params
        self.wire = PRECISIONS[wire]
        self.kv = PRECISIONS[kv]
        self.dense = PRECISIONS[dense]
        self.dap = self.sp["mode"] == "awdbb"

    def _lin(self, p, dense=False):
        return Linear(p["w"], self.wire, self.sp["w_nnz"], dense=dense)

    def _in(self, x):
        """A linear's input under DAP."""
        return dbb_prune(x, self.sp["a_nnz"]) if self.dap else x

    def _gqa(self, p, h, seqs, pos):
        m = self.m
        nh, nkv = m["n_heads"], m["n_kv_heads"]
        dh = m.get("d_head") or m["d_model"] // nh
        x = self._in(h)
        q = self._lin(p["wq"])(x).view(-1, nh, dh)
        k = self._lin(p["wk"])(x).view(-1, nkv, dh)
        v = self._lin(p["wv"])(x).view(-1, nkv, dh)
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
        k = self.kv.roundtrip(k.reshape(-1, nkv * dh)).view(-1, nkv, dh)
        v = self.kv.roundtrip(v.reshape(-1, nkv * dh)).view(-1, nkv, dh)
        out = []
        for a, b in seqs:
            qs = q[a:b].view(b - a, nkv, nh // nkv, dh)
            out.append(causal_attend(qs, k[a:b], v[a:b], 1.0 / math.sqrt(dh),
                                     self.page).reshape(b - a, -1))
        return self._lin(p["wo"])(self._in(torch.cat(out)))

    def _mla(self, p, h, seqs, pos):
        m, c = self.m, self.m["mla"]
        nh, lora = m["n_heads"], c["kv_lora_rank"]
        nope, rdim, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        eps = m["norm_eps"]
        x = self._in(h)
        cq = rmsnorm(self._lin(p["q_down"])(x), p["q_norm"]["scale"], eps)
        q = self._lin(p["q_up"])(self._in(cq)).view(-1, nh, nope + rdim)
        q_nope, q_rope = q[..., :nope], rope(q[..., nope:], pos, m["rope_theta"])
        kv = self._lin(p["kv_down"])(x)
        c_kv = rmsnorm(kv[:, :lora], p["kv_norm"]["scale"], eps)
        k_rope = rope(kv[:, None, lora:], pos, m["rope_theta"])[:, 0]
        lat = self.kv.roundtrip(torch.cat([c_kv, k_rope], dim=-1))  # [T, lora + rope]
        up = Linear(p["kv_up"]["w"], self.dense, 0, dense=True)
        w_up = up.codes.view(lora, nh, nope + dv)
        if up.scale is not None:
            w_up = w_up * up.scale.view(1, nh, nope + dv).double()
        w_k, w_v = w_up[..., :nope], w_up[..., nope:]
        # queries absorbed through kv_up's key half: scores over the latent
        q_abs = torch.einsum("thn,lhn->thl", q_nope.double(), w_k).float().to(BF16)
        q_cat = torch.cat([q_abs, q_rope], dim=-1)
        out = []
        for a, b in seqs:
            ctx = causal_attend(q_cat[a:b][:, None], lat[a:b][:, None], lat[a:b, None, :lora],
                                1.0 / math.sqrt(nope + rdim), self.page)[:, 0]
            o = torch.einsum("shl,lhv->shv", ctx.double(), w_v).float().to(BF16)
            out.append(o.reshape(b - a, nh * dv))
        return self._lin(p["wo"])(self._in(torch.cat(out)))

    @torch.no_grad()
    def logits(self, sequences, wanted) -> list:
        """``sequences``: token arrays, each run whole from position 0;
        ``wanted``: per sequence the positions whose next-token logits to
        return.  Returns float32 ``[len(wanted[i]), vocab]`` per sequence
        (the head's accumulator before its bf16 rounding)."""
        m, p = self.m, self.params
        dev = p["embed"]["w"].device
        lens = [len(s) for s in sequences]
        starts = [sum(lens[:i]) for i in range(len(lens))]
        seqs = [(a, a + n) for a, n in zip(starts, lens)]
        tokens = torch.cat([torch.as_tensor(s, dtype=torch.long) for s in sequences]).to(dev)
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        x = p["embed"]["w"][tokens]
        eps = m["norm_eps"]
        attn = self._mla if m.get("mla") else self._gqa
        for layer in p["layers"]:
            h = rmsnorm(x, layer["ln1"]["scale"], eps)
            x = x + attn(layer["attn"], h, seqs, pos)
            h = self._in(rmsnorm(x, layer["ln2"]["scale"], eps))
            g = self._lin(layer["mlp"]["gate"])(h, act="silu")
            u = self._lin(layer["mlp"]["up"])(h)
            x = x + self._lin(layer["mlp"]["down"])(self._in(g * u))
        rows = torch.cat([torch.as_tensor(w, dtype=torch.long, device=dev) + a
                          for w, (a, _) in zip(wanted, seqs)])
        hf = rmsnorm(x[rows], p["final_norm"]["scale"], eps)
        out = self._lin(p["lm_head"])(hf, out_f32=True)[:, : m["vocab"]]
        return list(out.split([len(w) for w in wanted]))


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best."""
    return ref_logits.amax(dim=-1) - ref_logits.gather(1, tokens.long()[:, None])[:, 0]
