"""The yardstick's arithmetic: the H100's peaks, the bytes and operations
a served forward pass needs from its kernels, and the model work of the
tokens fed.

The peaks and the byte and operation counts of the DBB matmuls and of
paged attention are a frozen copy of ``chip_smoke.py``'s (``finish_bound``
and the byte sums of its kernel phases), kept here so that an edit there
does not move the benchmark.  Bytes count each input read once and each
output written once; operations count the products these inputs need.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
BZ = 8


def peak_ops(cfg: dict) -> float:
    """The wire's peak: int8 on the int8 wire, bf16 otherwise."""
    return INT8_OPS_PER_S if cfg["serve"]["wire_dtype"] == "int8" else BF16_OPS_PER_S


def bound_s(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over the peak (``chip_smoke.finish_bound``)."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


# ------------------------------------------------------------ the linears


def linears(cfg: dict) -> list:
    """Every linear of one forward pass: ``(name, K, N, count, packed
    input, DAP on its input)``.  ``packed input``: the input reaches the
    kernel DAP-packed (#3/#4); otherwise dense (#2/#1), DAP-pruned unless
    it is the head.  MLA's ``kv_up`` is off the wire (counted in
    :func:`model_work` only)."""
    m = cfg["model"]
    d, h, n_layers, f = m["d_model"], m["n_heads"], m["n_layers"], m["d_ff"]
    vpad = -(-m["vocab"] // m.get("vocab_pad_multiple", 256)) * m.get("vocab_pad_multiple", 256)
    mla = m.get("mla")
    if mla:
        qk = mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]
        attn = [("q_down", d, mla["q_lora_rank"], True), ("q_up", mla["q_lora_rank"], h * qk, False),
                ("kv_down", d, mla["kv_lora_rank"] + mla["qk_rope_head_dim"], True),
                ("wo", h * mla["v_head_dim"], d, False)]
    else:
        dh = m.get("d_head") or d // h
        kv = m["n_kv_heads"] * dh
        attn = [("wq", d, h * dh, True), ("wk", d, kv, True), ("wv", d, kv, True),
                ("wo", h * dh, d, False)]
    mlp = [("gate", d, f, True), ("up", d, f, True), ("down", f, d, True)]
    out = [(name, k, n, n_layers, packed, True) for name, k, n, packed in attn + mlp]
    out.append(("lm_head", d, vpad, 1, False, False))
    return out


def linear_bytes(cfg: dict, k: int, n: int, m_rows: int, packed: bool) -> float:
    """One DBB matmul call's bytes at ``m_rows`` rows: the input (packed
    values and masks, or dense; int8 with a scale a row, or bf16), the
    packed weight (values, masks, int8 scales), the bf16 output."""
    w_nnz = cfg["sparsity"]["w_nnz"]
    a_nnz = cfg["sparsity"]["a_nnz"]
    int8 = cfg["serve"]["wire_dtype"] == "int8"
    el = 1 if int8 else 2
    kb = k // BZ
    if packed:
        x = m_rows * kb * a_nnz * el + m_rows * kb
    else:
        x = m_rows * k * el
    if int8:
        x += 4 * m_rows
    w = kb * w_nnz * n * el + kb * n + (4 * n if int8 else 0)
    return x + w + 2 * m_rows * n


def linear_ops(cfg: dict, k: int, n: int, m_rows: int, dap: bool) -> float:
    """The products a call needs: every input row keeps ``a_nnz`` of each
    8-block under DAP (all of them without), every weight column
    ``w_nnz``; two operations a product."""
    sp = cfg["sparsity"]
    a = sp["a_nnz"] / BZ if dap and sp["mode"] == "awdbb" else 1.0
    return 2.0 * m_rows * k * n * a * sp["w_nnz"] / BZ


def dbb_bound_s(cfg: dict, m_rows: int) -> float:
    """The DBB matmuls' bound over one pass of ``m_rows`` rows."""
    peak = peak_ops(cfg)
    return sum(count * bound_s(linear_bytes(cfg, k, n, m_rows, packed),
                               linear_ops(cfg, k, n, m_rows, dap), peak)
               for _, k, n, count, packed, dap in linears(cfg))


# ------------------------------------------------------------ paged attention


def attn_bytes_ops(cfg: dict, rows: list, page_size: int, b_rows: int, s_cols: int,
                   pages_per_row: int):
    """Paged attention over one pass, every layer: ``rows`` holds each
    real row's ``(first query position, queries)``; the pass's query
    tensor is ``[b_rows, s_cols]`` (padding included, as the kernel reads
    and writes it).  Bytes: the query and output tensors, each row's
    pages up to its last query (keys, values, their int8 scales, slot
    positions), the page tables and query positions.  Operations: QK^T
    and PV over the causal (query, key) pairs."""
    m = cfg["model"]
    h = m["n_heads"]
    int8_kv = cfg["serve"]["kv_dtype"] == "int8"
    el = 1 if int8_kv else 2
    mla = m.get("mla")
    if mla:
        dk = mla["kv_lora_rank"] + mla["qk_rope_head_dim"]
        dv = mla["kv_lora_rank"]
        page = page_size * dk * el + 4 * page_size + (4 * page_size if int8_kv else 0)
        q_out = 2 * b_rows * s_cols * h * (dk + dv)
        per_pair = 2.0 * h * (dk + dv)
    else:
        dh = m.get("d_head") or m["d_model"] // h
        kvd = m["n_kv_heads"] * dh
        page = 2 * page_size * kvd * el + 4 * page_size + (8 * page_size if int8_kv else 0)
        q_out = 2 * 2 * b_rows * s_cols * h * dh
        per_pair = 4.0 * h * dh
    pages = sum(math.ceil((p0 + n) / page_size) for p0, n in rows)
    pairs = sum(n * p0 + n * (n + 1) // 2 for p0, n in rows)
    nbytes = q_out + pages * page + 4 * b_rows * pages_per_row + 4 * b_rows * s_cols
    return m["n_layers"] * nbytes, m["n_layers"] * pairs * per_pair


def attn_bound_s(cfg: dict, rows: list, page_size: int, b_rows: int, s_cols: int,
                 pages_per_row: int) -> float:
    nbytes, nops = attn_bytes_ops(cfg, rows, page_size, b_rows, s_cols, pages_per_row)
    return bound_s(nbytes, nops, BF16_OPS_PER_S)


# ------------------------------------------------------------ model work


def model_work(cfg: dict, rows: list, sampled: int) -> float:
    """The model's operations for the tokens fed, whatever computes them:
    2 K N w_nnz/8 a token for every DBB linear but the head (its
    weights' non-zeros), the dense ones in full (MLA's absorbed
    ``kv_up``), QK^T and PV over each token's context, and the head for
    the ``sampled`` tokens whose logits are read.  ``rows``: ``(first
    position, tokens)`` runs."""
    m, sp = cfg["model"], cfg["sparsity"]
    w = sp["w_nnz"] / BZ if sp["mode"] in ("wdbb", "awdbb") else 1.0
    tokens = sum(n for _, n in rows)
    per_token = 0.0
    head = 0.0
    for name, k, n, count, _, _ in linears(cfg):
        if name == "lm_head":
            head = 2.0 * k * m["vocab"] * w
        else:
            per_token += count * 2.0 * k * n * w
    h = m["n_heads"]
    mla = m.get("mla")
    if mla:
        lora, nope, dv = mla["kv_lora_rank"], mla["qk_nope_head_dim"], mla["v_head_dim"]
        per_token += m["n_layers"] * 2.0 * h * lora * (nope + dv)
        per_pair = 2.0 * h * (lora + mla["qk_rope_head_dim"] + lora)
    else:
        dh = m.get("d_head") or m["d_model"] // h
        per_pair = 4.0 * h * dh
    pairs = sum(n * p0 + n * (n + 1) // 2 for p0, n in rows)
    return tokens * per_token + m["n_layers"] * pairs * per_pair + sampled * head
