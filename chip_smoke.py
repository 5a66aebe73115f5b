#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and runs right on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA card and nvcc, and
nothing of JAX.  Phases, each printed on its own line; any failure exits
non-zero and prints no result:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the kernel build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled
   with nvcc for sm_90a, all at once, and its time;
3. each kernel held against its plain PyTorch version on the card at its
   main paths' full widths, and timed beside its plain version, a
   PyTorch library call computing the same function, and its bound
   (bytes over 3.35 TB/s or operations over the peak rate): the int8
   matmuls (#2, #3) through their int8 tc body, bit for bit, with a check
   that a row's bits do not depend on M, at granite-3-8b's and
   qwen2-vl-72b's shapes (timed beside ``torch._int_mm`` with the weight
   row-major and column-major) and at minicpm3-4b's,
   granite-moe-1b-a400m's and qwen1.5-110b's int8-wire shapes (held, not
   timed), a random bias on every biased wq, wk and wv; GQA paged
   attention (#6) at granite-3-8b's and qwen2-vl-72b's heads (int8 KV),
   granite-moe-1b-a400m's and starcoder2-15b's (native KV; 12 query heads
   a KV head, its 4096-token window over tables of 5120 slots), with the
   padding and idle rows of a mixed step, in bf16 through the tensor-core
   kernel and in f32 through the scalar one, and bf16 calls at pages of 4
   and 2 slots; the native-wire matmuls (#1, #4) through their tc body,
   with a check that a row's bits do not depend on M, at minicpm3-4b's and
   granite-moe-1b-a400m's shapes (timed) and starcoder2-15b's (its gelu
   ``up`` included), phi3.5-moe's and qwen2-vl-72b's (held); latent paged
   attention (#6, MLA) at minicpm3-4b's on decode, whole-chunk and mixed
   steps, keyless rows included, in bf16 through the latent tensor-core
   kernel and in f32 through the scalar one; both tensor-core kernels at
   pages of 72 slots (64-slot sub-pages) and the latent one at
   minicpm3-4b's smoke latent of 40 (zero-padded to 48); DAP (#5) bit for
   bit in each of its four forms (pruned dense, native-packed, int8
   dense, int8-packed) at every width it serves on the paths and at
   qwen1.5-110b's down input (K = 49152, also at M = 512), NaN,
   infinities, ties and -0.0 included; one line of qwen2-vl-72b's kernel
   times over a mixed-step pass; a bf16 smoke minicpm3-4b engine served at
   pages of 16 and 72 slots; ``phase_autotune``: ``kernels/autotune.py``
   sweeps every legal tc-body plan of #3 at granite-3-8b's wq, gate, down
   and qwen2-vl-72b's gate, down, #2 at granite's lm_head, #4 at
   minicpm3-4b's gate, down and #1 at its lm_head (M = 64, cold L2; each
   candidate exact or within tolerance and, native, M-invariant), and
   gather against fused at granite's decode step and minicpm3's latent
   one; the winners go to a JSON cache in a temporary directory, a fresh
   process resolves them, and the cache is cleared so every later phase
   runs today's plans;
4. the main paths, each driven with the launch counters set to 0 just
   before and read just after: full-width granite-3-8b (40 layers, int8
   DBB wire, int8 KV), full-width minicpm3-4b (62 layers, native DBB
   wire, native KV), full-width granite-moe-1b-a400m (24 layers, 32
   experts top-8, native wire and KV: the reference's default),
   qwen2-vl-72b at full width and 40 of its 80 layers (M-RoPE, QKV bias,
   int8 wire and KV; ``QWEN2_VL_DEPTH``), full-width starcoder2-15b (40
   layers, gelu MLP, QKV bias, a 4096-token window, native wire and KV),
   phi3.5-moe-42b-a6.6b at
   full width and 8 of its 32 layers (16 experts top-2, native wire and
   KV) and full-width qwen1.5-110b (80 layers, d_ff 49152, QKV bias,
   int8 wire and KV: about 71 GB of weights on the 80 GB card), seeded
   random weights in bf16, each serving 8 requests
   continuously through ``Engine.generate_requests``; the counters show
   every packed linear, every attention call and every DAP call site
   (each in its form, one launch a call) went through the kernels, every
   bf16 GQA attention call through the tensor-core kernel, every bf16
   latent call through the latent tensor-core kernel, every bf16 #1 and
   #4 call through their tc body and every #2 and #3 call through the int8
   tc body.  A dense arch's request re-served alone is byte-identical; an
   MoE token depends on its co-batch (expert capacity), so there a fresh
   engine re-serves the same requests and arrivals byte-identically.
   Each path prints its init time, peak memory after init and after
   serving, wall, tokens/s and TTFT, the card and its power limit beside
   them.
5. ``phase_sampler`` (the threefry bits and sampled tokens on the card
   equal the CPU's) and ``phase_serving_modes`` (granite-3-8b's one-shot,
   stepped, gather, sampled and unpacked serves).
6. ``phase_spec``: self-speculative decoding at full width on the main
   path's 8 requests, ``decode_block=4`` — granite-3-8b (int8 wire and KV)
   with the ``nnz`` draft (2/8 activations), greedy and sampled, and
   minicpm3-4b (native) with the ``int8_wire`` draft (#2/#3 draft while
   #1/#4 verify); each serve's tokens equal the plain engine's, and the
   draft and verify passes' launches are counted into the record.
7. ``phase_durability``: granite-3-8b's chaos serve (allocator faults,
   a poisoned request, scribbles) whose healthy requests equal the
   fault-free serve, and a serve killed between a dispatch and its commit,
   restored from its last snapshot and resumed, equal to the
   uninterrupted serve; ``health()``'s step p50/p99 and a snapshot's size
   and time on disk.
8. ``phase_recurrent``: mamba2-130m (native and int8 wire) and
   hymba-1.5b (int8 wire and KV, native wire and KV; 16 of its 32 layers)
   at full width, each
   serving 8 prompts of 64 tokens + 32 new through ``Engine.generate``
   (stepped, by ``auto``), launches counted per pass, a fresh engine
   re-serving byte-identically; mamba2-130m's chunked ``lm.forward`` over
   512 tokens in f32 against stepped ``decode_step`` (the SSD duality).
   The kernel phases also hold #1-#4 at the mixers' ``in_proj``/
   ``out_proj`` shapes (hymba's 1600 -> 6482 through #2/#3's guarded
   column tail), in the record under ``"shapes"``.
9. ``phase_encdec``: whisper-base at full width on the native wire:
   4 x 1500 frames encoded, then 32 greedy ``decode_step`` calls over the
   ring, launches counted, a second run byte-identical.
10. ``phase_train``: granite-moe-1b-a400m trained whole at full width and
   depth (bf16, awdbb 4/8 with the straight-through DAP gradient,
   ``remat="full"``): 12 ``Trainer`` steps of AdamW over ``MarkovLM(2048,
   8 x 512)`` with the W-DBB schedule reaching 4/8 at step 8; #5's
   launches a step against ``train_launches``, the loss falling, every
   masked weight 4-of-8; int8 gradient compression at the same width; a
   kill-and-resume check at 2 layers under
   ``torch.use_deterministic_algorithms``; one smoke step on the card
   against the CPU; the STE at the training shape ``[4096, 1024]``, bit
   for bit, #5 timed there (the record's ``dap_prune`` ``"train"``).
11. ``phase_distributed``: the two distributed regions over
   ``torch.distributed`` at full width, nccl at world size 1 (a
   ``FileStore``), the (1, 1) ``("data", "model")`` mesh:
   granite-moe-1b-a400m (24 layers) through the expert-parallel region
   (``lm.forward`` over 4 x 512; f32 under wdbb against the grouped path,
   bf16 under awdbb held to itself) and granite-3-8b (40 layers, native
   wire and KV) prefilled into a window-sharded ring and decoded 32 steps
   through ``flash_decode`` (f32 under wdbb against the plain ring path,
   bf16 under awdbb held to itself); then both again with two spawned
   ranks sharing the card over gloo in a (1, 2) mesh (experts and ring
   window split in two; f32 against the undistributed paths, the ranks
   byte-identical; the MoE in bf16 too); launches, collectives a step
   and their bytes printed.
12. ``phase_dryrun``: the dry-run analysis (``repro_torch.launch.dryrun``,
   host only: one rank's program of each cell traced on fake tensors
   over a fake group) in subprocesses, since the fake group is
   process-global: every arch x applicable shape on the single-pod
   (16, 16) mesh, 33 cells, six processes at once; beside them one MoE
   ``train_4k`` and one ``long_500k`` cell on the multi-pod (2, 16, 16)
   mesh and one ``--packed`` decode cell; the report's tables and the
   phase's wall printed; any failed cell fails the run.
13. ``phase_examples``: the four ``examples/*_torch.py`` entry points in
   this process, each driven with the counters at 0 and its launches
   checked and counted into the record: the paper's Table 3 CNN at its
   example size (300 base + 3 x 150 fine-tune steps, f32, TF32 off; its
   first 5 steps of each fine-tune mode held against the CPU's, its rows
   printed (not the CPU port's: ``tests/test_torch_examples.py`` holds
   those, 19.9 s of the H100 machine's host); #5's dense form at its
   rows, K = 8 and 16, NNZ 4 and 2, bit for bit and timed), quickstart at full size (#1
   against ``kernels/ref.py``), serve_packed (packed == dense, int8-KV
   batched == stepped, KV bytes on meta tensors) and train_e2e at its
   ~110M-parameter default for 60 of its 300 steps (``E2E_STEPS``: the
   phase stays under 90 s), checkpoint and resume.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

SEED = 0
N_REQUESTS, N_NEW = 8, 32
SERVE_SHAPE = dict(
    prefill_mode="continuous", pack_weights=True, max_seq=1024, page_size=16, max_batch=4,
    prefill_chunk=16, decode_block=16,
)
# the main paths: (architecture, wire, KV dtype, layers served or None for
# all); phi3.5-moe's dense bf16 experts take 2.52 GB a layer, 80.5 GB at
# its 32 layers, so it serves 8 at full width.  qwen2-vl-72b serves 40 of
# its 80 layers so the script stays inside its time limit with
# qwen1.5-110b's 80: the same int8 GQA path at d 8192, which qwen1.5
# runs at full depth (qwen2-vl's M-RoPE and QKV bias do not depend on
# depth); its 80 layers took 43-53 s of the script
QWEN2_VL_DEPTH = 40
PATHS = (("granite_3_8b", "int8", "int8", None), ("minicpm3_4b", "native", "native", None),
         ("granite_moe_1b_a400m", "native", "native", None),
         ("qwen2_vl_72b", "int8", "int8", QWEN2_VL_DEPTH),
         ("starcoder2_15b", "native", "native", None),
         ("phi3_5_moe_42b_a6_6b", "native", "native", 8), ("qwen1_5_110b", "int8", "int8", None))
# whisper-base's encoder rows: 4 requests of 1500 frames (phase_encdec);
# the kernel phases also hold its encoder's DAP forms and linears at this M
WHISPER_B, WHISPER_NEW = 4, 32
WHISPER_ENC_ROWS = WHISPER_B * 1500
# the archs whose wq, wk and wv carry a bias: the kernel phases give those a
# random non-zero one (the inits draw zeros)
QKV_BIAS_ARCHS = ("qwen2-vl-72b", "qwen1.5-110b", "starcoder2-15b")
# (K, call sites, forms of DAP (#5) served there) on the main paths, the
# recurrent and enc-dec phases and at qwen1.5-110b's down input
DAP_WIDTHS = (
    (512, "whisper wo and cross wq input; attention and MLP input, the encoder output",
     ("dap_prune", "dap_pack")),
    (768, "minicpm3 q_up input; mamba2 in_proj input", ("dap_prune", "dap_prune_int8")),
    (1024, "granite-moe wo and MoE input; attention input", ("dap_prune", "dap_pack")),
    (1536, "mamba2 out_proj input", ("dap_prune", "dap_prune_int8")),
    (1600, "hymba wo and in_proj input; attention and MLP input",
     ("dap_prune", "dap_pack", "dap_prune_int8", "dap_pack_int8")),
    (2048, "whisper down input", ("dap_pack",)),
    (2560, "minicpm3 wo input; attention and MLP input", ("dap_prune", "dap_pack")),
    (3200, "hymba out_proj input", ("dap_prune", "dap_prune_int8")),
    (4096, "granite-3-8b wo input; attention and MLP input", ("dap_prune_int8",
                                                               "dap_pack_int8")),
    (4096, "phi3.5-moe wo and MoE input; attention input", ("dap_prune", "dap_pack")),
    (5504, "hymba down input", ("dap_pack", "dap_pack_int8")),
    (6144, "starcoder2 wo input; attention and MLP input", ("dap_prune", "dap_pack")),
    (6400, "minicpm3 down input", ("dap_pack",)),
    (8192, "qwen2-vl and qwen1.5 wo input; attention and MLP input", ("dap_prune_int8",
                                                                      "dap_pack_int8")),
    (12800, "granite-3-8b down input", ("dap_pack_int8",)),
    (24576, "starcoder2 down input", ("dap_pack",)),
    (29568, "qwen2-vl down input", ("dap_pack_int8",)),
    (49152, "qwen1.5-110b down input", ("dap_pack_int8",)),
    (8, "CNN input (examples/cnn_dap_finetune_torch.py), f32", ("dap_prune",)),
    (16, "CNN after pool 1, f32", ("dap_prune",)),
)
# the CNN's widths: held at NNZ 4 and 2 (its fine-tunes and its 2/8 row),
# timed at its own rows in phase_examples (CNN_DAP), not at M = 4 and 64
CNN_WIDTHS = {8: (4, 2), 16: (4, 2)}
# the widths whose forms are also held at a long M, rows bitwise equal to M =
# 4's: {K: (M, forms)}: the per-row forms at a solo prefill's 512 rows (K =
# 49152 takes two blocks a row), whisper's encoder forms at its 6000 rows
DAP_LONG_ROWS = {
    512: (WHISPER_ENC_ROWS, ("dap_prune", "dap_pack")),
    2048: (WHISPER_ENC_ROWS, ("dap_pack",)),
    29568: (512, ("dap_prune_int8", "dap_pack_int8")),
    49152: (512, ("dap_prune_int8", "dap_pack_int8")),
}
# DAP's forms: (wrapper in kernels/dap_prune.py, plain version in kernels/ref.py)
DAP_FORMS = {
    "dap_prune": ("dap_prune_cuda", "dap_prune_ref"),
    "dap_prune_int8": ("dap_prune_int8_cuda", "dap_prune_int8_ref"),
    "dap_pack": ("dap_pack_cuda", "dap_pack_ref"),
    "dap_pack_int8": ("dap_pack_int8_cuda", "dap_pack_int8_ref"),
}
# the JSON record of each form: one mixed-step pass (M = 64) of one arch,
# {K: calls a pass}
DAP_RECORD = {
    "dap_prune": ("granite-moe-1b-a400m", {1024: 48}),
    "dap_prune_int8": ("granite-3-8b", {4096: 40}),
    "dap_pack": ("minicpm3-4b", {2560: 124, 6400: 62}),
    "dap_pack_int8": ("granite-3-8b", {4096: 80, 12800: 40}),
}
# qwen2-vl-72b's int8 DAP calls a mixed-step pass (80 layers), {form: {K: calls}}
QWEN2_VL_DAP = {"dap_prune_int8": {8192: 80}, "dap_pack_int8": {8192: 160, 29568: 80}}
# (name, kernel, act on the main path, K, N, body) of granite-3-8b's
# linears; body: the matmul body that must take the call, "tc" or "generic"
LINEARS = (
    ("wq", "aw", None, 4096, 4096, "tc"),
    ("wk", "aw", None, 4096, 1024, "tc"),
    ("wv", "aw", None, 4096, 1024, "tc"),
    ("wo", "w", None, 4096, 4096, "tc"),
    ("gate", "aw", "silu", 4096, 12800, "tc"),
    ("up", "aw", None, 4096, 12800, "tc"),
    ("down", "aw", None, 12800, 4096, "tc"),
    ("lm_head", "w", None, 4096, 49408, "tc"),
)
# (arch, name, kernel, act on the main path, K, N, body) of the int8-wire
# linears of the other archs: held bit for bit in phase 3; qwen2-vl-72b's
# also timed (its main path's pass), not in the record; qwen1.5-110b shares
# every shape but the MLP's with qwen2-vl.  The recurrent archs' mixer
# projections are also held as #3 (packed input), which they do not serve
INT8_OTHER_LINEARS = (
    ("minicpm3-4b", "q_down", "aw", None, 2560, 768, "tc"),
    ("minicpm3-4b", "kv_down", "aw", None, 2560, 288, "tc"),
    ("minicpm3-4b", "q_up", "w", None, 768, 3840, "tc"),
    ("minicpm3-4b", "wo", "w", None, 2560, 2560, "tc"),
    ("minicpm3-4b", "gate", "aw", "silu", 2560, 6400, "tc"),
    ("minicpm3-4b", "up", "aw", None, 2560, 6400, "tc"),
    ("minicpm3-4b", "down", "aw", None, 6400, 2560, "tc"),
    ("minicpm3-4b", "lm_head", "w", None, 2560, 73472, "tc"),
    ("granite-moe-1b-a400m", "wq", "aw", None, 1024, 1024, "tc"),
    ("granite-moe-1b-a400m", "wk", "aw", None, 1024, 512, "tc"),
    ("granite-moe-1b-a400m", "wv", "aw", None, 1024, 512, "tc"),
    ("granite-moe-1b-a400m", "wo", "w", None, 1024, 1024, "tc"),
    ("granite-moe-1b-a400m", "lm_head", "w", None, 1024, 49408, "tc"),
    ("qwen2-vl-72b", "wq", "aw", None, 8192, 8192, "tc"),
    ("qwen2-vl-72b", "wk", "aw", None, 8192, 1024, "tc"),
    ("qwen2-vl-72b", "wv", "aw", None, 8192, 1024, "tc"),
    ("qwen2-vl-72b", "wo", "w", None, 8192, 8192, "tc"),
    ("qwen2-vl-72b", "gate", "aw", "silu", 8192, 29568, "tc"),
    ("qwen2-vl-72b", "up", "aw", None, 8192, 29568, "tc"),
    ("qwen2-vl-72b", "down", "aw", None, 29568, 8192, "tc"),
    ("qwen2-vl-72b", "lm_head", "w", None, 8192, 152064, "tc"),
    ("qwen1.5-110b", "gate", "aw", "silu", 8192, 49152, "tc"),
    ("qwen1.5-110b", "up", "aw", None, 8192, 49152, "tc"),
    ("qwen1.5-110b", "down", "aw", None, 49152, 8192, "tc"),
    ("mamba2-130m", "in_proj", "w", None, 768, 3352, "generic"),
    ("mamba2-130m", "in_proj", "aw", None, 768, 3352, "generic"),
    ("mamba2-130m", "out_proj", "w", None, 1536, 768, "tc"),
    ("mamba2-130m", "out_proj", "aw", None, 1536, 768, "tc"),
    ("mamba2-130m", "lm_head", "w", None, 768, 50432, "tc"),
    ("hymba-1.5b", "wq", "aw", None, 1600, 1600, "generic"),
    ("hymba-1.5b", "wk, wv", "aw", None, 1600, 320, "generic"),
    ("hymba-1.5b", "wo", "w", None, 1600, 1600, "generic"),
    ("hymba-1.5b", "gate, up", "aw", "silu", 1600, 5504, "generic"),
    ("hymba-1.5b", "down", "aw", None, 5504, 1600, "tc"),
    ("hymba-1.5b", "in_proj", "w", None, 1600, 6482, "generic"),
    ("hymba-1.5b", "in_proj", "aw", None, 1600, 6482, "generic"),
    ("hymba-1.5b", "out_proj", "w", None, 3200, 1600, "tc"),
    ("hymba-1.5b", "out_proj", "aw", None, 3200, 1600, "tc"),
    ("hymba-1.5b", "lm_head", "w", None, 1600, 32256, "generic"),
)
# int8-wire archs whose linears phase 3 times at M = 4 and 64
INT8_TIMED = {"granite-3-8b": 40, "qwen2-vl-72b": 80}  # arch: layers
# the recurrent archs' mixer projections, timed at M = 4 and 64 on both
# wires into the record's "shapes": (arch, name): calls a decode pass
MIXER_TIMED = {("mamba2-130m", "in_proj"): 24, ("mamba2-130m", "out_proj"): 24,
               ("hymba-1.5b", "in_proj"): 32, ("hymba-1.5b", "out_proj"): 32}
# (arch, name, kernel, act on the main path, DAP-pruned input, K, N, body)
# of the packed linears on the native wire: minicpm3-4b's and
# granite-moe-1b-a400m's (timed), starcoder2-15b's and phi3.5-moe's (its
# experts stay dense), qwen2-vl-72b's, whose native wire (79 GB of layers)
# one card cannot serve, the recurrent archs' (their mixer projections
# also held as #4, which they do not serve) and whisper-base's
NATIVE_LINEARS = (
    ("minicpm3-4b", "q_down", "aw", None, True, 2560, 768, "tc"),
    ("minicpm3-4b", "kv_down", "aw", None, True, 2560, 288, "tc"),
    ("minicpm3-4b", "q_up", "w", None, True, 768, 3840, "tc"),
    ("minicpm3-4b", "wo", "w", None, True, 2560, 2560, "tc"),
    ("minicpm3-4b", "gate", "aw", "silu", True, 2560, 6400, "tc"),
    ("minicpm3-4b", "up", "aw", None, True, 2560, 6400, "tc"),
    ("minicpm3-4b", "down", "aw", None, True, 6400, 2560, "tc"),
    ("minicpm3-4b", "lm_head", "w", None, False, 2560, 73472, "tc"),
    ("granite-moe-1b-a400m", "wq", "aw", None, True, 1024, 1024, "tc"),
    ("granite-moe-1b-a400m", "wk", "aw", None, True, 1024, 512, "tc"),
    ("granite-moe-1b-a400m", "wv", "aw", None, True, 1024, 512, "tc"),
    ("granite-moe-1b-a400m", "wo", "w", None, True, 1024, 1024, "tc"),
    ("granite-moe-1b-a400m", "lm_head", "w", None, False, 1024, 49408, "tc"),
    ("starcoder2-15b", "wq", "aw", None, True, 6144, 6144, "tc"),
    ("starcoder2-15b", "wk", "aw", None, True, 6144, 512, "tc"),
    ("starcoder2-15b", "wv", "aw", None, True, 6144, 512, "tc"),
    ("starcoder2-15b", "wo", "w", None, True, 6144, 6144, "tc"),
    ("starcoder2-15b", "up", "aw", "gelu", True, 6144, 24576, "tc"),
    ("starcoder2-15b", "down", "aw", None, True, 24576, 6144, "tc"),
    ("starcoder2-15b", "lm_head", "w", None, False, 6144, 49152, "tc"),
    ("phi3.5-moe-42b-a6.6b", "wq", "aw", None, True, 4096, 4096, "tc"),
    ("phi3.5-moe-42b-a6.6b", "wk", "aw", None, True, 4096, 1024, "tc"),
    ("phi3.5-moe-42b-a6.6b", "wv", "aw", None, True, 4096, 1024, "tc"),
    ("phi3.5-moe-42b-a6.6b", "wo", "w", None, True, 4096, 4096, "tc"),
    ("phi3.5-moe-42b-a6.6b", "lm_head", "w", None, False, 4096, 32256, "tc"),
    ("qwen2-vl-72b", "wq", "aw", None, True, 8192, 8192, "tc"),
    ("qwen2-vl-72b", "wk", "aw", None, True, 8192, 1024, "tc"),
    ("qwen2-vl-72b", "wv", "aw", None, True, 8192, 1024, "tc"),
    ("qwen2-vl-72b", "wo", "w", None, True, 8192, 8192, "tc"),
    ("qwen2-vl-72b", "gate", "aw", "silu", True, 8192, 29568, "tc"),
    ("qwen2-vl-72b", "up", "aw", None, True, 8192, 29568, "tc"),
    ("qwen2-vl-72b", "down", "aw", None, True, 29568, 8192, "tc"),
    ("qwen2-vl-72b", "lm_head", "w", None, False, 8192, 152064, "tc"),
    ("mamba2-130m", "in_proj", "w", None, True, 768, 3352, "tc"),
    ("mamba2-130m", "in_proj", "aw", None, True, 768, 3352, "tc"),
    ("mamba2-130m", "out_proj", "w", None, True, 1536, 768, "tc"),
    ("mamba2-130m", "out_proj", "aw", None, True, 1536, 768, "tc"),
    ("mamba2-130m", "lm_head", "w", None, False, 768, 50432, "tc"),
    ("hymba-1.5b", "wq", "aw", None, True, 1600, 1600, "tc"),
    ("hymba-1.5b", "wk, wv", "aw", None, True, 1600, 320, "tc"),
    ("hymba-1.5b", "wo", "w", None, True, 1600, 1600, "tc"),
    ("hymba-1.5b", "gate, up", "aw", "silu", True, 1600, 5504, "tc"),
    ("hymba-1.5b", "down", "aw", None, True, 5504, 1600, "tc"),
    ("hymba-1.5b", "in_proj", "w", None, True, 1600, 6482, "generic"),
    ("hymba-1.5b", "in_proj", "aw", None, True, 1600, 6482, "generic"),
    ("hymba-1.5b", "out_proj", "w", None, True, 3200, 1600, "tc"),
    ("hymba-1.5b", "out_proj", "aw", None, True, 3200, 1600, "tc"),
    ("hymba-1.5b", "lm_head", "w", None, False, 1600, 32256, "tc"),
    ("whisper-base", "wq, wk, wv; cross wk, wv", "aw", None, True, 512, 512, "tc"),
    ("whisper-base", "wo; cross wq", "w", None, True, 512, 512, "tc"),
    ("whisper-base", "up", "aw", "gelu", True, 512, 2048, "tc"),
    ("whisper-base", "down", "aw", None, True, 2048, 512, "tc"),
    ("whisper-base", "lm_head", "w", None, False, 512, 51968, "tc"),
)
# native-wire archs whose linears phase 3 times at M = 4 and 64 (the record
# holds minicpm3-4b's pass)
NATIVE_TIMED = {"minicpm3-4b": 62, "granite-moe-1b-a400m": 24}  # arch: layers
KERNELS = {
    "dbb_matmul": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_native.cu",
        replaces="src/repro/kernels/dbb_matmul.py:158",
    ),
    "dbb_matmul_int8": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_int8.cu",
        replaces="src/repro/kernels/dbb_matmul.py:272",
    ),
    "dbb_matmul_aw_int8": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_int8.cu",
        replaces="src/repro/kernels/dbb_matmul.py:345",
    ),
    "dbb_matmul_aw": dict(
        source="src/repro_torch/kernels/csrc/dbb_matmul_native.cu",
        replaces="src/repro/kernels/dbb_matmul.py:419",
    ),
    "paged_attn": dict(
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:168",
    ),
    "paged_attn_latent": dict(
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:168",
    ),
    "dap_prune": dict(
        source="src/repro_torch/kernels/csrc/dap_prune.cu",
        replaces="src/repro/kernels/dap_prune.py:54",
    ),
    "dap_prune_int8": dict(
        source="src/repro_torch/kernels/csrc/dap_prune.cu",
        replaces="src/repro/kernels/dap_prune.py:54",
    ),
    "dap_pack": dict(
        source="src/repro_torch/kernels/csrc/dap_prune.cu",
        replaces="src/repro/kernels/ops.py:198",
    ),
    "dap_pack_int8": dict(
        source="src/repro_torch/kernels/csrc/dap_prune.cu",
        replaces="src/repro/kernels/ops.py:214",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def phase_card(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    say(smi[0])
    say(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi[0]


def timer(torch, flush_buf):
    """Median device time in ms over ``iters`` calls, each timed with its
    own CUDA events and started with a cold L2 (a 256 MB write first), as
    the main path meets its weights: streamed once per step.  The median
    keeps one call that a stall of the shared host delayed past the
    device's head start out of the figure."""

    def run(fn, iters, warmup=1):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            # keep the card busy (~6 ms) while the host enqueues the call, so
            # the events time the device work and not the Python wrapper
            torch.cuda._sleep(10_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return run


def new_pass():
    """Per-kernel sums over one mixed-step pass: device ms, plain ms,
    library ms, bytes and operations."""
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0, bytes=0.0, ops=0.0)


def finish_bound(agg, ops_per_s):
    """``agg``'s bound: the larger of its bytes over the memory rate and its
    operations over ``ops_per_s``."""
    t_bytes = agg["bytes"] / HBM_BYTES_PER_S
    t_ops = agg["ops"] / ops_per_s
    agg["bound_ms"] = max(t_bytes, t_ops) * 1e3
    agg["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return agg


def random_bias(torch, gen, arch, name, n):
    """A random non-zero bf16 bias for the biased Q/K/V linears, else None."""
    if arch in QKV_BIAS_ARCHS and name in ("wq", "wk", "wv"):
        return torch.randn((n,), generator=gen, device="cuda").to(torch.bfloat16)
    return None


def check_body(label, body, total, tc, before):
    """Every launch of ``total`` since ``before`` (its and ``tc``'s counts)
    ran ``body``: all on the tc body ("tc") or none ("generic")."""
    n, n_tc = total.launches - before[0], tc.launches - before[1]
    check(n > 0 and n_tc == (n if body == "tc" else 0),
          f"{label}: {n_tc} of {n} launches on the tc body, the {body} body expected")


def shape_record(arch, name, kind, k, n, m, body, calls, t_k, t_p, nbytes, nops, rate, t_lib,
                 err):
    """One timed call of a recurrent arch's mixer projection, for the
    record's "shapes"."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / rate
    return dict(arch=arch, linear=name, K=k, N=n, M=m, body=body, served=kind == "w",
                calls_per_decode_pass=calls, ms=t_k, plain_ms=t_p,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=t_lib,
                max_abs_err=err)


def phase_matmuls(torch, run_ms, qwen, shapes):
    """Kernels #2 and #3 at granite-3-8b's full-width shapes (the record)
    and qwen2-vl-72b's (its pass, into ``qwen``), and, for correctness
    only, at minicpm3-4b's, granite-moe-1b-a400m's, qwen1.5-110b's,
    mamba2-130m's and hymba-1.5b's int8-wire shapes: every call through
    the body its row names (hymba's K = 1600 and mamba2's N = 3352 miss
    the tc body), int32 accumulators and the act=None f32 output (with a
    random bias on a biased wq, wk, wv) bit for bit against the plain
    versions at M = 1, 4 and 64, a row's bits the same at every M; the
    timed archs and ``MIXER_TIMED``'s rows (into ``shapes``) at M = 4 and
    64 beside torch._int_mm on the decoded operands with the weight
    row-major and column-major (the faster is the library time; it
    refuses N % 8 != 0)."""
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import dbb_matmul, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = dbb.DBBConfig(4, 8)
    per_kernel = {k: new_pass() for k in ("dbb_matmul_aw_int8", "dbb_matmul_int8")}
    qwen.update({k: new_pass() for k in per_kernel})
    linears = [("granite-3-8b",) + row for row in LINEARS] + list(INT8_OTHER_LINEARS)
    for arch, name, kind, act, k, n, body in linears:
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        wv, wm, ws = ref.pack_weight_int8(w.to(torch.bfloat16), cfg)
        del w
        w_dense = ref.decode_w(wv, wm, cfg)
        w_nz = (w_dense != 0).sum(dim=1).double()  # non-zeros per k row
        kname = "dbb_matmul_aw_int8" if kind == "aw" else "dbb_matmul_int8"
        bias = random_bias(torch, gen, arch, name, n)
        x = torch.randn((64, k), generator=gen, device="cuda").to(torch.bfloat16)
        if kind == "aw":
            xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
            x_dense = ref.decode_a(xv, xm, cfg)
            kern = lambda m, a, o, acc=None: dbb_matmul.dbb_matmul_aw_int8_cuda(  # noqa: E731
                xv[:m], xm[:m], xs[:m], wv, wm, ws, cfg, cfg, bias=bias, act=a, out_dtype=o,
                acc_out=acc)
            plain = lambda m, a, o: ref.dbb_matmul_aw_int8_ref(  # noqa: E731
                xv[:m], xm[:m], xs[:m], wv, wm, ws, cfg, cfg, bias=bias, act=a, out_dtype=o)
            x_bytes = lambda m: xv[:m].numel() + xm[:m].numel() + 4 * m  # noqa: E731
            total, tc = dbb_matmul.AW_INT8, dbb_matmul.AW_INT8_TC
        else:
            if name != "lm_head":  # every other dense-input linear's input is DAP-pruned
                x = apply_dap(x, DAPSpec(4, 8))
            xq, xs = ref.quantize_act_int8(x, per_row=True)
            x_dense = xq
            kern = lambda m, a, o, acc=None: dbb_matmul.dbb_matmul_int8_cuda(  # noqa: E731
                xq[:m], xs[:m], wv, wm, ws, cfg, bias=bias, act=a, out_dtype=o, acc_out=acc)
            plain = lambda m, a, o: ref.dbb_matmul_int8_ref(  # noqa: E731
                xq[:m], xs[:m], wv, wm, ws, cfg, bias=bias, act=a, out_dtype=o)
            x_bytes = lambda m: xq[:m].numel() + 4 * m  # noqa: E731
            total, tc = dbb_matmul.INT8, dbb_matmul.INT8_TC
        # exact: int32 accumulators and the act=None f32 output; a row's bits
        # do not depend on M; every call runs the row's body
        before = (total.launches, tc.launches)
        y = {}
        for m in (1, 4, 64):
            acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
            y[m] = kern(m, None, torch.float32, acc)
            check(torch.equal(acc, ref.int8_acc(x_dense[:m], w_dense)),
                  f"{arch} {name} M={m}: int32 accumulators differ")
            check(torch.equal(y[m], plain(m, None, torch.float32)),
                  f"{arch} {name} M={m}: act=None f32 output differs")
        check_body(f"{kname} {arch} {name}", body, total, tc, before)
        check(torch.equal(y[1][0], y[4][0]) and torch.equal(y[4], y[64][:4]),
              f"{arch} {name}: a row's output differs between M=1, 4 and 64")
        bm, kb_per_split, n_split = dbb_matmul.int8_plan(64, k, n)
        path = (f"path: tc body, {n_split} splits of {kb_per_split} 8-blocks at M=64"
                if body == "tc" else "path: generic body")
        with_bias = "" if bias is None else " with a random bias"
        mixer = MIXER_TIMED.get((arch, name))
        if arch not in INT8_TIMED and mixer is None:
            say(f"kernel {kname} {arch} {name} K={k} N={n} ({path}): int32 accumulators and "
                f"act=None f32 output{with_bias} bit-exact at M=1, 4 and 64, rows bitwise equal")
            del wv, wm, ws, w_dense, x_dense, y
            torch.cuda.empty_cache()
            continue
        count = 1 if name == "lm_head" else mixer or INT8_TIMED[arch]  # launches per pass
        w_cm = w_dense.t().contiguous().t()  # the column-major ("TN") weight for _int_mm
        for m in (4, 64):
            # silu and bf16: the f32 silu within 1e-6; bf16 within one bf16 ulp
            # (a 1-ulp f32 difference in sigmoid can straddle a bf16 rounding)
            ys = kern(m, "silu", torch.float32)
            ys_ref = plain(m, "silu", torch.float32)
            err32 = (ys - ys_ref).abs()
            check(bool((err32 <= 1e-6 + 1e-6 * ys_ref.abs()).all()),
                  f"{arch} {name} M={m}: silu f32 off by {err32.max().item():.3g}")
            yb = kern(m, "silu", torch.bfloat16).float()
            yb_ref = plain(m, "silu", torch.bfloat16).float()
            errb = (yb - yb_ref).abs()
            check(bool((errb <= 2.0 ** -7 * yb_ref.abs() + 1e-6).all()),
                  f"{arch} {name} M={m}: silu bf16 off by {errb.max().item():.3g}")
            err = max(err32.max().item(), errb.max().item())
            # times at the main path's call: bf16 out, its own activation
            t_k = run_ms(lambda: kern(m, act, torch.bfloat16), iters=10)
            t_p = run_ms(lambda: plain(m, act, torch.bfloat16), iters=2)
            t_rm = t_cm = t_lib = None
            if m > 16 and n % 8 == 0:  # torch._int_mm refuses M <= 16, N % 8 != 0
                t_rm = run_ms(lambda: torch._int_mm(x_dense[:m], w_dense), iters=10)
                t_cm = run_ms(lambda: torch._int_mm(x_dense[:m], w_cm), iters=10)
                t_lib = min(t_rm, t_cm)
            nbytes = x_bytes(m) + wv.numel() + wm.numel() + 4 * n + 2 * m * n
            if bias is not None:
                nbytes += 2 * n
            x_nz = (x_dense[:m] != 0).sum(dim=0).double()
            nops = 2.0 * float((x_nz * w_nz).sum())  # non-zero products only
            bound = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / INT8_OPS_PER_S else "operations"
            lib = ("n/a (_int_mm: M <= 16 or N % 8 != 0)" if t_lib is None else
                   f"{t_lib:.4f} (_int_mm, weight row-major {t_rm:.4f}, column-major {t_cm:.4f})")
            say(f"kernel {kname} {arch} {name} M={m} K={k} N={n}{with_bias} ({path}): kernel_ms "
                f"{t_k:.4f} plain_ms {t_p:.3f} library_ms {lib} bound_ms {bound:.4f} ({by}) "
                f"max_abs_err {err:.3g}")
            if mixer is not None:
                shapes[kname].append(shape_record(arch, name, kind, k, n, m, body, count, t_k,
                                                  t_p, nbytes, nops, INT8_OPS_PER_S, t_lib, err))
                continue
            # one mixed-step forward pass: the record (granite) or qwen2-vl's line
            agg = (per_kernel if arch == "granite-3-8b" else qwen)[kname]
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if m == 64:
                agg["ms"] += count * t_k
                agg["plain_ms"] += count * t_p
                agg["library_ms"] += count * t_lib
                agg["bytes"] += count * nbytes
                agg["ops"] += count * nops
        check_body(f"{kname} {arch} {name}", body, total, tc, before)
        say(f"kernel {kname} {arch} {name}: int32 accumulators and act=None f32 output"
            f"{with_bias} bit-exact at M=1, 4 and 64, rows bitwise equal ({body} body)")
        del wv, wm, ws, w_dense, w_cm, x_dense, y
        torch.cuda.empty_cache()
    for name in per_kernel:
        finish_bound(per_kernel[name], INT8_OPS_PER_S)
        finish_bound(qwen[name], INT8_OPS_PER_S)
    return per_kernel


def mixed_q_pos(torch, lengths, s):
    """The q_pos of a main-path mixed step over requests that cached
    ``lengths`` tokens: rows 0 and 2 decode (one token, then S - 1 padding
    rows at -1), row 1 prefills a whole chunk and row 3 the chunk's tail
    (S / 2 + 2 tokens, the rest padding)."""
    q_pos = torch.full((len(lengths), s), -1, dtype=torch.int32, device="cuda")
    for i, t in enumerate(lengths):
        n = (1, s, 1, s // 2 + 2)[i]
        q_pos[i, :n] = torch.arange(t - n, t, dtype=torch.int32, device="cuda")
    return q_pos


# #6-GQA cases of phase 3: (path, query heads per KV head, KV heads, head
# dim, KV dtype, layers, window, pages a table, tokens cached per request,
# query lengths); starcoder2's table holds more than its 4096-token window
ATTN_CASES = (
    ("granite-3-8b", 4, 8, 128, "int8", 40, None, 64, (1000, 517, 64, 250), (1, 16)),
    ("granite-moe-1b-a400m", 2, 8, 64, "native", 24, None, 64, (1000, 517, 64, 250), (1, 16)),
    ("qwen2-vl-72b", 8, 8, 128, "int8", 80, None, 64, (1000, 517, 64, 250), (1, 16)),
    ("starcoder2-15b", 12, 4, 128, "native", 40, 4096, 320, (5000, 4517, 64, 250),
     (1, 16, 20)),
)


def phase_attention(torch, run_ms, qwen):
    """Kernel #6's GQA mode at the main paths' shapes (``ATTN_CASES``):
    granite-3-8b (32 heads over 8 KV heads of 128, int8 KV),
    granite-moe-1b-a400m (16 over 8 of 64, native bf16 KV), qwen2-vl-72b
    (64 over 8 of 128, int8 KV) and starcoder2-15b (48 over 4 of 128: 12
    a KV head, native KV, its 4096-token window over tables of 5120
    slots), decode and chunks of 16 (starcoder2 also 20) rows, held
    against its plain version and timed beside SDPA on the gathered
    window; the chunks also on a main-path mixed step, where padding rows
    have no valid key.  bf16 calls must run the tensor-core kernel; f32
    calls (the scalar kernel) are held too, and both on rows with no
    valid key.  The record holds granite's mixed pass, ``qwen`` qwen2-vl's."""
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, ps = 4, 16
    stats = new_pass()
    qwen["paged_attn"] = new_pass()
    for arch, g, kv, d, kv_dtype, n_layers, window, p_cnt, lengths, sizes in ATTN_CASES:
        n_pages = b * p_cnt + 1
        kvd = kv * d
        k_f = torch.randn((n_pages, ps, kvd), generator=gen, device="cuda")
        v_f = torch.randn((n_pages, ps, kvd), generator=gen, device="cuda")
        if kv_dtype == "int8":
            (k_p, k_s), (v_p, v_s) = quant.quantize_rows(k_f), quant.quantize_rows(v_f)
            k32, v32 = k_p, v_p
        else:
            k_p, v_p, k_s, v_s = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16), None, None
            k32, v32 = k_p.float(), v_p.float()
        del k_f, v_f
        pos_tbl, tables = paged_tables(torch, gen, b, ps, p_cnt, lengths)
        kw = dict(kv_heads=kv, k_scale=k_s, v_scale=v_s, window=window)
        # library yardstick: SDPA over the gathered (dequantized) window;
        # the gather is set-up, outside the timed call
        if kv_dtype == "int8":
            kk = quant.dequantize_rows(k_p[tables.long()], k_s[tables.long()], torch.bfloat16)
            vv = quant.dequantize_rows(v_p[tables.long()], v_s[tables.long()], torch.bfloat16)
        else:
            kk, vv = k_p[tables.long()], v_p[tables.long()]
        kk = kk.reshape(b, p_cnt * ps, kv, d).transpose(1, 2)
        vv = vv.reshape(b, p_cnt * ps, kv, d).transpose(1, 2)
        kpos = pos_tbl[tables.long()].reshape(b, 1, 1, p_cnt * ps)
        patterns = [(s, pat) for s in sizes for pat in (("decode",) if s == 1
                                                         else ("chunks", "mixed"))]
        for s, pattern in patterns:
            q = torch.randn((b, s, kv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
            if pattern == "mixed":
                q_pos = mixed_q_pos(torch, lengths, s)
            else:
                q_pos = torch.stack(
                    [torch.arange(t - s, t, device="cuda") for t in lengths]).to(torch.int32)
            where = f"paged_attn {arch} S={s} {pattern}"
            tc_before = paged_attn.PAGED_ATTN_TC.launches
            out = paged_attn.paged_attn_cuda(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            check(paged_attn.PAGED_ATTN_TC.launches == tc_before + 1,
                  f"{where} bf16: not the tensor-core kernel")
            want = ref.paged_attn_ref(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            # bf16: the sums run in another order, which can straddle a bf16
            # rounding of a probability or of the output: two bf16 ulps at 1
            err = (out.float() - want.float()).abs().max().item()
            check(err <= 1.6e-2, f"{where} bf16: max error {err:.3g}")
            out32 = paged_attn.paged_attn_cuda(q.float(), k32, v32, pos_tbl, tables, q_pos, **kw)
            want32 = ref.paged_attn_ref(q.float(), k32, v32, pos_tbl, tables, q_pos, **kw)
            err32 = (out32 - want32).abs().max().item()
            check(err32 <= 1e-5 + 1e-5 * want32.abs().max().item(),
                  f"{where} f32: max error {err32:.3g}")
            # rows with no valid key (a padding tail, an idle row over the
            # null page) take the uniform mean over their table, as the plain
            # version
            q_pad, t_pad = q_pos.clone(), tables.clone()
            q_pad[0, s // 2 + 1:] = -1
            q_pad[3], t_pad[3] = -1, 0
            out32 = paged_attn.paged_attn_cuda(q.float(), k32, v32, pos_tbl, t_pad, q_pad, **kw)
            want32 = ref.paged_attn_ref(q.float(), k32, v32, pos_tbl, t_pad, q_pad, **kw)
            err_pad = (out32 - want32).abs().max().item()
            check(err_pad <= 1e-5 + 1e-5 * want32.abs().max().item(),
                  f"{where} f32 with keyless rows: max error {err_pad:.3g}")
            # the same keyless rows in bf16, through the tensor-core kernel
            out16 = paged_attn.paged_attn_cuda(q, k_p, v_p, pos_tbl, t_pad, q_pad, **kw)
            want16 = ref.paged_attn_ref(q, k_p, v_p, pos_tbl, t_pad, q_pad, **kw)
            err_pad16 = (out16.float() - want16.float()).abs().max().item()
            check(err_pad16 <= 1.6e-2, f"{where} bf16 with keyless rows: max error "
                  f"{err_pad16:.3g}")
            t_k = run_ms(lambda: paged_attn.paged_attn_cuda(
                q, k_p, v_p, pos_tbl, tables, q_pos, **kw), 20)
            t_p = run_ms(lambda: ref.paged_attn_ref(q, k_p, v_p, pos_tbl, tables, q_pos, **kw), 2)
            qp = q_pos.reshape(b, 1, s, 1)
            mask = (kpos >= 0) & (kpos <= qp)
            if window is not None:
                mask &= kpos > qp - window
            qq = q.transpose(1, 2)
            t_lib = run_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, enable_gqa=True), 20)
            # the pages this data attends: those with a key some row sees
            n_pages_read = int(mask.reshape(b, s, p_cnt, ps).any(dim=3).any(dim=1).sum())
            # k, v rows (+ their scales), slot positions of those pages
            page_bytes = 2 * ps * kvd * k_p.element_size() + 4 * ps
            if kv_dtype == "int8":
                page_bytes += 2 * 4 * ps
            nbytes = (2 * q.numel() * 2 + n_pages_read * page_bytes + tables.numel() * 4
                      + q_pos.numel() * 4)
            n_pairs = int(mask.sum())  # (query token, key) pairs this data attends
            nops = 4.0 * kv * g * d * n_pairs  # QK^T and PV
            bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / BF16_OPS_PER_S else "operations"
            say(f"kernel paged_attn {arch} B={b} S={s} {pattern} H={kv * g} KV={kv} D={d} "
                f"P={p_cnt} PS={ps} window={window} {kv_dtype}-KV bf16 (path: tensor cores, "
                f"{paged_attn.PAGES_PER_SPLIT} pages per split): kernel_ms {t_k:.4f} "
                f"plain_ms {t_p:.3f} library_ms {t_lib:.4f} bound_ms {bound:.4f} ({by}) "
                f"max_abs_err {err:.3g} (keyless rows {err_pad16:.3g}; f32 path: scalar, "
                f"{err32:.3g}, keyless rows {err_pad:.3g})")
            stats["max_abs_err"] = max(stats["max_abs_err"], err, err_pad16)
            if arch in ("granite-3-8b", "qwen2-vl-72b") and (s, pattern) == (16, "mixed"):
                # one mixed-step forward pass: the record (granite) or qwen2-vl's line
                agg = stats if arch == "granite-3-8b" else qwen["paged_attn"]
                agg.update(ms=n_layers * t_k, plain_ms=n_layers * t_p,
                           library_ms=n_layers * t_lib, bytes=n_layers * nbytes,
                           ops=n_layers * nops)
        del k_p, v_p, k32, v32, kk, vv
        torch.cuda.empty_cache()
    stats["max_abs_err"] = max(stats["max_abs_err"], small_page_gqa(torch, gen),
                               large_page_attention(torch, gen, latent=False))
    finish_bound(qwen["paged_attn"], BF16_OPS_PER_S)
    return finish_bound(stats, BF16_OPS_PER_S)


def small_page_gqa(torch, gen):
    """bf16 GQA calls at pages of 4 and 2 slots (pad slots fill the S
    fragment's 8-slot n-tile) at granite-3-8b's head shape, int8 and
    native KV, a mixed step with an idle row: through the tensor-core
    kernel, within 1.6e-2 of the plain version.  Returns the max error."""
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn, ref

    b, kv, g, d, s = 4, 8, 4, 128, 16
    lengths = (300, 117, 64, 50)
    worst = 0.0
    for ps in (4, 2):
        p_cnt = -(-max(lengths) // ps) + 1
        n_pages = b * p_cnt + 1
        k_f = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
        v_f = torch.randn((n_pages, ps, kv * d), generator=gen, device="cuda")
        pos_tbl = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
        tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")
        nxt = 1
        for i, t in enumerate(lengths):
            used = -(-t // ps)
            tables[i, :used] = torch.arange(nxt, nxt + used, device="cuda")
            pos = torch.arange(used * ps, device="cuda")
            pos_tbl[nxt:nxt + used] = torch.where(pos < t, pos, -1).reshape(used, ps).int()
            nxt += used
        q_pos = mixed_q_pos(torch, lengths, s)
        q_pos[3], tables[3] = -1, 0  # an idle row over the null page
        q = torch.randn((b, s, kv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
        for kv_name in ("int8", "native"):
            if kv_name == "int8":
                (k_p, k_s), (v_p, v_s) = quant.quantize_rows(k_f), quant.quantize_rows(v_f)
            else:
                k_p, v_p, k_s, v_s = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16), None, None
            kw = dict(kv_heads=kv, k_scale=k_s, v_scale=v_s)
            tc_before = paged_attn.PAGED_ATTN_TC.launches
            out = paged_attn.paged_attn_cuda(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            check(paged_attn.PAGED_ATTN_TC.launches == tc_before + 1,
                  f"paged_attn PS={ps} {kv_name} KV bf16: not the tensor-core kernel")
            want = ref.paged_attn_ref(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= 1.6e-2, f"paged_attn PS={ps} {kv_name} KV bf16: max error {err:.3g}")
            say(f"kernel paged_attn granite-3-8b B={b} S={s} mixed with an idle row H={kv * g} "
                f"KV={kv} D={d} P={p_cnt} PS={ps} {kv_name}-KV bf16 (path: tensor cores): "
                f"max_abs_err {err:.3g}")
            worst = max(worst, err)
    return worst


def large_page_attention(torch, gen, latent):
    """bf16 #6 at pages of 72 slots (walked as a 64-slot sub-page and an
    8-slot one), int8 and native KV, a mixed step with an idle row over
    the null page: GQA at granite-3-8b's head shape, or the latent mode at
    minicpm3-4b's (Dk 288, Dv 256, 40 heads) and at its smoke config's
    latent (Dk 40 = kv_lora 32 + rope 8, zero-padded to 48 in shared
    memory; Dv 32, 4 heads), the latter at pages of 16 and 72 slots.
    Every call through the tensor-core kernel, within 1.6e-2 of the plain
    version.  Returns the max error."""
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn, ref

    b, s = 4, 16
    lengths = (300, 117, 64, 50)
    if latent:
        cases = [(72, 40, 288, 256), (16, 4, 40, 32), (72, 4, 40, 32)]  # (PS, heads, Dk, Dv)
        counter = paged_attn.PAGED_ATTN_LATENT_TC
    else:
        cases = [(72, 32, 128, 128)]
        counter = paged_attn.PAGED_ATTN_TC
    worst = 0.0
    for ps, h, dk, dv in cases:
        kv = 1 if latent else 8
        p_cnt = -(-max(lengths) // ps) + 1
        n_pages = b * p_cnt + 1
        k_f = torch.randn((n_pages, ps, kv * dk), generator=gen, device="cuda")
        v_f = None if latent else torch.randn((n_pages, ps, kv * dv), generator=gen,
                                              device="cuda")
        pos_tbl = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
        tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")
        nxt = 1
        for i, t in enumerate(lengths):
            used = -(-t // ps)
            tables[i, :used] = torch.arange(nxt, nxt + used, device="cuda")
            pos = torch.arange(used * ps, device="cuda")
            pos_tbl[nxt:nxt + used] = torch.where(pos < t, pos, -1).reshape(used, ps).int()
            nxt += used
        q_pos = mixed_q_pos(torch, lengths, s)
        q_pos[3], tables[3] = -1, 0  # an idle row over the null page
        q = torch.randn((b, s, h, dk), generator=gen, device="cuda").to(torch.bfloat16)
        for kv_name in ("int8", "native"):
            if latent:
                k_s = v_p = v_s = None
                k_p = k_f.to(torch.bfloat16)
                if kv_name == "int8":
                    k_p, k_s = quant.quantize_rows(k_f)
                kw = dict(kv_heads=1, softmax_scale=1.0 / math.sqrt(96), k_scale=k_s,
                          latent_dv=dv)
            else:
                if kv_name == "int8":
                    (k_p, k_s), (v_p, v_s) = quant.quantize_rows(k_f), quant.quantize_rows(v_f)
                else:
                    k_p, v_p = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
                    k_s = v_s = None
                kw = dict(kv_heads=kv, k_scale=k_s, v_scale=v_s)
            tc_before = counter.launches
            out = paged_attn.paged_attn_cuda(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            mode = "paged_attn_latent" if latent else "paged_attn"
            check(counter.launches == tc_before + 1,
                  f"{mode} PS={ps} Dk={dk} {kv_name} KV bf16: not the tensor-core kernel")
            want = ref.paged_attn_ref(q, k_p, v_p, pos_tbl, tables, q_pos, **kw)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= 1.6e-2,
                  f"{mode} PS={ps} Dk={dk} {kv_name} KV bf16: max error {err:.3g}")
            say(f"kernel {mode} B={b} S={s} mixed with an idle row H={h} Dk={dk} Dv={dv} "
                f"P={p_cnt} PS={ps} {kv_name}-KV bf16 (path: tensor cores, "
                f"{-(-ps // 64)} sub-pages a page): max_abs_err {err:.3g}")
            worst = max(worst, err)
    return worst


def phase_native_matmuls(torch, run_ms, shapes):
    """Kernels #1 and #4 at every full-width native-wire shape
    (``NATIVE_LINEARS``: minicpm3-4b, granite-moe-1b-a400m, starcoder2-15b
    with its gelu ``up``, phi3.5-moe, qwen2-vl-72b, mamba2-130m,
    hymba-1.5b and whisper-base), bf16 operands, a random bias on a biased
    wq, wk, wv: every call through the body its row names (hymba's N =
    6482 misses the tc body), held against their plain versions (float64
    products, rounded once) within 1e-5 of the largest output in f32, a
    row's bits checked equal at M=1, 4 and 64 (whisper's encoder linears
    also at its ``WHISPER_ENC_ROWS``); minicpm3-4b's and
    granite-moe-1b-a400m's and ``MIXER_TIMED``'s rows (into ``shapes``)
    timed at M=4 and 64.  The record holds minicpm3-4b's pass."""
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import dbb_matmul, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cfg = dbb.DBBConfig(4, 8)
    bf16 = torch.bfloat16
    per_kernel = {k: new_pass() for k in ("dbb_matmul_aw", "dbb_matmul")}
    for arch, name, kind, act, dap, k, n, body in NATIVE_LINEARS:
        rows = (1, 4, 64)
        if arch == "whisper-base" and name != "lm_head":
            rows += (WHISPER_ENC_ROWS,)
        w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).to(bf16)
        wv, wm = ops.pack_weight(w, cfg)
        del w
        w_dense = ref.decode_w(wv, wm, cfg)
        w_nz = (w_dense != 0).sum(dim=1).double()  # non-zeros per k row
        kname = "dbb_matmul_aw" if kind == "aw" else "dbb_matmul"
        bias = random_bias(torch, gen, arch, name, n)
        x = torch.randn((rows[-1], k), generator=gen, device="cuda").to(bf16)
        if dap:
            x = apply_dap(x, DAPSpec(4, 8))
        if kind == "aw":
            xv, xm = ops.dap_pack(x, 4, 8)
            x_dense = ref.decode_a(xv, xm, cfg)
            kern = lambda m, a, o: dbb_matmul.dbb_matmul_aw_cuda(  # noqa: E731
                xv[:m], xm[:m], wv, wm, cfg, cfg, bias=bias, act=a, out_dtype=o)
            plain = lambda m, a, o: ref.dbb_matmul_aw_ref(  # noqa: E731
                xv[:m], xm[:m], wv, wm, cfg, cfg, bias=bias, act=a, out_dtype=o)
            x_bytes = lambda m: 2 * xv[:m].numel() + xm[:m].numel()  # noqa: E731
        else:
            x_dense = x
            kern = lambda m, a, o: dbb_matmul.dbb_matmul_cuda(  # noqa: E731
                x[:m], wv, wm, cfg, bias=bias, act=a, out_dtype=o)
            plain = lambda m, a, o: ref.dbb_matmul_ref(  # noqa: E731
                x[:m], wv, wm, cfg, bias=bias, act=a, out_dtype=o)
            x_bytes = lambda m: 2 * m * k  # noqa: E731
        # a row's bits do not depend on M; every call runs the row's body
        total, tc = ((dbb_matmul.AW_NATIVE, dbb_matmul.AW_NATIVE_TC) if kind == "aw"
                     else (dbb_matmul.NATIVE, dbb_matmul.NATIVE_TC))
        before = (total.launches, tc.launches)
        y = {m: kern(m, act, torch.float32) for m in rows}
        check_body(f"{kname} {arch} {name}", body, total, tc, before)
        check(all(torch.equal(y[a], y[b][:a]) for a, b in zip(rows, rows[1:])),
              f"{arch} {name}: a row's output differs between M={rows}")
        bn, kb_per_split, n_split = dbb_matmul.native_plan(k, n)
        path = (f"path: tc body, BN {bn}, {n_split} splits of {kb_per_split} 8-blocks"
                if body == "tc" else "path: generic body")
        served = f" act={act}" + ("" if bias is None else " with a random bias")
        mixer = MIXER_TIMED.get((arch, name))
        errs = []
        for m in rows[1:]:
            # f32 output within 1e-5 of the largest output; bf16 within that
            # plus one bf16 ulp of the larger of the two outputs (an f32
            # difference can straddle a rounding, up into the next binade)
            want = plain(m, act, torch.float32)
            tol32 = 1e-5 * want.abs().max().item()
            err32 = (y[m] - want).abs().max().item()
            check(err32 <= tol32, f"{arch} {name} M={m}: f32 output off by {err32:.3g} "
                  f"(largest output {want.abs().max().item():.3g})")
            yb = kern(m, act, bf16).float()
            yb_ref = plain(m, act, bf16).float()
            errb = (yb - yb_ref).abs()
            ulp = 2.0 ** -7 * torch.maximum(yb.abs(), yb_ref.abs())
            check(bool((errb <= ulp + tol32).all()),
                  f"{arch} {name} M={m}: bf16 output off by {errb.max().item():.3g}")
            err = max(err32, errb.max().item())
            errs.append(err)
            if m > 64 or (arch not in NATIVE_TIMED and mixer is None):
                continue
            count = 1 if name == "lm_head" else mixer or NATIVE_TIMED[arch]  # calls a pass
            t_k = run_ms(lambda: kern(m, act, bf16), iters=10)
            t_p = run_ms(lambda: plain(m, act, bf16), iters=2)
            t_lib = run_ms(lambda: torch.matmul(x_dense[:m], w_dense), iters=10)
            nbytes = x_bytes(m) + 2 * wv.numel() + wm.numel() + 2 * m * n
            x_nz = (x_dense[:m] != 0).sum(dim=0).double()
            nops = 2.0 * float((x_nz * w_nz).sum())  # non-zero products only
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"kernel {kname} {arch} {name} M={m} K={k} N={n} bf16 ({path}): kernel_ms "
                f"{t_k:.4f} plain_ms {t_p:.3f} library_ms {t_lib:.4f} (matmul) bound_ms "
                f"{bound:.4f} ({by}) max_abs_err {err:.3g} (f32 {err32:.3g})")
            if mixer is not None:
                shapes[kname].append(shape_record(arch, name, kind, k, n, m, body, count, t_k,
                                                  t_p, nbytes, nops, BF16_OPS_PER_S, t_lib, err))
            elif m == 64 and arch == "minicpm3-4b":  # the JSON record: one mixed-step pass
                agg = per_kernel[kname]
                agg["ms"] += count * t_k
                agg["plain_ms"] += count * t_p
                agg["library_ms"] += count * t_lib
                agg["bytes"] += count * nbytes
                agg["ops"] += count * nops
        check_body(f"{kname} {arch} {name}", body, total, tc, before)
        per_kernel[kname]["max_abs_err"] = max(per_kernel[kname]["max_abs_err"], *errs)
        say(f"kernel {kname} {arch} {name} K={k} N={n} bf16{served} ({path}): within "
            f"tolerance at M={', '.join(map(str, rows[1:]))} (max_abs_err {max(errs):.3g}), "
            f"rows bitwise equal at M={', '.join(map(str, rows))}")
        del wv, wm, w_dense, x_dense, y
        torch.cuda.empty_cache()
    for agg in per_kernel.values():
        finish_bound(agg, BF16_OPS_PER_S)
    return per_kernel


def phase_latent_attention(torch, run_ms):
    """Kernel #6's latent mode at minicpm3-4b's shapes (40 heads over one
    288-wide latent, v its first 256 features, softmax scale 1/sqrt(96)),
    native bf16 and int8 KV, on a decode step, whole chunks (the record)
    and a mixed step (decode rows, a whole chunk, a chunk tail: padding
    rows with no valid key): bf16 calls must run the latent tensor-core
    kernel, held against the plain version with and without keyless rows
    (an idle request over the null page, a padding tail); f32 calls (the
    scalar kernel) too; timed beside SDPA on the gathered latent window
    (one KV head, the heads folded into the query rows)."""
    from repro_torch.core import quant
    from repro_torch.kernels import paged_attn, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, h, dk, dv, ps, p_cnt = 4, 40, 288, 256, 16, 64
    scale = 1.0 / math.sqrt(64 + 32)
    n_pages = b * p_cnt + 1
    lat = torch.randn((n_pages, ps, dk), generator=gen, device="cuda")
    lat_q, lat_s = quant.quantize_rows(lat)
    lat = lat.to(torch.bfloat16)
    lengths = (1000, 517, 64, 250)  # tokens cached per request
    pos_tbl, tables = paged_tables(torch, gen, b, ps, p_cnt, lengths)
    valid_pages = pos_tbl[tables.long()].ge(0).any(dim=-1)  # [B, P] pages with data
    n_valid = int(valid_pages.sum())
    stats = new_pass()
    for kv_name, pages, k_scale in (("native", lat, None), ("int8", lat_q, lat_s)):
        kw = dict(kv_heads=1, softmax_scale=scale, k_scale=k_scale, latent_dv=dv)
        pages32 = pages if k_scale is not None else pages.float()
        # library yardstick: SDPA over the gathered, dequantized latent
        # window as one KV head, the 40 heads folded into the query rows
        # (row s * h + head; the gather, V's columns and the per-row mask are
        # set-up).  Not stride-0 views of the window expanded over the heads:
        # SDPA on those faults (scripts/sdpa_fault.py).
        win = pages[tables.long()].reshape(b, p_cnt * ps, dk)
        if k_scale is not None:
            win = quant.dequantize_rows(win, k_scale[tables.long()].reshape(b, -1),
                                        torch.bfloat16)
        kk = win[:, None]
        vv = win[:, None, :, :dv].contiguous()
        kpos = pos_tbl[tables.long()].reshape(b, 1, 1, p_cnt * ps)
        for s, pattern in ((1, "decode"), (16, "chunks"), (16, "mixed")):
            q = torch.randn((b, s, h, dk), generator=gen, device="cuda").to(torch.bfloat16)
            if pattern == "mixed":
                q_pos = mixed_q_pos(torch, lengths, s)
            else:
                q_pos = torch.stack(
                    [torch.arange(t - s, t, device="cuda") for t in lengths]).to(torch.int32)
            tc_before = paged_attn.PAGED_ATTN_LATENT_TC.launches
            out = paged_attn.paged_attn_cuda(q, pages, None, pos_tbl, tables, q_pos, **kw)
            check(paged_attn.PAGED_ATTN_LATENT_TC.launches == tc_before + 1,
                  f"paged_attn_latent S={s} {pattern} {kv_name} KV bf16: not the latent "
                  f"tensor-core kernel")
            want = ref.paged_attn_ref(q, pages, None, pos_tbl, tables, q_pos, **kw)
            # bf16: two bf16 ulps at 1, as for the GQA mode
            err = (out.float() - want.float()).abs().max().item()
            check(err <= 1.6e-2,
                  f"paged_attn_latent S={s} {pattern} {kv_name} KV bf16: max error {err:.3g}")
            out32 = paged_attn.paged_attn_cuda(q.float(), pages32, None, pos_tbl, tables, q_pos,
                                               **kw)
            want32 = ref.paged_attn_ref(q.float(), pages32, None, pos_tbl, tables, q_pos, **kw)
            err32 = (out32 - want32).abs().max().item()
            check(err32 <= 1e-5 + 1e-5 * want32.abs().max().item(),
                  f"paged_attn_latent S={s} {pattern} {kv_name} KV f32: max error {err32:.3g}")
            # rows with no valid key (a padding tail, an idle request over the
            # null page) take the uniform mean over their table, as the plain
            # version
            q_pad, t_pad = q_pos.clone(), tables.clone()
            q_pad[0, s // 2 + 1:] = -1
            q_pad[3], t_pad[3] = -1, 0
            out16 = paged_attn.paged_attn_cuda(q, pages, None, pos_tbl, t_pad, q_pad, **kw)
            want16 = ref.paged_attn_ref(q, pages, None, pos_tbl, t_pad, q_pad, **kw)
            err_pad = (out16.float() - want16.float()).abs().max().item()
            check(err_pad <= 1.6e-2,
                  f"paged_attn_latent S={s} {pattern} {kv_name} KV bf16 with keyless rows: "
                  f"max error {err_pad:.3g}")
            t_k = run_ms(lambda: paged_attn.paged_attn_cuda(
                q, pages, None, pos_tbl, tables, q_pos, **kw), 20)
            t_p = run_ms(lambda: ref.paged_attn_ref(q, pages, None, pos_tbl, tables, q_pos, **kw), 2)
            mask = ((kpos >= 0) & (kpos <= q_pos.reshape(b, 1, s, 1)))[:, :, :, None]
            mask = mask.expand(b, 1, s, h, p_cnt * ps).reshape(b, 1, s * h, p_cnt * ps)
            qq = q.reshape(b, 1, s * h, dk)
            t_lib = run_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=scale), 20)
            page_bytes = ps * dk * pages.element_size() + 4 * ps + (4 * ps if k_scale is not None else 0)
            nbytes = (2 * q.numel() + 2 * b * s * h * dv + n_valid * page_bytes
                      + tables.numel() * 4 + q_pos.numel() * 4)
            nops = 2.0 * s * h * (dk + dv) * n_valid * ps  # QK^T and PV over kept pages
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"kernel paged_attn_latent B={b} S={s} {pattern} H={h} Dk={dk} Dv={dv} "
                f"P={p_cnt} PS={ps} {kv_name}-KV bf16 (path: latent tensor cores, "
                f"{paged_attn.PAGES_PER_SPLIT} pages per split): kernel_ms {t_k:.4f} "
                f"plain_ms {t_p:.3f} library_ms {t_lib:.4f} (SDPA, one KV head) "
                f"bound_ms {bound:.4f} ({by}) "
                f"max_abs_err {err:.3g} (keyless rows {err_pad:.3g}; f32 path: scalar, "
                f"{err32:.3g})")
            stats["max_abs_err"] = max(stats["max_abs_err"], err, err_pad)
            if pattern == "chunks" and kv_name == "native":  # the JSON record: one mixed-step pass
                stats.update(ms=62 * t_k, plain_ms=62 * t_p, library_ms=62 * t_lib,
                             bytes=62 * nbytes, ops=62 * nops)
        del win, kk, vv
    stats["max_abs_err"] = max(stats["max_abs_err"], large_page_attention(torch, gen, latent=True))
    return finish_bound(stats, BF16_OPS_PER_S)


def dap_inputs(torch, gen, m, k, dtype):
    """``m`` normal rows of ``k`` with the hard cases planted in the first
    three: a NaN, zeros of both signs and ties in block 0 and a NaN block
    (row 0), ties of small integers and a -0.0 block (row 1), +-inf (row
    2: an int8 form's scale is inf there)."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    inf, nan = float("inf"), float("nan")
    x[0, :8] = torch.tensor([3.0, -3.0, 0.0, -0.0, nan, -3.0, -inf, 1.0], device="cuda")
    x[0, 8:16] = nan
    x[1] = torch.randint(-2, 3, (k,), generator=gen, device="cuda").float()
    x[1, :8] = -0.0
    x[2, :8] = torch.tensor([inf, -inf, 1.0, -inf, 2.0, inf, 0.5, -1.0], device="cuda")
    return x.to(dtype)


def phase_dap_prune(torch, run_ms, qwen):
    """Kernel #5's four forms (dense, pack, dense_int8, pack_int8) bit for
    bit against their plain versions at every width each serves on the
    main paths and the recurrent and enc-dec phases (``DAP_WIDTHS``), bf16
    and f32, M = 1, 4 and 64 (a row's bits the same at every M; the long
    rows of ``DAP_LONG_ROWS`` too: the per-row forms at K 29568 and 49152
    at M = 512, whisper's encoder forms at its 6000 rows), with a NaN
    block, +-inf, ties and -0.0 planted; timed in bf16 at M = 4 and 64
    beside the plain version and the bytes bound (no library call
    computes DAP: ``torch.topk`` breaks ties in no fixed order); the
    CNN's widths (K = 8 and 16, ``CNN_WIDTHS``) held at NNZ 4 and 2 and
    timed in ``phase_examples``.  dense_int8 is also timed beside the chain it replaces on
    granite's wo (#5's dense form, then the plain per-row quantize).  The
    record holds one form's pass (``DAP_RECORD``), ``qwen`` qwen2-vl-72b's
    int8 forms' pass."""
    from repro_torch.kernels import dap_prune, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    stats = {name: dict(new_pass(), library_ms=None) for name in DAP_FORMS}
    qwen.update({name: dict(new_pass(), library_ms=None) for name in QWEN2_VL_DAP})
    for k, what, served in DAP_WIDTHS:
        for name in served:
            kern, plain = getattr(dap_prune, DAP_FORMS[name][0]), getattr(ref, DAP_FORMS[name][1])
            rows = (1, 4, 64)
            long_m, long_forms = DAP_LONG_ROWS.get(k, (None, ()))
            if name in long_forms:
                rows += (long_m,)
            for dtype, nnz in [(d, n) for d in (torch.bfloat16, torch.float32)
                               for n in CNN_WIDTHS.get(k, (4,))]:
                x = dap_inputs(torch, gen, rows[-1], k, dtype)
                full = kern(x, nnz)
                err = 0.0  # over the finite entries of every output (codes and scales too)
                for m in rows:
                    got, want = kern(x[:m], nnz), plain(x[:m], nnz)
                    for i, (g, w) in enumerate(zip(got, want)):
                        v = view.get(g.dtype, g.dtype)
                        check(g.dtype == w.dtype and g.shape == w.shape
                              and torch.equal(g.view(v), w.view(v)),
                              f"{name} K={k} M={m} {dtype} NNZ {nnz} output {i}: differs from "
                              f"its plain version")
                        check(torch.equal(g.view(v), full[i][:m].view(v)),
                              f"{name} K={k} M={m} {dtype} NNZ {nnz} output {i}: a row's bits "
                              f"depend on M")
                        gf, wf = g.float(), w.float()
                        diff = (gf - wf)[torch.isfinite(gf) & torch.isfinite(wf)]
                        if diff.numel():
                            err = max(err, diff.abs().max().item())
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                if k in CNN_WIDTHS:
                    say(f"kernel {name} K={k} ({what}) {dtype} NNZ {nnz}: bit-exact at M="
                        f"{', '.join(str(r) for r in rows)}, NaN, +-inf, ties and -0.0 planted")
                if dtype != torch.bfloat16 or k in CNN_WIDTHS:
                    continue
                for m in (4, 64):
                    xm = x[:m]
                    out = kern(xm, 4)
                    t_k = run_ms(lambda: kern(xm, 4), iters=15)
                    t_p = run_ms(lambda: plain(xm, 4), iters=3)
                    chain = ""
                    if name == "dap_prune_int8":
                        t_c = run_ms(lambda: ref.quantize_act_int8(
                            dap_prune.dap_prune_cuda(xm, 4)[0], per_row=True), iters=15)
                        chain = f" (the chain it replaces: #5 dense + plain quantize {t_c:.4f})"
                    nbytes = xm.numel() * xm.element_size() + sum(
                        t.numel() * t.element_size() for t in out)
                    bound = nbytes / HBM_BYTES_PER_S * 1e3
                    held = ", ".join(str(r) for r in rows)
                    say(f"kernel {name} M={m} K={k} ({what}) bf16: kernel_ms {t_k:.4f} "
                        f"plain_ms {t_p:.3f}{chain} library_ms none bound_ms {bound:.5f} (bytes) "
                        f"bit-exact (bf16, f32 at M={held}), max_abs_err {err:.3g} over the "
                        f"finite entries")
                    if m != 64:
                        continue
                    # one mixed-step pass: the record's arch, and qwen2-vl's line
                    for st, per_pass in ((stats[name], DAP_RECORD[name][1]),
                                         (qwen.get(name), QWEN2_VL_DAP.get(name, {}))):
                        if k in per_pass:
                            st["ms"] += per_pass[k] * t_k
                            st["plain_ms"] += per_pass[k] * t_p
                            st["bytes"] += per_pass[k] * nbytes
    for st in list(stats.values()) + list(qwen[name] for name in QWEN2_VL_DAP):
        finish_bound(st, BF16_OPS_PER_S)
    return stats


# phase_autotune's matmul sweeps at M = 64: (kind, arch, linear, K, N, act on
# the main path); the kinds are kernels #3, #2, #4 and #1
AUTOTUNE_MATMULS = (
    ("aw_int8", "granite-3-8b", "wq", 4096, 4096, None),
    ("aw_int8", "granite-3-8b", "gate", 4096, 12800, "silu"),
    ("aw_int8", "granite-3-8b", "down", 12800, 4096, None),
    ("aw_int8", "qwen2-vl-72b", "gate", 8192, 29568, "silu"),
    ("aw_int8", "qwen2-vl-72b", "down", 29568, 8192, None),
    ("w_int8", "granite-3-8b", "lm_head", 4096, 49408, None),
    ("aw", "minicpm3-4b", "gate", 2560, 6400, "silu"),
    ("aw", "minicpm3-4b", "down", 6400, 2560, None),
    ("w", "minicpm3-4b", "lm_head", 2560, 73472, None),
)
AUTOTUNE_M = 64
AUTOTUNE_ITERS = 5  # cold-L2 calls a candidate's median takes


def paged_tables(torch, gen, b, ps, p_cnt, lengths):
    """A page pool's slot positions and ``b`` null-padded tables of
    ``p_cnt`` pages over random pages, request ``i`` holding
    ``lengths[i]`` tokens and one more (recycled, scrubbed) page."""
    n_pages = b * p_cnt + 1
    pos_tbl = torch.full((n_pages, ps), -1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((b, p_cnt), dtype=torch.int32, device="cuda")
    nxt = 0
    for i, t in enumerate(lengths):
        used = -(-t // ps) + 1
        pages = perm[nxt:nxt + used]
        nxt += used
        tables[i, :used] = pages
        for j, page in enumerate(pages[:-1].tolist()):
            pos = torch.arange(j * ps, (j + 1) * ps, device="cuda")
            pos_tbl[page] = torch.where(pos < t, pos, -1).to(torch.int32)
    return pos_tbl, tables


def phase_autotune(torch, run_ms):
    """``kernels/autotune.py`` on the card: sweep every candidate plan of
    #3 at granite-3-8b's wq, gate, down and qwen2-vl-72b's gate, down, #2
    at granite's lm_head, #4 at minicpm3-4b's gate, down and #1 at its
    lm_head (M = 64, random packed operands, the main path's act and bf16
    output), each candidate's cold-L2 median ms (``run_ms``) and its error
    against the plain version (#2/#3: the int32 accumulators and the
    act=None f32 output bit for bit; #1/#4: f32 within 1e-5 of the largest
    output, bf16 within one ulp, and an M = 4 call's rows equal to the M =
    64 call's bit for bit); then gather against fused at granite's decode
    shape (int8 KV) and minicpm3's latent shape.  The winners go to a JSON
    file named by ``REPRO_TORCH_AUTOTUNE_CACHE`` in a temporary directory;
    a fresh process with the variable set resolves ``get_plan`` and
    ``get_paged_attn_impl`` to them, and with it unset and the in-process
    cache cleared they are the heuristic's again.  Nothing is left behind:
    every later phase runs today's plans."""
    import tempfile

    from repro_torch import configs
    from repro_torch.core import dbb, quant
    from repro_torch.core.dap import DAPSpec, apply_dap
    from repro_torch.kernels import autotune, dbb_matmul, ops, ref
    from repro_torch.models import attention

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cfg = dbb.DBBConfig(4, 8)
    bf16, m = torch.bfloat16, AUTOTUNE_M
    var = "REPRO_TORCH_AUTOTUNE_CACHE"
    check(var not in os.environ, f"{var} is set: the main paths must run today's plans")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "plans.json")
    os.environ[var] = path
    autotune.clear_cache()
    winners, shapes = {}, []
    try:
        for kind, arch, name, k, n, act in AUTOTUNE_MATMULS:
            w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            if name != "lm_head":
                x = apply_dap(x, DAPSpec(4, 8))
            if kind in autotune.INT8_KINDS:
                wv, wm, ws = ref.pack_weight_int8(w.to(bf16), cfg)
                if kind == "aw_int8":
                    xv, xm, xs = ops.dap_pack_int8(x, 4, 8, act_scale="per_row")
                    x_dense = ref.decode_a(xv, xm, cfg)
                    kern = lambda r, a, o, plan, acc=None: (  # noqa: E731
                        dbb_matmul.dbb_matmul_aw_int8_cuda(
                            xv[:r], xm[:r], xs[:r], wv, wm, ws, cfg, cfg, act=a, out_dtype=o,
                            acc_out=acc, plan=plan))
                    plain = lambda r, a, o: ref.dbb_matmul_aw_int8_ref(  # noqa: E731
                        xv[:r], xm[:r], xs[:r], wv, wm, ws, cfg, cfg, act=a, out_dtype=o)
                else:
                    xq, xs = ref.quantize_act_int8(x, per_row=True)
                    x_dense = xq
                    kern = lambda r, a, o, plan, acc=None: (  # noqa: E731
                        dbb_matmul.dbb_matmul_int8_cuda(xq[:r], xs[:r], wv, wm, ws, cfg, act=a,
                                                        out_dtype=o, acc_out=acc, plan=plan))
                    plain = lambda r, a, o: ref.dbb_matmul_int8_ref(  # noqa: E731
                        xq[:r], xs[:r], wv, wm, ws, cfg, act=a, out_dtype=o)
                want_acc = ref.int8_acc(x_dense, ref.decode_w(wv, wm, cfg))
                want = plain(m, None, torch.float32)
            else:
                wv, wm = ops.pack_weight(w.to(bf16), cfg)
                if kind == "aw":
                    xv, xm = ops.dap_pack(x, 4, 8)
                    kern = lambda r, a, o, plan: dbb_matmul.dbb_matmul_aw_cuda(  # noqa: E731
                        xv[:r], xm[:r], wv, wm, cfg, cfg, act=a, out_dtype=o, plan=plan)
                    plain = lambda r, a, o: ref.dbb_matmul_aw_ref(  # noqa: E731
                        xv[:r], xm[:r], wv, wm, cfg, cfg, act=a, out_dtype=o)
                else:
                    kern = lambda r, a, o, plan: dbb_matmul.dbb_matmul_cuda(  # noqa: E731
                        x[:r], wv, wm, cfg, act=a, out_dtype=o, plan=plan)
                    plain = lambda r, a, o: ref.dbb_matmul_ref(  # noqa: E731
                        x[:r], wv, wm, cfg, act=a, out_dtype=o)
                want = plain(m, act, torch.float32)
                want_b = plain(m, act, bf16).float()
            del w
            errs = {}
            for plan in dbb_matmul.candidate_plans(kind, m, k, n):
                where = f"autotune {kind} {arch} {name} plan {plan}"
                if kind in autotune.INT8_KINDS:
                    acc = torch.empty((m, n), dtype=torch.int32, device="cuda")
                    y = kern(m, None, torch.float32, plan, acc)
                    check(torch.equal(acc, want_acc) and torch.equal(y, want),
                          f"{where}: not bit-exact")
                    errs[plan] = (y - want).abs().max().item()
                else:
                    y = kern(m, act, torch.float32, plan)
                    err32 = (y - want).abs().max().item()
                    check(err32 <= 1e-5 * want.abs().max().item(),
                          f"{where}: f32 off by {err32:.3g}")
                    yb = kern(m, act, bf16, plan).float()
                    errb = (yb - want_b).abs()
                    check(bool((errb <= 2.0 ** -7 * torch.maximum(yb.abs(), want_b.abs())
                                + 1e-5 * want.abs().max().item()).all()),
                          f"{where}: bf16 off by {errb.max().item():.3g}")
                    check(torch.equal(kern(4, act, torch.float32, plan), y[:4]),
                          f"{where}: an M=4 call's rows differ from the M=64 call's")
                    errs[plan] = max(err32, errb.max().item())
            timings = {}
            win = autotune.autotune(
                lambda plan: (lambda: kern(m, act, bf16, plan)), m, k, n, 4, 8, kind,
                rules=dbb_matmul.PLAN_RULES, timer=lambda fn: run_ms(fn, iters=AUTOTUNE_ITERS),
                timings=timings)
            check(all(isinstance(t, float) for t in timings.values()),
                  f"autotune {kind} {arch} {name}: a candidate failed: {timings}")
            heur = dbb_matmul.heuristic_plan(kind, m, k, n)
            winners[(kind, m, k, n)] = win
            shapes.append((kind, m, k, n))
            cands = "; ".join(f"{p} {timings[p]:.4f} ms err {errs[p]:.3g}" for p in timings)
            say(f"autotune {kind} {arch} {name} M={m} K={k} N={n}: heuristic {heur} "
                f"{timings[heur]:.4f} ms, winner {win} {timings[win]:.4f} ms "
                f"({timings[heur] / timings[win]:.3f}x); candidates: {cands}")
            del wv, wm, x
            torch.cuda.empty_cache()

        # gather against fused: granite's decode step, minicpm3's latent
        b, ps, p_cnt, lengths = 4, 16, 64, (1000, 517, 64, 250)
        attn = {}
        for label in ("granite-3-8b GQA", "minicpm3-4b latent"):
            pos_tbl, tables = paged_tables(torch, gen, b, ps, p_cnt, lengths)
            q_pos = torch.tensor([[t - 1] for t in lengths], dtype=torch.int32, device="cuda")
            n_pages = b * p_cnt + 1
            if label.endswith("GQA"):
                h, kvh, d = 32, 8, 128
                k_q, k_s = quant.quantize_rows(torch.randn((n_pages, ps, kvh * d), generator=gen,
                                                           device="cuda"))
                v_q, v_s = quant.quantize_rows(torch.randn((n_pages, ps, kvh * d), generator=gen,
                                                           device="cuda"))
                layer = dict(k=k_q, v=v_q, k_scale=k_s, v_scale=v_s, pos=pos_tbl)
                q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(bf16)
                sg, dk = h // kvh, d
                fn = lambda impl: attention.paged_attend(  # noqa: E731
                    impl, q, layer, tables, q_pos, kv_heads=kvh, window=None, dtype=bf16)
            else:
                mcfg = configs.get_config("minicpm3_4b")
                mla, h = mcfg.mla, mcfg.n_heads
                dk = mla.kv_lora_rank + mla.qk_rope_head_dim
                lat = torch.randn((n_pages, ps, dk), generator=gen, device="cuda").to(bf16)
                layer = dict(k=lat, v=torch.zeros((n_pages, ps, 1), dtype=bf16, device="cuda"),
                             pos=pos_tbl)
                q_nope = torch.randn((b, 1, h, mla.qk_nope_head_dim), generator=gen,
                                     device="cuda").to(bf16)
                q_rope = torch.randn((b, 1, h, mla.qk_rope_head_dim), generator=gen,
                                     device="cuda").to(bf16)
                w_up = (torch.randn((mla.kv_lora_rank, h, mla.qk_nope_head_dim + mla.v_head_dim),
                                    generator=gen, device="cuda") / 16).to(bf16)
                scale = 1.0 / math.sqrt(mla.qk_nope_head_dim + mla.qk_rope_head_dim)
                sg = h
                fn = lambda impl: attention.paged_attend_latent(  # noqa: E731
                    impl, q_nope, q_rope, layer, tables, q_pos, w_up, mla, scale, bf16)
            outs = {impl: fn(impl).float() for impl in autotune.PAGED_ATTN_IMPLS}
            diff = (outs["gather"] - outs["fused"]).abs().max().item()
            scale_out = outs["gather"].abs().max().item()
            check(diff <= 1.6e-2 * max(1.0, scale_out),
                  f"autotune paged_attn {label}: gather and fused {diff:.3g} apart")
            timings = {}
            win = autotune.autotune_paged_attn(
                lambda impl: (lambda: fn(impl)), b, sg, ps, dk,
                timer=lambda f: run_ms(f, iters=AUTOTUNE_ITERS), timings=timings)
            check(all(isinstance(t, float) for t in timings.values()),
                  f"autotune paged_attn {label}: an implementation failed: {timings}")
            attn[(b, sg, ps, dk)] = win
            say(f"autotune paged_attn {label} B={b} S=1 H={h} Dk={dk} PS={ps}: gather "
                f"{timings['gather']:.4f} ms, fused {timings['fused']:.4f} ms, winner {win} "
                f"(heuristic on the card: fused); outputs {diff:.3g} apart (largest "
                f"{scale_out:.3g})")
            del layer, pos_tbl, tables
            torch.cuda.empty_cache()

        # the file holds the winners; a fresh process resolves them
        with open(path) as f:
            saved = {tuple(json.loads(key)): tuple(v) for key, v in json.load(f).items()}
        for (kind, mm, k, n), win in winners.items():
            key = (kind, 0 if kind in autotune.NATIVE_KINDS else mm, k, n, 4, 8)
            check(saved.get(key) == win, f"autotune: {key} -> {saved.get(key)}, not {win}")
        for (b_, sg, ps_, dk), win in attn.items():
            check(saved.get(("paged_attn", b_, sg, ps_, dk, 0)) == (win,),
                  f"autotune: paged_attn {(b_, sg, ps_, dk)} not saved as {win}")
        code = ("import json, sys; "
                "from repro_torch.kernels import autotune as a, dbb_matmul as d; "
                "q = json.loads(sys.argv[1]); "
                "print(json.dumps([list(a.get_plan(*s, 4, 8, d.PLAN_RULES)) "
                "for s in q['plans']] + "
                "[a.get_paged_attn_impl(*s, 'cuda') for s in q['attn']]))")
        query = dict(plans=shapes, attn=[list(s) for s in attn])
        fresh = subprocess.run(
            [sys.executable, "-c", code, json.dumps(query)], capture_output=True, text=True,
            check=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        ).stdout.strip().splitlines()[-1]
        want = [list(winners[s]) for s in shapes] + list(attn.values())
        check(json.loads(fresh) == want, f"autotune: a fresh process resolved {fresh}, not {want}")
    finally:
        os.environ.pop(var, None)
        autotune.clear_cache()
        tmp.cleanup()
    for kind, mm, k, n in shapes:
        check(autotune.get_plan(kind, mm, k, n, 4, 8, dbb_matmul.PLAN_RULES)
              == dbb_matmul.heuristic_plan(kind, mm, k, n),
              f"autotune: {kind} {(mm, k, n)} not back on the heuristic")
    for key in attn:
        check(autotune.get_paged_attn_impl(*key, "cuda") == "fused",
              f"autotune: paged_attn {key} not back on fused")
    check(autotune.cuda_gather_calls() == 0, "autotune: a gather verdict is left on the card")
    # the host cost a launch pays for its plan: the memoized lookup against
    # the rule the launch called before
    host_us = {}
    rules = dbb_matmul.PLAN_RULES
    for label, fn in (("get_plan",
                       lambda: autotune.get_plan("aw_int8", 64, 4096, 4096, 4, 8, rules)),
                      ("int8_plan", lambda: dbb_matmul.int8_plan(64, 4096, 4096))):
        t0 = time.perf_counter()
        for _ in range(100_000):
            fn()
        host_us[label] = (time.perf_counter() - t0) * 10
    tuned = sum(winners[s] != dbb_matmul.heuristic_plan(*s) for s in shapes)
    say(f"autotune: {len(shapes)} matmul shapes swept, {tuned} won by another plan than the "
        f"heuristic's; winners saved and resolved by a fresh process, then cleared (every "
        f"later phase runs today's plans); a launch's plan on the host: get_plan "
        f"{host_us['get_plan']:.3f} us, int8_plan {host_us['int8_plan']:.3f} us; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def expected_launches(cfg, wire):
    """Kernel launches of one forward pass of ``cfg`` on ``wire``.  Every
    dense-input linear but the head DAP-prunes its input (#5's dense form;
    on the int8 wire its int8 dense form, which quantizes in the same
    launch), the MoE FFN its input before the router (dense form), and
    every packed input is DAP-packed once for the linears that share it
    (#5's packed form of the wire): the attention input and, but under
    MoE, the MLP's input and hidden state.  A swiglu MLP packs gate, up
    and down, a gelu one up and down."""
    n_l = cfg.n_layers
    moe_dap = 0
    mlp = 3 if cfg.mlp_act == "swiglu" else 2  # packed linears of a dense MLP
    if cfg.mla is not None:  # q_down, kv_down and the MLP packed; q_up, wo dense
        packed, dense, attn, packs = (2 + mlp) * n_l, 2 * n_l, ("paged_attn_latent", n_l), 3 * n_l
    elif cfg.moe is not None:  # wq, wk, wv packed; wo dense; dense experts
        packed, dense, attn, packs = 3 * n_l, n_l, ("paged_attn", n_l), n_l
        moe_dap = n_l
    else:  # wq, wk, wv and the MLP packed; wo dense
        packed, dense, attn, packs = (3 + mlp) * n_l, n_l, ("paged_attn", n_l), 3 * n_l
    int8 = wire == "int8"
    names = (("dbb_matmul_aw_int8", "dbb_matmul_int8") if int8
             else ("dbb_matmul_aw", "dbb_matmul"))
    return {names[0]: packed, names[1]: dense + 1, attn[0]: attn[1],
            "dap_prune": moe_dap + (0 if int8 else dense),
            "dap_prune_int8": dense if int8 else 0,
            "dap_pack_int8" if int8 else "dap_pack": packs}


def phase_main_path(torch, np, card, arch, wire, kv_dtype, n_layers=None):
    """One main path: a full-width engine (``n_layers`` of the config's
    layers, or all) serves 8 requests; the launch counters are set to 0
    just before and read just after."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import dbb_matmul, ops, paged_attn
    from repro_torch.models import lm
    from repro_torch.serve import paged_cache
    from repro_torch.serve.engine import Engine, ServeConfig

    serve = dict(SERVE_SHAPE, wire_dtype=wire, kv_dtype=kv_dtype)
    cfg = configs.get_config(arch)
    depth = f"{cfg.n_layers} layers"
    if n_layers is not None and n_layers != cfg.n_layers:
        depth = f"{n_layers} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, "cuda", wire_dtype=wire)
    torch.cuda.synchronize()

    nbytes = paged_cache.cache_nbytes  # bytes of any nest of tensors
    say(f"main path {arch}: init_params {time.perf_counter() - t0:.1f} s, "
        f"{depth}, {wire} DBB wire, {kv_dtype} KV, layer and head weights "
        f"{nbytes(params['layers']) + nbytes(params['lm_head'])} B, embedding "
        f"{nbytes(params['embed'])} B (bf16), peak memory after init "
        f"{torch.cuda.max_memory_allocated()} B ({card})")
    eng = Engine(params, cfg, ServeConfig(**serve), device="cuda")

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, size=int(s)).astype(np.int32) for s in lens]
    arrivals = [2 * i for i in range(N_REQUESTS)]

    steps = {"n": 0}
    inner = lm.paged_step

    def counting_step(*a, **kw):
        steps["n"] += 1
        return inner(*a, **kw)

    lm.paged_step = counting_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    paged_attn.PAGED_ATTN_TC.launches = 0
    paged_attn.PAGED_ATTN_LATENT_TC.launches = 0
    dbb_matmul.NATIVE_TC.launches = dbb_matmul.AW_NATIVE_TC.launches = 0
    dbb_matmul.INT8_TC.launches = dbb_matmul.AW_INT8_TC.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate_requests(prompts, N_NEW, arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.launches, c.plain) for k, c in ops.counters().items()}
    tc_launches = paged_attn.PAGED_ATTN_TC.launches
    latent_tc_launches = paged_attn.PAGED_ATTN_LATENT_TC.launches
    mm_tc = {"dbb_matmul": dbb_matmul.NATIVE_TC.launches,
             "dbb_matmul_aw": dbb_matmul.AW_NATIVE_TC.launches,
             "dbb_matmul_int8": dbb_matmul.INT8_TC.launches,
             "dbb_matmul_aw_int8": dbb_matmul.AW_INT8_TC.launches}
    lm.paged_step = inner
    passes = steps["n"]
    results = eng.last_results
    say(f"main path {arch}: {N_REQUESTS} requests, prompt lengths {lens.tolist()}, "
        f"arrivals {arrivals}, {N_NEW} new tokens each; {eng.step_calls} scheduler "
        f"dispatches ({eng.decode_run_calls} decode runs), {passes} forward passes, "
        f"wall {wall:.2f} s ({card})")
    for r in results:
        check(r.finish_reason == "length" and r.n_generated == N_NEW,
              f"{arch} request {r.rid}: {r.finish_reason} after {r.n_generated} tokens")
    check(all(len(o) == len(p) + N_NEW for o, p in zip(outs, prompts)), f"{arch}: output lengths")
    expect = expected_launches(cfg, wire)
    for name, (launches, plain) in counts.items():
        check(plain == 0, f"{arch} {name}: plain version ran {plain} times on the main path")
        per_pass = expect.get(name, 0)
        check(launches == per_pass * passes,
              f"{arch} {name}: {launches} launches, expected {per_pass} x {passes} passes")
    # every bf16 GQA call went through the tensor-core kernel
    check(tc_launches == counts["paged_attn"][0],
          f"{arch}: {tc_launches} of {counts['paged_attn'][0]} GQA attention launches "
          f"on the tensor-core kernel")
    # every bf16 latent call went through the latent tensor-core kernel
    check(latent_tc_launches == counts["paged_attn_latent"][0],
          f"{arch}: {latent_tc_launches} of {counts['paged_attn_latent'][0]} latent attention "
          f"launches on the latent tensor-core kernel")
    # every bf16 native-wire matmul (#1, #4) went through its tc body, every
    # int8-wire one (#2, #3) through the int8 tc body
    for name, n_tc in mm_tc.items():
        check(n_tc == counts[name][0],
              f"{arch}: {n_tc} of {counts[name][0]} {name} launches on the tc body")
    say(f"main path {arch}: launches {json.dumps({k: v[0] for k, v in counts.items()})} "
        f"(paged_attn on the tensor-core kernel: {tc_launches}, paged_attn_latent on the "
        f"latent tensor-core kernel: {latent_tc_launches}, dbb_matmul and dbb_matmul_aw on "
        f"the tc body: {mm_tc['dbb_matmul']}, {mm_tc['dbb_matmul_aw']}, dbb_matmul_int8 and "
        f"dbb_matmul_aw_int8 on the int8 tc body: {mm_tc['dbb_matmul_int8']}, "
        f"{mm_tc['dbb_matmul_aw_int8']}), "
        f"plain-version calls {json.dumps({k: v[1] for k, v in counts.items()})}")
    ttft = sorted(r.time_to_first_token for r in results)
    tok_s = N_REQUESTS * N_NEW / wall
    say(f"main path {arch}: TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
        f"{ttft[-1] * 1e3:.1f} ms (from enqueue; arrivals staggered), decode+prefill "
        f"throughput {tok_s:.2f} generated tokens/s, peak memory serving "
        f"{torch.cuda.max_memory_allocated()} B ({card})")

    k = int(np.argmax(lens))
    if cfg.moe is None:
        # the same request served alone (its prompt pages now hit the prefix
        # cache): every kernel sums a row in an order that does not depend
        # on the batch, so it is byte-identical
        again = eng.generate_requests([prompts[k]], N_NEW)[0]
        check(np.array_equal(again, outs[k]), f"{arch}: request {k} re-served alone diverged")
        alone = f"re-served request {k} alone byte-identical"
    else:
        # expert capacity couples a step's tokens, so a request served alone
        # may differ; a fresh engine serving the same requests and arrivals
        # must not
        again = Engine(params, cfg, ServeConfig(**serve), device="cuda").generate_requests(
            prompts, N_NEW, arrivals=arrivals)
        check(all(np.array_equal(a, b) for a, b in zip(again, outs)),
              f"{arch}: a fresh engine served different tokens")
        alone = "a fresh engine re-served all requests byte-identically"
    # finite logits: the longest prompt's prefill logits, one solo step on
    # a fresh cache; for a dense arch its greedy token equals the served one
    s = len(prompts[k])
    n_pages = -(-s // serve["page_size"]) + 1
    cache = paged_cache.make_paged_cache(eng.cfg, n_pages, serve["page_size"], "cuda")
    logits, _ = lm.paged_step(
        eng.params, cache, torch.tensor(prompts[k][None], device="cuda"),
        torch.arange(s, dtype=torch.int32, device="cuda")[None],
        torch.arange(1, n_pages, dtype=torch.int32, device="cuda")[None], eng.cfg,
    )
    row = logits[0, -1, : cfg.vocab]
    check(bool(torch.isfinite(logits[0, :, : cfg.vocab]).all()), f"{arch}: non-finite logits")
    check(cfg.moe is not None or int(row.argmax()) == int(outs[k][s]),
          f"{arch}: solo prefill token differs from served token")
    say(f"main path {arch}: {alone}; request {k}'s prefill logits finite, shape "
        f"{tuple(logits.shape)}")
    del eng, params, cache, logits
    torch.cuda.empty_cache()
    return counts, outs


def phase_smoke_latent_engine(torch, np):
    """minicpm3-4b's smoke config in bf16 (a latent of 40 = kv_lora 32 +
    rope 8: the shape the latent tensor-core kernel took only once it
    zero-pads the latent to 48) served on the card at pages of 16 and 72
    slots, native wire and KV: every latent call on the latent tensor-core
    kernel, every #1/#4 call on the tc body, every request finished, and
    the longest request re-served alone byte-identical."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import dbb_matmul, ops, paged_attn
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(configs.get_config("minicpm3_4b", smoke=True), dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                            wire_dtype="native")
    rng = np.random.default_rng(SEED + 5)
    lens = rng.integers(10, 121, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32) for n in lens]
    arrivals = [2 * i for i in range(N_REQUESTS)]
    for page_size in (16, 72):
        serve = dict(SERVE_SHAPE, max_seq=256, page_size=page_size, wire_dtype="native",
                     kv_dtype="native")
        eng = Engine(params, cfg, ServeConfig(**serve), device="cuda")
        ops.reset_counters()
        paged_attn.PAGED_ATTN_LATENT_TC.launches = 0
        dbb_matmul.NATIVE_TC.launches = dbb_matmul.AW_NATIVE_TC.launches = 0
        outs = eng.generate_requests(prompts, N_NEW, arrivals=arrivals)
        torch.cuda.synchronize()
        counts = ops.counters()
        check(all(r.finish_reason == "length" and r.n_generated == N_NEW
                  for r in eng.last_results), f"smoke minicpm3 PS={page_size}: a request failed")
        check(all(c.plain == 0 for c in counts.values()),
              f"smoke minicpm3 PS={page_size}: a plain version ran")
        n_lat = counts["paged_attn_latent"].launches
        check(n_lat > 0 and paged_attn.PAGED_ATTN_LATENT_TC.launches == n_lat,
              f"smoke minicpm3 PS={page_size}: {paged_attn.PAGED_ATTN_LATENT_TC.launches} of "
              f"{n_lat} latent launches on the latent tensor-core kernel")
        check(dbb_matmul.NATIVE_TC.launches == counts["dbb_matmul"].launches > 0
              and dbb_matmul.AW_NATIVE_TC.launches == counts["dbb_matmul_aw"].launches > 0,
              f"smoke minicpm3 PS={page_size}: a native matmul launch not on the tc body")
        k = int(np.argmax(lens))
        again = eng.generate_requests([prompts[k]], N_NEW)[0]
        check(np.array_equal(again, outs[k]),
              f"smoke minicpm3 PS={page_size}: request {k} re-served alone diverged")
        say(f"smoke minicpm3-4b bf16 (latent Dk 40 Dv 32) PS={page_size}: {N_REQUESTS} "
            f"requests served, {n_lat} latent launches on the latent tensor-core kernel, "
            f"{counts['dbb_matmul'].launches} + {counts['dbb_matmul_aw'].launches} #1/#4 "
            f"launches on the tc body; request {k} re-served alone byte-identical")
        del eng
    del params
    torch.cuda.empty_cache()


def drive(torch, fn):
    """Run ``fn`` once with every launch counter set to 0 just before and
    read just after, counting its forward passes (``lm.paged_step``,
    ``lm.prefill``, ``lm.decode_step`` calls).  Returns ``(fn's result,
    launches by kernel, passes, wall s, peak memory B)``; fails if a plain
    version ran."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    passes = {"n": 0}
    saved = {name: getattr(lm, name) for name in ("paged_step", "prefill", "decode_step")}

    def counting(f):
        def g(*a, **kw):
            passes["n"] += 1
            return f(*a, **kw)
        return g

    for name, f in saved.items():
        setattr(lm, name, counting(f))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(lm, name, f)
    wall = time.perf_counter() - t0
    counters = ops.counters()
    check(all(c.plain == 0 for c in counters.values()),
          f"a plain version ran on the card: {[k for k, c in counters.items() if c.plain]}")
    return (out, {k: c.launches for k, c in counters.items()}, passes["n"], wall,
            torch.cuda.max_memory_allocated())


def check_launches(label, counts, per_pass, passes):
    """Every kernel launched ``per_pass[name]`` times a forward pass."""
    for name, n in counts.items():
        want = per_pass.get(name, 0) * passes
        check(n == want, f"{label} {name}: {n} launches, expected "
                         f"{per_pass.get(name, 0)} x {passes} passes")


def ring_launches(cfg, wire):
    """Launches of a forward pass over the ring cache: the packed path's,
    with attention outside the kernels (``mha``/``_mla_absorbed``)."""
    return dict(expected_launches(cfg, wire), paged_attn=0, paged_attn_latent=0)


def unpacked_launches(cfg):
    """Launches of a forward pass over dense weights under awdbb: DAP's
    dense form before every attention and MLP linear (each prunes its own
    input), the head aside, and the paged attention."""
    mlp = 3 if cfg.mlp_act == "swiglu" else 2
    attn = "paged_attn_latent" if cfg.mla is not None else "paged_attn"
    return {"dap_prune": (4 + mlp) * cfg.n_layers, attn: cfg.n_layers}


def phase_sampler(torch, card):
    """The seeded sampler on the card: threefry keys, bits and uniform
    draws equal the CPU's bit for bit at qwen2-vl-72b's and
    granite-3-8b's vocabularies; ``sample_tokens`` at B = 4 gives the
    CPU's tokens on pinned logits; and its time a call at vocab 152064,
    greedy (the argmax the engine calls when no row samples) and
    sampled."""
    from repro_torch.core import prng
    from repro_torch.core.sampling import greedy_tokens, sample_tokens

    t0 = time.perf_counter()
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1]).repeat_interleave(4)
    positions = torch.tensor([0, 1, 1023, 40000]).repeat(4)
    for vocab in (152064, 49155):
        bits = {}
        for dev in ("cpu", "cuda"):
            key = prng.fold_in(prng.prng_key(seeds.to(dev)), positions.to(dev))
            bits[dev] = (prng.random_bits(key, vocab).cpu(), prng.uniform(key, vocab).cpu())
        check(torch.equal(bits["cuda"][0], bits["cpu"][0]),
              f"threefry bits at vocab {vocab} differ between the card and the CPU")
        check(torch.equal(bits["cuda"][1], bits["cpu"][1]),
              f"uniform draws at vocab {vocab} differ between the card and the CPU")
    gen = torch.Generator().manual_seed(SEED)
    rows = (torch.tensor([0.8, 0.0, 1.1, 0.7]), torch.tensor([50, 0, 0, 8]),
            torch.tensor([0.95, 1.0, 0.9, 1.0]), torch.tensor([11, 3, 2**32 - 1, 2**31 + 7]),
            torch.tensor([63, 511, 1023, 40000]))
    dev_rows = tuple(r.cuda() for r in rows)
    for trial in range(4):
        logits = torch.randn((4, 152064), generator=gen) * 4
        want = sample_tokens(logits, *rows)
        got = sample_tokens(logits.cuda(), *dev_rows).cpu()
        check(torch.equal(got, want), f"sampled tokens differ from the CPU's: {got} vs {want}")
    logits = logits.cuda()

    def ms(fn, iters=50):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    t_greedy = ms(lambda: greedy_tokens(logits))
    t_sampled = ms(lambda: sample_tokens(logits, *dev_rows))
    say(f"sampler: threefry keys, bits and uniform draws equal the CPU's at vocab 152064 and "
        f"49155 (4 seeds x 4 positions); sampled tokens equal the CPU's at B=4; a call at "
        f"B=4, vocab 152064: greedy {t_greedy:.4f} ms, sampled (temperature, top-k, top-p) "
        f"{t_sampled:.4f} ms ({card}); phase wall {time.perf_counter() - t0:.1f} s")


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def draw_granite(torch):
    """granite-3-8b's full-width weights, drawn once for the serving-mode,
    spec and durability phases: dense bf16, and packed on the int8 wire
    (bit for bit the main path's, which packs as it draws)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import pack_params_for_serving

    cfg = configs.get_config("granite_3_8b")
    t0 = time.perf_counter()
    dense = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                           wire_dtype=None)
    packed = pack_params_for_serving(dense, cfg, "int8")
    torch.cuda.synchronize()
    say(f"granite_3_8b: dense bf16 weights drawn and packed on the int8 wire once in "
        f"{time.perf_counter() - t0:.1f} s (the main path's draw)")
    return dense, packed


def main_requests(np, vocab):
    """The main path's 8 prompts (64-512 tokens) and arrivals."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=N_REQUESTS)
    prompts = [rng.integers(0, vocab, size=int(s)).astype(np.int32) for s in lens]
    return prompts, [2 * i for i in range(N_REQUESTS)]


def sampled_params():
    from repro_torch.core.sampling import SamplingParams

    return [SamplingParams(seed=1000 + i, **SAMPLED) for i in range(N_REQUESTS)]


def add_launches(launches, counts):
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n


def phase_serving_modes(torch, np, card, greedy_outs, launches, dense, packed):
    """granite-3-8b at full width (40 layers, int8 wire and KV), weights
    drawn once (``draw_granite``: dense bf16, packed once): one-shot
    ``generate`` batched and stepped, then continuous and gather, on 4
    prompts of 64 tokens; a sampled continuous serve of the main path's 8
    requests with per-request seeds, the same at ``decode_block=1``, a
    ``paged_attn="gather"`` serve and a ``pack_weights=False`` serve
    (bf16 weights, DAP's dense form).  Each serve is re-served by a fresh
    engine byte-identically, the sampled serve equals itself at
    ``decode_block`` 1 and 16 and differs from greedy (the main path's
    tokens on the same weights) at least once, every request finishes
    (a non-finite logit would quarantine it), and the prefill logits of
    ``generate`` are finite.  Launches are counted per sub-phase and added
    to ``launches``.  Returns the sampled serve's tokens."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    t_phase = time.perf_counter()
    arch, wire = "granite_3_8b", "int8"
    cfg = configs.get_config(arch)

    def add(counts):
        add_launches(launches, counts)

    def report(label, n_tok, wall, peak, extra=""):
        say(f"serving modes {arch} {label}: wall {wall:.2f} s, {n_tok / wall:.2f} generated "
            f"tokens/s, peak memory {peak} B{extra} ({card})")

    # -- one-shot and stepped generate, then continuous and gather, 4 x 64
    rng = np.random.default_rng(SEED + 1)
    prompts4 = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    n4 = 16
    gen_outs = {}
    for mode, attn in (("batched", "auto"), ("stepped", "auto"), ("continuous", "auto"),
                       ("continuous", "gather")):
        scfg = ServeConfig(**dict(SERVE_SHAPE, max_seq=64 + n4, prefill_mode=mode,
                                  paged_attn=attn, wire_dtype=wire, kv_dtype=wire))
        eng = Engine(packed, cfg, scfg, device="cuda")
        out, counts, passes, wall, peak = drive(torch, lambda: eng.generate(prompts4, n4))
        label = mode if attn == "auto" else "gather"
        if mode != "continuous":
            check_launches(f"{arch} {label}", counts, ring_launches(cfg, wire), passes)
            check(passes == (1 if mode == "batched" else 64) + n4, f"{label}: {passes} passes")
        else:
            per_pass = expected_launches(cfg, wire)
            if attn == "gather":
                per_pass = dict(per_pass, paged_attn=0)
            check_launches(f"{arch} {label}", counts, per_pass, passes)
        add(counts)
        check(out.shape == (4, 64 + n4), f"{label}: output shape {out.shape}")
        gen_outs[label] = out[:, 64:]
        report(f"generate {label} (4 x 64 prompt tokens, {n4} new)", 4 * n4, wall, peak,
               f", {passes} forward passes")
    cache = lm.make_cache(eng.cfg, 1, 64, "cuda")
    logits, _ = lm.prefill(eng.params, torch.tensor(prompts4[:1], device="cuda"), eng.cfg,
                           cache=cache)
    check(bool(torch.isfinite(logits[..., : cfg.vocab]).all()), "batched prefill: non-finite logits")
    stack = np.stack(list(gen_outs.values()))
    agree = float((stack == stack[0]).all(axis=0).mean())
    pairs = ", ".join(f"{a}/{b} {float(np.mean(gen_outs[a] == gen_outs[b])):.4f}" for a, b in (
        ("batched", "stepped"), ("batched", "continuous"), ("continuous", "gather")))
    say(f"serving modes {arch}: batched, stepped, continuous and gather agree on "
        f"{agree:.4f} of {stack[0].size} greedy tokens (pairs: {pairs}; under DAP the card's "
        f"engines are held to themselves, so this is printed, not asserted)")

    # -- the main path's 8 requests, sampled with per-request seeds
    prompts, arrivals = main_requests(np, cfg.vocab)
    samp = sampled_params()

    def serve(params, **over):
        scfg = ServeConfig(**{**SERVE_SHAPE, "wire_dtype": wire, "kv_dtype": wire, **over})
        eng = Engine(params, cfg, scfg, device="cuda")
        outs = eng.generate_requests(prompts, N_NEW, arrivals=arrivals, sampling=samp)
        check(all(r.finish_reason == "length" and r.n_generated == N_NEW
                  for r in eng.last_results), f"{over}: a request did not finish")
        return outs, eng.last_results

    serves = {}
    for label, params, over, per_pass in (
        ("sampled", packed, {}, expected_launches(cfg, wire)),
        ("sampled decode_block=1", packed, dict(decode_block=1), expected_launches(cfg, wire)),
        ("gather", packed, dict(paged_attn="gather"),
         dict(expected_launches(cfg, wire), paged_attn=0)),
        ("unpacked", dense, dict(pack_weights=False, wire_dtype="native"),
         unpacked_launches(cfg)),
    ):
        (outs, results), counts, passes, wall, peak = drive(torch, lambda: serve(params, **over))
        check_launches(f"{arch} {label}", counts, per_pass, passes)
        add(counts)
        serves[label] = outs
        ttft = sorted(r.time_to_first_token for r in results)
        report(f"{label} serve ({N_REQUESTS} requests, {N_NEW} new, {SAMPLED})",
               N_REQUESTS * N_NEW, wall, peak,
               f", TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, "
               f"{passes} forward passes")
        if label != "sampled decode_block=1":
            again, _ = serve(params, **over)
            check(all(np.array_equal(a, b) for a, b in zip(again, outs)),
                  f"{label}: a fresh engine served different tokens")
    check(all(np.array_equal(a, b) for a, b in
              zip(serves["sampled"], serves["sampled decode_block=1"])),
          "sampled serve: decode_block 1 and 16 differ")
    check(any(not np.array_equal(a, b) for a, b in zip(serves["sampled"], greedy_outs)),
          "sampled serve never differed from greedy")
    gen = [np.concatenate([o[len(p):] for o, p in zip(serves[k], prompts)])
           for k in ("sampled", "gather", "unpacked")]
    say(f"serving modes {arch}: each serve re-served by a fresh engine byte-identically; "
        f"sampled == sampled at decode_block=1; sampled differs from greedy on "
        f"{float(np.mean(gen[0] != np.concatenate([o[len(p):] for o, p in zip(greedy_outs, prompts)]))):.4f} "
        f"of tokens; gather agrees with fused on {float(np.mean(gen[1] == gen[0])):.4f}, unpacked "
        f"with packed on {float(np.mean(gen[2] == gen[0])):.4f} (printed, not asserted)")
    del eng, cache, logits
    torch.cuda.empty_cache()

    # -- minicpm3-4b: one batched generate (materialized prefill, absorbed
    # ring decode)
    arch_m = "minicpm3_4b"
    mcfg = configs.get_config(arch_m)
    t0 = time.perf_counter()
    mparams = lm.init_params(mcfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                             wire_dtype="native")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)
    mprompts = rng.integers(0, mcfg.vocab, (4, 32)).astype(np.int32)
    scfg = ServeConfig(max_seq=40, prefill_mode="batched", pack_weights=True,
                       wire_dtype="native", kv_dtype="native")
    eng = Engine(mparams, mcfg, scfg, device="cuda")
    out, counts, passes, wall, peak = drive(torch, lambda: eng.generate(mprompts, 8))
    check_launches(f"{arch_m} batched", counts, ring_launches(mcfg, "native"), passes)
    check(passes == 1 + 8 and out.shape == (4, 40), f"{arch_m} batched: {passes} passes")
    add(counts)
    cache = lm.make_cache(eng.cfg, 1, 32, "cuda")
    logits, _ = lm.prefill(eng.params, torch.tensor(mprompts[:1], device="cuda"), eng.cfg,
                           cache=cache)
    check(bool(torch.isfinite(logits[..., : mcfg.vocab]).all()), f"{arch_m}: non-finite logits")
    say(f"serving modes {arch_m}: init {t_init:.1f} s; batched generate (4 x 32 prompt tokens, "
        f"8 new, native wire and KV, {mcfg.n_layers} layers) wall {wall:.2f} s, "
        f"{32 / wall:.2f} generated tokens/s, peak memory {peak} B, {passes} forward passes; "
        f"prefill logits finite ({card})")
    del eng, mparams, cache, logits
    torch.cuda.empty_cache()
    say(f"serving modes: phase wall {time.perf_counter() - t_phase:.1f} s")
    return serves["sampled"]


SPEC_BLOCK = 4  # the spec serves' decode_block: a round is 3 draft passes and 1 verify


def tc_counters():
    """The tensor-core counters beside each kernel's total."""
    from repro_torch.kernels import dbb_matmul, paged_attn

    return {"paged_attn": paged_attn.PAGED_ATTN_TC,
            "paged_attn_latent": paged_attn.PAGED_ATTN_LATENT_TC,
            "dbb_matmul": dbb_matmul.NATIVE_TC, "dbb_matmul_aw": dbb_matmul.AW_NATIVE_TC,
            "dbb_matmul_int8": dbb_matmul.INT8_TC, "dbb_matmul_aw_int8": dbb_matmul.AW_INT8_TC}


def phase_spec(torch, np, card, greedy, sampled, granite_packed, launches):
    """Self-speculative decoding at full width, the main path's 8 requests
    with ``decode_block=4`` (3 draft passes and a verify pass a round):
    granite-3-8b on the int8 wire and KV with the ``nnz`` draft (#3 at
    NNZa 2 against NNZw 4, #5 at NNZ 2), greedy and sampled, and
    minicpm3-4b on the native wire and KV with the ``int8_wire`` draft
    (#2/#3 draft while #1/#4 verify; both packed copies resident).  Each
    serve's tokens equal the plain engine's on the same weights (the main
    path's greedy serve; the sampled serve of ``phase_serving_modes``);
    launches equal the target's per-pass count times the target's passes
    (mixed steps and verify passes) plus the draft's times the draft
    passes, every matmul and attention launch on its tensor-core body."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, SpecConfig

    t_phase = time.perf_counter()

    def spec_serve(label, params, arch, wire, draft, want, sampling=None):
        cfg = configs.get_config(arch)
        scfg = ServeConfig(**dict(SERVE_SHAPE, wire_dtype=wire, kv_dtype=wire,
                                  decode_block=SPEC_BLOCK, spec=SpecConfig(draft=draft)))
        t0 = time.perf_counter()
        eng = Engine(params, cfg, scfg, device="cuda")
        torch.cuda.synchronize()
        t_init, mem_init = time.perf_counter() - t0, torch.cuda.memory_allocated()
        prompts, arrivals = main_requests(np, cfg.vocab)
        passes = {"draft": 0, "target": 0}

        def serve():
            inner = lm.paged_step

            def counting(*a, **kw):
                passes["draft" if a[5] is eng.draft_cfg else "target"] += 1
                return inner(*a, **kw)

            lm.paged_step = counting
            try:
                return eng.generate_requests(prompts, N_NEW, arrivals=arrivals,
                                             sampling=sampling)
            finally:
                lm.paged_step = inner

        tcs = tc_counters()
        for c in tcs.values():
            c.launches = 0
        outs, counts, n_pass, wall, peak = drive(torch, serve)
        check(n_pass == passes["draft"] + passes["target"], f"spec {label}: pass count")
        per_target = expected_launches(cfg, wire)
        per_draft = expected_launches(cfg, "int8" if draft == "int8_wire" else wire)
        for name, n in counts.items():
            want_n = per_target.get(name, 0) * passes["target"] + \
                per_draft.get(name, 0) * passes["draft"]
            check(n == want_n, f"spec {label} {name}: {n} launches, expected {want_n}")
            if name in tcs:
                check(tcs[name].launches == n,
                      f"spec {label} {name}: {tcs[name].launches} of {n} on the tc body")
        add_launches(launches, counts)
        for r in eng.last_results:
            check(r.finish_reason == "length" and r.n_generated == N_NEW,
                  f"spec {label} request {r.rid}: {r.finish_reason}")
        for i, (a, b) in enumerate(zip(outs, want)):
            check(np.array_equal(a, b), f"spec {label}: request {i} differs from plain serving")
        st = eng.spec_stats()
        ttft = sorted(r.time_to_first_token for r in eng.last_results)
        say(f"spec {label}: tokens equal plain serving's; wall {wall:.2f} s, "
            f"{N_REQUESTS * N_NEW / wall:.2f} generated tokens/s, TTFT p50 "
            f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; {st['spec_runs']} rounds (verify passes), "
            f"{passes['draft']} draft passes, {passes['target'] - st['spec_runs']} mixed steps; "
            f"proposed {st['proposed']}, accepted {st['accepted']} (acceptance "
            f"{st['acceptance_rate']:.4f}), emitted {st['emitted']}; engine init "
            f"{t_init:.1f} s, memory after init {mem_init} B, peak serving {peak} B ({card})")
        return eng

    eng = spec_serve("granite-3-8b int8 nnz-draft greedy", granite_packed, "granite_3_8b",
                     "int8", "nnz", greedy["granite_3_8b"])
    del eng
    eng = spec_serve("granite-3-8b int8 nnz-draft sampled", granite_packed, "granite_3_8b",
                     "int8", "nnz", sampled, sampling=sampled_params())
    del eng
    torch.cuda.empty_cache()
    mcfg = configs.get_config("minicpm3_4b")
    t0 = time.perf_counter()
    dense = lm.init_params(mcfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                           wire_dtype=None)
    torch.cuda.synchronize()
    say(f"spec minicpm3-4b: dense bf16 weights drawn in {time.perf_counter() - t0:.1f} s "
        f"(the main path's draw), {torch.cuda.memory_allocated()} B")
    eng = spec_serve("minicpm3-4b native int8_wire-draft greedy", dense, "minicpm3_4b",
                     "native", "int8_wire", greedy["minicpm3_4b"])
    del eng, dense
    torch.cuda.empty_cache()
    say(f"spec: phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_durability(torch, np, card, want, dense, launches):
    """granite-3-8b at full width on the int8 wire and KV, the main path's
    8 requests: a chaos serve (allocator faults p 0.05, request 3's logits
    poisoned, free-page scribbles p 0.1) whose healthy requests equal the
    fault-free serve (the main path's) and whose poisoned one is
    quarantined; a serve with ``snapshot_every=4`` into a temporary
    directory, killed between a dispatch and its commit, then
    ``Engine.restore`` from the dense weights (packed anew) and
    ``resume()``, equal to the uninterrupted serve with a gapless stream;
    ``health()``'s step p50/p99, and a snapshot's size and time on disk."""
    import os
    import tempfile

    from repro_torch import configs
    from repro_torch.serve import faults
    from repro_torch.serve.engine import Engine, ServeConfig

    t_phase = time.perf_counter()
    cfg = configs.get_config("granite_3_8b")
    serve = dict(SERVE_SHAPE, wire_dtype="int8", kv_dtype="int8")
    per_pass = expected_launches(cfg, "int8")
    prompts, arrivals = main_requests(np, cfg.vocab)

    # -- chaos
    eng = Engine(dense, cfg, ServeConfig(**serve), device="cuda")
    eng.set_faults(faults.FaultConfig(seed=SEED, alloc_fail_p=0.05, nan_rids=(3,),
                                      scrub_corrupt_p=0.1))
    res, counts, passes, wall, peak = drive(
        torch, lambda: eng.serve_requests(prompts, N_NEW, arrivals=arrivals))
    check_launches("chaos", counts, per_pass, passes)
    add_launches(launches, counts)
    for i, r in enumerate(res):
        if r.rid == 3:
            check(r.finish_reason == "numerical_error", f"chaos: request 3 {r.finish_reason}")
        else:
            check(r.finish_reason == "length" and np.array_equal(r.tokens, want[i]),
                  f"chaos: healthy request {r.rid} {r.finish_reason} or its tokens differ")
    h = eng.health()
    check(h["quarantines"] == 1 and h["preemptions_fault"] == h["injected_alloc_faults"] > 0,
          f"chaos: health {h}")
    say(f"durability chaos: healthy requests equal the fault-free serve, request 3 "
        f"quarantined; wall {wall:.2f} s, {passes} forward passes, peak {peak} B; health "
        f"{json.dumps(h)} ({card})")
    del eng
    torch.cuda.empty_cache()

    # -- kill between a dispatch and its commit, restore, resume
    with tempfile.TemporaryDirectory() as d:
        scfg = ServeConfig(**serve, snapshot_dir=d, snapshot_every=4)
        eng = Engine(dense, cfg, scfg, device="cuda")
        eng.set_faults(faults.FaultConfig(seed=SEED, kill_at=20, kill_point="pre_commit"))
        streamed = {}

        def stream(rid, toks, start):
            buf = streamed.setdefault(rid, [])
            check(start == len(buf), f"stream of {rid}: a gap")
            buf.extend(int(t) for t in toks)

        def until_kill():
            try:
                eng.generate_requests(prompts, N_NEW, arrivals=arrivals, on_token=stream)
            except faults.SimulatedCrash:
                return True
            return False

        killed, counts, passes, wall, _ = drive(torch, until_kill)
        check(killed, "durability: the kill point was not reached")
        check_launches("until the kill", counts, per_pass, passes)
        add_launches(launches, counts)
        n_snaps = eng._snap_step
        del eng
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = Engine.restore(d, dense, cfg, device="cuda")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        resumed = {}

        def stream2(rid, toks, start):
            buf = resumed.setdefault(rid, [])
            check(start == len(streamed.get(rid, [])) + len(buf), f"resumed stream of {rid}")
            buf.extend(int(t) for t in toks)

        results, counts, passes2, wall2, peak = drive(torch, lambda: eng.resume(
            on_token=stream2, delivered={r: len(t) for r, t in streamed.items()}))
        check_launches("resume", counts, per_pass, passes2)
        add_launches(launches, counts)
        check(len(results) > 0, "durability: nothing was in flight")
        for r in results:
            i = r.rid - 1
            check(r.finish_reason == "length" and np.array_equal(r.tokens, want[i]),
                  f"durability: resumed request {r.rid} differs from the uninterrupted serve")
            gen = [int(t) for t in r.tokens[len(prompts[i]):]]
            check(streamed.get(r.rid, []) + resumed.get(r.rid, []) == gen,
                  f"durability: request {r.rid}'s stream across the kill")
        h = eng.health()
        t0 = time.perf_counter()
        path = eng.snapshot()
        t_snap = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        say(f"durability snapshot: killed at the 20th pre_commit after {passes} passes and "
            f"{n_snaps} snapshots; restore (pack + load) {t_restore:.2f} s; resume of "
            f"{len(results)} in-flight requests {wall2:.2f} s, {passes2} passes, peak {peak} B, "
            f"equal to the uninterrupted serve, streams gapless; step p50 "
            f"{h['step_p50_us']} us p99 {h['step_p99_us']} us, slow steps {h['slow_steps']}; "
            f"a snapshot {size} B in {t_snap:.2f} s ({card})")
        del eng
    torch.cuda.empty_cache()
    say(f"durability: phase wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------- recurrent and enc-dec families

# the recurrent serves: (arch, wire, KV dtype), 8 prompts of 64 tokens, 32
# new, stepped (what "auto" resolves to for ssm and hybrid)
RECURRENT_PATHS = (("mamba2_130m", "native", "native"), ("mamba2_130m", "int8", "native"),
                   ("hymba_1_5b", "int8", "int8"), ("hymba_1_5b", "native", "native"))
# hymba-1.5b's stepped serves are host-bound (6 of the phase's runs, 11-15 s
# each at 32 layers): served at full width and half depth, so that the
# whole script stays inside its time limit with phase_distributed
REC_DEPTH = {"hymba_1_5b": 16}
REC_S0, REC_NEW = 64, 32
DUALITY_S, DUALITY_TOL = 512, 5e-4  # forward vs stepped; tests/test_torch_ssm.py's bound


def recurrent_launches(cfg, wire):
    """Kernel launches of one stepped pass (``lm.decode_step``) of an ssm or
    hybrid model on ``wire``.  An ssm layer runs its mixer's ``in_proj``
    and ``out_proj``, each on a dense input DAP-pruned by #5's dense form
    (its int8 dense form on the int8 wire) then #1 (#2); the head adds one
    undapped #1 (#2).  A hybrid layer is a ring-cache decoder layer (its
    attention plain over the ring) plus the mixer's two such linears."""
    int8 = wire == "int8"
    w_mm = "dbb_matmul_int8" if int8 else "dbb_matmul"
    prune = "dap_prune_int8" if int8 else "dap_prune"
    n_l = cfg.n_layers
    if cfg.family == "ssm":
        return {w_mm: 2 * n_l + 1, prune: 2 * n_l}
    out = ring_launches(cfg, wire)
    out[w_mm] += 2 * n_l
    out[prune] += 2 * n_l
    return out


def encdec_launches(cfg, encode: bool):
    """Kernel launches of whisper's ``encode`` (``encode=True``) or of one
    ``decode_step`` on the native wire.  An encoder layer packs its
    attention input once for wq/wk/wv (#5's packed form, #4 each),
    DAP-prunes wo's input (#5's dense form, #1) and packs its gelu MLP's
    input and hidden state (#4 each); a decoder layer adds the
    cross-attention: wq on its DAP-pruned input (#1), one pack of the
    encoder output for wk/wv (#4 each), wo (#1); the head is one undapped
    #1."""
    if encode:
        n_l = cfg.n_enc_layers
        return {"dbb_matmul_aw": 5 * n_l, "dbb_matmul": n_l, "dap_pack": 3 * n_l,
                "dap_prune": n_l}
    n_l = cfg.n_layers
    return {"dbb_matmul_aw": 7 * n_l, "dbb_matmul": 3 * n_l + 1, "dap_pack": 4 * n_l,
            "dap_prune": 3 * n_l}


def greedy_alone(torch, eng, prompt, n_new):
    """``prompt`` served alone, greedy, through ``lm.decode_step`` over
    ``eng``'s packed params and a fresh cache, as a stepped
    ``Engine.generate`` does: (prompt and ``n_new`` tokens, whether every
    step's logits were finite)."""
    from repro_torch.core.sampling import greedy_tokens
    from repro_torch.models import lm

    cfg, v, dev = eng.cfg, eng.cfg.vocab, eng.device
    cache = lm.make_cache(cfg, 1, eng.scfg.max_seq, dev)
    toks = [torch.tensor(prompt[None], dtype=torch.int32, device=dev)]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for t in range(prompt.shape[0] + n_new - 1):
        cur = toks[0][:, t:t + 1] if t < prompt.shape[0] else toks[-1]
        logits, cache = lm.decode_step(eng.params, cache, cur, t, cfg)
        finite &= torch.isfinite(logits[:, -1, :v]).all()
        if t >= prompt.shape[0] - 1:
            toks.append(greedy_tokens(logits[:, -1, :v])[:, None])
    return torch.cat(toks, dim=1)[0].cpu().numpy(), bool(finite)


def phase_recurrent(torch, np, card, launches):
    """mamba2-130m (24 layers, d 768, 24 SSD heads of 64, state 128) and
    hymba-1.5b (16 of its 32 layers, ``REC_DEPTH``; 25 heads over 5 KV
    heads, a window of 1024, the mixer's ``in_proj`` 1600 -> 6482) at full
    width, seeded random bf16
    weights packed as drawn, each served through ``Engine.generate`` (8
    prompts of 64 tokens, 32 new; ``auto`` resolves to stepped) on
    ``RECURRENT_PATHS``: launches counted per pass against
    ``recurrent_launches`` (every packed linear on #1-#4, every DAP call
    site on #5, one launch a call, no plain version), a fresh engine
    re-serves byte-identically, and whether one request served alone
    (``greedy_alone``, its logits finite) equals its row of the batch is
    printed.  Then mamba2-130m in f32 on
    the native wire: ``lm.forward`` over 512 tokens (two chunks of 256)
    against stepped ``decode_step`` on the same prompt, the SSD duality at
    full width, held to ``DUALITY_TOL`` of the logits' scale without DAP
    (``wdbb``: under DAP a top-4 selection flipped by an ulp moves the
    logits by far more than the duality's error)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    for arch, wire, kv in RECURRENT_PATHS:
        cfg = configs.get_config(arch)
        depth = f"{cfg.n_layers} layers"
        if arch in REC_DEPTH:
            depth = f"{REC_DEPTH[arch]} of {cfg.n_layers} layers"
            cfg = dataclasses.replace(cfg, n_layers=REC_DEPTH[arch])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                                wire_dtype=wire)
        torch.cuda.synchronize()
        t_init, peak_init = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        scfg = ServeConfig(pack_weights=True, max_seq=REC_S0 + REC_NEW, wire_dtype=wire,
                           kv_dtype=kv)
        prompts = rng.integers(0, cfg.vocab, (N_REQUESTS, REC_S0)).astype(np.int32)
        eng = Engine(params, cfg, scfg, device="cuda")
        out, counts, passes, wall, peak = drive(torch, lambda: eng.generate(prompts, REC_NEW))
        label = f"{arch} {wire} wire {kv} KV"
        check(passes == REC_S0 + REC_NEW and eng.prefill_calls == REC_S0,
              f"{label}: {passes} passes, {eng.prefill_calls} prefill calls (not stepped)")
        check_launches(label, counts, recurrent_launches(cfg, wire), passes)
        add_launches(launches, counts)
        gen = out[:, REC_S0:]
        check(out.shape == (N_REQUESTS, REC_S0 + REC_NEW) and (gen >= 0).all()
              and (gen < cfg.vocab).all(), f"{label}: tokens out of range")
        again = Engine(params, cfg, scfg, device="cuda").generate(prompts, REC_NEW)
        check(np.array_equal(again, out), f"{label}: a fresh engine served different tokens")
        alone, finite = greedy_alone(torch, eng, prompts[3], REC_NEW)
        check(finite, f"{label}: non-finite logits serving request 3 alone")
        same = bool(np.array_equal(alone, out[3]))
        say(f"recurrent {label} ({depth}, d {cfg.d_model}): init_params "
            f"{t_init:.2f} s, peak memory after init {peak_init} B; stepped generate "
            f"({N_REQUESTS} x {REC_S0} prompt tokens, {REC_NEW} new) wall {wall:.2f} s, "
            f"{N_REQUESTS * REC_NEW / wall:.2f} generated tokens/s, peak memory serving {peak} "
            f"B, {passes} passes; launches {json.dumps(counts)}; a fresh engine re-served "
            f"byte-identically; request 3 served alone {'equals' if same else 'DIFFERS FROM'} "
            f"its row of the batch ({card})")
        del eng, params
        torch.cuda.empty_cache()

    # -- the SSD duality at full width: chunked forward vs the recurrent step
    base = dataclasses.replace(configs.get_config("mamba2_130m"), dtype="float32")
    prompt = torch.tensor(rng.integers(0, base.vocab, (1, DUALITY_S)).astype(np.int32),
                          device="cuda")
    cfg = dataclasses.replace(base, sparsity=dataclasses.replace(base.sparsity, mode="wdbb"))
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda",
                            wire_dtype="native")

    def duality():
        full = lm.forward(params, prompt, cfg)
        cache = lm.make_cache(cfg, 1, DUALITY_S, "cuda")
        steps = []
        for t in range(DUALITY_S):
            lg, cache = lm.decode_step(params, cache, prompt[:, t:t + 1], t, cfg)
            steps.append(lg)
        return full, torch.cat(steps, dim=1)

    (full, stepped), counts, passes, wall, _ = drive(torch, duality)
    add_launches(launches, counts)
    check(passes == DUALITY_S, f"duality: {passes} stepped passes")
    check(bool(torch.isfinite(full).all() and torch.isfinite(stepped).all()),
          "duality: non-finite logits")
    diff = (full - stepped)[..., : cfg.vocab].abs().max().item()
    scale = full[..., : cfg.vocab].abs().max().item()
    bound = DUALITY_TOL * max(1.0, scale)
    check(diff <= bound, f"duality: max |dlogit| {diff:.3g} > {bound:.3g}")
    say(f"recurrent mamba2-130m f32 native wire wdbb: lm.forward over {DUALITY_S} tokens "
        f"(chunks of {cfg.ssm.chunk}) vs {DUALITY_S} stepped decode_step calls: max |dlogit| "
        f"{diff:.3g}, bound {bound:.3g} ({DUALITY_TOL} x max(1, max |logit| {scale:.3g})); "
        f"wall {wall:.2f} s")
    del params, full, stepped
    torch.cuda.empty_cache()
    t = time.perf_counter() - t_phase
    say(f"recurrent: phase wall {t:.1f} s")
    return t


def phase_encdec(torch, np, card, launches):
    """whisper-base at full width (6 + 6 layers, d 512, 1500 frames, vocab
    51865 padded to 51968): seeded random bf16 weights (``encdec
    .init_params``) packed on the native wire by
    ``pack_params_for_serving``; 4 seeded frame tensors ``[4, 1500, 512]``
    encoded, then a 32-token greedy loop of ``encdec.decode_step`` over the
    ring cache.  Launches counted against ``encdec_launches`` (every packed
    linear on #1/#4, every DAP call site on #5, one launch a call, no plain
    version), finite encoder output and logits, a second run
    byte-identical, and whether one request run alone equals its row of
    the batch printed."""
    from repro_torch import configs
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import pack_params_for_serving

    t_phase = time.perf_counter()
    cfg = configs.get_config("whisper_base")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = encdec.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    params = pack_params_for_serving(dense, cfg, "native")
    del dense
    torch.cuda.synchronize()
    t_init, peak_init = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    frames = torch.randn((WHISPER_B, cfg.n_frames, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    start = torch.tensor(np.random.default_rng(SEED + 7).integers(0, cfg.vocab, (WHISPER_B, 1)),
                         dtype=torch.int32, device="cuda")
    times = {}

    def run(fr, tok):
        t0 = time.perf_counter()
        enc = encdec.encode(params, fr, cfg)
        torch.cuda.synchronize()
        times["encode"] = time.perf_counter() - t0
        cache = lm.make_cache(cfg, fr.shape[0], WHISPER_NEW, "cuda")
        finite = torch.isfinite(enc).all()
        outs = []
        for t in range(WHISPER_NEW):
            logits, cache = encdec.decode_step(params, cache, enc, tok, t, cfg)
            row = logits[:, -1, : cfg.vocab]
            finite = finite & torch.isfinite(row).all()
            tok = row.argmax(dim=-1, keepdim=True).to(torch.int32)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy(), bool(finite)

    (toks, finite), counts, _, wall, peak = drive(torch, lambda: run(frames, start))
    enc_want, dec_want = encdec_launches(cfg, True), encdec_launches(cfg, False)
    per_run = {k: enc_want.get(k, 0) + WHISPER_NEW * dec_want.get(k, 0)
               for k in set(enc_want) | set(dec_want)}
    check_launches("whisper-base", counts, per_run, 1)
    add_launches(launches, counts)
    check(finite, "whisper-base: non-finite encoder output or logits")
    check(toks.shape == (WHISPER_B, WHISPER_NEW) and (toks >= 0).all() and (toks < cfg.vocab).all(),
          "whisper-base: tokens out of range")
    t_encode = times["encode"]
    again, _ = run(frames, start)
    check(np.array_equal(again, toks), "whisper-base: a second run gave different tokens")
    alone, _ = run(frames[1:2], start[1:2])
    same = bool(np.array_equal(alone[0], toks[1]))
    say(f"encdec whisper-base ({cfg.n_enc_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_frames} frames, vocab {cfg.padded_vocab} padded, native wire): init "
        f"{t_init:.2f} s, peak memory after init {peak_init} B; encode of {WHISPER_B} x "
        f"{cfg.n_frames} frames {t_encode:.3f} s, then {WHISPER_NEW} greedy decode_step calls "
        f"(cross-attention re-projects the encoder output every step): wall {wall:.2f} s, "
        f"{WHISPER_B * WHISPER_NEW / (wall - t_encode):.2f} generated tokens/s after the encode, "
        f"peak memory {peak} B; launches {json.dumps(counts)}; finite; a second run "
        f"byte-identical; request 1 run alone {'equals' if same else 'DIFFERS FROM'} its row "
        f"of the batch ({card})")
    del params, frames
    torch.cuda.empty_cache()
    t = time.perf_counter() - t_phase
    say(f"encdec: phase wall {t:.1f} s")
    return t


# ------------------------------------------------------------------ training

TRAIN_ARCH = "granite_moe_1b_a400m"
# the stream's vocabulary: the reference's launcher caps it at 2048 (a
# Markov table is vocab x vocab in float64, 19.3 GB at 49155); its ids are
# valid ids of the model's full 49155-token head
TRAIN_VOCAB, TRAIN_B, TRAIN_S, TRAIN_STEPS = 2048, 8, 512, 12
TRAIN_WDBB = dict(begin_step=0, end_step=8, update_every=4)
RESUME_LAYERS = 2  # the kill-and-resume check's depth (full width)


def train_launches(cfg):
    """#5's dense-form launches of one training step of a GQA arch under
    awdbb: each of wq, wk, wv and wo prunes its own input
    (``maybe_pack_input`` packs only for packed weights), the MoE FFN its
    input once (a dense MLP each of its linears'), the head none; twice
    under remat (the backward recomputes every layer's forward; the
    straight-through backward launches nothing)."""
    mlp = 1 if cfg.moe is not None else (3 if cfg.mlp_act == "swiglu" else 2)
    passes = 1 if cfg.remat == "none" else 2
    return {"dap_prune": (4 + mlp) * cfg.n_layers * passes}


def train_opt_cfg(opt_mod):
    return opt_mod.OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)


def ste_phase(torch, run_ms, gen, launches_per_step):
    """The STE (``core/dap.DAPSTE``) at the training shape ``[B*S, d]``
    bf16 on the card, bit for bit against its plain version on the same
    tensors (``dbb.prune`` forward, the gradient times a recomputed
    ``dbb.topk_block_mask`` backward), on an input with zero-filled and
    part-zero blocks, -0.0, ties and a NaN block; #5's dense form timed at
    that shape beside its plain version, its bytes bound, and the STE
    backward's plain ms.  Returns the record's ``"train"`` entry."""
    from repro_torch.core import dbb
    from repro_torch.core.dap import DAPSTE, selection_mask
    from repro_torch.kernels import dap_prune, ref

    m, k = TRAIN_B * TRAIN_S, 1024
    x = dap_inputs(torch, gen, m, k, torch.float32)
    x[3, :64] = 0.0  # whole zero blocks
    x[4, ::3] = 0.0  # blocks with fewer than 4 non-zeros
    x[5, 8:16] = -0.0
    x = x.to(torch.bfloat16)
    g = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    xa = x.clone().requires_grad_(True)
    y = DAPSTE.apply(xa, 4, 8)
    y.backward(g)
    cfg = dbb.DBBConfig(4, 8)
    want_y = dbb.prune(x, cfg)
    want_g = torch.where(dbb.topk_block_mask(x, cfg), g, torch.zeros_like(g))
    v = torch.int16
    check(torch.equal(y.detach().view(v), want_y.view(v)),
          "STE forward at the training shape differs from dbb.prune")
    check(torch.equal(xa.grad.view(v), want_g.view(v)),
          "STE backward at the training shape differs from the recomputed selection")
    xb = x[8:]  # the timed calls: no planted rows
    out = dap_prune.dap_prune_cuda(xb, 4)
    t_k = run_ms(lambda: dap_prune.dap_prune_cuda(xb, 4), iters=15)
    t_p = run_ms(lambda: ref.dap_prune_ref(xb, 4), iters=3)
    gb = g[8:]
    t_bwd = run_ms(lambda: torch.where(selection_mask(xb, out[0], 4, 8), gb,
                                       torch.zeros_like(gb)), iters=15)
    nbytes = xb.numel() * 2 + sum(t.numel() * t.element_size() for t in out)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    n = launches_per_step
    say(f"kernel dap_prune (training shape M={m} K={k}, bf16: the DAP input of granite-moe's "
        f"wq/wk/wv/wo and MoE FFN at batch {TRAIN_B} x {TRAIN_S}): kernel_ms {t_k:.4f} plain_ms "
        f"{t_p:.3f} bound_ms {bound:.5f} (bytes) library_ms none; the STE backward (plain: "
        f"selection from the output, then where) {t_bwd:.4f} ms; {n} launches a step, "
        f"{n * t_k:.2f} ms of #5 a step; STE forward and backward bit for bit against "
        f"dbb.prune and the recomputed topk_block_mask (zero blocks, -0.0, ties, NaN)")
    return dict(M=m, K=k, ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by="bytes",
                library_ms=None, ste_backward_plain_ms=t_bwd, launches_per_step=n)


def masked_leaves(params, masks):
    """``(path, param)`` of every leaf whose W-DBB mask drops something."""
    from repro_torch.core import tree

    out = []
    for g, mg in zip(tree.groups(params), tree.groups(masks)):
        for path, p, m in zip(g.piece_paths(), g.pieces, mg.pieces):
            if not bool(m.all()):
                out.append((path, p))
    return out


def train_vs_cpu(torch):
    """One ``train_step`` of granite-moe-1b-a400m's smoke config in f32
    under wdbb (no DAP, so no selection flips) on the card and on the CPU
    from the same params, masks and batch: loss within 1e-5 relative,
    moments within 1e-4 of each leaf's largest, params within 1e-4 (AdamW's
    first step divides a moment by its root, so an element whose gradient
    is near eps moves by up to lr x a rounding difference; lr 1e-3).
    Returns the largest differences."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import dbb, schedule, tree
    from repro_torch.models import lm
    from repro_torch.train import optimizer, train_step

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH, smoke=True, sparsity_mode="wdbb"),
                              dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu", wire_dtype=None)
    masks = schedule.wdbb_masks(params, dbb.DBBConfig(4, 8))
    rng = torch.Generator().manual_seed(SEED + 9)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=rng, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    ocfg = optimizer.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda t: t.to(dev)
        out[dev] = train_step.train_step(
            tree.tree_map(mv, params), optimizer.init(tree.tree_map(mv, params)),
            {k: v.to(dev) for k, v in batch.items()}, cfg=cfg, opt_cfg=ocfg,
            masks=tree.tree_map(mv, masks))
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    dl = abs(float(mc["loss"]) - float(mg["loss"])) / abs(float(mc["loss"]))
    check(dl <= 1e-5, f"train_step card vs CPU: loss differs by {dl:.3g} relative")
    worst = {"loss_rel": dl}
    for name, a, b, bound, rel in (("params", pc, pg, 1e-4, False), ("mu", sc.mu, sg.mu, 1e-4, True),
                                   ("nu", sc.nu, sg.nu, 1e-4, True)):
        w = 0.0
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            d = (x - y.cpu()).abs().max().item()
            scale = x.abs().max().item() if rel else 1.0
            w = max(w, d / max(scale, 1e-30))
            check(d <= bound * max(scale, 1e-30) if rel else d <= bound,
                  f"train_step card vs CPU: {name} differs by {d:.3g}")
        worst[name] = w
    return worst


def resume_check(torch, cfg):
    """Kill and resume at full width and ``RESUME_LAYERS`` layers under
    ``torch.use_deterministic_algorithms``: 4 steps straight against 2
    steps, a save, a new ``Trainer`` restored from it and 2 more steps
    (the W-DBB schedule refreshing every 2 steps, so the resumed trainer's
    recomputed masks are the uninterrupted run's).  Params and moments bit
    for bit; an op without a deterministic CUDA path is named and the
    check held to 1 bf16 ulp of each param leaf's largest value and 1e-3
    of each moment leaf's largest instead.  Returns the line's text."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import warnings

    from repro_torch.core import dbb, tree
    from repro_torch.core.schedule import WDBBSchedule
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg2 = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    sched = WDBBSchedule(dbb.DBBConfig(4, 8), begin_step=0, end_step=8, update_every=2)

    def trainer(ckpt_dir=None):
        return Trainer(cfg2, train_opt_cfg(optimizer),
                       TrainerConfig(total_steps=4, log_every=0, ckpt_dir=ckpt_dir, wdbb=sched),
                       MarkovLM(TRAIN_VOCAB, TRAIN_B, TRAIN_S, seed=SEED),
                       torch.Generator(device="cuda").manual_seed(SEED + 1), device="cuda")

    d = tempfile.mkdtemp(prefix="train_resume_", dir=os.environ.get("TMPDIR"))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                a = trainer()
                a.run(4)
                b = trainer(d)
                b.run(2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b.save()
                t_save = time.perf_counter() - t0
                del b
                t0 = time.perf_counter()
                c = trainer(d)
                torch.cuda.synchronize()
                t_restore = time.perf_counter() - t0
                check(c.step == 2, f"resume: restored at step {c.step}, not 2")
                c.run(2)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        nbytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ops_nd = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    worst = {}
    for name, ta, tc, tol in (("params", a.params, c.params, 2 ** -8),
                              ("mu", a.opt_state.mu, c.opt_state.mu, 1e-3),
                              ("nu", a.opt_state.nu, c.opt_state.nu, 1e-3)):
        w = 0.0
        for x, y in zip(tree.leaves(ta), tree.leaves(tc)):
            if ops_nd:
                d_ = (x.float() - y.float()).abs().max().item()
                w = max(w, d_ / max(x.float().abs().max().item(), 1e-30))
                check(w <= tol, f"resume: {name} differs by {w:.3g} of a leaf's largest "
                                f"(bound {tol}; non-deterministic ops {ops_nd})")
            else:
                v = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
                check(torch.equal(x.view(v), y.view(v)), f"resume: {name} not bit for bit")
        worst[name] = w
    check(int(a.opt_state.step) == int(c.opt_state.step) == 4, "resume: optimizer steps differ")
    verdict = ("bit for bit (params, mu, nu) under use_deterministic_algorithms" if not ops_nd
               else f"held to a tolerance, ops without a deterministic CUDA path: {ops_nd}; "
                    f"largest differences {worst}")
    return (f"kill and resume at {RESUME_LAYERS} of {cfg.n_layers} layers, full width: 4 steps "
            f"== 2 steps, save, restore into a new Trainer, 2 steps: {verdict}; checkpoint "
            f"{nbytes} B, save {t_save:.2f} s, new Trainer with restore {t_restore:.2f} s")


def phase_train(torch, np, card, launches, stats):
    """granite-moe-1b-a400m trained whole at full width and depth (24
    layers, 32 experts top-8, padded vocabulary 49408), bf16, its awdbb
    4/8 sparsity with the STE at every DAP site, ``remat="full"``: 12
    ``Trainer`` steps of AdamW over ``MarkovLM(2048, batch 8, seq 512)``
    through a ``Prefetcher`` (the stream's ids are valid ids of the full
    head), W-DBB ramping to 4/8 by step 8.  Launches counted over the run
    (every one of #5's dense form, none plain); asserts finite losses, the
    last below the first, 4-of-8 on every masked weight after the schedule
    ends.  Then int8 gradient compression at the same width, the
    kill-and-resume check, the card against the CPU on a smoke step, and
    the STE at the training shape."""
    from repro_torch import configs
    from repro_torch.core import dbb, tree
    from repro_torch.core.schedule import WDBBSchedule
    from repro_torch.data.pipeline import MarkovLM, Prefetcher
    from repro_torch.kernels import ops
    from repro_torch.train import compression, optimizer, train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    run_ms = timer(torch, flush)
    cfg = configs.get_config(TRAIN_ARCH)
    per_step = train_launches(cfg)
    sched = WDBBSchedule(dbb.DBBConfig(cfg.sparsity.w_nnz, cfg.sparsity.bz), **TRAIN_WDBB)
    data = Prefetcher(MarkovLM(TRAIN_VOCAB, TRAIN_B, TRAIN_S, seed=SEED))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, train_opt_cfg(optimizer),
                     TrainerConfig(total_steps=TRAIN_STEPS, log_every=0, wdbb=sched), data,
                     torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        torch.cuda.synchronize()
        t_init, peak_init = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in tree.leaves(tr.params))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counters()
        hist, step_launches = [], []
        for _ in range(TRAIN_STEPS):
            before = ops.counters()["dap_prune"].launches
            hist += tr.run(1)
            step_launches.append(ops.counters()["dap_prune"].launches - before)
        torch.cuda.synchronize()
        peak_train = torch.cuda.max_memory_allocated()
        counters = ops.counters()
    finally:
        data.close()
    check(all(c.plain == 0 for c in counters.values()),
          f"train: a plain version ran on the card: {[k for k, c in counters.items() if c.plain]}")
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    check_launches("train granite-moe-1b-a400m", counts, per_step, TRAIN_STEPS)
    check(all(n == per_step["dap_prune"] for n in step_launches),
          f"train: #5 launches a step {step_launches}, expected {per_step['dap_prune']}")
    add_launches(launches, counts)
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    masked = masked_leaves(tr.params, tr.masks)
    want_masked = (4 + 3) * cfg.n_layers + 1  # wq wk wv wo, the experts' gate up down; the head
    check(len(masked) == want_masked, f"train: {len(masked)} masked leaves, {want_masked} expected")
    bad = [p for p, w in masked
           if not bool(dbb.satisfies(w.transpose(-2, -1), dbb.DBBConfig(4, 8)))]
    check(not bad, f"train: weights past 4-of-8 after step {TRAIN_WDBB['end_step']}: {bad[:4]}")
    times = [h["step_time"] for h in hist]
    steady = times[1:]
    p50 = statistics.median(steady)
    tok = TRAIN_B * TRAIN_S
    say(f"train {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, vocab {cfg.vocab} padded {cfg.padded_vocab}; {n_params} params, "
        f"bf16, awdbb 4/8 with the STE, remat {cfg.remat}; batch {TRAIN_B} x {TRAIN_S} from "
        f"MarkovLM({TRAIN_VOCAB}) through a Prefetcher: the stream's ids are valid ids of the "
        f"full head; AdamW lr 3e-4, warmup 2, W-DBB to 4/8 by step {TRAIN_WDBB['end_step']}, "
        f"refreshed every {TRAIN_WDBB['update_every']}): init {t_init:.2f} s, peak memory after "
        f"init {peak_init} B, while training {peak_train} B; losses "
        f"{[round(x, 4) for x in losses]}; step time first {times[0]:.3f} s, then p50 "
        f"{p50:.4f} s, max {max(steady):.4f} s; {tok / p50:.1f} tokens/s; #5 launches a step "
        f"{step_launches[0]} (predicted {per_step['dap_prune']}: 5 DAP sites x "
        f"{cfg.n_layers} layers x 2 with remat); every masked weight 4-of-8 after step "
        f"{TRAIN_WDBB['end_step']} ({len(masked)} leaves) ({card})")

    # int8 gradient compression with error feedback at the same width
    batch = {k: torch.as_tensor(np.asarray(v), device="cuda")
             for k, v in next(iter(MarkovLM(TRAIN_VOCAB, TRAIN_B, TRAIN_S, seed=SEED + 5))).items()}
    flat = tree.leaves(tr.params)
    req = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = train_step.loss_fn(tree.unflatten(tr.params, req), batch, cfg)
    grads = tree.unflatten(tr.params, list(torch.autograd.grad(loss, req)))
    del req, loss
    res = compression.init_residuals(tr.params)
    qtree, res = compression.compress_tree(grads, res)
    deq = compression.decompress_tree(qtree)
    worst = 0.0
    for g, q, dq in zip(tree.leaves(grads), tree.leaves(qtree), tree.leaves(deq)):
        err = (dq - g.float()).abs().max().item() / q[1].item()
        worst = max(worst, err)
    check(worst <= 0.5 + 1e-4, f"compression: a decompressed gradient {worst:.4f} scales off")
    del grads, qtree, deq
    p, s = tr.params, tr.opt_state
    losses_c = []
    for _ in range(2):
        p, s, m, res = train_step.train_step(p, s, batch, cfg=cfg, opt_cfg=train_opt_cfg(optimizer),
                                             masks=tr.masks, residuals=res)
        losses_c.append(float(m["loss"]))
    finite = all(bool(torch.isfinite(r).all()) for r in tree.leaves(res))
    check(finite and all(math.isfinite(x) for x in losses_c),
          f"compression: non-finite residuals or losses {losses_c}")
    say(f"train compression (int8, error feedback, one scale per stacked leaf): decompressed "
        f"gradients within {worst:.4f} of a scale of their input (bound 0.5); two train_steps "
        f"with residuals at full width: losses {[round(x, 4) for x in losses_c]}, residuals "
        f"finite ({card})")
    del p, s, res, tr
    torch.cuda.empty_cache()

    say("train " + resume_check(torch, cfg) + f" ({card})")
    torch.cuda.empty_cache()
    w = train_vs_cpu(torch)
    say(f"train card vs CPU (granite-moe smoke, f32, wdbb, one train_step): loss "
        f"{w['loss_rel']:.3g} relative, params {w['params']:.3g} absolute, mu {w['mu']:.3g} and "
        f"nu {w['nu']:.3g} of each leaf's largest (bounds 1e-5, 1e-4, 1e-4, 1e-4)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    stats["dap_prune"]["train"] = ste_phase(torch, run_ms, gen, per_step["dap_prune"])
    del flush
    torch.cuda.empty_cache()
    t = time.perf_counter() - t_phase
    say(f"train: phase wall {t:.1f} s")
    return t


# ------------------------------------------------------------ distribution

DIST_MOE_ARCH, DIST_MOE_B, DIST_MOE_S = "granite_moe_1b_a400m", 4, 512
DIST_DEC_ARCH, DIST_DEC_B, DIST_DEC_S0, DIST_DEC_NEW = "granite_3_8b", 4, 64, 32
# ranks sharing the one card over gloo in the (1, 2) run: nccl takes one
# rank a device, and gloo carries CUDA tensors for every collective the
# regions make (scripts/probe_gloo_cuda.py)
DIST_SHARED_RANKS = 2


def wdbb_launches(cfg):
    """Launches of a forward pass of native-packed weights under wdbb: no
    DAP, every packed linear on #1 (the attention's four, a dense MLP's,
    the head; MoE experts stay dense)."""
    mlp = 0 if cfg.moe is not None else (3 if cfg.mlp_act == "swiglu" else 2)
    return {"dbb_matmul": (4 + mlp) * cfg.n_layers + 1}


def _f32_wdbb(cfg):
    import dataclasses

    return dataclasses.replace(cfg, dtype="float32",
                               sparsity=dataclasses.replace(cfg.sparsity, mode="wdbb"))


def _per_pass(stats, passes):
    return {name: (calls / passes, nbytes / passes) for name, (calls, nbytes) in stats.items()}


def _same_on_every_rank(torch, *tensors):
    """Every rank of the default group holds the same bytes."""
    import hashlib

    import torch.distributed as dist

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, h.hexdigest())
    return len(set(digests)) == 1


def _dist_where(mesh, world):
    return (f"mesh {tuple(mesh.shape)}, " +
            ("nccl" if world == 1 else f"{world} ranks sharing the card over gloo"))


def dist_moe(torch, np, card, mesh, log):
    """granite-moe-1b-a400m at full width and depth through the
    expert-parallel region: ``lm.forward`` over 4 x 512 tokens under
    ``mesh``, native-packed weights, the experts placed by
    ``local_tree``.  f32 under wdbb against the grouped path without a
    context (the reference's 1e-4, of the logits' scale); at more than
    one model shard the tokens split over the sequence, so there at a
    capacity that drops nothing.  bf16 under the served awdbb: logits
    finite, two runs byte-identical on one rank, every rank's logits
    byte-identical on several.  Launches against ``ring_launches``/
    ``wdbb_launches``.  Returns the launches."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.sharding import partition
    from repro_torch.sharding.context import use_mesh

    world = dist.get_world_size()
    cfg = configs.get_config(DIST_MOE_ARCH)
    f32 = _f32_wdbb(cfg)
    if world > 1:
        f32 = dataclasses.replace(f32, moe=dataclasses.replace(
            f32.moe, capacity_factor=f32.moe.n_experts / f32.moe.top_k))
    toks = torch.tensor(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (DIST_MOE_B, DIST_MOE_S)), dtype=torch.int32, device="cuda")
    total = {}
    for label, c in (("f32 wdbb", f32), ("bf16 awdbb", cfg)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
        t0 = time.perf_counter()
        whole = lm.init_params(c, gen, "cuda", wire_dtype="native")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        with torch.no_grad():
            grouped = lm.forward(whole, toks, c) if c is f32 else None  # no context
            params = partition.local_tree(whole, lm.local_specs(c), mesh)
            del whole
            runs = []
            for _ in range(2 if c is cfg and world == 1 else 1):
                with use_mesh(mesh) as ctx:
                    logits, counts, _, wall, peak = drive(
                        torch, lambda: lm.forward(params, toks, c))
                runs.append(logits)
        want = ring_launches(c, "native") if c is cfg else wdbb_launches(c)
        check_launches(f"distributed {DIST_MOE_ARCH} {label}", counts, want, 1)
        add_launches(total, counts)
        check(bool(torch.isfinite(runs[0]).all()), f"distributed moe {label}: non-finite")
        line = (f"distributed {cfg.name} {label} ({c.n_layers} layers, {c.moe.n_experts} "
                f"experts top-{c.moe.top_k}, capacity factor {c.moe.capacity_factor}, native "
                f"wire; lm.forward over {DIST_MOE_B} x {DIST_MOE_S} tokens through the "
                f"expert-parallel region, {_dist_where(mesh, world)}): init {t_init:.2f} s, wall "
                f"{wall:.3f} s, peak memory {peak} B; collectives a forward (calls, bytes) "
                f"{json.dumps(_per_pass(ctx.stats, 1))}; launches {json.dumps(counts)}")
        if grouped is not None:
            scale = grouped.abs().max().item()
            err = (runs[0] - grouped).abs().max().item() / scale
            check(err <= 1e-4, f"distributed moe f32 ({world} ranks): {err:.3g} of the logits' "
                               f"scale from the grouped path (bound 1e-4)")
            line += f"; vs the grouped path {err:.3g} of the logits' scale {scale:.4g} (bound 1e-4)"
        elif world == 1:
            check(torch.equal(runs[0], runs[1]), "distributed moe bf16: two runs differ")
            line += "; two runs byte-identical"
        if world > 1:
            check(_same_on_every_rank(torch, runs[0]), f"distributed moe {label}: ranks differ")
            line += f"; the {world} ranks' logits byte-identical"
        log(line + f" ({card})")
        del params, runs, logits, grouped
        torch.cuda.empty_cache()
    return total


def dist_flash(torch, np, card, mesh, log):
    """granite-3-8b at full width and depth (40 layers) on the native wire
    and native KV through ``flash_decode``: 4 rows of 64 tokens prefilled
    into a window-sharded ring (``lm.make_cache`` under ``mesh``), then 32
    greedy ``decode_step`` calls.  f32 under wdbb against the plain ring
    path without a context (tokens equal, logits within 5e-4 of their
    scale), every rank's tokens and logits byte-identical on several; bf16
    under awdbb on one rank: logits finite, two runs byte-identical.
    Launches against ``wdbb_launches``/``ring_launches`` a pass.  Returns
    the launches."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.models import attention, lm
    from repro_torch.sharding.context import use_mesh

    world = dist.get_world_size()
    cfg = configs.get_config(DIST_DEC_ARCH)
    prompts = torch.tensor(np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab, (DIST_DEC_B, DIST_DEC_S0)), dtype=torch.int32, device="cuda")
    max_seq = DIST_DEC_S0 + DIST_DEC_NEW

    def run(params, c):
        cache = lm.make_cache(c, DIST_DEC_B, max_seq, "cuda")
        logits, cache = lm.prefill(params, prompts, c, cache)
        tok = logits[:, -1, :c.vocab].argmax(dim=-1, keepdim=True).to(torch.int32)
        toks, rows = [], []
        for i in range(DIST_DEC_NEW):
            logits, cache = lm.decode_step(params, cache, tok, DIST_DEC_S0 + i, c)
            row = logits[:, -1, :c.vocab]
            rows.append(row.float())
            tok = row.argmax(dim=-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        return torch.cat(toks, dim=1), torch.stack(rows, dim=1), isinstance(
            cache, attention.ShardedRing)

    total = {}
    runs = (("f32 wdbb", _f32_wdbb(cfg)), ("bf16 awdbb", cfg))
    # ranks sharing one card: the f32 check only (a bf16 run there would
    # double the sub-phase's wall; the MoE's bf16 run holds its ranks equal)
    for label, c in runs[:1] if world > 1 else runs:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        t0 = time.perf_counter()
        params = lm.init_params(c, gen, "cuda", wire_dtype="native")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        f32 = c is not cfg
        with torch.no_grad():
            results = []
            for _ in range(2 if not f32 and world == 1 else 1):
                with use_mesh(mesh) as ctx:
                    res, counts, passes, wall, peak = drive(torch, lambda: run(params, c))
                results.append(res)
            toks, rows, sharded = results[0]
            check(sharded, f"distributed {DIST_DEC_ARCH} {label}: the ring was not sharded")
            check(passes == 1 + DIST_DEC_NEW, f"distributed flash: {passes} passes")
            want = ring_launches(c, "native") if not f32 else wdbb_launches(c)
            check_launches(f"distributed {DIST_DEC_ARCH} {label}", counts, want, passes)
            add_launches(total, counts)
            check(bool(torch.isfinite(rows).all()), f"distributed flash {label}: non-finite")
            line = (f"distributed {cfg.name} {label} ({c.n_layers} layers, native wire, "
                    f"native KV; {DIST_DEC_B} x {DIST_DEC_S0} prefilled into a window-sharded "
                    f"ring, then {DIST_DEC_NEW} greedy decode_step calls through flash_decode, "
                    f"{_dist_where(mesh, world)}): init {t_init:.2f} s, wall {wall:.3f} s "
                    f"({DIST_DEC_B * DIST_DEC_NEW / wall:.2f} tokens/s, prefill included), "
                    f"peak memory {peak} B; collectives a pass (calls, bytes) "
                    f"{json.dumps(_per_pass(ctx.stats, DIST_DEC_NEW))} (decode steps only: "
                    f"prefill makes none); launches {json.dumps(counts)} over {passes} passes")
            if f32:
                ptoks, prows, psharded = run(params, c)  # no context: the plain ring
                check(not psharded, "distributed flash: a ring made without a context sharded")
                scale = prows.abs().max().item()
                err = (rows - prows).abs().max().item() / scale
                check(torch.equal(toks, ptoks), f"distributed flash f32 ({world} ranks): greedy "
                                                f"tokens differ from the plain ring path")
                check(err <= 5e-4, f"distributed flash f32 ({world} ranks): {err:.3g} of the "
                                   f"logits' scale from the plain ring (bound 5e-4)")
                line += (f"; vs the plain ring path: greedy tokens equal, logits {err:.3g} of "
                         f"their scale {scale:.4g} (bound 5e-4)")
            elif world == 1:
                check(torch.equal(toks, results[1][0]) and torch.equal(rows, results[1][1]),
                      "distributed flash bf16: two runs differ")
                line += "; two runs byte-identical"
            if world > 1:
                check(_same_on_every_rank(torch, toks, rows),
                      f"distributed flash {label}: ranks differ")
                line += f"; the {world} ranks' tokens and logits byte-identical"
        log(line + f" ({card})")
        del params, results
        torch.cuda.empty_cache()
    return total


def dist_shared_rank(rank, world, work, card):
    """One of ``world`` ranks sharing card 0 over gloo (spawned by
    ``phase_distributed``): the (1, world) mesh, both regions at full
    width; rank 0 prints; each rank writes its launches to ``work``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh()
        log = say if rank == 0 else (lambda *a: None)
        counts = dist_moe(torch, np, card, mesh, log)
        add_launches(counts, dist_flash(torch, np, card, mesh, log))
        with open(os.path.join(work, f"launches_{rank}.json"), "w") as f:
            json.dump(counts, f)
    finally:
        dist.destroy_process_group()


def phase_distributed(torch, np, card, launches):
    """The two distributed regions over ``torch.distributed`` at full
    width: granite-moe-1b-a400m through the expert-parallel region
    (:func:`dist_moe`), granite-3-8b through ``flash_decode``
    (:func:`dist_flash`).  First nccl at world size 1 from a ``FileStore``
    in ``$TMPDIR``, the (1, 1) ``("data", "model")`` mesh of
    ``launch.mesh.make_host_mesh``; then ``DIST_SHARED_RANKS`` spawned
    ranks sharing the card over gloo in a (1, 2) mesh (nccl refuses two
    ranks a device), each rank's launches added.  Every group is
    destroyed at the end."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp()
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"),
                  f"distributed: mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
            add_launches(launches, dist_moe(torch, np, card, mesh, say))
            add_launches(launches, dist_flash(torch, np, card, mesh, say))
        finally:
            dist.destroy_process_group()
        t1 = time.perf_counter()
        say(f"distributed: world size 1 {t1 - t_phase:.1f} s")
        shared = os.path.join(work, "shared")
        os.makedirs(shared)
        mp.start_processes(dist_shared_rank, args=(DIST_SHARED_RANKS, shared, card),
                           nprocs=DIST_SHARED_RANKS, start_method="spawn")
        for rank in range(DIST_SHARED_RANKS):
            with open(os.path.join(shared, f"launches_{rank}.json")) as f:
                add_launches(launches, json.load(f))
        say(f"distributed: {DIST_SHARED_RANKS} ranks on the card {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter() - t_phase
    say(f"distributed: phase wall {t:.1f} s")
    return t


DRYRUN_EXTRA = (  # (arch, shape, mesh, packed) traced beside the single-pod grid
    ("granite_moe_1b_a400m", "train_4k", "multi", False),
    ("starcoder2_15b", "long_500k", "multi", False),
    ("granite_3_8b", "decode_32k", "single", True),
)


def phase_dryrun(card):
    """The dry-run analysis on this host: ``python -m
    repro_torch.launch.dryrun --all --mesh single`` (six processes) and
    the cells of ``DRYRUN_EXTRA`` in processes of their own, all at once,
    into a temporary directory; every process must exit 0 and every
    cell's JSON must be there.  Prints the report's table a mesh."""
    import tempfile

    from repro_torch.launch import report

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
        cmds = [base + ["--all", "--mesh", "single", "--jobs", "6"]]
        for arch, shape, mesh, packed in DRYRUN_EXTRA:
            cmds.append(base + ["--arch", arch, "--shape", shape, "--mesh", mesh]
                        + ["--packed"] * packed)
        logs = [tempfile.TemporaryFile("w+") for _ in cmds]
        procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                                  text=True) for c, log in zip(cmds, logs)]
        try:
            for c, proc, log in zip(cmds, procs, logs):
                proc.wait(timeout=600)
                if proc.returncode:
                    log.seek(0)
                    print("".join(log.readlines()[-40:]), file=sys.stderr)
                check(proc.returncode == 0, f"dry-run {' '.join(c[5:])}: exit {proc.returncode}")
        finally:
            for proc, log in zip(procs, logs):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        cells = report.load_cells(out)
    from repro_torch import configs

    want = sum(len(configs.applicable_shapes(a)) for a in configs.ARCH_IDS)
    single = [c for c in cells if c["mesh"] == "single" and not c["tags"]]
    check(len(single) == want, f"dry-run: {len(single)} single-pod cells, want {want}")
    check(len(cells) == want + len(DRYRUN_EXTRA), f"dry-run: {len(cells)} cells")
    for c in cells:
        rl = c["roofline"]
        check(rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0,
              f"dry-run {c['arch']}/{c['shape']}/{c['mesh']}: empty counts")
    for mesh in ("single", "multi"):
        say(f"dry-run roofline, mesh {mesh} (H100 SXM data-sheet peaks; counts of one "
            f"rank's program):")
        say(report.table(cells, mesh))
    for c in cells:
        if c["tags"]:
            rl = c["roofline"]
            say(f"dry-run {c['arch']}/{c['shape']}/{c['mesh']} [{c['tags']}]: "
                f"t_compute {report.fmt_s(rl['t_compute_s'])} t_memory "
                f"{report.fmt_s(rl['t_memory_s'])} t_collective "
                f"{report.fmt_s(rl['t_collective_s'])} ({rl['bottleneck']})")
    wall = time.perf_counter() - t0
    say(f"phase_dryrun: {len(cells)} cells ({want} single-pod, {len(DRYRUN_EXTRA)} more) "
        f"traced on this host in {wall:.1f} s wall ({card})")
    return wall


# ------------------------------------------------------------ the examples

CNN_STEPS = (300, 150)  # the CNN example's steps_base and steps_ft (its __main__)
CNN_CHECK_STEPS = 5  # the first fine-tune steps of each mode, card against CPU
# of each leaf's largest magnitude: cuDNN's and oneDNN's f32 convolutions
# sum in their own orders (3e-7 of the logits' scale between XLA and oneDNN)
CNN_TOL = 1e-4
# #5's dense form at the CNN's two DAP points: (K, what, rows a training
# step, rows an evaluation batch); one call each a forward
CNN_DAP = ((8, "CNN input", 128 * 10 * 10, 256 * 10 * 10),
           (16, "CNN after pool 1", 128 * 5 * 5, 256 * 5 * 5))
# train_e2e's steps: 60 of its default 300, which took 172.7 s (a host-bound
# 0.50 s step); at 60 the phase stays under 90 s and the W-DBB masks still
# reach 4/8 (refreshed every 10 steps up to step 30)
E2E_STEPS = 60


def load_example(name):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cnn_dap_shapes(torch, run_ms, gen):
    """#5's dense form at the CNN's rows in f32, NNZ 4 and 2: bit for bit
    against its plain version (NaN, +-inf, ties and -0.0 planted), timed
    beside it and its bytes bound.  Returns the record's ``"cnn"``
    entries."""
    from repro_torch.kernels import dap_prune, ref

    out = []
    for k, what, m_train, m_eval in CNN_DAP:
        for m, use in ((m_train, "training step"), (m_eval, "evaluation")):
            x = dap_inputs(torch, gen, m, k, torch.float32)
            for nnz in CNN_WIDTHS[k]:
                got, want = dap_prune.dap_prune_cuda(x, nnz), ref.dap_prune_ref(x, nnz)
                check(all(torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                      w.view(torch.int32) if w.dtype == torch.float32 else w)
                          for g, w in zip(got, want)),
                      f"dap_prune K={k} M={m} NNZ {nnz} f32: differs from its plain version")
                t_k = run_ms(lambda: dap_prune.dap_prune_cuda(x, nnz), iters=15)
                t_p = run_ms(lambda: ref.dap_prune_ref(x, nnz), iters=3)
                nbytes = x.numel() * 4 + sum(t.numel() * t.element_size() for t in got)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                say(f"kernel dap_prune M={m} K={k} ({what}, a {use}) f32 NNZ {nnz}: kernel_ms "
                    f"{t_k:.4f} plain_ms {t_p:.3f} library_ms none bound_ms {bound:.5f} (bytes) "
                    f"bit-exact")
                out.append(dict(K=k, M=m, nnz=nnz, dtype="float32", use=use, ms=t_k,
                                plain_ms=t_p, bound_ms=bound, bound_by="bytes", max_abs_err=0.0))
    return out


def cnn_card_vs_cpu(torch, tc, init):
    """The first ``CNN_CHECK_STEPS`` steps of each fine-tune mode on the
    card and on the CPU (plain versions) from the same init and batches:
    the largest parameter difference of each mode over its leaves'
    largest magnitude, and of the losses, relative."""
    from repro_torch.data.pipeline import SyntheticVision

    worst = {}
    for name, wdbb, a_nnz in tc.FINE_TUNES:
        p_cpu, m_cpu = tc.prepare(init, wdbb)
        p_card = {k: v.cuda() for k, v in p_cpu.items()}
        m_card = None if m_cpu is None else {k: v.cuda() for k, v in m_cpu.items()}
        data = SyntheticVision(tc.N_CLASSES, tc.IMG, batch=128, seed=SEED)
        loss_err = 0.0
        for _ in range(CNN_CHECK_STEPS):
            raw = next(data)
            p_cpu, ce_cpu, _ = tc.train_step(p_cpu, tc.to_batch(raw, "cpu"), m_cpu, a_nnz)
            p_card, ce_card, _ = tc.train_step(p_card, tc.to_batch(raw, "cuda"), m_card, a_nnz)
            loss_err = max(loss_err, abs(float(ce_card) - float(ce_cpu)) / abs(float(ce_cpu)))
        err = max((p_card[k].cpu() - p_cpu[k]).abs().max().item() / p_cpu[k].abs().max().item()
                  for k in p_cpu)
        check(err <= CNN_TOL and loss_err <= CNN_TOL,
              f"CNN {name}: {CNN_CHECK_STEPS} steps on the card differ from the CPU's by "
              f"{err:.3g} of a leaf's scale, losses by {loss_err:.3g} (bound {CNN_TOL})")
        worst[name] = (err, loss_err)
    return worst


def cnn_launches(tc, steps_ft):
    """#5's launches of one ``run``: two DAP calls a forward (the input
    and the first pooled map) in the 2/8 evaluation and in the A-DBB and
    A/W-DBB fine-tunes and their evaluations (the straight-through
    backward launches nothing); none in the dense and W-DBB rows."""
    dap_fts = sum(1 for _, _, a_nnz in tc.FINE_TUNES if a_nnz is not None)
    return {"dap_prune": 2 * (20 * (1 + dap_fts) + steps_ft * dap_fts)}  # 20 batches an evaluation


def phase_examples(torch, np, card, launches, stats):
    """The four examples' entry points in this process on the card, each
    driven with the launch counters at 0 just before and read just after
    (no plain version may run), the launches checked and counted into the
    record: the Table 3 CNN at its example size (its first fine-tune steps
    held against the CPU's, #5 timed at its rows; not its rows on the CPU
    port, 19.9 s of the H100 machine's host, which
    ``tests/test_torch_examples.py`` holds against the reference),
    quickstart at full size, serve_packed, and train_e2e at its ~110M
    default for ``E2E_STEPS`` steps (60 of its 300)."""
    import tempfile

    from repro_torch import configs

    t_phase = time.perf_counter()
    tc = load_example("cnn_dap_finetune_torch")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    run_ms = timer(torch, flush)
    stats["dap_prune"]["cnn"] = cnn_dap_shapes(torch, run_ms,
                                               torch.Generator(device="cuda").manual_seed(SEED + 9))
    del flush
    torch.cuda.empty_cache()

    # the CNN: card against CPU step by step, then the table on the card
    init = tc.init_cnn(torch.Generator().manual_seed(SEED))
    worst = cnn_card_vs_cpu(torch, tc, init)
    (rows, derived), counts, _, wall, peak = drive(
        torch, lambda: tc.run(*CNN_STEPS, SEED, "cuda", params=init))
    check_launches("examples cnn", counts, cnn_launches(tc, CNN_STEPS[1]), 1)
    add_launches(launches, counts)
    check(rows[0]["acc"] > 0.5, f"CNN: the baseline did not learn: {rows}")
    # steady fine-tune steps a second on the card (A/W-DBB, DAP and masks)
    from repro_torch.data.pipeline import SyntheticVision

    p, masks = tc.prepare({k: v.cuda() for k, v in init.items()}, True)
    data = SyntheticVision(tc.N_CLASSES, tc.IMG, batch=128, seed=SEED)
    p = tc.fit(p, data, 10, masks, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tc.fit(p, data, CNN_STEPS[1], masks, 4)
    torch.cuda.synchronize()
    steps_s = CNN_STEPS[1] / (time.perf_counter() - t0)
    del p, masks
    say(f"examples cnn (Table 3, {CNN_STEPS[0]} base + 3 x {CNN_STEPS[1]} fine-tune steps, "
        f"batch 128 of {tc.IMG}, f32, TF32 off): card wall {wall:.2f} s (peak {peak} B); "
        f"first {CNN_CHECK_STEPS} fine-tune steps card vs CPU: "
        + ", ".join(f"{n} params {e:.3g} losses {le:.3g}" for n, (e, le) in worst.items())
        + f" (bound {CNN_TOL} of the scale); #5 launches {counts.get('dap_prune', 0)}; A/W-DBB "
        f"fine-tune {steps_s:.1f} steps/s on the card ({card}); cut: the CPU port's rows are "
        f"not run here (tests/test_torch_examples.py holds them)")
    w = max(len(r["config"]) for r in rows)
    say(f"examples cnn table: {'config':<{w}}  card")
    for r in rows:
        say(f"examples cnn table: {r['config']:<{w}}  {r['acc']:.4f}")
    say(f"examples cnn table: joint A/W-DBB vs baseline: card {derived:+.4f} "
        f"(paper: ~1% loss, recovered by fine-tuning)")

    # quickstart at full size: #5 in section 3 and the awdbb forward, #1 in 4-5
    qs = load_example("quickstart_torch")
    cfg_q = configs.get_config("granite_3_8b", smoke=True)
    logits, counts, _, wall, _ = drive(torch, lambda: qs.main([]))
    check_launches("examples quickstart", counts,
                   {"dbb_matmul": 1, "dap_prune": 1 + (4 + 3) * cfg_q.n_layers}, 1)
    add_launches(launches, counts)
    say(f"examples quickstart (full size: granite smoke, seq 32): {wall:.2f} s, logits "
        f"{tuple(logits.shape)} finite, kernel #1 against ref.py, launches {counts} ({card})")

    # serve_packed: #1 on the packed and int8-KV engines, #2 on the int8 wire
    sp = load_example("serve_packed_torch")
    cfg_s = configs.get_config("granite_3_8b", smoke=True, sparsity_mode="wdbb")
    res, counts, passes, wall, _ = drive(torch, lambda: sp.main([]))
    per_pass = wdbb_launches(cfg_s)["dbb_matmul"]
    n_new, s0 = 16, 12
    check_launches("examples serve_packed", counts, {
        "dbb_matmul": (2 * (1 + n_new) + s0 + n_new) * per_pass,
        "dbb_matmul_int8": (1 + n_new) * per_pass}, 1)
    add_launches(launches, counts)
    kv_f, kv_8 = res["kv_bytes"]
    say(f"examples serve_packed: {wall:.2f} s over {passes} passes; packed == dense, int8-KV "
        f"batched == stepped; KV bytes {kv_f} -> {kv_8} (cache_nbytes on meta tensors); "
        f"launches {counts} ({card})")

    # train_e2e at its default size
    e2e = load_example("train_e2e_torch")
    cfg_e, e_batch, e_seq = e2e.model_config(False)
    with tempfile.TemporaryDirectory(prefix="e2e_") as ckpt_dir:
        res, counts, _, wall, peak = drive(torch, lambda: e2e.main(
            ["--steps", str(E2E_STEPS), "--ckpt-dir", ckpt_dir]))
    check_launches("examples train_e2e", counts, train_launches(cfg_e), E2E_STEPS)
    add_launches(launches, counts)
    losses = [h["loss"] for h in res["history"]]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train_e2e: losses {losses[0]} -> {losses[-1]}")
    check(res["wdbb_ok"] and res["resumed_step"] == E2E_STEPS,
          f"train_e2e: W-DBB bound {res['wdbb_ok']}, resumed at {res['resumed_step']}")
    times = [h["step_time"] for h in res["history"]]
    p50 = statistics.median(times[1:])
    say(f"examples train_e2e ({cfg_e.n_layers}L d{cfg_e.d_model}, {cfg_e.param_count()} params, "
        f"f32 awdbb, batch {e_batch} x {e_seq}, {E2E_STEPS} of its 300 steps, W-DBB 4/8 by "
        f"step {E2E_STEPS // 2}): {wall:.2f} s with two checkpoints and the resume; loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; step p50 {p50:.4f} s "
        f"({e_batch * e_seq / p50:.1f} tokens/s); peak {peak} B; "
        f"W-DBB bound on layer 0's up; resumed at step {res['resumed_step']}; #5 launches "
        f"{counts.get('dap_prune', 0)} ({card})")
    torch.cuda.empty_cache()
    t = time.perf_counter() - t_phase
    say(f"phase_examples: phase wall {t:.1f} s ({card})")
    return t


def say_pass(arch, n_layers, per_kernel):
    """One line: ``arch``'s kernels summed over a mixed-step pass."""
    lib = {"dbb_matmul_aw_int8": "_int_mm", "dbb_matmul_int8": "_int_mm",
           "paged_attn": "SDPA"}
    parts = []
    for name, st in per_kernel.items():
        yard = ("none" if st["library_ms"] is None
                else f"{st['library_ms']:.4f} ({lib[name]})")
        parts.append(f"{name} kernel_ms {st['ms']:.4f} bound_ms {st['bound_ms']:.4f} "
                     f"({st['bound_by']}) library_ms {yard} plain_ms {st['plain_ms']:.3f}")
    say(f"pass {arch} (one mixed step, M=64 rows, S=16, {n_layers} layers): "
        + "; ".join(parts))


def main():
    t_start = time.perf_counter()
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # read at the first cuBLAS call: phase_train's resume check runs under
    # torch.use_deterministic_algorithms, which needs a fixed workspace
    # (the size is Hopper's default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_card(torch)
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    libs = native.build_all()
    say(f"build: {len(libs)} kernel libraries with nvcc ({' '.join(native.NVCC_FLAGS)}) "
        f"in {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    run_ms = timer(torch, flush)
    qwen = {}  # qwen2-vl-72b's pass, per kernel
    rec_shapes = {k: [] for k in ("dbb_matmul", "dbb_matmul_int8", "dbb_matmul_aw_int8",
                                  "dbb_matmul_aw")}  # MIXER_TIMED's calls, per kernel
    stats = phase_matmuls(torch, run_ms, qwen, rec_shapes)
    stats["paged_attn"] = phase_attention(torch, run_ms, qwen)
    stats.update(phase_native_matmuls(torch, run_ms, rec_shapes))
    stats["paged_attn_latent"] = phase_latent_attention(torch, run_ms)
    stats.update(phase_dap_prune(torch, run_ms, qwen))
    phase_autotune(torch, run_ms)
    say_pass("qwen2-vl-72b", 80, qwen)
    phase_smoke_latent_engine(torch, np)
    del flush
    torch.cuda.empty_cache()
    phase_sampler(torch, card)
    launches = {}
    greedy = {}
    for arch, wire, kv_dtype, n_layers in PATHS:
        t0 = time.perf_counter()
        counts, greedy[arch] = phase_main_path(torch, np, card, arch, wire, kv_dtype, n_layers)
        for name, (n, _) in counts.items():
            launches[name] = launches.get(name, 0) + n
        say(f"main path {arch}: phase wall {time.perf_counter() - t0:.1f} s ({card})")
    dense, packed = draw_granite(torch)
    sampled = phase_serving_modes(torch, np, card, greedy["granite_3_8b"], launches, dense,
                                  packed)
    phase_spec(torch, np, card, greedy, sampled, packed, launches)
    phase_durability(torch, np, card, greedy["granite_3_8b"], dense, launches)
    del dense, packed
    torch.cuda.empty_cache()
    t_new = phase_recurrent(torch, np, card, launches) + phase_encdec(torch, np, card, launches)
    say(f"recurrent and encdec phases together: {t_new:.1f} s")
    phase_train(torch, np, card, launches, stats)
    phase_distributed(torch, np, card, launches)
    phase_dryrun(card)
    phase_examples(torch, np, card, launches, stats)

    record = []
    for name, info in KERNELS.items():
        st = stats[name]
        check(launches.get(name, 0) > 0, f"{name}: no launch on any main path")
        record.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
        })
        if name in rec_shapes:
            record[-1]["shapes"] = rec_shapes[name]
        for extra in ("train", "cnn"):
            if extra in st:
                record[-1][extra] = st[extra]
    say("kernel times above in the record: one mixed-step forward pass (M=64 rows, S=16 "
        "query tokens per request; attention on a mixed step's rows: decode rows and a "
        "chunk tail padded to S), summed over its launches, of granite-3-8b for "
        "dbb_matmul_int8, dbb_matmul_aw_int8, paged_attn, dap_prune_int8 and dap_pack_int8, "
        "of minicpm3-4b for "
        "dbb_matmul, dbb_matmul_aw, paged_attn_latent and dap_pack, of granite-moe-1b-a400m "
        "for dap_prune; launches summed over the main paths, the serving-mode, spec, "
        "durability, recurrent, encdec, train, distributed and examples phases; under "
        "\"shapes\" the #1-#4 calls at the recurrent families' mixer shapes (M=4 and 64), "
        "under dap_prune's \"train\" and \"cnn\" its training shape and the CNN's rows")
    say(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f} s, the build included")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
