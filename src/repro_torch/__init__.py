"""PyTorch / CUDA port of the S2TA serving and training stack for NVIDIA
Hopper.

Mirrors the JAX package ``repro`` module for module
(``repro_torch/{configs,core,data,kernels,launch,models,runtime,serve,
train}``) and is held against it by the ``tests/test_torch_*.py`` parity
suite.  This package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.

Slice 1 covers int8 DBB continuous serving of dense GQA decoders
(granite-3-8b): ``serve.engine.Engine(...).generate_requests(...)`` over a
paged KV cache, with the int8 joint A/W-DBB matmul, the int8 W-DBB matmul
and fused paged attention as hand-written ``sm_90a`` CUDA kernels
(``kernels/csrc``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain
PyTorch version instead.
"""
