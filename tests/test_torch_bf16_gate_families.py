"""The remaining bf16 serving paths held against the reference, as
``tests/test_torch_bf16_gate.py`` holds the paged A/W-DBB path: the
reference's small configs in bf16 under their own ``awdbb``, every bias
non-zero (and a mixer's ``A_log``, ``D``, ``dt_bias`` and conv bias, a
layer norm's bias and scale), weights drawn by the reference and
carried across by the converter, teacher-forced on three sides (the
reference in bf16 and on the same weights cast to f32, the port in
bf16), the bound

    bound = max(max|ref_bf16 - ref_f32|, 2e-2 * max|ref_f32|),

greedy tokens equal above twice the bound, and the port's logits equal
to the reference's bit for bit (the reference compiled as its program
is written: ``_torch_bf16_gate``'s flags, and for each group the LLVM
build whose jitted reference equals its eager run, ``GROUPS``).

The cases (``_torch_bf16_gate.FAMILY_CASES``):
  * mamba2-130m on the int8 and the native wire, hymba-1.5b on (int8,
    int8 KV) and (native, native), its window 8 so that it bites: the
    chunked ``lm.forward`` over two prompts of 20 tokens (the SSD's
    chunk is 16), then ``lm.decode_step`` stepped through them and 8
    decodes over the ring, as the engine serves these families;
  * whisper-base on both wires: ``encode`` of 24 bf16 frames, then
    ``decode_step`` through a prompt of 6 and 8 decodes;
  * unpacked weights, the reference's default serve (``pack_weights=
    False``: dense weights, DAP on the activations, the activations
    through ``epilogue.apply_act`` in bf16): starcoder2-15b's two-chunk
    paged prefill and 8 decodes (its gelu MLP, QKV bias and window of 6)
    and whisper-base's encode and decode.
Every case is bit for bit.  Before the gelu was repaired
(``epilogue.gelu``), the two unpacked cases were not: ``F.gelu`` rounds
once where the reference rounds after each operation.
"""

import pytest

import _torch_bf16_gate as gate
from repro_torch import configs

# the cases in four processes side by side (weights drawn once a process),
# and the LLVM optimization each compiles the reference with: whisper's
# packed cases take gelu in the matmuls' f32 epilogue, and XLA's build
# without LLVM's optimizations has another f32 tanh than its optimized one
# (the one ``epilogue._tanh_f32`` repeats: one f32 ulp or more apart on
# 10% of values, which moves whisper's int8 case by 0.4844); the
# optimized build sums the unpacked paths' bf16 dots in another order
# (whisper's encoder 0.038 apart at 195 of 3072 values).  Each group's
# build is the one where the jitted reference equals its eager run.
GROUPS = (({"mamba2_130m"}, ("int8", "native"), True),
          ({"hymba_1_5b"}, ("int8", "native"), True),
          ({"whisper_base"}, ("int8", "native"), False),
          ({"whisper_base", "starcoder2_15b"}, ("unpacked",), True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    groups = [[c for c in gate.FAMILY_CASES if c[0] in archs and c[1] in wires]
              for archs, wires, _ in GROUPS]
    assert sorted(c for g in groups for c in g) == sorted(gate.FAMILY_CASES)
    return gate.run_groups(groups, tmp_path_factory.mktemp("bf16_families"), timeout=600,
                           group_kw=[{"fast_compile": fast} for _, _, fast in GROUPS])


@pytest.mark.parametrize("arch,wire,kv_dtype", gate.FAMILY_CASES)
def test_bf16_family_within_reference_bound(runs, arch, wire, kv_dtype, record_property):
    """The port's bf16 logits within the reference-derived bound of the
    reference's, and equal to them bit for bit; greedy tokens equal above
    the margin."""
    key = gate.case_key(arch, wire, kv_dtype)
    got, want, want32 = (runs[f"{key}/{side}"] for side in ("port", "ref_bf16", "ref_f32"))
    kind = gate.kind_of(configs.get_config(arch, smoke=True).family, wire)
    assert got.shape == (gate.n_positions(kind), got.shape[-1])
    gate.check_case(f"{arch} {wire} wire {kv_dtype} KV ({kind})", got, want, want32,
                    record_property)
