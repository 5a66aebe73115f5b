"""One training step of the VLM, recurrent and enc-dec archs against the
JAX reference on the CPU: the second half of
``test_torch_train_archs.py``'s archs, with its checks and tolerances."""

import pytest

from _torch_train import arch_step_matches

ARCHS = ("qwen2_vl_72b", "mamba2_130m", "hymba_1_5b", "whisper_base")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_train_step_matches_reference(monkeypatch, arch):
    arch_step_matches(monkeypatch, arch)
