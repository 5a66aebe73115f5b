"""The model's DTensor regions compute what the plain path computes: four
gloo ranks in a (2, 2) ``("data", "model")`` mesh (spawned once for the
file, ``tests/_torch_dtensor_ranks.py``) run smoke configs in f32 on
``DTensor`` leaves placed by the reference's spec trees, as the dry-run
places its fake ones, and each result is held to the plain,
undistributed one: the forward and its gradients of a dense GQA, an
MoE, the SSD mixer, MLA, the hybrid and the enc-dec arch (Megatron
linears, sequence-parallel attention, the expert-parallel and mixer
regions); ring decode through flash-decode, through the key-parallel
merge (batch 1) and MLA's absorbed region (serving specs); the
vocabulary-parallel loss, accuracy and gradients; DAP shard by shard,
bit for bit."""

import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_dtensor_ranks as ranks

WORLD = ranks.SHAPE[0] * ranks.SHAPE[1]


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("regions"))
    mp.start_processes(ranks.run, args=(WORLD, work), nprocs=WORLD, start_method="spawn")
    return dict(np.load(f"{work}/regions.npz"))


def _close(res, name, atol):
    got, want = res[f"{name}_dt"], res[f"{name}_plain"]
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", ranks.FORWARD_ARCHS)
def test_forward_regions_equal_plain(res, arch):
    """The logits, and the norm of every leaf's gradient of their sum of
    squares (the backward through each region: partial sums reduced)."""
    _close(res, f"forward_{arch}", 1e-5)
    _close(res, f"grads_{arch}", 1e-5)


@pytest.mark.parametrize("case", ["granite_3_8b_b4", "granite_3_8b_b1", "minicpm3_4b_b4"])
def test_decode_regions_equal_plain(res, case):
    _close(res, f"decode_{case}", 1e-5)


@pytest.mark.parametrize("name", ["loss", "acc", "grad_norm"])
def test_vocab_parallel_loss_equals_plain(res, name):
    _close(res, name, 1e-5)


def test_dap_shard_by_shard_is_bitwise(res):
    np.testing.assert_array_equal(res["dap_dt"], res["dap_plain"])
