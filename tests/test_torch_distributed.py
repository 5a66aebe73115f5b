"""Port parity, distribution: the sequence-parallel ring decode
(``attention.flash_decode``) and the expert-parallel MoE over
``torch.distributed``, on 8 gloo ranks in a (2, 4) (data, model) mesh and
on one rank in a (1, 1) mesh, against

* the reference's own regions (``shard_map`` over 8 XLA host devices in
  the same (2, 4) mesh, run in a JAX subprocess as
  ``tests/test_distributed.py`` runs them) on the same converted weights,
  within the port's parity bound (logits at atol 1e-4, the aux loss at
  1e-6);
* the port's undistributed paths, within the reference's own bounds:
  flash-decode against ``lm.forward`` at 5e-4, expert-parallel against
  the grouped path at 1e-4.

Smoke configs in f32 (the reference test's cases): granite-3-8b, 12 decode
steps of 2 rows from an empty 16-slot ring; granite-moe-1b-a400m with 4
experts top-2 at capacity factor 16, ``lm.forward`` over 4 x 16 tokens;
each under the config's own sparsity (awdbb 4/8) and under wdbb.  Also
hymba-1.5b's and whisper-base's ring decode through flash-decode against
the port's plain ring; the b = 1 guard (``tests/test_train_loss.py``'s
case: one row cannot shard over data, so the ring stays whole and decode
takes the plain path), the collectives each region makes, and the
elastic re-placement of a checkpoint under a (2, 4) and a (4, 2) mesh.

The ranks (``_torch_dist_ranks.py``) are spawned once for the file, the
reference subprocess beside them."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_ranks as ranks
from _torch_parity import reference_params, to_np
from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro_torch.models import lm as tlm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs.base import MoEConfig
from repro.models import lm
from repro.sharding.context import use_mesh

work = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
dec = np.load(work + "/dec_tokens.npy")
moe_toks = np.load(work + "/moe_tokens.npy")
out = {}
for mode in ("own", "wdbb"):
    def cfg_of(arch, **kw):
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="float32", **kw)
        if mode == "wdbb":
            cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(cfg.sparsity, mode="wdbb"))
        return cfg
    cfg = cfg_of("granite_3_8b")
    params, _ = lm.init_lm(cfg, jax.random.PRNGKey(0))
    cache = lm.make_cache(cfg, dec.shape[0], 16)
    outs = []
    with mesh, use_mesh(mesh, batch_axes=("data",)):
        step = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg))
        for t in range(dec.shape[1]):
            lg, cache = step(params, cache, jnp.asarray(dec[:, t:t + 1]), jnp.int32(t))
            outs.append(np.asarray(lg))
    out["flash_" + mode] = np.concatenate(outs, 1)
    cfg = cfg_of("granite_moe_1b_a400m",
                 moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=16.0))
    params, _ = lm.init_lm(cfg, jax.random.PRNGKey(0))
    with mesh, use_mesh(mesh, batch_axes=("data",)):
        lg, aux = jax.jit(lambda p, t: lm.forward(p, t, cfg))(params, jnp.asarray(moe_toks))
    out["ep_" + mode] = np.asarray(lg)
    out["ep_aux_" + mode] = np.asarray(aux)
np.savez(work + "/reference.npz", **out)
"""


def _undistributed(tparams, dec, moe_toks):
    """The port on one process, no context: the flash archs' ``forward``
    and plain ring decode, the MoE grouped path at 2 groups (the (2, 4)
    mesh's data shards) and at 1 (the (1, 1) mesh's)."""
    out = {}
    with torch.no_grad():
        for mode in ranks.MODES:
            cfg = ranks.port_cfg(ranks.FLASH_ARCH, mode)
            out[f"forward_{mode}"] = to_np(tlm.forward(tparams[ranks.FLASH_ARCH], dec, cfg))
            logits, _ = ranks.decode_loop(tparams[ranks.FLASH_ARCH], cfg, dec, ranks.DEC_B)
            out[f"ring_{mode}"] = to_np(logits)
            cfg = ranks.port_cfg(ranks.MOE_ARCH, mode)
            for g in (1, 2):
                logits, aux = tlm.forward(tparams[ranks.MOE_ARCH], moe_toks,
                                          dataclasses.replace(cfg, moe_groups=g), with_aux=True)
                out[f"grouped{g}_{mode}"] = to_np(logits)
                out[f"grouped{g}_aux_{mode}"] = to_np(aux)
        cfg = ranks.port_cfg(ranks.FLASH_ARCH, "own")
        logits, _ = ranks.decode_loop(tparams[ranks.FLASH_ARCH], cfg, dec[:1], 1)
        out["ring_b1"] = to_np(logits)
        for arch in ranks.OTHER_ARCHS:
            out[f"other_{arch}"] = to_np(ranks.other_decode(arch)[0])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, once: the reference subprocess and the 8-rank spawn run
    side by side, then the (1, 1) spawn and the undistributed port."""
    work = str(tmp_path_factory.mktemp("dist"))
    tparams, vocab = {}, {}
    for arch in (ranks.FLASH_ARCH, ranks.MOE_ARCH):
        jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype="float32")
        if arch == ranks.MOE_ARCH:
            jcfg = dataclasses.replace(jcfg, moe=JMoEConfig(**dataclasses.asdict(ranks.MOE)))
        _, tparams[arch] = reference_params(jcfg, seed=0)
        vocab[arch] = jcfg.vocab
    rng = np.random.default_rng(1)
    dec = rng.integers(0, vocab[ranks.FLASH_ARCH], (ranks.DEC_B, ranks.DEC_S)).astype(np.int32)
    moe_toks = rng.integers(0, vocab[ranks.MOE_ARCH], (ranks.MOE_B, ranks.MOE_S)).astype(np.int32)
    np.save(os.path.join(work, "dec_tokens.npy"), dec)
    np.save(os.path.join(work, "moe_tokens.npy"), moe_toks)
    dec_t, moe_t = torch.from_numpy(dec), torch.from_numpy(moe_toks)
    torch.save(dict(tparams, dec_tokens=dec_t, moe_tokens=moe_t),
               os.path.join(work, "inputs.pt"))

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, work], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for shape in ((2, 4), (1, 1)):
            world = shape[0] * shape[1]
            mp.start_processes(ranks.run, args=(world, work, shape), nprocs=world,
                               start_method="spawn")
        port = _undistributed(tparams, dec_t, moe_t)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    load = lambda name: dict(np.load(os.path.join(work, name)))  # noqa: E731
    return dict(ref=load("reference.npz"), p24=load("port_2x4.npz"), p11=load("port_1x1.npz"),
                port=port)


def _close(got, want, atol, what):
    v = min(got.shape[-1], want.shape[-1])
    np.testing.assert_allclose(got[..., :v], want[..., :v], atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("mode", ranks.MODES)
def test_flash_decode_matches_reference_region(runs, mode):
    """The port's flash-decode loop on the (2, 4) mesh == the reference's
    ``flash_decode`` under ``shard_map`` on the same mesh and weights."""
    _close(runs["p24"][f"flash_{mode}"], runs["ref"][f"flash_{mode}"], 1e-4, mode)


@pytest.mark.parametrize("mesh", ["p24", "p11"])
@pytest.mark.parametrize("mode", ranks.MODES)
def test_flash_decode_matches_forward_and_ring(runs, mode, mesh):
    """Flash-decode (window-sharded ring) against the port's cache-less
    ``forward`` within the reference's 5e-4, and against its plain ring
    decode within the parity bound; the ring was built sharded."""
    got, port = runs[mesh][f"flash_{mode}"], runs["port"]
    _close(got, port[f"forward_{mode}"], 5e-4, f"{mesh} {mode} vs forward")
    _close(got, port[f"ring_{mode}"], 1e-4, f"{mesh} {mode} vs plain ring")
    assert bool(runs[mesh][f"flash_sharded_{mode}"])
    n_data, n_model = (2, 4) if mesh == "p24" else (1, 1)
    want = (2, ranks.DEC_B // n_data, ranks.MAX_SEQ // n_model, 128 // 4 * 2)
    assert tuple(runs[mesh][f"flash_cache_shape_{mode}"]) == want


@pytest.mark.parametrize("mesh", ["p24", "p11"])
@pytest.mark.parametrize("arch", ranks.OTHER_ARCHS)
def test_flash_decode_other_families(runs, arch, mesh):
    """hymba-1.5b (its ring window-sharded, its recurrent state whole) and
    whisper-base's decoder (``encdec.decode_step``) decode through
    ``flash_decode`` under a context, within the parity bound of the
    port's plain ring decode."""
    assert bool(runs[mesh][f"other_sharded_{arch}"])
    _close(runs[mesh][f"other_{arch}"], runs["port"][f"other_{arch}"], 1e-4, f"{arch} {mesh}")


@pytest.mark.parametrize("mode", ranks.MODES)
def test_expert_parallel_matches_reference_region(runs, mode):
    """The port's expert-parallel ``lm.forward`` on the (2, 4) mesh == the
    reference's ``_moe_forward_shard_map``: logits within 1e-4, the aux
    loss (averaged over every rank) within 1e-6."""
    p24, ref = runs["p24"], runs["ref"]
    _close(p24[f"ep_{mode}"], ref[f"ep_{mode}"], 1e-4, mode)
    np.testing.assert_allclose(p24[f"ep_aux_{mode}"], ref[f"ep_aux_{mode}"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", ["p24", "p11"])
@pytest.mark.parametrize("mode", ranks.MODES)
def test_expert_parallel_matches_grouped(runs, mode, mesh):
    """Expert-parallel against the port's grouped path with one group a
    data shard, within the reference's 1e-4; on one rank the aux loss is
    the grouped path's too (1e-6)."""
    port = runs["port"]
    g = 2 if mesh == "p24" else 1
    _close(runs[mesh][f"ep_{mode}"], port[f"grouped{g}_{mode}"], 1e-4, f"{mesh} {mode}")
    if mesh == "p11":
        np.testing.assert_allclose(runs[mesh][f"ep_aux_{mode}"], port[f"grouped1_aux_{mode}"],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", ["p24", "p11"])
def test_collectives_per_region(runs, mesh):
    """The collectives each region makes, counted by the context: a decode
    step's layer reduces three times over model (the max, l, the output:
    ``[B_l, KV, G]``-sized) and gathers its output once over data; a MoE
    layer exchanges its dispatch buffer twice (``[E, C, d]`` f32) and
    reduces its aux over data and model."""
    r = runs[mesh]
    n_data, n_model = (2, 4) if mesh == "p24" else (1, 1)
    layers, steps = 2, ranks.DEC_S
    b_l, kv, g = ranks.DEC_B // n_data, 2, 2
    for mode in ranks.MODES:
        calls, nbytes = r[f"flash_all_reduce_{mode}"]
        assert calls == 3 * layers * steps
        assert nbytes == layers * steps * 4 * b_l * kv * g * (1 + 1 + 32)  # m, l, o (dv 32)
        assert tuple(r[f"flash_all_gather_{mode}"]) == (layers * steps,
                                                        layers * steps * 4 * b_l * 4 * 32)
        assert "flash_all_to_all_" + mode not in r
        t_l = ranks.MOE_B // n_data * ranks.MOE_S // n_model
        cap = max(8, -(-t_l * 2 // 4 * 16) // 8 * 8)
        assert tuple(r[f"ep_all_to_all_{mode}"]) == (2 * layers, 2 * layers * 4 * cap * 128 * 4)
        assert r[f"ep_all_reduce_{mode}"][0] == 2 * layers


@pytest.mark.parametrize("mesh", ["p24", "p11"])
def test_flash_decode_guard_batch_1(runs, mesh):
    """b = 1 under the (2, 4) mesh: the ring stays whole and decode takes
    the plain ring path, no collective made, the logits those of the port
    without a context.  Under (1, 1) one row shards (trivially), as the
    reference's guard says."""
    r = runs[mesh]
    assert bool(r["guard_b1_sharded"]) == (mesh == "p11")
    if mesh == "p24":
        assert int(r["guard_b1_collectives"]) == 0
        np.testing.assert_array_equal(r["guard_b1"], runs["port"]["ring_b1"])
    else:
        _close(r["guard_b1"], runs["port"]["ring_b1"], 1e-4, "b1 (1, 1)")


def test_meshes_and_local_experts(runs):
    """``make_host_mesh`` is (1, world); ``make_production_mesh`` raises
    off 256 ranks; ``local_tree`` holds a rank's 4 / 4 experts."""
    for mesh, world in (("p24", 8), ("p11", 1)):
        assert tuple(runs[mesh]["host_mesh"]) == (1, world)
        assert bool(runs[mesh]["production_raises"])
    assert tuple(runs["p24"]["expert_shape"]) == (1, 128, 64)  # [E / 4, d, f]
    assert tuple(runs["p11"]["expert_shape"]) == (4, 128, 64)


def test_elastic_replacement(runs):
    """A checkpoint's host leaves placed under a (2, 4) and a (4, 2) mesh:
    every leaf's ``full_tensor()`` equals the saved one, and the spec
    trees shard some of them."""
    r = runs["p24"]
    assert bool(r["elastic_ok"])
    assert int(r["elastic_sharded_leaves"]) > 0
