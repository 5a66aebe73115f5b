"""Port parity, the dry-run analysis: ``repro_torch.configs``' shape cells,
``launch/roofline.py``, ``launch/specs.py`` and ``launch/dryrun.py``.

Equal to the reference exactly, at full width and abstract (fake
tensors on the port's side, ``jax.eval_shape`` on the reference's):
``SHAPES``, ``shape_by_name``, ``applicable_shapes``,
``active_param_count`` and ``model_flops`` for every arch and cell; the
global shapes, dtypes and sanitized specs of ``abstract_model_state``
(with the AdamW state), ``serving_specs`` and ``packed_state`` (the last
at two layers: packing is per layer), leaf by leaf through
``core/tree.py``; the ``Roofline`` terms with the reference's constants.

Held by construction, on a fake process group started and destroyed by
each test (:func:`fake_group` refuses when a group exists): at world
size 1 a trace's flops are ``FlopCounterMode``'s over the plain
forward and it moves no collective byte; the 1- and 2-layer correction
equals a direct 4-layer trace in integer counts; rank 0's argument bytes
are the local shards ``partition.local_tree`` gives; and a packed
decode, an MoE train step, the flash-decode region and a ``long_500k``
decode trace."""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.sharding import partition as jpart
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import tree
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.partition import P

ARCHS = tconfigs.ARCH_IDS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks for the ``with`` block;
    refuses when this process has a group already."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists in this process; the dry-run needs its own")
    dryrun.ensure_fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- shape cells, counts


def test_shapes_equal_reference():
    assert [tuple(vars(s).values()) for s in tbase.SHAPES] == [
        tuple(vars(s).values()) for s in jbase.SHAPES]
    for s in jbase.SHAPES:
        assert tuple(vars(tbase.shape_by_name(s.name)).values()) == tuple(vars(s).values())
    with pytest.raises(KeyError):
        tbase.shape_by_name("train_8k")
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_and_model_flops_equal_reference(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert [s.name for s in tconfigs.applicable_shapes(arch)] == [
        s.name for s in jconfigs.applicable_shapes(arch)]
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for s in tconfigs.applicable_shapes(arch):
        assert roofline.model_flops(tcfg, s) == jroof.model_flops(jcfg, jbase.shape_by_name(s.name))


COUNTS = [(1e15, 1e12, 1e9), (1e12, 1e13, 1e9), (1e12, 1e10, 1e12), (0.0, 0.0, 0.0)]


@pytest.mark.parametrize("flops,byts,coll", COUNTS)
def test_roofline_terms_equal_reference_with_its_constants(monkeypatch, flops, byts, coll):
    breakdown = {k: coll / 5 for k in roofline.COLLECTIVES}
    calls = {k: 1 for k in roofline.COLLECTIVES}
    for name, val in (("PEAK_FLOPS", jroof.PEAK_FLOPS), ("HBM_BW", jroof.HBM_BW),
                      ("LINK_BW", jroof.ICI_BW)):
        monkeypatch.setattr(roofline, name, val)
    mine = roofline.Roofline(flops, byts, coll, dict(breakdown), dict(calls))
    ref = jroof.Roofline(flops, byts, coll, dict(breakdown), dict(calls))
    assert mine.as_dict() == ref.as_dict()
    assert mine.t_bound == ref.t_bound and mine.bottleneck == ref.bottleneck


def test_roofline_peaks_are_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert tuple(roofline.COLLECTIVES) == jroof._COLLECTIVES


# ------------------------------------------------------------- spec trees


def _jmesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _tmesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def _entries(spec, ndim):
    ent = [tuple(a) if isinstance(a, (tuple, list)) else a for a in spec]
    return tuple(ent + [None] * (ndim - len(ent)))


def _ref_leaves(t, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]
    return {"/".join(str(k.key) for k in path): v for path, v in flat}


def _check_tree(port, port_specs, ref, ref_specs):
    """Every reference leaf once: its stacked shape and dtype, and its
    spec sanitized on both production meshes."""
    jleaves = _ref_leaves(ref)
    jspec = _ref_leaves(ref_specs, is_leaf=lambda s: isinstance(s, JP))
    groups = tree.groups(port)
    spec_groups = {"/".join(g.path): g.pieces[0] for g in tree.groups(port_specs)}
    assert sorted("/".join(g.path) for g in groups) == sorted(jleaves)
    for g in groups:
        key = "/".join(g.path)
        piece = g.pieces[0]
        shape = ((len(g.pieces),) if g.stacked else ()) + tuple(piece.shape)
        assert shape == tuple(jleaves[key].shape), key
        assert str(piece.dtype).split(".")[-1] == str(jleaves[key].dtype), key
        assert all(tuple(p.shape) == tuple(piece.shape) and p.dtype == piece.dtype
                   for p in g.pieces), key
        for mesh in MESHES:
            want = _entries(jpart.sanitize(jspec[key], shape, _jmesh(mesh)), len(shape))
            got = _entries(tpart.sanitize(spec_groups[key], tuple(piece.shape), _tmesh(mesh)),
                           piece.ndim)
            assert got == (want[1:] if g.stacked else want), (key, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_model_state_equals_reference(arch):
    params, p_specs, opt, o_specs = specs.abstract_model_state(tconfigs.get_config(arch), True)
    jparams, jp_specs, jopt, jo_specs = jspecs.abstract_model_state(
        jconfigs.get_config(arch), with_opt=True)
    assert all(getattr(t, "fake_mode", None) is specs.fake_mode() for t in tree.leaves(params))
    _check_tree(params, p_specs, jparams, jp_specs)
    _check_tree(opt.mu, o_specs.mu, jopt.mu, jo_specs.mu)
    _check_tree(opt.nu, o_specs.nu, jopt.nu, jo_specs.nu)
    assert tuple(opt.step.shape) == tuple(jopt.step.shape) and opt.step.dtype == torch.int32
    _check_tree(params, specs.serving_specs(p_specs), jparams, jspecs.serving_specs(jp_specs))


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_state_equals_reference(arch):
    """Two layers at full width (each layer packs alone)."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    tcfg, jcfg = dryrun.with_layers(tcfg, 2), dryrun.with_layers(jcfg, 2)
    params, p_specs = specs.abstract_model_state(tcfg, with_opt=False)
    packed, pk_specs = specs.packed_state(tcfg, params, specs.serving_specs(p_specs))
    jparams, jp_specs = jspecs.abstract_model_state(jcfg, with_opt=False)
    jpacked, jpk_specs = jspecs.packed_state(jcfg, jparams, jspecs.serving_specs(jp_specs))
    _check_tree(packed, pk_specs, jpacked, jpk_specs)


def test_decode_and_batch_specs_equal_reference():
    for arch in ("granite_3_8b", "minicpm3_4b", "hymba_1_5b", "qwen2_vl_72b", "whisper_base"):
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for multi_pod in (False, True):
            for build, cell in ((specs.decode_specs, "decode_32k"),
                                (specs.train_batch_specs, "train_4k"),
                                (specs.prefill_specs, "prefill_32k")):
                mine, mine_s = build(tcfg, tbase.shape_by_name(cell), multi_pod)
                jbuild = getattr(jspecs, build.__name__)
                ref, ref_s = jbuild(jcfg, jbase.shape_by_name(cell), multi_pod)
                jl = _ref_leaves(ref)
                js = _ref_leaves(ref_s, is_leaf=lambda s: isinstance(s, JP))
                tl = {"/".join(g.path): g.pieces[0] for g in tree.groups(mine)}
                ts = {"/".join(g.path): g.pieces[0] for g in tree.groups(mine_s)}
                assert sorted(tl) == sorted(jl), (arch, cell)
                for k, t in tl.items():
                    assert tuple(t.shape) == tuple(jl[k].shape), (arch, cell, k)
                    assert str(t.dtype).split(".")[-1] == str(jl[k].dtype), (arch, cell, k)
                    assert _entries(ts[k], t.ndim) == _entries(js[k], t.ndim), (arch, cell, k)


# ------------------------------------------------------------ the traces


def _flops_of_plain_forward(cfg, tokens_shape):
    params, _ = specs.abstract_model_state(cfg, with_opt=False)
    tokens = specs.sds(tokens_shape, torch.int32)
    counter = FlopCounterMode(display=False)
    with specs.fake_mode(), counter:
        lm.forward(params, tokens, cfg)
    return counter.get_total_flops()


def test_world_size_one_is_the_plain_forward():
    cfg = dryrun.with_layers(tconfigs.get_config("granite_3_8b"), 2)
    cell = tbase.shape_by_name("prefill_32k")
    with fake_group(1):
        tr = dryrun.trace_step(cfg, cell, make_host_mesh(), False)
    assert tr.counts.flops == _flops_of_plain_forward(cfg, (cell.global_batch, cell.seq_len))
    assert sum(tr.counts.coll_bytes.values()) == 0


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m"])
def test_layer_correction_equals_a_four_layer_trace(arch):
    cell = tbase.shape_by_name("prefill_32k")
    cfg4 = dryrun.with_layers(tconfigs.get_config(arch), 4)
    with fake_group(256):
        res = dryrun.trace_cell(arch, cell.name, False, cfg_override=cfg4)
        direct = dryrun.trace_step(dryrun.cell_config(cfg4, cell, False), cell,
                                   make_production_mesh(), False)
    rl = res["roofline"]
    assert rl["flops_per_device"] == direct.counts.flops > 0
    assert rl["bytes_per_device"] == direct.counts.bytes_hbm
    assert rl["coll_breakdown"] == {k: direct.counts.coll_bytes.get(k, 0)
                                    for k in roofline.COLLECTIVES}
    assert res["memory"]["argument_bytes"] == direct.argument_bytes


def _local_bytes(t, spec_tree, mesh):
    return sum(x.numel() * x.element_size()
               for x in tree.leaves(tpart.local_tree(t, spec_tree, mesh)))


def test_argument_bytes_are_the_local_shards():
    """granite-3-8b ``train_4k`` at (16, 16): params, both AdamW moments,
    the batch (and the 4-byte step), each rank's shards only."""
    cfg = tconfigs.get_config("granite_3_8b")
    cell = tbase.shape_by_name("train_4k")
    with fake_group(256):
        res = dryrun.trace_cell("granite_3_8b", cell.name, False)
        mesh = make_production_mesh()
        params, p_specs, opt, o_specs = specs.abstract_model_state(cfg, with_opt=True)
        batch, b_specs = specs.train_batch_specs(cfg, cell, False)
        with specs.fake_mode():
            want = (_local_bytes(params, p_specs, mesh) + _local_bytes(opt.mu, o_specs.mu, mesh)
                    + _local_bytes(opt.nu, o_specs.nu, mesh) + _local_bytes(batch, b_specs, mesh)
                    + 4)
    whole = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    assert res["memory"]["argument_bytes"] == want
    assert want < whole / 16
    assert res["n_devices"] == 256 and res["mesh"] == "single"
    assert res["model_flops_per_device"] == roofline.model_flops(cfg, cell) / 256


@pytest.mark.parametrize("arch,shape,multi,tags", [
    ("granite_3_8b", "decode_32k", False, "packed"),
    ("granite_moe_1b_a400m", "train_4k", False, ""),
    ("starcoder2_15b", "long_500k", True, ""),
    ("granite_3_8b", "decode_32k", False, ""),
])
def test_cells_trace(arch, shape, multi, tags):
    with fake_group(512 if multi else 256):
        res = dryrun.trace_cell(arch, shape, multi, extra_tags=tags)
    rl = res["roofline"]
    assert res["tags"] == tags and res["n_devices"] == (512 if multi else 256)
    assert rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    if (arch, shape, tags) == ("granite_3_8b", "decode_32k", ""):
        # the window-sharded ring decodes through flash_decode: its three
        # reductions a layer are counted
        assert rl["coll_breakdown"]["all-reduce"] > 0
    assert dryrun.cell_id(arch, shape, res["mesh"], None, tags) == (
        f"{arch}_{shape}_{res['mesh']}" + (f"_{tags}" if tags else ""))


def test_fake_group_refuses_a_second_group():
    with fake_group(4):
        with pytest.raises(RuntimeError):
            dryrun.ensure_fake_group(8)
        with pytest.raises(RuntimeError):
            with fake_group(4):
                pass
    assert not dist.is_initialized()


def test_spec_is_the_port_partition_spec():
    assert isinstance(specs.serving_specs({"w": P("data", "model")})["w"], P)
