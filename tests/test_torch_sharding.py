"""Port parity, sharding specs (no process group needed): the port's
``sharding/partition.py`` against ``repro.sharding.partition`` on stand-in
meshes (``sanitize`` only reads axis names and sizes, as
``tests/test_sharding.py`` uses it), ``batch_spec``, and the spec trees
``lm.param_specs``/``lm.cache_specs``/``encdec.param_specs`` of every
arch's smoke config against the reference's ``init_lm``/``init_encdec``
specs (taken through ``jax.eval_shape``: nothing is allocated) with each
stacked layer spec unstacked; the DTensor placements, ``local_tree``'s
slices at every coordinate, and ``init_distributed`` refusing without a
card.  The multi-rank half is ``tests/test_torch_distributed.py``."""

import dataclasses
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.sharding import partition as jpart
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.partition import P

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SPECS = [("model", "data"), (("data", "model"),), (("pod", "data"), "model"),
         (None, "model"), (("pod", "data", "model"),), ("model",), (None,), (),
         ("data", None, "model"), (("model", "data"),), ("pod", "data", None, "model")]
SHAPES = [(49155, 4096), (49408, 1024), (8,), (4,), (3,), (6,), (16, 16), (32, 12800, 4096),
          (7, 16), (2, 16, 16), (24, 32, 1024, 512), (512,)]


def _meshes(name):
    shape, names = MESHES[name]
    ref = SimpleNamespace(axis_names=names, devices=np.zeros(shape))
    port = SimpleNamespace(mesh_dim_names=names, shape=shape)
    return ref, port


def _entries(spec):
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in spec)


@pytest.mark.parametrize("mesh", MESHES)
def test_sanitize_matches_reference(mesh):
    """Every spec of the grid against every shape: absent axes dropped,
    a tuple trimmed from its end until it divides (vocab 49155 over
    model), dims past the shape replicated."""
    jmesh, tm = _meshes(mesh)
    for spec, shape in itertools.product(SPECS, SHAPES):
        want = _entries(jpart.sanitize(JP(*spec), shape, jmesh))
        got = tpart.sanitize(P(*spec), shape, tm)
        assert isinstance(got, P) and _entries(got) == want, (spec, shape)
    assert tpart.sanitize(None, (4,), tm) == P()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_spec_matches_reference(multi_pod):
    for extra in (1, 2, 3):
        want = _entries(jpart.batch_spec(multi_pod, extra))
        assert _entries(tpart.batch_spec(multi_pod, extra)) == want


def _flat(tree, prefix=""):
    """``{path: spec entries}`` of a spec tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: _entries(tree)}


def _reference_specs(jcfg):
    box = {}

    def init(key):
        init_fn = jed.init_encdec if jcfg.family == "encdec" else jlm.init_lm
        params, box["specs"] = init_fn(jcfg, key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["specs"]


def _unstacked(jspecs, n_layers: dict):
    """The reference's spec tree with each stacked subtree as a list of
    per-layer specs, the leading ``None`` layer axis dropped."""
    out = {}
    for k, v in jspecs.items():
        if k in n_layers:
            flat = _flat(v)
            assert all(e[0] is None for e in flat.values()), k
            layer = {path: e[1:] for path, e in flat.items()}
            out.update({f"/{k}/{i}{path}": e for i in range(n_layers[k])
                        for path, e in layer.items()})
        else:
            out.update(_flat(v, f"/{k}"))
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_match_reference(arch):
    """The port's spec of every leaf equals the reference's unstacked
    spec, and the spec tree has exactly the leaves of the port's dense
    ``init_params`` tree."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    if tcfg.family == "encdec":
        got = ted.param_specs(tcfg)
        stacked = {"enc_layers": jcfg.n_enc_layers, "dec_layers": jcfg.n_layers}
        tree = ted.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    else:
        got = tlm.param_specs(tcfg)
        stacked = {"layers": jcfg.n_layers}
        tree = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu", wire_dtype=None)
    want = _unstacked(_reference_specs(jcfg), stacked)
    assert _flat(got) == want
    assert set(_flat(tpart.tree_shardings(SimpleNamespace(mesh_dim_names=("data", "model"),
                                                          shape=(1, 1)), got, tree))) \
        == set(want)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_match_reference(arch, kv_dtype):
    """``lm.cache_specs`` == ``repro.models.lm.cache_specs`` (GQA window
    over model, MLA latent, scale planes, the recurrent state), and names
    exactly the planes ``lm.make_cache`` builds."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, sparsity=dataclasses.replace(jcfg.sparsity,
                                                                  kv_dtype=kv_dtype))
    tcfg = dataclasses.replace(tcfg, sparsity=dataclasses.replace(tcfg.sparsity,
                                                                  kv_dtype=kv_dtype))
    got = tlm.cache_specs(tcfg)
    assert _flat(got) == _flat(jlm.cache_specs(jcfg))
    cache = tlm.make_cache(tcfg, 2, 16, "meta")
    assert set(got) == set(cache)
    for name, spec in got.items():
        assert len(spec) == cache[name].dim(), name


def test_placements_and_tree_shardings():
    """DTensor placements: a mesh dim shards the tensor dim naming it, a
    tuple entry shards one dim over several mesh dims (in mesh order; out
    of order raises); ``tree_shardings`` sanitizes first."""
    _, m = _meshes("2x16x16")
    assert tpart.placements(m, P(("pod", "data"), None, "model")) == [Shard(0), Shard(0),
                                                                       Shard(2)]
    assert tpart.placements(m, P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tpart.placements(m, P(("model", "data")))
    sh = tpart.tree_shardings(m, {"w": P("model", ("pod", "data")), "b": [P(None), P("model")]},
                              {"w": (49155, 64), "b": [(8,), (32,)]})
    assert sh["w"].spec == P(None, ("pod", "data"))
    assert sh["w"].placements == [Shard(1), Shard(1), Replicate()]
    assert sh["b"][1].spec == P("model") and sh["b"][0].spec == P(None)


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
def test_local_tree_slices_every_coordinate(mesh):
    """``local_tree`` at every coordinate of the mesh: the shards of a
    sharded dim tile it in coordinate order (the first axis major), a
    spec covers the subtree beneath it, a missing key keeps the leaf
    whole, a non-dividing dim stays whole."""
    shape, names = MESHES[mesh]
    t = torch.arange(32 * 64 * 6, dtype=torch.float32).reshape(32, 64, 6)
    tree = {"moe": {"gate": t, "router": t[0]}, "other": [t]}
    spec = {"moe": {"gate": P("model", ("pod", "data"), "model")}}
    tiles = {}
    for coord in itertools.product(*(range(n) for n in shape)):
        rank = dict(zip(names, coord))
        m = SimpleNamespace(mesh_dim_names=names, shape=shape,
                            get_local_rank=lambda a, r=rank: r[a])
        loc = tpart.local_tree(tree, spec, m)
        assert loc["moe"]["router"] is tree["moe"]["router"] and loc["other"][0] is t
        tiles[coord] = loc["moe"]["gate"]
    n_model = dict(zip(names, shape))["model"]
    n_batch = int(np.prod([s for a, s in zip(names, shape) if a != "model"]))
    for coord, tile in tiles.items():
        rank = dict(zip(names, coord))
        b = rank.get("pod", 0) * dict(zip(names, shape)).get("data", 1) + rank["data"]
        e0, d0 = rank["model"] * (32 // n_model), b * (64 // n_batch)
        assert torch.equal(tile, t[e0:e0 + 32 // n_model, d0:d0 + 64 // n_batch])


def test_local_specs_shard_only_the_experts():
    cfg = tconfigs.get_config("granite_moe_1b_a400m", smoke=True)
    specs = tlm.local_specs(cfg)
    assert len(specs["layers"]) == cfg.n_layers
    assert set(specs["layers"][0]) == {"moe"}
    assert set(specs["layers"][0]["moe"]) == {"gate", "up", "down"}
    assert tlm.local_specs(tconfigs.get_config("granite_3_8b", smoke=True)) == {}


def test_init_distributed_needs_a_card():
    """The card is the default; without one it raises (the CPU is asked
    for with ``device="cpu"``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed()
