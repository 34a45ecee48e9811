"""The port's sharding rules against the reference's: ``param_specs`` (both
policies and the serving layout), ``batch_specs`` over every cell's inputs
and ``cache_specs`` over the decode caches, leaf for leaf, for all ten
registry configs at FULL size (JAX through ``eval_shape``, the port on the
meta device), on abstract meshes (1,1), (4,2), (16,16) and (2,16,16).  The
specs are exact: a JAX ``PartitionSpec`` is compared as the tuple of its
entries."""
import functools

import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro import sharding as jsharding
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs
from repro.models import model as jmodel
from repro_torch import sharding
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.models import model
from repro_torch.sharding.specs import AbstractMesh as TAbstractMesh
from repro_torch.sharding.specs import MeshRules, _spec_for

ARCHS = list_archs()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _jmesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _rules(mesh_key: str, policy: str):
    sizes, names = MESHES[mesh_key]
    jm, tm = _jmesh(sizes, names), TAbstractMesh(names, sizes)
    if policy == "pure_dp":
        return jsharding.MeshRules.pure_dp(jm), MeshRules.pure_dp(tm)
    if policy == "serving":
        return jsharding.MeshRules.standard(jm).as_serving(), MeshRules.standard(tm).as_serving()
    return jsharding.MeshRules.standard(jm), MeshRules.standard(tm)


def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jflat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_jpath(p): tuple(s) for p, s in leaves}


def _tflat(specs) -> dict:
    from torch.utils._pytree import tree_flatten_with_path

    from repro_torch.sharding.specs import _path_str

    return {_path_str(p): tuple(s) for p, s in tree_flatten_with_path(specs)[0]}


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return jmodel.abstract_params(jget_config(arch)), model.abstract_params(get_config(arch))


@functools.lru_cache(maxsize=None)
def _caches(arch: str, batch: int, max_len: int):
    return (jmodel.cache_specs(jget_config(arch), batch, max_len),
            model.cache_specs(get_config(arch), batch, max_len))


def _assert_same(jspecs, tspecs):
    j, t = _jflat(jspecs), _tflat(tspecs)
    assert sorted(j) == sorted(t), "the trees differ in their leaves"
    bad = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_key):
    jp, tp = _params(arch)
    for policy in ("dp_tp", "pure_dp", "serving"):
        jr, tr = _rules(mesh_key, policy)
        _assert_same(jsharding.param_specs(jp, jr), sharding.param_specs(tp, tr))


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, mesh_key):
    jr, tr = _rules(mesh_key, "dp_tp")
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name in SHAPES:
        jb = jinput_specs(jcfg, JSHAPES[name])
        tb = input_specs(tcfg, SHAPES[name])
        _assert_same(jsharding.batch_specs(jb, jr), sharding.batch_specs(tb, tr))
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        jc, tc = _caches(arch, shape.global_batch, shape.seq_len)
        _assert_same(jsharding.cache_specs(jc, jr), sharding.cache_specs(tc, tr))


def test_long_context_cache_spreads_the_sequence_over_every_axis():
    """Batch 1 cannot shard: a KV cache's sequence goes over (data, model)
    jointly, as the reference lays out distributed flash-decode."""
    _, tr = _rules("16x16", "dp_tp")
    _, tc = _caches("mixtral-8x7b", 1, 524_288)
    specs = _tflat(sharding.cache_specs(tc, tr))
    k = [v for p, v in specs.items() if p.endswith("/k")]
    assert k and all(s[2] == ("data", "model") for s in k), k


@pytest.mark.parametrize("mode", ["seq", "feature"])
def test_cache_shard_env_matches_reference(monkeypatch, mode):
    monkeypatch.setenv("REPRO_CACHE_SHARD", mode)
    for arch in ("glm4-9b", "deepseek-v2-lite-16b", "zamba2-2.7b"):
        jr, tr = _rules("16x16", "dp_tp")
        jc, tc = _caches(arch, 128, 32_768)
        _assert_same(jsharding.cache_specs(jc, jr), sharding.cache_specs(tc, tr))
    specs = _tflat(sharding.cache_specs(_caches("glm4-9b", 128, 32_768)[1], tr))
    k = next(v for p, v in specs.items() if p.endswith("/k"))
    assert k == ((None, "data", None, None, "model") if mode == "feature"
                 else (None, "data", "model", None, None))


def test_divisibility_fallback():
    rules = MeshRules.standard(TAbstractMesh(("data", "model"), (4, 2)))
    # dim 7 not divisible by 4 / dim 3 not divisible by 2 -> replicated
    assert _spec_for((7, 3), ("batch", "seq"), rules) == (None, None)
    # divisible dims shard; a dim smaller than its axis does not
    assert _spec_for((8, 4), ("batch", "seq"), rules) == ("data", "model")
    assert _spec_for((8, 0), ("batch", "seq"), rules) == ("data", None)


def test_constrain_is_noop_without_mesh_or_dtensor():
    sharding.clear_mesh()
    x = torch.ones(4, 4)
    assert sharding.constrain(x, "batch", "seq") is x
    sharding.set_mesh(TAbstractMesh(("data", "model"), (1, 1)))
    try:
        assert sharding.constrain(x, "batch", "seq") is x
        assert sharding.get_mesh().tp_axis == "model"
    finally:
        sharding.clear_mesh()
    assert sharding.get_mesh() is None


def test_set_mesh_policies_match_reference():
    for key in MESHES:
        for policy in ("dp_tp", "pure_dp"):
            sizes, names = MESHES[key]
            j = jsharding.set_mesh(_jmesh(sizes, names), policy)
            t = sharding.set_mesh(TAbstractMesh(names, sizes), policy)
            assert (j.batch_axes, j.fsdp_axis, j.tp_axis) == (t.batch_axes, t.fsdp_axis, t.tp_axis)
            for logical in ("batch", "fsdp", "tp", "seq", "vocab", None):
                assert j.resolve(logical) == t.resolve(logical)
                assert j.axis_size(j.resolve(logical)) == t.axis_size(t.resolve(logical))
    jsharding.clear_mesh()
    sharding.clear_mesh()
    with pytest.raises(ValueError):
        sharding.set_mesh(TAbstractMesh(("data",), (2,)), "zero3")
