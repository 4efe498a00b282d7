"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the JAX package's, placement for placement.

Meshes are ``jax.sharding.AbstractMesh``es on the JAX side (no devices:
``param_spec`` reads only the axis sizes) and
``repro_torch.launch.mesh.MeshShape``s on the port's, at (2, 2), (1, 4),
(16, 16) and (2, 16, 16). For every architecture of the registry, full and
reduced, every parameter, train-state, batch and cache leaf (dense and
paged layouts) gets the same spec from both: the port's tuple equals
``tuple(PartitionSpec)``. The leaves come from JAX's ``eval_shape`` trees
(no weights are drawn). No processes; seconds in all.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.parallel import sharding as jsh
from repro.runtime.trainer import abstract_train_state
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.parallel import sharding as psh

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = [(a, r) for a in sorted(ARCHS) for r in (False, True)]


def _cfgs(arch, reduced):
    j, p = JARCHS[arch], get_config(arch)
    return (j.reduced(), p.reduced()) if reduced else (j, p)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_str(path): leaf for path, leaf in leaves}


_TREES = {}


def _trees(arch, reduced):
    """JAX's abstract train state (with the error buffer) and caches."""
    key = (arch, reduced)
    if key not in _TREES:
        jcfg, _ = _cfgs(arch, reduced)
        model = jbuild(jcfg, jpolicy("mirage"))
        state = abstract_train_state(model, JTrainConfig(
            policy=jpolicy("mirage"), grad_compression="bfp"))
        if jcfg.is_encdec:
            caches = {"dense": model.cache_spec(4, 64, 32)}
        else:
            caches = {"dense": model.cache_spec(4, 64),
                      "slots": model.cache_spec(4, 64, per_slot_idx=True)}
            if jcfg.family != "ssm":
                caches["paged"] = model.cache_spec(4, 64, layout="paged",
                                                   block_size=16)
        caches = {k: {n: jax.ShapeDtypeStruct(*sd) for n, sd in c.items()}
                  for k, c in caches.items()}
        _TREES[key] = (state, caches)
    return _TREES[key]


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), pmesh.MeshShape(shape, names)


def _specs(shardings):
    return {k: tuple(v.spec) for k, v in _flat(shardings).items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,reduced", VARIANTS)
def test_param_and_train_state_specs_equal_jax(arch, reduced, mesh):
    jcfg, pcfg = _cfgs(arch, reduced)
    jm, pm = _meshes(mesh)
    state, _ = _trees(arch, reduced)
    flat = {k: tuple(v.shape) for k, v in _flat(state).items()}
    want = _specs(jsh.train_state_shardings(jm, jcfg, state))
    got = psh.train_state_shardings(pm, pcfg, flat)
    assert got == want
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    want_p = _specs(jsh.param_shardings(jm, jcfg, state["params"]))
    assert psh.param_shardings(pm, pcfg, params) == want_p
    for path, shape in params.items():
        assert psh.param_spec(pm, pcfg, path, shape) == \
            tuple(jsh.param_spec(jm, jcfg, path, shape))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,reduced", VARIANTS)
def test_batch_cache_and_serve_specs_equal_jax(arch, reduced, mesh):
    jcfg, pcfg = _cfgs(arch, reduced)
    jm, pm = _meshes(mesh)
    _, caches = _trees(arch, reduced)
    batch = {"tokens": jax.ShapeDtypeStruct((32, 64), "int32"),
             "labels": jax.ShapeDtypeStruct((32, 64), "int32"),
             "patches": jax.ShapeDtypeStruct((32, 8, 16), "float32"),
             "frames": jax.ShapeDtypeStruct((6, 64, 16), "float32")}
    for tree in [batch] + list(caches.values()):
        flat = {k: tuple(v.shape) for k, v in _flat(tree).items()}
        assert psh.batch_shardings(pm, pcfg, flat) == \
            _specs(jsh.batch_shardings(jm, jcfg, tree))
        for name, shape in flat.items():
            if name not in batch:
                assert psh.cache_spec(pm, pcfg, name, shape) == \
                    tuple(jsh.cache_spec(jm, jcfg, name, shape))
    for cache in caches.values():
        serve = {"cache": cache,
                 "last_tok": jax.ShapeDtypeStruct((4,), "int32"),
                 "active": jax.ShapeDtypeStruct((4,), "bool"),
                 "health": {"flips": jax.ShapeDtypeStruct((), "int32"),
                            "per_channel": jax.ShapeDtypeStruct((8,),
                                                                "int32")},
                 "rng": jax.ShapeDtypeStruct((2,), "uint32")}
        flat = {k: tuple(v.shape) for k, v in _flat(serve).items()}
        assert psh.serve_state_shardings(pm, pcfg, flat) == \
            _specs(jsh.serve_state_shardings(jm, jcfg, serve))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kv_repeat_and_block_shards_equal_jax(mesh):
    jm, pm = _meshes(mesh)
    for arch in sorted(ARCHS):
        for reduced in (False, True):
            jcfg, pcfg = _cfgs(arch, reduced)
            assert psh.kv_repeat_for(pcfg, pm) == jsh.kv_repeat_for(jcfg, jm)
    for nb, ns in ((64, 8), (63, 8), (64, 6), (512, 32), (8, 2)):
        assert psh.serve_block_shards(pm, nb, ns) == \
            jsh.serve_block_shards(jm, nb, ns)
    assert psh.dp_axes(pm) == jsh.dp_axes(jm)
    assert psh.tp_size(pm) == jsh.tp_size(jm)
    assert psh.replicated(pm) == tuple(jsh.replicated(jm).spec)


def test_mesh_shapes():
    """The production and debug mesh shapes of the JAX package's
    ``launch.mesh``, without devices (the DeviceMesh factories need one
    rank each: the distributed tests build them)."""
    assert pmesh.production_shape() == pmesh.MeshShape(
        (16, 16), ("data", "model"))
    assert pmesh.production_shape(multi_pod=True).size == 512
    assert pmesh.debug_shape(2, 2, pods=2).mesh_dim_names == \
        ("pod", "data", "model")


def test_rules_import_no_jax():
    import subprocess
    import sys
    code = ("import sys; import repro_torch.parallel.sharding, "
            "repro_torch.launch.mesh, repro_torch.parallel.shard; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    import os
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    assert subprocess.run([sys.executable, "-c", code], env=env).returncode \
        == 0
