"""The port's sharding rules, mesh-free specs and cell specs against the
JAX package's.

The port's param trees keep one dict per layer where the reference stacks
``(n_groups, ...)`` (``repro_torch.convert``), so a port leaf
``layers/3/...`` stands for leaf ``[g]`` of the reference's
``layers/j/...`` (``3 = g * per + j``), zamba2's ``loras/g/...`` for
``loras/...``, and its spec must equal the reference's with the stacked
(leading) dim dropped.  Full trees are built under ``FakeTensorMode``
(the port) and with ``jax.eval_shape`` (the reference).  The reference's
``shardings`` run on a plain ``jax.sharding.Mesh`` of 8 forced host
devices, (2, 4), in a subprocess; the rest of the reference is mesh-free
and runs here.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro.models import get_model as ref_get_model
from repro.runtime import sharding as ref_sharding

from repro_torch import configs
from repro_torch.convert import _stacks
from repro_torch.launch import specs
from repro_torch.models import get_model
from repro_torch.runtime import sharding
from repro_torch.tree import tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = configs.ARCHS


class MeshStub:
    def __init__(self, **shape):
        self.shape = shape


def _port_tree(arch: str, smoke: bool, what: str = "params", *args):
    cfg = configs.get_config(arch, smoke=smoke)
    with FakeTensorMode():
        model = get_model(cfg, device="cpu")
        if what == "params":
            return cfg, model.init_params(0)
        return cfg, model.init_cache(*args)


def _ref_tree(arch: str, smoke: bool):
    model = ref_get_model(ref_configs.get_config(arch, smoke=smoke))
    return jax.eval_shape(model.init_params, jax.random.key(0))


def _ref_path(cfg, path: tuple) -> tuple[str, bool]:
    """(the reference's path string of a port leaf, whether the reference
    stacks it)."""
    stacks = _stacks(cfg)
    if path[0] in stacks and isinstance(path[1], int):
        per = stacks[path[0]][1]
        return "/".join(map(str, (path[0], path[1] % per) + path[2:])), True
    if path[0] == "loras":
        return "/".join(map(str, (path[0],) + path[2:])), True
    return "/".join(map(str, path)), False


def _ref_specs(tree) -> dict:
    return {ref_sharding._path_str(p): (tuple(leaf.shape), ref_sharding
                                        .spec_for(ref_sharding._path_str(p),
                                                  tuple(leaf.shape)))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference_on_every_leaf(arch, smoke):
    cfg, tree = _port_tree(arch, smoke)
    ref = _ref_specs(_ref_tree(arch, smoke))
    seen = set()
    for path, leaf in tree_paths(tree):
        rpath, stacked = _ref_path(cfg, path)
        rshape, rspec = ref[rpath]
        want = tuple(rspec)[1:] if stacked else tuple(rspec)
        assert tuple(leaf.shape) == (rshape[1:] if stacked else rshape)
        got = sharding.spec_for(sharding._path_str(path), tuple(leaf.shape))
        assert tuple(got) == want, (path, got, want)
        seen.add(rpath)
    assert seen == set(ref)


_REF_SHARDINGS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.launch.specs import infer_param_shardings
from repro.models import get_model
from repro.runtime.sharding import _path_str, shardings
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {}
for arch in configs.ARCHS:
    for smoke in (True, False):
        model = get_model(configs.get_config(arch, smoke=smoke))
        tree = jax.eval_shape(model.init_params, jax.random.key(0))
        sh = shardings(tree, mesh)
        inf = infer_param_shardings(sh)
        flat = jax.tree_util.tree_flatten_with_path(sh)[0]
        iflat = jax.tree.leaves(inf)
        out[f"{arch}|{smoke}"] = {
            _path_str(p): [list(ns.spec), list(i.spec)]
            for (p, ns), i in zip(flat, iflat)}
json.dump(out, open(sys.argv[1], "w"))
"""


def _listed(spec) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


@pytest.fixture(scope="module")
def ref_shardings(tmp_path_factory):
    out = tmp_path_factory.mktemp("shardings") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REF_SHARDINGS, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_reference_on_a_2x4_mesh(ref_shardings, arch, smoke):
    """The divisibility fix (an axis dropped where the dim is not a
    multiple of it, or smaller) and ``infer_param_shardings`` on every
    leaf, against the reference's ``NamedSharding``s on a (2, 4) mesh."""
    cfg, tree = _port_tree(arch, smoke)
    ref = ref_shardings[f"{arch}|{smoke}"]
    mesh = MeshStub(data=2, model=4)
    sh = sharding.shardings(tree, mesh)
    inf = specs.infer_param_shardings(sh)
    for (path, ns), (_, ins) in zip(tree_paths(sh), tree_paths(inf)):
        rpath, stacked = _ref_path(cfg, path)
        want, iwant = ref[rpath]
        if stacked:
            want, iwant = want[1:], iwant[1:]
        assert _listed(ns.spec) == want, (path, ns.spec, want)
        assert _listed(ins.spec) == iwant, (path, ins.spec, iwant)


def test_placements_follow_the_spec():
    """A spec's DTensor placements: ``Shard(dim)`` on each mesh dim the
    spec names, batch axes over both, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
    ns = sharding.NamedSharding(Mesh3(), sharding.P(("pod", "data"), None,
                                                    "model"))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    ns = sharding.NamedSharding(Mesh3(), sharding.P(None, "data"))
    assert ns.placements == (Replicate(), Shard(1), Replicate())
    assert sharding.batch_spec(MeshStub(pod=2, data=16, model=16)) == \
        sharding.P(("pod", "data"))
    assert sharding.batch_spec(MeshStub(data=16, model=16)) == \
        sharding.P("data")


MESH_STUBS = {"single": dict(data=16, model=16),
              "multi": dict(pod=2, data=16, model=16),
              "small": dict(data=2, model=4)}


@pytest.mark.parametrize("mesh", MESH_STUBS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_for_matches_reference(arch, mesh):
    """Every leaf of the port's and of the reference's cache trees, at
    each assigned shape, through both ``cache_spec_for``s."""
    stub = MeshStub(**MESH_STUBS[mesh])
    rcfg = ref_configs.get_config(arch)
    rmodel = ref_get_model(rcfg)
    for shape in configs.SHAPES.values():
        bs, seq = shape.global_batch, shape.seq_len
        cfg, cache = _port_tree(arch, False, "cache", bs, seq)
        rcache = jax.eval_shape(lambda: rmodel.init_cache(bs, seq))
        leaves = [(sharding._path_str(p), tuple(t.shape))
                  for p, t in tree_paths(cache)]
        leaves += [(ref_sharding._path_str(p), tuple(t.shape))
                   for p, t in jax.tree_util.tree_flatten_with_path(
                       rcache)[0]]
        for path, shp in leaves:
            got = specs.cache_spec_for(path, shp, cfg, stub)
            want = ref_specs.cache_spec_for(path, shp, rcfg, stub)
            assert tuple(got) == tuple(want), (shape.name, path, got, want)


def test_cache_spec_prefers_heads_then_seq():
    """The reference test's two cases (``tests/test_launch.py``)."""
    stub = MeshStub(data=16, model=16)
    cfg = configs.get_config("command-r-plus-104b")
    assert tuple(specs.cache_spec_for(
        "layers/3/k", (128, 8, 32768, 128), cfg, stub)) == \
        ("data", None, "model", None)
    cfg2 = configs.get_config("deepseek-moe-16b")
    assert tuple(specs.cache_spec_for(
        "layers/3/k", (128, 16, 32768, 128), cfg2, stub)) == \
        ("data", "model", None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_auto_policy_matches_reference(arch):
    for name, shape in configs.SHAPES.items():
        want = ref_specs.serve_auto_policy(ref_configs.get_config(arch),
                                           ref_configs.SHAPES[name])
        assert specs.serve_auto_policy(configs.get_config(arch),
                                       shape) == want


def test_configs_cells_match_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert {k: tuple(vars(v).values()) for k, v in configs.SHAPES.items()} \
        == {k: tuple(vars(v).values())
            for k, v in ref_configs.SHAPES.items()}
    assert configs.cells(include_skipped=True) == \
        ref_configs.cells(include_skipped=True)
    assert configs.cells() == ref_configs.cells()
    assert len(configs.cells(include_skipped=True)) == 40
    for a, s, ok, why in configs.cells(include_skipped=True):
        assert configs.applicable(a, s) == ref_configs.applicable(a, s)
