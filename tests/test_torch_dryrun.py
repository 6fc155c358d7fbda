"""The port's dry-run (``launch.dryrun``) on fake process groups.

The reference's four mini cells (``tests/test_launch.py``: qwen3 and
whisper train steps at 8 x 64, qwen3 and mamba2 decode steps with a cache
of 64, all at full width and depth, with the batch over ``data`` and the
sequence over ``model``) run on a fake (2, 4) group; one full cell,
command-r-plus-104b ``train_4k`` (forward, backward and AdamW at 256 x
4096 over 64 layers), on the fake (16, 16) production group, and its bytes
a rank holds equal the sums of the reference's shard shapes under the same
rules on a plain (16, 16) ``jax.sharding.Mesh`` of 256 forced host devices
(a subprocess).  The cells run on meta tensors: nothing of their size is
allocated.
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_group_left():
    """Each cell starts its own fake group; none outlives its test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


MINI = [("qwen3-0.6b", "mini_train"), ("whisper-base", "mini_train"),
        ("qwen3-0.6b", "mini_decode"), ("mamba2-2.7b", "mini_decode")]


@pytest.fixture
def mini_mesh(monkeypatch):
    monkeypatch.setitem(configs.SHAPES, "mini_train",
                        configs.ShapeSpec("mini_train", "train", 64, 8))
    monkeypatch.setitem(configs.SHAPES, "mini_decode",
                        configs.ShapeSpec("mini_decode", "decode", 64, 8))
    init_fake(8)
    return init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch,shape", MINI, ids=[f"{a}-{s}" for a, s in MINI])
def test_mini_cells_run_on_a_fake_2x4_group(mini_mesh, arch, shape):
    rec = dryrun.run_cell(arch, shape, "mini", microbatches=2,
                          mesh=mini_mesh,
                          activations=(("data",), "model", None, None))
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    held = rec["bytes_per_rank"]
    assert held["params"] > 0 and held["batch"] > 0
    assert ("opt_state" in held) == (shape == "mini_train")
    assert ("cache" in held) == (shape == "mini_decode")
    # a train step reduce-scatters grads onto the ZeRO-split params
    if shape == "mini_train":
        assert rec["collectives"].get("reduce_scatter_tensor", 0) > 0
    assert sum(rec["collectives"].values()) > 0


def test_skipped_cell_gives_the_applicable_reason():
    rec = dryrun.run_cell("qwen3-0.6b", "long_500k", "single")
    assert rec["status"] == "skipped"
    assert rec["reason"] == configs.applicable("qwen3-0.6b", "long_500k")[1]


_REF_BYTES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import math
import jax, numpy as np
from jax.sharding import Mesh
from repro.launch import specs
mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
_, args, in_sh, _ = specs.train_cell(sys.argv[1], "train_4k", mesh,
                                     microbatches=1)
out = {}
for name, tree, sh in zip(("params", "opt_state", "batch"), args, in_sh):
    out[name] = sum(
        math.prod(s.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
        for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)))
print(json.dumps(out))
"""


def test_command_r_train_4k_on_the_production_group():
    """The full cell runs at 256 ranks, and each rank holds at rest what
    the reference's shardings put on a device: params 0.81 GB, AdamW's
    moments 3.26 GB, the batch 0.79 MB (the reference's sums computed in
    a subprocess meanwhile).  At its peak over the step a rank holds more
    (a layer's weights gathered whole, activations, gradients) but less
    than an 80 GB card: gathering every weight at once would take the
    whole model's 208 GB."""
    arch = "command-r-plus-104b"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with subprocess.Popen([sys.executable, "-c", _REF_BYTES, arch],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, env=env, cwd=ROOT) as ref:
        rec = dryrun.run_cell(arch, "train_4k", "single", microbatches=1)
        out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["bytes_per_rank"] == want
    assert sum(want.values()) < rec["peak_bytes_per_rank"] < 80e9
    assert rec["collectives"].get("reduce_scatter_tensor", 0) > 0
