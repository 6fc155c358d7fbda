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

Each record carries one rank's FLOPs, HBM bytes and collective bytes
(``roofline.collect_step``): a rank's FLOPs halve from one rank to a data
axis of two, a one-rank group moves no collective bytes, and every kind
of collective the step issues has bytes; ``roofline_terms`` reads
command-r's record.  ``count_step``, which counts the card's one-card
steps on meta tensors (``chip_smoke.py`` phase 17), counts what the same
step counts on real tensors, and counts AdamW's update as the card's
fused kernels move it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import count_step
from repro_torch.launch.mesh import init_fake
from repro_torch.models import get_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.roofline import (collect_step, model_flops,
                                  roofline_terms)
from repro_torch.roofline.collect import (KIND, RESIDENT_BYTES, StepCounter,
                                          record)
from repro_torch.tree import tree_map
from repro_torch.runtime import make_train_step

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


def _mini_train(data: int) -> dict:
    """qwen3-0.6b's mini train cell at 2 layers on a fake (data, 1)
    group."""
    init_fake(data)
    mesh = init_device_mesh("cpu", (data, 1), mesh_dim_names=("data",
                                                                "model"))
    return dryrun.run_cell("qwen3-0.6b", "mini_train", "mini",
                           microbatches=2, mesh=mesh,
                           overrides={"n_layers": 2},
                           activations=(("data",), "model", None, None))


def test_flops_are_per_rank_and_collectives_by_kind(mini_mesh):
    """A data axis of two halves one rank's FLOPs (within 2 %).  A count
    of the global op would not: ``FlopCounterMode`` over DTensors counts
    the whole product, so on two ranks it reads twice the rank's share.
    One rank moves no collective bytes; on two every kind of collective
    the step issues (``collectives``) has bytes."""
    one, two = _mini_train(1), _mini_train(2)
    assert one["path"] == two["path"] == "plain"
    assert one["flops"] > 0 and one["bytes_accessed"] > 0
    assert two["flops"] == pytest.approx(one["flops"] / 2, rel=0.02)
    assert two["bytes_accessed"] < one["bytes_accessed"]
    assert one["collective_bytes"] == 0 and one["collective_breakdown"] == {}
    assert two["collective_bytes"] > 0
    assert two["collective_bytes"] == sum(
        two["collective_breakdown"].values())
    for name in two["collectives"]:
        assert two["collective_breakdown"][KIND[name]] > 0, name
    assert two["n_collectives"]["reduce-scatter"] == \
        two["collectives"]["reduce_scatter_tensor"]
    # the global count: a (256, 128) @ (128, 64) product, rows split 2 ways
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    a = DTensor.from_local(torch.empty(128, 128, device="meta"), mesh,
                           [Shard(0)], run_check=False)
    b = DTensor.from_local(torch.empty(128, 64, device="meta"), mesh,
                           [Replicate()], run_check=False)
    flop_counter = FlopCounterMode(display=False)
    with flop_counter:
        torch.mm(a, b)
    rank = collect_step(torch.mm, a, b)["flops"]
    assert rank == 2 * 128 * 128 * 64
    assert flop_counter.get_total_flops() == 2 * rank


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
    rl = roofline_terms(rec)
    useful = model_flops(configs.get_config(arch), configs.SHAPES[
        "train_4k"], "train") / rec["n_devices"] / rec["flops"]
    msg = (f"a rank: {rec['flops']:.4e} FLOP, {rec['bytes_accessed']:.4e} "
           f"B, {rec['collective_bytes']:.4e} collective B; roofline "
           f"{rl}, {rl.bottleneck}-bound; useful {useful:.3f}")
    assert min(rl.compute_s, rl.memory_s, rl.collective_s) > 0, msg
    assert 0 < useful <= 1, msg


STEPS = [("qwen3-0.6b", "train"), ("olmoe-1b-7b", "train"),
         ("zamba2-2.7b", "train"), ("whisper-base", "train"),
         ("qwen3-0.6b", "prefill"), ("qwen3-0.6b", "decode")]


@pytest.mark.parametrize("arch,kind", STEPS, ids=[f"{a}-{k}" for a, k in
                                                  STEPS])
def test_meta_count_equals_the_real_step(arch, kind):
    """``count_step`` on meta tensors counts what the same step counts on
    real CPU tensors (SMOKE, 2 x 16, a cache of 32): the bytes, and the
    FLOPs within 1e-3.  Both depend on shapes only, but ``F.one_hot`` (the
    MoE router's) runs as zeros and a scatter on the CPU and as a compare
    and a convert on meta tensors: olmoe's counts differ by 4096 of
    34 112 001."""
    cfg = configs.get_config(arch, smoke=True)
    got = count_step(cfg, kind, 2, 16, microbatches=2 if kind == "train"
                     else 1, max_len=32)
    model = get_model(cfg, device="cpu", attn="plain")
    params = model.init_params(0)
    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.as_tensor(rng.integers(2, cfg.vocab, (2, 16)))}
    for name, (shape_fn, dtype) in model.extra_inputs.items():
        inputs[name] = torch.zeros(shape_fn(2, 16), dtype=dtype)
    counter = StepCounter()
    if kind == "train":
        opt = dryrun.on_card_adamw(
            adamw(cosine_schedule(3e-3, 20, 100), inplace=True), counter)
        inputs.update(targets=inputs["tokens"], weights=torch.ones(2, 16))
        fn = make_train_step(model.loss_fn, opt, 2)
        args = (params, opt.init(params), inputs)
    elif kind == "prefill":
        fn, args = model.prefill, (params, inputs, model.init_cache(2, 32))
    else:
        fn, args = model.decode_step, (params, inputs["tokens"][:, 0],
                                       model.init_cache(2, 32))
    with torch.no_grad(), counter:
        fn(*args)
    want = record(counter)
    assert got["path"] == "plain"
    assert got["flops"] > 0
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-3)
    assert got["bytes_accessed"] == want["bytes_accessed"]


def test_adamw_counts_as_the_card_runs_it():
    """``on_card_adamw``: the update's FLOPs are its eager ops', its bytes
    what ``csrc/adamw.cu`` moves: each gradient read twice (the norm, the
    update), each param and moment read once and written once, so 2g + 2p
    + 16 bytes an element of a leaf above ``RESIDENT_BYTES`` and none of a
    smaller one; the eager ops' f32 temporaries move several times that."""
    params = {"w": torch.zeros(512, 300, dtype=torch.bfloat16),
              "layers": {"b": torch.zeros(256, 1024)}, "s": torch.zeros(8)}
    grads = tree_map(torch.ones_like, params)
    assert 512 * 300 * 2 > RESIDENT_BYTES >= 8 * 4
    opt = adamw(1e-3, inplace=True)
    eager = collect_step(opt.update, grads, opt.init(params), params)
    counter = StepCounter()
    state = opt.init(params)
    with counter:
        dryrun.on_card_adamw(opt, counter).update(grads, state, params)
    assert counter.flops == eager["flops"] > 0
    assert counter.bytes == 512 * 300 * (2 * 2 + 2 * 2 + 16) \
        + 256 * 1024 * (2 * 4 + 2 * 4 + 16)
    assert eager["bytes_accessed"] > 5 * counter.bytes
