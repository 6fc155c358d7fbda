"""The port's distribution layer across CPU processes, against the JAX
package.

Ranks are gloo processes (``torch_dist_workers.run_ranks``, each spawn
with its own timeout: world 4 as a (2, 2) ``("data", "model")`` mesh or
world 8 as (2, 4), one spawn a mesh for the collectives, the train steps,
the GQA cases, the int8 step and the sharded save, and one a test for the
rest); they read the inputs this module writes and rank 0 writes what it
checks.  The reference's sharded collectives run
in a subprocess on 8 forced host devices, on plain ``jax.sharding.Mesh``es
of the same shapes (``jax.make_mesh`` there gives Explicit axes, which the
reference's ``shard_map`` calls do not take).  Bounds: the reference test's
(``tests/test_runtime.py``): compressed psum within 0.02 of the largest
output, the decode within 2e-3; the gradients at the model bound of
``tests/test_torch_train.py`` (atol 1e-4, rtol 1e-4); the attention on
DTensors at the port's plain-kernel bound (atol 1e-5).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import load_checkpoint as ref_load_checkpoint
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.convert import to_reference_layout
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.optim import adamw, int8_compressed
from repro_torch.runtime import make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 8, 16
TRAIN_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-2.7b", "whisper-base")
# (case, arch, config overrides): olmoe again with dispatch blocks of 16
# tokens, which each rank's rows hold whole (its MoE then runs on each
# rank's rows; SMOKE's blocks of 128 span ranks, so the MoE runs whole)
TRAIN_CASES = tuple((a, a, {}) for a in TRAIN_ARCHS) + (
    ("olmoe-1b-7b/blocks16", "olmoe-1b-7b", {"moe_block_tokens": 16}),)

_REF_COLLECTIVES = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.runtime.collectives import compressed_psum, sharded_decode_attention
x = np.load(sys.argv[1])
out = {}
for name, shape in (("2x2", (2, 2)), ("2x4", (2, 4))):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    out[name + "_psum"] = np.asarray(compressed_psum(
        {"w": jnp.asarray(x["g"])}, mesh, axis="data")["w"])
    out[name + "_decode"] = np.asarray(sharded_decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["lens"]), mesh, seq_axis="model"))
np.savez(sys.argv[2], **out)
"""


def _collective_inputs(d):
    """The reference test's shapes; the reference's collectives' outputs
    on both meshes."""
    rng = np.random.default_rng(0)
    x = {"g": rng.standard_normal((8, 16)).astype(np.float32),
         "q": rng.standard_normal((2, 4, 16)).astype(np.float32),
         "k": rng.standard_normal((2, 4, 64, 16)).astype(np.float32),
         "v": rng.standard_normal((2, 4, 64, 16)).astype(np.float32),
         "lens": np.array([40, 64], np.int32)}
    np.savez(d / "coll.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REF_COLLECTIVES,
                        str(d / "coll.npz"), str(d / "ref.npz")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    torch.save({k: torch.from_numpy(v) for k, v in x.items()},
               d / "coll.pt")
    return dict(np.load(d / "ref.npz")), x


def _train_inputs():
    """{case: (arch, its overrides, the port's params from the reference's
    init, a batch)} and {case: (the reference's loss, its gradient leaves
    by key path)}."""
    inputs, want = {}, {}
    for case, arch, over in TRAIN_CASES:
        cfg = get_config(arch, smoke=True).replace(**over)
        rmodel = ref_get_model(ref_get_config(arch, smoke=True).replace(
            **over))
        jparams = rmodel.init_params(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(2, cfg.vocab, (B, S)),
                 "targets": rng.integers(2, cfg.vocab, (B, S))}
        for name, (shape_fn, _) in rmodel.extra_inputs.items():
            batch[name] = rng.standard_normal(
                shape_fn(B, S)).astype(np.float32)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = jax.jit(jax.value_and_grad(rmodel.loss_fn))(
            jparams, jbatch)
        want[case] = (float(jloss), {
            tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jgrads)[0]})
        params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
        inputs[case] = (arch, over, params,
                        {k: torch.as_tensor(v) for k, v in batch.items()})
    return inputs, want


GQA_CASES = {"hq8_hkv2": (8, 2), "hq12_hkv3": (12, 3), "hq16_hkv8": (16, 8)}


def _gqa_inputs():
    rng = np.random.default_rng(3)
    inputs = {}
    for key, (hq, hkv) in GQA_CASES.items():
        t = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32))
        inputs[key] = dict(q=t(2, hq, 16, 8), k=t(2, hkv, 16, 8),
                           v=t(2, hkv, 16, 8), do=t(2, hq, 16, 8),
                           qd=t(2, hq, 8),
                           lens=torch.tensor([5, 16], dtype=torch.int32))
    return inputs


def _int8_inputs() -> dict:
    cfg = get_config("qwen3-0.6b", smoke=True)
    rng = np.random.default_rng(11)
    return {"arch": "qwen3-0.6b",
            "params": get_model(cfg, device="cpu").init_params(0),
            "batch": {k: torch.as_tensor(rng.integers(2, cfg.vocab, (4, 16)))
                      for k in ("tokens", "targets")}}


def _state(arch: str) -> dict:
    """A param tree and AdamW state after one step, so the moments are
    not zeros."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, device="cpu", attn="kernel")
    params = model.init_params(0)
    opt = adamw(1e-3)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(2, cfg.vocab, (4, 8)),
             "targets": rng.integers(2, cfg.vocab, (4, 8))}
    params, opt_state, _ = make_train_step(model.loss_fn, opt)(
        params, opt.init(params), batch)
    return {"params": params, "opt": opt_state}


SERVE_CASES = {"qwen3_prompt6": ("qwen3-0.6b", 6),
               "gemma3_prompt5": ("gemma3-12b", 5),
               "gemma3_prompt12": ("gemma3-12b", 12)}


def _serve_inputs() -> dict:
    """SMOKE params, a prompt of 4 rows and 6 decode steps' tokens a
    case, with a cache of 32: qwen3's 2 kv heads split over a model axis
    of 2 and leave the cache split over its sequence at 4; gemma3's
    local layers keep rolling caches of its window of 8, which a prompt
    of 5 fills in part and one of 12 wraps."""
    rng = np.random.default_rng(13)
    out = {}
    for key, (arch, prompt) in SERVE_CASES.items():
        cfg = get_config(arch, smoke=True)
        out[key] = {
            "arch": arch, "max_len": 32,
            "params": get_model(cfg, device="cpu").init_params(0),
            "tokens": torch.as_tensor(rng.integers(2, cfg.vocab,
                                                   (4, prompt))),
            "steps": torch.as_tensor(rng.integers(2, cfg.vocab, (4, 6)))}
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``run(mesh)``: one spawn of the mesh's ranks, made once
    (``torch_dist_workers.mesh_checks``), running the collectives and the
    sharded train steps; on (2, 4) the GQA cases, on (2, 2) the int8
    step and the sharded save restored onto (4, 1); on both the sharded
    prefill and decode.  Returns (its
    results, the inputs and the reference's outputs)."""
    d = tmp_path_factory.mktemp("meshes")
    ref, coll = _collective_inputs(d)
    inputs, want = _train_inputs()
    torch.save(inputs, d / "train.pt")
    gqa = _gqa_inputs()
    torch.save(gqa, d / "gqa.pt")
    int8 = _int8_inputs()
    torch.save(int8, d / "int8.pt")
    saved = {"arch": "zamba2-2.7b", "state": _state("zamba2-2.7b")}
    torch.save(saved, d / "restore.pt")
    x = dict(ref=ref, coll=coll, train=want, gqa=gqa, int8=int8,
             restore=saved, ckpt=str(d / "ckpt"))
    serve = _serve_inputs()
    torch.save(serve, d / "serve.pt")
    x["serve"] = serve
    paths = {"2x2": {"int8": str(d / "int8.pt"),
                     "restore": str(d / "restore.pt"), "ckpt": x["ckpt"],
                     "serve": str(d / "serve.pt")},
             "2x4": {"gqa": str(d / "gqa.pt"), "serve": str(d / "serve.pt")}}
    done = {}

    def run(mesh):
        if mesh not in done:
            shape = MESHES[mesh]
            workers.run_ranks(
                "mesh_checks", shape[0] * shape[1], shape,
                dict(coll=str(d / "coll.pt"), train=str(d / "train.pt"),
                     **paths[mesh]), str(d / f"{mesh}.pt"))
            done[mesh] = torch.load(d / f"{mesh}.pt")
        return done[mesh], x
    return run


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_match_reference(mesh_runs, mesh):
    got, x = mesh_runs(mesh)
    got, ref = got["collectives"], x["ref"]
    psum, want = got["psum"].numpy(), ref[f"{mesh}_psum"]
    # the reference test's bound against the plain sum, and the
    # reference's own int8 sum
    plain = x["coll"]["g"] * MESHES[mesh][0]
    assert np.abs(psum - plain).max() / np.abs(plain).max() < 0.02
    assert np.abs(psum - want).max() / np.abs(want).max() < 0.02
    np.testing.assert_allclose(got["decode"].numpy(), ref[f"{mesh}_decode"],
                               atol=2e-3)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_matches_reference(mesh_runs, mesh):
    """One sharded step's loss and every gradient leaf of qwen3, olmoe
    (experts over model, the EP rule; its MoE on the whole batch, and with
    blocks of 16 tokens on each rank's rows), mamba2 and whisper SMOKE on
    the kernel path, against ``jax.value_and_grad``; the grads come out
    placed as the params; ``global_norm`` of the sharded grads equals the
    norm of the gathered ones (a replicated leaf counted once a rank would
    put it 2 to 8 times too high)."""
    got, x = mesh_runs(mesh)
    for case, arch, over in TRAIN_CASES:
        r, (jloss, jgrads) = got["train"][case], x["train"][case]
        cfg = get_config(arch, smoke=True).replace(**over)
        np.testing.assert_allclose(float(r["loss"]), jloss, **TOL,
                                   err_msg=case)
        mine = dict(tree_paths(params_to_jax(cfg, r["grads"])))
        assert mine.keys() == jgrads.keys()
        for path, g in mine.items():
            np.testing.assert_allclose(g.float().numpy(), jgrads[path],
                                       **TOL, err_msg=f"{case} {path}")
        assert r["placed"], case
        np.testing.assert_allclose(float(r["norm"]), float(r["whole_norm"]),
                                   rtol=1e-6, err_msg=case)
        assert r["moe_on_rows"] == case.endswith("blocks16"), case


def test_gqa_heads_over_model(mesh_runs):
    """q heads over a model axis of 4 with fewer kv heads than ranks: 8 q
    over 2 kv heads (each rank's 2 q heads share one kv head), 12 over 3
    (a rank's 3 q heads span two kv heads, one kv head each), and 16 over
    8 (kv heads split too); forward, dq, dk, dv and the decode against
    the same calls on whole tensors."""
    got, x = mesh_runs("2x4")
    got = got["gqa"]
    for key, inp in x["gqa"].items():
        leaves = [inp[n].clone().requires_grad_(True) for n in "qkv"]
        o = ops.covenant_attention(*leaves, causal=True)
        grads = torch.autograd.grad(o, leaves, inp["do"])
        np.testing.assert_allclose(got[key]["out"], o.detach(), atol=1e-5)
        for a, b in zip(got[key]["grads"], grads):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)
        dec = ops.covenant_decode_attention(inp["qd"], inp["k"], inp["v"],
                                            inp["lens"])
        np.testing.assert_allclose(got[key]["decode"], dec, atol=1e-5)
        assert got[key]["kv_split"] == (GQA_CASES[key][1] % 4 == 0)


def test_int8_compressed_on_dtensor_leaves(mesh_runs):
    """``int8_compressed(adamw)`` on DTensor leaves at (2, 2): each
    stacked leaf's scale is its max over every shard, so the new params,
    the error-feedback residuals and the moments equal one unsharded
    step's (qwen3 SMOKE: its layers stack in pairs)."""
    got, x = mesh_runs("2x2")
    got, inp = got["int8"], x["int8"]
    cfg = get_config(inp["arch"], smoke=True)
    model = get_model(cfg, device="cpu", attn="kernel")
    opt = int8_compressed(adamw(1e-3), cfg)
    params = inp["params"]
    new_p, new_s, m = make_train_step(model.loss_fn, opt)(
        params, opt.init(params), inp["batch"])
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-6)
    want = {"params": new_p, "err": new_s["err"],
            "mu": new_s["inner"]["mu"]}
    for key in want:
        for (path, a), b in zip(tree_paths(got[key]),
                                tree_leaves(want[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       err_msg=f"{key} {path}")


def test_restore_sharded_across_meshes(mesh_runs):
    """A (2, 2) save restored onto (4, 1) and onto one device, bit-equal
    to the state saved; the checkpoint read by the reference's
    ``load_checkpoint`` equals the state in the reference's layout
    (zamba2 SMOKE: its loras stack per group)."""
    got, x = mesh_runs("2x2")
    got, ckpt_dir = got["restore"], x["ckpt"]
    cfg = get_config(x["restore"]["arch"], smoke=True)
    want = to_reference_layout(cfg, x["restore"]["state"])
    assert got["step"] == 1 and got["placed"]
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), want)
    one, step, _ = ckpt.restore_sharded(ckpt_dir, like,
                                        tree_map(lambda _: "cpu", like))
    pairs = zip(tree_leaves(want), tree_leaves(got["tree"]),
                tree_leaves(one))
    for w, a, b in pairs:
        assert torch.equal(a, w) and torch.equal(b, w)
        assert not isinstance(b, torch.distributed.tensor.DTensor)
    ref_like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), like)
    ref_tree, ref_step, _ = ref_load_checkpoint(ckpt_dir, ref_like)
    assert ref_step == 1
    for w, r in zip(tree_leaves(want), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(w.float().numpy(),
                                      np.asarray(r, np.float32))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_prefill_and_decode_match_unsharded(mesh_runs, mesh):
    """Prefill and 6 decode steps on DTensors: the logits of every step
    and the final KV caches against the unsharded port on the same
    params and tokens, at the model bound (qwen3's cache split over its
    sequence at (2, 4), over its kv heads at (2, 2); gemma3's rolling
    caches, filled in part and wrapped)."""
    got, x = mesh_runs(mesh)
    got = got["serve"]
    for key, case in x["serve"].items():
        cfg = get_config(case["arch"], smoke=True)
        model = get_model(cfg, device="cpu", attn="kernel")
        cache = model.init_cache(case["tokens"].shape[0], case["max_len"])
        logits, cache = model.prefill(case["params"],
                                      {"tokens": case["tokens"]}, cache)
        want = [logits]
        for t in case["steps"].unbind(1):
            logits, cache = model.decode_step(case["params"], t, cache)
            want.append(logits)
        for i, (a, b) in enumerate(zip(got[key]["logits"], want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                       err_msg=f"{key} step {i}")
        for (path, a), b in zip(tree_paths(got[key]["cache"]),
                                tree_leaves(cache)):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       **TOL, err_msg=f"{key} {path}")
    split = {k: v["seq_split"] for k, v in got.items()}
    assert split["qwen3_prompt6"] == (mesh == "2x4"), split


def test_train_loop_resumes_sharded(tmp_path):
    """``train_loop`` at world 2 ((2, 1)): an injected failure at step 2
    on both ranks, a rerun that resumes from the step-2 checkpoint, and
    its losses equal an unsharded run's steps 2 and 3."""
    arch = "qwen3-0.6b"
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, device="cpu", attn="kernel")
    rng = np.random.default_rng(9)
    batches = [{"tokens": torch.as_tensor(rng.integers(2, cfg.vocab, (4, 8))),
                "targets": torch.as_tensor(rng.integers(2, cfg.vocab, (4, 8)))}
               for _ in range(4)]
    params = model.init_params(0)
    torch.save({"arch": arch, "params": params, "batches": batches},
               tmp_path / "in.pt")
    workers.run_ranks("loop", 2, (2, 1), str(tmp_path / "in.pt"),
                      str(tmp_path / "ckpt"), str(tmp_path / "out.pt"))
    got = torch.load(tmp_path / "out.pt")
    assert got["failed_at"] == 2 and got["resumed_from"] == 2
    assert got["steps_run"] == 2
    opt = adamw(1e-3)
    step = make_train_step(model.loss_fn, opt)
    p, s = params, opt.init(params)
    losses = []
    for b in batches:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses[2:], rtol=1e-5)


def test_launch_train_on_a_2x2_mesh_matches_unsharded(tmp_path):
    """``launch.train --model-axis 2`` at world 4: params placed by the
    rules and gathered at use, the activations split over the model axis
    (``split_activations``); its losses equal the unsharded run's."""
    from repro_torch.launch import train
    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "3", "--seq-len", "16", "--global-batch", "4",
            "--ckpt-every", "0", "--accel-target", "none"]
    workers.run_ranks("launch_train", 4, args + ["--model-axis", "2"],
                      str(tmp_path / "out.pt"))
    got = torch.load(tmp_path / "out.pt")["losses"]
    want = train.main(args)["report"].losses
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _no_group():
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_train_multi_pod_exits_2_on_a_smaller_world(capsys):
    """``--multi-pod`` asks for the (2, 16, 16) production mesh; a
    one-rank group has no room for it."""
    from repro_torch.launch import train
    try:
        with pytest.raises(SystemExit) as exc:
            train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--steps", "1", "--accel-target", "none",
                        "--ckpt-every", "0", "--multi-pod"])
        assert exc.value.code == 2
        assert "needs 512 ranks" in capsys.readouterr().err
    finally:
        _no_group()


def test_serve_under_a_launcher_serves_the_same_tokens(monkeypatch):
    """``launch.serve`` in a one-rank ``torchrun`` environment takes the
    host mesh and serves the tokens of the run without one."""
    from repro_torch.launch import serve
    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--accel-target", "none", "--requests", "4"]
    plain = serve.main(args)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost",
                     MASTER_PORT=str(workers.free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        launched = serve.main(args)
        assert torch.distributed.get_backend() == "gloo"
    finally:
        _no_group()
    assert len(launched["outputs"]) == len(plain["outputs"])
    for a, b in zip(launched["outputs"], plain["outputs"]):
        np.testing.assert_array_equal(a, b)
