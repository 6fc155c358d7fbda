"""The port's training runtime on the CPU, against the JAX package.

Data, optimizer, gradient accumulation, checkpoints and the fault-tolerant
loop of ``repro_torch`` on the SMOKE qwen3 config, held against
``repro.data``, ``repro.optim``, ``repro.runtime`` and ``repro.checkpoint``
on the same inputs (parameters made by the reference and carried across
with ``params_from_jax``).  The batches must be bit-identical; an
optimizer update on the same grads agrees within f32 rounding (atol 1e-6
on params that move by ~1e-3 a step); losses and accumulated grads within
the f32 model bound of ``tests/test_torch_models.py``; the loop tests are
the port's versions of ``tests/test_runtime.py``'s.
"""
import gc
import importlib
import os
import tempfile
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import int8_compressed as ref_int8
from repro.optim import linear_schedule as ref_linear
from repro.optim.compression import compress as ref_compress
from repro.runtime import make_train_step as ref_make_train_step

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import (from_reference_layout, params_from_jax,
                                 params_to_jax, to_reference_layout)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import get_model
from repro_torch.optim import (adamw, clip_by_global_norm, cosine_schedule,
                               global_norm, int8_compressed, linear_schedule)
from repro_torch.optim.compression import compress, decompress
from repro_torch.runtime import (make_loss_with_accum, make_train_step,
                                 train_loop)
from repro_torch.runtime.fault_tolerance import (InjectedFailure,
                                                 StragglerMonitor)
from repro_torch.tree import tree_map, tree_paths

ARCH = "qwen3-0.6b"
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # tests/test_torch_models.py


def jax_paths(tree) -> dict:
    """{key path: numpy leaf} with the port's path convention."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_tree_close(cfg, params, jtree, **tol):
    want = jax_paths(jtree)
    got = list(tree_paths(to_reference_layout(cfg, params)))
    assert {p for p, _ in got} == set(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf.float().numpy(), want[path],
                                   err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,n_hosts,host_id",
                         [(0, 0, 1, 0), (3, 5, 1, 0), (3, 2, 2, 1),
                          (7, 11, 4, 2)])
def test_batches_equal_reference(seed, step, n_hosts, host_id):
    kw = dict(vocab=100, seq_len=48, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host_id,
              extras={"frames": (lambda b, s: (b, 3, 5), np.float32)})
    got = SyntheticLM(**kw).batch(step)
    want = RefSyntheticLM(**kw).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batches_are_host_sharded():
    full = SyntheticLM(vocab=100, seq_len=32, global_batch=8, seed=3)
    h0 = SyntheticLM(vocab=100, seq_len=32, global_batch=8, seed=3,
                     n_hosts=2, host_id=0)
    h1 = SyntheticLM(vocab=100, seq_len=32, global_batch=8, seed=3,
                     n_hosts=2, host_id=1)
    np.testing.assert_array_equal(
        np.concatenate([h0.batch(2)["tokens"], h1.batch(2)["tokens"]]),
        full.batch(2)["tokens"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config(ARCH, smoke=True)
    rcfg = ref_get_config(ARCH, smoke=True)
    rmodel = ref_get_model(rcfg)
    jparams = rmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    data = RefSyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4,
                          seed=0)
    jgrads = jax.jit(jax.grad(rmodel.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in data.batch(0).items()})
    grads = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads),
                            device="cpu")
    return cfg, rmodel, jparams, params, data, jgrads, grads


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("warmup,total", [(0, 10), (5, 50), (20, 100)])
def test_schedules_equal_reference(kind, warmup, total):
    ours = {"cosine": cosine_schedule, "linear": linear_schedule}[kind]
    ref = {"cosine": ref_cosine, "linear": ref_linear}[kind]
    lr, rlr = ours(3e-3, warmup, total), ref(3e-3, warmup, total)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1,
                 total, total + 7):
        np.testing.assert_allclose(float(lr(torch.tensor(step))),
                                   float(rlr(step)), rtol=1e-6, atol=1e-12)


def test_global_norm_and_clip_equal_reference(smoke):
    from repro.optim import clip_by_global_norm as ref_clip
    from repro.optim import global_norm as ref_norm

    cfg, _, _, _, _, jgrads, grads = smoke
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(ref_norm(jgrads)), rtol=1e-6)
    clipped, g = clip_by_global_norm(grads, 0.5)
    jclipped, jg = ref_clip(jgrads, 0.5)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-6)
    assert_tree_close(cfg, clipped, jclipped, atol=1e-7, rtol=1e-6)


def test_adamw_update_equals_reference(smoke):
    cfg, _, jparams, params, _, jgrads, grads = smoke
    opt, ropt = adamw(cosine_schedule(1e-3, 2, 10)), \
        ref_adamw(ref_cosine(1e-3, 2, 10))
    state, rstate = opt.init(params), ropt.init(jparams)
    for _ in range(3):  # moments and bias corrections past step 1
        params, state, m = opt.update(grads, state, params)
        jparams, rstate, rm = ropt.update(jgrads, rstate, jparams)
    assert int(state["step"]) == int(rstate["step"]) == 3
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert_tree_close(cfg, params, jparams, **STEP_TOL)
    assert_tree_close(cfg, state["mu"], rstate["mu"], atol=1e-7, rtol=1e-5)
    assert_tree_close(cfg, state["nu"], rstate["nu"], atol=1e-9, rtol=1e-5)


def test_adamw_inplace_matches_functional(smoke):
    """``inplace=True`` gives the functional update's numbers bit for bit
    and returns the moments it was given, updated."""
    _, _, _, params, _, _, grads = smoke
    fun, inp = adamw(1e-3), adamw(1e-3, inplace=True)
    fstate, istate = fun.init(params), inp.init(params)
    fparams = iparams = params
    for _ in range(2):
        fparams, fstate, _ = fun.update(grads, fstate, fparams)
        mu_before = istate["mu"]
        iparams, istate, _ = inp.update(grads, istate, iparams)
        assert all(a is b for (_, a), (_, b) in zip(
            tree_paths(istate["mu"]), tree_paths(mu_before)))
    for tree_a, tree_b in ((fparams, iparams), (fstate["mu"], istate["mu"]),
                           (fstate["nu"], istate["nu"])):
        for (_, a), (_, b) in zip(tree_paths(tree_a), tree_paths(tree_b)):
            assert torch.equal(a, b)


def test_adamw_keeps_the_reference_dtypes():
    """bf16 params: f32 moments, bf16 params back, decay on matrices only
    (``ln_f``'s vector is not decayed; with zero grads only decay moves a
    param)."""
    p = {"embed": {"tokens": torch.ones(4, 3, dtype=torch.bfloat16)},
         "ln_f": {"scale": torch.ones(3, dtype=torch.bfloat16)},
         "layers": []}
    g = tree_map(torch.zeros_like, p)
    opt = adamw(0.5)
    new, state, _ = opt.update(g, opt.init(p), p)
    assert state["mu"]["embed"]["tokens"].dtype == torch.float32
    assert new["embed"]["tokens"].dtype == torch.bfloat16
    assert new["embed"]["tokens"][0, 0] == torch.tensor(0.95).bfloat16()
    assert float(new["ln_f"]["scale"][0]) == 1.0


SLICED = 1000   # SLICE_ELEMS for the tests: SMOKE's embedding in 15-row slices


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_slices_change_no_value(smoke, monkeypatch, dtype, inplace):
    """The clip and two updates over leaves cut into slices of ``SLICED``
    elements give params, moments and clipped grads bit-equal to one slice
    a leaf.  The norm is held at 3.7 on both sides, so the clip bites and
    only the slicing differs."""
    mod = importlib.import_module("repro_torch.optim.adamw")
    _, _, _, params, _, _, grads = smoke
    params, grads = (tree_map(lambda t: t.to(dtype), x)
                     for x in (params, grads))
    assert max(t.numel() for _, t in tree_paths(params)) > 8 * SLICED
    monkeypatch.setattr(mod, "global_norm", lambda tree: torch.tensor(3.7))
    out = []
    for elems in (mod.SLICE_ELEMS, SLICED):
        monkeypatch.setattr(mod, "SLICE_ELEMS", elems)
        opt = adamw(1e-3, inplace=inplace)
        p, state = params, opt.init(params)
        for _ in range(2):
            p, state, _ = opt.update(grads, state, p)
        out.append((p, state["mu"], state["nu"],
                    mod.clip_by_global_norm(grads, 1.0)[0]))
    for tree_a, tree_b in zip(*out):
        for (path, a), (_, b) in zip(tree_paths(tree_a), tree_paths(tree_b)):
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_sliced_global_norm_and_clip_equal_reference(smoke, monkeypatch):
    """``global_norm`` and ``clip_by_global_norm`` over slices of ``SLICED``
    elements against the reference's, within
    ``test_global_norm_and_clip_equal_reference``'s bounds."""
    from repro.optim import clip_by_global_norm as ref_clip
    from repro.optim import global_norm as ref_norm

    monkeypatch.setattr(importlib.import_module("repro_torch.optim.adamw"),
                        "SLICE_ELEMS", SLICED)
    cfg, _, _, _, _, jgrads, grads = smoke
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(ref_norm(jgrads)), rtol=1e-6)
    clipped, g = clip_by_global_norm(grads, 0.5)
    jclipped, jg = ref_clip(jgrads, 0.5)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-6)
    assert_tree_close(cfg, clipped, jclipped, atol=1e-7, rtol=1e-6)


# (device, param dtype, gradient dtype, moments dtype, strided gradient):
# whether the kernels' wrappers take the leaf as the optimizer sends it
# (update, norm)
_DISPATCH = {
    "cuda bf16": ("cuda", torch.bfloat16, torch.bfloat16, torch.float32,
                  False, True, True),
    "cuda f32": ("cuda", torch.float32, torch.float32, torch.float32, False,
                 True, True),
    "cuda bf16 param, f32 grad": ("cuda", torch.bfloat16, torch.float32,
                                  torch.float32, False, True, True),
    "cuda bf16 moments": ("cuda", torch.bfloat16, torch.bfloat16,
                          torch.bfloat16, False, False, True),
    "cuda strided": ("cuda", torch.bfloat16, torch.bfloat16, torch.float32,
                     True, True, True),
    "cuda f16": ("cuda", torch.float16, torch.float16, torch.float32, False,
                 False, False),
    "cpu bf16": ("cpu", torch.bfloat16, torch.bfloat16, torch.float32,
                 False, None, None),
    "cpu f32": ("cpu", torch.float32, torch.float32, torch.float32, False,
                None, None),
}


@pytest.mark.parametrize("case", sorted(_DISPATCH))
def test_fused_adamw_dispatch_follows_the_tensors(case, monkeypatch):
    """The optimizer sends every leaf on a CUDA card to the fused kernels,
    a strided gradient made contiguous, and every CPU leaf to the eager
    path; the kernels' wrappers take a CUDA leaf whose param and gradient
    are bf16 or f32 and whose moments are f32, and raise on any other.
    Fake tensors stand for the card's and the kernels are stubbed, so no
    card is needed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import adamw as fused

    device, pdt, gdt, mdt, strided, update, norm = _DISPATCH[case]
    sent = {}

    def sq_sums(grads):
        sent["norm"] = grads
        return torch.ones(len(grads), device=grads[0].device)

    def fused_update(leaves, *args, **kw):
        sent["update"] = leaves

    monkeypatch.setattr(fused, "sq_sums", sq_sums)
    monkeypatch.setattr(fused, "update", fused_update)
    # a fake CUDA tensor's ``contiguous`` copies through a CUDA build's
    # kernels; a clone to the contiguous format gives the same tensor
    monkeypatch.setattr(torch.Tensor, "contiguous", lambda t: t if
                        t.is_contiguous() else
                        t.clone(memory_format=torch.contiguous_format))
    with FakeTensorMode():
        p = torch.empty(6, 4, device=device, dtype=pdt)
        g = torch.empty(4, 6, device=device, dtype=gdt)
        g = g.t() if strided else g.view(6, 4)
        m, v = (torch.empty(6, 4, device=device, dtype=mdt)
                for _ in range(2))
        state = {"mu": {"w": m}, "nu": {"w": v},
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        new, _, _ = adamw(1e-3).update({"w": g}, state, {"w": p})
        assert new["w"].device.type == device and new["w"].dtype == pdt
        if device == "cpu":
            assert sent == {}
            return
        (sg,), ((ug, um, uv, up, *_),) = sent["norm"], sent["update"]
        assert ug.is_contiguous() and sg.is_contiguous()
        assert (ug.dtype, um, uv, up) == (gdt, m, v, p)
        assert fused._leaf_ok(ug, um, uv, up) is update
        assert fused._grad_ok(sg) is norm


def test_optim_counts_updated_elements_under_the_profiler(smoke):
    """Under the profiler ``update`` counts every param element it
    updated (``optim.elems``) and those the fused path took
    (``optim.fused_elems``, none on the CPU); with tracing off it counts
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    _, _, _, params, _, _, grads = smoke
    opt = adamw(1e-3)
    state = opt.init(params)
    tracing.reset()
    try:
        opt.update(grads, state, params)
        assert tracing.records()["counters"] == {}
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                opt.update(grads, state, params)
        counts = tracing.records()["counters"]
    finally:
        tracing.reset()
    total = sum(t.numel() for _, t in tree_paths(params))
    assert counts == {"optim.elems": 2 * total, "optim.fused_elems": 0}


def test_int8_compressed_update_equals_reference(smoke):
    cfg, _, jparams, params, _, jgrads, grads = smoke
    opt, ropt = int8_compressed(adamw(1e-3), cfg), ref_int8(ref_adamw(1e-3))
    state, rstate = opt.init(params), ropt.init(jparams)
    for _ in range(2):  # the second step feeds the first's residual back
        params, state, _ = opt.update(grads, state, params)
        jparams, rstate, _ = ropt.update(jgrads, rstate, jparams)
    assert_tree_close(cfg, params, jparams, **STEP_TOL)
    assert_tree_close(cfg, state["err"], rstate["err"], atol=1e-7, rtol=1e-4)


def test_compress_equals_reference():
    x = np.random.default_rng(3).standard_normal((7, 9)).astype(np.float32)
    q, scale = compress(torch.from_numpy(x))
    rq, rscale = ref_compress(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(scale), float(rscale), rtol=1e-7)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(decompress(q, scale).numpy(), x,
                               atol=float(scale) / 2 + 1e-7)


# ---------------------------------------------------------------------------
# train step and gradient accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_with_accum_equals_reference(smoke, microbatches):
    """Loss and gradients of the accumulating step, against the
    reference's ``make_loss_with_accum`` at the f32 model bound; with one
    microbatch they keep the param dtype, with more they come out f32."""
    from repro.runtime.trainstep import make_loss_with_accum as ref_accum

    cfg, rmodel, jparams, params, data, _, _ = smoke
    model = get_model(cfg, device="cpu", attn="kernel")
    batch = data.batch(0)
    loss, grads = make_loss_with_accum(model.loss_fn, microbatches)(
        params, batch)
    jloss, jgrads = jax.jit(ref_accum(rmodel.loss_fn, microbatches))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    assert_tree_close(cfg, grads, jgrads, **MODEL_TOL)


def test_grad_accumulation_equivalence(smoke):
    cfg, _, _, params, data, _, _ = smoke
    model = get_model(cfg, device="cpu", attn="kernel")
    opt = adamw(1e-3)
    s1 = make_train_step(model.loss_fn, opt, microbatches=1)
    s2 = make_train_step(model.loss_fn, opt, microbatches=2)
    batch = data.batch(0)
    p1, _, m1 = s1(params, opt.init(params), batch)
    p2, _, m2 = s2(params, opt.init(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(tree_paths(p1), tree_paths(p2)))
    assert diff < 2e-5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_layout_round_trip(smoke):
    cfg, _, jparams, params, _, _, _ = smoke
    state = {"params": params, "opt": adamw(1e-3).init(params)}
    ref_layout = to_reference_layout(cfg, state)
    want = jax_paths(jparams)
    for path, leaf in tree_paths(ref_layout["params"]):
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    back = from_reference_layout(cfg, ref_layout)
    for (pa, a), (pb, b) in zip(tree_paths(back), tree_paths(state)):
        assert pa == pb and torch.equal(a, b)


def test_port_checkpoint_loads_in_reference(smoke):
    cfg, _, jparams, params, _, _, grads = smoke
    opt, ropt = adamw(1e-3), ref_adamw(1e-3)
    params, state, _ = opt.update(grads, opt.init(params), params)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 7, to_reference_layout(
            cfg, {"params": params, "opt": state}), extra={"note": 1})
        like = {"params": jparams, "opt": ropt.init(jparams)}
        tree, step, extra = ref_ckpt.load_checkpoint(d, like)
    assert step == 7 and extra == {"note": 1}
    assert_tree_close(cfg, params, tree["params"], atol=0, rtol=0)
    assert_tree_close(cfg, state["nu"], tree["opt"]["nu"], atol=0, rtol=0)
    assert int(tree["opt"]["step"]) == 1


def test_reference_checkpoint_loads_in_port(smoke):
    cfg, _, jparams, params, _, jgrads, _ = smoke
    ropt = ref_adamw(1e-3)
    jparams, rstate, _ = ropt.update(jgrads, ropt.init(jparams), jparams)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save_checkpoint(d, 3, {"params": jparams, "opt": rstate})
        like = {"params": params, "opt": adamw(1e-3).init(params)}
        shapes = to_reference_layout(cfg, like)
        tree, step, _ = ckpt.load_checkpoint(d, shapes)
    state = from_reference_layout(cfg, tree)
    assert step == 3 and int(state["opt"]["step"]) == 1
    assert_tree_close(cfg, state["params"], jparams, atol=0, rtol=0)
    assert_tree_close(cfg, state["opt"]["mu"], rstate["mu"], atol=0, rtol=0)


def test_bf16_leaves_keep_the_reference_format():
    """A bf16 leaf is stored as the raw 2-byte values the reference's npz
    holds for its bf16 arrays, and loads back bit-exact."""
    x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    t = torch.from_numpy(x).bfloat16()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(os.path.join(d, "port"), 1, {"w": t})
        ref_ckpt.save_checkpoint(os.path.join(d, "ref"), 1,
                                 {"w": jnp.asarray(x, jnp.bfloat16)})
        with np.load(os.path.join(d, "port", "step_00000001",
                                  "arrays.npz")) as a, \
                np.load(os.path.join(d, "ref", "step_00000001",
                                     "arrays.npz")) as b:
            assert a["w"].dtype == b["w"].dtype
            assert a["w"].tobytes() == b["w"].tobytes()
        like = {"w": torch.empty(3, 4, dtype=torch.bfloat16)}
        back, _, _ = ckpt.load_checkpoint(os.path.join(d, "ref"), like)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)


def test_checkpoint_keeps_k_and_rejects_bad_shapes():
    with tempfile.TemporaryDirectory() as d:
        for s in range(5):
            ckpt.save_checkpoint(d, s, {"a": torch.full((2,), float(s))},
                                 keep=2)
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        assert ckpt.latest_step(d) == 4
        tree, step, _ = ckpt.load_checkpoint(d, {"a": torch.empty(2)})
        assert step == 4 and tree["a"].tolist() == [4.0, 4.0]
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(d, {"a": torch.empty(3)})
        with pytest.raises(KeyError):
            ckpt.load_checkpoint(d, {"b": torch.empty(2)})


# ---------------------------------------------------------------------------
# the fault-tolerant loop (the port's versions of tests/test_runtime.py's)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_setup(smoke):
    cfg, _, _, params, _, _, _ = smoke
    model = get_model(cfg, device="cpu", attn="kernel")
    opt = adamw(1e-3)
    step_fn = make_train_step(model.loss_fn, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    return cfg, params, opt.init(params), step_fn, data


def test_loop_trains_checkpoints_resumes(tiny_setup):
    cfg, params, opt_state, step_fn, data = tiny_setup
    with tempfile.TemporaryDirectory() as d:
        p, o, rep = train_loop(step_fn, params, opt_state, data.batch,
                               cfg=cfg, steps=8, ckpt_dir=d, ckpt_every=4,
                               logger=lambda *a: None)
        assert rep.steps_run == 8 and rep.resumed_from is None
        assert rep.losses[-1] < rep.losses[0]
        p, o, rep2 = train_loop(step_fn, params, opt_state, data.batch,
                                cfg=cfg, steps=12, ckpt_dir=d, ckpt_every=4,
                                logger=lambda *a: None)
        assert rep2.resumed_from == 8 and rep2.steps_run == 4
        assert int(o["step"]) == 12


def test_loop_rolls_back_on_nan(tiny_setup):
    cfg, params, opt_state, step_fn, data = tiny_setup
    with tempfile.TemporaryDirectory() as d:
        p, o, rep = train_loop(step_fn, params, opt_state, data.batch,
                               cfg=cfg, steps=6, ckpt_dir=d, ckpt_every=2,
                               inject_nan_at=3, logger=lambda *a: None)
        assert rep.rollbacks == 1
        assert all(np.isfinite(l) for l in rep.losses)
        # rolled back to step 2's state and skipped batch 3
        assert rep.steps_run == 5 and int(o["step"]) == 4


def test_loop_survives_process_failure(tiny_setup):
    """Injected crash mid-run; a fresh loop resumes from the checkpoint."""
    cfg, params, opt_state, step_fn, data = tiny_setup
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(InjectedFailure):
            train_loop(step_fn, params, opt_state, data.batch, cfg=cfg,
                       steps=10, ckpt_dir=d, ckpt_every=2,
                       inject_failure_at=5, logger=lambda *a: None)
        p, o, rep = train_loop(step_fn, params, opt_state, data.batch,
                               cfg=cfg, steps=10, ckpt_dir=d, ckpt_every=2,
                               logger=lambda *a: None)
        assert rep.resumed_from == 4  # last checkpoint before the crash
        assert rep.steps_run == 6


def test_loop_without_checkpoints(tiny_setup):
    """``ckpt_every=0`` trains and writes nothing; a non-finite loss then
    raises, having no checkpoint to roll back to."""
    cfg, params, opt_state, step_fn, data = tiny_setup
    with tempfile.TemporaryDirectory() as d:
        _, o, rep = train_loop(step_fn, params, opt_state, data.batch,
                               cfg=cfg, steps=2, ckpt_dir=d, ckpt_every=0,
                               logger=lambda *a: None)
        assert rep.steps_run == 2 and int(o["step"]) == 2
        assert os.listdir(d) == []
        with pytest.raises(FloatingPointError):
            train_loop(step_fn, params, opt_state, data.batch, cfg=cfg,
                       steps=2, ckpt_dir=d, ckpt_every=0, inject_nan_at=1,
                       logger=lambda *a: None)


def test_loop_lets_go_of_the_first_state(tiny_setup):
    """Once a step has replaced them, the loop holds no reference to the
    params and optimizer state it was given: a caller that keeps none sees
    them freed (at full width on one card a second copy of the params
    takes 5-9 GB)."""
    cfg, params, _, _, data = tiny_setup
    opt = adamw(1e-3)        # functional: each step makes new tensors
    step_fn = make_train_step(get_model(cfg, device="cpu").loss_fn, opt)
    refs, alive = [], []

    def fresh():
        p = tree_map(torch.clone, params)
        state = opt.init(p)
        refs.extend(weakref.ref(t) for tree in (p, state)
                    for _, t in tree_paths(tree))
        return p, state

    def step(p, o, batch):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        return step_fn(p, o, batch)

    with tempfile.TemporaryDirectory() as d:
        train_loop(step, *fresh(), data.batch, cfg=cfg, steps=3, ckpt_dir=d,
                   ckpt_every=0, logger=lambda *a: None)
    assert alive == [len(refs), 0, 0]


def test_loop_resumes_from_a_reference_run(smoke, tiny_setup):
    """The JAX package's loop writes, the port's resumes: both hold the
    same checkpoint layout."""
    from repro.runtime import train_loop as ref_train_loop

    cfg, rmodel, jparams, _, _, _, _ = smoke
    _, params, opt_state, step_fn, data = tiny_setup
    ropt = ref_adamw(1e-3)
    rstep = jax.jit(ref_make_train_step(rmodel.loss_fn, ropt))
    with tempfile.TemporaryDirectory() as d:
        ref_train_loop(rstep, jparams, ropt.init(jparams), data.batch,
                       steps=2, ckpt_dir=d, ckpt_every=2,
                       logger=lambda *a: None)
        _, o, rep = train_loop(step_fn, params, opt_state, data.batch,
                               cfg=cfg, steps=3, ckpt_dir=d, ckpt_every=2,
                               logger=lambda *a: None)
    assert rep.resumed_from == 2 and rep.steps_run == 1
    assert int(o["step"]) == 3


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(20):
        assert not mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert mon.observe(20, 1.5)
    assert mon.slow_steps and mon.slow_steps[0][0] == 20


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "3", "--seq-len", "32",
                              "--global-batch", "4", "--microbatches", "2",
                              "--ckpt-dir", d, "--ckpt-every", "2"])
        assert sorted(os.listdir(os.path.join(d, "qwen3-0.6b"))) == \
            ["step_00000000", "step_00000002", "step_00000003"]
        again = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--steps", "4", "--seq-len", "32",
                                "--global-batch", "4", "--accel-target",
                                "none", "--ckpt-dir", d])
    text = capsys.readouterr().out
    assert "[covenant] qwen3-0.6b @ h100, tokens=128" in text
    assert "[train] done: 3 steps, loss" in text
    assert out["report"].steps_run == 3
    assert all(np.isfinite(out["report"].losses))
    assert again["report"].resumed_from == 3
    assert again["report"].steps_run == 1
    # on CPU tensors the wrappers run their plain versions: no launches
    assert not any(out["launches"].values())


def test_train_cli_compress_grads_on_cpu(capsys):
    """``--compress-grads``: the optimizer state grows the reference's
    ``err`` tree, and the checkpoint holds it in the reference layout."""
    with tempfile.TemporaryDirectory() as d:
        out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "2", "--seq-len", "32",
                              "--global-batch", "2", "--compress-grads",
                              "--accel-target", "none", "--ckpt-dir", d])
        with np.load(os.path.join(d, "qwen3-0.6b", "step_00000002",
                                  "arrays.npz")) as z:
            keys = set(z.files)
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert all(np.isfinite(out["report"].losses))
    assert "opt|err|layers|#0|attn|wq" in keys
    assert "opt|inner|mu|layers|#0|attn|wq" in keys
    assert "opt|inner|step" in keys
