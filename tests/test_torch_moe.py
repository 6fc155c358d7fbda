"""The port's MoE family (deepseek-moe-16b, olmoe-1b-7b) against the JAX
package's, on the CPU.

Parameters come from the reference's ``jax.random`` init, carried across
with ``params_from_jax``.  SMOKE is f32, so the bound is f32's, as in
``tests/test_torch_models.py``: atol 1e-4, rtol 1e-4.  ``moe_ffn`` and its
aux loss are held against ``repro.models.moe.moe_ffn`` in one block,
in several blocks and in the single-block fallback, each at the configs'
capacity factor and at one that drops, on tokens that share a common
component (which crowds a few experts).  The dropping cases assert that
the port dropped assignments; the reference's output, which drops its
own, is the check that they were the same ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models import moe as ref_moe

from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import get_model, moe
from repro_torch.tree import tree_paths

ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN, STEPS = 2, 20, 32, 8


def test_archs_registered():
    assert set(ARCHS) <= set(PORT_ARCHS)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke=smoke))


@pytest.fixture(scope="module", params=ARCHS)
def ref_params(request):
    """(cfg, reference cfg, reference params, the port's params)."""
    arch = request.param
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    jparams = ref_moe.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, rcfg, jparams, params


# (tokens, moe_block_tokens, capacity factor, whether drops must happen).
# 96 tokens x top-2 over 8 experts is 24 assignments an expert: in one
# block the capacity is 32 at 1.25 and 8 at 0.25.  Blocks of 32 tokens
# hold 8 an expert (capacity 16 at 1.25, 8 at 0.25, so the crowded ones
# overflow); 40 does not divide 96, so one block of 96 runs.
FFN_CASES = [
    pytest.param(96, 32_768, 1.25, False, id="one-block"),
    pytest.param(96, 32_768, 0.25, True, id="one-block-drops"),
    pytest.param(96, 32, 1.25, False, id="3-blocks"),
    pytest.param(96, 32, 0.25, True, id="3-blocks-drops"),
    pytest.param(96, 40, 1.25, False, id="fallback"),
    pytest.param(96, 40, 0.25, True, id="fallback-drops"),
]


@pytest.mark.parametrize("t,block,cf,drops", FFN_CASES)
def test_moe_ffn_and_aux_match_reference(ref_params, t, block, cf, drops):
    cfg, rcfg, jparams, params = ref_params
    cfg = cfg.replace(moe_block_tokens=block, capacity_factor=cf)
    rcfg = rcfg.replace(moe_block_tokens=block, capacity_factor=cf)
    rng = np.random.default_rng(3)
    d = cfg.d_model
    x = (rng.standard_normal((2, t // 2, d))
         + rng.standard_normal(d)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["ffn"])
    want, want_aux = ref_moe.moe_ffn(rcfg, jp, jnp.asarray(x))
    p = params["layers"][0]["ffn"]
    xt = torch.from_numpy(x)
    got = moe.moe_ffn(cfg, p, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(moe.aux_loss(cfg, p, xt)),
                               float(want_aux), **TOL)
    kept = moe.kept_assignments(cfg, p, xt)
    assert kept.shape == (t, cfg.n_experts)
    assert bool((kept.sum(1) <= cfg.top_k).all())
    if drops:
        assert int(kept.sum()) < t * cfg.top_k


def test_routing_is_sorted_stably():
    """An expert's slots go to its tokens in token order (the stable
    sort), slot 0 upward, so which tokens overflow depends on token order
    alone, not on the order of experts inside a token's top-k."""
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(capacity_factor=0.25)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_ffn(cfg, gen)
    x = torch.randn((1, 64, cfg.d_model), generator=gen) + \
        torch.randn((cfg.d_model,), generator=gen)
    r = moe.route(cfg, p, x[0])
    tok, slot_e, slot_c = r.token.numpy(), r.slot_e.numpy(), r.slot_c.numpy()
    for e in range(cfg.n_experts):
        mine = tok[slot_e == e]
        assert list(mine) == sorted(mine)
        assert list(slot_c[slot_e == e]) == list(range(len(mine)))
    assert r.cap == moe.capacity(cfg, 64) == 8
    assert not bool(r.keep.all())


@pytest.fixture(scope="module")
def reference_run(ref_params):
    """The reference's forward (hidden, aux), loss, prefill logits and 8
    decode steps' logits and cache lengths on the same prompt."""
    cfg, rcfg, jparams, params = ref_params
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, rcfg.vocab, (B, S))
    targets = rng.integers(2, rcfg.vocab, (B, S))
    feed = rng.integers(2, rcfg.vocab, (STEPS, B))
    hidden, aux = jax.jit(lambda p, t: ref_moe.forward(rcfg, p, t))(
        jparams, jnp.asarray(prompt))
    loss = ref_moe.loss_fn(rcfg, jparams, {"tokens": jnp.asarray(prompt),
                                           "targets": jnp.asarray(targets)})
    model = ref_get_model(rcfg)
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(B, MAX_LEN)
    logits, cache = jax.jit(model.prefill)(
        jparams, {"tokens": jnp.asarray(prompt)}, cache)
    out = [np.asarray(logits)]
    for t in range(STEPS):
        logits, cache = decode(jparams, jnp.asarray(feed[t], jnp.int32),
                               cache)
        out.append(np.asarray(logits))
    return dict(cfg=cfg, params=params, prompt=prompt, targets=targets,
                feed=feed, hidden=np.asarray(hidden), aux=float(aux),
                loss=float(loss), logits=out,
                length=np.asarray(cache["length"]))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_forward_matches_reference(reference_run, attn):
    r = reference_run
    with torch.no_grad():
        h, aux = moe.forward(r["cfg"], r["params"],
                             torch.from_numpy(r["prompt"]), attn=attn)
    np.testing.assert_allclose(h.numpy(), r["hidden"], **TOL)
    np.testing.assert_allclose(float(aux), r["aux"], **TOL)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_matches_reference(reference_run, attn):
    r = reference_run
    model = get_model(r["cfg"], device="cpu", attn=attn)
    loss = model.loss_fn(r["params"], {"tokens": r["prompt"],
                                       "targets": r["targets"]})
    np.testing.assert_allclose(float(loss), r["loss"], **TOL)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(reference_run, attn):
    r = reference_run
    cfg = r["cfg"]
    model = get_model(cfg, device="cpu", attn=attn)
    cache = model.init_cache(B, MAX_LEN)
    assert len(cache["layers"]) == cfg.n_layers
    logits, cache = model.prefill(
        r["params"], {"tokens": torch.from_numpy(r["prompt"])}, cache)
    np.testing.assert_allclose(logits.numpy(), r["logits"][0], **TOL)
    for t in range(STEPS):
        logits, cache = model.decode_step(
            r["params"], torch.from_numpy(r["feed"][t]), cache)
        np.testing.assert_allclose(logits.numpy(), r["logits"][t + 1],
                                   **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), r["length"])


def test_params_round_trip(ref_params):
    """``params_to_jax(params_from_jax(tree))`` is the reference tree, leaf
    for leaf, ``dense_layers`` included."""
    cfg, _, jparams, params = ref_params
    want = dict(tree_paths(jax.tree.map(np.asarray, jparams)))
    got = dict(tree_paths(params_to_jax(cfg, params)))
    assert got.keys() == want.keys()
    assert any(path[0] == "dense_layers" for path in got) == \
        bool(cfg.first_dense)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path])


def test_port_init_has_reference_shapes(ref_params):
    """The port's own init draws every leaf of the reference's tree at its
    shape and dtype."""
    cfg, _, jparams, _ = ref_params
    gen = torch.Generator().manual_seed(0)
    got = dict(tree_paths(params_to_jax(cfg, moe.init_params(cfg, gen))))
    want = dict(tree_paths(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    stats = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "4",
                        "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "kernel launches" in out
    assert stats["requests"] == 3 and stats["new_tokens"] > 0
    # CPU tensors run the plain versions: no kernel is launched
    assert all(v == 0 for v in stats["launches"].values())


def test_serve_cli_cuts_depth_keeping_dense_layers():
    """``--n-layers`` keeps deepseek's leading dense layer and serves the
    rest as MoE layers; a depth that leaves no MoE layer is refused."""
    stats = serve_main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                        "cpu", "--requests", "2", "--max-new", "2",
                        "--prompt-len", "8", "--n-layers", "2"])
    assert stats["n_layers"] == 2 and stats["new_tokens"] > 0
    with pytest.raises(SystemExit):
        serve_main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                    "cpu", "--n-layers", "1"])
