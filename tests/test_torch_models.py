"""The port's qwen3 model and server against the JAX package's, on the CPU.

Parameters are initialised by the reference (``jax.random``) and carried
across with ``params_from_jax``, since the two frameworks draw different
numbers from one seed.  SMOKE is f32, so the bound is f32's: atol 1e-4,
rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models import transformer as ref_transformer

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import get_model
from repro_torch.models import transformer

ARCH = "qwen3-0.6b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH, smoke=True)
    rcfg = ref_get_config(ARCH, smoke=True)
    jparams = ref_transformer.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, rcfg, jparams, params


@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_equal_reference(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(ref_get_config(ARCH, smoke=smoke))


def test_params_keep_key_paths(setup):
    cfg, _, jparams, params = setup
    assert len(params["layers"]) == cfg.n_layers
    ref_layer = jax.tree.map(lambda a: a[1], jparams["layers"][0])
    for (path, a), (jpath, b) in zip(
            jax.tree_util.tree_flatten_with_path(params["layers"][1])[0],
            jax.tree_util.tree_flatten_with_path(ref_layer)[0]):
        assert path == jpath
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


B, S, MAX_LEN, STEPS = 2, 12, 32, 8


@pytest.fixture(scope="module")
def reference_run(setup):
    """The reference's prefill logits and 8 decode steps' logits (jitted)."""
    _, rcfg, jparams, _ = setup
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, rcfg.vocab, (B, S))
    feed = rng.integers(2, rcfg.vocab, (STEPS, B))
    model = ref_get_model(rcfg)
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(B, MAX_LEN)
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompt)}, cache)
    out = [np.asarray(logits)]
    for t in range(STEPS):
        logits, cache = decode(jparams, jnp.asarray(feed[t], jnp.int32),
                               cache)
        out.append(np.asarray(logits))
    return prompt, feed, out, np.asarray(cache["length"])


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(setup, reference_run, attn):
    cfg, _, _, params = setup
    prompt, feed, want, want_length = reference_run
    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = transformer.prefill(cfg, params, torch.from_numpy(prompt),
                                        cache, attn=attn)
    np.testing.assert_allclose(logits.numpy(), want[0], **TOL)
    for t in range(STEPS):
        logits, cache = transformer.decode_step(
            cfg, params, torch.from_numpy(feed[t]), cache, attn=attn)
        np.testing.assert_allclose(logits.numpy(), want[t + 1], **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), want_length)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_forward_matches_reference(setup, reference_run, attn):
    cfg, rcfg, jparams, params = setup
    prompt = reference_run[0]
    want = jax.jit(lambda p, t: ref_transformer.forward(rcfg, p, t))(
        jparams, jnp.asarray(prompt))
    got = transformer.forward(cfg, params, torch.from_numpy(prompt),
                              attn=attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _reference_serve(rcfg, jparams, prompts, batch, max_new, max_len):
    """The loop of ``repro/launch/serve.py``, returning its tokens."""
    model = ref_get_model(rcfg)
    decode = jax.jit(model.decode_step, donate_argnums=(2,))
    queue = list(prompts)
    outputs = []
    while queue:
        batch_prompts = [queue.pop() for _ in
                         range(min(batch, len(queue)))]
        bs = len(batch_prompts)
        cache = model.init_cache(bs, max_len)
        logits, cache = model.prefill(
            jparams, {"tokens": jnp.asarray(np.stack(batch_prompts),
                                            jnp.int32)}, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        steps = [np.asarray(tok)]
        done = np.zeros(bs, bool)
        for _ in range(max_new):
            logits, cache = decode(jparams, tok, cache)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            steps.append(np.asarray(tok))
            done |= np.asarray(tok) == 1
            if done.all():
                break
        outputs.append(np.stack(steps, 1))
    return outputs


def test_serve_loop_gives_reference_tokens(setup):
    cfg, rcfg, jparams, params = setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, cfg.vocab, 10) for _ in range(5)]
    model = get_model(cfg, device="cpu")
    got, new_tokens = serve(model, params, prompts, batch=2, max_new=6,
                            max_len=24)
    want = _reference_serve(rcfg, jparams, prompts, 2, 6, 24)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert new_tokens > 0


def test_serve_cli_on_cpu(capsys):
    stats = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "4",
                        "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "kernel launches" in out
    assert stats["requests"] == 3 and stats["new_tokens"] > 0
    # CPU tensors run the plain versions: no kernel is launched
    assert all(v == 0 for v in stats["launches"].values())


VARIANTS = [
    # gemma3-like 1:1 local/global layers, rolling 8-slot caches; two
    # stacked subtrees per group exercise params_from_jax's unstacking
    dict(window=8, local_global=(1, 1)),
    # command-r / stablelm-like branches of the shared blocks
    dict(parallel_block=True, norm="layernorm", mlp="geglu", qk_norm=False,
         rope_frac=0.25, tie_embeddings=False, logit_softcap=30.0,
         embed_scale=True),
    dict(mlp="gelu", window=4),
]


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["local_global", "parallel", "gelu_window"])
def test_config_variants_match_reference(variant):
    cfg = get_config(ARCH, smoke=True).replace(**variant)
    rcfg = ref_get_config(ARCH, smoke=True).replace(**variant)
    jparams = ref_transformer.init_params(rcfg, jax.random.PRNGKey(3))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, cfg.vocab, (B, S))
    feed = rng.integers(2, cfg.vocab, (4, B))
    model = ref_get_model(rcfg)
    jcache = model.init_cache(B, MAX_LEN)
    jlogits, jcache = jax.jit(model.prefill)(
        jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    want = [np.asarray(jlogits)]
    decode = jax.jit(model.decode_step)
    for t in range(4):
        jlogits, jcache = decode(jparams, jnp.asarray(feed[t], jnp.int32),
                                 jcache)
        want.append(np.asarray(jlogits))
    for attn in ("kernel", "plain"):
        cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
        logits, cache = transformer.prefill(
            cfg, params, torch.from_numpy(prompt), cache, attn=attn)
        np.testing.assert_allclose(logits.numpy(), want[0], **TOL)
        for t in range(4):
            logits, cache = transformer.decode_step(
                cfg, params, torch.from_numpy(feed[t]), cache, attn=attn)
            np.testing.assert_allclose(logits.numpy(), want[t + 1], **TOL)
