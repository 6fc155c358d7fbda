"""The port's other dense configs (stablelm-12b, gemma3-12b,
command-r-plus-104b) against the JAX package's, on the CPU.

Each SMOKE model runs on parameters initialised by the reference
(``jax.random``) and carried across with ``params_from_jax``: the forward,
the prefill and 8 decode steps, through both attention paths, against
``repro.models``.  SMOKE is f32, so the bound is f32's, as in
``tests/test_torch_models.py``: atol 1e-4, rtol 1e-4.  gemma3's SMOKE (6
layers, 5 local : 1 global, window 8) gets a prompt of 20 tokens, so its
rolling caches wrap in the prefill and again while decoding.
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

from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer

ARCHS = ("stablelm-12b", "gemma3-12b", "command-r-plus-104b")
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
def reference_run(request):
    """(cfg, the port's params, prompt, decode feed, the reference's forward
    hidden states, prefill logits and 8 decode steps' logits, and its cache
    lengths), on JAX-initialised SMOKE weights."""
    arch = request.param
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    jparams = ref_transformer.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, rcfg.vocab, (B, S))
    feed = rng.integers(2, rcfg.vocab, (STEPS, B))
    hidden = jax.jit(lambda p, t: ref_transformer.forward(rcfg, p, t))(
        jparams, jnp.asarray(prompt))
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
    return (cfg, params, prompt, feed, np.asarray(hidden), out,
            np.asarray(cache["length"]))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_forward_matches_reference(reference_run, attn):
    cfg, params, prompt, _, want, _, _ = reference_run
    got = transformer.forward(cfg, params, torch.from_numpy(prompt),
                              attn=attn)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(reference_run, attn):
    cfg, params, prompt, feed, _, want, want_length = reference_run
    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    if cfg.window:
        # the local layers' caches roll: the prompt is longer than them
        assert cache["layers"][0]["k"].shape[2] == cfg.window < S
    logits, cache = transformer.prefill(cfg, params, torch.from_numpy(prompt),
                                        cache, attn=attn)
    np.testing.assert_allclose(logits.numpy(), want[0], **TOL)
    for t in range(STEPS):
        logits, cache = transformer.decode_step(
            cfg, params, torch.from_numpy(feed[t]), cache, attn=attn)
        np.testing.assert_allclose(logits.numpy(), want[t + 1], **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), want_length)


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


def test_serve_cli_cuts_depth_on_cpu():
    """``--n-layers`` keeps the width and serves fewer layers."""
    stats = serve_main(["--arch", "command-r-plus-104b", "--smoke",
                        "--device", "cpu", "--requests", "2", "--max-new",
                        "2", "--prompt-len", "8", "--n-layers", "1"])
    assert stats["n_layers"] == 1 and stats["new_tokens"] > 0
