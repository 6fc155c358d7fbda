"""The port's encoder-decoder and VLM families (whisper-base, paligemma-3b)
against the JAX package's, on the CPU.

Parameters come from the reference's ``jax.random`` init, carried across
with ``params_from_jax``; both packages get the same numpy inputs from a
seed (tokens, and the stub frontend's ``frames`` or ``patches``), and
their ``SyntheticLM`` draw the same batches with those extras.  SMOKE is
f32, so the bound is f32's, as in ``tests/test_torch_dense_configs.py``:
atol 1e-4, rtol 1e-4.  Both attention paths are held: on CPU tensors the
kernel path runs the kernels' plain versions through the same dispatch
(``ops.covenant_attention``, ``ops.covenant_decode_attention``) that
launches them on the card, and its gradient through ``FlashAttention``.
Training: the loss and every leaf's gradient against ``jax.grad`` of the
reference's ``loss_fn`` (whisper's encoder leaves and paligemma's
projector among them), one step in 2 microbatches against 1, and
``launch.train --smoke --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import attention as ref_attention
from repro.models import get_model as ref_get_model
from repro.models import paligemma as ref_paligemma
from repro.models import whisper as ref_whisper

from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import (from_reference_layout, params_from_jax,
                                 params_to_jax, to_reference_layout)
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.launch.train import main as train_main
from repro_torch.models import attention, get_model, paligemma, whisper
from repro_torch.runtime.trainstep import make_loss_with_accum
from repro_torch.tree import tree_map, tree_paths

ARCHS = ("whisper-base", "paligemma-3b")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN, STEPS = 2, 6, 32, 8
REF_MODULES = {"whisper-base": ref_whisper, "paligemma-3b": ref_paligemma}


def test_archs_equal_reference():
    assert set(PORT_ARCHS) == set(REF_ARCHS)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_extra_inputs_match_reference(arch, smoke):
    """Names, shapes at a batch and a sequence, and dtypes (bf16 at full
    size, f32 in SMOKE) of the stub frontend's inputs."""
    got = get_model(get_config(arch, smoke=smoke), device="cpu").extra_inputs
    want = ref_get_model(ref_get_config(arch, smoke=smoke)).extra_inputs
    assert got.keys() == want.keys() and len(got) == 1
    for name, (shape_fn, dtype) in got.items():
        assert shape_fn(3, 7) == want[name][0](3, 7)
        assert str(dtype).split(".")[-1] == jnp.dtype(want[name][1]).name


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "mamba2-2.7b", "zamba2-2.7b"])
def test_other_families_take_no_extra_inputs(arch):
    assert get_model(get_config(arch, smoke=True),
                     device="cpu").extra_inputs == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_extras_match_reference(arch):
    """The data pipeline draws the same batch, extras included, as the
    reference's from the same seed and step."""
    cfg = get_config(arch, smoke=True)
    extras = get_model(cfg, device="cpu").extra_inputs
    ref_extras = ref_get_model(ref_get_config(arch, smoke=True)).extra_inputs
    got = SyntheticLM(cfg.vocab, S, B, seed=3, extras=extras).batch(2)
    want = RefSyntheticLM(cfg.vocab, S, B, seed=3,
                          extras=ref_extras).batch(2)
    assert got.keys() == want.keys() == {"tokens", "targets", "weights",
                                         *extras}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# the non-causal dispatch: (Sq, Sk) with Sq < Sk (cross attention), Sq > Sk
# and one query row; 4 q heads over 2 kv heads
NONCAUSAL_CASES = [(5, 9), (9, 5), (1, 10), (7, 7)]


@pytest.mark.parametrize("sq,sk", NONCAUSAL_CASES)
@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_noncausal_attention_matches_reference(attn, sq, sk):
    """``prefill_attention(causal=False)`` against the reference's
    ``dense_attention(causal=False)``: no mask, whatever Sk - Sq is."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    got = attention.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False, attn=attn)
    want = ref_attention.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _inputs(cfg, model, seed: int = 1) -> dict:
    """Numpy inputs: a prompt, its targets, the decode feed and the stub
    frontend's output, standard normal f32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab, (B, S)),
           "targets": rng.integers(2, cfg.vocab, (B, S)),
           "feed": rng.integers(2, cfg.vocab, (STEPS, B))}
    for name, (shape_fn, _) in model.extra_inputs.items():
        out[name] = rng.standard_normal(shape_fn(B, S)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The reference's params and outputs on one arch's SMOKE config, and
    the port's params carried across: its training-path outputs (whisper:
    encoder states, decoder hidden states on the reference's encoder
    states; paligemma: forward hidden states), its loss, prefill logits,
    8 decode steps' logits and the cache lengths."""
    arch = request.param
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    rmodel = ref_get_model(rcfg)
    jparams = rmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    x = _inputs(cfg, rmodel)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    r = dict(cfg=cfg, arch=arch, jparams=jparams, params=params, x=x)
    if arch == "whisper-base":
        enc = jax.jit(lambda p, f: ref_whisper.encode(rcfg, p, f))(
            jparams, j["frames"])
        r["enc"] = np.asarray(enc)
        r["dec"] = np.asarray(jax.jit(
            lambda p, t, e: ref_whisper.decode_train(rcfg, p, t, e))(
                jparams, j["tokens"], enc))
        extra = {"frames": j["frames"]}
    else:
        r["hidden"] = np.asarray(jax.jit(
            lambda p, t, pa: ref_paligemma.forward(rcfg, p, t, pa))(
                jparams, j["tokens"], j["patches"]))
        extra = {"patches": j["patches"]}
    jbatch = {"tokens": j["tokens"], "targets": j["targets"], **extra}
    r["loss"] = float(REF_MODULES[arch].loss_fn(rcfg, jparams, jbatch))
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: REF_MODULES[arch].loss_fn(rcfg, p, jbatch)))(jparams)
    r["grads"] = {tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path): np.asarray(leaf)
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    cache = rmodel.init_cache(B, MAX_LEN)
    logits, cache = jax.jit(rmodel.prefill)(
        jparams, {"tokens": j["tokens"], **extra}, cache)
    r["prefill_length"] = np.asarray(cache["length"])
    out = [np.asarray(logits)]
    decode = jax.jit(rmodel.decode_step)
    for t in range(STEPS):
        logits, cache = decode(jparams, jnp.asarray(x["feed"][t], jnp.int32),
                               cache)
        out.append(np.asarray(logits))
    r["logits"], r["length"] = out, np.asarray(cache["length"])
    return r


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_training_forward_matches_reference(run, attn):
    """whisper's ``encode`` and ``decode_train``; paligemma's ``forward``
    over the image prefix and the text."""
    cfg, params, x = run["cfg"], run["params"], run["x"]
    if run["arch"] == "whisper-base":
        enc = whisper.encode(cfg, params, _t(x["frames"]), attn=attn)
        np.testing.assert_allclose(enc.numpy(), run["enc"], **TOL)
        dec = whisper.decode_train(cfg, params, _t(x["tokens"]),
                                   _t(run["enc"]), attn=attn)
        np.testing.assert_allclose(dec.numpy(), run["dec"], **TOL)
    else:
        h = paligemma.forward(cfg, params, _t(x["tokens"]),
                              _t(x["patches"]), attn=attn)
        assert h.shape == (B, cfg.vis_tokens + S, cfg.d_model)
        np.testing.assert_allclose(h.numpy(), run["hidden"], **TOL)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_matches_reference(run, attn):
    """``Model.loss_fn`` on the numpy batch (paligemma: CE on the text
    positions only)."""
    cfg, x = run["cfg"], run["x"]
    model = get_model(cfg, device="cpu", attn=attn)
    batch = {k: v for k, v in x.items() if k != "feed"}
    got = float(model.loss_fn(run["params"], batch))
    np.testing.assert_allclose(got, run["loss"], **TOL)


def _check_grads(cfg, grads, want: dict) -> None:
    """Every leaf of the port's gradient, in the reference's layout,
    against ``jax.grad``'s."""
    got = dict(tree_paths(params_to_jax(cfg, grads)))
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_and_grads_match_reference(run, attn):
    """The train step's loss and every leaf's gradient (``jax.grad`` of the
    reference's ``loss_fn``), under ``_layers``' remat.  whisper's encoder
    leaves get theirs only through each decoder layer's cross-attention
    k and v inside its checkpointed closure, and paligemma's projector
    only through the image prefix, which carries no targets: each is held
    explicitly, and must not be zero."""
    cfg, x = run["cfg"], run["x"]
    assert cfg.remat
    model = get_model(cfg, device="cpu", attn=attn)
    batch = {k: v for k, v in x.items() if k != "feed"}
    loss, grads = make_loss_with_accum(model.loss_fn, 1)(run["params"],
                                                         batch)
    np.testing.assert_allclose(float(loss), run["loss"], **TOL)
    _check_grads(cfg, grads, run["grads"])
    if cfg.family == "audio":
        held = [g for lp in grads["enc_layers"] for _, g in tree_paths(lp)]
        held += [grads["pos_enc"], grads["enc_ln_f"]["scale"]]
        assert len(held) > 2 + cfg.enc_layers
    else:
        held = [grads["projector"]]
    assert all(bool(g.abs().sum() > 0) for g in held)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_two_microbatches_give_one_microbatch_step(run, attn):
    """One step's loss and gradient in 2 microbatches equal those in 1:
    the chunking splits every key of the batch, the stub frontend's
    ``frames`` or ``patches`` with the tokens."""
    cfg, x = run["cfg"], run["x"]
    model = get_model(cfg, device="cpu", attn=attn)
    batch = {k: v for k, v in x.items() if k != "feed"}
    seen = []

    def loss_fn(p, b):
        seen.append({k: tuple(v.shape) for k, v in b.items()})
        return model.loss_fn(p, b)

    one = make_loss_with_accum(loss_fn, 1)(run["params"], batch)
    two = make_loss_with_accum(loss_fn, 2)(run["params"], batch)
    name = next(iter(model.extra_inputs))
    assert [s[name][0] for s in seen] == [B, B // 2, B // 2]
    assert all(s["tokens"][0] == s[name][0] for s in seen)
    np.testing.assert_allclose(float(two[0]), float(one[0]), **TOL)
    np.testing.assert_allclose(float(two[0]), run["loss"], **TOL)
    for (path, a), (_, b) in zip(tree_paths(two[1]), tree_paths(one[1])):
        np.testing.assert_allclose(a.numpy(), b.float().numpy(), **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(run, attn):
    """``Model.prefill`` then 8 decode steps: logits and cache lengths
    (paligemma's cache holds the image prefix and the prompt)."""
    cfg, params, x = run["cfg"], run["params"], run["x"]
    model = get_model(cfg, device="cpu", attn=attn)
    batch = {"tokens": _t(x["tokens"])}
    batch.update({n: _t(x[n]) for n in model.extra_inputs})
    logits, cache = model.prefill(params, batch, model.init_cache(B, MAX_LEN))
    np.testing.assert_allclose(logits.numpy(), run["logits"][0], **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  run["prefill_length"])
    assert int(cache["length"][0]) == S + cfg.vis_tokens
    for t in range(STEPS):
        logits, cache = model.decode_step(params, _t(x["feed"][t]), cache)
        np.testing.assert_allclose(logits.numpy(), run["logits"][t + 1],
                                   **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), run["length"])


def test_whisper_cache_layout():
    """whisper's cache: per decoder layer a self k/v of ``max_len`` and a
    cross k/v of ``enc_frames``, the cross one filled by the prefill with
    the encoder's keys and values, the self one with the prompt's."""
    cfg = get_config("whisper-base", smoke=True)
    model = get_model(cfg, device="cpu", attn="plain")
    params = model.init_params(0)
    x = _inputs(cfg, model)
    cache = model.init_cache(B, MAX_LEN)
    kv = (B, cfg.n_kv_heads)
    assert len(cache["self"]) == len(cache["cross"]) == cfg.n_layers
    assert cache["self"][0]["k"].shape == (*kv, MAX_LEN, cfg.hd)
    assert cache["cross"][0]["v"].shape == (*kv, cfg.enc_frames, cfg.hd)
    _, cache = model.prefill(params, {"tokens": _t(x["tokens"]),
                                      "frames": _t(x["frames"])}, cache)
    lp = params["dec_layers"][1]
    enc = whisper.encode(cfg, params, _t(x["frames"]))
    want_v = (enc @ lp["xattn"]["wv"]).reshape(
        B, cfg.enc_frames, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    np.testing.assert_allclose(cache["cross"][1]["v"].numpy(),
                               want_v.numpy(), **TOL)
    assert bool((cache["self"][0]["k"][:, :, S:] == 0).all())
    assert not bool((cache["self"][0]["k"][:, :, :S] == 0).any())


def test_params_round_trip(run):
    """``params_to_jax(params_from_jax(tree))`` is the reference tree, leaf
    for leaf: whisper's two stacked subtrees, paligemma's projector."""
    cfg = run["cfg"]
    want = dict(tree_paths(jax.tree.map(np.asarray, run["jparams"])))
    got = dict(tree_paths(params_to_jax(cfg, run["params"])))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    key = "dec_layers" if cfg.family == "audio" else "projector"
    assert any(path[0] == key for path in got)


def test_reference_layout_of_a_train_state(run):
    """``to_reference_layout`` finds the param-shaped subtrees of a train
    state (whisper's too, which has no ``layers`` key) and stacks them;
    ``from_reference_layout`` gives the state back exactly."""
    cfg, params = run["cfg"], run["params"]
    state = {"params": params, "opt": {
        "mu": tree_map(torch.zeros_like, params),
        "count": torch.tensor(3)}}
    ref = to_reference_layout(cfg, state)
    want = dict(tree_paths(jax.tree.map(np.asarray, run["jparams"])))
    for sub in (ref["params"], ref["opt"]["mu"]):
        got = dict(tree_paths(sub))
        assert got.keys() == want.keys()
        assert all(tuple(v.shape) == want[p].shape for p, v in got.items())
    back = from_reference_layout(cfg, ref)
    a, b = dict(tree_paths(back)), dict(tree_paths(state))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[p], b[p]) for p in a)


def test_port_init_has_reference_shapes(run):
    """The port's own init draws every leaf of the reference's tree at its
    shape and dtype."""
    cfg = run["cfg"]
    gen = torch.Generator().manual_seed(0)
    mod = whisper if cfg.family == "audio" else paligemma
    got = dict(tree_paths(params_to_jax(cfg, mod.init_params(cfg, gen))))
    want = dict(tree_paths(jax.tree.map(np.asarray, run["jparams"])))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_draws_extras_as_reference(arch):
    """``serve`` gives each batch's prefill the stub frontend's output drawn
    from the prompts' rng after every prompt, batch by batch, as the
    reference's serve loop draws it."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, device="cpu", attn="plain")
    seen = []

    def prefill(p, b, c):
        seen.append(b)
        return model.prefill(p, b, c)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab, 5) for _ in range(3)]
    serve(dataclasses.replace(model, prefill=prefill), model.init_params(0),
          prompts, batch=2, max_new=2, max_len=MAX_LEN, rng=rng)
    want = np.random.default_rng(3)
    [want.integers(2, cfg.vocab, 5) for _ in range(3)]
    assert [int(b["tokens"].shape[0]) for b in seen] == [2, 1]
    for b in seen:
        for name, (shape_fn, dtype) in model.extra_inputs.items():
            drawn = want.standard_normal(shape_fn(b["tokens"].shape[0], 5))
            assert b[name].dtype == dtype
            np.testing.assert_array_equal(b[name].numpy(),
                                          drawn.astype(np.float32))


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


def test_serve_cli_refuses_a_cache_short_of_the_vlm_stream(capsys):
    """paligemma's cache must hold its image prefix, the prompt and the new
    tokens (SMOKE: 8 + 12 + 4 = 24); one short of that is refused with the
    length it needs, exactly that serves."""
    args = ["--arch", "paligemma-3b", "--smoke", "--device", "cpu",
            "--requests", "2", "--max-new", "4", "--prompt-len", "12"]
    with pytest.raises(SystemExit):
        serve_main(args + ["--max-len", "23"])
    assert "--max-len 24" in capsys.readouterr().err
    assert serve_main(args + ["--max-len", "24"])["new_tokens"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, tmp_path, capsys, monkeypatch):
    """``launch.train --smoke --device cpu`` trains the arch: finite
    losses, no kernel launched (CPU tensors take the plain versions), and
    each step's batch carries the stub frontend's output, drawn as the
    reference's ``SyntheticLM`` draws it for the model's
    ``extra_inputs``."""
    from repro_torch.launch import train as train_mod

    cfg = get_config(arch, smoke=True)
    ref_extras = ref_get_model(ref_get_config(arch, smoke=True)).extra_inputs
    want = RefSyntheticLM(cfg.vocab, 8, 2, seed=0, extras={
        k: ((lambda b, s, fn=fn: fn(b, s)), dt)
        for k, (fn, dt) in ref_extras.items()})
    seen = []
    real = train_mod.SyntheticLM

    class Recording(real):
        def batch(self, step):
            out = super().batch(step)
            seen.append((step, out))
            return out

    monkeypatch.setattr(train_mod, "SyntheticLM", Recording)
    stats = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--seq-len", "8", "--global-batch",
                        "2", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                        "0", "--accel-target", "none"])
    out = capsys.readouterr().out
    assert "[train] done: 2 steps" in out and "kernel launches" in out
    rep = stats["report"]
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert all(v == 0 for v in stats["launches"].values())
    assert [s for s, _ in seen] == [0, 1]
    for step, got in seen:
        ref = want.batch(step)
        assert got.keys() == ref.keys() == {"tokens", "targets", "weights",
                                            *ref_extras}
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
