"""Training of the MoE family and the other dense configs against the JAX
package, on the CPU: deepseek-moe-16b, olmoe-1b-7b, gemma3-12b,
stablelm-12b and command-r-plus-104b.

For each SMOKE config the loss and every gradient leaf of the port's
``loss_fn`` (through ``make_loss_with_accum``, as the train step takes it)
are held against ``jax.jit(jax.value_and_grad(rmodel.loss_fn))`` of the
reference's, on the same 2 x 32 token batch, with the reference's weights
carried across (``params_from_jax``).  Both attention paths are held, with
remat (the configs' default) and without.  The MoE archs run at their
capacity factor and at 0.25, where the dispatch drops assignments (and the
test asserts that it did): the reference's gradient, which drops its own,
is the check that they were the same ones.  gemma3's SMOKE window of 8
bites at 32 tokens.  SMOKE is f32, so the bound is the train parity tests'
(``tests/test_torch_train.py``): atol 1e-4, rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch.train import main as train_main
from repro_torch.models import get_model, moe
from repro_torch.runtime.trainstep import make_loss_with_accum
from repro_torch.tree import tree_paths

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 32
# (arch, capacity factor: None keeps the config's)
CASES = [("deepseek-moe-16b", None), ("deepseek-moe-16b", 0.25),
         ("olmoe-1b-7b", None), ("olmoe-1b-7b", 0.25),
         ("gemma3-12b", None), ("stablelm-12b", None),
         ("command-r-plus-104b", None)]


def _id(case) -> str:
    arch, cf = case
    return arch if cf is None else f"{arch}-cf{cf}"


@pytest.fixture(scope="module", params=CASES, ids=_id)
def run(request):
    """(cfg, the port's params, the batch, the reference's loss, its
    gradient leaves by key path)."""
    arch, cf = request.param
    cfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    if cf is not None:
        cfg, rcfg = (c.replace(capacity_factor=cf) for c in (cfg, rcfg))
    rmodel = ref_get_model(rcfg)
    jparams = rmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    batch = RefSyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                           seed=0).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(rmodel.loss_fn))(jparams,
                                                                jbatch)
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    return cfg, params, batch, float(jloss), want


def _loss_and_grads(cfg, params, batch, attn, monkeypatch):
    """The port's loss and gradient, and the assignments its dispatch
    dropped over the forward (0 for a dense config)."""
    dropped = []
    route = moe.route

    def recording(*args):
        r = route(*args)
        dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(moe, "route", recording)
    model = get_model(cfg, device="cpu", attn=attn)
    loss, grads = make_loss_with_accum(model.loss_fn, 1)(params, batch)
    return loss, grads, sum(dropped)


def _check(cfg, loss, grads, jloss, want) -> None:
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    got = dict(tree_paths(params_to_jax(cfg, grads)))
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[path], **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_and_grads_match_reference(run, attn, monkeypatch):
    """The loss and every leaf's gradient under remat; the MoE archs at
    0.25 must drop assignments, and every leaf of an MoE layer's FFN gets
    a gradient."""
    cfg, params, batch, jloss, want = run
    assert cfg.remat
    loss, grads, dropped = _loss_and_grads(cfg, params, batch, attn,
                                           monkeypatch)
    _check(cfg, loss, grads, jloss, want)
    if cfg.family == "moe":
        assert dropped > 0 or cfg.capacity_factor >= 1
        ffn = grads["layers"][0]["ffn"]
        assert all(bool(ffn[k].abs().sum() > 0)
                   for k in ("router", "wi", "wg", "wo"))


def test_grads_without_remat_match_reference(run, monkeypatch):
    """The same gradients with every layer's activations kept
    (``remat=False``), through the kernel path."""
    cfg, params, batch, jloss, want = run
    loss, grads, _ = _loss_and_grads(cfg.replace(remat=False), params, batch,
                                     "kernel", monkeypatch)
    _check(cfg, loss, grads, jloss, want)


# ---------------------------------------------------------------------------
# launch.train on these archs, and its --n-layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [("olmoe-1b-7b", 0),
                                           ("deepseek-moe-16b", 2),
                                           ("gemma3-12b", 6)])
def test_train_cli_on_cpu(arch, n_layers, tmp_path, capsys):
    """``launch.train --smoke --device cpu`` trains 3 steps at the given
    depth (0: the config's) with finite losses; CPU tensors take the plain
    versions, so no kernel is launched."""
    stats = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "3", "--seq-len", "16", "--global-batch",
                        "2", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                        "0", "--n-layers", str(n_layers)])
    out = capsys.readouterr().out
    assert "[train] done: 3 steps" in out
    rep = stats["report"]
    assert rep.steps_run == 3 and all(np.isfinite(rep.losses))
    assert stats["n_layers"] == (n_layers or
                                 get_config(arch, smoke=True).n_layers)
    assert all(v == 0 for v in stats["launches"].values())


@pytest.mark.parametrize("arch,n_layers,why", [
    ("deepseek-moe-16b", 1, "leading dense"),
    ("deepseek-moe-16b", -2, "leading dense"),
    ("olmoe-1b-7b", -1, "leading dense"),
    ("gemma3-12b", 4, "groups of 6"),
    ("zamba2-2.7b", 4, "groups of 3"),
    ("whisper-base", 2, "encoder")])
def test_train_cli_refuses_depths_it_cannot_cut(arch, n_layers, why, capsys):
    """``--n-layers`` exits 2 with a reason, never an ``AssertionError``,
    on a depth that keeps no layer past deepseek's dense one, splits the
    arch's layer groups, or would leave whisper's encoder whole."""
    with pytest.raises(SystemExit) as e:
        train_main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--n-layers", str(n_layers), "--ckpt-every", "0"])
    assert e.value.code == 2
    assert why in capsys.readouterr().err
