"""The port's roofline (``repro_torch.roofline``) against the reference's.

Each test of ``tests/test_roofline.py`` has its counterpart here: the
step counter (``collect_step``) sees every iteration of a loop and every
checkpointed recompute, as the reference's trip-count-aware HLO pricer
expands them, and prices a batched product, the residency threshold and
the three-term roofline alike.  ``param_count`` and ``model_flops`` equal
the reference's on every config and every dry-run cell.  On the same
SMOKE models and batch, the counted FLOPs of the port's loss and of its
loss and gradient come within a stated tolerance of the reference's
``analyze`` over ``jax.jit`` of its own.  (``tests/test_torch_dryrun.py``
holds the counts of the dry-run's records and of ``count_step``.)
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import configs as ref_configs
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import get_model as ref_get_model
from repro.roofline import model_flops as ref_model_flops
from repro.roofline import param_count as ref_param_count
from repro.roofline.hlo_cost import analyze

from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS, Roofline,
                                  collect_step, model_flops, param_count,
                                  roofline_terms)
from repro_torch.runtime.trainstep import _value_and_grad


def _mm_chain(x, n):
    for _ in range(n):
        x = x @ x
    return x


def test_loop_counts_every_iteration():
    x = torch.randn(128, 128)
    got = collect_step(_mm_chain, x, 10)["flops"]
    want = 10 * 2 * 128 ** 3
    assert abs(got - want) / want < 1e-4


def test_nested_loop_counts_every_iteration():
    def f(x):
        for _ in range(4):
            x = _mm_chain(x, 5)
        return x

    got = collect_step(f, torch.randn(128, 128))["flops"]
    want = 20 * 2 * 128 ** 3
    assert abs(got - want) / want < 1e-4


def test_remat_grad_counts_the_recompute():
    def grad(x):
        x = x.detach().requires_grad_(True)
        y = x
        for _ in range(8):
            y = checkpoint(lambda c: c @ c, y, use_reentrant=False)
        return torch.autograd.grad(y.sum(), x)

    got = collect_step(grad, torch.randn(128, 128) * 0.01)["flops"]
    # forward + recompute + backward (2 products a step) ~= 4x forward;
    # allow the reference's range [3x, 5x]
    fwd = 8 * 2 * 128 ** 3
    assert 3 * fwd <= got <= 5 * fwd


def test_flops_count_batched_product():
    a, b = torch.randn(4, 64, 32), torch.randn(4, 32, 16)
    got = collect_step(torch.einsum, "bij,bjk->bik", a, b)["flops"]
    want = 2 * 4 * 64 * 16 * 32
    assert abs(got - want) / want < 0.05


def test_bytes_respect_the_residency_threshold():
    # a small op's tensors stay on chip -> no HBM bytes
    small = torch.randn(64, 64)
    assert collect_step(torch.add, small, small)["bytes_accessed"] == 0
    # a big tensor crosses the threshold
    big = torch.randn(2048, 2048)
    assert collect_step(torch.add, big, big)["bytes_accessed"] >= \
        3 * 2048 * 2048 * 4


def test_constants_are_the_h100s():
    assert PEAK_FLOPS == 989e12       # bf16 dense, tensor cores
    assert HBM_BW == 3.35e12
    assert ICI_BW == 450e9            # NVLink 4, 18 links x 25 GB/s


def test_roofline_terms_and_bottleneck():
    rec = {"flops": PEAK_FLOPS, "bytes_accessed": 0.0,
           "collective_bytes": 0.0, "n_devices": 1}
    rl = roofline_terms(rec)
    assert isinstance(rl, Roofline)
    assert rl.bottleneck == "compute"
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.compute_fraction == pytest.approx(1.0)
    # the reference's 1e12 bytes are 20 s of its link; 20 s of NVLink's
    rl2 = roofline_terms(dict(rec, collective_bytes=20 * ICI_BW))
    assert rl2.bottleneck == "collective"
    assert rl2.compute_fraction < 0.1
    rl3 = roofline_terms(dict(rec, bytes_accessed=1e13))
    assert rl3.bottleneck == "memory"
    assert rl3.step_s == pytest.approx(1e13 / HBM_BW)


@pytest.mark.parametrize("arch,expected_b", [
    ("command-r-plus-104b", (95, 115)),
    ("gemma3-12b", (10, 14)),
    ("stablelm-12b", (11, 14)),
    ("qwen3-0.6b", (0.5, 0.9)),
    ("deepseek-moe-16b", (14, 20)),
    ("olmoe-1b-7b", (6, 8)),
    ("mamba2-2.7b", (2.4, 3.1)),
    # backbone only: the "3b" includes the ~400M SigLIP tower (a stub here)
    ("paligemma-3b", (1.7, 2.1)),
    ("zamba2-2.7b", (2.2, 3.2)),
    ("whisper-base", (0.05, 0.11)),
])
def test_param_counts_equal_the_reference_and_published(arch, expected_b):
    total, active = param_count(configs.get_config(arch))
    assert (total, active) == ref_param_count(ref_configs.get_config(arch))
    lo, hi = expected_b
    assert lo <= total / 1e9 <= hi, f"{arch}: {total / 1e9:.2f}B"
    assert active <= total


def test_moe_active_params_much_smaller():
    total, active = param_count(configs.get_config("deepseek-moe-16b"))
    assert active < 0.35 * total  # 6+2 of 64 experts active


CELLS = [(a, s) for a, s, _, _ in configs.cells(include_skipped=True)]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_reference(arch, shape):
    sh = configs.SHAPES[shape]
    ref_sh = ref_configs.SHAPES[shape]
    assert model_flops(configs.get_config(arch), sh, sh.kind) == \
        ref_model_flops(ref_configs.get_config(arch), ref_sh, ref_sh.kind)


def test_model_flops_train_is_3x_forward_same_shape():
    cfg = configs.get_config("qwen3-0.6b")
    shape = configs.SHAPES["train_4k"]
    tr = model_flops(cfg, shape, "train")
    fw = model_flops(cfg, shape, "prefill")
    assert tr == pytest.approx(3 * fw, rel=1e-6)


# Counted FLOPs of the port's step against ``analyze`` of the reference's
# HLO, SMOKE in f32 at B 2, S 64, by the tolerance each family measured
# on the CPU (loss, loss and gradient).  Both count every matmul alike
# (qwen3's 31 457 280 of the loss equal); the rest is elementwise work:
# qwen3 1.3 % / 1.2 % under, olmoe 0.5 % / 0.8 % under, mamba2 7.7 % /
# 6.6 % under, where XLA's fusions compute the depthwise conv's
# multiply-adds again in each fusion that reads the conv (24 multiplies of
# its (2, 64, 160) surface a layer in the HLO, 4 in the eager step).
PARITY = [("qwen3-0.6b", 0.05), ("olmoe-1b-7b", 0.05),
          ("mamba2-2.7b", 0.10)]
B, S = 2, 64


@pytest.fixture(scope="module", params=PARITY, ids=[a for a, _ in PARITY])
def parity(request):
    """(arch, tolerance, the reference's analyze of its loss and of its
    loss and gradient, the port's model, params and batch)."""
    arch, tol = request.param
    rcfg = ref_configs.get_config(arch, smoke=True)
    rmodel = ref_get_model(rcfg)
    jparams = rmodel.init_params(jax.random.PRNGKey(0))
    batch = RefSyntheticLM(vocab=rcfg.vocab, seq_len=S, global_batch=B,
                           seed=0).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {name: analyze(jax.jit(fn).lower(jparams, jbatch).compile()
                          .as_text())["flops"]
            for name, fn in (("loss", rmodel.loss_fn),
                             ("grad", jax.value_and_grad(rmodel.loss_fn)))}
    model = get_model(configs.get_config(arch, smoke=True), device="cpu",
                      attn="plain")
    return arch, tol, want, model, model.init_params(0), batch


def test_loss_flops_match_the_reference_analyze(parity):
    arch, tol, want, model, params, batch = parity
    with torch.no_grad():
        got = collect_step(model.loss_fn, params, batch)["flops"]
    assert abs(got - want["loss"]) / want["loss"] < tol, (arch, got, want)


def test_grad_flops_match_the_reference_analyze(parity):
    arch, tol, want, model, params, batch = parity
    got = collect_step(_value_and_grad, model.loss_fn, params,
                       batch)["flops"]
    assert abs(got - want["grad"]) / want["grad"] < tol, (arch, got, want)
