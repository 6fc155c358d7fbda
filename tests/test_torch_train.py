"""The port's training kernels and model on the CPU, against the JAX package.

The LSE forward and the backward's plain versions are held against the
reference's Pallas kernels in interpret mode; the autograd Function with
grouped-query attention against ``jax.grad`` through the reference's
``dense_attention``; the SMOKE qwen3 ``loss_fn`` and all its gradients
against ``jax.value_and_grad`` of the reference's.  Inputs are made with
numpy and parameters by the reference (``params_from_jax``).  Bounds:
atol 1e-5 for the forward (``tests/test_kernels.py``'s fwd_lse bound),
2e-3 / 2e-2 for the f32 / bf16 backward (its backward bound), and the
f32 model bound of ``tests/test_torch_models.py`` (atol 1e-4, rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.kernels import flash_attention as jfa
from repro.models import attention as ref_attention
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    FlashAttention, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd_lse,
    flash_attention_fwd_lse_plain, flash_attention_plain)
from repro_torch.kernels.matmul import thread_tile
from repro_torch.kernels.tiling import (attention_bwd_blocks,
                                        flash_bwd_smem_bytes)
from repro_torch.models import get_model, transformer
from repro_torch.runtime.trainstep import make_loss_with_accum
from repro_torch.targets import H100
from repro_torch.tree import tree_paths

rng = np.random.default_rng(11)
ARCH = "qwen3-0.6b"
TOL = dict(atol=1e-4, rtol=1e-4)
_T = {"f32": torch.float32, "bf16": torch.bfloat16}
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def pair(*shape, dtype="f32"):
    """The same values as a torch and a jax array."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(_T[dtype]), jnp.asarray(x, _J[dtype])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def jax_paths(tree) -> dict:
    """{key path: numpy leaf} with the port's path convention."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# kernel 4: forward with LSE
# ---------------------------------------------------------------------------

LSE_CASES = [
    dict(sq=64, sk=64, causal=True, win=None),
    dict(sq=64, sk=64, causal=True, win=0),       # 0 = no window here
    dict(sq=64, sk=64, causal=True, win=16),
    dict(sq=64, sk=64, causal=False, win=None),
    dict(sq=64, sk=64, causal=False, win=16),
    dict(sq=32, sk=64, causal=True, win=None),    # q_offset = Sk - Sq
]


@pytest.mark.parametrize("case", LSE_CASES)
def test_fwd_lse_plain_matches_reference(case):
    bh, d = 2, 32
    (q, jq), (k, jk), (v, jv) = (pair(bh, case["sq"], d),
                                 pair(bh, case["sk"], d),
                                 pair(bh, case["sk"], d))
    out, lse = flash_attention_fwd_lse_plain(q, k, v, causal=case["causal"],
                                             window=case["win"])
    jout, jlse = jfa.flash_attention_fwd_lse(
        jq, jk, jv, causal=case["causal"], window=case["win"], block_q=32,
        block_kv=32, interpret=True)
    assert lse.shape == (bh, case["sq"], 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(f32(out), f32(jout), atol=1e-5)
    np.testing.assert_allclose(f32(lse), f32(jlse), atol=1e-5)


def test_fwd_lse_wrapper_on_cpu_is_the_plain_version():
    (q, _), (k, _), (v, _) = pair(4, 40, 16), pair(2, 40, 16), pair(2, 40, 16)
    before = flash_attention_fwd_lse.launches
    got = flash_attention_fwd_lse(q, k, v, window=8)
    want = flash_attention_fwd_lse_plain(q, k, v, window=8)
    assert flash_attention_fwd_lse.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("window", [None, 7, 0])
def test_forward_only_and_lse_forwards_agree(window):
    """The serve path's forward-only kernel and the LSE forward give the
    same output (window 0 read as none by the LSE forward, so it is
    compared with the forward-only None)."""
    (q, _), (k, _), (v, _) = pair(6, 50, 16), pair(3, 70, 16), pair(3, 70, 16)
    out, _ = flash_attention_fwd_lse(q, k, v, window=window)
    want = flash_attention(q, k, v, window=window or None)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_fully_masked_rows_give_zeros_and_floor_lse():
    (q, _), (k, _), (v, _) = pair(2, 8, 16), pair(2, 8, 16), pair(2, 8, 16)
    # q_offset -8: q row i sits at kv position i - 8, before every key
    out, lse = flash_attention_fwd_lse(q, k, v, q_offset=-8)
    assert not out.any() and torch.all(lse == -1e30)
    dout = torch.ones_like(q)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, q_offset=-8)
    for g in grads:
        assert torch.isfinite(g).all() and not g.any()


# ---------------------------------------------------------------------------
# kernel 5: backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,win", [(True, None), (True, 16),
                                        (False, None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_plain_matches_reference(causal, win, dtype):
    bh, s, d = 2, 64, 32
    (q, jq), (k, jk), (v, jv), (do, jdo) = (pair(bh, s, d, dtype=dtype)
                                            for _ in range(4))
    jout, jlse = jfa.flash_attention_fwd_lse(
        jq, jk, jv, causal=causal, window=win, block_q=32, block_kv=32,
        interpret=True)
    want = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo, causal=causal,
                                   window=win, block_q=32, block_kv=32,
                                   interpret=True)
    out = torch.from_numpy(np.array(f32(jout))).to(_T[dtype])
    lse = torch.from_numpy(np.array(f32(jlse)))
    got = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                    window=win)
    tol = 2e-2 if dtype == "bf16" else 2e-3
    for a, b in zip(got, want):
        assert a.dtype == _T[dtype]
        np.testing.assert_allclose(f32(a), f32(b), atol=tol)


def test_bwd_plain_sums_the_group_over_kv_heads():
    """With GQA the backward's dk/dv are the repeated-kv gradients summed
    over each kv head's group of q heads."""
    (q, _), (k, _), (v, _), (do, _) = (pair(6, 24, 16), pair(2, 24, 16),
                                       pair(2, 24, 16), pair(6, 24, 16))
    out, lse = flash_attention_fwd_lse_plain(q, k, v, causal=True)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    kr, vr = k.repeat_interleave(3, 0), v.repeat_interleave(3, 0)
    dq_r, dk_r, dv_r = flash_attention_bwd_plain(q, kr, vr, out, lse, do,
                                                 causal=True)
    torch.testing.assert_close(dq, dq_r)
    torch.testing.assert_close(dk, dk_r.reshape(2, 3, 24, 16).sum(1))
    torch.testing.assert_close(dv, dv_r.reshape(2, 3, 24, 16).sum(1))


# ---------------------------------------------------------------------------
# the autograd Function, through ops.covenant_attention
# ---------------------------------------------------------------------------


# (sq, sk, causal, window): causal self attention with and without a
# window, at a block multiple and a ragged edge; then the non-causal shapes
# of an encoder (Sq = Sk, ragged) and of a cross attention (Sq != Sk either
# way, ragged Sk), where the Function's q_offset = Sk - Sq masks nothing
FUNCTION_CASES = {"32-0": (32, 32, True, 0), "32-8": (32, 32, True, 8),
                  "20-0": (20, 20, True, 0), "20-8": (20, 20, True, 8),
                  "noncausal-45x45": (45, 45, False, 0),
                  "noncausal-12x45": (12, 45, False, 0),
                  "noncausal-45x12": (45, 12, False, 0),
                  "noncausal-1x37": (1, 37, False, 0)}


@pytest.mark.parametrize("sq,sk,causal,window",
                         list(FUNCTION_CASES.values()),
                         ids=list(FUNCTION_CASES))
def test_function_grads_match_jax_dense_attention(sq, sk, causal, window):
    """GQA (Hq 4, Hkv 2) gradients of sum(out * dout), the port's Function
    against ``jax.grad`` through the reference's ``dense_attention`` (the
    models' window: 0 is none; the reference's q_offset 0 where the
    non-causal masks read none)."""
    b, hq, hkv, d = 2, 4, 2, 16
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        pair(b, hq, sq, d), pair(b, hkv, sk, d), pair(b, hkv, sk, d),
        pair(b, hq, sq, d))

    def jloss(q_, k_, v_):
        o = ref_attention.dense_attention(q_, k_, v_, causal=causal,
                                          window=window)
        return jnp.sum(o * jdo)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.covenant_attention(*leaves, causal=causal,
                                 window=window or None)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    for a, bb in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(bb), atol=1e-5)


def test_function_window_zero_keeps_the_forward_mask():
    """``covenant_attention(window=0)`` masks everything with or without a
    gradient: the Function keeps the forward kernel's meaning of 0."""
    (q, _), (k, _), (v, _) = pair(1, 2, 16, 8), pair(1, 2, 16, 8), \
        pair(1, 2, 16, 8)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.covenant_attention(*leaves, window=0)
    assert not out.detach().any()
    out.sum().backward()
    assert all(t.grad is not None and not t.grad.any() for t in leaves)
    torch.testing.assert_close(out.detach(),
                               ops.covenant_attention(q, k, v, window=0))


def test_function_saves_no_probabilities():
    """The Function keeps q, k, v, out and the (BH, Sq, 1) lse for its
    backward, never the (Sq, Sk) probabilities."""
    q, k, v = (torch.randn(3, 40, 8, requires_grad=True) for _ in range(3))
    out = FlashAttention.apply(q, k, v, True, None, None, (16, 16), (16, 16),
                               0)
    shapes = sorted(tuple(t.shape) for t in out.grad_fn.saved_tensors)
    assert shapes == sorted([(3, 40, 8)] * 4 + [(3, 40, 1)])


def test_no_grad_attention_takes_the_forward_only_path():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with torch.no_grad():
        out = ops.covenant_attention(q, q.detach(), q.detach())
    assert out.grad_fn is None
    out = ops.covenant_attention(q.detach(), q.detach(), q.detach())
    assert out.grad_fn is None


def test_wrappers_refuse_other_devices():
    meta = torch.ones(2, 64, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention_fwd_lse(meta, meta, meta)
    lse = torch.ones(2, 64, 1, device="meta")
    with pytest.raises(ValueError):
        flash_attention_bwd(meta, meta, meta, meta, lse, meta)


# ---------------------------------------------------------------------------
# the backward's blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,d,heads", [(512, 512, 128, 64),
                                           (4096, 4096, 128, 16),
                                           (32, 32, 16, 8), (100, 100, 16, 8),
                                           (2048, 2048, 64, 128)])
def test_attention_bwd_blocks_fit_the_kernels(sq, sk, d, heads):
    bq, bkv = attention_bwd_blocks(sq, sk, d, heads=heads)
    assert flash_bwd_smem_bytes(bq, bkv, d) <= H100["smem_bytes_per_block"]
    # the kernels' register micro-tiles are at most 4 x 8 over 256 threads
    for rows, cols in ((bq, bkv), (bq, d), (bkv, d)):
        tm, tn, _, _ = thread_tile(rows, cols, max_tn=8, max_tm=4)
        assert tm <= 4 and tn <= 8


def test_attention_bwd_blocks_at_the_training_shape():
    # qwen3-0.6b, microbatch 4 x 512: the forward's 64 x 128 shrinks to fit
    assert attention_bwd_blocks(512, 512, 128, heads=64) == (64, 64)
    assert flash_bwd_smem_bytes(64, 64, 128) == 165_888


# ---------------------------------------------------------------------------
# the model: loss and every gradient
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config(ARCH, smoke=True)
    rcfg = ref_get_config(ARCH, smoke=True)
    rmodel = ref_get_model(rcfg)
    jparams = rmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    batch = RefSyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2,
                           seed=0).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(rmodel.loss_fn))(jparams,
                                                                jbatch)
    return cfg, params, batch, float(jloss), jax_paths(jgrads)


def _check_grads(cfg, grads, want: dict) -> None:
    got = list(tree_paths(params_to_jax(cfg, grads)))
    assert {p for p, _ in got} == set(want)
    for path, g in got:
        np.testing.assert_allclose(f32(g), want[path], **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_loss_and_grads_match_reference(smoke, attn):
    cfg, params, batch, jloss, jgrads = smoke
    model = get_model(cfg, device="cpu", attn=attn)
    loss, grads = make_loss_with_accum(model.loss_fn, 1)(params, batch)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    _check_grads(cfg, grads, jgrads)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_remat_gives_the_same_grads(smoke, attn):
    cfg, params, batch, _, jgrads = smoke
    model = get_model(cfg.replace(remat=False), device="cpu", attn=attn)
    _, grads = make_loss_with_accum(model.loss_fn, 1)(params, batch)
    _check_grads(cfg, grads, jgrads)


def test_kernel_path_carries_attention_grads(smoke):
    """Every attention weight gets a gradient through the kernel path, and
    it equals the plain path's (the CPU side of the card's check)."""
    cfg, params, batch, _, _ = smoke
    leaves = {n: t.clone().requires_grad_(True)
              for n, t in params["layers"][0]["attn"].items()}
    layers = [{**params["layers"][0], "attn": leaves}] + params["layers"][1:]
    p = {**params, "layers": layers}
    tokens = torch.as_tensor(batch["tokens"])
    got = {}
    for attn in ("kernel", "plain"):
        h = transformer.forward(cfg, p, tokens, attn=attn)
        got[attn] = torch.autograd.grad(h.square().sum(),
                                        list(leaves.values()))
    for name, a, b in zip(leaves, got["kernel"], got["plain"]):
        assert a is not None and a.abs().sum() > 0, name
        torch.testing.assert_close(a, b, **TOL)


def test_cross_entropy_matches_reference():
    from repro.models.common import cross_entropy as ref_ce

    from repro_torch.models.common import cross_entropy

    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    targets = rng.integers(0, 11, (2, 5))
    weights = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for w in (None, weights, np.zeros_like(weights)):
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(targets),
                            None if w is None else torch.from_numpy(w))
        want = ref_ce(jnp.asarray(logits), jnp.asarray(targets),
                      None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)
