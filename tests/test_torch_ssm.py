"""The port's SSM slice against the JAX package's, on the CPU.

The SSD chunk scan's plain version against the reference's Pallas kernel
in interpret mode, ``covenant_ssd`` and the oracles against theirs, and the
mamba2 and zamba2 SMOKE models (forward, loss, prefill, decode, serving,
gradients) with the reference's weights carried across by
``params_from_jax``.  Kernel bounds are ``tests/test_kernels.py``'s (atol
2e-3); SMOKE is f32, so the model bound is f32's (atol 1e-4, rtol 1e-4, as
in ``tests/test_torch_models.py``).  ``attn="kernel"`` runs the kernels'
plain versions here: CPU tensors never launch a kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import ssd_scan as ref_ssd_scan
from repro.models import get_model as ref_get_model
from repro.models import ssm as ref_ssm

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (ssd_chunk_local_plain,
                                          ssd_chunk_scan,
                                          ssd_chunk_scan_plain)
from repro_torch.kernels.tiling import (SSD_MMA_BLOCK_C, SSD_MMA_BLOCK_L,
                                        ssd_mma_blocks, ssd_mma_smem_bytes,
                                        ssd_state_smem_bytes)
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import get_model, ssm
from repro_torch.targets import H100
from repro_torch.tree import tree_map, tree_paths

KERNEL_ATOL = 2e-3
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")

rng = np.random.default_rng(11)

SSD_CASES = [
    dict(b=2, s=64, h=4, p=16, g=2, n=8, chunk=16),
    dict(b=1, s=100, h=4, p=8, g=4, n=16, chunk=32),
    dict(b=2, s=33, h=2, p=8, g=1, n=4, chunk=16),
    dict(b=1, s=16, h=2, p=4, g=2, n=4, chunk=16),  # single chunk
]


def _ssd_inputs(case):
    b, s, h, p, g, n = (case[k] for k in "bshpgn")
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _head_batched(case, x, dt, A, B, C):
    """The reference's own padding and layout (``ops.covenant_ssd``): S
    padded to the chunk, heads folded into rows, B and C repeated to every
    head.  Also returns B and C per group, unrepeated, as the port's kernel
    reads them."""
    b, s, h, p, g, n = (case[k] for k in "bshpgn")
    ck = min(case["chunk"], s)
    spad = -(-s // ck) * ck

    def pad(a):
        return np.pad(a, [(0, 0), (0, spad - s)] + [(0, 0)] * (a.ndim - 2))

    xf = pad(x).transpose(0, 2, 1, 3).reshape(b * h, spad, p)
    dtf = pad(dt).transpose(0, 2, 1).reshape(b * h, spad)
    bg = pad(B).transpose(0, 2, 1, 3).reshape(b * g, spad, n)
    cg = pad(C).transpose(0, 2, 1, 3).reshape(b * g, spad, n)
    rep = h // g
    bh, ch = (np.repeat(t, rep, axis=0) for t in (bg, cg))
    af = np.tile(A, b)
    return ck, xf, dtf, af, bh, ch, bg, cg


def _pallas_cells(x, dt, A, B, C, chunk):
    """The reference kernel's own per-cell outputs (y_intra, states, dsums):
    its ``_ssd_chunk_kernel`` under the grid and BlockSpecs that
    ``ssd_chunk_scan`` gives it, in interpret mode."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nck = s // chunk
    return pl.pallas_call(
        ref_ssd_scan._ssd_chunk_kernel,
        grid=(bh, nck),
        in_specs=[
            pl.BlockSpec((1, chunk, p), lambda b, c: (b, c, 0)),
            pl.BlockSpec((1, chunk, 1), lambda b, c: (b, c, 0)),
            pl.BlockSpec((1, chunk, n), lambda b, c: (b, c, 0)),
            pl.BlockSpec((1, chunk, n), lambda b, c: (b, c, 0)),
            pl.BlockSpec((1,), lambda b, c: (b,), memory_space=pltpu.SMEM),
        ],
        out_specs=[
            pl.BlockSpec((1, chunk, p), lambda b, c: (b, c, 0)),
            pl.BlockSpec((1, n, p), lambda b, c: (b * nck + c, 0, 0)),
            pl.BlockSpec((1, 1), lambda b, c: (b * nck + c, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bh, s, p), jnp.float32),
            jax.ShapeDtypeStruct((bh * nck, n, p), jnp.float32),
            jax.ShapeDtypeStruct((bh * nck, 1), jnp.float32),
        ],
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(dt)[..., None], jnp.asarray(B),
      jnp.asarray(C), jnp.asarray(A))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_local_plain_matches_pallas_cells(case):
    """y_intra, the chunk states and the decay sums of each (bh, chunk)
    cell; the port reads B and C per group, the reference repeated."""
    ck, xf, dtf, af, bh, ch, bg, cg = _head_batched(case, *_ssd_inputs(case))
    want = _pallas_cells(xf, dtf, af, bh, ch, ck)
    got = ssd_chunk_local_plain(_t(xf), _t(dtf), _t(af), _t(bg), _t(cg),
                                chunk=ck)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2])[:, 0],
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "init_state"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_scan_plain_matches_reference_interpret(case, init):
    ck, xf, dtf, af, bh, ch, bg, cg = _head_batched(case, *_ssd_inputs(case))
    st0 = rng.standard_normal((xf.shape[0], case["n"], case["p"])).astype(
        np.float32) if init else None
    wy, wst = ref_ssd_scan.ssd_chunk_scan(
        jnp.asarray(xf), jnp.asarray(dtf), jnp.asarray(af), jnp.asarray(bh),
        jnp.asarray(ch), chunk=ck, interpret=True,
        init_state=None if st0 is None else jnp.asarray(st0))
    for b_, c_ in ((bg, cg), (bh, ch)):   # per group, and repeated
        y, st = ssd_chunk_scan_plain(
            _t(xf), _t(dtf), _t(af), _t(b_), _t(c_), chunk=ck,
            init_state=None if st0 is None else _t(st0))
        np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                   atol=KERNEL_ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(wst),
                                   atol=KERNEL_ATOL)
    # on a CPU tensor the wrapper runs the plain version: no launch
    before = ssd_chunk_scan.launches
    got = ssd_chunk_scan(_t(xf), _t(dtf), _t(af), _t(bg), _t(cg), chunk=ck)
    assert ssd_chunk_scan.launches == before
    assert got[0].shape == xf.shape


def test_chunk_scan_rejects_bad_shapes():
    x = torch.zeros(4, 32, 8)
    dt, A = torch.zeros(4, 32), torch.zeros(4)
    B = torch.zeros(3, 32, 4)             # 3 rows do not divide 4 heads
    with pytest.raises(ValueError):
        ssd_chunk_scan(x, dt, A, B, B, chunk=16)
    with pytest.raises(ValueError):       # S not a chunk multiple
        ssd_chunk_scan(x, dt, A, B[:2], B[:2], chunk=12)


# ---------------------------------------------------------------------------
# covenant_ssd and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES)
def test_covenant_ssd_matches_reference(case):
    x, dt, A, B, C = _ssd_inputs(case)
    st0 = rng.standard_normal((case["b"], case["h"], case["p"],
                               case["n"])).astype(np.float32)
    for init in (None, st0):
        got, st = ops.covenant_ssd(
            _t(x), _t(dt), _t(A), _t(B), _t(C), chunk=case["chunk"],
            return_state=True, init_state=None if init is None else _t(init))
        want, wst = ref_ops.covenant_ssd(
            jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B),
            jnp.asarray(C), chunk=case["chunk"], return_state=True,
            init_state=None if init is None else jnp.asarray(init),
            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_ATOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(wst),
                                   atol=KERNEL_ATOL)
        # and against the sequential oracle, as the reference test holds it
        rv, rst = ref.ssd_ref(_t(x), _t(dt), _t(A), _t(B), _t(C),
                              init_state=None if init is None else _t(init),
                              return_state=True)
        np.testing.assert_allclose(got.numpy(), rv.numpy(), atol=KERNEL_ATOL)
        np.testing.assert_allclose(st.numpy(), rst.numpy(), atol=KERNEL_ATOL)


def test_covenant_ssd_init_state_continuation():
    """Splitting a sequence across two calls == one call (decode
    contract): ``tests/test_kernels.py::test_ssd_init_state_continuation``."""
    case = dict(b=1, s=64, h=2, p=8, g=2, n=8, chunk=16)
    x, dt, A, B, C = (_t(a) for a in _ssd_inputs(case))
    y_full, st_full = ops.covenant_ssd(x, dt, A, B, C, chunk=16,
                                       return_state=True)
    half = 32
    y1, st1 = ops.covenant_ssd(x[:, :half], dt[:, :half], A, B[:, :half],
                               C[:, :half], chunk=16, return_state=True)
    y2, st2 = ops.covenant_ssd(x[:, half:], dt[:, half:], A, B[:, half:],
                               C[:, half:], chunk=16, init_state=st1,
                               return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=KERNEL_ATOL)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(),
                               atol=KERNEL_ATOL)


def test_covenant_ssd_decay_reduces_state_influence():
    case = dict(b=1, s=32, h=2, p=4, g=2, n=4, chunk=16)
    x, _, _, B, C = (_t(a) for a in _ssd_inputs(case))
    dt = torch.full((1, 32, 2), 0.1)
    _, slow = ops.covenant_ssd(x, dt, torch.tensor([-0.1, -0.1]), B, C,
                               chunk=16, return_state=True)
    _, fast = ops.covenant_ssd(x, dt, torch.tensor([-8.0, -8.0]), B, C,
                               chunk=16, return_state=True)
    assert float(fast.norm()) < float(slow.norm())


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_matches_reference(case):
    x, dt, A, B, C = _ssd_inputs(case)
    D = rng.standard_normal(case["h"]).astype(np.float32)
    st0 = rng.standard_normal((case["b"], case["h"], case["p"],
                               case["n"])).astype(np.float32)
    got, st = ref.ssd_ref(_t(x), _t(dt), _t(A), _t(B), _t(C), D=_t(D),
                          init_state=_t(st0), return_state=True)
    want, wst = ref_ref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                D=jnp.asarray(D), init_state=jnp.asarray(st0),
                                return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=1e-5)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_reference(case):
    x, dt, A, B, C = _ssd_inputs(case)
    st0 = rng.standard_normal((case["b"], case["h"], case["n"],
                               case["p"])).astype(np.float32)
    for init in (None, st0):
        got, st = ssm.ssd_chunked(
            _t(x), _t(dt), _t(A), _t(B), _t(C), chunk=case["chunk"],
            init_state=None if init is None else _t(init))
        want, wst = ref_ssm.ssd_chunked(
            *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk=case["chunk"],
            init_state=None if init is None else jnp.asarray(init))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=1e-5)


def test_ssd_blocks_fit_the_card():
    """The tensor-core kernel's blocks: built sizes (16-row warps), the
    intra block within half the SM's shared memory (two blocks an SM) and
    the state block within one block's; bf16 inputs in one part, f32 in
    two.  mamba2 and zamba2 prefill shapes, chip_smoke's ssd_ref check,
    a SMOKE chunk."""
    half = H100["smem_bytes_per_block"] // 2 - 1024
    for chunk, n, p, heads, parts in ((512, 128, 64, 1280, 1),
                                      (512, 64, 64, 1280, 2),
                                      (512, 128, 64, 16, 2),
                                      (8, 16, 16, 12, 1)):
        bl, bc = ssd_mma_blocks(chunk, n, p, heads=heads, parts=parts)
        assert bl in SSD_MMA_BLOCK_L and bl % 16 == 0
        assert bc in SSD_MMA_BLOCK_C and bc % 16 == 0
        assert ssd_mma_smem_bytes(bl, bc, chunk, n, parts) <= half
        assert ssd_state_smem_bytes(chunk, n, parts) <= \
            H100["smem_bytes_per_block"]


# ---------------------------------------------------------------------------
# the SSD's gradient: the autograd Function around the chunk-local stage
# ---------------------------------------------------------------------------


def _grad_inputs(case):
    x, dt, A, B, C = _ssd_inputs(case)
    st0 = rng.standard_normal((case["b"], case["h"], case["p"],
                               case["n"])).astype(np.float32)
    u = rng.standard_normal(x.shape).astype(np.float32)
    w = rng.standard_normal(st0.shape).astype(np.float32)
    return (x, dt, A, B, C, st0), u, w


def _port_grads(case, inputs, u, w):
    """Gradients of sum(y u) + sum(state w) through the port's
    ``covenant_ssd``, whose chunk-local stage is ``SsdChunkLocal`` (on a
    CPU tensor its forward is the plain local stage)."""
    leaves = [_t(a).requires_grad_(True) for a in inputs]
    y, st = ops.covenant_ssd(*leaves[:5], chunk=case["chunk"],
                             init_state=leaves[5], return_state=True)
    ((y * _t(u)).sum() + (st * _t(w)).sum()).backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_grads_match_reference_kernel(case):
    """Each input's gradient against the reference's ``covenant_ssd``
    (the Pallas kernel in interpret mode), along a random direction:
    pallas_call has no reverse-mode rule, so the reference side is
    ``jax.jvp``; each directional derivative agrees to 2e-3."""
    inputs, u, w = _grad_inputs(case)
    grads = _port_grads(case, inputs, u, w)
    prim = tuple(jnp.asarray(a) for a in inputs)

    def loss(x, dt, A, B, C, st0):
        y, st = ref_ops.covenant_ssd(x, dt, A, B, C, chunk=case["chunk"],
                                     init_state=st0, return_state=True,
                                     interpret=True)
        return jnp.sum(y * u) + jnp.sum(st * w)

    jvp = jax.jit(lambda t: jax.jvp(loss, prim, t)[1])
    for i, g in enumerate(grads):
        v = rng.standard_normal(g.shape).astype(np.float32)
        tang = tuple(jnp.asarray(v) if j == i else jnp.zeros_like(a)
                     for j, a in enumerate(prim))
        want = float(jvp(tang))
        got = float(np.sum(g.astype(np.float64) * v))
        assert abs(got - want) <= 2e-3 * max(1.0, abs(want)), (i, got, want)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_grads_match_ssd_chunked(case):
    """Every gradient element against ``jax.grad`` through the reference
    model's ``ssd_chunked`` (the reference's own training path), at 2e-3."""
    inputs, u, w = _grad_inputs(case)
    grads = _port_grads(case, inputs, u, w)

    def loss(x, dt, A, B, C, st0):
        y, st = ref_ssm.ssd_chunked(x, dt, A, B, C, chunk=case["chunk"],
                                    init_state=st0.swapaxes(-1, -2))
        return jnp.sum(y * u) + jnp.sum(st.swapaxes(-1, -2) * w)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in inputs))
    for g, wg in zip(grads, want):
        np.testing.assert_allclose(g, np.asarray(wg), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# the mamba2 and zamba2 SMOKE models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    model = ref_get_model(rcfg)
    jparams = model.init_params(jax.random.PRNGKey(0))
    if "loras" in jparams:
        # the reference starts each LoRA's up projection at zero; give them
        # values, so that the per-use adapters take part in the comparison
        r = np.random.default_rng(5)
        jparams = {**jparams, "loras": {
            k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32)
                            * 0.1) if k in ("qb", "ib") else v)
            for k, v in jparams["loras"].items()}}
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, rcfg, model, jparams, params


B, S, MAX_LEN, STEPS = 2, 13, 32, 5


@pytest.fixture(scope="module")
def reference_run(setup):
    """The reference's prefill logits, STEPS decode steps' logits and a
    loss and gradient, jitted."""
    cfg, rcfg, model, jparams, _ = setup
    r = np.random.default_rng(1)
    prompt = r.integers(2, cfg.vocab, (B, S))
    feed = r.integers(2, cfg.vocab, (STEPS, B))
    cache = model.init_cache(B, MAX_LEN)
    logits, cache = jax.jit(model.prefill)(
        jparams, {"tokens": jnp.asarray(prompt)}, cache)
    out = [np.asarray(logits)]
    decode = jax.jit(model.decode_step)
    for t in range(STEPS):
        logits, cache = decode(jparams, jnp.asarray(feed[t], jnp.int32),
                               cache)
        out.append(np.asarray(logits))
    batch = {"tokens": prompt, "targets": r.integers(0, cfg.vocab, (B, S))}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    hidden = jax.jit(lambda p, t: _ref_forward(rcfg)(rcfg, p, t))(
        jparams, jnp.asarray(prompt))
    return dict(prompt=prompt, feed=feed, logits=out, batch=batch,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                hidden=np.asarray(hidden),
                length=np.asarray(cache["length"]))


def _ref_forward(rcfg):
    from repro.models import mamba, zamba

    return (mamba if rcfg.family == "ssm" else zamba).forward


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke=smoke))


def test_params_round_trip(setup):
    cfg, _, _, jparams, params = setup
    back = params_to_jax(cfg, params)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), back))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(params["layers"]) == cfg.n_layers


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_prefill_and_decode_match_reference(setup, reference_run, attn):
    """Prefill of S tokens, then decode steps from the states it leaves:
    a state handed over in the wrong layout shows at the first step."""
    cfg, _, _, _, params = setup
    run = reference_run
    model = get_model(cfg, device="cpu", attn=attn)
    cache = model.init_cache(B, MAX_LEN)
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(run["prompt"])}, cache)
    np.testing.assert_allclose(logits.numpy(), run["logits"][0], **TOL)
    for t in range(STEPS):
        logits, cache = model.decode_step(
            params, torch.from_numpy(run["feed"][t]), cache)
        np.testing.assert_allclose(logits.numpy(), run["logits"][t + 1],
                                   **TOL)
    np.testing.assert_array_equal(cache["length"].numpy(), run["length"])


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_forward_and_loss_match_reference(setup, reference_run, attn):
    cfg, _, _, _, params = setup
    from repro_torch.models import mamba, zamba

    mod = mamba if cfg.family == "ssm" else zamba
    hidden = mod.forward(cfg, params, torch.from_numpy(
        reference_run["prompt"]), attn=attn)
    np.testing.assert_allclose(hidden.numpy(), reference_run["hidden"],
                               **TOL)
    loss = get_model(cfg, device="cpu", attn=attn).loss_fn(
        params, reference_run["batch"])
    np.testing.assert_allclose(float(loss), reference_run["loss"], **TOL)


@pytest.mark.parametrize("attn", ["kernel", "plain"])
def test_gradients_match_reference(setup, reference_run, attn):
    """Every leaf gets a finite gradient from ``loss_fn`` on the CPU, equal
    to ``jax.value_and_grad``'s; the kernel path's SSD gradient comes from
    ``SsdChunkLocal``, as on the card (``tests/test_torch_gpu.py``)."""
    cfg, _, _, _, params = setup
    tracked = tree_map(lambda t: t.clone().requires_grad_(True), params)
    get_model(cfg, device="cpu", attn=attn).loss_fn(
        tracked, reference_run["batch"]).backward()
    for path, t in tree_paths(tracked):
        assert t.grad is not None and torch.isfinite(t.grad).all(), path
    got = params_to_jax(cfg, tree_map(lambda t: t.grad, tracked))
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    want = jax.tree_util.tree_flatten_with_path(reference_run["grads"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)


def _reference_serve(rcfg, jparams, prompts, batch, max_new, max_len):
    """The loop of ``repro/launch/serve.py``, returning its tokens."""
    model = ref_get_model(rcfg)
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    queue = list(prompts)
    outputs = []
    while queue:
        batch_prompts = [queue.pop() for _ in
                         range(min(batch, len(queue)))]
        bs = len(batch_prompts)
        cache = model.init_cache(bs, max_len)
        logits, cache = prefill(
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
    cfg, rcfg, _, jparams, params = setup
    r = np.random.default_rng(2)
    prompts = [r.integers(2, cfg.vocab, 10) for _ in range(4)]
    got, new_tokens = serve(get_model(cfg, device="cpu"), params, prompts,
                            batch=2, max_new=5, max_len=24)
    want = _reference_serve(rcfg, jparams, prompts, 2, 5, 24)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert new_tokens > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    stats = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "4",
                        "--prompt-len", "12", "--batch", "2"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "ssd_chunk_scan=0" in out
    assert stats["requests"] == 3 and stats["new_tokens"] > 0
    assert stats["batches"] == 2 and stats["decode_steps"] > 0
    # CPU tensors run the plain versions: no kernel is launched
    assert all(v == 0 for v in stats["launches"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, tmp_path, capsys):
    """``launch.train`` trains the SSM archs (SMOKE, kernel path, whose
    wrappers run their plain versions on the CPU): finite losses, then a
    second run resumes from the first one's checkpoint."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len", "20",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path),
            "--accel-target", "none"]
    out = train_cli.main(args + ["--steps", "2"])
    again = train_cli.main(args + ["--steps", "3"])
    assert "[train] done: 2 steps, loss" in capsys.readouterr().out
    assert out["report"].steps_run == 2 and again["report"].steps_run == 1
    assert again["report"].resumed_from == 2
    assert all(np.isfinite(out["report"].losses + again["report"].losses))
    assert not any(out["launches"].values())
