"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: these need a CUDA card and nvcc, and skip elsewhere (the
decision is made in a fixture, never at import).  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Cases and bounds are those of ``tests/test_kernels.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd_lse,
                                                 flash_attention_plain,
                                                 flash_decode,
                                                 flash_decode_plain)
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.kernels.tiling import gemm_blocks

pytestmark = pytest.mark.gpu

rng = np.random.default_rng(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_h100_constants_match_the_card(cuda):
    from repro_torch.targets import H100

    props = torch.cuda.get_device_properties(cuda)
    assert props.multi_processor_count == H100["sms"]
    assert props.shared_memory_per_block_optin == H100["smem_bytes_per_block"]
    assert props.total_memory <= H100["hbm_bytes"]


def randn(dev, *s, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        device=dev, dtype=dtype)


@pytest.mark.parametrize("mnk", [(64, 64, 64), (96, 130, 200), (8, 8, 8),
                                 (33, 17, 9), (256, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_float_on_card(cuda, mnk, dtype):
    m, n, k = mnk
    a, b = randn(cuda, m, k, dtype=dtype), randn(cuda, k, n, dtype=dtype)
    before = matmul.launches
    got = ops.covenant_matmul(a, b, blocks=(32, 128, 128))
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = ops.matmul_ref(a, b)
    torch.testing.assert_close(got, want,
                               atol=5e-2 if dtype == torch.bfloat16 else 1e-4,
                               rtol=1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("mnk", [(64, 64, 64), (40, 50, 60)])
def test_matmul_int8_on_card(cuda, mnk):
    m, n, k = mnk
    a = torch.from_numpy(rng.integers(-8, 8, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8)).to(cuda)
    got = ops.covenant_matmul(a, b, blocks=(32, 128, 128))
    want = a.cpu().to(torch.int32) @ b.cpu().to(torch.int32)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(2048, 4096, 1024), (4, 4096, 1024),
                                   (4, 151936, 1024), (300, 200, 150)])
def test_matmul_tiler_blocks_on_card(cuda, shape):
    m, n, k = shape
    a = randn(cuda, m, k, dtype=torch.bfloat16)
    b = randn(cuda, k, n, dtype=torch.bfloat16)
    bm, bn, bk = gemm_blocks(m, n, k)
    got = ops.covenant_matmul(a, b)
    want = matmul_plain(a, b)
    # bf16 inputs are exact in f32; only the order of the f32 sums differs
    torch.testing.assert_close(got, want, atol=1e-3 * k ** 0.5, rtol=1e-4)
    assert (bm, bn, bk) == gemm_blocks(m, n, k)


FA_CASES = [
    dict(b=2, hq=4, hkv=4, sq=64, sk=64, d=32, causal=True, win=None),
    dict(b=1, hq=8, hkv=2, sq=100, sk=100, d=16, causal=True, win=None),
    dict(b=2, hq=4, hkv=2, sq=64, sk=64, d=32, causal=True, win=16),
    dict(b=1, hq=4, hkv=4, sq=32, sk=96, d=32, causal=True, win=None),
    dict(b=1, hq=2, hkv=2, sq=48, sk=48, d=16, causal=False, win=None),
    dict(b=1, hq=4, hkv=1, sq=40, sk=40, d=64, causal=True, win=None),
]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_on_card(cuda, case):
    q = randn(cuda, case["b"], case["hq"], case["sq"], case["d"])
    k = randn(cuda, case["b"], case["hkv"], case["sk"], case["d"])
    v = randn(cuda, case["b"], case["hkv"], case["sk"], case["d"])
    before = flash_attention.launches
    got = ops.covenant_attention(q, k, v, causal=case["causal"],
                                 window=case["win"], blocks=(32, 128))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ops.attention_ref(q, k, v, causal=case["causal"],
                             window=case["win"])
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("window", [None, 0, 7, 4096])
def test_flash_attention_masks_on_card(cuda, window):
    bh, sq, sk, d = 6, 70, 130, 64
    q, k, v = randn(cuda, bh, sq, d), randn(cuda, 3, sk, d), randn(cuda, 3, sk, d)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal, window=window,
                              block_q=64, block_kv=48, q_offset=sk - sq)
        want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=sk - sq)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_flash_attention_full_width_bf16_on_card(cuda):
    q = randn(cuda, 4, 16, 512, 128, dtype=torch.bfloat16)
    k = randn(cuda, 4, 8, 512, 128, dtype=torch.bfloat16)
    v = randn(cuda, 4, 8, 512, 128, dtype=torch.bfloat16)
    got = ops.covenant_attention(q, k, v, causal=True)
    want = ops.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


def test_flash_decode_on_card(cuda):
    b, hq, hkv, s, d = 3, 8, 2, 256, 32
    q, k, v = randn(cuda, b, hq, d), randn(cuda, b, hkv, s, d), \
        randn(cuda, b, hkv, s, d)
    kv_len = torch.tensor([100, 256, 17], device=cuda)
    before = flash_decode.launches
    got = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=64)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = ops.attention_ref(q[:, :, None, :], k, v, causal=False,
                             kv_len=kv_len)[:, :, 0, :]
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("block_kv", [16, 64, 1024])
def test_flash_decode_full_width_on_card(cuda, block_kv):
    rows, hg, s, d = 32, 2, 1024, 128
    q = randn(cuda, rows, hg, d, dtype=torch.bfloat16)
    k = randn(cuda, rows, s, d, dtype=torch.bfloat16)
    v = randn(cuda, rows, s, d, dtype=torch.bfloat16)
    kv_len = torch.from_numpy(rng.integers(0, s + 1, rows)).to(cuda)
    got = flash_decode(q, k, v, kv_len, block_kv=block_kv)
    want = flash_decode_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# the training pair: the LSE forward and the backward, and the Function
# ---------------------------------------------------------------------------

# kernel against plain version: bf16 at the attention bound of
# tests/test_kernels.py (2e-2), f32 at 2e-3; lse is an f32 log-sum-exp of
# the same inputs summed in another order, values below 10: 1e-3
TRAIN_CASES = [
    dict(b=2, hq=4, hkv=4, sq=64, sk=64, d=32, causal=True, win=None),
    dict(b=1, hq=8, hkv=2, sq=100, sk=100, d=16, causal=True, win=None),
    dict(b=2, hq=4, hkv=2, sq=64, sk=64, d=32, causal=True, win=16),
    dict(b=1, hq=4, hkv=4, sq=32, sk=96, d=32, causal=True, win=None),
    dict(b=1, hq=2, hkv=2, sq=48, sk=48, d=16, causal=False, win=None),
    dict(b=1, hq=4, hkv=1, sq=40, sk=40, d=64, causal=True, win=None),
    dict(b=1, hq=4, hkv=2, sq=70, sk=130, d=128, causal=False, win=7),
]


def _train_inputs(dev, case, dtype):
    b, hq, hkv = case["b"], case["hq"], case["hkv"]
    q = randn(dev, b * hq, case["sq"], case["d"], dtype=dtype)
    k = randn(dev, b * hkv, case["sk"], case["d"], dtype=dtype)
    v = randn(dev, b * hkv, case["sk"], case["d"], dtype=dtype)
    do = randn(dev, b * hq, case["sq"], case["d"], dtype=dtype)
    return q, k, v, do


def _blocks(case, dtype):
    """The tiler's backward blocks for the kernel ``dtype`` runs: the
    tensor-core kernel's for bf16, the SIMT kernel's for f32."""
    from repro_torch.kernels.tiling import (attention_bwd_blocks,
                                            attention_bwd_mma_blocks)

    pick = attention_bwd_mma_blocks if dtype == torch.bfloat16 \
        else attention_bwd_blocks
    return pick(case["sq"], case["sk"], case["d"],
                heads=case["b"] * case["hq"])


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_flash_fwd_lse_on_card(cuda, case):
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd_lse, flash_attention_fwd_lse_plain)

    q, k, v, _ = _train_inputs(cuda, case, torch.float32)
    off = case["sk"] - case["sq"]
    before = flash_attention_fwd_lse.launches
    out, lse = flash_attention_fwd_lse(q, k, v, causal=case["causal"],
                                       window=case["win"], block_q=32,
                                       block_kv=48, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_fwd_lse.launches == before + 1
    want, want_lse = flash_attention_fwd_lse_plain(
        q, k, v, causal=case["causal"], window=case["win"], q_offset=off)
    torch.testing.assert_close(out, want, atol=2e-3, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    # the serve path's forward-only kernel gives the same output
    fwd = flash_attention(q, k, v, causal=case["causal"],
                          window=case["win"] or None, block_q=32,
                          block_kv=48, q_offset=off)
    torch.testing.assert_close(out, fwd, atol=0, rtol=0)


@pytest.mark.parametrize("case", TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_on_card(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_lse_plain)

    q, k, v, do = _train_inputs(cuda, case, dtype)
    off = case["sk"] - case["sq"]
    out, lse = flash_attention_fwd_lse_plain(
        q, k, v, causal=case["causal"], window=case["win"], q_offset=off)
    bq, bkv = _blocks(case, dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=case["causal"],
                              window=case["win"], block_q=bq, block_kv=bkv,
                              q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                     causal=case["causal"],
                                     window=case["win"], q_offset=off)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)


def test_flash_training_pair_full_width_bf16_on_card(cuda):
    """qwen3-0.6b's training shape, microbatch 4 x 512, tiler blocks."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_lse, flash_attention_fwd_lse_plain)
    from repro_torch.kernels.tiling import attention_blocks

    case = dict(b=4, hq=16, hkv=8, sq=512, sk=512, d=128)
    q, k, v, do = _train_inputs(cuda, case, torch.bfloat16)
    bq, bkv = attention_blocks(512, 512, 128, heads=64)
    out, lse = flash_attention_fwd_lse(q, k, v, block_q=bq, block_kv=bkv)
    want, want_lse = flash_attention_fwd_lse_plain(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    bq, bkv = _blocks(case, torch.bfloat16)
    got = flash_attention_bwd(q, k, v, want, want_lse, do, block_q=bq,
                              block_kv=bkv)
    ref = flash_attention_bwd_plain(q, k, v, want, want_lse, do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("window", [None, 16])
def test_kernel_attention_carries_grads_on_card(cuda, window):
    """``requires_grad`` inputs on the card go through the Function: each
    gets a gradient, equal to the plain path's (f32, 2e-3)."""
    from repro_torch.models.attention import dense_attention

    q0 = randn(cuda, 2, 8, 96, 64)
    k0, v0 = randn(cuda, 2, 4, 96, 64), randn(cuda, 2, 4, 96, 64)
    do = randn(cuda, 2, 8, 96, 64)
    got, want = [], []
    for fn, sink in ((lambda *t: ops.covenant_attention(
            *t, causal=True, window=window), got),
                     (lambda *t: dense_attention(*t, causal=True,
                                                 window=window or 0), want)):
        leaves = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
        fn(*leaves).backward(do)
        sink.extend(t.grad for t in leaves)
    for a, b in zip(got, want):
        assert a is not None
        torch.testing.assert_close(a, b, atol=2e-3, rtol=0)


def test_model_kernel_path_grads_on_card(cuda):
    """``backward()`` through ``transformer.forward(attn="kernel")`` on the
    card gives wq, wk, wv, q_norm and k_norm gradients equal to the plain
    path's (SMOKE qwen3 in f32, the model bound of
    ``tests/test_torch_models.py``: atol 1e-4, rtol 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, transformer

    cfg = get_config("qwen3-0.6b", smoke=True)
    params = get_model(cfg, device=cuda).init_params(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 48))).to(cuda)
    grads = {}
    for attn in ("kernel", "plain"):
        attn_p = {n: t.clone().requires_grad_(True)
                  for n, t in params["layers"][0]["attn"].items()}
        layers = [{**params["layers"][0], "attn": attn_p}] + \
            params["layers"][1:]
        h = transformer.forward(cfg, {**params, "layers": layers}, tokens,
                                attn=attn)
        h.square().mean().backward()
        grads[attn] = {n: t.grad for n, t in attn_p.items()}
    for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
        assert grads["kernel"][name] is not None, name
        torch.testing.assert_close(grads["kernel"][name],
                                   grads["plain"][name], atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the SSD chunk scan, attention at head_dim 160, and the SSM models
# ---------------------------------------------------------------------------

# the four SSD_CASES of tests/test_kernels.py, then full widths with a
# ragged S (1000 with chunk 512), 2 groups of 4 heads
SSD_CARD_CASES = [
    dict(b=2, s=64, h=4, p=16, g=2, n=8, chunk=16),
    dict(b=1, s=100, h=4, p=8, g=4, n=16, chunk=32),
    dict(b=2, s=33, h=2, p=8, g=1, n=4, chunk=16),
    dict(b=1, s=16, h=2, p=4, g=2, n=4, chunk=16),
    dict(b=1, s=1000, h=8, p=64, g=2, n=128, chunk=512),
]


def _ssd_inputs(dev, case, dtype=torch.float32):
    b, s, h, p, g, n = (case[k] for k in "bshpgn")
    x = randn(dev, b, s, h, p, dtype=dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(
        np.float32)).to(dev)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (h,)).astype(
        np.float32)).to(dev)
    B, C = randn(dev, b, s, g, n, dtype=dtype), randn(dev, b, s, g, n,
                                                       dtype=dtype)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", SSD_CARD_CASES)
def test_ssd_f32_on_card(cuda, case):
    """The kernel path of ``covenant_ssd`` against the sequential oracle
    ``ssd_ref`` at the reference's bound (atol 2e-3), from zeros and from an
    ``init_state``."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan

    x, dt, A, B, C = _ssd_inputs(cuda, case)
    st0 = randn(cuda, case["b"], case["h"], case["p"], case["n"])
    for init in (None, st0):
        before = ssd_chunk_scan.launches
        got, st = ops.covenant_ssd(x, dt, A, B, C, chunk=case["chunk"],
                                   init_state=init, return_state=True)
        torch.cuda.synchronize()
        assert ssd_chunk_scan.launches == before + 1
        want, wst = ops.ssd_ref(x, dt, A, B, C, init_state=init,
                                return_state=True)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
        torch.testing.assert_close(st, wst, atol=2e-3, rtol=0)


@pytest.mark.parametrize("case", SSD_CARD_CASES)
def test_ssd_bf16_on_card(cuda, case):
    """bf16 x, B, C (dt f32): the kernel's chunk-local outputs against the
    plain version's on the same inputs, at ``chip_smoke.check_ssd``'s bound
    (3 * 2^-9 of the terms' absolute sum: the kernel rounds each scaled
    score to bf16 once, the plain version sums in f32); y, which both round
    to bf16, within that and one bf16 ulp (2^-7 relative) of the plain y;
    the states at the same bound."""
    from repro_torch.kernels.ssd_scan import (ssd_chunk_local,
                                              ssd_chunk_local_plain,
                                              ssd_chunk_scan,
                                              ssd_chunk_scan_plain)

    b, h, g, ck = case["b"], case["h"], case["g"], case["chunk"]
    x, dt, A, B, C = _ssd_inputs(cuda, case, torch.bfloat16)
    s = -(-case["s"] // ck) * ck
    pad = s - case["s"]
    xf = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).transpose(
        1, 2).reshape(b * h, s, -1)
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad)).transpose(
        1, 2).reshape(b * h, s)
    bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).transpose(
        1, 2).reshape(b * g, s, -1) for t in (B, C))
    af = A.repeat(b)
    absolute = [t.abs() for t in (xf, bf, cf)]
    got = ssd_chunk_local(xf, dtf, af, bf, cf, chunk=ck)
    want = ssd_chunk_local_plain(xf, dtf, af, bf, cf, chunk=ck)
    terms = ssd_chunk_local_plain(absolute[0], dtf, af, *absolute[1:],
                                  chunk=ck)
    for a, w, t in zip(got, want, (*terms[:2], want[2].abs())):
        assert bool(((a - w).abs() <= 3 * 2.0 ** -9 * t).all())
    y, st = ssd_chunk_scan(xf, dtf, af, bf, cf, chunk=ck)
    wy, wst = ssd_chunk_scan_plain(xf, dtf, af, bf, cf, chunk=ck)
    ty, tst = ssd_chunk_scan_plain(absolute[0], dtf, af, *absolute[1:],
                                   chunk=ck)
    assert y.dtype == torch.bfloat16
    assert bool(((y.float() - wy.float()).abs() <= 3 * 2.0 ** -9 * ty.float()
                 + 2.0 ** -7 * wy.float().abs()).all())
    assert bool(((st - wst).abs() <= 3 * 2.0 ** -9 * tst).all())


def test_ssd_init_state_continuation_on_card(cuda):
    """Splitting a sequence across two calls == one call (decode
    contract), as ``tests/test_kernels.py`` holds it."""
    case = dict(b=1, s=1024, h=8, p=64, g=2, n=128, chunk=512)
    x, dt, A, B, C = _ssd_inputs(cuda, case)
    y_full, st_full = ops.covenant_ssd(x, dt, A, B, C, chunk=512,
                                       return_state=True)
    half = 600
    y1, st1 = ops.covenant_ssd(x[:, :half], dt[:, :half], A, B[:, :half],
                               C[:, :half], chunk=512, return_state=True)
    y2, st2 = ops.covenant_ssd(x[:, half:], dt[:, half:], A, B[:, half:],
                               C[:, half:], chunk=512, init_state=st1,
                               return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=2e-3,
                               rtol=0)
    torch.testing.assert_close(st2, st_full, atol=2e-3, rtol=0)


@pytest.mark.parametrize("case", SSD_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_grad_on_card(cuda, case, dtype):
    """The kernel path carries gradients (``SsdChunkLocal``: the kernel
    forward, the plain local stage recomputed under autograd backward).
    The Function alone, given random output gradients, against autograd
    through ``ssd_chunk_local_plain``; in f32 also the whole function with
    an init_state, against ``ssd_chunk_scan_plain`` (its loss is linear in
    y and the final state, but the inter-chunk stage multiplies the chunk
    states by their decays, so a gradient there sees the forward's
    rounding: 2^-16 in f32, up to 2^-8 in bf16, which is why the whole
    chain is held in f32).  Every input's gradient at 2e-3, and one bf16
    ulp (2^-7 relative) of a bf16 gradient."""
    from repro_torch.kernels.ssd_scan import (ssd_chunk_local,
                                              ssd_chunk_local_plain,
                                              ssd_chunk_scan,
                                              ssd_chunk_scan_plain)

    b, h, g, ck = case["b"], case["h"], case["g"], case["chunk"]
    x, dt, A, B, C = _ssd_inputs(cuda, case, dtype)
    s = -(-case["s"] // ck) * ck
    pad = s - case["s"]
    xf = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).transpose(
        1, 2).reshape(b * h, s, -1)
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad)).transpose(
        1, 2).reshape(b * h, s)
    bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).transpose(
        1, 2).reshape(b * g, s, -1) for t in (B, C))
    inputs = (xf, dtf, A.repeat(b), bf, cf)
    nck = s // ck
    gouts = (randn(cuda, b * h, s, case["p"]),
             randn(cuda, b * h * nck, case["n"], case["p"]),
             randn(cuda, b * h * nck))
    st0 = randn(cuda, b * h, case["n"], case["p"])
    u, w = randn(cuda, *xf.shape), randn(cuda, *st0.shape)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 2e-3

    def grads(fn, whole):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (*inputs, st0)]
        before = ssd_chunk_scan.launches
        if whole:
            y, st = fn(*leaves[:5], chunk=ck, init_state=leaves[5])
            ((y.float() * u).sum() + (st * w).sum()).backward()
        else:
            torch.autograd.backward(fn(*leaves[:5], chunk=ck), gouts)
        kernel = fn in (ssd_chunk_local, ssd_chunk_scan)
        assert ssd_chunk_scan.launches == before + kernel
        return [t.grad for t in leaves[:6 if whole else 5]]

    pairs = [((ssd_chunk_local, False), (ssd_chunk_local_plain, False))]
    if dtype == torch.float32:
        pairs.append(((ssd_chunk_scan, True), (ssd_chunk_scan_plain, True)))
    for kernel, plain in pairs:
        for a, b_ in zip(grads(*kernel), grads(*plain)):
            assert a is not None and bool(torch.isfinite(a).all())
            torch.testing.assert_close(a.float(), b_.float(), atol=2e-3,
                                       rtol=rtol)


# both models' prefill shapes (mamba2 bf16 N128, zamba2 f32 N64) at one
# batch entry, and a SMOKE chunk of 8 with N 16 and P 16
SSD_MODEL_CASES = [(1, 2048, 80, 64, 1, 128, 512, torch.bfloat16),
                   (1, 2048, 80, 64, 1, 64, 512, torch.float32),
                   (2, 24, 4, 16, 1, 16, 8, torch.float32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", SSD_MODEL_CASES)
def test_ssd_kernel_bit_equal_and_bound_on_card(cuda, b, s, h, p, g, n,
                                                chunk, dtype):
    """The tensor-core kernel against the plain version at chip_smoke's
    bound (|kernel - plain| <= 3 * 2^-9 of the terms' absolute sum), and
    bit-equal over two runs (no atomics, a fixed summation order)."""
    from repro_torch.kernels.ssd_scan import (ssd_chunk_local,
                                              ssd_chunk_local_plain)

    x = randn(cuda, b * h, s, p, dtype=dtype)
    dt = torch.nn.functional.softplus(randn(cuda, b * h, s))
    A = -torch.linspace(1.0, 16.0, h, device=cuda).repeat(b)
    B, C = randn(cuda, b * g, s, n, dtype=dtype), randn(cuda, b * g, s, n,
                                                       dtype=dtype)
    got = ssd_chunk_local(x, dt, A, B, C, chunk=chunk)
    again = ssd_chunk_local(x, dt, A, B, C, chunk=chunk)
    want = ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
    terms = ssd_chunk_local_plain(x.abs(), dt, A, B.abs(), C.abs(),
                                  chunk=chunk)
    for a, a2, w_, t_ in zip(got, again, want, (*terms[:2], want[2].abs())):
        assert torch.equal(a, a2)
        assert bool(((a - w_).abs() <= 3 * 2.0 ** -9 * t_).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_160_on_card(cuda, dtype):
    """zamba2's shared block: 32 heads of head_dim 160, tiler blocks."""
    q = randn(cuda, 1, 32, 300, 160, dtype=dtype)
    k = randn(cuda, 1, 32, 300, 160, dtype=dtype)
    v = randn(cuda, 1, 32, 300, 160, dtype=dtype)
    got = ops.covenant_attention(q, k, v, causal=True)
    want = ops.attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_head_dim_160_on_card(cuda, dtype):
    from repro_torch.kernels.tiling import decode_block_kv

    b, h, s, d = 4, 32, 2080, 160
    q = randn(cuda, b, h, d, dtype=dtype)
    k, v = randn(cuda, b, h, s, d, dtype=dtype), randn(cuda, b, h, s, d,
                                                       dtype=dtype)
    kv_len = torch.tensor([1, 700, 2049, 2080], device=cuda)
    got = ops.covenant_decode_attention(
        q, k, v, kv_len, block_kv=decode_block_kv(b * h, s, d, 1))
    want = ops.attention_ref(q[:, :, None, :], k, v, causal=False,
                             kv_len=kv_len)[:, :, 0, :]
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_models_kernel_path_on_card(cuda, arch):
    """SMOKE mamba2 and zamba2 (f32) on the card: the kernel path's prefill
    and 4 decode steps against the plain path's, at the model bound of
    ``tests/test_torch_models.py`` (atol 1e-4, rtol 1e-4); the SSD kernel
    runs once per mamba layer of the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import get_model

    cfg = get_config(arch, smoke=True)
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 21))).to(cuda)
    feed = torch.from_numpy(rng.integers(2, cfg.vocab, (4, 2))).to(cuda)
    logits = {}
    for attn in ("kernel", "plain"):
        model = get_model(cfg, device=cuda, attn=attn)
        params = model.init_params(0)
        before = ssd_chunk_scan.launches
        cache = model.init_cache(2, 32)
        out, cache = model.prefill(params, {"tokens": prompt}, cache)
        steps = [out]
        for t in range(4):
            out, cache = model.decode_step(params, feed[t], cache)
            steps.append(out)
        torch.cuda.synchronize()
        launched = ssd_chunk_scan.launches - before
        assert launched == (cfg.n_layers if attn == "kernel" else 0)
        logits[attn] = steps
    for a, b in zip(logits["kernel"], logits["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the tensor-core paths: the bf16 GEMM (TMA + wgmma) and the bf16 flash
# forward (mma.sync), at the blocks the tiler picks on the main paths
# ---------------------------------------------------------------------------

# (M, N, K) and the blocks the tiler picks for the main-path GEMM of that
# block shape, at a size that keeps the check quick: mamba2's decode
# lm_head (N 50280 ragged to 48), qwen3's decode ffn_out, its train
# lm_head's and its prefill lm_head's blocks
GEMM_MAIN_BLOCKS = [
    ((4, 50280, 2560), (4, 48, 512)),
    ((4, 1024, 3072), (4, 16, 3072)),
    ((1024, 8192, 1024), (128, 64, 512)),
    ((2048, 4096, 1024), (256, 64, 128)),
]


def _gemm_gate(a, b, got, want):
    """The elementwise bound of ``chip_smoke.check_gemm``: both sums are
    within K u sum|a_i b_i| of the exact one (u = 2^-24), so they differ by
    at most 2(K + 1) u |A||B|."""
    k = a.shape[1]
    bound = 2 * (k + 1) * 2.0 ** -24 * (a.abs().float() @ b.abs().float())
    diff = (got - want).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.parametrize("shape,blocks", GEMM_MAIN_BLOCKS)
def test_matmul_bf16_main_blocks_on_card(cuda, shape, blocks):
    m, n, k = shape
    a = randn(cuda, m, k, dtype=torch.bfloat16)
    b = randn(cuda, k, n, dtype=torch.bfloat16)
    before = matmul.launches
    got = ops.covenant_matmul(a, b, blocks=blocks)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    _gemm_gate(a, b, got, matmul_plain(a, b))


def test_matmul_bf16_ragged_without_padding_on_card(cuda, monkeypatch):
    """M, N and K all off the block multiples (and K off the stage depth):
    the kernel masks the edges, so ``ops.covenant_matmul`` pads nothing."""
    def no_pad(*args, **kwargs):
        raise AssertionError("covenant_matmul padded a bf16 operand")

    m, n, k = 333, 1000, 520
    a = randn(cuda, m, k, dtype=torch.bfloat16)
    b = randn(cuda, k, n, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    for blocks in ((64, 64, 128), (128, 48, 64), (4, 256, 256)):
        got = ops.covenant_matmul(a, b, blocks=blocks)
        torch.cuda.synchronize()
        assert got.shape == (m, n)
        _gemm_gate(a, b, got, matmul_plain(a, b))


# bf16 forward cases: (Sq, Sk, window).  Sq != Sk puts q row 0 at kv
# position Sk - Sq; with Sq > Sk the first rows see no key under the causal
# mask and must come out as zeros with lse -1e30; window 0 is a window of
# none for flash_attention and no window for the LSE forward
MMA_FA_CASES = [(70, 130, None), (70, 130, 16), (130, 70, 0), (200, 200, 16)]


@pytest.mark.parametrize("sq,sk,window", MMA_FA_CASES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
def test_flash_mma_bf16_on_card(cuda, d, hq, hkv, sq, sk, window):
    from repro_torch.kernels.flash_attention import \
        flash_attention_fwd_lse_plain

    q = randn(cuda, hq, sq, d, dtype=torch.bfloat16)
    k = randn(cuda, hkv, sk, d, dtype=torch.bfloat16)
    v = randn(cuda, hkv, sk, d, dtype=torch.bfloat16)
    off = sk - sq
    want = flash_attention_plain(q, k, v, window=window, q_offset=off)
    want_o, want_lse = flash_attention_fwd_lse_plain(q, k, v, window=window,
                                                     q_offset=off)
    for bq, bkv in ((64, 64), (128, 32), (64, 128), (32, 64), (32, 128)):
        before = (flash_attention.launches, flash_attention_fwd_lse.launches)
        got = flash_attention(q, k, v, window=window, block_q=bq,
                              block_kv=bkv, q_offset=off)
        out, lse = flash_attention_fwd_lse(q, k, v, window=window,
                                           block_q=bq, block_kv=bkv,
                                           q_offset=off)
        torch.cuda.synchronize()
        assert (flash_attention.launches, flash_attention_fwd_lse.launches) \
            == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)
        torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2,
                                   rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        if off < 0:
            # rows whose q position is below 0 see no key: zeros, -1e30
            assert bool((out[:, :-off] == 0).all())
            assert bool((lse[:, :-off] == -1e30).all())


# ---------------------------------------------------------------------------
# the bf16 flash backward on the tensor cores (mma.sync) and the pipelined
# flash decode with its fused combine
# ---------------------------------------------------------------------------

# bf16 backward cases: (Sq, Sk, window); window 0 or None is no window at
# this level.  Sq > Sk puts q row 0 at kv position Sk - Sq, so the first
# rows see no key: lse -1e30, and their dq must be zeros
MMA_BWD_CASES = [(70, 130, None), (70, 130, 16), (130, 70, None),
                 (200, 200, 16)]


@pytest.mark.parametrize("sq,sk,window", MMA_BWD_CASES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
def test_flash_bwd_mma_bf16_on_card(cuda, d, hq, hkv, sq, sk, window):
    """Every block pair the kernel is built for, GQA, ragged edges, a
    window, Sq > Sk; against the plain version at the bf16 bound (2e-2).
    A pair whose tiles pass one block's shared memory (D160, (128, 128))
    raises."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_lse_plain)
    from repro_torch.kernels.tiling import (FLASH_BWD_MMA_BLOCKS,
                                            flash_bwd_mma_smem_bytes)
    from repro_torch.targets import H100

    q = randn(cuda, hq, sq, d, dtype=torch.bfloat16)
    k = randn(cuda, hkv, sk, d, dtype=torch.bfloat16)
    v = randn(cuda, hkv, sk, d, dtype=torch.bfloat16)
    do = randn(cuda, hq, sq, d, dtype=torch.bfloat16)
    off = sk - sq
    out, lse = flash_attention_fwd_lse_plain(q, k, v, window=window,
                                             q_offset=off)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, window=window,
                                     q_offset=off)
    for bq in FLASH_BWD_MMA_BLOCKS:
        for bkv in FLASH_BWD_MMA_BLOCKS:
            if flash_bwd_mma_smem_bytes(bq, bkv, d) > \
                    H100["smem_bytes_per_block"]:
                with pytest.raises(ValueError):
                    flash_attention_bwd(q, k, v, out, lse, do, block_q=bq,
                                        block_kv=bkv, q_offset=off)
                continue
            before = flash_attention_bwd.launches
            got = flash_attention_bwd(q, k, v, out, lse, do, window=window,
                                      block_q=bq, block_kv=bkv, q_offset=off)
            torch.cuda.synchronize()
            assert flash_attention_bwd.launches == before + 1
            for a, b in zip(got, want):
                assert a.dtype == torch.bfloat16 and a.shape == b.shape
                torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                           rtol=0)
            if off < 0:
                assert bool((lse[:, :-off] == -1e30).all())
                assert bool((got[0][:, :-off] == 0).all())


def test_flash_bwd_mma_refuses_other_head_dims_on_card(cuda):
    """bf16 head dims the tensor-core backward is not built for raise; they
    are not handed to the SIMT kernel."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd_lse_plain)

    for d in (80, 48):
        q = randn(cuda, 2, 64, d, dtype=torch.bfloat16)
        out, lse = flash_attention_fwd_lse_plain(q, q, q)
        with pytest.raises(ValueError):
            flash_attention_bwd(q, q, q, out, lse, q, block_q=64,
                                block_kv=64)
    q = randn(cuda, 2, 64, 64, dtype=torch.bfloat16)
    out, lse = flash_attention_fwd_lse_plain(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse, q, block_q=32, block_kv=64)


def test_flash_bwd_and_decode_deterministic_on_card(cuda):
    """Two runs of the bf16 backward (qwen3's training shape, tiler blocks)
    and of the decode (zamba2's shape, rows of several splits, whose last
    block to arrive combines them) give bit-equal results."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd_lse_plain)
    from repro_torch.kernels.tiling import (attention_bwd_mma_blocks,
                                            decode_block_kv)

    case = dict(b=4, hq=16, hkv=8, sq=512, sk=512, d=128)
    q, k, v, do = _train_inputs(cuda, case, torch.bfloat16)
    out, lse = flash_attention_fwd_lse_plain(q, k, v)
    bq, bkv = attention_bwd_mma_blocks(512, 512, 128, heads=64)
    runs = [flash_attention_bwd(q, k, v, out, lse, do, block_q=bq,
                                block_kv=bkv) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    b_, h, s, d = 4, 32, 2080, 160
    q = randn(cuda, b_, h, d, dtype=torch.bfloat16)
    k = randn(cuda, b_, h, s, d, dtype=torch.bfloat16)
    v = randn(cuda, b_, h, s, d, dtype=torch.bfloat16)
    kv_len = torch.tensor([1, 700, 2049, 2080], device=cuda,
                          dtype=torch.int32)
    bkv = decode_block_kv(b_ * h, s, d, 1)
    first = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=bkv)
    for _ in range(3):
        assert torch.equal(ops.covenant_decode_attention(
            q, k, v, kv_len, block_kv=bkv), first)


# the decode at the served models' shapes: (B, Hq, Hkv, S, D): qwen3,
# zamba2, gemma3's local and global caches, stablelm, command-r, and
# paligemma's (256, 8)
DECODE_MODEL_SHAPES = [(4, 16, 8, 1024, 128), (4, 32, 32, 2080, 160),
                       (4, 16, 8, 1024, 256), (4, 16, 8, 2080, 256),
                       (4, 32, 8, 2080, 160), (4, 96, 8, 2080, 128),
                       (4, 8, 1, 2080, 256)]


@pytest.mark.parametrize("shape", DECODE_MODEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_model_shapes_on_card(cuda, shape, dtype):
    """kv_len 0 (zeros), 1, either side of a split edge and the full cache,
    with the tiler's split; against the plain version (bf16 2e-2, f32
    2e-3), and bit-equal on a second run (rows of several splits, whose
    last block to arrive combines them).  The lengths are one per batch
    entry, int32 on the card as the models keep them, read by the kernel
    for each kv head's row."""
    from repro_torch.kernels.tiling import decode_block_kv

    b, hq, hkv, s, d = shape
    bkv = decode_block_kv(b * hkv, s, d, hq // hkv)
    q = randn(cuda, b, hq, d, dtype=dtype)
    k = randn(cuda, b, hkv, s, d, dtype=dtype)
    v = randn(cuda, b, hkv, s, d, dtype=dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for lens in ((0, 1, bkv, s), (bkv + 1, 2 * bkv - 1, 2 * bkv, s - 1)):
        kv_len = torch.tensor(lens, device=cuda, dtype=torch.int32)
        before = flash_decode.launches
        got = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=bkv)
        torch.cuda.synchronize()
        assert flash_decode.launches == before + 1
        want = flash_decode_plain(
            q.reshape(b * hkv, hq // hkv, d), k.reshape(b * hkv, s, d),
            v.reshape(b * hkv, s, d), kv_len, kv_heads=hkv).reshape(b, hq, d)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(got, ops.covenant_decode_attention(
            q, k, v, kv_len, block_kv=bkv))
        if lens[0] == 0:
            assert bool((got[0] == 0).all())


def test_flash_bwd_sass_holds_hmma_on_card(cuda):
    """The backward's library runs its bf16 products on the tensor cores:
    its SASS holds mma.sync (HMMA)."""
    from repro_torch.kernels import _build

    _build.library("flash_attention_bwd")
    assert _build.sass_counts("flash_attention_bwd")["HMMA"] > 0


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("hg", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_short_rows_on_card(cuda, d, hg, dtype):
    """Head dims of one to four 16-byte chunks (the SMOKE models' 16
    among them): a key gets fewer lanes, up to one a key.  Lengths of one
    batch entry per two rows, across several splits of 16."""
    rows, s = 6, 100
    q = randn(cuda, rows, hg, d, dtype=dtype)
    k, v = randn(cuda, rows, s, d, dtype=dtype), randn(cuda, rows, s, d,
                                                       dtype=dtype)
    kv_len = torch.tensor([0, 37, 100], device=cuda, dtype=torch.int32)
    got = flash_decode(q, k, v, kv_len, block_kv=16, kv_heads=2)
    want = flash_decode_plain(q, k, v, kv_len, kv_heads=2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert bool((got[:2] == 0).all())


def test_reference_bf16_attention_case_on_card(cuda):
    """``tests/test_kernels.py``'s own bf16 case: B1 H2 S64 D32 with
    caller-given blocks (32, 64), through ``covenant_attention`` on the
    tensor-core kernel, against ``attention_ref`` at 2e-2."""
    q, k, v = (randn(cuda, 1, 2, 64, 32, dtype=torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    got = ops.covenant_attention(q, k, v, causal=True, blocks=(32, 64))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ops.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 160])
@pytest.mark.parametrize("blocks", [None, (32, 64)])
def test_flash_attention_function_bf16_head_dims_on_card(cuda, d, blocks):
    """bf16 through ``FlashAttention`` at the newly built head dims: the
    LSE forward (tiler or caller blocks, block_q 32 among them) and the
    backward (tiler blocks), against the plain path's output and
    gradients at the bf16 bound (2e-2).  The output gradient is scaled to
    keep the gradients below 2, where one bf16 ulp is inside the bound."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.attention import dense_attention

    q0 = randn(cuda, 2, 4, 96, d, dtype=torch.bfloat16)
    k0, v0 = (randn(cuda, 2, 2, 96, d, dtype=torch.bfloat16)
              for _ in range(2))
    do = (randn(cuda, 2, 4, 96, d) * 0.25).bfloat16()
    outs, grads = {}, {}
    for path in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
        before = (flash_attention_fwd_lse.launches,
                  flash_attention_bwd.launches)
        if path == "kernel":
            out = ops.covenant_attention(*leaves, causal=True, blocks=blocks)
        else:
            out = dense_attention(*(t.float() for t in leaves), causal=True,
                                  window=0)
        out.float().backward(do.float())
        torch.cuda.synchronize()
        if path == "kernel":
            assert (flash_attention_fwd_lse.launches,
                    flash_attention_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
        outs[path], grads[path] = out, [t.grad for t in leaves]
    torch.testing.assert_close(outs["kernel"].float(), outs["plain"].float(),
                               atol=2e-2, rtol=0)
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_train_cli_smoke_on_card(cuda, arch, tmp_path):
    """``launch.train --smoke`` on the card: finite losses, the SSD kernel
    (and for zamba2 the flash forward with LSE and the backward) launched,
    and a resume from the checkpoint."""
    from repro_torch.launch import train

    args = ["--arch", arch, "--smoke", "--device", "cuda", "--seq-len",
            "40", "--global-batch", "2", "--ckpt-dir", str(tmp_path),
            "--accel-target", "none"]
    out = train.main(args + ["--steps", "3"])
    again = train.main(args + ["--steps", "4"])
    assert out["report"].steps_run == 3 and again["report"].resumed_from == 3
    assert all(np.isfinite(out["report"].losses + again["report"].losses))
    assert out["launches"]["ssd_chunk_scan"] > 0
    if arch == "zamba2-2.7b":
        assert out["launches"]["flash_attention_fwd_lse"] > 0
        assert out["launches"]["flash_attention_bwd"] > 0


# ---------------------------------------------------------------------------
# head dim 256 in the forward, any group from 1 to 16 in the decode
# ---------------------------------------------------------------------------

# the block pairs the bf16 forward is built for at head dim 256: block_kv
# 128 passes one block's shared memory
D256_BLOCKS = [(32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (128, 64)]


@pytest.mark.parametrize("sq,sk,window", MMA_FA_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_head_dim_256_on_card(cuda, sq, sk, window, dtype):
    """gemma3's head dim: the forward and the LSE forward at every block
    pair built for bf16 (2e-2) and at SIMT pairs for f32 (2e-3), with GQA,
    ragged edges, a window and Sq > Sk; a bf16 pair that is not built
    raises."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_fwd_lse_plain

    d = 256
    q = randn(cuda, 4, sq, d, dtype=dtype)
    k = randn(cuda, 2, sk, d, dtype=dtype)
    v = randn(cuda, 2, sk, d, dtype=dtype)
    off = sk - sq
    want = flash_attention_plain(q, k, v, window=window, q_offset=off)
    want_o, want_lse = flash_attention_fwd_lse_plain(q, k, v, window=window,
                                                     q_offset=off)
    bf16 = dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 2e-3
    for bq, bkv in (D256_BLOCKS if bf16 else [(64, 64), (32, 32)]):
        got = flash_attention(q, k, v, window=window, block_q=bq,
                              block_kv=bkv, q_offset=off)
        out, lse = flash_attention_fwd_lse(q, k, v, window=window,
                                           block_q=bq, block_kv=bkv,
                                           q_offset=off)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(out.float(), want_o.float(), atol=tol,
                                   rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        if off < 0:
            assert bool((out[:, :-off] == 0).all())
            assert bool((lse[:, :-off] == -1e30).all())
    if bf16:
        with pytest.raises(ValueError):
            flash_attention(q, k, v, block_q=64, block_kv=128, q_offset=off)


def test_flash_attention_gemma3_prefill_on_card(cuda):
    """gemma3's prefill through ``covenant_attention`` with the tiler's
    blocks: B2 of 16 q and 8 kv heads, S 2048, its local window 1024 and
    none, bf16, against ``attention_ref`` at 2e-2."""
    q = randn(cuda, 2, 16, 2048, 256, dtype=torch.bfloat16)
    k = randn(cuda, 2, 8, 2048, 256, dtype=torch.bfloat16)
    v = randn(cuda, 2, 8, 2048, 256, dtype=torch.bfloat16)
    for window in (1024, None):
        before = flash_attention.launches
        got = ops.covenant_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = ops.attention_ref(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)


@pytest.mark.parametrize("d", [8, 64, 160, 256])
@pytest.mark.parametrize("hg", list(range(1, 17)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_every_group_on_card(cuda, d, hg, dtype):
    """Every group from 1 to 16 (its warps split the heads, up to 4 a
    warp): ragged lengths of one batch entry per two rows, a zero-length
    entry, splits of 16 keys; against the plain version (bf16 2e-2, f32
    2e-3) and bit-equal on two runs."""
    rows, s = 6, 100
    q = randn(cuda, rows, hg, d, dtype=dtype)
    k, v = randn(cuda, rows, s, d, dtype=dtype), randn(cuda, rows, s, d,
                                                       dtype=dtype)
    kv_len = torch.tensor([0, 37, 100], device=cuda, dtype=torch.int32)
    got = flash_decode(q, k, v, kv_len, block_kv=16, kv_heads=2)
    again = flash_decode(q, k, v, kv_len, block_kv=16, kv_heads=2)
    want = flash_decode_plain(q, k, v, kv_len, kv_heads=2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(got, again)
    assert bool((got[:2] == 0).all())


def test_flash_decode_refuses_unbuilt_shapes_on_card(cuda):
    """A head dim the decode is not built for, or a group past 16, raises
    before a launch: it never falls back to the plain version."""
    for hg, d in ((1, 96), (17, 128)):
        q = randn(cuda, 2, hg, d, dtype=torch.bfloat16)
        k = randn(cuda, 2, 40, d, dtype=torch.bfloat16)
        kv_len = torch.tensor([40, 40], device=cuda, dtype=torch.int32)
        before = flash_decode.launches
        with pytest.raises(ValueError):
            flash_decode(q, k, k, kv_len)
        assert flash_decode.launches == before


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b"])
def test_moe_dispatch_on_card_matches_cpu(cuda, arch):
    """One MoE layer at full width, f32, 2 x 512 tokens that share a
    component (so a few experts overflow their capacity): the card keeps
    the same (token, expert) assignments as the CPU, its output is within
    1e-4 relative L2 of the CPU's, and two card runs are bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg = get_config(arch).replace(param_dtype="float32",
                                   compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_ffn(cfg, gen)
    x = torch.randn((2, 512, cfg.d_model), generator=gen) + \
        0.25 * torch.randn((cfg.d_model,), generator=gen)
    pd, xd = tree_map(lambda a: a.to(cuda), p), x.to(cuda)
    got, again = moe.moe_ffn(cfg, pd, xd), moe.moe_ffn(cfg, pd, xd)
    want = moe.moe_ffn(cfg, p, x)
    kept = moe.kept_assignments(cfg, p, x)
    assert int(kept.sum()) < 1024 * cfg.top_k
    assert torch.equal(moe.kept_assignments(cfg, pd, xd).cpu(), kept)
    assert torch.equal(got, again)
    assert float((got.cpu() - want).norm() / want.norm()) <= 1e-4


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b"])
def test_moe_serve_cli_two_layers_on_card(cuda, arch):
    """The serve CLI at full width and 2 layers (deepseek: its dense layer
    and one MoE layer): flash attention once per layer of each batch,
    flash decode once per layer of each decode step, the layer report's
    GEMMs through the kernel."""
    from repro_torch.launch.serve import main as serve_main

    stats = serve_main(["--arch", arch, "--n-layers", "2", "--prompt-len",
                        "128", "--max-len", "160", "--requests", "4",
                        "--max-new", "4"])
    torch.cuda.synchronize()
    launches = stats["launches"]
    assert stats["new_tokens"] > 0
    assert launches["flash_attention"] == 2 * stats["batches"]
    assert launches["flash_decode"] == 2 * stats["decode_steps"]
    assert launches["matmul"] > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b"])
def test_moe_decode_step_has_no_host_sync_on_card(cuda, arch):
    """One MoE decode step at full width and 2 layers, after a warm-up
    step, runs under ``torch.cuda.set_sync_debug_mode("error")``: nothing
    on the path (routing, capacity, dispatch, combine, attention) waits
    for the card, so a CUDA graph can capture the step."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch).replace(n_layers=2)
    model = get_model(cfg, device=cuda)
    params = model.init_params(0)
    tokens = torch.randint(2, cfg.vocab, (4, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  model.init_cache(4, 80))
    logits, cache = model.decode_step(params, logits.argmax(-1), cache)
    torch.cuda.synchronize()
    nxt = logits.argmax(-1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(params, nxt, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert logits.shape == (4, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM families: whisper-base's non-causal forward
# over 1500 frames and its decode against the full cross cache, and
# paligemma-3b's forward at head dim 256 with one kv head (group 8)
# ---------------------------------------------------------------------------

# (Sq, Sk): whisper's encoder (1500 frames, no multiple of 64), its cross
# attention (a 4-token prompt against the frames) and a longer prompt
NONCAUSAL_CASES = [(1500, 1500), (4, 1500), (70, 1500)]
# relative L2 bounds of the forward and the decode against the oracle,
# beside the absolute ones, which at 1500 keys sit near half a typical
# output: bf16, two roundings (P before P @ V, and the output) of at most
# 2^-8 each; f32, sums over the keys in another order (chip_smoke.py's
# ATTN_REL_L2)
REL_L2 = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def assert_rel_l2(got, want, dtype):
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= REL_L2[dtype], rel
    return rel


@pytest.mark.parametrize("sq,sk", NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_noncausal_whisper_shapes_on_card(cuda, sq, sk,
                                                          dtype):
    """``covenant_attention(causal=False)`` at whisper's head dim 64 with
    the tiler's blocks: its ``q_offset = Sk - Sq`` masks nothing, the
    ragged key edge at 1500 is masked by the kernel; bf16 2e-2, f32 2e-3,
    and ``REL_L2``, bit-equal on two runs."""
    q = randn(cuda, 2, 8, sq, 64, dtype=dtype)
    k = randn(cuda, 2, 8, sk, 64, dtype=dtype)
    v = randn(cuda, 2, 8, sk, 64, dtype=dtype)
    before = flash_attention.launches
    got = ops.covenant_attention(q, k, v, causal=False)
    again = ops.covenant_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(got, again)
    want = ops.attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert_rel_l2(got, want, dtype)


@pytest.mark.parametrize("sq", [1500, 4, None])
def test_bf16_gate_rejects_unmasked_key_edge_on_card(cuda, sq):
    """The relative bound catches the fault the absolute one lets through
    at whisper's 1500 keys: keys and values padded with zeros to 1536 and
    left unmasked (as the forward reads its last block's tail if it drops
    ``kpos < Sk``; ``sq`` None: the decode reading past ``kv_len``) take
    about 1.4 % of every row's weight.  The faulty output stays inside
    2e-2 of the oracle on the unpadded keys, and outside ``REL_L2``."""
    from repro_torch.kernels.tiling import decode_block_kv

    b, h, s, d, pad = 2, 8, 1500, 64, 36
    k = randn(cuda, b, h, s, d, dtype=torch.bfloat16)
    v = randn(cuda, b, h, s, d, dtype=torch.bfloat16)
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if sq is None:
        q = randn(cuda, b, h, d, dtype=torch.bfloat16)
        full = torch.full((b,), s + pad, device=cuda, dtype=torch.int32)
        got = ops.covenant_decode_attention(
            q, kp, vp, full, block_kv=decode_block_kv(b * h, s + pad, d, 1))
        want = ops.attention_ref(
            q[:, :, None, :], k, v, causal=False,
            kv_len=torch.full((b,), s, device=cuda))[:, :, 0, :]
    else:
        q = randn(cuda, b, h, sq, d, dtype=torch.bfloat16)
        got = ops.covenant_attention(q, kp, vp, causal=False)
        want = ops.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    with pytest.raises(AssertionError):
        assert_rel_l2(got, want, torch.bfloat16)


@pytest.mark.parametrize("lens", [(1500, 1500, 1500, 1500),
                                  (1, 1152, 1153, 1500)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_cross_cache_on_card(cuda, lens, dtype):
    """The decode against whisper's 1500-frame cross cache (head dim 64,
    group 1) at the tiler's split, whose last split is ragged: every row
    full, as the model runs it, and ragged lengths at the split edge;
    bf16 2e-2, f32 2e-3, and ``REL_L2``, bit-equal on two runs."""
    from repro_torch.kernels.tiling import decode_block_kv

    b, h, s, d = 4, 8, 1500, 64
    q = randn(cuda, b, h, d, dtype=dtype)
    k = randn(cuda, b, h, s, d, dtype=dtype)
    v = randn(cuda, b, h, s, d, dtype=dtype)
    kv_len = torch.tensor(lens, device=cuda, dtype=torch.int32)
    bkv = decode_block_kv(b * h, s, d, 1)
    assert s % bkv
    got = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=bkv)
    again = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=bkv)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ops.attention_ref(q[:, :, None, :], k, v, causal=False,
                             kv_len=kv_len)[:, :, 0, :]
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert_rel_l2(got, want, dtype)


@pytest.mark.parametrize("s", [288, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_d256_group8_on_card(cuda, s, dtype):
    """paligemma's causal prefill: 8 q heads reading one kv head of 256,
    over the 256-token image prefix and a 32-token prompt (and a ragged
    100), with the tiler's blocks; bf16 2e-2, f32 2e-3, and ``REL_L2``,
    bit-equal."""
    q = randn(cuda, 2, 8, s, 256, dtype=dtype)
    k = randn(cuda, 2, 1, s, 256, dtype=dtype)
    v = randn(cuda, 2, 1, s, 256, dtype=dtype)
    got = ops.covenant_attention(q, k, v, causal=True)
    again = ops.covenant_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ops.attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert_rel_l2(got, want, dtype)


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_encdec_vlm_smoke_kernel_path_on_card(cuda, arch):
    """SMOKE whisper and paligemma (f32) on the card: the kernel path's
    prefill and 8 decode steps against the plain path's, at the model
    bound of ``tests/test_torch_encdec_vlm.py`` (atol 1e-4, rtol 1e-4);
    flash attention launched once per attention of the prefill (whisper:
    each encoder layer, each decoder layer's self and cross attention),
    flash decode once per attention of each step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import extra_inputs
    from repro_torch.models import get_model

    cfg = get_config(arch, smoke=True)
    per_batch, per_step = ((cfg.enc_layers + 2 * cfg.n_layers,
                            2 * cfg.n_layers) if cfg.family == "audio"
                           else (cfg.n_layers, cfg.n_layers))
    prompt = rng.integers(2, cfg.vocab, (2, 7))
    feed = torch.from_numpy(rng.integers(2, cfg.vocab, (8, 2))).to(cuda)
    logits = {}
    for attn in ("kernel", "plain"):
        model = get_model(cfg, device=cuda, attn=attn)
        params = model.init_params(0)
        batch = {"tokens": torch.from_numpy(prompt).to(cuda),
                 **extra_inputs(model, 2, 7, np.random.default_rng(1))}
        fa, fd = flash_attention.launches, flash_decode.launches
        out, cache = model.prefill(params, batch, model.init_cache(2, 48))
        steps = [out]
        for t in range(8):
            out, cache = model.decode_step(params, feed[t], cache)
            steps.append(out)
        torch.cuda.synchronize()
        kernel = attn == "kernel"
        assert flash_attention.launches - fa == (per_batch if kernel else 0)
        assert flash_decode.launches - fd == (8 * per_step if kernel else 0)
        logits[attn] = steps
    for a, b in zip(logits["kernel"], logits["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_whisper_decode_step_has_no_host_sync_on_card(cuda):
    """One whisper decode step at full width and 2 encoder and 2 decoder
    layers, after a warm-up step, runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the cross attention's
    lengths are made on the card, and nothing on the step waits for it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import extra_inputs
    from repro_torch.models import get_model

    cfg = get_config("whisper-base").replace(n_layers=2, enc_layers=2)
    model = get_model(cfg, device=cuda)
    params = model.init_params(0)
    tokens = torch.randint(2, cfg.vocab, (4, 4), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    batch = {"tokens": tokens,
             **extra_inputs(model, 4, 4, np.random.default_rng(0))}
    logits, cache = model.prefill(params, batch, model.init_cache(4, 64))
    logits, cache = model.decode_step(params, logits.argmax(-1), cache)
    torch.cuda.synchronize()
    nxt = logits.argmax(-1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(params, nxt, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert logits.shape == (4, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# training the encoder-decoder and VLM families: the bf16 backward at head
# dim 256 (paligemma's 8 q heads over one kv head, gemma3's 16 over 8) and
# at whisper's non-causal shapes
# ---------------------------------------------------------------------------


def _bwd_case(dev, b, hq, hkv, sq, sk, d, dtype, causal=True, window=None):
    """Inputs, the plain forward's residuals and the plain backward of an
    attention with the model's mask (q row 0 at kv position Sk - Sq)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_lse_plain)

    q = randn(dev, b * hq, sq, d, dtype=dtype)
    k = randn(dev, b * hkv, sk, d, dtype=dtype)
    v = randn(dev, b * hkv, sk, d, dtype=dtype)
    do = randn(dev, b * hq, sq, d, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    out, lse = flash_attention_fwd_lse_plain(q, k, v, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    return (q, k, v, out, lse, do), kw, want


def _hold_bwd(inputs, kw, want, blocks, dtype):
    """The backward with ``blocks``, twice: one launch each, bit-equal,
    within the attention atol and ``REL_L2`` of the plain version on each
    of dq, dk, dv."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*inputs, block_q=blocks[0],
                              block_kv=blocks[1], **kw)
    again = flash_attention_bwd(*inputs, block_q=blocks[0],
                                block_kv=blocks[1], **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=0)
        assert_rel_l2(a, w, dtype)


@pytest.mark.parametrize("window,s", [(None, 300), (1024, 1100)])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_head_dim_256_on_card(cuda, hq, hkv, window, s, dtype):
    """The backward at head dim 256, groups 1, 2 and 8 (paligemma's 8 q
    heads over one kv head), causal with gemma3's window of 1024 (over
    1100 tokens, so it masks) and none, ragged edges: bf16 on the tensor
    cores with the tiler's (64, 64) blocks, f32 on the SIMT lanes; against
    the plain version at 2e-2 / 2e-3 and ``REL_L2``, bit-equal."""
    from repro_torch.kernels.tiling import (attention_bwd_blocks,
                                            attention_bwd_mma_blocks)

    inputs, kw, want = _bwd_case(cuda, 1, hq, hkv, s, s, 256, dtype,
                                 window=window)
    pick = attention_bwd_mma_blocks if dtype == torch.bfloat16 \
        else attention_bwd_blocks
    blocks = pick(s, s, 256, heads=hq)
    if dtype == torch.bfloat16:
        assert blocks == (64, 64)
    _hold_bwd(inputs, kw, want, blocks, dtype)


def test_flash_bwd_head_dim_256_refuses_unbuilt_blocks_on_card(cuda):
    """At head dim 256 only (64, 64) is built: the larger pairs, whose tiles
    pass one block's shared memory, raise naming the built set; none falls
    back to the SIMT kernel or to aten."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    inputs, kw, _ = _bwd_case(cuda, 1, 8, 1, 128, 128, 256, torch.bfloat16)
    before = flash_attention_bwd.launches
    for bq, bkv in ((128, 64), (64, 128), (128, 128)):
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_bwd(*inputs, block_q=bq, block_kv=bkv, **kw)
    assert flash_attention_bwd.launches == before


# whisper-base's training attentions at head dim 64: the encoder's
# non-causal self attention over 1500 frames (1500 = 23 x 64 + 28), the
# decoder's 448 tokens across them (Sq != Sk, q_offset = Sk - Sq masking
# nothing; 448 = 7 x 64) and its causal self attention
WHISPER_BWD_CASES = [(1500, 1500, False), (448, 1500, False),
                     (448, 448, True)]


@pytest.mark.parametrize("sq,sk,causal", WHISPER_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_whisper_shapes_on_card(cuda, sq, sk, causal, dtype):
    from repro_torch.kernels.tiling import (attention_bwd_blocks,
                                            attention_bwd_mma_blocks)

    inputs, kw, want = _bwd_case(cuda, 2, 8, 8, sq, sk, 64, dtype,
                                 causal=causal)
    pick = attention_bwd_mma_blocks if dtype == torch.bfloat16 \
        else attention_bwd_blocks
    _hold_bwd(inputs, kw, want, pick(sq, sk, 64, heads=16), dtype)


@pytest.mark.parametrize("sq", [1500, 448])
def test_bf16_bwd_gate_rejects_unmasked_key_edge_on_card(cuda, sq):
    """The backward's relative bound catches the ragged-edge fault the
    absolute one lets through (``chip_smoke.planted_bwd_fault``): keys and
    values padded with zeros to 1536 and left unmasked through the LSE
    forward and the backward.  dq, and dk and dv of the real keys, stay
    inside 2e-2 of the plain version on the unpadded keys, and outside
    ``REL_L2``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_lse, flash_attention_fwd_lse_plain)
    from repro_torch.kernels.tiling import (attention_bwd_mma_blocks,
                                            attention_mma_blocks)

    b, h, s, d, pad = 2, 8, 1500, 64, 36
    q = randn(cuda, b * h, sq, d, dtype=torch.bfloat16)
    k = randn(cuda, b * h, s, d, dtype=torch.bfloat16)
    v = randn(cuda, b * h, s, d, dtype=torch.bfloat16)
    do = randn(cuda, b * h, sq, d, dtype=torch.bfloat16)
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    bq, bkv = attention_mma_blocks(sq, s + pad, d, heads=b * h)
    out, lse = flash_attention_fwd_lse(q, kp, vp, causal=False, block_q=bq,
                                       block_kv=bkv)
    bq, bkv = attention_bwd_mma_blocks(sq, s + pad, d, heads=b * h)
    dq, dk, dv = flash_attention_bwd(q, kp, vp, out, lse, do, causal=False,
                                     block_q=bq, block_kv=bkv,
                                     q_offset=s + pad - sq)
    wout, wlse = flash_attention_fwd_lse_plain(q, k, v, causal=False)
    want = flash_attention_bwd_plain(q, k, v, wout, wlse, do, causal=False,
                                     q_offset=s - sq)
    torch.cuda.synchronize()
    for got, w in zip((dq, dk[:, :s], dv[:, :s]), want):
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2, rtol=0)
        with pytest.raises(AssertionError):
            assert_rel_l2(got, w, torch.bfloat16)


def test_flash_bwd_head_dim_256_on_the_tensor_cores_on_card(cuda):
    """The backward's D256 tensor-core passes are in the library, spill no
    register (no stack frame and no local memory: ``cuobjdump
    -res-usage``) and the library's SASS holds mma.sync (HMMA)."""
    import re
    import subprocess

    from repro_torch.kernels import _build

    _build.library("flash_attention_bwd")
    out = subprocess.run(
        [_build._tool("cuobjdump"), "-res-usage",
         str(_build._target("flash_attention_bwd"))],
        capture_output=True, text=True, check=True).stdout
    usage = {f: (stack, local) for f, stack, local in re.findall(
        r"Function (\S+):\s*\n\s*REG:\d+ STACK:(\d+) SHARED:\d+ "
        r"LOCAL:(\d+)", out)}
    d256 = {f: n for f, n in usage.items() if "mma_kernelILi256E" in f}
    assert len(d256) == 2, sorted(usage)   # the dq and dkv passes, (64, 64)
    assert all(n == ("0", "0") for n in d256.values()), d256
    assert _build.sass_counts("flash_attention_bwd")["HMMA"] > 0


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_encdec_vlm_train_cli_smoke_on_card(cuda, arch, tmp_path):
    """``launch.train --smoke`` of whisper and paligemma on the card, with
    their stub frontends' extras: finite losses, and the LSE forward and
    the backward launched once an attention and step each, the forward once
    more for remat (whisper SMOKE: 2 encoder layers and 2 decoder layers of
    two attentions, 6; paligemma SMOKE: 2)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    per = {"whisper-base": 6, "paligemma-3b": 2}[arch]
    assert get_config(arch, smoke=True).remat
    out = train.main(["--arch", arch, "--smoke", "--device", "cuda",
                      "--seq-len", "24", "--global-batch", "2", "--steps",
                      "3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "0",
                      "--accel-target", "none"])
    assert out["report"].steps_run == 3
    assert all(np.isfinite(out["report"].losses))
    assert out["launches"]["flash_attention_fwd_lse"] == 2 * 3 * per
    assert out["launches"]["flash_attention_bwd"] == 3 * per


# ---------------------------------------------------------------------------
# training the MoE family and the other dense configs: the MoE dispatch's
# backward, the backward at stablelm's and command-r's heads, the train CLI
# ---------------------------------------------------------------------------


def moe_layer_grads(cfg, p, x, w):
    """The gradient of ``sum(moe_ffn(x) * w)`` for x and every leaf of one
    MoE layer's params ``p``, in the order (x, *leaves)."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    x = x.detach().requires_grad_(True)
    out = moe.moe_ffn(cfg, p, x)
    return torch.autograd.grad((out.float() * w).sum(), [x, *tree_leaves(p)])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b"])
def test_moe_layer_backward_bit_equal_on_card(cuda, arch, dtype):
    """One MoE layer at full width, 2 x 512 tokens that crowd a few experts
    past their capacity: the gradient of x and of every weight (router,
    experts, deepseek's shared experts) is bit-equal on two card runs, and
    in f32 within 1e-4 relative L2 of the CPU's.  Each token is gathered
    once per top-k choice, so the backward sums k gradients a token."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_ffn(cfg, gen)
    x = (torch.randn((2, 512, cfg.d_model), generator=gen) + 0.25 *
         torch.randn((cfg.d_model,), generator=gen)).to(getattr(torch, dtype))
    w = torch.randn((2, 512, cfg.d_model), generator=gen)
    kept = moe.kept_assignments(cfg, p, x)
    assert int(kept.sum()) < 1024 * cfg.top_k      # some were dropped
    pd = tree_map(lambda a: a.to(cuda), p)
    got = moe_layer_grads(cfg, pd, x.to(cuda), w.to(cuda))
    again = moe_layer_grads(cfg, pd, x.to(cuda), w.to(cuda))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if dtype == "float32":
        want = moe_layer_grads(cfg, p, x, w)
        for a, b in zip(got, want):
            rel = float((a.cpu() - b).norm() / b.norm())
            assert rel <= 1e-4, rel


# stablelm-12b's 32 q heads over 8 kv heads of 160 (group 4) and
# command-r-plus-104b's 96 over 8 of 128 (group 12), with a ragged edge
BWD_GROUP_CASES = [(32, 8, 160), (96, 8, 128)]


@pytest.mark.parametrize("hq,hkv,d", BWD_GROUP_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_train_config_heads_on_card(cuda, hq, hkv, d, dtype):
    """The backward at stablelm's and command-r's heads over 300 causal
    tokens, with the tiler's blocks: against the plain version at 2e-2 /
    2e-3 and ``REL_L2`` on each of dq, dk, dv (dk, dv summed over the
    group without atomics), bit-equal."""
    from repro_torch.kernels.tiling import (attention_bwd_blocks,
                                            attention_bwd_mma_blocks)

    inputs, kw, want = _bwd_case(cuda, 1, hq, hkv, 300, 300, d, dtype)
    pick = attention_bwd_mma_blocks if dtype == torch.bfloat16 \
        else attention_bwd_blocks
    _hold_bwd(inputs, kw, want, pick(300, 300, d, heads=hq), dtype)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b",
                                  "gemma3-12b", "stablelm-12b",
                                  "command-r-plus-104b"])
def test_train_configs_cli_smoke_on_card(cuda, arch, tmp_path):
    """``launch.train --smoke`` of the MoE family and the other dense
    configs on the card: finite losses, the LSE forward launched twice an
    attention and step (remat) and the backward once, no other attention
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    per = get_config(arch, smoke=True).n_layers
    out = train.main(["--arch", arch, "--smoke", "--device", "cuda",
                      "--seq-len", "24", "--global-batch", "2", "--steps",
                      "3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "0",
                      "--accel-target", "none"])
    assert out["report"].steps_run == 3
    assert all(np.isfinite(out["report"].losses))
    assert out["launches"]["flash_attention_fwd_lse"] == 2 * 3 * per
    assert out["launches"]["flash_attention_bwd"] == 3 * per
    assert out["launches"]["flash_attention"] == 0
    assert out["launches"]["flash_decode"] == 0


@pytest.mark.parametrize("tokens", [4, 2048])
def test_layer_report_times_each_gemm_beside_its_prediction(cuda, tokens):
    """Against ``h100`` on the card each row of the cycle table carries
    the covenant's predicted ms and ``covenant_matmul``'s time (one
    warm-up and three timed calls a GEMM); against another covenant the
    table is cycles only and launches nothing."""
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch import layers

    cfg = get_config("qwen3-0.6b")
    before = matmul.launches
    text = layers.layer_report(cfg, tokens, "h100", device=cuda)
    torch.cuda.synchronize()
    rows = text.splitlines()[1:]
    gemms = layers.lm_layer_gemms(cfg, tokens)
    assert matmul.launches == before + 4 * len(gemms)
    for g, row in zip(gemms, rows):
        cyc = float(row.split()[2])
        pred = float(row.split("predicted")[1].split()[0])
        ms = float(row.split("cuda")[1].split()[0])
        bf16 = repro_torch.compile(g.build("bf16", "f32"), "h100").cycles()
        assert cyc > 0 and ms > 0
        assert pred == pytest.approx(layers.predicted_ms(bf16), abs=5e-5)
    assert "predicted" in rows[-1] and "block total" in rows[-1]
    before = matmul.launches
    other = layers.layer_report(cfg, tokens, "hvx", device=cuda)
    assert "predicted" not in other and matmul.launches == before


def test_parallel_compile_after_cuda_init_on_card(cuda, tmp_path):
    """``compile_layer_gemms(..., parallel=2)`` from a process that has
    already launched a kernel (as a server calling ``variant_report`` does)
    forks its compile workers after CUDA is up: the workers never touch
    the card, finish within 60 s and give the serial compile's cycles."""
    import threading

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.layers import compile_layer_gemms

    torch.ones(8, device=cuda).add_(1)
    torch.cuda.synchronize()
    assert torch.cuda.is_initialized()
    cfg = get_config("qwen3-0.6b")
    opts = repro_torch.CompileOptions(store=str(tmp_path / "store"))
    repro_torch.clear_cache()
    done = {}
    worker = threading.Thread(target=lambda: done.update(
        pairs=compile_layer_gemms(cfg, 4, options=opts, parallel=2)),
        daemon=True)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive(), "parallel=2 compile still running at 60 s"
    arts = [art for _, art in done["pairs"]]
    assert all(art.ctx.executed == [] for art in arts)
    assert repro_torch.cache_stats()["store_hits"] == len(arts)
    repro_torch.clear_cache()
    serial = [art.cycles() for _, art in compile_layer_gemms(cfg, 4)]
    assert [art.cycles() for art in arts] == serial


# ---------------------------------------------------------------------------
# the distribution layer on a one-rank NCCL group
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group (``launch.mesh.init_distributed``, which
    starts one where no launcher did) and its (1, 1) host mesh; the group
    ends with the test."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_distributed("cuda")
    assert dist.get_backend() == "nccl"
    yield mesh_lib.make_host_mesh(1, device_type="cuda")
    dist.destroy_process_group()


def test_sharded_attention_runs_the_kernels_on_card(nccl_mesh):
    """``covenant_attention`` with gradients and ``covenant_decode_attention``
    on DTensors at one rank: one LSE forward, one backward and one decode
    launch each, bit-equal to the same calls on the local tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b, hq, hkv, s, d = 2, 16, 8, 256, 128
    q, k, v, do = (randn(nccl_mesh.device_type, b, h, s, d,
                         dtype=torch.bfloat16) for h in (hq, hkv, hkv, hq))
    pl = (Shard(0), Replicate())

    def dt(t):
        return DTensor.from_local(t, nccl_mesh, pl, run_check=False)
    leaves = [dt(t).requires_grad_(True) for t in (q, k, v)]
    counts = (flash_attention_fwd_lse.launches, flash_decode.launches)
    out = ops.covenant_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dt(do))
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ops.covenant_attention(*plain)
    wgrads = torch.autograd.grad(want, plain, do)
    assert torch.equal(out.to_local(), want)
    for g, w in zip(grads, wgrads):
        assert torch.equal(g.to_local(), w)
    qd = randn(nccl_mesh.device_type, b, hq, d, dtype=torch.bfloat16)
    lens = torch.tensor([17, 256], device="cuda", dtype=torch.int32)
    got = ops.covenant_decode_attention(dt(qd), dt(k), dt(v), dt(lens))
    assert torch.equal(got.to_local(),
                       ops.covenant_decode_attention(qd, k, v, lens))
    assert flash_attention_fwd_lse.launches == counts[0] + 2
    assert flash_decode.launches == counts[1] + 2


def test_collectives_at_one_rank_on_card(nccl_mesh):
    """``compressed_psum`` is the int8 round trip of its input at one rank;
    ``sharded_decode_attention`` agrees with the decode's plain version."""
    from repro_torch.runtime import collectives
    g = randn("cuda", 64, 96)
    got = collectives.compressed_psum({"g": g}, nccl_mesh, "data")["g"]
    scale = g.abs().max() / 127.0 + 1e-12
    assert torch.equal(got, torch.clamp(torch.round(g / scale), -127, 127)
                       * scale)
    b, h, s, d = 2, 4, 64, 16
    q, k, v = randn("cuda", b, h, d), randn("cuda", b, h, s, d), \
        randn("cuda", b, h, s, d)
    lens = torch.tensor([40, 64], device="cuda", dtype=torch.int32)
    got = collectives.sharded_decode_attention(q, k, v, lens, nccl_mesh)
    want = flash_decode_plain(q.reshape(b * h, 1, d), k.reshape(b * h, s, d),
                              v.reshape(b * h, s, d), lens,
                              kv_heads=h).reshape(b, h, d)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_sharded_train_smoke_matches_unsharded_on_card(cuda, tmp_path):
    """``launch.train --smoke --model-axis 1`` (a one-rank NCCL group that
    the launcher starts) against the unsharded run: the same losses, bit
    for bit, and the same kernel launches."""
    import torch.distributed as dist
    from repro_torch.launch import train
    args = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--seq-len",
            "64", "--global-batch", "4", "--microbatches", "2",
            "--accel-target", "none", "--ckpt-every", "0"]
    plain = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    try:
        sharded = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                     "--model-axis", "1"])
        assert dist.get_backend() == "nccl"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert sharded["report"].losses == plain["report"].losses
    assert sharded["launches"] == plain["launches"]
    assert sharded["launches"]["flash_attention_bwd"] > 0


def test_profiled_spans_are_no_kernel_rows_on_card(cuda):
    """A SMOKE serve batch and an olmoe train step under the profiler
    (``launch.layers.profile_window``), where the program's spans are on:
    the spans' device-side shadows carry ``is_user_annotation`` and give
    no row of ``device_kernels``, so the card's busy time stays within
    the window's wall time; the MoE stages are timed on the card."""
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.launch import layers
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import make_train_step

    cfg = get_config("stablelm-12b", smoke=True)
    model = get_model(cfg, device=cuda)
    params = model.init_params(0)
    prompts = [rng.integers(2, cfg.vocab, 8) for _ in range(4)]
    run = [lambda: serve(model, params, prompts, batch=2, max_new=3,
                         max_len=12)]
    ocfg = get_config("olmoe-1b-7b", smoke=True).replace(
        capacity_factor=0.25)
    omodel = get_model(ocfg, device=cuda)
    oparams = omodel.init_params(0)
    opt = adamw(1e-3)
    step = make_train_step(omodel.loss_fn, opt)
    tokens = torch.randint(2, ocfg.vocab, (2, 64), device=cuda)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    state = opt.init(oparams)
    run.append(lambda: float(step(oparams, state, batch)[2]["loss"]))
    ours = ("serve.", "train.", "moe.")
    for fn in run:
        fn()
        tracing.reset()
        taken = layers.PROFILER_WINDOWS["taken"]
        rows, wall_ms = layers.profile_window(fn, "spans")
        assert rows and not [r for r in rows if r[0].startswith(ours)]
        assert sum(r[1] for r in rows) <= wall_ms
    spans = tracing.records()["spans"]
    # a window that lost a marker is taken again, with one more step
    assert spans["train.step"]["calls"] == \
        layers.PROFILER_WINDOWS["taken"] - taken
    assert spans["train.step"]["device_s"] is None
    for s in ("moe.route", "moe.dispatch", "moe.combine", "moe.combine.bwd"):
        assert spans[s]["device_self_s"] > 0
    tracing.reset()


# ---------------------------------------------------------------------------
# the fused AdamW (csrc/adamw.cu) against the eager path
# ---------------------------------------------------------------------------


def _eager_only(monkeypatch):
    """Send every leaf to the optimizer's eager path."""
    mod = importlib.import_module("repro_torch.optim.adamw")
    monkeypatch.setattr(mod, "_on_card", lambda t: False)


def _adamw_tree(dev, dtype):
    """(params, grads): leaves of 1, 7 and 1003 elements, undecayed and
    decayed (``layers``), matrices, one leaf of several chunks and a
    ragged tail, a param that is a view 2 bytes off its allocation's
    start, and an f32 gradient of a ``dtype`` param (as gradient
    accumulation gives)."""
    from repro_torch.kernels.adamw import CHUNK
    shapes = {"a": (1,), "b": (7,), "c": (1003,), "w": (33, 65),
              "big": (3, CHUNK // 2 + 5)}
    params = {"top": {k: randn(dev, *s, dtype=dtype)
                      for k, s in shapes.items()},
              "layers": {k: randn(dev, *s, dtype=dtype)
                         for k, s in shapes.items()}}
    base = randn(dev, 1004, dtype=dtype)
    params["top"]["view"] = base[1:]
    grads = {top: {k: randn(dev, *p.shape, dtype=dtype)
                   for k, p in leaves.items()}
             for top, leaves in params.items()}
    params["top"]["acc"] = randn(dev, 40, 9, dtype=dtype)
    grads["top"]["acc"] = randn(dev, 40, 9)
    return params, grads


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_bit_equal_to_eager_on_card(cuda, monkeypatch, dtype,
                                               inplace):
    """With the norm held at 3.7 on both sides (the clip bites), two fused
    steps give params and moments equal to the eager path's bit for bit,
    every leaf in one launch a step."""
    from repro_torch.kernels import adamw as fused
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.tree import tree_paths

    mod = importlib.import_module("repro_torch.optim.adamw")
    monkeypatch.setattr(mod, "global_norm",
                        lambda tree: torch.tensor(3.7, device=cuda))
    params, grads = _adamw_tree(cuda, dtype)
    out = []
    for eager in (False, True):
        if eager:
            _eager_only(monkeypatch)
        launches = fused.update.launches
        opt = adamw(cosine_schedule(3e-3, 1, 10), inplace=inplace)
        p, state = params, opt.init(params)
        for _ in range(2):
            p, state, _ = opt.update(grads, state, p)
        assert fused.update.launches - launches == (0 if eager else 2)
        out.append((p, state["mu"], state["nu"]))
    for tree_a, tree_b in zip(*out):
        for (path, a), (_, b) in zip(tree_paths(tree_a), tree_paths(tree_b)):
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_fused_global_norm_matches_eager_on_card(cuda, monkeypatch):
    """The fused norm over the SMOKE model's gradients: within rtol 1e-6 of
    the eager one (f32 sums added in another order), in one launch, and
    the same bits on every call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as fused
    from repro_torch.models import get_model
    from repro_torch.optim import global_norm
    from repro_torch.runtime import make_loss_with_accum

    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = get_model(cfg, device=cuda)
    params = model.init_params(0)
    tokens = torch.randint(2, cfg.vocab, (2, 64), device=cuda)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    _, grads = make_loss_with_accum(model.loss_fn, 1)(params, batch)
    launches = fused.sq_sums.launches
    got = global_norm(grads)
    assert torch.equal(global_norm(grads), got)
    assert fused.sq_sums.launches - launches == 2
    _eager_only(monkeypatch)
    want = global_norm(grads)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_fused_adamw_leaf_past_2_31_on_card(cuda, monkeypatch):
    """One bf16 leaf of 2^31 + 1000 elements (30 GB with its moments and
    new param): the fused step's last 1000 elements equal the eager step
    of that slice alone, and its norm is within rtol 1e-5 of one summed
    in f64 (its f32 sums take at most ~180 roundings in a row)."""
    from repro_torch.optim import adamw, global_norm

    n = (1 << 31) + 1000
    gen = torch.Generator(device=cuda).manual_seed(5)
    g, p = (torch.randn(2, n // 2, device=cuda, dtype=torch.bfloat16,
                        generator=gen) for _ in range(2))
    want_norm = sum(s.double().square().sum()
                    for s in g.view(-1).split(1 << 26)).sqrt()
    got_norm = global_norm({"w": g})
    torch.testing.assert_close(got_norm.double(), want_norm, rtol=1e-5,
                               atol=0)
    opt = adamw(1e-3, inplace=True)
    state = opt.init({"w": p})
    m, v = state["mu"]["w"], state["nu"]["w"]
    m.normal_(0.0, 1e-2, generator=gen)
    v.uniform_(0.0, 1e-4, generator=gen)
    tail = [t.view(-1)[-1000:].clone().view(1, 1000) for t in (g, m, v, p)]
    mod = importlib.import_module("repro_torch.optim.adamw")
    monkeypatch.setattr(mod, "global_norm",
                        lambda tree: torch.tensor(3.7, device=cuda))
    new, state, _ = opt.update({"w": g}, state, {"w": p})
    del g, p
    got = [t.view(-1)[-1000:] for t in (new["w"], state["mu"]["w"],
                                        state["nu"]["w"])]
    _eager_only(monkeypatch)
    tg, tm, tv, tp = tail
    small = {"mu": {"w": tm}, "nu": {"w": tv},
             "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    wnew, wstate, _ = opt.update({"w": tg}, small, {"w": tp})
    want = [t.view(-1) for t in (wnew["w"], wstate["mu"]["w"],
                                 wstate["nu"]["w"])]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_adamw_counts_every_element_on_card(cuda):
    """Under the profiler ``optim.fused_elems`` equals ``optim.elems``:
    every leaf on the card takes the kernel, a view off 16 bytes, an f32
    gradient of a bf16 param and a strided gradient included."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.optim import adamw

    params, grads = _adamw_tree(cuda, torch.bfloat16)
    params["top"]["t"] = randn(cuda, 12, 5, dtype=torch.bfloat16)
    grads["top"]["t"] = randn(cuda, 5, 12, dtype=torch.bfloat16).t()
    opt = adamw(1e-3)
    state = opt.init(params)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        opt.update(grads, state, params)
    counts = tracing.records()["counters"]
    tracing.reset()
    total = sum(t.numel() for v in params.values() for t in v.values())
    assert counts["optim.elems"] == counts["optim.fused_elems"] == total


def test_fused_adamw_update_has_no_host_sync_on_card(cuda):
    """A fused step, its norm and schedule included, never waits for the
    card: the leaf table goes up from pinned memory and the clip scale,
    the bias corrections and the learning rate stay on the card, so the
    host can enqueue the update behind the backward."""
    from repro_torch.optim import adamw, cosine_schedule

    params, grads = _adamw_tree(cuda, torch.bfloat16)
    opt = adamw(cosine_schedule(3e-3, 1, 10), inplace=True)
    state = opt.init(params)
    params, state, _ = opt.update(grads, state, params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state, metrics = opt.update(grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["grad_norm"]))


def _mixed_leaves(dev):
    """Gradient leaves of other sizes and scales, so a sum given to the
    wrong leaf shows: contiguous bf16 and f32, a strided bf16 view, one of
    several chunks, and a CPU leaf between them."""
    from repro_torch.kernels.adamw import CHUNK
    return [randn(dev, 7, dtype=torch.bfloat16) * 3,
            randn(dev, 33, 65) * 0.5,
            (randn(dev, 40, 9, dtype=torch.bfloat16) * 7).t(),
            randn("cpu", 11, 3) * 2,
            randn(dev, 3, CHUNK // 2 + 5, dtype=torch.bfloat16) * 0.1,
            randn(dev, 1003) * 11]


def test_fused_sq_sums_give_each_leaf_its_own_on_card(cuda):
    """``_sq_sums`` over a mixed list: the card's leaves from one launch
    (the strided one made contiguous), the CPU leaf from the eager sum,
    each leaf's sum within rtol 1e-6 of ``_sq_sum`` of that same leaf."""
    from repro_torch.kernels import adamw as fused
    mod = importlib.import_module("repro_torch.optim.adamw")
    leaves = _mixed_leaves(cuda)
    launches = fused.sq_sums.launches
    got = mod._sq_sums(leaves)
    assert fused.sq_sums.launches - launches == 1
    assert len(got) == len(leaves)
    for i, (a, g) in enumerate(zip(got, leaves)):
        want = mod._sq_sum(g)
        assert a.device == g.device, i
        torch.testing.assert_close(a, want, rtol=1e-6, atol=0,
                                   msg=f"leaf {i}")


def test_fused_whole_sums_of_dtensor_leaves_on_card(nccl_mesh):
    """``_whole_sums`` over DTensor leaves on a one-rank mesh, split and
    replicated, and a partial one: each leaf's sum within rtol 1e-6 of
    ``_sq_sum`` of its whole tensor, from one launch, and ``global_norm``
    of the tree within rtol 1e-6 of the eager norm of the plain tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels import adamw as fused
    from repro_torch.optim import global_norm
    mod = importlib.import_module("repro_torch.optim.adamw")
    cuda = nccl_mesh.device_type
    leaves = [t for t in _mixed_leaves(cuda) if t.device.type == cuda]
    places = [(Shard(0), Replicate()), (Replicate(), Replicate()),
              (Replicate(), Shard(1)), (Shard(1), Replicate()),
              (Partial(), Replicate())]
    tree = [DTensor.from_local(t, nccl_mesh, pl, run_check=False)
            for t, pl in zip(leaves, places)]
    launches = fused.sq_sums.launches
    got = mod._whole_sums(tree)
    assert fused.sq_sums.launches - launches == 1
    for i, (a, g) in enumerate(zip(got, leaves)):
        torch.testing.assert_close(a, mod._sq_sum(g), rtol=1e-6, atol=0,
                                   msg=f"leaf {i}")
    norm = global_norm(tree)
    want = torch.sqrt(sum(mod._sq_sum(g) for g in leaves))
    torch.testing.assert_close(norm, want, rtol=1e-6, atol=0)
