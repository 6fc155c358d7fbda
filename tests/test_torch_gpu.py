"""The port's Hopper kernels against their plain versions, on the card.

Marked ``gpu``: these need a CUDA card and nvcc, and skip elsewhere (the
decision is made in a fixture, never at import).  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Cases and bounds are those of ``tests/test_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
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


def _blocks(case):
    from repro_torch.kernels.tiling import attention_bwd_blocks

    return attention_bwd_blocks(case["sq"], case["sk"], case["d"],
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
    bq, bkv = _blocks(case)
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
    got = flash_attention_bwd(q, k, v, want, want_lse, do,
                              block_q=_blocks(case)[0],
                              block_kv=_blocks(case)[1])
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
