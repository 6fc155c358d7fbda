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
