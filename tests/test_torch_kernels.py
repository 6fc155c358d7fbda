"""The port's kernel API on the CPU (plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same inputs.

Cases and bounds are those of ``tests/test_kernels.py``.  Inputs are made
with numpy; bf16 inputs are rounded from the same f32 values on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_decode)
from repro_torch.kernels.matmul import matmul

rng = np.random.default_rng(7)

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


@pytest.mark.parametrize("mnk", [(64, 64, 64), (96, 130, 200), (8, 8, 8),
                                 (33, 17, 9), (256, 128, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_float_matches_reference(mnk, dtype):
    m, n, k = mnk
    (a, ja), (b, jb) = pair(m, k, dtype=dtype), pair(k, n, dtype=dtype)
    got = ops.covenant_matmul(a, b, blocks=(32, 128, 128))
    want = jops.covenant_matmul(ja, jb, blocks=(32, 128, 128))
    np.testing.assert_allclose(f32(got), f32(want),
                               atol=5e-2 if dtype == "bf16" else 1e-4,
                               rtol=1e-2 if dtype == "bf16" else 1e-5)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("mnk", [(64, 64, 64), (40, 50, 60)])
def test_matmul_int8_matches_reference(mnk):
    m, n, k = mnk
    a = rng.integers(-8, 8, (m, k)).astype(np.int8)
    b = rng.integers(-8, 8, (k, n)).astype(np.int8)
    got = ops.covenant_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              blocks=(32, 128, 128))
    want = jops.covenant_matmul(jnp.asarray(a), jnp.asarray(b),
                                blocks=(32, 128, 128))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_covenant_default_blocks():
    (a, ja), (b, jb) = pair(300, 200), pair(200, 150)
    got = ops.covenant_matmul(a, b)  # tiler-chosen blocks, h100 covenant
    want = jops.covenant_matmul(ja, jb)  # tpu_v5e covenant
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-3)


def test_matmul_rejects_untiled_shapes():
    with pytest.raises(ValueError):
        matmul(torch.ones(33, 8), torch.ones(8, 16), block_m=32, block_n=16,
               block_k=8)


FA_CASES = [
    dict(b=2, hq=4, hkv=4, sq=64, sk=64, d=32, causal=True, win=None),
    dict(b=1, hq=8, hkv=2, sq=100, sk=100, d=16, causal=True, win=None),
    dict(b=2, hq=4, hkv=2, sq=64, sk=64, d=32, causal=True, win=16),
    dict(b=1, hq=4, hkv=4, sq=32, sk=96, d=32, causal=True, win=None),
    dict(b=1, hq=2, hkv=2, sq=48, sk=48, d=16, causal=False, win=None),
    dict(b=1, hq=4, hkv=1, sq=40, sk=40, d=64, causal=True, win=None),  # MQA
]


def _qkv(case, dtype="f32"):
    return (pair(case["b"], case["hq"], case["sq"], case["d"], dtype=dtype),
            pair(case["b"], case["hkv"], case["sk"], case["d"], dtype=dtype),
            pair(case["b"], case["hkv"], case["sk"], case["d"], dtype=dtype))


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_matches_reference(case):
    (q, jq), (k, jk), (v, jv) = _qkv(case)
    got = ops.covenant_attention(q, k, v, causal=case["causal"],
                                 window=case["win"], blocks=(32, 128))
    want = jops.covenant_attention(jq, jk, jv, causal=case["causal"],
                                   window=case["win"], blocks=(32, 128))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_dtypes(dtype):
    case = dict(b=1, hq=2, hkv=2, sq=64, sk=64, d=32)
    (q, jq), (k, jk), (v, jv) = _qkv(case, dtype)
    got = ops.covenant_attention(q, k, v, blocks=(32, 64))
    want = jops.covenant_attention(jq, jk, jv, blocks=(32, 64))
    assert got.dtype == _T[dtype]
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2)


def test_flash_decode_matches_reference():
    b, hq, hkv, s, d = 3, 8, 2, 256, 32
    (q, jq), (k, jk), (v, jv) = pair(b, hq, d), pair(b, hkv, s, d), \
        pair(b, hkv, s, d)
    lens = np.array([100, 256, 17])
    got = ops.covenant_decode_attention(q, k, v, torch.from_numpy(lens),
                                        block_kv=64)
    want = jops.covenant_decode_attention(jq, jk, jv, jnp.asarray(lens),
                                          block_kv=64)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-3)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_flash_decode_kv_heads_matches_reference(kv_heads):
    """One length per batch entry of ``kv_heads`` rows: the same as the
    reference's Pallas decode (interpret mode) given one length per row."""
    from repro.kernels.flash_attention import flash_decode as jflash_decode

    b, hg, s, d = 3, 2, 96, 32
    rows = b * kv_heads
    (q, jq), (k, jk), (v, jv) = pair(rows, hg, d), pair(rows, s, d), \
        pair(rows, s, d)
    lens = np.array([0, 96, 33])
    got = flash_decode(q, k, v, torch.from_numpy(lens).int(), block_kv=32,
                       kv_heads=kv_heads)
    want = jflash_decode(jq, jk, jv, jnp.asarray(np.repeat(lens, kv_heads)),
                         block_kv=32, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-3)
    assert bool((got[:kv_heads] == 0).all())
    with pytest.raises(ValueError):
        flash_decode(q, k, v, torch.from_numpy(lens), kv_heads=kv_heads + 1)


def test_flash_window_equals_dense_when_window_covers_all():
    case = dict(b=1, hq=2, hkv=2, sq=64, sk=64, d=16)
    (q, jq), (k, jk), (v, jv) = _qkv(case)
    wide = ops.covenant_attention(q, k, v, causal=True, window=4096,
                                  blocks=(32, 64))
    dense = ops.covenant_attention(q, k, v, causal=True, window=None,
                                   blocks=(32, 64))
    np.testing.assert_allclose(f32(wide), f32(dense), atol=1e-5)
    want = jops.covenant_attention(jq, jk, jv, causal=True, window=4096,
                                   blocks=(32, 64))
    np.testing.assert_allclose(f32(wide), f32(want), atol=2e-3)


def test_kernel_window_zero_masks_everything():
    # the kernel-level meaning of window=0, as in _fa_kernel/attention_ref
    case = dict(b=1, hq=2, hkv=2, sq=32, sk=32, d=16)
    (q, jq), (k, jk), (v, jv) = _qkv(case)
    got = ops.covenant_attention(q, k, v, window=0, blocks=(32, 32))
    want = jops.covenant_attention(jq, jk, jv, window=0, blocks=(32, 32))
    np.testing.assert_array_equal(f32(got), f32(want))
    assert not f32(got).any()


@pytest.mark.parametrize("case", FA_CASES)
def test_attention_ref_matches_reference_oracle(case):
    (q, jq), (k, jk), (v, jv) = _qkv(case)
    got = ref.attention_ref(q, k, v, causal=case["causal"],
                            window=case["win"])
    want = jref.attention_ref(jq, jk, jv, causal=case["causal"],
                              window=case["win"])
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-3)


def test_attention_ref_kv_len_matches_reference_oracle():
    (q, jq), (k, jk), (v, jv) = pair(3, 8, 1, 32), pair(3, 2, 64, 32), \
        pair(3, 2, 64, 32)
    lens = np.array([10, 64, 0])
    got = ref.attention_ref(q, k, v, causal=False,
                            kv_len=torch.from_numpy(lens))
    want = jref.attention_ref(jq, jk, jv, causal=False,
                              kv_len=jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_ref_matches_reference_oracle(dtype):
    (a, ja), (b, jb) = pair(40, 24, dtype=dtype), pair(24, 56, dtype=dtype)
    np.testing.assert_allclose(f32(ref.matmul_ref(a, b)),
                               f32(jref.matmul_ref(ja, jb)),
                               atol=1e-4, rtol=1e-5)
    ai = rng.integers(-8, 8, (16, 32)).astype(np.int8)
    bi = rng.integers(-8, 8, (32, 8)).astype(np.int8)
    np.testing.assert_array_equal(
        ref.matmul_ref(torch.from_numpy(ai), torch.from_numpy(bi),
                       out_dtype=torch.int32).numpy(),
        np.asarray(jref.matmul_ref(jnp.asarray(ai), jnp.asarray(bi),
                                   out_dtype=jnp.int32)))


def test_wrappers_count_no_launch_on_cpu():
    before = (matmul.launches, flash_attention.launches,
              flash_decode.launches)
    ops.covenant_matmul(torch.ones(8, 8), torch.ones(8, 8))
    ops.covenant_attention(torch.ones(1, 2, 8, 16), torch.ones(1, 2, 8, 16),
                           torch.ones(1, 2, 8, 16))
    ops.covenant_decode_attention(torch.ones(1, 2, 16),
                                  torch.ones(1, 2, 8, 16),
                                  torch.ones(1, 2, 8, 16), torch.tensor([3]))
    assert (matmul.launches, flash_attention.launches,
            flash_decode.launches) == before


def test_wrappers_refuse_other_devices():
    meta = torch.ones(64, 64, device="meta")
    with pytest.raises(ValueError):
        matmul(meta, meta, block_m=64, block_n=64, block_k=64)
