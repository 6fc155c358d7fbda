"""The arithmetic behind the bf16 flash backward's operand split
(``launch/attn_probes.py``, ``csrc/mma_sync.cuh`` a_split3_from_c), on the
CPU: three bf16 parts hold an f32 value exactly, and at a small causal
attention the split's outputs round to the plain version's bf16 values as
often as an exact operand's do, where two parts miss several times as
often."""
import numpy as np
import pytest
import torch

from repro_torch.launch.attn_probes import bf16_parts, simulate


def test_three_bf16_parts_hold_an_f32():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    assert torch.equal(bf16_parts(x, 3), x.double())
    assert not torch.equal(bf16_parts(x, 2), x.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_three_parts_round_like_an_exact_operand(seed):
    shape = dict(b=1, hq=4, hkv=2, s=256)
    res = simulate(torch.device("cpu"), 32, seed, shape)
    numel = [4 * 256 * 32, 2 * 256 * 32, 2 * 256 * 32]   # dq, dk, dv
    for three, two, exact, n in zip(res["3 parts"], res["2 parts"],
                                    res["exact"], numel):
        assert three <= exact + 3 / n
        assert two > 2 * exact


def test_kernel_order_sums_against_float64():
    """The backward's order of sums (``kernel_order``) at a small causal
    attention of group 8, as paligemma's: its float64 arm is
    ``exact_bwd``'s, and compensated adds of dq, dk and dv come closer to
    float64 than plain f32 adds do; ``order_counts`` counts every arm."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_fwd_lse_plain
    from repro_torch.launch.attn_probes import (_inputs, exact_bwd,
                                                kernel_order, order_counts)

    q, k, v, do = _inputs(32, 0, torch.device("cpu"), 1, 8, 1, 128)
    out, lse = flash_attention_fwd_lse_plain(q, k, v)
    res = kernel_order(q, k, v, out, lse, do)
    for a, b in zip(res["exact"], exact_bwd(q, k, v, out, lse, do)):
        torch.testing.assert_close(a, b)
    err = {name: [float((t.double() - e).abs().sum())
                  for t, e in zip(res[name], res["exact"])]
           for name in ("order", "compensated")}
    for i in (0, 1, 2):
        assert err["compensated"][i] < err["order"][i]
    counts = order_counts(res)
    assert len(counts["big"]) == 3
    assert all(len(counts[n]["flips"]) == 3
               for n in ("order", "compensated", "plain"))


# the SSD kernel's operand parts (``launch/ssd_probes.py``,
# ``csrc/ssd_scan.cu``): at a small chunk, one part of bf16 inputs keeps
# each term within one bf16 rounding (2^-8, two thirds of the gate), f32
# inputs need two parts for both gates and one part misses the oracle's

def test_ssd_probe_parts_against_the_gates():
    from repro_torch.launch.ssd_probes import (bf16_split, check_ssd_case,
                                               check_ssd_ref_case)

    x = torch.randn(1000, dtype=torch.float32)
    assert torch.equal(sum(bf16_split(x, 3)), x.double())
    small = dict(heads=2, s=256, chunk=128)
    bf16 = check_ssd_case("mamba2", 1, **small)
    assert bf16["ok"] and bf16["worst_ratio"] <= 2 / 3 + 1e-3
    assert check_ssd_case("zamba2", 2, **small)["worst_ratio"] < 0.05
    assert check_ssd_ref_case(2)["ok"]
    assert not check_ssd_ref_case(1)["ok"]
