"""The bf16 attention gate of ``chip_smoke.py`` (``attn_probes.bf16_gate``).

Each element of a bf16 kernel output is held within max(2e-2, one bf16 ulp
of the f32 plain value): one ulp at magnitude 4 to 8 is 2^-5 = 0.03125,
above the reference's 2e-2, where a correct kernel's rounding alone can
reach it; below magnitude 4 the 2e-2 bound holds unchanged.
"""
import torch

from repro_torch.launch.attn_probes import bf16_gate


def test_one_ulp_rounding_at_magnitude_4_to_8_passes():
    want = torch.tensor([4.0, 5.3, -7.9, 0.5, 2.0])
    got = want.clone()
    got[:3] += torch.tensor([2.0 ** -5, -2.0 ** -5, 2.0 ** -5])
    err, ok = bf16_gate(got.to(torch.bfloat16), want)
    assert ok and err > 2e-2


def test_a_small_error_at_magnitude_1_fails():
    want = torch.tensor([1.0, 0.25, 3.0])
    got = want + torch.tensor([0.025, 0.0, 0.0])
    err, ok = bf16_gate(got, want)
    assert not ok and abs(err - 0.025) < 1e-6


def test_two_ulps_at_magnitude_4_fail_and_lists_are_held_together():
    want = torch.full((3,), 4.5)
    assert not bf16_gate(want + 2 * 2.0 ** -5, want)[1]
    ok_pair = bf16_gate([want, want], [want, want])
    bad_pair = bf16_gate([want, want + 0.07], [want, want])
    assert ok_pair == (0.0, True) and not bad_pair[1]
