"""The benchmark's frozen arithmetic against the program's own copy as it
stands, and the flash counts against a direct count."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench_smoke import cells
from bench import yardstick

BENCH = cells.spec()


def _configs():
    from repro_torch import configs

    ours = [cells.load_json(cells.config_file(c["name"]))
            for c in BENCH["configs"]]
    # every config the program holds, as a configuration file's keys
    theirs = [dataclasses.asdict(configs.get_config(a))
              for a in configs.ARCHS]
    return ours + theirs


@pytest.mark.parametrize("cfg", _configs(), ids=lambda c: c["name"])
def test_counts_equal_the_programs(cfg):
    from repro_torch.configs import ShapeSpec
    from repro_torch.roofline import model as theirs

    arch = cells.arch_config(cfg)
    assert yardstick.param_count(cfg) == theirs.param_count(arch)
    for kind, seq, batch in (("train", 2048, 2), ("prefill", 4080, 16),
                             ("decode", 4090, 16)):
        shape = ShapeSpec("s", kind, seq, batch)
        assert yardstick.model_flops(cfg, batch, seq, kind) == \
            theirs.model_flops(arch, shape, kind)


def test_peaks_are_the_data_sheets():
    from repro_torch.core.h100 import H100

    assert yardstick.PEAK_BF16_FLOPS == H100["peak_bf16_flops"] == 989e12
    assert yardstick.HBM_BYTES_PER_S == H100["hbm_bw"] == 3.35e12


@pytest.mark.parametrize("sq,sk", [(5, 5), (3, 7), (1, 9)])
def test_causal_pairs_count_the_mask(sq, sk):
    q = torch.arange(sk - sq, sk)[:, None]
    k = torch.arange(sk)[None, :]
    assert yardstick.causal_pairs(2, 3, sq, sk) == 6 * int((k <= q).sum())


def test_flash_counts():
    b, hq, hkv, s, d = 2, 4, 2, 8, 16
    pairs = b * hq * s * (s + 1) // 2
    f, by = yardstick.flash_forward(b, hq, hkv, s, d, 2, lse=False)
    assert f == 4 * pairs * d and by == (2 * b * hq + 2 * b * hkv) * s * d * 2
    f2, by2 = yardstick.flash_forward(b, hq, hkv, s, d, 2, lse=True)
    assert f2 == f and by2 == by + b * hq * s * 4
    f, by = yardstick.flash_backward(b, hq, hkv, s, d, 2)
    assert f == 10 * pairs * d
    assert by == (4 * b * hq + 4 * b * hkv) * s * d * 2 + b * hq * s * 4
    assert yardstick.bound_seconds(989e12, 0) == 1.0
    assert yardstick.bound_seconds(0, 3.35e12) == 1.0
