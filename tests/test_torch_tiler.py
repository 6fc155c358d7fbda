"""The port's copy of the Covenant tiler and its ``h100`` covenant.

The copied numpy core must give the same tilings and costs as
``repro.core`` on both ``h100`` and ``tpu_v5e``; the Hopper block rules
must hold for every shape the port runs.
"""
import dataclasses

import pytest
import torch

from repro.core import library as ref_library
from repro.core import scheduler as ref_scheduler
from repro.core.acg import ACG as RefACG
from repro.core.spec import ACGSpec as RefACGSpec
from repro.core.spec import validate_spec as ref_validate_spec
from repro.core.targets import TPU_V5E_SPEC
from repro.launch.layers import lm_layer_gemms as ref_lm_layer_gemms
from repro.configs import get_config as ref_get_config

from repro_torch.configs import get_config
from repro_torch.core import library, scheduler
from repro_torch.core.acg import ACG
from repro_torch.core.dtypes import dt
from repro_torch.core.spec import ACGSpec, validate_spec
from repro_torch.kernels.matmul import smem_bytes, thread_tile
from repro_torch.kernels.tiling import (K_UNIT, attention_blocks,
                                        decode_block_kv, flash_smem_bytes,
                                        gemm_blocks, gemm_fits)
from repro_torch.launch.layers import lm_layer_gemms
from repro_torch.targets import H100, H100_SPEC

SMEM_MAX = H100["smem_bytes_per_block"]
QWEN = get_config("qwen3-0.6b")
# test_kernels.py:22 shapes, then every qwen3 block GEMM at prefill
# (4 x 512 tokens) and decode (4 tokens)
SHAPES = [(512, 512, 512), (384, 4096, 1024), (8192, 8192, 8192),
          (100, 50, 30)] + sorted({(g.tokens, g.n, g.k)
                                   for t in (2048, 4)
                                   for g in lm_layer_gemms(QWEN, t)})


def test_h100_spec_is_valid_in_both_copies():
    assert validate_spec(H100_SPEC) == []
    ref = RefACGSpec.from_dict(H100_SPEC.to_dict())
    assert ref_validate_spec(ref) == []
    assert ref.to_dict() == H100_SPEC.to_dict()


def _tilings(lib, sched, acg, m, n, k, in_dtype):
    acc = "i32" if in_dtype == "i8" else "f32"
    cdlt = lib.gemm(m, n, k, in_dtype=in_dtype, acc_dtype=acc)
    sched.place_operands(cdlt, acg)
    sched.map_compute(cdlt, acg, vectorize=True)
    plans = sched.plan_operands(cdlt, acg)
    cands = sched.enumerate_tilings(cdlt, acg, plans, max_candidates=6000)
    if not cands:  # the §4 zero-padding fallback, as gemm_blocks uses it
        cands = sched.enumerate_tilings(cdlt, acg, plans,
                                        max_candidates=6000, pad_align=True)
    costs = [sched.estimate_tiling_cost(cdlt, acg, plans, t) for t in cands]
    staging = [(p.surrogate, p.path) for p in plans]
    return cands, costs, staging


@pytest.mark.parametrize("target", ["h100", "tpu_v5e"])
@pytest.mark.parametrize("in_dtype", ["bf16", "i8"])
@pytest.mark.parametrize("mnk", SHAPES)
def test_copied_tiler_matches_reference(target, in_dtype, mnk):
    spec = H100_SPEC if target == "h100" else TPU_V5E_SPEC
    mine = ACG.from_spec(ACGSpec.from_dict(spec.to_dict()))
    ref = RefACG.from_spec(RefACGSpec.from_dict(spec.to_dict()))
    got = _tilings(library, scheduler, mine, *mnk, in_dtype)
    want = _tilings(ref_library, ref_scheduler, ref, *mnk, in_dtype)
    assert got == want
    assert got[0], "Algorithm 1 found no tiling"


@pytest.mark.parametrize("in_dtype", ["bf16", "f32", "i8"])
@pytest.mark.parametrize("mnk", SHAPES)
def test_gemm_blocks_obey_hopper_rules(in_dtype, mnk):
    m, n, k = mnk
    bm, bn, bk = gemm_blocks(m, n, k, in_dtype=in_dtype)
    assert bm == m if m < 64 else bm % 64 == 0
    assert bn % 16 == 0 and bk % K_UNIT[in_dtype] == 0
    assert gemm_fits(bm, bn, bk, in_dtype)
    # the GEMM kernel can launch what the tiler picked
    tm, tn, txc, tyc = thread_tile(bm, bn)
    assert tm <= 8 and tn <= 16 and txc * tyc <= 256
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "i8": torch.int8}[in_dtype]
    assert smem_bytes(bm, bn, bk, dtype) <= SMEM_MAX


@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 128), (512, 512, 128),
                                     (64, 64, 32), (100, 100, 16),
                                     (2, 1024, 128)])
def test_attention_blocks_bounded(sq, sk, d):
    bq, bkv = attention_blocks(sq, sk, d)
    assert bq == sq if sq < 64 else bq % 64 == 0
    assert bkv % 16 == 0
    assert flash_smem_bytes(bq, bkv, d) <= SMEM_MAX
    for rows, cols in ((bq, bkv), (bq, d)):
        tm, tn, txc, tyc = thread_tile(rows, cols, max_tn=8)
        assert tm <= 8 and tn <= 8 and txc * tyc <= 256


def test_decode_split_fills_the_card():
    # qwen3 decode: batch 4 x 8 kv heads, 2 q heads each, 1024-slot cache
    bkv = decode_block_kv(32, 1024, 128, 2)
    assert bkv % 16 == 0 and 32 * -(-1024 // bkv) >= 2 * H100["sms"]


def test_h100_constants_follow_the_data_sheet():
    acg = ACG.from_spec(H100_SPEC)
    assert acg.memory("SMEM").capacity_bytes <= SMEM_MAX
    assert acg.highest_memory().name == "HBM"
    per_sm_cycle = H100["hbm_bw"] / H100["sms"] / H100["clock_hz"]
    assert abs(acg.edge("HBM", "SMEM").bandwidth / 8 - per_sm_cycle) < 1
    assert dt("bf16").torch() is torch.bfloat16 and dt("i8").torch() is \
        torch.int8


@pytest.mark.parametrize("tokens", [2048, 4])
def test_layer_gemms_match_reference(tokens):
    mine = [dataclasses.astuple(g) for g in lm_layer_gemms(QWEN, tokens)]
    ref = [dataclasses.astuple(g) for g in
           ref_lm_layer_gemms(ref_get_config("qwen3-0.6b"), tokens)]
    assert mine == ref


def test_paper_layers_compile_on_h100_with_the_reference_driver():
    # the examples/new_accelerator.py flow: the spec is data, so the
    # reference compiler takes the port's covenant unchanged
    import repro
    from repro.core.library import PAPER_LAYERS

    spec = RefACGSpec.from_dict(H100_SPEC.to_dict())
    for layer in PAPER_LAYERS:
        assert repro.compile(layer, spec).cycles() > 0, layer


@pytest.mark.parametrize("tokens", [2048, 4])
def test_gemm_grid_fills_the_card(tokens):
    # Hopper runs blocks in parallel; the serial cost model alone gave the
    # decode projections one block.  The target is two blocks per SM, or
    # the most aligned blocks the shape has; the tiler's pruned divisor grid
    # may land within a factor of two of it.
    for g in lm_layer_gemms(QWEN, tokens):
        bm, bn, _ = gemm_blocks(g.tokens, g.n, g.k)
        blocks = -(-g.tokens // bm) * -(-g.n // bn)
        most = -(-g.tokens // min(g.tokens, 64)) * -(-g.n // 16)
        assert blocks >= min(2 * H100["sms"], most) // 2, (g, bm, bn)
