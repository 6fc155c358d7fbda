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
# the covenant's RF node: the accumulator budget of one block
H100_SPEC_RF_BYTES = ACG.from_spec(H100_SPEC).memory("RF").capacity_bytes
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


@pytest.mark.parametrize("seq_k,want", [(8, 16), (32, 32), (60, 64),
                                        (96, 64)])
def test_decode_split_floor_stops_at_the_cache(seq_k, want):
    """The 64-key floor of the decode's split never passes the cache, which
    it takes whole (rounded up to 16) when it is shorter."""
    assert decode_block_kv(4, seq_k, 16, 2) == want


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


# The blocks of the kernels that derive their tiling from ``gemm_blocks``
# but keep their SIMT design, at every shape the main paths and
# ``chip_smoke.py`` give them: (seq_q, seq_k, head_dim, heads) -> blocks.
# Pinned before the tensor-core GEMM and flash forward taught the tiler
# their own rules, so that those rules cannot move these kernels.
PINNED_BWD = {
    (512, 512, 128, 64): (64, 64),       # qwen3 train, microbatch 4 x 512
    (1024, 1024, 128, 64): (64, 64),     # qwen3 at 1024 tokens
    (256, 256, 128, 16): (64, 32),       # chip_smoke's f32 window check
    (2048, 2048, 160, 128): (32, 32),    # zamba2 prefill shape
    (2080, 2080, 160, 128): (32, 32),    # zamba2 at its cache length
}
# (rows, seq_k, head_dim, group) -> kv split
PINNED_DECODE = {
    (32, 1024, 128, 2): 64,              # qwen3 serve: 4 x 8 kv heads
    (128, 2080, 160, 1): 112,            # zamba2 serve: 4 x 32 kv heads
    # the other dense configs' serve shapes, whose tiler splits of 32 (16
    # at paligemma's 4 rows) the 64-key floor lifts: gemma3's local and
    # global caches, stablelm, command-r, paligemma's group 8
    (32, 1024, 256, 2): 64,
    (32, 2080, 256, 2): 64,
    (32, 2080, 160, 4): 64,
    (32, 2080, 128, 12): 64,
    (4, 2080, 256, 8): 64,
}
# (chunk, state, headdim, heads, bf16 parts) -> (block_l, block_c) of the
# tensor-core SSD kernel
PINNED_SSD = {
    (512, 128, 64, 1280, 1): (64, 64),   # mamba2 prefill: 320 rows x 4, bf16
    (512, 64, 64, 1280, 2): (64, 64),    # zamba2 prefill, f32
    (512, 128, 64, 16, 2): (64, 32),     # chip_smoke's ssd_ref check, f32
}


@pytest.mark.parametrize("shape", sorted(PINNED_BWD))
def test_attention_bwd_blocks_pinned(shape):
    from repro_torch.kernels.tiling import attention_bwd_blocks

    sq, sk, d, heads = shape
    assert attention_bwd_blocks(sq, sk, d, heads=heads) == PINNED_BWD[shape]


@pytest.mark.parametrize("shape", sorted(PINNED_DECODE))
def test_decode_block_kv_pinned(shape):
    assert decode_block_kv(*shape) == PINNED_DECODE[shape]


@pytest.mark.parametrize("shape", sorted(PINNED_SSD))
def test_ssd_blocks_pinned(shape):
    from repro_torch.kernels.tiling import ssd_mma_blocks

    chunk, n, p, heads, parts = shape
    assert ssd_mma_blocks(chunk, n, p, heads=heads, parts=parts) == \
        PINNED_SSD[shape]


# every bf16 GEMM the main paths run: qwen3 prefill, decode and train rows,
# and the decode GEMMs of mamba2-2.7b and zamba2-2.7b
MAIN_GEMMS = sorted({(g.tokens, g.n, g.k)
                     for arch, rows in (("qwen3-0.6b", (2048, 4, 4096)),
                                        ("mamba2-2.7b", (4,)),
                                        ("zamba2-2.7b", (4,)))
                     for t in rows
                     for g in lm_layer_gemms(get_config(arch), t)})


@pytest.mark.parametrize("mnk", SHAPES + MAIN_GEMMS)
def test_wgmma_blocks_obey_the_kernel_rules(mnk):
    """The tensor-core GEMM's rules: wgmma's N (<= 256) among the built
    instruction sizes, 64-row warpgroup slabs (at most four), the
    warpgroups' accumulators within the RF node, and a ring of at least two
    stages that fits shared memory with its barriers and alignment."""
    from repro_torch.kernels.tiling import (GEMM_SMEM_RESERVE, WGMMA_N,
                                            gemm_stage_bytes, gemm_stages,
                                            wgmma_fits, wgmma_rows)

    bm, bn, bk = gemm_blocks(*mnk, wgmma=True)
    assert wgmma_fits(bm, bn, bk)
    assert bn in WGMMA_N and bn <= 256 and bn % 8 == 0
    rows = wgmma_rows(bm)
    assert rows >= bm and rows % 64 == 0 and rows // 64 <= 4
    rf = H100_SPEC_RF_BYTES
    assert rows * bn * 4 <= rf and bm * bn * 4 <= rf
    stage_k, stages = gemm_stages(bm, bn, bk)
    assert stage_k % 64 == 0 and 64 <= stage_k <= 128
    assert 2 <= stages <= 8
    assert stages * gemm_stage_bytes(bm, bn, stage_k) + GEMM_SMEM_RESERVE \
        <= SMEM_MAX


@pytest.mark.parametrize("mnk", MAIN_GEMMS)
def test_wgmma_rules_keep_the_main_path_blocks(mnk):
    # the kernel's rules only filter: every main-path GEMM keeps its blocks
    assert gemm_blocks(*mnk, wgmma=True) == gemm_blocks(*mnk)


@pytest.mark.parametrize("blocks,ring", [
    ((128, 64, 512), (128, 2)),      # qwen3 train lm_head: half the SM
    ((256, 64, 128), (128, 2)),      # qwen3 prefill lm_head: all of it
    ((4, 16, 3072), (128, 5)),       # qwen3 decode ffn_out: 64-row A slab
    ((4, 48, 512), (128, 3)),        # mamba2 decode lm_head
    ((256, 256, 128), (64, 3)),      # two 128-deep stages do not fit
    ((64, 64, 16), (64, 6)),         # a k block below one swizzle row
])
def test_gemm_stages(blocks, ring):
    from repro_torch.kernels.tiling import gemm_stages

    assert gemm_stages(*blocks) == ring


@pytest.mark.parametrize("mnk", MAIN_GEMMS)
def test_gemm_ring_leaves_room_for_a_second_block(mnk):
    """Where two 128-deep stages fit half of the SM's shared memory, the
    ring takes no more than that half (with its barriers, alignment and
    the hardware's 1 KB a block), so two blocks share an SM."""
    from repro_torch.kernels.tiling import (GEMM_SMEM_RESERVE,
                                            gemm_stage_bytes, gemm_stages)

    bm, bn, bk = gemm_blocks(*mnk, wgmma=True)
    stage_k, stages = gemm_stages(bm, bn, bk)
    half = SMEM_MAX // 2 - GEMM_SMEM_RESERVE
    if 2 * gemm_stage_bytes(bm, bn, min(128, -(-bk // 64) * 64)) <= half:
        assert stages * gemm_stage_bytes(bm, bn, stage_k) <= half


def test_wgmma_fits_refuses_what_the_kernel_cannot_run():
    from repro_torch.kernels.tiling import wgmma_fits

    assert wgmma_fits(256, 64, 128)
    assert not wgmma_fits(64, 320, 64)     # wgmma's n is at most 256
    assert not wgmma_fits(64, 80, 64)      # no instruction built for 80
    assert not wgmma_fits(320, 64, 64)     # five warpgroups
    assert not wgmma_fits(64, 512, 64)     # no n of 512, nor room in the RF
    assert not wgmma_fits(70, 192, 64)     # two slabs of (64, 192) f32


# (seq_q, seq_k, head_dim, heads) of the bf16 forward on the main paths:
# qwen3 serve and train (B 4 x 16 heads, S 512), zamba2 and stablelm
# prefill (B 4 x 32 heads of 160, S 2048), gemma3 prefill (B 4 x 16 heads
# of 256), command-r prefill (B 4 x 96 heads of 128), and short and ragged
# sequences
MMA_ATTN = [(512, 512, 128, 64), (1024, 1024, 128, 64),
            (2048, 2048, 160, 128), (2080, 2080, 160, 128),
            (2048, 2048, 256, 64), (2048, 2048, 128, 384),
            (300, 300, 160, 32), (300, 300, 256, 8), (21, 21, 64, 4),
            (70, 130, 128, 8)]


@pytest.mark.parametrize("shape", MMA_ATTN)
def test_attention_mma_blocks_fit_the_kernel(shape):
    """The bf16 forward's working set: q tiles of 64 or 128 rows (16 a
    warp), kv tiles it is built for, fragments within the register budget
    and the bf16 tiles within half of shared memory (two blocks an SM)."""
    from repro_torch.kernels.tiling import (FLASH_MMA_BLOCK_KV,
                                            FLASH_MMA_BLOCK_Q,
                                            FLASH_MMA_FRAG_REGS,
                                            attention_mma_blocks,
                                            flash_mma_built, flash_mma_regs,
                                            flash_mma_smem_bytes)

    sq, sk, d, heads = shape
    bq, bkv = attention_mma_blocks(sq, sk, d, heads=heads)
    assert bq in FLASH_MMA_BLOCK_Q and bq % 64 == 0
    assert bkv in FLASH_MMA_BLOCK_KV and bkv % 16 == 0
    assert flash_mma_regs(bkv, d) <= FLASH_MMA_FRAG_REGS < 255
    assert flash_mma_smem_bytes(bq, bkv, d) <= SMEM_MAX // 2 - 1024
    assert flash_mma_built(bq, bkv, d)


def test_attention_mma_blocks_at_the_main_path_shapes():
    from repro_torch.kernels.tiling import (attention_mma_blocks,
                                            flash_mma_smem_bytes)

    assert attention_mma_blocks(512, 512, 128, heads=64) == (64, 64)
    assert attention_mma_blocks(2048, 2048, 160, heads=128) == (64, 64)
    # bf16 q (64 x 168), k and v (2 x 64 x 168 each): 107,520 bytes
    assert flash_mma_smem_bytes(64, 64, 160) == 107_520
    # gemma3's prefill: at head dim 256 (64, 64)'s tiles pass half the SM
    # (168,960 bytes), so block_kv halves: (64 + 4 x 32) x 264 x 2 bytes
    assert attention_mma_blocks(2048, 2048, 256, heads=64) == (64, 32)
    assert flash_mma_smem_bytes(64, 32, 256) == 101_376


def test_flash_mma_d256_holds_q_in_shared_memory():
    """At head dim 256 the O accumulator takes 128 registers a thread, so
    the kernel reloads q's fragments each k step instead of holding them:
    the (64, 32) block's fragments fit the budget; held q fragments (64
    more) would not."""
    from repro_torch.kernels.tiling import (FLASH_MMA_FRAG_REGS,
                                            FLASH_MMA_HOLD_Q_MAX_D,
                                            flash_mma_regs)

    assert FLASH_MMA_HOLD_Q_MAX_D == 160
    assert flash_mma_regs(32, 256) == 128 + 16 + 8 <= FLASH_MMA_FRAG_REGS
    assert flash_mma_regs(32, 256) + 256 // 4 > FLASH_MMA_FRAG_REGS
    # below it the q fragments are still counted
    assert flash_mma_regs(64, 160) == 80 + 40 + 32 + 16


@pytest.mark.parametrize("blocks,built", [
    ((64, 32), True), ((32, 32), True), ((128, 64), True), ((32, 64), True),
    ((32, 128), False), ((64, 128), False), ((128, 128), False),
    ((64, 48), False), ((16, 32), False)])
def test_flash_mma_built_at_head_dim_256(blocks, built):
    """The bf16 forward is built at head dim 256 for the block pairs whose
    tiles fit one block's shared memory: block_kv 128 does not."""
    from repro_torch.kernels.tiling import flash_mma_built

    assert flash_mma_built(*blocks, 256) is built


@pytest.mark.parametrize("head_dim", [8, 48, 80, 96, 512])
def test_flash_mma_built_refuses_other_head_dims(head_dim):
    from repro_torch.kernels.tiling import flash_mma_built

    assert not flash_mma_built(64, 32, head_dim)


def _reference_attention_shapes():
    """(arch, head_dim, group) of every reference config with attention:
    zamba2's shared block attends over concat(hidden, embed), twice
    d_model wide."""
    from repro.configs import ARCHS as REF_ARCHS

    out = []
    for arch in REF_ARCHS:
        cfg = ref_get_config(arch)
        if not cfg.n_heads:
            continue
        hd = 2 * cfg.d_model // cfg.n_heads if cfg.family == "hybrid" \
            else cfg.hd
        out.append((arch, hd, cfg.n_heads // cfg.n_kv_heads))
    return out


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_decode_built_for_every_reference_config(elem_bytes):
    """The decode kernel is built for the (head_dim, group) of each of the
    reference's configs with attention, in bf16 and f32: gemma3 (256, 2),
    stablelm (160, 4), command-r (128, 12), paligemma (256, 8) among them."""
    from repro_torch.kernels.flash_attention import _decode_built

    shapes = _reference_attention_shapes()
    assert {(hd, g) for _, hd, g in shapes} >= {
        (128, 2), (256, 2), (160, 4), (128, 12), (256, 8), (160, 1),
        (64, 1), (128, 1)}
    for arch, hd, g in shapes:
        assert _decode_built(hd, g, elem_bytes), (arch, hd, g)


@pytest.mark.parametrize("head_dim,group", [
    (48, 1), (96, 2), (200, 4), (512, 1), (128, 17), (128, 0), (4, 1)])
def test_decode_mirror_refuses_what_is_not_built(head_dim, group):
    """Head dims the kernel is not built for, and groups past 16, are
    refused before a launch: ``flash_decode`` raises on them on the card."""
    from repro_torch.kernels.flash_attention import _decode_built

    for elem_bytes in (2, 4):
        assert not _decode_built(head_dim, group, elem_bytes)


# (seq_q, seq_k, head_dim, heads) -> the bf16 backward's blocks: qwen3's
# training shape (microbatch 4 x 512, 16 heads), qwen3 at 1024 tokens, and
# the D64 case chip_smoke.py checks beside the train shape
PINNED_BWD_MMA = {
    (512, 512, 128, 64): (64, 64),
    (1024, 1024, 128, 64): (64, 64),
    (512, 512, 64, 64): (64, 128),
}
# every bf16 backward shape of the card tests and the main path (whisper's
# encoder, cross and decoder attention at its train batch among them)
BWD_MMA_SHAPES = sorted(PINNED_BWD_MMA) + [
    (1500, 1500, 64, 64), (448, 1500, 64, 64), (448, 448, 64, 64),
    (64, 64, 32, 8), (100, 100, 16, 8), (32, 96, 32, 4),
    (48, 48, 16, 2), (40, 40, 64, 4), (70, 130, 128, 8), (130, 70, 16, 4),
    (200, 200, 64, 2), (2048, 2048, 128, 128), (21, 21, 32, 1)]


@pytest.mark.parametrize("shape", sorted(PINNED_BWD_MMA))
def test_attention_bwd_mma_blocks_pinned(shape):
    from repro_torch.kernels.tiling import attention_bwd_mma_blocks

    sq, sk, d, heads = shape
    assert attention_bwd_mma_blocks(sq, sk, d, heads=heads) == \
        PINNED_BWD_MMA[shape]


@pytest.mark.parametrize("shape", BWD_MMA_SHAPES)
def test_attention_bwd_mma_blocks_fit_the_kernel(shape):
    """Blocks the kernel is built for (4 or 8 warps of 16 rows, whole
    32-column slices), both passes' tiles within half of shared memory
    with the hardware's 1 KB a block (two blocks an SM), and the dkv
    pass's fragments within the register budget."""
    from repro_torch.kernels.tiling import (FLASH_BWD_MMA_BLOCKS,
                                            FLASH_BWD_MMA_FRAG_REGS,
                                            FLASH_BWD_MMA_SLICE,
                                            attention_bwd_mma_blocks,
                                            flash_bwd_mma_regs,
                                            flash_bwd_mma_smem_bytes)

    sq, sk, d, heads = shape
    bq, bkv = attention_bwd_mma_blocks(sq, sk, d, heads=heads)
    for blk in (bq, bkv):
        assert blk in FLASH_BWD_MMA_BLOCKS
        assert blk % 16 == 0 and blk % FLASH_BWD_MMA_SLICE == 0
        assert blk // 16 in (4, 8)
    assert 2 * (flash_bwd_mma_smem_bytes(bq, bkv, d) + 1024) <= SMEM_MAX
    assert flash_bwd_mma_regs(d) <= FLASH_BWD_MMA_FRAG_REGS < 255


def test_flash_bwd_mma_budgets():
    """The layouts the kernel allocates (csrc/flash_attention_bwd.cu,
    dq_mma_smem and dkv_mma_smem) and the fragments: at D128 one
    accumulator (dV, then dK, or dQ) takes 64 registers a thread, the two
    16 x 32 tiles of a slice 32; dK and dV together would take 128."""
    from repro_torch.kernels.tiling import (FLASH_BWD_MMA_FRAG_REGS,
                                            FLASH_BWD_MMA_HEAD_DIMS,
                                            flash_bwd_mma_regs,
                                            flash_bwd_mma_smem_bytes)

    # dq: (2 x 64 + 4 x 64) rows of 136 bf16 + 64 f32 delta; dkv: (2 x 64
    # + 4 x 64) rows + 2 x 2 x 64 f32 lse and delta
    assert flash_bwd_mma_smem_bytes(64, 64, 128) == 384 * 272 + 1024
    # the dkv pass is the larger with block_q 128: (2 x 64 + 4 x 128) rows
    # of 72 bf16 and 2 x 2 x 128 f32
    assert flash_bwd_mma_smem_bytes(128, 64, 64) == 640 * 144 + 2048
    assert flash_bwd_mma_regs(128) == 64 + 32
    assert 2 * 64 + 32 <= FLASH_BWD_MMA_FRAG_REGS
    assert all(flash_bwd_mma_regs(d) <= FLASH_BWD_MMA_FRAG_REGS
               for d in FLASH_BWD_MMA_HEAD_DIMS)
    # at 160 (zamba2's shared block) a (64, 64) block passes half of shared
    # memory and holds an SM alone, within one block's limit
    assert 2 * (flash_bwd_mma_smem_bytes(64, 64, 160) + 1024) > SMEM_MAX
    assert flash_bwd_mma_smem_bytes(64, 64, 160) + 1024 <= SMEM_MAX


# the D256 shapes of the train paths: paligemma-3b (batch 4, 8 q heads, an
# image prefix of 256 and 256 text tokens) and gemma3-12b (batch 4, 16 q
# heads, 2048 tokens)
BWD_MMA_D256 = [(512, 512, 256, 32), (2048, 2048, 256, 64)]


@pytest.mark.parametrize("shape", BWD_MMA_D256)
def test_attention_bwd_mma_blocks_at_head_dim_256(shape):
    """Only (64, 64) fits at head dim 256: its tiles take 203,008 B in the
    dq pass and 203,776 B in the dkv pass, past half of shared memory (one
    block holds an SM, as at 160) but within one block's; every larger
    pair passes one block's."""
    from repro_torch.kernels.tiling import (FLASH_BWD_MMA_BLOCKS,
                                            attention_bwd_mma_blocks,
                                            flash_bwd_mma_smem_bytes)

    sq, sk, d, heads = shape
    assert attention_bwd_mma_blocks(sq, sk, d, heads=heads) == (64, 64)
    row = 2 * (256 + 8)
    assert (2 * 64 + 4 * 64) * row + 4 * 64 == 203_008
    assert flash_bwd_mma_smem_bytes(64, 64, 256) == 203_776
    assert 2 * (203_776 + 1024) > SMEM_MAX >= 203_776 + 1024
    assert [(bq, bkv) for bq in FLASH_BWD_MMA_BLOCKS
            for bkv in FLASH_BWD_MMA_BLOCKS
            if flash_bwd_mma_smem_bytes(bq, bkv, 256) <= SMEM_MAX] == \
        [(64, 64)]


def test_flash_bwd_mma_regs_follow_the_walk():
    """The fragments count one walk's accumulator columns: the whole head
    dim up to 128, half of it above (160 -> 80, 256 -> 128), so D256
    holds what D128 holds."""
    from repro_torch.kernels.tiling import (FLASH_BWD_MMA_FRAG_REGS,
                                            FLASH_BWD_MMA_SLICE,
                                            flash_bwd_mma_regs,
                                            flash_bwd_walk_cols)

    slices = 2 * 16 * FLASH_BWD_MMA_SLICE // 32
    for d, cols in ((64, 64), (128, 128), (160, 80), (256, 128)):
        assert flash_bwd_walk_cols(d) == cols
        assert flash_bwd_mma_regs(d) == cols // 2 + slices
    assert flash_bwd_mma_regs(256) == flash_bwd_mma_regs(128) == 96
    assert flash_bwd_mma_regs(256) < FLASH_BWD_MMA_FRAG_REGS


def test_attention_bwd_mma_blocks_refuse_tiles_past_one_block(monkeypatch):
    """A shape whose smallest tiles pass one block's shared memory raises
    rather than returning blocks the launch would refuse."""
    from repro_torch.kernels import tiling

    smem, rf = tiling._budgets()
    monkeypatch.setattr(tiling, "_budgets", lambda: (200_000, rf))
    with pytest.raises(ValueError, match="shared memory"):
        tiling.attention_bwd_mma_blocks(512, 512, 256, heads=32)
    assert tiling.attention_bwd_mma_blocks(512, 512, 128, heads=64) == \
        (64, 64)


@pytest.mark.parametrize("head_dim", [8, 48, 80, 96, 192])
def test_attention_bwd_mma_blocks_refuse_other_head_dims(head_dim):
    from repro_torch.kernels.tiling import attention_bwd_mma_blocks

    with pytest.raises(ValueError):
        attention_bwd_mma_blocks(512, 512, head_dim, heads=64)


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh header, so
    an edited header builds anew instead of reusing a stale library."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build._target("k") == before
