"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

``python3 chip_smoke.py`` from the repository root:

1. builds the Hopper kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once), prints each library's tensor-core instructions
   (``HGMMA``, ``HMMA``, ``IMMA`` in its SASS; the GEMM must hold
   ``HGMMA``, the flash forward, the flash backward and the SSD chunk scan
   ``HMMA`` or ``HGMMA``, and their tensor-core kernels must build without
   a register spill) and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card, in the
   working dtype, at the shapes the main paths give it, and times kernel,
   plain version and one PyTorch library call with CUDA events around a
   loop of host calls and by their device time, CUDA events around calls
   the card runs back to back while a spin kernel holds the stream
   (``device_ms``);
   the forward, the decode and the backward must give bit-equal results
   on two runs, and every attention kernel (the forward with and without
   the LSE, the decode, each of the backward's dq, dk and dv) must also
   come within a relative L2 of its plain version (``ATTN_REL_L2``);
3. serve: drives ``repro_torch.launch.serve``: the Covenant report of the
   model's block GEMMs against ``h100`` (cycles, predicted ms and
   ``covenant_matmul``'s time), then full-width qwen3-0.6b with seeded random
   bf16 weights serving 8 requests (batch 4, prompt 512, 32 new tokens)
   with ``--attn kernel``, every launch counter set to 0 just before and
   read just after; then compares the kernel path with the plain path on
   the same weights, and profiles one more batch for the card's busy share;
4. train: holds the fused AdamW (``csrc/adamw.cu``) against the eager
   path on full-width qwen3-0.6b's param tree with seeded random gradients
   and moments (the norm within ``ADAMW_NORM_RTOL``, a step at that norm
   bit-equal, both bit-equal on two runs, each timed against the eager
   path and its bytes bound); holds one full-width train step's loss and
   gradient, kernel
   attention against plain attention on the same weights and batch, in f32
   and in bf16; then drives ``repro_torch.launch.train`` (the block-GEMM
   report at 8 x 512 tokens, then 6 AdamW steps of full-width qwen3-0.6b,
   batch 8 x 512 in 2 microbatches, checkpoints every 3 steps under
   ``build/train_ckpt``) with every launch counter set to 0 just before and
   read just after, and resumes the same run to 8 steps from its step-6
   checkpoint; then profiles one more train step for the card's busy share;
5. ssd: holds ``ssd_chunk_scan`` against its plain version at the
   prefill shapes of mamba2-2.7b (bf16) and zamba2-2.7b (f32), bit-equal
   on two runs, with its device time, and in f32 against the sequential
   oracle ``ssd_ref`` (ragged S, 2 groups, an ``init_state``
   continuation);
6. and 7. serves full-width mamba2-2.7b, then zamba2-2.7b (seeded random
   bf16 weights, 8 requests, batch 4, prompt 2048, 32 new tokens, cache
   2080) through ``launch.serve`` with every counter from 0, requires the
   SSD kernel once per mamba layer of each batch (and for zamba2 flash
   attention once per shared-block use of each batch, flash decode once
   per use of each decode step, at head_dim 160, checked first), compares
   the kernel path with the plain path (gated in f32, printed in bf16
   beside the bf16 model's own spread); each model is freed before the
   next loads;
8. trains mamba2-2.7b, then zamba2-2.7b: the SSD kernel at the train
   shape (2 x 1024 tokens, bf16) and for zamba2 the LSE forward and the
   backward at head dim 160; one train step at full width and reduced
   depth, kernel path against plain path in f32 and bf16
   (``compare_ssm_train_paths``); then ``launch.train`` at full width and
   depth, 3 steps of 2 x 1024 with no checkpoint, the counters from 0,
   the SSD kernel (and for zamba2 the flash backward) required;
9. serves gemma3-12b and stablelm-12b at full width and depth and
   command-r-plus-104b at full width and 4 of its 64 layers (seeded random
   bf16 weights, 8 requests, batch 4, prompt 2048, 32 new tokens, cache
   2080), one after another, each freed before the next loads: first
   their GEMM, attention (each window their layers use; gemma3's head dim
   256 also in f32 and through the LSE forward) and decode shapes (each
   cache width, bf16 and f32; and the (256, 8) group beside gemma3's),
   then ``launch.serve`` with every counter from 0, flash attention
   required once per layer of each batch and flash decode once per layer
   of each decode step, the kernel path against the plain path in bf16
   beside the plain path's own one-ulp spread;
10. serves the MoE family, deepseek-moe-16b then olmoe-1b-7b, at full
   width and depth with the same traffic, each freed before the next
   loads: their GEMM, attention (head dim 128, group 1) and decode shapes
   checked first; one MoE layer's dispatch at full width on the card
   against the CPU in f32, on tokens that crowd a few experts past their
   capacity (the same assignments kept, outputs within 1e-4, bit-equal on
   two card runs); then ``launch.serve`` with every counter from 0, flash
   attention required once per layer of each batch and flash decode once
   per layer of each decode step, the dense leading layer counted; the
   kernel path against the plain path gated in f32 (olmoe at full depth,
   deepseek at 4 layers) and printed in bf16 at full depth beside the
   plain path's own one-ulp spread and the (token, expert) assignments
   that differ between the paths in each layer;
11. serves whisper-base, then paligemma-3b, at full width and depth,
   with seeded random bf16 weights
   (whisper: 16 requests, batch 8 of (8, 1500, 512) frames, prompt 4, 128
   new tokens, cache 448; paligemma: 8 requests, batch 4 of (4, 256,
   1152) patches, prompt 32, 32 new tokens, cache 320), each freed before
   the next loads: first their GEMM,
   attention and decode shapes in bf16 and f32 (whisper's non-causal
   encoder forward over 1500 frames and cross attention of the prompt
   against them, its causal decoder prompt, its decode against the self
   cache and against the full cross cache; paligemma's causal forward at
   head dim 256 and group 8 over image prefix and prompt, and its
   decode), and whisper's ragged key edge at 1500 left unmasked on
   purpose, which the bf16 gates must reject (``planted_faults``); then
   ``launch.serve`` with every counter from 0, flash
   attention required once per attention of each batch (whisper: each
   encoder layer, and each decoder layer's self and cross attention) and
   flash decode once per attention of each decode step; the kernel path
   against the plain path over the prefill and 8 decode steps, gated in
   f32 (1e-4) and in bf16 (beside the plain path's own one-ulp spread);
12. trains whisper-base, then paligemma-3b, at full width and depth, each
   freed before the next loads: first the layer report's GEMMs at the
   train tokens, and the LSE forward and the backward at their train
   shapes in bf16 and f32 (whisper, batch 8: the non-causal encoder over
   1500 frames, the 448-token decoder across them, its causal self
   attention; paligemma, batch 4: causal at head dim 256, 8 q heads over
   one kv head, 256 + 256 tokens), each gated in relative L2 too, and
   whisper's ragged
   key edge left unmasked through the LSE forward and the backward on
   purpose, which the backward's relative gate must reject
   (``planted_bwd_fault``); then one train step at full width and reduced
   depth (whisper 2 + 2 layers, paligemma 2), kernel path against plain
   path in f32 and bf16 (``compare_encdec_vlm_train_paths``); then
   ``launch.train`` at full width and depth, 3 steps (whisper 8 x 448
   tokens with (8, 1500, 512) frames, paligemma 4 x 256 with (4, 256,
   1152) patches), no checkpoint, every counter from 0, the LSE forward
   and the backward required exactly ``train_attention_launches`` times;
13. trains olmoe-1b-7b, deepseek-moe-16b, stablelm-12b, gemma3-12b and
   command-r-plus-104b at full width and reduced depth (``TRAIN_CONFIGS``:
   8, 6, 10, 12 and 1 layers; 2 x 2048 tokens, command-r 1 x 2048), each
   freed before the next loads: the layer report's GEMMs at the train
   tokens; the LSE forward and the backward at the train shape in bf16
   and f32 (the MoE family's 16 heads of 128, stablelm's 32 q / 8 kv of
   160, gemma3's 16 / 8 of 256 with its window of 1024 and without,
   command-r's 96 / 8 of 128), gated as phase 12's; for the MoE archs one
   layer's dispatch backward at full width, bit-equal on two card runs in
   bf16 and f32 and within 1e-4 of the CPU's in f32 with tokens dropped
   (``check_moe_backward``); one train step at full width and the gate
   depth, kernel path against plain path in f32 (loss 1e-4, gradient
   1e-3) and bf16 (3x the plain path's one-ulp spread), with the MoE
   archs' routing differences beside them; then ``launch.train
   --n-layers`` for 3 steps, no checkpoint, every counter from 0, the LSE
   forward and the backward exactly ``train_attention_launches`` times,
   none of the other attention and SSD kernels, the peak device memory at
   most 70 GiB;
14. the Covenant compiler on the card: compiles each of the ten configs'
   block GEMMs at full width against ``h100`` (``repro_torch.compile``) at
   the decode batch of its serve phase and the tokens a step of its train
   phase, as the reference's i8 codelets and as bf16 ones, into a fresh
   disk store; prints per GEMM the cycles, the covenant's predicted ms,
   the device time of ``covenant_matmul`` and of ``torch.matmul`` in bf16
   and the bound; runs ``launch.serve`` for full-width qwen3-0.6b with
   ``--accel-target hvx --accel-search`` and with ``--accel-target
   dnnweaver@pe=32x32`` (exit 0, ``block total`` printed, flash attention
   and flash decode launched); and replays every compile from
   the store in a child process, which must run no pipeline stage;
15. the sweep coordinator, ``compile_many(parallel=N)`` and the model
   examples on the card: ``python -m repro_torch.sweep`` over every paper
   layer x ``h100``, ``h100@HBM.depth=4096`` and ``dnnweaver@pe=32x32``
   with 4 workers into a fresh store, cold (each unit compiled exactly
   once by the sweep journal) and warm (every unit from the store, zero
   pipeline stages); phase 14's i8 compiles again in a child through
   ``compile_layer_gemms(..., parallel=4)``, whose cycles must equal
   phase 14's serial ones; the examples' attention kernels at the shapes
   their paths give them, in f32 (train_lm's 12 / 6 heads of 64 over 256,
   serve_lm's 4 / 2 heads of 16 with its window of 8 and without), held
   against their plain versions, and each example's model, kernel path
   against plain path (serve_lm's logits 1e-4; a train_lm step as phase
   13's); ``python -m repro_torch.examples.serve_lm``
   (exit 0, ``block total``, flash attention and flash decode launched)
   and ``python -m repro_torch.examples.train_lm --steps 30`` (exit 0,
   the loss falling, the LSE forward and the backward launched exactly
   ``train_attention_launches`` times); the examples' launches join the
   ``kernels`` line;
16. the sharded main path in a one-rank NCCL group, in a child under
   ``torchrun`` (``sharded_main``): ``launch.train --model-axis 1``,
   ``restore_sharded``, ``launch.serve`` and both collectives;
17. the roofline of the one-card steps (``roofline_steps``): phase 3's
   prefill and decode step (timed in phase 3, ``time_serve_steps``) and
   the train steps of phases 4, 8, 12 and 13, each counted on the CPU on
   meta tensors through the plain path, AdamW as its fused kernels move it
   (``launch.dryrun.count_step``), and
   set beside its measured ms: counted FLOPs and HBM bytes, model FLOPs,
   the H100 roofline and its bound, mfu, the roofline's share of the
   measured time and model FLOPs over counted FLOPs; every count positive,
   every mfu and share in (0, 1.05]; no kernel launch;
18. prints the count of ``device_ms`` windows taken again as the host
   fell behind and of profiler windows that lost records, and what they
   left (``launch.layers.DEVICE_WINDOWS``, ``PROFILER_WINDOWS``; one line
   for this process, one for the child of phases 9 to 13), a
   ``kernels`` JSON line (eight kernels, launches summed over every
   path)
   and, last, the ``ok`` JSON line; the per-case details go to
   ``chiprun_out/chip_smoke.json``.

Phases 9 to 13 run in a child process (``chip_smoke.py --late``,
``late_main``), which starts the profiler's clock skew from zero again:
it grows with a process's age, and each profiled window pauses longer
than it.  The child draws its checks' inputs on from the parent's
generator and hands it back, so every check sees the inputs it saw when
one process ran every phase.  Every phase raises on failure; there is
no CPU fallback.
"""
import contextlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import adamw as fused_adamw  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.examples import train_lm as train_lm_example  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd_lse, flash_attention_fwd_lse_plain,
    flash_attention_plain, flash_decode, flash_decode_plain)
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunk_local, ssd_chunk_local_plain, ssd_chunk_scan,
    ssd_chunk_scan_plain)
from repro_torch.kernels.tiling import (  # noqa: E402
    attention_blocks, attention_bwd_blocks, attention_bwd_mma_blocks,
    attention_mma_blocks, decode_block_kv, gemm_blocks, ssd_mma_blocks)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.dryrun import count_step  # noqa: E402
from repro_torch.launch.attn_probes import bf16_gate  # noqa: E402
from repro_torch.launch.layers import (  # noqa: E402
    DEVICE_WINDOWS, PROFILER_WINDOWS, compile_layer_gemms, device_ms,
    lm_layer_gemms, mean_ms, predicted_ms, profile_window)
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import global_norm, leaf_slices  # noqa: E402
from repro_torch.roofline import (PEAK_FLOPS, model_flops,  # noqa: E402
                                  roofline_terms)
from repro_torch.runtime import (make_loss_with_accum,  # noqa: E402
                                 make_train_step)
from repro_torch.targets import H100  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ARCH = "qwen3-0.6b"
BATCH, PROMPT, MAX_NEW, REQUESTS, MAX_LEN = 4, 512, 32, 8, 1024
SERVE_ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
              str(PROMPT), "--max-new", str(MAX_NEW), "--requests",
              str(REQUESTS), "--max-len", str(MAX_LEN), "--seed", "0",
              "--device", "cuda", "--attn", "kernel"]
OUT_DIR = ROOT / "chiprun_out"
# about 6 GB a checkpoint at full width: under build/, which .gitignore
# lists and which does not come back with chiprun_out/; removed at the end
CKPT_DIR = ROOT / "build" / "train_ckpt"
TRAIN_BATCH, TRAIN_SEQ, MICROBATCHES, TRAIN_STEPS = 8, 512, 2, 6
TRAIN_ARGS = ["--arch", ARCH, "--seq-len", str(TRAIN_SEQ), "--global-batch",
              str(TRAIN_BATCH), "--microbatches", str(MICROBATCHES),
              "--ckpt-every", "3", "--seed", "0", "--device", "cuda",
              "--attn", "kernel", "--ckpt-dir", str(CKPT_DIR)]
MB = TRAIN_BATCH // MICROBATCHES  # the rows one forward/backward sees
# mamba2-2.7b and zamba2-2.7b served at full width, the same traffic as
# qwen3-0.6b with 2048-token prompts: the cache holds prompt + 32 new tokens
SSM_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
SSM_PROMPT, SSM_MAX_LEN = 2048, 2080
SSD_CHUNK, SSD_HEADS, SSD_HEADDIM = 512, 80, 64   # both models' SSD
SSD_INPUT_ROUNDING = 3 * 2.0 ** -9   # see check_ssd
BF16_ULP = 2.0 ** -7                 # one bf16 ulp, relative, at most
SSD_REF_ATOL = 2e-3                  # tests/test_kernels.py SSD bound
U32 = 2.0 ** -24          # f32 unit roundoff
ATTN_BF16_ATOL = 2e-2     # tests/test_kernels.py bf16 attention bound
ATTN_F32_ATOL = 2e-3      # tests/test_kernels.py f32 attention bound
# relative L2 of a forward's or decode's output against its plain version,
# beside the absolute bounds, which at 1500 keys sit near half a typical
# output (std about sqrt(e / 1500) = 0.043).  bf16: the kernel rounds P to
# bf16 before P @ V and the output to bf16, the plain version only the
# output; each rounding moves a value by at most 2^-8 of itself, so two
# give at most 2^-7 = 7.8e-3.  A key of a padded block left unmasked takes
# about 1.4 % of a row's weight at 1500 keys (36 zero keys against 1500 of
# mean weight e^0.5), and moves the output by that (``planted_faults``).
# f32: the sums over up to 2080 keys in another order, about
# sqrt(2080) * 2^-24 = 2.7e-6; 1e-4 leaves a factor 37.  The backward's dq,
# dk and dv take the same bounds: in bf16 the kernel (P and dS in three
# bf16 parts, dV's sums compensated) and the plain version each round a
# near-exact f32 sum once to bf16, so where they differ it is by one ulp,
# at most 2^-7 of the value; in f32 they sum in another order, over up to
# 8 x 512 rows (paligemma's dk), sqrt(4096) * 2^-24 = 3.8e-6.  The same
# unmasked key edge moves dq, dk and dv by about 1.4 % too
# (``planted_bwd_fault``)
ATTN_REL_L2 = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
LSE_ATOL = 1e-3           # f32 log-sum-exp of the same inputs, values < 10
LOGITS_REL_L2 = 5e-2      # see compare_paths
LOSS_REL_F32 = 1e-4       # see compare_train_paths
GRAD_REL_L2_F32 = 1e-3
GRAD_REL_L2_BF16 = 5e-2
# the leaves whose gradients the attention kernels give directly
ATTN_LEAVES = {("attn", n) for n in ("wq", "wk", "wv", "q_norm", "k_norm")}
KERNELS = {
    "matmul": dict(route="cuda", source="src/repro_torch/csrc/matmul.cu",
                   replaces="src/repro/kernels/matmul.py:37"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:147"),
    "flash_attention_fwd_lse": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:310"),
    "flash_attention_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:261"),
    "ssd_chunk_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:63"),
    "adamw_sq_sums": dict(
        route="cuda", source="src/repro_torch/csrc/adamw.cu",
        replaces="src/repro/optim/adamw.py:18"),
    "adamw_update": dict(
        route="cuda", source="src/repro_torch/csrc/adamw.cu",
        replaces="src/repro/optim/adamw.py:77"),
}
KERNEL_FNS = (matmul, flash_attention, flash_decode, flash_attention_fwd_lse,
              flash_attention_bwd, ssd_chunk_scan, fused_adamw.sq_sums,
              fused_adamw.update)
# the fused AdamW norm against the eager one: f32 sums of the same squares
# in another order, each rounding at most 2^-24 of a partial sum; 1e-6
# leaves room for a few dozen roundings in a row (``check_adamw``)
ADAMW_NORM_RTOL = 1e-6
# the tensor-core instructions each redesigned source must hold: the bf16
# GEMM runs wgmma (HGMMA), the bf16 flash forward and backward and the SSD
# chunk scan mma.sync (HMMA)
TENSOR_CORE_OPS = {"matmul": ("HGMMA",), "flash_attention": ("HMMA", "HGMMA"),
                   "flash_attention_bwd": ("HMMA", "HGMMA"),
                   "ssd_scan": ("HMMA", "HGMMA")}
# the instantiations that must build without a register spill: the
# mma.sync kernels, whose fragments live in registers (every kernel of
# ssd_scan, the *_mma_kernel ones of the flash sources)
NO_SPILLS = {"flash_attention": "_mma_kernel", "flash_attention_bwd":
             "_mma_kernel", "ssd_scan": ""}


def spilling(log: str) -> list[str]:
    """The functions of a ptxas -v report that spill registers."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
        elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
            out.append(cur)
    return out
# the SSM train phase: a gate step at full width and reduced depth (mamba2:
# 4 layers; zamba2: 6 mamba layers and one use of the shared block), then
# each arch at full width and depth for 3 steps of 2 x 1024 tokens (two
# chunks of 512, so the inter-chunk carry takes part)
SSM_GATE_LAYERS = {"mamba2-2.7b": 4, "zamba2-2.7b": 6}
# the bf16 gradient gate of the SSM gate step, in units of the plain
# path's own spread (see compare_ssm_train_paths)
SSM_BF16_SPREAD = 3.0
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 1024, 3
# the other dense configs, served at full width with the SSM archs'
# traffic (2048-token prompts, cache 2080): gemma3-12b and stablelm-12b at
# full depth, command-r-plus-104b at 4 of its 64 layers (its bf16 weights
# take 208 GB; 4 layers and the tied embedding about 19 GB); the value is
# the layers served, 0 for all
DENSE_ARCHS = {"gemma3-12b": 0, "stablelm-12b": 0, "command-r-plus-104b": 4}
DENSE_PROMPT, DENSE_MAX_LEN = 2048, 2080
# the MoE family, served at full width and depth with the dense configs'
# traffic; the value is the depth of the f32 gate (see compare_moe): all
# 16 of olmoe's layers (about 27.7 GB in f32), 4 of deepseek's 28 (the
# dense one and 3 MoE layers, about 9 GB; all 28 take about 65 GB)
MOE_ARCHS = {"deepseek-moe-16b": 4, "olmoe-1b-7b": 0}
# the dispatch check's tokens: standard normal plus this multiple of one
# shared standard normal vector, which crowds a few experts past their
# capacity at capacity_factor 1.25 (independent tokens load every expert
# to about 80 % of it, and nothing is dropped)
MOE_COMMON = 0.1
MOE_DISPATCH_REL_L2 = 1e-4   # see check_moe_dispatch
ENCDEC_VLM_F32_REL_L2 = 1e-4  # see compare_encdec_vlm
# the encoder-decoder and VLM families at full width and depth: (batch,
# prompt, new tokens, cache, requests).  whisper-base: 8 30-second segments
# ((8, 1500, 512) frames), Whisper's 4 start tokens, 128 new, its 448-token
# decoder context, 16 requests; paligemma-3b: 4 224-px images ((4, 256,
# 1152) patches), 32-token prompts, 32 new, a cache of 256 + 32 + 32, 8
# requests
ENCDEC_VLM = {"whisper-base": (8, 4, 128, 448, 16),
              "paligemma-3b": (4, 32, 32, 320, 8)}
COMPARE_STEPS = 8            # decode steps of compare_encdec_vlm
# phase 12, the encoder-decoder and VLM families trained at full width and
# depth: (batch, decoder tokens, depth of the gate step).  whisper-base:
# 8 30-second segments ((8, 1500, 512) frames) x 448 decoder tokens,
# Whisper's whole decoder context, as fine-tuning feeds it; paligemma-3b:
# 4 224-px images ((4, 256, 1152) patches) x 256 text tokens, captioning
# and VQA fine-tuning (its 1.9 B parameters with AdamW's f32 moments take
# about 30 GB); the gate step at 2 encoder and 2 decoder layers (whisper)
# and 2 layers (paligemma)
ENCDEC_VLM_TRAIN = {"whisper-base": (8, 448, 2), "paligemma-3b": (4, 256, 2)}
ENCDEC_VLM_TRAIN_STEPS = 3
# phase 13, the MoE family and the other dense configs trained at full
# width and reduced depth, in this order, each freed before the next:
# (launch.train's depth, batch, tokens a row; the gate step's depth,
# batch, tokens a row).  AdamW keeps bf16 params and grads and two f32
# moments, 12 bytes a parameter: the depths keep that at 41-57 GB
# (olmoe 8 of 16 layers, 3.56 B parameters; deepseek its dense layer and
# 5 MoE layers of 28, 3.44 B; stablelm 10 of 40, 3.81 B; gemma3 two
# periods of 5 local and 1 global of 48, 3.70 B; command-r 1 of 64 beside
# its 3.15 B tied embedding, 4.72 B).  2 x 2048 tokens are 2k-token
# fine-tuning sequences: olmoe's experts take 640 slots, deepseek's 480,
# and gemma3's window of 1024 bites; command-r takes one sequence, whose
# 2048 x 256000 logits and their gradient must fit beside 56.6 GB.  The
# gate steps run in f32 (4 bytes a parameter and a gradient, twice): 2
# layers (deepseek: its dense one and one MoE layer), gemma3 one period of
# 6 at 1 x 2048 so the window bites, command-r 1 layer at 1 x 1024
TRAIN_CONFIGS = {"olmoe-1b-7b": (8, 2, 2048, 2, 2, 2048),
                 "deepseek-moe-16b": (6, 2, 2048, 2, 2, 2048),
                 "stablelm-12b": (10, 2, 2048, 2, 2, 2048),
                 "gemma3-12b": (12, 2, 2048, 6, 1, 2048),
                 "command-r-plus-104b": (1, 1, 2048, 1, 1, 1024)}
TRAIN_CONFIG_STEPS = 3
TRAIN_PEAK_GIB = 70.0   # the most device memory a phase-13 run may take
# phase 14, the Covenant compiler on the card: each config's block GEMMs
# at full width, compiled against ``h100`` at the decode batch of its serve
# phase and the tokens a step of its train phase (the rows its layer
# reports take), timed through ``covenant_matmul`` in bf16 beside the
# covenant's prediction; then ``launch.serve`` against other covenants,
# and the compiles replayed from a disk store in a child process
COVENANT_TOKENS = {
    ARCH: (BATCH, TRAIN_BATCH * TRAIN_SEQ),
    **{a: (BATCH, SSM_TRAIN_BATCH * SSM_TRAIN_SEQ) for a in SSM_ARCHS},
    **{a: (BATCH, TRAIN_CONFIGS[a][1] * TRAIN_CONFIGS[a][2])
       for a in (*DENSE_ARCHS, *MOE_ARCHS)},
    **{a: (ENCDEC_VLM[a][0],
           ENCDEC_VLM_TRAIN[a][0] * ENCDEC_VLM_TRAIN[a][1])
       for a in ENCDEC_VLM},
}
COVENANT_CLI = (["--accel-target", "hvx", "--accel-search"],
                ["--accel-target", "dnnweaver@pe=32x32"])
COVENANT_STORE = ROOT / "build" / "covenant_store"
# the child that replays phase 14's compiles from the store: argv[1] is
# the JSON list of (arch, tokens); prints, for every artifact in order,
# its cycles and the pipeline stages it ran, and the driver's counts
COVENANT_REPLAY = '''
import json, sys
import repro_torch
from repro_torch import configs
from repro_torch.launch.layers import compile_layer_gemms
arts = []
for arch, tokens in json.loads(sys.argv[1]):
    for g, art in compile_layer_gemms(configs.get_config(arch), tokens):
        arts += [art, repro_torch.compile(g.build("bf16", "f32"), "h100")]
print(json.dumps({"cycles": [a.cycles() for a in arts],
                  "executed": [a.ctx.executed for a in arts],
                  "stats": repro_torch.cache_stats()}))
'''

# phase 15, the sweep coordinator, ``compile_many(parallel=N)`` and the
# model examples on the card: ``python -m repro_torch.sweep`` over every
# paper layer against these targets with 4 workers, cold and then warm
# (``h100@HBM.depth=4096`` is the variant that streams run on); phase 14's
# i8 compiles again through ``compile_layer_gemms(parallel=4)``; then
# ``examples.serve_lm`` and ``examples.train_lm`` for 30 steps
SWEEP_TARGETS = "h100,h100@HBM.depth=4096,dnnweaver@pe=32x32"
SWEEP_WORKERS = 4
SWEEP_STORE = ROOT / "build" / "sweep_store"
PARALLEL_STORE = ROOT / "build" / "parallel_store"
TRAIN_LM_STEPS = 30
TRAIN_LM_CKPT = ROOT / "build" / "train_lm_ckpt"
# phase 17, the roofline of the one-card steps: the prefills and decode
# steps ``time_serve_steps`` times of phase 3's served run, median of this
# many; an mfu or a roofline share above ROOFLINE_MAX means the count or
# the time is wrong
SERVE_TIMED = 8
ROOFLINE_MAX = 1.05
# phases 9 to 13 run in a child (``late_main``), which writes its results
# here, within LATE_TIMEOUT seconds
LATE_OUT = ROOT / "build" / "late_phases.json"
LATE_TIMEOUT = 900
# examples.serve_lm's shapes: its --batch and --max-new, and the
# --prompt-len and --max-len of launch.serve's defaults, which it keeps;
# its decode reads the global layers' cache of SERVE_LM_MAX_LEN at
# SERVE_LM_PROMPT + 1 to SERVE_LM_PROMPT + SERVE_LM_NEW - 1 rows, the
# local layers' rolling cache of the window full
SERVE_LM_BATCH, SERVE_LM_NEW = 4, 16
SERVE_LM_PROMPT, SERVE_LM_MAX_LEN = 16, 96
# the examples' models in f32, kernel path against plain path: the two
# differ only in the order of f32 sums inside attention, about
# sqrt(S) * 2^-24 relative an attention output (S <= 256 keys: 9.5e-7)
# over 6 and 10 layers, a few 1e-6; the logits' relative L2 <= 1e-4
# leaves an order and more, as ENCDEC_VLM_F32_REL_L2
EXAMPLE_F32_REL_L2 = 1e-4
# the child that compiles phase 14's i8 GEMMs with parallel=4 into a fresh
# store: argv[1] is the JSON list of (arch, tokens), argv[2] the store;
# prints every artifact's cycles and the pipeline stages it ran in this
# process, and the driver's counts
PARALLEL_COMPILE = '''
import json, sys
import repro_torch
from repro_torch import configs
from repro_torch.launch.layers import compile_layer_gemms
opts = repro_torch.CompileOptions(store=sys.argv[2])
arts = [art for arch, tokens in json.loads(sys.argv[1])
        for _, art in compile_layer_gemms(configs.get_config(arch), tokens,
                                          options=opts, parallel=4)]
print(json.dumps({"cycles": [a.cycles() for a in arts],
                  "executed": [a.ctx.executed for a in arts],
                  "stats": repro_torch.cache_stats()}))
'''


def bound(ops_count: float, peak: float, nbytes: float) -> tuple[float, str]:
    """(least ms, what bounds it): operations over the peak rate against
    bytes moved once over the HBM rate."""
    t_ops = ops_count / peak * 1e3
    t_bytes = nbytes / H100["hbm_bw"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bit_equal(run) -> bool:
    """Two calls of ``run`` give bit-equal tensors (a tensor or a tuple)."""
    a, b = run(), run()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


class Record:
    """Every checked case; ``main_path`` marks the shapes the served run
    gives a kernel, which the ``kernels`` line sums over."""

    def __init__(self):
        self.cases = []

    def add(self, name, case, *, err, ok, tol, ms, plain_ms, bound_ms,
            bound_by, library_ms, main_path, device_ms=None,
            library_device_ms=None, rel_l2=None, rel_tol=None):
        self.cases.append(dict(kernel=name, case=case, max_abs_err=err,
                               tol=tol, rel_l2=rel_l2, rel_tol=rel_tol,
                               ok=bool(ok), ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms, main_path=main_path,
                               device_ms=device_ms,
                               library_device_ms=library_device_ms))
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        dev = "" if device_ms is None else (
            f" device_ms={device_ms:.4f} library_device_ms="
            + ("null" if library_device_ms is None
               else f"{library_device_ms:.4f}"))
        rel = "" if rel_l2 is None else (
            f" rel_l2={rel_l2:.3e} (tol {rel_tol:.3e})")
        print(f"[check] {name:15s} {case:44s} max_abs_err={err:.3e} "
              f"(tol {tol}){rel} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib}{dev} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {case}: max_abs_err {err}, "
                                 f"tolerance {tol}; rel_l2 {rel_l2}, "
                                 f"tolerance {rel_tol}")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in f32."""
    d = got.float() - want.float()
    return float(d.norm() / want.float().norm())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_gemm(rec: Record, dev, gen, m: int, n: int, k: int,
               dtype: torch.dtype, label: str, main_path: bool) -> None:
    if dtype == torch.int8:
        a = torch.randint(-8, 8, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    got = ops.covenant_matmul(a, b)
    want = matmul_plain(a, b)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    if dtype == torch.int8:
        ok, tol = err == 0, "exact"
    else:
        # products of the inputs are exact or rounded once in f32, and the
        # two sums differ only in order: each is within K u sum|a_i b_i| of
        # the exact sum (u = 2^-24), so they differ by at most twice that
        bound_e = 2 * (k + 1) * U32 * (a.abs().float() @ b.abs().float())
        ok, tol = bool((diff <= bound_e).all()), "2(K+1)u|A||B| elementwise"
        del bound_e
    del got, want, diff
    iters = 3 if m * n * k > 1e11 else 10
    run = lambda: ops.covenant_matmul(a, b)  # noqa: E731
    ms = mean_ms(run, dev, iters)
    plain_ms = mean_ms(lambda: matmul_plain(a, b), dev, iters)
    library_ms = None if dtype == torch.int8 else \
        mean_ms(lambda: torch.matmul(a, b), dev, iters)
    dev_ms = device_ms(run) if main_path else None
    library_dev_ms = device_ms(lambda: torch.matmul(a, b)) \
        if main_path else None
    in_dt = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.int8: "i8"}[dtype]
    peak = {"bf16": H100["peak_bf16_flops"], "f32": H100["peak_f32_flops"],
            "i8": H100["peak_i8_ops"]}[in_dt]
    b_ms, b_by = bound(2.0 * m * n * k, peak,
                       (m * k + k * n) * a.element_size() + m * n * 4)
    blocks = "x".join(map(str, gemm_blocks(m, n, k, in_dtype=in_dt,
                                           wgmma=in_dt == "bf16")))
    rec.add("matmul", f"{label} {m}x{n}x{k} {in_dt} b{blocks}", err=err,
            ok=ok, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms, main_path=main_path,
            device_ms=dev_ms, library_device_ms=library_dev_ms)


def check_attention(rec: Record, dev, gen, b=BATCH, hq=16, hkv=8, s=PROMPT,
                    d=128, *, window: int | None = None,
                    dtype: torch.dtype = torch.bfloat16,
                    main_path: bool = True, causal: bool = True,
                    sq: int | None = None) -> None:
    """``ops.covenant_attention`` (the prefill's causal forward, with the
    model's sliding ``window`` or none; or, with ``causal=False``, an
    encoder's or a cross attention's, ``sq`` queries against ``s`` keys)
    against its plain version, with CUDA-event and device times beside
    SDPA's (``enable_gqa``; a window goes to it as a boolean mask)."""
    sq = s if sq is None else sq
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    qf, kf, vf = (q.reshape(b * hq, sq, d), k.reshape(b * hkv, s, d),
                  v.reshape(b * hkv, s, d))
    run = lambda: ops.covenant_attention(  # noqa: E731
        q, k, v, causal=causal, window=window)
    got = run()
    want = flash_attention_plain(qf, kf, vf, causal=causal,
                                 window=window).reshape(q.shape)
    err, within = attn_atol(got, want, lambda: flash_attention_plain(
        qf.float(), kf.float(), vf.float(), causal=causal,
        window=window).reshape(q.shape))
    rel = rel_l2(got, want)
    del got, want
    same = bit_equal(run)
    ms = mean_ms(run, dev, 10)
    dev_ms = device_ms(run)
    plain_ms = mean_ms(lambda: flash_attention_plain(
        qf, kf, vf, causal=causal, window=window), dev, 10)
    mask = None
    if window is not None:
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    library_ms = mean_ms(sdpa, dev, 10)
    library_dev_ms = device_ms(sdpa)
    del mask
    pairs = _pairs(b, hq, s, causal, window, sq)  # visible (q, k) pairs
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * s * d) * q.element_size()
    bf16 = dtype == torch.bfloat16
    b_ms, b_by = bound(4.0 * pairs * d, H100["peak_bf16_flops"] if bf16
                       else H100["peak_f32_flops"], nbytes)
    bq, bkv = (attention_mma_blocks if bf16 else attention_blocks)(
        sq, s, d, heads=b * hq)
    seqs = f"S{s}" if sq == s else f"Sq{sq} Sk{s}"
    mode = f"causal w{window or 0}" if causal else "noncausal"
    rec.add("flash_attention",
            f"B{b} Hq{hq} Hkv{hkv} {seqs} D{d} {mode} "
            f"{'bf16' if bf16 else 'f32'} b{bq}x{bkv} "
            f"{'bit-equal' if same else 'NOT bit-equal'}", err=err,
            ok=within and rel <= ATTN_REL_L2[dtype] and same,
            tol=ATTN_BF16_ATOL if bf16 else ATTN_F32_ATOL, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=main_path, device_ms=dev_ms,
            library_device_ms=library_dev_ms, rel_l2=rel,
            rel_tol=ATTN_REL_L2[dtype])


def check_decode(rec: Record, dev, gen, b=BATCH, hq=16, hkv=8, s=MAX_LEN,
                 d=128, lens=(1, 300, 777, 1024), *,
                 dtype: torch.dtype = torch.bfloat16,
                 main_path: bool = True) -> None:
    g = hq // hkv
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
    bkv = decode_block_kv(b * hkv, s, d, g)
    run = lambda: ops.covenant_decode_attention(  # noqa: E731
        q, k, v, kv_len, block_kv=bkv)
    got = run()
    qg, kf, vf = (q.reshape(b * hkv, g, d), k.reshape(b * hkv, s, d),
                  v.reshape(b * hkv, s, d))
    want = flash_decode_plain(qg, kf, vf, kv_len,
                              kv_heads=hkv).reshape(b, hq, d)
    err, within = attn_atol(got, want, lambda: flash_decode_plain(
        qg.float(), kf.float(), vf.float(), kv_len,
        kv_heads=hkv).reshape(b, hq, d))
    rel = rel_l2(got, want)
    same = bit_equal(run)
    ms = mean_ms(run, dev, 50)
    dev_ms = device_ms(run)
    plain_ms = mean_ms(lambda: flash_decode_plain(qg, kf, vf, kv_len,
                                                  kv_heads=hkv), dev, 50)
    mask = (torch.arange(s, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k, v, attn_mask=mask, enable_gqa=True)
    library_ms = mean_ms(sdpa, dev, 50)
    library_dev_ms = device_ms(sdpa)
    valid = float(kv_len.sum()) * hkv            # cache rows this data reads
    nbytes = (2 * valid * d + 2 * b * hq * d) * q.element_size() + b * 4
    bf16 = dtype == torch.bfloat16
    b_ms, b_by = bound(4.0 * valid * g * d, H100["peak_bf16_flops"] if bf16
                       else H100["peak_f32_flops"], nbytes)
    tol = ATTN_BF16_ATOL if bf16 else ATTN_F32_ATOL
    rec.add("flash_decode",
            f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} {'bf16' if bf16 else 'f32'} "
            f"ragged split{bkv} {'bit-equal' if same else 'NOT bit-equal'}",
            err=err, ok=within and rel <= ATTN_REL_L2[dtype] and same,
            tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=main_path, device_ms=dev_ms,
            library_device_ms=library_dev_ms, rel_l2=rel,
            rel_tol=ATTN_REL_L2[dtype])


def attn_atol(got, want, want_f32) -> tuple[float, bool]:
    """(largest error, within the atol gate) of an attention output (or a
    list: dq, dk, dv) against its plain version.  f32: |got - want| at
    most ``ATTN_F32_ATOL``.  bf16: held against the plain version computed
    in f32 on the same bf16 inputs (``want_f32()``), each element within
    max(``ATTN_BF16_ATOL``, one bf16 ulp of the f32 value)
    (``attn_probes.bf16_gate``): 2e-2 below magnitude 4, one ulp (2^-5)
    from 4 to 8, where 2e-2 is under the output's resolution."""
    torch.cuda.synchronize()
    many = not isinstance(got, torch.Tensor)
    gl, wl = (list(got), list(want)) if many else ([got], [want])
    if gl[0].dtype == torch.bfloat16:
        return bf16_gate(gl, list(want_f32()) if many else [want_f32()],
                         ATTN_BF16_ATOL)
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(gl, wl))
    return err, err <= ATTN_F32_ATOL


def _bwd_plain_f32(q, k, v, do, **kw):
    """The plain backward in f32 on the same inputs, after the plain LSE
    forward in f32."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    out, lse = flash_attention_fwd_lse_plain(q, k, v, **kw)
    return flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)


def planted_faults(dev, gen, b, hq, hkv, d, sk, sq) -> dict:
    """The bf16 gates of ``check_attention`` and ``check_decode`` against
    the fault they must catch at a ragged key edge, planted on the
    caller's side: keys and values padded with zeros to the next multiple
    of 64 and left unmasked, as the forward reads its last block's tail
    (loaded as zeros) if it drops its ``kpos < Sk`` term, and as a decode
    reads its last split if it reads past ``kv_len``.  Each faulty output
    is held against the plain version on the unpadded inputs; raises
    unless ``ATTN_REL_L2`` rejects it.  Returns the readings, beside
    whether ``ATTN_BF16_ATOL`` alone would have."""
    pad, dtype = -sk % 64, torch.bfloat16
    tol, rel_tol = ATTN_BF16_ATOL, ATTN_REL_L2[dtype]
    k = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dtype)
    kp, vp = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    kf, vf = k.reshape(b * hkv, sk, d), v.reshape(b * hkv, sk, d)
    out = {}
    for name, nq in (("forward encoder", sk), ("forward cross", sq),
                     ("decode cross", None)):
        if nq is None:
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
            full = torch.full((b,), sk + pad, device=dev, dtype=torch.int32)
            got = ops.covenant_decode_attention(
                q, kp, vp, full,
                block_kv=decode_block_kv(b * hkv, sk + pad, d, hq // hkv))
            def plain(dt, q=q):
                return flash_decode_plain(
                    q.reshape(b * hkv, hq // hkv, d).to(dt), kf.to(dt),
                    vf.to(dt), torch.full((b,), sk, device=dev,
                                          dtype=torch.int32),
                    kv_heads=hkv).reshape(q.shape)
        else:
            q = torch.randn((b, hq, nq, d), generator=gen,
                            device=dev).to(dtype)
            got = ops.covenant_attention(q, kp, vp, causal=False)

            def plain(dt, q=q, nq=nq):
                return flash_attention_plain(
                    q.reshape(b * hq, nq, d).to(dt), kf.to(dt), vf.to(dt),
                    causal=False).reshape(q.shape)
        want = plain(dtype)
        err, within = attn_atol(got, want, lambda: plain(torch.float32))
        rel = rel_l2(got, want)
        out[name] = dict(max_abs_err=err, rel_l2=rel, atol_caught=not within,
                         rel_caught=rel > rel_tol)
        print(f"[fault] {name} B{b} Hq{hq} Hkv{hkv} Sk{sk} D{d} bf16, keys "
              f"padded with zeros to {sk + pad} and unmasked: max_abs_err="
              f"{err:.3e} (tol max({tol}, 1 ulp): "
              f"{'passes' if within else 'caught'})"
              f" rel_l2={rel:.3e} (tol {rel_tol:.3e}: "
              f"{'caught' if rel > rel_tol else 'passes'})", flush=True)
        if rel <= rel_tol:
            raise AssertionError(f"the bf16 gate passes a planted fault: "
                                 f"{name} rel_l2 {rel} <= {rel_tol}")
    return out


def _train_qkv(dev, gen, b, hq, hkv, s, d, dtype, sq=None):
    """q, k, v, dout of a training attention: ``sq`` query rows (``s``
    unless given) against ``s`` keys."""
    sq = s if sq is None else sq
    shapes = ((b * hq, sq, d), (b * hkv, s, d), (b * hkv, s, d),
              (b * hq, sq, d))
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for sh in shapes]


def _pairs(b, hq, s, causal, window, sq=None) -> float:
    """Visible (q, k) pairs of a (B*Hq, Sq, S) attention, q row 0 at kv
    position S - Sq (Sq = S: self attention)."""
    sq = s if sq is None else sq
    i = np.arange(sq)[:, None] + (s - sq)
    j = np.arange(s)[None, :]
    mask = np.ones((sq, s), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    return float(b * hq * mask.sum())


def check_fwd_lse(rec: Record, dev, gen, b, hq, hkv, s, d, dtype, *,
                  window, main_path, causal: bool = True,
                  sq: int | None = None) -> None:
    """The LSE forward (training's) against its plain version: causal with
    the model's ``window`` or none, or with ``causal=False`` an encoder's or
    a cross attention's, ``sq`` queries against ``s`` keys (q row 0 at kv
    position s - sq, as ``FlashAttention`` hands it); device times and
    aten's flash forward (which also returns the logsumexp; with a window,
    ``aten_flash_window``; in f32 without a window, its memory-efficient
    forward) on the main path's shapes."""
    sq = s if sq is None else sq
    q, k, v, _ = _train_qkv(dev, gen, b, hq, hkv, s, d, dtype, sq)
    pick = attention_mma_blocks if dtype == torch.bfloat16 \
        else attention_blocks
    bq, bkv = pick(sq, s, d, heads=b * hq)
    if dtype != torch.bfloat16:
        bq = min(bq, sq)
    kw = dict(causal=causal, window=window)
    run = lambda: flash_attention_fwd_lse(  # noqa: E731
        q, k, v, block_q=bq, block_kv=bkv, **kw)
    out, lse = run()
    want, want_lse = flash_attention_fwd_lse_plain(q, k, v, **kw)
    err, within = attn_atol(out, want, lambda: flash_attention_fwd_lse_plain(
        q.float(), k.float(), v.float(), **kw)[0])
    torch.cuda.synchronize()
    rel = rel_l2(out, want)
    lse_err = float((lse - want_lse).abs().max())
    tol = ATTN_BF16_ATOL if dtype == torch.bfloat16 else ATTN_F32_ATOL
    del out, lse, want, want_lse
    same = bit_equal(run)
    ms = mean_ms(run, dev, 10)
    dev_ms = device_ms(run) if main_path else None
    plain_ms = mean_ms(lambda: flash_attention_fwd_lse_plain(
        q, k, v, **kw), dev, 10)
    library_ms = library_dev_ms = None
    if dtype == torch.bfloat16:
        # aten's flash forward, which also returns the logsumexp; it takes
        # equal head counts, so k and v are repeated before the timing
        q4, k4, v4 = _library_qkv(q, k, v, b, hq, hkv, s, sq, d)
        lib = (lambda: aten_flash_window(q4, k4, v4, window)) if window \
            else (lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, causal))
        library_ms = mean_ms(lib, dev, 10)
        library_dev_ms = device_ms(lib) if main_path else None
    elif main_path and not window:
        # aten's memory-efficient forward, which takes f32 and also returns
        # the logsumexp; equal head counts, as above
        q4, k4, v4 = _library_qkv(q, k, v, b, hq, hkv, s, sq, d)
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        lib = lambda: eff(q4, k4, v4, None, True, 0.0, causal)  # noqa: E731
        library_ms = mean_ms(lib, dev, 10)
        library_dev_ms = device_ms(lib)
    pairs = _pairs(b, hq, s, causal, window, sq)
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * s * d) * q.element_size() \
        + b * hq * sq * 4
    peak = H100["peak_bf16_flops"] if dtype == torch.bfloat16 \
        else H100["peak_f32_flops"]
    b_ms, b_by = bound(4.0 * pairs * d, peak, nbytes)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    seqs = f"S{s}" if sq == s else f"Sq{sq} Sk{s}"
    mode = f"causal w{window or 0}" if causal else "noncausal"
    rec.add("flash_attention_fwd_lse",
            f"B{b} Hq{hq} Hkv{hkv} {seqs} D{d} {mode} {dt} "
            f"b{bq}x{bkv} (lse err {lse_err:.1e}) "
            f"{'bit-equal' if same else 'NOT bit-equal'}", err=err,
            ok=(within and rel <= ATTN_REL_L2[dtype]
                and lse_err <= LSE_ATOL and same), tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=main_path, device_ms=dev_ms,
            library_device_ms=library_dev_ms, rel_l2=rel,
            rel_tol=ATTN_REL_L2[dtype])


def _library_qkv(q, k, v, b, hq, hkv, s, sq, d):
    """q, k, v as (B, H, S, D) for aten's attention, which takes equal
    head counts: k and v repeated over each kv head's group."""
    return (q.reshape(b, hq, sq, d),
            k.reshape(b, hkv, s, d).repeat_interleave(hq // hkv, 1),
            v.reshape(b, hkv, s, d).repeat_interleave(hq // hkv, 1))


def aten_flash_window(q, k, v, window: int, do=None):
    """aten's flash attention with its own sliding window, the library
    yardstick of a windowed causal forward and backward: q, k, v (and
    ``do``) in (B, H, S, D), equal head counts -> (out in (B, S, H, D),
    the logsumexp in (B, H, S), and with ``do`` a callable that runs the
    backward on them, else None).  Key j is visible to row i where
    i - (window - 1) <= j <= i, the models' ``j > i - window``."""
    bshd = [t.transpose(1, 2) for t in (q, k, v)]
    sq, sk = q.shape[2], k.shape[2]
    win = dict(window_size_left=window - 1, window_size_right=0)
    out, lse, rng, unused, _ = torch.ops.aten._flash_attention_forward(
        *bshd, None, None, sq, sk, 0.0, True, False, **win)
    if do is None:
        return out, lse, None
    dob = do.transpose(1, 2)
    return out, lse, lambda: torch.ops.aten._flash_attention_backward(
        dob, *bshd, out, lse, None, None, sq, sk, 0.0, True, rng, unused,
        **win)


def check_bwd(rec: Record, dev, gen, b, hq, hkv, s, d, dtype, *, window,
              main_path, causal: bool = True, sq: int | None = None) -> None:
    """The backward against its plain version on the plain forward's
    residuals, with the model's mask: causal with ``window`` or none, or
    with ``causal=False`` an encoder's or a cross attention's, ``sq``
    queries against ``s`` keys, ``q_offset = s - sq`` as ``FlashAttention``
    hands it.  Gated at the attention atol and, on each of dq, dk and dv, at
    ``ATTN_REL_L2`` (see ``planted_bwd_fault``); bit-equal on two runs;
    device times and aten's flash backward (with a window,
    ``aten_flash_window``'s; in f32 without a window, its memory-efficient
    backward) on the main path's shapes."""
    sq = s if sq is None else sq
    q, k, v, do = _train_qkv(dev, gen, b, hq, hkv, s, d, dtype, sq)
    pick = attention_bwd_mma_blocks if dtype == torch.bfloat16 \
        else attention_bwd_blocks
    bq, bkv = pick(sq, s, d, heads=b * hq)
    kw = dict(causal=causal, window=window, q_offset=s - sq)
    out, lse = flash_attention_fwd_lse_plain(q, k, v, **kw)
    run = lambda: flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, block_q=bq, block_kv=bkv, **kw)
    got = run()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    err, within = attn_atol(got, want, lambda: _bwd_plain_f32(
        q, k, v, do, **kw))
    rel = max(rel_l2(a, w) for a, w in zip(got, want))
    tol = ATTN_BF16_ATOL if dtype == torch.bfloat16 else ATTN_F32_ATOL
    del got, want
    same = bit_equal(run)
    ms = mean_ms(run, dev, 10)
    dev_ms = device_ms(run) if main_path else None
    plain_ms = mean_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), dev, 5)
    library_ms = library_dev_ms = None
    if dtype == torch.bfloat16:
        # aten's flash backward on its own forward's residuals (k and v
        # repeated, so it returns per-q-head dk, dv without the group sum)
        q4, k4, v4 = _library_qkv(q, k, v, b, hq, hkv, s, sq, d)
        do4 = do.reshape(b, hq, sq, d)
        if window:
            lib = aten_flash_window(q4, k4, v4, window, do4)[2]
        else:
            fwd = torch.ops.aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, causal)
            o4, lse4, cq, ck, mq, mk, seed, offset = fwd[:8]
            aten_bwd = \
                torch.ops.aten._scaled_dot_product_flash_attention_backward
            lib = lambda: aten_bwd(  # noqa: E731
                do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, causal, seed,
                offset)
        library_ms = mean_ms(lib, dev, 10)
        library_dev_ms = device_ms(lib) if main_path else None
    elif main_path and not window:
        # aten's memory-efficient backward, which takes f32, on its own
        # forward's residuals (per-q-head dk, dv, as above)
        q4, k4, v4 = _library_qkv(q, k, v, b, hq, hkv, s, sq, d)
        do4 = do.reshape(b, hq, sq, d)
        aten = torch.ops.aten
        o4, lse4, seed, offset = \
            aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, causal)
        eff_bwd = aten._scaled_dot_product_efficient_attention_backward
        lib = lambda: eff_bwd(  # noqa: E731
            do4, q4, k4, v4, None, o4, lse4, seed, offset, 0.0,
            [True, True, True, False], causal)
        library_ms = mean_ms(lib, dev, 10)
        library_dev_ms = device_ms(lib)
    pairs = _pairs(b, hq, s, causal, window, sq)
    # read q, k, v, out, dout and lse once, write dq, dk, dv once; five
    # products (S, dP, dq, dk, dv) of 2 * pairs * D operations each
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * s * d) * q.element_size() \
        + b * hq * sq * 4
    peak = H100["peak_bf16_flops"] if dtype == torch.bfloat16 \
        else H100["peak_f32_flops"]
    b_ms, b_by = bound(10.0 * pairs * d, peak, nbytes)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    seqs = f"S{s}" if sq == s else f"Sq{sq} Sk{s}"
    mode = f"causal w{window or 0}" if causal else "noncausal"
    rec.add("flash_attention_bwd",
            f"B{b} Hq{hq} Hkv{hkv} {seqs} D{d} {mode} {dt} "
            f"b{bq}x{bkv} {'bit-equal' if same else 'NOT bit-equal'}",
            err=err, ok=within and rel <= ATTN_REL_L2[dtype] and same,
            tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=main_path, device_ms=dev_ms,
            library_device_ms=library_dev_ms, rel_l2=rel,
            rel_tol=ATTN_REL_L2[dtype])


def planted_bwd_fault(dev, gen, b, hq, hkv, d, sk, sq) -> dict:
    """The backward's bf16 gates against ``planted_faults``' ragged-edge
    fault, planted in a training attention: keys and values padded with
    zeros to the next multiple of 64 and left unmasked through the LSE
    forward and the backward, as the two kernels read their last block's
    tail (loaded as zeros) if both drop their ``kpos < Sk`` term, for the
    encoder (Sq = Sk) and the cross (``sq`` queries) shapes.  dq, and dk
    and dv of the real keys, are held against the plain forward and
    backward on the unpadded inputs.  (The backward alone reading the zero
    tail changes nothing: a zero key adds nothing to dq, and its dk, dv
    rows are not written.)  Raises unless ``ATTN_REL_L2`` rejects each;
    returns the readings, beside whether ``ATTN_BF16_ATOL`` alone would
    have."""
    pad, dtype = -sk % 64, torch.bfloat16
    tol, rel_tol = ATTN_BF16_ATOL, ATTN_REL_L2[dtype]
    k = torch.randn((b * hkv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b * hkv, sk, d), generator=gen, device=dev).to(dtype)
    kp, vp = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    out = {}
    for name, nq in (("backward encoder", sk), ("backward cross", sq)):
        q = torch.randn((b * hq, nq, d), generator=gen, device=dev).to(dtype)
        do = torch.randn((b * hq, nq, d), generator=gen,
                         device=dev).to(dtype)
        bq, bkv = attention_mma_blocks(nq, sk + pad, d, heads=b * hq)
        o, lse = flash_attention_fwd_lse(q, kp, vp, causal=False, block_q=bq,
                                         block_kv=bkv)
        bq, bkv = attention_bwd_mma_blocks(nq, sk + pad, d, heads=b * hq)
        dq, dk, dv = flash_attention_bwd(q, kp, vp, o, lse, do, causal=False,
                                         block_q=bq, block_kv=bkv,
                                         q_offset=sk + pad - nq)
        got = (dq, dk[:, :sk], dv[:, :sk])
        wo, wlse = flash_attention_fwd_lse_plain(q, k, v, causal=False)
        want = flash_attention_bwd_plain(q, k, v, wo, wlse, do, causal=False,
                                         q_offset=sk - nq)
        err, within = attn_atol(got, want, lambda: _bwd_plain_f32(
            q, k, v, do, causal=False, q_offset=sk - nq))
        rel = max(rel_l2(a, w) for a, w in zip(got, want))
        out[name] = dict(max_abs_err=err, rel_l2=rel, atol_caught=not within,
                         rel_caught=rel > rel_tol)
        print(f"[fault] {name} B{b} Hq{hq} Hkv{hkv} Sq{nq} Sk{sk} D{d} bf16, "
              f"keys padded with zeros to {sk + pad} and unmasked in the LSE "
              f"forward and the backward: max_abs_err={err:.3e} (tol max("
              f"{tol}, 1 ulp): {'passes' if within else 'caught'}) "
              f"rel_l2={rel:.3e} (tol "
              f"{rel_tol:.3e}: {'caught' if rel > rel_tol else 'passes'})",
              flush=True)
        if rel <= rel_tol:
            raise AssertionError(f"the bf16 backward gate passes a planted "
                                 f"fault: {name} rel_l2 {rel} <= {rel_tol}")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path, then kernel path against plain path
# ---------------------------------------------------------------------------


def compare_paths(cfg, dev, prompt: int = PROMPT, max_len: int = MAX_LEN,
                  tol: float | None = LOGITS_REL_L2, batch: int = BATCH,
                  steps: int = 4) -> tuple[dict, dict, object, dict]:
    """Prefill last-token logits and the logits of ``steps`` decode steps
    fed the same tokens, kernel path against plain path, same weights;
    gated at relative L2 ``tol`` (None: printed only).  Returns (relative
    L2 by step, argmax agreement by step, the kernel-path model, the
    weights).

    Bounds, each stated before the run that first held it:
    * qwen3-0.6b in bf16, 5e-2: the two paths differ only inside
      attention, which both compute in f32 and round to bf16 at different
      points; each of the 28 layers adds a relative perturbation of about
      one bf16 rounding (2^-8) to the residual stream, and such independent
      perturbations grow like a random walk, sqrt(28) * 2^-8 ~= 2.1e-2.
    * mamba2-2.7b and zamba2-2.7b in f32, 5e-2 (see ``compare_ssm``).
    * gemma3-12b, stablelm-12b and command-r-plus-104b (4 layers) in bf16,
      5e-2, by qwen3's rule: sqrt(48) * 2^-8 ~= 2.7e-2, sqrt(40) * 2^-8
      ~= 2.5e-2 and sqrt(4) * 2^-8 ~= 7.8e-3; each model's plain path
      against itself with one weight moved one bf16 ulp is printed beside
      it (``compare_dense``).
    * deepseek-moe-16b (4 layers) and olmoe-1b-7b in f32, 5e-2, printed in
      bf16 at full depth (see ``compare_moe``).
    * whisper-base and paligemma-3b at full depth in f32, 1e-4, and in
      bf16, 5e-2, over 8 decode steps (see ``compare_encdec_vlm``)."""
    kmodel = get_model(cfg, device=dev, attn="kernel")
    pmodel = get_model(cfg, device=dev, attn="plain")
    params = kmodel.init_params(1)
    rel, agree = _compare(kmodel, pmodel, params, params, prompt, max_len,
                          f"{cfg.name} {cfg.compute_dtype}", tol, batch,
                          steps)
    return rel, agree, kmodel, params


def _compare(amodel, bmodel, aparams, bparams, prompt, max_len, label,
             tol, batch: int = BATCH, n_steps: int = 4
             ) -> tuple[dict, dict]:
    """Logits of ``amodel`` against ``bmodel`` at prefill and ``n_steps``
    decode steps fed ``bmodel``'s argmax, both given the same prompt (and
    stub frontend inputs, ``serve.extra_inputs``); relative L2 and argmax
    agreement by step, gated at ``tol`` unless it is None."""
    cfg = amodel.cfg
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (batch, prompt)),
                           device=amodel.device)
    inputs = {"tokens": toks,
              **serve.extra_inputs(amodel, batch, prompt, rng)}
    ac, bc = amodel.init_cache(batch, max_len), bmodel.init_cache(batch,
                                                                 max_len)
    al, ac = amodel.prefill(aparams, inputs, ac)
    bl, bc = bmodel.prefill(bparams, inputs, bc)
    del inputs
    steps = [(al, bl)]
    tok = bl.argmax(-1)
    for _ in range(n_steps):
        al, ac = amodel.decode_step(aparams, tok, ac)
        bl, bc = bmodel.decode_step(bparams, tok, bc)
        steps.append((al, bl))
        tok = bl.argmax(-1)
    del ac, bc
    out, agreed = {}, {}
    for i, (a, b) in enumerate(steps):
        rel = float((a - b).norm() / b.norm())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        name = "prefill" if i == 0 else f"decode{i}"
        print(f"[compare] {label} {name}: rel_l2={rel:.3e} (tol {tol}) "
              f"max_abs={float((a - b).abs().max()):.3e} "
              f"max|logit|={float(b.abs().max()):.3e} "
              f"argmax_agree={agree:.2f} finite={bool(torch.isfinite(a).all())}",
              flush=True)
        if not torch.isfinite(a).all() or a.shape != (batch, cfg.vocab):
            raise AssertionError(f"{label} {name}: logits not finite of "
                                 f"shape {(batch, cfg.vocab)}")
        if tol is not None and rel > tol:
            raise AssertionError(f"{label} {name}: rel_l2 {rel} > {tol}")
        out[name], agreed[name] = rel, agree
    return out, agreed


def compare_ssm(cfg, dev) -> tuple[dict, object, dict]:
    """mamba2-2.7b or zamba2-2.7b at full width, kernel path against plain
    path: gated in f32, printed in bf16 beside the bf16 model's own
    sensitivity.  Returns (the comparisons, the bf16 kernel-path model,
    its weights).

    Why f32.  Under a bf16 bound derived like qwen3's (one rounding of
    the SSD output per layer, sqrt(64) * 2^-8 ~= 3.1e-2), mamba2's
    prefill logits differed by 0.28.  The kernel path differs from the
    plain path there in one place: ``covenant_ssd`` returns y in bf16,
    ``ssd_chunked`` in f32.  In bf16 these random-weight models amplify
    any such change: it flips bf16 roundings downstream, in dt among
    them, whose sums over a chunk sit in Gamma's exponent.  So the bf16
    comparison cannot tell a kernel fault from rounding.  It is printed
    with the plain path's own spread: plain against plain with one
    weight of layer 0 (its first norm scale entry) moved by one bf16
    ulp.

    Bound in f32, 5e-2, the serve gate: both paths compute the SSD from
    the same f32 inputs in f32 and return f32, so they differ only in the
    order of f32 sums, at most about 5e-4 of the terms' absolute sum
    (``check_ssd`` at zamba2's f32 shape: 0.09 of its 3 * 2^-9 bound),
    with no bf16 rounding for a change to flip.  A wrong index, mask or
    state layout moves SSD outputs by their own size, and the logits by
    far more than 5e-2."""
    out = {}
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    rel, agree, model, params = compare_paths(f32, dev, SSM_PROMPT,
                                              SSM_MAX_LEN)
    out["float32"] = dict(rel_l2=rel, argmax_agree=agree)
    del model, params
    torch.cuda.empty_cache()
    rel, agree, model, params = compare_paths(cfg, dev, SSM_PROMPT,
                                              SSM_MAX_LEN, tol=None)
    out["bfloat16"] = dict(rel_l2=rel, argmax_agree=agree)
    pmodel = get_model(cfg, device=dev, attn="plain")
    moved = {**params, "layers": [
        {**params["layers"][0], "ln": {"scale": params["layers"][0]["ln"][
            "scale"].clone()}}] + params["layers"][1:]}
    moved["layers"][0]["ln"]["scale"][0] *= 1 + BF16_ULP
    rel, agree = _compare(pmodel, pmodel, moved, params, SSM_PROMPT,
                          SSM_MAX_LEN, f"{cfg.name} bf16 plain, one weight "
                          "moved one ulp,", None)
    out["bfloat16_plain_spread"] = dict(rel_l2=rel, argmax_agree=agree)
    del moved, pmodel
    return out, model, params


def _profile(fn, label: str) -> dict:
    """``fn()`` once under ``torch.profiler`` (``profile_window``, which
    takes a window again until it kept every record): wall ms, the summed
    device time of its kernels (one stream, so the time the card is busy)
    and the kernels that take most of it."""
    rows, wall_ms = profile_window(fn, label)
    busy = sum(r[1] for r in rows)
    print(f"[profile] {label} under the profiler: wall {wall_ms:.1f} ms, "
          f"device kernels {busy:.1f} ms, busy share {busy / wall_ms:.3f}",
          flush=True)
    for name, ms, calls in rows[:8]:
        print(f"[profile]   {ms:9.2f} ms {calls:6d}x  {name[:80]}", flush=True)
    return dict(wall_ms=wall_ms, device_ms=busy, busy_share=busy / wall_ms,
                top=[dict(kernel=n, ms=m, calls=c) for n, m, c in rows[:8]])


def profile_batch(model, params) -> dict:
    """One batch of the served run (kernel path) under the profiler."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, model.cfg.vocab, PROMPT) for _ in range(BATCH)]
    return _profile(lambda: serve.serve(model, params, prompts, batch=BATCH,
                                        max_new=MAX_NEW, max_len=MAX_LEN),
                    "one serve batch")


def time_serve_steps(model, params) -> dict:
    """Wall ms of the served run's two steps on the kernel path (its model
    and weights): one prefill of ``BATCH`` prompts of ``PROMPT`` tokens into
    a fresh cache of ``MAX_LEN``, and one decode step of ``BATCH`` rows
    against it, the card synchronised around each; the median of
    ``SERVE_TIMED`` prefills (after one warm-up) and of ``SERVE_TIMED``
    decode steps after each.  Phase 17 sets them beside their roofline."""
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(2, model.cfg.vocab, (BATCH, PROMPT)),
                           device=model.device)
    prefill, decode = [], []

    def timed(fn, out):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
        return res

    for i in range(SERVE_TIMED + 1):
        cache = model.init_cache(BATCH, MAX_LEN)
        logits, cache = timed(lambda: model.prefill(params, {"tokens": toks},
                                                    cache), prefill)
        tok = logits.argmax(-1)
        for _ in range(SERVE_TIMED if i else 1):
            logits, cache = timed(lambda: model.decode_step(params, tok,
                                                            cache), decode)
            tok = logits.argmax(-1)
    out = {"prefill": float(np.median(prefill[1:])),
           "decode": float(np.median(decode[1:]))}
    print(f"[serve] {model.cfg.name} kernel path: prefill {BATCH} x {PROMPT} "
          f"{out['prefill']:.2f} ms, decode step {BATCH} rows, cache "
          f"{MAX_LEN}: {out['decode']:.2f} ms (medians of {SERVE_TIMED})",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def compare_train_paths(cfg, dev) -> dict:
    """One full-width train step's loss and gradient (one microbatch,
    ``MB`` x ``TRAIN_SEQ``), kernel attention against plain attention, same
    weights and batch, in f32 and then in bf16.

    Bounds.  In f32 the two paths differ only in the order of f32 sums
    inside attention (the kernels' online softmax over kv blocks against
    einsum + softmax): a few units of f32 roundoff (2^-24) per attention
    output, carried through 28 layers forward and back.  A CPU run of the
    same comparison at full width and 4 layers gave a gradient relative L2
    of 1e-6; so |dloss| / |loss| <= 1e-4 and a relative L2 of the
    flattened gradient <= 1e-3 leave two to three orders of headroom for
    depth and order.  In bf16 both paths round attention's inputs and
    outputs to bf16 at different points, about one bf16 rounding (2^-8)
    per layer, forward and backward: as for the served logits
    (``compare_paths``), sqrt(28) * 2^-8 ~= 2.1e-2, under the serve gate's
    5e-2.  The softmax of the loss does not amplify it: with these random
    weights the logits have a standard deviation near 32, so its gradient
    is nearly one-hot and moves little with the logits (the same CPU run
    gave 8.5e-3 at 4 layers, 2.2e-2 scaled by sqrt(28 / 4)).

    The whole gradient's norm is mostly the tied embedding's (its share is
    printed), and a wrong dq or dk/dv moves the attention leaves first.
    So in f32 the largest relative L2 over the leaves that the kernels'
    gradients reach directly (``ATTN_LEAVES`` of every layer) is gated at
    the same 1e-3: each is a sum of f32 products over the 4 x 512 tokens,
    with the same roundoff argument and the same headroom.  In bf16 they
    are printed only: their rounding differences add up over the layers
    above a leaf, with no bound derived per leaf."""
    rng = np.random.default_rng(3)
    out = {}
    for dt, loss_tol, grad_tol in (("float32", LOSS_REL_F32, GRAD_REL_L2_F32),
                                   ("bfloat16", None, GRAD_REL_L2_BF16)):
        c = cfg.replace(param_dtype=dt, compute_dtype=dt)
        batch = SyntheticLM(vocab=c.vocab, seq_len=TRAIN_SEQ,
                            global_batch=MB, seed=int(rng.integers(1 << 30))
                            ).batch(0)
        res = {}
        params = get_model(c, device=dev).init_params(1)
        for attn in ("kernel", "plain"):
            model = get_model(c, device=dev, attn=attn)
            res[attn] = make_loss_with_accum(model.loss_fn, 1)(params, batch)
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        num = den = embed2 = 0.0
        attn_worst, attn_leaf = 0.0, None
        per_layer: dict = {}
        for (path, a), (_, b) in zip(tree_paths(gk), tree_paths(gp)):
            d2 = float((a.float() - b.float()).square().sum())
            n2 = float(b.float().square().sum())
            num, den = num + d2, den + n2
            leaf_rel = (d2 / max(n2, 1e-30)) ** 0.5
            if path[0] == "embed":
                embed2 += n2
            if path[0] == "layers" and path[2:] in ATTN_LEAVES \
                    and leaf_rel >= attn_worst:
                attn_worst, attn_leaf = leaf_rel, path
            group, leaf = ((f"layer {path[1]:02d}", path[2:])
                           if path[0] == "layers" else (path[0], path[1:]))
            per_layer.setdefault(group, []).append(
                f"{'.'.join(leaf)}={leaf_rel:.1e}")
        rel = (num / den) ** 0.5
        embed_share = (embed2 / den) ** 0.5
        for key, leaves in per_layer.items():
            print(f"[grad {dt}] {key}: {' '.join(leaves)}", flush=True)
        finite = all(torch.isfinite(g).all() for _, g in tree_paths(gk))
        leaf_tol = grad_tol if dt == "float32" else None
        print(f"[grad {dt}] loss kernel {float(lk):.6f} plain {float(lp):.6f}"
              f" rel {loss_rel:.3e} (tol {loss_tol}); gradient rel_l2 "
              f"{rel:.3e} (tol {grad_tol}); worst attention leaf "
              f"{'.'.join(map(str, attn_leaf))} rel_l2 {attn_worst:.3e} "
              f"(tol {leaf_tol}); embedding's share of the gradient norm "
              f"{embed_share:.3f}; finite {finite}", flush=True)
        if not finite or not np.isfinite(float(lk)):
            raise AssertionError(f"{dt}: kernel path gradient not finite")
        if loss_tol is not None and loss_rel > loss_tol:
            raise AssertionError(f"{dt}: loss rel {loss_rel} > {loss_tol}")
        if rel > grad_tol:
            raise AssertionError(f"{dt}: gradient rel_l2 {rel} > {grad_tol}")
        if leaf_tol is not None and attn_worst > leaf_tol:
            raise AssertionError(f"{dt}: {attn_leaf} rel_l2 {attn_worst} > "
                                 f"{leaf_tol}")
        out[dt] = dict(loss_kernel=float(lk), loss_plain=float(lp),
                       loss_rel=loss_rel, grad_rel_l2=rel,
                       attn_leaf_rel_l2=attn_worst,
                       attn_leaf=".".join(map(str, attn_leaf)),
                       embed_share=embed_share)
        del res, gk, gp, params
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _adamw_held(norm=None, eager: bool = False):
    """``optim.adamw`` with its global norm held at ``norm`` (where given)
    and, with ``eager``, every leaf sent to its eager path."""
    mod = importlib.import_module("repro_torch.optim.adamw")
    saved = mod.global_norm, mod._on_card
    if norm is not None:
        mod.global_norm = lambda tree: norm
    if eager:
        mod._on_card = lambda t: False
    try:
        yield
    finally:
        mod.global_norm, mod._on_card = saved


def check_adamw(rec: Record, dev, cfg) -> None:
    """The fused AdamW on the param tree of phase 4's main path (full-width
    ``cfg``, as ``launch.train`` makes it), with seeded random gradients
    in the params' dtypes and random moments: the fused norm within
    ``ADAMW_NORM_RTOL`` of the eager one, and with the norm held at the
    fused one a step bit-equal to the eager step (params and moments);
    each bit-equal on two runs.  Timed with CUDA events around a loop of
    host calls against the eager path, the update with its moments in
    place as ``launch.train`` runs it; the bounds are the bytes: the norm
    reads g, the update reads g, p, m and v and writes p, m and v."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    params = get_model(cfg, device=dev).init_params(0)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=dev, dtype=p.dtype), params)
    opt = adamw(1e-3)
    state = opt.init(params)
    for m, v in zip(tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        m.normal_(0.0, 1e-2, generator=gen)
        v.uniform_(0.0, 1e-4, generator=gen)
    n = sum(p.numel() for p in tree_leaves(params))
    g_bytes = sum(g.numel() * g.element_size() for g in tree_leaves(grads))
    p_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    hbm = H100["hbm_bw"] / 1e3   # bytes a ms
    case = f"{cfg.name} tree, {n / 1e9:.3f} B params"

    def norm():
        return global_norm(grads)
    got = norm()
    with _adamw_held(eager=True):
        want = norm()
        plain_ms = mean_ms(norm, dev, 5)
    err = abs(float(got) - float(want)) / float(want)
    rec.add("adamw_sq_sums", case, err=err,
            ok=err <= ADAMW_NORM_RTOL and bit_equal(norm),
            tol=ADAMW_NORM_RTOL, ms=mean_ms(norm, dev, 20),
            plain_ms=plain_ms, bound_ms=g_bytes / hbm, bound_by="bytes",
            library_ms=None, main_path=True)

    def step():
        new, st, _ = opt.update(grads, state, params)
        return (*tree_leaves(new), *tree_leaves(st["mu"]),
                *tree_leaves(st["nu"]))
    in_place = adamw(1e-3, inplace=True)
    with _adamw_held(norm=got):
        fused = step()
        equal = bit_equal(step)
        with _adamw_held(eager=True):
            eager = step()
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(fused, eager))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(fused, eager))
        del fused, eager
        # last: these move the moments in place
        ms = mean_ms(lambda: in_place.update(grads, state, params), dev, 10)
        with _adamw_held(eager=True):
            plain_ms = mean_ms(lambda: in_place.update(grads, state, params),
                               dev, 3)
    rec.add("adamw_update", case, err=diff, ok=same and equal, tol=0.0,
            ms=ms, plain_ms=plain_ms,
            bound_ms=(g_bytes + 2 * p_bytes + 16 * n) / hbm,
            bound_by="bytes", library_ms=None, main_path=True)
    del params, grads, state
    torch.cuda.empty_cache()


def profile_train_step(cfg, dev) -> dict:
    """One more train step of the main path's shape (kernel attention,
    AdamW with its moments in place as ``launch.train`` has them, 2
    microbatches of MB x TRAIN_SEQ) under the profiler, after one step
    outside it.  Only phases 3 and 4 profile: later phases' busy shares
    are PERF.md's from earlier runs, and each profiled window pauses for
    the profiler's clock skew."""
    model = get_model(cfg, device=dev, attn="kernel")
    params = model.init_params(0)
    opt = adamw(1e-3, inplace=True)
    state = opt.init(params)
    step = make_train_step(model.loss_fn, opt, microbatches=MICROBATCHES)
    data = _train_batch(model, TRAIN_BATCH, TRAIN_SEQ, 0)
    params, state, _ = step(params, state, data)
    prof = _profile(lambda: float(step(params, state, data)[2]["loss"]),
                    f"one {cfg.name} train step")
    del model, params, state
    torch.cuda.empty_cache()
    return prof


def _train_batch(model, batch: int, seq: int, seed: int) -> dict:
    """One ``SyntheticLM`` batch with the model's stub-frontend extras, as
    ``launch.train`` draws it."""
    return SyntheticLM(vocab=model.cfg.vocab, seq_len=seq,
                       global_batch=batch, seed=seed,
                       extras=model.extra_inputs).batch(0)


def train_main_path() -> tuple[dict, dict, dict]:
    """``launch.train`` for TRAIN_STEPS steps with the counters from 0,
    then the same run resumed to TRAIN_STEPS + 2.  Returns (the first
    run's stats, its launches, the resumed run's stats)."""
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for fn in KERNEL_FNS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = train.main(TRAIN_ARGS + ["--steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    launches = train.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rep = stats["report"]
    print(f"[train] launches on the main path: {launches}; peak device "
          f"memory {peak_gb:.1f} GiB", flush=True)
    for name in ("matmul", "flash_attention_fwd_lse", "flash_attention_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"train path never launched {name}")
    if rep.steps_run != TRAIN_STEPS or not all(np.isfinite(rep.losses)):
        raise AssertionError(f"train: {rep.steps_run} steps, losses "
                             f"{rep.losses}")
    print(f"[train] {stats['ms_per_step']:.1f} ms per step after the first, "
          f"{stats['tokens_per_s']:.0f} train tokens/s, losses "
          f"{[round(x, 4) for x in rep.losses]}", flush=True)
    resumed = train.main(TRAIN_ARGS + ["--steps", str(TRAIN_STEPS + 2),
                                       "--accel-target", "none"])
    rrep = resumed["report"]
    print(f"[train] resumed from {rrep.resumed_from}, ran {rrep.steps_run} "
          f"steps, losses {[round(x, 4) for x in rrep.losses]}", flush=True)
    if rrep.resumed_from != TRAIN_STEPS or rrep.steps_run != 2 \
            or not all(np.isfinite(rrep.losses)):
        raise AssertionError(f"resume: from {rrep.resumed_from}, "
                             f"{rrep.steps_run} steps")
    stats["peak_gib"] = peak_gb
    return stats, launches, resumed


def _grad_rel_l2(gk, gp) -> tuple[float, bool]:
    """Relative L2 of the flattened gradient ``gk`` against ``gp``, and
    whether every leaf of ``gk`` is finite; in f32 on ``gp``'s device, a
    slice of a leaf at a time (``leaf_slices``: command-r's tied embedding
    is one leaf of 3.1 B parameters, 12.6 GB in f32)."""
    num = den = 0.0
    finite = True
    for (_, a), (_, b) in zip(tree_paths(gk), tree_paths(gp)):
        for sa, sb in leaf_slices(a, b):
            sa = sa.to(sb.device)
            num += float((sa.float() - sb.float()).square().sum())
            den += float(sb.float().square().sum())
            finite = finite and bool(torch.isfinite(sa).all())
    return (num / den) ** 0.5, finite


def compare_ssm_train_paths(arch: str, dev) -> dict:
    """One train step of ``arch`` at full width and reduced depth
    (``SSM_GATE_LAYERS``), batch 2 x 1024 (two chunks), kernel path
    against plain path on the same weights and batch, in f32 and then in
    bf16.  The kernel path runs the SSD kernel forward and
    ``SsdChunkLocal``'s backward (the plain local stage recomputed under
    autograd), and for zamba2 ``FlashAttention`` at head dim 160; the plain
    path runs ``ssd_chunked`` and plain attention under autograd.

    Bounds, derived as ``compare_train_paths``'s, before the first run.  In
    f32 the paths differ in the SSD forward by the kernel's two bf16 parts
    of x, B and C, each term within about 2^-16 of f32 arithmetic
    (``launch.ssd_probes simulate``: rms 4.9e-5 absolute, 0.0046 of
    ``check_ssd``'s bound at zamba2's shape), and otherwise in the order of
    f32 sums (the backwards are f32 autograd through the same algebra, in
    chunk-local and in chunked form; zamba2's attention as in
    ``compare_train_paths``).  A relative change of 2^-16 ~= 1.5e-5 per SSD
    output, added by 4 to 7 blocks as a random walk and carried back,
    moves the loss by a few 1e-5 relative and the gradient by about 1e-4:
    |dloss| / |loss| <= 1e-4 and gradient relative L2 <= 1e-3 keep one
    order of headroom for the gradient, the loss gate less.  In bf16 the
    kernel path rounds each SSD output to bf16 (``covenant_ssd`` returns
    x's dtype, ``ssd_chunked`` f32 into the gated norm) and each scaled
    score once (at most 2^-8): about one bf16 rounding (2^-8) per block,
    forward and back, sqrt(2 x 4) x 2^-8 ~= 1.1e-2 for mamba2 and
    sqrt(2 x 7) x 2^-8 ~= 1.5e-2 for zamba2, under 5e-2; the loss is
    printed only, as in ``compare_train_paths``.  The kernel path must
    launch the SSD kernel (and for zamba2 the flash backward).

    The bf16 gate, corrected after the first run.  That run measured the
    f32 gates as derived (mamba2: loss 8.4e-8, gradient 1.0e-4) but a bf16
    gradient of 5.45e-2 for mamba2, past 5e-2.  The derivation above left
    out what ``compare_ssm`` found for serving: these random-weight bf16
    models amplify any change, through the bf16 roundings it flips (dt's
    among them, which a chunk's cumsum carries into Γ's exponent).  Measured
    on the same batch (``NVIDIA H100 80GB HBM3, 700.00 W``): the plain path
    against itself with one weight of layer 0 moved one bf16 ulp differs by
    5.0e-2 in mamba2's gradient and 0.10 in zamba2's; the kernel path with
    its SSD kernel swapped for the plain local stage (the reference's own
    bf16 rounding of the SSD output, ``covenant_ssd``) by 5.6e-2 and 0.11.
    So no bound under that spread can tell a fault from rounding, and the
    bf16 gradient is held to three times the plain path's own spread
    (``SSM_BF16_SPREAD``), measured here on the same weights and batch, and
    never below 5e-2: a wrong SSD or attention gradient moves the gradient
    by its own size, far above.  The spread is printed beside it."""
    cfg = configs.get_config(arch).replace(n_layers=SSM_GATE_LAYERS[arch])
    need = ["ssd_chunk_scan"] + (["flash_attention_bwd"]
                                 if cfg.family == "hybrid" else [])
    return compare_train_step(f"ssm-train {arch}", cfg, dev, SSM_TRAIN_BATCH,
                              SSM_TRAIN_SEQ, seed=4, moved=("layers", "ln"),
                              need=need)


def compare_train_step(tag: str, cfg, dev, batch_n: int, seq: int, *,
                       seed: int, moved: tuple[str, str], need: list,
                       front: set | None = None) -> dict:
    """One train step of ``cfg`` on a ``batch_n`` x ``seq`` ``SyntheticLM``
    batch (with the model's stub-frontend extras), kernel path against
    plain path on the same weights and batch, in f32 and then in bf16.
    f32: |dloss| / |loss| <= ``LOSS_REL_F32`` and gradient relative L2 <=
    ``GRAD_REL_L2_F32``, the ``front`` leaves (top-level keys) together
    too.  bf16: gradient relative L2 <= ``SSM_BF16_SPREAD`` times the
    plain path's own spread (the plain path against itself with entry 0
    of the norm scale ``moved`` = (stack, norm) of layer 0 moved one bf16
    ulp), never below ``GRAD_REL_L2_BF16``.  The kernel path must launch
    each kernel of ``need``.  For an MoE config, the (token, expert)
    assignments that differ between the paths' forwards in each MoE layer
    are printed beside each gate (and, in bf16, those between the plain
    path and its moved twin beside the spread).  The callers derive these
    bounds."""
    stack, norm = moved
    rng = np.random.default_rng(seed)
    out = {}
    for dt, loss_tol, grad_tol in (("float32", LOSS_REL_F32, GRAD_REL_L2_F32),
                                   ("bfloat16", None, GRAD_REL_L2_BF16)):
        c = cfg.replace(param_dtype=dt, compute_dtype=dt)
        model = get_model(c, device=dev)
        batch = _train_batch(model, batch_n, seq, int(rng.integers(1 << 30)))
        params = model.init_params(1)
        res, models = {}, {}
        for fn in KERNEL_FNS:
            fn.launches = 0
        for attn in ("kernel", "plain"):
            model = models[attn] = get_model(c, device=dev, attn=attn)
            loss, grads = make_loss_with_accum(model.loss_fn, 1)(params,
                                                                 batch)
            if attn == "kernel":
                launches = train.kernel_launches()
                # on the host while the plain path runs: command-r's f32
                # gradient takes 18.9 GB, and its tied embedding's backward
                # 12.6 GB buffers beside it
                grads = tree_map(lambda g: g.cpu(), grads)
            res[attn] = loss, grads
        del loss, grads
        routed = c.family == "moe"
        if routed:
            kept = {attn: _kept_by_layer(
                lambda m=m: m.loss_fn(params, batch), len(params["layers"]),
                f"{tag} {dt} {attn}") for attn, m in models.items()}
            flips = _differing(kept["kernel"], kept["plain"])
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        rel, finite = _grad_rel_l2(gk, gp)
        front_rel = None if front is None else _grad_rel_l2(
            {k: gk[k] for k in front}, {k: gp[k] for k in front})[0]
        spread = spread_flips = None
        if dt == "bfloat16":
            lp0 = params[stack][0]
            moved_p = {**params, stack: [
                {**lp0, norm: {**lp0[norm],
                               "scale": lp0[norm]["scale"].clone()}}]
                + params[stack][1:]}
            moved_p[stack][0][norm]["scale"][0] *= 1 + BF16_ULP
            _, gm = make_loss_with_accum(model.loss_fn, 1)(moved_p, batch)
            spread = _grad_rel_l2(gm, gp)[0]
            grad_tol = max(grad_tol, SSM_BF16_SPREAD * spread)
            if routed:
                spread_flips = _differing(_kept_by_layer(
                    lambda: model.loss_fn(moved_p, batch),
                    len(params["layers"]), f"{tag} {dt} moved"),
                    kept["plain"])
            del moved_p, gm
        front_tol = GRAD_REL_L2_F32 if dt == "float32" and front else None
        depth = f"{c.n_layers} layers" + (
            f" + {c.enc_layers} encoder" if c.family == "audio" else "")
        front_txt = "" if front is None else (
            f"; {'+'.join(sorted(front))} rel_l2 {front_rel:.3e} (tol "
            f"{front_tol})")
        if routed:
            front_txt += (f"; (token, expert) assignments that differ by MoE "
                          f"layer, kernel against plain {flips}, plain "
                          f"against its moved twin {spread_flips}")
        print(f"[{tag} {dt}] {depth}, {batch_n} x {seq}: loss kernel "
              f"{float(lk):.6f} plain {float(lp):.6f} rel {loss_rel:.3e} "
              f"(tol {loss_tol}); gradient rel_l2 {rel:.3e} (tol "
              f"{grad_tol:.3e}; plain path's own spread {spread})"
              f"{front_txt}; finite {finite}; launches {launches}",
              flush=True)
        if not finite or not np.isfinite(float(lk)):
            raise AssertionError(f"{tag} {dt}: kernel path not finite")
        if loss_tol is not None and loss_rel > loss_tol:
            raise AssertionError(f"{tag} {dt}: loss rel {loss_rel} > "
                                 f"{loss_tol}")
        if rel > grad_tol:
            raise AssertionError(f"{tag} {dt}: gradient rel_l2 {rel} > "
                                 f"{grad_tol}")
        if front_tol is not None and front_rel > front_tol:
            raise AssertionError(f"{tag} {dt}: {sorted(front)} rel_l2 "
                                 f"{front_rel} > {front_tol}")
        if any(launches[k] <= 0 for k in need):
            raise AssertionError(f"{tag} {dt}: kernel path launched "
                                 f"{launches}")
        out[dt] = dict(loss_kernel=float(lk), loss_plain=float(lp),
                       loss_rel=loss_rel, grad_rel_l2=rel, grad_tol=grad_tol,
                       frontend_rel_l2=front_rel, plain_spread=spread,
                       launches=launches)
        if routed:
            out[dt].update(routing_differs=flips,
                           plain_spread_routing_differs=spread_flips)
        del res, gk, gp, params, model, models
        torch.cuda.empty_cache()
    return out


def train_ssm_main_path(arch: str) -> dict:
    """``launch.train --arch arch`` at full width and depth with its
    defaults (kernel path, bf16) for ``SSM_TRAIN_STEPS`` steps of
    ``SSM_TRAIN_BATCH`` x ``SSM_TRAIN_SEQ``, the counters from 0, and no
    checkpoint: one would take tens of GB at 2.7B parameters with AdamW's
    f32 moments.  The SSD kernel must launch, and for zamba2 the LSE
    forward and the flash backward, and every loss must be finite."""
    required = {"matmul": None, "ssd_chunk_scan": None}
    if configs.get_config(arch).family == "hybrid":
        required.update(flash_attention_fwd_lse=None,
                        flash_attention_bwd=None)
    return train_full_depth(f"ssm-train {arch}", arch, SSM_TRAIN_BATCH,
                            SSM_TRAIN_SEQ, SSM_TRAIN_STEPS, required)


def train_full_depth(tag: str, arch: str, batch: int, seq: int, steps: int,
                     required: dict, n_layers: int = 0,
                     peak_gib: float | None = None) -> dict:
    """``launch.train --arch arch`` at full width and depth (or at
    ``--n-layers n_layers``) with its defaults (kernel path, bf16, the
    model's stub-frontend extras) for ``steps`` steps of ``batch`` x
    ``seq``, every counter from 0, no checkpoint.  Each kernel of
    ``required`` must launch exactly that many times (None: at least
    once), every loss must be finite, and the peak device memory must stay
    at or under ``peak_gib`` where one is given."""
    for fn in KERNEL_FNS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = train.main(["--arch", arch, "--seq-len", str(seq),
                        "--global-batch", str(batch), "--steps", str(steps),
                        "--seed", "0", "--device", "cuda", "--ckpt-dir",
                        str(CKPT_DIR), "--ckpt-every", "0", "--n-layers",
                        str(n_layers)])
    torch.cuda.synchronize()
    launches = train.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rep = stats["report"]
    print(f"[{tag}] {rep.steps_run} steps of {batch} x {seq} at full width "
          f"and {stats['n_layers']} layers, losses "
          f"{[round(x, 4) for x in rep.losses]}, step seconds "
          f"{[round(x, 4) for x in rep.step_seconds]}, "
          f"{stats['ms_per_step']:.1f} ms per step after the first; "
          f"launches {launches}, required {required} (None: at least "
          f"one); peak device memory {peak_gb:.2f} GiB (limit {peak_gib})",
          flush=True)
    for name, n in required.items():
        if (launches[name] <= 0) if n is None else (launches[name] != n):
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times, required {n}")
    if rep.steps_run != steps or not all(np.isfinite(rep.losses)):
        raise AssertionError(f"{tag}: {rep.steps_run} steps, losses "
                             f"{rep.losses}")
    if peak_gib is not None and peak_gb > peak_gib:
        raise AssertionError(f"{tag}: peak device memory {peak_gb:.2f} GiB "
                             f"> {peak_gib}")
    return dict(ms_per_step=stats["ms_per_step"],
                tokens_per_s=stats["tokens_per_s"], losses=rep.losses,
                step_seconds=rep.step_seconds, launches=launches,
                required=required, peak_gib=peak_gb,
                n_layers=stats["n_layers"])


# ---------------------------------------------------------------------------
# phase 5: the SSD chunk scan; phases 6 and 7: mamba2 and zamba2 served
# ---------------------------------------------------------------------------


def _ssd_inputs(dev, gen, bh, bg, s, n, dtype, heads=SSD_HEADS):
    """Head-batched SSD inputs as a prefill of mamba2-2.7b or zamba2-2.7b
    gives them to the kernel (``ops.covenant_ssd``): x (BH, S, P), B and C
    (BG, S, N) unit normals in ``dtype``; dt the softplus of a unit normal
    (the models' dt projection, dt_bias 0); A the models' -linspace(1, 16,
    H) for every head row, H = ``heads``."""
    x = torch.randn((bh, s, SSD_HEADDIM), generator=gen, device=dev)
    dt = F.softplus(torch.randn((bh, s), generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, heads, device=dev).repeat(bh // heads)
    B = torch.randn((bg, s, n), generator=gen, device=dev)
    C = torch.randn((bg, s, n), generator=gen, device=dev)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def _ssd_bound(x, B, n, chunk) -> tuple[float, str]:
    """The chunk-local function's least time: its products over the causal
    half of each chunk (C B^T and its product with dt * x, 2 (N + P)
    operations a visible pair) and the end state (2 L N P a chunk), against
    reading x, dt, A, B and C once and writing y_intra, the states and the
    decay sums once (f32).  The products count at the bf16 tensor cores'
    peak for both input dtypes: that is the fastest the card computes any
    of them, and a tensor-core kernel on f32 inputs (as bf16 parts) may beat
    the SIMT f32 peak, so that would be no bound.  The bytes term is the
    inputs' own width."""
    bh, s, p = x.shape
    nck = s // chunk
    cells = bh * nck
    ops_count = cells * (chunk * (chunk + 1) / 2 * 2 * (n + p)
                         + 2 * chunk * n * p)
    nbytes = (bh * s * p * x.element_size() + bh * s * 4 + bh * 4
              + 2 * B.numel() * B.element_size()
              + bh * s * p * 4 + cells * n * p * 4 + cells * 4)
    return bound(ops_count, H100["peak_bf16_flops"], nbytes)


def check_ssd(rec: Record, dev, gen, n: int, dtype: torch.dtype,
              label: str, batch: int = BATCH, seq: int = SSM_PROMPT) -> dict:
    """``ssd_chunk_scan`` at a served model's prefill shape (``batch`` x
    ``seq`` tokens, by default 4 x 2048, 80 heads of 64, one group, chunk
    512, state ``n``; the train path gives it 2 x 1024) against its plain
    version on the same inputs: the chunk-local outputs (y_intra, states,
    decay sums) of ``ssd_chunk_local`` and the whole function's y and final
    state.

    Bound, elementwise, stated before the first run: |kernel - plain| <=
    3 * 2^-9 * T, plus one bf16 ulp (2^-7 |plain|) on a bf16 y.  T is the
    same output computed from |x|, |B| and |C| (dt and Gamma are
    positive): the sum of the absolute values of the terms.  Both versions
    read the same inputs and compute in f32; they differ in the order of
    the f32 sums, in the products and in the cumsum of dt * A inside
    Gamma's exponent (near -3000 at a chunk's end with these A and dt,
    where an f32 rounding is 1.2e-4 absolute: a relative error of about
    1e-4 in the terms near the diagonal that carry y).  The bound is the
    effect of one bf16 rounding (2^-9) of each of x, B and C, ten times
    that; the inputs the models give come from bf16 activations, so
    nothing finer reaches them.  A wrong index or mask moves outputs by
    their own size, far above it.  The tensor-core kernel rounds each
    scaled score to bf16 once, at most 2^-8 of its term, two thirds of the
    bound whatever the signs (``launch.ssd_probes simulate``: 0.65 at
    mamba2's shape in bf16, 0.0046 at zamba2's in f32, two bf16 parts).

    Also: the chunk-local outputs are bit-equal on two runs, and the
    kernel's device time (``device_ms``) is read beside its CUDA-event
    time."""
    bh, bg, s, chunk = batch * SSD_HEADS, batch, seq, SSD_CHUNK
    x, dt, A, B, C = _ssd_inputs(dev, gen, bh, bg, s, n, dtype)
    ax, aB, aC = x.abs().float(), B.abs().float(), C.abs().float()
    err, worst = 0.0, 0.0

    def hold(got, want, terms, rounded):
        nonlocal err, worst
        tol = SSD_INPUT_ROUNDING * terms
        if rounded:
            tol = tol + BF16_ULP * want.float().abs()
        diff = (got.float() - want.float()).abs()
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff / tol.clamp_min(1e-30)).max()))

    got = ssd_chunk_local(x, dt, A, B, C, chunk=chunk)
    want = ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
    terms = ssd_chunk_local_plain(ax, dt, A, aB, aC, chunk=chunk)
    for g_, w_, t_ in zip(got, want, (*terms[:2], want[2].abs())):
        hold(g_, w_, t_, False)
    del got, want, terms
    y, st = ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    wy, wst = ssd_chunk_scan_plain(x, dt, A, B, C, chunk=chunk)
    ty, tst = ssd_chunk_scan_plain(ax, dt, A, aB, aC, chunk=chunk)
    hold(y, wy, ty, dtype == torch.bfloat16)
    hold(st, wst, tst, False)
    finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    del y, st, wy, wst, ty, tst, ax, aB, aC
    torch.cuda.synchronize()
    run = lambda: ssd_chunk_local(x, dt, A, B, C, chunk=chunk)  # noqa: E731
    same = bit_equal(run)
    ms = mean_ms(run, dev, 10)
    dev_ms = device_ms(run)
    plain_ms = mean_ms(lambda: ssd_chunk_local_plain(x, dt, A, B, C,
                                                     chunk=chunk), dev, 3)
    full_ms = mean_ms(lambda: ssd_chunk_scan(x, dt, A, B, C, chunk=chunk),
                      dev, 10)
    full_plain_ms = mean_ms(lambda: ssd_chunk_scan_plain(
        x, dt, A, B, C, chunk=chunk), dev, 3)
    b_ms, b_by = _ssd_bound(x, B, n, chunk)
    parts = 1 if dtype == torch.bfloat16 else 2
    bl, bc = ssd_mma_blocks(chunk, n, SSD_HEADDIM, heads=bh * (s // chunk),
                            parts=parts)
    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"[ssd] {label}: the whole function (kernel + torch inter-chunk "
          f"stage) {full_ms:.4f} ms, plain {full_plain_ms:.4f} ms; worst "
          f"|kernel - plain| / bound {worst:.3e}; finite {finite}",
          flush=True)
    rec.add("ssd_chunk_scan",
            f"{label} BH{bh} S{s} N{n} P{SSD_HEADDIM} L{chunk} {dt_name} "
            f"b{bl}x{bc} {'bit-equal' if same else 'NOT bit-equal'}",
            err=err, ok=worst <= 1.0 and finite and same,
            tol="3*2^-9*T (+2^-7|y| bf16)", ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, main_path=True,
            device_ms=dev_ms)
    return dict(case=label, worst_ratio=worst, full_ms=full_ms,
                full_plain_ms=full_plain_ms, device_ms=dev_ms,
                bit_equal=same)


def check_ssd_ref(rec: Record, dev, gen) -> None:
    """The kernel path of ``ops.covenant_ssd`` in f32 against the
    sequential oracle ``ssd_ref`` at the bound of ``tests/test_kernels.py``
    (atol 2e-3) and its inputs (dt in [0.01, 0.2], A in [-2, -0.5]): a
    ragged S (1000 with chunk 512), 2 groups of 4 heads, and the sequence
    split at 600 and continued from the first part's state."""
    b, s, h, g, n, p = 1, 1000, 8, 2, 128, SSD_HEADDIM
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
    A = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    B = torch.randn((b, s, g, n), generator=gen, device=dev)
    C = torch.randn((b, s, g, n), generator=gen, device=dev)
    want, wst = ops.ssd_ref(x, dt, A, B, C, return_state=True)
    y, st = ops.covenant_ssd(x, dt, A, B, C, chunk=SSD_CHUNK,
                             return_state=True)
    half = 600
    y1, st1 = ops.covenant_ssd(x[:, :half], dt[:, :half], A, B[:, :half],
                               C[:, :half], chunk=SSD_CHUNK,
                               return_state=True)
    y2, st2 = ops.covenant_ssd(x[:, half:], dt[:, half:], A, B[:, half:],
                               C[:, half:], chunk=SSD_CHUNK, init_state=st1,
                               return_state=True)
    torch.cuda.synchronize()
    err = max(float((a - w).abs().max()) for a, w in (
        (y, want), (st, wst), (torch.cat([y1, y2], 1), want), (st2, wst)))
    # the head-batched shape the kernel sees: S padded to 1024
    xf, dtf, af, bf, cf = _ssd_inputs(dev, gen, b * h, b * g, 1024, n,
                                      torch.float32, heads=h)
    ms = mean_ms(lambda: ssd_chunk_local(xf, dtf, af, bf, cf,
                                         chunk=SSD_CHUNK), dev, 10)
    plain_ms = mean_ms(lambda: ssd_chunk_local_plain(
        xf, dtf, af, bf, cf, chunk=SSD_CHUNK), dev, 10)
    b_ms, b_by = _ssd_bound(xf, bf, n, SSD_CHUNK)
    rec.add("ssd_chunk_scan",
            f"vs ssd_ref S{s} H{h} G{g} N{n} P{p} L{SSD_CHUNK} f32 +init",
            err=err, ok=err <= SSD_REF_ATOL, tol=SSD_REF_ATOL, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, main_path=False)


def serve_ssm(rec: Record, dev, gen, arch: str) -> dict:
    """The served path of ``arch`` at full width: its layer report's GEMM
    shapes (and, for zamba2, attention and decode at head_dim 160) checked,
    then ``launch.serve`` with every counter from 0, the launch counts
    required, kernel path against plain path."""
    cfg = configs.get_config(arch)
    for g in lm_layer_gemms(cfg, BATCH):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"{arch[:6]} decode {g.name.split('_', 3)[-1]}",
                   main_path=True)
    n_groups, _ = cfg.layer_groups()
    if cfg.family == "hybrid":
        hd = 2 * cfg.d_model // cfg.n_heads
        check_attention(rec, dev, gen, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                        s=SSM_PROMPT, d=hd)
        check_decode(rec, dev, gen, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                     s=SSM_MAX_LEN, d=hd, lens=(1, 700, 2049, 2080))
    args = ["--arch", arch, "--batch", str(BATCH), "--prompt-len",
            str(SSM_PROMPT), "--max-new", str(MAX_NEW), "--requests",
            str(REQUESTS), "--max-len", str(SSM_MAX_LEN), "--seed", "0",
            "--device", "cuda", "--attn", "kernel"]
    for fn in KERNEL_FNS:
        fn.launches = 0
    stats = serve.main(args)
    torch.cuda.synchronize()
    launches = serve.kernel_launches()
    expected = {"ssd_chunk_scan": cfg.n_layers * stats["batches"]}
    if cfg.family == "hybrid":
        expected["flash_attention"] = n_groups * stats["batches"]
        expected["flash_decode"] = n_groups * stats["decode_steps"]
    print(f"[serve] {arch} launches on the main path: {launches}; required "
          f"{expected} ({stats['batches']} batches, {stats['decode_steps']} "
          f"decode steps)", flush=True)
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"{arch}: {name} launched {launches[name]}"
                                 f" times, not {n}")
    if launches["matmul"] <= 0:
        raise AssertionError(f"{arch}: the layer report never launched "
                             "matmul")
    compared = compare_ssm(cfg, dev)[0]
    torch.cuda.empty_cache()
    return dict(tok_per_s=stats["tok_per_s"], new_tokens=stats["new_tokens"],
                seconds=stats["seconds"], batch_seconds=stats["batch_seconds"],
                launches=launches, required=expected, compare=compared)


def compare_dense(cfg, dev, prompt: int = DENSE_PROMPT,
                  max_len: int = DENSE_MAX_LEN, batch: int = BATCH,
                  steps: int = 4) -> tuple[dict, object, dict]:
    """A dense config at full width, kernel path against plain path in
    bf16 on the same weights, gated at ``LOGITS_REL_L2`` (bound derived in
    ``compare_paths``), then the plain path against itself with one weight
    of (decoder) layer 0 (its first norm scale entry) moved by one bf16
    ulp: the model's own spread under a change of one rounding, printed
    beside the gate.  Returns (the comparisons, the kernel-path model, its
    weights)."""
    rel, agree, model, params = compare_paths(cfg, dev, prompt, max_len,
                                              batch=batch, steps=steps)
    pmodel = get_model(cfg, device=dev, attn="plain")
    key = "dec_layers" if cfg.family == "audio" else "layers"
    lp0 = params[key][0]
    moved = {**params, key: [
        {**lp0, "ln1": {**lp0["ln1"], "scale": lp0["ln1"]["scale"].clone()}}]
        + params[key][1:]}
    moved[key][0]["ln1"]["scale"][0] *= 1 + BF16_ULP
    srel, sagree = _compare(pmodel, pmodel, moved, params, prompt, max_len,
                            f"{cfg.name} bf16 plain, one weight moved one "
                            "ulp,", None, batch, steps)
    del moved, pmodel
    return (dict(rel_l2=rel, argmax_agree=agree,
                 plain_spread=dict(rel_l2=srel, argmax_agree=sagree)),
            model, params)


def _kept_by_layer(run, n_moe: int, label: str) -> list[torch.Tensor]:
    """The (token, expert) assignments that each MoE layer keeps over
    ``run()`` (without grad), recorded through ``moe.moe_ffn``; raises
    unless it recorded one a MoE layer (a patched name that stopped being
    called would show no differences)."""
    kept, ffn = [], moe.moe_ffn

    def recording(cfg, p, x):
        kept.append(moe.kept_assignments(cfg, p, x))
        return ffn(cfg, p, x)

    moe.moe_ffn = recording
    try:
        with torch.no_grad():
            run()
    finally:
        moe.moe_ffn = ffn
    if len(kept) != n_moe:
        raise RuntimeError(f"{label}: recorded {len(kept)} MoE layers' "
                           f"routing, expected {n_moe}")
    return kept


def _differing(a: list, b: list) -> list[int]:
    """For each MoE layer, the (token, expert) assignments kept on one side
    and not on the other (a token whose top-k changed by one expert counts
    2)."""
    return [int((x != y).sum()) for x, y in zip(a, b)]


def routing_differences(amodel, aparams, bmodel, bparams, prompt: int,
                        max_len: int, label: str) -> list[int]:
    """``_differing`` over one prefill of the prompt ``_compare`` feeds."""
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(2, amodel.cfg.vocab,
                                        (BATCH, prompt)),
                           device=amodel.device)
    out = _differing(*(_kept_by_layer(
        lambda m=model, p=params: m.prefill(p, {"tokens": toks},
                                            m.init_cache(BATCH, max_len)),
        len(aparams["layers"]), label)
        for model, params in ((amodel, aparams), (bmodel, bparams))))
    print(f"[compare] {label}: (token, expert) assignments that differ, by "
          f"MoE layer of the prefill: {out} (of {BATCH * prompt} tokens x "
          f"top-{amodel.cfg.top_k})", flush=True)
    return out


def compare_moe(cfg, dev) -> tuple[dict, object, dict]:
    """An MoE config at full width, kernel path against plain path: gated
    in f32 (at ``MOE_ARCHS[cfg.name]`` layers, 0 for all), printed in bf16
    at full depth beside the plain path's own spread (plain against plain
    with the first MoE layer's first norm scale entry moved by one bf16
    ulp), each beside the (token, expert) assignments that differ between
    the two sides in each layer.  Returns (the comparisons, the bf16
    kernel-path model, its weights).

    Why f32.  In bf16 the paths differ inside attention by about one
    rounding a layer (``compare_paths``), and over 4 x 2048 tokens and 64
    experts some tokens' top-k choices sit closer than that.  Such a
    token's routing flips, which moves its FFN output by a whole expert's
    share and shifts which later tokens that expert keeps at its capacity.
    That is rounding, not a fault, but its size is not one rounding's; so
    bf16 is printed with the flips that explain it.

    Bound in f32, 5e-2, the serve gate: the paths differ inside attention
    by the order of f32 sums, about 1e-6 relative, so a flip needs two of a
    token's router probabilities that close at the top-k edge, which is
    rare, and moves only that token (and its experts' capacity edges),
    while the gate reads the last token's logits.  A wrong mask, layout,
    gate weight or capacity moves the logits by their own size."""
    out = {}
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                      n_layers=MOE_ARCHS[cfg.name] or cfg.n_layers)
    for key, c, tol in (("float32", f32, LOGITS_REL_L2),
                        ("bfloat16", cfg, None)):
        rel, agree, model, params = compare_paths(c, dev, DENSE_PROMPT,
                                                  DENSE_MAX_LEN, tol=tol)
        pmodel = get_model(c, device=dev, attn="plain")
        flips = routing_differences(
            model, params, pmodel, params, DENSE_PROMPT, DENSE_MAX_LEN,
            f"{c.name} {c.compute_dtype} ({c.n_layers} layers) kernel "
            "against plain")
        out[key] = dict(n_layers=c.n_layers, rel_l2=rel, argmax_agree=agree,
                        routing_differs=flips)
        if c is f32:
            del model, params, pmodel
            torch.cuda.empty_cache()
    lp0 = params["layers"][0]
    moved = {**params, "layers": [
        {**lp0, "ln1": {**lp0["ln1"], "scale": lp0["ln1"]["scale"].clone()}}]
        + params["layers"][1:]}
    moved["layers"][0]["ln1"]["scale"][0] *= 1 + BF16_ULP
    srel, sagree = _compare(pmodel, pmodel, moved, params, DENSE_PROMPT,
                            DENSE_MAX_LEN, f"{cfg.name} bf16 plain, one "
                            "weight moved one ulp,", None)
    sflips = routing_differences(
        pmodel, moved, pmodel, params, DENSE_PROMPT, DENSE_MAX_LEN,
        f"{cfg.name} bf16 plain, one weight moved one ulp, against plain")
    out["bfloat16_plain_spread"] = dict(rel_l2=srel, argmax_agree=sagree,
                                        routing_differs=sflips)
    del moved, pmodel
    return out, model, params


def check_moe_dispatch(cfg, dev) -> dict:
    """One MoE layer's ``moe_ffn`` at full width on the card against the
    CPU, on the same f32 weights (seeded on the CPU) and ``BATCH`` x
    ``DENSE_PROMPT`` tokens with a shared component (``MOE_COMMON``) that
    crowds a few experts past their capacity at the config's capacity
    factor.  Drops must happen; the kept (token, expert) assignments must
    be equal; the outputs within ``MOE_DISPATCH_REL_L2`` relative L2; two
    card runs bit-equal.

    Bound, 1e-4: both sides compute the same f32 products (no TF32) and
    differ in the order of their sums, each within K u of its terms'
    absolute sum (K = 2048, u = 2^-24: 1.2e-4 at worst, about sqrt(K) u
    ~= 2.7e-6 for terms of random sign).  One token routed, kept or
    dropped otherwise moves its row by a whole expert's share, about
    1e-3 of the whole output's norm even for one row of 8192."""
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_ffn(f32, gen)
    d = cfg.d_model
    x = (torch.randn((BATCH, DENSE_PROMPT, d), generator=gen)
         + MOE_COMMON * torch.randn((d,), generator=gen))
    pd, xd = tree_map(lambda a: a.to(dev), p), x.to(dev)
    run = lambda: moe.moe_ffn(f32, pd, xd)  # noqa: E731
    got = run().cpu()
    same = bit_equal(run)
    kept_card = moe.kept_assignments(f32, pd, xd).cpu()
    ms = mean_ms(run, dev, 5)
    t0 = time.perf_counter()
    want = moe.moe_ffn(f32, p, x)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    kept = moe.kept_assignments(f32, p, x)
    rel = float((got - want).norm() / want.norm())
    cap = moe.capacity(f32, BATCH * DENSE_PROMPT)
    dropped = BATCH * DENSE_PROMPT * cfg.top_k - int(kept.sum())
    full = int((kept.sum(0) == cap).sum())
    differ = int((kept_card != kept).sum())
    ok = dropped > 0 and differ == 0 and rel <= MOE_DISPATCH_REL_L2 and same
    print(f"[moe] {cfg.name} dispatch, one layer, {BATCH}x{DENSE_PROMPT} "
          f"tokens f32, capacity {cap}: {dropped} assignments dropped, "
          f"{full} of {cfg.n_experts} experts full; card against CPU: "
          f"{differ} kept assignments differ, rel_l2={rel:.3e} (tol "
          f"{MOE_DISPATCH_REL_L2}), {'bit-equal' if same else 'NOT bit-equal'}"
          f" on two card runs; card {ms:.3f} ms, CPU {cpu_ms:.1f} ms "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{cfg.name} dispatch: dropped {dropped}, "
                             f"{differ} kept assignments differ, rel_l2 "
                             f"{rel}, bit-equal {same}")
    return dict(capacity=cap, dropped=dropped, experts_full=full,
                kept_differ=differ, rel_l2=rel, bit_equal=same, card_ms=ms,
                cpu_ms=cpu_ms)


def serve_dense(rec: Record, dev, gen, arch: str, n_layers: int) -> dict:
    """A dense or MoE config at full width (``n_layers`` layers, 0 for
    all): its kernels at the served shapes (the layer report's GEMMs, the
    prefill's attention with each window its layers use, the decode
    against each cache width, bf16 on the main path and f32 beside it;
    an MoE config's dispatch, ``check_moe_dispatch``), then
    ``launch.serve`` with every counter from 0, the launch counts required
    (flash attention once per layer of each batch, flash decode once per
    layer of each decode step), kernel path against plain path
    (``compare_dense``, or ``compare_moe``)."""
    cfg = configs.get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    for g in lm_layer_gemms(cfg, BATCH):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"{arch[:6]} decode {g.name.split('_', 3)[-1]}",
                   main_path=True)
    hd = cfg.hd
    for window in ([cfg.window, None] if cfg.window else [None]):
        check_attention(rec, dev, gen, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                        s=DENSE_PROMPT, d=hd, window=window)
    widths = sorted({min(cfg.window, DENSE_MAX_LEN) if cfg.window
                     else DENSE_MAX_LEN, DENSE_MAX_LEN})
    for dtype in (torch.bfloat16, torch.float32):
        for width in widths:
            check_decode(rec, dev, gen, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                         s=width, d=hd, lens=(1, 700, width - 31, width),
                         dtype=dtype, main_path=dtype == torch.bfloat16)
    dispatch = check_moe_dispatch(cfg, dev) if cfg.family == "moe" \
        else None
    args = ["--arch", arch, "--batch", str(BATCH), "--prompt-len",
            str(DENSE_PROMPT), "--max-new", str(MAX_NEW), "--requests",
            str(REQUESTS), "--max-len", str(DENSE_MAX_LEN), "--seed", "0",
            "--device", "cuda", "--attn", "kernel", "--n-layers",
            str(n_layers)]
    launches, stats, expected = serve_counted(cfg, args)
    compared = (compare_moe if cfg.family == "moe" else compare_dense)(
        cfg, dev)[0]
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, tok_per_s=stats["tok_per_s"],
                new_tokens=stats["new_tokens"], seconds=stats["seconds"],
                batch_seconds=stats["batch_seconds"], launches=launches,
                required=expected, compare=compared, dispatch=dispatch)


def attention_launches(cfg) -> tuple[int, int]:
    """(flash attention launches a served batch, flash decode launches a
    decode step) on ``cfg``'s served path: one a layer each for the dense,
    MoE and VLM families; whisper adds one a batch for each encoder layer,
    and its decoder layers attend twice (self and cross) in the prefill
    and in every step."""
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def serve_counted(cfg, args: list[str]) -> tuple[dict, dict, dict]:
    """``launch.serve`` on ``args`` with every counter from 0: flash
    attention and flash decode required ``attention_launches`` times a
    batch and a decode step, matmul at least once (the layer report).
    Returns (the launches, serve's stats, the required counts)."""
    for fn in KERNEL_FNS:
        fn.launches = 0
    stats = serve.main(args)
    torch.cuda.synchronize()
    launches = serve.kernel_launches()
    per_batch, per_step = attention_launches(cfg)
    expected = {"flash_attention": per_batch * stats["batches"],
                "flash_decode": per_step * stats["decode_steps"]}
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers) launches on the main "
          f"path: {launches}; required {expected} ({stats['batches']} "
          f"batches, {stats['decode_steps']} decode steps)", flush=True)
    for name, n in expected.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{cfg.name}: {name} launched "
                                 f"{launches[name]} times, not {n}")
    if launches["matmul"] <= 0:
        raise AssertionError(f"{cfg.name}: the layer report never launched "
                             "matmul")
    return launches, stats, expected


def compare_encdec_vlm(cfg, dev, batch: int, prompt: int, max_len: int
                       ) -> tuple[dict, object, dict]:
    """whisper-base or paligemma-3b at full width and depth, kernel path
    against plain path over the prefill and ``COMPARE_STEPS`` decode
    steps: gated in f32 at ``ENCDEC_VLM_F32_REL_L2``, then in bf16 by the
    dense configs' rule (``compare_dense``: ``LOGITS_REL_L2``, the plain
    path's one-ulp spread beside it).  Returns (the comparisons, the bf16
    kernel-path model, its weights).

    Bounds.  In f32 the paths differ only by the order of f32 sums inside
    attention (the block GEMMs are the same torch calls on both): about
    sqrt(1500) * 2^-24 = 2.3e-6 relative an attention at 1500 keys, over
    18 attentions a token (whisper: 6 encoder layers and 6 decoder layers
    of two; paligemma: 18 layers) a random walk of sqrt(18) * 2.3e-6 =
    1e-5; ``ENCDEC_VLM_F32_REL_L2`` = 1e-4 leaves a factor 10 for the
    network's gain and sits 100 times under the 1e-2 that a 1 % fault
    (a leaked mask, a wrong kv row at the ragged split, a cross cache off
    by some frames) moves the logits by.  The first whole run read
    6.3e-7 / 2.0e-7 (PERF.md section 6).  In bf16,
    by qwen3's rule, about one bf16 rounding a layer that attends:
    whisper's 6 encoder layers and 6 decoder layers (two attentions
    each), sqrt(18) * 2^-8 ~= 1.7e-2; paligemma's 18 layers,
    sqrt(18) * 2^-8 ~= 1.7e-2.  A wrong mask (one that hid the ragged
    key edge at 1500, or masked a non-causal row), a wrong kv head or a
    wrong cross cache moves the logits by their own size."""
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    rel, agree, model, params = compare_paths(
        f32, dev, prompt, max_len, tol=ENCDEC_VLM_F32_REL_L2, batch=batch,
        steps=COMPARE_STEPS)
    out = {"float32": dict(rel_l2=rel, argmax_agree=agree)}
    del model, params
    torch.cuda.empty_cache()
    out["bfloat16"], model, params = compare_dense(
        cfg, dev, prompt, max_len, batch=batch, steps=COMPARE_STEPS)
    return out, model, params


def serve_encdec_vlm(rec: Record, dev, gen, arch: str) -> dict:
    """whisper-base or paligemma-3b at full width and depth with its
    traffic (``ENCDEC_VLM``): its kernels at the served shapes (the layer
    report's GEMMs; whisper's non-causal encoder and cross attention
    forward, its causal decoder prompt, its decode against the self cache
    and the full 1500-frame cross cache; paligemma's causal forward over
    image prefix and prompt at head dim 256, group 8, and its decode),
    bf16 on the main path and f32 beside it; then ``launch.serve`` with
    every counter from 0 (``serve_counted``), the kernel path against the
    plain path (``compare_encdec_vlm``)."""
    cfg = configs.get_config(arch)
    batch, prompt, max_new, max_len, requests = ENCDEC_VLM[arch]
    for g in lm_layer_gemms(cfg, batch):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"{arch[:6]} decode {g.name.split('_', 3)[-1]}",
                   main_path=True)
    heads = dict(b=batch, hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd)
    faults = None
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        if cfg.family == "audio":
            se = cfg.enc_frames
            check_attention(rec, dev, gen, s=se, causal=False, dtype=dtype,
                            main_path=main, **heads)
            check_attention(rec, dev, gen, s=se, sq=prompt, causal=False,
                            dtype=dtype, main_path=main, **heads)
            check_attention(rec, dev, gen, s=prompt, dtype=dtype,
                            main_path=main, **heads)
            check_decode(rec, dev, gen, s=se, lens=(se,) * batch,
                         dtype=dtype, main_path=main, **heads)
            if main:
                faults = planted_faults(dev, gen, sk=se, sq=prompt, **heads)
            lens = (1, prompt + 1, 64, 100, prompt + max_new, 300,
                    max_len - 1, max_len)
        else:
            stream = cfg.vis_tokens + prompt
            check_attention(rec, dev, gen, s=stream, dtype=dtype,
                            main_path=main, **heads)
            lens = (1, stream + 1, stream + 17, max_len)
        check_decode(rec, dev, gen, s=max_len, lens=lens, dtype=dtype,
                     main_path=main, **heads)
    args = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--max-new", str(max_new), "--requests",
            str(requests), "--max-len", str(max_len), "--seed", "0",
            "--device", "cuda", "--attn", "kernel"]
    launches, stats, expected = serve_counted(cfg, args)
    compared = compare_encdec_vlm(cfg, dev, batch, prompt, max_len)[0]
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, tok_per_s=stats["tok_per_s"],
                new_tokens=stats["new_tokens"], seconds=stats["seconds"],
                batch_seconds=stats["batch_seconds"], launches=launches,
                required=expected, compare=compared, planted_faults=faults)


# ---------------------------------------------------------------------------
# phase 12: whisper-base and paligemma-3b trained
# ---------------------------------------------------------------------------


def _frontend_leaves(cfg) -> set:
    """The top-level keys of the leaves whose gradient reaches them only
    through this family's new paths: whisper's encoder (through every
    decoder layer's cross-attention k and v), paligemma's projector
    (through the image prefix, which carries no targets)."""
    return ({"pos_enc", "enc_layers", "enc_ln_f"} if cfg.family == "audio"
            else {"projector"})


def compare_encdec_vlm_train_paths(arch: str, dev) -> dict:
    """One train step of whisper-base or paligemma-3b at full width and the
    gate depth of ``ENCDEC_VLM_TRAIN``, at its full train batch (with the
    stub frontend's extras), kernel path against plain path on the same
    weights and batch, in f32 and then in bf16.  The kernel path runs
    ``FlashAttention``: whisper's non-causal encoder attention over 1500
    frames, its cross attention (Sq 448 against Sk 1500) and causal
    decoder attention at D64; paligemma's causal D256 attention at group 8
    over image prefix and text.

    Bounds, derived as ``compare_train_paths``' before the first run.  In
    f32 the two paths differ only by the order of f32 sums inside
    attention (the kernels' online softmax and their dq, dk, dv walks
    against einsum, softmax and autograd): about sqrt(1500) * 2^-24 =
    2.3e-6 relative an attention output at 1500 keys, over 6 (whisper: 2
    encoder layers, 2 decoder layers of two) or 2 attentions forward and
    back a few 1e-6; |dloss| / |loss| <= 1e-4 and a gradient relative L2
    <= 1e-3 leave two orders of headroom.  The whole gradient's norm is
    mostly the tied embedding's, so the leaves the new paths alone reach
    (``_frontend_leaves``: whisper's encoder, paligemma's projector) are
    gated together at the same 1e-3 in f32: a wrong cross-attention dk or
    dv, or a wrong gradient through the image prefix, moves them by their
    own size.  In bf16 the paths round attention's inputs and outputs to
    bf16 at different points, and these random-weight models amplify any
    change, as ``compare_ssm_train_paths`` found for the SSM archs; so the
    bf16 gradient is held, as there, to ``SSM_BF16_SPREAD`` times the
    plain path's own spread (the plain path against itself with the first
    layer's first norm scale entry moved one bf16 ulp), never below 5e-2,
    and the loss and the frontend leaves are printed."""
    batch_n, seq, depth = ENCDEC_VLM_TRAIN[arch]
    cfg = configs.get_config(arch).replace(n_layers=depth)
    if cfg.family == "audio":
        cfg = cfg.replace(enc_layers=depth)
    first = "enc_layers" if cfg.family == "audio" else "layers"
    return compare_train_step(
        f"encdec-vlm-train {arch}", cfg, dev, batch_n, seq, seed=5,
        moved=(first, "ln1"), front=_frontend_leaves(cfg),
        need=["flash_attention_fwd_lse", "flash_attention_bwd"])


def train_attention_launches(cfg, steps: int, microbatches: int = 1
                             ) -> dict:
    """The flash launches ``launch.train`` makes on ``cfg``: each attention
    of a microbatch's forward (whisper: one a layer of its encoder, two a
    decoder layer, self and cross; paligemma: one a layer) runs the LSE
    forward, remat (``cfg.remat``: every layer under
    ``torch.utils.checkpoint``) runs each once more in the backward, and
    the backward runs the flash backward once.  whisper-base: 6 + 2 x 6 =
    18 attentions, 36 LSE forwards and 18 backwards a step; paligemma-3b:
    18, 36 and 18."""
    per = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "audio"
           else cfg.n_layers) * steps * microbatches
    return {"flash_attention_fwd_lse": (2 if cfg.remat else 1) * per,
            "flash_attention_bwd": per}


def train_encdec_vlm_main_path(arch: str) -> dict:
    """``train_full_depth`` of whisper-base or paligemma-3b for
    ``ENCDEC_VLM_TRAIN_STEPS`` steps of its ``ENCDEC_VLM_TRAIN`` batch: the
    LSE forward and the backward exactly ``train_attention_launches``
    times, matmul at least once (the layer report), no other kernel."""
    cfg = configs.get_config(arch)
    batch_n, seq, _ = ENCDEC_VLM_TRAIN[arch]
    required = {"matmul": None, "flash_attention": 0, "flash_decode": 0,
                "ssd_chunk_scan": 0,
                **train_attention_launches(cfg, ENCDEC_VLM_TRAIN_STEPS)}
    return train_full_depth(f"encdec-vlm-train {arch}", arch, batch_n, seq,
                            ENCDEC_VLM_TRAIN_STEPS, required)


def train_encdec_vlm(rec: Record, dev, gen, arch: str) -> dict:
    """whisper-base or paligemma-3b trained: its layer report's GEMMs at the
    train tokens, its attention's LSE forward and backward at the train
    shapes in bf16 (the main path) and f32 (whisper's non-causal encoder
    over 1500 frames, its cross attention of 448 decoder tokens across
    them and its causal decoder attention; paligemma's causal D256
    attention at group 8 over 256 + 256 tokens), whisper's ragged key edge
    left unmasked through both on purpose (``planted_bwd_fault``); then
    the gate step
    (``compare_encdec_vlm_train_paths``), ``launch.train`` at full width
    and depth (``train_encdec_vlm_main_path``)."""
    cfg = configs.get_config(arch)
    batch_n, seq, _ = ENCDEC_VLM_TRAIN[arch]
    for g in lm_layer_gemms(cfg, batch_n * seq):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"{arch[:6]} train {g.name.split('_', 3)[-1]}",
                   main_path=True)
    heads = dict(b=batch_n, hq=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd)
    if cfg.family == "audio":
        se = cfg.enc_frames
        shapes = [dict(s=se, causal=False), dict(s=se, sq=seq, causal=False),
                  dict(s=seq)]
    else:
        shapes = [dict(s=cfg.vis_tokens + seq)]
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for shape in shapes:
            for check in (check_fwd_lse, check_bwd):
                check(rec, dev, gen, dtype=dtype, window=None,
                      main_path=main, **heads, **shape)
    faults = planted_bwd_fault(dev, gen, sk=cfg.enc_frames, sq=seq,
                               **heads) if cfg.family == "audio" else None
    gates = compare_encdec_vlm_train_paths(arch, dev)
    run = train_encdec_vlm_main_path(arch)
    return dict(gates=gates, planted_faults=faults, **run)


# ---------------------------------------------------------------------------
# phase 13: the MoE family and the other dense configs trained
# ---------------------------------------------------------------------------


def moe_layer_grads(cfg, p: dict, x: torch.Tensor, w: torch.Tensor
                    ) -> tuple:
    """The gradient of ``sum(moe_ffn(x) * w)`` for x and every leaf of one
    MoE layer's params ``p``, in the order (x, *leaves)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    x = x.detach().requires_grad_(True)
    out = moe.moe_ffn(cfg, p, x)
    return torch.autograd.grad((out.float() * w).sum(), [x, *tree_leaves(p)])


def check_moe_backward(cfg, dev, batch: int, seq: int) -> dict:
    """One MoE layer's backward at full width on ``batch`` x ``seq`` tokens
    with ``check_moe_dispatch``'s shared component, which crowds a few
    experts past their capacity: in bf16 (the main path's dtype) and f32,
    the gradient of the input and of every weight bit-equal on two card
    runs; in f32, drops must happen and each gradient must come within
    ``MOE_DISPATCH_REL_L2`` of the CPU's on the same weights and tokens
    (seeded on the CPU).  The dispatch gathers each token once per top-k
    choice (``xf[token]``), so the input's gradient sums k rows a token
    through the gather's backward: a sum whose order must not change from
    run to run.

    Bound, 1e-4, as ``check_moe_dispatch``'s: both sides compute the same
    f32 products (no TF32) and differ in the order of their sums, over
    d_ff (1024 or 1408) terms for the input, over up to the capacity's
    tokens for an expert's weights and over all tokens for the router's,
    about sqrt(K) u; one token routed, kept or dropped otherwise moves its
    gradient row and its experts' weights by a whole share."""
    out = {}
    for dt in ("bfloat16", "float32"):
        c = cfg.replace(param_dtype=dt, compute_dtype=dt)
        gen = torch.Generator().manual_seed(0)
        p = moe.init_moe_ffn(c, gen)
        x = (torch.randn((batch, seq, c.d_model), generator=gen) + MOE_COMMON
             * torch.randn((c.d_model,), generator=gen)).to(getattr(torch, dt))
        w = torch.randn((batch, seq, c.d_model), generator=gen)
        pd, xd, wd = tree_map(lambda a: a.to(dev), p), x.to(dev), w.to(dev)
        run = lambda: moe_layer_grads(c, pd, xd, wd)  # noqa: E731
        same = bit_equal(run)
        res = dict(bit_equal=same)
        ok = same
        if dt == "float32":
            got = [g.cpu() for g in run()]
            t0 = time.perf_counter()
            want = moe_layer_grads(c, p, x, w)
            cpu_s = time.perf_counter() - t0
            dropped = batch * seq * c.top_k - int(
                moe.kept_assignments(c, p, x).sum())
            rels = [rel_l2(a, b) for a, b in zip(got, want)]
            res.update(dropped=dropped, input_rel_l2=rels[0],
                       weights_rel_l2=max(rels[1:]), cpu_s=cpu_s)
            ok = ok and dropped > 0 and max(rels) <= MOE_DISPATCH_REL_L2
            del got, want
        print(f"[moe] {cfg.name} dispatch backward, one layer, {batch}x{seq} "
              f"tokens {dt}: gradients of the input and the "
              f"{len(tree_leaves(p))} weights "
              f"{'bit-equal' if same else 'NOT bit-equal'} on two card runs"
              + ("" if dt != "float32" else
                 f"; {res['dropped']} assignments dropped; card against CPU "
                 f"rel_l2 input {res['input_rel_l2']:.3e}, weights at most "
                 f"{res['weights_rel_l2']:.3e} (tol {MOE_DISPATCH_REL_L2}); "
                 f"CPU {res['cpu_s']:.1f} s")
              + f" {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{cfg.name} dispatch backward {dt}: {res}")
        out[dt] = res
        del p, pd, x, xd, w, wd
        torch.cuda.empty_cache()
    return out


def compare_config_train_paths(arch: str, dev) -> dict:
    """One train step of an MoE or dense config at full width and the gate
    depth of ``TRAIN_CONFIGS`` (``compare_train_step``), kernel path
    against plain path on the same weights and batch, in f32 and then in
    bf16.  The kernel path runs ``FlashAttention``: the MoE family's D128
    at group 1, stablelm's D160 at group 4, gemma3's D256 at group 2 with
    its window on 5 of 6 layers, command-r's D128 at group 12.

    Bounds, derived as ``compare_train_paths``' before the first run.  In
    f32 the two paths differ only by the order of f32 sums inside
    attention: about sqrt(2048) * 2^-24 = 2.7e-6 relative an attention
    output at 2048 keys, over 1 to 6 layers forward and back a few 1e-6;
    |dloss| / |loss| <= 1e-4 and a gradient relative L2 <= 1e-3 leave two
    orders of headroom.  For the MoE archs a token whose top-k choices sit
    within that of each other can switch experts: it moves that token's
    gradient rows, and its experts' weights by one token's share of 640
    or 480 slots, against a gradient whose norm is mostly the embedding's;
    the assignments that differ are printed beside the gate.  In bf16 the
    gradient is held to ``SSM_BF16_SPREAD`` times the plain path's own
    one-ulp spread (never below 5e-2), as for the SSM, whisper and
    paligemma archs.  For the MoE archs one ulp reroutes tokens on both
    sides alike: the kernel path against the plain path and the plain path
    against its moved twin each differ by rounding and by the reroutes it
    causes, so the same rule holds, and the reroutes are printed beside
    the spread."""
    _, _, _, depth, batch_n, seq = TRAIN_CONFIGS[arch]
    cfg = configs.get_config(arch).replace(n_layers=depth)
    return compare_train_step(
        f"config-train {arch}", cfg, dev, batch_n, seq, seed=6,
        moved=("layers", "ln1"),
        need=["flash_attention_fwd_lse", "flash_attention_bwd"])


def train_config(rec: Record, dev, gen, arch: str, seen: set) -> dict:
    """An MoE or dense config trained at full width and the depth of
    ``TRAIN_CONFIGS``: its layer report's GEMMs at the train tokens; the
    LSE forward and the backward at its train shape (each window its
    layers use) in bf16 (the main path) and f32, a shape in ``seen`` (an
    earlier config's) not again; for an MoE config the dispatch's backward
    (``check_moe_backward``); the gate step
    (``compare_config_train_paths``); ``launch.train --n-layers`` for
    ``TRAIN_CONFIG_STEPS`` steps, the LSE forward and the backward exactly
    ``train_attention_launches`` times, no other attention or SSD kernel,
    the peak at most ``TRAIN_PEAK_GIB``."""
    depth, batch_n, seq, _, _, _ = TRAIN_CONFIGS[arch]
    cfg = configs.get_config(arch).replace(n_layers=depth)
    for g in lm_layer_gemms(cfg, batch_n * seq):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"{arch[:6]} train {g.name.split('_', 3)[-1]}",
                   main_path=True)
    heads = dict(b=batch_n, hq=cfg.n_heads, hkv=cfg.n_kv_heads, s=seq,
                 d=cfg.hd)
    if tuple(heads.values()) not in seen:
        seen.add(tuple(heads.values()))
        for dtype in (torch.bfloat16, torch.float32):
            for window in ([cfg.window, None] if cfg.window else [None]):
                for check in (check_fwd_lse, check_bwd):
                    check(rec, dev, gen, dtype=dtype, window=window,
                          main_path=dtype == torch.bfloat16, **heads)
    backward = check_moe_backward(cfg, dev, batch_n, seq) \
        if cfg.family == "moe" else None
    gates = compare_config_train_paths(arch, dev)
    required = {"matmul": None, "flash_attention": 0, "flash_decode": 0,
                "ssd_chunk_scan": 0,
                **train_attention_launches(cfg, TRAIN_CONFIG_STEPS)}
    run = train_full_depth(f"config-train {arch}", arch, batch_n, seq,
                           TRAIN_CONFIG_STEPS, required, n_layers=depth,
                           peak_gib=TRAIN_PEAK_GIB)
    return dict(gates=gates, dispatch_backward=backward, **run)


# ---------------------------------------------------------------------------
# phase 14: the Covenant compiler on the card
# ---------------------------------------------------------------------------


def child(args: list[str], tag: str, timeout: int = 600, env=None
          ) -> tuple[str, float]:
    """Runs ``python args`` from the repository root with ``src`` on the
    path; raises unless it exits 0.  Returns (its stdout, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{tag}: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, wall


def launches_line(stdout: str, prefix: str) -> dict:
    """The counts of a child's ``<prefix> kernel launches: k=v ...``."""
    m = re.search(re.escape(prefix) + r" kernel launches: (.*)", stdout)
    if m is None:
        raise AssertionError(f"no '{prefix} kernel launches:' line")
    return {k: int(v) for k, v in
            (kv.split("=") for kv in m.group(1).split())}


def serve_child(args: list[str], tag: str) -> tuple[str, dict, float]:
    """A serving entry point run as ``python args`` on the card in a
    child (``child``): it must print ``block total`` and launch flash
    attention and flash decode.  Returns (its stdout, its launches, wall
    seconds)."""
    stdout, wall = child(args, tag)
    print(stdout, end="", flush=True)
    launches = launches_line(stdout, "[serve]")
    # the model's GEMMs are torch's; only an h100 report launches the GEMM
    # kernel
    if "block total" not in stdout or any(
            launches[k] <= 0 for k in ("flash_attention", "flash_decode")):
        raise AssertionError(f"{tag}: launches {launches}")
    return stdout, launches, wall


def covenant_on_card(dev, gen, smi: str) -> dict:
    """Phase 14.  Compiles every config's block GEMMs at full width
    against ``h100`` (``COVENANT_TOKENS``) into a fresh disk store: the
    reference's i8 codelets, which its layer report prints, and bf16 ones;
    prints per GEMM the cycles of both, the covenant's predicted ms
    (``predicted_ms``), the device time of ``covenant_matmul`` and of
    ``torch.matmul`` on bf16 operands, and the bound.  Then runs
    ``launch.serve`` for full-width qwen3-0.6b against each of
    ``COVENANT_CLI`` (exit 0, ``block total`` printed, its launch counts
    read from a fresh process), and replays every compile in a child
    process from the store: no pipeline stage may run.  The predicted
    against measured ratio is printed, not gated."""
    shutil.rmtree(COVENANT_STORE, ignore_errors=True)
    repro_torch.clear_cache()
    opts = repro_torch.CompileOptions(store=str(COVENANT_STORE))
    rows, timed, cycles = [], {}, []
    for arch, token_counts in COVENANT_TOKENS.items():
        cfg = configs.get_config(arch)
        tag = cfg.name.replace(".", "_").replace("-", "_") + "_"
        for tokens in token_counts:
            for g, art in compile_layer_gemms(cfg, tokens, options=opts):
                bf = repro_torch.compile(g.build("bf16", "f32"), "h100",
                                         opts)
                cyc, cyc_bf = art.cycles(), bf.cycles()
                cycles += [cyc, cyc_bf]
                if not (cyc > 0 and cyc_bf > 0):
                    raise AssertionError(f"covenant {arch} {g.name}: "
                                         f"cycles {cyc}, {cyc_bf}")
                shape = (g.tokens, g.n, g.k)
                if shape not in timed:
                    a = torch.randn((g.tokens, g.k), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    b = torch.randn((g.k, g.n), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    flops = 2.0 * g.tokens * g.n * g.k
                    calls = 3 if flops > 1e11 else 20
                    timed[shape] = (
                        device_ms(lambda: ops.covenant_matmul(a, b),
                                  calls=calls),
                        device_ms(lambda: torch.matmul(a, b), calls=calls),
                        *bound(flops, H100["peak_bf16_flops"],
                               (g.tokens * g.k + g.k * g.n) * 2
                               + g.tokens * g.n * 4))
                    del a, b
                dev_ms, lib_ms, b_ms, b_by = timed[shape]
                row = dict(arch=arch, tokens=tokens, gemm=g.name,
                           shape="x".join(map(str, shape)), cycles_i8=cyc,
                           cycles_bf16=cyc_bf,
                           predicted_ms_i8=predicted_ms(cyc),
                           predicted_ms_bf16=predicted_ms(cyc_bf),
                           device_ms=dev_ms, torch_device_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"[covenant] {arch:19s} tokens={tokens:<5d} "
                      f"{g.name.removeprefix(tag):8s} {row['shape']:17s} "
                      f"i8 {cyc:.0f} cyc {row['predicted_ms_i8']:.4f} ms, "
                      f"bf16 {cyc_bf:.0f} cyc "
                      f"{row['predicted_ms_bf16']:.4f} ms; covenant_matmul "
                      f"device_ms={dev_ms:.4f} torch.matmul "
                      f"device_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
                      f"({b_by}); predicted/measured "
                      f"{row['predicted_ms_bf16'] / dev_ms:.3g}; {smi}",
                      flush=True)
    torch.cuda.empty_cache()

    cli = []
    for extra in COVENANT_CLI:
        _, launches, _ = serve_child(
            ["-m", "repro_torch.launch.serve", "--arch", ARCH, "--requests",
             "4", "--max-new", "8", "--seed", "0", "--device", "cuda",
             *extra], f"launch.serve {extra}")
        cli.append(dict(args=extra, launches=launches))

    work = [(arch, t) for arch, ts in COVENANT_TOKENS.items() for t in ts]
    stdout, _ = child(["-c", COVENANT_REPLAY, json.dumps(work)],
                      "store replay",
                      env={"REPRO_TORCH_CACHE_DIR": str(COVENANT_STORE)})
    replay = json.loads(stdout.strip().splitlines()[-1])
    stats = replay["stats"]
    print(f"[covenant] store replay in a child process: {len(cycles)} "
          f"artifacts, driver counts {stats}", flush=True)
    if any(replay["executed"]) or stats["store_hits"] <= 0 \
            or stats["store_misses"] or replay["cycles"] != cycles:
        raise AssertionError(f"store replay ran stages or missed: {stats}, "
                             f"stages run {replay['executed']}")
    shutil.rmtree(COVENANT_STORE, ignore_errors=True)
    return dict(gemms=rows, cli=cli, replay=stats)


def example_kernels(rec: Record, dev, gen) -> dict:
    """The model examples' attention kernels held against their plain
    versions at the shapes their paths give them, in f32 as they run:
    ``examples.train_lm``'s LSE forward and backward (one microbatch of
    ``GLOBAL_BATCH // MICROBATCHES`` rows, its 12 / 6 heads of 64 over
    ``SEQ_LEN``, causal); ``examples.serve_lm``'s prefill attention on the
    smoke gemma3's 4 / 2 heads of 16 over the prompt, with its window of
    8 (the local layers) and without (the global one), and its decode
    against the global layers' cache and the local layers' rolling one.
    Then each example's model, kernel path against plain path on the same
    weights: serve_lm's logits at prefill and each decode step it serves
    (``compare_paths``, relative L2 <= ``EXAMPLE_F32_REL_L2``), and one
    train step of train_lm's model (``compare_train_step``: in f32 the
    loss 1e-4 and the gradient 1e-3, in bf16 3x the plain path's own
    one-ulp spread).  Returns the two gates' readings."""
    lm = train_lm_example.config()
    mb = train_lm_example.GLOBAL_BATCH // train_lm_example.MICROBATCHES
    seq = train_lm_example.SEQ_LEN
    for check in (check_fwd_lse, check_bwd):
        check(rec, dev, gen, mb, lm.n_heads, lm.n_kv_heads, seq, lm.hd,
              torch.float32, window=None, main_path=True)
    sm = configs.get_config("gemma3-12b", smoke=True)
    heads = dict(b=SERVE_LM_BATCH, hq=sm.n_heads, hkv=sm.n_kv_heads,
                 d=sm.hd, dtype=torch.float32)
    for window in (sm.window, None):
        check_attention(rec, dev, gen, s=SERVE_LM_PROMPT, window=window,
                        **heads)
    first, last = SERVE_LM_PROMPT + 1, SERVE_LM_PROMPT + SERVE_LM_NEW - 1
    check_decode(rec, dev, gen, s=SERVE_LM_MAX_LEN,
                 lens=(first, 21, 26, last), **heads)
    check_decode(rec, dev, gen, s=sm.window,
                 lens=(sm.window,) * SERVE_LM_BATCH, **heads)
    rel, agree, model, params = compare_paths(
        sm, dev, SERVE_LM_PROMPT, SERVE_LM_MAX_LEN, tol=EXAMPLE_F32_REL_L2,
        batch=SERVE_LM_BATCH, steps=SERVE_LM_NEW - 1)
    del model, params
    train_gates = compare_train_step(
        "train_lm", lm, dev, mb, seq, seed=7, moved=("layers", "ln1"),
        need=["flash_attention_fwd_lse", "flash_attention_bwd"])
    return dict(serve_lm=dict(rel_l2=rel, argmax_agree=agree),
                train_lm=train_gates)


def sweeps_on_card(rec: Record, dev, gen, covenant: dict, smi: str
                   ) -> dict:
    """Phase 15.  (a) ``python -m repro_torch.sweep`` over every paper
    layer x ``SWEEP_TARGETS`` with ``SWEEP_WORKERS`` workers into a fresh
    store: cold with ``--assert-unique-compiles`` (every unit compiled,
    each exactly once by the journal), then warm with
    ``--expect-store-hits`` too (zero pipeline stages).  (b) Phase 14's i8
    compiles again in a fresh child through ``compile_layer_gemms(...,
    parallel=4)`` into a fresh store: the workers compile, the ordered
    pass restores every artifact warm, and the cycles must equal phase
    14's serial ones.  (c) ``examples.serve_lm`` on the card: exit 0,
    ``block total`` printed, flash attention and flash decode launched.
    (d) ``examples.train_lm --steps 30``: exit 0, the last loss below the
    first, the LSE forward and the backward launched exactly
    ``train_attention_launches`` times, no other attention or SSD
    kernel.  Before (c) and (d), ``example_kernels`` holds the examples'
    kernels and models against their plain versions."""
    t0 = time.perf_counter()
    shutil.rmtree(SWEEP_STORE, ignore_errors=True)
    sweeps = []
    for run, extra in (("cold", []), ("warm", ["--expect-store-hits"])):
        report = SWEEP_STORE.parent / f"sweep_{run}.json"
        stdout, wall = child(
            ["-m", "repro_torch.sweep", "--targets", SWEEP_TARGETS,
             "--workers", str(SWEEP_WORKERS), "--store", str(SWEEP_STORE),
             "--json", str(report), "--assert-unique-compiles", *extra],
            f"sweep {run}")
        rep = repro_torch.SweepReport.load(str(report))
        counts = rep.counts()
        print(f"[sweep] {run}: {wall:.1f} s wall, {counts['units']} units; "
              f"{rep.summary()}; {smi}", flush=True)
        if run == "cold" and (counts["compiled"] != counts["units"]
                              or "compiled exactly once" not in stdout):
            raise AssertionError(f"cold sweep: {counts}")
        if run == "warm" and ("zero pipeline stages executed" not in stdout
                              or rep.stages_run()):
            raise AssertionError(f"warm sweep: {counts}")
        sweeps.append(dict(run=run, wall_s=wall, summary=rep.summary(),
                           counts=counts, stages_run=rep.stages_run()))
    shutil.rmtree(SWEEP_STORE, ignore_errors=True)

    serial = [r["cycles_i8"] for r in covenant["gemms"]]
    work = [(arch, t) for arch, ts in COVENANT_TOKENS.items() for t in ts]
    shutil.rmtree(PARALLEL_STORE, ignore_errors=True)
    stdout, par_wall = child(["-c", PARALLEL_COMPILE, json.dumps(work),
                              str(PARALLEL_STORE)],
                             "compile_layer_gemms parallel=4")
    par = json.loads(stdout.strip().splitlines()[-1])
    shutil.rmtree(PARALLEL_STORE, ignore_errors=True)
    print(f"[sweep] compile_layer_gemms(parallel=4) in a child: "
          f"{len(par['cycles'])} GEMMs in {par_wall:.1f} s wall, driver "
          f"counts {par['stats']}; cycles equal to phase 14's serial ones: "
          f"{par['cycles'] == serial}", flush=True)
    if par["cycles"] != serial or any(par["executed"]) \
            or par["stats"]["store_hits"] != len(serial):
        raise AssertionError(f"parallel=4 compiles: {par['stats']}, "
                             f"{len(par['cycles'])} against "
                             f"{len(serial)} serial")

    gates = example_kernels(rec, dev, gen)
    torch.cuda.empty_cache()
    stdout, serve_launches, wall = serve_child(
        ["-m", "repro_torch.examples.serve_lm"], "serve_lm")
    tok_s = float(re.search(r"\(([\d.]+) tok/s\)", stdout).group(1))
    print(f"[sweep] examples.serve_lm: {tok_s} tok/s, {wall:.1f} s wall, "
          f"launches {serve_launches}; {smi}", flush=True)

    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    try:
        stdout, wall = child(["-m", "repro_torch.examples.train_lm",
                              "--steps", str(TRAIN_LM_STEPS), "--ckpt-dir",
                              str(TRAIN_LM_CKPT)], "train_lm")
    finally:
        shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    print(stdout, end="", flush=True)
    train_launches = launches_line(stdout, "[train_lm]")
    losses = [float(x) for x in re.search(
        r"\[train_lm\] losses: (.*)", stdout).group(1).split()]
    ms = float(re.search(r"\[train_lm\] ([\d.]+) ms per step",
                         stdout).group(1))
    required = {"flash_attention": 0, "flash_decode": 0,
                "ssd_chunk_scan": 0, **train_attention_launches(
                    train_lm_example.config(), TRAIN_LM_STEPS,
                    train_lm_example.MICROBATCHES)}
    print(f"[sweep] examples.train_lm: {len(losses)} steps, {ms} ms a step "
          f"after the first, loss {losses[0]} -> {losses[-1]}, launches "
          f"{train_launches}, required {required}; {smi}", flush=True)
    if len(losses) != TRAIN_LM_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm: losses {losses}")
    for name, n in required.items():
        if train_launches[name] != n:
            raise AssertionError(f"train_lm: {name} launched "
                                 f"{train_launches[name]} times, not {n}")
    return dict(sweeps=sweeps, parallel=dict(
        wall_s=par_wall, gemms=len(serial), stats=par["stats"]),
        example_gates=gates,
        serve_lm=dict(tok_per_s=tok_s, launches=serve_launches),
        train_lm=dict(ms_per_step=ms, losses=losses,
                      launches=train_launches, required=required),
        seconds=time.perf_counter() - t0)


def later_configs(rec: Record, dev, gen, t0: float) -> dict:
    """Phases 9 to 13: the other dense configs and the MoE family served,
    whisper-base and paligemma-3b served and trained, the MoE family and
    the other dense configs trained.  Returns each phase's results."""
    # phase 9: the other dense configs, one after another: gemma3's head
    # dim 256 also in f32 and through the LSE forward (training's), both
    # windows; the decode at (256, 8), paligemma's group, beside them
    dense = {}
    for arch, n_layers in DENSE_ARCHS.items():
        if arch == "gemma3-12b":
            for dtype in (torch.bfloat16, torch.float32):
                for window in (1024, None):
                    if dtype == torch.float32:
                        check_attention(rec, dev, gen, s=DENSE_PROMPT, d=256,
                                        window=window, dtype=dtype,
                                        main_path=False)
                    check_fwd_lse(rec, dev, gen, BATCH, 16, 8, DENSE_PROMPT,
                                  256, dtype, window=window, main_path=False)
                check_decode(rec, dev, gen, hq=8, hkv=1, s=DENSE_MAX_LEN,
                             d=256, lens=(1, 700, 2049, DENSE_MAX_LEN),
                             dtype=dtype, main_path=False)
        dense[arch] = serve_dense(rec, dev, gen, arch, n_layers)
        print(f"[phase] {arch} served at {time.perf_counter() - t0:.1f}s: "
              f"{dense[arch]['tok_per_s']:.1f} tok/s", flush=True)

    # phase 10: the MoE family at full width and depth, one after another
    moes = {}
    for arch in MOE_ARCHS:
        moes[arch] = serve_dense(rec, dev, gen, arch, 0)
        print(f"[phase] {arch} served at {time.perf_counter() - t0:.1f}s: "
              f"{moes[arch]['tok_per_s']:.1f} tok/s", flush=True)

    # phase 11: whisper-base, then paligemma-3b, at full width and depth
    encdec_vlm = {}
    for arch in ENCDEC_VLM:
        encdec_vlm[arch] = serve_encdec_vlm(rec, dev, gen, arch)
        print(f"[phase] {arch} served at {time.perf_counter() - t0:.1f}s: "
              f"{encdec_vlm[arch]['tok_per_s']:.1f} tok/s", flush=True)

    # phase 12: whisper-base, then paligemma-3b, trained at full width and
    # depth
    encdec_vlm_train = {}
    for arch in ENCDEC_VLM_TRAIN:
        encdec_vlm_train[arch] = train_encdec_vlm(rec, dev, gen, arch)
        print(f"[phase] {arch} trained at {time.perf_counter() - t0:.1f}s: "
              f"{encdec_vlm_train[arch]['ms_per_step']:.1f} ms a step",
              flush=True)

    # phase 13: the MoE family and the other dense configs trained at full
    # width and reduced depth, one after another
    train_configs, seen = {}, set()
    for arch in TRAIN_CONFIGS:
        train_configs[arch] = train_config(rec, dev, gen, arch, seen)
        print(f"[phase] {arch} trained at {time.perf_counter() - t0:.1f}s: "
              f"{train_configs[arch]['ms_per_step']:.1f} ms a step, peak "
              f"{train_configs[arch]['peak_gib']:.2f} GiB", flush=True)
    return dict(dense=dense, moes=moes, encdec_vlm=encdec_vlm,
                encdec_vlm_train=encdec_vlm_train, train_configs=train_configs)


def late_main(out: str, gen_state: str, offset: str) -> None:
    """``chip_smoke.py --late OUT STATE OFFSET``, which ``main`` starts
    after phase 8: phases 9 to 13 (``later_configs``) in a process of
    their own.  A fresh process starts the profiler's clock skew, which
    grows with a process's age (``launch.layers``), from zero again, and
    with it the pause each profiled window takes.  The checks draw from
    the parent's generator, whose state comes as STATE (hex), so they
    draw the inputs the phases drew in the parent's process; the phases'
    times count from OFFSET seconds, the parent's age.  The results, the
    checks, the window counts (``DEVICE_WINDOWS``, ``PROFILER_WINDOWS``)
    and the generator's state at the end go to OUT as JSON."""
    dev = card()
    _build.build_all()              # built by the parent: loads only
    gen = torch.Generator(device=dev)
    gen.set_state(torch.tensor(list(bytes.fromhex(gen_state)),
                               dtype=torch.uint8))
    rec = Record()
    res = later_configs(rec, dev, gen, time.perf_counter() - float(offset))
    Path(out).parent.mkdir(exist_ok=True)
    Path(out).write_text(json.dumps(dict(
        res, cases=rec.cases, device_windows=dict(DEVICE_WINDOWS),
        profiler_windows=dict(PROFILER_WINDOWS),
        gen_state=gen.get_state().numpy().tobytes().hex())))


def late_child(gen, t0: float) -> dict:
    """Runs ``late_main`` in a child on the card, its output on this
    process's, from ``gen``'s state, which it sets to the child's at the
    end; raises unless the child exits 0.  Returns what the child wrote,
    its wall seconds under ``wall_s``."""
    torch.cuda.empty_cache()
    LATE_OUT.unlink(missing_ok=True)
    sys.stdout.flush()
    start = time.perf_counter()
    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--late",
         str(LATE_OUT), gen.get_state().numpy().tobytes().hex(),
         f"{start - t0:.3f}"], cwd=ROOT, timeout=LATE_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - start
    if run.returncode != 0:
        raise AssertionError(f"phases 9-13: exit {run.returncode}")
    late = json.loads(LATE_OUT.read_text())
    LATE_OUT.unlink()
    gen.set_state(torch.tensor(list(bytes.fromhex(late.pop("gen_state"))),
                               dtype=torch.uint8))
    print(f"[phase] phases 9-13 done in a child at "
          f"{time.perf_counter() - t0:.1f}s ({wall:.1f} s wall)", flush=True)
    return dict(late, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 16: the sharded main path, in a one-rank NCCL group under torchrun
# ---------------------------------------------------------------------------

SHARDED_OUT = ROOT / "build" / "sharded_phase.json"
SHARDED_CKPT = ROOT / "build" / "sharded_ckpt"
SHARDED_STEPS = 3          # within the warmup, where the lr is the 6-step
SHARDED_TIMEOUT = 300      # run's too, so phase 4's first losses compare
# qwen3's decode shapes for the collectives: batch 4, 16 heads (the 8 kv
# heads repeated, as the caller does), cache 1024, head dim 128
COLL_B, COLL_H, COLL_S, COLL_D = BATCH, 16, MAX_LEN, 128
COLL_LENS = (1, 300, 777, 1024)


def sharded_main(out_path: str) -> None:
    """``torchrun --standalone --nproc-per-node 1 chip_smoke.py --sharded
    OUT``, which ``sharded_child`` starts after phase 15: the one-rank NCCL
    group and the (1, 1) mesh of ``launch.train --model-axis 1`` (qwen3 at
    full width and depth, phase 4's batches, every counter from 0), its
    last checkpoint restored onto the mesh by ``restore_sharded`` and its
    arrays placed onto one device as ``restore_sharded`` places them (each
    held to the arrays the file holds, bit for bit), the served
    tokens under the launcher, and both collectives at qwen3's decode
    shapes.  Writes what the parent checks to ``out_path``."""
    dev = card()
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.convert import to_reference_layout
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import collectives, sharding
    t0 = time.perf_counter()
    out = {}
    shutil.rmtree(SHARDED_CKPT, ignore_errors=True)
    for fn in KERNEL_FNS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    args = [a if a != str(CKPT_DIR) else str(SHARDED_CKPT) for a in TRAIN_ARGS]
    stats = train.main(args + ["--steps", str(SHARDED_STEPS),
                               "--model-axis", "1", "--accel-target",
                               "none"])
    torch.cuda.synchronize()
    rep = stats["report"]
    out["train"] = dict(losses=rep.losses, step_seconds=rep.step_seconds,
                        ms_per_step=stats["ms_per_step"],
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        launches=stats["launches"], seconds=stats["seconds"])
    print(f"[sharded] at {time.perf_counter() - t0:.1f} s: launch.train on "
          f"a one-rank NCCL mesh: "
          f"{stats['ms_per_step']:.1f} ms per step after the first, peak "
          f"{out['train']['peak_gib']:.2f} GiB, losses {rep.losses}, "
          f"launches {stats['launches']}", flush=True)
    if not dist.is_initialized() or dist.get_backend() != "nccl":
        raise AssertionError("launch.train did not start an NCCL group")
    mesh = mesh_lib.make_host_mesh(1, device_type="cuda")

    # the checkpoint of the last step, restored onto the mesh and onto one
    # device, against its arrays as the file holds them
    cfg = configs.get_config(ARCH)
    with FakeTensorMode():
        model = get_model(cfg, device="cpu")
        params = model.init_params(0)
        state = to_reference_layout(cfg, {"params": params,
                                          "opt": adamw(1e-3).init(params)})
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), state)
    del model, params, state
    ckpt_dir = str(SHARDED_CKPT / cfg.name)
    saved, saved_step, _ = ckpt_lib.load_checkpoint(ckpt_dir, like)
    restored = {}
    for where in ("mesh", "one device"):
        if where == "mesh":
            tree, step, _ = ckpt_lib.restore_sharded(
                ckpt_dir, like, sharding.shardings(like, mesh))
        else:
            # what restore_sharded does after its read, on the arrays
            # already read: the file is read twice in all, not three times
            tree = tree_map(ckpt_lib.store.place_array, saved,
                            tree_map(lambda _: dev, like))
            step = saved_step
        pairs = list(zip(tree_leaves(tree), tree_leaves(saved)))
        same = all(torch.equal(ckpt_lib.store.gathered(a).cpu(), b)
                   for a, b in pairs)
        placed = all(isinstance(a, torch.distributed.tensor.DTensor)
                     == (where == "mesh") for a, _ in pairs)
        restored[where] = dict(step=step, bit_equal=same, placed=placed,
                               leaves=len(pairs))
        print(f"[sharded] at {time.perf_counter() - t0:.1f} s: "
              f"restore_sharded onto {where}: step {step}, "
              f"{len(pairs)} leaves, bit-equal {same}", flush=True)
        del tree, pairs
    out["restore"] = restored
    del saved
    shutil.rmtree(SHARDED_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()

    # the served tokens under the launcher
    for fn in KERNEL_FNS:
        fn.launches = 0
    served = serve.main(SERVE_ARGS + ["--accel-target", "none"])
    print(f"[sharded] at {time.perf_counter() - t0:.1f} s: served",
          flush=True)
    out["serve"] = dict(tokens=[o.tolist() for o in served["outputs"]],
                        launches=served["launches"],
                        tok_per_s=served["tok_per_s"])

    # the collectives on NCCL at one rank
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    g = torch.randn((1024, 2048), generator=gen, device=dev)
    got = collectives.compressed_psum({"g": g}, mesh, "data")["g"]
    scale = g.abs().max() / 127.0 + 1e-12
    want = torch.clamp(torch.round(g / scale), -127, 127) * scale
    psum_err = float((got - want).abs().max())
    q = torch.randn((COLL_B, COLL_H, COLL_D), generator=gen, device=dev)
    k, v = (torch.randn((COLL_B, COLL_H, COLL_S, COLL_D), generator=gen,
                        device=dev) for _ in range(2))
    lens = torch.tensor(COLL_LENS, device=dev, dtype=torch.int32)
    got = collectives.sharded_decode_attention(q, k, v, lens, mesh, "model")
    want = flash_decode_plain(
        q.reshape(COLL_B * COLL_H, 1, COLL_D),
        k.reshape(COLL_B * COLL_H, COLL_S, COLL_D),
        v.reshape(COLL_B * COLL_H, COLL_S, COLL_D), lens,
        kv_heads=COLL_H).reshape(q.shape)
    dec_err, dec_rel = float((got - want).abs().max()), rel_l2(got, want)
    out["collectives"] = dict(
        compressed_psum_max_abs_err=psum_err,
        decode_max_abs_err=dec_err, decode_rel_l2=dec_rel,
        decode_ok=dec_err <= ATTN_F32_ATOL
        and dec_rel <= ATTN_REL_L2[torch.float32])
    print(f"[sharded] at {time.perf_counter() - t0:.1f} s: "
          f"compressed_psum against the int8 round trip of g: "
          f"max_abs_err {psum_err}; sharded_decode_attention (B{COLL_B} "
          f"H{COLL_H} S{COLL_S} D{COLL_D} f32, lens {COLL_LENS}) against "
          f"flash_decode's plain version: max_abs_err {dec_err:.3e} (tol "
          f"{ATTN_F32_ATOL}), rel_l2 {dec_rel:.3e} (tol "
          f"{ATTN_REL_L2[torch.float32]:.1e})", flush=True)
    out["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()


def sharded_child(t0: float, tstats: dict, train_launches: dict,
                  served: dict) -> dict:
    """Phase 16: ``sharded_main`` in a child started through ``torchrun
    --standalone --nproc-per-node 1`` (a fresh NCCL group and profiler
    clock), its output on this process's; then its readings against
    phase 4's unsharded run and phase 3's tokens.  Raises unless the child
    exits 0 and every check passes.  Returns the child's readings."""
    torch.cuda.empty_cache()
    SHARDED_OUT.unlink(missing_ok=True)
    sys.stdout.flush()
    start = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"), "--sharded",
         str(SHARDED_OUT)], cwd=ROOT, timeout=SHARDED_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - start
    if run.returncode != 0:
        raise AssertionError(f"phase 16: exit {run.returncode}")
    res = json.loads(SHARDED_OUT.read_text())
    SHARDED_OUT.unlink()
    tr = res["train"]
    # the losses: bit-equal to phase 4's first steps (one rank runs the
    # same ops on the same whole tensors; its grad norm adds the leaves'
    # sums in the same order)
    base = tstats["report"].losses[:SHARDED_STEPS]
    if tr["losses"] != base:
        raise AssertionError(f"phase 16 losses {tr['losses']} are not "
                             f"phase 4's {base}")
    # the launches: phase 4's for the steps run (its layer report's GEMMs,
    # which phase 16 does not print, left out), so the flash and AdamW
    # kernels ran on the local shards and none fell back
    want = {k: (0 if k == "matmul" else v * SHARDED_STEPS // TRAIN_STEPS)
            for k, v in train_launches.items()}
    if tr["launches"] != want:
        raise AssertionError(f"phase 16 launches {tr['launches']} against "
                             f"phase 4's {want}")
    bad = [w for w, r in res["restore"].items()
           if not (r["bit_equal"] and r["placed"]
                   and r["step"] == SHARDED_STEPS)]
    if bad:
        raise AssertionError(f"restore_sharded onto {bad}: {res['restore']}")
    tokens = [o.tolist() for o in served["outputs"]]
    if res["serve"]["tokens"] != tokens:
        raise AssertionError("launch.serve under torchrun served other "
                             "tokens than phase 3")
    coll = res["collectives"]
    if coll["compressed_psum_max_abs_err"] != 0.0 or not coll["decode_ok"]:
        raise AssertionError(f"collectives: {coll}")
    print(f"[phase] sharded main path done in a torchrun child at "
          f"{time.perf_counter() - t0:.1f}s ({wall:.1f} s wall): losses "
          f"bit-equal to phase 4's {base}, launches {tr['launches']}, "
          f"{tr['ms_per_step']:.1f} ms a step against phase 4's "
          f"{tstats['ms_per_step']:.1f}, peak {tr['peak_gib']:.2f} GiB "
          f"against {tstats['peak_gib']:.2f}; restored bit-equal onto the "
          f"mesh and one device; served tokens equal to phase 3's",
          flush=True)
    return dict(res, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 17: the roofline of the one-card steps
# ---------------------------------------------------------------------------


def roofline_steps(serve_ms: dict, train_ms: dict) -> list[dict]:
    """Phase 17: each step the script times, counted on the CPU on meta
    tensors through the plain path, AdamW's update as the card's fused
    kernels move it (``launch.dryrun.count_step``): phase
    3's prefill and decode step (``serve_ms``), and the train steps of
    phases 4, 8, 12 and 13 at the shapes and depths they train
    (``train_ms``: ms a step by arch).  Prints for each the counted FLOPs
    and HBM bytes, ``roofline.model_flops``, the H100 roofline's ms and
    what bounds it, the measured ms, ``mfu`` = model FLOPs / (measured s x
    ``PEAK_FLOPS``), the roofline's share of the measured time and model
    FLOPs / counted FLOPs (``useful``, the reference table's ratio); raises
    unless every count is positive and every mfu and share lies in (0,
    ``ROOFLINE_MAX``].  No kernel launches and nothing goes to the card."""
    steps = [("serve", ARCH, "prefill", BATCH, PROMPT, 0, 1,
              serve_ms["prefill"]),
             ("serve", ARCH, "decode", BATCH, MAX_LEN, 0, 1,
              serve_ms["decode"]),
             ("phase 4", ARCH, "train", TRAIN_BATCH, TRAIN_SEQ, 0,
              MICROBATCHES, train_ms[ARCH])]
    steps += [("phase 8", arch, "train", SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, 0,
               1, train_ms[arch]) for arch in SSM_ARCHS]
    steps += [("phase 12", arch, "train", b, seq, 0, 1, train_ms[arch])
              for arch, (b, seq, _) in ENCDEC_VLM_TRAIN.items()]
    steps += [("phase 13", arch, "train", b, seq, depth, 1, train_ms[arch])
              for arch, (depth, b, seq, *_) in TRAIN_CONFIGS.items()]
    out = []
    for phase, arch, kind, batch, seq, depth, mb, ms in steps:
        t = time.perf_counter()
        cfg = configs.get_config(arch)
        cfg = cfg.replace(n_layers=depth) if depth else cfg
        rec = count_step(cfg, kind, batch, seq, microbatches=mb,
                         max_len=MAX_LEN)
        # the reference's shapes count a VLM's image prefix in its tokens
        tokens = seq + (cfg.vis_tokens if cfg.family == "vlm" else 0)
        mf = model_flops(cfg, configs.ShapeSpec(kind, kind, tokens, batch),
                         kind)
        rl = roofline_terms(rec)
        rec.update(phase=phase, arch=arch, kind=kind, batch=batch, seq=seq,
                   n_layers=cfg.n_layers, microbatches=mb, model_flops=mf,
                   compute_ms=1e3 * rl.compute_s, memory_ms=1e3 * rl.memory_s,
                   collective_ms=1e3 * rl.collective_s,
                   roofline_ms=1e3 * rl.step_s, bound_by=rl.bottleneck,
                   measured_ms=ms, mfu=mf / (ms * 1e-3 * PEAK_FLOPS),
                   roofline_share=rl.step_s / (ms * 1e-3),
                   useful=mf / rec["flops"],
                   count_s=time.perf_counter() - t)
        print(f"[roofline] {arch} {kind} {batch} x {seq} ({cfg.n_layers} "
              f"layers, {phase}): counted {rec['flops']:.4e} FLOP "
              f"{rec['bytes_accessed']:.4e} B; model {mf:.4e} FLOP; "
              f"roofline {rec['roofline_ms']:.3f} ms ({rl.bottleneck}; "
              f"compute {rec['compute_ms']:.3f}, memory "
              f"{rec['memory_ms']:.3f}); measured {ms:.3f} ms; mfu "
              f"{rec['mfu']:.4f}; share {rec['roofline_share']:.4f}; useful "
              f"{rec['useful']:.3f}; counted in {rec['count_s']:.1f} s",
              flush=True)
        if min(rec["flops"], rec["bytes_accessed"], mf) <= 0 or not (
                0 < rec["mfu"] <= ROOFLINE_MAX
                and 0 < rec["roofline_share"] <= ROOFLINE_MAX):
            raise AssertionError(f"roofline of {arch} {kind}: counts, mfu "
                                 f"or share out of range: {rec}")
        out.append(rec)
    return out


def print_windows(where: str, dw: dict, pw: dict) -> None:
    """The counts of ``device_ms`` and profiler windows of a process."""
    print(f"[profile] device_ms windows over {where}: "
          f"{dw['taken']}, of which {dw['late']} "
          f"taken again as the host fell behind; spin at the end "
          f"{dw['spin_cycles']} cycles; torch.profiler windows: "
          f"{pw['taken']}, of which "
          f"{len(pw['lost'])} lost a marker; pause at the end "
          f"{pw['pause_s']} s", flush=True)
    for w in pw["lost"]:
        print(f"[profile]   lost the {w['marker']} marker of {w['label']} "
              f"after a pause of {w['pause_s']} s, {w['age_s']} s into the "
              f"process", flush=True)


def card() -> torch.device:
    """The card, f32 GEMMs in IEEE f32; exits unless there is one."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card; the port runs on the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 plain GEMMs
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def main() -> None:
    dev = card()

    # phase 1: build
    t0 = time.perf_counter()
    build_s = _build.build_all()
    smi = nvidia_smi_line()
    print(f"[build] {len(_build.SOURCES)} kernels from src/repro_torch/csrc "
          f"in {build_s:.1f}s", flush=True)
    for name in _build.SOURCES:
        log = _build.build_logs.get(name, "")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spilled = spilling(log)
        spills = len(spilled)
        sass = _build.sass_counts(name)
        print(f"[build] {name}: {len(regs)} instantiations, at most "
              f"{max(regs, default=0)} registers a thread, {spills} with "
              f"spills; tensor-core instructions in SASS {sass}", flush=True)
        want = TENSOR_CORE_OPS.get(name, ())
        if want and not any(sass[op] for op in want):
            raise AssertionError(f"{name}: no {' or '.join(want)} in its "
                                 f"SASS: not on the tensor cores")
        bad = [f for f in spilled if name in NO_SPILLS
               and NO_SPILLS[name] in f]
        if bad:
            raise AssertionError(f"{name}: tensor-core kernels spill: {bad}")
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 2: kernel checks
    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rec = Record()
    # the served run's layer report gives the GEMM the decode shapes
    for tokens, label in ((BATCH * PROMPT, "prefill"), (BATCH, "decode")):
        for g in lm_layer_gemms(cfg, tokens):
            check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                       f"{label} {g.name.split('_', 3)[-1]}",
                       main_path=tokens == BATCH)
    check_gemm(rec, dev, gen, 2048, 1024, 1024, torch.float32, "f32",
               main_path=False)
    check_gemm(rec, dev, gen, 2048, 1024, 1024, torch.int8, "s8",
               main_path=False)
    check_attention(rec, dev, gen)
    check_decode(rec, dev, gen)
    print(f"[phase] kernel checks done at {time.perf_counter() - t0:.1f}s",
          flush=True)

    # phase 3: the serve path, counters from 0
    for fn in KERNEL_FNS:
        fn.launches = 0
    stats = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    serve_launches = serve.kernel_launches()
    print(f"[serve] launches on the main path: {serve_launches}", flush=True)
    for name in ("matmul", "flash_attention", "flash_decode"):
        if serve_launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    rel, agree, model, params = compare_paths(cfg, dev)
    prof = profile_batch(model, params)
    serve_ms = time_serve_steps(model, params)
    del model, params
    torch.cuda.empty_cache()
    print(f"[phase] serve done at {time.perf_counter() - t0:.1f}s: "
          f"{stats['tok_per_s']:.1f} tok/s, rel_l2 {rel}", flush=True)

    # phase 4: the train path: its kernels' checks, the step gates, then
    # the main path with counters from 0, then resume
    # the train run's layer report gives the GEMM batch x seq rows
    for g in lm_layer_gemms(cfg, TRAIN_BATCH * TRAIN_SEQ):
        check_gemm(rec, dev, gen, g.tokens, g.n, g.k, torch.bfloat16,
                   f"train {g.name.split('_', 3)[-1]}", main_path=True)
    check_fwd_lse(rec, dev, gen, MB, 16, 8, TRAIN_SEQ, 128, torch.bfloat16,
                  window=None, main_path=True)
    check_bwd(rec, dev, gen, MB, 16, 8, TRAIN_SEQ, 128, torch.bfloat16,
              window=None, main_path=True)
    check_bwd(rec, dev, gen, MB, 16, 8, TRAIN_SEQ, 64, torch.bfloat16,
              window=None, main_path=False)
    check_fwd_lse(rec, dev, gen, 1, 16, 8, 256, 128, torch.float32,
                  window=16, main_path=False)
    check_bwd(rec, dev, gen, 1, 16, 8, 256, 128, torch.float32, window=16,
              main_path=False)
    check_adamw(rec, dev, cfg)
    gates = compare_train_paths(cfg, dev)
    try:
        tstats, train_launches, resumed = train_main_path()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    train_prof = profile_train_step(cfg, dev)
    print(f"[phase] train done at {time.perf_counter() - t0:.1f}s",
          flush=True)

    # phase 5: the SSD chunk scan at both models' prefill shapes (mamba2's
    # SSD sees bf16 inputs, zamba2's f32: its conv runs in f32), and in f32
    # against the sequential oracle
    ssd = [check_ssd(rec, dev, gen, 128, torch.bfloat16, "mamba2"),
           check_ssd(rec, dev, gen, 64, torch.float32, "zamba2")]
    check_ssd_ref(rec, dev, gen)
    print(f"[phase] ssd checks done at {time.perf_counter() - t0:.1f}s",
          flush=True)

    # phases 6 and 7: mamba2-2.7b, then zamba2-2.7b, served at full width
    ssm = {}
    for arch in SSM_ARCHS:
        ssm[arch] = serve_ssm(rec, dev, gen, arch)
        print(f"[phase] {arch} served at {time.perf_counter() - t0:.1f}s: "
              f"{ssm[arch]['tok_per_s']:.1f} tok/s", flush=True)

    # phase 8: the SSM archs trained: their kernels at the train shapes
    # (bf16 SSD inputs, zamba2's attention at head dim 160), the gate step,
    # then launch.train at full width and depth
    ssm_train = {}
    for arch in SSM_ARCHS:
        acfg = configs.get_config(arch)
        ssd.append(check_ssd(rec, dev, gen, acfg.ssm_state, torch.bfloat16,
                             f"{arch[:6]} train", batch=SSM_TRAIN_BATCH,
                             seq=SSM_TRAIN_SEQ))
        if acfg.family == "hybrid":
            hd = 2 * acfg.d_model // acfg.n_heads
            for check in (check_fwd_lse, check_bwd):
                check(rec, dev, gen, SSM_TRAIN_BATCH, acfg.n_heads,
                      acfg.n_kv_heads, SSM_TRAIN_SEQ, hd, torch.bfloat16,
                      window=None, main_path=True)
        gates_a = compare_ssm_train_paths(arch, dev)
        ssm_train[arch] = dict(gates=gates_a, **train_ssm_main_path(arch))
        print(f"[phase] {arch} trained at {time.perf_counter() - t0:.1f}s",
              flush=True)

    # phases 9 to 13 in a child (``late_main``)
    late = late_child(gen, t0)
    rec.cases.extend(late["cases"])
    dense, moes, encdec_vlm, encdec_vlm_train, train_configs = (
        late[k] for k in ("dense", "moes", "encdec_vlm", "encdec_vlm_train",
                          "train_configs"))

    # phase 14: the Covenant compiler on the card
    covenant = covenant_on_card(dev, gen, smi)
    print(f"[phase] covenant compiler done at {time.perf_counter() - t0:.1f}"
          f"s", flush=True)

    # phase 15: the sweep coordinator, compile_many(parallel=N) and the
    # model examples
    sweep = sweeps_on_card(rec, dev, gen, covenant, smi)
    print(f"[phase] sweeps and examples done at "
          f"{time.perf_counter() - t0:.1f}s ({sweep['seconds']:.1f} s)",
          flush=True)

    # phase 16: the sharded main path in a one-rank NCCL group
    sharded = sharded_child(t0, tstats, train_launches, stats)

    # phase 17: the roofline of the one-card steps, counted on the CPU
    t17 = time.perf_counter()
    roofline = roofline_steps(serve_ms, {
        ARCH: tstats["ms_per_step"],
        **{a: r["ms_per_step"] for a, r in (
            *ssm_train.items(), *encdec_vlm_train.items(),
            *train_configs.items())}})
    print(f"[phase] roofline of {len(roofline)} steps done at "
          f"{time.perf_counter() - t0:.1f}s "
          f"({time.perf_counter() - t17:.1f} s)", flush=True)
    print_windows("this process", DEVICE_WINDOWS, PROFILER_WINDOWS)
    print_windows("phases 9-13's child", late["device_windows"],
                  late["profiler_windows"])

    # the kernels line, launches summed over every main path
    paths = [serve_launches, train_launches] + [
        r["launches"] for r in (*ssm.values(), *ssm_train.values(),
                                *dense.values(), *moes.values(),
                                *encdec_vlm.values(),
                                *encdec_vlm_train.values(),
                                *train_configs.values(), *covenant["cli"],
                                sweep["serve_lm"], sweep["train_lm"],
                                sharded["train"], sharded["serve"])]
    launches = {k: sum(p.get(k, 0) for p in paths) for k in KERNELS}
    kernels = []
    for name, meta in KERNELS.items():
        cases = [c for c in rec.cases if c["kernel"] == name]
        main = [c for c in cases if c["main_path"]]
        by_bytes = sum(c["bound_ms"] for c in main
                       if c["bound_by"] == "bytes")
        by_ops = sum(c["bound_ms"] for c in main
                     if c["bound_by"] == "operations")
        lib = [c["library_ms"] for c in main]
        dev_ms = [c["device_ms"] for c in main]
        lib_dev = [c["library_device_ms"] for c in main]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in main),
            ms=sum(c["ms"] for c in main),
            plain_ms=sum(c["plain_ms"] for c in main),
            bound_ms=by_bytes + by_ops,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if None in lib else sum(lib),
            device_ms=None if None in dev_ms else sum(dev_ms),
            library_device_ms=None if None in lib_dev else sum(lib_dev),
            shapes=[c["case"] for c in main], checks=len(cases),
            checks_ok=all(c["ok"] for c in cases)))
    print(json.dumps({"kernels": kernels}), flush=True)
    for c in rec.cases:
        c.pop("kernel", None)
    rep = tstats["report"]
    summary = dict(card=smi, build_s=build_s, serve=dict(
        tok_per_s=stats["tok_per_s"], new_tokens=stats["new_tokens"],
        seconds=stats["seconds"], requests=stats["requests"],
        batch_seconds=stats["batch_seconds"], step_ms=serve_ms),
        compare_rel_l2=rel, argmax_agree=agree, profile=prof, train=dict(
            ms_per_step=tstats["ms_per_step"],
            tokens_per_s=tstats["tokens_per_s"],
            step_seconds=rep.step_seconds, losses=rep.losses,
            peak_gib=tstats["peak_gib"], launches=train_launches,
            resumed_from=resumed["report"].resumed_from,
            resumed_steps=resumed["report"].steps_run, gates=gates,
            profile=train_prof),
        ssd=ssd, ssm=ssm, ssm_train=ssm_train, dense=dense, moe=moes,
        encdec_vlm=encdec_vlm, encdec_vlm_train=encdec_vlm_train,
        train_configs=train_configs, covenant=covenant, sweep=sweep,
        sharded=sharded, roofline=roofline,
        launches=launches, late_wall_s=late["wall_s"],
        device_windows=dict(DEVICE_WINDOWS),
        profiler_windows=dict(PROFILER_WINDOWS),
        late_device_windows=late["device_windows"],
        late_profiler_windows=late["profiler_windows"],
        cases=rec.cases)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--late"]:
        late_main(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--sharded"]:
        sharded_main(sys.argv[2])
    else:
        main()
