"""Covenant -> Hopper bridge: the paper's Algorithm-1 tiler picks the block
geometry of the port's CUDA kernels.

``gemm_blocks`` runs placement, compute mapping and Algorithm-1 tiling
enumeration with cost-based selection on a GEMM codelet against the ``h100``
covenant (``repro_torch.targets``), as ``repro/kernels/tiling.py`` does
against ``tpu_v5e``.  The TPU's (8, 128) / MXU-128 alignment rule becomes
Hopper's:

* M in multiples of 64 (a warpgroup's rows), or the whole M when M < 64;
* N in multiples of 16;
* K in multiples of 16 for bf16 and f32, 32 for i8 (a 32-byte MMA depth);
* the staged (a, b, acc) tiles fit the SMEM node and the accumulator fits
  the RF node;
* and, since Hopper runs blocks in parallel, a tiling whose grid gives
  every SM two blocks ranks first (``_fill_deficit``).

``attention_blocks`` sizes the flash kernel's (q, kv) tiles through the
equivalent QK^T GEMM, then bounds the flash working set by shared memory;
``attention_bwd_blocks`` shrinks that tiling to the backward kernels'
larger working set; ``decode_block_kv`` is its kv block for the decode
kernel, whose split kv walk is what fills the card when batch x kv heads
is small.  ``ssd_mma_blocks`` sizes the SSD chunk kernel's row and column
blocks the same way, through the equivalent C B^T GEMM of one chunk.

The bf16 GEMM and the bf16 flash forward run on the tensor cores, and their
kernels add rules of their own beside these, which the other kernels do not
inherit: ``gemm_blocks(..., wgmma=True)`` keeps only tilings the wgmma GEMM
can run (``wgmma_fits``: wgmma's N sizes, at most four 64-row consumer
warpgroups, a stage ring of at least two stages, ``gemm_stages``), and
``attention_mma_blocks`` fits the tiler's flash tiling to the mma.sync
forward's 16-row warps, register fragments and bf16 shared memory
(``flash_mma_smem_bytes``), and ``attention_bwd_mma_blocks`` does the same
for the mma.sync backward (``flash_bwd_mma_smem_bytes``,
``flash_bwd_mma_regs``).
"""
from __future__ import annotations

import functools
import math

from ..core import library, scheduler
from ..core.scheduler import enumerate_tilings, plan_operands
from ..targets import H100, h100_acg

WARPGROUP_M = 64
N_UNIT = 16
K_UNIT = {"bf16": 16, "f32": 16, "i8": 32}
_BYTES = {"bf16": 2, "f32": 4, "i8": 1, "i32": 4}


def _acc_dtype(in_dtype: str) -> str:
    return "i32" if in_dtype == "i8" else "f32"


def _round_up(x: int, unit: int) -> int:
    return max(unit, math.ceil(x / unit) * unit)


def _align_score(t: dict[str, int], dims: dict[str, int], k_unit: int) -> tuple:
    """Prefer Hopper-aligned tiles (M by 64, N by 16, K by the MMA depth)."""
    def sc(var, unit):
        v = t.get(var, 1)
        return 0 if v % unit == 0 or v == dims[var] else 1
    return (sc("n", N_UNIT) + sc("k", k_unit) + sc("m", WARPGROUP_M),)


@functools.lru_cache(maxsize=None)
def _budgets() -> tuple[int, int]:
    """(SMEM bytes, RF bytes) one block may stage, read off the covenant."""
    acg = h100_acg()
    return acg.memory("SMEM").capacity_bytes, acg.memory("RF").capacity_bytes


# the wgmma GEMM (csrc/matmul.cu, bf16): the instruction N sizes it is
# built for, its consumer warpgroups of 64 rows each, and its TMA stage ring
# of k slabs, each a whole number of 64-element (128-byte) swizzle rows of A
WGMMA_N = (16, 32, 48, 64, 96, 128, 192, 256)
WGMMA_MAX_WARPGROUPS = 4
GEMM_STAGE_K_UNIT = 64
GEMM_MAX_STAGE_K = 128
GEMM_MAX_STAGES = 8
# shared memory a block keeps beside the ring: 1024 bytes to align the ring
# to the 128-byte swizzle's 1024-byte atom, two mbarriers a stage, and the
# 1 KB the hardware reserves for each block
GEMM_SMEM_RESERVE = 1024 + 16 * GEMM_MAX_STAGES + 1024


def wgmma_rows(bm: int) -> int:
    """Rows of A a block stages and multiplies: whole 64-row warpgroup
    slabs (TMA fills the rows past M with zeros)."""
    return WARPGROUP_M * math.ceil(bm / WARPGROUP_M)


def gemm_stage_bytes(bm: int, bn: int, stage_k: int) -> int:
    """One stage of the ring: the (wgmma_rows(bm), stage_k) A slab and the
    (stage_k, bn) B slab, in bf16."""
    return 2 * stage_k * (wgmma_rows(bm) + bn)


def gemm_stages(bm: int, bn: int, bk: int) -> tuple[int, int]:
    """(stage_k, stages): the wgmma GEMM's ring for the tiler's blocks.  A
    stage is a k slab of the tiler's ``bk`` rounded to whole 64-element
    swizzle rows and cut to at most 128.  Where two such stages fit half
    of the SM's shared memory, the ring takes that half, so two blocks
    share an SM and one's first loads and stores overlap the other's
    products; otherwise it takes all of it, its slabs halved until two
    stages fit.  As many stages as fit the budget, at most 8."""
    smem_b, _ = _budgets()
    half = smem_b // 2 - GEMM_SMEM_RESERVE
    s = min(_round_up(bk, GEMM_STAGE_K_UNIT), GEMM_MAX_STAGE_K)
    if half // gemm_stage_bytes(bm, bn, s) >= 2:
        budget = half
    else:
        budget = smem_b - GEMM_SMEM_RESERVE
        while (s > GEMM_STAGE_K_UNIT
               and budget // gemm_stage_bytes(bm, bn, s) < 2):
            s = _round_up(s // 2, GEMM_STAGE_K_UNIT)
    return s, min(GEMM_MAX_STAGES, budget // gemm_stage_bytes(bm, bn, s))


def wgmma_fits(bm: int, bn: int, bk: int) -> bool:
    """The wgmma GEMM can run these blocks: ``bn`` is an instruction N it is
    built for (wgmma's n <= 256), at most four consumer warpgroups own the
    64-row slabs of ``bm``, their (64, bn) f32 accumulators together fit
    the RF node (the kernel is built for no larger tile: a thread would have
    too few registers), and at least two stages fit shared memory."""
    _, rf_b = _budgets()
    return (bn in WGMMA_N
            and math.ceil(bm / WARPGROUP_M) <= WGMMA_MAX_WARPGROUPS
            and wgmma_rows(bm) * bn * 4 <= rf_b
            and gemm_stages(bm, bn, bk)[1] >= 2)


def gemm_fits(bm: int, bn: int, bk: int, in_dtype: str = "bf16") -> bool:
    """The (a, b, acc) working set fits SMEM and the accumulator fits RF."""
    smem_b, rf_b = _budgets()
    acc = bm * bn * _BYTES[_acc_dtype(in_dtype)]
    staged = (bm * bk + bk * bn) * _BYTES[in_dtype] + acc
    return staged <= smem_b and acc <= rf_b


@functools.lru_cache(maxsize=512)
def gemm_blocks(m: int, n: int, k: int, in_dtype: str = "bf16",
                grid_batch: int = 1, wgmma: bool = False
                ) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) for an (m, n, k) GEMM, chosen by the
    Covenant tiler against the ``h100`` ACG.  ``grid_batch`` GEMMs of this
    shape share the launch grid (heads of an attention).  ``wgmma`` keeps
    only tilings the bf16 tensor-core GEMM can run (``wgmma_fits``)."""
    acg = h100_acg()
    cdlt = library.gemm(m, n, k, in_dtype=in_dtype,
                        acc_dtype=_acc_dtype(in_dtype),
                        name=f"h100gemm_{m}x{n}x{k}")
    scheduler.place_operands(cdlt, acg)
    scheduler.map_compute(cdlt, acg, vectorize=True)
    plans = plan_operands(cdlt, acg)
    cands = enumerate_tilings(cdlt, acg, plans, max_candidates=6000)
    if not cands:
        cands = enumerate_tilings(cdlt, acg, plans, max_candidates=6000,
                                  pad_align=True)
    k_unit = K_UNIT[in_dtype]
    dims = {"m": m, "n": n, "k": k}
    best, best_key = None, None
    for t in cands:
        blocks = _hopper_blocks(t, m, n, k, k_unit)
        if not gemm_fits(*blocks, in_dtype) or (wgmma
                                                 and not wgmma_fits(*blocks)):
            continue
        cost = scheduler.estimate_tiling_cost(cdlt, acg, plans, t)
        key = (_align_score(t, dims, k_unit),
               _fill_deficit(m, n, *blocks, grid_batch), cost)
        if best_key is None or key < best_key:
            best, best_key = blocks, key
    assert best is not None, f"no tiling for GEMM {m}x{n}x{k}"
    return best


def _hopper_blocks(t: dict[str, int], m: int, n: int, k: int,
                   k_unit: int) -> tuple[int, int, int]:
    """A tiling rounded up to Hopper alignment (ops.py pads the problem to
    these multiples)."""
    bm, bn, bk = t.get("m", m), t.get("n", n), t.get("k", k)
    bm = m if m < WARPGROUP_M else min(_round_up(bm, WARPGROUP_M),
                                       _round_up(m, WARPGROUP_M))
    bn = min(_round_up(bn, N_UNIT), _round_up(n, N_UNIT))
    bk = min(_round_up(bk, k_unit), _round_up(k, k_unit))
    return bm, bn, bk


def _fill_deficit(m: int, n: int, bm: int, bn: int, bk: int,
                  grid_batch: int) -> int:
    """Blocks short of two per SM.  The Algorithm-1 cost model counts one
    core's cycles, as on the single-core TPU; Hopper runs the grid's blocks
    in parallel on 132 SMs, so a tiling that leaves SMs idle ranks below
    one that fills them, whatever its single-core cost."""
    blocks = math.ceil(m / bm) * math.ceil(n / bn) * grid_batch
    return max(0, 2 * H100["sms"] - blocks)


def flash_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Shared memory of one flash-attention block, in the kernel's layout
    (``csrc/flash_attention.cu``): f32 q (bq, d+1), k (bkv, d+1) and
    v (bkv, d) tiles, the (bq, bkv+1) logits and three f32 row stats."""
    d = head_dim
    floats = (block_q * (d + 1) + block_kv * (d + 1) + block_kv * d
              + block_q * (block_kv + 1) + 3 * block_q)
    return 4 * floats


# the bf16 tensor-core flash forward (csrc/flash_attention.cu): 16 q rows a
# warp, 2, 4 or 8 warps; the kv tiles, head dims and fragment registers it
# is built for (a pair whose tiles pass one block's shared memory is not:
# at head dim 256, block_kv 128); K and V rows padded by 8 bf16 so ldmatrix
# is free of bank conflicts; up to FLASH_MMA_HOLD_Q_MAX_D a warp holds its q
# fragments in registers, above it reloads them from shared memory
FLASH_MMA_BLOCK_Q = (32, 64, 128)
FLASH_MMA_BLOCK_KV = (32, 64, 128)
FLASH_MMA_HEAD_DIMS = (16, 32, 64, 128, 160, 256)
FLASH_MMA_HOLD_Q_MAX_D = 160
FLASH_MMA_PAD = 8
# of the 255 registers a thread may hold, what the fragments may take; the
# rest holds addresses, masks and the softmax state
FLASH_MMA_FRAG_REGS = 192


def flash_mma_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Shared memory of one block of the bf16 tensor-core flash forward:
    the bf16 q tile and two buffers each of the k and v tiles, every row
    padded by 8 elements."""
    return 2 * (block_q + 4 * block_kv) * (head_dim + FLASH_MMA_PAD)


def flash_mma_regs(block_kv: int, head_dim: int) -> int:
    """32-bit registers a thread holds in fragments: the f32 O accumulator
    (16 x d a warp), the bf16 q fragments where the kernel holds them (head
    dims up to ``FLASH_MMA_HOLD_Q_MAX_D``; above, one k step's fragment at a
    time, counted with the addresses), the f32 scores (16 x block_kv) and
    their bf16 copy, the A operand of P V."""
    q = head_dim // 4 if head_dim <= FLASH_MMA_HOLD_Q_MAX_D else 0
    return head_dim // 2 + q + block_kv // 2 + block_kv // 4


def flash_mma_built(block_q: int, block_kv: int, head_dim: int) -> bool:
    """The bf16 tensor-core forward is built for this block pair and head
    dim: each is one it is built for and its tiles
    (``flash_mma_smem_bytes``) fit one block's shared memory."""
    smem_b, _ = _budgets()
    return (head_dim in FLASH_MMA_HEAD_DIMS and block_q in FLASH_MMA_BLOCK_Q
            and block_kv in FLASH_MMA_BLOCK_KV
            and flash_mma_smem_bytes(block_q, block_kv, head_dim) <= smem_b)


def attention_mma_blocks(seq_q: int, seq_k: int, head_dim: int,
                         heads: int = 1) -> tuple[int, int]:
    """(block_q, block_kv) for the bf16 tensor-core flash forward: the
    Covenant tiler's flash tiling (``attention_blocks``) fitted to the
    kernel's rules.  block_q is 64 or 128 (4 or 8 warps of 16 rows, at
    least a warpgroup's rows; the kernel masks a ragged q edge), block_kv
    one of 32, 64, 128; then both shrink, block_q down to 32, until the
    fragments fit ``FLASH_MMA_FRAG_REGS`` and the bf16 tiles fit half the
    SM's shared memory, so two blocks share an SM and one's copies overlap
    the other's products.  A caller may pass any built pair itself, as the
    reference's tests pass (32, 64)."""
    bq, bkv = attention_blocks(seq_q, seq_k, head_dim, heads=heads)
    bq = FLASH_MMA_BLOCK_Q[-1] if bq >= FLASH_MMA_BLOCK_Q[-1] \
        else WARPGROUP_M
    bkv = max(v for v in FLASH_MMA_BLOCK_KV
              if v <= max(bkv, FLASH_MMA_BLOCK_KV[0]))
    smem_b, _ = _budgets()
    while (flash_mma_smem_bytes(bq, bkv, head_dim) > smem_b // 2 - 1024
           or flash_mma_regs(bkv, head_dim) > FLASH_MMA_FRAG_REGS):
        if bkv > FLASH_MMA_BLOCK_KV[0]:
            bkv //= 2
        elif bq > FLASH_MMA_BLOCK_Q[0]:
            bq //= 2
        else:
            break
    return bq, bkv


def attention_blocks(seq_q: int, seq_k: int, head_dim: int,
                     heads: int = 1) -> tuple[int, int]:
    """(block_q, block_kv) for flash attention: the Covenant tiler sizes the
    q/k tiles via the equivalent QK^T GEMM (m=seq_q, n=seq_k, k=head_dim),
    one per head (``heads`` = batch x heads)."""
    bm, bn, _ = gemm_blocks(seq_q, seq_k, head_dim, grid_batch=heads)
    bq = bm if seq_q >= WARPGROUP_M else seq_q
    bkv = min(_round_up(bn, N_UNIT), _round_up(seq_k, N_UNIT))
    smem_b, rf_b = _budgets()
    # the (bq, d) f32 accumulator lives in registers; the q/k/v tiles and
    # the (bq, bkv) logits in shared memory
    while bq > WARPGROUP_M and bq * head_dim * 4 > rf_b:
        bq //= 2
    while flash_smem_bytes(bq, bkv, head_dim) > smem_b or bq * bkv * 4 > rf_b:
        if bkv > N_UNIT:
            bkv = _round_up(bkv // 2, N_UNIT)
        elif bq > WARPGROUP_M:
            bq //= 2
        else:
            break
    return bq, bkv


def flash_bwd_smem_bytes(block_q: int, block_kv: int, head_dim: int) -> int:
    """Shared memory of one flash-backward block, in the layout of
    ``csrc/flash_attention_bwd.cu`` (both passes): f32 q and dout
    (bq, d+1) tiles, k and v (bkv, d+1) tiles, the (bq, bkv+1) P and dS
    tiles and two f32 row stats (lse, delta)."""
    d = head_dim
    floats = (2 * block_q * (d + 1) + 2 * block_kv * (d + 1)
              + 2 * block_q * (block_kv + 1) + 2 * block_q)
    return 4 * floats


def attention_bwd_blocks(seq_q: int, seq_k: int, head_dim: int,
                         heads: int = 1) -> tuple[int, int]:
    """(block_q, block_kv) for the flash backward: the forward's Covenant
    tiling (``attention_blocks``), shrunk until the backward's working set
    fits: ``flash_bwd_smem_bytes`` in shared memory, and in the register
    budget the dk and dv (bkv, d) f32 accumulators, or dq's (bq, d) held to
    the same half, beside the (bq, bkv) scores tile."""
    bq, bkv = attention_blocks(seq_q, seq_k, head_dim, heads=heads)
    smem_b, rf_b = _budgets()
    while (flash_bwd_smem_bytes(bq, bkv, head_dim) > smem_b
           or 2 * max(bq, bkv) * head_dim * 4 > rf_b
           or 2 * bq * bkv * 4 > rf_b):
        if bkv > N_UNIT and bkv >= bq:
            bkv = _round_up(bkv // 2, N_UNIT)
        elif bq > N_UNIT:
            bq = _round_up(bq // 2, N_UNIT)
        else:
            break
    return bq, bkv


# the bf16 tensor-core flash backward (csrc/flash_attention_bwd.cu): warps
# of 16 rows in both passes (q rows in the dq pass, kv rows in the dkv
# pass), the head dims and blocks it is built for (the head dims the bf16
# backward's tests and the train paths use: 160 zamba2's shared block, 256
# paligemma's and gemma3's; a block pair is built where its tiles fit one
# block's shared memory, at 256 only (64, 64)), and the columns of the
# walked tile a warp holds in registers at once
FLASH_BWD_MMA_HEAD_DIMS = (16, 32, 64, 128, 160, 256)
FLASH_BWD_MMA_BLOCKS = (64, 128)
FLASH_BWD_MMA_SLICE = 32
# of the 255 registers a thread may hold, what the backward's fragments may
# take: it addresses more operand tiles and masks a step than the forward
# (FLASH_MMA_FRAG_REGS)
FLASH_BWD_MMA_FRAG_REGS = 160


def flash_bwd_mma_smem_bytes(block_q: int, block_kv: int,
                             head_dim: int) -> int:
    """Shared memory of one block of the bf16 tensor-core flash backward,
    the larger of its two passes, rows padded by 8 elements: the dq pass
    holds the bf16 q and dout tiles (block_q rows), two buffers each of the
    k and v tiles (block_kv rows) and its rows' f32 delta; the dkv pass
    holds the k and v tiles and two buffers each of the q and dout tiles
    and of their f32 lse and delta."""
    row = 2 * (head_dim + FLASH_MMA_PAD)
    dq = (2 * block_q + 4 * block_kv) * row + 4 * block_q
    dkv = (2 * block_kv + 4 * block_q) * row + 16 * block_q
    return max(dq, dkv)


def flash_bwd_walk_cols(head_dim: int) -> int:
    """Accumulator columns one walk of a backward pass holds (``kWalkCols``
    in csrc/flash_attention_bwd.cu): the whole head dim up to 128, half of
    it above, where each pass walks once per half."""
    return head_dim // 2 if head_dim > 128 else head_dim


def flash_bwd_mma_regs(head_dim: int) -> int:
    """32-bit registers a thread holds in fragments, the larger pass: the
    dkv pass walks its q tiles once for dV and once for dK, so a warp
    holds one f32 (16 x walk columns) accumulator (``flash_bwd_walk_cols``)
    beside the f32 S^T and dP^T tiles of one 32-column slice (16 x 32
    each); the dq pass the same for dQ."""
    return (16 * flash_bwd_walk_cols(head_dim)
            + 2 * 16 * FLASH_BWD_MMA_SLICE) // 32


def attention_bwd_mma_blocks(seq_q: int, seq_k: int, head_dim: int,
                             heads: int = 1) -> tuple[int, int]:
    """(block_q, block_kv) for the bf16 tensor-core flash backward: the
    Covenant tiler's flash tiling (``attention_blocks``) fitted to the
    kernel's rules.  Each is 64 or 128 (4 or 8 warps of 16 rows in the pass
    whose block it is; the kernel masks ragged edges); then the larger
    shrinks until both passes' tiles fit half the SM's shared memory
    (``flash_bwd_mma_smem_bytes``), so two blocks share an SM.  At head dim
    160 (zamba2's shared block) even a (64, 64) block's tiles pass that
    half, and one block holds an SM.  Head dims the kernel is not built
    for raise."""
    if head_dim not in FLASH_BWD_MMA_HEAD_DIMS:
        raise ValueError(f"the bf16 flash backward is built for head dims "
                         f"{FLASH_BWD_MMA_HEAD_DIMS}, not {head_dim}")
    lo, hi = FLASH_BWD_MMA_BLOCKS
    bq, bkv = attention_blocks(seq_q, seq_k, head_dim, heads=heads)
    bq, bkv = (hi if bq >= hi else lo), (hi if bkv >= hi else lo)
    smem_b, _ = _budgets()
    while flash_bwd_mma_smem_bytes(bq, bkv, head_dim) > smem_b // 2 - 1024:
        if bkv > lo and bkv >= bq:
            bkv = lo
        elif bq > lo:
            bq = lo
        else:
            break
    if flash_bwd_mma_smem_bytes(bq, bkv, head_dim) > smem_b:
        raise ValueError(f"the bf16 flash backward's ({bq}, {bkv}) tiles at "
                         f"head dim {head_dim} exceed one block's shared "
                         f"memory ({smem_b} bytes)")
    return bq, bkv


# the decode kernel's shortest kv split: below it a split's fixed work (its
# q load, its partials, its share of the combine) costs more than the
# parallelism it adds (``launch.attn_probes decode``: 32-key splits took
# 1.1 to 1.4 times as long as 64-key ones at the dense configs' shapes,
# 16-key ones twice as long)
DECODE_MIN_BLOCK_KV = 64


def decode_block_kv(rows: int, seq_k: int, head_dim: int,
                    group: int) -> int:
    """kv split length for decode: the QK^T tiling of the ``rows`` (batch x
    kv heads) GEMMs of shape (group, seq_k, head_dim), at least
    ``DECODE_MIN_BLOCK_KV`` keys (or the whole cache, rounded up to 16).
    The decode kernel's grid is (kv splits x rows), so the fill rule is
    what splits the kv walk when batch x kv heads alone would leave SMs
    idle."""
    bkv = attention_blocks(group, seq_k, head_dim, heads=rows)[1]
    return max(bkv, min(DECODE_MIN_BLOCK_KV, _round_up(seq_k, N_UNIT)))


# the SSD chunk scan on the tensor cores (csrc/ssd_scan.cu): row blocks of
# 16 rows a warp, the column blocks it walks, the P slab a block computes,
# and the positions a step of its state kernel takes; operand rows padded
# by 8 bf16 as in the flash kernels
SSD_MMA_BLOCK_L = (64, 128)
SSD_MMA_BLOCK_C = (32, 64)
SSD_MMA_SLAB_P = 64
SSD_MMA_SLAB_N = 128
SSD_MMA_STATE_C = 64


def _ssd_scan_floats(chunk: int) -> int:
    return 2 * _round_up(chunk, 4)


def ssd_mma_smem_bytes(block_l: int, block_c: int, chunk: int, state: int,
                       parts: int = 1) -> int:
    """Shared memory of one block of the SSD intra-chunk kernel, in its
    layout (``csrc/ssd_scan.cu``, ``intra_smem``): the chunk's f32 cumsum
    and dt, then in bf16, ``parts`` parts each (1 for bf16 inputs, 2 for
    f32 ones), the C rows (block_l, N + 8) and two buffers of the B
    (block_c, N + 8) and X (block_c, 64 + 8) tiles, N rounded up to 16."""
    ldn = _round_up(state, 16) + FLASH_MMA_PAD
    ldx = SSD_MMA_SLAB_P + FLASH_MMA_PAD
    return 4 * _ssd_scan_floats(chunk) + 2 * parts * (
        block_l * ldn + 2 * block_c * ldn + 2 * block_c * ldx)


def ssd_state_smem_bytes(chunk: int, state: int, parts: int = 1) -> int:
    """Shared memory of one block of the SSD state kernel (``state_smem``):
    the f32 cumsum and the decay weights of every position its 64-position
    steps read, then two buffers of the B tile (64, min(N, 128) + 8) and
    the X tile (64, 64 + 8), ``parts`` bf16 parts each."""
    nw = min(_round_up(state, 16), SSD_MMA_SLAB_N)
    ldx = SSD_MMA_SLAB_P + FLASH_MMA_PAD
    floats = _round_up(chunk, 4) + _round_up(chunk, SSD_MMA_STATE_C)
    return 4 * floats + 2 * parts * 2 * SSD_MMA_STATE_C * (
        nw + FLASH_MMA_PAD + ldx)


def ssd_mma_blocks(chunk: int, state: int, headdim: int, heads: int = 1,
                   parts: int = 1) -> tuple[int, int]:
    """(block_l, block_c) of the SSD kernel on the tensor cores: the rows of
    a chunk one block computes and the column block it walks them with.
    The Covenant tiler sizes them through the equivalent C B^T GEMM of one
    chunk (m = n = chunk, k = state), one per (batch x head, chunk)
    (``heads``), as ``attention_mma_blocks`` does through QK^T; fitted to
    the built set (block_l 64 or 128, a whole number of 16-row warps;
    block_c 32 or 64), then the column block and the row block shrink until
    the block's tiles (``ssd_mma_smem_bytes``, ``parts`` bf16 parts of each
    operand) fit half the SM's shared memory, so at least two blocks share
    an SM.  A shape whose tiles fit no block raises."""
    bm, bn, _ = gemm_blocks(chunk, chunk, state, grid_batch=heads)
    bl = SSD_MMA_BLOCK_L[-1] if bm >= SSD_MMA_BLOCK_L[-1] \
        else SSD_MMA_BLOCK_L[0]
    bc = SSD_MMA_BLOCK_C[-1] if bn >= SSD_MMA_BLOCK_C[-1] \
        else SSD_MMA_BLOCK_C[0]
    smem_b, _ = _budgets()
    while ssd_mma_smem_bytes(bl, bc, chunk, state, parts) > smem_b // 2 - 1024:
        if bc > SSD_MMA_BLOCK_C[0]:
            bc = SSD_MMA_BLOCK_C[0]
        elif bl > SSD_MMA_BLOCK_L[0]:
            bl = SSD_MMA_BLOCK_L[0]
        else:
            break
    if (ssd_mma_smem_bytes(bl, bc, chunk, state, parts) > smem_b
            or ssd_state_smem_bytes(chunk, state, parts) > smem_b):
        raise ValueError(f"ssd_chunk_scan: chunk {chunk}, state {state} in "
                         f"{parts} part(s) exceed one block's shared memory")
    return bl, bc


__all__ = ["DECODE_MIN_BLOCK_KV", "FLASH_BWD_MMA_BLOCKS", "FLASH_BWD_MMA_FRAG_REGS",
           "FLASH_BWD_MMA_HEAD_DIMS", "FLASH_BWD_MMA_SLICE",
           "FLASH_MMA_BLOCK_KV", "FLASH_MMA_BLOCK_Q", "FLASH_MMA_HEAD_DIMS",
           "FLASH_MMA_HOLD_Q_MAX_D",
           "K_UNIT", "N_UNIT", "WARPGROUP_M", "WGMMA_N", "attention_blocks",
           "attention_bwd_blocks", "attention_bwd_mma_blocks",
           "attention_mma_blocks", "decode_block_kv",
           "flash_bwd_mma_regs", "flash_bwd_mma_smem_bytes",
           "flash_bwd_walk_cols",
           "flash_bwd_smem_bytes", "flash_mma_built", "flash_mma_regs",
           "flash_mma_smem_bytes",
           "flash_smem_bytes", "gemm_blocks", "gemm_fits", "gemm_stage_bytes",
           "gemm_stages", "ssd_mma_blocks", "ssd_mma_smem_bytes",
           "ssd_state_smem_bytes", "wgmma_fits", "wgmma_rows"]
