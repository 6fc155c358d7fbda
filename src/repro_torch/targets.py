"""The ``h100`` covenant: an NVIDIA H100 SXM as an ACG spec.

This is the Hopper counterpart of ``TPU_V5E_SPEC`` (``repro/core/targets.py``),
built with the copied spec builders.  The Covenant Algorithm-1 tiler runs
against it to choose the block geometry of the port's Hopper kernels, as it
runs against ``tpu_v5e`` to choose the Pallas ``BlockSpec``s.

The graph models what one thread block on one streaming multiprocessor (SM)
programs: device memory (HBM) -> shared memory (SMEM) -> registers (RF),
a tensor-core unit (TC) whose GEMM capability has the shape of a warpgroup
MMA, and the SIMT lanes for elementwise work.  Numbers come from NVIDIA's
H100 SXM data sheet and Hopper white paper; the per-cycle edge rates are
derived below the way the ``tpu_v5e`` comment derives its own.
"""
from __future__ import annotations

from .core.acg import ACG
from .core.spec import BINARY, UNARY, acg_spec, scap, scu, sedge, smem, sop

# Hardware constants of one H100 SXM card (data sheet, dense rates).
H100 = dict(
    sms=132,
    peak_bf16_flops=989e12,     # FLOP/s, tensor cores
    peak_i8_ops=1979e12,        # OP/s, tensor cores
    peak_f32_flops=67e12,       # FLOP/s, SIMT lanes (no TF32)
    hbm_bw=3.35e12,             # B/s
    hbm_bytes=80 * 2**30,
    smem_bytes_per_block=232_448,   # 227 KB opt-in dynamic shared memory
    # tensor-core clock implied by the bf16 peak: 132 SMs x 4096 dense bf16
    # FLOP per SM-cycle (4 tensor cores x 512 FMA) -> 1.83 GHz
    clock_hz=989e12 / (132 * 4096),
)

# * HBM -> SMEM: 3.35 TB/s / 132 SMs / 1.83 GHz ~= 13.9 B per SM-cycle =>
#   112 bits per transfer op (bandwidth only drives cost, not correctness).
# * SMEM <-> TC/RF: 32 banks x 4 B = 128 B per cycle => 1024 bits.
# * RF <-> TC/SIMT: a warpgroup's 4 x 32 lanes x 32 bits => 4096 bits.
# * HBM: 32 B sector = data_width 256 bits; a 128 B line is one element.
# * SMEM: 32 banks of 4 B; depth covers the 227 KB a block may opt in to.
# * RF: the accumulator budget of one 256-thread block, 64 of each thread's
#   255 registers (the SM has 256 KB; the rest holds addresses and operands).
# * TC: warpgroup MMA, 64 rows x up to 256 columns, k16 for bf16 (k32 for
#   i8); 64*256*16 MACs at 2048 bf16 MAC per SM-cycle = 128 cycles.
# * SIMT: 128 FP32 lanes per SM.
H100_SPEC = acg_spec(
    "h100",
    memories=[
        smem("HBM", data_width=256, banks=4,
             depth=(80 * 2**30) // 128, offchip=True),
        smem("SMEM", data_width=32, banks=32, depth=232_448 // 128),
        smem("RF", data_width=32, banks=32, depth=(256 * 64 * 4) // 128),
    ],
    computes=[
        scu("TC", [
            scap("GEMM", sop("f32", 64, 256),
                 [sop("bf16", 64, 16), sop("bf16", 16, 256),
                  sop("f32", 64, 256)],
                 cycles=128, geometry=(64, 256, 16)),
            scap("MAC", sop("f32", 64, 256),
                 [sop("bf16", 64, 16), sop("bf16", 16, 256),
                  sop("f32", 64, 256)],
                 cycles=128, geometry=(64, 256, 16)),
            scap("MMUL", sop("f32", 64, 256),
                 [sop("bf16", 64, 16), sop("bf16", 16, 256)],
                 cycles=128, geometry=(64, 256, 16)),
            scap("GEMM", sop("i32", 64, 256),
                 [sop("i8", 64, 32), sop("i8", 32, 256),
                  sop("i32", 64, 256)],
                 cycles=128, geometry=(64, 256, 32)),
        ], slot="tc"),
        scu("SIMT", [
            *(scap(n, sop("f32", 128), [sop("f32", 128)] * 2)
              for n in BINARY),
            *(scap(n, sop("f32", 128), [sop("f32", 128)]) for n in UNARY),
            scap("MAC", sop("f32", 128), [sop("f32", 128)] * 3,
                 geometry=(1, 128, 1)),
            *(scap(n, sop("i32", 128), [sop("i32", 128)] * 2)
              for n in BINARY),
        ], slot="simt"),
    ],
    edges=[
        sedge("HBM", "SMEM", bandwidth=112, bidir=True),
        sedge("SMEM", "TC", bandwidth=1024),
        sedge("SMEM", "RF", bandwidth=1024, bidir=True),
        sedge("RF", "TC", bandwidth=4096, bidir=True),
        sedge("RF", "SIMT", bandwidth=4096, bidir=True),
    ],
    # wgmma reads A and B from shared memory and keeps the sum in registers
    operand_ports={
        ("TC", "GEMM"): ("SMEM", "SMEM", "RF"),
        ("TC", "MAC"): ("SMEM", "SMEM", "RF"),
        ("TC", "MMUL"): ("SMEM", "SMEM", "RF"),
    },
    addr_bits=32,
)


def h100_acg() -> ACG:
    return ACG.from_spec(H100_SPEC)


__all__ = ["H100", "H100_SPEC", "h100_acg"]
