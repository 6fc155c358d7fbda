"""Time the bf16 tensor-core GEMM with each stage ring, on the card.

``tiling.gemm_stages`` turns the tiler's blocks into the kernel's ring of
TMA stages.  This script launches ``csrc/matmul.cu`` at the main paths'
largest GEMM shapes, with the tiler's blocks, once for each (stage depth,
stage count) and once with the ring ``gemm_stages`` picks, and prints the
mean milliseconds of each beside ``torch.matmul``'s (CUDA events):

    PYTHONPATH=src python -m repro_torch.launch.gemm_rings
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.matmul import _I, _P
from ..kernels.tiling import gemm_blocks, gemm_stages
from .layers import mean_ms

# qwen3-0.6b's lm_head at train, prefill and decode rows, its train
# ffn_out and qkv, and mamba2-2.7b's decode lm_head
SHAPES = ((4096, 151936, 1024), (2048, 151936, 1024), (4, 151936, 1024),
          (4096, 1024, 3072), (4096, 4096, 1024), (4, 50280, 2560))
RINGS = ((128, 8), (128, 4), (128, 3), (128, 2), (64, 6), (64, 4), (64, 3),
         (64, 2))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_rings: needs a CUDA card")
    dev = torch.device("cuda")
    fn = _build.bind("matmul", "covenant_matmul_bf16",
                     [_P, _P, _P] + [_I] * 7 + [_P])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for m, n, k in SHAPES:
        bm, bn, bk = gemm_blocks(m, n, k, wgmma=True)
        a = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        b = torch.randn((k, n), generator=gen, device=dev).bfloat16()
        c = torch.empty((m, n), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        repeats = 5 if m * n > 1e8 else 50
        cells = []
        for stage_k, stages in RINGS:
            def run():
                _build.check("matmul", fn(
                    a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, bm, bn,
                    stage_k, stages, stream))
            try:
                cells.append(f"{stage_k}x{stages} "
                             f"{mean_ms(run, dev, repeats):.4f}")
            except RuntimeError:   # the ring does not fit shared memory
                cells.append(f"{stage_k}x{stages} -")
        picked = "x".join(map(str, gemm_stages(bm, bn, bk)))
        lib = mean_ms(lambda: torch.matmul(a, b), dev, repeats)
        print(f"{m}x{n}x{k} blocks {bm}x{bn}x{bk} gemm_stages {picked}; "
              f"torch.matmul {lib:.4f} ms; ring ms: " + ", ".join(cells),
              flush=True)


if __name__ == "__main__":
    main()
