"""The GEMM workloads of an LM block, through the Covenant GEMM kernel.

The counterpart of ``repro/launch/layers.py``: ``LayerGemm`` and
``lm_layer_gemms`` give a model's block GEMMs at its real widths, and
``layer_report`` runs each of them through ``ops.covenant_matmul`` with the
blocks the tiler picks against the ``h100`` covenant, timing it on the
device.  The reference's report compiles the same GEMMs with its Covenant
compile driver and counts accelerator cycles; that driver, and with it
``compile_layer_gemms`` and ``variant_report``, comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..core import library
from ..core.codelet import Codelet
from ..kernels import ops
from ..kernels.tiling import gemm_blocks


@dataclasses.dataclass(frozen=True)
class LayerGemm:
    """One GEMM workload of an LM block: ``out[tokens, n] += x[tokens, k]
    @ w[k, n]``."""

    name: str
    tokens: int  # rows: batch (decode) or batch*seq (train/prefill)
    n: int
    k: int

    def build(self) -> Codelet:
        return library.gemm(self.tokens, self.n, self.k, name=self.name)


def lm_layer_gemms(cfg, tokens: int, lm_head: bool = True) -> list[LayerGemm]:
    """The GEMM workloads of one transformer block of ``cfg`` (plus the LM
    head) at ``tokens`` rows.  Families without attention (pure SSM) just
    contribute their FFN/head GEMMs."""
    out: list[LayerGemm] = []
    d = cfg.d_model
    tag = cfg.name.replace(".", "_").replace("-", "_")
    if getattr(cfg, "n_heads", 0):
        qkv = (cfg.n_heads + 2 * max(cfg.n_kv_heads, 1)) * cfg.hd
        out.append(LayerGemm(f"{tag}_attn_qkv", tokens, qkv, d))
        out.append(LayerGemm(f"{tag}_attn_out", tokens, d,
                             cfg.n_heads * cfg.hd))
    if getattr(cfg, "d_ff", 0):
        out.append(LayerGemm(f"{tag}_ffn_in", tokens, cfg.d_ff, d))
        out.append(LayerGemm(f"{tag}_ffn_out", tokens, d, cfg.d_ff))
    if lm_head and getattr(cfg, "vocab", 0):
        out.append(LayerGemm(f"{tag}_lm_head", tokens, cfg.vocab, d))
    return out


def layer_report(cfg, tokens: int, *, device: str | torch.device = "cuda",
                 seed: int = 0) -> str:
    """Per-GEMM table: shape, the tiler's blocks and the mean time of
    ``ops.covenant_matmul`` on random bf16 operands (CUDA events on a card,
    the host clock on the CPU; the column names the device)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    gemms = lm_layer_gemms(cfg, tokens)
    width = max(len(g.name) for g in gemms)
    lines = [f"[covenant] {cfg.name} block GEMMs @ h100 tiler, "
             f"tokens={tokens}, {device.type} ms"]
    total = 0.0
    for g in gemms:
        a = torch.randn((g.tokens, g.k), generator=gen, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
        b = torch.randn((g.k, g.n), generator=gen, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
        ms = mean_ms(lambda: ops.covenant_matmul(a, b), device, 3)
        total += ms
        blocks = "x".join(map(str, gemm_blocks(g.tokens, g.n, g.k,
                                               wgmma=True)))
        shape = f"{g.tokens}x{g.n}x{g.k}"
        lines.append(f"  {g.name:{width}s} {shape:18s} blocks {blocks:12s} "
                     f"{ms:10.4f} ms")
    lines.append(f"  {'block total':{width}s} {'':18s} {'':19s}"
                 f"{total:10.4f} ms")
    return "\n".join(lines)


def mean_ms(fn, device: torch.device, repeats: int) -> float:
    """Mean milliseconds of ``fn`` after one warm-up call (which builds a
    kernel on first use): CUDA events on a card, the host clock on the
    CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def device_kernels(prof) -> list[tuple[str, float, int]]:
    """(kernel, device ms, calls) of every kernel a profile saw, largest
    first."""
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])


def device_ms(fn, calls: int = 20, rounds: int = 3,
              empty_windows: int = 5) -> float:
    """Device time of one call of ``fn`` under ``torch.profiler``, as
    chip_smoke.py's profiles read the card's time: over ``calls`` calls,
    after one outside the window, each kernel's mean time a launch times
    its launches a call (its count over ``calls``, rounded, at least one),
    summed over the kernels; the median of ``rounds`` windows.  A window
    sometimes loses kernel records, or holds one from the calls before
    it, so a kernel's count alone would misread the time.  A window that
    lost every record is taken again; after ``empty_windows`` such windows
    this raises.  CUDA events around a loop of host calls (``mean_ms``)
    also count the host's gaps between short kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals = []
    empty = 0
    while len(totals) < rounds:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        if not rows:
            empty += 1
            if empty >= empty_windows:
                raise AssertionError(f"torch.profiler saw no device time "
                                     f"in {empty} windows")
            continue
        totals.append(sum(ms / n * max(1, round(n / calls))
                          for _, ms, n in rows))
    return sorted(totals)[rounds // 2]


__all__ = ["LayerGemm", "device_kernels", "device_ms", "layer_report",
           "lm_layer_gemms", "mean_ms"]
