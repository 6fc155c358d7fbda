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


# Kineto keeps a profile's GPU records only where their timestamps, moved
# onto the host's clock, fall inside the profile's window.  On the H100
# host that clock lags the host's by a skew that grows over a process's
# life: 4-10 ms in its first minute and, in chip_smoke.py, past a window's
# length by minute 7, past 0.4 s on another host, and past 3.2 s by minute
# 8 in a run that opened few windows; a window's records then read as
# before it opened and were dropped (PERF.md section 6).
# ``device_ms`` therefore times with CUDA events and no profiler.
# ``profile_window`` keeps the profiler for what only it sees (which
# kernels ran): it brackets the work with two marker kernels and takes a
# window again, after a longer pause on the host, until both show.
# ``DEVICE_WINDOWS`` and ``PROFILER_WINDOWS`` count the windows each opened
# in this process and those taken again, and hold what later windows keep.
SPIN_CYCLES = 1 << 23          # about 4 ms of the card's clock
PROFILE_PAUSE_S = 0.2
MARKER = "spin_kernel"          # the kernel of torch.cuda._sleep
DEVICE_WINDOWS = {"taken": 0, "late": 0, "spin_cycles": SPIN_CYCLES}
PROFILER_WINDOWS = {"taken": 0, "lost": [], "pause_s": PROFILE_PAUSE_S}
_BORN = time.perf_counter()


def device_ms(fn, calls: int = 20, rounds: int = 3,
              late_windows: int = 5) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    calls that the host queues while a spin kernel holds the stream, so
    the card runs them back to back and never waits on the host; the
    median of ``rounds`` windows, after one call outside them.  A window
    whose spin ended before the host had queued every call (its start
    event already reached) may hold the host's gaps: it is taken again
    with a spin twice as long, which later windows keep; after
    ``late_windows`` such windows this raises (``fn`` may wait on the
    card).  The time counts the card's gaps between a call's kernels;
    CUDA events around a loop of host calls (``mean_ms``) also count the
    host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    late = 0
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(DEVICE_WINDOWS["spin_cycles"])
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        DEVICE_WINDOWS["taken"] += 1
        if ahead:
            times.append(start.elapsed_time(end) / calls)
            continue
        DEVICE_WINDOWS["late"] += 1
        DEVICE_WINDOWS["spin_cycles"] *= 2
        late += 1
        if late >= late_windows:
            spin = DEVICE_WINDOWS["spin_cycles"] // 2
            raise AssertionError(
                f"no device time free of the host's gaps in {late} windows: "
                f"the card finished a spin of {spin} cycles before the host "
                f"had queued {calls} calls")
    return sorted(times)[rounds // 2]


def lost_markers(prof) -> str:
    """Which of a profiled window's two marker kernels, the first and the
    last of its kernels, its records lost: "", "first", "last" or
    "both"."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks = [MARKER in e.name for e in kernels]
    first = bool(marks) and marks[0]
    last = bool(marks) and marks[-1] and sum(marks) - first >= 1
    return {(True, True): "", (False, True): "first", (True, False): "last",
            (False, False): "both"}[(first, last)]


def profile_window(fn, label: str, tries: int = 8
                   ) -> tuple[list[tuple[str, float, int]], float]:
    """(``device_kernels`` rows, wall ms) of one call of ``fn`` under
    ``torch.profiler``, the two marker kernels left out.  The window pauses
    on the host, launches a marker, runs ``fn``, launches a marker and
    waits for the card.  A window that lost either marker lost records (a
    skew read the first as before the window opened): it is taken again
    after a pause twice as long, which later windows keep, and noted in
    ``PROFILER_WINDOWS["lost"]`` (which marker, the pause, the process's
    age).  Raises after ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        pause = PROFILER_WINDOWS["pause_s"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            torch.cuda._sleep(1)
            t0 = time.perf_counter()
            fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        PROFILER_WINDOWS["taken"] += 1
        lost = lost_markers(prof)
        if not lost:
            return ([r for r in device_kernels(prof) if MARKER not in r[0]],
                    wall_ms)
        PROFILER_WINDOWS["lost"].append(dict(
            label=label, marker=lost, pause_s=pause,
            age_s=round(time.perf_counter() - _BORN, 1)))
        PROFILER_WINDOWS["pause_s"] = 2 * pause
    raise AssertionError(f"torch.profiler lost records of {label} in "
                         f"{tries} windows")


__all__ = ["DEVICE_WINDOWS", "LayerGemm", "PROFILER_WINDOWS", "device_kernels",
           "device_ms", "layer_report", "lm_layer_gemms", "lost_markers",
           "mean_ms", "profile_window"]
