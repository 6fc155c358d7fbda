"""Covenant layer compilation for the serving and training stack.

The counterpart of ``repro/launch/layers.py``: ``LayerGemm`` and
``lm_layer_gemms`` give a model's block GEMMs at its real widths, and
``compile_layer_gemms`` compiles each of them through the port's Covenant
compile driver (``repro_torch.compile_many``: the shared content-addressed
cache, optional schedule search and the ``REPRO_TORCH_CACHE_DIR`` store)
against any covenant the port's registry names, derived variants such as
``"dnnweaver@pe=32x32"`` included.  ``layer_report`` prints the
reference's per-GEMM cycle table; against ``h100`` on a card each row also
carries the time of ``ops.covenant_matmul`` at that shape, with the blocks
the tiler picks, beside the covenant's prediction of that time.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import core
from ..core import library
from ..core.codelet import Codelet
from ..core.pipeline import CompileOptions
from ..kernels import ops
from ..kernels.tiling import gemm_blocks
from ..targets import H100


@dataclasses.dataclass(frozen=True)
class LayerGemm:
    """One GEMM workload of an LM block: ``out[tokens, n] += x[tokens, k]
    @ w[k, n]``."""

    name: str
    tokens: int  # rows: batch (decode) or batch*seq (train/prefill)
    n: int
    k: int

    def build(self, in_dtype: str = "i8", acc_dtype: str = "i32") -> Codelet:
        """The GEMM codelet: the reference's i8 one unless asked for
        another dtype (the port's kernels run bf16 with an f32 sum)."""
        return library.gemm(self.tokens, self.n, self.k, name=self.name,
                            in_dtype=in_dtype, acc_dtype=acc_dtype)


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


def compile_layer_gemms(cfg, tokens: int, target: str = "h100",
                        options: CompileOptions | None = None,
                        ) -> list[tuple[LayerGemm, "core.CompiledArtifact"]]:
    """Compile every block GEMM of ``cfg`` through
    ``repro_torch.compile_many`` (shared content-addressed cache, optional
    disk store and search).  ``target`` is any name of the port's registry
    (``core.targets``), derived-variant names included."""
    gemms = lm_layer_gemms(cfg, tokens)
    arts = core.compile_many(gemms, target=target, options=options)
    return list(zip(gemms, arts))


def variant_report(cfg, tokens: int, targets: list[str],
                   options: CompileOptions | None = None) -> str:
    """Per-GEMM cycles across several targets or architecture variants in
    one batched heterogeneous ``compile_many``: the design-space view of a
    serving config."""
    gemms = lm_layer_gemms(cfg, tokens)
    pairs = [(g, t) for t in targets for g in gemms]
    arts = core.compile_many(pairs, options=options)
    width = max(len(g.name) for g in gemms)
    lines = [f"[covenant] {cfg.name} variants, tokens={tokens}"]
    header = "  " + " " * width + "".join(f" {t:>24s}" for t in targets)
    lines.append(header)
    for gi, g in enumerate(gemms):
        row = f"  {g.name:{width}s}"
        for ti in range(len(targets)):
            row += f" {arts[ti * len(gemms) + gi].cycles():24.0f}"
        lines.append(row)
    return "\n".join(lines)


def check_accel_target(ap, name: str) -> None:
    """``ap.error`` (exit 2) unless ``name`` is ``none`` or a target the
    port's registry resolves, derived variants included."""
    if name == "none":
        return
    try:
        core.targets.get_target(name)
    except (KeyError, ValueError) as e:
        ap.error(f"--accel-target {name!r}: {e.args[0]} (a registered "
                 f"name, a derived base@key=value or 'none')")


def predicted_ms(cycles: float) -> float:
    """The ``h100`` covenant's time for ``cycles``: its ACG models one SM,
    so the cycles of one GEMM, spread over the card's SMs, run at the
    tensor cores' clock (``targets.H100``)."""
    return cycles / H100["clock_hz"] / H100["sms"] * 1e3


def layer_report(cfg, tokens: int, target: str = "h100",
                 options: CompileOptions | None = None, *,
                 device: str | torch.device | None = None,
                 seed: int = 0) -> str:
    """The reference's per-GEMM cycle table (its i8 codelets) and the
    driver's cache and store counts.  Against ``h100`` with a CUDA
    ``device``, each row also carries the mean time of
    ``ops.covenant_matmul`` on random bf16 operands at that shape (CUDA
    events around 3 calls after one warm-up) beside the covenant's
    prediction of it (``predicted_ms`` of the same GEMM compiled in bf16
    with an f32 sum), and the tiler's blocks; the total line sums both
    times."""
    pairs = compile_layer_gemms(cfg, tokens, target, options)
    timed = (target == "h100" and device is not None
             and torch.device(device).type == "cuda")
    if timed:
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    width = max(len(g.name) for g, _ in pairs)
    lines = [f"[covenant] {cfg.name} @ {target}, tokens={tokens}"]
    total = pred_total = ms_total = 0.0
    for g, art in pairs:
        cyc = art.cycles()
        total += cyc
        searched = ""
        if art.search is not None:
            searched = f"  search_gain=x{art.search.gain:.2f}"
        shape = f"{g.tokens}x{g.n}x{g.k}"
        row = f"  {g.name:{width}s} {shape:16s} {cyc:14.0f} cyc{searched}"
        if timed:
            a = torch.randn((g.tokens, g.k), generator=gen, device=device,
                            dtype=torch.float32).to(torch.bfloat16)
            b = torch.randn((g.k, g.n), generator=gen, device=device,
                            dtype=torch.float32).to(torch.bfloat16)
            ms = mean_ms(lambda: ops.covenant_matmul(a, b), device, 3)
            pred = predicted_ms(core.compile(
                g.build("bf16", "f32"), target, options).cycles())
            ms_total += ms
            pred_total += pred
            blocks = "x".join(map(str, gemm_blocks(g.tokens, g.n, g.k,
                                                   wgmma=True)))
            row += (f"  bf16 predicted {pred:10.4f} ms  cuda {ms:10.4f} ms"
                    f"  blocks {blocks}")
        lines.append(row)
    stats = core.cache_stats()
    total_row = (f"  {'block total':{width}s} {'':16s} {total:14.0f} cyc  "
                 f"(cache hits={stats['hits']} misses={stats['misses']} "
                 f"store_hits={stats['store_hits']})")
    if timed:
        total_row += (f"  bf16 predicted {pred_total:10.4f} ms  "
                      f"cuda {ms_total:10.4f} ms")
    lines.append(total_row)
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


__all__ = ["DEVICE_WINDOWS", "LayerGemm", "PROFILER_WINDOWS",
           "check_accel_target", "compile_layer_gemms", "device_kernels",
           "device_ms", "layer_report", "lm_layer_gemms", "lost_markers",
           "mean_ms", "predicted_ms", "profile_window", "variant_report"]
