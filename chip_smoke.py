"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

``python3 chip_smoke.py`` from the repository root:

1. builds the Hopper kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) and prints the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card, in the
   working dtype, at the shapes the main path gives it, and times kernel,
   plain version and one PyTorch library call with CUDA events;
3. drives the main path through ``repro_torch.launch.serve``: the Covenant
   GEMM report of the model's block GEMMs, then full-width qwen3-0.6b with
   seeded random bf16 weights serving 8 requests (batch 4, prompt 512, 32
   new tokens) with ``--attn kernel``, every launch counter set to 0 just
   before and read just after; then compares the kernel path with the plain
   path on the same weights, and profiles one more batch for the card's
   busy share;
4. prints a ``kernels`` JSON line and, last, the ``ok`` JSON line; the
   per-case details go to ``chiprun_out/chip_smoke.json``.

Every phase raises on failure; there is no CPU fallback.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, flash_decode, flash_decode_plain)
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: E402
from repro_torch.kernels.tiling import (attention_blocks,  # noqa: E402
                                        decode_block_kv, gemm_blocks)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.layers import lm_layer_gemms, mean_ms  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.targets import H100  # noqa: E402

ARCH = "qwen3-0.6b"
BATCH, PROMPT, MAX_NEW, REQUESTS, MAX_LEN = 4, 512, 32, 8, 1024
SERVE_ARGS = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
              str(PROMPT), "--max-new", str(MAX_NEW), "--requests",
              str(REQUESTS), "--max-len", str(MAX_LEN), "--seed", "0",
              "--device", "cuda", "--attn", "kernel"]
U32 = 2.0 ** -24          # f32 unit roundoff
ATTN_BF16_ATOL = 2e-2     # tests/test_kernels.py bf16 attention bound
LOGITS_REL_L2 = 5e-2      # see compare_paths
KERNELS = {
    "matmul": dict(route="cuda", source="src/repro_torch/csrc/matmul.cu",
                   replaces="src/repro/kernels/matmul.py:37"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:147"),
}


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


class Record:
    """Every checked case; ``main_path`` marks the shapes the served run
    gives a kernel, which the ``kernels`` line sums over."""

    def __init__(self):
        self.cases = []

    def add(self, name, case, *, err, ok, tol, ms, plain_ms, bound_ms,
            bound_by, library_ms, main_path):
        self.cases.append(dict(kernel=name, case=case, max_abs_err=err,
                               tol=tol, ok=bool(ok), ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms, main_path=main_path))
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        print(f"[check] {name:15s} {case:44s} max_abs_err={err:.3e} "
              f"(tol {tol}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {case}: max_abs_err {err}, "
                                 f"tolerance {tol}")


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
    ms = mean_ms(lambda: ops.covenant_matmul(a, b), dev, iters)
    plain_ms = mean_ms(lambda: matmul_plain(a, b), dev, iters)
    library_ms = None if dtype == torch.int8 else \
        mean_ms(lambda: torch.matmul(a, b), dev, iters)
    in_dt = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.int8: "i8"}[dtype]
    peak = {"bf16": H100["peak_bf16_flops"], "f32": H100["peak_f32_flops"],
            "i8": H100["peak_i8_ops"]}[in_dt]
    b_ms, b_by = bound(2.0 * m * n * k, peak,
                       (m * k + k * n) * a.element_size() + m * n * 4)
    blocks = "x".join(map(str, gemm_blocks(m, n, k, in_dtype=in_dt)))
    rec.add("matmul", f"{label} {m}x{n}x{k} {in_dt} b{blocks}", err=err,
            ok=ok, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms, main_path=main_path)


def check_attention(rec: Record, dev, gen) -> None:
    b, hq, hkv, s, d = BATCH, 16, 8, PROMPT, 128
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    qf, kf, vf = (q.reshape(b * hq, s, d), k.reshape(b * hkv, s, d),
                  v.reshape(b * hkv, s, d))
    got = ops.covenant_attention(q, k, v, causal=True)
    want = flash_attention_plain(qf, kf, vf, causal=True).reshape(q.shape)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = mean_ms(lambda: ops.covenant_attention(q, k, v, causal=True),
                 dev, 10)
    plain_ms = mean_ms(lambda: flash_attention_plain(qf, kf, vf,
                                                     causal=True), dev, 10)
    library_ms = mean_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), dev, 10)
    pairs = b * hq * s * (s + 1) / 2            # visible (q, k) pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2
    b_ms, b_by = bound(4.0 * pairs * d, H100["peak_bf16_flops"], nbytes)
    bq, bkv = attention_blocks(s, s, d, heads=b * hq)
    rec.add("flash_attention",
            f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal b{bq}x{bkv}", err=err,
            ok=err <= ATTN_BF16_ATOL, tol=ATTN_BF16_ATOL, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=True)


def check_decode(rec: Record, dev, gen) -> None:
    b, hq, hkv, s, d = BATCH, 16, 8, MAX_LEN, 128
    g = hq // hkv
    q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    kv_len = torch.tensor([1, 300, 777, 1024], device=dev, dtype=torch.int32)
    bkv = decode_block_kv(b * hkv, s, d, g)
    got = ops.covenant_decode_attention(q, k, v, kv_len, block_kv=bkv)
    qg, kf, vf = (q.reshape(b * hkv, g, d), k.reshape(b * hkv, s, d),
                  v.reshape(b * hkv, s, d))
    lens = kv_len.repeat_interleave(hkv)
    want = flash_decode_plain(qg, kf, vf, lens).reshape(b, hq, d)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = mean_ms(lambda: ops.covenant_decode_attention(q, k, v, kv_len,
                                                       block_kv=bkv), dev, 50)
    plain_ms = mean_ms(lambda: flash_decode_plain(qg, kf, vf, lens), dev, 50)
    mask = (torch.arange(s, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = mean_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True), dev, 50)
    valid = float(kv_len.sum()) * hkv            # cache rows this data reads
    nbytes = (2 * valid * d + 2 * b * hq * d) * 2 + b * hkv * 4
    b_ms, b_by = bound(4.0 * valid * g * d, H100["peak_bf16_flops"], nbytes)
    rec.add("flash_decode",
            f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} ragged split{bkv}", err=err,
            ok=err <= ATTN_BF16_ATOL, tol=ATTN_BF16_ATOL, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, main_path=True)


# ---------------------------------------------------------------------------
# phase 3: the main path, then kernel path against plain path
# ---------------------------------------------------------------------------


def compare_paths(cfg, dev) -> tuple[dict, object, dict]:
    """Prefill last-token logits and the logits of 4 decode steps fed the
    same tokens, kernel path against plain path, same weights.

    Bound: relative L2 error <= 5e-2.  The two paths differ only inside
    attention, which both compute in f32 and round to bf16 at different
    points; each of the 28 layers adds a relative perturbation of about one
    bf16 rounding (2^-8) to the residual stream, and such independent
    perturbations grow like a random walk, sqrt(28) * 2^-8 ~= 2.1e-2."""
    kmodel = get_model(cfg, device=dev, attn="kernel")
    pmodel = get_model(cfg, device=dev, attn="plain")
    params = kmodel.init_params(1)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (BATCH, PROMPT)),
                           device=dev)
    out = {}
    kc, pc = kmodel.init_cache(BATCH, MAX_LEN), pmodel.init_cache(BATCH,
                                                                 MAX_LEN)
    kl, kc = kmodel.prefill(params, {"tokens": toks}, kc)
    pl, pc = pmodel.prefill(params, {"tokens": toks}, pc)
    steps = [(kl, pl)]
    tok = pl.argmax(-1)
    for _ in range(4):
        kl, kc = kmodel.decode_step(params, tok, kc)
        pl, pc = pmodel.decode_step(params, tok, pc)
        steps.append((kl, pl))
        tok = pl.argmax(-1)
    for i, (a, b) in enumerate(steps):
        rel = float((a - b).norm() / b.norm())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        name = "prefill" if i == 0 else f"decode{i}"
        print(f"[compare] {name}: rel_l2={rel:.3e} (tol {LOGITS_REL_L2}) "
              f"max_abs={float((a - b).abs().max()):.3e} "
              f"max|logit|={float(b.abs().max()):.3e} "
              f"argmax_agree={agree:.2f} finite={bool(torch.isfinite(a).all())}",
              flush=True)
        if not torch.isfinite(a).all() or a.shape != (BATCH, cfg.vocab):
            raise AssertionError(f"{name}: logits not finite of shape "
                                 f"{(BATCH, cfg.vocab)}")
        if rel > LOGITS_REL_L2:
            raise AssertionError(f"{name}: kernel vs plain rel_l2 {rel}")
        out[name] = rel
    return out, kmodel, params


def profile_batch(model, params) -> dict:
    """One batch of the served run (kernel path) under ``torch.profiler``:
    wall ms, the summed device time of its kernels (one stream, so the
    time the card is busy) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, model.cfg.vocab, PROMPT) for _ in range(BATCH)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.serve(model, params, prompts, batch=BATCH, max_new=MAX_NEW,
                    max_len=MAX_LEN)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] one batch under the profiler: wall {wall_ms:.1f} ms, "
          f"device kernels {busy:.1f} ms, busy share {busy / wall_ms:.3f}",
          flush=True)
    for name, ms, calls in rows[:8]:
        print(f"[profile]   {ms:9.2f} ms {calls:6d}x  {name[:80]}", flush=True)
    return dict(wall_ms=wall_ms, device_ms=busy, busy_share=busy / wall_ms,
                top=[dict(kernel=n, ms=m, calls=c) for n, m, c in rows[:8]])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card; the port runs on the "
                         "card only")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 plain GEMMs
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: build
    t0 = time.perf_counter()
    build_s = _build.build_all()
    smi = nvidia_smi_line()
    print(f"[build] {len(_build.SOURCES)} kernels from src/repro_torch/csrc "
          f"in {build_s:.1f}s", flush=True)
    for name, log in _build.build_logs.items():
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        spills = sum(" 0 bytes spill stores" not in ln
                     for ln in log.splitlines() if "spill stores" in ln)
        print(f"[build] {name}: {len(regs)} instantiations, "
              f"{spills} with spills", flush=True)
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

    # phase 3: the main path, counters from 0
    for fn in (matmul, flash_attention, flash_decode):
        fn.launches = 0
    stats = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = serve.kernel_launches()
    print(f"[serve] launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    rel, model, params = compare_paths(cfg, dev)
    prof = profile_batch(model, params)
    print(f"[phase] serve done at {time.perf_counter() - t0:.1f}s: "
          f"{stats['tok_per_s']:.1f} tok/s, rel_l2 {rel}", flush=True)

    # phase 4: the kernels line
    kernels = []
    for name, meta in KERNELS.items():
        cases = [c for c in rec.cases if c["kernel"] == name]
        main = [c for c in cases if c["main_path"]]
        by_bytes = sum(c["bound_ms"] for c in main
                       if c["bound_by"] == "bytes")
        by_ops = sum(c["bound_ms"] for c in main
                     if c["bound_by"] == "operations")
        lib = [c["library_ms"] for c in main]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in main),
            ms=sum(c["ms"] for c in main),
            plain_ms=sum(c["plain_ms"] for c in main),
            bound_ms=by_bytes + by_ops,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if None in lib else sum(lib),
            shapes=len(main), checks=len(cases),
            checks_ok=all(c["ok"] for c in cases)))
    print(json.dumps({"kernels": kernels}), flush=True)
    for c in rec.cases:
        c.pop("kernel", None)
    summary = dict(card=smi, build_s=build_s, serve=dict(
        tok_per_s=stats["tok_per_s"], new_tokens=stats["new_tokens"],
        seconds=stats["seconds"], requests=stats["requests"],
        batch_seconds=stats["batch_seconds"]),
        compare_rel_l2=rel, profile=prof, cases=rec.cases)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
