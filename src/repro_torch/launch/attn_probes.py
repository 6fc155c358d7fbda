"""Probe the bf16 flash backward's exactness and the decode's device time.

    PYTHONPATH=src python -m repro_torch.launch.attn_probes simulate
    PYTHONPATH=src python -m repro_torch.launch.attn_probes bwd
    PYTHONPATH=src python -m repro_torch.launch.attn_probes decode

``simulate`` repeats the backward's arithmetic at qwen3's training shape
(B4 Hq16 Hkv8 S512, causal, unit-normal bf16 inputs) with P and dS entering
the products as one, two or three bf16 parts and the sums in float64, and
prints the share of dq, dk, dv that round to another bf16 value than the
plain f32 version's, beside the same share for an exact operand: the plain
version's own f32 rounding.  It runs on the card if there is one.

``bwd`` (card) runs the tensor-core backward at that shape at D128 and D64
over ten seeds and prints the largest |kernel - plain| once both are
rounded to bf16 (``chip_smoke.py``'s 2e-2 gate) beside the same for
float64 arithmetic rounded to bf16, which no kernel can beat; how many
outputs of 2 or more the kernel and the plain version round to another
bf16 value than float64's; the share of outputs whose bf16 value differs
from the plain version's; and the kernel's device time.

``decode`` (card) prints the decode's device time at the served models'
decode shapes (``DECODE_SHAPES``) over split lengths and kv_len patterns,
beside SDPA's with a mask and one fill kernel's.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.flash_attention import (flash_attention_bwd,
                                       flash_attention_bwd_plain,
                                       flash_attention_fwd_lse_plain)
from ..kernels.tiling import attention_bwd_mma_blocks, decode_block_kv
from .layers import device_ms

TRAIN = dict(b=4, hq=16, hkv=8, s=512)


def bf16_parts(x: torch.Tensor, parts: int) -> torch.Tensor:
    """``x`` as the float64 sum of ``parts`` bf16 values, each rounding
    what the ones before it left out (one part: ``x`` rounded to bf16)."""
    out = torch.zeros_like(x, dtype=torch.float64)
    rest = x.float()
    for _ in range(parts):
        p = rest.bfloat16().float()
        out += p.double()
        rest = rest - p
    return out


def _inputs(d: int, seed: int, device, b, hq, hkv, s):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shapes = ((b * hq, s, d), (b * hkv, s, d), (b * hkv, s, d),
              (b * hq, s, d))
    return [torch.randn(sh, generator=g, device=device).bfloat16()
            for sh in shapes]


def exact_bwd(q, k, v, out, lse, do, *, operand_parts: int | None = None):
    """dq, dk, dv of a causal self attention from the flash residuals, in
    float64; with ``operand_parts`` P and dS enter the three products as
    that many bf16 parts (``bf16_parts``), as the kernel feeds them."""
    bh, s, d = q.shape
    g = bh // k.shape[0]
    q, k, v, out, do = (t.double() for t in (q, k, v, out, do))
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = (q @ k.transpose(1, 2)) * d ** -0.5
    p = torch.where(mask, torch.exp(sc - lse.double()), torch.zeros_like(sc))
    ds = p * (do @ v.transpose(1, 2) - (do * out).sum(-1, keepdim=True)) \
        * d ** -0.5
    if operand_parts is not None:
        p, ds = bf16_parts(p, operand_parts), bf16_parts(ds, operand_parts)
    dk = (ds.transpose(1, 2) @ q).reshape(bh // g, g, s, d).sum(1)
    dv = (p.transpose(1, 2) @ do).reshape(bh // g, g, s, d).sum(1)
    return ds @ k, dk, dv


def _mismatch(got, want) -> list[float]:
    """Share of each of dq, dk, dv whose bf16 value differs."""
    return [float((a.bfloat16() != w.bfloat16()).float().mean())
            for a, w in zip(got, want)]


def simulate(device, d: int = 64, seed: int = 0, shape: dict = TRAIN
             ) -> dict:
    """{operand: [dq, dk, dv] mismatch share against the plain version}
    for P and dS in 1, 2 or 3 bf16 parts and exact, at ``shape`` (b, hq,
    hkv, s)."""
    q, k, v, do = _inputs(d, seed, device, **shape)
    out, lse = flash_attention_fwd_lse_plain(q, k, v)
    plain = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      out.float(), lse, do.float())
    res = {f"{n} part{'s' if n > 1 else ''}": _mismatch(
        exact_bwd(q, k, v, out, lse, do, operand_parts=n), plain)
        for n in (1, 2, 3)}
    res["exact"] = _mismatch(exact_bwd(q, k, v, out, lse, do), plain)
    return res


def bwd(device, seeds: int = 10) -> None:
    for d in (128, 64):
        worst_k = worst_i = 0.0
        fails_k = fails_i = big_k = big_p = big_n = 0
        for seed in range(seeds):
            q, k, v, do = _inputs(d, 100 + seed, device, **TRAIN)
            out, lse = flash_attention_fwd_lse_plain(q, k, v)
            bq, bkv = attention_bwd_mma_blocks(TRAIN["s"], TRAIN["s"], d,
                                               heads=TRAIN["b"] * TRAIN["hq"])
            got = flash_attention_bwd(q, k, v, out, lse, do, block_q=bq,
                                      block_kv=bkv)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do)
            ideal = [t.bfloat16() for t in exact_bwd(q, k, v, out, lse, do)]
            ek = max(float((a.float() - w.float()).abs().max())
                     for a, w in zip(got, want))
            ei = max(float((a.float() - w.float()).abs().max())
                     for a, w in zip(ideal, want))
            worst_k, worst_i = max(worst_k, ek), max(worst_i, ei)
            fails_k, fails_i = fails_k + (ek > 2e-2), fails_i + (ei > 2e-2)
            # outputs of 2 or more whose bf16 value is not float64's
            exact = exact_bwd(q, k, v, out, lse, do)
            big_k += sum(int(((a != e.bfloat16()) & (e.abs() >= 2)).sum())
                         for a, e in zip(got, exact))
            big_p += sum(int(((w != e.bfloat16()) & (e.abs() >= 2)).sum())
                         for w, e in zip(want, exact))
            big_n += sum(int((e.abs() >= 2).sum()) for e in exact)
            if seed == 0:
                f32 = flash_attention_bwd_plain(
                    q.float(), k.float(), v.float(), out.float(), lse,
                    do.float())
                share = _mismatch(got, f32)
        ms = device_ms(lambda: flash_attention_bwd(
            q, k, v, out, lse, do, block_q=bq, block_kv=bkv))
        print(f"bwd D{d} blocks {bq}x{bkv}: over {seeds} seeds the gate's "
              f"worst {worst_k:.4e} (float64 rounded to bf16: "
              f"{worst_i:.4e}), over 2e-2 {fails_k} times (float64: "
              f"{fails_i}); of {big_n} outputs of 2 or more, rounded to "
              f"another bf16 value than float64's: kernel {big_k}, plain "
              f"{big_p}; dq, dk, dv differing from the plain version in "
              f"bf16 (seed 0): {', '.join(f'{x:.3%}' for x in share)}; "
              f"device {ms:.4f} ms", flush=True)


# (B, Hq, Hkv, S, D, kv_len patterns): qwen3's and zamba2's serve shapes,
# then gemma3's local and global caches, stablelm's, command-r's and
# paligemma's group 8
DECODE_SHAPES = (
    (4, 16, 8, 1024, 128, ((1, 300, 777, 1024), (0,) * 4, (1,) * 4,
                           (64,) * 4, (65,) * 4, (1024,) * 4)),
    (4, 32, 32, 2080, 160, ((1, 700, 2049, 2080),)),
    (4, 16, 8, 1024, 256, ((1, 700, 993, 1024), (1024,) * 4)),
    (4, 16, 8, 2080, 256, ((1, 700, 2049, 2080), (2049,) * 4)),
    (4, 32, 8, 2080, 160, ((1, 700, 2049, 2080), (2049,) * 4)),
    (4, 96, 8, 2080, 128, ((1, 700, 2049, 2080), (2049,) * 4)),
    (4, 8, 1, 2080, 256, ((1, 700, 2049, 2080),)))


def decode(device) -> None:
    g = torch.Generator(device=device)
    g.manual_seed(0)
    for (b, hq, hkv, s, d, lens) in DECODE_SHAPES:
        q = torch.randn((b, hq, d), generator=g, device=device).bfloat16()
        k = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
        v = torch.randn((b, hkv, s, d), generator=g, device=device).bfloat16()
        tiler = decode_block_kv(b * hkv, s, d, hq // hkv)
        for ln in lens:
            kv_len = torch.tensor(ln, device=device, dtype=torch.int32)
            mask = (torch.arange(s, device=device)[None, :]
                    < kv_len[:, None])[:, None, None, :]
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
            cells = []
            for bkv in sorted({tiler, 32, 64, 128, 256, 512}):
                us = device_ms(lambda: ops.covenant_decode_attention(
                    q, k, v, kv_len, block_kv=bkv)) * 1e3
                cells.append(f"{bkv}: {us:.1f}")
            print(f"decode B{b} Hq{hq} Hkv{hkv} S{s} D{d} kv_len {ln} "
                  f"(tiler split {tiler}): SDPA {lib * 1e3:.1f} us; by "
                  f"split, us: {', '.join(cells)}", flush=True)
    z = torch.empty(1, device=device)
    print(f"one fill kernel: {device_ms(lambda: z.zero_()) * 1e3:.1f} us",
          flush=True)


def main(argv: list[str] | None = None) -> None:
    mode = (argv if argv is not None else sys.argv[1:] or ["simulate"])[0]
    cuda = torch.cuda.is_available()
    if mode != "simulate" and not cuda:
        raise SystemExit(f"attn_probes {mode}: needs a CUDA card")
    device = torch.device("cuda" if cuda else "cpu")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    if mode == "simulate":
        for d in (128, 64):
            for name, share in simulate(device, d).items():
                print(f"simulate D{d} P and dS as {name}: dq, dk, dv "
                      f"differing from the plain version in bf16: "
                      f"{', '.join(f'{x:.3%}' for x in share)}", flush=True)
    elif mode == "bwd":
        bwd(device)
    elif mode == "decode":
        decode(device)
    else:
        raise SystemExit(f"attn_probes: unknown mode {mode}")


if __name__ == "__main__":
    main()
