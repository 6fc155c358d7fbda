"""Probe the bf16 flash backward's exactness and the decode's device time.

    PYTHONPATH=src python -m repro_torch.launch.attn_probes simulate
    PYTHONPATH=src python -m repro_torch.launch.attn_probes bwd
    PYTHONPATH=src python -m repro_torch.launch.attn_probes decode

``simulate`` repeats the backward's arithmetic at qwen3's training shape
(B4 Hq16 Hkv8 S512, causal, unit-normal bf16 inputs) with P and dS entering
the products as one, two or three bf16 parts and the sums in float64, and
prints the share of dq, dk, dv that round to another bf16 value than the
plain f32 version's, beside the same share for an exact operand: the plain
version's own f32 rounding.  Then, at the train shapes of the encoder-
decoder and VLM families and gemma3 (``BWD_SHAPES``), it repeats the
kernel's order of sums (``kernel_order``): each 16-deep k step's products
exactly, rounded to f32, added to the accumulator in f32 plainly or with
the kernel's compensated add; and prints, for dq, dk and dv, how many
outputs reach 4 (where one bf16 ulp passes the 2e-2 gate), how many of them
each order and the plain version round to another bf16 value than float64
arithmetic, and how many outputs each order puts past the gate against
the plain version.  It runs on the card if there is one.

``bwd`` (card) runs the tensor-core backward at qwen3's training shape at
D128 and D64 over ten seeds, and at ``BWD_SHAPES`` over two, and prints
the largest |kernel - plain| once both are rounded to bf16
(``chip_smoke.py``'s 2e-2 gate) beside the same for float64 arithmetic
rounded to bf16, which no kernel can beat; how many outputs of 2 or more
the kernel and the plain version round to another bf16 value than
float64's; the share of outputs whose bf16 value differs from the plain
version's; and the kernel's device time.

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
# the bf16 backward's train shapes beside qwen3's: paligemma-3b (batch 4,
# 8 q heads over one kv head of 256, image prefix 256 + text 256, causal),
# whisper-base (batch 8, 8 heads of 64: the non-causal encoder over 1500
# frames, the decoder's 448 tokens across them, its causal self attention)
# and gemma3-12b (batch 4, 16 q / 8 kv heads of 256, 2048 tokens, its
# local window and its global layers)
BWD_SHAPES = {
    "paligemma S512 D256 g8": dict(b=4, hq=8, hkv=1, sq=512, sk=512, d=256),
    "whisper encoder S1500": dict(b=8, hq=8, hkv=8, sq=1500, sk=1500, d=64,
                                  causal=False),
    "whisper cross 448x1500": dict(b=8, hq=8, hkv=8, sq=448, sk=1500, d=64,
                                   causal=False),
    "whisper decoder S448": dict(b=8, hq=8, hkv=8, sq=448, sk=448, d=64),
    "gemma3 S2048 D256 w1024": dict(b=4, hq=16, hkv=8, sq=2048, sk=2048,
                                    d=256, window=1024),
    "gemma3 S2048 D256": dict(b=4, hq=16, hkv=8, sq=2048, sk=2048, d=256),
}
_ORDERS = (("order", "plain adds"), ("compensated", "compensated adds"),
           ("plain", "the plain version"))
BIG = 4.0   # |output| from which one bf16 ulp (2^-5) passes the 2e-2 gate
GATE = 2e-2


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


def _inputs(d: int, seed: int, device, b, hq, hkv, s, sk=None):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sk = s if sk is None else sk
    shapes = ((b * hq, s, d), (b * hkv, sk, d), (b * hkv, sk, d),
              (b * hq, s, d))
    return [torch.randn(sh, generator=g, device=device).bfloat16()
            for sh in shapes]


def _mask(sq, sk, causal, window, device) -> torch.Tensor:
    """The (Sq, Sk) mask of the model's attention: q row 0 at kv position
    Sk - Sq, as ``ops.covenant_attention`` hands it to the backward."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _p_ds(q, k, v, out, lse, do, causal=True, window=None):
    """float64 P and dS (BH, Sq, Sk) of the flash residuals, and the
    float64 q, dout and the repeated k, v they were made from."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    g = bh // k.shape[0]
    q, k, v, out, do = (t.double() for t in (q, k, v, out, do))
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    mask = _mask(sq, sk, causal, window, q.device)
    sc = (q @ k.transpose(1, 2)) * d ** -0.5
    p = torch.where(mask, torch.exp(sc - lse.double()), torch.zeros_like(sc))
    ds = p * (do @ v.transpose(1, 2) - (do * out).sum(-1, keepdim=True)) \
        * d ** -0.5
    return p, ds, q, k, do


def exact_bwd(q, k, v, out, lse, do, *, operand_parts: int | None = None,
              causal: bool = True, window: int | None = None):
    """dq, dk, dv of an attention from the flash residuals, in float64 (the
    model's mask, q row 0 at kv position Sk - Sq); with ``operand_parts``
    P and dS enter the three products as that many bf16 parts
    (``bf16_parts``), as the kernel feeds them."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    p, ds, q, k, do = _p_ds(q, k, v, out, lse, do, causal, window)
    if operand_parts is not None:
        p, ds = bf16_parts(p, operand_parts), bf16_parts(ds, operand_parts)
    dk = (ds.transpose(1, 2) @ q).reshape(bkv, g, sk, d).sum(1)
    dv = (p.transpose(1, 2) @ do).reshape(bkv, g, sk, d).sum(1)
    return ds @ k, dk, dv


def _f32_walk(chunks, compensated: bool) -> torch.Tensor:
    """The kernel's sum of float64 k-step chunks: each rounded to f32 (its
    products go into a fragment from zero), then added to the f32
    accumulator, plainly or as ``add_compensated`` does (Fast2Sum, what
    each add rounds away gathered in a bf16 pair), the pair's sum read at
    the end."""
    acc = cmp = None
    for t64 in chunks:
        t = t64.float()
        if acc is None:
            acc, cmp = torch.zeros_like(t), torch.zeros_like(t)
        if compensated:
            s = acc + t
            cmp = (cmp + (t - (s - acc))).bfloat16().float()
            acc = s
        else:
            acc = acc + t
    return acc + cmp


def kernel_order(q, k, v, out, lse, do, *, causal=True, window=None,
                 rows: int = 4) -> dict:
    """{"exact", "plain", "order", "compensated": [dq, dk, dv]}: float64
    arithmetic, the plain f32 version, and the kernel's order of sums
    (``_f32_walk`` over 16-deep k steps: dq over the kv positions in
    order; dk and dv over the group's q heads, each over its q rows in
    order) with plain and with compensated adds.  The chunks themselves
    are exact (P and dS in three bf16 parts, ``simulate``), so this isolates
    the accumulation.  ``rows`` kv heads at a time bound the memory."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    res = {n: [[], [], []] for n in ("exact", "order", "compensated")}
    for r0 in range(0, bkv, rows):
        sl = slice(r0 * g, min(r0 + rows, bkv) * g)
        kv = slice(r0, min(r0 + rows, bkv))
        p, ds, q64, k64, do64 = _p_ds(q[sl], k[kv], v[kv], out[sl], lse[sl],
                                      do[sl], causal, window)
        n = p.shape[0] // g
        res["exact"][0].append(ds @ k64)
        res["exact"][1].append((ds.transpose(1, 2) @ q64)
                               .reshape(n, g, sk, d).sum(1))
        res["exact"][2].append((p.transpose(1, 2) @ do64)
                               .reshape(n, g, sk, d).sum(1))
        dq_chunks = [ds[:, :, c:c + 16] @ k64[:, c:c + 16]
                     for c in range(0, sk, 16)]
        p4, ds4 = (t.reshape(n, g, sq, sk) for t in (p, ds))
        q4, do4 = (t.reshape(n, g, sq, d) for t in (q64, do64))

        def walk(a, b):
            return (a[:, h, i:i + 16].transpose(1, 2) @ b[:, h, i:i + 16]
                    for h in range(g) for i in range(0, sq, 16))

        for name, comp in (("order", False), ("compensated", True)):
            res[name][0].append(_f32_walk(dq_chunks, comp))
            res[name][1].append(_f32_walk(walk(ds4, q4), comp))
            res[name][2].append(_f32_walk(walk(p4, do4), comp))
        del p, ds, dq_chunks, p4, ds4
    out_ = {n: [torch.cat(x) for x in v_] for n, v_ in res.items()}
    plain = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(),
        causal=causal, window=window, q_offset=sk - sq)
    out_["plain"] = list(plain)
    return out_


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), float64."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_gate(got, want_f32, atol: float = 2e-2) -> tuple[float, bool]:
    """The bf16 attention gate: every element of ``got`` (a tensor, or a
    list of them) within max(``atol``, one bf16 ulp of |``want_f32``|) of
    ``want_f32``, the plain version computed in f32 on the same bf16
    inputs.  Below magnitude 4 an ulp is 2^-6 or less, so ``atol`` (the
    reference's 2e-2) holds; from 4 to 8 one ulp is 2^-5, where 2e-2 is
    under the output's resolution.  Returns (the largest |got -
    want_f32|, whether every element passes)."""
    if isinstance(got, torch.Tensor):
        got, want_f32 = [got], [want_f32]
    if len(got) != len(want_f32):
        raise ValueError(f"{len(got)} outputs against {len(want_f32)}")
    worst, ok = 0.0, True
    for g, w in zip(got, want_f32):
        w = w.float()
        err = (g.float() - w).abs()
        worst = max(worst, float(err.max()))
        ok = ok and bool((err <= torch.clamp(_ulp_bf16(w), min=atol)).all())
    return worst, ok


def order_counts(res: dict) -> dict:
    """{"big": [n], name: {"flips", "expected", "gate", "gate_expected"}}
    for dq, dk, dv: the outputs of at least ``BIG``; of those, the ones
    each sum rounds to another bf16 value than float64's, and the number
    expected to (each output's |sum - float64| over one bf16 ulp there:
    the chance that a rounding midpoint lies between them); then every
    output whose bf16 value each sum puts more than ``GATE`` from the
    plain version's, and the number of outputs of at least ``BIG``
    expected to (|sum - plain| over one ulp)."""
    exact = res["exact"]
    big = [t.abs() >= BIG for t in exact]
    ulp = [_ulp_bf16(t) for t in exact]
    plain = res["plain"]
    out = {"big": [int(m.sum()) for m in big]}
    for name in ("order", "compensated", "plain"):
        got = res[name]
        out[name] = dict(
            flips=[int(((a.bfloat16() != e.bfloat16()) & m).sum())
                   for a, e, m in zip(got, exact, big)],
            expected=[float(((a.double() - e).abs() / u)[m].sum())
                      for a, e, u, m in zip(got, exact, ulp, big)],
            gate=[int((a.bfloat16().float() - w.bfloat16().float())
                      .abs().gt(GATE).sum()) for a, w in zip(got, plain)],
            gate_expected=[float(((a.double() - w.double()).abs() / u)[m]
                                 .sum())
                           for a, w, u, m in zip(got, plain, ulp, big)])
    return out


def _arm(counts: dict, key: str, name: str, seen: str, expected: str
         ) -> str:
    """One arm of ``order_counts`` as printed: its counts, then what was
    expected of them."""
    exp = ", ".join(f"{x:.3f}" for x in counts[key][expected])
    return f"{name} {counts[key][seen]} ({exp})"


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


def _shape_inputs(shape: dict, seed: int, device):
    """bf16 inputs and the plain forward's residuals at a ``BWD_SHAPES``
    entry: (q, k, v, out, lse, dout, causal, window)."""
    causal, window = shape.get("causal", True), shape.get("window")
    q, k, v, do = _inputs(shape["d"], seed, device, shape["b"], shape["hq"],
                          shape["hkv"], shape["sq"], shape["sk"])
    out, lse = flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                             window=window)
    return q, k, v, out, lse, do, causal, window


def simulate_order(device, name: str, seed: int = 0) -> dict:
    """``order_counts`` of ``kernel_order`` at ``BWD_SHAPES[name]``."""
    q, k, v, out, lse, do, causal, window = _shape_inputs(
        BWD_SHAPES[name], seed, device)
    return order_counts(kernel_order(q, k, v, out, lse, do, causal=causal,
                                     window=window))


def _bwd_case(label, seeds, make, blocks, causal=True, window=None):
    """``bwd``'s readings over ``seeds`` draws of ``make(seed)`` (q, k, v,
    out, lse, dout) with the backward's ``blocks``."""
    worst_k = worst_i = 0.0
    fails_k = fails_i = big_k = big_p = big_n = 0
    for seed in range(seeds):
        q, k, v, out, lse, do = make(seed)
        sk, sq = k.shape[1], q.shape[1]
        kw = dict(causal=causal, window=window, q_offset=sk - sq)
        bq, bkv = blocks
        got = flash_attention_bwd(q, k, v, out, lse, do, block_q=bq,
                                  block_kv=bkv, **kw)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        exact = exact_bwd(q, k, v, out, lse, do, causal=causal,
                          window=window)
        ideal = [t.bfloat16() for t in exact]
        ek = max(float((a.float() - w.float()).abs().max())
                 for a, w in zip(got, want))
        ei = max(float((a.float() - w.float()).abs().max())
                 for a, w in zip(ideal, want))
        worst_k, worst_i = max(worst_k, ek), max(worst_i, ei)
        fails_k, fails_i = fails_k + (ek > GATE), fails_i + (ei > GATE)
        # outputs of 2 or more whose bf16 value is not float64's
        big_k += sum(int(((a != e.bfloat16()) & (e.abs() >= 2)).sum())
                     for a, e in zip(got, exact))
        big_p += sum(int(((w != e.bfloat16()) & (e.abs() >= 2)).sum())
                     for w, e in zip(want, exact))
        big_n += sum(int((e.abs() >= 2).sum()) for e in exact)
        if seed == 0:
            f32 = flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), out.float(), lse,
                do.float(), **kw)
            share = _mismatch(got, f32)
        del exact, ideal, want
    ms = device_ms(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, block_q=bq, block_kv=bkv, **kw))
    print(f"bwd {label} blocks {bq}x{bkv}: over {seeds} seeds the gate's "
          f"worst {worst_k:.4e} (float64 rounded to bf16: "
          f"{worst_i:.4e}), over 2e-2 {fails_k} times (float64: "
          f"{fails_i}); of {big_n} outputs of 2 or more, rounded to "
          f"another bf16 value than float64's: kernel {big_k}, plain "
          f"{big_p}; dq, dk, dv differing from the plain version in "
          f"bf16 (seed 0): {', '.join(f'{x:.3%}' for x in share)}; "
          f"device {ms:.4f} ms", flush=True)


def bwd(device, seeds: int = 10, shape_seeds: int = 2) -> None:
    for d in (128, 64):
        def make(seed, d=d):
            q, k, v, do = _inputs(d, 100 + seed, device, **TRAIN)
            out, lse = flash_attention_fwd_lse_plain(q, k, v)
            return q, k, v, out, lse, do

        blocks = attention_bwd_mma_blocks(TRAIN["s"], TRAIN["s"], d,
                                          heads=TRAIN["b"] * TRAIN["hq"])
        _bwd_case(f"D{d}", seeds, make, blocks)
    for name, shape in BWD_SHAPES.items():
        def make(seed, shape=shape):
            return _shape_inputs(shape, 100 + seed, device)[:6]

        blocks = attention_bwd_mma_blocks(shape["sq"], shape["sk"],
                                          shape["d"],
                                          heads=shape["b"] * shape["hq"])
        _bwd_case(name, shape_seeds, make, blocks,
                  causal=shape.get("causal", True),
                  window=shape.get("window"))


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
    argv = argv if argv is not None else sys.argv[1:] or ["simulate"]
    mode = argv[0]
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
        for name in BWD_SHAPES:
            c = simulate_order(device, name)
            print(f"order {name}: dq, dk, dv outputs of {BIG:g} or more "
                  f"{c['big']}; rounded to another bf16 value than "
                  f"float64's (expected): "
                  + "; ".join(_arm(c, k, n, "flips", "expected")
                              for k, n in _ORDERS)
                  + f"; past {GATE:g} against the plain version (expected): "
                  + "; ".join(_arm(c, k, n, "gate", "gate_expected")
                              for k, n in _ORDERS[:2]), flush=True)
    elif mode == "bwd":
        bwd(device)
    elif mode == "decode":
        decode(device)
    else:
        raise SystemExit(f"attn_probes: unknown mode {mode}")


if __name__ == "__main__":
    main()
