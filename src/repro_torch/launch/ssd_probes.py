"""Probe the SSD chunk-scan kernel's operand rounding on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.ssd_probes simulate

``simulate`` repeats the arithmetic of ``csrc/ssd_scan.cu`` in float64 with
each operand entering the tensor cores as one, two or three bf16 parts
(every product takes the part pairs (i, j) with i + j < parts, as the kernel
does for two: hi hi, hi lo, lo hi), and holds it against the two gates of
``chip_smoke.py`` at their own inputs:

* ``check_ssd`` at the prefill shapes of mamba2-2.7b (bf16 x, B, C, N 128)
  and zamba2-2.7b (f32, N 64), L 512, P 64, dt = softplus(unit normal), A
  the models' -linspace(1, 16, 80), on ``--heads`` of the 80 heads (spread
  over A's range) and one sequence of 2048 tokens: the worst elementwise
  |model - plain| over 3 * 2^-9 * T, T the terms' absolute sum, for
  y_intra and the states; above 1 fails;
* ``check_ssd_ref`` (f32, S 1000 padded to 1024, 8 heads in 2 groups, N
  128, L 512, dt in [0.01, 0.2], A in [-2, -0.5]): the largest |y - ssd_ref|
  and |state - ssd_ref's| with the inter-chunk stage in float64; above 2e-3
  fails.

It prints one line per (case, parts) and returns the numbers.  The kernel
takes one part for bf16 inputs (they enter exact; only the scaled scores
S' and B w are rounded) and two for f32 inputs.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..kernels.ref import ssd_ref
from ..kernels.ssd_scan import ssd_chunk_local_plain

SSD_BOUND = 3 * 2.0 ** -9           # chip_smoke.check_ssd
REF_ATOL = 2e-3                     # chip_smoke.check_ssd_ref
MODELS = {"mamba2": dict(n=128, dtype=torch.bfloat16),
          "zamba2": dict(n=64, dtype=torch.float32)}


def bf16_split(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """``x`` (rounded to f32 first, as the kernel holds it) as ``parts``
    bf16 values in float64, each rounding what the ones before it left
    out."""
    rest = x.float()
    out = []
    for _ in range(parts):
        p = rest.bfloat16().float()
        out.append(p.double())
        rest = rest - p
    return out


def _product(a: list, b: list, op) -> torch.Tensor:
    """The sum of op(a_i, b_j) over the part pairs i + j < len(a)."""
    n = len(a)
    return sum(op(a[i], b[j]) for i in range(n) for j in range(n - i))


def chunk_local_model(x, dt, A, B, C, *, chunk: int, parts: int):
    """``ssd_chunk_local`` as the kernel computes it, in float64 but for
    its roundings: x, B and C enter as ``parts`` bf16 parts, the f32 cumsum
    of dt * A, the scaled scores S' = (C B^T) Γ dt and B w (w = exp(cum_L -
    cum) dt) rounded to f32 and split into ``parts`` parts again.
    x (BH, S, P), dt (BH, S), A (BH,), B and C (BH, S, N), one group a
    head row.  Returns (y_intra, states, dsums) as the plain version
    shapes them."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nck = s // chunk
    xs = [t.reshape(bh, nck, chunk, p) for t in bf16_split(x, parts)]
    bs = [t.reshape(bh, nck, chunk, n) for t in bf16_split(B, parts)]
    cs = [t.reshape(bh, nck, chunk, n) for t in bf16_split(C, parts)]
    dtf = dt.float().reshape(bh, nck, chunk)
    cum = torch.cumsum(dtf * A.float()[:, None, None], -1).double()
    dtd = dtf.double()
    idx = torch.arange(chunk)
    tril = idx[None, :] <= idx[:, None]
    seg = cum[..., :, None] - cum[..., None, :]
    gamma = torch.exp(torch.where(tril, seg, torch.full_like(seg, -1e30)))
    scores = _product(cs, bs, lambda c, b: c @ b.transpose(-1, -2))
    sp = bf16_split(scores * gamma * dtd[..., None, :], parts)
    y = _product(sp, xs, lambda a, b: a @ b)
    w = torch.exp(cum[..., -1:] - cum) * dtd
    bw = bf16_split(sum(bs) * w[..., None], parts)
    states = _product(bw, xs, lambda a, b: a.transpose(-1, -2) @ b)
    return (y.reshape(bh, s, p), states.reshape(bh * nck, n, p),
            cum[..., -1].reshape(bh * nck))


def _model_inputs(gen, heads: int, s: int, n: int, dtype, p: int = 64,
                  total_heads: int = 80):
    """``chip_smoke._ssd_inputs`` for ``heads`` head rows of one sequence,
    their A spread over the models' -linspace(1, 16, 80)."""
    pick = torch.linspace(0, total_heads - 1, heads).round().long()
    A = -torch.linspace(1.0, 16.0, total_heads)[pick]
    x = torch.randn((heads, s, p), generator=gen)
    dt = F.softplus(torch.randn((heads, s), generator=gen))
    B = torch.randn((heads, s, n), generator=gen)
    C = torch.randn((heads, s, n), generator=gen)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def check_ssd_case(name: str, parts: int, heads: int = 8, seed: int = 0,
                   s: int = 2048, chunk: int = 512) -> dict:
    """The worst |model - plain| / (3 * 2^-9 * T) over y_intra and the
    states at ``name``'s prefill shape (``MODELS``)."""
    gen = torch.Generator().manual_seed(seed)
    cfg = MODELS[name]
    x, dt, A, B, C = _model_inputs(gen, heads, s, cfg["n"], cfg["dtype"])
    got = chunk_local_model(x, dt, A, B, C, chunk=chunk, parts=parts)
    want = ssd_chunk_local_plain(x, dt, A, B, C, chunk=chunk)
    terms = ssd_chunk_local_plain(x.abs(), dt, A, B.abs(), C.abs(),
                                  chunk=chunk)
    worst, rms = 0.0, 0.0
    for g, w, t in zip(got[:2], want[:2], terms[:2]):
        diff = (g - w.double()).abs()
        worst = max(worst, float((diff / (SSD_BOUND * t.double())
                                  .clamp_min(1e-300)).max()))
        rms = max(rms, float(diff.square().mean().sqrt()))
    return dict(case=f"check_ssd {name}", parts=parts, worst_ratio=worst,
                rms_err=rms, ok=worst <= 1.0)


def check_ssd_ref_case(parts: int, seed: int = 0) -> dict:
    """The model's covenant_ssd path (f32 inputs, S 1000 padded to the
    chunk, 2 groups of 4 heads) against the sequential oracle."""
    gen = torch.Generator().manual_seed(seed)
    b, s, h, g, n, p, chunk = 1, 1000, 8, 2, 128, 64, 512
    x = torch.randn((b, s, h, p), generator=gen)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen)
    A = -(0.5 + 1.5 * torch.rand((h,), generator=gen))
    B = torch.randn((b, s, g, n), generator=gen)
    C = torch.randn((b, s, g, n), generator=gen)
    want, wst = ssd_ref(*(t.double() for t in (x, dt, A, B, C)),
                        return_state=True)
    spad = -(-s // chunk) * chunk
    pad = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, spad - s])  # noqa
    xf = pad(x).transpose(1, 2).reshape(h, spad, p)
    dtf = pad(dt).transpose(1, 2).reshape(h, spad)
    rep = h // g
    bf, cf = (pad(t).repeat_interleave(rep, 2).transpose(1, 2)
              .reshape(h, spad, n) for t in (B, C))
    y_intra, states, dsums = chunk_local_model(xf, dtf, A, bf, cf,
                                               chunk=chunk, parts=parts)
    nck = spad // chunk
    states = states.reshape(h, nck, n, p)
    hprev, hs = torch.zeros((h, n, p), dtype=torch.float64), []
    for c in range(nck):
        hs.append(hprev)
        hprev = torch.exp(dsums.reshape(h, nck)[:, c])[:, None, None] \
            * hprev + states[:, c]
    cum = torch.cumsum(dtf.double().reshape(h, nck, chunk)
                       * A.double()[:, None, None], -1)
    y_inter = (cf.double().reshape(h, nck, chunk, n) @ torch.stack(hs, 1)) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter.reshape(h, spad, p))[:, :s]
    err_y = float((y - want[0].transpose(0, 1)).abs().max())
    err_st = float((hprev.transpose(1, 2) - wst[0]).abs().max())
    err = max(err_y, err_st)
    return dict(case="check_ssd_ref f32", parts=parts, max_abs_err=err,
                y_err=err_y, state_err=err_st, ok=err <= REF_ATOL)


def simulate(heads: int = 8, seed: int = 0) -> list[dict]:
    """Both gates at both models' shapes for 1, 2 and 3 parts."""
    out = []
    for parts in (1, 2, 3):
        for name in MODELS:
            out.append(check_ssd_case(name, parts, heads, seed))
        out.append(check_ssd_ref_case(parts, seed))
    for r in out:
        nums = " ".join(f"{k}={v:.3e}" for k, v in r.items()
                        if isinstance(v, float))
        print(f"[simulate] {r['case']:20s} parts={r['parts']} {nums} "
              f"{'ok' if r['ok'] else 'FAILS'}", flush=True)
    return out


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "simulate":
        raise SystemExit("usage: python -m repro_torch.launch.ssd_probes "
                         "simulate [heads] [seed]")
    simulate(*(int(a) for a in argv[1:3]))


if __name__ == "__main__":
    main()
