"""Mamba2 (SSD) block: the chunked SSD, the block and its one-token decode.

The counterpart of ``repro/models/ssm.py``.  ``ssd_chunked`` is the
plain-torch twin of the chunked scan (the same chunk decomposition; a loop
over chunks carries the inter-chunk state while the quadratic intra-chunk
work runs as chunk-local products).  The reference's docstring says the
Pallas kernel replaces the intra-chunk stage on the accelerator, but its
models call ``ssd_chunked`` everywhere.  The port does what the docstring
says: ``ssd`` sends the full-sequence SSD of ``mamba_block`` and the
prefills through ``ops.covenant_ssd`` (the Hopper kernel on a CUDA tensor)
when ``attn="kernel"``, and through ``ssd_chunked`` when ``attn="plain"``.
Decode is the O(1) recurrent step, plain torch on both paths: the
reference has no kernel for it.

State layouts: ``ssd_chunked`` and the decode cache hold (b, h, n, p);
``ops.covenant_ssd`` (like ``ref.ssd_ref``) returns (b, h, p, n), which
``ssd`` transposes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels import ops
from .attention import _check_impl
from .common import batch_split, dense_init, pdt, pinned
from .config import ArchConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked SSD (sequence parallel within a chunk, a loop across chunks)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, *, chunk: int,
                init_state: torch.Tensor | None = None):
    """x (b,s,h,p), dt (b,s,h) (>0), A (h,) (<0), B/C (b,s,g,n).
    Returns (y (b,s,h,p) f32, final_state (b,h,n,p) f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    ck = min(chunk, s)
    spad = -(-s // ck) * ck
    if spad != s:
        x = F.pad(x, (0, 0, 0, 0, 0, spad - s))
        dt = F.pad(dt, (0, 0, 0, spad - s))
        B = F.pad(B, (0, 0, 0, 0, 0, spad - s))
        C = F.pad(C, (0, 0, 0, 0, 0, spad - s))
    nck = spad // ck
    # B/C stay unrepeated (b,s,g,n): the grouped einsums below broadcast
    # over the head-repeat dim ``r``, as the reference's do
    xr = x.reshape(b, nck, ck, g, rep, p)
    dtr = dt.float().reshape(b, nck, ck, g, rep)
    br = B.reshape(b, nck, ck, g, n)
    cr = C.reshape(b, nck, ck, g, n)
    af = A.float().reshape(g, rep)
    idx = torch.arange(ck, device=x.device)
    tril = (idx[None, :] <= idx[:, None])[None, :, :, None, None]

    h_prev = (torch.zeros((b, g, rep, n, p), dtype=torch.float32,
                          device=x.device) if init_state is None
              else init_state.float().reshape(b, g, rep, n, p))
    ys = []
    for c in range(nck):
        xc, dtc = xr[:, c].float(), dtr[:, c]
        bc, cc = br[:, c].float(), cr[:, c].float()
        da = dtc * af                                       # (b,ck,g,r)
        cum = torch.cumsum(da, 1)
        seg = cum[:, :, None] - cum[:, None]                # (b,l,m,g,r)
        # mask inside the exp: the masked branch must not overflow
        gamma = torch.exp(torch.where(tril, seg,
                                      torch.full_like(seg, NEG_INF)))
        xdt = xc * dtc[..., None]
        cb = torch.einsum("blgn,bmgn->blmg", cc, bc)
        att = cb[..., None] * gamma                         # (b,l,m,g,r)
        y_intra = torch.einsum("blmgr,bmgrp->blgrp", att, xdt)
        gamma_in = torch.exp(cum)                           # (b,l,g,r)
        y_inter = torch.einsum("blgn,bgrnp->blgrp", cc, h_prev) * \
            gamma_in[..., None]
        decay_end = torch.exp(cum[:, -1:] - cum)            # (b,l,g,r)
        state = torch.einsum("blgn,blgrp->bgrnp", bc,
                             xdt * decay_end[..., None])
        h_prev = torch.exp(cum[:, -1])[..., None, None] * h_prev + state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, spad, h, p)[:, :s]
    return y, h_prev.reshape(b, h, n, p)


def ssd(x, dt, A, B, C, *, chunk: int, attn: str = "kernel"):
    """The full-sequence SSD of a block: (y (b,s,h,p), final state
    (b,h,n,p) f32).  ``attn="kernel"`` goes through ``ops.covenant_ssd``,
    whose y comes back in x's dtype, as the reference's kernel API gives
    it; ``attn="plain"`` through ``ssd_chunked``, whose y is f32.  On
    DTensors both see whole sequences, and their outputs' gradients come
    back so: only the batch stays split (the kernel path's ``local_map``
    does the same)."""
    _check_impl(attn)
    if attn == "plain":
        if not isinstance(x, DTensor):
            return ssd_chunked(x, dt, A, B, C, chunk=chunk)
        x, dt, B, C = (batch_split(t) for t in (x, dt, B, C))
        return tuple(pinned(t) for t in ssd_chunked(x, dt, A, B, C,
                                                    chunk=chunk))
    y, st = ops.covenant_ssd(x, dt, A, B, C, chunk=chunk, return_state=True)
    return y, st.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def init_mamba_block(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    g, n, hh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * g * n
    dtype = pdt(cfg)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * g * n + hh), dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        # fixed f32 leaves, whatever the model's dtype
        "A_log": torch.log(torch.linspace(1.0, 16.0, hh, device=dev)),
        "D": torch.ones((hh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((hh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, g, n, hh = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                    cfg.ssm_nheads)
    return torch.split(zxbcdt, [di, di, 2 * g * n, hh], -1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Gated RMS: stats in f32, IO in z's dtype."""
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(-1, keepdim=True)
    out = yf * torch.rsqrt(ms + eps) * scale.float()
    return out.to(z.dtype)


def mixer(cfg: ArchConfig, p: dict, u: torch.Tensor, *,
          conv_dtype: torch.dtype, attn: str = "kernel"):
    """The block up to ``out_proj``: in_proj, the depthwise causal conv (in
    ``conv_dtype``), SSD, the D skip and the gated norm.  Returns (the
    normed y (b,s,d_inner) in z's dtype, the conv input (b,s,ch), the SSD's
    final state (b,h,n,p) f32)."""
    b, s, _ = u.shape
    di, g, n, hh, hp = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xbc_x, bc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xbc_x, bc], -1)            # conv input (b,s,conv_ch)
    w = p["conv_w"].to(conv_dtype)
    xp = F.pad(xbc.to(conv_dtype), (0, 0, cfg.ssm_conv - 1, 0))
    conv = sum(xp[:, i:i + s] * w[i] for i in range(cfg.ssm_conv))
    conv = F.silu(conv + p["conv_b"].to(conv_dtype))
    x, B, C = torch.split(conv, [di, g * n, g * n], -1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, st = ssd(x.reshape(b, s, hh, hp), dtv, A, B.reshape(b, s, g, n),
                C.reshape(b, s, g, n), chunk=cfg.ssm_chunk, attn=attn)
    y = y + x.reshape(b, s, hh, hp) * p["D"][None, None, :, None]
    return _gated_norm(y.reshape(b, s, di), z, p["norm_scale"]), xbc, st


def mamba_block(cfg: ArchConfig, p: dict, u: torch.Tensor,
                attn: str = "kernel") -> torch.Tensor:
    """Full-sequence mamba2 block.  u: (b, s, d_model).  The conv runs in
    the compute dtype, as the reference's does."""
    y, _, _ = mixer(cfg, p, u, conv_dtype=u.dtype, attn=attn)
    return y @ p["out_proj"].to(y.dtype)


def conv_state(cfg: ArchConfig, xbc: torch.Tensor) -> torch.Tensor:
    """The decode cache's conv state: the last (w-1) conv inputs, f32."""
    s = xbc.shape[1]
    return xbc.float()[:, s - (cfg.ssm_conv - 1):]


# -- decode ------------------------------------------------------------------


def init_mamba_cache(cfg: ArchConfig, batch: int, *,
                     device: torch.device | str = "cuda") -> dict:
    di, g, n, hh, hp = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    conv_ch = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, hh, n, hp), dtype=torch.float32,
                           device=device),
    }


def mamba_block_decode(cfg: ArchConfig, p: dict, u: torch.Tensor,
                       cache: dict) -> tuple[torch.Tensor, dict]:
    """One token.  u: (b, d_model); cache: {conv (b,w-1,ch), ssm
    (b,h,n,p)}.  Works in f32 and casts the output to u's dtype."""
    b, _ = u.shape
    di, g, n, hh, hp = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                        cfg.ssm_nheads, cfg.ssm_headdim)
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xbc_x, bc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xbc_x, bc], -1).float()
    hist = torch.cat([cache["conv"], xbc[:, None]], 1)      # (b,w,ch)
    w = p["conv_w"].float()
    conv = F.silu(torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].float())
    x, B, C = torch.split(conv, [di, g * n, g * n], -1)
    dtv = F.softplus(dt.float() + p["dt_bias"])              # (b,hh)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, hh, hp)
    bh = B.reshape(b, g, n).repeat_interleave(hh // g, 1)
    ch = C.reshape(b, g, n).repeat_interleave(hh // g, 1)
    decay = torch.exp(A[None] * dtv)                         # (b,hh)
    ssm = cache["ssm"] * decay[..., None, None] + \
        torch.einsum("bhn,bhp->bhnp", bh, xh * dtv[..., None])
    y = torch.einsum("bhnp,bhn->bhp", ssm, ch) + xh * p["D"][None, :, None]
    y = _gated_norm(y.reshape(b, di), z, p["norm_scale"])
    # the reference multiplies y (z's dtype) by an f32 out_proj: in f32
    out = (y.float() @ p["out_proj"].float()).to(u.dtype)
    return out, {"conv": hist[:, 1:], "ssm": ssm}


__all__ = ["conv_state", "init_mamba_block", "init_mamba_cache",
           "mamba_block", "mamba_block_decode", "mixer", "ssd",
           "ssd_chunked"]
