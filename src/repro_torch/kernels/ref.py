"""Plain-PyTorch oracles, the counterparts of ``repro/kernels/ref.py``.

These are the semantics every kernel is held to.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 (or i32) accumulation."""
    if out_dtype.is_floating_point:
        return (a.float() @ b.float()).to(out_dtype)
    if a.device.type == "cpu":
        return (a.to(torch.int32) @ b.to(torch.int32)).to(out_dtype)
    # integer matmul is CPU-only in PyTorch; f64 sums of int8 products are
    # exact below 2**53
    return torch.round(a.double() @ b.double()).to(out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention oracle.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) — GQA handled by head repeat.
    ``window``: sliding-window size (each query attends to the ``window``
    most recent keys, inclusive).  ``kv_len``: optional per-batch valid kv
    length (decode); keys at index >= kv_len are masked.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sk = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask = mask[None] & (kpos[None] < kv_len.to(q.device)[:, None, None])
        mask = mask[:, None]  # (B,1,Sq,Sk)
    logits = torch.where(mask, logits, torch.full_like(logits, -torch.inf))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None,
            init_state: torch.Tensor | None = None,
            return_state: bool = False):
    """Mamba2 SSD oracle: the exact sequential recurrence.

    x:  (b, s, h, p)   inputs per head
    dt: (b, s, h)      softplus-activated step sizes (> 0)
    A:  (h,)           negative decay rates
    B:  (b, s, g, n)   input projections (g groups, heads share groups)
    C:  (b, s, g, n)   output projections
    D:  (h,)           optional skip
    state: (b, h, p, n)

    h_t = exp(A dt_t) * h_{t-1} + dt_t * x_t B_t^T ;  y_t = h_t C_t
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    bh = B.float().repeat_interleave(rep, dim=2)     # (b,s,h,n)
    ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A.float()[None, None, :] * dtf)  # (b,s,h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, 1)  # (b,s,h,p)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, state
    return y


__all__ = ["attention_ref", "matmul_ref", "ssd_ref"]
