"""Plain PyTorch building blocks of the benchmark's reference models.

Everything here computes in float32 from the equations the configuration
files state; it imports nothing of the program.  A ``Precision`` rounds
the operands of every product (linear layers, both attention products):
``F32`` leaves them as they are, ``FP8`` rounds them to float8 e4m3 with
one scale a tensor, forward and backward, which is the control that the
comparison of a bf16 configuration has to fail; ``FP8_LAYERS`` rounds
the layers' products alike and leaves the head's in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def fp32_matmuls() -> None:
    """Full float32 products on a card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class Precision:
    """How the reference rounds the operands of its products: those of the
    layers, and (``head``) those of the head's."""

    def __init__(self, rounds: bool, head: bool | None = None):
        self.rounds = rounds
        self.head_rounds = rounds if head is None else head

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.rounds else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)

    def head_mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.head_rounds:
            return _Fp8.apply(a) @ _Fp8.apply(b)
        return a @ b


F32_PRECISION = Precision(False)
FP8_PRECISION = Precision(True)
FP8_LAYERS = Precision(True, head=False)


# ---------------------------------------------------------------------------
# parameter trees: nested dicts and lists; paths are tuples of keys
# ---------------------------------------------------------------------------


def paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict / list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def build(items) -> dict:
    """The nested tree of ``(path, leaf)`` items; an int key makes a list."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
        node[path[-1]] = leaf
    return root


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def norm(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (with bias) over the last dim, in f32."""
    eps = cfg["norm_eps"]
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * p["scale"].float()


def rope(cfg: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the first ``rope_frac`` of each head's dims,
    rotating adjacent pairs (2i, 2i + 1); x (..., S, D), pos (S,)."""
    d = x.shape[-1]
    rot = int(d * cfg["rope_frac"])
    rot -= rot % 2
    if rot == 0:
        return x
    inv = cfg["rope_theta"] ** (-torch.arange(0, rot, 2, dtype=F32,
                                              device=x.device) / rot)
    ang = pos.to(F32)[:, None] * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :rot:2], x[..., 1:rot:2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rotated.flatten(-2), x[..., rot:]], -1)


def head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: Precision, heads_a_chunk: int = 0
                     ) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over visible keys (k <= q), each q head
    reading kv head ``h // group``; q (B, Hq, S, D), k / v (B, Hkv, S, D).
    ``heads_a_chunk`` bounds the (S, S) scores held at once."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    step = heads_a_chunk or hq
    outs = []
    for h0 in range(0, hq, step):
        h1 = min(hq, h0 + step)
        kv = torch.arange(h0, h1, device=q.device) // group
        scores = prec.mm(q[:, h0:h1], k[:, kv].transpose(-1, -2)) \
            / math.sqrt(d)
        scores = scores.masked_fill(~mask, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, -1), v[:, kv]))
    return torch.cat(outs, 1)


def self_attention(cfg: dict, p: dict, h: torch.Tensor, prec: Precision,
                   heads_a_chunk: int = 0) -> torch.Tensor:
    """The attention block's output (before the residual): projections,
    optional per-head q/k RMSNorm, rotary, causal attention, ``wo``."""
    b, s, _ = h.shape
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["hd"]
    q = prec.mm(h, p["wq"].float()).view(b, s, hq, hd).transpose(1, 2)
    k = prec.mm(h, p["wk"].float()).view(b, s, hkv, hd).transpose(1, 2)
    v = prec.mm(h, p["wv"].float()).view(b, s, hkv, hd).transpose(1, 2)
    if cfg["qk_norm"]:
        q = head_rms(q, p["q_norm"], cfg["norm_eps"])
        k = head_rms(k, p["k_norm"], cfg["norm_eps"])
    pos = torch.arange(s, device=h.device)
    q, k = rope(cfg, q, pos), rope(cfg, k, pos)
    o = causal_attention(q, k, v, prec, heads_a_chunk)
    return prec.mm(o.transpose(1, 2).reshape(b, s, hq * hd),
                   p["wo"].float())


def swiglu(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """silu(x wi) * (x wg), then wo."""
    return prec.mm(F.silu(prec.mm(x, p["wi"].float()))
                   * prec.mm(x, p["wg"].float()), p["wo"].float())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy over every position."""
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


def derived(cfg: dict) -> dict:
    """The configuration with its head size worked out."""
    return {**cfg, "hd": cfg.get("head_dim") or cfg["d_model"]
            // cfg["n_heads"]}
