"""AdamW's global norm and its clipped update over a tree's CUDA leaves:
the wrappers of ``csrc/adamw.cu``.

``sq_sums`` gives each gradient leaf's sum of squares in f32, every leaf in
one launch; ``update`` does AdamW's step, the clip included, of every leaf
it is given in one pass over them.  Both take a table of the leaves
(pointers, element counts, dtypes, the decay flag), copied to the card from
pinned memory without a host wait, and walk each leaf in chunks of
``CHUNK`` elements, one block a chunk, with 64-bit offsets.

``optim/adamw.py`` sends every leaf on a CUDA card here, its gradient made
contiguous.  The kernels take a leaf whose tensors are contiguous, on one
card, param and gradient in bf16 or f32 and moments in f32; the wrappers
raise on any other.  CPU leaves take the eager path there, which is these
kernels' plain version: ``_sq_sum`` computes a leaf's sum of squares in
another order, and the eager update computes the same bits as ``update``
given the same norm.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# elements of a leaf that one block takes (a multiple of the kernels'
# 8-element vectors): 1.4 MB of traffic a chunk for a bf16 param
CHUNK = 1 << 16
_IO = (torch.bfloat16, torch.float32)
_GRAD_BF16, _PARAM_BF16, _DECAY = 1, 2, 4
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _grad_ok(g: torch.Tensor) -> bool:
    """Whether the kernels take the gradient leaf ``g``."""
    return (g.device.type == "cuda" and g.dtype in _IO and g.numel() > 0
            and g.is_contiguous())


def _leaf_ok(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             p: torch.Tensor) -> bool:
    """Whether ``update`` takes the leaf of gradient ``g``, moments ``m``
    and ``v`` and param ``p`` (a DTensor's local shards)."""
    return (_grad_ok(g) and p.dtype in _IO
            and m.dtype == v.dtype == torch.float32
            and all(t.device == g.device and t.is_contiguous()
                    for t in (m, v, p)))


def _table(rows: list, device: torch.device) -> tuple[torch.Tensor, int]:
    """The leaf table of ``csrc/adamw.cu`` on ``device``, from rows of
    (seven pointers, elements, flags), and its number of chunks: each row
    gains the index of its leaf's first chunk."""
    chunk0, packed = 0, []
    for *ptrs, n, flags in rows:
        packed.append([*ptrs, n, chunk0, flags])
        chunk0 += -(-n // CHUNK)
    host = torch.tensor(packed, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True), chunk0


def _one_card(tensors) -> torch.device:
    """The card every tensor lies on; raises if they lie on more."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"adamw kernels: leaves on "
                         f"{sorted(map(str, devices))}, not on one card")
    return devices.pop()


def sq_sums(grads: list[torch.Tensor]) -> torch.Tensor:
    """Each of ``grads``' sum of squares in f32, a ``(len(grads),)``
    tensor: one partial a chunk, then each leaf's partials added in a fixed
    order, so a run repeats bit for bit.  Every leaf is contiguous, bf16 or
    f32, not empty, and all lie on one card."""
    bad = [g for g in grads if not _grad_ok(g)]
    if bad:
        raise ValueError(f"adamw sq_sums: a gradient leaf the kernel does "
                         f"not take ({bad[0].dtype} {tuple(bad[0].shape)} on "
                         f"{bad[0].device}, contiguous "
                         f"{bad[0].is_contiguous()})")
    device = _one_card(grads)
    rows = [[g.data_ptr()] + [0] * 6
            + [g.numel(), _GRAD_BF16 * (g.dtype == torch.bfloat16)]
            for g in grads]
    with torch.cuda.device(device):
        table, n_chunks = _table(rows, device)
        partials = torch.empty(n_chunks, dtype=torch.float32, device=device)
        sums = torch.empty(len(rows), dtype=torch.float32, device=device)
        fn = _build.bind("adamw", "covenant_adamw_sq_sums",
                         [_P, _I, _L, _L, _P, _P, _P])
        err = fn(table.data_ptr(), len(rows), n_chunks, CHUNK,
                 partials.data_ptr(), sums.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check("adamw", err)
    sq_sums.launches += 1
    return sums


sq_sums.launches = 0


def update(leaves: list[tuple], scale: torch.Tensor, b1c: torch.Tensor,
           b2c: torch.Tensor, lr: torch.Tensor, *, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """One AdamW step of every leaf of ``leaves``, each ``(g, m, v, p,
    p_out, m_out, v_out, decay)`` as ``sq_sums`` takes ``g``, with f32
    moments and a bf16 or f32 param, all contiguous and on one card:
    the new param into ``p_out`` (never ``p``) and the moments into
    ``m_out`` and ``v_out`` (``m`` and ``v`` themselves in place).
    ``scale`` (the clip's), ``b1c``, ``b2c`` (the bias corrections) and
    ``lr`` are 0-d tensors read on the card; the Python floats are rounded
    to f32 as PyTorch rounds a scalar against an f32 tensor."""
    device = _one_card(t for leaf in leaves for t in leaf[:7])
    rows = []
    for g, m, v, p, p_out, m_out, v_out, decay in leaves:
        if not (_leaf_ok(g, m, v, p) and _leaf_ok(g, m_out, v_out, p_out)
                and p_out.dtype == p.dtype and p_out.data_ptr() != p.data_ptr()
                and all(t.shape == p.shape for t in (g, m, v, p_out, m_out,
                                                     v_out))):
            raise ValueError(f"adamw update: a leaf the kernel does not take "
                             f"(param {p.dtype} {tuple(p.shape)}, grad "
                             f"{g.dtype} {tuple(g.shape)})")
        flags = (_GRAD_BF16 * (g.dtype == torch.bfloat16)
                 + _PARAM_BF16 * (p.dtype == torch.bfloat16)
                 + _DECAY * bool(decay))
        rows.append([t.data_ptr() for t in (g, p, m, v, p_out, m_out, v_out)]
                    + [p.numel(), flags])
    with torch.cuda.device(device):
        table, n_chunks = _table(rows, device)
        scalars = [t.to(device=device, dtype=torch.float32)
                   for t in (scale, b1c, b2c, lr)]
        fn = _build.bind("adamw", "covenant_adamw_update",
                         [_P, _I, _L, _L] + [_F] * 6 + [_P] * 5)
        err = fn(table.data_ptr(), len(rows), n_chunks, CHUNK, b1, 1 - b1,
                 b2, 1 - b2, eps, weight_decay,
                 *(t.data_ptr() for t in scalars),
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check("adamw", err)
    update.launches += 1


update.launches = 0

__all__ = ["CHUNK", "sq_sums", "update"]
