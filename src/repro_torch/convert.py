"""Carry a JAX parameter tree across to the port.

``params_from_jax(cfg, tree)`` takes the tree that
``repro.models.transformer.init_params`` returns, with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``), and returns the port's
parameters with the same key paths.  The reference stacks every layer leaf
as ``(n_groups, ...)`` inside a list of ``per`` subtrees (one per position
in the layer pattern); the port keeps one dict per layer, so layer
``g * per + j`` is leaf ``[g]`` of subtree ``j``.  Weight layouts stay
``(in, out)``, as ``x @ W`` uses them.  numpy has no bfloat16: bf16
leaves arrive as ``ml_dtypes.bfloat16`` and cross as raw bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ArchConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(cfg: ArchConfig, tree: dict, *,
                    device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a reference tree of numpy leaves."""
    n_groups, per = cfg.layer_groups()
    stacked = tree["layers"]
    if len(stacked) != per:
        raise ValueError(f"{cfg.name}: expected {per} stacked subtrees, "
                         f"got {len(stacked)}")
    layers = [_map(stacked[j], lambda a, g=g: _tensor(a[g], device))
              for g in range(n_groups) for j in range(per)]
    to_t = lambda a: _tensor(a, device)  # noqa: E731
    return {"embed": _map(tree["embed"], to_t), "layers": layers,
            "ln_f": _map(tree["ln_f"], to_t)}


__all__ = ["params_from_jax"]
