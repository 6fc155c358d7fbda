"""Carry parameter trees between the JAX package's layout and the port's.

``params_from_jax(cfg, tree)`` takes the tree that the reference's
``init_params`` returns (any family's), with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), and returns the port's parameters
with the same key paths.  The reference stacks every layer leaf as
``(n_groups, ...)`` inside a list of ``per`` subtrees (one per position in
the layer pattern); the port keeps one dict per layer, so layer
``g * per + j`` is leaf ``[g]`` of subtree ``j``.  whisper stacks two such
subtrees, ``enc_layers`` and ``dec_layers``, each a one-element list; the
port keeps one dict per layer in each.  zamba2's ``loras``, one adapter
per group stacked ``(n_groups, ...)`` in the reference, become a list
with one dict per group.  The MoE family's ``dense_layers``, a plain list
of dicts in the reference, stay one, and paligemma's ``projector`` is a
plain leaf.  Weight layouts stay ``(in, out)``, as ``x @ W`` uses them.
numpy has no bfloat16: bf16 leaves arrive as ``ml_dtypes.bfloat16`` and
cross as raw bits.

``params_to_jax`` is the inverse, for any param-shaped tree (params, and
the optimizer's ``mu``, ``nu`` and ``err``); ``to_reference_layout`` and
``from_reference_layout`` apply the two to every param-shaped subtree of a
training state, which is how a checkpoint holds the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ArchConfig
from .tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _stacks(cfg: ArchConfig) -> dict[str, tuple[int, int]]:
    """The layer subtrees the reference stacks, each with its (n_groups,
    per): ``layers`` by ``cfg.layer_groups()``; whisper's two, each one
    layer a group, ``enc_layers`` by ``enc_layers`` and ``dec_layers`` by
    ``n_layers``."""
    if cfg.family == "audio":
        return {"enc_layers": (cfg.enc_layers, 1),
                "dec_layers": (cfg.n_layers, 1)}
    return {"layers": cfg.layer_groups()}


def _unstack(cfg: ArchConfig, tree: dict, leaf) -> dict:
    stacks = _stacks(cfg)
    out = {k: tree_map(leaf, v) for k, v in tree.items()
           if k not in stacks and k != "loras"}
    for key, (n_groups, per) in stacks.items():
        stacked = tree[key]
        if len(stacked) != per:
            raise ValueError(f"{cfg.name}: expected {per} stacked {key} "
                             f"subtrees, got {len(stacked)}")
        out[key] = [tree_map(lambda a, g=g: leaf(a[g]), stacked[j])
                    for g in range(n_groups) for j in range(per)]
    if "loras" in tree:
        n_groups, _ = cfg.layer_groups()
        out["loras"] = [tree_map(lambda a, g=g: leaf(a[g]), tree["loras"])
                        for g in range(n_groups)]
    return out


def params_from_jax(cfg: ArchConfig, tree: dict, *,
                    device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a reference tree of numpy leaves."""
    return _unstack(cfg, tree, lambda a: _tensor(a, device))


def params_to_jax(cfg: ArchConfig, tree: dict) -> dict:
    """The reference's layout of a port param-shaped tree: each layer leaf
    stacked ``(n_groups, ...)`` in the subtree of its pattern position
    (whisper: in ``enc_layers`` and ``dec_layers``), and zamba2's
    ``loras`` stacked ``(n_groups, ...)``.  Leaves stay tensors on their
    device (``meta`` ones give the layout's shapes for free)."""
    stacks = _stacks(cfg)
    out = {k: v for k, v in tree.items() if k not in stacks and k != "loras"}
    for key, (n_groups, per) in stacks.items():
        layers = tree[key]
        if len(layers) != n_groups * per:
            raise ValueError(f"{cfg.name}: expected {n_groups * per} "
                             f"{key}, got {len(layers)}")
        out[key] = [tree_map(lambda *xs: torch.stack(xs), *layers[j::per])
                    for j in range(per)]
    if "loras" in tree:
        out["loras"] = tree_map(lambda *xs: torch.stack(xs), *tree["loras"])
    return out


def _is_params(cfg: ArchConfig, tree) -> bool:
    """A param-shaped tree: a dict with a list under each of the keys the
    reference stacks (whisper's ``enc_layers`` and ``dec_layers``, every
    other family's ``layers``)."""
    return isinstance(tree, dict) and all(
        isinstance(tree.get(k), list) for k in _stacks(cfg))


def to_reference_layout(cfg: ArchConfig, state):
    """``params_to_jax`` on every param-shaped subtree (``_is_params``)
    of ``state``; other leaves as they are."""
    if _is_params(cfg, state):
        return params_to_jax(cfg, state)
    if isinstance(state, dict):
        return {k: to_reference_layout(cfg, v) for k, v in state.items()}
    return state


def from_reference_layout(cfg: ArchConfig, state):
    """The inverse of ``to_reference_layout``: tensor leaves, each layer's
    a view of its stacked tensor."""
    if _is_params(cfg, state):
        return _unstack(cfg, state, lambda a: a)
    if isinstance(state, dict):
        return {k: from_reference_layout(cfg, v) for k, v in state.items()}
    return state


__all__ = ["from_reference_layout", "params_from_jax", "params_to_jax",
           "to_reference_layout"]
