"""Sharding-rule engine: parameter-path patterns -> PartitionSpec.

The counterpart of ``repro/runtime/sharding.py``, with its rules, written
for ``torch.distributed``: a ``PartitionSpec`` names, for each dim of a
tensor, the mesh axes it is split over (or None), and a ``NamedSharding``
turns it into the DTensor placements of a ``DeviceMesh`` (``Shard(dim)``
on every mesh dim named in the spec, ``Replicate()`` on the others).

Defaults implement the reference's production layout for every family:

* tensor parallelism over ``model``: attention heads, ffn hidden, experts
  (EP), vocab;
* ZeRO-3-style weight sharding over ``data`` on the complementary matrix
  dim (the models gather a weight whole inside the layer that reads it,
  ``models.common.at_use``);
* everything small (norms, biases, scalars) replicated;
* batch dims of activations over ``("pod", "data")``.

The reference stacks each layer leaf as ``(n_groups, ...)``; the port keeps
one dict per layer (``layers/3/attn/wq`` where the reference has
``layers/0/attn/wq``), so a port leaf has one fewer leading dim.  The
rules give specs for the trailing dims and pad the leading ones with None,
so both layouts get the same sharding on the dims they share.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..tree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (not split).  Missing trailing entries are None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


# (regex over path, spec for the *trailing* dims).  Specs are given for the
# logical 2-D (in, out) matrix; leading dims get None.  DATA = ZeRO
# weight-shard axis, MODEL = tensor axis.
RULES: list[tuple[str, tuple]] = [
    (r"embed/tokens$",            ("model", "data")),    # (vocab, d)
    (r"embed/unembed$",           ("data", "model")),    # (d, vocab)
    (r"projector$",               (None, "model")),      # (vis, d)
    (r"pos_enc$",                 (None, None)),
    (r"attn/w[qkv]$",             ("data", "model")),    # (d, heads*hd)
    (r"attn/wo$",                 ("model", "data")),    # (heads*hd, d)
    (r"(xattn)/w[qkv]$",          ("data", "model")),
    (r"(xattn)/wo$",              ("model", "data")),
    (r"mlp/w[ig]$",               ("data", "model")),    # (d, ff)
    (r"mlp/wo$",                  ("model", "data")),    # (ff, d)
    (r"ffn/router$",              (None, None)),         # small, replicated
    # dense (non-expert) layers in the MoE family keep 2-D ffn weights
    (r"dense_layers/.*/ffn/w[ig]$", ("data", "model")),
    (r"dense_layers/.*/ffn/wo$",  ("model", "data")),
    (r"ffn/w[ig]$",               ("model", "data", None)),  # (E, d, ff) EP
    (r"ffn/wo$",                  ("model", None, "data")),  # (E, ff, d)
    (r"ffn/shared/w[ig]$",        ("data", "model")),
    (r"ffn/shared/wo$",           ("model", "data")),
    (r"mamba/in_proj$",           ("data", "model")),
    (r"mamba/out_proj$",          ("model", "data")),
    (r"mamba/conv_w$",            (None, "model")),      # (w, conv_ch)
    (r"mamba/conv_b$",            ("model",)),
    (r"mamba/(A_log|D|dt_bias)$", ("model",)),
    (r"mamba/norm_scale$",        ("model",)),
    (r"shared/w[qkvig]$",         ("data", "model")),    # zamba shared block
    (r"shared/wo(_mlp)?$",        ("model", "data")),
    (r"loras?/.*a$",              ("data", None)),
    (r"loras?/.*b$",              (None, "model")),
    (r"(wi|wg)$",                 ("data", "model")),    # moe dense fallback
    (r"wo$",                      ("model", "data")),
]


def spec_for(path: str, shape: tuple[int, ...], rules=None) -> P:
    """PartitionSpec for one leaf; leading dims padded with None."""
    rules = rules if rules is not None else RULES
    for pat, trailing in rules:
        if re.search(pat, path):
            t = tuple(trailing)
            if len(t) > len(shape):
                t = t[-len(shape):] if len(shape) else ()
            return P(*((None,) * (len(shape) - len(t)) + t))
    return P()  # replicate (norms, scalars)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with a
    ``shape`` dict, as the tests' mesh stubs)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(ax) -> tuple:
    return () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))


def axes_size(mesh, ax) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _names(ax))


def divisible(dim: int, mesh, ax) -> bool:
    """``dim`` splits evenly over the mesh axes ``ax`` (at least one row
    each)."""
    size = axes_size(mesh, ax)
    return dim >= size and dim % size == 0


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the DTensor placements it stands for."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, ax in enumerate(self.spec) if name in _names(ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (the whole tensor, the same on every rank) as a DTensor
        with these placements."""
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def fixed_spec(shape: tuple, spec: P, mesh) -> P:
    """``spec`` with an axis name dropped wherever the dim is not a
    multiple of the axis size, or is smaller than it."""
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(ax if ax is not None and divisible(d, mesh, ax) else None
               for d, ax in zip(shape, full)))


def shardings(tree, mesh, rules=None):
    """NamedShardings for every leaf of ``tree`` (tensors, fake or meta
    ones included)."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for(_path_str(path), shape, rules)
        return NamedSharding(mesh, fixed_spec(shape, spec, mesh))

    return tree_map_with_path(one, tree)


def batch_spec(mesh) -> P:
    axes = tuple(n for n in ("pod", "data") if n in axis_sizes(mesh))
    return P(axes if len(axes) > 1 else axes[0])


def batch_shardings(batch_tree, mesh):
    """Shard every batch leaf's dim 0 over (pod, data)."""
    bs = tuple(batch_spec(mesh))
    return tree_map(lambda leaf: NamedSharding(
        mesh, P(*bs, *((None,) * (len(leaf.shape) - 1)))), batch_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place(tree, sh_tree):
    """Every leaf of ``tree`` as a DTensor placed by ``sh_tree``."""
    return tree_map(lambda t, sh: sh.place(t), tree, sh_tree)


def local_bytes(t) -> int:
    """Bytes of the shard this rank holds (a whole tensor's own)."""
    loc = t.to_local() if isinstance(t, DTensor) else t
    return loc.numel() * loc.element_size()


__all__ = ["NamedSharding", "P", "PartitionSpec", "RULES", "axes_size",
           "axis_sizes", "batch_shardings", "batch_spec", "divisible",
           "fixed_spec", "local_bytes", "place", "replicated", "shardings",
           "spec_for"]
