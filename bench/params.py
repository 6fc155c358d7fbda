"""The weights of a configuration, made on the device from the seed.

The tree's layout is the reference's (``reference.<family>.layout``):
the same paths, shapes and dtypes as the program's ``init_params``.  The
leaves that share a dtype and an initialiser are one tensor made by one
call of the card's generator; each leaf is a view into it.

A ``relabelled`` workload draws one set of weights, and one of inputs
(``traffic``), for every seed, and the seed relabels them: each MoE
layer's experts (``permute_experts``) and the vocabulary
(``vocab_permutation``).  The model computes the same function of the
relabelled inputs, so the routing load, and with it the work of a run,
does not change with the seed; the token ids and the weights' order do.
"""
from __future__ import annotations

import functools
import hashlib
import math

import torch

from .reference.common import build


def derive(seed: int, *keys) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


# the seed of the one draw a ``relabelled`` workload takes
FIXED_SEED = 0


def make(layout: list, seed: int, device) -> dict:
    """The parameter tree of ``layout`` (reference ``layout`` entries),
    its normal leaves drawn from ``seed``."""
    groups: dict[tuple, list] = {}
    for path, shape, dtype, init in layout:
        groups.setdefault((dtype, init), []).append((path, shape))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "params"))
    items = []
    for (dtype, init), leaves in groups.items():
        dt = getattr(torch, dtype)
        n = sum(math.prod(shape) for _, shape in leaves)
        if init[0] == "normal":
            flat = torch.randn(n, generator=gen, dtype=dt, device=device)
            flat.mul_(init[1])
        elif init[0] == "ones":
            flat = torch.ones(n, dtype=dt, device=device)
        else:
            flat = torch.zeros(n, dtype=dt, device=device)
        off = 0
        for path, shape in leaves:
            size = math.prod(shape)
            items.append((path, flat[off:off + size].view(shape)))
            off += size
    return build(items)



def permute_experts(tree: dict, seed: int) -> dict:
    """Relabel in place each MoE layer's experts by a permutation drawn
    from ``seed``: the router's columns and the experts' weights alike."""
    gen = torch.Generator()
    gen.manual_seed(derive(seed, "experts"))
    for lp in tree.get("layers", []):
        ffn = lp.get("ffn", {})
        if "router" not in ffn:
            continue
        perm = torch.randperm(ffn["router"].shape[1], generator=gen)
        perm = perm.to(ffn["router"].device)
        ffn["router"].copy_(ffn["router"][:, perm])
        for name in ("wi", "wg", "wo"):
            ffn[name].copy_(ffn[name][perm])
    return tree


@functools.lru_cache(maxsize=4)
def vocab_permutation(seed: int, vocab: int, device) -> torch.Tensor:
    """The new id of each token id, drawn from ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(derive(seed, "vocab"))
    return torch.randperm(vocab, generator=gen).to(device)


def permute_vocab(tree: dict, perm: torch.Tensor) -> dict:
    """Move in place token ``t``'s embedding row and unembedding column to
    ``perm[t]``."""
    inv = torch.argsort(perm)
    emb = tree["embed"]
    emb["tokens"].copy_(emb["tokens"][inv])
    if "unembed" in emb:
        emb["unembed"].copy_(emb["unembed"][:, inv])
    return tree


def for_workload(layout: list, workload: dict, seed: int, device) -> dict:
    """A cell's weights: drawn from ``seed``, or, for a ``relabelled``
    workload, the one fixed draw relabelled by ``seed``."""
    if not workload.get("relabelled", False):
        return make(layout, seed, device)
    tree = permute_experts(make(layout, FIXED_SEED, device), seed)
    vocab = tree["embed"]["tokens"].shape[0]
    return permute_vocab(tree, vocab_permutation(seed, vocab, device))
