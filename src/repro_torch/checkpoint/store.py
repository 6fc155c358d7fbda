"""Checkpointing: atomic npz files and keep-k retention.

The counterpart of ``repro/checkpoint/store.py``, with its on-disk format:
``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, written to a tmp dir
and ``os.replace``d into place (atomic on POSIX), so a crash mid-write
never leaves a half checkpoint that resume would pick up.  Arrays are keyed
by their ``|``-joined key paths, ``#i`` for a list index.  numpy has no
bfloat16: a bf16 tensor is stored as its raw 2-byte values, which is what
``np.savez`` writes for the reference's bf16 arrays (``'<V2'``), and such
an array loads back into a bf16 leaf.

The layout of the tree is the caller's: the training loop writes the
reference's stacked layer layout (``convert.to_reference_layout``), so
checkpoints cross-load with the JAX package both ways.

A tree of DTensors is saved whole: every rank gathers each leaf (so every
rank must call ``save_checkpoint``), rank 0 writes the reference layout,
and the others wait for it at a barrier.  ``restore_sharded`` places each
array of a checkpoint by the shardings it is given, which may be of
another mesh than the one that saved, or plain devices.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import whole
from ..tree import tree_map, tree_map_with_path, tree_paths

_SEP = "|"


def _key(path: tuple) -> str:
    return _SEP.join(f"#{k}" if isinstance(k, int) else str(k)
                     for k in path)


def gathered(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor as a plain tensor on its device (a
    collective: every rank calls it), with no copy where every mesh dim
    that splits it has one rank (``models.common.whole``); a plain tensor
    as it is."""
    return whole(t).to_local() if isinstance(t, DTensor) else t


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(tree) -> None:
    """Wait for rank 0's write when ``tree`` is distributed."""
    if dist.is_initialized() and any(isinstance(t, DTensor)
                                     for _, t in tree_paths(tree)):
        dist.barrier()


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = gathered(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """``arr`` as a CPU tensor of ``like``'s dtype (when ``like`` has
    one)."""
    dtype = getattr(like, "dtype", None)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(dtype) if isinstance(dtype, torch.dtype) else t


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf) for path, leaf in tree_paths(tree)}


def _unflatten(like, flat: dict[str, np.ndarray]):
    def load(path: tuple, leaf):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = flat[key]
        want = getattr(leaf, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(want)}")
        return _to_tensor(arr, leaf)

    return tree_map_with_path(load, like)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    keep: int = 3) -> str:
    """Atomically write ``tree`` (params/opt state/...) for ``step``.  A
    tree of DTensors: gathered on every rank, written by rank 0."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _rank() != 0:
        for _, leaf in tree_paths(tree):
            gathered(leaf)
        _barrier(tree)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "n_arrays": len(flat),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    _barrier(tree)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, like, step: int | None = None):
    """Load into CPU tensors shaped like ``like`` (whose leaves may be
    tensors on any device, "meta" included: only their shape and dtype are
    read).  Returns (tree, step, extra)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return _unflatten(like, flat), step, manifest.get("extra", {})


def place_array(arr: torch.Tensor, sh) -> torch.Tensor:
    """One loaded array placed by ``sh``: anything with a ``mesh`` and
    ``placements`` (a ``runtime.sharding.NamedSharding``; each rank keeps
    its piece of the array it loaded), or a device."""
    if hasattr(sh, "placements"):
        from torch.distributed.tensor import distribute_tensor
        dev = sh.mesh.device_type
        return distribute_tensor(arr.to(dev), sh.mesh, sh.placements,
                                 src_data_rank=None)
    return arr.to(sh)


def restore_sharded(ckpt_dir: str, like, shardings, step: int | None = None):
    """Elastic restore: place arrays with the provided shardings (a tree
    like ``like`` of NamedShardings, of any mesh, or of devices).  Every
    rank reads the checkpoint.  Returns (tree, step, extra)."""
    host_tree, step, extra = load_checkpoint(ckpt_dir, like, step)
    return tree_map(place_array, host_tree, shardings), step, extra


__all__ = ["gathered", "latest_step", "load_checkpoint", "place_array",
           "restore_sharded", "save_checkpoint"]
