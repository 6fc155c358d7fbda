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
checkpoints cross-load with the JAX package both ways.  The reference's
``restore_sharded`` places arrays on a mesh and waits for the
distribution slice.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

from ..tree import tree_map_with_path, tree_paths

_SEP = "|"


def _key(path: tuple) -> str:
    return _SEP.join(f"#{k}" if isinstance(k, int) else str(k)
                     for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
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
    """Atomically write ``tree`` (params/opt state/...) for ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
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


__all__ = ["latest_step", "load_checkpoint", "save_checkpoint"]
