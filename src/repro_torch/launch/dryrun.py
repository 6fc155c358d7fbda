"""Multi-pod dry-run: one train step or serve step of every (arch x shape x
mesh) cell on DTensors, with no data and no card.

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell on 512 fake CPU devices; here one process stands for
every rank of a fake process group (256 ranks single-pod, 512 multi-pod,
``launch.mesh.init_fake``), and the cell runs on ``meta`` tensors, which
carry shape and dtype only (made under ``FakeTensorMode``, where the
models' seeded initializers run).  A cell that runs means DTensor found a
sharding for every op of the train step (forward, backward, AdamW) or of
prefill / decode, with the rules' placements, and every collective it
needs is expressible; an op without one raises.  The models take the
plain attention path, as the reference's take ``dense_attention``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --mesh single --out build/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
(--all spawns one subprocess per cell, so no state carries over.)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from .. import configs


def _mesh(kind: str):
    from .mesh import init_fake, make_production_mesh
    init_fake(512 if kind == "multi" else 256)
    return make_production_mesh(multi_pod=(kind == "multi"),
                                device_type="cpu")


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _per_rank_bytes(tree) -> int:
    from ..runtime.sharding import local_bytes
    from ..tree import tree_leaves
    return sum(local_bytes(t) for t in tree_leaves(tree))


@contextlib.contextmanager
def _all_to_all():
    """DTensor's shard-to-shard moves as the all-to-all a cluster of
    cards runs, its buffers of the local shard's size.  On a cpu mesh
    DTensor swaps it for an all-gather and a chunk (gloo has none), and
    the shape function of its own all-to-all op also makes the whole
    tensor: either would have a rank hold the whole tensor for a moment
    and count it in the peak."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        n = mesh.size(mesh_dim)
        # the n pieces of the split dim go to the n ranks, in order; the
        # piece from rank r takes place r along the gathered dim
        y = funcol.all_to_all_single(x.movedim(shard_dim, 0).contiguous(),
                                     None, None, (mesh, mesh_dim))
        y = funcol.wait_tensor(y)
        y = y.reshape(n, y.shape[0] // n, *y.shape[1:]).movedim(
            1, shard_dim + 1)
        return torch.cat(y.unbind(0), dim=gather_dim)

    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev


def _comm_counts(mode) -> dict[str, int]:
    return {str(k).split(".")[-1]: int(v)
            for k, v in mode.get_comm_counts().items()}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             microbatches: int = 4, overrides: dict | None = None,
             zero_serve_params: bool | None = None, mesh=None,
             activations: tuple | None = None) -> dict:
    """Run one cell on the fake group; returns its record:

    * ``status`` ``ok``, or ``skipped`` with the ``applicable`` reason;
    * ``seconds``: the wall time of the step (the host's, under fake
      tensors: a measure of the dry-run, not of any device);
    * ``bytes_per_rank``: the bytes one rank holds at rest of
      ``params``, ``opt_state``, ``batch`` and ``cache`` (local shard
      shapes);
    * ``peak_bytes_per_rank``: the most one rank holds at once over the
      step, those inputs included: each local tensor the step's ops make
      counts from its making to its last use (``MemTracker``), so the
      weights a layer gathers whole, activations, gradients and the
      buffers of collectives count here and not at rest;
    * ``collectives``: how many of each collective the step issued
      (``CommDebugMode``);
    * ``flops``, ``bytes_accessed``, ``collective_bytes``,
      ``collective_breakdown`` and ``n_collectives``: one rank's FLOPs,
      HBM bytes and collective bytes (by kind) over the step, counted on
      its local ops (``roofline.collect.StepCounter``), so
      ``roofline.roofline_terms(record)`` reads a record as it reads the
      reference's; ``path`` names the path counted (``plain``).

    ``mesh`` runs the cell on a mesh of the caller's (the
    tests' small fake groups) in place of the production one;
    ``activations`` the (batch, seq, heads, vocab) axes of
    ``configure_activation_sharding`` in place of the reference's choice
    (batch over pod and data, seq over model, heads and vocab over model
    where they divide it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    from . import specs
    from .mesh import use_mesh
    from ..models.common import configure_activation_sharding
    from ..roofline.collect import StepCounter, record
    from ..runtime.sharding import axis_sizes, place
    from ..tree import tree_leaves, tree_map

    ok, why = configs.applicable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}

    shape = configs.SHAPES[shape_name]
    mesh = mesh if mesh is not None else _mesh(mesh_kind)
    sizes = axis_sizes(mesh)
    cfg = configs.get_config(arch)
    t0 = time.time()
    comm = CommDebugMode()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    if activations is None:
        activations = specs.activation_axes(cfg, mesh)
    # the stand-ins are made in the fake mode and run as meta tensors, out
    # of any mode, so DTensor's own small index tensors (placement
    # arithmetic) stay real
    with fake:
        if shape.kind == "train":
            fn, args, in_sh, _ = specs.train_cell(
                arch, shape_name, mesh, microbatches=microbatches,
                overrides=overrides)
            names = ("params", "opt_state", "batch")
        else:
            kind = "prefill" if shape.kind == "prefill" else "decode"
            fn, args, in_sh, _ = specs.serve_cell(
                arch, shape_name, mesh, kind, overrides=overrides,
                zero_params=zero_serve_params)
            names = ("params", "batch", "cache")
    held = {n: place(tree_map(_meta, a), s)
            for n, a, s in zip(names, args, in_sh)}
    t_setup = time.time() - t0
    peak = MemTracker()
    peak.track_external(*tree_leaves(list(held.values())))
    configure_activation_sharding(*activations)
    # the counter sits under the other modes, which see the step as they
    # would without it
    counter = StepCounter()
    try:
        with counter, use_mesh(mesh), _all_to_all(), comm, peak, \
                torch.no_grad():
            fn(*held.values())
    finally:
        configure_activation_sharding(None, None, None, None)
    return {**record(counter), "path": "plain",
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_devices": mesh.size(), "mesh_shape": sizes,
        "microbatches": microbatches,
        "bytes_per_rank": {k: _per_rank_bytes(v) for k, v in held.items()},
        "peak_bytes_per_rank": max(
            snap["Total"] for snap in peak.get_tracker_snapshot("peak")
            .values()),
        "collectives": _comm_counts(comm),
        "setup_s": round(t_setup, 1),
        "seconds": round(time.time() - t0 - t_setup, 1),
    }


def count_step(cfg, kind: str, batch: int, seq: int, *,
               microbatches: int = 1, max_len: int = 0) -> dict:
    """One step of the model ``cfg`` as one card runs it, on no mesh,
    counted on meta tensors through the plain path
    (``roofline.collect_step``): a ``train`` step (``launch.train``'s:
    forward, backward and AdamW over ``batch`` rows of ``seq`` tokens in
    ``microbatches``), a ``prefill`` of ``batch`` prompts of ``seq``
    tokens into a cache of ``max_len``, or one ``decode`` step of
    ``batch`` rows against that cache.  The model's stub-frontend inputs
    come at ``extra_inputs``' shapes.  AdamW's update counts as the card
    runs it (``on_card_adamw``).  Returns the counted record and
    ``path``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import get_model
    from ..optim import adamw, cosine_schedule
    from ..roofline.collect import StepCounter, record
    from ..runtime import make_train_step
    from ..tree import tree_map

    # the stand-ins are drawn by a cpu model in the fake mode; the step
    # runs a meta model's functions, which put the batch on ``meta``
    model = get_model(cfg, device="meta", attn="plain")
    counter = StepCounter()
    opt = on_card_adamw(adamw(cosine_schedule(3e-3, 20, 100), inplace=True),
                        counter)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = get_model(cfg, device="cpu").init_params(0)
        inputs = {"tokens": torch.zeros((batch, seq), dtype=torch.long)}
        for name, (shape_fn, dtype) in model.extra_inputs.items():
            inputs[name] = torch.zeros(shape_fn(batch, seq), dtype=dtype)
        if kind == "train":
            inputs["targets"] = inputs["tokens"]
            inputs["weights"] = torch.ones((batch, seq))
            fn = make_train_step(model.loss_fn, opt, microbatches)
            args = (params, opt.init(params), inputs)
        elif kind == "prefill":
            fn, args = model.prefill, (params, inputs,
                                       model.init_cache(batch, max_len))
        else:
            fn, args = model.decode_step, (
                params, torch.zeros((batch,), dtype=torch.long),
                model.init_cache(batch, max_len))
    with torch.no_grad(), counter:
        fn(*tree_map(_meta, args))
    return {**record(counter), "path": "plain"}


def on_card_adamw(opt, counter):
    """``opt`` with its update counted by ``counter`` as ``csrc/adamw.cu``
    runs it on the card: the norm's kernel reads the gradients, then one
    kernel clips and updates every leaf, reading gradients, params and
    moments once and writing params and moments once.  The eager ops' FLOPs
    count; their f32 temporaries, which the kernel keeps in registers, move
    no bytes."""
    from ..optim import Optimizer

    def update(grads, state, params):
        return counter.fused(opt.update, grads, state, params, reread=grads)
    return Optimizer(opt.init, update)


def _parse_set(items: list[str]) -> dict:
    """``k=v`` ArchConfig overrides: ints, True / False, else strings."""
    out = {}
    for kv in items:
        k, v = kv.split("=")
        out[k] = int(v) if v.lstrip("-").isdigit() else \
            {"True": True, "False": False}.get(v, v)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--set", nargs="*", default=[],
                    help="ArchConfig overrides, e.g. ssm_chunk=128")
    ap.add_argument("--serve-sharding", default="auto",
                    choices=["auto", "zero", "replicated"])
    args = ap.parse_args(argv)
    overrides = _parse_set(args.set)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        # one subprocess per cell: no state carries over, a crash is one
        cells = [(a, s) for a, s, _, _ in configs.cells(include_skipped=True)]
        failures = []
        for mesh_kind in meshes:
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{mesh_kind}"
                out_file = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_file):
                    print(f"[dryrun] {tag}: cached")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                       "--microbatches", str(args.microbatches),
                       "--serve-sharding", args.serve_sharding,
                       "--out", args.out] + \
                    (["--set"] + args.set if args.set else [])
                print(f"[dryrun] {tag} ...", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                if r.returncode != 0:
                    failures.append(tag)
                    with open(os.path.join(args.out, tag + ".err"), "w") as f:
                        f.write(r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                    print(f"[dryrun] {tag}: FAILED")
                else:
                    print(r.stdout.strip().splitlines()[-1]
                          if r.stdout.strip() else f"[dryrun] {tag}: ok")
        print(f"[dryrun] done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all, are required")
    from ..roofline import roofline_terms
    for mesh_kind in meshes:
        rec = run_cell(args.arch, args.shape, mesh_kind, args.microbatches,
                       overrides=overrides or None,
                       zero_serve_params={"auto": None, "zero": True,
                                          "replicated": False}[
                                              args.serve_sharding])
        tag = f"{args.arch}__{args.shape}__{mesh_kind}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            b = rec["bytes_per_rank"]
            print(f"[dryrun] {tag}: ok bytes/rank " + " ".join(
                f"{k}={v:.3e}" for k, v in b.items()) +
                f" peak={rec['peak_bytes_per_rank']:.3e}"
                f" collectives={sum(rec['collectives'].values())}"
                f" flops={rec['flops']:.3e}"
                f" coll_bytes={rec['collective_bytes']:.3e}"
                f" bottleneck={roofline_terms(rec).bottleneck} "
                f"step={rec['seconds']}s")
        else:
            print(f"[dryrun] {tag}: {rec['status']} ({rec.get('reason', '')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
