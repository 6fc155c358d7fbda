"""Worker processes of ``tests/test_torch_distributed.py``.

Each function runs in every rank of a gloo group of CPU processes that
``run_ranks`` spawns; it imports torch and the port only, reads its inputs
from a ``torch.save`` file the test wrote, and rank 0 writes what the test
checks.  Kept apart from the test module so that the workers do not import
JAX.
"""
from __future__ import annotations

import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, port, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        globals()[fn_name](rank, world, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn_name: str, world: int, *args, timeout: float = 120.0):
    """``fn_name(rank, world, *args)`` in ``world`` spawned ranks; raises
    if one fails or the ranks outlast ``timeout`` seconds (then killed)."""
    port = free_port()
    ctx = mp.start_processes(_entry, args=(world, port, fn_name, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn_name} at world {world} ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("data", "model"))


def mesh_checks(rank, world, shape, paths, out):
    """On one mesh: the collectives, the sharded train steps and each
    check ``paths`` names an input for (``gqa``, ``int8``, ``restore``,
    ``serve``);
    rank 0 writes the results."""
    res = {"collectives": collectives(shape, paths["coll"]),
           "train": train_step(shape, paths["train"])}
    if "gqa" in paths:
        res["gqa"] = gqa(shape, paths["gqa"])
    if "int8" in paths:
        res["int8"] = int8(shape, paths["int8"])
    if "restore" in paths:
        res["restore"] = restore(shape, paths["restore"], paths["ckpt"])
    if "serve" in paths:
        res["serve"] = serve(shape, paths["serve"])
    if rank == 0:
        torch.save(res, out)


def collectives(shape, inp):
    """Both collectives of ``runtime.collectives`` on the inputs of
    ``inp``, every rank holding the same ones."""
    from repro_torch.runtime.collectives import (compressed_psum,
                                                 sharded_decode_attention)
    mesh = _mesh(shape)
    x = torch.load(inp)
    psum = compressed_psum({"w": x["g"]}, mesh, axis="data")["w"]
    dec = sharded_decode_attention(x["q"], x["k"], x["v"], x["lens"], mesh,
                                   seq_axis="model")
    return {"psum": psum, "decode": dec}


def train_step(shape, inp):
    """Each case of ``inp``: one sharded loss and gradient (params placed
    by the rules, the batch over data, activations sharded as the dry-run
    shards them, the grads constrained to the params' placements) on the
    kernel path, gathered; ``global_norm`` of the sharded grads beside
    the norm of the gathered ones; and whether a MoE layer ran on each
    rank's rows."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import configure_activation_sharding
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.trainstep import make_loss_with_accum
    from repro_torch.tree import tree_map
    from repro_torch.models import moe
    mesh = _mesh(shape)
    res = {}
    for case, (arch, over, params, batch) in torch.load(inp).items():
        cfg = configs.get_config(arch, smoke=True).replace(**over)
        model = get_model(cfg, device="cpu", attn="kernel")
        on_rows, moe_rows = [], moe._rows_hold_blocks

        def spy(*a):
            on_rows.append(moe_rows(*a))
            return on_rows[-1]
        moe._rows_hold_blocks = spy
        p_sh = sh.shardings(params, mesh)
        dparams = sh.place(params, p_sh)
        dbatch = sh.place(batch, sh.batch_shardings(batch, mesh))
        configure_activation_sharding(*specs.activation_axes(cfg, mesh))
        try:
            with use_mesh(mesh):
                loss, grads = make_loss_with_accum(model.loss_fn, 1, p_sh)(
                    dparams, dbatch)
        finally:
            configure_activation_sharding(None, None, None, None)
            moe._rows_hold_blocks = moe_rows
        placed = all(g.placements == s.placements for g, s in zip(
            _leaves(grads), _leaves(p_sh)))
        full = tree_map(lambda g: g.full_tensor(), grads)
        res[case] = dict(loss=loss.full_tensor(), grads=full, placed=placed,
                         norm=global_norm(grads), whole_norm=global_norm(full),
                         moe_on_rows=any(on_rows))
    return res


def serve(shape, inp):
    """Each case of ``inp``: prefill and decode steps on DTensors, the
    params placed by the rules, the cache by ``specs.cache_shardings``
    (kv heads over model where they divide it, else the sequence), the
    prompt and tokens over data and the activations sharded as the
    dry-run shards them, on the kernel path: each step's logits and the
    final cache, gathered, and whether a cache was split over its
    sequence."""
    from torch.distributed.tensor import Shard
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import configure_activation_sharding
    from repro_torch.runtime import sharding as sh
    from repro_torch.tree import tree_map
    mesh = _mesh(shape)
    res = {}
    for key, x in torch.load(inp).items():
        cfg = configs.get_config(x["arch"], smoke=True)
        model = get_model(cfg, device="cpu", attn="kernel")
        params = sh.place(x["params"], sh.shardings(x["params"], mesh))
        cache = model.init_cache(x["tokens"].shape[0], x["max_len"])
        cache = sh.place(cache, specs.cache_shardings(cache, cfg, mesh))
        seq_split = any(Shard(2) in t.placements
                        for t in _leaves(cache["layers"]))

        def rows(t):
            return sh.place(t, sh.batch_shardings(t, mesh))

        configure_activation_sharding(*specs.activation_axes(cfg, mesh))
        try:
            with use_mesh(mesh):
                logits, cache = model.prefill(
                    params, {"tokens": rows(x["tokens"])}, cache)
                out = [logits.full_tensor()]
                for t in x["steps"].unbind(1):
                    logits, cache = model.decode_step(params, rows(t), cache)
                    out.append(logits.full_tensor())
        finally:
            configure_activation_sharding(None, None, None, None)
        res[key] = dict(logits=out, seq_split=seq_split,
                        cache=tree_map(lambda t: t.full_tensor(), cache))
    return res


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def gqa(shape, inp):
    """``covenant_attention`` (forward and dq, dk, dv) and
    ``covenant_decode_attention`` on DTensors with q's heads over model,
    for each (Hq, Hkv) case of ``inp``, against the same calls on whole
    tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.runtime import sharding as sh
    mesh = _mesh(shape)
    sizes = sh.axis_sizes(mesh)
    res = {}
    for key, x in torch.load(inp).items():
        def placed(t, heads):
            split = heads and t.shape[1] % sizes["model"] == 0
            return DTensor.from_local(
                *_local(t, mesh, split), mesh,
                (Shard(0), Shard(1) if split else Replicate()),
                run_check=False)
        q, k, v = (placed(x[n], True).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = ops.covenant_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(o, (q, k, v),
                                    placed(x["do"], True).detach())
        dec = ops.covenant_decode_attention(
            placed(x["qd"], True), placed(x["k"], True),
            placed(x["v"], True),
            DTensor.from_local(_local(x["lens"], mesh, False)[0], mesh,
                               (Shard(0), Replicate()), run_check=False))
        res[key] = dict(out=o.detach().full_tensor(),
                        grads=[g.full_tensor() for g in grads],
                        decode=dec.full_tensor(),
                        kv_split=k.placements[1] == Shard(1))
    return res


def _local(t, mesh, heads_split):
    """This rank's piece of ``t``: rows over data, heads over model."""
    r = mesh.get_local_rank("data")
    rows = t.chunk(mesh.size(0), 0)[r]
    if heads_split:
        rows = rows.chunk(mesh.size(1), 1)[mesh.get_local_rank("model")]
    return (rows.contiguous(),)


def restore(shape, inp, ckpt_dir):
    """Save a sharded state on ``shape`` through the training loop's
    checkpoint, then restore it with ``restore_sharded`` onto a
    (world, 1) mesh: the restored leaves, gathered, and whether each came
    back placed as asked."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.convert import to_reference_layout
    from repro_torch.runtime import fault_tolerance, sharding as sh
    from repro_torch.tree import tree_map
    x = torch.load(inp)
    cfg = configs.get_config(x["arch"], smoke=True)
    state = x["state"]
    mesh = _mesh(shape)
    dstate = sh.place(state, sh.shardings(state, mesh))
    fault_tolerance._save(cfg, ckpt_dir, 1, dstate, keep=3)
    like = to_reference_layout(cfg, tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state))
    other = _mesh((shape[0] * shape[1], 1))
    shard = sh.shardings(like, other)
    tree, step, _ = ckpt.restore_sharded(ckpt_dir, like, shard)
    placed = all(t.placements == s.placements
                 for t, s in zip(_leaves(tree), _leaves(shard)))
    return {"tree": tree_map(ckpt.store.gathered, tree), "step": step,
            "placed": placed}


def loop(rank, world, shape, inp, ckpt_dir, out):
    """``train_loop`` on a sharded state, failing once at step 2 (after
    the checkpoint of step 2) and resumed to step 4; rank 0 writes both
    reports' losses and where the second run resumed."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import (fault_tolerance, make_train_step,
                                     sharding as sh)
    x = torch.load(inp)
    cfg = configs.get_config(x["arch"], smoke=True)
    model = get_model(cfg, device="cpu", attn="kernel")
    mesh = _mesh(shape)
    opt = adamw(1e-3)
    params = x["params"]
    p_sh = sh.shardings(params, mesh)
    step = make_train_step(model.loss_fn, opt, grad_shardings=p_sh)
    b_sh = sh.batch_shardings(x["batches"][0], mesh)

    def data(s):
        return sh.place(x["batches"][s], b_sh)

    def first():
        dp = sh.place(params, p_sh)
        return dp, opt.init(dp)

    failed_at = None
    try:
        fault_tolerance.train_loop(step, *first(), data, cfg=cfg, steps=4,
                                   ckpt_dir=ckpt_dir, ckpt_every=1,
                                   inject_failure_at=2, logger=_quiet)
    except fault_tolerance.InjectedFailure as e:
        failed_at = e.step
    _, _, rep = fault_tolerance.train_loop(
        step, *first(), data, cfg=cfg, steps=4, ckpt_dir=ckpt_dir,
        ckpt_every=1, logger=_quiet)
    if rank == 0:
        torch.save({"failed_at": failed_at, "resumed_from": rep.resumed_from,
                    "losses": rep.losses, "steps_run": rep.steps_run}, out)


def launch_train(rank, world, argv, out):
    """``launch.train.main(argv)`` in the group the spawn started; rank
    0 writes the losses."""
    from repro_torch.launch import train
    stats = train.main(list(argv))
    if rank == 0:
        torch.save({"losses": stats["report"].losses}, out)


def int8(shape, inp):
    """One step of ``int8_compressed(adamw)`` on DTensor leaves placed by
    the rules: the new params, residuals and moments, gathered, and the
    loss."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.optim import adamw, int8_compressed
    from repro_torch.runtime import make_train_step, sharding as sh
    from repro_torch.tree import tree_map
    x = torch.load(inp)
    cfg = configs.get_config(x["arch"], smoke=True)
    model = get_model(cfg, device="cpu", attn="kernel")
    mesh = _mesh(shape)
    opt = int8_compressed(adamw(1e-3), cfg)
    p_sh = sh.shardings(x["params"], mesh)
    params = sh.place(x["params"], p_sh)
    state = opt.init(params)
    new_p, new_s, m = make_train_step(model.loss_fn, opt,
                                      grad_shardings=p_sh)(
        params, state, sh.place(x["batch"], sh.batch_shardings(x["batch"],
                                                               mesh)))
    res = tree_map(lambda t: t.full_tensor(),
                   {"params": new_p, "err": new_s["err"],
                    "mu": new_s["inner"]["mu"]})
    return dict(res, loss=m["loss"])


def _quiet(*_):
    pass


__all__ = ["free_port", "run_ranks"]
