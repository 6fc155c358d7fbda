"""Training driver: ``python -m repro_torch.launch.train --arch qwen3-0.6b``.

The counterpart of ``repro/launch/train.py``: config -> model -> train
step with microbatch accumulation -> synthetic data -> fault-tolerant loop
(checkpoint/restart, NaN rollback, straggler monitor).  Runs on
``--device cuda`` unless asked otherwise; ``--attn kernel`` sends attention
forward and backward through the Hopper kernels (``--attn plain``: plain
PyTorch under autograd); every arch trains, the SSM archs through the SSD
kernel's autograd Function, the MoE archs through the sort-based
dispatch, whisper-base and paligemma-3b on the stub frontend's ``frames``
or ``patches``, which ``SyntheticLM`` draws beside each batch from the
model's ``extra_inputs``, as the reference's ``launch.train`` draws them.
``--smoke`` takes the reduced config, which runs on the CPU.
``--n-layers N`` trains N layers at the arch's full width (0: all), as
``launch.serve`` serves them: a config whose whole depth does not fit one
card trains cut, until the distribution slice.  It refuses an N that keeps
no layer past deepseek's leading dense one, one that splits the arch's
layer groups (gemma3's 5 local + 1 global, zamba2's mamba layers between
uses of its shared block), and whisper, whose encoder it would not cut.
``--ckpt-every 0`` writes no checkpoint.  AdamW updates its moments in
place (``adamw(..., inplace=True)``).  Before training it
prints ``launch.layers.layer_report`` at ``global_batch x seq_len`` tokens:
the model's block GEMMs compiled by the Covenant driver against
``--accel-target`` (any name of the port's registry, derived variants
included; ``none`` skips it; an unknown name exits 2), and against
``h100`` on a card also timed through the Covenant-tiled GEMM kernel.

Distribution, as the reference's: started under ``torchrun`` (or given
``--model-axis``) the run takes the host mesh, every rank of the process
group as (world / model_axis, model_axis) (``launch.mesh``; NCCL on
``cuda``, gloo on ``cpu``); ``--multi-pod`` asks for the (2, 16, 16)
production mesh and exits 2 on a smaller world.  On a mesh the params
and the AdamW moments are DTensors placed by the rules
(``runtime.sharding``) and gathered layer by layer where the model
reads them, the batch is split over ``data``, on a model axis of more
than one rank the activations split over it (``split_activations``), the
step constrains its grads to the params' placements (``grad_shardings``),
and rank 0 writes the checkpoints.  Given neither flag and started by no
launcher, the run is the unsharded single-device one.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import configs
from ..data import SyntheticLM
from ..kernels import kernel_launches
from ..models import get_model
from ..optim import adamw, cosine_schedule, int8_compressed
from ..runtime import make_train_step, sharding as shard_rules, train_loop
from ..models.common import configure_activation_sharding
from . import mesh as mesh_lib, specs
from .layers import check_accel_target, layer_report


def cut_depth(ap: argparse.ArgumentParser, cfg, n_layers: int):
    """``cfg`` at ``n_layers`` layers, or ``ap.error`` where that depth
    cannot be cut."""
    if cfg.family == "audio":
        ap.error(f"--n-layers does not cut {cfg.name}'s "
                 f"{cfg.enc_layers}-layer encoder; train it at full depth")
    if n_layers <= cfg.first_dense:
        ap.error(f"--n-layers must exceed {cfg.name}'s {cfg.first_dense} "
                 f"leading dense layers")
    cut = cfg.replace(n_layers=n_layers)
    try:
        cut.layer_groups()
    except AssertionError:
        ap.error(f"--n-layers {n_layers} splits {cfg.name}'s groups of "
                 f"{cfg.layer_groups()[1]} layers after its "
                 f"{cfg.first_dense} dense ones")
    return cut


def sharded_state(model, opt, data, mesh, args):
    """(the step with ``grad_shardings``, a function that makes the first
    (params, moments) as DTensors placed by the rules, ``step -> batch``
    split over data).  Every rank draws the same params and batches from
    the seed and keeps its own piece."""
    with FakeTensorMode():  # the params' shapes, for their shardings
        p_sh = shard_rules.shardings(
            get_model(model.cfg, device="cpu").init_params(args.seed), mesh)

    def start():
        params = shard_rules.place(model.init_params(args.seed), p_sh)
        opt_state = opt.init(params)
        return params, shard_rules.place(
            opt_state, shard_rules.shardings(opt_state, mesh))

    step_fn = make_train_step(model.loss_fn, opt,
                              microbatches=args.microbatches,
                              grad_shardings=p_sh)
    first = data.batch(0)
    b_sh = shard_rules.batch_shardings(first, mesh)
    dev = torch.device(args.device)

    def batch_of(step: int) -> dict:
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        return shard_rules.place(batch, b_sh)

    return step_fn, start, batch_of


def fresh_state(model, opt, seed: int) -> tuple[dict, dict]:
    """(params drawn from ``seed``, the optimizer's first state)."""
    params = model.init_params(seed)
    return params, opt.init(params)


@contextlib.contextmanager
def split_activations(cfg, mesh):
    """On a mesh whose model axis has more than one rank, the activations
    split as the dry-run splits them (``specs.activation_axes``: rows over
    data, the sequence, heads and vocab over model), so the ranks along
    model share a step's work and do not each repeat it.  A model axis of
    one splits nothing and the run keeps the unsharded one's ops."""
    on = mesh is not None and shard_rules.axis_sizes(mesh)["model"] > 1
    if on:
        configure_activation_sharding(*specs.activation_axes(cfg, mesh))
    try:
        yield
    finally:
        if on:
            configure_activation_sharding(None, None, None, None)


def sharded_run(args, ap):
    """The mesh of a sharded run, or None for the single-device one."""
    if not (args.multi_pod or args.model_axis or mesh_lib.launched()):
        return None
    mesh_lib.init_distributed(args.device)
    dev_type = torch.device(args.device).type
    try:
        if args.multi_pod:
            return mesh_lib.make_production_mesh(multi_pod=True,
                                                 device_type=dev_type)
        return mesh_lib.make_host_mesh(args.model_axis or 1,
                                       device_type=dev_type)
    except ValueError as e:
        ap.error(str(e))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accel-target", default="h100",
                    help="Covenant target of the layer-compile report: any "
                         "name of the port's registry, derived variants "
                         "like 'dnnweaver@pe=32x32' included ('none' skips "
                         "it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="train this many layers at full width (0: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh")
    ap.add_argument("--model-axis", type=int, default=0,
                    help="the host mesh's model axis (0: 1 under a "
                         "launcher, else no mesh)")
    args = ap.parse_args(argv)
    check_accel_target(ap, args.accel_target)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.n_layers:
        cfg = cut_depth(ap, cfg, args.n_layers)
    tokens = args.global_batch * args.seq_len
    before = kernel_launches()
    if args.accel_target != "none":
        print(layer_report(cfg, tokens=tokens, target=args.accel_target,
                           device=args.device, seed=args.seed))
    mesh = sharded_run(args, ap)
    model = get_model(cfg, device=args.device, attn=args.attn)
    where = "" if mesh is None else \
        f" on mesh {shard_rules.axis_sizes(mesh)}"
    print(f"[train] {cfg.name} ({cfg.n_layers} layers) on {args.device}"
          f"{where} (attn={args.attn}), batch {args.global_batch} x "
          f"{args.seq_len} in {args.microbatches} microbatches")

    # the loop owns the optimizer state and rolls back from checkpoints, so
    # the moments update in place (a second copy does not fit at 2.7B)
    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps),
                inplace=True)
    if args.compress_grads:
        opt = int8_compressed(opt, cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                       global_batch=args.global_batch, seed=args.seed,
                       extras=model.extra_inputs)
    if mesh is None:
        step_fn = make_train_step(model.loss_fn, opt,
                                  microbatches=args.microbatches)
        batch_of = data.batch

        def start():
            return fresh_state(model, opt, args.seed)
    else:
        step_fn, start, batch_of = sharded_state(model, opt, data, mesh,
                                                 args)

    t0 = time.perf_counter()
    # the first state goes to the loop with no name here, so the loop can
    # free it once a step has replaced it
    with mesh_lib.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext(), split_activations(cfg, mesh):
        params, opt_state, report = train_loop(
            step_fn, *start(), batch_of, cfg=cfg, steps=args.steps,
            ckpt_dir=f"{args.ckpt_dir}/{cfg.name}",
            ckpt_every=args.ckpt_every)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    stats = {"report": report, "seconds": seconds, "launches": launches,
             "n_layers": cfg.n_layers}
    steady = report.step_seconds[1:] or report.step_seconds
    if steady:
        stats["ms_per_step"] = 1e3 * sum(steady) / len(steady)
        stats["tokens_per_s"] = tokens / sum(steady) * len(steady)
        print(f"[train] {stats['ms_per_step']:.1f} ms per step after the "
              f"first, {stats['tokens_per_s']:.0f} train tokens/s on "
              f"{args.device}")
    print("[train] kernel launches: " +
          " ".join(f"{k}={v}" for k, v in launches.items()))
    if report.losses:
        print(f"[train] done: {report.steps_run} steps, "
              f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}, "
              f"{report.rollbacks} rollbacks, "
              f"{len(report.slow_steps)} straggler events")
    return stats


if __name__ == "__main__":
    main()
